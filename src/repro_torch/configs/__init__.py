"""Experiment configurations of the port: the paper's graphs, strategies and
sweeps (``graphs``).  The LM configurations come with the LM-side stack
(ROADMAP queue 1, item 12)."""
