"""Entry points of the port that serve traffic (``serve``)."""
