"""LM model substrate of the port: configs, layers, the SSM mixers, MoE, the
model with its frontends, and the serving steps (the twin of
``repro.models``; sharding and training are ROADMAP queue 1, items 12.6
and 12.7)."""
