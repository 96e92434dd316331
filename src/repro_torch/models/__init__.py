"""LM model substrate of the port: configs, layers, the dense model with its
frontends, and the serving steps (the twin of ``repro.models``; SSM, MoE,
sharding and training are ROADMAP queue 1, items 12.3, 12.4, 12.6, 12.7)."""
