"""LM model substrate of the port: configs, layers, the SSM mixers, MoE, the
model with its frontends, the serving steps, the sharding rule tables and
the training step (the twin of ``repro.models``)."""
