"""PyTorch/CUDA port of the actor-model graph engine (``repro`` is the JAX
reference).  Imports torch and numpy only -- never JAX, never ``repro``."""
