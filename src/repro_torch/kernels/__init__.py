"""Push kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
plain torch versions, and the wrappers the engine calls (``ops``)."""
