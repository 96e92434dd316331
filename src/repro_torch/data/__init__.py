"""Step-indexed synthetic data of the port (the twin of ``repro.data``)."""

from repro_torch.data.pipeline import SyntheticLM, batch_for_shape, make_pipeline
