"""Data pipelines of the port: the deterministic synthetic LM token
stream, the twin of ``repro.data``."""
from repro_torch.data.pipeline import (
    DataConfig, SyntheticTokenPipeline, lm_synthetic_batch)

__all__ = ["DataConfig", "SyntheticTokenPipeline", "lm_synthetic_batch"]
