"""Model zoo of the port: dense GQA language models for serving
(``qwen2-1.5b``), the twins of ``repro.models``."""
from repro_torch.models.lm import (
    ArchConfig,
    build_plan,
    init_model,
    lm_decode,
    lm_prefill,
    load_reference_params,
    model_spec,
    n_params,
)
