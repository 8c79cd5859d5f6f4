"""Model zoo of the port: dense attention language models, whisper's
encoder-decoder and the vision-prefix model (``configs.ARCH_NAMES``),
the twins of ``repro.models``."""
from repro_torch.models.lm import (
    ArchConfig,
    build_plan,
    encode_frames,
    init_model,
    lm_decode,
    lm_loss,
    lm_prefill,
    load_reference_params,
    model_spec,
    n_params,
)
