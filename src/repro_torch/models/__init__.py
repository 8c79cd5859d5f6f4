"""Model zoo of the port: dense attention language models, whisper's
encoder-decoder, the vision-prefix model, xLSTM, the Mamba2 hybrid and
the MLA + MoE models (``configs.ARCH_NAMES``), the twins of
``repro.models``."""
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
