"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality).

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060]
Sequence mixing is the chunked SSD algorithm; sub-quadratic -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state=128, head_dim=64, expand=2, chunk=256, conv_dim=4),
    subquadratic=True,
    notes="pure SSM; no attention, no MLP (in/out proj + SSD only)",
)
