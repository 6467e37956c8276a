"""mixtral-8x22b [moe] — 8 experts top-2, SWA. 56L d=6144 48H (kv=8) ff=16384 v=32768.

[arXiv:2401.04088; hf]. TP impl (one body on one device); sliding-window
attention (window 4096) -> rolling decode cache.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    act="silu",
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=16384, impl="tp"),
    subquadratic=True,
)
