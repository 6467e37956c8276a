"""qwen2.5-32b [dense] — GQA, QKV bias. 64L d=5120 40H (kv=8) ff=27648 v=152064.

[hf:Qwen/Qwen2.5-0.5B family scaling]. SwiGLU + RMSNorm + RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    act="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
