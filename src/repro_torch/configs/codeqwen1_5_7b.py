"""codeqwen1.5-7b [dense] — qwen1.5-arch. 32L d=4096 32H (MHA kv=32) ff=13440 v=92416.

[hf:Qwen/CodeQwen1.5-7B]. SwiGLU, QKV bias (qwen1.5 family trait).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    act="silu",
    qkv_bias=True,
)
