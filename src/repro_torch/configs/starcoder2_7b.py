"""starcoder2-7b [dense] — GQA, RoPE. 32L d=4608 36H (kv=4) ff=18432 v=49152.

[arXiv:2402.19173; hf]. StarCoder2 uses a classic 4x GELU MLP (not SwiGLU).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    act="gelu_mlp",
    qkv_bias=True,
    notes="gpt-bigcode lineage: GELU MLP, biases; full attention here",
)
