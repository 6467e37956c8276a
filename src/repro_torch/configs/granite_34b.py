"""granite-34b [dense] — llama-arch, code. 88L d=6144 48H (MQA kv=1) ff=24576 v=49152.

[arXiv:2405.04324; hf]. Assignment labels it llama-arch -> SwiGLU + RMSNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    act="silu",
    notes="MQA (kv=1): decode uses seq-sharded KV (heads cannot shard)",
)
