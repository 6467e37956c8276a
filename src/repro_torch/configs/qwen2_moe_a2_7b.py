"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts top-4.

24L d_model=2048 16H (MHA kv=16) expert_ff=1408 vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B]. EP impl (one body on one device); shared
expert ff = 4*1408 = 5632 with a sigmoid gate.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    act="silu",
    qkv_bias=True,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        expert_ff=1408,
        num_shared=4,
        shared_ff=5632,
        impl="ep",
    ),
)
