"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000. [arXiv:2402.19427]
Local attention window 2048; sub-quadratic -> long_500k runs.
38 layers = 12 x (rec, rec, attn) groups + 2 trailing recurrent layers.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    act="gelu",
    sliding_window=2048,
    rglru=RGLRUConfig(lru_width=4096, conv_dim=4, c_exponent=8.0),
    subquadratic=True,
    notes="head_dim=256 (4096/16); GeGLU MLP; rotary on attention layers only",
)
