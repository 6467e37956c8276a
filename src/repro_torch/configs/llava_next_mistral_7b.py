"""llava-next-mistral-7b [vlm] — Mistral-7B backbone of LLaVA-NeXT.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, S, d_model); the backbone is what this config exercises.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    act="silu",
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    notes="anyres tiling handled by the (stubbed) frontend; full attention",
)
