"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048. [arXiv:2306.05284; hf]
EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings; output head predicts one codebook (vocab=2048).
GELU MLP (musicgen uses a standard transformer decoder); RoPE substituted for
the original sinusoidal embedding (positional scheme not under test).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    act="gelu_mlp",
    frontend="audio_stub",
)
