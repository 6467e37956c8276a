"""Config dataclasses + registry of the PyTorch port.

Twin of `repro.configs.base`, kept as an independent copy so the port never
imports the JAX package. All ten architectures are registered: the dense
attention family (starcoder2-7b, codeqwen1.5-7b, qwen2.5-32b, granite-34b),
the stub-frontend configs (llava-next-mistral-7b, musicgen-large: the
backbone, fed tokens or precomputed embeddings), the MoE family
(qwen2-moe-a2.7b, mixtral-8x22b), mamba2-1.3b (SSD) and recurrentgemma-9b
(the RG-LRU hybrid).
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import tempfile
from dataclasses import dataclass
from typing import Optional, Tuple

# GEMM backends of the port (kernels/ops.py): `cuda` = the hand-written
# Hopper kernels, `torch` = their plain PyTorch versions, `auto` = the kernel
# for a CUDA tensor and the plain version for a CPU tensor
BACKEND_NAMES = ("auto", "cuda", "torch")


@dataclass(frozen=True)
class SpammConfig:
    enable: bool = False
    tau: float = 0.0                    # norm-product threshold (paper τ)
    valid_ratio: Optional[float] = None # target executed fraction (the
                                        # model path gates on tau, as in
                                        # the reference)
    tile: int = 64                      # LoNum
    block_n: int = 1                    # super-column width in the mm kernel
    backend: str = "auto"               # auto | cuda | torch
    bwd: str = "dense"                  # dense | spamm gradient path
    levels: int = 0                     # norm-pyramid coarsening steps (0 =
                                        # flat)
    dtype: str = "float32"              # GEMM compute dtype: float32 |
                                        # bfloat16 | int8 (f32 accumulate;
                                        # the gate stays a superset of the
                                        # f32 gate through the widened τ)
    moe_bmm: bool = False               # run the MoE grouped FFNs through
                                        # the batched spamm_bmm path (one
                                        # dense-grid launch per GEMM over
                                        # all experts); False gates each
                                        # expert through maybe_spamm_matmul
    autotune: bool = False              # roofline-autotune block_n/levels/
                                        # bucket per weight at freeze time
                                        # (`plans.precompute.tune_for`)
    tune_profile: Optional[str] = None  # cost-profile JSON (`core.cost.
                                        # CostProfile`): the coefficients
                                        # of the autotuner and of the
                                        # engine's cost residual

    @property
    def coarse_tile(self) -> int:
        """Tile size of the coarsest pyramid level (== tile when flat)."""
        return self.tile * (2 ** self.levels)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0
    shared_ff: int = 0
    impl: str = "tp"                    # "tp": ff-dim TP; "ep": expert-
                                        # parallel (one body on one device)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001    # load-balancing aux loss


@dataclass(frozen=True)
class SSMConfig:                         # Mamba2 / SSD
    state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_dim: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:                       # RecurrentGemma
    lru_width: int = 0                  # 0 → d_model
    conv_dim: int = 4
    c_exponent: float = 8.0
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")  # 1 attn : 2 rec


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                   # 0 → d_model // num_heads
    act: str = "silu"                   # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: Optional[str] = None      # None | "vision_stub" | "audio_stub"
    subquadratic: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's widths)."""
        kw = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            d_ff=128,
            vocab=256,
            head_dim=16,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                expert_ff=32,
                shared_ff=64 if self.moe.num_shared else 0,
                top_k=min(self.moe.top_k, 2),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state=16, head_dim=16,
                                            chunk=32)
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(self.rglru, lru_width=64)
            kw["num_layers"] = 3  # one full (rec, rec, attn) group
        if self.sliding_window:
            kw["sliding_window"] = 32
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# shape cells (the reference's; the same for all ten archs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ParallelConfig:
    """The runtime config of the reference, except the compute dtype's
    default (f32, the port's numerics of record, where the reference's is
    bf16) and two fields the port has no use for: `scan_layers` (its stack
    is a Python loop) and `attn_kv_chunk` (its attention takes each q chunk
    against the whole KV in one softmax). `fsdp`, `seq_shard_acts` and
    `decode_seq_shard` act over a (data, model) mesh
    (`transformer.NetCtx`); on one device they change nothing."""
    fsdp: bool = True                   # ZeRO-3 param sharding over data
    remat: str = "full"                 # none | dots | full (training
                                        # stack, `transformer.stack_fwd`)
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    loss_chunk: int = 1024              # chunked-CE seq chunk
    attn_q_chunk: int = 512             # attention q block (rows per chunk)
    decode_seq_shard: bool = True       # seq-sharded KV decode over model
    seq_shard_acts: bool = False        # Megatron-SP: residual stream
                                        # sharded on seq over model
    grad_compression: str = "none"      # none | int8_ef


def _default_ckpt_dir() -> str:
    # the reference's /tmp/repro_ckpt, under the temp directory the
    # environment names
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0
    ckpt_every: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)


ARCH_IDS = (
    "llava-next-mistral-7b",
    "mamba2-1.3b",
    "starcoder2-7b",
    "granite-34b",
    "codeqwen1.5-7b",
    "qwen2.5-32b",
    "recurrentgemma-9b",
    "qwen2-moe-a2.7b",
    "mixtral-8x22b",
    "musicgen-large",
)

# archs whose config module exists in the port: all of them
PORTED_ARCHS = ("starcoder2-7b", "codeqwen1.5-7b", "qwen2.5-32b",
                "granite-34b", "qwen2-moe-a2.7b", "mixtral-8x22b",
                "llava-next-mistral-7b", "musicgen-large", "mamba2-1.3b",
                "recurrentgemma-9b")


# archs for which long_500k runs (sub-quadratic sequence mixing); the rest
# are documented skips
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b", "mixtral-8x22b")


def get_config(name: str) -> ModelConfig:
    if name not in PORTED_ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def cells(include_skipped: bool = False):
    """All (arch, shape, skipped) dry-run cells: 33 runnable and 7
    documented skips (long_500k outside LONG_CONTEXT_ARCHS; the reference's
    docstring says 37 + 3, its code gives these)."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            skipped = (shape.name == "long_500k"
                       and arch not in LONG_CONTEXT_ARCHS)
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name, skipped))
    return out
