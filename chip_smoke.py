#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/kernels/csrc, checks
that the tensor-core work-list kernels' SASS runs on the tensor cores (the
`wgmma` kernels of the tiles from 48, which serve every path below at tile
64 and the large tiles: IGMMA int8, HGMMA bf16; the `mma.sync` kernels of
tiles 16 and 32: IMMA int8, HMMA bf16; no IDP4A anywhere) and that the
tensor-core get-norm kernels do (HMMA on TF32, the int8 one loading no
more than the f32 one), and drives two paths of the port. Each work-list
kernel_check line names the kernel that ran and its instruction family
("wgmma", "mma.sync", "fma").

Serving: holds the get-norm and work-list kernels against their plain
PyTorch versions at the serving path's shapes, prefill and decode (and
frozen ≡ eager bit for bit), the f32 decode kernel (csrc/spamm_decode.cu)
at w1 and w2 decode with BATCH, 1 and 16 live rows (on the live rows bit
for bit the 64-row kernel on every row, within 1e-4 of its plain version,
timed by device beside the 64-row kernel and `torch.matmul` at the live
and the padded rows), and the low-precision kernels the same way:
the fused int8 get-norm bit for bit against the unfused composition, the
int8 work-list (tensor cores) bit for bit against its plain version at
prefill, decode w1 and decode w2 (column slices), block_n 1 and 2, and
within 1e-5 of the f32 kernel on the dequantized operands, the bf16
work-list (tensor cores) within 1e-4 of the output's magnitude against the
f32 kernel on bf16-rounded operands and its plain version, deterministic,
at prefill and decode shapes, and frozen int8 / bf16 ≡ eager bit for
bit. The device time of each get-norm kernel at the prefill and decode
activation shapes and at w1 is read from the profiler, beside the
wrapper's host cost per call; the get-norm pair is also timed back to back
at w1 and at the prefill activation. It then serves starcoder2-7b at full
width (d=4608, ff=18432, 36/4 heads, SERVE_LAYERS of its 32 layers, random
weights from a seed) through `Engine.generate`: dense, τ = 0 and a τ > 0 derived from the first
gated GEMM of a decode step (so that both prefill and decode keep part of
their tiles), then at that τ with int8 and with bf16 GEMMs; and checks at
layer-0 wq that the int8 and bf16 gates keep every tile the f32 gate keeps.
Every decode step runs as a CUDA graph (the engine's default); runs (c),
(d) and (e) are served once more by the same engine eagerly, which must
give the graphed wave's tokens, step logits, gating stats and launch
counts bit for bit, and run (c) is profiled both ways.
The tensor-core get-norm pair (use_mxu=True, paper Eq. 3-4) is held against
its plain versions at the activation and w1 shapes, fused ≡ unfused bit for
bit, and its device time is read at tiles 16 and 32 of the activation and
on one N = 16384 library operand, beside the CUDA-core pair's; an empty
kernel's device time is printed as launch_floor_ms.

Store: at run (c)'s τ, every gated weight of run (c)'s model is frozen
into a fresh plan store (the offline `populate` walk); a fresh
`Engine(plan_store=…)` then serves the wave from store hits only, with no
get-norm launch while it freezes and run (c)'s tokens and prefill logits
bit for bit; the walk is repeated with use_mxu=True at f32 and int8 over the
first STORE_MXU_LAYERS layers (new keys, one launch of the tensor-core
kernels per weight), the normmaps compared with the CUDA-core ones, and
once more warm (store hits only, no launch, the cold use_mxu artifacts bit
for bit).

Chunked: run (f), the chunked-prefill plane on the same model: eight
prompts of 64 to 448 tokens (seed 0) through four slots, one-tile chunks,
max_len 512, decode and chunk steps as CUDA graphs. At τ = 0 each
request's tokens equal its solo wave's; at run (c)'s τ a warm wave is
measured (tok/s, TTFT, decode ms/step, chunks, captures, graph pool
bytes, valid fractions) and served again eagerly, bit for bit.

Obs: run (c)'s engine (the observability bundle on, graphed) against a
second engine of the same params and frozen weights with obs=False: tokens,
every step's logits and launches bit for bit, the same device nodes per
replayed decode step, per_layer with every layer × 6 sites
summing to the wave's aggregates, a graphed wave's cells equal to an eager
wave's, the Prometheus dump through `parse_prometheus`, and the Chrome
trace (written under chiprun_out/chip_smoke_obs/) holding the engine's
spans; decode ms/step, TTFT and tok/s with obs on and off, the cost
residual per phase. Run (f)'s chunked engine must report prefill_chunk
spans and the admission and chunk counters it counts.

Calibrate: `core.cost.calibrate` on the card at starcoder2-7b's serving
shapes (its layer's gated weights, run (c)'s prefill and decode rows),
each sample device-bound (calls captured as a CUDA graph, replayed back to
back): get-norms up to ≈ 105 MB, the frozen w1 work-list at the prefill
and decode grids across τ and block_n 1, 2; the gate rate from the frozen
device gate at the decode grid. Prints the fitted coefficients beside the
nominal ones, the NNLS columns kept, the largest |log2(measured /
predicted)| over the samples; the profile is saved under
chiprun_out/chip_smoke_calibrate/.

Autotune (on run (c)'s engine, after the obs phase): each gated site of
starcoder2-7b tuned once on its layer-0 weight at run (c)'s τ, with the
calibrated and with the nominal profile (picks, Σ predicted against Σ
default predicted, seconds); run (c) served graphed on the tuned
artifacts and on run (c)'s own, in turns (tok/s, TTFT, decode ms/step,
nodes per replayed step), each wave's taps priced with both profiles
(cost residual); tuned graphed ≡ tuned eager; the tuned gate keeps every
tile the block_n = 1 gate keeps at layer 0; a warm plan store hits every
tuned artifact.

Dense families, at full width and FAMILY_DEPTH layers: codeqwen1.5-7b
(dense, τ = 0 ≡ dense, the median τ graphed ≡ eager, that τ autotuned:
graphed ≡ eager, its gate ⊇ the untuned gate at layer 0), qwen2.5-32b and
granite-34b (dense, τ = 0 ≡ dense;
granite-34b's chunked plane graphed ≡ eager), peak memory of each.

MoE: qwen2-moe-a2.7b at full width and MOE_LAYERS of its 24 layers (d
2048, 16/16 heads, 60 experts top-4 of ff 1408, a sigmoid-gated shared
expert of ff 5632, vocab 151936; 57.3 GB of f32 whole) on run (c)'s wave:
dense; τ = 0 with moe_bmm (tokens equal dense, prefill logits within
1e-3); the median τ of the first gated decode GEMM with moe_bmm (graphed
≡ eager bit for bit, the dense-grid kernel three times a layer per
prefill), one decode step profiled (routing,
routed-expert bmms, shared expert, attention gates) beside its graph's
replay; the per-expert path at that τ on 4 layers ≡ moe_bmm bit for bit;
the chunked plane (SpAMM off, τ = 0, that τ; graphed ≡ eager; chunk steps
captured only with SpAMM off). mixtral-8x22b at full width, 4 of 56
layers (41.7 GB): dense, τ = 0 with moe_bmm, on the sliding-window ring
decode cache.

Last families (`phase_last_families`), each freed before the next, run
(c)'s wave at max_len 512: llava-next-mistral-7b (8 of 32 layers, GQA
32/8, SwiGLU ff 14336) and musicgen-large (12 of 48 layers, MHA, GELU
MLP) behind their stub frontends: dense, τ = 0 ≡ dense tokens (prefill logits
within 1e-3), the median τ of the first gated GEMM of a decode step
(graphed ≡ eager bit for bit), a prefill fed embedding[tokens] as
`embeds` ≡ the token prefill bit for bit; musicgen's chunked plane at
τ = 0 (4 prompts of 37–128 tokens, 2 slots; graphed ≡ eager, ≡ solo
waves). recurrentgemma-9b (5 of its 12 (rec, rec, attn) groups + the 2
rec layers of its tail, MQA 16/1 of head_dim 256, window 2048): the same
checks, every gated weight frozen, the ring decode cache, a decode step's device time by range
(RG-LRU blocks, attention layers, MLPs, frozen gates, work-lists), and a
mixed-length batch and prefill_chunk refused. mamba2-1.3b (48 SSD
layers): dense at 4 × 128 and 4 × 320 tokens (one carried 256-token chunk
and a 64-token remainder), graphed ≡ eager; SpAMM on at recurrentgemma's
τ ≡ dense bit for bit with no get-norm or work-list launch; prefill_chunk
and a mixed-length batch refused.

Train (`phase_train`, after the last families): starcoder2-7b at full
width and TRAIN_LAYERS of its 32 layers, TRAIN_BATCH × TRAIN_SEQ tokens of
`SyntheticLM` a step, AdamW, remat "full": (t1) dense steps (losses fall;
step ms, tokens/s, peak GB); (t2) τ = 0 with bwd="spamm" ≡ dense (step
0's loss within 1e-5, each gradient leaf within 1e-3 of its magnitude,
rows 1 and 2 launched as the code counts, remat none and full); (t3) the
median τ of step 0's first gated GEMM with bwd="dense" and bwd="spamm";
(t4) layer 0's w1 backward products (dx = g @ w1ᵀ, dW = xᵀ @ g) at their
real operands against the plain version, bit for bit over two calls,
timed against `torch.matmul`; (t5) a reduced model crashed and resumed
from its checkpoints on the card, the final loss within 0.15.

Library: the paper's own call. (a) spamm() and plan(levels=3) + execute()
with the valid-ratio τ-search on two N = 16384 algebraic-decay matrices
(the paper's §4.1 ensemble) at ratios 0.30 and 0.10: achieved ratio,
hierarchical ≡ flat bit for bit, τ = 0 against torch.matmul; (b) batched
spamm_bmm at the expert shapes of qwen2-moe-a2.7b (60 experts, d 2048,
expert ff 1408), per-slice through the dense-grid kernel and shared-weight
through the work-list kernel; (c) the pyramid pooling kernel; (d) the eager
gated GEMM with a pyramid (levels = 2 ≡ levels = 0) on starcoder2-7b's w1;
(e) spamm(valid_ratio=0.30) with int8 and with bf16 GEMMs on the ensemble;
(f) spamm(valid_ratio=0.30) with the tensor-core get-norm.

Multi (`phase_multi`, after train), the multi-GPU slice on the one card:
(m1) spamm_rowpart and spamm_2d on a 1×1 mesh over NCCL on the library
run's operands at the τ its spamm(valid_ratio=0.30) finds, ≡ the flat
product bit for bit; (m2) MULTI_RANKS gloo ranks spawned on cuda:0 (the
kernels built here first): spamm_rowpart under each schedule ≡ flat bit
for bit, at int8 and bf16 ≡ the flat product at that dtype bit for bit,
each rank's row-2 device time of its strip (all timed by rank 0, one
strip at a time), the predicted imbalance (the schedule's coarse
estimate and the fine V) against the measured; (m3) spamm_2d on a 2×2
mesh within 1e-4; (m4) starcoder2-7b at full width and MULTI_LAYERS
layers, one wave of MULTI_BATCH × MULTI_PLEN tokens, sharded over
MULTI_SHARDS shards of cuda:0 with re-sharding every 2 engine steps:
tokens ≡ the unsharded engine's, the captures fixed across re-cuts that
move request groups, each shard's replayed decode step against the live
predicted imbalance, graphed ≡ eager at the live cut; (m5)
MULTI_TRAIN_STEPS train-loop steps with re-sharding ≡ without (losses,
gradient norms, final parameters).

Tp (`phase_tp`, after multi), the model parallelism of the model on the
one card: 4 gloo ranks share cuda:0 as a 2×2 (data, model) mesh (not a
multi-card time), each holding its shards (`models.model.placements`,
`shard_params`); the unsharded runs first on cuda:0. (p1) starcoder2-7b
at full width and TP_LAYERS layers, FSDP off: prefill of TP_BATCH ×
TP_PLEN tokens and TP_NEW decode steps on a sequence-sharded cache
(flash-decoding merge over "model"), dense, τ = 0 and τ > 0 (layer 0
wq's median product; decode through each rank's frozen slices), fed the
unsharded port's greedy tokens per data shard: logits within
TP_LOGIT_RTOL, dense and τ = 0 tokens equal, each gated prefill GEMM's
global valid fraction (the model ranks' counts summed) equal to the
unsharded one, rows 1 and 2 launched on every rank; (p2) (p1)'s prefill
under Megatron-SP; (p3) TP_TRAIN_STEPS train-loop steps with FSDP and
remat full against the same loop on one device (losses within 1e-5,
parameters within TP_PARAM_ATOL, first moments within TP_MU_RTOL), then
one int8_ef step against the same step on one device (its residuals' and
its update's sums of squares per shard within TP_INT8_RTOL, the loss of a
following forward within 1e-5); (p4)
qwen2-moe-a2.7b at full width and TP_MOE_LAYERS layers, impl tp and ep
at τ > 0 with `moe_bmm` (row 6 launches): tp ≡ ep and both against the
unsharded prefill per data shard; (p5) (p3)'s parameters and moments
written as each rank's shards, put together by the 3 surviving ranks
and re-placed on `best_mesh_shape(3, 2)` = (3, 1) bit for bit, then one
step with a finite loss.

Serve_tp (inside the tp phase's spawn, after (p4)), the serving engine over
a model axis: each rank builds its shards of `init_params(SEED)` and
serves through `Engine(ctx=)`, against the unsharded `Engine` on cuda:0.
(s1) starcoder2-7b at full width, ST_LAYERS layers, model axis 4: a wave
at τ = 0 and at derive_tau's τ moved into a gap of the gate products, and
the chunked plane at τ = 0 (ST_SLOTS slots, queued prompts of
ST_CHUNK_PLENS tokens): tokens ≡, per-layer and aggregate valid fractions
equal, prefill logits within ST_LOGIT_RTOL, steps reported eager under
gloo, rows 1 and 2 launched on every rank; reported beside the gate
margin, how far the activation tile norms of a split prefill stray from
the unsharded ones. (s2) qwen2-moe-a2.7b, ST_LAYERS layers, model axis 2, experts tp
then ep with `moe_bmm` (row 6 on every rank) at τ = 0: tokens ≡. (s3) the
legacy path (`freeze_plans=False`) of (s1)'s model at its τ on cuda:0:
prefill logits ≡ the frozen engine's bit for bit, a decode step launches
no get-norm or work-list kernel.

Dryrun (`phase_dryrun`, after tp), the dry-run tooling: this process as
rank 0 of a fake process group of the production world (256 ranks as a
32×8 (data, model) mesh, 512 as 2×32×8), collectives counted by
`launch.op_analysis.OpAnalysis` and not performed. The SpAMM variants of
`launch.dryrun_spamm` (rowpart contiguous and cyclic, 2d, 2d at bf16, 2d
over two pods) on the N = 32768 decay matrix at its default tile, the
reference's 128, at the τ calibrated for a 0.10 ratio at N = 4096: rank
0's own product (before its first collective) ≡ flat `spamm()` on its
rows at that τ, tile and dtype, bit for bit; the counted tile products = its plan's real steps; the counted
all-gather wire bytes = the ring model. Then qwen2.5-32b's train_4k and
starcoder2-7b's decode_32k cells of `launch.dryrun` (rank 0's shards,
moments, batch and cache, one real step): peak memory, FLOPs, bytes, wire
bytes per axis and the roofline terms (H100 SXM data-sheet rates).

Large tiles (`phase_large_tiles`, after library): the gated GEMM kernels
at the reference's tiles 128, 256 and 512, walked in K-chunks of a
64-wide sub-tile on the planner's own step tables. (l1) spamm() at ratio
0.30 on the library's N = 16384 ensemble at tiles 128 and 256, f32, bf16
and int8: the achieved ratio, plan() + execute() ≡ spamm() with their
times, and on the plan's first row band the product against the plain
version (int8 bit for bit, f32 and bf16 within 1e-4) and, f32 and bf16,
bit for bit against the 64-tile kernel on the refined step tables; at
128 work-list ≡ dense-grid and a levels-3 plan ≡ flat. (l2)
starcoder2-7b's w1 frozen at 128, 256 and 512 for the 512-row prefill:
frozen ≡ eager at each dtype; rows 2, 2 bf16 and 5 at about half their
tile products against their plain versions and the 64-tile kernels,
timed single and back to back beside their bound and `torch.matmul` /
`torch._int_mm`; the use_mxu freezes at 128. (l3) the get-norm kernels
(rows 1, 1 mxu, 4, 4 mxu) at 128 and 256 on w1 and the activation.
(l4) spamm_bmm at 128 on 8 slices of 256 × 2048 @ 2048 × 1408
(qwen2-moe's expert widths): row 6 ≡ the per-slice work-list and the
64-tile dense-grid kernel on the refined gate bit for bit, within 1e-4
of its plain version, beside `torch.bmm`. (l5) the bf16 and int8
work-list kernels at the tiles that are not multiples of 64: starcoder2-7b's
w1 frozen at 96 and 48 (the `wgmma` kernels) and 32 and 16 (the `mma.sync`
kernels) for the prefill activation padded to the tile, w2 at 32 for a
decode step (`mma.sync`, 2 column slices): int8 bit for bit and bf16
within 1e-4 against their plain versions, frozen ≡ eager, each on the
family the route gives its tile, timed single and back to back beside
their bound and the library call; driven with the counts at 0 just
before and read just after, apart from (l1)–(l4).

Every result line is a JSON object; the line before the last lists
twelve kernel entries (the work-list GEMM three times, f32's 64-row and
decode kernels and bf16, and the bf16 and int8 ones again for their
`mma.sync` kernels; each of the get-norm pair twice, CUDA-core and
tensor-core) with their launches on their path (the τ > 0 serving run at
its dtype, and (l5) for the bf16 and int8 `wgmma` kernels too, run (c)'s
decode steps for the decode kernel, the store walk, the library path, the
large_tiles phase's (l5), or the dense-grid GEMM's
qwen2-moe τ > 0 wave; the f32 pair
also on run (f), the MoE wave, the last families' τ > 0 waves and the
training runs, with row 2's times at the backward products' shapes),
errors, times and bounds, and each entry's multi_launches and
tp_launches on the multi and tp phases' cells (summed over the ranks; rows
1, 2 and 2 bf16 also dryrun_launches per SpAMM variant), and its
large_tile_launches on the large_tiles phase's main path with its
numbers there (`large_tiles`, one entry per tile and shape);
the last line is {"ok": true, "device": {...}}.
Any failed check exits non-zero. Without CUDA, or without the repository's
src/ beside it, it exits 2 and prints no result.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

# H100 SXM data sheet: HBM3 bandwidth, f32 (non-tensor-core) peak, and the
# dense tensor-core peaks of bf16 and int8
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
PEAK_INT8_OP_S = 1979e12

DEV = "cuda"
# the store phase's temporary plan store, in a directory .gitignore lists
STORE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "plan_store")
ARCH = "starcoder2-7b"
# the serving, store, chunked, obs and autotune runs: starcoder2-7b at full
# width and this depth of its 32 layers, cut for the smoke's time limit
# (the checks do not depend on the depth; every gated site of a layer runs)
SERVE_LAYERS = 8
TILE = 64
BATCH, PROMPT_LEN, MAX_NEW = 4, 128, 16
DECAY_N, DECAY_LAM = 4096, 0.999
MAX_LEN = PROMPT_LEN + MAX_NEW + 16
# run (f), the chunked plane: mixed prompt lengths through a slot pool
CHUNK_PLENS = (64, 100, 128, 200, 256, 300, 384, 448)
CHUNK_SLOTS, CHUNK_MAX_LEN = 4, 512
PROFILE_NEW = 4  # tokens of the profiled wave: prefill + 3 decode steps
SEED = 0
# the obs phase's metrics dump and Chrome trace, in a directory .gitignore
# lists
OBS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "chip_smoke_obs")
# the spans a wave of the engine records, and the gated GEMM sites of a
# starcoder2-7b layer
OBS_SPANS = ("freeze", "plan_assembly", "prefill", "decode_step", "wave")
OBS_SITES = ("wq", "wk", "wv", "wo", "w1", "w2")
# a wave's per-(layer, site) bytes summed against the aggregate, relative
OBS_BYTES_RTOL = 1e-9
# the calibrated cost profile and the calibration's full report, in a
# directory .gitignore lists
CAL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "chip_smoke_calibrate")
# the dense family at full width and this depth: codeqwen1.5-7b (32 layers
# whole; cut for the smoke's time limit), qwen2.5-32b (1.95 GB of f32 a
# layer) and
# granite-34b (88 layers, 187 GB of f32 whole)
FAMILY_DEPTH = {"codeqwen1.5-7b": 8, "qwen2.5-32b": 8, "granite-34b": 8}
# granite-34b's chunked plane (MQA in the chunk and decode graphs): mixed
# prompt lengths through two slots
FAMILY_CHUNK_PLENS = (64, 100, 37, 128)
# the MoE family: qwen2-moe-a2.7b (24 layers, 14.3 B parameters, 57.3 GB of
# f32 whole) at this depth, cut for the smoke's time limit, its per-expert
# path (180 eager plans a layer) at this depth, and mixtral-8x22b (10.0 GB
# of f32 a layer) at full width and this depth
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_LAYERS = 12
MOE_PER_EXPERT_LAYERS = 4
MOE_MIXTRAL_LAYERS = 4
# the last four families: llava-next-mistral-7b (32 layers,
# 29.0 GB of f32) and musicgen-large (48, 9.7 GB) behind their stub
# frontends, recurrentgemma-9b (38: 12 (rec, rec, attn) groups + 2 rec; 38.5
# GB) and mamba2-1.3b (48, 5.8 GB); their waves at this max_len
LAST_FAMILIES = ("llava-next-mistral-7b", "musicgen-large",
                 "recurrentgemma-9b", "mamba2-1.3b")
# cut, for the smoke's time limit, since the multi phase came in:
# llava-next-mistral-7b, musicgen-large and recurrentgemma-9b (5 (rec, rec,
# attn) groups + the 2-layer tail) at this depth; mamba2-1.3b stays whole
LAST_FAMILY_DEPTH = {"llava-next-mistral-7b": 8, "musicgen-large": 12,
                     "recurrentgemma-9b": 17}
FAMILY_MAX_LEN = 512
# mamba2's long prompt: one carried 256-token SSD chunk and a 64-token
# remainder
SSM_LONG_PROMPT = 320
# the store phase's use_mxu walks run at this depth (the walk's checks do
# not depend on it; the cold and warm run (c) walks take every layer of run
# (c)'s model)
STORE_MXU_LAYERS = 8
# the training phase: starcoder2-7b at full width and this depth (1.32 B
# parameters; the whole model's f32 parameters, gradients and two AdamW
# moments, ≈ 118 GB, exceed the card's 80), TRAIN_BATCH sequences of
# TRAIN_SEQ tokens from SyntheticLM, TRAIN_STEPS steps of AdamW at
# TRAIN_LR with TRAIN_WARMUP warm-up steps
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 256
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 8, 1e-3, 2
# (t5): the reduced model crashes at RESUME_CRASH with a checkpoint every
# RESUME_EVERY steps and resumes to RESUME_STEPS (a full-width checkpoint
# would be ≈ 16 GB on disk); the final loss within the reference test's
# RESUME_LOSS_TOL of the uninterrupted run's
RESUME_CRASH, RESUME_EVERY, RESUME_STEPS = 6, 3, 9
RESUME_LOSS_TOL = 0.15
# τ = 0 with bwd="spamm" against dense: step 0's loss (relative), and each
# gradient leaf relative to its own largest magnitude (the work-list sums
# in fmaf order, cuBLAS reassociates)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
# the resume check's checkpoints, in a directory .gitignore lists
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chiprun_out", "chip_smoke_train")
# nvidia-smi's "name, power.limit" line, set by main()
CARD = None
# tile norms: f32 sums of 4096 squares in two orders (pooling: four squares
# summed in one order in both versions)
NORM_RTOL = 1e-5
# work-list GEMM vs plain: FMA vs multiply-add over K ≤ 18432, relative to
# the output's largest magnitude; also the bf16 kernel (tensor-core MMA
# sums) against the f32 kernel on the rounded operands and its plain version
MM_RTOL = 1e-4
# τ = 0 vs dense prefill logits after up to 32 f32 layers (reassociated sums),
# relative to the logits' largest magnitude
LOGIT_RTOL = 1e-3
# int8 work-list vs the f32 kernel on the dequantized operands, relative to
# the output's largest magnitude (the reference's own bound,
# tests/test_mixed_precision.py): the f32 kernel rounds inside each tile dot
INT8_DEQ_RTOL = 1e-5
LOWP_DTYPES = ("int8", "bfloat16")

# library path: the paper's §4.1 ensemble at N = 16384 (A, B and C 1 GiB
# each in f32), the valid ratios asked for, the search's tolerance and the
# pyramid depth of the hierarchical plans
LIB_N = 16384
LIB_RATIOS = (0.30, 0.10)
RATIO_TOL = 0.01
LIB_LEVELS = 3
# qwen2-moe-a2.7b expert shapes (src/repro/configs/qwen2_moe_a2_7b.py, from
# Qwen/Qwen1.5-MoE-A2.7B): 60 experts, d_model 2048, expert ff 1408. A
# 512-token prefill at top-4 routes about 34 tokens to each expert, padded
# to one 64-row tile
MOE_EXPERTS, MOE_D, MOE_FF, MOE_ROWS = 60, 2048, 1408, 64
# the eager gated GEMM with a pyramid
EAGER_LEVELS = 2

# the multi phase (after train): the distributed library call and the
# pod-sharded engine on the one card. (m2)/(m3) spawn MULTI_RANKS gloo
# ranks on cuda:0 (NCCL refuses two ranks on one GPU); (m4) serves
# starcoder2-7b at full width and MULTI_LAYERS of its 32 layers over
# MULTI_SHARDS shards of one card: MULTI_BATCH requests of MULTI_PLEN tokens
# at tile 64 (8 request groups; at tile 16 a prefill's frozen step tables
# would hold 434 M steps a layer), MULTI_NEW new tokens, re-sharding every 2
# engine steps on a probe window of MULTI_PROBE_WINDOW tokens a request.
# The embedding rows get a hot/cold profile (the reference test's): the
# probe's norm products of an all-hot tile sit at MULTI_HOT·τ, of an
# all-cold one at MULTI_COLD·τ, so the prompts' tokens move the work
# estimate. (m5): MULTI_TRAIN_STEPS steps of the train loop with and without
# re-sharding.
MULTI_RANKS = 4
MULTI_SCHEDULES = ("contiguous", "cyclic", "equal_work", "auto")
MULTI_LAYERS = 8
MULTI_SHARDS = 4
MULTI_BATCH, MULTI_PLEN, MULTI_NEW = 512, 64, 8
MULTI_PROBE_WINDOW = 32
MULTI_HOT, MULTI_COLD = 4.0, 0.04
MULTI_TRAIN_STEPS = 2
# the tp phase (after multi): model parallelism of the model over a 2×2
# (data, model) mesh of TP_RANKS gloo ranks sharing cuda:0 (not a
# multi-card time). (p1) starcoder2-7b at full width and TP_LAYERS of its
# 32 layers, TP_BATCH prompts of TP_PLEN tokens, TP_NEW decode steps on a
# TP_MAX_LEN-slot sequence-sharded cache, dense, τ = 0 and τ > 0, FSDP off
# (serving); (p2) (p1)'s prefill under Megatron-SP; (p3) TP_TRAIN_STEPS
# train-loop steps with FSDP and remat full, TP_BATCH × TP_TRAIN_SEQ
# tokens, then one int8_ef step; (p4) qwen2-moe-a2.7b at full width and
# TP_MOE_LAYERS of its 24 layers, impl tp and ep at τ > 0 (moe_bmm);
# (p5) (p3)'s state re-placed onto the 3 surviving ranks.
TP_RANKS = 4
TP_MESH = (2, 2)
TP_LAYERS = 2
TP_BATCH, TP_PLEN, TP_NEW, TP_MAX_LEN = 4, 128, 8, 256
TP_TRAIN_SEQ, TP_TRAIN_STEPS = 256, 2
TP_MOE_LAYERS = 2
# sharded against unsharded logits, relative to the logits' largest
# magnitude: f32 row-parallel partial sums added over the model ranks (and,
# at τ > 0, a gate flipped at a tie by an ulp of a layer-1 norm)
TP_LOGIT_RTOL = 1e-4
# parameters after TP_TRAIN_STEPS steps (lr_at(1) = TRAIN_LR / 2, then
# TRAIN_LR), absolute: a fifth of one step. AdamW divides each gradient
# element by its own magnitude, so only an element whose gradient sits at
# the rounding level of the reordered sums may move by more; wrong, zero
# or sign-flipped gradients move most elements by a whole step
TP_PARAM_ATOL = TRAIN_LR / 5
# first moments after TP_TRAIN_STEPS steps, per leaf: ‖Δμ‖ / ‖μ‖ on each
# rank's shard (μ is linear in the gradients, so a gradient off by any
# factor shows here even where AdamW's normalization hides it)
TP_MU_RTOL = 1e-4
# the int8_ef step, per leaf and shard: the sums of squares of the error
# feedback residuals and of the parameters' update (a scale taken over
# one shard, not the whole leaf, re-grids every residual)
TP_INT8_RTOL = 1e-3
# the serve_tp phase (inside tp's spawn of TP_RANKS gloo ranks on cuda:0):
# `Engine(ctx=)` over a model axis against the unsharded `Engine` on the
# same whole weights. (s1) starcoder2-7b at full width and ST_LAYERS
# layers, model axis 4: a wave of ST_BATCH × ST_PLEN prompts with ST_NEW
# new tokens at τ = 0 and at derive_tau's τ (moved into a gap of the
# products around it: up to ST_GAP_TRIES gaps tried, each on its own run,
# until every product is ST_GATE_MARGIN away, relative, else the best;
# the phase fails unless that margin is ST_MARGIN_OVER_DEV times the
# largest relative deviation by which the row-parallel sums moved an
# activation tile's norm on the ranks, so that no gate flips), and the
# chunked plane at τ = 0 (ST_SLOTS slots, prompts of ST_CHUNK_PLENS tokens
# in chunks of ST_CHUNK); (s2) qwen2-moe-a2.7b at full width and ST_LAYERS
# layers, model axis 2 (a 2×2 mesh of replicas), experts tp then ep,
# moe_bmm at τ = 0; (s3) the legacy path (freeze_plans=False) of (s1)'s
# model on cuda:0.
ST_LAYERS = 2
ST_BATCH, ST_PLEN, ST_NEW, ST_MAX_LEN = 4, 128, 8, 256
ST_SLOTS, ST_CHUNK = 4, 64
ST_CHUNK_PLENS = (64, 192, 128, 96, 160, 64)
ST_GATE_MARGIN = 3e-6
ST_GAP_TRIES = 10
ST_MARGIN_OVER_DEV = 10.0
ST_LOGIT_RTOL = 1e-4
# the dryrun phase (after tp): this process as rank 0 of a fake process
# group of the production world (`launch.mesh.fake_world`; 256 ranks as
# (data 32, model 8), 512 as (pod 2, data 32, model 8)). The SpAMM
# variants of `launch.dryrun_spamm` on the N = DRYRUN_N decay matrix at
# the τ calibrated for DRYRUN_RATIO on a DRYRUN_CALIBRATE_N proxy, and
# DRYRUN_CELLS of `launch.dryrun` (one train step, one decode step of a
# 32k cache: the rank's shards, moments, batch and cache). starcoder2-7b's
# train_4k peaks at 59 GB a rank, which beside the ≈ 24 GB the earlier
# phases leave allocated does not fit the card; qwen2.5-32b's at 34 GB
# at `launch.dryrun_spamm`'s default tile DRYRUN_TILE, the reference's
DRYRUN_N = 32768
DRYRUN_RATIO = 0.10
DRYRUN_CALIBRATE_N = 4096
DRYRUN_TILE = 128
DRYRUN_CELLS = (("qwen2.5-32b", "train_4k"), ("starcoder2-7b",
                                              "decode_32k"))
# the large_tiles phase (after library): the gated GEMMs at the reference's
# large tiles, walked in K-chunks of a 64-wide sub-tile. (l1) spamm() at
# LIB_RATIOS[0] on the library's N = LIB_N ensemble at LT_LIB_TILES, f32,
# bf16 and int8, and a levels = LIB_LEVELS plan at the first; (l2)
# starcoder2-7b's w1 (4608 × 18432, divisible by 128, 256 and 512) frozen
# at LT_TILES for the 512-row prefill activation, each dtype at about half
# its tile products; (l3) the get-norm kernels at LT_NORM_TILES on w1 and
# the activation; (l4) spamm_bmm at LT_MOE_TILE on LT_MOE_SLICES slices of
# qwen2-moe's expert GEMM at LT_MOE_ROWS rows (the serving capacity of 64
# rows does not divide by 128); (l5) the bf16 and int8 work-list kernels at
# the tiles that are not multiples of 64: w1 frozen at LT_ODD_TILES (tiles
# dividing 4608 and 18432: 96 and 48 for the `wgmma` kernels, 32 and 16 for
# the `mma.sync` kernels) for the prefill activation zero-padded to the
# tile, and w2 frozen at LT_ODD_DECODE_TILE for a decode step (BATCH real
# rows in one row tile: 144 runs, 2 column slices). Plain versions at N =
# LIB_N run on the
# first row band of the plan only (rows 0 .. T, all of its runs)
LT_TILES = (128, 256, 512)
LT_LIB_TILES = (128, 256)
LT_NORM_TILES = (128, 256)
LT_MOE_TILE = 128
LT_MOE_SLICES, LT_MOE_ROWS = 8, 256
LT_W1_RATIO = 0.50
LT_ODD_TILES = (96, 48, 32, 16)
LT_ODD_DECODE_TILE = 32
# (l5)'s one (dtype, tile) whose prefill case sits on an open fault
# (ROADMAP.md C, frozen ≢ eager at a low-precision τ tie): a FrozenWeight
# rounds the requested τ to f32 before widening it, an eager plan after
# (as the reference's planners do), and at int8 tile 32 the median product
# as τ lies between two f32 values, so a product on the gate is kept by
# one plan only. That case takes its τ rounded to f32; every other check
# keeps the median product as it is
LT_ODD_F32_TAU = (("int8", 32),)


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


def time_ms_back_to_back(fn, calls=20, reps=5):
    """Median over `reps` of the CUDA-event time of `calls` back-to-back
    calls of fn(), per call: the wrapper's host cost overlaps the previous
    launch, so a kernel longer than it is timed on its own (time_ms puts
    the host cost of one call inside its event pair)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    times.sort()
    return times[len(times) // 2]


def reset_counts():
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import getnorm, spamm_mm

    getnorm.launches = getnorm.pool_launches = getnorm.quant_launches = 0
    getnorm.mxu_launches = getnorm.quant_mxu_launches = 0
    spamm_mm.launches = spamm_mm.dense_launches = 0
    spamm_mm.decode_launches = 0
    spamm_mm.bf16_launches = spamm_mm.int8_launches = 0
    spamm_mm.bf16_mma_sync_launches = spamm_mm.int8_mma_sync_launches = 0


def read_counts():
    """Every kernel's launch count: the f32 work-list split by kernel
    ("spamm_mm_worklist" the 64-row kernels', "spamm_mm_worklist_decode"
    the decode kernel's), the bf16 and int8 work-list wrappers' split by
    family, "spamm_mm_worklist_bf16" / "_int8" the `wgmma` kernels' and
    "..._mma_sync" the `mma.sync` kernels'."""
    from repro_torch.kernels import getnorm, spamm_mm

    return {"tile_norms": getnorm.launches,
            "spamm_mm_worklist": spamm_mm.launches,
            "spamm_mm_worklist_decode": spamm_mm.decode_launches,
            "spamm_mm_worklist_bf16": (spamm_mm.bf16_launches
                                       - spamm_mm.bf16_mma_sync_launches),
            "pool_norms": getnorm.pool_launches,
            "spamm_mm": spamm_mm.dense_launches,
            "tile_norms_quant": getnorm.quant_launches,
            "spamm_mm_worklist_int8": (spamm_mm.int8_launches
                                       - spamm_mm.int8_mma_sync_launches),
            "tile_norms_mxu": getnorm.mxu_launches,
            "tile_norms_quant_mxu": getnorm.quant_mxu_launches,
            "spamm_mm_worklist_bf16_mma_sync":
                spamm_mm.bf16_mma_sync_launches,
            "spamm_mm_worklist_int8_mma_sync":
                spamm_mm.int8_mma_sync_launches}


def host_ms(fn):
    """(result, host milliseconds) of fn(), ending in a device sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound_ms(nbytes, flops, peak=PEAK_F32_FLOP_S):
    """Least time for the work on an H100: the larger of bytes over HBM
    bandwidth and operations over the peak rate of their type (f32 on the
    CUDA cores unless `peak` says otherwise)."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def errors(got, want):
    d = (got.double() - want.double()).abs()
    scale = want.double().abs().max().clamp(min=1e-30)
    return float(d.max()), float(d.max() / scale)


def check_tile_norms(x, label, tile=TILE):
    import torch

    from repro_torch.kernels import getnorm

    t = tile
    m, k = x.shape
    got = getnorm.tile_norms_cuda(x, t)
    want = getnorm.tile_norms_plain(x, t)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    abs_err = float((got - want).abs().max())
    check(rel <= NORM_RTOL, f"tile_norms {label}: max rel err {rel}")
    x4 = x.view(m // t, t, k // t, t)
    bms, by = bound_ms(m * k * 4 + (m // t) * (k // t) * 4, 2 * m * k)
    res = {
        "name": "tile_norms", "shape": label, "max_abs_err": abs_err,
        "max_rel_err": rel,
        "ms": time_ms(lambda: getnorm.tile_norms_cuda(x, t)),
        "ms_back_to_back": time_ms_back_to_back(
            lambda: getnorm.tile_norms_cuda(x, t)),
        "plain_ms": time_ms(lambda: getnorm.tile_norms_plain(x, t), reps=5),
        "library_ms": time_ms(
            lambda: torch.linalg.vector_norm(x4, dim=(1, 3))),
        "bound_ms": bms, "bound_by": by,
    }
    emit({"kernel_check": res})
    return res


def worklist_work(work, tile, block_n, itemsize=4):
    """(flops, ACC steps, bytes) the work-list needs: 2·t³ per ACC step;
    each A and B tile the ACC steps touch read once at `itemsize` bytes per
    element, the step tables read once (the caller adds the output)."""
    import torch

    acc = (work.step_flags & 2) != 0
    si, sj, sk = (t[acc].long() for t in (work.step_i, work.step_j,
                                          work.step_k))
    n_acc = int(acc.sum())
    a_tiles = int(torch.unique(si * 1_000_003 + sk).numel())
    b_tiles = int(torch.unique(sk * 1_000_003 + sj).numel())
    flops = 2 * tile ** 3 * block_n * n_acc
    tables = 4 * work.step_i.numel() * 4 + work.runs.numel() * 4
    return flops, n_acc, ((a_tiles * tile * tile
                           + b_tiles * tile * tile * block_n) * itemsize
                          + tables)


def kernel_name(geometry, dtype):
    """The work-list kernel a launch of `geometry` ran at operand type
    `dtype` ("float32", "bfloat16", "int8"): the f32 decode kernel of
    spamm_decode.cu by row block and width, `wgmma` ones of spamm_wgmma.cu
    by width and whether the tile is not a multiple of 64, the others of
    spamm_mm.cu by sub-tile, slices and (f32) whether the tile is walked in
    K-chunks."""
    dt = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}[dtype]
    if geometry["mma"] == "fma_decode":
        return (f"spamm_worklist_f32_decode_kernel<{geometry['row_block']}, "
                f"{geometry['width']}>")
    if geometry["mma"] == "wgmma":
        odd = str(geometry["last_band_rows"] > 0).lower()
        return f"spamm_worklist_{dt}_wgmma_kernel<{geometry['width']}, {odd}>"
    chunked = (f", {str(geometry['row_bands'] > 1).lower()}"
               if dt == "f32" else "")
    return (f"spamm_worklist_{dt}_kernel<{geometry['sub_tile']}, "
            f"{geometry['column_slices']}{chunked}>")


def check_worklist(a, b, p, label):
    import torch

    from repro_torch.kernels import spamm_mm

    w = p.work
    args = (a, b, w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
    got = spamm_mm.spamm_mm_worklist_cuda(*args, tile=TILE)
    geometry = dict(spamm_mm.last_geometry)
    want = spamm_mm.spamm_mm_worklist_plain(*args, tile=TILE)
    torch.cuda.synchronize()
    abs_err, rel = errors(got, want)
    check(rel <= MM_RTOL, f"spamm_mm_worklist {label}: max rel err {rel}")
    flops, n_acc, nbytes = worklist_work(w, TILE, 1)
    nbytes += a.shape[0] * b.shape[1] * 4
    bms, by = bound_ms(nbytes, flops)
    res = {
        "name": "spamm_mm_worklist", "shape": label,
        "kernel": kernel_name(geometry, "float32"), "mma": geometry["mma"],
        "valid_fraction": float(p.valid_fraction), "acc_steps": n_acc,
        "steps": int(w.step_i.numel()), "runs": int(w.runs.numel() - 1),
        "geometry": geometry, "max_abs_err": abs_err, "max_rel_err": rel,
        "ms": time_ms(lambda: spamm_mm.spamm_mm_worklist_cuda(*args,
                                                              tile=TILE)),
        "plain_ms": time_ms(
            lambda: spamm_mm.spamm_mm_worklist_plain(*args, tile=TILE),
            reps=3, warmup=1),
        "library_ms": time_ms(lambda: torch.matmul(a, b)),
        "bound_ms": bms, "bound_by": by,
    }
    emit({"kernel_check": res})
    return res


def median_product_tau(na, nb):
    """The (lower) median of the norm products na[i,k]·nb[k,j] over all
    (i, j, k): a τ that keeps about half of the tile products."""
    return float((na[:, None, :] * nb.T[None]).flatten().median())


def check_frozen(x, w, label):
    """The frozen plan of `w` for x's row grid at τ = the median norm
    product: the work-list kernel against its plain version, and frozen ≡
    eager bit for bit (same active steps, same kernel, same k order)."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.kernels import getnorm
    from repro_torch.plans.frozen import FrozenWeight

    tau = median_product_tau(getnorm.tile_norms_cuda(x, TILE),
                             getnorm.tile_norms_cuda(w, TILE))
    fw = FrozenWeight.build(w, tau, tile=TILE, backend="cuda")
    frozen = P.plan(x, frozen_weight=fw.for_rows(x.shape[0] // TILE))
    vf = float(frozen.valid_fraction)
    check(0.0 < vf < 1.0, f"{label}: frozen plan keeps all or nothing ({vf})")
    res = check_worklist(x, w, frozen, label)
    eager = P.plan(x, w, tau, tile=TILE, backend="cuda")
    same = torch.equal(P.execute(frozen, x, w), P.execute(eager, x, w))
    emit({"frozen_equals_eager": {"shape": label, "bit_identical": same,
                                  "tau": tau, "valid_fraction": vf,
                                  "eager_valid_tiles": int(eager.valid_tiles),
                                  "frozen_valid_tiles":
                                      int(frozen.valid_tiles)}})
    check(same, f"{label}: frozen and eager plans differ")
    return res


def decode_work(work, rows, k, n, tile=TILE):
    """(flops, ACC steps, bytes) of a work-list call at `rows` live rows:
    2·rows·t² per ACC step; each B tile the ACC steps touch, the live rows
    of A and of the output, and the step tables, once each."""
    import torch

    acc = (work.step_flags & 2) != 0
    sj, sk = (t[acc].long() for t in (work.step_j, work.step_k))
    n_acc = int(acc.sum())
    b_tiles = int(torch.unique(sk * 1_000_003 + sj).numel())
    tables = 4 * work.step_i.numel() * 4 + work.runs.numel() * 4
    return (2 * rows * tile * tile * n_acc, n_acc,
            b_tiles * tile * tile * 4 + rows * (k + n) * 4 + tables)


def check_decode(x, w, rows, label):
    """The f32 decode kernel at `rows` live rows of x (its other rows
    zeroed) on the frozen plan of `w` at the median norm product: on the
    live rows bit for bit the 64-row kernel on every row, within MM_RTOL
    of its plain version, "fma_decode"; timed single, back to back and by
    device (a CUDA graph of 20 calls, `ablate_wgmma.graph_ms`) beside the
    64-row kernel's device time and `torch.matmul` at the live and the
    padded rows."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.kernels import getnorm, spamm_mm
    from repro_torch.launch.ablate_wgmma import graph_ms
    from repro_torch.plans.frozen import FrozenWeight

    x = x.clone()
    x[rows:] = 0.0
    tau = median_product_tau(getnorm.tile_norms_cuda(x, TILE),
                             getnorm.tile_norms_cuda(w, TILE))
    fw = FrozenWeight.build(w, tau, tile=TILE, backend="cuda")
    p = P.plan(x, frozen_weight=fw.for_rows(x.shape[0] // TILE))
    wk = p.work
    args = (x, w, wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs)

    def call():
        return spamm_mm.spamm_mm_worklist_cuda(*args, tile=TILE, rows=rows)

    got = call()
    geometry = dict(spamm_mm.last_geometry)
    every_row = spamm_mm.spamm_mm_worklist_cuda(*args, tile=TILE)
    want = spamm_mm.spamm_mm_worklist_plain(*args, tile=TILE, rows=rows)
    torch.cuda.synchronize()
    same = bool(torch.equal(got[:rows], every_row[:rows])
                and not got[rows:].any())
    abs_err, rel = errors(got, want)
    check(geometry["mma"] == "fma_decode",
          f"decode {label}: ran {geometry['mma']}")
    check(same, f"decode {label}: live rows differ from the 64-row kernel")
    check(rel <= MM_RTOL, f"decode {label}: max rel err {rel}")
    flops, n_acc, nbytes = decode_work(wk, rows, w.shape[0], w.shape[1])
    bms, by = bound_ms(nbytes, flops)
    xr = x[:rows].contiguous()
    res = {
        "name": "spamm_mm_worklist_decode", "shape": label, "rows": rows,
        "kernel": kernel_name(geometry, "float32"), "mma": geometry["mma"],
        "valid_fraction": float(p.valid_fraction), "acc_steps": n_acc,
        "geometry": geometry, "bit_identical_to_64_row_kernel": same,
        "max_abs_err": abs_err, "max_rel_err": rel,
        "ms": time_ms(call), "ms_back_to_back": time_ms_back_to_back(call),
        "device_ms": graph_ms(call),
        "device_ms_64_row_kernel": graph_ms(
            lambda: spamm_mm.spamm_mm_worklist_cuda(*args, tile=TILE)),
        "plain_ms": time_ms(
            lambda: spamm_mm.spamm_mm_worklist_plain(*args, tile=TILE,
                                                     rows=rows),
            reps=3, warmup=1),
        "library_ms": time_ms(lambda: torch.matmul(xr, w)),
        "library_device_ms": graph_ms(lambda: torch.matmul(xr, w)),
        "library_64_rows_device_ms": graph_ms(lambda: torch.matmul(x, w)),
        "library_call": "torch.matmul f32 at the live rows",
        "bound_ms": bms, "bound_by": by,
    }
    emit({"kernel_check": res})
    return res


def check_tile_norms_quant(x, label, tile=TILE):
    """The fused int8 get-norm: bit for bit against the unfused composition
    on the card (quantize → dequantize → the f32 get-norm kernel; scales
    against the quantizer's), within NORM_RTOL of the plain composition.
    No single PyTorch call computes it: the yardstick is the unfused torch
    composition (quantize, dequantize, `vector_norm`)."""
    import torch

    from repro_torch.kernels import getnorm
    from repro_torch.kernels import quantize as Q

    t = tile
    m, k = x.shape
    norms, scales = getnorm.tile_norms_quant_cuda(x, t)
    q, s = Q.quantize_tiles(x, t)
    unfused = getnorm.tile_norms_cuda(Q.dequantize_tiles(q, s, t), t)
    pn, ps = getnorm.tile_norms_quant_plain(x, t)
    torch.cuda.synchronize()
    same_n, same_s = torch.equal(norms, unfused), torch.equal(scales, s)
    rel = float(((norms - pn).abs() / pn.abs().clamp(min=1e-30)).max())
    check(same_n and same_s and torch.equal(scales, ps) and rel <= NORM_RTOL,
          f"tile_norms_quant {label}: norms bit-identical {same_n}, scales "
          f"{same_s}, rel err to plain {rel}")

    def unfused_torch():
        dq = Q.dequantize_tiles(*Q.quantize_tiles(x, t), t)
        return torch.linalg.vector_norm(dq.view(m // t, t, k // t, t),
                                        dim=(1, 3))

    gm, gk = m // t, k // t
    # abs, max, divide, round, two clamps, multiply, square-add per element
    bms, by = bound_ms(m * k * 4 + 2 * gm * gk * 4, 9 * m * k)
    res = {"name": "tile_norms_quant", "shape": label,
           "max_abs_err": float((norms - pn).abs().max()),
           "max_rel_err": rel, "norms_bit_identical_to_unfused": same_n,
           "scales_bit_identical": same_s,
           "ms": time_ms(lambda: getnorm.tile_norms_quant_cuda(x, t)),
           "ms_back_to_back": time_ms_back_to_back(
               lambda: getnorm.tile_norms_quant_cuda(x, t)),
           "plain_ms": time_ms(lambda: getnorm.tile_norms_quant_plain(x, t),
                               reps=5),
           "library_ms": time_ms(unfused_torch),
           "library_call": "unfused torch composition: quantize_tiles, "
                           "dequantize_tiles, vector_norm",
           "bound_ms": bms, "bound_by": by}
    emit({"kernel_check": res})
    return res


def check_tile_norms_mxu(x, label, tile=TILE):
    """The tensor-core get-norm pair (use_mxu=True, paper Eq. 3-4) against
    their plain versions within NORM_RTOL (scales bit for bit), and fused ≡
    unfused bit for bit under use_mxu=True. Yardsticks: `vector_norm` for
    the tile norms, the unfused torch composition for the fused pair.
    Returns the two kernel_check results."""
    import torch

    from repro_torch.kernels import getnorm
    from repro_torch.kernels import quantize as Q

    t = tile
    m, k = x.shape
    gm, gk = m // t, k // t
    x4 = x.view(gm, t, gk, t)
    got = getnorm.tile_norms_cuda(x, t, use_mxu=True)
    want = getnorm.tile_norms_plain(x, t, use_mxu=True)
    norms, scales = getnorm.tile_norms_quant_cuda(x, t, use_mxu=True)
    q, s = Q.quantize_tiles(x, t)
    unfused = getnorm.tile_norms_cuda(Q.dequantize_tiles(q, s, t), t,
                                      use_mxu=True)
    pn, ps = getnorm.tile_norms_quant_plain(x, t, use_mxu=True)
    torch.cuda.synchronize()

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())

    rel_n, rel_q = rel(got, want), rel(norms, pn)
    same_n, same_s = torch.equal(norms, unfused), torch.equal(scales, s)
    check(rel_n <= NORM_RTOL and rel_q <= NORM_RTOL and same_n and same_s
          and torch.equal(scales, ps),
          f"use_mxu get-norm {label}: rel err {rel_n} / {rel_q}, fused ≡ "
          f"unfused {same_n}, scales {same_s}")

    def unfused_torch():
        dq = Q.dequantize_tiles(*Q.quantize_tiles(x, t), t)
        return torch.linalg.vector_norm(dq.view(gm, t, gk, t), dim=(1, 3))

    bms, by = bound_ms(m * k * 4 + gm * gk * 4, 2 * m * k)
    res = {"name": "tile_norms_mxu", "shape": label,
           "max_abs_err": float((got - want).abs().max()),
           "max_rel_err": rel_n,
           "ms": time_ms(lambda: getnorm.tile_norms_cuda(x, t, use_mxu=True)),
           "ms_back_to_back": time_ms_back_to_back(
               lambda: getnorm.tile_norms_cuda(x, t, use_mxu=True)),
           "plain_ms": time_ms(lambda: getnorm.tile_norms_plain(
               x, t, use_mxu=True), reps=5),
           "library_ms": time_ms(
               lambda: torch.linalg.vector_norm(x4, dim=(1, 3))),
           "library_call": "torch.linalg.vector_norm over the tile dims",
           "cuda_core_ms": time_ms(lambda: getnorm.tile_norms_cuda(x, t)),
           "bound_ms": bms, "bound_by": by}
    emit({"kernel_check": res})
    bms, by = bound_ms(m * k * 4 + 2 * gm * gk * 4, 9 * m * k)
    res_q = {"name": "tile_norms_quant_mxu", "shape": label,
             "max_abs_err": float((norms - pn).abs().max()),
             "max_rel_err": rel_q, "norms_bit_identical_to_unfused": same_n,
             "scales_bit_identical": same_s,
             "ms": time_ms(lambda: getnorm.tile_norms_quant_cuda(
                 x, t, use_mxu=True)),
             "ms_back_to_back": time_ms_back_to_back(
                 lambda: getnorm.tile_norms_quant_cuda(x, t, use_mxu=True)),
             "plain_ms": time_ms(lambda: getnorm.tile_norms_quant_plain(
                 x, t, use_mxu=True), reps=5),
             "library_ms": time_ms(unfused_torch),
             "library_call": "unfused torch composition: quantize_tiles, "
                             "dequantize_tiles, vector_norm",
             "cuda_core_ms": time_ms(lambda: getnorm.tile_norms_quant_cuda(
                 x, t)),
             "bound_ms": bms, "bound_by": by}
    emit({"kernel_check": res_q})
    return res, res_q


def lowp_median_tau(x, w, dtype, tile=TILE, f32=False):
    """A τ whose widened gate sits at the median of the norm products of
    the quantized operands, so that a `dtype` plan keeps about half of its
    tile products (the f32 median would keep nearly all of them at int8:
    the gate is widened by (1 − 64/254)² ≈ 0.56 at tile 64). At int8 and
    tiles ≥ 254 the widening is to 0 (`quantize.gate_eps` is 1): every τ
    keeps every tile, and the median product itself is returned. `f32`:
    the τ rounded to an f32 value (see LT_ODD_F32_TAU)."""
    import torch

    from repro_torch.kernels import getnorm
    from repro_torch.kernels import quantize as Q

    if dtype == "int8":
        na, nb = (getnorm.tile_norms_quant_cuda(t, tile)[0] for t in (x, w))
    else:
        na, nb = (getnorm.tile_norms_cuda(t.bfloat16().float(), tile)
                  for t in (x, w))
    eps = Q.gate_eps(dtype, tile)
    tau = median_product_tau(na, nb) / ((1.0 - eps) ** 2 if eps < 1 else 1)
    return float(torch.tensor(tau, dtype=torch.float32)) if f32 else tau


def check_int8_frozen(x, w, label, block_n=1, tile=TILE, f32_tau=False):
    """The frozen int8 plan of `w` for x's row grid at `lowp_median_tau`:
    the int8 work-list kernel bit for bit against its plain
    version and within INT8_DEQ_RTOL of the f32 kernel on the dequantized
    operands; frozen int8 ≡ eager int8 bit for bit. Times it against
    `torch._int_mm` on the same codes (the dense int8 product without the
    per-tile scales: a yardstick, never called by the port), with B
    row-major and column-major."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.kernels import getnorm, spamm_mm
    from repro_torch.kernels import quantize as Q
    from repro_torch.plans.frozen import FrozenWeight

    tau = lowp_median_tau(x, w, "int8", tile, f32=f32_tau)
    fw = FrozenWeight.build(w, tau, tile=tile, block_n=block_n,
                            backend="cuda", compute_dtype="int8")
    frozen = P.plan(x, frozen_weight=fw.for_rows(x.shape[0] // tile))
    vf = float(frozen.valid_fraction)
    check(0.0 < vf < 1.0, f"{label}: int8 frozen plan keeps all or nothing "
          f"({vf})")
    wk = frozen.work
    a_q, a_s = Q.quantize_tiles(x, tile, scales=frozen.a_scale)
    b_q, b_s = Q.quantize_tiles(w, tile, scales=frozen.b_scale)
    tables = (wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs)
    args = (a_q, b_q, a_s, b_s, *tables)
    kw = {"tile": tile, "block_n": block_n}
    got = spamm_mm.spamm_mm_worklist_int8_cuda(*args, **kw)
    geometry = dict(spamm_mm.last_geometry)
    want = spamm_mm.spamm_mm_worklist_int8_plain(*args, **kw)
    f32 = spamm_mm.spamm_mm_worklist_cuda(Q.dequantize_tiles(a_q, a_s, tile),
                                          Q.dequantize_tiles(b_q, b_s, tile),
                                          *tables, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    abs_err, rel = errors(got, f32)
    eager = P.plan(x, w, tau, tile=tile, block_n=block_n, backend="cuda",
                   compute_dtype="int8")
    same_fe = torch.equal(P.execute(frozen, x, w), P.execute(eager, x, w))
    emit({"frozen_equals_eager": {"shape": label, "dtype": "int8",
                                  "block_n": block_n, "bit_identical": same_fe,
                                  "tau": tau, "gate_tau": frozen.tau,
                                  "valid_fraction": vf}})
    check(same and rel <= INT8_DEQ_RTOL and same_fe,
          f"spamm_mm_worklist_int8 {label}: plain bit-identical {same}, rel "
          f"err to f32 on dequantized {rel}, frozen ≡ eager {same_fe}")
    flops, n_acc, nbytes = worklist_work(wk, tile, block_n, itemsize=1)
    nbytes += got.numel() * 4 + (a_s.numel() + b_s.numel()) * 4
    bms, by = bound_ms(nbytes, flops, PEAK_INT8_OP_S)
    b_cm = b_q.t().contiguous().t()
    res = {"name": "spamm_mm_worklist_int8", "shape": label, "tile": tile,
           "kernel": kernel_name(geometry, "int8"), "mma": geometry["mma"],
           "block_n": block_n, "valid_fraction": vf, "acc_steps": n_acc,
           "geometry": geometry,
           "max_abs_err": 0.0 if same else float((got - want).abs().max()),
           "bit_identical_to_plain": same,
           "max_abs_err_vs_f32_dequantized": abs_err,
           "max_rel_err_vs_f32_dequantized": rel,
           "ms": time_ms(lambda: spamm_mm.spamm_mm_worklist_int8_cuda(*args,
                                                                     **kw)),
           "ms_back_to_back": time_ms_back_to_back(
               lambda: spamm_mm.spamm_mm_worklist_int8_cuda(*args, **kw)),
           "plain_ms": time_ms(
               lambda: spamm_mm.spamm_mm_worklist_int8_plain(*args, **kw),
               reps=3, warmup=1),
           "library_ms": time_ms(lambda: torch._int_mm(a_q, b_q)),
           "library_call": "torch._int_mm on the int8 codes (dense, no "
                           "scales)",
           "library_colmajor_b_ms": time_ms(lambda: torch._int_mm(a_q, b_cm)),
           "bound_ms": bms, "bound_by": by,
           "bound_bytes_ms": nbytes / PEAK_BYTES_S * 1e3,
           "bound_ops_ms": flops / PEAK_INT8_OP_S * 1e3}
    emit({"kernel_check": res})
    return res


def check_bf16_frozen(x, w, label, tile=TILE):
    """The frozen bf16 plan of `w` at `lowp_median_tau`: the bf16
    work-list kernel (tensor cores) within MM_RTOL of the output's
    magnitude against the f32 kernel on the bf16-rounded operands and
    against its plain version, two launches equal (determinism); frozen
    bf16 ≡ eager bf16 bit for bit."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.kernels import spamm_mm
    from repro_torch.plans.frozen import FrozenWeight

    tau = lowp_median_tau(x, w, "bfloat16", tile)
    fw = FrozenWeight.build(w, tau, tile=tile, backend="cuda",
                            compute_dtype="bfloat16")
    frozen = P.plan(x, frozen_weight=fw.for_rows(x.shape[0] // tile))
    vf = float(frozen.valid_fraction)
    check(0.0 < vf < 1.0, f"{label}: bf16 frozen plan keeps all or nothing "
          f"({vf})")
    wk = frozen.work
    xb, wb = x.bfloat16(), w.bfloat16()
    tables = (wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs)
    got = spamm_mm.spamm_mm_worklist_cuda(xb, wb, *tables, tile=tile)
    geometry = dict(spamm_mm.last_geometry)
    again = spamm_mm.spamm_mm_worklist_cuda(xb, wb, *tables, tile=tile)
    f32 = spamm_mm.spamm_mm_worklist_cuda(xb.float(), wb.float(), *tables,
                                          tile=tile)
    want = spamm_mm.spamm_mm_worklist_plain(xb, wb, *tables, tile=tile)
    torch.cuda.synchronize()
    deterministic = torch.equal(got, again)
    abs_err, rel = errors(got, want)
    abs32, rel32 = errors(got, f32)
    eager = P.plan(x, w, tau, tile=tile, backend="cuda",
                   compute_dtype="bfloat16")
    same_fe = torch.equal(P.execute(frozen, x, w), P.execute(eager, x, w))
    emit({"frozen_equals_eager": {"shape": label, "dtype": "bfloat16",
                                  "bit_identical": same_fe, "tau": tau,
                                  "gate_tau": frozen.tau,
                                  "valid_fraction": vf}})
    check(rel <= MM_RTOL and rel32 <= MM_RTOL and deterministic and same_fe,
          f"spamm_mm_worklist bf16 {label}: rel err to plain {rel}, to f32 "
          f"on rounded {rel32}, deterministic {deterministic}, frozen ≡ "
          f"eager {same_fe}")
    flops, n_acc, nbytes = worklist_work(wk, tile, 1, itemsize=2)
    nbytes += got.numel() * 4
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
    res = {"name": "spamm_mm_worklist_bf16", "shape": label, "tile": tile,
           "kernel": kernel_name(geometry, "bfloat16"),
           "mma": geometry["mma"],
           "valid_fraction": vf, "acc_steps": n_acc, "geometry": geometry,
           "max_abs_err": abs_err, "max_rel_err": rel,
           "max_abs_err_vs_f32_on_rounded": abs32,
           "max_rel_err_vs_f32_on_rounded": rel32,
           "tolerance_rel": MM_RTOL, "deterministic": deterministic,
           "ms": time_ms(lambda: spamm_mm.spamm_mm_worklist_cuda(
               xb, wb, *tables, tile=tile)),
           "ms_back_to_back": time_ms_back_to_back(
               lambda: spamm_mm.spamm_mm_worklist_cuda(xb, wb, *tables,
                                                       tile=tile)),
           "plain_ms": time_ms(lambda: spamm_mm.spamm_mm_worklist_plain(
               xb, wb, *tables, tile=tile), reps=3, warmup=1),
           "library_ms": time_ms(lambda: torch.matmul(xb, wb)),
           "library_call": "torch.matmul on the bf16 operands (dense, bf16 "
                           "out)",
           "bound_ms": bms, "bound_by": by}
    emit({"kernel_check": res})
    return res


def int8_sass():
    """Opcode counts of the tensor-core work-list kernels in the built
    libraries' SASS (`cuobjdump -sass`): the `wgmma` kernels of
    spamm_wgmma.cu (tiles from 48) must run the int8 product on IGMMA and
    the bf16 one on HGMMA, the `mma.sync` kernels of spamm_mm.cu (tiles 16
    and 32) the int8 one on IMMA and the bf16 one on HMMA, and neither
    library may hold a CUDA-core dot (IDP4A)."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    rows = {"wgmma_int8": ("spamm_wgmma.cu",
                           "spamm_worklist_int8_wgmma_kernel", "IGMMA"),
            "wgmma_bf16": ("spamm_wgmma.cu",
                           "spamm_worklist_bf16_wgmma_kernel", "HGMMA"),
            "mma_sync_int8": ("spamm_mm.cu", "spamm_worklist_int8_kernel",
                              "IMMA"),
            "mma_sync_bf16": ("spamm_mm.cu", "spamm_worklist_bf16_kernel",
                              "HMMA")}
    counts, idp4a = {}, 0
    for source in ("spamm_wgmma.cu", "spamm_mm.cu"):
        lines = subprocess.run(
            [tool, "-sass", str(build.library_path(source))],
            capture_output=True, text=True, check=True).stdout.splitlines()
        idp4a += sum(" IDP4A" in ln for ln in lines)
        for row, (src, kernel, op) in rows.items():
            if src != source:
                continue
            c, fn = {"functions": 0, op: 0}, ""
            for line in lines:
                if "Function :" in line:
                    fn = line.split("Function :")[1].strip()
                    c["functions"] += kernel in fn
                elif kernel in fn:
                    c[op] += f" {op}." in line or f" {op} " in line
            counts[row] = c
    counts["IDP4A_in_libraries"] = idp4a
    emit({"int8_sass": counts})
    check(all(c["functions"] > 0 and c[op] > 0
              for row, (_, _, op) in rows.items()
              for c in [counts[row]]) and idp4a == 0,
          f"tensor-core work-list SASS: {counts}")
    return counts


def mxu_sass():
    """Opcode counts of the tensor-core get-norm kernels in the built
    library's SASS: every one of them (templated and runtime-tile, f32 and
    int8) must sum on the tensor cores (HMMA with TF32 operands), and each
    templated int8 kernel must load no more than the f32 kernel of the same
    tile and load path (it takes its tile from registers: one read)."""
    import re

    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(
        "getnorm.cu"))], capture_output=True, text=True, check=True).stdout
    kernels, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            m = re.search(r"(tile_norms(?:_quant)?_mxu(?:_any)?_f32_kernel)"
                          r"(?:INS_8MxuShapeILi(\d+)ELb([01])E)?", name)
            fn = None
            if m:
                fn = m.group(1) + (f"<{m.group(2)}, vec={m.group(3)}>"
                                   if m.group(2) else "")
                kernels[fn] = {"HMMA_TF32": 0, "loads": 0}
        elif fn:
            kernels[fn]["HMMA_TF32"] += " HMMA." in line and "TF32" in line
            kernels[fn]["loads"] += bool(re.search(r"\s(LDG|LD)\.", line))
    pairs = {k: (v["loads"], kernels.get(k.replace("_mxu_", "_quant_mxu_"),
                                         {}).get("loads"))
             for k, v in kernels.items()
             if k.startswith("tile_norms_mxu_f32_kernel<")}
    emit({"mxu_sass": {"kernels": kernels,
                       "templated_loads_f32_int8": pairs}})
    check(len(kernels) == 14 and all(v["HMMA_TF32"] > 0
                                     for v in kernels.values())
          and len(pairs) == 6
          and all(q is not None and q <= f for f, q in pairs.values()),
          f"tensor-core get-norm SASS: {kernels}")
    return kernels


def launch_floor_ms(calls=100):
    """Device time of one launch of an empty kernel (`getnorm.cu`'s
    launch_floor_kernel), from the profiler: the floor that the get-norm
    kernels' device times at the decode and pooling shapes sit on."""
    import ctypes

    import torch

    from repro_torch.kernels import getnorm

    fn = getnorm._lib().spamm_launch_floor
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        rc = fn(torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()))
        check(rc == 0, f"empty kernel launch failed: CUDA error {rc}")

    ms = kernel_device_ms(launch, "launch_floor_kernel", calls)
    emit({"launch_floor_ms": ms, "calls": calls})
    return ms


def mxu_device_times(x, label, tiles, calls=100):
    """Device time of one launch of each tensor-core get-norm kernel on x at
    each tile of `tiles`, from the profiler, beside its CUDA-core twin and
    the bytes bound (x read once, the normmap(s) written once)."""
    from repro_torch.kernels import getnorm

    m, k = x.shape
    out = {}
    for t in tiles:
        nm = (m // t) * (k // t) * 4
        rows = {
            "tile_norms_mxu": (lambda: getnorm.tile_norms_cuda(
                x, t, use_mxu=True), "tile_norms_mxu_f32_kernel", 1),
            "tile_norms_quant_mxu": (lambda: getnorm.tile_norms_quant_cuda(
                x, t, use_mxu=True), "tile_norms_quant_mxu_f32_kernel", 2),
            "tile_norms": (lambda: getnorm.tile_norms_cuda(x, t),
                           "tile_norms_f32_kernel", 1),
            "tile_norms_quant": (lambda: getnorm.tile_norms_quant_cuda(x, t),
                                 "tile_norms_quant_f32_kernel", 2),
        }
        out[t] = {name: {"device_ms": kernel_device_ms(fn, kernel, calls),
                         "bound_ms": bound_ms(m * k * 4 + maps * nm,
                                              2 * m * k)[0]}
                  for name, (fn, kernel, maps) in rows.items()}
    emit({"mxu_device": {"shape": label, "calls": calls, "tiles": out}})
    return out


def getnorm_device_times(x, label, calls=100, reps=5):
    """Device time of one launch of each get-norm kernel on x (the pooling
    kernel on x's normmap), from the profiler over `calls` back-to-back
    calls, beside the wrapper's host cost per call (the median over `reps`
    runs of the host clock over `calls` calls, each before its closing
    sync) and the time per call by CUDA events around `calls` calls (the
    larger of the two)."""
    import torch

    from repro_torch.kernels import getnorm

    t = TILE
    nm = getnorm.tile_norms_cuda(x, t)
    rows = {
        "tile_norms": (lambda: getnorm.tile_norms_cuda(x, t),
                       "tile_norms_f32_kernel"),
        "tile_norms_mxu": (lambda: getnorm.tile_norms_cuda(x, t, use_mxu=True),
                           "tile_norms_mxu_f32_kernel"),
        "pool_norms": (lambda: getnorm.pool_norms_cuda(nm),
                       "pool_norms_f32_kernel"),
        "tile_norms_quant": (lambda: getnorm.tile_norms_quant_cuda(x, t),
                             "tile_norms_quant_f32_kernel"),
        "tile_norms_quant_mxu": (
            lambda: getnorm.tile_norms_quant_cuda(x, t, use_mxu=True),
            "tile_norms_quant_mxu_f32_kernel"),
    }
    out = {}
    for name, (fn, kernel) in rows.items():
        fn()
        hosts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(calls):
                fn()
            hosts.append((time.perf_counter() - t0) * 1e3 / calls)
            e1.record()
            e1.synchronize()
        hosts.sort()
        out[name] = {"device_ms": kernel_device_ms(fn, kernel, calls),
                     "host_ms_per_call": hosts[len(hosts) // 2],
                     "events_ms_per_call": e0.elapsed_time(e1) / calls}
    emit({"getnorm_device": {"shape": label,
                             "normmap": list(nm.shape), "calls": calls,
                             "kernels": out}})
    return out


def decode_rows(n_cols, gen):
    """A decode step's activation as the gated GEMMs see it: BATCH real
    rows, zero-padded to one row tile."""
    import torch

    x = torch.zeros(TILE, n_cols, device=DEV)
    x[:BATCH] = torch.randn(BATCH, n_cols, generator=gen, device=DEV)
    return x


def phase_kernels():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import plan as P
    from repro_torch.kernels import getnorm, spamm_mm

    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d, ff = cfg.d_model, cfg.d_ff
    w1 = torch.randn(d, ff, generator=gen, device=DEV).mul_(d ** -0.5)
    w2 = torch.randn(ff, d, generator=gen, device=DEV).mul_(ff ** -0.5)
    x = torch.randn(BATCH * PROMPT_LEN, d, generator=gen, device=DEV)
    check_tile_norms(w1, f"w1 {d}x{ff}")
    norms_act = check_tile_norms(x, f"activation {BATCH * PROMPT_LEN}x{d}")

    # (a) frozen plans of the MLP weights at the serving shapes: w1 for a
    # 512-row prefill, then w1 and w2 for a decode step (one row tile, 8 and
    # 72 runs of 72 and 288 steps)
    mm_w1 = check_frozen(x, w1, f"frozen w1 {x.shape[0]}x{d}x{ff}")
    check_frozen(decode_rows(d, gen), w1,
                 f"frozen w1 decode {TILE}({BATCH})x{d}x{ff}")
    check_frozen(decode_rows(ff, gen), w2,
                 f"frozen w2 decode {TILE}({BATCH})x{ff}x{d}")
    # the decode kernel at the same shapes: BATCH live rows (run (c)'s
    # decode steps), then 1 and DECODE_MAX_ROWS
    decode = {}
    for rows in (BATCH, 1, spamm_mm.DECODE_MAX_ROWS):
        for name, x_d, w_d, n_in, n_out in (("w1", decode_rows(d, gen), w1,
                                             d, ff),
                                            ("w2", decode_rows(ff, gen), w2,
                                             ff, d)):
            x_d[BATCH:] = torch.randn(TILE - BATCH, n_in, generator=gen,
                                      device=DEV)
            decode.setdefault(name, []).append(check_decode(
                x_d, w_d, rows, f"frozen {name} decode {TILE}({rows})x{n_in}"
                                f"x{n_out}"))

    # (b) the low-precision kernels at the same shapes: the fused int8
    # get-norm on the activation and w1; the int8 work-list on frozen w1 at
    # prefill and decode shapes, block_n 1 and 2; the bf16 work-list
    lowp = {"quant": check_tile_norms_quant(
        x, f"activation {BATCH * PROMPT_LEN}x{d}")}
    check_tile_norms_quant(w1, f"w1 {d}x{ff}")
    # the tensor-core get-norm pair at the same two shapes; the store path
    # runs it on the weights, so the w1 results go into the kernels line
    check_tile_norms_mxu(x, f"activation {BATCH * PROMPT_LEN}x{d}")
    lowp["mxu"] = check_tile_norms_mxu(w1, f"w1 {d}x{ff}")
    xd, xd2 = decode_rows(d, gen), decode_rows(ff, gen)
    for block_n in (1, 2):
        res = check_int8_frozen(x, w1, f"frozen w1 {x.shape[0]}x{d}x{ff}",
                                block_n)
        lowp.setdefault("int8", res)
        check_int8_frozen(xd, w1, f"frozen w1 decode {TILE}({BATCH})x{d}x"
                          f"{ff}", block_n)
        check_int8_frozen(xd2, w2, f"frozen w2 decode {TILE}({BATCH})x{ff}x"
                          f"{d}", block_n)
    lowp["bf16"] = check_bf16_frozen(x, w1,
                                     f"frozen w1 {x.shape[0]}x{d}x{ff}")
    check_bf16_frozen(xd, w1, f"frozen w1 decode {TILE}({BATCH})x{d}x{ff}")
    check_bf16_frozen(xd2, w2, f"frozen w2 decode {TILE}({BATCH})x{ff}x{d}")
    # device time of the get-norm kernels at the activation shapes the
    # serving path hands them (prefill and decode) and at the weight shape
    # a freeze hands them
    getnorm_device_times(x, f"activation {BATCH * PROMPT_LEN}x{d}")
    getnorm_device_times(xd, f"decode activation {TILE}({BATCH})x{d}")
    getnorm_device_times(w1, f"w1 {d}x{ff}")
    # the tensor-core pair at the packed tiles, and the launch floor the
    # decode-shape device times are read against
    mxu_device_times(x, f"activation {BATCH * PROMPT_LEN}x{d}", (16, 32))
    launch_floor_ms()
    del xd, xd2

    # (c) the paper's synthetic: exponential-decay matrices,
    # |a_ij| = lam^|i-j| · U(0.5, 1), random signs
    n, lam = DECAY_N, DECAY_LAM
    idx = torch.arange(n, device=DEV, dtype=torch.float32)
    dist = (idx[:, None] - idx[None, :]).abs()

    def decay():
        mag = lam ** dist * (0.5 + 0.5 * torch.rand(n, n, generator=gen,
                                                    device=DEV))
        sign = torch.randint(0, 2, (n, n), generator=gen, device=DEV) * 2 - 1
        return (mag * sign).contiguous()

    a, b = decay(), decay()
    tau_d = median_product_tau(getnorm.tile_norms_cuda(a, TILE),
                               getnorm.tile_norms_cuda(b, TILE))
    pd = P.plan(a, b, tau_d, tile=TILE, backend="cuda")
    vfd = float(pd.valid_fraction)
    check(0.2 < vfd < 0.8, f"exp-decay valid fraction {vfd} outside (0.2, 0.8)")
    check_worklist(a, b, pd, f"exp-decay {n}x{n}x{n} lam={lam}")
    del w1, w2, x, a, b, pd
    torch.cuda.empty_cache()
    return norms_act, mm_w1, lowp, decode


def run_engine(cfg, pcfg, params, prompts, spamm_cfg, label):
    """Warm wave (freezes plans, first kernel calls), then the measured
    wave with every launch counter set to 0 just before it. Returns
    (engine, tokens, measured request metadata, launch counts)."""
    import numpy as np

    from repro_torch.serving.engine import Engine, Request

    eng = Engine(cfg, pcfg, params, max_len=MAX_LEN, spamm_cfg=spamm_cfg)

    def wave():
        reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
        t0 = time.perf_counter()
        toks = np.stack(eng.generate(reqs))
        dt = time.perf_counter() - t0
        return toks, reqs[0].out, dt

    _, cold, cold_s = wave()
    reset_counts()
    toks, out, dt = wave()
    counts = read_counts()
    lat, sp = out["latency"], out["spamm"] or {}
    emit({"serve": label, "tok_per_s": toks.size / dt, "wave_s": dt,
          "ttft_ms": lat["ttft_s"] * 1e3,
          "decode_ms_per_step": (lat["decode_mean_s"] or 0.0) * 1e3,
          "decode_steps": lat["decode_steps"],
          "cold_wave_s": cold_s, "cold_ttft_ms": cold["latency"]["ttft_s"] * 1e3,
          "prefill_valid_fraction": sp.get("valid_fraction"),
          "decode_valid_fraction": sp.get("decode_valid_fraction"),
          "gated_gemms": sp.get("gated_gemms"),
          "decode_gated_gemms": sp.get("decode_gated_gemms"),
          "compute_dtype": sp.get("compute_dtype"),
          "gemm_bytes_moved": sp.get("gemm_bytes_moved"),
          "decode_gemm_bytes_moved": sp.get("decode_gemm_bytes_moved"),
          "launches": counts, "tokens_req0": toks[0].tolist(),
          "step_keys": dict(eng.trace_counts), "graphs": eng.graph_stats()})
    profile_wave(label, eng, prompts)
    return eng, toks, out, counts


def replay_profile(g, reps=20):
    """A captured graph replayed `reps` times back to back: CUDA-event ms
    per replay, the profiler's kernel ms and its count of device nodes
    (kernels, copies, fills) per replay, and the kernel ms per replay of
    the f32 work-list's 64-row and decode kernels, the get-norm kernels
    and the rest (`by_kernel`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(reps):
            g.replay()

    ms = time_ms(run, reps=5, warmup=1) / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    parts = {"worklist_f32": "spamm_worklist_f32_kernel",
             "worklist_f32_decode": "spamm_worklist_f32_decode_kernel",
             "tile_norms": "tile_norms"}
    by = dict.fromkeys((*parts, "rest"), 0.0)
    for e in dev:
        part = next((p for p, key in parts.items() if key in e.key), "rest")
        by[part] += e.self_device_time_total / 1e3 / reps
    return {"ms": ms, "kernel_ms": sum(by.values()),
            "nodes": sum(e.count for e in dev) / reps, "by_kernel": by}


def graph_breakdown(eng, params, label, reps=20):
    """Where a graphed decode step's time goes, from graphs replayed back
    to back (no host in the way): the wave's captured decode step of run
    `label`; the frozen gate alone (`core.plan._plan_frozen`: get-norm plus
    the gate's small ops) of each of layer 0's six gated GEMMs on a decode
    activation of BATCH rows, summed over the layers as the gate's share
    of a step; and layer-0 w1's whole gated GEMM on BATCH rows (the
    decode kernel). Per replay: CUDA-event ms, the profiler's kernel ms
    and its count of device nodes (kernels, copies, fills); the gap
    between the two times is the device idling between nodes. Eager ms
    per call beside each. The decode step's kernel ms also split by
    kernel: the f32 work-list kernels (64-row and decode), the get-norm,
    the rest (`by_kernel`)."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.core.module import spamm_linear_frozen

    def captured(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        return g

    step = eng._steps[(("wave", BATCH), True)]
    res = {"run": label, "decode_step": {**replay_profile(step._graph, reps),
                                         "graph_nodes": step.nodes()},
           "gates": {}}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    frozen = eng._frozen_for(BATCH)["layers"][0]
    with torch.inference_mode():
        for part, site in (("mix", "wq"), ("mix", "wk"), ("mix", "wv"),
                           ("mix", "wo"), ("mlp", "w1"), ("mlp", "w2")):
            w = params["layers"][0][part][site]
            x = decode_rows(w.shape[0], gen)
            fp = frozen[part][site]
            gate = lambda: P._plan_frozen(x, fp)   # noqa: E731
            res["gates"][site] = replay_profile(captured(gate), reps)
            res["gates"][site]["eager_ms"] = time_ms(gate, reps=20, warmup=2)
            if site == "w1":
                # the engine's activation: BATCH rows, padded inside
                xb = x[:BATCH].contiguous()
                gemm = lambda: spamm_linear_frozen(xb, w, fp)  # noqa: E731
                res["gated_gemm_w1"] = replay_profile(captured(gemm), reps)
                res["gated_gemm_w1"]["eager_ms"] = time_ms(gemm, reps=20,
                                                           warmup=2)
    layers = len(params["layers"])
    res["frozen_gates_per_step"] = {
        k: layers * sum(g[k] for g in res["gates"].values())
        for k in ("ms", "kernel_ms", "nodes")}
    emit({"graph_breakdown": res})
    return res


def logged_wave(eng, prompts, max_new):
    """One wave with the logits of every decode and chunk step kept, and
    every launch count set to 0 just before it: (tokens, step logits,
    request 0's metadata, launch counts, wave seconds)."""
    import numpy as np

    from repro_torch.serving import graphs as G
    from repro_torch.serving.engine import Request

    logits = []
    orig = G.StepGraph.__call__

    def logged(self, **values):
        out = orig(self, **values)
        logits.append(out["logits"].clone())
        return out

    G.StepGraph.__call__ = logged
    try:
        reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
        reset_counts()
        t0 = time.perf_counter()
        toks = [np.asarray(o) for o in eng.generate(reqs)]
        dt = time.perf_counter() - t0
        counts = read_counts()
    finally:
        G.StepGraph.__call__ = orig
    return toks, logits, reqs[0].out, counts, dt


def wave_numbers(toks, out, dt):
    lat = out["latency"]
    return {"tok_per_s": sum(len(t) for t in toks) / dt, "wave_s": dt,
            "ttft_ms": lat["ttft_s"] * 1e3,
            "decode_ms_per_step": (lat["decode_mean_s"] or 0.0) * 1e3,
            "decode_steps": lat["decode_steps"]}


def timing_free(sp):
    """A wave's spamm stats without its host-clock measurements: no
    latency block, and of the cost residual only the predicted seconds."""
    if sp is None:
        return None
    sp = {k: v for k, v in sp.items() if k != "latency"}
    if "cost_residual" in sp:
        sp["cost_residual"] = {ph: c["predicted_s"]
                               for ph, c in sp["cost_residual"].items()}
    return sp


def compare_graphed_eager(eng, prompts, label, max_new=MAX_NEW):
    """The same engine serves the wave as CUDA graphs and then eagerly
    (`cuda_graphs=False`, its own steps, the same frozen plans): tokens,
    the logits of every decode and chunk step and the spamm stats (per
    (layer, site) cells and predicted seconds included; not the host-clock
    times) must be equal bit for bit, and every launch count the same.
    Returns the comparison (the graphed wave's launches under
    "launches")."""
    import torch

    g = logged_wave(eng, prompts, max_new)
    eng.cuda_graphs = False
    try:
        e = logged_wave(eng, prompts, max_new)
    finally:
        eng.cuda_graphs = True
    res = {"run": label, "steps": len(g[1]),
           "tokens_equal": all(bool((a == b).all()) and a.shape == b.shape
                               for a, b in zip(g[0], e[0])),
           "step_logits_bit_identical": len(g[1]) == len(e[1]) and all(
               torch.equal(a, b) for a, b in zip(g[1], e[1])),
           "spamm_equal": (timing_free(g[2]["spamm"])
                           == timing_free(e[2]["spamm"])),
           "launches_equal": g[3] == e[3],
           "graphed": wave_numbers(g[0], g[2], g[4]),
           "eager": wave_numbers(e[0], e[2], e[4]),
           "launches": g[3]}
    emit({"graphed_vs_eager": res})
    check(res["steps"] > 0 and res["tokens_equal"]
          and res["step_logits_bit_identical"] and res["spamm_equal"]
          and res["launches_equal"],
          f"graphed and eager waves of run {label} differ: {res}")
    return res


def phase_obs(cfg, pcfg, params, eng, prompts, sct):
    """The observability plane on run (c): `eng` (obs on, graphed, warm)
    against an engine of the same params with obs=False that takes `eng`'s
    frozen weights (no second freeze). Tokens, step logits and launches
    bit for bit; the same device nodes per replayed decode step; per_layer
    with every (layer, site) cell, summing to the aggregates; a graphed
    wave's cells equal an eager wave's; the metrics dump through
    `parse_prometheus`; the trace's spans. Timed waves on, off, off, on,
    with the host ms of each wave's tap drain (`end_stats`) and stats
    (`_spamm_stats`: per_layer, cost residual and, with obs on, the
    registry feed)."""
    import numpy as np
    import torch

    from repro_torch.core.module import SpammContext
    from repro_torch.obs import parse_prometheus
    from repro_torch.serving.engine import Engine

    check(eng.obs.enabled and eng.cuda_graphs, "obs phase: engine of run (c)")
    off = Engine(cfg, pcfg, params, max_len=MAX_LEN, spamm_cfg=sct,
                 obs=False)
    off._fw_tree = eng._fw_tree
    logged_wave(off, prompts, MAX_NEW)                  # captures
    waves = {"on": [], "off": []}
    host = {n: {"end_stats_ms": [], "spamm_stats_ms": []}
            for n in ("on", "off")}

    def timed(cls, name, key):
        orig = getattr(cls, name)

        def wrapper(self, *a, **k):
            t0 = time.perf_counter()
            out = orig(self, *a, **k)
            which = "on" if self in (eng, eng.spamm_ctx) else "off"
            host[which][key].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(cls, name, wrapper)
        return orig

    origs = (timed(SpammContext, "end_stats", "end_stats_ms"),
             timed(Engine, "_spamm_stats", "spamm_stats_ms"))
    try:
        for name in ("on", "off", "off", "on"):
            waves[name].append(logged_wave(eng if name == "on" else off,
                                           prompts, MAX_NEW))
    finally:
        SpammContext.end_stats, Engine._spamm_stats = origs
    on, of = waves["on"][0], waves["off"][0]
    same_tokens = all(bool(np.array_equal(a, b)) for a, b in zip(on[0], of[0]))
    same_logits = len(on[1]) == len(of[1]) and all(
        torch.equal(a, b) for a, b in zip(on[1], of[1]))
    key = (("wave", BATCH), True)
    nodes = {n: e._steps[key].nodes() for n, e in (("on", eng), ("off", off))}
    sp, sp_off = on[2]["spamm"], of[2]["spamm"]
    cells = [(layer, site, c) for layer, sites in sp["per_layer"].items()
             for site, c in sites.items()]
    full = (sorted(sp["per_layer"]) == list(range(cfg.num_layers))
            and all(sorted(sites) == sorted(OBS_SITES)
                    for sites in sp["per_layer"].values()))
    sums = {
        "gated_gemms": sum(c["gated_gemms"] for *_, c in cells),
        "decode_gated_gemms": sum(c["decode_gated_gemms"] for *_, c in cells),
        "gemm_bytes": sum(c["gemm_bytes_moved"] or 0.0 for *_, c in cells)}
    total_bytes = sp["gemm_bytes_moved"] + sp["decode_gemm_bytes_moved"]
    sums_ok = (sums["gated_gemms"] == sp["gated_gemms"]
               and sums["decode_gated_gemms"] == sp["decode_gated_gemms"]
               and abs(sums["gemm_bytes"] - total_bytes)
               <= OBS_BYTES_RTOL * total_bytes)
    eng.cuda_graphs = False
    try:
        eager = logged_wave(eng, prompts, MAX_NEW)
    finally:
        eng.cuda_graphs = True
    eager_cells = eager[2]["spamm"]["per_layer"] == sp["per_layer"]
    os.makedirs(OBS_DIR, exist_ok=True)
    mpath = eng.obs.write_metrics(os.path.join(OBS_DIR, "metrics.prom"))
    tpath = eng.obs.write_trace(os.path.join(OBS_DIR, "trace.json"))
    text = open(mpath).read()
    parsed = parse_prometheus(text)
    reg = {m.name: m for m in eng.obs.registry.metrics()}
    gemm_samples = parsed["spamm_gated_gemms_total"]["samples"]
    round_trip = (set(parsed) == set(reg)
                  and len(gemm_samples)
                  == len(reg["spamm_gated_gemms_total"].series())
                  and sum(gemm_samples.values()) == sum(
                      reg["spamm_gated_gemms_total"].series().values())
                  and parsed["serve_waves_total"]["samples"][
                      "serve_waves_total"] == reg["serve_waves_total"].value())
    with open(tpath) as f:
        events = json.load(f)["traceEvents"]
    span_names = {e["name"] for e in events if e["ph"] == "X"}

    def numbers(ws):
        return {k: [wave_numbers(w[0], w[2], w[4])[k] for w in ws]
                for k in ("tok_per_s", "ttft_ms", "decode_ms_per_step")}

    res = {"card": CARD, "run": f"c: tau={sct.tau:.6g}",
           "on": numbers(waves["on"]), "off": numbers(waves["off"]),
           "host_ms": host,
           "tokens_equal": same_tokens,
           "step_logits_bit_identical": same_logits,
           "launches_equal": on[3] == of[3],
           "nodes_per_replayed_decode_step": nodes,
           "per_layer_cells": len(cells), "per_layer_complete": full,
           "cells_sum_to_aggregates": sums_ok,
           "graphed_cells_equal_eager": eager_cells,
           "off_silent": ("latency" not in sp_off
                          and "cost_residual" not in sp_off
                          and off.obs.tracer.events == []),
           "cost_residual": sp.get("cost_residual"),
           "latency": sp["latency"],
           "metrics_bytes": len(text.encode()), "metrics_series": sum(
               len(m.series()) for m in reg.values()),
           "prometheus_round_trip": round_trip,
           "trace_events": len(events),
           "spans": sum(e["ph"] == "X" for e in events),
           "span_names": sorted(span_names)}
    emit({"obs": res})
    check(same_tokens and same_logits and res["launches_equal"],
          "obs on and off differ in tokens, step logits or launches")
    check(nodes["on"] == nodes["off"] > 0,
          f"obs on and off replay different graphs: {nodes}")
    check(full and len(cells) == cfg.num_layers * len(OBS_SITES)
          and sums_ok and eager_cells,
          f"per_layer: {len(cells)} cells, complete {full}, sums {sums} "
          f"against the aggregates, graphed = eager {eager_cells}")
    check(round_trip and set(OBS_SPANS) <= span_names
          and res["off_silent"] and sp.get("cost_residual"),
          "metrics dump, trace or obs=False: see the obs line")
    del off
    torch.cuda.empty_cache()
    return res


def profile_wave(label, eng, prompts):
    """A short wave (prefill + PROFILE_NEW - 1 decode steps) under
    torch.profiler: device time by CUDA kernel, the port kernels' shares,
    and the device's busy share of the wave's wall clock (one stream, so
    kernel times do not overlap; the profiler's own host cost inflates the
    wall clock, so the share is a lower bound). Profiler ranges, for this
    wave only, give the device time of the kernels each one launches in
    an eager wave: the decode steps (`StepGraph` calls), the per-call
    operand quantization (every `quantize_tiles` call; the weights are
    most of it), dtype casts (`aten::_to_copy`: the bf16 operands) and the
    frozen gate's small ops (`core.plan._plan_frozen` less its get-norm
    kernel). A graphed wave's decode steps replay without their host ops,
    and the profiler ties no replayed kernel to a host range, so those
    four are printed for eager waves only (`graph_breakdown` times the
    graphs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import plan as P
    from repro_torch.kernels import quantize as Q
    from repro_torch.serving import graphs as G
    from repro_torch.serving.engine import Request

    reqs = [Request(prompt=p, max_new_tokens=PROFILE_NEW) for p in prompts]
    spans = {"chip_smoke::quantize_tiles": (Q, "quantize_tiles"),
             "chip_smoke::frozen_gate": (P, "_plan_frozen"),
             "chip_smoke::step": (G.StepGraph, "__call__")}
    saved = {name: getattr(obj, attr) for name, (obj, attr) in spans.items()}

    def traced(name):
        fn = saved[name]

        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)

        return run

    torch.cuda.synchronize()
    for name, (obj, attr) in spans.items():
        setattr(obj, attr, traced(name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate(reqs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, (obj, attr) in spans.items():
            setattr(obj, attr, saved[name])
    events = prof.key_averages()
    # a range also shows as a GPU annotation spanning its kernels: it is
    # no kernel, so it stays out of the kernel rows and the device time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in events
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in spans]
    device_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])

    def share(tag):
        return sum(r[1] for r in rows if tag in r[0])

    def inclusive(key):
        """Device time of the kernels launched under the host op `key`."""
        return sum(e.device_time_total / 1e3 for e in events
                   if e.key == key and e.device_type == DeviceType.CPU)

    graphed = eng.cuda_graphs
    steps = PROFILE_NEW - 1
    step_ms = inclusive("chip_smoke::step")
    gate_ms = None
    if not graphed:
        norms = inclusive("chip_smoke::frozen_gate")
        gate_ms = norms - share("tile_norms_f32_kernel") - share(
            "tile_norms_quant_f32_kernel")
    emit({"profile": label, "decode_steps": steps,
          "graphed": graphed, "wall_ms": wall_ms,
          "device_ms": device_ms if rows else "not measured",
          "device_busy_share": device_ms / wall_ms if rows else None,
          "decode_step_device_ms": (None if graphed else step_ms / steps),
          "frozen_gate_ops_ms": gate_ms,
          "tile_norms_ms": share("tile_norms_f32_kernel"),
          "spamm_mm_worklist_ms": share("spamm_worklist_f32_kernel"),
          "spamm_mm_worklist_decode_ms": share(
              "spamm_worklist_f32_decode_kernel"),
          "spamm_mm_worklist_bf16_ms": share("spamm_worklist_bf16_"),
          "tile_norms_quant_ms": share("tile_norms_quant_f32_kernel"),
          "spamm_mm_worklist_int8_ms": share("spamm_worklist_int8_"),
          "quantize_tiles_ms": (None if graphed
                                else inclusive("chip_smoke::quantize_tiles")),
          "to_copy_ms": None if graphed else inclusive("aten::_to_copy"),
          "top": [{"kernel": k[:80], "ms": ms, "count": n}
                  for k, ms, n in rows[:10]]})


def prefill_logits(cfg, pcfg, params, prompts, eng=None):
    import torch

    from repro_torch.models import model as M

    step = M.make_prefill_step(
        cfg, pcfg, spamm_cfg=None if eng is None else eng.spamm_ctx)
    frozen = None if eng is None else eng._frozen_for(prompts.size)
    with torch.inference_mode():
        _, logits = step(params, {"tokens": torch.as_tensor(
            prompts, device=DEV)}, frozen)
    return logits


def derive_tau(cfg, params, prompts, first_tokens):
    """τ for run (c): the median of the norm products of a decode step's
    first gated GEMM (layer 0 wq on the normalised embeddings of the dense
    run's first generated tokens, zero-padded to one row tile, as the
    engine pads them). A decode tile holds BATCH real rows of 64, so its
    norm products lie far below a prefill tile's: a τ taken from prefill
    gates every decode tile out, this one keeps part of both. The prefill
    median of the same GEMM is printed beside it and returned too."""
    import torch

    from repro_torch.kernels import getnorm

    wq = params["layers"][0]["mix"]["wq"]
    nb = getnorm.tile_norms_cuda(wq, TILE)

    with torch.inference_mode():
        x_dec = first_gemm_input(cfg, params, first_tokens)
        x_pre = first_gemm_input(cfg, params, prompts)
        dec_shape, pre_shape = list(x_dec.shape), list(x_pre.shape)
        tau = median_product_tau(getnorm.tile_norms_cuda(x_dec, TILE), nb)
        tau_prefill = median_product_tau(getnorm.tile_norms_cuda(x_pre, TILE),
                                         nb)
    emit({"tau_derivation": {
        "gemm": "layer 0 wq, first decode step", "activation": dec_shape,
        "weight": list(wq.shape),
        "rule": "median of norm_a[i,k]*norm_b[k,j] over all (i,j,k)",
        "tau": tau, "prefill_activation": pre_shape,
        "prefill_median": tau_prefill}})
    return tau, tau_prefill


def first_gemm_input(cfg, params, tokens):
    """The activation of layer 0's first gated GEMM (wq): the normalised
    embeddings of `tokens`, flattened and zero-padded to whole row tiles,
    as the engine pads them."""
    import torch

    from repro_torch.core.plan import pad_to_tile
    from repro_torch.models.layers import embed, rms_norm

    x = embed(params["embed"], torch.as_tensor(tokens, device=DEV).long(),
              torch.float32)
    x = rms_norm(x, params["layers"][0]["ln1"], cfg.norm_eps)
    return pad_to_tile(x.reshape(-1, cfg.d_model), TILE).contiguous()


def check_superset(cfg, params, prompts, tau):
    """At layer-0 wq, on the prefill activation at `tau`: every (i, j, k)
    step the f32 gate keeps is kept by the int8 and by the bf16 gate (their
    τ is widened by the quantization bound)."""
    import torch

    from repro_torch.core import plan as P

    wq = params["layers"][0]["mix"]["wq"]
    with torch.inference_mode():
        x = first_gemm_input(cfg, params, prompts)
        masks = {d: P.plan(x, wq, tau, tile=TILE, backend="cuda",
                           compute_dtype=d).mask
                 for d in ("float32",) + LOWP_DTYPES}
    f32 = masks["float32"]
    res = {"gemm": f"layer 0 wq, prefill {tuple(x.shape)} @ "
                   f"{tuple(wq.shape)}", "tau": tau,
           "kept": {d: int(m.sum()) for d, m in masks.items()},
           "total": f32.numel()}
    res["superset"] = {d: bool((masks[d] | ~f32).all()) for d in LOWP_DTYPES}
    emit({"gate_superset": res})
    check(all(res["superset"].values()) and 0 < res["kept"]["float32"]
          < res["total"], f"low-precision gates drop f32-kept steps: {res}")


def phase_serve(profile_path):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ParallelConfig, SpammConfig, get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(ARCH), num_layers=SERVE_LAYERS)
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=PROMPT_LEN)
    t0 = time.perf_counter()
    params = M.init_params(cfg, pcfg, SEED, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit({"model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "vocab": cfg.vocab,
          "params": n_params, "init_s": time.perf_counter() - t0,
          "depth_cut": f"{SERVE_LAYERS} of 32 layers"})
    prompts = np.random.default_rng(SEED).integers(
        1, cfg.vocab, size=(BATCH, PROMPT_LEN)).astype(np.int32)

    eng, dense_toks, _, _ = run_engine(cfg, pcfg, params, prompts, None,
                                       "a: dense")
    dense_logits = prefill_logits(cfg, pcfg, params, prompts)
    del eng

    sc0 = SpammConfig(enable=True, tau=0.0, tile=TILE, block_n=1, levels=0)
    eng, toks0, out0, counts0 = run_engine(cfg, pcfg, params, prompts, sc0,
                                           "b: tau=0")
    logits0 = prefill_logits(cfg, pcfg, params, prompts, eng)
    abs_err, rel = errors(logits0, dense_logits)
    same = bool((toks0 == dense_toks).all())
    emit({"tau0_vs_dense": {"prefill_logits_max_abs_err": abs_err,
                            "prefill_logits_max_rel_err": rel,
                            "tolerance_rel": LOGIT_RTOL,
                            "tokens_equal": same}})
    check(rel <= LOGIT_RTOL, f"τ=0 prefill logits differ from dense ({rel})")
    check(same, "τ=0 greedy tokens differ from the dense run")
    check(out0["spamm"]["valid_fraction"] == 1.0, "τ=0 dropped tiles")
    check(counts0["tile_norms"] > 0 and counts0["spamm_mm_worklist"] > 0,
          f"τ=0 launches {counts0}")
    del eng
    torch.cuda.empty_cache()

    tau, tau_prefill = derive_tau(cfg, params, prompts, dense_toks[:, 0])
    sct = SpammConfig(enable=True, tau=tau, tile=TILE, block_n=1, levels=0)
    eng, toks_c, out, counts = run_engine(cfg, pcfg, params, prompts, sct,
                                          f"c: tau={tau:.6g}")
    for phase in ("valid_fraction", "decode_valid_fraction"):
        vf = out["spamm"][phase]
        check(vf is not None and 0.0 < vf < 1.0,
              f"τ>0 {phase} {vf} not strictly inside (0, 1)")
    check(counts["tile_norms"] > 0 and counts["spamm_mm_worklist"] > 0
          and counts["spamm_mm_worklist_decode"] > 0,
          f"τ>0 launches {counts}")
    compare_graphed_eager(eng, prompts, "c")
    graph_breakdown(eng, params, "c")
    phase_obs(cfg, pcfg, params, eng, prompts, sct)
    t0 = time.perf_counter()
    tuned_counts = phase_autotune(cfg, pcfg, params, prompts, sct, eng,
                                  profile_path)
    autotune_s = time.perf_counter() - t0
    eng.cuda_graphs = False
    profile_wave(f"c: tau={tau:.6g}, eager", eng, prompts)
    eng.cuda_graphs = True
    logits_c = prefill_logits(cfg, pcfg, params, prompts, eng)
    abs_err, rel = errors(logits_c, dense_logits)
    emit({"float32_vs_dense": {"prefill_logits_max_abs_err": abs_err,
                               "prefill_logits_max_rel_err": rel,
                               "token_agreement": float(
                                   (toks_c == dense_toks).mean())}})
    bytes_f32 = out["spamm"]["gemm_bytes_moved"]
    del eng
    torch.cuda.empty_cache()

    check_superset(cfg, params, prompts, tau_prefill)
    lowp = {}
    for dtype, label in (("int8", "d"), ("bfloat16", "e")):
        scl = SpammConfig(enable=True, tau=tau, tile=TILE, block_n=1,
                          levels=0, dtype=dtype)
        eng, toks, outl, cnt = run_engine(cfg, pcfg, params, prompts, scl,
                                          f"{label}: {dtype} tau={tau:.6g}")
        compare_graphed_eager(eng, prompts, label)
        eng.cuda_graphs = False
        profile_wave(f"{label}: {dtype} tau={tau:.6g}, eager", eng, prompts)
        eng.cuda_graphs = True
        sp = outl["spamm"]
        abs_err, rel = errors(prefill_logits(cfg, pcfg, params, prompts, eng),
                              dense_logits)
        ratio = bytes_f32 / sp["gemm_bytes_moved"]
        emit({f"{dtype}_vs_dense": {
            "prefill_logits_max_abs_err": abs_err,
            "prefill_logits_max_rel_err": rel,
            "token_agreement": float((toks == dense_toks).mean()),
            "compute_dtype": sp["compute_dtype"],
            "prefill_gemm_bytes_f32_over_this": ratio}})
        for phase in ("valid_fraction", "decode_valid_fraction"):
            vf = sp[phase]
            check(vf is not None and 0.0 < vf <= 1.0,
                  f"{dtype} {phase} {vf} not inside (0, 1]")
        check(sp["compute_dtype"] == dtype and ratio >= 1.5
              and bool(np.isfinite(toks).all()),
              f"{dtype} serving: dtype {sp['compute_dtype']}, f32/{dtype} "
              f"prefill GEMM bytes {ratio}")
        lowp[dtype] = cnt
        del eng
        torch.cuda.empty_cache()
    check(lowp["int8"]["tile_norms_quant"] > 0
          and lowp["int8"]["spamm_mm_worklist_int8"] > 0
          and lowp["bfloat16"]["spamm_mm_worklist_bf16"] > 0
          and lowp["bfloat16"]["tile_norms"] > 0,
          f"low-precision serving launches {lowp}")
    store = phase_store(cfg, pcfg, params, prompts, sct, toks_c, logits_c)
    chunked = phase_chunked(cfg, pcfg, params, sct)
    return counts, lowp, store, chunked, tuned_counts, autotune_s


def phase_chunked(cfg, pcfg, params, sct):
    """Run (f), the chunked plane at run (c)'s width and depth: CHUNK_PLENS
    prompts (seed 0) through CHUNK_SLOTS slots, chunks of one tile (the
    auto chunk at tile 64), CUDA graphs. At τ = 0 every request's tokens
    equal its solo wave's; at run (c)'s τ a warm wave is measured with
    every count set to 0 just before it and read just after, then served
    again as graphs and eagerly, bit for bit. Returns the measured wave's
    launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.serving.engine import Engine, Request

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in CHUNK_PLENS]

    def engine(sc):
        eng = Engine(cfg, pcfg, params, max_len=CHUNK_MAX_LEN, spamm_cfg=sc,
                     max_slots=CHUNK_SLOTS)
        check(eng._resolve_chunk(True) == TILE
              and eng._slot_count(len(prompts)) == CHUNK_SLOTS,
              "run (f) chunk or slot count")
        return eng

    eng = engine(dataclasses.replace(sct, tau=0.0))
    toks0, _, out0, _, dt0 = logged_wave(eng, prompts, MAX_NEW)
    solo = [np.asarray(eng.generate([Request(prompt=p,
                                             max_new_tokens=MAX_NEW)])[0])
            for p in prompts]
    same = [bool(np.array_equal(a, b)) for a, b in zip(toks0, solo)]
    emit({"chunked_tau0": {"cold_wave": True,
                           "prompt_lens": list(CHUNK_PLENS),
                           "slots": CHUNK_SLOTS, "chunk": TILE,
                           "max_len": CHUNK_MAX_LEN,
                           "tokens_equal_solo_wave": same,
                           **wave_numbers(toks0, out0, dt0),
                           "step_keys": dict(eng.trace_counts),
                           "graphs": eng.graph_stats()}})
    check(all(same), f"run (f) at τ=0 differs from solo waves: {same}")
    del eng
    torch.cuda.empty_cache()

    eng = engine(sct)
    logged_wave(eng, prompts, MAX_NEW)                 # freezes, captures
    c0 = eng.chunk_steps
    toks, _, out, counts, dt = logged_wave(eng, prompts, MAX_NEW)
    sp = out["spamm"]
    reg = {m.name: m for m in eng.obs.registry.metrics()}
    obs_f = {"span_names": sorted(eng.obs.tracer.span_names()),
             "prefill_chunk_spans": sum(
                 e["name"] == "prefill_chunk" for e in eng.obs.tracer.events),
             "serve_admissions_total": reg["serve_admissions_total"].value(),
             "serve_prefill_chunks_total":
                 reg["serve_prefill_chunks_total"].value(),
             "cost_residual": sp.get("cost_residual")}
    emit({"serve": f"f: chunked tau={sct.tau:.6g}",
          **wave_numbers(toks, out, dt),
          "prefill_chunks": eng.chunk_steps - c0,
          "admissions": eng.admissions, "obs": obs_f,
          "prefill_valid_fraction": sp["valid_fraction"],
          "decode_valid_fraction": sp["decode_valid_fraction"],
          "gated_gemms": sp["gated_gemms"],
          "decode_gated_gemms": sp["decode_gated_gemms"],
          "launches": counts, "step_keys": dict(eng.trace_counts),
          "graphs": eng.graph_stats(),
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    for phase in ("valid_fraction", "decode_valid_fraction"):
        check(sp[phase] is not None and 0.0 < sp[phase] <= 1.0,
              f"run (f) {phase} {sp[phase]}")
    check(counts["tile_norms"] > 0 and counts["spamm_mm_worklist"] > 0
          and eng.trace_counts == {"prefill": 1, "decode": 1},
          f"run (f) launches {counts}, step keys {eng.trace_counts}")
    check(obs_f["prefill_chunk_spans"] == eng.chunk_steps > 0
          and obs_f["serve_prefill_chunks_total"] == eng.chunk_steps
          and obs_f["serve_admissions_total"] == eng.admissions > 0,
          f"run (f) obs: {obs_f}, chunks {eng.chunk_steps}, admissions "
          f"{eng.admissions}")
    compare_graphed_eager(eng, prompts, "f")
    del eng
    torch.cuda.empty_cache()
    return counts


def compare_artifacts(base, other):
    """Largest relative difference of the finest normmaps of two freezes
    of the same weights, the count of normmap entries that differ at all,
    and of weight-admissible (k, j) pairs in one artifact but not the
    other."""
    import numpy as np

    rel, entries, pairs = 0.0, 0, 0
    for a, b in zip(_leaves(base), _leaves(other)):
        na, nb = a.levels[0], b.levels[0]
        rel = max(rel, float(((na - nb).abs()
                              / na.abs().clamp(min=1e-30)).max()))
        entries += int((na != nb).sum())
        gk = a.grid[0]
        ka = set((a.kj_j.astype(np.int64) * gk + a.kj_k).tolist())
        kb = set((b.kj_j.astype(np.int64) * gk + b.kj_k).tolist())
        pairs += len(ka ^ kb)
    return rel, entries, pairs


def phase_store(cfg, pcfg, params, prompts, sct, toks_c, logits_c):
    """The offline plan-store path at run (c)'s width and depth, at its
    τ: (1) freeze every gated weight into a fresh store (the cold pass of
    `populate`: one get-norm launch per weight, every lookup a miss); (2)
    a fresh `Engine(plan_store=…)` serves the wave warm-started from it:
    store hits only, no get-norm launch while it freezes, and run (c)'s
    tokens and prefill logits bit for bit; a second wave reports 0/0
    store traffic; (3) the same walk with the tensor-core get-norm
    (use_mxu=True) at f32 and at int8, new keys beside the CUDA-core
    artifacts, with one launch of the new kernels per weight. Every count
    is set to 0 just before the walks and the wave and read just after.
    Returns the launches of the path."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.plans.precompute import freeze_tree, iter_gated_weights
    from repro_torch.plans.store import PlanStore
    from repro_torch.serving.engine import Engine, Request

    n_weights = sum(1 for _ in iter_gated_weights(params))
    os.makedirs(STORE_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke-", dir=STORE_DIR)
    sc8 = dataclasses.replace(sct, dtype="int8")
    try:
        store = PlanStore(root)
        reset_counts()
        fw32, cold_s = host_ms(lambda: freeze_tree(params, sct,
                                                   store=store)[0])
        cold_counts = read_counts()
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        emit({"store_cold": {"weights": n_weights, "layers": cfg.num_layers,
                             "freeze_s": cold_s / 1e3,
                             "artifacts": len(store), "bytes_on_disk": disk,
                             "hits": store.hits, "misses": store.misses,
                             "launches": cold_counts}})
        check(store.misses == n_weights == len(store) == 6 * cfg.num_layers
              and store.hits == 0
              and cold_counts["tile_norms"] == n_weights,
              f"cold store pass: {len(store)} artifacts, {store.hits}h/"
              f"{store.misses}m, launches {cold_counts}")

        eng = Engine(cfg, pcfg, params, max_len=MAX_LEN, spamm_cfg=sct,
                     plan_store=root)
        freeze = {"ms": 0.0, "calls": 0, "launches": dict.fromkeys(
            read_counts(), 0)}
        ensure = eng._ensure_fw_tree

        def timed_freeze():   # the engine calls it once per new row grid
            c0 = read_counts()
            freeze["ms"] += host_ms(ensure)[1]
            freeze["calls"] += 1
            for k, v in read_counts().items():
                freeze["launches"][k] += v - c0[k]

        eng._ensure_fw_tree = timed_freeze
        reset_counts()
        reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
        toks = np.stack(eng.generate(reqs))
        warm_counts = read_counts()
        sp = reqs[0].out["spamm"]
        logits = prefill_logits(cfg, pcfg, params, prompts, eng)
        reqs2 = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
        eng.generate(reqs2)
        sp2 = reqs2[0].out["spamm"]
        same_toks = bool((toks == toks_c).all())
        same_logits = torch.equal(logits, logits_c)
        getnorms = sum(v for k, v in freeze["launches"].items()
                       if k.startswith("tile_norms"))
        emit({"store_warm": {
            "freeze_s": freeze["ms"] / 1e3, "freeze_calls": freeze["calls"],
            "plan_store_hits": sp["plan_store_hits"],
            "plan_store_misses": sp["plan_store_misses"],
            "weight_getnorm_launches_in_freeze": getnorms,
            "tokens_equal_cold": same_toks,
            "prefill_logits_bit_identical_to_cold": same_logits,
            "second_wave_hits": sp2["plan_store_hits"],
            "second_wave_misses": sp2["plan_store_misses"],
            "launches": warm_counts}})
        check(sp["plan_store_hits"] == n_weights
              and sp["plan_store_misses"] == 0 and getnorms == 0
              and same_toks and same_logits
              and (sp2["plan_store_hits"], sp2["plan_store_misses"]) == (0, 0),
              "warm start from the plan store: see the store_warm line")
        del eng
        torch.cuda.empty_cache()

        keys0 = set(store.keys())
        # the use_mxu walks over the first STORE_MXU_LAYERS layers
        mparams = {**params, "layers": params["layers"][:STORE_MXU_LAYERS]}
        n_mxu = sum(1 for _ in iter_gated_weights(mparams))
        reset_counts()
        fw32m, mxu32_s = host_ms(lambda: freeze_tree(mparams, sct,
                                                     store=store,
                                                     use_mxu=True)[0])
        fw8m, mxu8_s = host_ms(lambda: freeze_tree(mparams, sc8, store=store,
                                                   use_mxu=True)[0])
        mxu_counts = read_counts()
        new_keys = set(store.keys()) - keys0
        # the CUDA-core int8 artifacts the int8 ones are compared with
        fw8, _ = host_ms(lambda: freeze_tree(mparams, sc8, store=store)[0])
        res = {"layers": STORE_MXU_LAYERS, "weights": n_mxu,
               "freeze_s": {"float32": mxu32_s / 1e3, "int8": mxu8_s / 1e3},
               "new_artifacts": len(new_keys), "launches": mxu_counts}
        # the same use_mxu walks again, warm: store hits only, no get-norm
        # launch, the cold walks' artifacts bit for bit
        reset_counts()
        warm_m = {"float32": freeze_tree(mparams, sct, store=store,
                                         use_mxu=True)[0],
                  "int8": freeze_tree(mparams, sc8, store=store,
                                      use_mxu=True)[0]}
        res["warm_launches"] = read_counts()
        for dtype, base, other in (("float32", fw32, fw32m),
                                   ("int8", fw8, fw8m)):
            rel, entries, pairs = compare_artifacts(base, other)
            _, warm_entries, warm_pairs = compare_artifacts(other,
                                                            warm_m[dtype])
            res[dtype] = {"max_rel_normmap_diff_vs_use_mxu_false": rel,
                          "normmap_entries_differing": entries,
                          "kj_pairs_differing": pairs,
                          "warm_entries_differing_from_cold": warm_entries,
                          "warm_kj_pairs_differing_from_cold": warm_pairs}
        emit({"store_mxu": res})
        check(mxu_counts["tile_norms_mxu"] == n_mxu
              and mxu_counts["tile_norms_quant_mxu"] == n_mxu
              and len(new_keys) == 2 * n_mxu
              and not any(res["warm_launches"].values())
              and all(res[d]["max_rel_normmap_diff_vs_use_mxu_false"]
                      <= NORM_RTOL
                      and res[d]["warm_entries_differing_from_cold"] == 0
                      and res[d]["warm_kj_pairs_differing_from_cold"] == 0
                      for d in ("float32", "int8")),
              f"use_mxu store pass: {res}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"weights": n_weights, "mxu_weights": n_mxu, "cold": cold_counts,
            "warm": warm_counts, "mxu": mxu_counts}

# ---------------------------------------------------------------------------
# cost calibration, the autotuner, the dense family
# ---------------------------------------------------------------------------

def layer_gemms(cfg):
    """{site: (K, N)} of one layer's gated weights at `cfg`'s widths."""
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    gemms = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
             "w1": (d, ff), "w2": (ff, d)}
    if cfg.act != "gelu_mlp":
        gemms["w3"] = (d, ff)
    return gemms


def phase_calibrate():
    """`core.cost.calibrate` on the card at ARCH's serving shapes (its
    layer's gated weights; run (c)'s prefill wave and decode step rows),
    every count set to 0 just before it and read just after: device-bound
    samples (calls captured as a CUDA graph, replayed back to back) of
    get-norms up to ≈ 105 MB and of the frozen w1 work-list at the prefill
    and decode grids across τ and block_n 1, 2; the gate rate from the
    device gate at the decode grid. Prints the fitted coefficients beside
    the nominal ones, the samples and the NNLS columns kept, the largest
    |log2(measured / predicted)| and the seconds; saves the profile (and
    the whole report) under CAL_DIR. Returns (profile path, coefficients,
    launches)."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import cost

    sweep = cost.CardSweep(layer_gemms(get_config(ARCH)),
                           prefill_rows=BATCH * PROMPT_LEN, decode_rows=BATCH)
    reset_counts()
    t0 = time.perf_counter()
    report = {}
    coeffs = cost.calibrate("cuda", sweep=sweep, report=report)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    prof = cost.CostProfile(meta={"card": CARD, "script": "chip_smoke.py"})
    prof.put("cuda", coeffs)
    os.makedirs(CAL_DIR, exist_ok=True)
    path = prof.save(os.path.join(CAL_DIR, "profile.json"))
    with open(os.path.join(CAL_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    worst = sorted(report["samples"], key=lambda r: -abs(r["log2_ratio"]))
    emit({"calibrate": {
        "card": CARD, "device_kind": report["device_kind"],
        "sweep": {"arch": ARCH, **sweep._asdict()},
        "fitted": coeffs._asdict(),
        "nominal": cost.DEFAULT_COEFFS["cuda"]._asdict(),
        "samples": len(report["samples"]),
        "columns_kept": report["columns_kept"],
        "fit_base_step_invbw_invflops": report["fit"],
        "max_abs_log2_measured_over_predicted": report["max_abs_log2"],
        "samples_us": [[r["kind"], r["shape"], r.get("tau"),
                        r.get("block_n"), r["measured_s"] * 1e6,
                        r["predicted_s"] * 1e6] for r in report["samples"]],
        "worst": [[r["kind"], r["shape"], r.get("tau"), r.get("block_n"),
                   r["log2_ratio"]] for r in worst[:3]],
        "gate_us": [[g["site"], g["rows"], g["steps"], g["s"] * 1e6]
                    for g in report["gate"]],
        "launches": counts, "seconds": seconds, "profile": path}})
    check(coeffs.calibrated and all(math.isfinite(v) and v > 0
                                    for v in coeffs[:5]),
          f"calibrated coefficients {coeffs}")
    check(counts["tile_norms"] > 0 and counts["spamm_mm_worklist"] > 0,
          f"calibration launches {counts}")
    torch.cuda.empty_cache()
    return path, coeffs, counts


def layer0_inputs(eng, cfg, pcfg, params, prompts):
    """{site: activation} of layer 0's gated GEMMs in one prefill of `eng`
    (recorded at `spamm_linear_frozen`, flattened and tile-padded as the
    GEMM pads them)."""
    from repro_torch.core import module as Mod

    got = {}
    orig = Mod.spamm_linear_frozen

    def recording(x, w, fp, ctx=None, site=None):
        if ctx is eng.spamm_ctx and ctx._layer == 0 and site not in got:
            got[site] = Mod._flatten_pad(x, fp.tile)[0]
        return orig(x, w, fp, ctx, site=site)

    Mod.spamm_linear_frozen = recording
    try:
        prefill_logits(cfg, pcfg, params, prompts, eng)
    finally:
        Mod.spamm_linear_frozen = orig
    return got


def kept_steps(x, fp):
    """(gm, gn // block_n, gk) bool grid of the (i, j, k) tile products the
    frozen gate keeps for activation x."""
    import torch

    from repro_torch.core import plan as P

    p = P.plan(x, frozen_weight=fp)
    w = p.work
    act = (w.step_flags & P.STEP_ACC) != 0
    grid = torch.zeros(fp.gm, fp.gnb, fp.gk, dtype=torch.bool,
                       device=x.device)
    grid[w.step_i[act].long(), w.step_j[act].long(),
         w.step_k[act].long()] = True
    return grid


def tuned_superset(eng_t, eng_c, cfg, pcfg, params, prompts):
    """At each of layer 0's gated sites, on the prefill's own activation:
    every tile product the block_n = 1 gate keeps lies in a super-column
    the tuned gate keeps. Returns per site (tuned block_n, kept at block_n
    = 1, kept tuned super-column steps, superset)."""
    import torch.nn.functional as F

    xs = layer0_inputs(eng_t, cfg, pcfg, params, prompts)
    rows = prompts.size
    ft = eng_t._frozen_for(rows)["layers"][0]
    fc = eng_c._frozen_for(rows)["layers"][0]
    res = {}
    for part, sites in ft.items():
        for site, fpt in sites.items():
            g1 = kept_steps(xs[site], fc[part][site])
            gt = kept_steps(xs[site], fpt)
            b = fpt.block_n
            pad = gt.shape[1] * b - g1.shape[1]
            g1b = F.pad(g1, (0, 0, 0, pad)).reshape(
                g1.shape[0], gt.shape[1], b, g1.shape[2]).any(2)
            res[site] = {"block_n": b, "kept_block_n1": int(g1.sum()),
                         "kept_tuned": int(gt.sum()),
                         "superset": bool((gt | ~g1b).all())}
    return res


@contextlib.contextmanager
def drained_taps(ctx):
    """The `Tap` lists `ctx.end_stats()` drains while the block runs (one
    per wave)."""
    from repro_torch.core.module import SpammContext

    got = []
    orig = SpammContext.end_stats

    def keep(self):
        taps = orig(self)
        if self is ctx:
            got.append(taps)
        return taps

    SpammContext.end_stats = keep
    try:
        yield got
    finally:
        SpammContext.end_stats = orig


def plan_statics(eng, coeffs):
    """{(phase, layer, site): `cost.predict_plan_static` under `coeffs`} of
    each frozen GEMM of `eng` at run (c)'s grids: the prefill's BATCH ×
    PROMPT_LEN rows, a decode step's BATCH."""
    import torch

    from repro_torch.core import cost
    from repro_torch.core import plan as P

    out = {}
    for phase, rows in (("prefill", BATCH * PROMPT_LEN), ("decode", BATCH)):
        for li, layer in enumerate(eng._frozen_for(rows)["layers"]):
            for sites in layer.values():
                for site, fp in sites.items():
                    x = torch.zeros(fp.gm * fp.tile, fp.gk * fp.tile,
                                    device=DEV)
                    out[(phase, li, site)] = cost.predict_plan_static(
                        P.plan(x, frozen_weight=fp), coeffs)
    return out


def priced_s(taps, statics, coeffs):
    """Predicted seconds per phase of a wave's drained taps, each finished
    (`cost.finish_plan_time_s`) from `statics` with `coeffs`, summed in the
    engine's order."""
    from repro_torch.core import cost

    out = {"prefill": 0.0, "decode": 0.0}
    for t in taps:
        if t.predicted_s is not None:
            ph = "decode" if t.phase == "decode" else "prefill"
            out[ph] += cost.finish_plan_time_s(
                statics[(ph, t.layer, t.site)], t.value, t.nbytes, coeffs)
    return out


def phase_autotune(cfg, pcfg, params, prompts, sct, eng_c, profile_path):
    """The roofline autotuner on starcoder2-7b at run (c)'s τ. Tuning: each
    gated site once, on layer 0's weight (`tune_for`, as `freeze_tree`
    tunes), with the calibrated profile and with the nominal one: the
    picks' histogram over the model's gated weights, Σ predicted_us against Σ
    default_predicted_us, the tuning seconds; and with run (c)'s engine's
    observed row grids (`gm_histogram`). Serving: run (c) graphed on the
    tuned artifacts (an engine priced by the calibrated profile) and on run
    (c)'s own (`eng_c`, nominal), waves in turns: tok/s, TTFT, decode
    ms/step, nodes per replayed decode step, and the cost residual per
    phase under both profiles — each wave's drained taps re-priced with
    each profile through `predict_plan_static`/`finish_plan_time_s`, the
    engine's own profile reproducing its residual's predictions. Checks:
    tuned graphed ≡ tuned eager; the tuned gate keeps every tile the
    block_n = 1 gate keeps at layer 0; a warm plan store hits every tuned
    artifact. Returns the tuned wave's launches."""
    import collections
    import dataclasses
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import cost
    from repro_torch.plans.precompute import (freeze_tree, frozen_leaves,
                                              iter_gated_weights, tune_for)
    from repro_torch.plans.store import PlanStore
    from repro_torch.serving.engine import Engine

    n_weights = sum(1 for _ in iter_gated_weights(params))
    sa = dataclasses.replace(sct, autotune=True, tune_profile=profile_path)
    layer0 = [(p[-1], w) for p, w in iter_gated_weights(params) if p[1] == 0]
    cal = cost.CostProfile.load(profile_path)
    kind = cost.device_kind(torch.device(DEV))
    coeffs = {"calibrated": cal.coeffs("cuda", kind),
              "nominal": cost.CostProfile().coeffs("cuda", kind)}

    def summary(picks, secs):
        hist = collections.Counter((t.block_n, t.levels, t.bucket)
                                   for t in picks.values())
        return {"sites": {s: [t.block_n, t.levels, t.bucket, t.predicted_us,
                              t.default_predicted_us, t.profile_key]
                          for s, t in picks.items()},
                "histogram": {str(k): v * cfg.num_layers
                                  for k, v in sorted(hist.items())},
                "predicted_us_sum": cfg.num_layers * sum(
                    t.predicted_us for t in picks.values()),
                "default_predicted_us_sum": cfg.num_layers * sum(
                    t.default_predicted_us for t in picks.values()),
                "tuning_s": secs}

    tuning = {}
    for name, prof in (("calibrated", cal), ("nominal", cost.CostProfile())):
        t0 = time.perf_counter()
        picks = {s: tune_for(w, sa, profile=prof) for s, w in layer0}
        tuning[name] = summary(picks, time.perf_counter() - t0)
    gm_hist = eng_c.gm_histogram
    t0 = time.perf_counter()
    picks = {s: cost.tune_weight(w, sct.tau, tile=sct.tile, profile=cal,
                                 gm_hist=gm_hist) for s, w in layer0}
    tuning["calibrated_gm_histogram"] = {
        "gm_histogram": gm_hist, **summary(picks, time.perf_counter() - t0)}
    emit({"autotune_picks": {"card": CARD, "tau": sct.tau, **tuning}})
    for name in ("calibrated", "nominal"):
        t = tuning[name]
        check(t["predicted_us_sum"] <= t["default_predicted_us_sum"],
              f"{name} picks predicted slower than the defaults: {t}")

    os.makedirs(STORE_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke-tuned-", dir=STORE_DIR)
    eng_t = None
    try:
        eng_t = Engine(cfg, pcfg, params, max_len=MAX_LEN, spamm_cfg=sa,
                       plan_store=root)
        (_, freeze_ms) = host_ms(eng_t._ensure_fw_tree)
        fws = list(frozen_leaves(eng_t._fw_tree))
        served_picks = collections.Counter(
            (fw.block_n, fw.num_levels, fw.bucket_floor) for fw in fws)
        check(len(fws) == n_weights and all(
            fw.tuned is not None and fw.block_n == fw.tuned.block_n
            and fw.num_levels == fw.tuned.levels for fw in fws),
            "tuned engine's artifacts are not frozen at their picks")
        engines = {"default": (eng_c, "nominal"),
                   "tuned": (eng_t, "calibrated")}
        check(all(e.spamm_ctx.cost_coeffs == coeffs[prof]
                  for e, prof in engines.values()),
              "an engine's cost taps are not armed with its profile")
        logged_wave(eng_t, prompts, MAX_NEW)        # captures, warm
        statics = {(arts, prof): plan_statics(e, coeffs[prof])
                   for arts, (e, _) in engines.items() for prof in coeffs}
        waves = {arts: [] for arts in engines}
        for arts in ("default", "tuned", "tuned", "default"):
            e, own = engines[arts]
            with drained_taps(e.spamm_ctx) as got:
                w = logged_wave(e, prompts, MAX_NEW)
            (taps,) = got
            cres = w[2]["spamm"]["cost_residual"]
            res_w = {}
            for prof, c in coeffs.items():
                pred = priced_s(taps, statics[(arts, prof)], c)
                res_w[prof] = {ph: {"predicted_s": pred[ph],
                                    "measured_s": cres[ph]["measured_s"],
                                    "log2_ratio": math.log2(
                                        cres[ph]["measured_s"] / pred[ph])}
                               for ph in ("prefill", "decode")}
            check(all(abs(res_w[own][ph]["predicted_s"]
                          - cres[ph]["predicted_s"])
                      <= 1e-12 * cres[ph]["predicted_s"]
                      for ph in ("prefill", "decode")),
                  f"re-pricing {arts}'s taps with its own profile "
                  f"({res_w[own]}) differs from its residual ({cres})")
            waves[arts].append((w, res_w))
        res = {"card": CARD, "run": f"c: tau={sct.tau:.6g}",
               "tuned_freeze_s": freeze_ms / 1e3,
               "served_picks": {str(k): v
                                for k, v in sorted(served_picks.items())}}
        for arts, ws in waves.items():
            nums = [wave_numbers(w[0], w[2], w[4]) for w, _ in ws]
            res[arts] = {k: [n[k] for n in nums]
                         for k in ("tok_per_s", "ttft_ms",
                                   "decode_ms_per_step")}
            res[arts]["engine_profile"] = engines[arts][1]
            res[arts]["cost_residual"] = {
                prof: [r[prof] for _, r in ws] for prof in coeffs}
            res[arts]["nodes_per_replayed_decode_step"] = \
                engines[arts][0]._steps[(("wave", BATCH), True)].nodes()
            res[arts]["valid_fraction"] = [
                ws[0][0][2]["spamm"]["valid_fraction"],
                ws[0][0][2]["spamm"]["decode_valid_fraction"]]
        tt, dd = waves["tuned"][0][0], waves["default"][0][0]
        res["token_agreement_tuned_vs_default"] = float(np.mean(
            [np.mean(a == b) for a, b in zip(tt[0], dd[0])]))
        res["tuned_launches"] = tt[3]
        emit({"autotune_serve": res})
        lt = res["tuned_launches"]
        check(lt["tile_norms"] > 0 and lt["spamm_mm_worklist"] > 0,
              f"tuned wave launches {lt}")
        compare_graphed_eager(eng_t, prompts, "c tuned")

        sup = tuned_superset(eng_t, eng_c, cfg, pcfg, params, prompts)
        emit({"tuned_gate_superset": {"tau": sct.tau, "layer": 0,
                                      "sites": sup}})
        check(all(v["superset"] for v in sup.values()),
              f"the tuned gate drops block_n = 1 tiles: {sup}")

        store = PlanStore(root)
        reset_counts()
        (tree, _), warm_ms = host_ms(lambda: freeze_tree(params, sa,
                                                         store=store))
        warm_counts = read_counts()
        same = all(a.tuned._replace(profile_key="")
                   == b.tuned._replace(profile_key="")
                   and a.block_n == b.block_n and a.weight_hash
                   == b.weight_hash
                   for a, b in zip(frozen_leaves(tree), fws))
        emit({"autotune_store_warm": {
            "artifacts": len(store), "hits": store.hits,
            "misses": store.misses, "freeze_s": warm_ms / 1e3,
            "tuned_records_equal": same, "launches": warm_counts}})
        check(store.hits == n_weights and store.misses == 0 and same
              and len(store) == n_weights,
              "warm tuned store: see the autotune_store_warm line")
    finally:
        del eng_t
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return res["tuned_launches"]


def family_wave(cfg, pcfg, params, prompts, sc, label, depth_cut,
                max_len=MAX_LEN, line="dense_family"):
    """An engine of `cfg` at SpAMM config `sc`: a cold wave (freeze,
    captures), then the measured wave with every count set to 0 just
    before it. Emits a `line` line; returns (engine, tokens, out,
    launches)."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, pcfg, params, max_len=max_len, spamm_cfg=sc)
    logged_wave(eng, prompts, MAX_NEW)
    toks, _, out, counts, dt = logged_wave(eng, prompts, MAX_NEW)
    sp = out["spamm"] or {}
    emit({line: cfg.name, "run": label, "card": CARD,
          "layers": cfg.num_layers, "depth_cut": depth_cut,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "vocab": cfg.vocab,
          **wave_numbers(toks, out, dt),
          "prefill_valid_fraction": sp.get("valid_fraction"),
          "decode_valid_fraction": sp.get("decode_valid_fraction"),
          "cost_residual": sp.get("cost_residual"), "launches": counts,
          "prompt_len": len(prompts[0]), "max_len": max_len,
          "graphs": eng.graph_stats(),
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return eng, np.stack(toks), out, counts


def phase_dense_families(profile_path):
    """codeqwen1.5-7b, qwen2.5-32b and granite-34b at full width and
    FAMILY_DEPTH layers, random weights from SEED, run
    (c)'s wave shape. Each: dense, then τ = 0 (tokens equal dense, prefill
    logits within LOGIT_RTOL), graphed. codeqwen1.5-7b also at the median
    product τ of its first decode GEMM (graphed ≡ eager) and at that τ
    autotuned with the calibrated profile (its d_ff of 210 tiles pads at
    block_n 4); granite-34b also on the chunked plane (MQA in the chunk
    graph) at τ = 0, graphed ≡ eager. Peak memory per model. Returns the
    launches of codeqwen1.5-7b's τ > 0 waves."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ParallelConfig, SpammConfig, get_config
    from repro_torch.models import model as M
    from repro_torch.plans.precompute import frozen_leaves
    from repro_torch.serving.engine import Engine

    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=PROMPT_LEN)
    launches = {}
    for arch, depth in FAMILY_DEPTH.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        cut = None if depth is None else (
            f"{depth} of {get_config(arch).num_layers} layers")
        params = M.init_params(cfg, pcfg, SEED, device=DEV)
        prompts = np.random.default_rng(SEED).integers(
            1, cfg.vocab, size=(BATCH, PROMPT_LEN)).astype(np.int32)
        eng, dense_toks, _, _ = family_wave(cfg, pcfg, params, prompts, None,
                                            "dense", cut)
        dense_logits = prefill_logits(cfg, pcfg, params, prompts)
        del eng
        sc0 = SpammConfig(enable=True, tau=0.0, tile=TILE)
        eng, toks0, out0, c0 = family_wave(cfg, pcfg, params, prompts, sc0,
                                           "tau=0", cut)
        _, rel = errors(prefill_logits(cfg, pcfg, params, prompts, eng),
                        dense_logits)
        same = bool((toks0 == dense_toks).all())
        emit({"dense_family_tau0_vs_dense": {
            "model": arch, "prefill_logits_max_rel_err": rel,
            "tolerance_rel": LOGIT_RTOL, "tokens_equal": same}})
        check(rel <= LOGIT_RTOL and same
              and out0["spamm"]["valid_fraction"] == 1.0
              and c0["tile_norms"] > 0 and c0["spamm_mm_worklist"] > 0,
              f"{arch} at τ = 0: rel {rel}, tokens equal {same}, "
              f"launches {c0}")
        del eng
        if arch == "granite-34b":
            rng = np.random.default_rng(SEED)
            mixed = [rng.integers(1, cfg.vocab, n).astype(np.int32)
                     for n in FAMILY_CHUNK_PLENS]
            eng = Engine(cfg, pcfg, params, max_len=CHUNK_MAX_LEN,
                         spamm_cfg=sc0, max_slots=2)
            logged_wave(eng, mixed, MAX_NEW)
            compare_graphed_eager(eng, mixed, f"{arch} chunked tau=0")
            del eng
        if arch == "codeqwen1.5-7b":
            tau, _ = derive_tau(cfg, params, prompts, dense_toks[:, 0])
            sct = SpammConfig(enable=True, tau=tau, tile=TILE)
            eng, toks, out, c = family_wave(cfg, pcfg, params, prompts, sct,
                                            f"tau={tau:.6g}", cut)
            sp = out["spamm"]
            check(0.0 < sp["valid_fraction"] < 1.0
                  and 0.0 < sp["decode_valid_fraction"] < 1.0,
                  f"{arch} τ > 0 valid fractions {sp['valid_fraction']}, "
                  f"{sp['decode_valid_fraction']}")
            compare_graphed_eager(eng, prompts, f"{arch} tau")
            launches["tau"] = c
            sa = dataclasses.replace(sct, autotune=True,
                                     tune_profile=profile_path)
            eng_t, toks_t, out_t, c = family_wave(
                cfg, pcfg, params, prompts, sa, f"tau={tau:.6g} autotuned",
                cut)
            picks = {}
            for fw in frozen_leaves(eng_t._fw_tree):
                k = str((fw.block_n, fw.num_levels, fw.bucket_floor))
                picks[k] = picks.get(k, 0) + 1
            pads = sorted({(fw.wshape[1], fw.padded[1])
                           for fw in frozen_leaves(eng_t._fw_tree)
                           if fw.padded[1] != fw.wshape[1]})
            check(c["tile_norms"] > 0 and c["spamm_mm_worklist"] > 0,
                  f"{arch} autotuned launches {c}")
            compare_graphed_eager(eng_t, prompts, f"{arch} tau autotuned")
            sup = tuned_superset(eng_t, eng, cfg, pcfg, params, prompts)
            emit({"dense_family_autotune": {
                "model": arch, "tau": tau, "picks": picks,
                "padded_n": pads,
                "token_agreement_vs_untuned": float((toks_t == toks).mean()),
                "gate_superset_layer0": sup}})
            check(all(v["superset"] for v in sup.values()),
                  f"{arch}'s tuned gate drops block_n = 1 tiles: {sup}")
            launches["autotuned"] = c
            del eng, eng_t
        emit({"dense_family_done": {"model": arch, "layers": cfg.num_layers,
                                    "seconds": time.perf_counter() - t0,
                                    "peak_allocated_gb":
                                        torch.cuda.max_memory_allocated()
                                        / 1e9}})
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the MoE family
# ---------------------------------------------------------------------------

def moe_site_cells(eng, site="moe_bmm"):
    """(Σ valid fraction, count) of the engine's registry over the prefill
    taps of the MoE block at `site` (layer -1)."""
    from repro_torch.obs import parse_prometheus

    s = parse_prometheus(eng.obs.registry.render_prometheus()).get(
        "spamm_valid_fraction", {"samples": {}})["samples"]
    lab = f'{{phase="prefill",layer="-1",site="{site}"}}'
    return (s.get(f"spamm_valid_fraction_sum{lab}", 0.0),
            s.get(f"spamm_valid_fraction_count{lab}", 0.0))


def moe_wave(cfg, pcfg, params, prompts, sc, label, depth_cut, **kw):
    """An engine of the MoE `cfg` at SpAMM config `sc` (engine options
    `kw`): a cold wave (freeze, captures), then the measured wave with
    every count set to 0 just before it and read just after. Emits a "moe"
    line: tok/s, TTFT, decode ms/step, valid fractions (the moe_bmm
    taps' mean too), the dense-grid kernel's launches, whether decode and
    chunk steps ran as CUDA graphs, peak memory. Returns (engine, tokens,
    out, launches)."""
    import torch

    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, pcfg, params, max_len=kw.pop("max_len", MAX_LEN),
                 spamm_cfg=sc, **kw)
    logged_wave(eng, prompts, MAX_NEW)
    s0, n0 = moe_site_cells(eng) if sc is not None else (0.0, 0.0)
    toks, _, out, counts, dt = logged_wave(eng, prompts, MAX_NEW)
    s1, n1 = moe_site_cells(eng) if sc is not None else (0.0, 0.0)
    sp = out["spamm"] or {}
    emit({"moe": cfg.name, "run": label, "card": CARD,
          "layers": cfg.num_layers, "depth_cut": depth_cut,
          "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
          "top_k": cfg.moe.top_k, "expert_ff": cfg.moe.expert_ff,
          "shared_ff": cfg.moe.shared_ff,
          "moe_bmm": None if sc is None else sc.moe_bmm,
          **wave_numbers(toks, out, dt),
          "prefill_valid_fraction": sp.get("valid_fraction"),
          "decode_valid_fraction": sp.get("decode_valid_fraction"),
          "moe_bmm_valid_fraction": ((s1 - s0) / (n1 - n0)
                                     if n1 > n0 else None),
          "moe_bmm_taps": n1 - n0,
          "dense_grid_launches": counts["spamm_mm"],
          "launches": counts, "step_graphs": out["graphs"],
          "graphs": eng.graph_stats(),
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return eng, toks, out, counts


def decode_step_ranges(eng, tokens, ranges):
    """Device milliseconds of one eager decode step of the wave's engine
    under torch.profiler, by range: `ranges` maps a name to the (module,
    function) whose calls the range wraps, each range's time being the
    device time of the kernels it launches (inclusive: a range inside
    another counts in both). The repository's own kernels launch through
    ctypes, outside any PyTorch op, so the profiler may not attribute them
    to a range: their device time is also summed by kernel name. Returns
    ({name: ms, "decode_step": ms}, kernel ms outside every range name, or
    "not measured", {kernel name part: ms} of the hand-written kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    keys = {f"chip_smoke::{n}": oa for n, oa in ranges.items()}
    saved = {k: getattr(o, a) for k, (o, a) in keys.items()}

    def traced(name):
        fn = saved[name]

        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)

        return run

    eng.cuda_graphs = False
    step = eng._wave_decode_step(BATCH)
    with torch.inference_mode():
        step(tokens=tokens, pos=PROMPT_LEN)
        torch.cuda.synchronize()
        for name, (o, a) in keys.items():
            setattr(o, a, traced(name))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("chip_smoke::decode_step"):
                    step(tokens=tokens, pos=PROMPT_LEN)
                torch.cuda.synchronize()
        finally:
            for name, (o, a) in keys.items():
                setattr(o, a, saved[name])
            eng.cuda_graphs = True
    events = prof.key_averages()

    def inclusive(key):
        return sum(e.device_time_total / 1e3 for e in events
                   if e.key == key and e.device_type == DeviceType.CPU)

    names = list(keys) + ["chip_smoke::decode_step"]
    ms = {n.split("::")[1]: inclusive(n) for n in names}
    kernels = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and e.key not in names) / 1e3
    own = {part: sum(e.self_device_time_total for e in events
                     if e.device_type == DeviceType.CUDA
                     and part in e.key) / 1e3
           for part in ("tile_norms", "spamm_worklist", "spamm_dense")}
    return ms, (kernels if kernels > 0 else "not measured"), own


def moe_decode_profile(eng, tokens, label):
    """Where a qwen2-moe decode step's device time goes: one eager decode
    step of the wave's engine (`decode_step_ranges`), with ranges around
    the routing (`models.moe._dispatch`), the routed experts' dense bmms
    (`_grouped_ffn`), the shared expert (`_shared_ffn`) and the frozen
    attention gates (`core.plan._plan_frozen`); the captured step's replay
    beside it. The expectation (not a claim): the routed experts' GEMMs
    read every expert's weights, 3·E·d·ff·4 bytes a layer."""
    from repro_torch.core import plan as P
    from repro_torch.models import moe as MoE

    cfg = eng.cfg
    ms, kernels, own = decode_step_ranges(eng, tokens, {
        "moe_dispatch": (MoE, "_dispatch"),
        "moe_experts": (MoE, "_grouped_ffn"),
        "moe_shared": (MoE, "_shared_ffn"),
        "attention_gates": (P, "_plan_frozen")})
    nbytes = 3 * cfg.moe.num_experts * cfg.d_model * cfg.moe.expert_ff * 4
    replay = replay_profile(eng._steps[(("wave", BATCH), True)]._graph)
    res = {"run": label, "card": CARD, "eager_step_device_ms": ms,
           "eager_step_kernel_ms": kernels,
           "hand_written_kernel_ms": own, "graphed_step": replay,
           "expert_weight_bytes_per_step": nbytes * cfg.num_layers,
           "expert_bytes_bound_ms":
               nbytes * cfg.num_layers / PEAK_BYTES_S * 1e3}
    emit({"moe_decode_profile": res})
    return res


def moe_per_expert(cfg, pcfg, params, prompts, tau):
    """The per-expert path (moe_bmm=False: every expert's three GEMMs plan
    eagerly, 3·E plans a layer) against moe_bmm=True at the same τ on the
    first MOE_PER_EXPERT_LAYERS layers: tokens and prefill logits, and
    layer 0's block output on one input, bit for bit (dense-grid ≡
    work-list)."""
    import dataclasses

    import torch

    from repro_torch.configs import SpammConfig
    from repro_torch.core.module import SpammContext
    from repro_torch.models import moe as MoE

    n = min(MOE_PER_EXPERT_LAYERS, cfg.num_layers)
    cfg4 = dataclasses.replace(cfg, num_layers=n)
    params4 = dict(params, layers=params["layers"][:n])
    cut = f"{n} of {cfg.num_layers} layers"
    runs = {}
    for bmm in (False, True):
        sc = SpammConfig(enable=True, tau=tau, tile=TILE, moe_bmm=bmm)
        eng, toks, out, counts = moe_wave(
            cfg4, pcfg, params4, prompts, sc,
            f"tau={tau:.6g} moe_bmm={bmm}", cut)
        runs[bmm] = (toks, prefill_logits(cfg4, pcfg, params4, prompts, eng),
                     counts)
        del eng
        torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    x = torch.randn(BATCH, PROMPT_LEN, cfg.d_model, generator=gen,
                    device=DEV)
    blocks = {}
    with torch.inference_mode():
        for bmm in (False, True):
            ctx = SpammContext(SpammConfig(enable=True, tau=tau, tile=TILE,
                                           moe_bmm=bmm))
            blocks[bmm] = MoE.moe_block(params["layers"][0]["moe"], x,
                                        cfg.moe, cfg.act, spamm_cfg=ctx)[0]
    res = {"layers": n, "tau": tau,
           "tokens_equal": all(bool((a == b).all()) for a, b in
                               zip(runs[False][0], runs[True][0])),
           "prefill_logits_bit_identical": torch.equal(runs[False][1],
                                                       runs[True][1]),
           "layer0_block_bit_identical": torch.equal(blocks[False],
                                                     blocks[True]),
           "layer0_block_max_abs_diff": float(
               (blocks[False] - blocks[True]).abs().max()),
           "launches_per_expert": runs[False][2],
           "launches_moe_bmm": runs[True][2]}
    emit({"moe_per_expert_vs_bmm": res})
    check(res["tokens_equal"] and res["prefill_logits_bit_identical"]
          and res["layer0_block_bit_identical"]
          and runs[False][2]["spamm_mm"] == 0
          and runs[True][2]["spamm_mm"] == 3 * n,
          f"per-expert path differs from moe_bmm: {res}")


def moe_chunked(cfg, pcfg, params, taus):
    """The chunked plane on qwen2-moe-a2.7b: FAMILY_CHUNK_PLENS prompts
    through two slots, SpAMM off and at each τ of `taus` with moe_bmm;
    graphed ≡ eager bit for bit; the chunk steps are captured only with
    SpAMM off (gated MoE chunk steps plan on the host)."""
    import numpy as np
    import torch

    from repro_torch.configs import SpammConfig

    rng = np.random.default_rng(SEED)
    mixed = [rng.integers(1, cfg.vocab, n).astype(np.int32)
             for n in FAMILY_CHUNK_PLENS]
    for tau in (None,) + tuple(taus):
        sc = (None if tau is None else
              SpammConfig(enable=True, tau=tau, tile=TILE, moe_bmm=True))
        label = "dense" if tau is None else f"tau={tau:.6g}"
        eng, _, out, counts = moe_wave(cfg, pcfg, params, mixed, sc,
                                       f"chunked {label}", None,
                                       max_len=CHUNK_MAX_LEN, max_slots=2)
        want = {"decode": True, "chunk": tau is None}
        check(out["graphs"] == want and eng.chunk_steps > 0,
              f"qwen2-moe chunked {label}: graphs {out['graphs']}")
        if tau is not None:
            check(counts["spamm_mm"] > 0 and counts["spamm_mm"] % (
                3 * cfg.num_layers) == 0,
                f"qwen2-moe chunked {label}: launches {counts}")
        compare_graphed_eager(eng, mixed, f"qwen2-moe chunked {label}")
        del eng
        torch.cuda.empty_cache()


def moe_model(arch, depth, pcfg):
    """(cfg, params, depth cut) of `arch` at full width and `depth` layers
    (None: all), random weights from SEED on the card; emits a "model"
    line."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full,
                                                         num_layers=depth)
    cut = None if depth is None else f"{depth} of {full.num_layers} layers"
    t0 = time.perf_counter()
    params = M.init_params(cfg, pcfg, SEED, device=DEV)
    torch.cuda.synchronize()
    emit({"model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "vocab": cfg.vocab,
          "moe": {"experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                  "expert_ff": cfg.moe.expert_ff,
                  "shared_ff": cfg.moe.shared_ff, "impl": cfg.moe.impl},
          "sliding_window": cfg.sliding_window,
          "params": sum(t.numel() for t in _leaves(params)),
          "param_gb": sum(t.numel() * t.element_size()
                          for t in _leaves(params)) / 1e9,
          "init_s": time.perf_counter() - t0, "depth_cut": cut})
    return cfg, params, cut


def moe_tau0(cfg, pcfg, params, prompts, cut, dense_toks, dense_logits):
    """τ = 0 with moe_bmm on the wave: tokens equal dense, prefill logits
    within LOGIT_RTOL, every tile kept, three dense-grid launches a layer."""
    import numpy as np

    from repro_torch.configs import SpammConfig

    sc0 = SpammConfig(enable=True, tau=0.0, tile=TILE, moe_bmm=True)
    eng, toks0, out0, c0 = moe_wave(cfg, pcfg, params, prompts, sc0,
                                    "tau=0 moe_bmm", cut)
    _, rel = errors(prefill_logits(cfg, pcfg, params, prompts, eng),
                    dense_logits)
    same = bool((np.stack(toks0) == dense_toks).all())
    emit({"moe_tau0_vs_dense": {"model": cfg.name,
                                "prefill_logits_max_rel_err": rel,
                                "tolerance_rel": LOGIT_RTOL,
                                "tokens_equal": same}})
    check(rel <= LOGIT_RTOL and same
          and out0["spamm"]["valid_fraction"] == 1.0
          and c0["spamm_mm"] == 3 * cfg.num_layers
          and c0["spamm_mm_worklist"] > 0 and c0["tile_norms"] > 0,
          f"{cfg.name} at τ = 0: rel {rel}, tokens equal {same}, "
          f"launches {c0}")


def phase_moe():
    """The MoE family at full width, random weights from SEED, run (c)'s
    wave shape, graphed decode, after a warm-up wave. qwen2-moe-a2.7b at
    MOE_LAYERS of its 24 layers (≈ 57.3 GB of f32 whole): dense; τ = 0
    with moe_bmm (tokens equal dense, prefill logits within LOGIT_RTOL);
    the median τ of the first gated decode GEMM with moe_bmm (graphed ≡
    eager bit for bit, three dense-grid launches a layer per prefill), its
    decode step profiled;
    the per-expert path at that τ on MOE_PER_EXPERT_LAYERS layers (≡
    moe_bmm bit for bit); the chunked plane (SpAMM off, τ = 0, that τ;
    graphed ≡ eager). Then mixtral-8x22b at full width and
    MOE_MIXTRAL_LAYERS layers (sliding-window ring decode, 8 experts top-2):
    dense, τ = 0 with moe_bmm. Each model is freed before the next is
    built. Returns the launches of the qwen2-moe τ > 0 wave."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ParallelConfig, SpammConfig

    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=PROMPT_LEN)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, cut = moe_model(MOE_ARCH, MOE_LAYERS, pcfg)
    prompts = np.random.default_rng(SEED).integers(
        1, cfg.vocab, size=(BATCH, PROMPT_LEN)).astype(np.int32)
    eng, dense_toks, out, _ = moe_wave(cfg, pcfg, params, prompts, None,
                                       "dense", cut)
    check(out["graphs"] == {"decode": True, "chunk": True},
          f"qwen2-moe dense graphs {out['graphs']}")
    dense_toks = np.stack(dense_toks)
    del eng
    dense_logits = prefill_logits(cfg, pcfg, params, prompts)
    moe_tau0(cfg, pcfg, params, prompts, cut, dense_toks, dense_logits)
    torch.cuda.empty_cache()

    tau, _ = derive_tau(cfg, params, prompts, dense_toks[:, 0])
    sct = SpammConfig(enable=True, tau=tau, tile=TILE, moe_bmm=True)
    eng, _, out, counts = moe_wave(cfg, pcfg, params, prompts, sct,
                                   f"tau={tau:.6g} moe_bmm", cut)
    sp = out["spamm"]
    check(0.0 < sp["valid_fraction"] <= 1.0
          and 0.0 < sp["decode_valid_fraction"] < 1.0
          and counts["spamm_mm"] == 3 * cfg.num_layers
          and counts["tile_norms"] > 0 and counts["spamm_mm_worklist"] > 0
          and out["graphs"] == {"decode": True, "chunk": False},
          f"qwen2-moe τ > 0: valid fractions {sp['valid_fraction']}, "
          f"{sp['decode_valid_fraction']}, launches {counts}, graphs "
          f"{out['graphs']}")
    compare_graphed_eager(eng, prompts, f"qwen2-moe tau={tau:.6g}")
    moe_decode_profile(eng, dense_toks[:, :1], f"tau={tau:.6g} moe_bmm")
    del eng
    torch.cuda.empty_cache()
    moe_per_expert(cfg, pcfg, params, prompts, tau)
    moe_chunked(cfg, pcfg, params, (0.0, tau))
    emit({"moe_done": {"model": cfg.name, "layers": cfg.num_layers,
                       "seconds": time.perf_counter() - t0,
                       "peak_allocated_gb":
                           torch.cuda.max_memory_allocated() / 1e9}})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    cfg_m, params_m, cut_m = moe_model("mixtral-8x22b", MOE_MIXTRAL_LAYERS,
                                       pcfg)
    prompts_m = np.random.default_rng(SEED).integers(
        1, cfg_m.vocab, size=(BATCH, PROMPT_LEN)).astype(np.int32)
    eng, toks_m, _, _ = moe_wave(cfg_m, pcfg, params_m, prompts_m, None,
                                 "dense", cut_m)
    check(all(c["k"].shape[1] <= cfg_m.sliding_window
              for c in eng._caches[("wave", BATCH)]["layers"]),
          "mixtral decode cache is not the window's ring")
    del eng
    logits_m = prefill_logits(cfg_m, pcfg, params_m, prompts_m)
    moe_tau0(cfg_m, pcfg, params_m, prompts_m, cut_m, np.stack(toks_m),
             logits_m)
    emit({"moe_done": {"model": cfg_m.name, "layers": cfg_m.num_layers,
                       "seconds": time.perf_counter() - t0,
                       "peak_allocated_gb":
                           torch.cuda.max_memory_allocated() / 1e9}})
    del params_m
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the last four families
# ---------------------------------------------------------------------------

def family_model(arch, pcfg):
    """(cfg, params) of `arch`, whole or at LAST_FAMILY_DEPTH, random
    weights from SEED on the card; emits a "model" line."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    full = get_config(arch)
    depth = LAST_FAMILY_DEPTH.get(arch)
    cfg = (full if depth is None
           else dataclasses.replace(full, num_layers=depth))
    t0 = time.perf_counter()
    params = M.init_params(cfg, pcfg, SEED, device=DEV)
    torch.cuda.synchronize()
    sub = {k: dataclasses.asdict(getattr(cfg, k)) for k in ("ssm", "rglru")
           if getattr(cfg, k) is not None}
    emit({"model": cfg.name, "family": cfg.family, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "act": cfg.act, "frontend": cfg.frontend,
          "sliding_window": cfg.sliding_window, **sub,
          "params": sum(t.numel() for t in _leaves(params)),
          "param_gb": sum(t.numel() * t.element_size()
                          for t in _leaves(params)) / 1e9,
          "init_s": time.perf_counter() - t0,
          "depth_cut": (None if depth is None
                        else f"{depth} of {full.num_layers} layers")})
    return cfg, params


def decode_median_tau(eng, prompts):
    """derive_tau's rule read from the gate itself, so that it holds on a
    stack whose layer 0 has no wq: the median norm product of the first
    gated GEMM of a decode step, recorded (`core.plan._plan_frozen`) in an
    eager wave of `eng` (τ = 0, every step kept) with two new tokens — the
    first call on a one-tile row grid is the first decode step's first
    gated GEMM."""
    from repro_torch.core import plan as P
    from repro_torch.serving.engine import Request

    first = []
    orig = P._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        if fp.gm == 1 and not first:
            prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k,
                                                              fp.step_j]
            first.append((prod[fp.step_real], list(a.shape),
                          [fp.gk * fp.tile, fp.gnb * fp.tile * fp.block_n]))
        return p

    eng.cuda_graphs = False
    P._plan_frozen = recording
    try:
        eng.generate([Request(prompt=p, max_new_tokens=2) for p in prompts])
    finally:
        P._plan_frozen = orig
        eng.cuda_graphs = True
    prods, act, wshape = first[0]
    tau = float(prods.flatten().median())
    emit({"tau_derivation": {
        "model": eng.cfg.name, "gemm": "first gated GEMM of the first "
        "decode step", "activation": act, "weight_shape": wshape,
        "rule": "median of norm_a[i,k]*norm_b[k,j] over all (i,j,k)",
        "products": int(prods.numel()), "tau": tau}})
    return tau


def embeds_equal_tokens(cfg, pcfg, params, prompts, eng):
    """The stub frontends' path: a prefill fed `embeds = embedding[tokens]`
    ≡ the token prefill bit for bit (logits), dense and through `eng`'s
    frozen plans."""
    import torch

    from repro_torch.models import model as M

    tok = torch.as_tensor(prompts, device=DEV)
    emb = params["embed"]["embedding"][tok.long()]
    res = {}
    for label, ctx, frozen in (
            ("dense", None, None),
            ("gated", eng.spamm_ctx, eng._frozen_for(prompts.size))):
        step = M.make_prefill_step(cfg, pcfg, spamm_cfg=ctx)
        with torch.inference_mode():
            _, lt = step(params, {"tokens": tok}, frozen)
            _, le = step(params, {"embeds": emb}, frozen)
        res[label] = bool(torch.equal(lt, le))
    emit({"embeds_vs_tokens": {"model": cfg.name, "frontend": cfg.frontend,
                               "bit_identical": res}})
    check(all(res.values()), f"{cfg.name} embeds prefill differs: {res}")


def family_tau0(cfg, pcfg, params, prompts, dense_toks, dense_logits):
    """τ = 0 ≡ dense: tokens equal, prefill logits within LOGIT_RTOL,
    every tile kept, rows 1 and 2 launched. Returns the engine."""
    from repro_torch.configs import SpammConfig

    sc0 = SpammConfig(enable=True, tau=0.0, tile=TILE)
    eng, toks0, out0, c0 = family_wave(cfg, pcfg, params, prompts, sc0,
                                       "tau=0", None, FAMILY_MAX_LEN,
                                       "family")
    _, rel = errors(prefill_logits(cfg, pcfg, params, prompts, eng),
                    dense_logits)
    same = bool((toks0 == dense_toks).all())
    emit({"family_tau0_vs_dense": {
        "model": cfg.name, "prefill_logits_max_rel_err": rel,
        "tolerance_rel": LOGIT_RTOL, "tokens_equal": same}})
    check(rel <= LOGIT_RTOL and same
          and out0["spamm"]["valid_fraction"] == 1.0
          and c0["tile_norms"] > 0 and c0["spamm_mm_worklist"] > 0,
          f"{cfg.name} at τ = 0: rel {rel}, tokens equal {same}, "
          f"launches {c0}")
    return eng


def gated_family(cfg, pcfg, params, prompts):
    """An attention or hybrid model whole: dense; τ = 0 ≡ dense; the median
    decode τ (graphed ≡ eager bit for bit). Returns (τ, the τ > 0 engine,
    its launches, the dense tokens)."""
    import torch

    from repro_torch.configs import SpammConfig
    from repro_torch.plans.precompute import frozen_leaves

    eng, dense_toks, _, _ = family_wave(cfg, pcfg, params, prompts, None,
                                        "dense", None, FAMILY_MAX_LEN,
                                        "family")
    del eng
    dense_logits = prefill_logits(cfg, pcfg, params, prompts)
    eng = family_tau0(cfg, pcfg, params, prompts, dense_toks, dense_logits)
    tau = decode_median_tau(eng, prompts)
    del eng
    torch.cuda.empty_cache()
    sct = SpammConfig(enable=True, tau=tau, tile=TILE)
    eng, _, out, counts = family_wave(cfg, pcfg, params, prompts, sct,
                                      f"tau={tau:.6g}", None, FAMILY_MAX_LEN,
                                      "family")
    sp = out["spamm"]
    gemms = len(list(frozen_leaves(eng._fw_tree)))
    emit({"family_launches": {
        "model": cfg.name, "tau": tau, "gated_weights": gemms,
        "expected_rows_1_2": gemms * MAX_NEW,
        "measured": {k: counts[k] for k in ("tile_norms",
                                            "spamm_mm_worklist")}}})
    check(0.0 < sp["valid_fraction"] <= 1.0
          and 0.0 < sp["decode_valid_fraction"] < 1.0
          and counts["tile_norms"] > 0 and counts["spamm_mm_worklist"] > 0,
          f"{cfg.name} τ > 0: valid fractions {sp['valid_fraction']}, "
          f"{sp['decode_valid_fraction']}, launches {counts}")
    compare_graphed_eager(eng, prompts, f"{cfg.name} tau={tau:.6g}")
    return tau, eng, counts, dense_toks


def family_chunked_tau0(cfg, pcfg, params):
    """The chunked plane at τ = 0: FAMILY_CHUNK_PLENS prompts through two
    slots, graphed ≡ eager bit for bit, each request's tokens ≡ its solo
    wave's."""
    import numpy as np

    from repro_torch.configs import SpammConfig
    from repro_torch.serving.engine import Engine, Request

    rng = np.random.default_rng(SEED)
    mixed = [rng.integers(1, cfg.vocab, n).astype(np.int32)
             for n in FAMILY_CHUNK_PLENS]
    eng = Engine(cfg, pcfg, params, max_len=CHUNK_MAX_LEN,
                 spamm_cfg=SpammConfig(enable=True, tau=0.0, tile=TILE),
                 max_slots=2)
    toks = logged_wave(eng, mixed, MAX_NEW)[0]
    compare_graphed_eager(eng, mixed, f"{cfg.name} chunked tau=0")
    solo = [np.asarray(eng.generate([Request(prompt=p,
                                             max_new_tokens=MAX_NEW)])[0])
            for p in mixed]
    same = [bool(np.array_equal(a, b)) for a, b in zip(toks, solo)]
    emit({"family_chunked_tau0": {"model": cfg.name,
                                  "prompt_lens": list(FAMILY_CHUNK_PLENS),
                                  "slots": 2, "chunks": eng.chunk_steps,
                                  "tokens_equal_solo_wave": same}})
    check(all(same), f"{cfg.name} chunked τ = 0 differs from solo waves")


def hybrid_decode_profile(eng, tokens, label):
    """Where a recurrentgemma decode step's device time goes
    (`decode_step_ranges`): the RG-LRU blocks (`rglru_decode_step`), the
    attention layers (`attention_decode`, their frozen gates and
    work-lists included), the MLPs (`layers.mlp`, gates and work-lists
    included), and across both the frozen gates (`core.plan._plan_frozen`)
    and the work-lists (`core.plan.execute`); the get-norm and work-list
    kernels by name; the captured step's replay beside it."""
    from repro_torch.core import plan as P
    from repro_torch.models import rglru, transformer

    ms, kernels, own = decode_step_ranges(eng, tokens, {
        "rglru_blocks": (rglru, "rglru_decode_step"),
        "attention_layers": (transformer, "attention_decode"),
        "mlps": (transformer, "mlp"),
        "frozen_gates": (P, "_plan_frozen"),
        "work_lists": (P, "execute")})
    replay = replay_profile(eng._steps[(("wave", BATCH), True)]._graph)
    res = {"run": label, "card": CARD, "eager_step_device_ms": ms,
           "eager_step_kernel_ms": kernels,
           "hand_written_kernel_ms": own, "graphed_step": replay,
           "note": "frozen_gates and work_lists lie inside the attention "
                   "and MLP ranges; the hand-written kernels by name"}
    emit({"hybrid_decode_profile": res})
    return res


def phase_last_families():
    """The last four families at full width, whole or at
    LAST_FAMILY_DEPTH, random f32 weights from SEED, one at a time
    (memory freed between them), run
    (c)'s wave shape at max_len FAMILY_MAX_LEN, graphed after a warm-up.
    llava-next-mistral-7b and musicgen-large (stub frontends): dense, τ = 0
    ≡ dense, the median decode τ graphed ≡ eager, a prefill fed
    `embeds = embedding[tokens]` ≡ the token prefill; musicgen also the
    chunked plane at τ = 0. recurrentgemma-9b ((rec, rec, attn) groups + 2
    rec): the same, every gated weight frozen, the ring decode cache, a
    decode step's device time by range, and a mixed-length batch and
    `prefill_chunk` refused. mamba2-1.3b: dense at BATCH × PROMPT_LEN and
    at BATCH × SSM_LONG_PROMPT (one carried SSD chunk and a remainder),
    graphed ≡ eager; SpAMM on at recurrentgemma's τ ≡ dense bit for bit
    with no get-norm or work-list launch; `prefill_chunk` refused. Returns
    {arch: launches of its τ > 0 wave}."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ParallelConfig, SpammConfig
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.plans.precompute import frozen_leaves, iter_gated_weights
    from repro_torch.serving.engine import Engine, Request

    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=PROMPT_LEN)
    launches, taus = {}, {}

    def prompts_of(cfg, n=PROMPT_LEN):
        return np.random.default_rng(SEED).integers(
            1, cfg.vocab, size=(BATCH, n)).astype(np.int32)

    def refused(cfg, what, words, fn):
        try:
            fn()
        except ValueError as e:
            emit({"refused": {"model": cfg.name, "what": what,
                              "error": str(e)}})
            check(words in str(e), f"{cfg.name} refused {what}: {e}")
            return
        raise SmokeFailure(f"{cfg.name} accepted {what}")

    for arch in LAST_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, params = family_model(arch, pcfg)
        prompts = prompts_of(cfg)
        if cfg.family != "ssm":
            tau, eng, counts, dense_toks = gated_family(cfg, pcfg, params,
                                                        prompts)
            launches[arch], taus[arch] = counts, tau
            if cfg.frontend is not None:
                embeds_equal_tokens(cfg, pcfg, params, prompts, eng)
            if cfg.family == "hybrid":
                n = len(list(frozen_leaves(eng._fw_tree)))
                gated = len(list(iter_gated_weights(params)))
                attn = [c for c in eng._caches[("wave", BATCH)]["layers"]
                        if "k" in c]
                emit({"hybrid": {"model": cfg.name, "frozen_weights": n,
                                 "gated_weights": gated,
                                 "attention_layers": len(attn),
                                 "decode_cache_len": attn[0]["k"].shape[1],
                                 "window": cfg.sliding_window}})
                check(n == gated and len(attn) == layer_kinds(cfg).count(
                    "attn") and all(
                    c["k"].shape[1] == FAMILY_MAX_LEN <= cfg.sliding_window
                    for c in attn), f"{cfg.name} frozen {n}, attention "
                    f"caches {[c['k'].shape for c in attn]}")
                hybrid_decode_profile(eng, dense_toks[:, :1],
                                      f"tau={tau:.6g}")
            del eng
            torch.cuda.empty_cache()
            if cfg.name == "musicgen-large":
                family_chunked_tau0(cfg, pcfg, params)
        else:
            sc = SpammConfig(enable=True, tau=taus["recurrentgemma-9b"],
                             tile=TILE)
            eng, dense_toks, _, _ = family_wave(
                cfg, pcfg, params, prompts, None, "dense", None,
                FAMILY_MAX_LEN, "family")
            compare_graphed_eager(eng, prompts, f"{cfg.name} dense")
            d_toks, d_logits, *_ = logged_wave(eng, prompts, MAX_NEW)
            del eng
            long = prompts_of(cfg, SSM_LONG_PROMPT)
            eng, _, _, _ = family_wave(cfg, pcfg, params, long, None,
                                       f"dense {SSM_LONG_PROMPT} tokens",
                                       None, FAMILY_MAX_LEN, "family")
            compare_graphed_eager(eng, long,
                                  f"{cfg.name} dense {SSM_LONG_PROMPT}")
            del eng
            eng, s_toks, out, counts = family_wave(
                cfg, pcfg, params, prompts, sc, f"tau={sc.tau:.6g}", None,
                FAMILY_MAX_LEN, "family")
            g_toks, g_logits, *_ = logged_wave(eng, prompts, MAX_NEW)
            same = (all(np.array_equal(a, b) for a, b in zip(g_toks, d_toks))
                    and len(g_logits) == len(d_logits)
                    and all(torch.equal(a, b)
                            for a, b in zip(g_logits, d_logits))
                    and bool(torch.equal(
                        prefill_logits(cfg, pcfg, params, prompts, eng),
                        prefill_logits(cfg, pcfg, params, prompts))))
            sp = out["spamm"]
            emit({"ssm_spamm_vs_dense": {
                "model": cfg.name, "tau": sc.tau, "bit_identical": same,
                "gated_gemms": sp["gated_gemms"],
                "decode_gated_gemms": sp["decode_gated_gemms"],
                "launches": counts}})
            check(same and sp["gated_gemms"] == 0
                  and sp["decode_gated_gemms"] == 0
                  and counts["tile_norms"] == 0
                  and counts["spamm_mm_worklist"] == 0
                  and counts["spamm_mm_worklist_decode"] == 0,
                  f"{cfg.name} with SpAMM on: equal {same}, stats "
                  f"{sp['gated_gemms']}, launches {counts}")
            launches[arch] = counts
            del eng
        if cfg.family in ("ssm", "hybrid"):
            refused(cfg, "prefill_chunk", "attention stack", lambda: Engine(
                cfg, pcfg, params, max_len=FAMILY_MAX_LEN,
                prefill_chunk=TILE))
            mixed = [p[:n] for p, n in zip(prompts, (
                PROMPT_LEN, PROMPT_LEN * 3 // 4, PROMPT_LEN // 2, PROMPT_LEN))]
            eng = Engine(cfg, pcfg, params, max_len=FAMILY_MAX_LEN)
            refused(cfg, "a mixed-length batch", "cannot chunk",
                    lambda: eng.generate([Request(prompt=p,
                                                  max_new_tokens=MAX_NEW)
                                          for p in mixed]))
            del eng
        emit({"family_done": {"model": cfg.name, "layers": cfg.num_layers,
                              "seconds": time.perf_counter() - t0,
                              "peak_allocated_gb":
                                  torch.cuda.max_memory_allocated() / 1e9}})
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# multi: the distributed library call and the pod-sharded engine
# ---------------------------------------------------------------------------

def _multi_rank(rank, n, tau):
    """(m2) and (m3) on one of MULTI_RANKS gloo ranks sharing cuda:0: the
    library run's operands made on the card (every rank the same), the
    flat product, then the main path with every count at 0 just before it
    and read just after: spamm_rowpart under each schedule and at int8 and
    bf16 on a MULTI_RANKS-rank 1-D mesh; spamm_2d on a 2×2 mesh. Rank 0
    then times every rank's strip under each schedule (the row-2 device
    time, one profiler session while the other ranks wait, so no two
    ranks share the card while timed) and returns the predicted loads."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.core import plan as P
    from repro_torch.core import schedule as S
    from repro_torch.core.spamm import spamm
    from repro_torch.device import f32_numerics
    from repro_torch.kernels import getnorm
    from repro_torch.launch.mesh import make_mesh

    f32_numerics()
    a = algebraic_decay_on_card(n, SEED)
    b = algebraic_decay_on_card(n, SEED + 1)
    t0 = time.perf_counter()
    c_flat, info = spamm(a, b, tau, tile=TILE)
    # the flat low-precision products: per-tile quantization, the widened
    # gate and each output tile's k order do not depend on the other rows,
    # so each rank's strip equals them bit for bit
    flat_lowp = {dtype: spamm(a, b, tau, tile=TILE, compute_dtype=dtype)
                 for dtype in LOWP_DTYPES}
    out = {"rank": rank, "flat_valid_fraction": float(info.valid_fraction),
           "schedules": {}, "lowp": {}, "seconds": {}}
    out["seconds"]["operands_and_flat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make_mesh((MULTI_RANKS,), ("data",), backend="gloo",
                     device_type="cuda")
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    for s in MULTI_SCHEDULES:
        c, frac = D.spamm_rowpart(a, b, tau, mesh, axis="data", tile=TILE,
                                  schedule=s)
        out["schedules"][s] = {"bit_identical": bool(torch.equal(c, c_flat)),
                               "valid_fraction": float(frac)}
        del c
    for dtype in LOWP_DTYPES:
        c, frac = D.spamm_rowpart(a, b, tau, mesh, axis="data", tile=TILE,
                                  compute_dtype=dtype)
        want, winfo = flat_lowp.pop(dtype)
        out["lowp"][dtype] = {
            "bit_identical": bool(torch.equal(c, want)),
            "max_abs_err": float((c - want).abs().max()),
            "valid_fraction": float(frac),
            "flat_valid_fraction": float(winfo.valid_fraction),
            "max_abs_diff_from_f32": float((c - c_flat).abs().max())}
        del c, want
    torch.cuda.synchronize()
    out["m2_launches"] = read_counts()
    out["seconds"]["m2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh2 = make_mesh((2, 2), ("data", "model"), backend="gloo",
                      device_type="cuda")
    dist.barrier()
    reset_counts()
    c, frac = D.spamm_2d(a, b, tau, mesh2, tile=TILE)
    torch.cuda.synchronize()
    out["m3_launches"] = read_counts()
    out["m3"] = {"max_abs_err": float((c - c_flat).abs().max()),
                 "bit_identical": bool(torch.equal(c, c_flat)),
                 "valid_fraction": float(frac)}
    del c, c_flat
    torch.cuda.empty_cache()
    out["seconds"]["m3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gm = n // TILE
    torch.cuda.synchronize()
    dist.barrier()
    if rank == 0:
        # one job per distinct strip (schedules that cut alike share it)
        jobs, strip_of, out["strip_rows"] = {}, {}, {}
        for s in MULTI_SCHEDULES:
            for r in range(MULTI_RANKS):
                rows, _, _ = D._row_layout(a, b, tau, MULTI_RANKS, r,
                                           tile=TILE, backend="auto",
                                           sched_levels=3, schedule=s,
                                           offsets=None)
                key = strip_of[s, r] = np.asarray(rows, np.int64).tobytes()
                if key not in jobs:
                    a_loc = a.reshape(gm, TILE, n)[torch.as_tensor(
                        rows, device=a.device)].reshape(-1, n)
                    jobs[key] = (P.plan(a_loc, b, tau, tile=TILE), a_loc)
                out["strip_rows"][s, r] = int(rows.shape[0])
        ms = dict(zip(jobs, kernel_device_ms_each(
            [lambda p=p, x=x: P.execute(p, x, b) for p, x in jobs.values()],
            "spamm_worklist", calls=5)))
        out["kernel_ms"] = {sr: ms[k] for sr, k in strip_of.items()}
        out["distinct_strips"] = len(jobs)
        del jobs
        torch.cuda.synchronize()
    dist.barrier()
    out["seconds"]["timed_strips"] = time.perf_counter() - t0
    if rank == 0:
        v, lv, _ = D._work_estimate(a, b, tau, MULTI_RANKS, tile=TILE,
                                    backend="auto", sched_levels=3)
        pick, offs = D._pick_schedule(a, b, tau, MULTI_RANKS, tile=TILE,
                                      backend="auto", sched_levels=3)
        # the estimate the schedules decide from (level lv), and the fine
        # one (level 0) for the same row ownership
        v0 = S.v_matrix(getnorm.tile_norms_cuda(a, TILE),
                        getnorm.tile_norms_cuda(b, TILE), tau)
        pred = {}
        for s in MULTI_SCHEDULES:
            sched = pick if s == "auto" else s
            own = offs if s == "auto" else None
            loads = S.device_loads(v, MULTI_RANKS, sched, level=lv,
                                   fine_rows=gm, offsets=own)
            if sched == "equal_work" and own is None:
                own = S.equal_work_partition(v, MULTI_RANKS, level=lv,
                                             fine_rows=gm)
            fine = S.device_loads(v0, MULTI_RANKS, sched, offsets=own)
            pred[s] = {"schedule": sched, "level": lv,
                       "loads": [float(x) for x in loads],
                       "imbalance": float(loads.max()
                                          / max(loads.mean(), 1e-9)),
                       "level0_loads": [float(x) for x in fine],
                       "level0_imbalance": float(fine.max()
                                                 / max(fine.mean(), 1e-9))}
        out["predicted"] = pred
        out["auto_offsets"] = None if offs is None else np.asarray(
            offs).tolist()
    return out


def multi_library():
    """(m1)-(m3): the library run's operands (the paper's §4.1 ensemble at
    N = LIB_N) at the τ its flat spamm(valid_ratio=0.30) finds. (m1) a
    1×1 mesh on NCCL in this process: spamm_rowpart and spamm_2d ≡ the
    flat product bit for bit. (m2)/(m3) MULTI_RANKS gloo ranks spawned on
    the one card (`_multi_rank`), kernels built here first. Returns
    {cell: launches}."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core.spamm import spamm
    from repro_torch.launch import mesh as MS

    a = algebraic_decay_on_card(LIB_N, SEED)
    b = algebraic_decay_on_card(LIB_N, SEED + 1)
    c_flat, info = spamm(a, b, valid_ratio=LIB_RATIOS[0], tile=TILE)
    tau = float(info.tau)
    MS.init_group("nccl", rank=0, world_size=1, addr="localhost",
                  port=MS.free_port(), device=torch.device("cuda", 0))
    try:
        mesh = MS.make_host_mesh(backend="nccl", device_type="cuda")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        c_row, f_row = D.spamm_rowpart(a, b, tau, mesh, axis="data",
                                       tile=TILE)
        c_2d, f_2d = D.spamm_2d(a, b, tau, mesh, tile=TILE)
        torch.cuda.synchronize()
        m1_s = time.perf_counter() - t0
        m1 = read_counts()
    finally:
        MS.destroy_group()
    res = {"card": CARD, "n": LIB_N, "tile": TILE, "tau": tau,
           "valid_ratio": LIB_RATIOS[0], "backend": "nccl", "world": 1,
           "seconds": m1_s, "launches": m1,
           "rowpart_bit_identical": bool(torch.equal(c_row, c_flat)),
           "spamm_2d_bit_identical": bool(torch.equal(c_2d, c_flat)),
           "spamm_2d_max_abs_err": float((c_2d - c_flat).abs().max()),
           "valid_fraction": [float(info.valid_fraction), float(f_row),
                              float(f_2d)]}
    emit({"multi_m1": res})
    check(res["rowpart_bit_identical"]
          and res["spamm_2d_max_abs_err"] <= 1e-4
          and float(f_row) == float(info.valid_fraction),
          f"(m1) on NCCL: {res}")
    del a, b, c_flat, c_row, c_2d
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = MS.spawn_ranks(_multi_rank, MULTI_RANKS, backend="gloo",
                           devices=[torch.device("cuda", 0)] * MULTI_RANKS,
                           args=(LIB_N, tau), timeout_s=600)
    spawn_s = time.perf_counter() - t0
    pred = ranks[0]["predicted"]
    sched = {}
    for s in MULTI_SCHEDULES:
        ms = [ranks[0]["kernel_ms"][s, r] for r in range(MULTI_RANKS)]
        meas = (max(ms) / (sum(ms) / len(ms))
                if all(isinstance(x, float) for x in ms) else "not measured")
        sched[s] = {"picked": pred[s]["schedule"],
                    "bit_identical": [r["schedules"][s]["bit_identical"]
                                      for r in ranks],
                    "valid_fraction": ranks[0]["schedules"][s]
                    ["valid_fraction"],
                    "strip_rows": [ranks[0]["strip_rows"][s, r]
                                   for r in range(MULTI_RANKS)],
                    "predicted_loads": pred[s]["loads"],
                    "predicted_imbalance": pred[s]["imbalance"],
                    "level0_predicted_loads": pred[s]["level0_loads"],
                    "level0_predicted_imbalance":
                        pred[s]["level0_imbalance"],
                    "rank_worklist_ms": ms, "measured_imbalance": meas}
    m2 = {k: sum(r["m2_launches"][k] for r in ranks) for k in ranks[0][
        "m2_launches"]}
    m3 = {k: sum(r["m3_launches"][k] for r in ranks) for k in ranks[0][
        "m3_launches"]}
    emit({"multi_m2": {"card": CARD, "n": LIB_N, "tile": TILE, "tau": tau,
                       "ranks": MULTI_RANKS, "backend": "gloo",
                       "devices": "cuda:0 shared", "seconds": spawn_s,
                       "level": pred["auto"]["level"],
                       "auto_offsets": ranks[0]["auto_offsets"],
                       "distinct_strips_timed": ranks[0]["distinct_strips"],
                       "schedules": sched,
                       "lowp": {r["rank"]: r["lowp"] for r in ranks},
                       "rank_seconds": [r["seconds"] for r in ranks],
                       "launches": m2,
                       "note": "ranks time their strips one after another "
                               "(barriers); not a multi-card time"}})
    emit({"multi_m3": {"card": CARD, "mesh": [2, 2], "backend": "gloo",
                       "per_rank": [r["m3"] for r in ranks],
                       "launches": m3}})
    check(all(all(v["bit_identical"]) for v in sched.values()),
          f"(m2) rowpart differs from the flat product: {sched}")
    check(all(r["lowp"][d]["bit_identical"]
              for r in ranks for d in LOWP_DTYPES),
          f"(m2) low-precision rowpart differs from the flat product: "
          f"{[r['lowp'] for r in ranks]}")
    check(all(r["m3"]["max_abs_err"] <= 1e-4 for r in ranks),
          f"(m3) spamm_2d: {[r['m3'] for r in ranks]}")
    check(all(m2[k] > 0 for k in ("tile_norms", "spamm_mm_worklist",
                                  "pool_norms", "tile_norms_quant",
                                  "spamm_mm_worklist_int8",
                                  "spamm_mm_worklist_bf16")),
          f"(m2) launches {m2}")
    return {"m1": m1, "m2": m2, "m3": m3}


def probe_scales(params, tau, cfg):
    """The hot and cold factors of the embedding profile: the median tile
    norm of 4096 embedding rows times the median tile norm of the
    unembedding, scaled to MULTI_HOT·τ and MULTI_COLD·τ."""
    import torch

    from repro_torch.kernels import getnorm

    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    ids = torch.randint(0, cfg.vocab, (4096,), generator=gen, device=DEV)
    na = getnorm.tile_norms_cuda(params["embed"]["embedding"][ids], TILE)
    nb = getnorm.tile_norms_cuda(params["unembed"]["kernel"], TILE)
    base = float(na.median()) * float(nb.median())
    return MULTI_HOT * tau / base, MULTI_COLD * tau / base


def multi_engine():
    """(m4): starcoder2-7b at full width, MULTI_LAYERS layers, τ derived as
    run (c)'s, the embedding's hot/cold profile, one wave whose first half
    of the prompts is hot. The unsharded engine serves it; the sharded
    engine (mesh_devices=MULTI_SHARDS on [cuda:0] × MULTI_SHARDS,
    re-sharding every 2 engine steps) serves it with every count at 0
    just before and read just after: tokens ≡ unsharded bit for bit,
    captures fixed across the re-cuts, at least one re-cut that moved
    request groups. Then each shard's captured decode step replayed
    (device ms against the live predicted imbalance) and, at the live
    cut, the same wave graphed ≡ eager, whose graphed launches split
    evenly over the shards. Returns the launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ParallelConfig, SpammConfig, get_config
    from repro_torch.core.schedule import ReshardConfig
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), num_layers=MULTI_LAYERS)
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=MULTI_PLEN)
    params = M.init_params(cfg, pcfg, SEED, device=DEV)
    rng = np.random.default_rng(SEED)
    half = cfg.vocab // 2
    cold = rng.integers(1, half, size=(MULTI_BATCH, MULTI_PLEN)).astype(
        np.int32)
    first = prefill_logits(cfg, pcfg, params, cold).argmax(-1).cpu().numpy()
    tau, _ = derive_tau(cfg, params, cold, first[:, None])
    hot_f, cold_f = probe_scales(params, tau, cfg)
    scale = torch.full((cfg.vocab, 1), cold_f, device=DEV)
    scale[half:] = hot_f
    params["embed"]["embedding"].mul_(scale)
    prompts = cold.copy()
    prompts[:MULTI_BATCH // 2] = rng.integers(
        half, cfg.vocab, size=(MULTI_BATCH // 2, MULTI_PLEN))
    emit({"model": cfg.name, "phase": "multi", "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "tau": tau,
          "embedding_profile": {"cold": cold_f, "hot": hot_f},
          "depth_cut": f"{MULTI_LAYERS} of 32 layers"})
    max_len = MULTI_PLEN + MULTI_NEW + 16
    seconds = {"setup": time.perf_counter() - t_phase}

    def serve(eng):
        reqs = [Request(prompt=p, max_new_tokens=MULTI_NEW) for p in prompts]
        t0 = time.perf_counter()
        toks = np.stack(eng.generate(reqs))
        return toks, reqs[0].out, time.perf_counter() - t0

    ref = Engine(cfg, pcfg, params, max_len=max_len,
                 spamm_cfg=SpammConfig(enable=True, tau=tau, tile=TILE))
    ref_toks, ref_meta, seconds["unsharded_wave"] = serve(ref)
    del ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sh = Engine(cfg, pcfg, params, max_len=max_len,
                spamm_cfg=SpammConfig(enable=True, tau=tau, tile=TILE),
                mesh_devices=MULTI_SHARDS,
                devices=[torch.device("cuda", 0)] * MULTI_SHARDS,
                reshard_cfg=ReshardConfig(every=2, drift_threshold=1.0,
                                          probe_window=MULTI_PROBE_WINDOW))
    moves = []
    refresh = sh._refresh_shard

    def counting():
        src = refresh()
        if src is not None:
            moves.append([int(x) for x in sh._shard["offs_g"]])
        return src

    sh._refresh_shard = counting     # the group-level cuts that moved
    seconds["sharded_init"] = time.perf_counter() - t0
    reset_counts()
    toks, meta, seconds["sharded_wave"] = serve(sh)
    torch.cuda.synchronize()
    counts = read_counts()
    captures = sh.graph_stats()["captures"]
    rs = sh._resharder
    per = sh.shard_layout["slot_width"]
    t0 = time.perf_counter()
    # the median CUDA-event ms of one replay over 20 (a replay's ≈ 20 ms
    # of device work dwarfs its launch)
    shard_ms = [time_ms(sh._steps[(("shard_wave", d, per, False),
                                   True)]._graph.replay, reps=20, warmup=2)
                for d in range(MULTI_SHARDS)]
    seconds["shard_replay"] = time.perf_counter() - t0
    res = {"card": CARD, "tau": tau, "batch": MULTI_BATCH,
           "prompt_len": MULTI_PLEN, "new_tokens": MULTI_NEW,
           "hot_prompts": MULTI_BATCH // 2,
           "shards": MULTI_SHARDS, "devices": "cuda:0 shared",
           "tokens_equal_unsharded": bool(np.array_equal(toks, ref_toks)),
           "captures": captures,
           "resharded": rs.resharded, "reshard_probes": rs.probes,
           "group_cuts_moved_to": moves,
           "history": [{k: h[k] for k in ("step", "grid", "live_imbalance",
                                          "fresh_imbalance", "resharded")}
                       for h in rs.history],
           "layout": {"offsets": [int(x) for x in
                                  sh.shard_layout["offsets"]],
                      "slot_width": per},
           "live_imbalance": rs.live_imbalance,
           "live_loads": [float(x) for x in rs.live_loads],
           "shard_decode_replay_ms": shard_ms,
           "measured_shard_imbalance": max(shard_ms) / (sum(shard_ms)
                                                        / len(shard_ms)),
           "decode_ms_per_step": {
               "sharded": (meta["latency"]["decode_mean_s"] or 0) * 1e3,
               "unsharded": (ref_meta["latency"]["decode_mean_s"] or 0)
               * 1e3},
           "spamm": {k: meta["spamm"][k] for k in (
               "valid_fraction", "decode_valid_fraction", "gated_gemms",
               "decode_gated_gemms", "resharded", "reshard_probes",
               "partition_imbalance")},
           "launches": counts,
           "note": "the shards share one card and run one after another: "
                   "decode ms/step is the shards' sum, not a multi-card "
                   "time"}
    check(res["tokens_equal_unsharded"],
          f"(m4) sharded tokens differ from the unsharded engine's: {res}")
    check(captures == MULTI_SHARDS and rs.resharded >= 1 and moves,
          f"(m4) captures {captures}, re-cuts {rs.resharded}, group cuts "
          f"moved {moves}")
    sh._resharder = None           # graphed ≡ eager at the live cut
    t0 = time.perf_counter()
    try:
        ge = compare_graphed_eager(sh, prompts,
                                   f"m4 sharded x{MULTI_SHARDS}",
                                   max_new=MULTI_NEW)
    finally:
        sh._resharder = rs
    seconds["graphed_vs_eager"] = time.perf_counter() - t0
    # the graphed wave at a fixed cut: every launch is one shard's
    fixed = ge["launches"]
    res.update(captures_after_graphed_vs_eager=sh.graph_stats()["captures"],
               fixed_cut_launches=fixed,
               fixed_cut_launches_per_shard={
                   k: fixed[k] / MULTI_SHARDS
                   for k in ("tile_norms", "spamm_mm_worklist")},
               seconds={**seconds, "total": time.perf_counter() - t_phase})
    emit({"multi_m4": res})
    check(res["captures_after_graphed_vs_eager"] == MULTI_SHARDS
          and fixed["spamm_mm_worklist"] > 0
          and fixed["tile_norms"] % MULTI_SHARDS == 0
          and fixed["spamm_mm_worklist"] % MULTI_SHARDS == 0,
          f"(m4) fixed-cut launches {fixed}, captures "
          f"{res['captures_after_graphed_vs_eager']}")
    del sh, params
    torch.cuda.empty_cache()
    return counts


def multi_train():
    """(m5): the train phase's model (starcoder2-7b, TRAIN_LAYERS layers,
    TRAIN_BATCH × TRAIN_SEQ tokens a step, remat full) through the train
    loop for MULTI_TRAIN_STEPS steps at (t3)'s rule for τ, with re-sharding
    every step over 4 strips and without: the losses, every step's
    gradient norm and the final parameters bit for bit. Returns the
    launches of the re-sharding run."""
    import dataclasses

    import torch

    from repro_torch.configs import (ParallelConfig, SpammConfig,
                                     TrainConfig, get_config)
    from repro_torch.core.schedule import ReshardConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import getnorm
    from repro_torch.models import model as M
    from repro_torch.models.layers import rms_norm
    from repro_torch.train import loop

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    pcfg = ParallelConfig(compute_dtype="float32", remat="full",
                          attn_q_chunk=64, loss_chunk=128)
    base = M.init_params(cfg, pcfg, SEED, device=DEV)
    batch = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                        device=DEV).batch_at(0)
    p0 = base["layers"][0]
    x0 = rms_norm(M._inputs(base, batch, torch.float32), p0["ln1"],
                  cfg.norm_eps).reshape(-1, cfg.d_model)
    tau = median_product_tau(getnorm.tile_norms_cuda(x0, TILE),
                             getnorm.tile_norms_cuda(p0["mix"]["wq"], TILE))
    del base, x0
    torch.cuda.empty_cache()
    runs, seconds = {}, {}
    for label, rc in (("reshard", ReshardConfig(num_devices=4, every=1)),
                      ("off", None)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = loop.train(
            cfg, pcfg, TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                   total_steps=MULTI_TRAIN_STEPS,
                                   ckpt_every=0),
            global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            spamm_cfg=SpammConfig(enable=True, tau=tau, tile=TILE,
                                  backend="auto", bwd="spamm"),
            reshard_cfg=rc, log_every=0, device=DEV)
        torch.cuda.synchronize()
        res.opt_state = None  # the card keeps one run's moments at a time
        runs[label] = (res, read_counts())
        seconds[label] = time.perf_counter() - t0
    (on, counts), (off, _) = runs["reshard"], runs["off"]
    same_params = all(torch.equal(x, y) for x, y in zip(
        _leaves(on.params), _leaves(off.params)))
    res = {"card": CARD, "layers": TRAIN_LAYERS, "tau": tau,
           "steps": MULTI_TRAIN_STEPS, "losses": on.losses,
           "losses_off": off.losses, "grad_norms": on.grad_norms,
           "grad_norms_off": off.grad_norms,
           "final_params_bit_identical": same_params,
           "reshard": [{k: s.get(k) for k in ("imbalance", "resharded",
                                               "offsets", "loads")}
                       for s in on.spamm_stats],
           "launches": counts, "seconds": seconds}
    emit({"multi_m5": res})
    check(on.losses == off.losses
          and on.grad_norms == off.grad_norms and same_params
          and all(s["imbalance"] is not None for s in on.spamm_stats),
          f"(m5) re-sharding changed the training run: {res}")
    del on, off, runs
    torch.cuda.empty_cache()
    return counts


def phase_multi():
    """The multi-GPU slice on the one card: (m1)-(m3) the distributed
    library call (`multi_library`), (m4) the pod-sharded engine
    (`multi_engine`), (m5) the train loop with re-sharding (`multi_train`).
    Returns {cell: launches}."""
    counts = multi_library()
    counts["m4"] = multi_engine()
    counts["m5"] = multi_train()
    return counts


# ---------------------------------------------------------------------------
# tp: model parallelism of the model over a (data, model) mesh
# ---------------------------------------------------------------------------

def _tp_ctx(mesh, cfg, pcfg, params=None):
    """The NetCtx of `mesh` with the placements of `params` (or of the
    model's own shapes)."""
    from repro_torch.launch import mesh as MS
    from repro_torch.models import model as M

    ctx = MS.make_ctx(mesh, tile=TILE)
    if params is None:
        return M.with_placements(ctx, cfg, pcfg)
    return ctx.replace(specs=M.placements(cfg, pcfg, params, ctx,
                                          tile=TILE))


def _tp_rows(t, ctx):
    w = t.shape[0] // ctx.ndata
    return t[ctx.data_index * w:(ctx.data_index + 1) * w]


def _tp_specialize(tree, gm):
    if isinstance(tree, dict):
        return {k: _tp_specialize(v, gm) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tp_specialize(v, gm) for v in tree]
    return tree.for_rows(gm)


def _tp_serve(cfg, pcfg, params, prompts, feed, spamm_cfg, ctx=None):
    """Prefill of `prompts`, then TP_NEW decode steps fed `feed` (B, TP_NEW)
    (each step's input token; None: greedy, the previous logits' argmax),
    decode gated through frozen plans of the weights this rank computes
    with. Returns (prefill logits, [decode logits], prefill taps, the fed
    tokens) as host arrays."""
    import numpy as np
    import torch

    from repro_torch.core.module import SpammContext
    from repro_torch.models import model as M
    from repro_torch.plans.precompute import freeze_tree

    sc = SpammContext(spamm_cfg) if spamm_cfg is not None else None
    with torch.no_grad():
        if sc is not None:
            sc.begin_stats()
        cache, logits = M.make_prefill_step(cfg, pcfg, spamm_cfg=sc,
                                            ctx=ctx)(
            params, {"tokens": torch.as_tensor(prompts, device=DEV)})
        taps = [t.value for t in sc.end_stats()] if sc is not None else []
        cache = M.place_cache(cache, cfg, pcfg, TP_MAX_LEN, ctx=ctx)
        frozen = None
        if sc is not None:
            fw, _ = freeze_tree(M.compute_params(params, cfg, ctx),
                                spamm_cfg)
            frozen = _tp_specialize(fw, -(-prompts.shape[0] // TILE))
        step = M.make_decode_step(cfg, pcfg, spamm_cfg=sc, ctx=ctx)
        greedy = feed is None
        if greedy:
            feed = np.zeros((prompts.shape[0], TP_NEW), np.int64)
        lg = logits
        dec = []
        for i in range(TP_NEW):
            if greedy:
                feed[:, i] = lg.argmax(-1).cpu().numpy()
            lg, cache = step(params, torch.as_tensor(
                feed[:, i:i + 1], device=DEV), cache, TP_PLEN + i, frozen)
            dec.append(lg.cpu().numpy())
    torch.cuda.synchronize()
    return logits.cpu().numpy(), dec, taps, feed


def _tp_train(cfg, pcfg, tcfg, ctx=None):
    """TP_TRAIN_STEPS steps of the train loop (`train.loop.train`) from
    init_params(SEED), over `ctx`'s mesh when given; returns (losses,
    params, opt_state) after the last step."""
    from repro_torch.train import loop

    res = loop.train(cfg, pcfg, tcfg, global_batch=TP_BATCH,
                     seq_len=TP_TRAIN_SEQ, log_every=0, device=DEV, ctx=ctx)
    return res.losses, res.params, res.opt_state


def _tp_int8_step(cfg, pcfg, tcfg, params, state, batch, ctx=None):
    """One AdamW step with int8_ef compression (fresh residuals) from
    `params`/`state` (updated in place), at step TP_TRAIN_STEPS of a
    schedule two steps longer (so its learning rate is not 0). Returns its
    loss, the loss of a following forward on the same batch, the
    parameters before the step, and the parameters and state after it."""
    import dataclasses

    import torch

    from repro_torch import tree as T
    from repro_torch.distributed.compression import Int8EF
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW

    opt = AdamW(dataclasses.replace(tcfg, total_steps=TP_TRAIN_STEPS + 2),
                compression=Int8EF())
    st = dict(state, ef=T.map_(torch.zeros_like, state["mu"]))
    before = T.map_(lambda t: t.detach().clone(), params)
    step = M.make_train_step(cfg, pcfg, opt, ctx=ctx)
    params, st, met = step(params, st, batch, TP_TRAIN_STEPS)
    with torch.no_grad():
        nxt, _ = M.loss_fn(cfg, pcfg, params, batch, ctx=ctx)
    torch.cuda.synchronize()
    return float(met["loss"]), float(nxt), before, params, st


def _tp_sumsq(params, before, ef, specs, coord=None):
    """{path: [Σ ef², Σ (params − before)²]} over each leaf as held (a
    rank's shards), or over the shard at `coord` of whole leaves, in
    f64."""
    out = {}
    for path, spec in _tp_spec_items(specs):
        p, b, e = (_tp_leaf(t, path).detach() for t in (params, before, ef))
        if coord is not None:
            p, b, e = (_tp_cut(t, spec, coord) for t in (p, b, e))
        p, b, e = p.double(), b.double(), e.double()
        out[path] = [float((e * e).sum()), float(((p - b) ** 2).sum())]
    return out


class _TpCoord:
    """The (data, model) coordinates of one rank of TP_MESH, for `_tp_cut`
    in the process that holds the whole trees."""

    def __init__(self, data, model):
        self._ix = {"data": data, "model": model}

    def size(self, ax):
        return TP_MESH[("data", "model").index(ax)]

    def index(self, ax):
        return self._ix[ax]


def _tp_rel(got, want, scale=None):
    """|got − want| / |scale| (scale: want); 0 or inf where the scale is
    0."""
    scale = want if scale is None else scale
    d = abs(got - want)
    return d / abs(scale) if scale else (0.0 if d == 0 else float("inf"))


def _tp_configs():
    import dataclasses

    from repro_torch.configs import ParallelConfig, TrainConfig, get_config

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TP_LAYERS)
    serve = ParallelConfig(compute_dtype="float32", attn_q_chunk=TP_PLEN,
                           fsdp=False, decode_seq_shard=True)
    train = ParallelConfig(compute_dtype="float32", remat="full",
                           attn_q_chunk=TP_TRAIN_SEQ, loss_chunk=128,
                           fsdp=True)
    tcfg = TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                       total_steps=TP_TRAIN_STEPS, ckpt_every=0)
    moe = dataclasses.replace(get_config(MOE_ARCH), num_layers=TP_MOE_LAYERS)
    return cfg, serve, train, tcfg, moe


def _tp_rank(rank, job):
    """One of TP_RANKS gloo ranks on cuda:0, a 2×2 (data, model) mesh:
    (p1)/(p2) serving, (p3) training and (p5) the elastic move of its
    state, (p4) the MoE block split both ways, then serve_tp's (s1)/(s2)
    (`_serve_tp_rank`). Every launch count is set to 0 just before each
    run and read just after. Returns host arrays (logits of model rank 0
    only) and numbers."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.configs import SpammConfig
    from repro_torch.core.module import SpammContext
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.device import f32_numerics
    from repro_torch.distributed import elastic as E
    from repro_torch.launch import mesh as MS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    f32_numerics()
    cfg, spcfg, tpcfg, tcfg, moe_cfg = _tp_configs()
    out = {"rank": rank, "seconds": {}, "launches": {}}
    mesh = make_mesh(TP_MESH, ("data", "model"), backend="gloo",
                     device_type="cuda")
    t0 = time.perf_counter()
    ctx = _tp_ctx(mesh, cfg, spcfg)
    local = M.init_params(cfg, spcfg, SEED, device=DEV, ctx=ctx)
    out["data_index"], out["mrank"] = ctx.data_index, ctx.mrank
    keep = ctx.mrank == 0
    prompts = _tp_rows(job["prompts"], ctx)
    out["seconds"]["setup"] = time.perf_counter() - t0

    # (p1) dense, τ = 0, τ > 0; (p2) SP prefill
    for mode, tau in (("dense", None), ("tau0", 0.0), ("tau", job["tau"])):
        sc = (None if tau is None
              else SpammConfig(enable=True, tau=tau, tile=TILE))
        feed = _tp_rows(job["feed"][mode], ctx)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        reset_counts()
        pre, dec, taps, _ = _tp_serve(cfg, spcfg, local, prompts, feed, sc,
                                      ctx)
        out["launches"]["p1_" + mode] = read_counts()
        out["seconds"]["p1_" + mode] = time.perf_counter() - t0
        out["p1_" + mode] = {"taps": taps,
                             "argmax": [d.argmax(-1).tolist() for d in dec]}
        if keep:
            out["p1_" + mode].update(prefill=pre, decode=dec)
        if mode != "tau0":
            sp = dataclasses.replace(spcfg, seq_shard_acts=True)
            dist.barrier()
            t0 = time.perf_counter()
            reset_counts()
            with torch.no_grad():
                _, lg = M.make_prefill_step(
                    cfg, sp, spamm_cfg=(SpammContext(sc) if sc else None),
                    ctx=ctx)(local, {"tokens": torch.as_tensor(prompts,
                                                               device=DEV)})
            torch.cuda.synchronize()
            out["launches"]["p2_" + mode] = read_counts()
            out["seconds"]["p2_" + mode] = time.perf_counter() - t0
            lg = lg.cpu().numpy()
            out["p2_" + mode] = {"max_abs_vs_p1": float(np.abs(lg - pre)
                                                       .max())}
            if keep:
                out["p2_" + mode]["prefill"] = lg
    del local
    torch.cuda.empty_cache()

    # (p3) the train loop with FSDP, then an int8_ef step
    dist.barrier()
    t0 = time.perf_counter()
    reset_counts()
    tctx = _tp_ctx(mesh, cfg, tpcfg)
    torch.cuda.reset_peak_memory_stats()
    losses, params, state = _tp_train(cfg, tpcfg, tcfg, tctx)
    out["launches"]["p3"] = read_counts()
    out["p3"] = {"losses": losses,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    ref = torch.load(job["train_ref"], mmap=True)
    worst, mu_err = {}, {}
    for path, spec in _tp_spec_items(tctx.specs):
        want = _tp_cut(ref["params/" + path], spec, tctx).to(DEV)
        got = _tp_leaf(params, path).detach()
        worst[path] = float((got - want).abs().max())
        want = _tp_cut(ref["mu/" + path], spec, tctx).to(DEV).double()
        got = _tp_leaf(state["mu"], path).double()
        mu_err[path] = _tp_rel(float((got - want).norm()), 0.0,
                               float(want.norm()))
    del ref, want, got
    out["p3"]["param_max_abs_err"] = max(worst.values())
    out["p3"]["param_worst_leaf"] = max(worst, key=worst.get)
    out["p3"]["mu_rel_err"] = max(mu_err.values())
    out["p3"]["mu_worst_leaf"] = max(mu_err, key=mu_err.get)
    batch = SyntheticLM(cfg, TP_BATCH, TP_TRAIN_SEQ, seed=tcfg.seed,
                        device=DEV).batch_at(TP_TRAIN_STEPS)
    batch = {k: _tp_rows(v, tctx) for k, v in batch.items()}
    loss8, next8, before, p8, st8 = _tp_int8_step(
        cfg, tpcfg, tcfg, T.map_(lambda t: t.detach().clone(), params),
        {k: T.map_(lambda t: t.clone(), v) for k, v in state.items()},
        batch, tctx)
    out["p3"]["int8"] = {"loss": loss8, "next_loss": next8,
                         "coord": (tctx.index("data"), tctx.mrank),
                         "sumsq": _tp_sumsq(p8, before, st8["ef"],
                                            tctx.specs)}
    del before, p8, st8
    out["seconds"]["p3"] = time.perf_counter() - t0

    # (p5) the state onto the surviving ranks 0-2: each rank writes its
    # shards (the sharded checkpoint), the survivors put the whole state
    # together from the four files and re-place it on the best mesh
    dist.barrier()
    t0 = time.perf_counter()
    flat = {f"{name}/{path}": t.detach().cpu() for name, tree in
            (("params", params), ("mu", state["mu"]), ("nu", state["nu"]))
            for path, t in T.flatten_with_paths(tree)}
    flat["coords"] = (tctx.index("data"), tctx.mrank)
    torch.save(flat, os.path.join(job["shard_dir"], f"rank{rank}.pt"))
    del flat, params, state
    torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"]["p5_write"] = time.perf_counter() - t0
    new_mesh = E.build_elastic_mesh(range(3), model_parallel=TP_MESH[1],
                                    device_type="cuda")
    out["p5"] = {"mesh": list(new_mesh.shape)}
    if new_mesh.get_coordinate() is not None:
        files = [torch.load(os.path.join(job["shard_dir"], f"rank{r}.pt"),
                            mmap=True) for r in range(TP_RANKS)]
        by_coord = {f["coords"]: f for f in files}
        whole = {name: _tp_tree(by_coord, name, tctx.specs)
                 for name in ("params", "mu", "nu")}
        del files, by_coord
        moved = E.reshard_state(
            {"params": whole["params"],
             "opt_state": {"mu": whole["mu"], "nu": whole["nu"]}},
            cfg, tpcfg, new_mesh, tile=TILE, device=DEV)
        c3 = MS.make_ctx(new_mesh, tile=TILE, specs=moved["specs"])
        same = True
        for path, spec in _tp_spec_items(c3.specs):
            for name, got in (("params", moved["params"]),
                              ("mu", moved["opt_state"]["mu"]),
                              ("nu", moved["opt_state"]["nu"])):
                want = _tp_slice3(_tp_leaf(whole[name], path), spec,
                                  c3.data_index)
                same &= torch.equal(_tp_leaf(got, path).cpu(), want)
        out["p5"]["bitwise"] = bool(same)
        del whole
        out["seconds"]["p5_move"] = time.perf_counter() - t0
        from repro_torch.optim.adamw import AdamW

        step = M.make_train_step(cfg, tpcfg, AdamW(tcfg), ctx=c3)
        b3 = SyntheticLM(cfg, 3, TP_TRAIN_SEQ, seed=tcfg.seed,
                         device=DEV).batch_at(TP_TRAIN_STEPS)
        b3 = {k: _tp_rows(v, c3) for k, v in b3.items()}
        _, _, met = step(moved["params"], moved["opt_state"], b3,
                         TP_TRAIN_STEPS)
        out["p5"]["loss"] = float(met["loss"])
        del moved, step
    torch.cuda.empty_cache()
    dist.barrier()
    out["seconds"]["p5"] = time.perf_counter() - t0

    # (p4) the MoE block split over "model": tp, then ep
    dist.barrier()
    t0 = time.perf_counter()
    mprompts = _tp_rows(job["moe_prompts"], ctx)
    sc = SpammConfig(enable=True, tau=job["moe_tau"], tile=TILE,
                     moe_bmm=True)
    impls = {impl: dataclasses.replace(moe_cfg, moe=dataclasses.replace(
        moe_cfg.moe, impl=impl)) for impl in ("tp", "ep")}
    for impl, c in impls.items():
        mctx = _tp_ctx(mesh, c, spcfg)
        loc = M.init_params(c, spcfg, SEED, device=DEV, ctx=mctx)
        torch.cuda.synchronize()
        dist.barrier()
        t1 = time.perf_counter()
        reset_counts()
        msc = SpammContext(sc)
        msc.begin_stats()
        with torch.no_grad():
            _, lg = M.make_prefill_step(c, spcfg, spamm_cfg=msc, ctx=mctx)(
                loc, {"tokens": torch.as_tensor(mprompts, device=DEV)})
        torch.cuda.synchronize()
        out["launches"]["p4_" + impl] = read_counts()
        out["p4_taps_" + impl] = [(t.site, t.value)
                                  for t in msc.end_stats()]
        out["seconds"]["p4_" + impl] = time.perf_counter() - t1
        with torch.no_grad():
            _, dense = M.make_prefill_step(c, spcfg, ctx=mctx)(
                loc, {"tokens": torch.as_tensor(mprompts, device=DEV)})
        if keep:
            out["p4_" + impl] = lg.cpu().numpy()
            out["p4_dense_" + impl] = dense.cpu().numpy()
        del loc
        torch.cuda.empty_cache()
    out["seconds"]["p4"] = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    out["serve_tp"] = _serve_tp_rank(job["serve_tp"])
    out["seconds"]["serve_tp"] = time.perf_counter() - t0
    return out


def _tp_spec_items(specs, prefix=""):
    """[(path, placement)] of a placement tree, paths as
    `tree.flatten_with_paths` writes them."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _tp_spec_items(specs[k], f"{prefix}{k}/")]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs)
                for x in _tp_spec_items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], specs)]


def _tp_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _tp_cut(t, spec, ctx):
    """The rank's shard of a whole leaf (the placement's cut)."""
    for dim, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            n, i = ctx.size(ax), ctx.index(ax)
            w = t.shape[dim] // n
            t = t.narrow(dim, i * w, w)
    return t


def _tp_tree(by_coord, name, specs):
    """The whole `name` tree ("params", "mu" or "nu") put together from the
    ranks' saved shards, {(data, model) coordinate: flat shard dict}: each
    leaf's shards concatenated along its placed dims."""
    def whole(spec, prefix):
        if isinstance(spec, dict):
            return {k: whole(v, f"{prefix}{k}/") for k, v in spec.items()}
        if isinstance(spec, list):
            return [whole(v, f"{prefix}{i}/") for i, v in enumerate(spec)]
        key = f"{name}/{prefix[:-1]}"
        dims = {e: d for d, e in enumerate(spec) if e is not None}
        rows = []
        for di in range(TP_MESH[0]) if "data" in dims else (0,):
            parts = [by_coord[di, mi][key] for mi in
                     (range(TP_MESH[1]) if "model" in dims else (0,))]
            rows.append(torch.cat(parts, dims["model"]) if "model" in dims
                        else parts[0])
        return torch.cat(rows, dims["data"]) if "data" in dims else rows[0]

    import torch

    return whole(specs, "")


def _tp_slice3(t, spec, r):
    """What data rank r of a (3, 1) mesh must hold of a whole leaf: chunk r
    of 3 along the dim placed on "data", else all of it (written apart
    from `shard_params`)."""
    for dim, entry in enumerate(spec):
        if entry == "data":
            w = t.shape[dim] // 3
            return t[(slice(None),) * dim + (slice(r * w, (r + 1) * w),)]
    return t


# ---------------------------------------------------------------------------
# serve_tp: the serving engine over a model axis (inside tp's spawn)
# ---------------------------------------------------------------------------

def _st_configs():
    """(s1)'s and (s2)'s model configs at ST_LAYERS layers, the serving
    ParallelConfig, and the wave and chunked-plane prompts."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ParallelConfig, get_config

    dense = dataclasses.replace(get_config(ARCH), num_layers=ST_LAYERS)
    moe = dataclasses.replace(get_config(MOE_ARCH), num_layers=ST_LAYERS)
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=ST_PLEN,
                          fsdp=False, decode_seq_shard=True)
    rng = np.random.default_rng(SEED + 11)
    wave = list(rng.integers(1, dense.vocab, size=(ST_BATCH, ST_PLEN))
                .astype(np.int32))
    mixed = [rng.integers(1, dense.vocab, size=n).astype(np.int32)
             for n in ST_CHUNK_PLENS]
    moe_wave = list(rng.integers(1, moe.vocab, size=(ST_BATCH, ST_PLEN))
                    .astype(np.int32))
    return dense, moe, pcfg, wave, mixed, moe_wave


def _st_cells(tau):
    """{cell: (arch key, impl, model ranks, spamm kwargs, plane)}."""
    return {"s1_tau0": ("dense", None, 4, dict(tau=0.0), "wave"),
            "s1_tau": ("dense", None, 4, dict(tau=tau), "wave"),
            "s1_chunked": ("dense", None, 4, dict(tau=0.0), "chunked"),
            "s2_tp": ("moe", "tp", 2, dict(tau=0.0, moe_bmm=True), "wave"),
            "s2_ep": ("moe", "ep", 2, dict(tau=0.0, moe_bmm=True), "wave")}


def _st_serve(eng, prompts, params):
    """One wave through `eng`: (tokens, out["spamm"] without its clock
    readings, out["graphs"], the wave's prefill logits through the
    engine's own step and frozen plans when its prompts are of one
    length, the launch counts read just after the wave)."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import Request

    reqs = [Request(prompt=p, max_new_tokens=ST_NEW) for p in prompts]
    toks = [o.tolist() for o in eng.generate(reqs)]
    torch.cuda.synchronize()
    launches = read_counts()
    logits = None
    if len({len(p) for p in prompts}) == 1:
        t = torch.as_tensor(np.stack(prompts), device=DEV)
        with torch.inference_mode():
            _, lg = eng._prefill(params, {"tokens": t},
                                 eng._frozen_for(t.numel()))
        logits = lg.cpu().numpy()
    return (toks, timing_free(reqs[0].out["spamm"]), reqs[0].out["graphs"],
            logits, launches)


def _st_free():
    """Drop what deleted engines still hold on the card: an engine's steps
    close over the engine, so it goes only when the cycle collector runs
    (its params, caches, graph pools and plan cache with it)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _st_engine(cfg, pcfg, params, cell, spamm_kw, ctx=None, **kw):
    """The engine of a serve_tp cell (its plane from `_st_cells`) on DEV,
    SpAMM at TILE with `spamm_kw`."""
    from repro_torch.configs import SpammConfig
    from repro_torch.serving.engine import Engine

    plane = _st_cells(0.0)[cell][4]
    extra = (dict(prefill_chunk=ST_CHUNK, max_slots=ST_SLOTS)
             if plane == "chunked" else {})
    return Engine(cfg, pcfg, params, max_len=ST_MAX_LEN, device=DEV,
                  spamm_cfg=SpammConfig(enable=True, tile=TILE, **spamm_kw),
                  ctx=ctx, **extra, **kw)


def _serve_tp_rank(job):
    """(s1) and (s2) on this rank: for each cell a (1, model)-shaped ctx of
    the 4 ranks (model 2: a 2×2 mesh whose rows are replicas), this
    rank's shards of `init_params(SEED)`, one wave through `Engine(ctx=)`;
    launch counts set to 0 just before the wave and read just after.
    Returns per cell the tokens, stats, graphs, launches, seconds and (model
    rank 0) the prefill logits."""
    import dataclasses

    import torch

    from repro_torch.launch import mesh as MS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    dense, moe, pcfg, wave, mixed, moe_wave = _st_configs()
    out = {}
    made = {}
    for cell, (arch, impl, model, spamm_kw, plane) in _st_cells(
            job["tau"]).items():
        cfg = dense if arch == "dense" else dataclasses.replace(
            moe, moe=dataclasses.replace(moe.moe, impl=impl))
        key = (arch, impl, model)
        if key not in made:
            made.clear()
            _st_free()
            mesh = make_mesh((TP_RANKS // model, model), ("data", "model"),
                             backend="gloo", device_type="cuda")
            ctx = M.with_placements(
                MS.make_ctx(mesh, tile=TILE, batch_axes=()), cfg, pcfg)
            made[key] = (ctx, M.init_params(cfg, pcfg, SEED, device=DEV,
                                            ctx=ctx))
        ctx, local = made[key]
        eng = _st_engine(cfg, pcfg, local, cell, spamm_kw, ctx=ctx)
        prompts = (mixed if plane == "chunked" else
                   moe_wave if arch == "moe" else wave)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        reset_counts()
        toks, sp, graphs, logits, launches = _st_serve(eng, prompts, local)
        out[cell] = {"tokens": toks, "spamm": sp, "graphs": graphs,
                     "launches": launches, "mrank": ctx.mrank,
                     "seconds": time.perf_counter() - t0,
                     "logits": logits if ctx.mrank == 0 else None}
        if cell == "s1_tau":
            # the activation tile norms a split prefill gates with
            norms = _st_prefill_norms(eng, wave, local)
            if ctx.mrank == 0:
                out["prefill_norms"] = norms
        del eng
        _st_free()
    made.clear()
    _st_free()
    return out


def _st_record(run, norms=False):
    """What the frozen plans evaluate during `run()`, read to the host
    with `core.plan._plan_frozen` wrapped (`run` must be eager): every
    gate product (f64, the positive ones), or with `norms` each call's
    activation normmap in call order. Returns that and run()'s value."""
    import numpy as np

    from repro_torch.core import plan as P

    got = []
    orig = P._plan_frozen

    def rec(a, fp, **kw):
        p = orig(a, fp, **kw)
        if norms:
            got.append(p.norm_a.double().cpu().numpy())
        else:
            prod = (p.norm_a[fp.step_i, fp.step_k]
                    * fp.nbmax[fp.step_k, fp.step_j])
            got.append(prod[fp.step_real].double().cpu().numpy())
        return p

    P._plan_frozen = rec
    try:
        out = run()
    finally:
        P._plan_frozen = orig
    if norms:
        return got, out
    p = np.concatenate(got)
    return p[p > 0], out


def _st_prefill_norms(eng, prompts, params):
    """The activation normmap of each frozen GEMM of one eager prefill of
    `prompts` through `eng`'s step and frozen plans, in call order."""
    import numpy as np
    import torch

    t = torch.as_tensor(np.stack(prompts), device=DEV)
    with torch.inference_mode():
        got, _ = _st_record(lambda: eng._prefill(
            params, {"tokens": t}, eng._frozen_for(t.numel())), norms=True)
    return got


def _st_gap_tau(run, tau):
    """τ moved into a gap of the gate products `run(τ)` evaluates: the
    ST_GAP_TRIES widest gaps (relative) among the 10 % of the products
    nearest τ by rank, each tried at its middle on a run of its own
    (downstream products move with the gate) until one keeps every
    product ST_GATE_MARGIN away; else the best. Returns (τ, its run's
    margin, the (τ, margin) pairs tried)."""
    import numpy as np

    p = np.sort(_st_record(lambda: run(tau))[0])
    tried = [(tau, float(np.min(np.abs(p - tau)) / tau))]
    i = int(np.searchsorted(p, tau))
    w = max(8, p.size // 20)
    lo, hi = max(i - w, 0), min(i + w, p.size - 1)
    ratio = p[lo + 1:hi + 1] / p[lo:hi]
    for g in lo + np.argsort(ratio)[::-1][:ST_GAP_TRIES]:
        t = float(np.sqrt(p[g] * p[g + 1]))
        q = _st_record(lambda: run(t))[0]
        tried.append((t, float(np.min(np.abs(q - t)) / t)))
        if tried[-1][1] >= ST_GATE_MARGIN:
            break
    tau, margin = max(tried, key=lambda x: x[1])
    return tau, margin, tried


def _serve_tp_setup():
    """The unsharded side of (s1)-(s3) on cuda:0: (s1)'s τ, each cell's
    unsharded wave (tokens, stats, prefill logits, the smallest top-2
    margin of the wave's prefill logits), and (s3). Returns (the ranks'
    job, the unsharded results)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    t0 = time.perf_counter()
    gb0 = torch.cuda.memory_allocated() / 1e9
    dense, moe, pcfg, wave, mixed, moe_wave = _st_configs()
    params = M.init_params(dense, pcfg, SEED, device=DEV)
    deng = Engine(dense, pcfg, params, max_len=ST_MAX_LEN, device=DEV)
    reqs = [Request(prompt=p, max_new_tokens=1) for p in wave]
    first = np.array([[t[0]] for t in deng.generate(reqs)])
    del deng
    _st_free()
    derived, _ = derive_tau(dense, params, np.stack(wave), first)

    def eager(tau):
        eng = _st_engine(dense, pcfg, params, "s1_tau", dict(tau=tau),
                         cuda_graphs=False)
        _st_serve(eng, wave, params)
        del eng
        _st_free()

    t1 = time.perf_counter()
    tau, margin, tried = _st_gap_tau(eager, derived)
    res = {"tau": tau, "tau_derived": derived, "gate_margin": margin,
           "gap_tries": tried, "gap_seconds": time.perf_counter() - t1}
    cells = _st_cells(tau)
    for cell, (arch, impl, model, spamm_kw, plane) in cells.items():
        if arch != "dense":
            continue
        eng = _st_engine(dense, pcfg, params, cell, spamm_kw)
        toks, sp, graphs, logits, _ = _st_serve(
            eng, mixed if plane == "chunked" else wave, params)
        res[cell] = {"tokens": toks, "spamm": sp, "graphs": graphs,
                     "logits": logits}
        if cell == "s1_tau":
            frozen_logits = logits
            res["prefill_norms"] = _st_prefill_norms(eng, wave, params)
        del eng
        _st_free()
    # (s3) the legacy path at (s1)'s τ: eager prefill gates, dense decode
    legacy = _st_engine(dense, pcfg, params, "s1_tau", dict(tau=tau),
                        freeze_plans=False)
    reset_counts()
    ltoks, lsp, _, llogits, wave_launches = _st_serve(legacy, wave, params)
    reset_counts()
    with torch.inference_mode():
        legacy._wave_decode_step(ST_BATCH)(
            tokens=np.array(first, np.int32), pos=ST_PLEN)
    torch.cuda.synchronize()
    res["s3"] = {"tokens": ltoks, "wave_launches": wave_launches,
                 "decode_step_launches": read_counts(),
                 "prefill_bitwise": bool(np.array_equal(llogits,
                                                        frozen_logits)),
                 "prefill_max_abs_diff": float(np.abs(
                     llogits - frozen_logits).max()),
                 "gated_gemms": lsp["gated_gemms"],
                 "decode_gated_gemms": lsp["decode_gated_gemms"],
                 "fw_tree_frozen": legacy._fw_tree is not None}
    del legacy, params
    _st_free()
    for cell, (arch, impl, model, spamm_kw, plane) in cells.items():
        if arch != "moe":
            continue
        cfg = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe,
                                                               impl=impl))
        mp = M.init_params(cfg, pcfg, SEED, device=DEV,
                           model_axis_size=model)
        eng = _st_engine(cfg, pcfg, mp, cell, spamm_kw)
        toks, sp, graphs, logits, _ = _st_serve(eng, moe_wave, mp)
        res[cell] = {"tokens": toks, "spamm": sp, "graphs": graphs,
                     "logits": logits}
        del eng, mp
        _st_free()
    for cell in cells:
        lg = res[cell]["logits"]
        if lg is not None:
            top = np.sort(lg, axis=-1)[:, -2:]
            res[cell]["top2_margin"] = float(
                (top[:, 1] - top[:, 0]).min() / np.abs(lg).max())
    _st_free()
    # what the unsharded side leaves allocated for the ranks' spawn
    res["main_allocated_gb"] = {"before": gb0,
                                "after": torch.cuda.memory_allocated() / 1e9}
    res["seconds"] = time.perf_counter() - t0
    return {"tau": tau}, res


def _serve_tp_check(ranks, unsharded):
    """Hold every rank's (s1)/(s2) waves against the unsharded ones and
    (s3)'s legacy engine against the frozen one; emit the phase's line.
    Returns {cell: [launches per rank]}."""
    import numpy as np

    def fractions(sp):
        return {(layer, site): (c["valid_fraction"],
                                c["decode_valid_fraction"])
                for layer, sites in sp["per_layer"].items()
                for site, c in sites.items()}

    res = {"card": CARD, "backend": "gloo",
           "devices": "cuda:0 shared by 4 ranks", "layers": ST_LAYERS,
           "tau": unsharded["tau"], "tau_derived": unsharded["tau_derived"],
           "gate_margin": unsharded["gate_margin"],
           "gap_tries": unsharded["gap_tries"],
           "gap_seconds": unsharded["gap_seconds"],
           "unsharded_seconds": unsharded["seconds"],
           "main_allocated_gb": unsharded["main_allocated_gb"],
           "note": "ranks share one card: not a multi-card time"}
    counts = {}
    for cell in _st_cells(0.0):
        want = unsharded[cell]
        got = [r["serve_tp"][cell] for r in ranks]
        lg = [g["logits"] for g in got if g["logits"] is not None]
        c = {"tokens_equal": all(g["tokens"] == want["tokens"] for g in got),
             "fractions_equal": all(fractions(g["spamm"])
                                    == fractions(want["spamm"])
                                    for g in got),
             "aggregates_equal": all(
                 g["spamm"][k] == want["spamm"][k] for g in got
                 for k in ("valid_fraction", "gated_gemms",
                           "decode_valid_fraction", "decode_gated_gemms")),
             "valid_fraction": want["spamm"]["valid_fraction"],
             "decode_valid_fraction": want["spamm"]["decode_valid_fraction"],
             "graphs": got[0]["graphs"],
             "unsharded_graphs": want["graphs"],
             "seconds": [g["seconds"] for g in got]}
        if want["logits"] is not None:
            c["prefill_rel_err"] = max(
                float(np.abs(x - want["logits"]).max()
                      / np.abs(want["logits"]).max()) for x in lg)
            c["unsharded_top2_margin"] = want["top2_margin"]
        counts[cell] = [g["launches"] for g in got]
        c["launches_per_rank"] = [{k: v for k, v in n.items() if v}
                                  for n in counts[cell]]
        res[cell] = c
    # how far the row-parallel sums move the activation tile norms the
    # gates read (the GEMMs whose activation is whole on a rank: wq, wk,
    # wv, w1), relative, on model rank 0's prefill at (s1)'s τ
    mine = next(r["serve_tp"]["prefill_norms"] for r in ranks
                if "prefill_norms" in r["serve_tp"])
    dev = [float(np.max(np.abs(a - b)[b > 0] / b[b > 0]))
           for a, b in zip(mine, unsharded["prefill_norms"])
           if a.shape == b.shape]
    res["prefill_norm_rel_dev"] = {"max": max(dev), "gemms": len(dev)}
    res["margin_over_dev"] = res["gate_margin"] / max(max(dev), 1e-30)
    res["s3"] = unsharded["s3"]
    res["seconds"] = {"per_rank": [r["seconds"]["serve_tp"] for r in ranks],
                      "unsharded": unsharded["seconds"]}
    emit({"serve_tp": res})
    for cell in _st_cells(0.0):
        c = res[cell]
        check(c["tokens_equal"], f"(serve_tp) {cell}: tokens: {c}")
        check(c["fractions_equal"] and c["aggregates_equal"],
              f"(serve_tp) {cell}: valid fractions: {c}")
        check(c.get("prefill_rel_err", 0.0) <= ST_LOGIT_RTOL,
              f"(serve_tp) {cell}: prefill logits: {c}")
        check(c["graphs"]["decode"] is False
              and "gloo" in c["graphs"].get("eager", ""),
              f"(serve_tp) {cell}: graphs under gloo: {c['graphs']}")
        check(all(n["tile_norms"] > 0 and (n["spamm_mm_worklist"] > 0
                                           or n["spamm_mm"] > 0)
                  for n in counts[cell]),
              f"(serve_tp) {cell}: a rank launched no get-norm or gated "
              f"GEMM: {c['launches_per_rank']}")
    # a product nearer τ than ten times the split's norm deviation could
    # flip its gate on a rank: no τ tried was far enough from a tie
    check(res["margin_over_dev"] >= ST_MARGIN_OVER_DEV,
          f"(s1) the gate margin is not {ST_MARGIN_OVER_DEV}× the split "
          f"prefill's norm deviation: {res['gate_margin']}, "
          f"{res['prefill_norm_rel_dev']}, tried {res['gap_tries']}")
    check(0.0 < res["s1_tau"]["valid_fraction"] < 1.0
          and 0.0 < res["s1_tau"]["decode_valid_fraction"] < 1.0,
          f"(s1) τ keeps part of prefill and decode: {res['s1_tau']}")
    s3 = res["s3"]
    check(s3["prefill_bitwise"] and s3["gated_gemms"] > 0
          and s3["decode_gated_gemms"] == 0 and not s3["fw_tree_frozen"]
          and s3["wave_launches"]["spamm_mm_worklist"] > 0
          and s3["decode_step_launches"]["spamm_mm_worklist"] == 0
          and s3["decode_step_launches"]["spamm_mm_worklist_decode"] == 0
          and s3["decode_step_launches"]["tile_norms"] == 0,
          f"(s3) the legacy path: {s3}")
    return counts


def _tp_keep_some(cfg, pcfg, params, prompts, tau, **kw):
    """τ, halved until every gated GEMM of an unsharded prefill of
    `prompts` keeps at least 5 % of its tiles (a GEMM gated to 0 would
    hide the sums of its split). Returns τ."""
    import torch

    from repro_torch.configs import SpammConfig
    from repro_torch.core.module import SpammContext
    from repro_torch.models import model as M

    for _ in range(12):
        probe = SpammContext(SpammConfig(enable=True, tau=tau, tile=TILE,
                                         **kw))
        probe.begin_stats()
        with torch.no_grad():
            M.make_prefill_step(cfg, pcfg, spamm_cfg=probe)(
                params, {"tokens": torch.as_tensor(prompts, device=DEV)})
        if min(t.value for t in probe.end_stats()) >= 0.05:
            return tau
        tau /= 2
    raise SmokeFailure(f"no τ keeps 5 % of every gated GEMM: {tau}")


def phase_tp():
    """(p1)-(p5), the model parallelism of the port on the one card (see
    the TP_* constants), and the serve_tp phase's (s1)-(s3): the unsharded
    runs on cuda:0 here, then TP_RANKS gloo ranks spawned on cuda:0
    (`_tp_rank`; the kernels are built already). Returns ({cell: launches
    summed over the ranks}, {serve_tp cell: [launches per rank]}, the
    serve_tp phase's seconds)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs import SpammConfig
    from repro_torch.kernels import getnorm
    from repro_torch.launch import mesh as MS
    from repro_torch.models import model as M
    from repro_torch.models.layers import rms_norm

    t_phase = time.perf_counter()
    _st_free()
    main_gb = torch.cuda.memory_reserved() / 1e9
    cfg, spcfg, tpcfg, tcfg, moe_cfg = _tp_configs()
    rng = np.random.default_rng(SEED + 7)
    prompts = rng.integers(1, cfg.vocab, size=(TP_BATCH, TP_PLEN))
    moe_prompts = rng.integers(1, moe_cfg.vocab, size=(TP_BATCH, TP_PLEN))
    params = M.init_params(cfg, spcfg, SEED, device=DEV)
    x0 = rms_norm(params["embed"]["embedding"][torch.as_tensor(
        prompts[:TP_BATCH // 2], device=DEV)], params["layers"][0]["ln1"],
        cfg.norm_eps).reshape(-1, cfg.d_model)
    tau = median_product_tau(
        getnorm.tile_norms_cuda(x0, TILE),
        getnorm.tile_norms_cuda(params["layers"][0]["mix"]["wq"], TILE))
    tau = _tp_keep_some(cfg, spcfg, params, prompts[:TP_BATCH // 2], tau)
    # the unsharded port on each data shard's rows (a decode row tile holds
    # only its shard's rows), greedy: its tokens feed the sharded run
    half = TP_BATCH // TP_MESH[0]
    unsharded, feed = {}, {}
    for mode, t in (("dense", None), ("tau0", 0.0), ("tau", tau)):
        sc = None if t is None else SpammConfig(enable=True, tau=t, tile=TILE)
        runs = []
        for d in range(TP_MESH[0]):
            pre, dec, taps, fd = _tp_serve(
                cfg, spcfg, params, prompts[d * half:(d + 1) * half], None,
                sc)
            runs.append({"prefill": pre, "decode": dec, "taps": taps,
                         "feed": fd})
        unsharded[mode] = runs
        feed[mode] = np.concatenate([r["feed"] for r in runs])
    del params, x0
    torch.cuda.empty_cache()
    # (p3) unsharded: the same loop on one device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    losses1, p1, st1 = _tp_train(cfg, tpcfg, tcfg)
    train1_s = time.perf_counter() - t0
    train1_gb = torch.cuda.max_memory_allocated() / 1e9
    ref_path = os.path.join(tempfile.gettempdir(), "chip_smoke_tp_ref.pt")
    torch.save({f"{name}/{path}": t.detach().cpu()
                for name, tree in (("params", p1), ("mu", st1["mu"]))
                for path, t in T.flatten_with_paths(tree)}, ref_path)
    from repro_torch.data.pipeline import SyntheticLM

    batch = SyntheticLM(cfg, TP_BATCH, TP_TRAIN_SEQ, seed=tcfg.seed,
                        device=DEV).batch_at(TP_TRAIN_STEPS)
    loss8, next8, before, p8, st8 = _tp_int8_step(cfg, tpcfg, tcfg, p1, st1,
                                                  batch)
    tspecs = M.placements(cfg, tpcfg, M.init_params(
        cfg, tpcfg, device="meta", model_axis_size=TP_MESH[1]),
        dict(zip(("data", "model"), TP_MESH)), tile=TILE)
    sumsq8 = {(d, m): _tp_sumsq(p8, before, st8["ef"], tspecs,
                                _TpCoord(d, m))
              for d in range(TP_MESH[0]) for m in range(TP_MESH[1])}
    del p1, st1, batch, before, p8, st8
    torch.cuda.empty_cache()
    # (p4) unsharded: the MoE model's prefill per data shard at τ > 0
    mp = M.init_params(moe_cfg, spcfg, SEED, device=DEV)
    mx = rms_norm(mp["embed"]["embedding"][torch.as_tensor(
        moe_prompts[:half], device=DEV)], mp["layers"][0]["ln2"],
        moe_cfg.norm_eps).reshape(-1, moe_cfg.d_model)
    moe_tau = median_product_tau(
        getnorm.tile_norms_cuda(mx, TILE),
        getnorm.tile_norms_cuda(mp["layers"][0]["moe"]["w1"][0], TILE))
    from repro_torch.core.module import SpammContext

    # the routed experts' buffers hold ≈ t·k/E rows of each 64-row tile
    # and the down-projections' inputs are smaller than the layer's, so
    # their products sit below layer 0's
    moe_tau = _tp_keep_some(moe_cfg, spcfg, mp, moe_prompts[:half], moe_tau,
                            moe_bmm=True)
    msc = SpammConfig(enable=True, tau=moe_tau, tile=TILE, moe_bmm=True)
    moe1, moe1_dense = [], []
    with torch.no_grad():
        for d in range(TP_MESH[0]):
            rows = {"tokens": torch.as_tensor(
                moe_prompts[d * half:(d + 1) * half], device=DEV)}
            _, lg = M.make_prefill_step(moe_cfg, spcfg,
                                        spamm_cfg=SpammContext(msc))(mp, rows)
            moe1.append(lg.cpu().numpy())
            _, lg = M.make_prefill_step(moe_cfg, spcfg)(mp, rows)
            moe1_dense.append(lg.cpu().numpy())
    del mp, mx
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t_phase
    st_job, st_unsharded = _serve_tp_setup()

    t0 = time.perf_counter()
    shard_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    job = {"prompts": prompts, "feed": feed, "tau": tau,
           "moe_prompts": moe_prompts, "moe_tau": moe_tau,
           "train_ref": ref_path, "shard_dir": shard_dir,
           "serve_tp": st_job}
    try:
        ranks = MS.spawn_ranks(_tp_rank, TP_RANKS, backend="gloo",
                               devices=[torch.device("cuda", 0)] * TP_RANKS,
                               args=(job,), timeout_s=600)
    finally:
        os.remove(ref_path)
        shutil.rmtree(shard_dir, ignore_errors=True)
    spawn_s = time.perf_counter() - t0

    def by_shard(key, sub):
        return {r["data_index"]: r[key][sub] for r in ranks
                if r["mrank"] == 0}

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    res = {"card": CARD, "mesh": list(TP_MESH), "backend": "gloo",
           "devices": "cuda:0 shared by 4 ranks", "tau": tau,
           "moe_tau": moe_tau, "layers": TP_LAYERS,
           "main_process_reserved_gb": main_gb,
           "note": "ranks share one card: not a multi-card time"}
    for mode in ("dense", "tau0", "tau"):
        pre = by_shard("p1_" + mode, "prefill")
        dec = by_shard("p1_" + mode, "decode")
        ref = unsharded[mode]
        cell = {"prefill_rel_err": max(rel(pre[d], ref[d]["prefill"])
                                       for d in pre),
                "decode_rel_err": max(rel(dec[d][i], ref[d]["decode"][i])
                                      for d in dec for i in range(TP_NEW)),
                "tokens_equal": all(
                    r["p1_" + mode]["argmax"] == [
                        x.argmax(-1).tolist() for x in
                        ref[r["data_index"]]["decode"]] for r in ranks)}
        if mode != "dense":
            # the global fraction of each gated prefill GEMM: the model
            # ranks' counts summed in the taps; the data shards' equal
            # shares averaged against the unsharded port per shard
            got = [r["p1_" + mode]["taps"] for r in ranks]
            want = [ref[r["data_index"]]["taps"] for r in ranks]
            cell["taps"] = len(got[0])
            cell["fraction_max_abs_diff"] = max(
                abs(a - b) for g, w in zip(got, want) for a, b in zip(g, w))
            cell["fractions"] = got[0]
        cell["seconds"] = [r["seconds"]["p1_" + mode] for r in ranks]
        res["p1_" + mode] = cell
    for mode in ("dense", "tau"):
        res["p2_" + mode] = {
            "prefill_rel_err": max(rel(by_shard("p2_" + mode, "prefill")[d],
                                       unsharded[mode][d]["prefill"])
                                   for d in range(TP_MESH[0])),
            "max_abs_vs_p1": max(r["p2_" + mode]["max_abs_vs_p1"]
                                 for r in ranks)}
    int8_err = {}
    for r in ranks:
        i8 = r["p3"]["int8"]
        for path, pair in i8["sumsq"].items():
            want = sumsq8[tuple(i8["coord"])][path]
            for what, g, w in zip(("ef", "update"), pair, want):
                key = f"{what}:{path}"
                int8_err[key] = max(int8_err.get(key, 0.0), _tp_rel(g, w))
    worst8 = max(int8_err, key=int8_err.get)
    res["p3"] = {"losses": ranks[0]["p3"]["losses"],
                 "losses_unsharded": losses1,
                 "param_max_abs_err": max(r["p3"]["param_max_abs_err"]
                                          for r in ranks),
                 "param_worst_leaf": ranks[0]["p3"]["param_worst_leaf"],
                 "param_atol": TP_PARAM_ATOL,
                 "mu_rel_err": max(r["p3"]["mu_rel_err"] for r in ranks),
                 "mu_worst_leaf": max(
                     ranks, key=lambda r: r["p3"]["mu_rel_err"])["p3"][
                         "mu_worst_leaf"],
                 "mu_rtol": TP_MU_RTOL,
                 "int8_ef_losses": [r["p3"]["int8"]["loss"] for r in ranks],
                 "int8_ef_loss_unsharded": loss8,
                 "int8_ef_next_losses": [r["p3"]["int8"]["next_loss"]
                                         for r in ranks],
                 "int8_ef_next_loss_unsharded": next8,
                 "int8_sumsq_rel_err": int8_err[worst8],
                 "int8_sumsq_worst": worst8, "int8_rtol": TP_INT8_RTOL,
                 "unsharded_seconds": train1_s,
                 "peak_gb_per_rank": [r["p3"]["peak_gb"] for r in ranks],
                 "peak_gb_unsharded": train1_gb,
                 "seconds": [r["seconds"]["p3"] for r in ranks]}
    m4 = {impl: {r["data_index"]: r["p4_" + impl] for r in ranks
                 if r["mrank"] == 0} for impl in ("tp", "ep")}
    m4d = {impl: {r["data_index"]: r["p4_dense_" + impl] for r in ranks
                  if r["mrank"] == 0} for impl in ("tp", "ep")}
    res["p4"] = {"tp_vs_ep_rel_err": max(rel(m4["tp"][d], m4["ep"][d])
                                         for d in m4["tp"]),
                 "dense": {f"{impl}_rel_err": max(
                     rel(m4d[impl][d], moe1_dense[d]) for d in m4d[impl])
                     for impl in ("tp", "ep")},
                 "logit_max_abs": float(np.abs(moe1[0]).max()),
                 **{f"{impl}_rel_err": max(rel(m4[impl][d], moe1[d])
                                           for d in m4[impl])
                    for impl in ("tp", "ep")},
                 "taps": {impl: ranks[0]["p4_taps_" + impl]
                          for impl in ("tp", "ep")},
                 "seconds": {impl: [r["seconds"]["p4_" + impl]
                                    for r in ranks] for impl in ("tp", "ep")}}
    res["p5"] = {"mesh": ranks[0]["p5"]["mesh"],
                 "bitwise": [r["p5"].get("bitwise") for r in ranks],
                 "losses": [r["p5"].get("loss") for r in ranks],
                 "seconds": [r["seconds"]["p5"] for r in ranks]}
    counts = {}
    for cell in ("p1_dense", "p1_tau0", "p1_tau", "p2_dense", "p2_tau", "p3",
                 "p4_tp", "p4_ep"):
        counts[cell] = {k: sum(r["launches"][cell][k] for r in ranks)
                        for k in ranks[0]["launches"][cell]}
    res["launches"] = counts
    res["launches_per_rank_p1_tau"] = [
        {k: v for k, v in r["launches"]["p1_tau"].items() if v}
        for r in ranks]
    res["seconds"] = {"unsharded_setup": setup_s, "spawn": spawn_s,
                      "per_rank": [r["seconds"] for r in ranks]}
    emit({"tp": res})
    for mode in ("dense", "tau0", "tau"):
        c = res["p1_" + mode]
        check(c["prefill_rel_err"] <= TP_LOGIT_RTOL
              and c["decode_rel_err"] <= TP_LOGIT_RTOL,
              f"(p1) {mode}: sharded logits against the unsharded: {c}")
        if mode != "tau":
            check(c["tokens_equal"], f"(p1) {mode}: tokens differ: {c}")
        else:
            check(c["fraction_max_abs_diff"] <= 1e-4,
                  f"(p1) the global valid fraction: {c}")
    check(all(r["launches"]["p1_tau"]["tile_norms"] > 0
              and r["launches"]["p1_tau"]["spamm_mm_worklist"] > 0
              for r in ranks), f"(p1) a rank launched no row 1 or 2: "
          f"{res['launches_per_rank_p1_tau']}")
    check(all(res[f"p2_{m}"]["prefill_rel_err"] <= TP_LOGIT_RTOL
              for m in ("dense", "tau")), f"(p2) SP prefill: {res}")
    p3 = res["p3"]
    check(np.allclose(p3["losses"], p3["losses_unsharded"], rtol=1e-5,
                      atol=0)
          and all(_tp_rel(x, p3["int8_ef_loss_unsharded"]) <= 1e-5
                  for x in p3["int8_ef_losses"])
          and all(_tp_rel(x, p3["int8_ef_next_loss_unsharded"]) <= 1e-5
                  for x in p3["int8_ef_next_losses"])
          and p3["param_max_abs_err"] <= TP_PARAM_ATOL
          and p3["mu_rel_err"] <= TP_MU_RTOL
          and p3["int8_sumsq_rel_err"] <= TP_INT8_RTOL, f"(p3) {p3}")
    p4 = res["p4"]
    check(max(p4["tp_vs_ep_rel_err"], p4["tp_rel_err"], p4["ep_rel_err"],
              *p4["dense"].values()) <= TP_LOGIT_RTOL and counts["p4_tp"]["spamm_mm"] > 0
          and counts["p4_ep"]["spamm_mm"] > 0, f"(p4) {p4}")
    p5 = res["p5"]
    check(p5["mesh"] == [3, 1] and p5["bitwise"][:3] == [True] * 3
          and all(np.isfinite(x) for x in p5["losses"][:3])
          and p5["losses"][3] is None, f"(p5) {p5}")
    t0 = time.perf_counter()
    st_counts = _serve_tp_check(ranks, st_unsharded)
    st_seconds = (st_unsharded["seconds"] + time.perf_counter() - t0
                  + max(r["seconds"]["serve_tp"] for r in ranks))
    return counts, st_counts, st_seconds


# ---------------------------------------------------------------------------
# library path
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# dryrun: the dry runs as rank 0 of a fake production world
# ---------------------------------------------------------------------------

def _ring_all_gather_bytes(kind, n, rows, cols):
    """The result all-gathers' wire bytes of one SpAMM variant by the ring
    model, written out: C's f32 bytes over the row ranks (2d: first the
    rank's column blocks over the column ranks) and the 4-byte valid
    fractions the same way."""
    out = n * n * 4 * (rows - 1) / rows + 4 * (rows - 1)
    if kind == "2d":
        out += (n // rows) * n * 4 * (cols - 1) / cols + 4 * (cols - 1)
    return out


def phase_dryrun():
    """The SpAMM variants and DRYRUN_CELLS as rank 0 of the fake production
    world (see the DRYRUN_* constants), the variants at the dry run's
    default tile DRYRUN_TILE (the reference's 128). Each variant's rank-0
    product (before its first collective) ≡ flat `spamm()` on the same rows at the
    same τ, tile and dtype, bit for bit; its counted tile products = the
    rank's plan's real steps. At these shapes (an A strip of 1024 × 32768
    against the whole 32768² B; 1024 × 4096 against 4096 × 32768 in 2d)
    the kernels are also held against their plain versions: the plan's
    norms within NORM_RTOL of `tile_norms_plain` on the same operands, the
    product within MM_RTOL of `spamm_mm_worklist_plain` on the plan's own
    step tables (so no gate decision an ulp from τ can differ), and the
    counted tile products = the (i, j, k) that pass na·nb ≥ τ, counted on
    the norms with no step table. Its all-gathers' counted wire bytes =
    the ring model on C's bytes. Returns {variant: launches of the
    variant's run}."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.core import spamm as cs
    from repro_torch.kernels import getnorm, spamm_mm
    from repro_torch.kernels.quantize import quantized_view
    from repro_torch.launch import dryrun
    from repro_torch.launch import dryrun_spamm as DS

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tau, ratio = DS.calibrate_tau(DRYRUN_CALIBRATE_N, DRYRUN_TILE,
                                  DRYRUN_RATIO)
    check(abs(ratio - DRYRUN_RATIO) <= RATIO_TOL,
          f"dryrun: calibrated ratio {ratio} for {DRYRUN_RATIO}")
    a = DS.decay_operand(DRYRUN_N)
    corner = min(2048, DRYRUN_N)       # Toeplitz: the corner is the whole
    check(torch.equal(a[:corner, :corner].cpu(),
                      torch.as_tensor(cs.algebraic_decay(corner))),
          "dryrun: the decay operand differs from numpy's")
    counts = {}
    for name, (kind, _, dtype, multi) in DS.VARIANTS.items():
        torch.cuda.synchronize()
        reset_counts()
        # at the dry run's own default tile, the reference's
        out, loc = DS.run_variant(name, a, tau, ratio, verbose=False)
        check(out["tile"] == DRYRUN_TILE,
              f"dryrun {name}: ran at tile {out['tile']}")
        counts[name] = read_counts()
        row2 = ("spamm_mm_worklist_bf16" if dtype == "bfloat16"
                else "spamm_mm_worklist")
        check(counts[name]["tile_norms"] >= 1 and counts[name][row2] == 1,
              f"dryrun {name}: rows 1 and 2 not launched: {counts[name]}")
        c_flat, _ = cs.spamm(loc["a"], loc["b"], tau, tile=DRYRUN_TILE,
                             compute_dtype=dtype)
        check(torch.equal(c_flat, loc["product"]),
              f"dryrun {name}: rank 0's product differs from flat spamm()")
        del c_flat
        p = P.plan(loc["a"], loc["b"], tau, tile=DRYRUN_TILE,
                   compute_dtype=dtype)
        steps = int(p.valid_tiles)
        gated = int((p.norm_a[:, :, None] * p.norm_b[None] >= p.tau).sum())
        check(out["tile_products"] == steps == gated,
              f"dryrun {name}: {out['tile_products']} counted tile "
              f"products, the plan has {steps}, the gate passes {gated}")
        norm_rel = max(
            float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
            for got, want in (
                (p.norm_a, getnorm.tile_norms_plain(
                    quantized_view(loc["a"], dtype, DRYRUN_TILE),
                    DRYRUN_TILE)),
                (p.norm_b, getnorm.tile_norms_plain(
                    quantized_view(loc["b"], dtype, DRYRUN_TILE),
                    DRYRUN_TILE))))
        w = p.work
        plain = spamm_mm.spamm_mm_worklist_plain(
            loc["a"], loc["b"], w.step_i, w.step_j, w.step_k, w.step_flags,
            w.runs, tile=DRYRUN_TILE)
        abs_err, mm_rel = errors(loc["product"], plain)
        check(norm_rel <= NORM_RTOL and mm_rel <= MM_RTOL,
              f"dryrun {name}: against the plain versions, norms max rel "
              f"err {norm_rel}, product {mm_rel}")
        del p, plain
        rows = 64 if multi else 32
        cols = 8 if kind == "2d" else 1
        wire = out["collectives"]["all-gather"]["wire_bytes"]
        want = _ring_all_gather_bytes(kind, DRYRUN_N, rows, cols)
        check(wire == want, f"dryrun {name}: all-gather wire bytes {wire}, "
                            f"ring model {want}")
        r = out["roofline"]
        emit({"dryrun_spamm": {
            "variant": name, "mesh": out["mesh"], "n": DRYRUN_N,
            "tile": DRYRUN_TILE, "tau": tau, "calibrated_ratio": ratio,
            "rank0_valid_fraction": out["rank_valid_fraction"],
            "tile_products": out["tile_products"],
            "flops": out["flops_per_device"],
            "hbm_bytes": out["hbm_bytes_per_device"],
            "wire_bytes": {k: v["wire_bytes"]
                           for k, v in out["collectives"].items()},
            "roofline": r, "peak_gb": out["memory"]["peak_bytes"] / 1e9,
            "argument_gb": out["memory"]["argument_bytes"] / 1e9,
            "seconds": out["seconds"], "launches": counts[name],
            "plain_norm_rel_err": norm_rel, "plain_product_abs_err": abs_err,
            "plain_product_rel_err": mm_rel, "card": CARD}})
        del loc
    del a
    torch.cuda.empty_cache()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    for arch, shape in DRYRUN_CELLS:
        out = dryrun.run_cell(arch, shape, verbose=False)
        h, r, mem = out["hlo"], out["roofline"], out["memory"]
        check(h["flops_per_device"] > 0 and h["hbm_bytes_per_device"] > 0
              and h["collective_wire_bytes_per_device"] > 0
              and not h["warnings"]
              and mem["argument_bytes"] < mem["peak_bytes"] <= card_bytes
              and r["dominant"] in ("compute_s", "memory_s", "collective_s"),
              f"dryrun {arch} × {shape}: {h['warnings']} {mem} {r}")
        emit({"dryrun_cell": {
            "arch": arch, "shape": shape, "mesh": out["mesh"],
            "batch_per_rank": out["batch_per_rank"],
            "flops": h["flops_per_device"],
            "hbm_bytes": h["hbm_bytes_per_device"],
            "wire_bytes": {k: v["wire_bytes"]
                           for k, v in h["collectives"].items()},
            "roofline": r, "peak_gb": mem["peak_bytes"] / 1e9,
            "argument_gb": mem["argument_bytes"] / 1e9,
            "top_bytes": out["top_bytes"],
            "seconds": out["compile_s"], "card": CARD}})
        torch.cuda.empty_cache()
    emit({"dryrun_phase": {"seconds": time.perf_counter() - t_phase}})
    return counts


def train_run(cfg, pcfg, base, batches, spamm_cfg, label):
    """TRAIN_STEPS AdamW steps from a copy of `base` (fresh moments), one
    batch each, every launch counter set to 0 just before the first.
    Emits a "train" line (per-step loss, grad norm, valid fraction, gated
    GEMMs and host ms ending in a sync; the median ms over steps 2..,
    tokens/s, peak GB) and returns (losses, launches)."""
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs import TrainConfig
    from repro_torch.core import module as spmod
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW

    params = T.map_(lambda t: t.detach().clone(), base)
    opt = AdamW(TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                            total_steps=TRAIN_STEPS))
    state = opt.init(params)
    ctx = spmod.as_context(spamm_cfg)
    step = M.make_train_step(cfg, pcfg, opt, spamm_cfg=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    reset_counts()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch, i)
        vals = {k: v.tolist() for k, v in met.items()}
        torch.cuda.synchronize()
        rows.append({"step": i, "ms": (time.perf_counter() - t0) * 1e3,
                     "loss": vals["loss"], "grad_norm": vals["grad_norm"],
                     "valid_fraction": vals.get("spamm_valid_fraction"),
                     "gated_gemms": vals.get("spamm_gated_gemms")})
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in rows]
    check(all(np.isfinite(losses)), f"train {label}: losses {losses}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"train {label}: losses do not fall: {losses}")
    ms = sorted(r["ms"] for r in rows[2:])
    med = ms[len(ms) // 2]
    emit({"train": label, "steps": rows, "median_step_ms": med,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (med / 1e3),
          "peak_gb": peak, "launches": counts,
          "launches_per_step": {k: v / len(rows) for k, v in counts.items()
                                if v}})
    del params, state
    torch.cuda.empty_cache()
    return losses, counts


def train_grads(cfg, pcfg, base, batch, spamm_cfg):
    """(loss, metrics, gradient leaves, launches) of one loss and backward
    from a copy of `base`, the counters set to 0 just before."""
    import torch

    from repro_torch import tree as T
    from repro_torch.core import module as spmod
    from repro_torch.models import model as M

    params = T.map_(lambda t: t.detach().clone().requires_grad_(True), base)
    torch.cuda.synchronize()
    reset_counts()
    loss, met = M.loss_fn(cfg, pcfg, params, batch,
                          spamm_cfg=spmod.as_context(spamm_cfg))
    loss.backward()
    torch.cuda.synchronize()
    counts = read_counts()
    grads = [p.grad for p in T.leaves(params)]
    return (float(loss.detach()), {k: v.tolist() for k, v in met.items()},
            grads, counts)


def layer0_w1_operands(cfg, pcfg, params, batch):
    """Layer 0's w1 product as the backward meets it: its input x (B·S,
    d) and the loss gradient g (B·S, ff) at its output, from the model's
    own pieces split at that product (dense, no SpAMM); also the loss."""
    import dataclasses

    import torch

    from repro_torch.models import model as M
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import _gelu, chunked_ce_loss, rms_norm

    p0 = params["layers"][0]
    eps = cfg.norm_eps
    with torch.no_grad():
        x = M._inputs(params, batch, torch.float32)
        b, s, d = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
            b, s)
        h = x + tr.attention_layer(p0["mix"], rms_norm(x, p0["ln1"], eps),
                                   cfg, pcfg, pos,
                                   window=cfg.sliding_window)
        xin = rms_norm(h, p0["ln2"], eps)
        y = xin @ p0["mlp"]["w1"]
    y.requires_grad_(True)
    x1 = h + _gelu(y) @ p0["mlp"]["w2"]
    rest = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
    out, _ = tr.stack_fwd({"layers": params["layers"][1:]}, x1, rest,
                          dataclasses.replace(pcfg, remat="none"), pos)
    loss = chunked_ce_loss(rms_norm(out, params["final_norm"], eps),
                           params["unembed"]["kernel"], batch["labels"],
                           pcfg.loss_chunk)
    (g,) = torch.autograd.grad(loss, y)
    return xin.reshape(b * s, d), g.reshape(b * s, -1), float(loss)


def check_train_product(a, b, p, label):
    """A backward product's work-list kernel against its plain version
    (check_worklist), bit for bit over two calls, timed back to back."""
    import torch

    from repro_torch.kernels import spamm_mm

    res = check_worklist(a, b, p, label)
    w = p.work
    args = (a, b, w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
    one = spamm_mm.spamm_mm_worklist_cuda(*args, tile=TILE)
    two = spamm_mm.spamm_mm_worklist_cuda(*args, tile=TILE)
    torch.cuda.synchronize()
    check(torch.equal(one, two), f"{label}: two calls differ")
    res["ms_back_to_back"] = time_ms_back_to_back(
        lambda: spamm_mm.spamm_mm_worklist_cuda(*args, tile=TILE))
    res["bit_identical_over_two_calls"] = True
    emit({"train_product": res})
    return res


def phase_train():
    """Training (`models.model.make_train_step`: the loss, backward, AdamW
    in place) on starcoder2-7b at full width, TRAIN_LAYERS of its 32
    layers, random f32 weights from SEED, TRAIN_BATCH × TRAIN_SEQ tokens of
    SyntheticLM (seed 0) per step, remat "full" (the reference CLI's
    setting at full size).

    (t1) dense, TRAIN_STEPS steps: losses finite and falling; median step
    ms, tokens/s, peak GB. (t2) one loss and backward at τ = 0 with
    bwd="spamm" against dense from the same parameters, remat "none" and
    "full": the loss within TRAIN_LOSS_RTOL, every gradient leaf within
    TRAIN_GRAD_RTOL of its largest magnitude, and the launches of rows 1
    and 2 exactly as the code counts them (per gated GEMM: forward 2
    get-norms + 1 work-list, backward 1 + 2; remat adds the forward's
    again). (t3) τ = the median norm product of step 0's first gated GEMM,
    TRAIN_STEPS steps each with bwd="dense" and bwd="spamm": losses finite
    and falling, per-step valid fraction. (t4) layer 0's w1 backward
    products at their real operands — dx = g (B·S × ff) @ w1ᵀ and dW =
    xᵀ (d × B·S) @ g — each at (t3)'s τ and at its own median product,
    held against the plain version, bit for bit over two calls, timed
    against `torch.matmul`. (t5) the resume path on a reduced starcoder2-7b
    on the card. Returns (the launches of (t3)'s bwd="spamm" run, the
    (t2) counts, the (t4) results)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import tree as T
    from repro_torch.configs import (ParallelConfig, SpammConfig,
                                     TrainConfig, get_config)
    from repro_torch.core import plan as P
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import getnorm
    from repro_torch.models import model as M
    from repro_torch.models.layers import rms_norm
    from repro_torch.train import loop

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    pcfg = ParallelConfig(compute_dtype="float32", remat="full",
                          attn_q_chunk=64, loss_chunk=128)
    t0 = time.perf_counter()
    base = M.init_params(cfg, pcfg, SEED, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in T.leaves(base))
    emit({"model": cfg.name, "phase": "train", "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "params": n_params, "train_state_gb": 4 * n_params * 4 / 1e9,
          "init_s": time.perf_counter() - t0,
          "depth_cut": f"{TRAIN_LAYERS} of 32 layers"})
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEV)
    batches = [data.batch_at(i) for i in range(TRAIN_STEPS)]

    # (t1)
    train_run(cfg, pcfg, base, batches, None, "t1 dense")

    # (t2)
    none = dataclasses.replace(pcfg, remat="none")
    tau0 = SpammConfig(enable=True, tau=0.0, tile=TILE, backend="auto",
                       bwd="spamm")
    d_loss, _, d_grads, _ = train_grads(cfg, none, base, batches[0], None)
    t2 = {}
    for remat in ("none", "full"):
        pc = dataclasses.replace(pcfg, remat=remat)
        loss, met, grads, counts = train_grads(cfg, pc, base, batches[0],
                                               tau0)
        gated = int(met["spamm_gated_gemms"])
        per = {"none": (3, 3), "full": (5, 4)}[remat]
        want = {"tile_norms": per[0] * gated,
                "spamm_mm_worklist": per[1] * gated}
        got = {k: counts[k] for k in want}
        errs = [float((g - d).abs().max() / d.abs().max().clamp(min=1e-30))
                for g, d in zip(grads, d_grads)]
        rel = abs(loss - d_loss) / abs(d_loss)
        emit({"train_tau0": remat, "loss": loss, "dense_loss": d_loss,
              "loss_rel_err": rel, "max_grad_rel_err": max(errs),
              "gated_gemms": gated, "valid_fraction":
              met["spamm_valid_fraction"], "launches": got,
              "expected_launches": want})
        check(rel <= TRAIN_LOSS_RTOL, f"t2 {remat}: loss rel err {rel}")
        check(max(errs) <= TRAIN_GRAD_RTOL,
              f"t2 {remat}: grad rel err {max(errs)}")
        check(got == want, f"t2 {remat}: launches {got}, want {want}")
        check(met["spamm_valid_fraction"] == 1.0, "t2: τ = 0 skipped tiles")
        t2[remat] = got
        del grads
    del d_grads
    torch.cuda.empty_cache()

    # (t3): τ from step 0's first gated GEMM (layer 0's wq)
    p0 = base["layers"][0]
    x0 = rms_norm(M._inputs(base, batches[0], torch.float32),
                  p0["ln1"], cfg.norm_eps).reshape(-1, cfg.d_model)
    tau = median_product_tau(getnorm.tile_norms_cuda(x0, TILE),
                             getnorm.tile_norms_cuda(p0["mix"]["wq"], TILE))
    del x0
    t3 = {}
    for bwd in ("dense", "spamm"):
        sc = SpammConfig(enable=True, tau=tau, tile=TILE, backend="auto",
                         bwd=bwd)
        _, t3[bwd] = train_run(cfg, pcfg, base, batches, sc,
                               f"t3 tau={tau:.4f} bwd={bwd}")

    # (t4): layer 0's w1 backward products
    xin, g, loss0 = layer0_w1_operands(cfg, pcfg, base, batches[0])
    check(abs(loss0 - d_loss) <= TRAIN_LOSS_RTOL * abs(d_loss),
          f"t4: split loss {loss0} vs {d_loss}")
    w1 = base["layers"][0]["mlp"]["w1"]
    nw = getnorm.tile_norms_cuda(w1, TILE)
    nx = getnorm.tile_norms_cuda(xin, TILE)
    ng = getnorm.tile_norms_cuda(g, TILE)
    w1t, xt = w1.T.contiguous(), xin.T.contiguous()
    m, k = xin.shape
    n = w1.shape[1]
    products = []
    for which, t in (("t3", tau), ("median", None)):
        tdx = t if t is not None else median_product_tau(ng, nw.T)
        tdw = t if t is not None else median_product_tau(nx.T, ng)
        p_dx = P.plan(g, None, tdx, norm_b=nw.T, tile=TILE, backend="cuda")
        p_dw = P.plan(None, None, tdw, norm_a=nx.T, norm_b=p_dx.norm_a,
                      tile=TILE, backend="cuda")
        products.append(check_train_product(
            g, w1t, p_dx, f"dx g({m}x{n}) @ w1T({n}x{k}), tau={tdx:.6g} "
            f"({which})"))
        products.append(check_train_product(
            xt, g, p_dw, f"dW xT({k}x{m}) @ g({m}x{n}), tau={tdw:.6g} "
            f"({which})"))
    del xin, g, w1t, xt, base, batches
    torch.cuda.empty_cache()

    # (t5): resume on CUDA tensors, reduced
    rcfg = get_config(ARCH).reduced()
    rpc = ParallelConfig(compute_dtype="float32", remat="none",
                         attn_q_chunk=64, loss_chunk=128)
    rsc = SpammConfig(enable=True, tau=0.0, tile=TILE, backend="auto",
                      bwd="spamm")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    def tc(name):
        return TrainConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=RESUME_STEPS, ckpt_every=RESUME_EVERY,
                           ckpt_dir=os.path.join(TRAIN_DIR, name))

    kw = dict(global_batch=TRAIN_BATCH, seq_len=64, spamm_cfg=rsc,
              log_every=0, device=DEV)
    ref = loop.train(rcfg, rpc, tc("uninterrupted"), **kw)
    raised = None
    try:
        loop.train(rcfg, rpc, tc("crashed"), fail_at_step=RESUME_CRASH, **kw)
    except RuntimeError as e:
        raised = str(e)
    check(raised == f"injected failure at step {RESUME_CRASH}",
          f"t5: the crashed run ended with {raised!r}")
    res = loop.train(rcfg, rpc, tc("crashed"), resume=True, **kw)
    gap = abs(res.losses[-1] - ref.losses[-1])
    emit({"train_resume": rcfg.name, "crash_at": RESUME_CRASH,
          "ckpt_every": RESUME_EVERY, "final_step": res.final_step,
          "restarts": res.restarts, "losses": res.losses,
          "uninterrupted_losses": ref.losses[RESUME_CRASH:],
          "final_loss_gap": gap,
          "bit_identical": res.losses == ref.losses[RESUME_CRASH:]})
    check(res.final_step == RESUME_STEPS and res.restarts == 1,
          f"t5: final step {res.final_step}, restarts {res.restarts}")
    check(gap < RESUME_LOSS_TOL, f"t5: final loss gap {gap}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return t3["spamm"], t2, products


def algebraic_decay_on_card(n, seed, c=0.1, lam=0.1):
    """`core.spamm.algebraic_decay(n, seed=...)`'s formula made on the card:
    |a_ij| = c / (|i-j|^lam + 1), one float64 value per distance rounded to
    float32 as the numpy generator rounds it, times random signs from a
    torch.Generator (numpy would need 2 GiB of float64 per matrix)."""
    import torch

    mag = (c / (torch.arange(n, dtype=torch.float64, device=DEV) ** lam
                + 1.0)).to(torch.float32)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    idx = torch.arange(n, device=DEV)
    out = torch.empty(n, n, device=DEV)
    for r0 in range(0, n, 1024):
        dist = (idx[r0:r0 + 1024, None] - idx[None, :]).abs()
        sign = torch.randint(0, 2, dist.shape, generator=gen, device=DEV,
                             dtype=torch.int8) * 2 - 1
        out[r0:r0 + 1024] = mag[dist] * sign
    return out


def batched_median_tau(na, nb):
    """The median over all slices of the products na[s,i,k]·nb[s,k,j]."""
    return float((na[..., :, None, :] * nb.transpose(-1, -2)[..., None, :, :]
                  ).flatten().median())


def moe_operands(gen):
    """Per-expert operands at qwen2-moe-a2.7b's shapes: x1 (E, rows, d) @
    w1 (E, d, ff) and x2 (E, rows, ff) @ w2 (E, ff, d), weights scaled by
    fan_in^-1/2."""
    import torch

    e, d, ff, rows = MOE_EXPERTS, MOE_D, MOE_FF, MOE_ROWS
    x1 = torch.randn(e, rows, d, generator=gen, device=DEV)
    w1 = torch.randn(e, d, ff, generator=gen, device=DEV).mul_(d ** -0.5)
    x2 = torch.randn(e, rows, ff, generator=gen, device=DEV)
    w2 = torch.randn(e, ff, d, generator=gen, device=DEV).mul_(ff ** -0.5)
    return {"w1": (x1, w1), "w2": (x2, w2)}


def slice_norms(x, tile=TILE):
    """(E, M/t, K/t) normmaps of a batch of slices, one get-norm launch."""
    from repro_torch.kernels import getnorm

    e, m, k = x.shape
    return getnorm.tile_norms_cuda(x.reshape(e * m, k), tile).reshape(
        e, m // tile, k // tile)


def library_main_path(a, b, moe, eager):
    """The library path as a user calls it, with no check or timing in
    between: (a) spamm(valid_ratio) and plan(valid_ratio, levels) + execute
    at both ratios, (b) spamm_bmm per-slice on both expert GEMMs and
    shared-weight once, (d) the eager gated GEMM at levels 2 and 0, (e)
    spamm(valid_ratio=0.30) with int8 and with bf16 GEMMs, (f)
    spamm(valid_ratio=0.30) with the tensor-core get-norm. Returns the
    outputs and the launches of (d)."""
    from repro_torch.configs import SpammConfig
    from repro_torch.core import module as mod
    from repro_torch.core import plan as P
    from repro_torch.core.spamm import spamm

    out = {"paper": {}, "moe": {}, "eager": {}, "lowp": {}}
    for r in LIB_RATIOS:
        (c_flat, info), spamm_ms = host_ms(lambda: spamm(a, b, valid_ratio=r,
                                                         tile=TILE))
        p_hier, plan_ms = host_ms(lambda: P.plan(a, b, valid_ratio=r,
                                                 tile=TILE,
                                                 levels=LIB_LEVELS))
        c_hier, exec_ms = host_ms(lambda: P.execute(p_hier, a, b))
        out["paper"][r] = {"c_flat": c_flat, "info": info,
                           "spamm_host_ms": spamm_ms, "p_hier": p_hier,
                           "c_hier": c_hier, "hier_plan_host_ms": plan_ms,
                           "hier_execute_host_ms": exec_ms}
    for name, (x, w, tau) in moe.items():
        out["moe"][name] = P.spamm_bmm(x, w, tau, tile=TILE)
    xe, we, tau_e = eager
    before = read_counts()["pool_norms"]
    for levels in (EAGER_LEVELS, 0):
        ctx = mod.SpammContext(SpammConfig(enable=True, tau=tau_e, tile=TILE,
                                           levels=levels))
        out["eager"][levels] = mod.maybe_spamm_matmul(xe, we, ctx)
        if levels:
            out["eager"]["pool_launches"] = (read_counts()["pool_norms"]
                                             - before)
    for dtype in LOWP_DTYPES:
        (c, info), ms = host_ms(lambda: spamm(a, b, valid_ratio=LIB_RATIOS[0],
                                              tile=TILE,
                                              compute_dtype=dtype))
        out["lowp"][dtype] = {"c": c, "info": info, "spamm_host_ms": ms}
    (c, info), ms = host_ms(lambda: spamm(a, b, valid_ratio=LIB_RATIOS[0],
                                          tile=TILE, use_mxu_norm=True))
    out["mxu"] = {"c": c, "info": info, "spamm_host_ms": ms}
    return out


def check_paper(a, b, runs):
    """(a): the search's achieved ratio within its tolerance, hierarchical
    ≡ flat at the flat τ (tables and output), times against dense, and
    τ = 0 against torch.matmul."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.core.tau_search import search_tau, search_tau_pyramid
    from repro_torch.kernels import getnorm

    na, nb = getnorm.tile_norms_cuda(a, TILE), getnorm.tile_norms_cuda(b, TILE)
    pa = P.NormPyramid.from_normmap(na, LIB_LEVELS, tile=TILE)
    pb = P.NormPyramid.from_normmap(nb, LIB_LEVELS, tile=TILE)
    dense_ms = time_ms(lambda: torch.matmul(a, b), reps=5)
    n = a.shape[0]
    for r, run in runs.items():
        tau, res = search_tau(na, nb, r)
        tau_h, res_h = search_tau_pyramid(pa, pb, r)
        info = run["info"]
        check(tau == info.tau, f"ratio {r}: spamm's τ {info.tau} is not the "
              f"search's {tau}")
        check(abs(res.achieved_ratio - r) <= RATIO_TOL,
              f"ratio {r}: flat search achieved {res.achieved_ratio}")
        check(abs(res_h.achieved_ratio - r) <= RATIO_TOL,
              f"ratio {r}: coarse-first search achieved "
              f"{res_h.achieved_ratio}")
        check(run["p_hier"].tau == tau_h, f"ratio {r}: plan's τ differs")
        p_flat, plan_ms = host_ms(lambda: P.plan(a, b, tau, tile=TILE))
        p_h, hplan_ms = host_ms(lambda: P.plan(a, b, tau, tile=TILE,
                                               levels=LIB_LEVELS))
        same_tables = all(torch.equal(x, y)
                          for x, y in zip(p_flat.work, p_h.work))
        c_flat = run["c_flat"]
        same_out = torch.equal(P.execute(p_h, a, b), c_flat)
        exec_ms = time_ms(lambda: P.execute(p_flat, a, b), reps=5)
        vf = float(p_flat.valid_fraction)
        emit({"library_paper": {
            "n": n, "tile": TILE, "valid_ratio": r,
            "flat": {"tau": tau, "achieved_ratio": res.achieved_ratio,
                     "iterations": res.iterations, "valid_fraction": vf,
                     "plan_host_ms": plan_ms,
                     "spamm_host_ms": run["spamm_host_ms"]},
            "hier": {"levels": LIB_LEVELS, "tau": tau_h,
                     "achieved_ratio": res_h.achieved_ratio,
                     "iterations": res_h.iterations,
                     "valid_fraction": float(run["p_hier"].valid_fraction),
                     "plan_host_ms": run["hier_plan_host_ms"],
                     "plan_at_flat_tau_host_ms": hplan_ms},
            "execute_ms": exec_ms, "dense_matmul_ms": dense_ms,
            "execute_bound_ms": bound_ms(0, 2 * TILE ** 3
                                         * int(p_flat.valid_tiles))[0],
            "hier_tables_equal_flat": same_tables,
            "hier_output_bit_identical": same_out}})
        check(same_tables and same_out,
              f"ratio {r}: hierarchical plan differs from flat")
        del p_flat, p_h
    p0 = P.plan(a, b, 0.0, tile=TILE)
    abs_err, rel = errors(P.execute(p0, a, b), torch.matmul(a, b))
    emit({"library_tau0_vs_matmul": {"n": n, "max_abs_err": abs_err,
                                     "max_rel_err": rel,
                                     "tolerance_rel": MM_RTOL,
                                     "valid_fraction":
                                         float(p0.valid_fraction)}})
    check(rel <= MM_RTOL and float(p0.valid_fraction) == 1.0,
          f"τ = 0 differs from torch.matmul ({rel})")
    return na


def check_lowp_library(a, b, runs):
    """(e): spamm(valid_ratio=0.30) at int8 and bf16 on the ensemble: the
    achieved ratio within the search's tolerance, finite output, plan host
    ms and execute ms against dense torch.matmul."""
    import torch

    from repro_torch.core import plan as P

    r = LIB_RATIOS[0]
    dense_ms = time_ms(lambda: torch.matmul(a, b), reps=3, warmup=1)
    for dtype, run in runs.items():
        c, info = run["c"], run["info"]
        vf = float(info.valid_fraction)
        p, plan_ms = host_ms(lambda: P.plan(a, b, valid_ratio=r, tile=TILE,
                                            compute_dtype=dtype))
        exec_ms = time_ms(lambda: P.execute(p, a, b), reps=3, warmup=1)
        finite = bool(torch.isfinite(c).all())
        emit({"library_lowp": {
            "n": a.shape[0], "tile": TILE, "compute_dtype": dtype,
            "valid_ratio": r, "tau": info.tau, "achieved_ratio": vf,
            "plan_tau": p.tau, "plan_host_ms": plan_ms,
            "spamm_host_ms": run["spamm_host_ms"], "execute_ms": exec_ms,
            "dense_matmul_ms": dense_ms,
            "gemm_bytes_moved": float(p.bytes_moved()), "finite": finite}})
        check(abs(vf - r) <= RATIO_TOL and finite and p.tau == info.tau,
              f"{dtype} spamm at ratio {r}: achieved {vf}, finite {finite}")
        del p


def check_mxu_library(info_f32, run):
    """(f): spamm(valid_ratio=0.30, use_mxu_norm=True) reaches its ratio
    within the search's tolerance; its τ beside the CUDA-core run's."""
    import torch

    info = run["info"]
    vf = float(info.valid_fraction)
    finite = bool(torch.isfinite(run["c"]).all())
    emit({"library_mxu": {
        "n": LIB_N, "tile": TILE, "valid_ratio": LIB_RATIOS[0],
        "tau": info.tau, "achieved_ratio": vf,
        "tau_use_mxu_false": info_f32.tau,
        "achieved_ratio_use_mxu_false": float(info_f32.valid_fraction),
        "spamm_host_ms": run["spamm_host_ms"], "finite": finite}})
    check(abs(vf - LIB_RATIOS[0]) <= RATIO_TOL and finite,
          f"spamm(use_mxu_norm=True) at ratio {LIB_RATIOS[0]}: achieved {vf}")


def check_dense_grid(name, x, w, tau, c, info, tile=TILE):
    """(b) and (l4): the dense-grid kernel against its plain version on the
    batched gate, bit for bit against the work-list kernel on each slice's
    own plan (and, above tile 64, against the 64-tile dense-grid kernel on
    the refined gate), and its time against torch.bmm and its bound."""
    import numpy as np
    import torch

    from repro_torch.core import plan as P
    from repro_torch.kernels import ref, spamm_mm

    vf = float(info.valid_fraction)
    check(0.0 < vf < 1.0, f"moe {name}: valid fraction {vf} not in (0, 1)")
    mask = P.gate_mask(slice_norms(x, tile), slice_norms(w, tile), tau)
    kidx, nvalid = ref.spamm_compact_ref(mask)
    args = (x, w, kidx, nvalid)
    got = spamm_mm.spamm_mm_cuda(*args, tile=tile)
    geometry = dict(spamm_mm.last_geometry)
    want = spamm_mm.spamm_mm_plain(*args, tile=tile)
    torch.cuda.synchronize()
    abs_err, rel = errors(got, want)
    check(rel <= MM_RTOL, f"spamm_mm {name}: max rel err {rel}")
    check(torch.equal(got, c), f"moe {name}: spamm_bmm is not the kernel's "
          f"output")
    same = True
    for s in range(x.shape[0]):
        p = P.plan(x[s], w[s], tau, tile=tile)
        same = same and torch.equal(P.execute(p, x[s], w[s]), c[s])
    check(same, f"moe {name}: dense-grid differs from work-list")
    res = {}
    if tile > 64:
        r = tile // 64
        fine = torch.as_tensor(np.repeat(np.repeat(np.repeat(
            mask.cpu().numpy(), r, 1), r, 2), r, 3), device=x.device)
        sub = spamm_mm.spamm_mm_cuda(x, w, *ref.spamm_compact_ref(fine),
                                     tile=64)
        res["bit_identical_to_sub_tile_kernel"] = torch.equal(got, sub)
        check(res["bit_identical_to_sub_tile_kernel"],
              f"moe {name}: differs from the 64-tile kernel")
    steps = int(nvalid.sum())
    a_tiles = int(mask.any(dim=2).sum())   # (slice, i, k) read by some j
    b_tiles = int(mask.any(dim=1).sum())   # (slice, k, j) read by some i
    nbytes = ((a_tiles + b_tiles) * tile * tile * 4 + c.numel() * 4
              + (kidx.numel() + nvalid.numel()) * 4)
    bms, by = bound_ms(nbytes, 2 * tile ** 3 * steps)
    e, m, k = x.shape
    res = {"name": "spamm_mm", "tile": tile,
           "shape": f"{e}x{m}x{k}x{w.shape[2]} per-slice ({name})",
           "tau": tau, "valid_fraction": vf, "valid_steps": steps,
           "geometry": geometry, "max_abs_err": abs_err, "max_rel_err": rel,
           "bit_identical_to_worklist": same, **res,
           "ms": time_ms(lambda: spamm_mm.spamm_mm_cuda(*args, tile=tile)),
           "ms_back_to_back": time_ms_back_to_back(
               lambda: spamm_mm.spamm_mm_cuda(*args, tile=tile), calls=10,
               reps=3),
           "plain_ms": time_ms(lambda: spamm_mm.spamm_mm_plain(
               *args, tile=tile), reps=3, warmup=1),
           "library_ms": time_ms(lambda: torch.bmm(x, w)),
           "bound_ms": bms, "bound_by": by}
    emit({"kernel_check": res})
    return res


def kernel_device_ms(fn, kernel, calls=20):
    """Mean device time of one launch of `kernel` over `calls` calls of fn
    under torch.profiler (over the launches it recorded) — for kernels so
    short that an event pair around one call measures the host's launch
    path instead. "not measured" when the profiler records no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    us = sum(e.self_device_time_total for e in rows)
    # the mean over the launches the profiler kept: it can drop records of
    # a long run, which a division by `calls` would count as zero time
    n = sum(e.count for e in rows)
    return us / n / 1e3 if us > 0 else "not measured"


def kernel_device_ms_each(fns, kernel, calls=5):
    """`kernel_device_ms` of several functions, each launching `kernel`
    once a call, in one profiler session: `calls` rounds, each calling
    every function once (a drift of the card's clock spreads over all of
    them); the median of a function's device records, in launch order.
    "not measured" for each when the profiler kept another number of
    records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    recs = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and kernel in e.name),
                  key=lambda e: e.time_range.start)
    if len(recs) != len(fns) * calls:
        return ["not measured"] * len(fns)
    us = [sorted(e.time_range.elapsed_us() for e in recs[i::len(fns)])
          for i in range(len(fns))]
    return [u[calls // 2] / 1e3 for u in us]


def check_pool(x, label):
    """(c): the pooling kernel against its plain version and one torch
    expression (square, pad, 2×2 sum, sqrt)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import getnorm

    gm, gk = x.shape
    gmc, gkc = (gm + 1) // 2, (gk + 1) // 2
    got = getnorm.pool_norms_cuda(x)
    want = getnorm.pool_norms_plain(x)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    check(rel <= NORM_RTOL, f"pool_norms {label}: max rel err {rel}")
    bms, by = bound_ms((x.numel() + got.numel()) * 4, 7 * got.numel())
    res = {"name": "pool_norms", "shape": label,
           "max_abs_err": float((got - want).abs().max()),
           "max_rel_err": rel, "bit_identical": torch.equal(got, want),
           "device_ms": kernel_device_ms(
               lambda: getnorm.pool_norms_cuda(x), "pool_norms_f32_kernel"),
           "ms": time_ms(lambda: getnorm.pool_norms_cuda(x)),
           "plain_ms": time_ms(lambda: getnorm.pool_norms_plain(x)),
           "library_ms": time_ms(lambda: torch.sqrt(
               F.pad(x * x, (0, gk % 2, 0, gm % 2))
               .reshape(gmc, 2, gkc, 2).sum((1, 3)))),
           "bound_ms": bms, "bound_by": by}
    emit({"kernel_check": res})
    return res


def phase_library():
    """The library path at full size: operands made on the card, the main
    path driven once with every count at 0 just before and read just after,
    then the checks and timings."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.spamm import spamm
    from repro_torch.kernels import getnorm

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a = algebraic_decay_on_card(LIB_N, SEED)
    b = algebraic_decay_on_card(LIB_N, SEED + 1)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    moe = {}
    for name, (x, w) in moe_operands(gen).items():
        moe[name] = (x, w, batched_median_tau(slice_norms(x),
                                              slice_norms(w)))
    x1, w1, _ = moe["w1"]
    moe_shared = (x1, w1[0], batched_median_tau(slice_norms(x1),
                                                slice_norms(w1[:1])))
    cfg = get_config(ARCH)
    xe = torch.randn(BATCH * PROMPT_LEN, cfg.d_model, generator=gen,
                     device=DEV)
    we = torch.randn(cfg.d_model, cfg.d_ff, generator=gen,
                     device=DEV).mul_(cfg.d_model ** -0.5)
    tau_e = median_product_tau(getnorm.tile_norms_cuda(xe, TILE),
                               getnorm.tile_norms_cuda(we, TILE))
    torch.cuda.synchronize()
    emit({"library_setup": {"seconds": time.perf_counter() - t0,
                            "paper_n": LIB_N, "moe_taus": {
                                k: v[2] for k, v in moe.items()},
                            "moe_shared_tau": moe_shared[2],
                            "eager_tau": tau_e}})

    reset_counts()
    t0 = time.perf_counter()
    out = library_main_path(a, b, {**moe, "shared": moe_shared},
                            (xe, we, tau_e))
    torch.cuda.synchronize()
    counts = read_counts()
    emit({"library_path": {"seconds": time.perf_counter() - t0,
                           "launches": counts,
                           "eager_pool_launches":
                               out["eager"]["pool_launches"]}})
    # the fused int8 get-norm's tensor-core variant runs on the store path,
    # the `mma.sync` work-list kernels on the large_tiles phase's, the f32
    # decode kernel on the serving runs' decode steps
    check(all(v > 0 for k, v in counts.items()
              if k not in ("tile_norms_quant_mxu", "spamm_mm_worklist_decode")
              and not k.endswith("_mma_sync")),
          f"library launches {counts}")

    check_mxu_library(out["paper"][LIB_RATIOS[0]]["info"], out["mxu"])
    del out["mxu"]
    norm_a = check_paper(a, b, out["paper"])
    del out["paper"]
    check_lowp_library(a, b, out["lowp"])
    mxu_device_times(a, f"library operand {LIB_N}x{LIB_N}", (TILE,))
    del out["lowp"], a, b
    torch.cuda.empty_cache()
    mm = {name: check_dense_grid(name, *moe[name], *out["moe"][name])
          for name in ("w1", "w2")}
    c_s, info_s = out["moe"]["shared"]
    x1, ws, tau_s = moe_shared
    vf_s = float(info_s.valid_fraction)
    ref_s = torch.stack([spamm(x1[s], ws, tau_s, tile=TILE)[0]
                         for s in range(x1.shape[0])])
    emit({"library_moe_shared": {"shape": f"{tuple(x1.shape)} @ "
                                          f"{tuple(ws.shape)}",
                                 "tau": tau_s, "valid_fraction": vf_s,
                                 "per_slice_bit_identical":
                                     torch.equal(c_s, ref_s)}})
    check(0.0 < vf_s < 1.0 and torch.equal(c_s, ref_s),
          "shared-weight spamm_bmm differs from per-slice spamm")
    pool = check_pool(norm_a, f"normmap {tuple(norm_a.shape)}")
    gen_r = torch.Generator(device=DEV).manual_seed(SEED + 3)
    check_pool(torch.rand(255, 257, generator=gen_r, device=DEV),
               "normmap (255, 257)")
    same = torch.equal(out["eager"][EAGER_LEVELS], out["eager"][0])
    emit({"library_eager": {"gemm": f"{tuple(xe.shape)} @ {tuple(we.shape)}",
                            "tau": tau_e, "levels": EAGER_LEVELS,
                            "bit_identical_to_levels_0": same,
                            "pool_launches": out["eager"]["pool_launches"]}})
    check(same and out["eager"]["pool_launches"] > 0,
          "eager levels > 0 differs from flat or never pooled")
    return counts, pool, mm["w1"]


def refined_tables(mask, r, block_n=1):
    """Step tables and runs of the gate `mask` ((gm, gnb, gk) at tile T)
    at the sub-tile T / r and block_n 1: each kept (i, j, k) becomes its r
    × r·block_n output sub-blocks, each with the r sub-tile k's of k in
    ascending order. The sub-tile kernels on these tables add every
    element's products in the chunked kernels' order (f32: fmaf over
    ascending q; bf16: the k16 slices in order), so they are the chunked
    kernels' oracle bit for bit."""
    import numpy as np
    import torch

    from repro_torch.core import plan as P

    m = mask.cpu().numpy()
    fine = np.repeat(np.repeat(np.repeat(m, r, 0), r * block_n, 1), r, 2)
    work, _ = P.compact_from_triples(*np.nonzero(fine), gm=fine.shape[0],
                                     gn=fine.shape[1], gk=fine.shape[2])
    return tuple(torch.as_tensor(getattr(work, n), device=mask.device)
                 for n in ("step_i", "step_j", "step_k", "step_flags",
                           "runs"))


def first_band(p):
    """(step tables, runs) of plan p's first row band: the runs of row tile
    0, which an eager plan orders first."""
    w = p.work
    n0 = int((w.step_i[w.runs[:-1].long()] == 0).sum())
    return (w.step_i, w.step_j, w.step_k, w.step_flags, w.runs[:n0 + 1])


def lt_library_main(a, b):
    """(l1) as a user calls it: spamm(valid_ratio) at each tile of
    LT_LIB_TILES and dtype, then a levels = LIB_LEVELS plan at the first
    tile's f32 τ. Returns {(tile, dtype): {c, info, spamm_host_ms},
    "hier": plan}."""
    from repro_torch.core import plan as P
    from repro_torch.core.spamm import spamm

    out = {}
    for t in LT_LIB_TILES:
        for dtype in ("float32", "bfloat16", "int8"):
            (c, info), ms = host_ms(lambda: spamm(
                a, b, valid_ratio=LIB_RATIOS[0], tile=t, compute_dtype=dtype))
            out[(t, dtype)] = {"c": c, "info": info, "spamm_host_ms": ms}
    t = LT_LIB_TILES[0]
    out["hier"] = P.plan(a, b, out[(t, "float32")]["info"].tau, tile=t,
                         levels=LIB_LEVELS)
    return out


def check_lt_library(a, b, runs):
    """(l1): the achieved ratio within RATIO_TOL; plan() + execute() ≡
    spamm() bit for bit, with their times; on the plan's own first row band
    of step tables, C against the plain version (int8 bit for bit; f32 and
    bf16 within MM_RTOL: the kernel adds with fmaf, the plain version
    rounds product and sum apart) and, f32 and bf16, bit for bit against
    the 64-tile kernel on the refined tables; at the first tile, work-list
    ≡ dense-grid over the whole product and the levels plan's tables ≡
    the flat plan's."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.kernels import ref, spamm_mm
    from repro_torch.kernels import quantize as Q

    r = LIB_RATIOS[0]
    dense_ms = time_ms(lambda: torch.matmul(a, b), reps=3, warmup=1)
    for (t, dtype), run in ((k, v) for k, v in runs.items() if k != "hier"):
        c, info = run["c"], run["info"]
        vf = float(info.valid_fraction)
        p, plan_ms = host_ms(lambda: P.plan(a, b, valid_ratio=r, tile=t,
                                            compute_dtype=dtype))
        exec_ms = time_ms(lambda: P.execute(p, a, b), reps=3, warmup=1)
        same_exec = torch.equal(P.execute(p, a, b), c)
        tabs = first_band(p)
        if dtype == "int8":
            a_q, a_s = Q.quantize_tiles(a[:t], t, scales=p.a_scale[:1])
            b_q, b_s = Q.quantize_tiles(b, t, scales=p.b_scale)
            plain = spamm_mm.spamm_mm_worklist_int8_plain(a_q, b_q, a_s, b_s,
                                                          *tabs, tile=t)
            del b_q
            sub_same = None
        else:
            ops = ((a[:t], b) if dtype == "float32"
                   else (a[:t].bfloat16(), b.bfloat16()))
            plain = spamm_mm.spamm_mm_worklist_plain(*ops, *tabs, tile=t)
            fine = spamm_mm.spamm_mm_worklist_cuda(
                *ops, *refined_tables(p.mask[:1], t // 64), tile=64)
            sub_same = torch.equal(c[:t], fine)
            del ops, fine
        abs_err, rel = errors(c[:t], plain)
        plain_same = torch.equal(c[:t], plain)
        del plain
        flops, n_acc, nbytes = worklist_work(
            p.work, t, 1, itemsize={"float32": 4, "bfloat16": 2,
                                    "int8": 1}[dtype])
        peak = {"float32": PEAK_F32_FLOP_S, "bfloat16": PEAK_BF16_FLOP_S,
                "int8": PEAK_INT8_OP_S}[dtype]
        bms, by = bound_ms(nbytes + c.numel() * 4, flops, peak)
        res = {"n": a.shape[0], "tile": t, "compute_dtype": dtype,
               "valid_ratio": r, "tau": info.tau, "achieved_ratio": vf,
               "acc_steps": n_acc, "spamm_host_ms": run["spamm_host_ms"],
               "plan_host_ms": plan_ms, "execute_ms": exec_ms,
               "dense_matmul_ms": dense_ms, "execute_bound_ms": bms,
               "bound_by": by, "plan_execute_bit_identical": same_exec,
               "band_rows": t, "band_runs": int(tabs[4].numel() - 1),
               "band_max_abs_err_vs_plain": abs_err,
               "band_max_rel_err_vs_plain": rel,
               "band_bit_identical_to_plain": plain_same,
               "band_bit_identical_to_sub_tile_kernel": sub_same}
        ok = (abs(vf - r) <= RATIO_TOL and p.tau == info.tau and same_exec
              and (plain_same if dtype == "int8" else
                   rel <= MM_RTOL and sub_same))
        if t == LT_LIB_TILES[0] and dtype == "float32":
            kidx, nvalid = ref.spamm_compact_ref(p.mask)
            res["dense_grid_bit_identical"] = torch.equal(
                spamm_mm.spamm_mm_cuda(a, b, kidx, nvalid, tile=t), c)
            del kidx, nvalid
            hier = runs["hier"]
            res["hier_tables_equal_flat"] = all(
                torch.equal(x, y) for x, y in zip(hier.work, p.work))
            res["hier_output_bit_identical"] = torch.equal(
                P.execute(hier, a, b), c)
            ok = ok and res["dense_grid_bit_identical"] and \
                res["hier_tables_equal_flat"] and \
                res["hier_output_bit_identical"]
        emit({"large_tile_library": res})
        check(ok, f"large tiles library {t} {dtype}: {res}")
        del p
        torch.cuda.empty_cache()


def lt_w1_taus(x, w1):
    """The τ of each (tile, dtype) of (l2): the median norm product of the
    (quantized) operands, before widening."""
    from repro_torch.kernels import getnorm

    taus = {}
    for t in LT_TILES:
        taus[(t, "float32")] = median_product_tau(
            getnorm.tile_norms_cuda(x, t), getnorm.tile_norms_cuda(w1, t))
        for dtype in LOWP_DTYPES:
            taus[(t, dtype)] = lowp_median_tau(x, w1, dtype, t)
    return taus


def lt_w1_main(x, w1, taus):
    """(l2) as the serving path runs a gated weight: freeze w1 at each tile
    and dtype, plan the activation against it, execute; then, at the first
    tile, the same with the tensor-core get-norm (use_mxu) at f32 and int8.
    Returns {(tile, dtype): (frozen plan, C)}."""
    from repro_torch.core import plan as P
    from repro_torch.plans.frozen import FrozenWeight

    out = {}
    for t in LT_TILES:
        for dtype in ("float32", "bfloat16", "int8"):
            fw = FrozenWeight.build(w1, taus[(t, dtype)], tile=t,
                                    compute_dtype=dtype)
            frozen = P.plan(x, frozen_weight=fw.for_rows(x.shape[0] // t))
            out[(t, dtype)] = (frozen, P.execute(frozen, x, w1))
    t = LT_TILES[0]
    for dtype in ("float32", "int8"):
        fw = FrozenWeight.build(w1, taus[(t, dtype)], tile=t, use_mxu=True,
                                compute_dtype=dtype)
        frozen = P.plan(x, frozen_weight=fw.for_rows(x.shape[0] // t),
                        use_mxu_norm=True)
        out[("mxu", dtype)] = (frozen, P.execute(frozen, x, w1))
    return out


def check_lt_w1(x, w1, taus, runs):
    """(l2) at each tile: frozen ≡ eager bit for bit at each dtype (at int8
    and tiles ≥ 254 the widened gate keeps every tile); the f32 and bf16
    kernels on the frozen plan's tables, the int8 kernel on a
    valid_ratio = LT_W1_RATIO plan's (its frozen gate keeps all at 256 and
    512), against their plain versions (int8 bit for bit, f32 and bf16
    within MM_RTOL), bit for bit against the 64-tile kernel on the refined
    tables (f32, bf16), bf16 against the f32 kernel on the rounded
    operands and twice equal; each timed single and back to back beside
    its bound and the library call (`torch.matmul` f32 / bf16,
    `torch._int_mm` with B row- and column-major). Returns the
    kernel_check results by (tile, dtype)."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.kernels import spamm_mm
    from repro_torch.kernels import quantize as Q

    d, ff = w1.shape
    xb, wb = x.bfloat16(), w1.bfloat16()
    out = {}
    for t in LT_TILES:
        r = t // 64
        for dtype in ("float32", "bfloat16", "int8"):
            frozen, c = runs[(t, dtype)]
            eager = P.plan(x, w1, taus[(t, dtype)], tile=t,
                           compute_dtype=dtype)
            same_fe = torch.equal(P.execute(eager, x, w1), c)
            vf_frozen = float(frozen.valid_fraction)
            del eager
            label = f"frozen w1 {x.shape[0]}x{d}x{ff} tile {t}"
            if dtype == "int8":
                p = P.plan(x, w1, valid_ratio=LT_W1_RATIO, tile=t,
                           compute_dtype="int8")
                wk = p.work
                a_q, a_s = Q.quantize_tiles(x, t, scales=p.a_scale)
                b_q, b_s = Q.quantize_tiles(w1, t, scales=p.b_scale)
                tabs = (wk.step_i, wk.step_j, wk.step_k, wk.step_flags,
                        wk.runs)
                args = (a_q, b_q, a_s, b_s, *tabs)

                def fn(args=args, t=t):
                    return spamm_mm.spamm_mm_worklist_int8_cuda(*args,
                                                                tile=t)

                got = fn()
                geometry = dict(spamm_mm.last_geometry)
                want = spamm_mm.spamm_mm_worklist_int8_plain(*args, tile=t)
                f32 = spamm_mm.spamm_mm_worklist_cuda(
                    Q.dequantize_tiles(a_q, a_s, t),
                    Q.dequantize_tiles(b_q, b_s, t), *tabs, tile=t)
                same = torch.equal(got, want)
                abs_f, rel_f = errors(got, f32)
                ok = same and rel_f <= INT8_DEQ_RTOL
                flops, n_acc, nbytes = worklist_work(wk, t, 1, itemsize=1)
                nbytes += got.numel() * 4 + (a_s.numel() + b_s.numel()) * 4
                bms, by = bound_ms(nbytes, flops, PEAK_INT8_OP_S)
                b_cm = b_q.t().contiguous().t()
                res = {"max_abs_err": float((got - want).abs().max()),
                       "bit_identical_to_plain": same,
                       "max_rel_err_vs_f32_dequantized": rel_f,
                       "valid_fraction": float(p.valid_fraction),
                       "plain_ms": time_ms(lambda: spamm_mm.
                                           spamm_mm_worklist_int8_plain(
                                               *args, tile=t), reps=1,
                                           warmup=0),
                       "library_ms": time_ms(lambda: torch._int_mm(a_q,
                                                                   b_cm)),
                       "library_call": "torch._int_mm on the int8 codes, B "
                                       "column-major (dense, no scales)",
                       "library_rowmajor_b_ms": time_ms(
                           lambda: torch._int_mm(a_q, b_q))}
                del p, a_q, b_q, b_cm, f32, want
            else:
                wk = frozen.work
                tabs = (wk.step_i, wk.step_j, wk.step_k, wk.step_flags,
                        wk.runs)
                ops = (x, w1) if dtype == "float32" else (xb, wb)

                def fn(ops=ops, tabs=tabs, t=t):
                    return spamm_mm.spamm_mm_worklist_cuda(*ops, *tabs,
                                                           tile=t)

                got = fn()
                geometry = dict(spamm_mm.last_geometry)
                want = spamm_mm.spamm_mm_worklist_plain(*ops, *tabs, tile=t)
                fine = spamm_mm.spamm_mm_worklist_cuda(
                    *ops, *refined_tables(frozen.mask, r), tile=64)
                abs_err, rel = errors(got, want)
                sub_same = torch.equal(got, fine)
                ok = rel <= MM_RTOL and sub_same and torch.equal(got, c)
                res = {"max_abs_err": abs_err, "max_rel_err": rel,
                       "bit_identical_to_sub_tile_kernel": sub_same,
                       "valid_fraction": vf_frozen}
                if dtype == "bfloat16":
                    f32 = spamm_mm.spamm_mm_worklist_cuda(
                        xb.float(), wb.float(), *tabs, tile=t)
                    _, rel32 = errors(got, f32)
                    det = torch.equal(got, fn())
                    ok = ok and rel32 <= MM_RTOL and det
                    res.update({"max_rel_err_vs_f32_on_rounded": rel32,
                                "deterministic": det})
                    del f32
                flops, n_acc, nbytes = worklist_work(
                    wk, t, 1, itemsize=4 if dtype == "float32" else 2)
                nbytes += got.numel() * 4
                bms, by = bound_ms(nbytes, flops,
                                   PEAK_F32_FLOP_S if dtype == "float32"
                                   else PEAK_BF16_FLOP_S)
                res.update({
                    "plain_ms": time_ms(lambda: spamm_mm.
                                        spamm_mm_worklist_plain(
                                            *ops, *tabs, tile=t), reps=1,
                                        warmup=0),
                    "library_ms": time_ms(lambda: torch.matmul(*ops)),
                    "library_call": f"torch.matmul on the {dtype} "
                                    f"operands (dense)"})
                del want, fine
            res = {"name": {"float32": "spamm_mm_worklist",
                            "bfloat16": "spamm_mm_worklist_bf16",
                            "int8": "spamm_mm_worklist_int8"}[dtype],
                   "shape": label, "tile": t,
                   "kernel": kernel_name(geometry, dtype),
                   "mma": geometry["mma"], "acc_steps": n_acc,
                   "geometry": geometry, **res,
                   "frozen_equals_eager": same_fe,
                   "frozen_valid_fraction": vf_frozen,
                   "ms": time_ms(fn),
                   "ms_back_to_back": time_ms_back_to_back(fn, calls=10,
                                                           reps=3),
                   "bound_ms": bms, "bound_by": by, "card": CARD}
            emit({"kernel_check": res})
            check(ok and same_fe, f"large tiles w1 {t} {dtype}: {res}")
            out[(t, dtype)] = res
            del got
    for dtype in ("float32", "int8"):
        t = LT_TILES[0]
        mxu = runs[("mxu", dtype)]
        emit({"large_tile_mxu_freeze": {
            "tile": t, "compute_dtype": dtype,
            "valid_fraction": float(mxu[0].valid_fraction),
            "finite": bool(torch.isfinite(mxu[1]).all())}})
        check(bool(torch.isfinite(mxu[1]).all()),
              f"large tiles use_mxu freeze {dtype}: non-finite output")
    return out


def lt_odd_cases(x, w1, w2, gen):
    """(label, activation, weight, tile) of (l5): the prefill activation
    zero-padded to each of LT_ODD_TILES against w1, a decode step's
    activation (BATCH real rows of one row tile) against w2 at
    LT_ODD_DECODE_TILE."""
    import torch

    from repro_torch.core import plan as P

    d, ff = w1.shape
    out = []
    for t in LT_ODD_TILES:
        xp = P.pad_to_tile(x, t).contiguous()
        out.append((f"frozen w1 {xp.shape[0]}({x.shape[0]})x{d}x{ff} tile "
                    f"{t}", xp, w1, t))
    t = LT_ODD_DECODE_TILE
    xd = torch.zeros(t, ff, device=DEV)
    xd[:BATCH] = torch.randn(BATCH, ff, generator=gen, device=DEV)
    out.append((f"frozen w2 decode {t}({BATCH})x{ff}x{d} tile {t}", xd, w2,
                t))
    return out


def lt_odd_f32_tau(label, dtype, tile):
    """Whether (l5)'s case `label` at `dtype` takes an f32 τ
    (LT_ODD_F32_TAU: prefill cases only)."""
    return (dtype, tile) in LT_ODD_F32_TAU and "decode" not in label


def lt_odd_main(cases, taus):
    """(l5) as the serving path runs a gated weight: freeze each case's
    weight at its tile at bf16 and int8, plan its activation against it,
    execute."""
    from repro_torch.core import plan as P
    from repro_torch.plans.frozen import FrozenWeight

    for label, xa, w, t in cases:
        for dtype in LOWP_DTYPES:
            fw = FrozenWeight.build(w, taus[(label, dtype)], tile=t,
                                    compute_dtype=dtype)
            frozen = P.plan(xa, frozen_weight=fw.for_rows(xa.shape[0] // t))
            P.execute(frozen, xa, w)


def check_lt_odd(cases):
    """(l5): each case at int8 (`check_int8_frozen`: ≡ plain bit for bit)
    and bf16 (`check_bf16_frozen`: within MM_RTOL, deterministic), frozen ≡
    eager, each on the family `mma_family` gives its tile (`wgmma` from 48,
    `mma.sync` at 16 and 32); the decode case at 2 column slices. Returns
    the kernel_check results by kernel name ("spamm_mm_worklist_bf16" /
    "_int8" for `wgmma`, "..._mma_sync")."""
    import torch

    from repro_torch.kernels import spamm_mm

    out = {}
    for label, xa, w, t in cases:
        f32_tau = lt_odd_f32_tau(label, "int8", t)
        for dt, res in (("int8", check_int8_frozen(xa, w, label, tile=t,
                                                   f32_tau=f32_tau)),
                        ("bf16", check_bf16_frozen(xa, w, label, tile=t))):
            geo = res["geometry"]
            fam = spamm_mm.mma_family(
                t, torch.int8 if dt == "int8" else torch.bfloat16)
            check(geo["mma"] == fam and (
                t != LT_ODD_DECODE_TILE or "decode" not in label
                or geo["column_slices"] == 2),
                f"large tiles {label}: {dt} ran {geo}, not {fam}")
            name = (f"spamm_mm_worklist_{dt}"
                    f"{'_mma_sync' if fam == 'mma.sync' else ''}")
            out.setdefault(name, []).append(res)
    return out


def phase_large_tiles():
    """The gated GEMMs at the reference's large tiles (LT_* above):
    operands made on the card, the main path ((l1) spamm() at each tile and
    dtype and a levels plan, (l2) frozen w1 at each tile and dtype and the
    use_mxu freezes, (l4) spamm_bmm; then (l5) the tiles that are not
    multiples of 64) driven once, (l1)–(l4) and (l5) each with every count
    at 0 just before and read just after, then the checks and timings, (l3)
    the get-norm kernels at LT_NORM_TILES among them. Returns ((l1)–(l4)'s
    counts, (l5)'s counts, the kernel_check results by kernel name)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import plan as P

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    a = algebraic_decay_on_card(LIB_N, SEED)
    b = algebraic_decay_on_card(LIB_N, SEED + 1)
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d, ff = cfg.d_model, cfg.d_ff
    w1 = torch.randn(d, ff, generator=gen, device=DEV).mul_(d ** -0.5)
    x = torch.randn(BATCH * PROMPT_LEN, d, generator=gen, device=DEV)
    w2 = torch.randn(ff, d, generator=gen, device=DEV).mul_(ff ** -0.5)
    odd = lt_odd_cases(x, w1, w2, gen)
    gen_m = torch.Generator(device=DEV).manual_seed(SEED)
    xm = torch.randn(LT_MOE_SLICES, LT_MOE_ROWS, MOE_D, generator=gen_m,
                     device=DEV)
    wm = torch.randn(LT_MOE_SLICES, MOE_D, MOE_FF, generator=gen_m,
                     device=DEV).mul_(MOE_D ** -0.5)
    taus = lt_w1_taus(x, w1)
    taus_ms = {(label, dt): lowp_median_tau(
        xa, w, dt, t, f32=lt_odd_f32_tau(label, dt, t))
        for label, xa, w, t in odd for dt in LOWP_DTYPES}
    tau_m = batched_median_tau(slice_norms(xm, LT_MOE_TILE),
                               slice_norms(wm, LT_MOE_TILE))
    torch.cuda.synchronize()
    emit({"large_tiles_setup": {
        "seconds": time.perf_counter() - t_phase,
        "w1_taus": {f"{t} {dt}": v for (t, dt), v in taus.items()},
        "odd_tile_taus": {f"{k} {dt}": v for (k, dt), v in taus_ms.items()},
        "moe_tau": tau_m}})

    reset_counts()
    t0 = time.perf_counter()
    lib = lt_library_main(a, b)
    w1_runs = lt_w1_main(x, w1, taus)
    c_m, info_m = P.spamm_bmm(xm, wm, tau_m, tile=LT_MOE_TILE)
    torch.cuda.synchronize()
    counts = read_counts()
    reset_counts()
    t1 = time.perf_counter()
    lt_odd_main(odd, taus_ms)
    torch.cuda.synchronize()
    odd_counts = read_counts()
    emit({"large_tiles_path": {"seconds": time.perf_counter() - t0,
                               "launches": counts,
                               "odd_tiles_seconds": time.perf_counter() - t1,
                               "odd_tiles_launches": odd_counts}})
    # every kernel but the f32 decode kernel (the serving runs' decode
    # steps; held at tiles 128 and 256 by tests/test_torch_cuda.py); (l5)
    # the bf16 and int8 `wgmma` and `mma.sync` kernels
    check(all(v + odd_counts[k] > 0 for k, v in counts.items()
              if k != "spamm_mm_worklist_decode")
          and all(odd_counts[f"spamm_mm_worklist_{dt}{fam}"] > 0
                  for dt in ("bf16", "int8") for fam in ("", "_mma_sync")),
          f"large tiles launches {counts}, (l5) {odd_counts}")

    results = {}
    check_lt_library(a, b, lib)
    del lib, a, b
    torch.cuda.empty_cache()
    for (t, dtype), res in check_lt_w1(x, w1, taus, w1_runs).items():
        results.setdefault(res["name"], []).append(res)
    del w1_runs
    torch.cuda.empty_cache()
    for name, res in check_lt_odd(odd).items():
        results.setdefault(name, []).extend(res)
    del odd, w2
    torch.cuda.empty_cache()
    for t in LT_NORM_TILES:
        for m, label in ((w1, f"w1 {d}x{ff}"),
                         (x, f"activation {x.shape[0]}x{d}")):
            label = f"{label} tile {t}"
            results.setdefault("tile_norms", []).append(
                check_tile_norms(m, label, tile=t))
            results.setdefault("tile_norms_quant", []).append(
                check_tile_norms_quant(m, label, tile=t))
            mxu, mxu_q = check_tile_norms_mxu(m, label, tile=t)
            results.setdefault("tile_norms_mxu", []).append(mxu)
            results.setdefault("tile_norms_quant_mxu", []).append(mxu_q)
    results["spamm_mm"] = [check_dense_grid("qwen2-moe expert w1", xm, wm,
                                            tau_m, c_m, info_m,
                                            tile=LT_MOE_TILE)]
    del x, w1, xm, wm, c_m
    torch.cuda.empty_cache()
    emit({"large_tiles_phase": {"seconds": time.perf_counter() - t_phase}})
    return counts, odd_counts, results


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.device import f32_numerics
    from repro_torch.kernels import build, spamm_mm

    f32_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    t0 = time.perf_counter()
    report = build.build_all()
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "sources": {s: {"seconds": r["seconds"],
                                    "cached": r["cached"],
                                    "ptxas": [ln.strip() for ln in
                                              r["ptxas"].splitlines()
                                              if "Used" in ln or "spill" in ln]}
                                for s, r in report.items()}}})
    int8_sass()
    mxu_sass()

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    norms_act, mm_w1, lowp, decode = timed("kernels", phase_kernels)
    profile_path, _, cal_counts = timed("calibrate", phase_calibrate)
    (counts, lowp_counts, store_counts, chunked_counts, tuned_counts,
     seconds["autotune"]) = timed("serve", phase_serve, profile_path)
    family_counts = timed("dense_families", phase_dense_families,
                          profile_path)
    moe_counts = timed("moe", phase_moe)
    last_counts = timed("last_families", phase_last_families)
    train_counts, train_tau0, train_products = timed("train", phase_train)
    multi_counts = timed("multi", phase_multi)
    tp_counts, st_counts, seconds["serve_tp"] = timed("tp", phase_tp)
    dry_counts = timed("dryrun", phase_dryrun)
    lib_counts, pool, dense = timed("library", phase_library)
    lt_counts, odd_counts, lt = timed("large_tiles", phase_large_tiles)
    emit({"phase_seconds": {**seconds, "note": "serve includes autotune; "
                                               "tp includes serve_tp"}})

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    train_path = (f"train: {ARCH} at {TRAIN_LAYERS} layers, (t3) τ > 0 "
                  f"bwd=spamm, {TRAIN_STEPS} steps (remat full)")
    serve_path = "serve: starcoder2-7b wave, run (c)"
    chunked_path = "serve: starcoder2-7b chunked plane, run (f)"
    int8_path = "serve: starcoder2-7b wave, run (d) int8"
    bf16_path = "serve: starcoder2-7b wave, run (e) bf16"
    odd_path = (f"large_tiles (l5): {ARCH} w1 frozen at tiles "
                f"{', '.join(map(str, LT_ODD_TILES))} (prefill), "
                f"w2 at {LT_ODD_DECODE_TILE} (decode)")
    lib_path = "library: (a) paper ensemble, (b) moe spamm_bmm, (d) eager"
    moe_path = (f"serve: {MOE_ARCH} wave, derived τ > 0, moe_bmm "
                f"(one prefill, {MAX_NEW - 1} graphed decode steps)")
    store_path = (f"store: freeze {ARCH}'s first {STORE_MXU_LAYERS} "
                  f"layers' {store_counts['mxu_weights']} gated weights into "
                  f"a plan store, use_mxu=True at f32 and int8")
    def multi_path(name):
        """A kernel's launches on each cell of the multi phase ((m2) and
        (m3): summed over the ranks)."""
        return {cell: c[name] for cell, c in multi_counts.items()}

    def tp_path(name):
        """A kernel's launches on each cell of the tp phase, summed over
        its 4 ranks."""
        return {cell: c[name] for cell, c in tp_counts.items()}

    def serve_tp_path(name):
        """A kernel's launches on each rank in each cell of the serve_tp
        phase (`Engine(ctx=)` over a model axis)."""
        return {"serve_tp_launches_per_rank": {
            cell: [n[name] for n in per] for cell, per in st_counts.items()}}

    def dryrun_path(name):
        """A kernel's launches on each SpAMM variant of the dryrun phase."""
        return {"dryrun_launches": {v: c[name]
                                    for v, c in dry_counts.items()}}

    def large_tile_path(name):
        """A kernel's launches on the large_tiles phase's main path and its
        kernel_check numbers there, one entry per tile and shape."""
        lt_keys = keys + ("tile", "ms_back_to_back", "valid_fraction",
                          "kernel", "mma")
        return {"large_tile_launches": lt_counts[name],
                "large_tiles": [{k: r[k] for k in lt_keys if k in r}
                                for r in lt.get(name, [])]}

    def other_paths(name):
        """A kernel's launches on the calibration, the tuned run (c) wave,
        codeqwen1.5-7b's τ > 0 and autotuned waves, the τ > 0 waves of
        the last four families (mamba2-1.3b's: none) and the multi and tp
        phases' cells."""
        return {"multi_launches": multi_path(name),
                "tp_launches": tp_path(name), **serve_tp_path(name),
                "calibrate_launches": cal_counts[name],
                "autotune_launches": tuned_counts[name],
                "dense_family_launches": {
                    k: c[name] for k, c in family_counts.items()},
                "last_family_launches": {
                    k: c[name] for k, c in last_counts.items()}}

    kernels = [
        {"name": "tile_norms", "route": "cuda",
         **large_tile_path("tile_norms"),
         "source": "src/repro_torch/kernels/csrc/getnorm.cu",
         "replaces": "src/repro/kernels/getnorm.py:147",
         "launches": counts["tile_norms"], "path": serve_path,
         "chunked_launches": chunked_counts["tile_norms"],
         "chunked_path": chunked_path,
         "moe_launches": moe_counts["tile_norms"], "moe_path": moe_path,
         "train_launches": train_counts["tile_norms"],
         "train_path": train_path,
         "train_tau0_launches": {k: c["tile_norms"]
                                 for k, c in train_tau0.items()},
         **other_paths("tile_norms"), **dryrun_path("tile_norms"),
         "ms_back_to_back": norms_act["ms_back_to_back"],
         **{k: norms_act[k] for k in keys}},
        {"name": "spamm_mm_worklist", "route": "cuda",
         **large_tile_path("spamm_mm_worklist"),
         "source": "src/repro_torch/kernels/csrc/spamm_mm.cu",
         "replaces": "src/repro/kernels/spamm_mm.py:203",
         "launches": counts["spamm_mm_worklist"], "path": serve_path,
         "chunked_launches": chunked_counts["spamm_mm_worklist"],
         "chunked_path": chunked_path,
         "moe_launches": moe_counts["spamm_mm_worklist"],
         "moe_path": moe_path,
         "train_launches": train_counts["spamm_mm_worklist"],
         "train_path": train_path,
         "train_tau0_launches": {k: c["spamm_mm_worklist"]
                                 for k, c in train_tau0.items()},
         "train_products": [{k: r[k] for k in keys + ("ms_back_to_back",
                                                      "valid_fraction")}
                            for r in train_products],
         **other_paths("spamm_mm_worklist"),
         **dryrun_path("spamm_mm_worklist"),
         **{k: mm_w1[k] for k in keys}},
        {"name": "spamm_mm_worklist_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/spamm_decode.cu",
         "replaces": "src/repro/kernels/spamm_mm.py:203",
         "variant": f"f32 at ≤ {spamm_mm.DECODE_MAX_ROWS} live rows "
                    f"(rows=), tile a multiple of 64",
         "kernel": decode["w2"][0]["kernel"], "mma": "fma_decode",
         "launches": counts["spamm_mm_worklist_decode"], "path": serve_path,
         "chunked_launches": chunked_counts["spamm_mm_worklist_decode"],
         "chunked_path": chunked_path,
         "moe_launches": moe_counts["spamm_mm_worklist_decode"],
         "moe_path": moe_path,
         **other_paths("spamm_mm_worklist_decode"),
         "ms_back_to_back": decode["w2"][0]["ms_back_to_back"],
         "device_ms": decode["w2"][0]["device_ms"],
         "geometry": decode["w2"][0]["geometry"],
         "shapes": [{k: r[k] for k in keys + (
             "rows", "kernel", "ms_back_to_back", "device_ms",
             "device_ms_64_row_kernel", "library_device_ms",
             "library_64_rows_device_ms", "valid_fraction")}
             for site in ("w1", "w2") for r in decode[site]],
         **{k: decode["w2"][0][k] for k in keys}},
        {"name": "spamm_mm_worklist_bf16", "route": "cuda",
         **large_tile_path("spamm_mm_worklist_bf16"),
         "multi_launches": multi_path("spamm_mm_worklist_bf16"),
         **dryrun_path("spamm_mm_worklist_bf16"),
         "source": "src/repro_torch/kernels/csrc/spamm_wgmma.cu",
         "kernel": lowp["bf16"]["kernel"], "mma": lowp["bf16"]["mma"],
         "odd_tile_launches": odd_counts["spamm_mm_worklist_bf16"],
         "odd_tile_path": odd_path,
         "mma_sync_source": "src/repro_torch/kernels/csrc/spamm_mm.cu "
                            "(tiles 16 and 32)",
         "replaces": "src/repro/kernels/spamm_mm.py:203",
         "launches": lowp_counts["bfloat16"]["spamm_mm_worklist_bf16"],
         "path": bf16_path,
         "ms_back_to_back": lowp["bf16"]["ms_back_to_back"],
         "geometry": lowp["bf16"]["geometry"],
         **{k: lowp["bf16"][k] for k in keys}},
        {"name": "pool_norms", "route": "cuda",
         **large_tile_path("pool_norms"),
         "multi_launches": multi_path("pool_norms"),
         "source": "src/repro_torch/kernels/csrc/getnorm.cu",
         "replaces": "src/repro/kernels/getnorm.py:98",
         "launches": lib_counts["pool_norms"], "path": lib_path,
         **{k: pool[k] for k in keys}},
        {"name": "spamm_mm", "route": "cuda",
         **large_tile_path("spamm_mm"),
         "multi_launches": multi_path("spamm_mm"),
         "source": "src/repro_torch/kernels/csrc/spamm_mm.cu",
         "replaces": "src/repro/kernels/spamm_mm.py:109",
         "launches": moe_counts["spamm_mm"], "path": moe_path,
         "tp_launches": tp_path("spamm_mm"), **serve_tp_path("spamm_mm"),
         "library_path_launches": lib_counts["spamm_mm"],
         "library_path": lib_path,
         **{k: dense[k] for k in keys}},
        {"name": "tile_norms_quant", "route": "cuda",
         **large_tile_path("tile_norms_quant"),
         "multi_launches": multi_path("tile_norms_quant"),
         "source": "src/repro_torch/kernels/csrc/getnorm.cu",
         "replaces": "src/repro/kernels/getnorm.py:180",
         "launches": lowp_counts["int8"]["tile_norms_quant"],
         "path": int8_path, "library_call": lowp["quant"]["library_call"],
         "ms_back_to_back": lowp["quant"]["ms_back_to_back"],
         **{k: lowp["quant"][k] for k in keys}},
        {"name": "spamm_mm_worklist_int8", "route": "cuda",
         **large_tile_path("spamm_mm_worklist_int8"),
         "multi_launches": multi_path("spamm_mm_worklist_int8"),
         "source": "src/repro_torch/kernels/csrc/spamm_wgmma.cu",
         "kernel": lowp["int8"]["kernel"], "mma": lowp["int8"]["mma"],
         "odd_tile_launches": odd_counts["spamm_mm_worklist_int8"],
         "odd_tile_path": odd_path,
         "mma_sync_source": "src/repro_torch/kernels/csrc/spamm_mm.cu "
                            "(tiles 16 and 32)",
         "replaces": "src/repro/kernels/spamm_mm.py:322",
         "launches": lowp_counts["int8"]["spamm_mm_worklist_int8"],
         "path": int8_path, "library_call": lowp["int8"]["library_call"],
         "library_colmajor_b_ms": lowp["int8"]["library_colmajor_b_ms"],
         "ms_back_to_back": lowp["int8"]["ms_back_to_back"],
         "geometry": lowp["int8"]["geometry"],
         **{k: lowp["int8"][k] for k in keys}},
        *({"name": name, "route": "cuda", **large_tile_path(name),
           "source": f"src/repro_torch/kernels/csrc/{source}",
           "kernel": lt[name][0]["kernel"], "mma": lt[name][0]["mma"],
           "replaces": replaces, "launches": odd_counts[name],
           "path": odd_path,
           "ms_back_to_back": lt[name][0]["ms_back_to_back"],
           "geometry": lt[name][0]["geometry"],
           **{k: lt[name][0][k] for k in keys}}
          for name, source, replaces in (
              ("spamm_mm_worklist_bf16_mma_sync", "spamm_mm.cu",
               "src/repro/kernels/spamm_mm.py:203"),
              ("spamm_mm_worklist_int8_mma_sync", "spamm_mm.cu",
               "src/repro/kernels/spamm_mm.py:322"))),
        {"name": "tile_norms_mxu", "route": "cuda",
         **large_tile_path("tile_norms_mxu"),
         "multi_launches": multi_path("tile_norms_mxu"),
         "source": "src/repro_torch/kernels/csrc/getnorm.cu",
         "replaces": "src/repro/kernels/getnorm.py:147",
         "variant": "use_mxu=True (_tile_sumsq :36-46)",
         "launches": store_counts["mxu"]["tile_norms_mxu"],
         "path": store_path,
         "library_path_launches": lib_counts["tile_norms_mxu"],
         "library_call": lowp["mxu"][0]["library_call"],
         "ms_back_to_back": lowp["mxu"][0]["ms_back_to_back"],
         **{k: lowp["mxu"][0][k] for k in keys}},
        {"name": "tile_norms_quant_mxu", "route": "cuda",
         **large_tile_path("tile_norms_quant_mxu"),
         "multi_launches": multi_path("tile_norms_quant_mxu"),
         "source": "src/repro_torch/kernels/csrc/getnorm.cu",
         "replaces": "src/repro/kernels/getnorm.py:180",
         "variant": "use_mxu=True (_tile_sumsq :36-46)",
         "launches": store_counts["mxu"]["tile_norms_quant_mxu"],
         "path": store_path, "library_call": lowp["mxu"][1]["library_call"],
         "ms_back_to_back": lowp["mxu"][1]["ms_back_to_back"],
         **{k: lowp["mxu"][1][k] for k in keys}},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
