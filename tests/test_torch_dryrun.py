"""The port's production-mesh dry run (`repro_torch.launch.dryrun`) against
the reference's (`repro.launch.dryrun`): the shape cells, the analytic
MODEL_FLOPS, the rank-local batch shapes, and a tiny cell run as rank 0 of
a fake 2×2 world on the CPU.

Tolerances: `model_flops_estimate` and the batch shapes are exact. The
tiny cell's counted FLOPs equal the analytic count of the port's GEMMs
exactly. Against the reference's `HloAnalysis` of `build_cell` on the
same tiny config and 2×2 mesh they are held within 6 %, and the
difference is accounted for exactly: the reference's flash attention
skips the kv chunks wholly above the causal diagonal (at S = 64 with
32-wide chunks one block of four, a quarter of the attention products, in
every pass: forward, rematerialized forward and the two backward
products), while the port's attention takes the whole KV per q chunk.
GSPMD's other choices (where it gathers, in which dtype) move bytes and
collectives, not FLOPs, so only FLOPs are compared."""
import json

import pytest

from conftest import run_subprocess

TINY = dict(seq=64, batch=4, chunk=32, mesh=((2, 2), ("data", "model")),
            tile=16)

REF_KEYS = {"arch", "shape", "mesh", "devices", "lower_s", "compile_s",
            "memory", "xla_cost_analysis_flops", "hlo", "roofline"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                "model_flops_global", "model_flops_per_device",
                "useful_flops_ratio", "step_time_bound_s"}
REF_HLO = {"flops_per_device", "hbm_bytes_per_device",
           "hbm_staging_bytes_per_device", "hbm_math_bytes_per_device",
           "collective_wire_bytes_per_device", "collectives", "warnings"}


def _all_cells():
    from repro_torch.configs import cells

    return [(a, s) for a, s, _ in cells(include_skipped=True)]


def test_shapes_and_cells_equal_reference():
    import dataclasses

    from repro.configs import base as RB
    from repro_torch.configs import base as TB

    assert {k: dataclasses.asdict(v) for k, v in TB.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RB.SHAPES.items()}
    assert TB.LONG_CONTEXT_ARCHS == RB.LONG_CONTEXT_ARCHS
    for skipped in (False, True):
        assert TB.cells(include_skipped=skipped) == \
            RB.cells(include_skipped=skipped)
    assert len(TB.cells()) == 33 and len(TB.cells(include_skipped=True)) == 40


@pytest.mark.parametrize("arch,shape", _all_cells(),
                         ids=[f"{a}-{s}" for a, s in _all_cells()])
def test_model_flops_estimate_equals_reference(arch, shape):
    from repro.configs import SHAPES as RS, get_config as rcfg
    from repro.launch.dryrun import model_flops_estimate as ref
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import model_flops_estimate

    assert model_flops_estimate(get_config(arch), SHAPES[shape]) == \
        ref(rcfg(arch), RS[shape])


REF_BATCH = r"""
import json
from jax.sharding import NamedSharding
from repro.configs import SHAPES, cells, get_config
from repro.launch.dryrun import batch_specs
from repro.launch.mesh import make_ctx, make_mesh

mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch, shape, _ in cells(include_skipped=True):
    cfg, sh = get_config(arch), SHAPES[shape]
    ba = make_ctx(mesh).batch_axes
    if sh.global_batch % 2:
        ba = None
    specs = batch_specs(cfg, sh, mesh, ba)
    out[f"{arch}/{shape}"] = {k: [list(v.sharding.shard_shape(v.shape)),
                                  str(v.dtype)] for k, v in specs.items()}
print("JSON" + json.dumps(out))
"""


def test_batch_specs_equal_reference_shard_shapes():
    import torch

    from repro_torch.configs import SHAPES, cells, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world

    out = run_subprocess(REF_BATCH, devices=4)
    ref = json.loads(out.split("JSON", 1)[1])
    dtypes = {torch.int32: "int32", torch.bfloat16: "bfloat16"}
    with fake_world(4, shape=(2, 2), axis_names=("data", "model"),
                    device_type="cpu") as mesh:
        for arch, shape, _ in cells(include_skipped=True):
            ctx = dryrun.cell_ctx(mesh, SHAPES[shape])
            got = dryrun.batch_specs(get_config(arch), SHAPES[shape], ctx)
            assert {k: [list(s), dtypes[dt]] for k, (s, dt) in got.items()} \
                == ref[f"{arch}/{shape}"], (arch, shape)


def _tiny():
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config

    cfg = get_config("starcoder2-7b").reduced()
    pcfg = ParallelConfig(compute_dtype="bfloat16",
                          attn_q_chunk=TINY["chunk"],
                          loss_chunk=TINY["chunk"])
    shapes = {k: ShapeConfig(k, k, TINY["seq"], TINY["batch"])
              for k in ("prefill", "decode", "train")}
    return cfg, pcfg, shapes


def _attention(cfg, kind, b, s, nm):
    """One layer's forward attention products on one rank (see
    `analytic_flops`)."""
    hd, hq = cfg.resolved_head_dim, cfg.num_heads
    return (4 * b * hq * (s // nm) * hd if kind == "decode"
            else 4 * b * (hq // nm) * s * s * hd)


def analytic_flops(cfg, kind, b, s, nm):
    """The port's GEMMs on one rank of a (data, model = nm) mesh for the
    tiny starcoder2 (GELU MLP of two matrices, every dim cut whole): the
    q/k/v/o projections and the MLP on the rank's heads and ff, attention
    (prefill and train: each q chunk against the whole KV, per rank head;
    decode: every head against the rank's S/nm cache slots), the
    vocabulary-parallel head (prefill and decode: the last position; train:
    every token). Train: forward, the rematerialized forward and two
    backward products per forward one (layers), forward and two backward
    (head)."""
    d, hd, ff, v = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    t = b if kind == "decode" else b * s
    proj = 2 * t * d * hd * (hq + 2 * hk) // nm + 2 * t * hq * hd * d // nm
    mlp = 2 * 2 * t * d * ff // nm
    layer = proj + mlp + _attention(cfg, kind, b, s, nm)
    head = 2 * (b * s if kind == "train" else b) * d * (v // nm)
    if kind == "train":
        return 4 * cfg.num_layers * layer + 3 * head
    return cfg.num_layers * layer + head


@pytest.fixture(scope="module")
def tiny_cells():
    from repro_torch.launch import dryrun

    cfg, pcfg, shapes = _tiny()
    return {k: dryrun.run_cell("starcoder2-7b", k, pcfg=pcfg, device="cpu",
                               cfg=cfg, shape=sh, mesh_shape=TINY["mesh"],
                               tile=TINY["tile"], verbose=False)
            for k, sh in shapes.items()}


REF_TINY = r"""
import json
import repro.launch.dryrun as D
from repro.configs import ParallelConfig, ShapeConfig, get_config
from repro.launch import hlo_analysis
from repro.launch.mesh import make_mesh

cfg = get_config("starcoder2-7b").reduced()
D.get_config = lambda name: cfg
D.SHAPES = {k: ShapeConfig(k, k, %(seq)d, %(batch)d)
            for k in ("prefill", "decode", "train")}
mesh = make_mesh((2, 2), ("data", "model"))
pcfg = ParallelConfig(attn_q_chunk=%(chunk)d, attn_kv_chunk=%(chunk)d,
                      loss_chunk=%(chunk)d)
out = {}
for k in ("prefill", "decode", "train"):
    lowered, _ = D.build_cell("starcoder2-7b", k, mesh, pcfg)
    t = hlo_analysis.HloAnalysis(lowered.compile().as_text(), 4).totals()
    out[k] = t["flops_per_device"]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_tiny_flops():
    out = run_subprocess(REF_TINY % TINY, devices=4)
    return json.loads(out.split("JSON", 1)[1])


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_tiny_cell_json_has_reference_keys(tiny_cells, kind):
    out = tiny_cells[kind]
    assert REF_KEYS <= set(out)
    assert REF_MEMORY <= set(out["memory"])
    assert REF_ROOFLINE <= set(out["roofline"])
    assert REF_HLO <= set(out["hlo"])
    assert out["mesh"] == "2x2" and out["devices"] == 4
    assert out["memory"]["argument_bytes"] > 0
    assert out["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert not out["hlo"]["warnings"]
    # FSDP gathers every matrix over "data"
    assert out["hlo"]["collectives"]["all-gather"]["count"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_tiny_cell_flops_equal_the_analytic_count(tiny_cells, kind):
    cfg, _, _ = _tiny()
    b = TINY["batch"] // TINY["mesh"][0][0]
    assert tiny_cells[kind]["hlo"]["flops_per_device"] == analytic_flops(
        cfg, kind, b, TINY["seq"], TINY["mesh"][0][1])


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_tiny_cell_prices_each_dtype_at_its_peak(tiny_cells, kind):
    """The attention products are f32 (the port's attention computes in
    f32), the projections, MLP and head bf16; each is priced at its own
    data-sheet peak."""
    from repro_torch.launch.dryrun import PEAK_FLOPS

    cfg, _, _ = _tiny()
    b = TINY["batch"] // TINY["mesh"][0][0]
    nm = TINY["mesh"][0][1]
    out = tiny_cells[kind]
    f32 = ({"train": 4}.get(kind, 1) * cfg.num_layers
           * _attention(cfg, kind, b, TINY["seq"], nm))
    total = analytic_flops(cfg, kind, b, TINY["seq"], nm)
    assert out["hlo"]["flops_by_dtype"] == {"float32": f32,
                                            "bfloat16": total - f32}
    assert out["roofline"]["compute_s"] == pytest.approx(
        f32 / PEAK_FLOPS["float32"] + (total - f32) / PEAK_FLOPS["bfloat16"],
        rel=1e-12)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_tiny_cell_flops_agree_with_reference_hlo(tiny_cells, ref_tiny_flops,
                                                  kind):
    cfg, _, _ = _tiny()
    got, ref = tiny_cells[kind]["hlo"]["flops_per_device"], \
        ref_tiny_flops[kind]
    assert abs(got - ref) / ref <= 0.06, (got, ref)
    # the difference is the causally masked kv blocks the reference skips
    b, s, c = TINY["batch"] // 2, TINY["seq"], TINY["chunk"]
    nq = s // c
    masked = nq * (nq - 1) // 2
    block = 4 * b * (cfg.num_heads // 2) * c * c * cfg.resolved_head_dim
    passes = {"prefill": 1, "decode": 0, "train": 4}[kind]
    assert got - ref == passes * cfg.num_layers * masked * block


def test_run_cell_writes_its_json(tmp_path):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    cfg, pcfg, _ = _tiny()
    out = dryrun.run_cell("starcoder2-7b", "decode", pcfg=pcfg,
                          out_dir=str(tmp_path), device="cpu", cfg=cfg,
                          shape=ShapeConfig("decode", "decode", 64, 1),
                          mesh_shape=TINY["mesh"], tile=TINY["tile"],
                          verbose=False)
    # a batch of 1 does not divide over 2 data ranks: replicated
    assert out["batch_replicated"] and out["batch_per_rank"] == 1
    with open(tmp_path / "2x2" / "starcoder2-7b__decode.json") as f:
        assert json.load(f)["hlo"]["flops_per_device"] == \
            out["hlo"]["flops_per_device"]


def test_production_world_is_32x8():
    from repro_torch.launch.mesh import fake_world

    for multi_pod, shape in ((False, (32, 8)), (True, (2, 32, 8))):
        with fake_world(256 * (2 if multi_pod else 1), multi_pod=multi_pod,
                        device_type="cpu") as mesh:
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names[-1] == "model"
