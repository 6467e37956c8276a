"""The port stands alone: no module of `src/repro_torch` imports JAX or the
reference package, and importing the package and its serve CLI leaves JAX
out of `sys.modules`."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()}
    for twin in ("kernels/getnorm.py", "kernels/spamm_mm.py", "kernels/ops.py",
                 "core/plan.py", "core/tau_search.py", "core/spamm.py",
                 "plans/frozen.py", "plans/store.py", "plans/precompute.py",
                 "serving/engine.py", "launch/serve.py",
                 "launch/precompute_plans.py", "obs/__init__.py",
                 "obs/registry.py", "obs/tracer.py", "obs/residual.py",
                 "models/moe.py", "models/ssm.py", "models/rglru.py",
                 "configs/spamm_synth.py", "optim/adamw.py",
                 "distributed/compression.py", "data/pipeline.py",
                 "checkpoint/checkpoint.py", "train/loop.py",
                 "launch/train.py", "core/schedule.py",
                 "core/distributed.py", "launch/mesh.py",
                 "distributed/elastic.py", "models/parallel.py",
                 "compat.py", "launch/op_analysis.py", "launch/dryrun.py",
                 "launch/dryrun_spamm.py"):
        assert twin in names


# the reference's modules whose twin has another name
RENAMED_TWINS = {"launch/hlo_analysis.py": "launch/op_analysis.py"}


def test_every_reference_module_has_a_twin():
    ref = SRC / "repro"
    names = {p.relative_to(PORT).as_posix() for p in _port_files()}
    missing = [m for m in (p.relative_to(ref).as_posix()
                           for p in sorted(ref.rglob("*.py")))
               if RENAMED_TWINS.get(m, m) not in names]
    assert not missing, missing


# the low-precision entry points: the fused int8 get-norm, the int8 work-list
# GEMM (plain / CUDA / dispatch each), the registry's int8 entries and the
# GEMM-byte count
LOWP_ENTRY_POINTS = (
    ("repro_torch.kernels.getnorm", ("tile_norms_quant_plain",
                                     "tile_norms_quant_cuda",
                                     "tile_norms_quant", "quant_launches")),
    ("repro_torch.kernels.spamm_mm", ("spamm_mm_worklist_int8_plain",
                                      "spamm_mm_worklist_int8_cuda",
                                      "spamm_mm_worklist_int8",
                                      "int8_launches", "bf16_launches")),
    ("repro_torch.kernels.ops", ("int8_norms_and_scales",)),
    ("repro_torch.core.cost", ("gemm_bytes",)),
)


# the tensor-core get-norm's counters, the plan store and its writer, the
# frozen tier of the weight cache
STORE_ENTRY_POINTS = (
    ("repro_torch.kernels.getnorm", ("mxu_launches", "quant_mxu_launches")),
    ("repro_torch.kernels.ops", ("resolve_backend",)),
    ("repro_torch.core.cost", ("TunedParams",)),
    ("repro_torch.plans.frozen", ("PLAN_FORMAT_VERSION",)),
    ("repro_torch.plans.store", ("PlanStore", "PlanStoreError", "fingerprint",
                                 "fingerprints")),
    ("repro_torch.plans.precompute", ("populate", "freeze_tree", "tune_for",
                                      "_freeze_one")),
    ("repro_torch.launch.precompute_plans", ("main",)),
)


# the observability plane and the cost model's predicting half
OBS_ENTRY_POINTS = (
    ("repro_torch.obs", ("Observability", "MetricsRegistry", "Counter",
                         "Gauge", "Histogram", "SpanTracer", "maybe_span",
                         "CostResidualTracker", "parse_prometheus",
                         "LATENCY_BUCKETS_S", "FRACTION_BUCKETS",
                         "RESIDUAL_LOG2_BUCKETS", "IMBALANCE_BUCKETS")),
    ("repro_torch.core.cost", ("CostCoeffs", "DEFAULT_COEFFS", "device_kind",
                               "profile_key", "CostProfile", "gemm_flops",
                               "predict_time_s", "predict_plan_time_s",
                               "predict_plan_static", "finish_plan_time_s")),
    ("repro_torch.core.module", ("Tap", "TapLabel")),
    ("repro_torch.serving.engine", ("wave_latency", "COUNT_BUCKETS")),
)


# the training path: the differentiable gated GEMM, the loss, the training
# stack and step, AdamW, compression, data, checkpoints, the loop and CLI
TRAIN_ENTRY_POINTS = (
    ("repro_torch.configs", ("TrainConfig",)),
    ("repro_torch.core.module", ("spamm_linear", "_SpammLinear")),
    ("repro_torch.models.layers", ("chunked_ce_loss",)),
    ("repro_torch.models.transformer", ("stack_fwd",)),
    ("repro_torch.models.model", ("forward_hidden", "loss_fn",
                                  "make_train_step")),
    ("repro_torch.optim.adamw", ("AdamW",)),
    ("repro_torch.distributed.compression", ("Int8EF",)),
    ("repro_torch.data.pipeline", ("SyntheticLM", "synthesized_decay",
                                   "ergo_like", "vgg_im2col_shapes",
                                   "relu_sparse_matrix")),
    ("repro_torch.checkpoint.checkpoint", ("save", "restore", "all_steps",
                                           "latest_step",
                                           "plan_store_pointer",
                                           "open_plan_store")),
    ("repro_torch.train.loop", ("train", "TrainResult")),
    ("repro_torch.launch.train", ("main",)),
)


# the multi-GPU slice: schedules, distributed SpAMM, meshes, row shards of
# the frozen plans, the halo wire format, the shared re-sharding probe
MULTI_ENTRY_POINTS = (
    ("repro_torch.core.schedule", (
        "v_matrix", "rows_for_device", "rows_for_partition",
        "device_permutation", "equal_work_partition", "partition_loads",
        "partition_imbalance", "strip_tables", "rescale_offsets",
        "device_loads", "imbalance", "tile_imbalance", "auto_schedule",
        "ReshardConfig", "ReshardController", "resolve_reshard_devices",
        "probe_v_estimate")),
    ("repro_torch.core.distributed", ("spamm_rowpart", "spamm_2d",
                                      "_pick_schedule", "_resolve_schedule")),
    ("repro_torch.launch.mesh", ("make_mesh", "make_host_mesh", "init_group",
                                 "destroy_group", "spawn_ranks")),
    ("repro_torch.plans.frozen", ("stack_plans",)),
    ("repro_torch.distributed.compression", ("compress_tiles",
                                             "decompress_tiles",
                                             "halo_wire_bytes")),
    ("repro_torch.models.model", ("reshard_probe",)),
)


# model parallelism: placements, NetCtx, the TP/SP/FSDP layers, seq-sharded
# decode, the sharded MoE block, elastic re-meshing, the production mesh
TP_ENTRY_POINTS = (
    ("repro_torch.models.model", (
        "param_specs", "sanitize_spec", "place_spec", "placements",
        "with_placements", "shard_params", "gather_params",
        "compute_params", "place_cache")),
    ("repro_torch.models.transformer", ("NetCtx", "attn_weights",
                                        "seq_sharded")),
    ("repro_torch.models.parallel", (
        "gather", "scatter", "reduce_scatter", "enter", "leave",
        "full_weight", "model_slice", "attn_split", "ff_split",
        "split_matmul", "block_in", "block_out", "all_kv_heads")),
    ("repro_torch.models.attention", ("decode_attention_seqsharded",)),
    ("repro_torch.models.moe", ("padded_experts",)),
    ("repro_torch.models.layers", ("chunked_ce_parts", "mlp_weights")),
    ("repro_torch.distributed.elastic", ("best_mesh_shape",
                                         "build_elastic_mesh",
                                         "reshard_state")),
    ("repro_torch.launch.mesh", ("make_ctx", "mesh_from_devices",
                                 "make_production_mesh", "production_shape")),
)


# the dry-run tooling: the version shims, the shape cells, the op-level
# roofline counter, the two dry runs and the fake production world
DRYRUN_ENTRY_POINTS = (
    ("repro_torch.compat", ("all_gather_single", "reduce_scatter_single")),
    ("repro_torch.configs", ("ShapeConfig", "SHAPES", "LONG_CONTEXT_ARCHS",
                             "cells")),
    ("repro_torch.launch.op_analysis", ("OpAnalysis", "COLLECTIVES",
                                        "_wire_bytes")),
    ("repro_torch.launch.dryrun", ("batch_specs", "model_flops_estimate",
                                   "build_cell", "run_cell", "cell_ctx",
                                   "main")),
    ("repro_torch.launch.dryrun_spamm", ("calibrate_tau", "decay_operand",
                                         "run_variant", "main")),
    ("repro_torch.launch.mesh", ("fake_world",)),
    ("repro_torch.kernels.ops", ("analysis",)),
)


@pytest.mark.parametrize("module,names", DRYRUN_ENTRY_POINTS,
                         ids=[m for m, _ in DRYRUN_ENTRY_POINTS])
def test_dryrun_entry_points_exist(module, names):
    import importlib

    mod = importlib.import_module(module)
    for name in names:
        assert hasattr(mod, name), f"{module}.{name}"


@pytest.mark.parametrize("module,names", TP_ENTRY_POINTS,
                         ids=[m for m, _ in TP_ENTRY_POINTS])
def test_tp_entry_points_exist(module, names):
    import importlib

    mod = importlib.import_module(module)
    for name in names:
        assert hasattr(mod, name), f"{module}.{name}"


@pytest.mark.parametrize("module,names", MULTI_ENTRY_POINTS,
                         ids=[m for m, _ in MULTI_ENTRY_POINTS])
def test_multi_entry_points_exist(module, names):
    import importlib

    mod = importlib.import_module(module)
    for name in names:
        assert hasattr(mod, name), f"{module}.{name}"
    from repro_torch.plans.frozen import FrozenWeight

    assert callable(FrozenWeight.slice_rows)
    assert callable(FrozenWeight.shard_by_offsets)


@pytest.mark.parametrize("module,names", TRAIN_ENTRY_POINTS,
                         ids=[m for m, _ in TRAIN_ENTRY_POINTS])
def test_train_entry_points_exist(module, names):
    import importlib

    mod = importlib.import_module(module)
    for name in names:
        assert hasattr(mod, name), f"{module}.{name}"


@pytest.mark.parametrize("module,names", OBS_ENTRY_POINTS,
                         ids=[m for m, _ in OBS_ENTRY_POINTS])
def test_obs_entry_points_exist(module, names):
    import importlib

    mod = importlib.import_module(module)
    for name in names:
        assert hasattr(mod, name), f"{module}.{name}"


@pytest.mark.parametrize("module,names", LOWP_ENTRY_POINTS,
                         ids=[m for m, _ in LOWP_ENTRY_POINTS])
def test_lowp_entry_points_exist(module, names):
    import importlib

    mod = importlib.import_module(module)
    for name in names:
        assert hasattr(mod, name), f"{module}.{name}"


@pytest.mark.parametrize("module,names", STORE_ENTRY_POINTS,
                         ids=[m for m, _ in STORE_ENTRY_POINTS])
def test_store_entry_points_exist(module, names):
    import importlib

    mod = importlib.import_module(module)
    for name in names:
        assert hasattr(mod, name), f"{module}.{name}"


def test_every_backend_has_the_lowp_entries():
    from repro_torch.kernels import ops

    for name, bk in ops.BACKENDS.items():
        assert callable(bk.norms_quant) and callable(bk.matmul_worklist_int8), \
            name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_fresh_import_keeps_jax_out():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.serving.engine\n"
        "import repro_torch.plans.precompute, repro_torch.kernels.ops\n"
        "import repro_torch.core.spamm, repro_torch.core.tau_search\n"
        "import repro_torch.kernels.getnorm, repro_torch.kernels.spamm_mm\n"
        "import repro_torch.kernels.quantize, repro_torch.core.cost\n"
        "import repro_torch.plans.store, repro_torch.launch.precompute_plans\n"
        "import repro_torch.obs, repro_torch.obs.registry\n"
        "import repro_torch.obs.tracer, repro_torch.obs.residual\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.train.loop, repro_torch.launch.train\n"
        "import repro_torch.optim.adamw, repro_torch.data.pipeline\n"
        "import repro_torch.checkpoint.checkpoint\n"
        "import repro_torch.distributed.compression\n"
        "import repro_torch.core.schedule, repro_torch.core.distributed\n"
        "import repro_torch.launch.mesh, repro_torch.compat\n"
        "import repro_torch.launch.op_analysis, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.dryrun_spamm\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# reference CLI flags the port states it does not take: the port's
# attention takes each q chunk against the whole KV in one softmax, so the
# dry run has no KV chunk to set
FLAG_DEPARTURES = {"dryrun.py": {"--kv-chunk"}}


def _cli_flags(path):
    flags = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            flags.update(a.value for a in node.args
                         if isinstance(a, ast.Constant)
                         and str(a.value).startswith("-"))
    return flags


@pytest.mark.parametrize("name", sorted(
    p.name for p in (SRC / "repro" / "launch").glob("*.py")))
def test_every_reference_cli_flag_has_a_twin(name):
    """Each `add_argument` flag of a reference launcher has a twin in the
    port's launcher of the same role, or stands in FLAG_DEPARTURES."""
    twin = PORT / "launch" / RENAMED_TWINS.get(f"launch/{name}",
                                               f"launch/{name}")[7:]
    missing = (_cli_flags(SRC / "repro" / "launch" / name)
               - _cli_flags(twin) - FLAG_DEPARTURES.get(name, set()))
    assert not missing, f"{name}: {sorted(missing)}"


def _init_params(path, cls):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for item in node.body:
                if (isinstance(item, ast.FunctionDef)
                        and item.name == "__init__"):
                    a = item.args
                    return {x.arg for x in a.posonlyargs + a.args
                            + a.kwonlyargs} - {"self"}
    raise AssertionError(f"no {cls}.__init__ in {path}")


def test_engine_takes_every_reference_parameter():
    rel = "serving/engine.py"
    ref = _init_params(SRC / "repro" / rel, "Engine")
    port = _init_params(PORT / rel, "Engine")
    assert "ctx" in ref and "freeze_plans" in ref
    assert not ref - port, sorted(ref - port)
