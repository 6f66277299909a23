"""Multi-pod dry-run: one rank of each (arch x shape x mesh) cell's sharded
step, counted without the devices — the port of ``repro.launch.dryrun``.

The reference lowers and compiles every cell on 256 or 512 fake CPU
devices and reads XLA's memory and cost analyses and the collectives of
the partitioned HLO.  Torch has no lowering, so the port runs **one rank**
(rank 0) of the real sharded step of the cell (``make_train_step`` /
``make_prefill_step`` / ``make_serve_step(..., mesh=)``), in one
process, on nothing:

* a world of 256 or 512 ranks on torch's ``"fake"`` backend
  (``FakeStore``, from ``torch.testing._internal.distributed.fake_pg``):
  every collective returns at once and moves nothing; the world is
  destroyed when the cell ends, also when it fails (:func:`fake_world`);
* the mesh of ``launch.mesh.make_mesh_compat`` over it, on ``device``
  (``"cuda"`` by default; the tests pass ``"cpu"``);
* the parameters (placed by ``checkpoint.reshard``), the optimizer state,
  the batch and the decode cache under ``FakeTensorMode``: shapes and
  dtypes, no storage, at this rank's local shapes;
* ``FlopCounterMode`` for the FLOPs, ``distributed.compat.STATS`` (and
  ``APART``) for the collectives, and
  ``torch.distributed._tools.mem_tracker.MemTracker`` for the peak bytes.

Each record (``experiments/torch_dryrun/<arch>__<shape>__<mesh>.json``,
or under the directory a caller passes) holds the reference's keys where
they translate: ``arch``, ``shape``, ``kind``, ``mesh``, ``n_devices``,
``trace_s`` (the wall seconds of building and running the rank's step,
in place of ``lower_s`` / ``compile_s``), ``memory`` (this rank's
``argument_bytes``: parameter, optimizer, batch and cache; the step's
``output_bytes`` that are no argument; ``temp_bytes``, the peak over the
arguments, the gathered weights of the step included; ``peak_bytes`` and
``MemTracker``'s ``peak_by_kind`` at it, on the step's device, the
arguments counted as "Other"; ``code_bytes`` and ``alias_bytes`` None),
``cost.flops`` (this rank's, forward, backward,
recomputation and optimizer), ``collectives`` (one step's ``bytes`` and
``counts`` under the reference's kinds, ``by_axes`` by the mesh axes of
each group, ``ops`` as ``compat.STATS`` names them; ``working_gather``
apart: the train step's gathers of weights, layer by layer and again
where a block is recomputed, in its counts, or the serving steps' fill
of their working module, once, not in their step's counts; ``recompute``
apart: the calls the recomputed blocks issue again; ``gathered``:
``compat.GATHERED``, the train step's gathered leaves, their bytes and
the most bytes of them alive at once),
``model_flops_global``, ``remat_policy`` and ``differs_from_reference``,
which names where the port partitions otherwise than the reference's
GSPMD program (ROADMAP.md, queue 1).  A collective's bytes are this
rank's input, as ``compat`` counts them (an all-gather's output is the
group's size times that); the reference counts each op's result.

Not reproduced: the HLO line count, XLA's temp and code bytes and
``bytes_accessed``.  The reference's probes (``probe_layer_pair``,
``run_probe``) extrapolate from two unrolled depths because XLA counts a
scan body once; the port's layers are an eager loop, counted every one,
so a full-depth cell is its own total and there is no probe.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..configs import SHAPES, ARCH_IDS, get_config, shape_applicable
from ..configs.base import ModelConfig, ShapeSpec
from ..distributed import compat
from ..distributed.sharding import (axis_size, batch_shardings, dp_axes,
                                    map_cache, mixer_heads, param_shardings)
from ..models import decode_input_specs, input_specs, model_flops
from ..models.encdec import EncDec
from ..models.transformer import Decoder
from ..train.optim import init_opt
from ..train.step import (_main_input, make_prefill_step, make_serve_step,
                          make_train_step)
from .mesh import MULTIPOD_SHAPE, POD_SHAPE, make_mesh_compat

__all__ = ["lower_cell", "run_cell", "cell_path", "all_cells",
           "collective_bytes", "build_cell", "step_counts", "fake_world",
           "main", "OUT_DIR"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch_dryrun"

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
# compat's op names -> the reference's HLO kinds
_KIND_OF = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter",
            "ppermute": "collective-permute"}


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks on the ``"fake"`` backend,
    this process rank 0, destroyed (with every group made on it) when the
    block ends.  Refuses to replace a group that is already live."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run makes a world of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_of(multi_pod: bool, mesh_shape: Optional[Sequence[int]]):
    """``(shape, axes)``: ``mesh_shape``, else the production mesh's, its
    axes the last of ("pod", "data", "model")."""
    shape = tuple(mesh_shape) if mesh_shape is not None else (
        MULTIPOD_SHAPE if multi_pod else POD_SHAPE)
    if not 2 <= len(shape) <= 3:
        raise ValueError(f"no axis names for a mesh of {shape}")
    return shape, ("pod", "data", "model")[-len(shape):]


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(map(str, shape))


def _counts(stats: Dict[str, dict]) -> Dict[str, dict]:
    """``{op: {"calls", "bytes"}}`` of ``compat.STATS``-like counts (the
    host seconds dropped: a fake collective takes none)."""
    return {op: {"calls": int(v["calls"]), "bytes": int(v["bytes"])}
            for op, v in sorted(stats.items())}


def _minus(a: Dict[str, dict], b: Dict[str, dict]) -> Dict[str, dict]:
    out = {}
    for op, v in a.items():
        w = b.get(op, {"calls": 0, "bytes": 0})
        c = {"calls": v["calls"] - w["calls"], "bytes": v["bytes"] - w["bytes"]}
        if c["calls"]:
            out[op] = c
    return out


def collective_bytes(ops: Dict[str, dict]) -> dict:
    """The reference's ``collective_bytes`` record (``bytes`` and ``counts``
    by HLO kind, ``total_bytes``) from compat's per-op counts (``ops``,
    :func:`_counts`; a ``"<axis>:<op>"`` name counts under its op)."""
    out = {k: 0 for k in _KINDS}
    counts = {k: 0 for k in _KINDS}
    for op, v in ops.items():
        kind = _KIND_OF[op.rpartition(":")[2]]
        out[kind] += v["bytes"]
        counts[kind] += v["calls"]
    return {"bytes": out, "counts": counts,
            "total_bytes": int(sum(out.values()))}


def _by_axes(stats: compat.CollectiveStats) -> Dict[str, dict]:
    return {f"{k.rpartition(':')[0]}:{_KIND_OF[k.rpartition(':')[2]]}": v
            for k, v in sorted(stats.by_axes().items())}


def _tensors(tree):
    out = []
    map_cache(lambda t: out.append(t), tree)
    return out


def _storage_bytes(tensors) -> int:
    """The bytes of the storages of ``tensors``, each storage once."""
    seen, total = set(), 0
    for t in tensors:
        s = t.untyped_storage()
        if s._cdata not in seen:
            seen.add(s._cdata)
            total += s.nbytes()
    return total


def _zeros_like_spec(specs: Dict[str, torch.Tensor], device):
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}


def differs_from_reference(cfg: ModelConfig, shape: ShapeSpec, kind: str,
                           mesh) -> list:
    """Where this cell's step partitions otherwise than the reference's
    GSPMD program (ROADMAP.md, queue 1)."""
    out = []
    dp = dp_axes(mesh)
    if kind != "train" and mesh.axis_size(dp) > 1:
        out.append("weights gathered whole over the data axes once and held "
                   "across calls (the serving step's working module), not "
                   "layer by layer")
    tp, heads = axis_size(mesh, "model"), mixer_heads(cfg)
    if tp > 1 and heads and heads % tp:
        out.append(f"Mamba2 / xLSTM mixers gathered and computed whole on "
                   f"every model rank: their {heads} heads do not divide "
                   f"the model axis's {tp} ranks")
    elif tp > 1 and heads and kind == "decode":
        out.append("Mamba2 / xLSTM mixers computed whole on every model "
                   "rank in the decode: their states are stored on N / K / "
                   "channels, not by head, and gathered over the model "
                   "axis each step")
    if kind != "decode" and mesh.axis_size(dp) > 1:
        specs = batch_shardings(input_specs(cfg, shape), mesh)
        if specs[_main_input(specs)][:1] != (dp,):
            out.append("batch does not split over the data axes: the rules "
                       "shard the sequence, each data rank computes the "
                       "whole batch")
    if cfg.n_experts and mesh.axis_size(dp) > 1:
        out.append("each data rank's MoE expert buffer is sized by the whole "
                   "batch")
    return out


def build_cell(cfg: ModelConfig, shape: ShapeSpec, kind: str, mesh,
               device, seed: Optional[int] = None,
               cache_dtype=torch.bfloat16):
    """``(args, run)``: this rank's arguments of the cell's step on the live
    ``mesh`` (its parameters placed by ``checkpoint.reshard``, the
    optimizer's moments, the zero batch and the fresh decode cache, as a
    list of tensors) and ``run()``, one call of the step.  Under a
    ``FakeTensorMode`` (:func:`lower_cell`) nothing is stored; with a
    ``seed`` the weights are drawn from it (real ranks of the same cell).
    The decode cache is ``cache_dtype`` (bf16, as the reference's
    dry-run makes it)."""
    from ..checkpoint import reshard

    whole = (EncDec if cfg.encoder_decoder else Decoder)(cfg, device=device)
    if seed is not None:
        whole.init_(torch.Generator(device=device).manual_seed(seed))
    specs = param_shardings(whole, mesh, cfg.n_experts)
    params = reshard(whole, specs, mesh)
    del whole
    args = list(params.values())
    if kind == "train":
        opt = init_opt(params)
        args += list(opt.mu.values()) + list(opt.nu.values())
        batch = _zeros_like_spec(input_specs(cfg, shape), device)
        _, step = make_train_step(cfg, device=device, mesh=mesh)
        run = lambda: step(params, opt, batch)  # noqa: E731
    elif kind == "prefill":
        batch = _zeros_like_spec(input_specs(cfg, shape), device)
        batch.pop("labels", None)
        _, step = make_prefill_step(cfg, device=device, mesh=mesh)
        run = lambda: step(params, batch)  # noqa: E731
    elif kind == "decode":
        model, step = make_serve_step(cfg, device=device, mesh=mesh)
        kw = {"mem_len": shape.seq_len} if cfg.encoder_decoder else {}
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 dtype=cache_dtype, mesh=mesh, **kw)
        args += _tensors(cache.local)
        batch = _zeros_like_spec(decode_input_specs(cfg, shape), device)
        run = lambda: step(params, cache, batch)  # noqa: E731
    else:
        raise ValueError(kind)
    return args + list(batch.values()), run


def step_counts(kind: str) -> dict:
    """``compat``'s counts of one call of a cell's step, as the record
    keeps them: ``ops`` and ``by_axes`` of the step (for the serving
    steps without the working module's one-time gather), the gathers and
    the recomputed calls apart, and ``compat.GATHERED`` (module
    docstring)."""
    none = compat.CollectiveStats()
    gather = compat.APART.get("working_gather", none)
    recompute = compat.APART.get("recompute", none)
    ops, axes = _counts(compat.STATS.as_dict()), _by_axes(compat.STATS)
    if kind != "train":
        ops = _minus(ops, _counts(gather.as_dict()))
        axes = _minus(axes, _by_axes(gather))
    return {**collective_bytes(ops), "ops": ops, "by_axes": axes,
            "working_gather": {**collective_bytes(_counts(gather.as_dict())),
                               "ops": _counts(gather.as_dict()),
                               "in_step": kind == "train"},
            "recompute": {**collective_bytes(_counts(recompute.as_dict())),
                          "ops": _counts(recompute.as_dict())},
            "gathered": {k: v for k, v in compat.GATHERED.as_dict().items()
                         if k != "alive"}}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               step_kind: Optional[str] = None, *, device="cuda",
               cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeSpec] = None,
               mesh_shape: Optional[Sequence[int]] = None,
               cache_dtype=torch.bfloat16) -> dict:
    """One rank of the cell's step on a fake world; returns the record
    (module docstring).  ``cfg`` (a reduced or changed config of
    ``arch``), ``shape`` (a smaller ShapeSpec than ``SHAPES[shape_name]``),
    ``mesh_shape`` (another mesh than the production one, its last axes
    named ("pod",) "data", "model") and ``cache_dtype`` (the decode
    cache's) are for tests and comparisons with live ranks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    kind = step_kind or shape.kind
    mshape, axes = _mesh_of(multi_pod, mesh_shape)
    n = math.prod(mshape)
    rec = {"arch": arch, "shape": shape_name, "kind": kind,
           "mesh": mesh_name(mshape), "n_devices": n,
           "remat_policy": cfg.remat_policy}
    t0 = time.time()
    with fake_world(n), FakeTensorMode(allow_non_fake_inputs=True):
        mesh = make_mesh_compat(mshape, axes, device=device)
        args, run = build_cell(cfg, shape, kind, mesh, device,
                               cache_dtype=cache_dtype)
        arg_bytes = _storage_bytes(args)
        compat.reset_stats()
        tracker = MemTracker()
        tracker.track_external(*args)
        flops = FlopCounterMode(display=False)
        try:
            with tracker, flops:
                out = run()
            rec["collectives"] = step_counts(kind)
        finally:
            compat.reset_stats()
        # the step's device only: the modules the sharded steps fill are
        # built on the meta device, which holds no memory
        peaks = [v for d, v in tracker.get_tracker_snapshot("peak").items()
                 if d.type == torch.device(device).type]
        peak = sum(v["Total"] for v in peaks)
        by_kind = {}
        for v in peaks:
            for k, b in v.items():
                if k != "Total":
                    by_kind[k.value] = by_kind.get(k.value, 0) + int(b)
        arg_ids = {t.untyped_storage()._cdata for t in args}
        out_bytes = _storage_bytes([t for t in _tensors(out)
                                    if t.untyped_storage()._cdata
                                    not in arg_ids])
        rec["differs_from_reference"] = differs_from_reference(
            cfg, shape, kind, mesh)
    rec["trace_s"] = round(time.time() - t0, 2)
    rec["memory"] = {"argument_bytes": int(arg_bytes),
                     "output_bytes": int(out_bytes),
                     "temp_bytes": int(peak - arg_bytes),
                     "peak_bytes": int(peak), "peak_by_kind": by_kind,
                     "alias_bytes": None, "code_bytes": None}
    rec["cost"] = {"flops": float(flops.get_total_flops())}
    rec["model_flops_global"] = model_flops(cfg, shape)
    return rec


def _prod_mesh_name(multi_pod: bool) -> str:
    return mesh_name(MULTIPOD_SHAPE if multi_pod else POD_SHAPE)


def cell_path(arch: str, shape_name: str, multi_pod: bool,
              out_dir: Optional[Path] = None) -> Path:
    return Path(out_dir or OUT_DIR) / (
        f"{arch}__{shape_name}__{_prod_mesh_name(multi_pod)}.json")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, out_dir: Optional[Path] = None,
             device="cuda") -> dict:
    """The cell's record, from its file where an earlier run wrote one
    that is ``ok`` (unless ``force``), else from :func:`lower_cell`;
    written to :func:`cell_path`.  A failing cell is recorded as
    ``status: error`` with its error."""
    path = cell_path(arch, shape_name, multi_pod, out_dir)
    if path.exists() and not force:
        prev = json.loads(path.read_text())
        if prev.get("status") == "ok":
            print(f"[skip] {path.name} (ok)")
            return prev
    mesh = _prod_mesh_name(multi_pod)
    print(f"[dryrun] {arch} x {shape_name} x {mesh} ...", flush=True)
    try:
        rec = lower_cell(arch, shape_name, multi_pod, device=device)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — failures are data here
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}"}
        print(f"  ERROR: {rec['error']}", flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    if rec["status"] == "ok":
        print(f"  ok: trace={rec['trace_s']}s "
              f"flops/dev={rec['cost']['flops']:.3g} "
              f"coll={rec['collectives']['total_bytes']:.3g}B "
              f"peak={rec['memory']['peak_bytes'] / 1e9:.3g}GB", flush=True)
    return rec


def all_cells():
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            if not shape_applicable(arch, shape_name):
                continue
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu needs no card)")
    ap.add_argument("--out-dir", type=Path, default=None)
    args = ap.parse_args(argv)

    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]
    if args.all:
        cells = list(all_cells())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    for arch, shape_name in cells:
        for mp in meshes:
            run_cell(arch, shape_name, mp, force=args.force,
                     out_dir=args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
