"""Gloo ranks on the CPU for the port's distribution-layer tests, and the
reference's multi-device side in a process of its own.

:func:`run_ranks` spawns ``world`` processes (``torch.multiprocessing``,
the worker a function of this module, as spawn pickles it by name), each
initialising a gloo world through ``distributed.compat.init_distributed``
with a ``file://`` rendezvous in the test's own directory (no fixed port:
several test workers run at once) and torch on one thread.  Each rank
runs ``JOBS[job](*args)`` (the jobs below) and saves what it returns; a
failing rank fails the call (the others are stopped), and a rank that has
not ended by ``timeout`` seconds stops them all and fails it, so no test
hangs.  The
jobs import no JAX.

:func:`start_reference` runs ``tests/_torch_dist_ref.py`` (the reference
on 8 fake CPU devices: ``XLA_FLAGS=--xla_force_host_platform_device_count
=8``, fixed when JAX initialises, which a test worker may already have
done with one) and loads the ``.npz`` it writes.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def _env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(SRC)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        **extra)


def start_reference(job, out, *args):
    """Start ``job`` of tests/_torch_dist_ref.py in the background; returns
    a function that waits for it and returns its arrays."""
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist_ref.py"), job, str(out),
         *map(str, args)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait(timeout=600):
        _, err = proc.communicate(timeout=timeout)
        if proc.returncode:
            raise RuntimeError(f"reference {job} failed:\n{err[-4000:]}")
        with np.load(out) as z:
            return {k: z[k] for k in z.files}

    return wait


def _worker(rank, world, init, job, out, args):
    torch.set_num_threads(1)
    from repro_torch.distributed import compat

    compat.init_distributed(device="cpu", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    try:
        result = JOBS[job](*args)
        torch.save(result, Path(out) / f"rank{rank}.pt")
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def run_ranks(job, world, tmp, *args, timeout=300):
    """Each rank's result of ``JOBS[job](*args)``, in rank order."""
    tmp = Path(tmp)
    out = tmp / f"{job}_{world}_out"
    out.mkdir(parents=True, exist_ok=True)
    init = tmp / f"{job}_{world}_{time.monotonic_ns()}.init"
    ctx = mp.spawn(_worker, args=(world, str(init), job, str(out), args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job}: ranks still running after "
                               f"{timeout} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def shard_slices(spec, coords, mesh_shape, shape):
    """The index (a tuple of slices) of the shard that the rank at
    ``coords`` of a mesh of ``mesh_shape`` (axis -> size) holds of a
    tensor of ``shape`` under ``spec``: the rules' placement, computed
    here without a mesh."""
    out = []
    for dim, axes in enumerate(tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        if not axes:
            out.append(slice(None))
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        n, i = 1, 0
        for a in axes:
            n *= mesh_shape[a]
            i = i * mesh_shape[a] + coords[a]
        size = shape[dim] // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def mesh_shape_of(ranks):
    """Axis -> size of the mesh the ranks' ``coords`` span."""
    return {a: 1 + max(r["coords"][a] for r in ranks)
            for a in ranks[0]["coords"]}


def assemble(ranks, key, shapes):
    """``{name: whole array}`` from every rank's shards ``ranks[i][key]``,
    each placed at its slice; raises where ranks that hold the same slice
    differ in any bit, or a slice is held by no rank."""
    mesh_shape = mesh_shape_of(ranks)
    out = {}
    for name, shape in shapes.items():
        whole = np.zeros(shape, ranks[0][key][name].dtype)
        seen = np.zeros(shape, bool)
        held = {}
        for r in ranks:
            at = shard_slices(r["specs"][name], r["coords"], mesh_shape,
                              shape)
            local = r[key][name]
            first = held.setdefault(str(at), local)
            if first.tobytes() != local.tobytes():
                raise AssertionError(f"{key} {name}: replicas of {at} "
                                     "differ")
            whole[at] = local
            seen[at] = True
        if not seen.all():
            raise AssertionError(f"{key} {name}: no rank holds all of it")
        out[name] = whole
    return out


# ---------------------------------------------------------------------------
# the jobs (torch and the port only)
# ---------------------------------------------------------------------------

JOBS = {}
# the train-step tests' optimizer (tests/_torch_train.py::OPT)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def _np(named):
    return {n: t.detach().numpy().copy() for n, t in named.items()}


@job
def collectives():
    """Each collective of ``compat`` on a live (2, 2) mesh."""
    from repro_torch.distributed import compat
    from repro_torch.launch.mesh import make_mesh_compat

    mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    r = torch.distributed.get_rank()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    out = dict(coords=mesh.coords, index={
        axes: (mesh.index(axes), compat.axis_index(mesh.group(axes)))
        for axes in ("data", "model", ("data", "model"))})
    for axes in ("data", "model", ("data", "model")):
        g = mesh.group(axes)
        out[f"psum {axes}"] = compat.psum(x, g).numpy()
        out[f"pmax {axes}"] = compat.pmax(x, g).numpy()
        out[f"gather0 {axes}"] = compat.all_gather(x, g, dim=0).numpy()
        out[f"gather1 {axes}"] = compat.all_gather(x, g, dim=1).numpy()
        n = mesh.axis_size(axes)
        out[f"ring {axes}"] = compat.ppermute(
            x, g, [(i, (i + 1) % n) for i in range(n)]).numpy()
        out[f"half {axes}"] = compat.ppermute(x, g, [(0, n - 1)]).numpy()
    out["input"] = x.numpy()
    out["stats"] = compat.STATS.as_dict()
    return out


@job
def sp(ref_npz):
    """The port's ``make_sp_decode`` on a 4-rank ``model`` mesh, on the
    reference run's inputs."""
    from repro_torch.distributed import make_sp_decode
    from repro_torch.launch.mesh import make_mesh_compat

    mesh = make_mesh_compat((4,), ("model",), device="cpu")
    with np.load(ref_npz) as z:
        q, k, v, valid = (torch.from_numpy(z[n]) for n in
                          ("q", "k", "v", "valid"))
    return make_sp_decode(mesh)(q, k, v, valid).numpy()


@job
def pp(ref_npz):
    """The port's ``pipeline_apply`` on a 4-rank ``pod`` mesh: each rank
    passes its own stage's weight."""
    from repro_torch.distributed import pipeline_apply
    from repro_torch.launch.mesh import make_mesh_compat

    mesh = make_mesh_compat((4,), ("pod",), device="cpu")
    with np.load(ref_npz) as z:
        ws, x = torch.from_numpy(z["ws"]), torch.from_numpy(z["x"])
    piped = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws.shape[0],
                           x.shape[0], mesh, axis="pod")
    return piped(ws[mesh.coords["pod"]], x).numpy()


def restored(arch, ckpt_dir):
    """Reduced ``arch``'s parameters (a ``Decoder``, or whisper's
    ``EncDec``) from a checkpoint of them."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import Decoder

    cfg = reduced(get_config(arch))
    module = (EncDec if cfg.encoder_decoder else Decoder)(cfg, device="cpu")
    restore_checkpoint(ckpt_dir, module)
    return cfg, module


def mesh_name(shape):
    return "x".join(map(str, shape))


@job
def train(arch, ckpt_dir, ref_npz, shapes, compress=False):
    """One sharded step (with the int8 compression where ``compress``) on
    each live (data, model) mesh of ``shapes`` in turn, from the
    reference's weights and batch, keyed by the mesh's name (``2x4``):
    the gradients, the step's metrics, this rank's shards of the
    parameters and moments, and what the model axis split: the working
    module's shapes and each leaf's ``compute_split``, the logits' shape
    and the expert count of each ``torch.bmm`` of the loss.  The
    gradients of ``sharded_loss_and_grads`` are this rank's model
    shards: they are gathered whole over "model" here."""
    from repro_torch.checkpoint import reshard
    from repro_torch.distributed import param_shardings, tp
    from repro_torch.distributed.sharding import (compute_split, only_model,
                                                  unshard)
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train import optim as PO
    from repro_torch.train.step import (gather_working, make_train_step,
                                        sharded_loss_and_grads,
                                        working_module)

    cfg, module = restored(arch, ckpt_dir)
    with np.load(ref_npz) as z:
        batch = {k.split("/")[1]: torch.from_numpy(z[k]) for k in z.files
                 if k.startswith("batch/")}
    out = {}
    for shape in shapes:
        mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
        specs = param_shardings(module, mesh, cfg.n_experts)
        params = reshard(module, specs, mesh)
        opt = PO.init_opt(params)
        model, step = make_train_step(cfg, PO.AdamWConfig(**OPT),
                                      compress_grads=compress, device="cpu",
                                      mesh=mesh)
        work = working_module(cfg, params, "cpu")
        gather_working(params, work)
        experts = []
        bmm = torch.bmm

        def counted(a, b):
            experts.append(a.shape[0])
            return bmm(a, b)

        torch.bmm = counted
        try:
            loss, ce, grads = sharded_loss_and_grads(model, params, work,
                                                     batch, cfg)
        finally:
            torch.bmm = bmm
        grads = {n: unshard(g, only_model(specs[n]), mesh)
                 for n, g in grads.items()}
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        with torch.no_grad(), tp.split_model(tp.ModelAxis.of(mesh)):
            logits = model.apply(work, **inputs)[0]
        params, opt, m = step(params, opt, batch)
        out[mesh_name(shape)] = dict(
            coords=mesh.coords, specs=specs, grads=_np(grads),
            grad_loss=float(loss), grad_ce=float(ce),
            metrics={k: float(v) for k, v in m.items()},
            params=_np(params), mu=_np(opt.mu), nu=_np(opt.nu),
            step=int(opt.step),
            split=compute_split(specs, cfg, mesh),
            work={n: tuple(p.shape) for n, p in work.named_parameters()},
            logits=tuple(logits.shape), experts=experts)
    return out


@job
def one_rank_mesh(arch, ckpt_dir, steps, compress=False):
    """``steps`` steps of the plain ``make_train_step`` and of the sharded
    one on a (1, 1) mesh (with the int8 compression where ``compress``),
    from the same weights and the port's ``TokenPipeline`` batches: both
    states after them."""
    import copy

    from repro_torch.checkpoint import reshard
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import param_shardings
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train import optim as PO
    from repro_torch.train.step import make_train_step

    cfg, module = restored(arch, ckpt_dir)
    plain = copy.deepcopy(module)
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    opt_cfg = PO.AdamWConfig(**OPT)
    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=4, seq_len=32, seed=0)
    out = {}
    for name, mesh_ in (("plain", None), ("mesh", mesh)):
        params = plain if mesh_ is None else reshard(
            module, param_shardings(module, mesh, cfg.n_experts), mesh)
        opt = PO.init_opt(params)
        _, step = make_train_step(cfg, opt_cfg, compress_grads=compress,
                                  device="cpu", mesh=mesh_)
        metrics = []
        for i in range(steps):
            params, opt, m = step(params, opt, pipe.batch_at(i))
            metrics.append({k: float(v) for k, v in m.items()})
        named = dict(params.named_parameters()) if mesh_ is None else params
        out[name] = dict(params=_np(named), mu=_np(opt.mu), nu=_np(opt.nu),
                         step=int(opt.step), metrics=metrics)
    return out


@job
def reshard_onto(ckpt_dir, shapes, save_dir):
    """Reduced gemma3 restored from ``ckpt_dir`` and resharded onto each
    (data, model) mesh of ``shapes`` in turn: this rank's shards, and the
    state gathered whole; the last placement, with moments made from the
    weights, saved sharded to ``save_dir``."""
    from repro_torch.checkpoint import reshard, save_checkpoint
    from repro_torch.distributed import param_shardings
    from repro_torch.launch.mesh import make_mesh_compat

    cfg, module = restored("gemma3-1b", ckpt_dir)
    out = []
    for shape in shapes:
        mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
        specs = param_shardings(module, mesh, cfg.n_experts)
        placed = reshard(module, specs, mesh)
        out.append(dict(shape=shape, coords=mesh.coords, specs=specs,
                        local=_np(placed),
                        whole=_np({n: placed.whole(n) for n in placed})))
    state = reshard((module, moments(dict(module.named_parameters()))),
                    specs, mesh)
    save_checkpoint(save_dir, 3, state, extra={"mesh": list(shapes[-1])})
    return out


def moments(named):
    """An ``OptState`` made from the weights (``mu = w / 2``, ``nu =
    w * w``, step 3): a state with every tensor distinct."""
    from repro_torch.train.optim import OptState

    with torch.no_grad():
        return OptState(mu={n: t.detach() / 2 for n, t in named.items()},
                        nu={n: t.detach() * t.detach()
                            for n, t in named.items()},
                        step=torch.tensor(3, dtype=torch.int32))
