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

import contextlib
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


@contextlib.contextmanager
def recording_gathers(seen):
    """``seen[name]`` = the shape of the tensor each leaf is gathered to
    (or used as, where nothing gathers it) by the sharded train step's
    per-layer gather (``distributed.fsdp``) inside the block."""
    from repro_torch.distributed import fsdp

    inner = fsdp.LayerGather._gather

    def record(self, name, p):
        out = inner(self, name, p)
        seen[name] = tuple(out.shape)
        return out

    fsdp.LayerGather._gather = record
    try:
        yield seen
    finally:
        fsdp.LayerGather._gather = inner


@contextlib.contextmanager
def recording_heads(seen):
    """``seen[mixer]``: the head counts each Mamba2 ``ssd_chunked``, mLSTM
    ``_per_head_scan`` and sLSTM step (``"mamba"``, ``"mlstm"``,
    ``"slstm"``) ran on inside the block, and ``seen["mlstm v"]`` the v
    channels a head of each mLSTM scan (its inputs but the normaliser's
    ones channel)."""
    from repro_torch.models import ssm, xlstm

    def spy(module, name, mixer, heads):
        inner = getattr(module, name)

        def record(*args):
            for key, n in heads(*args).items():
                seen.setdefault(key, set()).add(n)
            return inner(*args)

        return module, name, inner, record

    spies = [spy(ssm, "ssd_chunked", "mamba",
                 lambda x, *_: {"mamba": x.shape[2]}),
             spy(xlstm, "_per_head_scan", "mlstm",
                 lambda xs, log_f, *_: {"mlstm": log_f.shape[2],
                                        "mlstm v": xs.shape[3] - 1}),
             spy(xlstm, "_slstm_step", "slstm",
                 lambda r, *_: {"slstm": r.shape[0]})]
    for module, name, _, record in spies:
        setattr(module, name, record)
    try:
        yield seen
    finally:
        for module, name, inner, _ in spies:
            setattr(module, name, inner)


@job
def train(arch, ckpt_dir, ref_npz, shapes, compress=False):
    """One sharded step (with the int8 compression where ``compress``) on
    each live (data, model) mesh of ``shapes`` in turn, from the
    reference's weights and batch, keyed by the mesh's name (``2x4``):
    the gradients, the step's metrics, this rank's shards of the
    parameters and moments, and what the model axis split: the shapes
    the per-layer gather gave each leaf and each leaf's
    ``compute_split``, the logits' shape, the expert count of each
    ``torch.bmm`` of the loss and the head counts the mixers ran on
    (:func:`recording_heads`).  The gradients of
    ``sharded_loss_and_grads`` are this rank's shards of the parameters'
    specs: they are gathered whole here."""
    from repro_torch.checkpoint import reshard
    from repro_torch.distributed import compat, fsdp, param_shardings, tp
    from repro_torch.distributed.sharding import compute_split, unshard
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import module_of
    from repro_torch.train import optim as PO
    from repro_torch.train.step import make_train_step, sharded_loss_and_grads

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
        experts, work, heads = [], {}, {}
        bmm = torch.bmm

        def counted(a, b):
            experts.append(a.shape[0])
            return bmm(a, b)

        torch.bmm = counted
        compat.reset_stats()
        try:
            with recording_gathers(work), recording_heads(heads):
                loss, ce, grads = sharded_loss_and_grads(model, params,
                                                         batch, cfg)
        finally:
            torch.bmm = bmm
        gathered = compat.GATHERED.as_dict()
        local = {n: tuple(g.shape) for n, g in grads.items()}
        grads = {n: unshard(g, specs[n], mesh) for n, g in grads.items()}
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        plan = fsdp.LayerGather(
            module_of(cfg, lambda n: params[n].detach()), params, False)
        with torch.no_grad(), tp.split_model(tp.ModelAxis.of(mesh)), \
                fsdp.gathering(plan):
            logits = model.apply(plan.module, **inputs)[0]
        params, opt, m = step(params, opt, batch)
        out[mesh_name(shape)] = dict(
            coords=mesh.coords, specs=specs, grads=_np(grads),
            grad_shapes=local,
            grad_loss=float(loss), grad_ce=float(ce),
            metrics={k: float(v) for k, v in m.items()},
            params=_np(params), mu=_np(opt.mu), nu=_np(opt.nu),
            step=int(opt.step),
            split=compute_split(specs, cfg, mesh), work=work,
            gathered=gathered, logits=tuple(logits.shape), experts=experts,
            heads={k: sorted(v) for k, v in heads.items()})
    return out


@job
def layer_gather(archs, root, shapes, bound_layers):
    """:func:`train` of each reduced config of ``archs`` (the reference's
    weights and batch under ``root/<arch>``, ``root/<arch>.npz``) on
    each mesh of ``shapes``, keyed by the arch, and under ``"bound"``
    :func:`gather_bound` on the same meshes."""
    out = {arch: train(arch, f"{root}/{arch}", f"{root}/{arch}.npz", shapes)
           for arch in archs}
    out["bound"] = gather_bound(shapes, bound_layers)
    return out


def gather_bound(shapes, n_layers, B=4, S=32):
    """Reduced qwen2-72b cut to ``n_layers`` blocks, weights from seed 0,
    numpy-seeded tokens: on each live (data, model) mesh of ``shapes``
    and under ``remat_policy`` "full" and "dots", one
    ``sharded_loss_and_grads``: ``compat.GATHERED`` over it and after it,
    and the bytes each leaf is gathered to (the leaves that some axis
    gathers), keyed ``<mesh>/<policy>``."""
    import dataclasses

    from repro_torch.checkpoint import reshard
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import compat, param_shardings
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build
    from repro_torch.train.step import sharded_loss_and_grads

    cfg = dataclasses.replace(reduced(get_config("qwen2-72b")),
                              n_layers=n_layers)
    module = build(cfg, device="cpu").init(0)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    out = {}
    for shape in shapes:
        mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
        params = reshard(module, param_shardings(module, mesh,
                                                 cfg.n_experts), mesh)
        for policy in ("full", "dots"):
            c = dataclasses.replace(cfg, remat_policy=policy)
            work = {}
            compat.reset_stats()
            with recording_gathers(work):
                _, _, grads = sharded_loss_and_grads(build(c, device="cpu"),
                                                     params, batch, c)
            during = compat.GATHERED.as_dict()
            del grads
            out[f"{mesh_name(shape)}/{policy}"] = dict(
                gathered=during, after=compat.GATHERED.as_dict(),
                sizes={n: int(np.prod(s)) * params[n].element_size()
                       for n, s in work.items()
                       if s != tuple(params[n].shape)})
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


# ---------------------------------------------------------------------------
# the serving steps on a mesh (tests/test_torch_dist_serve_*.py)
# ---------------------------------------------------------------------------

def cache_leaves(node, keys=(), at=(), top=True):
    """``(key, at, leaf)`` for every leaf of a port cache (or of its spec
    tree): ``key`` the reference's path to the leaf it sits in (the keys
    joined by ``/``: the reference stacks every list of the port's but the
    top one, the segments), ``at`` its index on those stacked axes."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            yield from cache_leaves(getattr(node, f), keys + (f,), at, False)
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from cache_leaves(v, keys + (k,), at, False)
    elif isinstance(node, list):
        for i, c in enumerate(node):
            yield from (cache_leaves(c, keys + (str(i),), at, False) if top
                        else cache_leaves(c, keys, at + (i,), False))
    else:
        yield "/".join(keys), at, node


def cache_from(template, arrays, keys=(), at=(), top=True):
    """The port cache of ``template``'s structure whose leaves are the
    reference's ``arrays`` (``{path: array}``) at their stacked index."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(cache_from(getattr(template, f), arrays,
                                           keys + (f,), at, False)
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: cache_from(v, arrays, keys + (k,), at, False)
                for k, v in template.items()}
    if isinstance(template, list):
        return [cache_from(c, arrays, keys + (str(i),), at, False) if top
                else cache_from(c, arrays, keys, at + (i,), False)
                for i, c in enumerate(template)]
    leaf = arrays["/".join(keys)][at]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(leaf, dtype=np.float32))
    return int(leaf)


def serve_inputs(cfg, z):
    """``(batch, feed, cache0)``: the reference's prompt batch (no labels),
    feed and first cache (``tests/_torch_dist_ref.py::serve``) from its
    arrays ``z`` of one config, as the port's (the cache whole, in the
    port's structure)."""
    from repro_torch.models import build

    batch = {k[6:]: torch.from_numpy(v) for k, v in z.items()
             if k.startswith("batch/") and k != "batch/labels"}
    feed = {}
    for k, v in z.items():
        if k.startswith("feed/"):
            _, key, i = k.split("/")
            feed.setdefault(int(i), {})[key] = torch.from_numpy(v)
    B, T = batch[next(iter(batch))].shape[:2]
    kw = {"mem_len": T} if cfg.encoder_decoder else {}
    template = build(cfg, device="cpu").init_cache(
        B, int(z["max_len"]), torch.float32, **kw)
    cache0 = cache_from(template, {k[7:]: v for k, v in z.items()
                                   if k.startswith("cache0/")})
    return batch, [feed[i] for i in sorted(feed)], cache0


def arch_view(ref, arch):
    """The reference's arrays of ``arch`` under their plain keys."""
    return {k[len(arch) + 1:]: v for k, v in ref.items()
            if k.startswith(arch + "/")}


def flat_cache(cache):
    """``[(key, at, array or int, spec)]`` of a ``ShardedCache``'s leaves."""
    return [(key, at, t.numpy().copy() if isinstance(t, torch.Tensor)
             else t, spec)
            for (key, at, t), (_, _, spec) in zip(
                cache_leaves(cache.local), cache_leaves(cache.specs))]


class _Created:
    """The shapes of the real (not fake, not meta) tensors every op makes
    inside the block."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        shapes = self.shapes = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch._subclasses.fake_tensor import FakeTensor

                out = func(*args, **(kwargs or {}))
                for t in (out if isinstance(out, (list, tuple)) else [out]):
                    if (isinstance(t, torch.Tensor)
                            and not isinstance(t, FakeTensor)
                            and t.device.type != "meta"):
                        shapes.append(tuple(t.shape))
                return out

        self.mode = Mode()


@contextlib.contextmanager
def spying(module, name, spy):
    """``module.name`` replaced inside the block by a function that calls
    ``spy`` with its arguments first."""
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        spy(*args, **kwargs)
        return inner(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, inner)


def _served(ST, mesh, model, params, cache, feed, serve_step):
    """Each step of ``serve_step`` over ``feed``: its tokens, its logits
    (gathered whole from what it hands ``greedy_pick``) and the last
    cache."""
    logits, tokens = [], []
    with spying(ST, "greedy_pick", lambda lg, m, b, v: logits.append(
            ST.whole_logits(lg, m, b, v).numpy().copy())):
        for inputs in feed:
            tok, cache = serve_step(params, cache, inputs)
            tokens.append(tok.numpy().copy())
    return np.stack(logits), np.stack(tokens), cache


@job
def serve(archs, ckpt_root, ref_npz, shapes, extras=False):
    """For each reduced config of ``archs`` (weights from the reference's
    checkpoints under ``ckpt_root``) on each live (data, model) mesh of
    ``shapes``, from the reference's batch, feed and first cache
    (``ref_npz``): the sharded prefill's logits, each ``serve_step``'s
    tokens and whole logits, the calls of ``sp_decode_attention``, this
    rank's final cache slices with their specs, and the shapes of
    ``init_cache(..., mesh=)``'s leaves and of every tensor it made, keyed
    ``<arch>/<mesh>``; with ``extras``, a first-max tie across the vocab
    shards and an SP block with no valid slot on the first mesh."""
    from repro_torch.checkpoint import reshard
    from repro_torch.distributed import ShardedCache, param_shardings
    from repro_torch.distributed import sp as SP
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train import step as ST

    with np.load(ref_npz) as z:
        ref = {k: z[k] for k in z.files}
    meshes = [make_mesh_compat(s, ("data", "model"), device="cpu")
              for s in shapes]
    out = {}
    for arch in archs:
        cfg, module = restored(arch, f"{ckpt_root}/{arch}")
        z = arch_view(ref, arch)
        batch, feed, cache0 = serve_inputs(cfg, z)
        B = next(iter(batch.values())).shape[0]
        kw = {"mem_len": batch["frames"].shape[1]} \
            if cfg.encoder_decoder else {}
        for shape, mesh in zip(shapes, meshes):
            params = reshard(module, param_shardings(module, mesh,
                                                     cfg.n_experts), mesh)
            model, prefill = ST.make_prefill_step(cfg, device="cpu",
                                                  mesh=mesh)
            _, serve_step = ST.make_serve_step(cfg, device="cpu", mesh=mesh)
            pre = prefill(params, batch)
            cache = ShardedCache.place(cache0, mesh, B, cfg.n_kv_heads)
            if cfg.encoder_decoder:
                cache = ST.sharded_prefill_memory(model, params, cache,
                                                  batch["frames"])
            sp_calls = []
            with spying(SP, "sp_decode_attention",
                        lambda *a: sp_calls.append(1)):
                logits, tokens, cache = _served(ST, mesh, model, params,
                                                cache, feed, serve_step)
            made = _Created()
            with made.mode:
                fresh = model.init_cache(B, int(z["max_len"]),
                                         torch.float32, mesh=mesh, **kw)
            out[f"{arch}/{mesh_name(shape)}"] = dict(
                coords=mesh.coords, prefill=pre.numpy().copy(),
                logits=logits, tokens=tokens, sp_calls=len(sp_calls),
                cache=flat_cache(cache), fresh=flat_cache(fresh),
                made=made.shapes)
    if extras:
        out["tie"] = tie_pick(meshes[0])
        out["empty_block"] = empty_block(meshes[0])
    return out


def tie_pick(mesh):
    """``greedy_pick`` and ``whole_logits`` of seeded (8, 256) logits on
    ``mesh`` (its vocab blocks of 256 / tp), with first-max ties: row 0
    between two model ranks' blocks, row 1 inside one block, row 2
    across a block boundary, row 3 at the last column, row 4 reached by
    every rank; and the whole logits' first maxima."""
    from repro_torch.train import step as ST

    B, V = 8, 256
    whole = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, V)).astype(np.float32))
    n = V // mesh.axis_size("model")
    for row, cols in ((0, (n + 6, 3 * n + 6)), (1, (5, 6)),
                      (2, (n - 1, n)), (3, (V - 1,)),
                      (4, tuple(i * n + 2 for i in range(V // n)))):
        whole[row, list(cols)] = 7.0
    b = B // mesh.axis_size("data")
    local = whole[mesh.index("data") * b:][:b, mesh.index("model") * n:][
        :, :n]
    return dict(pick=ST.greedy_pick(local, mesh, B, V).numpy(),
                whole=ST.whole_logits(local, mesh, B, V).numpy(),
                want=torch.argmax(whole, dim=-1).numpy())


def empty_block(mesh):
    """``sp_decode_attention`` over the model axis on seeded q, k, v of
    2 x 32 slots whose last model block holds no valid slot: its output
    with that block's k / v seeded and with them set to 1e4, and the
    whole cache's attention by softmax (f64)."""
    from repro_torch.distributed import sp_decode_attention

    rng = np.random.default_rng(4)
    B, T, H, KV, D = 2, 32, 4, 1, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, 1, H, D), (B, T, KV, D), (B, T, KV, D)))
    n = mesh.axis_size("model")
    t = T // n
    valid = torch.arange(T)[None].expand(B, T) < (n - 1) * t - 3
    mine = slice(mesh.index("model") * t, (mesh.index("model") + 1) * t)
    group = mesh.group("model")
    out = sp_decode_attention(q, k[:, mine], v[:, mine], valid[:, mine],
                              group)
    k2, v2 = k.clone(), v.clone()
    k2[:, (n - 1) * t:] = 1e4
    v2[:, (n - 1) * t:] = 1e4
    out2 = sp_decode_attention(q, k2[:, mine], v2[:, mine], valid[:, mine],
                               group)
    s = torch.einsum("bhd,btd->bht", q[:, 0].double(),
                     k[:, :, 0].double()) / D ** 0.5
    s = s.masked_fill(~valid[:, None], float("-inf"))
    dense = torch.einsum("bht,btd->bhd", torch.softmax(s, -1),
                         v[:, :, 0].double())[:, None]
    return dict(out=out.numpy(), out_garbage=out2.numpy(),
                dense=dense.numpy(), empty_rank=n - 1,
                valid_slots=int(valid[0].sum()))


@job
def serve_one_rank(archs, ckpt_root, ref_npz):
    """For each config of ``archs``: the one-process prefill and decode
    (``make_prefill_step`` / ``make_serve_step`` without a mesh, the
    logits of each step from ``model.decode_step`` on the same cache)
    and the sharded ones on a (1, 1) mesh, from the same weights, batch,
    feed and first cache: both sides' prefill logits, step logits,
    tokens and final cache leaves; then both sides' prefill again after
    the weights are halved in place (the mesh step told to
    ``regather()``)."""
    import copy

    from repro_torch.checkpoint import reshard
    from repro_torch.distributed import ShardedCache, param_shardings
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.encdec import encdec_prefill_memory
    from repro_torch.train import step as ST

    with np.load(ref_npz) as z:
        ref = {k: z[k] for k in z.files}
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    out = {}
    for arch in archs:
        cfg, module = restored(arch, f"{ckpt_root}/{arch}")
        batch, feed, cache0 = serve_inputs(cfg, arch_view(ref, arch))
        B = next(iter(batch.values())).shape[0]
        model, prefill = ST.make_prefill_step(cfg, device="cpu")
        _, serve_step = ST.make_serve_step(cfg, device="cpu")
        cache = copy.deepcopy(cache0)
        with torch.no_grad():
            if cfg.encoder_decoder:
                cache = encdec_prefill_memory(module, cfg, batch["frames"],
                                              cache)
            plain = dict(prefill=prefill(module, batch).numpy())
            logits, tokens = [], []
            for inputs in feed:
                logits.append(model.decode_step(module, cache, **inputs)[0][
                    :, -1].numpy().copy())
                tok, cache = serve_step(module, cache, inputs)
                tokens.append(tok.numpy())
        plain.update(logits=np.stack(logits), tokens=np.stack(tokens),
                     cache=[(k, a, t.numpy().copy() if isinstance(
                         t, torch.Tensor) else t)
                         for k, a, t in cache_leaves(cache)])
        params = reshard(module, param_shardings(module, mesh,
                                                 cfg.n_experts), mesh)
        _, mprefill = ST.make_prefill_step(cfg, device="cpu", mesh=mesh)
        _, mserve = ST.make_serve_step(cfg, device="cpu", mesh=mesh)
        cache = ShardedCache.place(cache0, mesh, B, cfg.n_kv_heads)
        if cfg.encoder_decoder:
            cache = ST.sharded_prefill_memory(model, params, cache,
                                              batch["frames"])
        sharded = dict(prefill=mprefill(params, batch).numpy())
        logits, tokens, cache = _served(ST, mesh, model, params, cache, feed,
                                        mserve)
        sharded.update(logits=logits, tokens=tokens,
                       cache=[(k, a, t) for k, a, t, _ in flat_cache(cache)])
        with torch.no_grad():
            held = {t.data_ptr(): t for t in [*params.values(),
                                              *module.parameters()]}
            for t in held.values():
                t.mul_(0.5)
            mprefill.regather()
            sharded["prefill_regathered"] = mprefill(params, batch).numpy()
            plain["prefill_regathered"] = prefill(module, batch).numpy()
        out[arch] = dict(plain=plain, mesh=sharded)
    return out


@job
def dryrun_twin(cells, shape=(2, 2)):
    """Each cell ``(arch, kind, B, S)`` of tests/test_torch_dryrun.py on a
    live (data, model) mesh of ``shape``: one call of the reduced
    config's step, built by
    ``launch.dryrun.build_cell`` from real weights (seed 0), with
    ``compat``'s counts of it as the dry-run keeps them
    (``dryrun.step_counts``), its FLOPs under ``FlopCounterMode`` and the
    parameter bytes of the serving steps' working module
    (``dryrun.held_bytes``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import compat
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_compat

    mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
    out = {}
    for arch, kind, B, S in cells:
        cfg = reduced(get_config(arch))
        _, run, step = dryrun.build_cell(cfg, ShapeSpec("t", S, B, kind),
                                         kind, mesh, "cpu", seed=0)
        compat.reset_stats()
        flops = FlopCounterMode(display=False)
        with flops:
            run()
        out[f"{arch}/{kind}"] = dict(counts=dryrun.step_counts(kind),
                                     flops=flops.get_total_flops(),
                                     held=dryrun.held_bytes(step))
    return out


@job
def remat_sharded(archs, B, S):
    """``sharded_loss_and_grads`` of each reduced config of ``archs`` on a
    live (2, 2) mesh, from weights drawn from seed 0 and numpy-seeded
    tokens, without recomputation and under ``remat_policy`` "full" and
    "dots": ``{arch: {policy: loss, ce, grads (this rank's, numpy), the
    recomputed collectives}}``."""
    import dataclasses

    from repro_torch.checkpoint import reshard
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import compat, param_shardings
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build
    from repro_torch.train.step import sharded_loss_and_grads

    mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in archs:
        cfg = reduced(get_config(arch))
        module = build(cfg, device="cpu").init(0)
        params = reshard(module, param_shardings(module, mesh,
                                                 cfg.n_experts), mesh)
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])}
        out[arch] = {}
        for policy in ("none", "full", "dots"):
            c = dataclasses.replace(cfg, remat_policy="full"
                                    if policy == "none" else policy)
            compat.reset_stats()
            loss, ce, grads = sharded_loss_and_grads(
                build(c, device="cpu"), params, batch, c,
                remat=policy != "none")
            recomputed = compat.APART.get("recompute")
            out[arch][policy] = dict(
                loss=loss.numpy().copy(), ce=ce.numpy().copy(),
                grads=_np(grads),
                recomputed={} if recomputed is None
                else recomputed.as_dict())
    return out


MIXERS = {"mamba": ("zamba2-2.7b", "mambas.0.mixer"),
          "mlstm": ("xlstm-1.3b", "mlstms.0.core"),
          "slstm": ("xlstm-1.3b", "slstm.core")}


def _with_leaves(module, leaves):
    """A copy of ``module`` whose parameters are ``leaves`` (name ->
    tensor), each an autograd leaf of its own."""
    import copy

    new = copy.deepcopy(module)
    for name, t in leaves.items():
        *path, leaf = name.split(".")
        owner = new
        for p in path:
            owner = getattr(owner, p)
        setattr(owner, leaf, torch.nn.Parameter(t.detach().clone()))
    return new


def _mixer_run(apply, module, x, ct, cfg, axis=None):
    """``(y, dy/dx, {leaf: gradient})`` of ``sum(apply(module, x) * ct)``."""
    from repro_torch.distributed import tp

    x = x.detach().clone().requires_grad_(True)
    named = list(module.named_parameters())
    with tp.split_model(axis):
        y = apply(module, x, cfg) if axis is None else apply(
            module, x, cfg, axis)
    gx, *gp = torch.autograd.grad((y * ct).sum(), [x] + [p for _, p in named])
    return (y.detach(), gx, {n: g for (n, _), g in zip(named, gp)})


@job
def mixer_split(shapes, seq_lens, B=2, L=32):
    """Each mixer of MIXERS (the first of its kind in a reduced config's
    first super-block, weights from seed 0, every leaf moved off its
    init by numpy-seeded noise) on each live (data, model) mesh of
    ``shapes``: one process's forward and gradients of ``sum(y * ct)``
    on numpy-seeded ``x`` and ``ct`` (B, L, d), and the same on this
    rank's heads (its ``SPLIT`` leaves' model shards under
    ``compute_split``, its ``SELECT`` leaves whole), the split leaves'
    gradients gathered whole over "model"; the split RMS norm
    (``tp.rms_norm``) of numpy-seeded (B, L, 128) inputs beside
    ``layers.rms_norm`` of the whole, with their gradients; and the
    model axis's collective calls of a reduced sharded train step at each
    sequence length of ``seq_lens``.  Keyed by the mesh's name."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import compat, param_shardings, tp
    from repro_torch.distributed.sharding import (SPLIT, compute_split,
                                                  local_slice, only_model,
                                                  unshard)
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build, layers, ssm, xlstm
    from repro_torch.checkpoint import reshard
    from repro_torch.train.step import sharded_loss_and_grads

    applies = {"mamba": ssm.mamba_apply, "mlstm": xlstm.mlstm_apply,
               "slstm": xlstm.slstm_apply}
    rng = np.random.default_rng(0)
    out = {}
    for shape in shapes:
        mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
        axis = tp.ModelAxis.of(mesh)
        res = {}
        for mixer, (arch, prefix) in MIXERS.items():
            cfg = reduced(get_config(arch))
            whole = build(cfg, device="cpu").init(0)
            with torch.no_grad():
                for p in whole.parameters():
                    p.add_(torch.from_numpy(0.1 * rng.standard_normal(
                        p.shape).astype(np.float32)))
            specs = param_shardings(whole, mesh, cfg.n_experts)
            split = compute_split(specs, cfg, mesh)
            module = whole.get_submodule(f"segments.0.0.{prefix}")
            leaves = {n: f"segments.0.0.{prefix}.{n}"
                      for n, _ in module.named_parameters()}
            x = torch.from_numpy(rng.standard_normal(
                (B, L, cfg.d_model)).astype(np.float32))
            ct = torch.from_numpy(rng.standard_normal(
                (B, L, cfg.d_model)).astype(np.float32))
            want = _mixer_run(applies[mixer], module, x, ct, cfg)
            mine = _with_leaves(module, {
                n: local_slice(p, only_model(specs[leaves[n]]), mesh)
                for n, p in module.named_parameters()
                if split[leaves[n]] == SPLIT})
            got = _mixer_run(applies[mixer], mine, x, ct, cfg, axis)
            gathered = {n: unshard(g.contiguous(),
                                   only_model(specs[leaves[n]]), mesh)
                        if split[leaves[n]] == SPLIT else g
                        for n, g in got[2].items()}
            res[mixer] = dict(
                split={n: split[leaves[n]] for n in leaves},
                local={n: tuple(p.shape) for n, p in mine.named_parameters()},
                want=[want[0].numpy(), want[1].numpy(), _np(want[2])],
                got=[got[0].numpy(), got[1].numpy(), _np(gathered)])
        # the split norm
        x = torch.from_numpy(rng.standard_normal((B, L, 128))
                             .astype(np.float32))
        scale = torch.from_numpy(0.1 * rng.standard_normal(128)
                                 .astype(np.float32))
        ct = torch.from_numpy(rng.standard_normal((B, L, 128))
                              .astype(np.float32))
        norms = {}
        for name, (xs, ss, ax) in (
                ("whole", (x, scale, None)),
                ("split", (local_slice(x, (None, None, "model"), mesh),
                           local_slice(scale, ("model",), mesh), axis))):
            xs, ss = (t.clone().requires_grad_(True) for t in (xs, ss))
            y = (layers.rms_norm(xs, ss, 1e-5) if ax is None
                 else tp.rms_norm(xs, ss, 1e-5, ax))
            ct_mine = ct if ax is None else local_slice(
                ct, (None, None, "model"), mesh)
            gx, gs = torch.autograd.grad((y * ct_mine).sum(), [xs, ss])
            norms[name] = [y.detach().numpy(), gx.numpy(), gs.numpy()]
        res["norm"] = norms
        # the model axis's collective calls a step, by sequence length
        calls = {}
        for arch in ("zamba2-2.7b", "xlstm-1.3b"):
            cfg = reduced(get_config(arch))
            model = build(cfg, device="cpu")
            module = model.init(0)
            params = reshard(module, param_shardings(module, mesh,
                                                     cfg.n_experts), mesh)
            for S in seq_lens:
                toks = np.random.default_rng(1).integers(
                    0, cfg.vocab_size, (4, S + 1)).astype(np.int32)
                batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                         "labels": torch.from_numpy(toks[:, 1:])}
                compat.reset_stats()
                sharded_loss_and_grads(model, params, batch, cfg)
                calls[f"{arch}/{S}"] = {
                    op: c["calls"] for op, c in compat.STATS.as_dict().items()
                    if op.startswith("model:")}
        res["calls"] = calls
        res["coords"] = mesh.coords
        out[mesh_name(shape)] = res
    return out


@job
def head_group(shape, B=2, L=32):
    """Reduced xlstm's mLSTM, its sLSTM (the first of each in the first
    super-block) and that whole super-block (``"block"``), weights from
    seed 0 moved off their init by numpy-seeded noise, on a live (data,
    model) mesh of ``shape`` whose model axis is a multiple of the 4
    heads: one process's forward and gradients of ``sum(y * ct)`` on
    numpy-seeded ``x`` and ``ct`` (B, L, d), in f64 (``f64``) and in f32
    (``want``), and the same on this rank's head group (``got``: its
    ``SPLIT`` leaves' model shards under ``compute_split``, its
    ``SELECT`` leaves whole; the split leaves' gradients gathered whole
    over "model"), every mLSTM readout of the f32 runs on the f64 run's
    sides of the normaliser's kink; and each f32 side's forward matmul
    FLOPs (``FlopCounterMode``, no autograd)."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import param_shardings, tp
    from repro_torch.distributed.sharding import (SPLIT, compute_split,
                                                  local_slice, only_model,
                                                  unshard)
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build, xlstm
    from repro_torch.models.transformer import _apply_super

    rng = np.random.default_rng(0)
    mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
    axis = tp.ModelAxis.of(mesh)
    cfg = reduced(get_config("xlstm-1.3b"))
    whole = build(cfg, device="cpu").init(0)
    with torch.no_grad():
        for p in whole.parameters():
            p.add_(torch.from_numpy(0.1 * rng.standard_normal(
                p.shape).astype(np.float32)))
    specs = param_shardings(whole, mesh, cfg.n_experts)
    split = compute_split(specs, cfg, mesh)
    positions = torch.arange(L)[None].expand(B, L)

    def block(m, x, c, *_):
        return _apply_super("xlstm_super", m, x, positions, c)[0]

    units = {"mlstm": ("segments.0.0.mlstms.0.core", xlstm.mlstm_apply),
             "slstm": ("segments.0.0.slstm.core", xlstm.slstm_apply),
             "block": ("segments.0.0", block)}
    out = {"coords": mesh.coords}
    for unit, (prefix, apply) in units.items():
        module = whole.get_submodule(prefix)
        leaves = {n: f"{prefix}.{n}" for n, _ in module.named_parameters()}
        x = torch.from_numpy(rng.standard_normal(
            (B, L, cfg.d_model)).astype(np.float32))
        ct = torch.from_numpy(rng.standard_normal(
            (B, L, cfg.d_model)).astype(np.float32))
        with xlstm.NormaliserSides() as sides:
            want64 = _mixer_run(apply, copy.deepcopy(module).double(),
                                x.double(), ct.double(), cfg)
        with xlstm.NormaliserSides(sides.seen):
            want = _mixer_run(apply, module, x, ct, cfg)
        mine = _with_leaves(module, {
            n: local_slice(p, only_model(specs[leaves[n]]), mesh)
            for n, p in module.named_parameters()
            if split[leaves[n]] == SPLIT})
        with xlstm.NormaliserSides(sides.seen, mesh):
            got = _mixer_run(apply, mine, x, ct, cfg, axis)
        gathered = {n: unshard(g.contiguous(), only_model(specs[leaves[n]]),
                               mesh) if split[leaves[n]] == SPLIT else g
                    for n, g in got[2].items()}
        flops = []
        for m, ax in ((module, None), (mine, axis)):
            counter = FlopCounterMode(display=False)
            with torch.no_grad(), tp.split_model(ax), counter:
                apply(m, x, cfg) if ax is None else apply(m, x, cfg, ax)
            flops.append(counter.get_total_flops())
        out[unit] = dict(
            split={n: split[leaves[n]] for n in leaves},
            local={n: tuple(p.shape) for n, p in mine.named_parameters()},
            whole={n: tuple(p.shape) for n, p in module.named_parameters()},
            want=[want[0].numpy(), want[1].numpy(), _np(want[2])],
            got=[got[0].numpy(), got[1].numpy(), _np(gathered)],
            f64=[want64[0].numpy(), want64[1].numpy(), _np(want64[2])],
            flops_one=flops[0], flops_rank=flops[1])
    return out


@contextlib.contextmanager
def recording_calls(seen):
    """``seen``: ``(op, bytes)`` of each collective ``compat`` counts
    inside the block, in order (``op`` as ``compat.STATS`` names it)."""
    from repro_torch.distributed import compat

    inner = compat.STATS.add

    def record(op, nbytes, *args, **kwargs):
        seen.append((op, int(nbytes)))
        return inner(op, nbytes, *args, **kwargs)

    compat.STATS.add = record
    try:
        yield seen
    finally:
        del compat.STATS.add


def _seeded_state(cache, rng):
    """``cache`` (a recurrent state) with every leaf drawn from ``rng``:
    normal values, the stabilisers' shifted below 0."""
    from repro_torch.distributed import map_cache

    def draw(t):
        v = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        return torch.from_numpy(v - 2.0 if float(t.reshape(-1)[0]) < -1
                                else 0.5 * v)
    return map_cache(draw, cache)


@contextlib.contextmanager
def recording_whole(seen):
    """``seen``: the name of each leaf ``Sharded.whole`` gathers whole
    inside the block (the serving steps' working gather of the leaves it
    does not keep at their model shards)."""
    from repro_torch.distributed import Sharded

    inner = Sharded.whole

    def record(self, name):
        seen.append(name)
        return inner(self, name)

    Sharded.whole = record
    try:
        yield seen
    finally:
        Sharded.whole = inner


@job
def decode_mixers(shapes, steps, B=8):
    """Each mixer of MIXERS' decode (weights as :func:`mixer_split`'s, a
    state drawn from numpy, ``steps`` inputs ``(B, 1, d)``) on each live
    (data, model) mesh of ``shapes``: the one-process decode's outputs
    and states a step, and the same steps on this rank's slices of the
    state under ``cache_shardings`` (its data slice of the inputs), with
    the weights at their stored model shards (``compute_split(...,
    mixers=False)``, ``"stored"``) and whole (``"whole"``), with the
    collectives of each step (``(op, bytes)`` a call); then two sharded
    serve steps of each reduced config (weights from seed 0, a zero cache
    placed by ``ShardedCache.place``): the leaves the first gathered
    whole, the second's collectives a call and
    ``compat.APART["recurrent"]``, the shapes of the step's working
    module and the stored specs.  Keyed by the mesh's name."""
    from repro_torch.checkpoint import reshard
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import (ShardedCache, cache_shardings,
                                         compat, map_cache, param_shardings,
                                         tp)
    from repro_torch.distributed.sharding import (SPLIT, compute_split,
                                                  local_slice, only_model)
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build, ssm, xlstm
    from repro_torch.train import step as ST

    decodes = {"mamba": (ssm.mamba_decode, ssm.init_mamba_cache),
               "mlstm": (xlstm.mlstm_decode, xlstm.init_mlstm_cache),
               "slstm": (xlstm.slstm_decode, xlstm.init_slstm_cache)}
    out = {}
    for shape in shapes:
        rng = np.random.default_rng(0)
        mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
        axis = tp.ModelAxis.of(mesh)
        axis = axis if axis.size > 1 else None
        b = B // mesh.axis_size("data")
        mine = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
        res = {}
        for mixer, (arch, prefix) in MIXERS.items():
            decode, init = decodes[mixer]
            cfg = reduced(get_config(arch))
            whole = build(cfg, device="cpu").init(0)
            with torch.no_grad():
                for p in whole.parameters():
                    p.add_(torch.from_numpy(0.1 * rng.standard_normal(
                        p.shape).astype(np.float32)))
            specs = param_shardings(whole, mesh, cfg.n_experts)
            split = compute_split(specs, cfg, mesh, mixers=False)
            module = whole.get_submodule(f"segments.0.0.{prefix}")
            full = {n: f"segments.0.0.{prefix}.{n}"
                    for n, _ in module.named_parameters()}
            weights = {"whole": module, "stored": _with_leaves(module, {
                n: local_slice(p, only_model(specs[full[n]]), mesh)
                for n, p in module.named_parameters()
                if split[full[n]] == SPLIT})}
            state = _seeded_state(init(B, cfg, device="cpu"), rng)
            xs = torch.from_numpy(rng.standard_normal(
                (steps, B, 1, cfg.d_model)).astype(np.float32))
            spec = cache_shardings(state, mesh, B, cfg.n_kv_heads)
            local0 = map_cache(lambda t, s: local_slice(t, s, mesh).clone(
                memory_format=torch.contiguous_format), state, spec)
            want, got, calls = [], {}, {}
            with torch.no_grad():
                for x in xs:
                    y, state = decode(module, x, state, cfg)
                    want.append((y.numpy().copy(), {
                        k: v.numpy().copy()
                        for k, v in state._asdict().items()}))
                for kind, params in weights.items():
                    local, got[kind], calls[kind] = local0, [], []
                    for x in xs:
                        seen = []
                        with recording_calls(seen):
                            y, local = decode(params, x[mine], local, cfg,
                                              axis, spec)
                        got[kind].append((y.numpy(), {
                            k: v.numpy().copy()
                            for k, v in local._asdict().items()}))
                        calls[kind].append(seen)
            res[mixer] = dict(want=want, got=got, calls=calls,
                              spec=spec._asdict())
        steps_out = {}
        for arch in ("zamba2-2.7b", "xlstm-1.3b"):
            cfg = reduced(get_config(arch))
            model = build(cfg, device="cpu")
            module = model.init(0)
            params = reshard(module, param_shardings(module, mesh,
                                                     cfg.n_experts), mesh)
            _, serve_step = ST.make_serve_step(cfg, device="cpu", mesh=mesh)
            cache = ShardedCache.place(model.init_cache(B, 16, torch.float32),
                                       mesh, B, cfg.n_kv_heads)
            tokens = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (2, B, 1)).astype(np.int32))
            gathered = []
            with recording_whole(gathered):
                _, cache = serve_step(params, cache, {"token": tokens[0]})
            compat.reset_stats()
            seen = []
            with recording_calls(seen):
                serve_step(params, cache, {"token": tokens[1]})
            recurrent = compat.APART.get("recurrent")
            steps_out[arch] = dict(
                calls=seen, recurrent={} if recurrent is None
                else recurrent.as_dict(), gathered_whole=gathered,
                held={n: tuple(p.shape)
                      for n, p in serve_step.held().named_parameters()},
                specs=dict(params.specs),
                leaves={k: [tuple(t.shape) for t in v] for k, v in (
                    ("mambas", [c.state for seg in cache.local for sup in seg
                                if "mambas" in sup
                                for c in sup["mambas"]]),
                    ("mlstms", [c.C for seg in cache.local for sup in seg
                                if "mlstms" in sup
                                for c in sup["mlstms"]]))})
        res["steps"] = steps_out
        res["coords"] = mesh.coords
        out[mesh_name(shape)] = res
    return out
