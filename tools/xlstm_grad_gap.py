#!/usr/bin/env python3
"""How far xlstm-1.3b's f32 train-step gradients lie from the same
gradients in f64, one process and sharded.

    PYTHONPATH=src python3 tools/xlstm_grad_gap.py              # one card
    PYTHONPATH=src python3 tools/xlstm_grad_gap.py --batch 2 --no-sharded

xlstm-1.3b at full width cut to one super-block (``--layers`` 6: 5 mLSTM
and 1 sLSTM), random weights from seed 0, the ``TokenPipeline`` batch of
seed 0 (``--batch`` x ``--seq`` tokens, as ``chip_smoke.py`` phase 18
trains it), the loss of ``train.step.loss_fn`` under its default
recomputation:

* ``float64``: the one-process gradients with the model's f32 weights
  and activations cast to f64 (where the model casts to f32 on purpose,
  as the reference does: its norms, the mLSTM gates, the sLSTM and the
  loss, those stay f32);
* ``float32``: the same in f32, each mLSTM readout on the side of its
  normaliser's kink that the f64 step took (``models.xlstm.
  NormaliserSides``); ``float32_free`` on its own sides, and
  ``free_flips``, how many of those differ from the f64 step's;
* ``sharded`` (unless ``--no-sharded``): ``sharded_loss_and_grads`` on a
  (2, 2) ``("data", "model")`` mesh of four gloo ranks spawned on the
  same card (the mixers split by head) on the f64 step's sides, each
  gradient gathered whole.

For each leaf its gap is ``max |g - g64| / max |g64|``; the script prints
the losses, the largest gap of each side and the leaves with the largest
f32 gaps, as JSON.  Where an f32 step takes the other side of the kink
at some position (``|den|`` within rounding of 1), its gradients differ
from f64's by the jump there, whatever the device: the free reading.
TF32 is off (``torch.set_float32_matmul_precision("highest")``), as in
``chip_smoke.py``.  ``--device cpu`` runs it on the
CPU (with ``--reduced`` for a config small enough there).

``--localise`` finds where the device's f32 step leaves f64.  The
weights are made once on ``--device`` (as the plain mode makes them) and
copied to the CPU, and the CPU in f64 is the oracle:

* ``steps``: the gradient gaps of the device in f32 (with and without
  recomputation) and of the CPU in f32 (without), each from the oracle;
* ``blocks``: each mixer's output and its input gradient, in call order;
* ``focus``: inside the ``--focus``-th mLSTM (0-based): ``q``, ``k``,
  ``v``, the log gates, the per-head scan's output, and how many of the
  normaliser's ``|n . q| >= 1`` decisions differ from the oracle's;
* ``ops``: every aten op of the device's run without recomputation,
  forward and backward, recomputed on the CPU in f64 and in f32 from the
  device's own inputs; an op's gap is ``max |out - f64| / max |f64|``,
  its ``ratio`` the device's gap over the CPU's f32 gap (the op's
  arithmetic, not its inputs, at fault where it is large); ops inside the
  focus mLSTM's ``ssd_chunked`` carry ``ctx`` "ssd", its other ops
  "mlstm";
* ``ssd_alone``: ``ssd_chunked`` alone on the focus mLSTM's captured
  inputs and output gradient, at the whole folded batch and at its first
  half, on the device in f32 against the CPU in f64.

The full op table goes to ``--out`` (JSON).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_map  # noqa: E402


def _setup(device: str) -> torch.device:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")


def _cfg(args, dtype="float32"):
    from repro_torch.configs import get_config, reduced

    cfg = get_config("xlstm-1.3b")
    if args.reduced:
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, dtype=dtype, n_layers=args.layers)


def _batch(cfg, args, dev):
    from repro_torch.data import TokenPipeline

    b = TokenPipeline(vocab=cfg.vocab_size, batch=args.batch,
                      seq_len=args.seq, seed=0).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _one(args, dev, dtype, pinned=None):
    """``(loss, {leaf: gradient in f64 on the host}, sides)`` in one
    process, the normaliser's sides taken from ``pinned`` where given and
    recorded (``sides``) either way."""
    from repro_torch.models import build
    from repro_torch.models.transformer import init_decoder
    from repro_torch.models.xlstm import NormaliserSides
    from repro_torch.train.step import loss_fn

    p = init_decoder(0, _cfg(args), dev)
    cfg = _cfg(args, dtype)
    if dtype == "float64":
        p = p.to(torch.float64)
        p.cfg = cfg
    named = list(p.named_parameters())
    with NormaliserSides(pinned) as sides:
        loss, _ = loss_fn(build(cfg, device=dev), p, _batch(cfg, args, dev),
                          cfg)
        grads = torch.autograd.grad(loss, [q for _, q in named])
    return float(loss.detach()), {n: g.detach().double().cpu()
                                  for (n, _), g in zip(named, grads)}, \
        sides.seen


def _rank(rank, world, init, out, args, pinned):
    torch.set_num_threads(1)
    dev = _setup(args.device)
    from repro_torch.checkpoint import reshard
    from repro_torch.distributed import compat, param_shardings
    from repro_torch.distributed.sharding import unshard
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build
    from repro_torch.models.transformer import init_decoder
    from repro_torch.models.xlstm import NormaliserSides
    from repro_torch.train.step import sharded_loss_and_grads

    compat.init_distributed(device=str(dev), backend="gloo",
                            init_method=f"file://{init}", world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh_compat((2, 2), ("data", "model"), device=dev)
        cfg = _cfg(args)
        p = init_decoder(0, cfg, dev)
        specs = param_shardings(p, mesh, 0)
        params = reshard(p, specs, mesh)
        del p
        with NormaliserSides(pinned, mesh):
            loss, _, grads = sharded_loss_and_grads(
                build(cfg, device=dev), params, _batch(cfg, args, dev), cfg)
        grads = {n: unshard(g.contiguous(), specs[n], mesh).double().cpu()
                 for n, g in grads.items()}
        if rank == 0:
            torch.save((float(loss), grads), Path(out) / "sharded.pt")
    finally:
        torch.distributed.destroy_process_group()


def _gap(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


# ---------------------------------------------------------------------------
# --localise
# ---------------------------------------------------------------------------

def _copy_to(p, cfg, device):
    """A copy of the decoder ``p`` on ``device`` in ``cfg.dtype``."""
    from repro_torch.models.transformer import Decoder

    q = Decoder(_f32(cfg), device=device).to(getattr(torch, cfg.dtype))
    q.load_state_dict(p.state_dict())
    q.cfg = cfg
    return q


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _host(t):
    return t.detach().double().cpu()


class _Probe:
    """Records the mixers' outputs and gradients (module docstring) by
    wrapping the functions the decoder calls; tags the autograd nodes each
    wrapped call made, so the op check can name a backward op's place."""

    def __init__(self, focus):
        self.focus = focus
        self.vals, self.tags, self.ctx = {}, {}, []
        self.calls = {"mlstm": 0, "slstm": 0}
        self.ssd_in = self.ssd_cot = None

    def keep(self, name, t):
        self.vals[name] = _host(t)

    def keep_grad(self, name, t):
        if t.requires_grad:
            t.register_hook(lambda g: self.keep(name, g))

    def tag(self, outs, ins, name):
        stop = {t.grad_fn for t in ins if t.grad_fn is not None}
        todo = [t.grad_fn for t in outs if t.grad_fn is not None]
        while todo:
            n = todo.pop()
            if n is None or n in stop or n in self.tags:
                continue
            self.tags[n] = name
            todo.extend(f for f, _ in n.next_functions)

    @contextlib.contextmanager
    def patched(self):
        from repro_torch.models import transformer, xlstm

        saved = {(m, n): getattr(m, n) for m, n in (
            (transformer, "mlstm_apply"), (transformer, "slstm_apply"),
            (xlstm, "_mlstm_qkv"), (xlstm, "_per_head_scan"),
            (xlstm, "ssd_chunked"))}

        def block(kind, fn):
            def run(params, x, cfg, *a, **k):
                i = self.calls[kind]
                self.calls[kind] += 1
                name = f"{kind}{i}"
                focus = kind == "mlstm" and i == self.focus
                self.ctx.append("mlstm" if focus else name)
                self.keep_grad(f"{name}.in_grad", x)
                try:
                    y = fn(params, x, cfg, *a, **k)
                finally:
                    self.ctx.pop()
                self.keep(f"{name}.out", y)
                self.tag([y], [x], "mlstm" if focus else name)
                return y
            return run

        def in_focus():
            return self.ctx and self.ctx[-1] in ("mlstm", "ssd")

        def qkv(*a, **k):
            out = saved[(xlstm, "_mlstm_qkv")](*a, **k)
            if in_focus():
                for n, t in zip(("q", "k", "v", "log_i", "log_f"), out):
                    self.keep(f"focus.{n}", t)
            return out

        def scan(*a, **k):
            y = saved[(xlstm, "_per_head_scan")](*a, **k)
            if in_focus():
                self.keep("focus.scan", y)
                self.keep("focus.den", y[..., -1])
            return y

        def ssd(*a, **k):
            if not in_focus():
                return saved[(xlstm, "ssd_chunked")](*a, **k)
            self.ssd_in = [t.detach().clone() for t in a[:4]]
            self.ctx.append("ssd")
            try:
                y, state = saved[(xlstm, "ssd_chunked")](*a, **k)
            finally:
                self.ctx.pop()
            self.tag([y, state], list(a[:4]), "ssd")
            if y.requires_grad:
                y.register_hook(lambda g: setattr(
                    self, "ssd_cot", g.detach().clone()))
            return y, state

        patches = {(transformer, "mlstm_apply"): block(
                       "mlstm", saved[(transformer, "mlstm_apply")]),
                   (transformer, "slstm_apply"): block(
                       "slstm", saved[(transformer, "slstm_apply")]),
                   (xlstm, "_mlstm_qkv"): qkv,
                   (xlstm, "_per_head_scan"): scan,
                   (xlstm, "ssd_chunked"): ssd}
        for (m, n), f in patches.items():
            setattr(m, n, f)
        try:
            yield self
        finally:
            for (m, n), f in saved.items():
                setattr(m, n, f)


def _gap0(a, b) -> float:
    """``_gap`` that is 0 where both sides are all zeros."""
    d = float((a - b).abs().max()) if a.numel() else 0.0
    return 0.0 if d == 0.0 else _gap(a, b)


_NO_CHECK = ("empty", "detach", "lift_fresh", "_local_scalar_dense",
             "set_", "resize_", "record_stream")


class _OpCheck(TorchDispatchMode):
    """Recomputes every aten op on the CPU in f64 and in f32 from the
    inputs it was given on the device (module docstring, ``ops``)."""

    def __init__(self, probe):
        super().__init__()
        self.probe, self.rows, self.backward = probe, [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, _ = tree_flatten((args, kwargs))
        name = str(func)
        if (func.is_view or any(w in name for w in _NO_CHECK)
                or any(isinstance(t, torch.Generator) for t in leaves)
                or not any(isinstance(t, torch.Tensor)
                           and t.is_floating_point() for t in leaves)):
            return func(*args, **kwargs)

        def to_cpu(dtype):
            def one(t):
                if isinstance(t, torch.Tensor):
                    c = t.detach().to("cpu", copy=True)
                    return c.to(dtype) if c.is_floating_point() else c
                if isinstance(t, torch.device):
                    return torch.device("cpu")
                if t is torch.float32:
                    return dtype
                return t
            return tree_map(one, (args, kwargs))

        a64, a32 = to_cpu(torch.float64), to_cpu(torch.float32)
        out = func(*args, **kwargs)
        row = dict(i=len(self.rows), phase="bwd" if self.backward else "fwd",
                   op=name, shapes=[list(t.shape) for t in leaves
                                    if isinstance(t, torch.Tensor)],
                   strides=[list(t.stride()) for t in leaves
                            if isinstance(t, torch.Tensor)])
        if self.backward:
            node = getattr(torch._C, "_current_autograd_node",
                           lambda: None)()
            row["node"] = None if node is None else node.name()
            row["ctx"] = self.probe.tags.get(node)
        else:
            row["ctx"] = self.probe.ctx[-1] if self.probe.ctx else None
        try:
            r64, r32 = func(*a64[0], **a64[1]), func(*a32[0], **a32[1])
        except (RuntimeError, TypeError, ValueError) as e:
            row["error"] = str(e).splitlines()[0][:200]
            self.rows.append(row)
            return out
        pairs = [(o, x, y) for o, x, y in zip(
            tree_flatten(out)[0], tree_flatten(r64)[0], tree_flatten(r32)[0])
            if isinstance(o, torch.Tensor) and o.is_floating_point()]
        if pairs:
            dev = max(_gap0(_host(o), x.double()) for o, x, _ in pairs)
            cpu = max(_gap0(y.double(), x.double()) for _, x, y in pairs)
            row.update(dev=dev, cpu=cpu, ratio=dev / max(cpu, 2.0 ** -24))
            self.rows.append(row)
        return out


def _run(p, cfg, batch, probe=None, check=None, remat=False):
    """``(loss, grads)`` of one step of ``p``; ``probe`` records, ``check``
    holds each op against the CPU."""
    from repro_torch.models import build
    from repro_torch.train.step import loss_fn

    named = list(p.named_parameters())
    with contextlib.ExitStack() as stack:
        if probe is not None:
            stack.enter_context(probe.patched())
        if check is not None:
            stack.enter_context(check)
        loss, _ = loss_fn(build(cfg, device=batch["tokens"].device), p,
                          batch, cfg, remat=remat)
        if check is not None:
            check.backward = True
        grads = torch.autograd.grad(loss, [q for _, q in named])
    return float(loss.detach()), {n: _host(g)
                                  for (n, _), g in zip(named, grads)}


def _worst(grads, want):
    gaps = {n: _gap(grads[n], want[n]) for n in want}
    n = max(gaps, key=gaps.get)
    return dict(gap=gaps[n], leaf=n)


def _ssd_alone(ins, cot, dev, dtype):
    from repro_torch.models.ssm import ssd_chunked

    xs = [t.detach().to(dev, dtype).requires_grad_() for t in ins]
    y, _ = ssd_chunked(*xs)
    grads = torch.autograd.grad(y, xs, cot.to(dev, dtype))
    return [_host(y)] + [_host(g) for g in grads]


def localise(args, dev) -> dict:
    """The ``--localise`` report (module docstring)."""
    from repro_torch.models.transformer import init_decoder

    cfg = _cfg(args)
    p_dev = init_decoder(0, cfg, dev)
    cpu = torch.device("cpu")
    p64 = _copy_to(p_dev, _cfg(args, "float64"), cpu)
    p32 = _copy_to(p_dev, cfg, cpu)
    b_dev, b_cpu = _batch(cfg, args, dev), _batch(cfg, args, cpu)
    rep = dict(batch=[args.batch, args.seq], layers=args.layers,
               focus=args.focus)

    oracle = _Probe(args.focus)
    loss64, want = _run(p64, p64.cfg, b_cpu, probe=oracle)
    probe = _Probe(args.focus)
    check = _OpCheck(probe)
    loss_dev, g_dev = _run(p_dev, cfg, b_dev, probe=probe, check=check)
    host = _Probe(args.focus)
    loss32, g32 = _run(p32, cfg, b_cpu, probe=host)
    loss_r, g_r = _run(p_dev, cfg, b_dev, remat=True)
    rep["steps"] = dict(
        losses=dict(f64=loss64, device=loss_dev, cpu_f32=loss32,
                    device_remat=loss_r),
        device=_worst(g_dev, want), device_remat=_worst(g_r, want),
        cpu_f32=_worst(g32, want))

    names = [n for n in oracle.vals if not n.startswith("focus.")]
    rep["blocks"] = {n: dict(device=_gap0(probe.vals[n], oracle.vals[n]),
                             cpu_f32=_gap0(host.vals[n], oracle.vals[n]))
                     for n in names if n in probe.vals}
    focus = {n[6:]: dict(device=_gap0(probe.vals[n], oracle.vals[n]),
                         cpu_f32=_gap0(host.vals[n], oracle.vals[n]))
             for n in oracle.vals if n.startswith("focus.")}
    den64 = oracle.vals["focus.den"].abs()
    focus["den"].update(
        flips_device=int(((probe.vals["focus.den"].abs() >= 1)
                          != (den64 >= 1)).sum()),
        flips_cpu_f32=int(((host.vals["focus.den"].abs() >= 1)
                           != (den64 >= 1)).sum()),
        nearest_to_1=float((den64 - 1).abs().min()))
    rep["focus"] = focus

    rows = [r for r in check.rows if "dev" in r]
    rep["ops"] = dict(
        checked=len(rows), errors=len(check.rows) - len(rows),
        by_ratio=sorted(rows, key=lambda r: -r["ratio"])[:args.top],
        first_off=[r for r in rows if r["dev"] > 1e-5
                   and r["ratio"] > 10][:args.top],
        ssd=[dict(i=r["i"], phase=r["phase"], op=r["op"],
                  node=r.get("node"), shapes=r["shapes"], dev=r["dev"],
                  cpu=r["cpu"]) for r in rows if r["ctx"] == "ssd"])

    ins, cot = probe.ssd_in, probe.ssd_cot
    whole = _ssd_alone(ins, cot, dev, torch.float32)
    ref = _ssd_alone(ins, cot, cpu, torch.float64)
    half = len(ins[0]) // 2
    first = _ssd_alone([t[:half] for t in ins], cot[:half], dev,
                       torch.float32)
    names = ("y", "dx", "da", "dB", "dC")
    rep["ssd_alone"] = dict(
        b=len(ins[0]), shapes=[list(t.shape) for t in ins],
        whole={n: _gap0(w, r) for n, w, r in zip(names, whole, ref)},
        half={n: _gap0(f, r[:half]) for n, f, r in zip(names, first, ref)},
        half_vs_whole={n: _gap0(f, w[:half])
                       for n, f, w in zip(names, first, whole)})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(rep, rows=rows)))
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--no-sharded", dest="sharded", action="store_false")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--localise", action="store_true")
    ap.add_argument("--focus", type=int, default=2,
                    help="which mLSTM (0-based) --localise looks inside")
    ap.add_argument("--out", default="",
                    help="--localise: write the full op table here")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("xlstm_grad_gap: no CUDA device", file=sys.stderr)
        return 2
    dev = _setup(args.device)
    if args.localise:
        rep = localise(args, dev)
        rep["device"] = (torch.cuda.get_device_name(0)
                         if args.device == "cuda" else "cpu")
        print(json.dumps(rep))
        return 0
    # the f64 step first: every f32 step takes its normaliser's sides
    losses, grads = {}, {}
    losses["float64"], want, sides = _one(args, dev, "float64")
    if args.sharded:
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank, nprocs=4, args=(
                4, os.path.join(tmp, "init"), tmp, args, sides))
            losses["sharded"], grads["sharded"] = torch.load(
                Path(tmp) / "sharded.pt")
    losses["float32"], grads["float32"], _ = _one(args, dev, "float32",
                                                  sides)
    losses["float32_free"], grads["float32_free"], free = _one(
        args, dev, "float32")
    gaps = {side: {n: _gap(g[n], want[n]) for n in want}
            for side, g in grads.items()}
    worst = sorted(want, key=lambda n: -gaps["float32"][n])[:args.top]
    print(json.dumps(dict(
        batch=[args.batch, args.seq], layers=args.layers,
        device=torch.cuda.get_device_name(0) if args.device == "cuda"
        else "cpu", losses=losses,
        worst={side: max(g.values()) for side, g in gaps.items()},
        free_flips=sum(int((a != b).sum()) for a, b in zip(free, sides)),
        leaves={n: {side: gaps[side][n] for side in gaps} for n in worst})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
