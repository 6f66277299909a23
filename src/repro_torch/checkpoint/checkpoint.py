"""Fault-tolerant checkpointing: atomic saves, auto-resume — the port of
``repro.checkpoint.checkpoint``, writing the reference's layout::

    ckpt_dir/
      step_000123/
        manifest.json       # step, flat-key list, data-pipeline state
        arrays.npz          # flat {key: array}
      LATEST                # atomically-renamed pointer file

Crash safety: writes go to ``step_X.tmp`` and are renamed into place only
after fsync; ``latest_step`` falls back to the newest complete step when
``LATEST`` points at a half-written one.

A state is flattened under the reference's keys, so a checkpoint written
by either package restores in the other: a model (``Decoder``,
``EncDec``) as the reference's pytree (``models.convert.params_to_jax``:
``0/segments/0/global/attn/wk/kernel``), an ``OptState``'s fields as
``.mu`` / ``.nu`` (in the same layout) and ``.step``, tuples and lists
by index, dicts by key.  Restoring fills the template's tensors in place
(a 12 GB state on the card is not allocated twice) and returns them;
numpy leaves of the template are replaced by the arrays read.

Elastic re-scale: :func:`reshard` places a host state (a restored one)
onto a live mesh by the sharding rules (``distributed.sharding``): each
rank keeps its own slice of each tensor.  A state holding such shards
(``distributed.sharding.Sharded``, and an ``OptState`` whose moments are
shards) is saved by every rank of the mesh: each tensor is gathered
whole, rank 0 writes, and every rank returns after a barrier.  The files
hold the unsharded logical arrays, as the reference's do, so a sharded
save's bytes are those of the unsharded save of the same state, and a
checkpoint restores onto any mesh.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import Sharded
from ..models.convert import leaf_shapes, tree_of, tree_path
from ..train.optim import OptState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "reshard"]


def _is_model(x) -> bool:
    return isinstance(x, torch.nn.Module)


def _items(node):
    """The children of ``node`` as ``(key, child)``, keyed as the
    reference's flat keys are (``.field`` for a named tuple's field);
    None for a leaf."""
    if isinstance(node, OptState):
        return [(".mu", _Named(node.mu)), (".nu", _Named(node.nu)),
                (".step", node.step)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    if isinstance(node, dict):
        return sorted(node.items())
    return None


class _Named:
    """A mapping of a model's parameter names to tensors (a moment of
    ``OptState``): stored in the model's tree layout."""

    def __init__(self, named: Dict[str, torch.Tensor]):
        self.named = named


def _whole(node) -> Dict[str, torch.Tensor]:
    """The named tensors of a model, a ``_Named`` or a ``Sharded`` (each
    gathered whole: a collective)."""
    if _is_model(node):
        return dict(node.named_parameters())
    named = node.named if isinstance(node, _Named) else node
    if isinstance(named, Sharded):
        return {n: named.whole(n) for n in named}
    return named


def _flatten(node, prefix: str, flat: Dict[str, np.ndarray]) -> None:
    if _is_model(node) or isinstance(node, (_Named, Sharded)):
        _flatten(tree_of(_whole(node)), prefix, flat)
        return
    items = _items(node)
    if items is None:
        flat[prefix[:-1]] = (node.detach().cpu().numpy()
                             if isinstance(node, torch.Tensor)
                             else np.asarray(node))
        return
    for key, child in items:
        _flatten(child, f"{prefix}{key}/", flat)


def _get(flat, key: str) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"the checkpoint has no {key!r}")
    return flat[key]


def _fill(node, prefix: str, flat: Dict[str, np.ndarray]):
    """``node`` with every leaf read from ``flat``: tensors in place, numpy
    leaves replaced."""
    if _is_model(node) or isinstance(node, _Named):
        named = (dict(node.named_parameters()) if _is_model(node)
                 else node.named)
        want = leaf_shapes(named)
        with torch.no_grad():
            for name, t in named.items():
                keys, at = tree_path(name)
                key = prefix + "/".join(map(str, keys))
                arr = _get(flat, key)
                if tuple(arr.shape) != want[keys]:
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{arr.shape} vs {want[keys]}")
                t.copy_(torch.from_numpy(np.ascontiguousarray(arr[at])))
        return node if _is_model(node) else node.named
    items = _items(node)
    if items is None:
        key = prefix[:-1]
        arr = _get(flat, key)
        if tuple(arr.shape) != tuple(np.shape(node)):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(np.shape(node))}")
        if isinstance(node, torch.Tensor):
            with torch.no_grad():
                node.copy_(torch.from_numpy(np.array(arr)))
            return node
        return arr
    filled = [_fill(c, f"{prefix}{k}/", flat) for k, c in items]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*filled)
    if isinstance(node, (tuple, list)):
        return type(node)(filled)
    return {k: v for (k, _), v in zip(items, filled)}


def save_checkpoint(ckpt_dir: str | Path, step: int, state: Any,
                    extra: Optional[dict] = None) -> Path:
    """Write ``state`` as ``ckpt_dir/step_XXXXXXXX`` (through a ``.tmp``
    directory, fsync'd, then renamed) and point ``LATEST`` at it.  A state
    that holds shards is saved by every rank of its mesh (module
    docstring)."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    flat: Dict[str, np.ndarray] = {}
    _flatten(state, "", flat)
    sharded = _has_shards(state)
    if sharded and dist.get_rank() != 0:
        dist.barrier()
        return final
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    # fsync then atomic rename — the crash-safety boundary
    for f in tmp.iterdir():
        fd = os.open(f, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest = ckpt_dir / "LATEST"
    tmp_latest = ckpt_dir / "LATEST.tmp"
    tmp_latest.write_text(str(step))
    os.replace(tmp_latest, latest)
    if sharded:
        dist.barrier()
    return final


def _has_shards(node) -> bool:
    if isinstance(node, Sharded):
        return True
    if isinstance(node, OptState):
        return isinstance(node.mu, Sharded)
    items = None if _is_model(node) else _items(node)
    return bool(items) and any(_has_shards(c) for _, c in items)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The step ``LATEST`` names, or the newest complete step when it names
    a half-written one; None without a checkpoint."""
    ckpt_dir = Path(ckpt_dir)
    latest = ckpt_dir / "LATEST"
    if not latest.exists():
        return None
    step = int(latest.read_text().strip())
    if not (ckpt_dir / f"step_{step:08d}" / "manifest.json").exists():
        # LATEST points at a half-written dir: fall back to the newest valid
        steps = sorted(
            int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
            if (p / "manifest.json").exists() and not p.name.endswith(".tmp"))
        return steps[-1] if steps else None
    return step


def restore_checkpoint(ckpt_dir: str | Path, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, dict]:
    """``(state, manifest)`` of ``step`` (default: :func:`latest_step`),
    read into ``template``'s structure: its tensors are filled in place."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    return _fill(template, "", flat), manifest


def reshard(state: Any, shardings: Dict[str, tuple], mesh) -> Any:
    """Place a host-side state onto the live ``mesh`` (elastic restore):
    each model or mapping of its parameter names to tensors becomes a
    ``Sharded`` of this rank's slices by ``shardings`` (``{name: spec}``,
    ``distributed.sharding.param_shardings``), an ``OptState``'s moments
    likewise (optimizer state shardings mirror params; ``step`` is
    replicated), in tuples and lists alike."""
    if _is_model(state) or (isinstance(state, dict)
                            and not isinstance(state, Sharded)):
        return Sharded.place(state, shardings, mesh)
    if isinstance(state, OptState):
        return OptState(mu=reshard(state.mu, shardings, mesh),
                        nu=reshard(state.nu, shardings, mesh),
                        step=state.step)
    if isinstance(state, (tuple, list)):
        return type(state)(reshard(s, shardings, mesh) for s in state)
    raise TypeError(f"reshard: a {type(state).__name__} is no model, "
                    "mapping, OptState, tuple or list")
