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
numpy leaves of the template are replaced by the arrays read.  The
reference's ``reshard`` (placing a state onto a device mesh) comes with
the distributed slice.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.convert import tree_of, tree_path
from ..train.optim import OptState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


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


def _flatten(node, prefix: str, flat: Dict[str, np.ndarray]) -> None:
    if _is_model(node) or isinstance(node, _Named):
        named = (dict(node.named_parameters()) if _is_model(node)
                 else node.named)
        _flatten(tree_of(named), prefix, flat)
        return
    items = _items(node)
    if items is None:
        flat[prefix[:-1]] = (node.detach().cpu().numpy()
                             if isinstance(node, torch.Tensor)
                             else np.asarray(node))
        return
    for key, child in items:
        _flatten(child, f"{prefix}{key}/", flat)


def _leaf_shapes(named) -> Dict[tuple, tuple]:
    """The shape of each leaf of ``tree_of(named)``, by its keys."""
    lead: Dict[tuple, list] = {}
    shape = {}
    for name, t in named.items():
        keys, at = tree_path(name)
        top = lead.setdefault(keys, [0] * len(at))
        lead[keys] = [max(a, i + 1) for a, i in zip(top, at)]
        shape[keys] = tuple(t.shape)
    return {k: tuple(lead[k]) + shape[k] for k in lead}


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
        want = _leaf_shapes(named)
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
    directory, fsync'd, then renamed) and point ``LATEST`` at it."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten(state, "", flat)
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
    return final


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
