"""Blob helpers shared by the port's parity tests.

``canon`` turns a codec blob of either package (dicts, numpy arrays,
bytes, the codec dataclasses) into a plain nested value whose equality
is byte equality.  ``transplant`` rebuilds a blob of one package as the
other package's classes, so a cross-decode runs the *decoding* package's
code, not the blob's own methods.  ``flat_arrays`` is a Flat index of
either package as plain numpy arrays (what the port's ``FlatIndex`` is
carried across from).
"""

import importlib

import numpy as np


def canon(obj):
    if isinstance(obj, dict):
        return {k: canon(v) for k, v in sorted(obj.items())}
    if isinstance(obj, np.ndarray):
        return ("ndarray", str(obj.dtype), obj.shape, obj.tobytes())
    if isinstance(obj, (list, tuple)):
        return [canon(v) for v in obj]
    if isinstance(obj, np.generic):
        return ("scalar", str(obj.dtype), obj.tobytes())
    if obj is None or isinstance(obj, (bytes, int, float, str, bool)):
        return obj
    if hasattr(obj, "__dict__"):
        return (type(obj).__name__, canon(vars(obj)))
    if hasattr(obj, "__slots__"):            # BigANS
        return (type(obj).__name__,
                {k: canon(getattr(obj, k)) for k in obj.__slots__})
    raise TypeError(f"cannot canonicalise {type(obj).__name__}")


def transplant(obj, to: str):
    """Rebuild ``obj`` with the classes of package ``to`` ("repro" or
    "repro_torch"); containers are rebuilt, leaves shared."""
    if isinstance(obj, dict):
        return {k: transplant(v, to) for k, v in obj.items()}
    if isinstance(obj, list):
        return [transplant(v, to) for v in obj]
    if isinstance(obj, tuple):
        return tuple(transplant(v, to) for v in obj)
    mod = type(obj).__module__
    if mod.split(".")[0] not in ("repro", "repro_torch"):
        return obj
    target = to + "." + mod.split(".", 1)[1]
    cls = getattr(importlib.import_module(target), type(obj).__name__)
    if hasattr(obj, "__dict__"):
        new = cls.__new__(cls)
        new.__dict__.update({k: transplant(v, to)
                             for k, v in vars(obj).items()})
        return new
    if hasattr(obj, "__slots__"):            # BigANS
        new = cls.__new__(cls)
        for k in obj.__slots__:
            setattr(new, k, transplant(getattr(obj, k), to))
        return new
    return obj


def flat_arrays(index) -> dict:
    """A Flat index of either package as numpy: its spec, ``vecs`` (n, d)
    f32 and ``id_map`` (int64, or None)."""
    id_map = getattr(index, "id_map", None)
    return dict(spec=index.spec, vecs=np.asarray(index.vecs, np.float32),
                id_map=None if id_map is None else np.asarray(id_map,
                                                              np.int64))
