"""Static checks over every module of the port (``src/repro_torch``), its
examples (``examples/torch_*.py``) and ``chip_smoke.py``, parsed with ``ast`` (nothing is imported):

* no ``import jax`` / ``jaxlib`` and nothing of the reference package
  ``repro`` (absolute, or relative past the top of ``repro_torch``);
* no ``allow_tf32 = True`` (matmul or cuDNN), and no
  ``set_float32_matmul_precision`` other than ``"highest"``: the plain
  versions decide in full f32, and the split-TF32 kernels do their own
  rounding.

The import-guard subprocess test (``tests/test_torch_ivf.py``) checks the
same at run time for the modules a run imports; this one reaches every
file, also those no test imports.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py"))
         + sorted((ROOT / "examples").glob("torch_*.py"))
         + [ROOT / "chip_smoke.py"])
BANNED = ("jax", "jaxlib", "repro")


def _module_parts(path: Path):
    """Package parts of the module ``path`` (``repro_torch.ann`` for
    ``src/repro_torch/ann/ivf.py``); None outside the package."""
    try:
        rel = path.relative_to(PORT.parent)
    except ValueError:
        return None
    return list(rel.parts[:-1])


def _imported(tree: ast.AST, path: Path):
    """(line, absolute module name) of every import in ``tree``."""
    pkg = _module_parts(path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.lineno, node.module or ""
                continue
            if pkg is None or node.level > len(pkg):
                yield node.lineno, "<relative import past the package>"
                continue
            base = pkg[:len(pkg) - node.level + 1]
            yield node.lineno, ".".join(base + ([node.module]
                                                if node.module else []))


def _violations(path: Path, source=None):
    """Every banned import or precision setting in ``path`` (or in
    ``source``, judged as if it were the module at ``path``)."""
    source = path.read_text() if source is None else source
    tree = ast.parse(source, filename=str(path))
    bad = []
    for line, name in _imported(tree, path):
        top = name.split(".")[0]
        if top in BANNED or name.startswith("<"):
            bad.append(f"{path.name}:{line}: imports {name}")
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (isinstance(target, ast.Attribute)
                        and target.attr == "allow_tf32"
                        and not (isinstance(node.value, ast.Constant)
                                 and node.value.value is False)):
                    bad.append(f"{path.name}:{node.lineno}: allow_tf32 "
                               "set to something other than False")
        if (isinstance(node, ast.Call)
                and isinstance(node.func, (ast.Attribute, ast.Name))
                and getattr(node.func, "attr", getattr(node.func, "id", ""))
                == "set_float32_matmul_precision"):
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                bad.append(f"{path.name}:{node.lineno}: "
                           "set_float32_matmul_precision not 'highest'")
    return bad


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(ROOT)) for f in FILES])
def test_port_file_is_clean(path):
    assert not _violations(path)


@pytest.mark.parametrize("source,want", [
    ("import jax\n", "imports jax"),
    ("import jax.numpy as jnp\n", "imports jax.numpy"),
    ("from jaxlib import xla_client\n", "imports jaxlib"),
    ("import repro.ann.ivf\n", "imports repro.ann.ivf"),
    ("from repro.core import codecs\n", "imports repro.core"),
    ("from ...repro import api\n", "past the package"),
    ("import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n",
     "allow_tf32"),
    ("import torch\ntorch.backends.cudnn.allow_tf32 = flag\n", "allow_tf32"),
    ("import torch\ntorch.set_float32_matmul_precision('high')\n",
     "not 'highest'"),
    ("def f():\n    from jax import numpy\n", "imports jax"),
])
def test_the_check_catches(source, want):
    """Each banned form, in a module at ``src/repro_torch/ann/``, is
    reported (the check is not vacuous)."""
    found = _violations(PORT / "ann" / "mod.py", source)
    assert any(want in f for f in found), found


@pytest.mark.parametrize("source", [
    "from ..kernels import l2_dist\n",
    "from . import scan\n",
    "import torch\ntorch.backends.cuda.matmul.allow_tf32 = False\n",
    "import torch\ntorch.set_float32_matmul_precision('highest')\n",
    "import reprolib\n",
])
def test_the_check_passes_clean_forms(source):
    assert not _violations(PORT / "ann" / "mod.py", source)
