"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``), each run as a real subprocess on the CPU at the
sizes of ``tests/test_examples_smoke.py``.

Every printed line that holds no time is equal: bits/id per codec, the
share of compact and "identical", container MB, the RAM ledger,
recall@10, bits/edge, nodes visited.  A line that holds a time is
dropped, except the quickstart's codec rows, whose ``search ms`` column
alone is masked.  ``train_embedder`` starts from other weights (the
port's init stream), so its run is held to its stages, a falling
training loss, bits/id below compact and a self-recall@1 at least the
reference's at the same arguments.

The reference examples run once per module, side by side, with
``JAX_PLATFORMS=cpu``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 420

QUICKSTART = ("--n", "3000", "--queries", "30", "--nlist", "32",
              "--graph-n", "400")
SERVE = {
    "ivf_pq_xla": ("--n", "3000", "--queries", "60", "--nlist", "32",
                   "--pq-m", "8", "--engine", "xla", "--cache-mb", "4"),
    "nsg": ("--n", "1200", "--queries", "40", "--spec", "NSG8,ids=roc",
            "--request-size", "2"),
}
EMBEDDER = ("--steps", "10", "--docs", "320")

REFERENCE = {"quickstart": ("quickstart.py", QUICKSTART),
             "embedder": ("train_embedder.py", EMBEDDER),
             **{f"serve_{k}": ("serve_ann.py", v) for k, v in SERVE.items()}}

# lines whose text holds a time (or counts that follow the batching clock)
TIMED = ("throughput:", "micro-batching:", "id resolve overhead:",
         "sharded serving:", "degraded mode:")
CODEC_ROW = re.compile(r"^(\s*IVF\S+\s+\S+\s+\S+)\s+\S+(\s+\S+)$")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _start(script, args):
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(ROOT))


def _finish(proc, script):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, (
        f"{script} failed\nstdout:\n{out}\nstderr:\n{err}")
    return out


def _torch(script, *args):
    name = f"torch_{script}"
    return _finish(_start(name, (*args, "--device", "cpu")), name)


@pytest.fixture(scope="module")
def reference():
    """Each reference example's stdout, by key of ``REFERENCE``."""
    procs = {k: _start(s, a) for k, (s, a) in REFERENCE.items()}
    return {k: _finish(p, REFERENCE[k][0]) for k, p in procs.items()}


def _untimed(out):
    """The lines of ``out`` that hold no time (module docstring)."""
    lines = []
    for line in out.splitlines():
        if line.strip().startswith(TIMED):
            continue
        lines.append(CODEC_ROW.sub(r"\1 <ms>\2", line))
    return lines


def test_untimed_masks_only_times():
    out = ("                 IVF32,ids=roc     6.15     51.2%      0.264"
           "      True\nthroughput:           2,737 QPS (0.37 ms/query)\n"
           "recall@10 (vs exact): 0.393")
    assert _untimed(out) == [
        "                 IVF32,ids=roc     6.15     51.2% <ms>      True",
        "recall@10 (vs exact): 0.393"]


def test_quickstart_equals_reference(reference):
    out = _torch("quickstart.py", *QUICKSTART)
    assert "compression is lossless" in out
    assert "bit-identical results" in out
    assert "same search API" in out
    assert _untimed(out) == _untimed(reference["quickstart"])


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serve_ann_equals_reference(reference, case):
    out = _torch("serve_ann.py", *SERVE[case])
    assert "recall@10" in out
    assert "RAM ledger" in out
    assert _untimed(out) == _untimed(reference[f"serve_{case}"])


def _self_recall(out):
    return float(re.search(r"self-recall@1: ([\d.]+)", out).group(1))


def test_train_embedder_end_to_end(reference):
    out = _torch("train_embedder.py", *EMBEDDER)
    for stage in ("[1/4] training", "[2/4] embedding 320 documents",
                  "[3/4] building RetrievalIndex", "[4/4] querying"):
        assert stage in out
    first, last = map(float, re.search(
        r"\[train\] done: loss ([\d.]+) -> ([\d.]+)", out).groups())
    assert last < first
    bits, compact = map(float, re.search(
        r"ids: ([\d.]+) bits/id \(compact would be (\d+)\)", out).groups())
    assert bits < compact
    assert "embeddings: (320, 64)" in out
    assert _self_recall(out) >= _self_recall(reference["embedder"])
