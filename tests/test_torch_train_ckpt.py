"""The port's token pipeline, checkpoint and training driver (CPU).

* ``TokenPipeline`` batches and ``make_tokens`` equal to the reference's;
* ``params_to_jax`` is the exact inverse of ``params_from_jax`` for every
  reduced config (structure, dtypes, shapes, bits);
* a checkpoint of ``(params, OptState)`` written by the port restores
  through ``repro.checkpoint.restore_checkpoint`` into the reference's
  template with equal keys, shapes and arrays, and the reverse;
* the partial-write fallback;
* ``launch.train.main(["--device", "cpu", ...])``: the loss of reduced
  gemma3 falls by more than 0.3 over 40 steps (the reference's
  criterion), and a run stopped at step 20 and resumed equals the
  unbroken 30-step run exactly (losses and final parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RCfg
from repro.checkpoint import checkpoint as RK
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.data.synthetic import make_tokens as ref_make_tokens
from repro.models import encdec as RE
from repro.models import transformer as RT
from repro.train import optim as RO
import repro_torch.configs as PCfg
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.data import TokenPipeline, make_tokens
from repro_torch.launch.train import main as train_main
from repro_torch.models import build, params_from_jax
from repro_torch.models.convert import params_to_jax
from repro_torch.train import optim as PO

from _torch_train import torch_one_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

PIPES = [dict(seed=0, step=0, n_shards=1, shard=0),
         dict(seed=3, step=17, n_shards=1, shard=0),
         dict(seed=3, step=5, n_shards=2, shard=1),
         dict(seed=11, step=1000, n_shards=4, shard=2)]


@pytest.mark.parametrize("kw", PIPES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_pipeline_batches_equal(kw):
    step = kw["step"]
    args = dict(vocab=300, batch=8, seq_len=24, seed=kw["seed"],
                n_shards=kw["n_shards"], shard=kw["shard"])
    want = RefPipeline(**args).batch_at(step)
    got = TokenPipeline(**args).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        assert np.array_equal(got[k], want[k])
    pipe = TokenPipeline(**args).restore({"seed": kw["seed"], "step": step})
    it = iter(pipe)
    assert np.array_equal(next(it)["tokens"], want["tokens"])
    assert np.array_equal(next(it)["labels"],
                          RefPipeline(**args).batch_at(step + 1)["labels"])
    assert pipe.state() == {"seed": kw["seed"], "step": step + 1}


@pytest.mark.parametrize("seed,vocab", [(0, 256), (5, 50304)])
def test_make_tokens_equal(seed, vocab):
    got, want = make_tokens(5000, vocab, seed), ref_make_tokens(5000, vocab,
                                                                seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _ref_tree(arch):
    rc = RCfg.reduced(RCfg.get_config(arch))
    init = RE.init_encdec if rc.encoder_decoder else RT.init_decoder
    return rc, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), rc))


@pytest.mark.parametrize("arch", RCfg.ARCH_IDS)
def test_params_to_jax_inverts_params_from_jax(arch):
    _, tree = _ref_tree(arch)
    cfg = PCfg.reduced(PCfg.get_config(arch))
    back = params_to_jax(cfg, params_from_jax(cfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.int32), b.view(np.int32))


def _states(arch):
    """The same (params, OptState) in both packages: the reference's
    weights, seeded moments, step 7."""
    rc, tree = _ref_tree(arch)
    cfg = PCfg.reduced(PCfg.get_config(arch))
    rng = np.random.default_rng(2)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    nu = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), tree)
    params = params_from_jax(cfg, tree, device="cpu")
    def named(t):
        return {n: p.detach().clone() for n, p in params_from_jax(
            cfg, t, device="cpu").named_parameters()}

    port = (params, PO.OptState(mu=named(mu), nu=named(nu),
                                step=torch.tensor(7, dtype=torch.int32)))
    ref = (tree, RO.OptState(mu=mu, nu=nu, step=np.int32(7)))
    return cfg, port, ref


def _port_template(cfg):
    params = build(cfg, device="cpu").init(0)
    return params, PO.init_opt(params)


def _flat(state):
    return {k: np.asarray(v) for k, v in RK._flatten(state).items()}


@pytest.mark.parametrize("arch", RCfg.ARCH_IDS)
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    cfg, port, ref = _states(arch)
    save_checkpoint(tmp_path, 7, port, extra={"pipeline": {"seed": 0,
                                                           "step": 7}})
    template = jax.tree.map(jnp.zeros_like, ref)
    restored, manifest = RK.restore_checkpoint(tmp_path, template)
    assert manifest["step"] == 7 and manifest["extra"]["pipeline"]["step"] == 7
    got, want = _flat(restored), _flat(ref)
    assert sorted(got) == sorted(want) == manifest["keys"]
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k],
                                                                want[k]), k
    if arch == "gemma3-1b":
        assert len(want) == 61
        assert want["0/segments/0/global/attn/wk/kernel"].shape == (2, 64, 16)
        assert "1/.mu/segments/0/global/attn/wk/kernel" in want
        assert "1/.step" in want


@pytest.mark.parametrize("arch", RCfg.ARCH_IDS)
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    cfg, port, ref = _states(arch)
    RK.save_checkpoint(tmp_path, 9, jax.tree.map(jnp.asarray, ref))
    (params, opt), manifest = restore_checkpoint(tmp_path,
                                                 _port_template(cfg))
    assert manifest["step"] == 9 and int(opt.step) == 7
    assert opt.step.dtype == torch.int32
    for n, p in port[0].named_parameters():
        assert torch.equal(dict(params.named_parameters())[n], p), n
        assert torch.equal(opt.mu[n], port[1].mu[n]), n
        assert torch.equal(opt.nu[n], port[1].nu[n]), n


def test_restore_checks_shapes(tmp_path):
    cfg, port, _ = _states("gemma3-1b")
    save_checkpoint(tmp_path, 1, port)
    other = PCfg.reduced(PCfg.get_config("granite-20b"))
    with pytest.raises((ValueError, KeyError)):
        restore_checkpoint(tmp_path, _port_template(other))


def test_checkpoint_survives_partial_write(tmp_path):
    cfg, port, _ = _states("gemma3-1b")
    save_checkpoint(tmp_path, 10, port)
    broken = tmp_path / "step_00000020"
    broken.mkdir()
    (broken / "arrays.npz").write_bytes(b"garbage")
    (tmp_path / "LATEST").write_text("20")
    assert latest_step(tmp_path) == 10
    (params, _), manifest = restore_checkpoint(tmp_path, _port_template(cfg))
    assert manifest["step"] == 10
    assert torch.equal(params.embed.table, port[0].embed.table)


def test_train_loss_decreases():
    losses = train_main(["--arch", "gemma3-1b", "--reduced", "--steps", "40",
                         "--batch", "4", "--seq", "64", "--lr", "1e-3",
                         "--device", "cpu"])
    assert len(losses) == 40
    assert losses[-1] < losses[0] - 0.3


def test_train_crash_and_resume_is_exact(tmp_path):
    """30 steps with a checkpoint every 10, against a run stopped after 20
    and resumed from its checkpoint: equal losses and equal step-30
    checkpoints, bit for bit."""
    full_dir, crash_dir = tmp_path / "full", tmp_path / "crash"
    args = ["--arch", "gemma3-1b", "--reduced", "--batch", "4", "--seq",
            "32", "--ckpt-every", "10", "--device", "cpu", "--steps", "30"]
    full = train_main(args + ["--ckpt-dir", str(full_dir), "--resume",
                              "never"])
    first = train_main(args + ["--ckpt-dir", str(crash_dir), "--resume",
                               "never", "--stop-after", "20"])
    assert len(first) == 20 and latest_step(crash_dir) == 20
    resumed = train_main(args + ["--ckpt-dir", str(crash_dir)])
    assert len(resumed) == 10
    assert np.array_equal(np.asarray(first + resumed), np.asarray(full))
    with np.load(full_dir / "step_00000030" / "arrays.npz") as a, \
            np.load(crash_dir / "step_00000030" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
