"""The reference's distribution layer on 8 fake CPU devices (run as a
script by tests/_torch_dist.py::start_reference with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``); writes one
``.npz``.

    python tests/_torch_dist_ref.py sp OUT.npz
    python tests/_torch_dist_ref.py pp OUT.npz
    python tests/_torch_dist_ref.py train OUT.npz ARCH CKPT_DIR [COMPRESS
        [MESHES]]

``sp``: ``make_sp_decode`` on a 4-device ``model`` mesh at the reference
test's sizes (``tests/test_distributed.py::test_sp_decode_matches_dense``,
its seed) and with ``NVALID`` valid slots.  ``pp``: ``pipeline_apply`` on
a 4-device ``pod`` mesh, the reference test's 4 stages x 8 microbatches
of ``tanh(x @ w)``.  ``train``: reduced ``ARCH`` from ``init_decoder`` on
``PRNGKey(0)`` (saved to ``CKPT_DIR`` by the reference's
``save_checkpoint``, whence the port reads it; ``init_encdec`` for
whisper), one batch of the reference's ``TokenPipeline`` (``B`` x
``S``; whisper's ``frames`` and qwen2-vl's ``embeddings`` seeded by
numpy, its M-RoPE ``positions`` ``arange(S)``), and on each
``("data", "model")`` mesh of ``MESHES`` (comma-separated, ``2x4`` by
default), under ``param_shardings`` / ``batch_shardings`` as
tests/test_distributed.py runs it: the jitted gradients of ``loss_fn``
and one jitted ``train_step``, with the int8 gradient compression where
``COMPRESS`` is 1 (the arrays gathered, each key under its mesh's name:
``2x4/grads/<path>``, ``2x4/params/<path>``, ``2x4/mu/<path>``,
``2x4/nu/<path>``, ``2x4/metrics/<name>``), ``batch/<key>``, and
``drops``, the MoE assignments the whole batch's routing drops (an
unsharded run of ``loss_fn`` whose MoE layers report them).

    python tests/_torch_dist_ref.py serve OUT.npz ARCHS CKPT_ROOT [MESHES]

``serve``: for each reduced config of ``ARCHS`` (comma-separated; its
keys under ``<arch>/``, its weights saved as ``train`` saves them, to
``CKPT_ROOT/<arch>``), on each ``("data", "model")`` mesh of ``MESHES``
(``2x4,1x8`` by default):
``make_prefill_step`` jitted under ``param_shardings`` /
``batch_shardings`` on the batch of ``train`` without labels
(``<mesh>/prefill``, ``(B, V)``); then from ``cache0`` (the reference's
f32 decode cache of ``SERVE[arch]``'s ``max_len`` slots, every tensor
filled with seeded normals, every length ``start``; whisper's memory
filled by ``encdec_prefill_memory`` jitted under the cache's shardings)
placed by ``cache_shardings``, ``steps`` jitted ``make_serve_step`` calls
on seeded inputs (``feed/token/<i>``; qwen2-vl: ``feed/embedding/<i>``),
each jitted with the same step's ``decode_step`` logits
(``<mesh>/logits``, ``<mesh>/tokens``) and every input placed by
``jax.device_put`` first; the final cache gathered
(``<mesh>/cache/<path>``, ``cache0/<path>``: the path's keys joined by
``/``); ``max_len``, ``start``, ``steps``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint.checkpoint import save_checkpoint
from repro.configs import get_config, reduced
from repro.data.pipeline import TokenPipeline
from repro.distributed.pp import pipeline_apply
from repro.distributed.sharding import (batch_shardings, cache_shardings,
                                        param_shardings)
from repro.distributed.sp import make_sp_decode
from repro.launch.mesh import make_mesh_compat, use_mesh
from repro.models import encdec as RE
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.models.layers import dense
from repro.train import optim as RO
from repro.train import step as RS

SP = dict(B=2, T=64, H=8, KV=4, D=16, NVALID=50)
# the decode of tests/test_torch_dist_serve_*.py: gemma3's local ring of
# 64 slots wraps between ``start`` and ``start + steps``
SERVE = {"gemma3-1b": dict(max_len=96, start=60, steps=8)}
SERVE_DEFAULT = dict(max_len=32, start=12, steps=8)
PP = dict(n_stages=4, n_micro=8, mb=4, d=16)
B, S = 8, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def path_str(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                  getattr(p, "name", p))))
                    for p in path)


def flat(prefix, tree):
    return {f"{prefix}/{path_str(p)}": np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def sp():
    mesh = make_mesh_compat((4,), ("model",))
    rng = np.random.default_rng(3)
    b, t, h, kv, d = (SP[k] for k in ("B", "T", "H", "KV", "D"))
    q = jnp.asarray(rng.standard_normal((b, 1, h, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, t, kv, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, t, kv, d)), jnp.float32)
    valid = jnp.asarray(np.arange(t)[None, :] < SP["NVALID"]).repeat(b, 0)
    with use_mesh(mesh):
        out = make_sp_decode(mesh)(q, k, v, valid)
    return dict(q=q, k=k, v=v, valid=valid, out=out)


def pp():
    mesh = make_mesh_compat((4,), ("pod",))
    rng = np.random.default_rng(2)
    n, m, mb, d = (PP[k] for k in ("n_stages", "n_micro", "mb", "d"))
    ws = jnp.asarray(rng.standard_normal((n, d, d)) * 0.3)
    x = jnp.asarray(rng.standard_normal((m, mb, d)))
    piped = pipeline_apply(lambda w, h: jnp.tanh(h @ w), n, m, mesh,
                           axis="pod")
    with use_mesh(mesh):
        out = piped(ws, x)
    return dict(ws=ws, x=x, out=out)


def batch_for(cfg):
    """The step's batch: the pipeline's tokens, and numpy-seeded frames
    (whisper) or embeddings with M-RoPE positions (qwen2-vl)."""
    toks = TokenPipeline(vocab=cfg.vocab_size, batch=B, seq_len=S,
                         seed=0).batch_at(0)
    rng = np.random.default_rng(0)
    if cfg.encoder_decoder:
        batch = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(
                     np.float32),
                 "dec_tokens": toks["tokens"], "labels": toks["labels"]}
    elif cfg.frontend == "vision":
        batch = {"embeddings": rng.standard_normal((B, S, cfg.d_model))
                 .astype(np.float32),
                 "positions": np.broadcast_to(np.arange(S, dtype=np.int32)[
                     None, None], (3, B, S)).copy(),
                 "labels": toks["labels"]}
    else:
        batch = dict(toks)
    return {k: jnp.asarray(v) for k, v in batch.items()}


def train(arch, ckpt_dir, compress="0", meshes="2x4"):
    cfg = reduced(get_config(arch))
    model, step = RS.make_train_step(cfg, RO.AdamWConfig(**OPT),
                                     compress_grads=compress == "1")
    init = RE.init_encdec if cfg.encoder_decoder else RT.init_decoder
    params0 = init(jax.random.PRNGKey(0), cfg)
    save_checkpoint(ckpt_dir, 0, params0)
    batch0 = batch_for(cfg)
    out = {f"batch/{k}": v for k, v in batch0.items()}
    if cfg.n_experts:
        drops = []
        inner = RT.moe_apply

        def counted(p, x, cfg_):
            T = x.shape[0] * x.shape[1]
            logits = dense(p["router"], x.reshape(T, -1)).astype(jnp.float32)
            _, ids = jax.lax.top_k(jax.nn.softmax(logits, -1),
                                   cfg_.experts_per_token)
            counts = jnp.bincount(ids.reshape(-1), length=cfg_.n_experts)
            over = jnp.maximum(counts - RM.moe_capacity(T, cfg_), 0).sum()
            jax.debug.callback(lambda c: drops.append(int(c)), over)
            return inner(p, x, cfg_)

        RT.moe_apply = counted
        try:
            RS.loss_fn(model, params0, batch0, cfg)[0].block_until_ready()
            jax.effects_barrier()
        finally:
            RT.moe_apply = inner
        out["drops"] = np.asarray(drops)
    for name in meshes.split(","):
        shape = tuple(int(n) for n in name.split("x"))
        mesh = make_mesh_compat(shape, ("data", "model"))
        with use_mesh(mesh):
            shapes = jax.eval_shape(lambda: params0)
            params = jax.tree.map(jax.device_put, params0, param_shardings(
                shapes, mesh, cfg.n_experts))
            opt = RO.init_opt(params)
            batch = jax.tree.map(jax.device_put, batch0, batch_shardings(
                jax.eval_shape(lambda: batch0), mesh))
            grads = jax.jit(jax.grad(
                lambda p, b: RS.loss_fn(model, p, b, cfg)[0]))(params, batch)
            params, opt, metrics = jax.jit(step)(params, opt, batch)
        for key, tree in (("grads", grads), ("params", params),
                          ("mu", opt.mu), ("nu", opt.nu)):
            out.update(flat(f"{name}/{key}", tree))
        out.update({f"{name}/metrics/{k}": np.asarray(v)
                    for k, v in metrics.items()})
    return out


def serve_inputs(cfg):
    """``(cache0, feed)``: the decode's first cache (module docstring) and
    its ``steps`` inputs, each ``{"token": (B, 1)}`` or, for qwen2-vl,
    ``{"embedding": (B, 1, d)}``."""
    sv = SERVE.get(cfg.name, SERVE_DEFAULT)
    kw = {"mem_len": S} if cfg.encoder_decoder else {}
    cache = RE.init_encdec_cache(B, sv["max_len"], cfg, jnp.float32, **kw) \
        if cfg.encoder_decoder else RT.init_decoder_cache(
            B, sv["max_len"], cfg, jnp.float32)
    rng = np.random.default_rng(5)

    def fill(path, a):
        name = path_str(path)
        if name.endswith("length"):
            return jnp.full(a.shape, sv["start"], a.dtype)
        if name.startswith("mem_"):
            return a
        return jnp.asarray(rng.standard_normal(a.shape) * 0.5, a.dtype)

    cache = jax.tree_util.tree_map_with_path(fill, cache)
    rng = np.random.default_rng(6)
    if cfg.frontend == "vision":
        feed = [{"embedding": jnp.asarray(rng.standard_normal(
            (B, 1, cfg.d_model)), jnp.float32)} for _ in range(sv["steps"])]
    else:
        feed = [{"token": jnp.asarray(rng.integers(
            0, cfg.vocab_size, (B, 1)), jnp.int32)}
            for _ in range(sv["steps"])]
    return cache, feed


def serve(archs, ckpt_root, meshes="2x4,1x8"):
    out = {}
    for arch in archs.split(","):
        one = serve_one(arch, f"{ckpt_root}/{arch}", meshes)
        out.update({f"{arch}/{k}": v for k, v in one.items()})
    return out


def serve_one(arch, ckpt_dir, meshes):
    cfg = reduced(get_config(arch))
    init = RE.init_encdec if cfg.encoder_decoder else RT.init_decoder
    params0 = init(jax.random.PRNGKey(0), cfg)
    save_checkpoint(ckpt_dir, 0, params0)
    batch0 = batch_for(cfg)
    prompt0 = {k: v for k, v in batch0.items() if k != "labels"}
    cache0, feed = serve_inputs(cfg)
    out = {f"batch/{k}": v for k, v in batch0.items()}
    out.update(flat("cache0", cache0))
    out.update(SERVE.get(cfg.name, SERVE_DEFAULT))
    for i, inputs in enumerate(feed):
        out.update({f"feed/{k}/{i}": v for k, v in inputs.items()})
    model, prefill_step = RS.make_prefill_step(cfg)
    _, serve_step = RS.make_serve_step(cfg)
    for name in meshes.split(","):
        shape = tuple(int(n) for n in name.split("x"))
        mesh = make_mesh_compat(shape, ("data", "model"))
        with use_mesh(mesh):
            p_shard = param_shardings(jax.eval_shape(lambda: params0), mesh,
                                      cfg.n_experts)
            params = jax.device_put(params0, p_shard)
            b_shard = batch_shardings(jax.eval_shape(lambda: prompt0), mesh)
            logits = jax.jit(prefill_step, in_shardings=(p_shard, b_shard))(
                params, jax.device_put(prompt0, b_shard))
            c_shard = cache_shardings(jax.eval_shape(lambda: cache0), mesh,
                                      B, cfg.n_kv_heads)
            cache = jax.device_put(cache0, c_shard)
            if cfg.encoder_decoder:
                f_shard = batch_shardings(
                    {"frames": jax.eval_shape(lambda: batch0["frames"])},
                    mesh)["frames"]
                cache = jax.jit(
                    lambda p, f, c: RE.encdec_prefill_memory(p, cfg, f, c),
                    in_shardings=(p_shard, f_shard, c_shard),
                    out_shardings=c_shard)(
                    params, jax.device_put(batch0["frames"], f_shard), cache)
            i_shard = batch_shardings(jax.eval_shape(lambda: feed[0]), mesh)
            step = jax.jit(
                lambda p, c, i: (serve_step(p, c, i),
                                 model.decode_step(p, c, **i)[0][:, -1]),
                in_shardings=(p_shard, c_shard, i_shard),
                out_shardings=((None, c_shard), None))
            tokens, step_logits = [], []
            for inputs in feed:
                (tok, cache), lg = step(params, cache,
                                        jax.device_put(inputs, i_shard))
                tokens.append(tok)
                step_logits.append(lg)
        out[f"{name}/prefill"] = logits
        out[f"{name}/tokens"] = np.stack(tokens)
        out[f"{name}/logits"] = np.stack(step_logits)
        out.update(flat(f"{name}/cache", cache))
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    job, dest, *rest = sys.argv[1:]
    if jax.device_count() < 8:
        raise SystemExit(f"needs 8 fake devices, has {jax.device_count()}")
    res = dict(sp=sp, pp=pp, train=train, serve=serve)[job](*rest)
    np.savez(dest, **{k: np.asarray(v) for k, v in res.items()})
