"""Activation recomputation (``repro_torch.models.remat``) in the port's
train steps, on the CPU.

* For each of the ten reduced configs (f32, weights drawn from seed 0,
  zamba2's ``lora_b`` drawn non-zero), the loss, ce, the MoE aux and
  every gradient under ``remat_policy`` "full" and "dots" equal the run
  without recomputation **bit for bit**: recomputing runs the same ops on
  the same inputs.
* The same inside the sharded step (``sharded_loss_and_grads``) on four
  gloo ranks on a (2, 2) mesh, for gemma3 and olmoe, where the recomputed
  blocks issue their model-axis collectives again (counted in
  ``compat.APART["recompute"]``, the same on every rank).
* One train step under "dots" against the reference's jitted step with
  ``remat_policy="dots"``, at the train-step tests' bounds
  (tests/_torch_train.py: loss and ce within 1e-5 relative, each gradient
  within 1e-4 of its leaf's max, ...), for three configs.
* Under "dots" the recomputation of one super-block runs again exactly
  its batched products (attention, MoE experts, the SSD and sLSTM
  products) and none of its products with no batch dimensions (one a
  ``Dense`` weight of the block but Mamba2's elementwise conv kernel, two
  for zamba2's LoRA adapter), whose outputs the forward kept.
* ``FlopCounterMode``'s FLOPs of a loss and its gradients order as
  none < "dots" < "full".
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils.flop_counter import FlopCounterMode

from _torch_dist import run_ranks
from _torch_lm import configs
from _torch_train import (Runs, batch_for, hold_step,
                          torch_one_thread)  # noqa: F401  (autouse)
from repro_torch.configs import ARCH_IDS
from repro_torch.distributed import compat
from repro_torch.models import build, layers
from repro_torch.models import transformer as T
from repro_torch.models.remat import remat_call
from repro_torch.train import step as PS

POLICIES = ("full", "dots")


def _model(arch, policy="full"):
    cfg = dataclasses.replace(configs(arch)[1], remat_policy=policy)
    model = build(cfg, device="cpu")
    params = model.init(0)
    if cfg.family == "hybrid":          # the reference's lora_b is 0 at init
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for seg in params.segments:
                for sup in seg:
                    sup.lora_b.normal_(0.0, 0.02, generator=gen)
    return cfg, model, params


def _batch(cfg):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch_for(cfg, 0).items()}


def _loss_and_grads(cfg, params, batch, remat):
    model = build(cfg, device="cpu")
    named = list(params.named_parameters())
    _, _, aux = PS._loss_sums(model, params, batch, cfg, remat=remat)
    loss, ce = PS.loss_fn(model, params, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return dict(loss=loss.detach(), ce=ce.detach(), aux=aux.detach(),
                grads={n: g for (n, _), g in zip(named, grads)})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_equals_no_remat_bit_for_bit(arch):
    cfg, _, params = _model(arch)
    batch = _batch(cfg)
    plain = _loss_and_grads(cfg, params, batch, remat=False)
    for policy in POLICIES:
        got = _loss_and_grads(dataclasses.replace(cfg, remat_policy=policy),
                              params, batch, remat=True)
        for key in ("loss", "ce", "aux"):
            assert torch.equal(got[key], plain[key]), (policy, key)
        for n, g in plain["grads"].items():
            h = got["grads"][n]
            assert (g is None) == (h is None), (policy, n)
            assert g is None or torch.equal(h, g), (policy, n)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return run_ranks("remat_sharded", 4, tmp_path_factory.mktemp("remat"),
                     ("gemma3-1b", "olmoe-1b-7b"), 4, 32)


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
def test_sharded_remat_equals_no_remat_on_gloo_ranks(sharded, arch):
    for rank in sharded:
        runs = rank[arch]
        plain = runs["none"]
        assert plain["recomputed"] == {}
        for policy in POLICIES:
            got = runs[policy]
            for key in ("loss", "ce"):
                assert np.array_equal(got[key], plain[key]), (policy, key)
            for n, g in plain["grads"].items():
                assert np.array_equal(got["grads"][n], g), (policy, n)
            calls = got["recomputed"]
            assert calls["model:all_reduce"]["calls"] > 0, (policy, calls)
    for policy in POLICIES:     # every rank recomputes the same collectives
        counts = [{k: (v["calls"], v["bytes"])
                   for k, v in rank[arch][policy]["recomputed"].items()}
                  for rank in sharded]
        assert all(c == counts[0] for c in counts), (policy, counts)


_DOTS = Runs(changes={a: dict(remat_policy="dots") for a in ARCH_IDS})


@pytest.mark.parametrize("arch", ["qwen2-72b", "olmoe-1b-7b",
                                  "whisper-medium"])
def test_dots_step_matches_the_reference(arch):
    case, got, want = _DOTS(arch)
    assert case.cfg.remat_policy == case.ref_cfg.remat_policy == "dots"
    hold_step(got, want)


_aten = torch.ops.aten
_PRODUCTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default)


class _Products(TorchDispatchMode):
    """The output shapes of the products that run in the forward pass, and
    of those that run again while a checkpointed block is recomputed in
    the backward pass (not the gradients' own products)."""

    def __init__(self):
        super().__init__()
        self.forward, self.recomputed, self.backward = [], [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCTS:
            if not self.backward:
                self.forward.append(tuple(out.shape))
            elif "recompute" in compat._APART.get():
                self.recomputed.append(tuple(out.shape))
        return out


def _dense_weights(module):
    """The ``Dense`` weights of ``module`` that enter a product: all but
    Mamba2's depthwise ``conv`` kernel, which is applied elementwise (as
    in the reference)."""
    return sum(isinstance(m, layers.Dense) and not name.endswith("conv")
               for name, m in module.named_modules())


@pytest.mark.parametrize("arch", ["qwen2-72b", "gemma3-1b", "olmoe-1b-7b",
                                  "zamba2-2.7b", "xlstm-1.3b"])
def test_dots_keeps_exactly_the_products_without_batch_dims(arch):
    cfg, _, params = _model(arch, "dots")
    (kind, _, _), seg = T.segments_for(cfg)[0], params.segments[0]
    sup = seg[0]
    B, S = 2, 32
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2), requires_grad=True)
    positions = torch.arange(S)[None].expand(B, S)
    expected = _dense_weights(sup)
    if kind == "mamba_hybrid":      # the shared block and the LoRA adapter
        expected += _dense_weights(params.shared) + 2
    seen = _Products()
    with set_checkpoint_early_stop(False), seen:
        out, _ = remat_call(cfg, T._apply_super, kind, sup, x, positions,
                            cfg, params.shared)
        seen.backward = True
        out.float().square().sum().backward()
    # recomputed: every batched product again (3-D outputs), no projection
    assert seen.recomputed, arch
    assert all(len(s) == 3 for s in seen.recomputed), seen.recomputed
    batched = [s for s in seen.forward if len(s) == 3]
    assert sorted(seen.recomputed) == sorted(batched), arch
    # kept: one product a Dense weight (2-D outputs: the leading dims
    # folded), each run once in the forward and not again
    kept = [s for s in seen.forward if len(s) == 2]
    assert all(s[0] in (B * S,) for s in kept), kept
    assert len(kept) + len(batched) == len(seen.forward)
    assert len(kept) == expected, (len(kept), expected)


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
def test_flops_order_none_dots_full(arch):
    cfg, _, params = _model(arch)
    batch = _batch(cfg)
    flops = {}
    for policy in ("none",) + POLICIES:
        c = dataclasses.replace(cfg, remat_policy="full" if policy == "none"
                                else policy)
        counter = FlopCounterMode(display=False)
        with counter:
            _loss_and_grads(c, params, batch, remat=policy != "none")
        flops[policy] = counter.get_total_flops()
    assert flops["none"] < flops["dots"] < flops["full"], flops
