"""The port's mixture of experts against the reference (CPU, f32).

``moe_capacity`` exactly; the routing (expert ids, the stable sort's
order, ``keep``, ``slot``, counts) bit for bit on the same bf16 logits,
built to tie at the k-th edge, and the gates within 1e-6 relative (a
few f32 ulp: the two softmaxes round differently in the last bit);
``moe_apply`` and its aux loss at reduced olmoe and llama4 sizes where
assignments are dropped;
the reduced models' logits, the decode against the reference's decode
and the serving loop's tokens; ``count_params`` (total and active) of
the full configs.

Tolerance for outputs and logits: ``atol = 1e-4 * max(1, max|want|)``,
``rtol = 1e-4`` (f32 products summed in another order); aux losses
within 1e-6 relative; tokens, routing and counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import moe as RM
from repro.models.model import count_params as ref_count_params
from repro.models.model import model_flops as ref_model_flops
import repro_torch.configs as PC
from repro_torch.models import count_params, model_flops
from repro_torch.models import moe as PM
from repro_torch.models.convert import _load

from _torch_lm import Case, close, configs, hold_decode, hold_serve, \
    port_decode, t

jax.config.update("jax_platforms", "cpu")

MOE = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]


def ref_route(logits, k, E, C):
    """The routing steps of ``repro.models.moe.moe_apply`` (moe.py:59-82),
    as they stand there, on given f32 logits."""
    T = logits.shape[0]
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    flat_expert = expert_ids.reshape(-1)
    order = jnp.argsort(flat_expert)
    sorted_expert = flat_expert[order]
    counts = jnp.bincount(sorted_expert, length=E)
    starts = jnp.cumsum(counts) - counts
    pos_in_expert = jnp.arange(T * k) - starts[sorted_expert]
    keep = pos_in_expert < C
    slot = sorted_expert * C + jnp.where(keep, pos_in_expert, 0)
    return dict(expert_ids=expert_ids, gate=gate_vals, order=order,
                keep=keep, slot=slot, counts=counts)


def hold_routing(got: PM.Routing, want):
    for name in ("expert_ids", "order", "keep", "slot", "counts"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(want[name])), name
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want["gate"]),
                               rtol=1e-6, atol=0)


def tied_logits(T, E, seed):
    """bf16-rounded logits on a coarse grid: many exact ties, at the k-th
    edge too."""
    r = np.random.default_rng(seed)
    x = np.round(r.standard_normal((T, E)) * 3) / 3
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float()


# -- capacity and routing ------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_moe_capacity_equals_the_reference(arch, cf):
    for reduce in (False, True):
        ref = dataclasses.replace(RC.get_config(arch), capacity_factor=cf)
        port = dataclasses.replace(PC.get_config(arch), capacity_factor=cf)
        if reduce:
            ref, port = RC.reduced(ref), PC.reduced(port)
        for T in list(range(1, 40)) + [64, 100, 128, 257, 512, 4096]:
            assert PM.moe_capacity(T, port) == RM.moe_capacity(T, ref)
    # below 8 tokens the capacity exceeds the tokens
    assert PM.moe_capacity(2, PC.get_config("olmoe-1b-7b")) == 8


@pytest.mark.parametrize("T,E,k,C", [(512, 64, 8, 80), (128, 8, 2, 40),
                                     (96, 16, 1, 8), (4, 64, 8, 8)])
def test_routing_is_bit_equal_on_tied_bf16_logits(T, E, k, C):
    logits = tied_logits(T, E, seed=T + E)
    probs = torch.softmax(logits, -1).sort(-1, descending=True).values
    edge_ties = int((probs[:, k - 1] == probs[:, k]).sum())
    assert edge_ties > 0
    got = PM.moe_route(logits, k, C)
    want = ref_route(logits.numpy(), k, E, C)
    hold_routing(got, want)
    if T * k > E * C:
        assert not bool(got.keep.all())


def test_routing_breaks_ties_toward_the_lower_expert():
    logits = torch.zeros((3, 6))
    logits[1, 4] = logits[1, 2] = 1.0
    logits[2] = torch.tensor([0.5, 1.0, 1.0, 0.5, 1.0, 0.0])
    got = PM.moe_route(logits, 2, 8)
    assert got.expert_ids.tolist() == [[0, 1], [2, 4], [1, 2]]
    hold_routing(got, ref_route(logits.numpy(), 2, 6, 8))


# -- the layer -----------------------------------------------------------------

class Layer:
    """One reduced MoE layer in both packages and T = 2 x 64 tokens.  The
    tokens share a mean of 0.5, so the router favours a few experts and
    assignments past the capacity (40 for olmoe, 20 for llama4) drop."""

    def __init__(self, arch):
        self.ref_cfg, self.cfg = configs(arch)
        tree = jax.tree.map(np.asarray, RM.init_moe(jax.random.PRNGKey(5),
                                                    self.ref_cfg))
        self.tree = tree
        self.mod = PM.MoE(self.cfg)
        with torch.no_grad():
            assert _load(self.mod, tree) == sum(
                a.size for a in jax.tree.leaves(tree))
        self.x = np.random.default_rng(6).standard_normal(
            (2, 64, self.cfg.d_model)).astype(np.float32) + 0.5

    def logits(self):
        with torch.no_grad():
            return t(self.x).reshape(-1, self.cfg.d_model) \
                @ self.mod.router.kernel

    def route(self):
        C = PM.moe_capacity(self.x.shape[0] * self.x.shape[1], self.cfg)
        return PM.moe_route(self.logits(), self.cfg.experts_per_token, C)


@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_with_drops_equals_the_reference(arch):
    layer = Layer(arch)
    dropped = int((~layer.route().keep).sum())
    assert dropped > 0
    want, want_aux = RM.moe_apply(layer.tree, layer.x, layer.ref_cfg)
    with torch.no_grad():
        got, aux = PM.moe_apply(layer.mod, t(layer.x), layer.cfg)
    assert got.shape == layer.x.shape and got.dtype == torch.float32
    close(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_routes_as_the_reference(arch):
    """The reference's routing of the port's router logits equals the
    port's (these logits are the layer's own, in f32)."""
    layer = Layer(arch)
    C = PM.moe_capacity(128, layer.cfg)
    hold_routing(layer.route(), ref_route(
        layer.logits().numpy(), layer.cfg.experts_per_token,
        layer.cfg.n_experts, C))


def test_moe_apply_in_bf16_keeps_the_dtype():
    """bf16 activations stay bf16 (the router's logits and the aux loss
    are f32); the bf16 logits route otherwise than the f32 ones, so the
    output is not held against the f32 layer."""
    layer = Layer("olmoe-1b-7b")
    with torch.no_grad():
        got, aux = PM.moe_apply(layer.mod, t(layer.x).to(torch.bfloat16),
                                layer.cfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert got.shape == layer.x.shape
    assert bool(torch.isfinite(got.float()).all())


# -- the model -----------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def case(request):
    return Case(request.param)


def test_decoder_apply_logits_and_aux(case):
    got, aux = case.apply()
    assert got.shape == (2, 64, case.cfg.padded_vocab)
    close(got, case.ref_logits)
    assert aux > 0
    np.testing.assert_allclose(aux, case.ref_aux, rtol=1e-6)


def test_decode_equals_the_reference_decode(case):
    """64 steps, the first 32 tokens fed, then each package's own greedy
    tokens (a step routes 2 tokens: capacity 8, nothing dropped)."""
    hold_decode(case, feed=32)


def test_decode_equals_prefill_when_nothing_drops():
    """With ``capacity_factor = E / k`` the prefill's capacity is T: no
    assignment is dropped, and the decode equals the prefill (the check
    the card repeats at olmoe's full width)."""
    c = Case("olmoe-1b-7b", capacity_factor=4.0)
    assert PM.moe_capacity(128, c.cfg) == 128
    close(port_decode(c, feed=64), c.apply()[0])
    close(c.ref_logits, c.apply()[0])


@pytest.mark.parametrize("arch", MOE)
def test_serving_loop_tokens_equal_the_reference(arch):
    hold_serve(arch)


def test_serving_loop_serves_the_weights_own_config():
    """Handed weights, the loop serves their config (llama4 cut to one
    layer, as the card's run cuts it in depth); another arch's raises."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.transformer import init_decoder

    _, cfg = configs("llama4-scout-17b-a16e", n_layers=1)
    params = init_decoder(0, cfg, device="cpu")
    argv = ["--arch", cfg.name, "--batch", "2", "--prompt-len", "3",
            "--gen", "4", "--device", "cpu"]
    got = serve_main(argv, params=params)
    assert got.shape == (4, 2)
    assert np.array_equal(serve_main(argv, params=params), got)
    argv[1] = "olmoe-1b-7b"
    with pytest.raises(ValueError, match="parameters are"):
        serve_main(argv, params=params)


@pytest.mark.parametrize("arch", MOE)
def test_count_params_total_and_active_equal_the_reference(arch):
    port, ref = PC.get_config(arch), RC.get_config(arch)
    for active in (False, True):
        assert count_params(port, active) == ref_count_params(ref, active)
    assert count_params(port, True) < count_params(port)
    for shape in PC.SHAPES:
        assert model_flops(port, PC.SHAPES[shape]) == \
            ref_model_flops(ref, RC.SHAPES[shape])


def test_olmoe_counts_its_published_sizes():
    cfg = PC.get_config("olmoe-1b-7b")
    assert count_params(cfg) == 6_816_073_728
    assert count_params(cfg, active_only=True) == 1_178_929_152
