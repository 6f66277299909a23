"""The serving steps on a mesh for the dense configs (gemma3-1b, granite-20b,
minitron-4b, qwen2-72b, reduced) on 8 gloo ranks (CPU), against the
reference's jitted ``prefill_step`` / ``serve_step`` under its shardings
on 8 fake devices, on (2, 4) and (1, 8), at the LM serving tests' f32
bound (tests/_torch_dist_serve.py).  On (2, 4) gemma3's and granite's one
KV head does not divide the model axis, so their caches shard the slots
over "model" and decode runs flash-decoding over it; minitron's and
qwen2's four KV heads split over it.  On (1, 8) every cache shards its
slots over ("data", "model").  Also: gemma3's local ring of 64 slots
wrapping on a slot-sharded cache (the written slot moves from the last
model rank's block to the first's), the greedy pick's first maximum
across vocab shards, and an SP block with no valid slot contributing
nothing."""

import numpy as np

import _torch_dist_serve as S
from _torch_dist import mesh_shape_of, shard_slices
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

ARCHS = ("gemma3-1b", "granite-20b", "minitron-4b", "qwen2-72b")
WINDOW = 64     # reduced gemma3's sliding window

(runs, view, test_prefill_logits, test_decode_logits_and_tokens,
 test_cache_slices, test_sequence_sharded_decode_calls_sp,
 test_fresh_cache_has_local_shapes_only,
 test_one_rank_mesh_is_the_one_process_step,
 test_mesh_step_regathers_weights_changed_in_place) = S.serve_suite(
    ARCHS, extras=True)


def test_kv_layout_follows_the_heads(runs):
    for arch, heads in (("gemma3-1b", False), ("granite-20b", False),
                        ("minitron-4b", True), ("qwen2-72b", True)):
        ref, ranks = view(runs, arch, "2x4")
        for r in ranks:
            b, t, kv, _ = S.spec_of(r, "0/k" if arch != "gemma3-1b"
                                    else "0/global/k")
            assert b == ("data",)
            assert (kv, t) == (("model", None) if heads else (None, "model"))
            assert (r["sp_calls"] == 0) == heads
        _, ranks = view(runs, arch, "1x8")
        for r in ranks:
            assert S.spec_of(r, "0/k" if arch != "gemma3-1b"
                             else "0/global/k")[1] == ("data", "model")
            assert r["sp_calls"] > 0


def test_gemma3_ring_wraps_on_a_sequence_sharded_cache(runs):
    for mesh in ("2x4", "1x8"):
        ref, ranks = view(runs, "gemma3-1b", mesh)
        start, steps = int(ref["start"]), int(ref["steps"])
        assert start < WINDOW < start + steps
        written = {(start + i) % WINDOW for i in range(steps)}
        mesh_shape = mesh_shape_of(ranks)
        holders = set()
        for r in ranks:
            for key, at, got, spec in r["cache"]:
                if "locals" not in key or key.endswith("length"):
                    continue
                assert spec[1], (key, spec)
                was = S.ref_leaf(ref, "cache0", key, at)
                cut = shard_slices(spec, r["coords"], mesh_shape, was.shape)
                slots = range(WINDOW)[cut[1]]
                changed = {slots[i] for i in np.flatnonzero(
                    (got != was[cut]).any(axis=(0, 2, 3)))}
                assert changed == written & set(slots), (key, changed)
                if changed:
                    holders.add(slots.start)
        # the slots before the wrap and after it sit in different blocks
        assert len(holders) == 2


def test_greedy_pick_takes_the_first_max_across_vocab_shards(runs):
    for r in runs[1]:
        tie = r["tie"]
        np.testing.assert_array_equal(tie["pick"], tie["want"])
        # the constructed maxima of tests/_torch_dist.py::tie_pick at tp = 4
        assert list(tie["want"][:5]) == [70, 5, 63, 255, 2]
        assert tie["whole"].shape == (8, 256)
        assert tie["whole"].tobytes() == runs[1][0]["tie"]["whole"].tobytes()


def test_sp_block_with_no_valid_slot_contributes_nothing(runs):
    for r in runs[1]:
        e = r["empty_block"]
        assert e["out"].tobytes() == e["out_garbage"].tobytes()
        np.testing.assert_allclose(e["out"], e["dense"], rtol=0, atol=2e-5)
