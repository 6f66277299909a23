"""The serving steps on a mesh for the MoE and vision configs (olmoe-1b-7b,
llama4-scout-17b-a16e, qwen2-vl-7b, reduced) on 8 gloo ranks (CPU),
against the reference's jitted ``prefill_step`` / ``serve_step`` under
its shardings on 8 fake devices, on (2, 4) and (1, 8), at the LM serving
tests' f32 bound (tests/_torch_dist_serve.py).  Each model rank runs its
experts of the 8; the MoE layers route over the whole batch (the prefill's
256 tokens, a decode step's 8), so the drops and slots are the
reference's; qwen2-vl decodes from embeddings with M-RoPE positions.  On
(2, 4) the four KV heads split over "model"; on (1, 8) the slots shard
over ("data", "model")."""

import _torch_dist_serve as S
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "qwen2-vl-7b")

(runs, view, test_prefill_logits, test_decode_logits_and_tokens,
 test_cache_slices, test_sequence_sharded_decode_calls_sp,
 test_fresh_cache_has_local_shapes_only,
 test_one_rank_mesh_is_the_one_process_step,
 test_mesh_step_regathers_weights_changed_in_place) = S.serve_suite(ARCHS)


def test_kv_heads_split_on_two_by_four(runs):
    for arch in ARCHS:
        _, ranks = view(runs, arch, "2x4")
        for r in ranks:
            assert S.spec_of(r, "0/k") == (("data",), None, "model", None)
            assert r["sp_calls"] == 0
