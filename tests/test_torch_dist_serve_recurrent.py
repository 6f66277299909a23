"""The serving steps on a mesh for the recurrent and encoder-decoder
configs (zamba2-2.7b, xlstm-1.3b, whisper-medium, reduced) on 8 gloo ranks
(CPU), against the reference's jitted ``prefill_step`` / ``serve_step``
under its shardings on 8 fake devices, on (2, 4) and (1, 8), at the LM
serving tests' f32 bound (tests/_torch_dist_serve.py).  The mesh
prefill splits the Mamba2, mLSTM and sLSTM mixers by head over the model
axis where their heads divide it (zamba2's 8 on both meshes, xlstm's 4
on (2, 4)), and xlstm's over groups of two model ranks a head on (1,
8) (each rank its head's q / k / gates and sLSTM recurrence whole, its
half of the head's v / z / output channels), as the train step does.  The decode keeps
the Mamba2 conv windows and states and the mLSTM / sLSTM states where
the rules shard them (the last dimension the model axis divides, not the
heads): each rank updates its slice and the readouts are reduced over
"model" (tests/test_torch_dist_decode_mixers.py holds each mixer alone).
zamba2's shared attention and
whisper's self-attention decode on KV heads (2, 4) or slots (1, 8) split
over the model axis; whisper's memory is filled in its shards by the
mesh prefill of the encoder and read by the cross-attention in the same
layout."""

import _torch_dist_serve as S
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

ARCHS = ("zamba2-2.7b", "xlstm-1.3b", "whisper-medium")

(runs, view, test_prefill_logits, test_decode_logits_and_tokens,
 test_cache_slices, test_sequence_sharded_decode_calls_sp,
 test_fresh_cache_has_local_shapes_only,
 test_one_rank_mesh_is_the_one_process_step,
 test_mesh_step_regathers_weights_changed_in_place) = S.serve_suite(ARCHS)


def test_recurrent_states_are_stored_sharded_on_the_model_axis(runs):
    for mesh in ("2x4", "1x8"):
        for arch, keys in (("zamba2-2.7b", ("0/mambas/state",
                                             "0/mambas/conv")),
                           ("xlstm-1.3b", ("0/mlstms/C", "0/slstm/c",
                                           "0/slstm/h"))):
            _, ranks = view(runs, arch, mesh)
            for r in ranks:
                for key in keys:
                    spec = S.spec_of(r, key)
                    assert spec[-1] == "model", (arch, key, spec)
                    assert spec[0] == (("data",) if mesh == "2x4" else None)


def test_whisper_memory_sharded_as_its_self_cache(runs):
    for mesh, want in (("2x4", (None, ("data",), None, "model", None)),
                       ("1x8", (None, None, ("data", "model"), None,
                                None))):
        _, ranks = view(runs, "whisper-medium", mesh)
        for r in ranks:
            assert S.spec_of(r, "mem_k") == want
            assert S.spec_of(r, "self_kv/k") == want[1:]
