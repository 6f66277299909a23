#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # full size: 1M vectors a path
    python3 chip_smoke.py --n 200000      # a quicker, smaller run

Phases, each printed with its seconds; any failure raises and the script
exits non-zero without the final ``ok`` line:

1. environment: card name, power limit and top SM clock (``nvidia-smi``),
   torch/CUDA;
2. build: every kernel of ``src/repro_torch/csrc`` compiled by ``nvcc``
   (all sources in parallel) into the git-ignored ``build/``, with each
   kernel's registers and spills and its count of tensor-core MMA
   instructions in the SASS (``cuobjdump -sass``); ``l2_dist`` and
   ``l2_top1`` must have some;
3. kernels vs plain: each CUDA kernel against its plain torch version on
   the card — ``seg_topk`` bit-equal to the plain version run on a CPU copy
   (rows with ties, +inf, signed zeros and NaN of both signs) at n = 16384
   and 32768 and every k the scan's retry reaches, plus k = n; ``pq_adc``
   bitwise equal to the j-ordered f32 sum, with its lookup count, and at
   m = 256 (PQ256x8: two j-ordered launches, the second adding onto the
   first's partial sums) bitwise equal to the plain version;
   ``l2_dist``, ``pq_adc`` and ``l2_top1`` inside the scan's
   ``rescore_eps`` band (``l2_top1`` at the IVF1024 and PQ8x8 k-means
   shapes; ``band_use`` is the largest error over the band); ``rans_decode``
   bit-equal to the plain version run on a CPU copy on ``gap_ans``'s
   quotient model at (L, rows) = (128, 8192), (16, 64) and (1024, 1024),
   with ``step_cycles`` (one step at the top SM clock); ``wt_rank`` on a
   2^24-bit random bitvector (too large for shared memory: the global
   route) — with CUDA-event times (short
   kernels from a CUDA graph's replay, so the host's cost of each call is
   not counted), a roofline bound from this run's inputs (``l2_dist`` and
   ``l2_top1`` at the TF32 tensor-core rate, with the old SIMT f32 bound
   beside it as ``bound_f32_ms``) and one library call's time as a
   yardstick where there is one;
4. determinism: k-means (1024 centroids, 8 iterations) twice on the base
   vectors; the centroids must be bitwise equal;
5. main path: ``IVF1024,ids=roc`` and ``IVF1024,PQ8x8,ids=roc,codes=polya``
   built on the card from 1M ``sift-like`` vectors (the PQ spec from the
   first ``PQ_MAIN_N``, 7,812: its Pólya coding runs on the host;
   k-means assignment and PQ encoding through ``l2_top1``) and served
   through ``AnnService`` (4-query requests, ``max_batch=64``,
   ``nprobe=16``, top-10) twice, with the decoded-id cache cold and then
   warm; then an ingest pass: five
   ``add`` calls of 10,000 new vectors each (five epochs; for the PQ
   spec one of the first ``PQ_ADD_ROWS``, 625, whose Pólya coding runs
   on the host), and the queries served
   again.  Every kernel's launch count (and the launch shapes:
   ``seg_topk`` by ``(n, k)``, ``l2_top1`` by ``(K, d, rows)``, the rows
   of ``pq_adc`` and ``l2_dist``) is set to 0 before the build and read
   after the last pass; results must equal ``search_ref`` exactly on the
   first 64 queries, before and after ingest;
6. Flat path: ``Flat`` on the card (``make_index("Flat")``) over the same
   1M vectors, serving the same queries through ``AnnService`` twice (the
   first pass uploads the base); every kernel's launch count set to 0
   before the build and read after; ids and dists equal to a CPU
   ``FlatIndex`` (the numpy loop, its queries split over host threads) on
   the first 64 queries, and recall@10 1.0 against exact search;
7. container path: ``save_index`` and ``load_index(device="cuda")`` of
   an ``IVF1024,ids=roc`` index over the first CONTAINER_N vectors after
   the same ingest (six epochs) and of the Flat index, with pack and
   unpack seconds and blob MB; bits per id and
   epochs equal, and search after reload equal to search before over all
   queries (counts set to 0 before the path and read after);
8. sharded paths (``repro_torch.shard``), over the indexes built above,
   each counted on its own: the ``IVF1024,ids=roc`` index after its
   ingest planned onto 1, 2 and 4 shards by range and 4 by hash and served
   through ``ShardedAnnService`` cold (the monolith's decoded-id cache
   budget split across the shards) and warm, ids and dists equal to the
   monolith's on all queries, with QPS, p50/p99 and the merge share beside
   the monolith's warm QPS; one routed add of 10,000 vectors to the
   monolith and to both 4-shard services (every shard's n and epochs equal
   the monolith's, results equal); ``IVF1024,PQ8x8,ids=roc,codes=polya``
   over the first 6,250 vectors on 2 shards by hash (a host-bound cut:
   the planner re-encodes each shard's Pólya codes); Flat on 4 shards by
   hash, its plan saved and loaded onto the card (pack / unpack seconds,
   MB), equal before and after; an ``IVF1024,ids=roc`` plan over the first
   25,000 vectors saved and loaded (the joint ROC streams cost ~1 min at
   1M on the host), equal;
9. graph paths, on the reference's graph workload (``GRAPH_N``, 100,000,
   ``deep-like`` vectors, d = 96, seed 0, and its own 1000 queries: a
   host-bound cut from 1M, whose builds took 73.6 + 43.4 s):
   ``NSG32,ids=roc``
   built on the card (kNN through ``l2_dist`` + ``seg_topk``, the
   occlusion prune, the host's ROC coding, each timed; bits per edge, and
   the nodes a search can reach from the entry), served through
   ``AnnService`` (ef = 32) cold and warm, then grown by five ``add``
   calls of ``GRAPH_ADD_ROWS`` vectors and served again; results equal to
   ``search_ref`` on the first 64 queries after each pass, recall@10
   against exact search.  One beam step's device path (copies, gather,
   ``l2_dist``, copy back) is timed against the host re-score of the same
   candidates at tiles of 64 x 128 .. 4096.  The reference's builders
   leave this base in pieces (a search reaches only the entry's mode), so
   ``NSG32`` is also built and served over the first ``GRAPH_NAV_N``
   vectors, where its graph is navigable: the reachable share and
   recall@10 must reach ``GRAPH_NAV_FLOOR``, and warm passes at each
   ``kernel_min`` of ``GRAPH_GATES`` in turns (results equal) give the
   reading behind ``graph_scan.KERNEL_MIN_CUDA`` and every step's tile
   width.  That navigable graph on 2 shards (each shard's graph rebuilt
   on the card), served through ``ShardedAnnService``: each shard equal to
   its own ``search_ref`` on 64 queries, the merge equal to an independent
   merge of the shards' results on all queries, the shards' reachable
   share and recall@10; and over its first 2000 vectors the reference's
   exhaustive regime (ef = 2048 >= n): the monolith and each shard return
   the exact top-10 over the nodes reachable from their entries, and the
   merge equals the monolith on every query whose exact top-10 is
   reachable in both (the other queries counted).  The card's decisions
   against the CPU's: the NSG32 and HNSW16
   prunes of the first 10,000 nodes' kNN lists (and NSG32's against the
   lists the full build made), HNSW's reverse edges on that subgraph (card,
   CPU and the reference's loop), ``knn_graph`` over 5,000 vectors
   (differing only inside ``rescore_eps``) and ``np_sum_f32`` (bit-equal
   to ``np.sum``).  ``HNSW16,ids=roc`` built over the same vectors and
   served cold and warm.  An ``NSG32,ids=roc`` index over the first
   2,500 vectors after an ``add`` of 2,500 saved with webgraph and REC edges
   and loaded onto the card (a host-only cut: the edge coders cost
   ~0.1-0.3 ms a node), search equal.  Every ``l2_dist`` tile and
   ``seg_topk`` ``(rows, n, k)`` these paths launched is held against its
   plain version and timed; each path's counts are set to 0 before it and
   read after.  Then the sharded degraded mode, after every counted path
   and not counted: a dead shard (``stats.partial``, none of its ids
   served) and a flaky one (full results after one retry);
10. main-path shapes: ``seg_topk`` at every ``(n, k)`` and ``l2_top1`` at
   every ``(K, d, rows)`` that phases 5-8 launched (each checked as in
   phase 3; at n = 2^20, Flat's width, the kernel reads its keys from
   global memory on every pass, and it is timed, bounded and set beside
   ``torch.topk`` on the block Flat gives it: the first 64 queries'
   distances to the padded base, lens = n on every row, held bit-equal
   as well), ``pq_adc`` and ``l2_dist`` at the IVF
   mean arena rows (``l2_dist`` at Flat's 2^20 rows in phase 3), and
   ``pq_adc`` / ``l2_dist`` at the sharded paths' mean arena rows and a
   Flat shard's padded rows; each
   kernel's ``main_path_ms`` is launches x time at the shape launched
   (the graph paths' launches at their tiles of phase 9 included);
11. kernel API path: ``wt_rank`` on level 0 of a wavelet tree over the flat
   index's assignment (2^20 positions, the resident route; bit-equal to
   ``BitVector`` and the plain version on a CPU copy) and ``rans_decode``
   on gap_ans-model streams at (128, 8192) and (16, 64) (bit-equal to the
   encoded symbols and the plain version).  No engine calls these two, so
   their launches (and ``wt_rank``'s routes) are counted here; the
   (1024, 1024) decode is timed in phase 3 and not counted;
12. LM serving (``repro_torch.launch.serve``, counts set to 0 before the
   phase and read after): gemma3-1b at full width (26 layers, d_model
   1152, vocab 262,144, window 512) from the port's own init (seed 0),
   ``count_params`` equal to the reference's 999,812,736; in f32, the
   decode of 2 prompts of 600 tokens (every local layer's ring wraps)
   against ``make_prefill_step``'s last position, and one local/global
   super-block (6 layers, full width) on the card against a CPU copy of
   its weights (prefill logits within ``LM_TOL``, 16 greedy tokens
   equal); the serving loop twice in bf16 with its retrieval side-car
   (``IVF64,ids=roc`` over 20,000 deep-like vectors: ``l2_top1`` in
   k-means, ``l2_dist`` + ``seg_topk`` in the scan), tokens equal, with
   tokens/s, ms a decode step against the bf16 weight-read bound, bits
   per id and ms a lookup; the decode step with a bf16 cache, traced by
   ``torch.profiler`` (host ops and kernels a step, the card's idle
   share); then ``embed_corpus`` over 4096 documents of 128 random
   tokens in bf16, indexed as ``IVF64,ids=roc`` on the card:
   self-retrieval >= 0.9 on 256 documents and equal to ``search_ref`` on
   64 queries.  Every ``l2_top1``, ``seg_topk`` and ``l2_dist`` shape
   the phase launched is held against its plain version and timed, and
   added to ``main_path_ms`` (``lm_serving_ms`` on its own);
13. LM serving, MoE (counts set to 0 before the phase and read after):
   olmoe-1b-7b at full width and depth (16 layers, d_model 2048, 64
   experts top-8, vocab 50,304; seed 0), ``count_params`` and the active
   count equal to the reference's (6,816,073,728 and 1,178,929,152;
   llama4-scout's 106,735,375,360 and 16,138,408,960 on the meta device);
   in f32 with ``capacity_factor = E / k`` (capacity T: nothing dropped)
   the decode of 2 x 256 tokens against the prefill at every position;
   the first 2 layers on the card against a CPU copy (2 x 64 tokens,
   capacity 20: assignments dropped, counted), each layer's routing of
   the card's router logits bit-equal on both devices (expert ids, order,
   keep, slot, counts; with each side's smallest gap at the k-th edge),
   prefill and decode logits within ``LM_TOL``, 16 greedy tokens equal;
   the serving loop twice in bf16 with its side-car, tokens equal, ms a
   step against the all-expert and the active weight-read bounds, a
   decode step traced; then llama4-scout-17b-a16e at full width (d_model
   5120, 16 experts top-1, a shared expert) cut to 2 of 48 layers, served
   twice (batch 8, 8 + 8 tokens).  The side-car's shapes are held and
   timed as in phase 12;
14. LM serving, Mamba2 hybrid: zamba2-2.7b at full width and depth (9 x
   (6 Mamba2 + the shared attention block)), ``lora_b`` drawn non-zero,
   ``count_params`` 2,346,365,088; f32 decode of 2 x 512 tokens (two
   256-token SSD chunks) against the prefill at every position; one
   super-block on the card against the CPU; the serving loop twice in
   bf16 (no side-car: no kernel of this repo is on the path);
15. LM serving, xLSTM: xlstm-1.3b at full width and depth (8 x (5 mLSTM
   + 1 sLSTM)), ``count_params`` 1,144,129,856; one super-block on the
   card against the CPU, prefill and 64 decode steps (each form against
   its own counterpart: the reference's two mLSTM forms differ); the
   serving loop twice in bf16.  Each model is freed before the next;
16. LM serving, encoder-decoder (counts set to 0 before the phase and
   read after): whisper-medium at full width and depth (24 encoder + 24
   decoder layers, d_model 1024, vocab 51,865 padded to 51,968; frames
   in, the audio frontend a stub; seed 0), ``count_params`` 959,309,824
   and ``model_flops`` of decode_32k and train_4k equal to the
   reference's; in f32 the decode of 2 x 128 tokens over a memory of 1500
   frames (Whisper's 30-second window) against the prefill at every
   position, and of 2 x 32 tokens over 3000 frames (the prefill's encoder
   and cross-attention past the block threshold of 2048); 2 encoder + 2
   decoder layers on the card against a CPU copy (prefill over 1500
   frames, decode, 16 greedy tokens equal); the serving loop twice in
   bf16 with its side-car (batch 8, 1500 frames, 32 tokens), tokens
   equal, ms a step against the decoder's weight-read bounds and the f32
   memory read, a decode step traced; the side-car's shapes held and
   timed as in phase 12;
17. LM training (``repro_torch.train``, ``launch.train``; counts set to 0
   before the phase and read after: no kernel of the port is on the
   path): gemma3-1b at full width and depth (seed 0, bf16 activations,
   f32 weights and AdamW moments), 20 steps of ``make_train_step`` on
   ``TokenPipeline`` batches of 4 x 512 tokens at lr 1e-3 (warmup 1),
   the loss falling by more than 0.3; ms a step (mean, p50, p99),
   tokens/s and the share of the 6 N D bound at the bf16 peak; the
   optimizer alone against its 28 bytes a weight; one step traced by
   ``torch.profiler``; ``save_checkpoint`` / ``restore_checkpoint`` of
   (params, OptState) of gemma3-1b cut to 6 layers after one step (5.5
   GB; the 26-layer state's 12.0 GB until PR 28), with seconds, the
   restored state training on to the same next two losses; one
   super-block (6 layers, f32) on the
   card against a CPU copy (loss, every gradient, the update, at the CPU
   tests' bounds); crash and resume through ``launch.train.main`` on
   reduced gemma3 (resumed losses within 1e-4 of the unbroken run's), and
   whether two runs and the resumed one are equal bit for bit; one step of
   the same model and batch without activation recomputation and under
   ``remat_policy`` "full" and "dots" (``models.remat``): the loss and
   every gradient of the three bit-equal, or within 1e-6 of each
   gradient's max where the card's products are not bit-stable across a
   recomputation (the reason printed), with peak GB and ms a step (the
   mean of 5 steps after one warm-up) for each.  The 20 steps above run
   under the config's own policy, "full", as the reference's loss does;
18. distributed (``repro_torch.distributed``, ``launch.mesh``, the
   sharded train step, ``checkpoint.reshard``; counts set to 0 before the
   phase here and in each spawned rank before its job, read after and
   summed: no kernel of the port is on the path): four
   ranks spawned on cuda:0 over gloo (NCCL refuses two ranks on one
   device; every collective crosses the host), each a module-level job
   of this script: sequence-parallel decode at granite-20b's attention
   width (48 heads, 1 KV head, head_dim 128) over decode_32k's 32,768
   slots for 8 sequences, the last 1000 empty, against dense attention
   within 2e-5; GPipe over four full-width minitron-4b layers, 8
   microbatches of 2 x 512 tokens, against the layers in sequence within
   1e-4 of the output's scale, with ms and the bubble share
   (S - 1) / (S - 1 + M); two sharded steps of reduced gemma3 on a
   (2, 2) mesh, replicas bit-equal, losses against the plain step; a
   reduced checkpoint resharded onto (2, 2) and (4, 1), every shard its
   slice bit for bit; then the model axis's split at full width, f32,
   on (data 2, model 2), one step of 4 x 512 tokens each, every sharded
   train step gathering its weights layer by layer inside each
   recomputed super-block (``distributed.fsdp``): gemma3-1b at
   full depth (its 4 heads split, its one KV head's ``wk`` / ``wv``
   gathered, the MLP column- / row-parallel, the embedding, logits and
   loss vocab-parallel) and olmoe-1b-7b cut to 2 of its 16 layers (32
   of the 64 experts a model rank), each against the one-process step
   that each rank runs in turn on the whole batch (loss, ce and
   grad_norm within 1e-5 relative, each gradient within 1e-4 of its
   tensor's max, each updated weight within lr (1e-2 + du); MoE routing
   of each rank's tokens bit-equal to the one-process step's), replicas
   bit-equal by digest, with ms a step, the host ms and bytes of the
   data axes' and of the model axis's collectives, each rank's peak
   memory (since it built its model, and the step's own), the leaves it
   gathered and the most gathered bytes alive at once
   (``compat.GATHERED``), and its matmul FLOPs (``FlopCounterMode``) as
   a share of the one-process step's; olmoe's loss and gradients are
   also computed once before its step from the same state and compared
   bit for bit with the step's (printed, not a failure: the expert
   buffer's scatter and its backward may use float atomics).  Two ranks: gemma3-1b at full
   width and depth in f32 on (data 2, model 1), one sharded step of 4 x
   512 tokens against the one-process step (loss and grad_norm within
   1e-5 relative, each gradient within 1e-4 of its tensor's max, each
   updated weight within lr (1e-2 + du)), with ms a step, the
   host-staged collectives' time, each rank's peak memory and gathered
   bytes, printed beside the (2, 2) step's (``per_layer``).  The serving steps on (data 2, model 2) at
   the same widths (``make_prefill_step`` / ``make_serve_step`` with
   ``mesh=``): the sharded prefill of 4 x 512 prompts against the
   one-process prefill, then 8 sharded serve steps from a one-process f32
   cache placed by ``cache_shardings`` (gemma3-1b: filled to 508 tokens,
   its caches sharded by slot over "model" and read by flash-decoding,
   its 512-slot rings wrapping inside the sharded steps;
   olmoe-1b-7b: 64 tokens, its 16 KV heads split), each step's logits
   within 1e-4 of the one-process step's scale and its tokens equal where
   the top-2 gap exceeds that, each rank's final cache slices within
   1e-4 of the one-process cache's, MoE routing bit-equal, with ms a
   step and the collectives' host ms; the one-process side runs once, in this
   process, before the ranks start, so that neither side is timed while
   the other runs.  Then zamba2-2.7b and xlstm-1.3b at full width, each
   cut to one super-block (6 Mamba2 layers and the shared block; 5 mLSTM
   and 1 sLSTM), their mixers split by head over the model axis: one
   sharded step of 4 x 512 tokens each against the one-process step at
   the same bounds (xlstm: its train-step tests' bound, 3.32e-4 of each
   leaf's max, for its sharded gradients against the one-process f32
   step's, and for both against the one-process gradients in f64, every
   step on the f64 step's sides of the mLSTM normaliser's kink; grad_norm
   within 3.32e-4), and their serving steps on the same mesh: the
   sharded prefill of 4 x 512 prompts
   against the one-process prefill within 1e-4 of the logits' scale,
   then 8 sharded serve steps from a one-process f32 cache filled by 16
   decode steps and placed by ``cache_shardings``, whose Mamba2, mLSTM
   and sLSTM weights the serve step holds at their stored model shards
   and whose states stay where the rules store them (each rank computes
   each projection on its shard and updates its slice; the readouts and
   the row-split output projections are reduced over "model"): each
   step's logits within 1e-4 of the one-process step's scale, its tokens
   equal where the top-2 gap exceeds that, each rank's final cache
   slices within 1e-4 of the one-process cache's; each rank's matmul
   FLOPs share printed beside the predicted one, the mixers' model-axis
   calls and bytes a decode step (``compat.APART["recurrent"]``) and the
   serve step's parameter bytes a rank (mixers, and the rest) equal to
   the ones counted from the shapes, beside what the weights whole and
   gathering every split state would move and hold (``mixers``; the
   weights-whole figures on the line before).  Then xlstm-1.3b's
   super-block again on (data 1, model 8), eight ranks on cuda:0: each of
   its 4 heads on a group of two model ranks (each rank its head's q / k
   / gates and sLSTM recurrence whole, its half of the head's v / z /
   output channels): one sharded step of 4 x 512 tokens against the
   one-process f32 and f64 steps that the (2, 2) case computed and left on
   disk, at the same bounds and sides, its prefill and 8 serve steps
   checked as on (2, 2), each rank's matmul FLOPs share printed beside
   the predicted one (``xlstm-1.3b 1x8`` in ``mixers``).  Then the dry-run (``launch.dryrun``) of rank 0 of
   the same gemma3-1b train step and serve step on a fake world of 4 in
   this process, with fake ``cuda`` tensors: its collective calls and
   bytes by op equal to what rank 0 counted (``compat.STATS``) over one
   real step of each, and its ``FlopCounterMode`` FLOPs equal to rank 0's
   under the same counter, the train step's gathered leaves and bytes
   equal to rank 0's; its ``temp_bytes`` and peak printed beside the
   real ``max_memory_allocated``, with the ratio.  A world of one on
   NCCL in this process: the sharded step on (1, 1) equal to the plain
   step bit for bit.  Any rank's failure fails the phase;
19. examples on the card (counts read in each example's process and
   summed): ``examples/torch_quickstart.py``, ``torch_serve_ann.py``
   (monolithic, then on 4 shards with a 5% fault rate) and
   ``torch_train_embedder.py --full``, each a process of its own with
   ``--device cuda`` at the sizes of EXAMPLE_RUNS, all started at once;
   each must exit 0 and print its expected lines, and together they must
   launch ``l2_top1``, ``l2_dist``, ``seg_topk`` and ``pq_adc``; each
   run's seconds, launches and result lines printed.

The last four lines are the total of the phases' seconds (with the
seconds since ``main`` started and the margin under RUN_LIMIT_S), the card's
name and power limit (as ``nvidia-smi`` gives them), the ``kernels`` JSON
(one entry a kernel) and ``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the HBM3 rate; the
# non-tensor f32 rate of the SIMT kernels (pq_adc, seg_topk, wt_rank,
# rans_decode); and the dense TF32 tensor-core rate, at which l2_dist and
# l2_top1 run their dot products as three TF32 products (csrc/l2_mma.cuh)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 494.7e12
# the dense bf16 tensor-core rate, for the 6 N D bound of an LM train step
PEAK_BF16_S = 989e12
TF32_PRODUCTS = 3
# SASS mnemonics of the tensor-core MMA instructions (wgmma, mma.sync)
TENSOR_CORE_SASS = ("HGMMA", "HMMA")

SPECS = ("IVF1024,ids=roc", "IVF1024,PQ8x8,ids=roc,codes=polya")
NPROBE, TOPK, REQUEST, MAX_BATCH = 16, 10, 4, 64
NLIST = 1024
# l2_top1 at the k-means shapes of the main path: IVF1024 over ~1M
# 128-d rows, and one PQ8x8 subspace (256 centroids of 16 dims)
TOP1_SHAPES = ((1 << 20, NLIST, 128), (1 << 20, 256, 16))
INGEST_ADDS, INGEST_ROWS = 5, 10_000
# the IVF container round trip runs over an index of the first CONTAINER_N
# vectors grown by the same adds: its joint ROC streams are packed and
# unpacked on the host at a cost that grows faster than the lists (at the
# main path's 1M, 68.9 s + 79.3 s of the phase's 157.0 s, and 166.3 s on
# a slower host, before the run grew past RUN_LIMIT_S there)
# (125,000 since recomputation and the dry-run grew phases 17-18; 62,500
# since the examples' phase 19; 31,250 since the mesh decode of zamba2
# and xlstm joined phase 18)
CONTAINER_N = 31_250
# the PQ spec is built over the first PQ_MAIN_N vectors and grown by the
# first add only: its Pólya coding runs on the host (the build took
# 218.7-290 s at 1M, each add ~20-43 s), cuts of depth that keep the run
# with its sharded, LM serving, LM training and distributed phases inside
# RUN_LIMIT_S (1034.3 s of phases with the PQ build at 1M; 1069.2 and
# 1302.7 s on two hosts with it at 500,000, two adds and the training
# phase; 898.05 s at 250,000 before the distributed phase, which took
# 60.3 s, on a host that ran this phase 1.2x faster than another; 910.9
# and 1066.5 s at 125,000 on two hosts, before the distributed phase's
# full-width (2, 2) steps took it from 40.8-64.6 s to 106.3 s)
# (31,250 since recomputation and the dry-run grew phases 17-18:
# 33.0 s at 62,500; 15,625 since the examples' phase 19, 7.4 s of
# phase; 7,812 since the mesh decode of zamba2 and xlstm joined phase 18)
PQ_MAIN_N = 7_812
PQ_INGEST_ADDS = 1
# the PQ spec's add takes the first PQ_ADD_ROWS rows of the first add: its
# Pólya coding runs on the host (35.9 s for 10,000 rows on a slow host,
# since recomputation and the dry-run grew phases 17-18; 1,250 since the
# examples' phase 19; 625 since the mesh decode of zamba2 and xlstm
# joined phase 18)
PQ_ADD_ROWS = 625
# Flat's results are held against the CPU's numpy loop over 1M vectors on
# the first 64 queries, split over FLAT_LOOP_THREADS host threads (~0.5-0.7
# s a query on one; 64 took 46 s)
FLAT_LOOP_THREADS = 8
# seg_topk at two row widths and every k the scan's K-doubling retry
# reaches up to 2048 (and k = 16, the earlier kernel's shape), plus the
# retry's worst case k = n; the (n, k) the main path launched (at 1M
# sift-like rows, nprobe=16: n = 131072 and 262144) are added after it
SEG_NS = (16384, 32768)
SEG_KS = (16, 32, 64, 128, 256, 512, 1024, 2048)
# shared memory serves 32 four-byte words a clock on each SM
SMEM_WORDS_PER_CLOCK = 32
# rans_decode at (lanes, rows): 2^20 symbols, and one IVF1024 cluster at 1M
# (the kernel-API path); and eight decode warps at L = 1024, timed beside
# them but not counted in main_path_ms
RANS_SHAPES = ((128, 8192), (16, 64))
RANS_WIDE = (1024, 1024)
WT_QUERIES = 1 << 20
# wt_rank also on a bitvector too large for shared memory (the global route)
WT_LARGE_BITS = 1 << 24
# the graph paths run on the reference's graph workload, the deep-like
# preset (benchmarks/graph_bench.py:38; d = 96), seed 0, as many vectors
# and queries as the main path: NSG32 (the paper's Table 2 graph) at full
# scale, served and grown like the IVF specs; HNSW16 built and served; the
# card's decisions held against the CPU's on the first nodes; a graph
# container round trip on a host-only cut of the base (webgraph / REC
# coding is ~0.2-0.3 ms a node on the host)
GRAPH_PRESET = "deep-like"
# the graph paths' base: the first GRAPH_N vectors (a host-bound cut since
# recomputation and the dry-run grew phases 17-18; at 1M the NSG32
# path took 73.6 s and HNSW16 43.4 s, and a search reached 802 nodes)
GRAPH_N = 100_000
# its ingest: INGEST_ADDS adds of GRAPH_ADD_ROWS vectors, each add's prune
# decided and its edges coded on the host (5 x 10,000 until the mesh
# decode of zamba2 and xlstm joined phase 18: 8.2 s of add_s)
GRAPH_ADD_ROWS = 4_000
GRAPH_SPECS = ("NSG32,ids=roc", "HNSW16,ids=roc")
GRAPH_EF = 32
# The reference's builders (exact kNN, the occlusion prune, no step that
# joins components) leave deep-like at 1M in pieces: from the entry a
# search reaches only the entry's Gaussian mode, whose points all have
# their 64 nearest neighbours inside it.  So NSG32 is served as well over
# the first GRAPH_NAV_N vectors, the most at which its graph is navigable
# (tools/graph_ladder.py), and must reach the floors below there; the
# kernel_min gate is read on that graph, in warm passes at each of
# GRAPH_GATES in turns (GRAPH_BLOCK_N: every step's tile on the kernel;
# the last: none)
GRAPH_NAV_N = 50_000
# (the ladder: reachable share 0.994-0.996 and recall@10 0.82-0.92 from
# 20,000 to 50,000 vectors; from 70,000 on, a search stays in one mode or
# recall falls to 0.36 and below)
GRAPH_NAV_FLOOR = dict(reachable_share=0.98, recall_at_10=0.75)
GRAPH_GATES = (128, 512, 1024, 2048, 1 << 30)
GRAPH_GATE_ROUNDS = 3
# (20,000 and 10,000 until xlstm's (1, 8) case joined phase 18: the
# decisions against the CPU took 45.6 s on a slow host)
GRAPH_CHECK_NODES = 10_000
GRAPH_KNN_CHECK = 5_000
# (10,000 since the serving steps on a mesh joined phase 18 and its
# one-process side stopped overlapping the ranks: the container phase took
# 54.25 s of a run's 1075.10 s of phases at 100,000, 34-40 s at 50,000 and
# 27.34 s of 1103.52 s at 25,000)
# (5,000 since recomputation and the dry-run grew phases 17-18: 21.6 s
# at 10,000; 2,500, grown by the first GRAPH_CONTAINER_ADD rows of the
# first add, not all 10,000, since the mesh decode of zamba2 and xlstm
# joined phase 18: 14.6 s at 5,000 + 10,000, 10.0 s of it coding)
GRAPH_CONTAINER_N, GRAPH_CONTAINER_ADD = 2_500, 2_500
NPSUM_DIMS = (7, 24, 128, 129, 960)
# graph-step tiles (query rows, candidate columns) at which one step's
# device path is timed against the host re-score of the same candidates
STEP_TILES = tuple((64, n) for n in (128, 256, 512, 1024, 2048, 4096))
# the most elements of a beam step's l2_dist tile (64 rows x 4096)
STEP_TILE_MAX = 64 * 4096
# sharded serving (repro_torch.shard) over the indexes the paths above
# built: IVF1024,ids=roc after its ingest at 1, 2 and 4 shards by range and
# 4 by hash, then one routed add of SHARD_ADD_ROWS vectors; PQ over the
# first SHARD_PQ_N vectors (the planner re-encodes each shard's Pólya
# codes on the host: at 1M that costs about as much as the PQ build; 35.0
# s at 50,000), 2 shards by hash; Flat at full size, 4 by hash, its plan
# saved and loaded onto the card; an IVF plan saved and loaded over the first
# SHARD_CONTAINER_N vectors (the host's joint ROC streams cost ~1 min at
# 1M); the navigable NSG32 graph, 2 shards, and the reference's
# exhaustive regime (ef >= n) over its first SHARD_EXHAUSTIVE_N vectors
SHARD_IVF = ((1, "range"), (2, "range"), (4, "range"), (4, "hash"))
SHARD_ADD_ROWS = 10_000
# (SHARD_PQ_N 12,500 and SHARD_CONTAINER_N 50,000 until the mesh decode
# of zamba2 and xlstm joined phase 18: 9.3 s and 2.2 s of phase)
SHARD_PQ_N = 6_250
SHARD_CONTAINER_N = 25_000       # 100,000 before phase 19
SHARD_GRAPH = 2
SHARD_EXHAUSTIVE_N = 2000
SHARD_EXHAUSTIVE_EF = 2048
SHARD_EXHAUSTIVE_Q = 128
# the time a run of this script may take, kernels' build included
RUN_LIMIT_S = 1200
# LM serving (repro_torch.launch.serve) at gemma3-1b's full width: f32
# decode against prefill over LM_PREFILL (prompts, tokens), past the
# 512-token window so every local layer's ring wraps; the card against
# the CPU at LM_CPU_LAYERS (one local/global super-block) over a
# LM_CPU_PROMPT-token prompt and LM_CPU_GEN greedy tokens; the serving
# loop twice (bf16, with the retrieval side-car); then the model's own
# embeddings of LM_DOCS documents of LM_DOC_LEN random tokens (batches of
# LM_DOC_BATCH) indexed as IVF64,ids=roc.  LM_TOL: logits agree within
# atol = LM_TOL * max(1, max|logits|) and rtol = LM_TOL.  On the CPU the
# reduced gemma3 (14 layers, 80 tokens past a window of 64) puts decode
# within 2.1e-6 of prefill at a logit scale of 4.4 (5e-7 of it); full
# width sums 18x longer rows through twice the depth, which would grow
# that to ~1e-5 of the scale: LM_TOL leaves a margin of ~10 over it
LM_ARCH = "gemma3-1b"
LM_PARAMS = 999_812_736
LM_PREFILL = (2, 600)
LM_CPU_LAYERS, LM_CPU_PROMPT, LM_CPU_GEN = 6, 64, 16
LM_SERVE_ARGV = ["--arch", LM_ARCH, "--batch", "8", "--prompt-len", "32",
                 "--gen", "32", "--retrieval"]
LM_BF16_CACHE_STEPS = 64
LM_DOCS, LM_DOC_LEN, LM_DOC_BATCH = 4096, 128, 16
LM_SELF_CHECK, LM_SELF_FLOOR, LM_REF_QUERIES = 256, 0.9, 64
LM_TOL = 1e-4
LM_TRACE_STEPS = 4
# The other decoder-only families at their published widths (random
# weights from a seed), each held to LM_TOL as above.  MoE: olmoe-1b-7b at
# full depth (decode against prefill over MOE_PREFILL with a capacity
# that drops nothing; the card against the CPU over its first
# MOE_CPU_LAYERS layers, where 2 x 64 tokens overflow the capacity of 20;
# the serving loop with its side-car), then llama4-scout cut to
# SCOUT_LAYERS of 48 layers (~22 GB in f32), the only top-1 routing with
# a shared expert.  Hybrid: zamba2-2.7b at full depth, lora_b drawn from
# N(0, HYBRID_LORA_STD^2) (zero at init would leave the adapter
# unchecked), decode against prefill over HYBRID_PREFILL (two 256-token
# SSD chunks).  xLSTM: xlstm-1.3b at full depth; the card against the CPU
# over one super-block, the decode over XLSTM_DECODE_STEPS steps (its
# stabilised decode is not the prefill's form, so each is held against
# its own counterpart).
MOE_ARCH = "olmoe-1b-7b"
MOE_PARAMS, MOE_ACTIVE = 6_816_073_728, 1_178_929_152
MOE_PREFILL = (2, 256)
MOE_CPU_LAYERS, MOE_CPU_PROMPT, MOE_CPU_GEN = 2, 64, 16
MOE_SERVE_ARGV = ["--arch", MOE_ARCH, "--batch", "8", "--prompt-len", "32",
                  "--gen", "32", "--retrieval"]
SCOUT_ARCH = "llama4-scout-17b-a16e"
SCOUT_PARAMS, SCOUT_ACTIVE = 106_735_375_360, 16_138_408_960
SCOUT_LAYERS = 2
SCOUT_SERVE_ARGV = ["--arch", SCOUT_ARCH, "--batch", "8", "--prompt-len",
                    "8", "--gen", "8"]
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_PARAMS = 2_346_365_088
HYBRID_PREFILL = (2, 512)
HYBRID_LORA_STD = 0.01
HYBRID_SERVE_ARGV = ["--arch", HYBRID_ARCH, "--batch", "8", "--prompt-len",
                     "32", "--gen", "32"]
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_PARAMS = 1_144_129_856
XLSTM_DECODE_STEPS = 64
XLSTM_SERVE_ARGV = ["--arch", XLSTM_ARCH, "--batch", "8", "--prompt-len",
                    "32", "--gen", "32"]
# The encoder-decoder at full width and depth (24 + 24 layers, d_model
# 1024; the audio frontend a stub: frames in).  ENCDEC_FRAMES = 1500
# encoder positions is Whisper's 30-second window; f32 decode of
# ENCDEC_DECODE tokens against the prefill over it, and of
# ENCDEC_BLOCKED_DECODE tokens over ENCDEC_BLOCKED_FRAMES, past the
# attention's block threshold of 2048 (the prefill's encoder and
# cross-attention take the blocked path, a one-token decode's does not);
# the card against the CPU on ENCDEC_CPU_LAYERS encoder and decoder
# layers; the serving loop twice with its side-car over ENCDEC_FRAMES.
# The reference's own decode and prefill agree for whisper on the CPU
# (tools/lm_forms.py, reduced: 2.15e-6 at a logit scale of 3.50 over 24
# frames, 1.79e-6 at 4.15 over 2100), so the decode is held against the
# prefill within LM_TOL.
ENCDEC_ARCH = "whisper-medium"
ENCDEC_PARAMS = 959_309_824
ENCDEC_FRAMES, ENCDEC_DECODE = 1500, (2, 128)
ENCDEC_BLOCKED_FRAMES, ENCDEC_BLOCKED_DECODE = 3000, (2, 32)
ENCDEC_CPU_LAYERS, ENCDEC_CPU_PROMPT, ENCDEC_CPU_GEN = 2, 32, 16
ENCDEC_SERVE_ARGV = ["--arch", ENCDEC_ARCH, "--batch", "8", "--prompt-len",
                     str(ENCDEC_FRAMES), "--gen", "32", "--retrieval"]


# LM training (repro_torch.train, launch.train) at gemma3-1b's full width
# and depth: TRAIN_STEPS steps of make_train_step on TokenPipeline batches
# of TRAIN_BATCH (B, S) in bf16 activations with f32 weights and moments,
# lr TRAIN_LR with warmup 1; the loss must fall by more than
# TRAIN_LOSS_DROP (the reference's test).  Time a step against 6 N D at
# the bf16 tensor-core peak, the optimizer alone (TRAIN_OPT_REPS calls)
# against the 28 bytes a weight AdamW moves.  The card against the CPU
# over one super-block (LM_CPU_LAYERS layers, f32) on a TRAIN_CPU_BATCH
# batch, at the CPU tests' bounds (tests/_torch_train.py): loss, ce and
# grad_norm within TRAIN_LOSS_TOL relative, gradients within
# TRAIN_GRAD_TOL of each tensor's max, updates within lr *
# TRAIN_UPDATE_TOL.  Crash and resume through launch.train.main on reduced
# gemma3 as the reference's test runs it (TRAIN_RESUME_ARGV), the resumed
# losses within TRAIN_RESUME_RTOL (the reference's rtol).
TRAIN_BATCH = (4, 512)
TRAIN_STEPS = 20
TRAIN_LR = 1e-3
TRAIN_LOSS_DROP = 0.3
TRAIN_OPT_REPS = 3
TRAIN_CPU_BATCH = (1, 64)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_UPDATE_TOL = 1e-5, 1e-4, 1e-2
# xlstm's gradient and grad_norm bound in the train-step tests
# (tests/_torch_train.py XLSTM_GRAD_TOL: twice the reference's own f32
# gradients' gap from their f64 values)
TRAIN_XLSTM_GRAD_TOL = 3.32e-4
TRAIN_RESUME_ARGV = ["--arch", LM_ARCH, "--reduced", "--batch", "4",
                     "--seq", "32", "--ckpt-every", "10", "--steps", "30",
                     "--log-every", "100", "--device", "cuda"]
TRAIN_RESUME_RTOL = 1e-4
# the checkpoint round trip's model: gemma3-1b cut to TRAIN_CKPT_LAYERS
# layers after one step (host-bound writes and reads, cut for phase 18's
# growth: the whole model's state is 12.0 GB)
TRAIN_CKPT_LAYERS = 6

# The distribution layer (repro_torch.distributed, launch.mesh, the sharded
# train step, checkpoint.reshard) on DIST_WORLD ranks that share cuda:0
# over gloo (NCCL refuses two ranks on one device): sequence-parallel
# decode at granite-20b's attention width (48 heads, 1 KV head, head_dim
# 128; the config whose cache the rules shard by sequence) over
# decode_32k's T of 32,768 for SP_BATCH sequences, the last SP_INVALID
# slots empty, against dense attention on the card within SP_TOL (the
# reference test's tolerance); GPipe over four full-width minitron-4b
# decoder layers (d 3072, 24 heads, 8 KV heads, ff 9216) on PP_MICRO
# microbatches of PP_MB (batch, tokens), against the layers in sequence
# within PP_TOL of the output's scale; gemma3-1b at full width and depth
# in f32 on a DIST_TRAIN_MESH (data, model) mesh of two ranks, one step
# on DIST_TRAIN_BATCH tokens against the one-process step (loss and
# grad_norm within TRAIN_LOSS_TOL relative, every gradient within
# TRAIN_GRAD_TOL of its tensor's max, every updated weight within lr *
# (TRAIN_UPDATE_TOL + du)); reduced gemma3 on DIST_SMALL_MESH for
# DIST_SMALL_STEPS steps (replicas bit-equal, losses against the plain
# step's) and its checkpoint resharded onto each of RESHARD_MESHES
# (slices bit-equal); a world of one on NCCL, where the sharded step
# equals the plain step bit for bit.  A rank not done after
# DIST_TIMEOUT_S fails the phase.
DIST_WORLD = 4
SP_ARCH, SP_BATCH, SP_T, SP_INVALID, SP_TOL, SP_REPS = \
    "granite-20b", 8, 32_768, 1000, 2e-5, 5
PP_ARCH, PP_MICRO, PP_MB, PP_TOL = "minitron-4b", 8, (2, 512), 1e-4
DIST_TRAIN_MESH, DIST_TRAIN_BATCH = (2, 1), (4, 512)
DIST_SMALL_MESH, DIST_SMALL_STEPS, DIST_SMALL_BATCH = (2, 2), 2, (4, 32)
RESHARD_MESHES = ((2, 2), (4, 1))
# the model axis's split at full width: gemma3-1b (all 26 layers) and
# olmoe-1b-7b cut to DIST_TP_MOE_LAYERS of its 16, f32, one step of
# DIST_TRAIN_BATCH on DIST_TP_MESH against the one-process step
DIST_TP_MESH, DIST_TP_MOE_LAYERS = (2, 2), 2
# the Mamba2 and xLSTM mixers split by head over the model axis: zamba2-2.7b
# and xlstm-1.3b at full width, each cut to one super-block of
# DIST_TP_MIXER_LAYERS layers (6 Mamba2 layers and the shared block; 5
# mLSTM and 1 sLSTM), f32, one step of DIST_TRAIN_BATCH on DIST_TP_MESH
# against the one-process step, and the mesh prefill of DIST_TRAIN_BATCH
# prompts against the one-process prefill within DIST_SERVE_TOL of the
# logits' scale; each rank's matmul FLOPs printed beside
# DIST_TP_MIXER_SHARE, the share of the one-process step's predicted from
# the weights' shapes (one data half of the batch, the mixers, the
# shared block, LoRA and the logits over tp = 2)
DIST_TP_MIXER_ARCHS, DIST_TP_MIXER_LAYERS = (HYBRID_ARCH, XLSTM_ARCH), 6
# xlstm-1.3b's super-block again on DIST_GROUP_MESH, over
# DIST_GROUP_WORLD ranks: its 4 heads each on a group of two model ranks
# (each rank its head's q / k / gates and sLSTM recurrence whole, its half
# of the head's v / z / output channels); one step of DIST_TRAIN_BATCH
# against the one-process f32 and f64 steps that the (2, 2) case computed
# and saved, its prefill and decode as on (2, 2)
DIST_GROUP_MESH, DIST_GROUP_WORLD = (1, 8), 8
DIST_GROUP = f"{XLSTM_ARCH} 1x8"
DIST_TP_MIXER_SHARE = {HYBRID_ARCH: 0.251, XLSTM_ARCH: 0.250,
                       DIST_GROUP: 0.162}
DIST_TIMEOUT_S = 600
# the serving steps on DIST_TP_MESH at the same widths (gemma3-1b's full
# depth, olmoe-1b-7b's DIST_TP_MOE_LAYERS layers, f32): the sharded
# prefill of DIST_TRAIN_BATCH prompts against the one-process prefill;
# then, from a one-process f32 cache of DIST_SERVE_MAX_LEN slots filled by
# DIST_SERVE_FILL decode steps and placed by cache_shardings,
# DIST_SERVE_STEPS sharded serve steps (gemma3's cache sharded by slot
# over "model", its 512-slot local rings wrapping inside the sharded
# steps, at 512: a fill of 508 in place of 1020 since PR 28, host-bound
# one-process steps cut for the phase's growth; olmoe's by KV head),
# each step's logits
# within DIST_SERVE_TOL of the one-process step's scale and its tokens
# equal where the top-2 gap exceeds that, and each rank's final cache
# slices within DIST_SERVE_TOL of the one-process cache's; MoE routing
# bit-equal.  The same for DIST_TP_MIXER_ARCHS' super-blocks, filled by
# 16 steps: their recurrent states stay where cache_shardings stores
# them, the mixers' model-axis calls and bytes a step held to
# mixer_decode_calls.  The one-process side is computed once, by this
# process before the ranks start, so that nothing else uses the card or
# the host while either side is timed
DIST_SERVE_FILL = {"gemma3-1b": 508, "olmoe-1b-7b": 64, HYBRID_ARCH: 16,
                   XLSTM_ARCH: 16}
# activation recomputation in phase 17: one step under each policy, then
# TRAIN_REMAT_STEPS timed steps after one warm-up; gradients that are not
# bit-equal to the step without recomputation must lie within
# TRAIN_REMAT_TOL of their tensor's max (a cuBLAS product whose algorithm
# differs between the forward and its recomputation would round apart)
TRAIN_REMAT_POLICIES = ("none", "full", "dots")
TRAIN_REMAT_STEPS, TRAIN_REMAT_TOL = 5, 1e-6
DIST_SERVE_MAX_LEN = {"gemma3-1b": 528, "olmoe-1b-7b": 80, HYBRID_ARCH: 32,
                      XLSTM_ARCH: 32}
DIST_SERVE_STEPS, DIST_SERVE_TOL = 8, 1e-4

# Phase 19: the port's examples (examples/torch_*.py), each run as its own
# process on the card, side by side: (name, script, arguments, the lines
# its output must hold).  Host-bound cuts, the default spec's Polya codes
# being coded on the host (again for each shard): quickstart at 50,000 of
# its 100,000 vectors (32.4-42.5 s at 100,000); serve_ann at 50,000 of its
# 200,000, and with 4 shards and a 5% fault rate at 10,000 (86.5 s at
# 50,000, 38.2-40.6 s at 20,000); train_embedder --full (gemma3-1b
# trained at full width, the ~100M-param embedder) for 20 of its 200
# steps (112.6 s at 200, 38.2-45.6 s at 40).  Seconds on H100 hosts, the
# four runs side by side.
EXAMPLE_RUNS = (
    ("quickstart", "torch_quickstart.py",
     ("--n", "50000", "--queries", "100", "--nlist", "256", "--graph-n",
      "2000"),
     ("compression is lossless", "reloaded index returns bit-identical",
      "same search API")),
    ("serve_ann", "torch_serve_ann.py", ("--n", "50000", "--queries", "1000"),
     ("recall@10", "RAM ledger")),
    ("serve_ann_sharded", "torch_serve_ann.py",
     ("--n", "10000", "--queries", "1000", "--shards", "4", "--fault-rate",
      "0.05"),
     ("recall@10", "sharded serving:", "degraded mode:", "RAM ledger")),
    ("train_embedder", "torch_train_embedder.py",
     ("--full", "--steps", "20"),
     ("[train] done", "[4/4] querying", "self-recall@1")),
)
EXAMPLE_KERNELS = ("l2_top1", "l2_dist", "seg_topk", "pq_adc")
EXAMPLE_TIMEOUT_S = 400
# runs an example as __main__ in a process of its own, then prints the
# launch counts of the port's kernels in that process
EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "from repro_torch.kernels import launch_counts\n"
    "print('LAUNCHES ' + json.dumps(launch_counts()))\n")

class Phases:
    """The run's phase timer: ``with phases(name):`` prints the phase's
    start and, if it raised nothing, its seconds, which ``seconds`` keeps
    (their sum is the run's total of phase seconds)."""

    def __init__(self):
        self.seconds = []

    @contextlib.contextmanager
    def __call__(self, name):
        t = time.perf_counter()
        print(f"[phase] {name} ...", flush=True)
        yield
        s = time.perf_counter() - t
        self.seconds.append(s)
        print(f"[phase] {name} ok in {s:.3f} s", flush=True)


def cuda_ms(fn, reps=20, warmup=3, graph=False):
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up.

    ``graph=True`` captures the ``reps`` calls in one CUDA graph and times
    its replay, so a short kernel is timed without the host's cost of each
    call (the wrapper's checks, allocations and launch)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nflops, peak=PEAK_F32_S):
    """(least time in ms, "bytes" | "operations") on the card's peaks, the
    operations at ``peak`` per second."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, nflops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def l2_bounds(nbytes, m, n, d):
    """Bounds of an (m, d) x (n, d) squared-L2 kernel: (ms, by) of the
    split-TF32 tensor-core design (three TF32 products of 2 m n d each),
    and the ms of the SIMT f32 design it replaced (the dot products, the
    norms and the 3-operation epilogue at the f32 rate)."""
    b, by = bound_ms(nbytes, TF32_PRODUCTS * 2 * m * n * d, PEAK_TF32_S)
    f32, _ = bound_ms(nbytes, 2 * m * n * d + 2 * (m + n) * d + 3 * m * n)
    return b, by, f32


def sass_tensor_core_count(lib_path):
    """Tensor-core MMA instructions in a built library's SASS, by
    ``cuobjdump -sass``: {mnemonic: count}."""
    from repro_torch.kernels import _build

    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    ops = re.findall(r"\b(" + "|".join(TENSOR_CORE_SASS) + r")\.", sass)
    return {m: ops.count(m) for m in TENSOR_CORE_SASS}


def rescore_band(d, ref, qn):
    """The scan's ``rescore_eps(d, ref, qn)`` elementwise, as a tensor."""
    import torch

    eps32 = float(torch.finfo(torch.float32).eps)
    return 16.0 * d * eps32 * (1.0 + ref.abs().double() + qn)


def check_l2_dist(dev, gen, n=1 << 20, qb=64, d=128):
    import torch
    from repro_torch.kernels.l2_topk import l2_dist, l2_dist_ref

    q = torch.randn(qb, d, device=dev, generator=gen)
    a = torch.randn(n, d, device=dev, generator=gen)
    out = l2_dist(q, a)
    ref = l2_dist_ref(q, a)
    torch.cuda.synchronize()
    qn = (q.double() ** 2).sum(1, keepdim=True)
    err = (out.double() - ref.double()).abs()
    band_use = float((err / rescore_band(d, ref, qn)).max())
    if not band_use <= 1.0:
        raise AssertionError(f"l2_dist outside rescore_eps: max err "
                             f"{float(err.max())}, {band_use} of the band")
    qn32, an32 = (q * q).sum(1, keepdim=True), (a * a).sum(1)
    b, by, b32 = l2_bounds(4 * (qb * d + n * d + qb * n), qb, n, d)
    small = n < (1 << 16)        # a graph step's tile: time a graph replay
    return dict(
        name="l2_dist" if n == 1 << 20 else f"l2_dist(n={n})" if qb == 64
        else f"l2_dist({qb}x{n})", route="cuda",
        source="src/repro_torch/csrc/l2_dist.cu",
        replaces="src/repro/kernels/l2_topk/kernel.py:76",
        shape=f"q {qb}x{d}, arena {n}x{d} f32",
        max_abs_err=float(err.max()), band_use=band_use,
        ms=cuda_ms(lambda: l2_dist(q, a), graph=small),
        plain_ms=cuda_ms(lambda: l2_dist_ref(q, a), graph=small),
        bound_ms=b, bound_by=by, bound_f32_ms=b32,
        library_ms=cuda_ms(lambda: torch.addmm(an32[None], q, a.T,
                                               alpha=-2.0).add_(qn32),
                           graph=small))


def check_pq_adc(dev, gen, sm_hz, n=1 << 20, m=8):
    """pq_adc bitwise equal to a sequential j-ordered f32 sum (a loop over
    j on the card) and to the plain version (the same sum) and inside
    rescore_eps of it; with the lookup count (qb * n * m
    shared-memory words) and its time at 32 words a clock on every SM,
    beside the byte bound, and the launches one call makes (``chunks``:
    m >= 228 is scored as j-ordered chunks of tables)."""
    import torch
    from repro_torch.kernels.pq_adc import pq_adc, pq_adc_ref
    from repro_torch.kernels.pq_adc.ops import chunk_plan

    qb, d = 64, max(128, m)
    luts = torch.rand(qb, m, 256, device=dev, generator=gen) * 40.0
    codes = torch.randint(0, 256, (n, m), device=dev, generator=gen,
                          dtype=torch.int32).to(torch.uint8)
    out = pq_adc(luts, codes)
    ref = pq_adc_ref(luts, codes)
    seq = torch.zeros(qb, n, device=dev)
    for j in range(m):
        seq += luts[:, j, codes[:, j].long()]
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), seq.view(torch.int32)):
        raise AssertionError("pq_adc differs from the j-ordered f32 sum")
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"pq_adc m={m} differs from the plain version")
    err = (out.double() - ref.double()).abs()
    if not bool((err <= rescore_band(d, ref, 0.0)).all()):
        raise AssertionError(f"pq_adc outside rescore_eps: max err "
                             f"{float(err.max())}")
    del seq
    # library yardstick: one embedding_bag sums rows lut[:, j, code[r, j]]
    # of an (m*256, qb) table, giving out.T (n, qb)
    bags = codes.long() + 256 * torch.arange(m, device=dev)
    table = luts.permute(1, 2, 0).reshape(m * 256, qb).contiguous()
    lib = torch.nn.functional.embedding_bag(bags, table, mode="sum")
    torch.cuda.synchronize()
    lib_err = (lib.T.double() - ref.double()).abs()
    if not bool((lib_err <= rescore_band(d, ref, 0.0)).all()):
        raise AssertionError(f"embedding_bag yardstick outside rescore_eps: "
                             f"max err {float(lib_err.max())}")
    b, by = bound_ms(4 * qb * m * 256 + n * m + 4 * qb * n, qb * n * m)
    lookups = qb * n * m
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(
        name=("pq_adc" if (n, m) == (1 << 20, 8) else f"pq_adc(n={n})"
              if m == 8 else f"pq_adc(m={m})"), route="cuda",
        source="src/repro_torch/csrc/pq_adc.cu",
        replaces="src/repro/kernels/pq_adc/kernel.py:37",
        shape=f"luts {qb}x{m}x256 f32, codes {n}x{m} u8",
        chunks=len(chunk_plan(m)),
        max_abs_err=float(err.max()), bitwise_j_ordered=True,
        ms=cuda_ms(lambda: pq_adc(luts, codes), graph=True),
        plain_ms=cuda_ms(lambda: pq_adc_ref(luts, codes), reps=3, warmup=1),
        bound_ms=b, bound_by=by, lookups=lookups,
        lookup_ms=lookups / (SMEM_WORDS_PER_CLOCK * sms * sm_hz) * 1e3,
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            bags, table, mode="sum"), graph=True))


def seg_topk_inputs(dev, gen, qb=64, n=16384):
    """Random rows plus the edge rows: ties, +inf, -0.0/+0.0, lens < k,
    lens = 0, lens past n, and NaN of both signs and two payloads."""
    import torch

    d = torch.randn(qb, n, device=dev, generator=gen)
    lens = torch.randint(n // 2, n + 1, (qb,), device=dev, generator=gen,
                         dtype=torch.int32)
    d[1] = 1.0                                   # all tied
    d[2] = float("inf")                          # all +inf, full length
    d[3, ::2] = -0.0                             # signed zeros tie by column
    d[3, 1::2] = 0.0
    d[4, : n // 2] = torch.floor(d[4, : n // 2] * 4)   # duplicate values
    lens[5] = 5                                  # lens < k
    lens[6] = 0                                  # empty row
    lens[7] = n + 100                            # clamped to n
    d[8, 100:] = float("inf")                    # genuine +inf past a few hits
    bits = d[9].view(torch.int32)                # NaN: both signs, 2 payloads
    bits[1::7] = 0x7FC00000
    bits[2::7] = 0xFFC00000 - (1 << 32)
    bits[3::11] = 0x7FA00001
    lens[9] = n
    return d.contiguous(), lens.contiguous()


def seg_topk_held(d, lens, ks, n, what):
    """seg_topk at each k of ``ks`` on one (qb, n) block, bit-equal to the
    plain version run on a CPU copy (the card's stable sort orders NaN
    otherwise; whether it agrees is reported).  Returns {k: (max_abs_err,
    plain_on_card_agrees)}."""
    import torch
    from repro_torch.kernels.seg_topk import seg_topk, seg_topk_ref

    # the first k of one full stable sort are the plain version at k
    full_v, full_i = seg_topk_ref(d.cpu(), lens.cpu().clamp(max=n), n)
    held = {}
    for k in ks:
        v, i = seg_topk(d, lens, k)
        vr, ir = full_v[:, :k], full_i[:, :k]
        if not (torch.equal(v.cpu().view(torch.int32), vr.view(torch.int32))
                and torch.equal(i.cpu(), ir)):
            bad = (i.cpu() != ir).any(1).nonzero().flatten().tolist()
            raise AssertionError(f"seg_topk n={n} k={k} on {what} differs "
                                 f"from the stable sort in rows {bad[:8]}")
        vc, ic = seg_topk_ref(d, lens.clamp(max=n), k)
        agrees = bool(torch.equal(vc.cpu().view(torch.int32),
                                  vr.view(torch.int32))
                      and torch.equal(ic.cpu(), ir))
        both = torch.isfinite(v) & torch.isfinite(vr.to(d.device))
        held[k] = (float(torch.where(both, (v - vr.to(d.device)).abs(),
                                     0.0).max()), agrees)
    return held


def check_seg_topk(dev, gen, shapes, flat=None):
    """seg_topk at each (n, k) of ``shapes``, bit-equal to the plain
    version on random rows with the edge rows (``seg_topk_inputs``); with a
    bound and a ``torch.topk`` yardstick at each shape, timed on those rows.
    ``flat`` = (dmat, lens), a (qb, n) block of Flat's own distances with
    every row's lens the index's rows: at its width n, seg_topk is held
    bit-equal on it too, and the time, the bound and ``torch.topk`` are
    taken on it, the input the Flat path gives the kernel.  Returns {(n,
    k): record}."""
    import torch
    from repro_torch.kernels.seg_topk import seg_topk, seg_topk_ref

    qb, rows = 64, {}
    for n in sorted({n for n, _ in shapes}):
        ks = sorted(k for m, k in shapes if m == n)
        d, lens = seg_topk_inputs(dev, gen, qb, n)
        held = seg_topk_held(d, lens, ks, n, "random and edge rows")
        timed_on = "random rows, lens in [n/2, n], edge rows"
        if flat is not None and flat[0].shape[1] == n:
            d, lens = flat
            on_flat = seg_topk_held(d, lens, ks, n, "Flat's distances")
            held = {k: (max(held[k][0], on_flat[k][0]),
                        held[k][1] and on_flat[k][1]) for k in ks}
            timed_on = (f"Flat's distances, {d.shape[0]} queries, lens = "
                        f"{int(lens[0])} on every row")
        live = int(lens.clamp(max=n).sum())
        masked = torch.where(
            torch.arange(n, device=dev)[None] < lens[:, None].clamp(max=n),
            d, torch.full((), float("inf"), device=dev))
        for k in ks:
            b, by = bound_ms(4 * live + 4 * qb + 8 * qb * k, live)
            reps = 5 if k > 4096 else 20
            rows[(n, k)] = dict(
                name=f"seg_topk(n={n},k={k})", route="cuda",
                source="src/repro_torch/csrc/seg_topk.cu",
                replaces="src/repro/kernels/seg_topk/kernel.py:71",
                shape=f"{qb}x{n} f32, k={k}", timed_on=timed_on,
                max_abs_err=held[k][0], plain_on_card_agrees=held[k][1],
                ms=cuda_ms(lambda: seg_topk(d, lens, k), reps=reps,
                           graph=True),
                plain_ms=cuda_ms(lambda: seg_topk_ref(d, lens, k),
                                 reps=reps),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1,
                                                      largest=False),
                                   reps=reps, graph=True))
        del masked
    return rows


def check_l2_top1(dev, gen, nq, k, d):
    """l2_top1 against its plain version: every row's index must be a
    nearest centroid inside ``rescore_eps`` of the plain minimum."""
    import torch
    from repro_torch.kernels.l2_topk import l2_dist_ref, l2_top1, l2_top1_ref
    from repro_torch.kernels.l2_topk.ref import TOP1_CHUNK

    q = torch.randn(nq, d, device=dev, generator=gen)
    c = torch.randn(k, d, device=dev, generator=gen)
    idx, val = l2_top1(q, c)
    ridx, rval = l2_top1_ref(q, c)
    torch.cuda.synchronize()
    band = rescore_band(d, rval, (q.double() ** 2).sum(1))
    at = torch.cat([
        l2_dist_ref(q[i:i + TOP1_CHUNK], c).gather(
            1, idx[i:i + TOP1_CHUNK].long()[:, None])[:, 0]
        for i in range(0, nq, TOP1_CHUNK)])
    if not bool(((at.double() - rval.double()).abs() <= band).all()):
        raise AssertionError(f"l2_top1 ({nq}, {k}, {d}): an index is not a "
                             "nearest centroid inside rescore_eps")
    err = (val.double() - rval.double()).abs()
    band_use = float((err / band).max())
    if not band_use <= 1.0:
        raise AssertionError(f"l2_top1 ({nq}, {k}, {d}) values outside "
                             f"rescore_eps: max err {float(err.max())}, "
                             f"{band_use} of the band")
    cn = (c * c).sum(1)[None]

    def chunked_addmm_min():
        # the yardstick: assign's chunked addmm + min before the kernel
        for i in range(0, nq, TOP1_CHUNK):
            sl = q[i:i + TOP1_CHUNK]
            torch.addmm(cn, sl, c.T, alpha=-2.0).add_(
                (sl * sl).sum(1, keepdim=True)).min(1)

    b, by, b32 = l2_bounds(4 * (nq * d + k * d + 2 * nq), nq, k, d)
    return dict(
        name="l2_top1" if (k, d) == (NLIST, 128) else f"l2_top1(K={k},d={d})",
        route="cuda", source="src/repro_torch/csrc/l2_top1.cu",
        replaces="src/repro/kernels/l2_topk/kernel.py:39",
        shape=f"rows {nq}x{d}, centroids {k}x{d} f32",
        max_abs_err=float(err.max()), band_use=band_use,
        idx_differ=int((idx != ridx).sum()),
        ms=cuda_ms(lambda: l2_top1(q, c), reps=10),
        plain_ms=cuda_ms(lambda: l2_top1_ref(q, c), reps=5, warmup=1),
        bound_ms=b, bound_by=by, bound_f32_ms=b32,
        library_ms=cuda_ms(chunked_addmm_min, reps=5, warmup=1))


def rans_stream(lanes, rows, seed):
    """(symbols (rows, lanes), heads, words, tables, r) on gap_ans's own
    quotient model, encoded by the port's 32/16 coder."""
    import numpy as np
    from repro_torch.core import gap_ans
    from repro_torch.core.vrans import VRans16Encoder
    from repro_torch.kernels.rans_decode import make_tables

    r, freqs, starts = gap_ans._Q_PRECISION, gap_ans._QF, gap_ans._QC
    rng = np.random.default_rng(seed)
    data = rng.choice(gap_ans._Q_SYMBOLS, size=(rows, lanes),
                      p=freqs / freqs.sum())
    enc = VRans16Encoder(lanes)
    for t in range(rows - 1, -1, -1):
        enc.push(starts[data[t]], freqs[data[t]], r)
    heads, words = enc.finalize()
    return data, heads, words, make_tables(freqs, r), r


def rans_args(dev, heads, words, tables):
    import numpy as np
    import torch

    return [torch.from_numpy(heads.view(np.int32)).to(dev),
            torch.from_numpy(words.astype(np.int32)).to(dev),
            *(torch.from_numpy(t).to(dev) for t in tables)]


def check_rans_decode(dev, lanes, rows, sm_hz):
    """rans_decode bit-equal to the plain step loop run on a CPU copy and to
    the symbols; ``step_cycles`` is one step's time at the top SM clock."""
    import numpy as np
    import torch
    from repro_torch.kernels.rans_decode import rans_decode, rans_decode_ref

    data, heads, words, tables, r = rans_stream(lanes, rows, seed=lanes)
    args = rans_args(dev, heads, words, tables)
    out = rans_decode(*args, rows=rows, r=r)
    ref = rans_decode_ref(*(a.cpu() for a in args), rows=rows, r=r)
    if not (torch.equal(out.cpu(), ref)
            and np.array_equal(out.cpu().numpy(), data)):
        raise AssertionError(f"rans_decode L={lanes} rows={rows} differs "
                             "from the symbols or the plain version")
    # bytes: heads, words (int32 here), three tables, the symbols; the
    # integer operations (~12 a symbol) never decide the bound
    b, by = bound_ms(4 * (lanes + len(words) + 3 * (1 << r) + rows * lanes),
                     12 * rows * lanes)
    ms = cuda_ms(lambda: rans_decode(*args, rows=rows, r=r), reps=5,
                 graph=True)
    return dict(
        name="rans_decode" if (lanes, rows) == RANS_SHAPES[0] else
        f"rans_decode(L={lanes},rows={rows})",
        route="cuda", source="src/repro_torch/csrc/rans_decode.cu",
        replaces="src/repro/kernels/rans_decode/kernel.py:62",
        shape=f"L={lanes} rows={rows} r={r} words={len(words)}",
        max_abs_err=0.0, ms=ms, step_cycles=ms * 1e-3 * sm_hz / rows,
        plain_ms=cuda_ms(lambda: rans_decode_ref(*args, rows=rows, r=r),
                         reps=1, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None)


def wavelet_level0(cluster_of):
    """Level 0 of the port's wavelet tree over an IVF assignment."""
    from repro_torch.core.wavelet_tree import WaveletTree

    return WaveletTree.build(cluster_of, NLIST).levels[0]


def wt_rank_args(dev, gen, level0):
    import numpy as np
    import torch
    from repro_torch.kernels.wt_rank import pack_bits_u32

    words, sup = pack_bits_u32(level0.bits())
    q = torch.randint(0, level0.nbits + 1, (WT_QUERIES,), device=dev,
                      generator=gen, dtype=torch.int32)
    return [torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(sup).to(dev), q]


def wt_rank_large_args(dev, gen):
    """A random bitvector of WT_LARGE_BITS bits (too large for shared
    memory) and its ``BitVector``, with WT_QUERIES random queries."""
    import numpy as np
    import torch
    from repro_torch.core.bitvec import BitVector
    from repro_torch.kernels.wt_rank import pack_bits_u32

    bits = np.random.default_rng(7).random(WT_LARGE_BITS) < 0.5
    words, sup = pack_bits_u32(bits.astype(np.uint8))
    q = torch.randint(0, WT_LARGE_BITS + 1, (WT_QUERIES,), device=dev,
                      generator=gen, dtype=torch.int32)
    return [torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(sup).to(dev), q], BitVector.from_bits(bits)


def check_wt_rank(args, bitvec, what):
    """wt_rank bit-equal to the plain version run on a CPU copy and to
    ``BitVector``; the route the wrapper took."""
    import numpy as np
    import torch
    from repro_torch.kernels.wt_rank import wt_rank, wt_rank_ref

    words, sup, q = args
    before = dict(wt_rank.routes)
    out = wt_rank(*args)
    (route,) = [r for r, n in wt_rank.routes.items() if n != before.get(r, 0)]
    if not (torch.equal(out.cpu(), wt_rank_ref(*(a.cpu() for a in args)))
            and np.array_equal(out.cpu().numpy(),
                               bitvec.rank1_batch(q.cpu().numpy()))):
        raise AssertionError("wt_rank differs from the plain version or "
                             "BitVector.rank1_batch")
    # bytes: words, superblock counts, queries and ranks once each; ops:
    # a popcount and an add per word each query needs (never decides)
    qs = q.long()
    ops = 2 * int((((qs >> 5) & 15) + ((qs & 31) > 0).long() + 1).sum())
    b, by = bound_ms(4 * (words.numel() + sup.numel() + 2 * q.numel()), ops)
    return dict(
        name="wt_rank", route="cuda", source="src/repro_torch/csrc/wt_rank.cu",
        replaces="src/repro/kernels/wt_rank/kernel.py:54",
        shape=f"{bitvec.nbits} bits ({what}), {q.numel()} queries",
        kernel_route=route,
        max_abs_err=0.0, ms=cuda_ms(lambda: wt_rank(*args), graph=True),
        plain_ms=cuda_ms(lambda: wt_rank_ref(*args), reps=5),
        bound_ms=b, bound_by=by, library_ms=None)


def exact_topk(base_dev, q_dev, k):
    """Ground-truth neighbours for recall (the harness's own yardstick)."""
    import torch

    out = []
    bn = (base_dev * base_dev).sum(1)
    for i in range(0, q_dev.shape[0], 256):
        q = q_dev[i:i + 256]
        d = (q * q).sum(1, keepdim=True) - 2.0 * q @ base_dev.T + bn[None]
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def serve_pass(svc, queries):
    """Submit ``queries`` as 4-query requests, flush; (tickets, report)."""
    import numpy as np

    svc.reset_stats()
    t = time.perf_counter()
    tickets = [svc.submit(queries[i:i + REQUEST])
               for i in range(0, len(queries), REQUEST)]
    svc.flush()
    wall = time.perf_counter() - t
    lat = np.array([tk.latency_s for tk in tickets])
    st = svc.stats()
    report = dict(
        qps=len(queries) / wall, serve_s=wall,
        p50_latency_ms=float(np.quantile(lat, 0.5)) * 1e3,
        p99_latency_ms=float(np.quantile(lat, 0.99)) * 1e3,
        search_s=st["search_s"], resolve_s=st["resolve_s"],
        decodes=st["decodes"], batches=st["batches"],
        mean_batch=st["mean_batch"], device_selects=st["device_selects"],
        host_block_bytes=st["host_block_bytes"])
    if getattr(svc, "steps", 0):     # a graph index's beam steps
        report.update(steps=svc.steps, dedup_hits=svc.dedup_hits)
    if "merge_s" in st:              # a sharded service
        report.update(merge_s=st["merge_s"],
                      merge_share=st["merge_s"] / st["search_s"],
                      shards=st["shards"],
                      partial_batches=st["partial_batches"])
    return tickets, report


def results(tickets):
    """(ids, dists) of a pass's tickets, in request order."""
    import numpy as np

    return (np.concatenate([tk.ids for tk in tickets]),
            np.concatenate([tk.dists for tk in tickets]))


def hold_equal(what, got, want):
    """Ids and dists ``np.array_equal`` (bit for bit), or raise."""
    import numpy as np

    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        rows = int((~((got[0] == want[0]) & (got[1] == want[1]))).any(1)
                   .sum())
        raise AssertionError(f"{what}: differs from the monolith in {rows} "
                             f"of {len(want[0])} queries")


def check_parity(spec, idx, tickets, queries):
    """Served results of the right shape, finite, and equal to
    ``search_ref`` on the first 64 queries."""
    import numpy as np

    ids = np.concatenate([tk.ids for tk in tickets])
    dists = np.concatenate([tk.dists for tk in tickets])
    if ids.shape != (len(queries), TOPK) or not np.isfinite(dists).all():
        raise AssertionError(f"{spec}: bad result shape or non-finite dists")
    ids_r, d_r, _ = idx.ivf.search_ref(queries[:64], nprobe=NPROBE, topk=TOPK)
    if not (np.array_equal(ids[:64], ids_r)
            and np.array_equal(dists[:64], d_r)):
        raise AssertionError(f"{spec}: served results differ from "
                             "search_ref")
    return ids


def serve(spec, base, queries, gt, adds, device):
    """Build ``spec`` on ``device`` and serve ``queries`` through AnnService
    twice (decoded-id cache cold, then warm); then ingest ``adds`` one
    ``add`` call each and serve the queries again.  The launch counts are
    set to 0 before the build and read after the last pass.  Returns
    (report, launch counts, launch shapes, the built index's assignment,
    the index)."""
    import numpy as np
    import torch
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy

    reset_launches()
    t = time.perf_counter()
    idx = index_factory(spec, device=device).build(base, seed=1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    build_top1 = launch_counts()["l2_top1"]
    cluster_of = np.array(idx.ivf.cluster_of, np.int64)
    svc = AnnService(idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
                     device=device, nprobe=NPROBE)
    cold_t, cold = serve_pass(svc, queries)
    warm_t, warm = serve_pass(svc, queries)
    for tickets in (cold_t, warm_t):
        ids = check_parity(spec, idx, tickets, queries)
    recall = recall_at_10(ids, gt)
    bits_built = idx.ivf.bits_per_id()

    top1 = launch_counts()["l2_top1"]
    t = time.perf_counter()
    for x in adds:
        svc.add(x)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t
    ingest_top1 = launch_counts()["l2_top1"] - top1
    if idx.ivf.n != base.shape[0] + sum(len(x) for x in adds):
        raise AssertionError(f"{spec}: {idx.ivf.n} ids after ingest")
    grown_t, grown = serve_pass(svc, queries)
    counts, shapes = launch_counts(), launch_shapes()
    check_parity(spec, idx, grown_t, queries)
    return dict(
        spec=spec, n=int(base.shape[0]), build_s=build_s,
        recall_at_10=recall, bits_per_id=bits_built,
        cold=cold, warm=warm, parity_vs_search_ref=True,
        ingest=dict(adds=len(adds), rows=int(sum(len(x) for x in adds)),
                    add_s=add_s, epochs=idx.ivf.n_epochs, n=int(idx.ivf.n),
                    bits_per_id=idx.ivf.bits_per_id(),
                    l2_top1_launches_build=build_top1,
                    l2_top1_launches_ingest=ingest_top1,
                    served=grown, parity_vs_search_ref=True),
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes, \
        cluster_of, idx


def recall_at_10(ids, gt):
    import numpy as np

    return float(np.mean([len(set(a) & set(b)) / TOPK
                          for a, b in zip(ids, gt)]))


def serve_flat(base, queries, gt, device):
    """Build ``Flat`` on ``device`` and serve ``queries`` through AnnService
    twice (the first pass uploads the padded base); launch counts set to 0
    before the build and read after the second pass.  Results must equal a
    CPU ``FlatIndex`` (the numpy loop) on the first 64 queries and reach
    recall@10 1.0.  Returns (report, counts, shapes, the index)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from repro_torch.api import make_index
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy

    reset_launches()
    t = time.perf_counter()
    idx = make_index("Flat", device=device).build(base)
    build_s = time.perf_counter() - t
    svc = AnnService(idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
                     device=device)
    first_t, first = serve_pass(svc, queries)
    second_t, second = serve_pass(svc, queries)
    torch.cuda.synchronize()
    counts, shapes = launch_counts(), launch_shapes()
    if svc.last_stats.engine != "flat-pallas":
        raise AssertionError(f"Flat served by {svc.last_stats.engine}")
    # each query's loop is its own, and numpy's scoring and sort release
    # the GIL: the 64 queries in FLAT_LOOP_THREADS pieces give the same
    # results as one call
    t = time.perf_counter()
    cpu = make_index("Flat", device="cpu").build(base)
    with ThreadPoolExecutor(FLAT_LOOP_THREADS) as pool:
        parts = list(pool.map(lambda q: cpu.search(q, k=TOPK), np.array_split(
            queries[:64], FLAT_LOOP_THREADS)))
    loop_s = time.perf_counter() - t
    if {st.engine for _, _, st in parts} != {"flat"}:
        raise AssertionError("CPU Flat ran another engine than the loop")
    d_cpu = np.concatenate([d for d, _, _ in parts])
    ids_cpu = np.concatenate([i for _, i, _ in parts])
    for tickets in (first_t, second_t):
        ids = np.concatenate([tk.ids for tk in tickets])
        dists = np.concatenate([tk.dists for tk in tickets])
        if ids.shape != (len(queries), TOPK) or not np.isfinite(dists).all():
            raise AssertionError("Flat: bad result shape or non-finite dists")
        if not (np.array_equal(ids[:64], ids_cpu)
                and np.array_equal(dists[:64], d_cpu)):
            raise AssertionError("Flat: served results differ from the "
                                 "numpy loop")
    recall = recall_at_10(ids, gt)
    if recall != 1.0:
        raise AssertionError(f"Flat recall@10 {recall} against exact search")
    return dict(
        spec="Flat", n=int(base.shape[0]), build_s=build_s,
        recall_at_10=recall, first=first, second=second,
        parity_vs_numpy_loop=True, numpy_loop_s_64_queries=loop_s,
        numpy_loop_threads=FLAT_LOOP_THREADS,
        launches=counts, shapes=shape_report(counts, shapes)), counts, \
        shapes, idx


def container_path(name, idx, opts, queries, device):
    """``save_index`` and ``load_index(device=...)`` of one index: pack and
    unpack seconds, blob MB, bits per id and epochs equal, and search
    (with ``opts``) after reload equal to search before over all
    ``queries``.  Launch counts set to 0 before and read after.  Returns
    (report, counts, shapes)."""
    import numpy as np
    import torch
    from repro_torch.api import load_index, save_index
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)

    reset_launches()
    d0, i0, _ = idx.search(queries, k=TOPK, **opts)
    t = time.perf_counter()
    blob = save_index(idx)
    pack_s = time.perf_counter() - t
    t = time.perf_counter()
    back = load_index(blob, device=device)
    torch.cuda.synchronize()
    unpack_s = time.perf_counter() - t
    rec = dict(index=name, spec=idx.spec, blob_mb=len(blob) / 2**20,
               pack_s=pack_s, unpack_s=unpack_s)
    del blob
    if back.spec != idx.spec or back.device != idx.device:
        raise AssertionError(f"{name}: reloaded as {back.spec} on "
                             f"{back.device}")
    inner, inner2 = getattr(idx, "ivf", None), getattr(back, "ivf", None)
    if inner is not None:
        rec.update(bits_per_id=inner2.bits_per_id(),
                   epochs=inner2.n_epochs)
        if (inner2.bits_per_id() != inner.bits_per_id()
                or inner2.n_epochs != inner.n_epochs):
            raise AssertionError(f"{name}: bits per id or epochs differ "
                                 "after reload")
    t = time.perf_counter()
    d1, i1, st = back.search(queries, k=TOPK, **opts)
    rec.update(search_after_reload_s=time.perf_counter() - t,
               engine=st.engine)
    if not (np.array_equal(i1, i0) and np.array_equal(d1, d0)):
        raise AssertionError(f"{name}: search after reload differs")
    rec["search_equal_after_reload"] = True
    del back
    counts, shapes = launch_counts(), launch_shapes()
    return dict(rec, launches=counts), counts, shapes


def sharded_service(plan, device, **opts):
    """A ShardedAnnService over ``plan`` with the main path's batching."""
    from repro_torch.serve import BatchPolicy
    from repro_torch.shard import ShardedAnnService

    return ShardedAnnService(plan, topk=TOPK,
                             policy=BatchPolicy(max_batch=MAX_BATCH),
                             device=device, **opts)


def timed(fn):
    """(fn(), seconds), the card synchronised before the clock stops."""
    import torch

    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def shard_ivf_path(idx, queries, add_x, device):
    """Sharded serving of the built ``IVF1024,ids=roc`` index (after its
    ingest): the monolith served warm through AnnService; each plan of
    SHARD_IVF served cold (the monolith's decoded-id cache budget split
    across the shards) and warm through ShardedAnnService, ids and dists
    equal to the monolith's on every query; then one routed add of
    ``add_x`` to the monolith and to both 4-shard services: every shard's
    n and epochs equal the monolith's, results equal again.  Counts set to
    0 before and read after.  Returns (report, counts, shapes)."""
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy
    from repro_torch.shard import plan_shards

    reset_launches()
    mono_svc = AnnService(idx, topk=TOPK,
                          policy=BatchPolicy(max_batch=MAX_BATCH),
                          device=device, nprobe=NPROBE)
    mono_t, mono = serve_pass(mono_svc, queries)
    want = results(mono_t)
    budget_mb = idx.ivf.decoded_cache.max_bytes / 2**20
    plans, keep = [], {}
    for nshards, by in SHARD_IVF:
        plan, plan_s = timed(lambda: plan_shards(idx, nshards, by=by))
        svc = sharded_service(plan, device, cache_mb=budget_mb,
                              nprobe=NPROBE)
        cold_t, cold = serve_pass(svc, queries)
        warm_t, warm = serve_pass(svc, queries)
        for tickets in (cold_t, warm_t):
            hold_equal(f"{idx.spec} on {nshards} shards by {by}",
                       results(tickets), want)
        plans.append(dict(
            nshards=nshards, by=by, plan_s=plan_s,
            n_local=[info.n_local for info in plan.shards], cold=cold,
            warm=warm, warm_qps_over_monolith=warm["qps"] / mono["qps"],
            equal_on_all_queries=True))
        if nshards == 4:
            keep[by] = svc
        else:
            svc.close()
        del plan
    _, mono_add_s = timed(lambda: mono_svc.add(add_x))
    grown_t, grown = serve_pass(mono_svc, queries)
    want = results(grown_t)
    adds = []
    for by, svc in keep.items():
        _, add_s = timed(lambda: svc.add(add_x))
        got = [(sh.ivf.n, sh.ivf.n_epochs) for sh in svc.plan.indexes]
        if set(got) != {(idx.ivf.n, idx.ivf.n_epochs)}:
            raise AssertionError(f"routed add by {by}: shards at (n, "
                                 f"epochs) {got}, the monolith at "
                                 f"{(idx.ivf.n, idx.ivf.n_epochs)}")
        g_t, g = serve_pass(svc, queries)
        hold_equal(f"{idx.spec} on 4 shards by {by} after a routed add",
                   results(g_t), want)
        adds.append(dict(by=by, add_s=add_s, served=g,
                         equal_on_all_queries=True))
        svc.close()
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec=idx.spec, cache_mb=budget_mb, monolith_warm=mono, plans=plans,
        routed_add=dict(rows=len(add_x), monolith_add_s=mono_add_s,
                        n=int(idx.ivf.n), epochs=idx.ivf.n_epochs,
                        monolith_served=grown, sharded=adds),
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes


def shard_pq_path(base, queries, device):
    """``IVF1024,PQ8x8,ids=roc,codes=polya`` built on the card over the
    first SHARD_PQ_N vectors, served through AnnService (cold, warm), then
    planned onto 2 shards by hash (each shard's Pólya codes re-encoded on
    the host) and served cold and warm through ShardedAnnService, equal to
    the monolith on every query.  Counts set to 0 before the build and
    read after.  Returns (report, counts, shapes)."""
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy
    from repro_torch.shard import plan_shards

    reset_launches()
    x = base[:SHARD_PQ_N]
    idx, build_s = timed(lambda: index_factory(SPECS[1], device=device)
                         .build(x, seed=1))
    mono_svc = AnnService(idx, topk=TOPK,
                          policy=BatchPolicy(max_batch=MAX_BATCH),
                          device=device, nprobe=NPROBE)
    serve_pass(mono_svc, queries)
    mono_t, mono = serve_pass(mono_svc, queries)
    want = results(mono_t)
    plan, plan_s = timed(lambda: plan_shards(idx, 2, by="hash"))
    budget_mb = idx.ivf.decoded_cache.max_bytes / 2**20
    with sharded_service(plan, device, cache_mb=budget_mb,
                         nprobe=NPROBE) as svc:
        cold_t, cold = serve_pass(svc, queries)
        warm_t, warm = serve_pass(svc, queries)
    for tickets in (cold_t, warm_t):
        hold_equal(f"{idx.spec} at n={len(x)} on 2 shards", results(tickets),
                   want)
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec=idx.spec, n=len(x), build_s=build_s, plan_s=plan_s,
        bits_per_code=[sh.ivf.code_bits_per_element()
                       for sh in plan.indexes],
        monolith_bits_per_code=idx.ivf.code_bits_per_element(),
        monolith_warm=mono, cold=cold, warm=warm, equal_on_all_queries=True,
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes


def save_load_plan(plan, device):
    """``plan.save`` into a temporary directory under the git-ignored
    ``build/`` and ``ShardPlan.load`` onto ``device``: (loaded plan,
    pack s, unpack s, MB on disk)."""
    import tempfile

    from repro_torch.shard import ShardPlan

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        _, pack_s = timed(lambda: plan.save(tmp))
        mb = sum(f.stat().st_size for f in Path(tmp).iterdir()) / 2**20
        loaded, unpack_s = timed(lambda: ShardPlan.load(tmp, device=device))
    return loaded, pack_s, unpack_s, mb


def shard_flat_path(idx, queries, device):
    """The 1M ``Flat`` index on 4 shards by hash: served twice through
    ShardedAnnService (the first pass uploads each shard's base), equal to
    the monolith's AnnService pass on every query; the plan saved and
    loaded onto the card, served again, equal.  Counts set to 0 before and
    read after.  Returns (report, counts, shapes)."""
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy
    from repro_torch.shard import plan_shards

    reset_launches()
    mono_t, mono = serve_pass(AnnService(
        idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
        device=device), queries)
    want = results(mono_t)
    plan, plan_s = timed(lambda: plan_shards(idx, 4))
    with sharded_service(plan, device) as svc:
        first_t, first = serve_pass(svc, queries)
        second_t, second = serve_pass(svc, queries)
    for tickets in (first_t, second_t):
        hold_equal("Flat on 4 shards", results(tickets), want)
    loaded, pack_s, unpack_s, mb = save_load_plan(plan, device)
    del plan
    with sharded_service(loaded, device) as svc:
        back_t, back = serve_pass(svc, queries)
    hold_equal("Flat on 4 shards after save and load", results(back_t), want)
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec="Flat", n=int(idx.n), plan_s=plan_s,
        n_local=[info.n_local for info in loaded.shards], monolith=mono,
        first=first, second=second, plan_mb=mb, pack_s=pack_s,
        unpack_s=unpack_s, after_reload=back, equal_on_all_queries=True,
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes


def shard_container_path(base, queries, device):
    """``IVF1024,ids=roc`` built over the first SHARD_CONTAINER_N vectors,
    planned onto 4 shards by hash, the plan saved and loaded onto the card
    (pack / unpack seconds, MB), and the loaded plan served equal to the
    monolith on every query.  Counts set to 0 before and read after.
    Returns (report, counts, shapes, the loaded plan)."""
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.shard import plan_shards

    reset_launches()
    x = base[:SHARD_CONTAINER_N]
    idx = index_factory(SPECS[0], device=device).build(x, seed=1)
    d0, i0, _ = idx.search(queries, k=TOPK, nprobe=NPROBE)
    plan = plan_shards(idx, 4, by="hash")
    loaded, pack_s, unpack_s, mb = save_load_plan(plan, device)
    with sharded_service(loaded, device, nprobe=NPROBE) as svc:
        served_t, served = serve_pass(svc, queries)
    hold_equal(f"{idx.spec} at n={len(x)} on 4 shards after save and load",
               results(served_t), (i0, d0))
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec=idx.spec, n=len(x), plan_mb=mb, pack_s=pack_s,
        unpack_s=unpack_s, served=served, equal_on_all_queries=True,
        launches=counts, shapes=shape_report(counts, shapes)), counts, \
        shapes, loaded


def merge_by_dist_id(parts, k):
    """Each query's ``k`` smallest ``(dist, id)`` pairs over the shards'
    ``(ids, dists)``, one query at a time in Python: the graph shards'
    merge rule, written independently of the router's."""
    import numpy as np

    nq = parts[0][0].shape[0]
    ids = np.zeros((nq, k), np.int64)
    dists = np.full((nq, k), np.inf, np.float32)
    for qi in range(nq):
        pairs = sorted((float(d), int(i)) for ids_s, d_s in parts
                       for d, i in zip(d_s[qi], ids_s[qi]) if np.isfinite(d))
        for j, (d, i) in enumerate(pairs[:k]):
            ids[qi, j], dists[qi, j] = i, d
    return ids, dists


def exact_over(x, nodes, q, k):
    """The ``k`` smallest ``(dist, id)`` over ``nodes`` (global ids into
    ``x``) for each query, dists by the graph search's own numpy
    expression: (ids, dists)."""
    import numpy as np

    ids = np.zeros((len(q), k), np.int64)
    dists = np.full((len(q), k), np.inf, np.float32)
    for qi in range(len(q)):
        d = np.sum((x[nodes] - q[qi]) ** 2, axis=1)
        top = np.lexsort((nodes, d))[:k]
        ids[qi, :len(top)], dists[qi, :len(top)] = nodes[top], d[top]
    return ids, dists


def shard_graph_path(nav_idx, queries, gt, device):
    """The navigable ``NSG32,ids=roc`` index on SHARD_GRAPH shards by hash
    (each shard's graph rebuilt on the card), served cold and warm through
    ShardedAnnService (ef = GRAPH_EF): every shard's results equal its own
    ``search_ref`` on the first 64 queries, and the merged results equal an
    independent merge of the shards' results on every query; the shards'
    reachable share and the merged recall@10.  Then the reference's
    exhaustive regime over the first SHARD_EXHAUSTIVE_N vectors (ef =
    SHARD_EXHAUSTIVE_EF >= n): the monolith and every shard return the
    exact top-10 over the nodes reachable from their entries, the merge
    equals the merge of the shards, and the merge equals the monolith on
    every query whose exact top-10 lies inside the nodes reachable in both
    (the precondition of exhaustive parity; the other queries are
    counted).  Counts set to 0 before and read after.  Returns (report,
    counts, shapes)."""
    import numpy as np
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.shard import plan_shards

    reset_launches()
    plan, plan_s = timed(lambda: plan_shards(nav_idx, SHARD_GRAPH, seed=0))
    with sharded_service(plan, device, ef=GRAPH_EF) as svc:
        cold_t, cold = serve_pass(svc, queries)
        warm_t, warm = serve_pass(svc, queries)
    got = results(warm_t)
    hold_equal("NSG32 shards, cold against warm", results(cold_t), got)
    parts, shard_rows = [], []
    for sh in plan.indexes:
        g = sh.graph
        d, i, _ = sh.search(queries, k=TOPK, ef=GRAPH_EF)
        i_r, d_r, _ = g.search_ref(queries[:64], ef=GRAPH_EF, topk=TOPK)
        i_r = np.where(np.isfinite(d_r), g.id_map[i_r], 0)
        hold_equal("an NSG32 shard against its search_ref",
                   (i[:64], d[:64]), (i_r, d_r))
        parts.append((i, d))
        reach = reachable_from_entry(g.adj_raw, g.entry)
        shard_rows.append(dict(n=int(g.n), reachable_share=reach / g.n,
                               bits_per_edge=g.bits_per_edge()))
    hold_equal("NSG32 shards against a merge of the shards' results", got,
               merge_by_dist_id(parts, TOPK))

    # the exhaustive regime
    x = nav_idx.graph.x[:SHARD_EXHAUSTIVE_N]
    q = queries[:SHARD_EXHAUSTIVE_Q]
    small = index_factory(nav_idx.spec, device=device).build(x)
    splan = plan_shards(small, SHARD_GRAPH, seed=0)
    ef = SHARD_EXHAUSTIVE_EF
    d_m, i_m, _ = small.search(q, k=TOPK, ef=ef)
    with sharded_service(splan, device, ef=ef) as svc:
        merged = svc.search(q)
    reach_m = np.flatnonzero(reachable_mask(small.graph.adj_raw,
                                            small.graph.entry))
    hold_equal("exhaustive NSG32 monolith against the exact top-10 over "
               "its reachable nodes", (i_m, d_m),
               exact_over(x, reach_m, q, TOPK))
    sparts, reach_s = [], []
    for sh in splan.indexes:
        g = sh.graph
        d, i, _ = sh.search(q, k=TOPK, ef=ef)
        r = g.id_map[reachable_mask(g.adj_raw, g.entry)]
        hold_equal("an exhaustive NSG32 shard against the exact top-10 "
                   "over its reachable nodes", (i, d),
                   exact_over(x, r, q, TOPK))
        sparts.append((i, d))
        reach_s.append(r)
    hold_equal("exhaustive NSG32 shards against a merge of the shards",
               merged, merge_by_dist_id(sparts, TOPK))
    exact, _ = exact_over(x, np.arange(len(x)), q, TOPK)
    both = np.intersect1d(reach_m, np.concatenate(reach_s))
    held = np.isin(exact, both).all(1)
    hold_equal("exhaustive NSG32 shards against the monolith where every "
               "exact top-10 node is reachable in both",
               (merged[0][held], merged[1][held]), (i_m[held], d_m[held]))
    same = ((merged[0] == i_m) & (merged[1] == d_m)).all(1)
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec=nav_idx.spec, n=int(nav_idx.graph.n), ef=GRAPH_EF,
        plan_s=plan_s, shards=shard_rows, cold=cold, warm=warm,
        recall_at_10=recall_at_10(got[0], gt),
        shards_equal_search_ref_64=True, merge_equal_on_all_queries=True,
        exhaustive=dict(
            n=len(x), ef=ef, queries=len(q),
            reachable=[len(reach_m)] + [len(r) for r in reach_s],
            precondition_held=int(held.sum()),
            equal_to_monolith=int(same.sum()),
            equal_where_held=True),
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes


def degraded_passes(plan, queries, device):
    """Not counted, and run after every counted path: ``ScriptedFaults(
    dead=[1])`` must give ``stats.partial`` with no result id of shard 1,
    and ``ScriptedFaults(flaky={0: 1})`` the full results after one
    retry."""
    import numpy as np
    from repro_torch.shard import RetryPolicy, ScriptedFaults

    no_sleep = RetryPolicy(sleep=lambda s: None)
    with sharded_service(plan, device, nprobe=NPROBE) as svc:
        want = svc.search(queries)
    with sharded_service(plan, device, nprobe=NPROBE, retry=no_sleep,
                         fault_policy=ScriptedFaults(dead=[1])) as svc:
        ids, dists, st = svc.search(queries, with_stats=True)
    dead = np.concatenate([lst for lst in plan.indexes[1].ivf._lists
                           if len(lst)])
    if not (st.partial and st.shards_failed == 1
            and np.isfinite(dists[:, 0]).all()
            and not np.isin(ids[np.isfinite(dists)], dead).any()):
        raise AssertionError(f"dead shard 1: partial={st.partial}, "
                             f"failed={st.shards_failed}, or its ids served")
    with sharded_service(plan, device, nprobe=NPROBE, retry=no_sleep,
                         fault_policy=ScriptedFaults(flaky={0: 1})) as svc:
        ids_f, dists_f, st_f = svc.search(queries, with_stats=True)
    if st_f.partial or st_f.retries != 1:
        raise AssertionError(f"flaky shard 0: partial={st_f.partial}, "
                             f"retries={st_f.retries}")
    hold_equal("a flaky shard after its retry", (ids_f, dists_f), want)
    return dict(dead=dict(shard=1, partial=True, shards_failed=1,
                          ids_of_dead_shard_served=0),
                flaky=dict(shard=0, retries=1, partial=False,
                           equal_to_full=True))


def reachable_from_entry(adj, entry):
    """How many nodes a search can reach from ``entry``."""
    return int(reachable_mask(adj, entry).sum())


def reachable_mask(adj, entry):
    """Nodes a search can reach: those on a directed path from ``entry``
    (a frontier expansion over the friend lists), as a bool mask."""
    import numpy as np

    lens = np.fromiter((len(a) for a in adj), np.int64, len(adj))
    flat = np.concatenate(adj)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    seen = np.zeros(len(adj), bool)
    seen[entry] = True
    front = np.array([entry])
    while front.size:
        cnt = lens[front]
        pos = np.repeat(start[front] - np.cumsum(cnt) + cnt, cnt) + \
            np.arange(int(cnt.sum()))
        nb = np.unique(flat[pos])
        front = nb[~seen[nb]]
        seen[front] = True
    return seen


def check_graph_parity(spec, idx, tickets, queries):
    """Served graph results of the right shape, finite, and equal to the
    index's own ``search_ref`` on the first 64 queries."""
    import numpy as np

    ids = np.concatenate([tk.ids for tk in tickets])
    dists = np.concatenate([tk.dists for tk in tickets])
    if ids.shape != (len(queries), TOPK) or not np.isfinite(dists).all():
        raise AssertionError(f"{spec}: bad result shape or non-finite dists")
    ids_r, d_r, _ = idx.graph.search_ref(queries[:64], ef=GRAPH_EF,
                                         topk=TOPK)
    if not (np.array_equal(ids[:64], ids_r)
            and np.array_equal(dists[:64], d_r)):
        raise AssertionError(f"{spec}: served results differ from "
                             "search_ref")
    return ids


def serve_graph(spec, base, queries, gt, adds, device, floor=None):
    """Build the graph ``spec`` on ``device`` (stage seconds from
    ``build_s``) and serve ``queries`` through AnnService (``ef``) cold and
    warm; then, when ``adds`` are given, ingest them one ``add`` call each
    and serve again.  Parity with ``search_ref`` on the first 64 queries
    after each pass; recall@10 against ``gt``, and the share of nodes a
    search can reach from the entry, each held to ``floor`` when given.
    Launch counts are set to 0 before the build and read after the last
    pass.  Returns (report, counts, shapes, the index, its first
    GRAPH_CHECK_NODES friend lists as built)."""
    import torch
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy

    reset_launches()
    t = time.perf_counter()
    idx = index_factory(spec, device=device).build(base)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    built_head = [a.copy() for a in idx.graph.adj_raw[:GRAPH_CHECK_NODES]]
    build_launches = launch_counts()
    svc = AnnService(idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
                     device=device, ef=GRAPH_EF)
    cold_t, cold = serve_pass(svc, queries)
    warm_t, warm = serve_pass(svc, queries)
    for tickets in (cold_t, warm_t):
        ids = check_graph_parity(spec, idx, tickets, queries)
    reach = reachable_from_entry(idx.graph.adj_raw, idx.graph.entry)
    report = dict(
        spec=spec, n=int(base.shape[0]), ef=GRAPH_EF, build_s=build_s,
        build_stages_s=dict(idx.build_s),
        edges=int(sum(len(a) for a in idx.graph.adj_raw)),
        bits_per_edge=idx.graph.bits_per_edge(),
        reachable_from_entry=reach, reachable_share=reach / base.shape[0],
        recall_at_10=recall_at_10(ids, gt), cold=cold, warm=warm,
        parity_vs_search_ref=True, build_launches=build_launches)
    if floor is not None:
        low = {k: report[k] for k, v in floor.items() if report[k] < v}
        if low:
            raise AssertionError(f"{spec} at n={base.shape[0]}: {low} below "
                                 f"the floors {floor}")
        report["floor"] = floor
    if adds:
        t = time.perf_counter()
        for x in adds:
            svc.add(x)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t
        if idx.graph.n != base.shape[0] + sum(len(x) for x in adds):
            raise AssertionError(f"{spec}: {idx.graph.n} nodes after ingest")
        grown_t, grown = serve_pass(svc, queries)
        check_graph_parity(spec, idx, grown_t, queries)
        report["ingest"] = dict(
            adds=len(adds), rows=int(sum(len(x) for x in adds)), add_s=add_s,
            epochs=idx.graph.n_epochs, n=int(idx.graph.n),
            bits_per_edge=idx.graph.bits_per_edge(), served=grown,
            parity_vs_search_ref=True)
    counts, shapes = launch_counts(), launch_shapes()
    report.update(launches=counts, shapes=shape_report(counts, shapes))
    return report, counts, shapes, idx, built_head


def gate_passes(spec, idx, queries, gates, device, rounds):
    """Warm passes through AnnService at each ``kernel_min`` of ``gates``
    in turns, forwards then backwards (so each gate runs early and late),
    ``rounds`` times; each pass's results must equal the first's (the
    gate never changes them).  Returns (one record a pass: QPS, p50/p99,
    search seconds, steps and the ``l2_dist`` launches by ``(NQ, N)``
    tile; per gate: the median search seconds and QPS over its passes,
    its launches a pass and the share of steps they are)."""
    import numpy as np
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy

    first, rows = None, []
    for gate in (list(gates) + list(gates)[::-1]) * rounds:
        svc = AnnService(idx, topk=TOPK,
                         policy=BatchPolicy(max_batch=MAX_BATCH),
                         device=device, ef=GRAPH_EF, kernel_min=gate)
        reset_launches()
        tickets, rep = serve_pass(svc, queries)
        ids = np.concatenate([tk.ids for tk in tickets])
        dists = np.concatenate([tk.dists for tk in tickets])
        if first is None:
            first = (ids, dists)
        elif not (np.array_equal(ids, first[0])
                  and np.array_equal(dists, first[1])):
            raise AssertionError(f"{spec}: kernel_min={gate} changed the "
                                 "results")
        rows.append(dict(kernel_min=gate, **{k: rep[k] for k in (
            "qps", "p50_latency_ms", "p99_latency_ms", "search_s",
            "steps")}, l2_dist_launches=launch_counts()["l2_dist"],
            tiles=dict(sorted(launch_shapes()["l2_dist_tiles"].items()))))
    summary = {}
    for gate in gates:
        mine = [r for r in rows if r["kernel_min"] == gate]
        summary[gate] = dict(
            passes=len(mine),
            median_search_s=float(np.median([r["search_s"] for r in mine])),
            median_qps=float(np.median([r["qps"] for r in mine])),
            l2_dist_launches=mine[0]["l2_dist_launches"],
            share_of_steps=mine[0]["l2_dist_launches"] / mine[0]["steps"])
    return rows, summary


def graph_decisions(base, nsg_head, device):
    """The card's graph decisions against the CPU's (no launch counted):
    the NSG32 and HNSW16 prunes of the first GRAPH_CHECK_NODES nodes' kNN
    lists equal on both devices (and NSG's equal to the lists the 1M build
    made), HNSW's closed-form reverse edges on that subgraph equal on both
    devices and to the reference's loop, ``knn_graph`` over the first
    GRAPH_KNN_CHECK vectors differing from the CPU's only at near-ties
    inside ``rescore_eps``, and ``np_sum_f32`` bit-equal to ``np.sum``."""
    import numpy as np
    import torch
    from repro_torch.ann.graph import (hnsw_reverse_edges, kept_lists,
                                       knn_graph, prune_kept)
    from repro_torch.ann.npsum import np_sum_f32
    from repro_torch.ann.scan import rescore_eps

    rec = {}
    xdev = torch.from_numpy(base).to(device)
    xcpu = torch.from_numpy(base)
    nodes = np.arange(GRAPH_CHECK_NODES)
    for name, r, k in (("NSG32", 32, 64), ("HNSW16", 16, 32)):
        nn = knn_graph(xdev, k, rows=GRAPH_CHECK_NODES)
        t = time.perf_counter()
        card = prune_kept(xdev, nn, nodes, r)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = prune_kept(xcpu, nn, nodes, r)
        cpu_s = time.perf_counter() - t
        if not np.array_equal(card, cpu):
            bad = np.flatnonzero((card != cpu).any(1))
            raise AssertionError(f"{name} prune: card differs from the CPU "
                                 f"at nodes {bad[:8].tolist()}")
        rec[f"{name}_prune"] = dict(nodes=GRAPH_CHECK_NODES, card_s=card_s,
                                    cpu_s=cpu_s, equal=True)
        if name == "NSG32":
            if not all(np.array_equal(a, b)
                       for a, b in zip(kept_lists(card), nsg_head)):
                raise AssertionError("NSG32 prune of the first nodes differs "
                                     "from the lists the build made")
            rec[f"{name}_prune"]["equal_to_build"] = True
        else:
            sub = np.where(card < GRAPH_CHECK_NODES, card, -1)
            got = hnsw_reverse_edges(sub, r, device=device)
            want = hnsw_reverse_edges(sub, r, device="cpu")
            adj = [[int(j) for j in row if j >= 0] for row in sub]
            for i in range(len(adj)):               # the reference's loop
                for j in adj[i]:
                    if len(adj[j]) < r and i not in adj[j]:
                        adj[j].append(i)
            if not all(np.array_equal(a, b) and np.array_equal(
                    a, np.asarray(sorted(set(c)), np.int64))
                    for a, b, c in zip(got, want, adj)):
                raise AssertionError("HNSW16 reverse edges: card, CPU and "
                                     "the loop differ")
            rec["HNSW16_reverse_edges"] = dict(
                nodes=GRAPH_CHECK_NODES, equal_card_cpu_loop=True,
                edges=int(sum(len(a) for a in got)))
    del xdev
    sub = base[:GRAPH_KNN_CHECK]
    card = knn_graph(torch.from_numpy(sub).to(device), 64)
    cpu = knn_graph(torch.from_numpy(sub), 64)
    x64 = sub.astype(np.float64)
    diff = np.argwhere(card != cpu)
    band_use = 0.0
    for i, j in diff:
        da = float(np.sum((x64[cpu[i, j]] - x64[i]) ** 2))
        db = float(np.sum((x64[card[i, j]] - x64[i]) ** 2))
        eps = rescore_eps(sub.shape[1], da, float(x64[i] @ x64[i]))
        band_use = max(band_use, abs(da - db) / eps)
    if band_use > 1.0:
        raise AssertionError(f"knn_graph: card and CPU differ outside "
                             f"rescore_eps ({band_use} of the band)")
    rec["knn_graph"] = dict(n=GRAPH_KNN_CHECK, k=64,
                            positions_differ=int(len(diff)),
                            rows_differ=int((card != cpu).any(1).sum()),
                            band_use=band_use)
    rng = np.random.default_rng(5)
    for d in NPSUM_DIMS:
        a = (rng.standard_normal((4096, d)) ** 2 * rng.uniform(
            0.01, 1e4, (4096, 1))).astype(np.float32)
        got = np_sum_f32(torch.from_numpy(a).to(device)).cpu().numpy()
        if not np.array_equal(got.view(np.int32),
                              np.sum(a, axis=1).view(np.int32)):
            raise AssertionError(f"np_sum_f32 d={d} on the card differs "
                                 "from np.sum")
    rec["np_sum_f32"] = dict(dims=list(NPSUM_DIMS), rows=4096,
                             bit_equal=True)
    return rec


def graph_container_path(base, queries, add, device):
    """``save_index`` / ``load_index(device=...)`` of an NSG32 index over
    the first GRAPH_CONTAINER_N vectors after the ``add``, with webgraph and
    REC edges: pack and unpack seconds, blob MB, bits per edge and epochs
    equal, search after reload equal over all ``queries``.  Launch counts
    set to 0 before and read after.  Returns (report, counts, shapes)."""
    import numpy as np
    import torch
    from repro_torch.api import index_factory, load_index, save_index
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)

    reset_launches()
    t = time.perf_counter()
    idx = index_factory(GRAPH_SPECS[0], device=device).build(
        base[:GRAPH_CONTAINER_N])
    idx.add(add)
    torch.cuda.synchronize()
    rec = dict(spec=GRAPH_SPECS[0], n=int(idx.n), build_and_add_s=(
        time.perf_counter() - t), epochs=idx.n_epochs,
        bits_per_edge=idx.graph.bits_per_edge())
    d0, i0, _ = idx.search(queries, k=TOPK, ef=GRAPH_EF)
    for codec in ("webgraph", "rec"):
        t = time.perf_counter()
        blob = save_index(idx, graph_codec=codec)
        pack_s = time.perf_counter() - t
        t = time.perf_counter()
        back = load_index(blob, device=device)
        torch.cuda.synchronize()
        unpack_s = time.perf_counter() - t
        if (back.spec != idx.spec or back.device != idx.device
                or back.graph.bits_per_edge() != idx.graph.bits_per_edge()
                or back.n_epochs != idx.n_epochs):
            raise AssertionError(f"graph container ({codec}): spec, device, "
                                 "bits per edge or epochs differ")
        d1, i1, st = back.search(queries, k=TOPK, ef=GRAPH_EF)
        if not (np.array_equal(i1, i0) and np.array_equal(d1, d0)):
            raise AssertionError(f"graph container ({codec}): search after "
                                 "reload differs")
        rec[codec] = dict(blob_mb=len(blob) / 2**20, pack_s=pack_s,
                          unpack_s=unpack_s, engine=st.engine,
                          search_equal_after_reload=True)
        del blob, back
    counts, shapes = launch_counts(), launch_shapes()
    return dict(rec, launches=counts), counts, shapes


def time_step_tiles(idx, queries):
    """One graph step's device path (``score_step``: the H2D copies, the
    gather of the candidates, ``l2_dist`` and the ``(n_pad,)`` copy back,
    on the host clock with a synchronize) against the host re-score of
    the same candidates (the engine's numpy expression), at each tile of
    STEP_TILES; and the smallest tile where the device path is faster.
    The candidates are random nodes spread over the tile's query rows."""
    import numpy as np
    import torch
    from repro_torch.ann.graph_scan import KERNEL_MIN_CUDA, score_step

    g = idx.graph
    rng = np.random.default_rng(3)
    rows, crossover = [], None
    for qb, n_pad in STEP_TILES:
        cand_v = rng.integers(0, g.n, n_pad)
        cand_row = np.sort(rng.integers(0, qb, n_pad))
        qblk = np.ascontiguousarray(queries[:qb], np.float32)
        idx_pad = cand_v.astype(np.int32)

        def device_step():
            score_step(g, qblk, idx_pad, cand_row)

        def host_rescore():
            np.sum((g.x[cand_v] - qblk[cand_row]) ** 2, axis=1)

        times = {}
        for name, fn in (("device_ms", device_step),
                         ("host_rescore_ms", host_rescore)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            reps = 50
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t) / reps * 1e3
        rows.append(dict(tile=f"{qb}x{n_pad}", **times))
        if crossover is None and times["device_ms"] < times["host_rescore_ms"]:
            crossover = n_pad
    return dict(tiles=rows, device_faster_from=crossover,
                kernel_min_cuda=KERNEL_MIN_CUDA)


def time_graph_tiles(l2_tiles, seg_tiles, base_dev, queries_dev):
    """Every kernel launch shape of the graph paths, held and timed:
    ``l2_dist`` at each ``(NQ, N)`` tile (the queries against the first N
    base rows; inside ``rescore_eps`` of ``l2_dist_ref``; a CUDA graph's
    replay for a beam step's tiles) and ``seg_topk`` at each ``(rows,
    n, k)`` on the base's own distances with ``lens = n`` (bit-equal to the
    plain version on a CPU copy of 16 rows).  At the most launched wide
    tile of each (the kNN build's block) also the bound, the plain
    version's time and a library call's (``torch.addmm``, ``torch.topk``).
    Returns ({tile: ms} for ``l2_dist``, {tile: ms} for ``seg_topk``,
    {kernel: record at its widest tile})."""
    import torch
    from repro_torch.kernels.l2_topk import l2_dist, l2_dist_ref
    from repro_torch.kernels.seg_topk import seg_topk, seg_topk_ref

    d = base_dev.shape[1]
    l2_ms, seg_ms, wide = {}, {}, {}
    wide_l2 = max((t for t in l2_tiles if t[0] * t[1] > STEP_TILE_MAX),
                  key=l2_tiles.get)
    wide_seg = max(seg_tiles, key=seg_tiles.get)
    for nq, n in sorted(l2_tiles):
        q = (queries_dev if nq <= queries_dev.shape[0] else base_dev)[:nq]
        a = base_dev[:n]
        out, ref = l2_dist(q, a), l2_dist_ref(q, a)
        qn = (q.double() ** 2).sum(1, keepdim=True)
        band_use = float(((out.double() - ref.double()).abs()
                          / rescore_band(d, ref, qn)).max())
        if not band_use <= 1.0:
            raise AssertionError(f"l2_dist at tile {nq}x{n} outside "
                                 f"rescore_eps ({band_use} of the band)")
        del out, ref
        small = nq * n <= STEP_TILE_MAX     # a beam step's tile
        l2_ms[(nq, n)] = cuda_ms(lambda: l2_dist(q, a), graph=small,
                                 reps=20 if small else 3,
                                 warmup=3 if small else 1)
        if (nq, n) == wide_l2:
            qn32, an32 = (q * q).sum(1, keepdim=True), (a * a).sum(1)
            b, by, _ = l2_bounds(4 * (nq * d + n * d + nq * n), nq, n, d)
            wide["l2_dist"] = dict(
                tile=f"{nq}x{n}", launches=l2_tiles[wide_l2],
                ms=l2_ms[wide_l2], band_use=band_use, bound_ms=b,
                bound_by=by, plain_ms=cuda_ms(lambda: l2_dist_ref(q, a),
                                              reps=3, warmup=1),
                library_ms=cuda_ms(lambda: torch.addmm(
                    an32[None], q, a.T, alpha=-2.0).add_(qn32), reps=3,
                    warmup=1))
    for rows, n, k in sorted(seg_tiles):
        dmat = l2_dist(base_dev[:rows], base_dev[:n])
        lens = torch.full((rows,), n, dtype=torch.int32,
                          device=base_dev.device)
        v, i = seg_topk(dmat[:16].contiguous(), lens[:16], k)
        vr, ir = seg_topk_ref(dmat[:16].cpu(), lens[:16].cpu(), k)
        if not (torch.equal(v.cpu().view(torch.int32), vr.view(torch.int32))
                and torch.equal(i.cpu(), ir)):
            raise AssertionError(f"seg_topk at ({rows}, {n}, {k}) differs "
                                 "from the plain version")
        seg_ms[(rows, n, k)] = cuda_ms(lambda: seg_topk(dmat, lens, k),
                                       reps=3, warmup=1)
        if (rows, n, k) == wide_seg:
            b, by = bound_ms(4 * rows * n + 4 * rows + 8 * rows * k,
                             rows * n)
            wide["seg_topk"] = dict(
                tile=f"{rows}x{n},k={k}", launches=seg_tiles[wide_seg],
                ms=seg_ms[wide_seg], bound_ms=b, bound_by=by,
                plain_ms=cuda_ms(lambda: seg_topk_ref(dmat, lens, k),
                                 reps=2, warmup=1),
                library_ms=cuda_ms(lambda: torch.topk(dmat, k, dim=1,
                                                      largest=False),
                                   reps=3, warmup=1))
        del dmat
    return l2_ms, seg_ms, wide


def shape_report(counts, shapes):
    """The launch shapes of a main-path run, JSON-ready."""
    return dict(
        seg_topk={f"n={n},k={k}": c for (n, k), c in
                  sorted(shapes["seg_topk"].items())},
        pq_adc=dict(launches=counts["pq_adc"], rows=shapes["pq_adc"]),
        l2_dist=dict(launches=counts["l2_dist"], rows=shapes["l2_dist"]),
        l2_top1={f"K={k},d={d},rows={r}": c for (k, d, r), c
                 in sorted(shapes["l2_top1"].items())})


def lm_close(what, got, want):
    """Raise unless ``got`` agrees with ``want`` within LM_TOL (see there);
    returns the largest difference and the logit scale."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max())
    err = (got - want).abs()
    tol = LM_TOL * max(1.0, scale) + LM_TOL * want.abs()
    if not (bool(torch.isfinite(got).all()) and bool((err <= tol).all())):
        raise AssertionError(f"{what}: max |err| {float(err.max())} at a "
                             f"logit scale {scale} (tolerance {LM_TOL} of it)")
    return dict(max_abs_err=float(err.max()), logit_scale=scale,
                argmax_equal=bool(torch.equal(got.argmax(-1),
                                              want.argmax(-1))))


def lm_cache(model, params, batch, max_len, frames=None):
    """A fresh f32 decode cache of ``max_len`` tokens; for the
    encoder-decoder, holding the encoder memory of ``frames`` (B, T, d)."""
    import torch
    from repro_torch.models.encdec import encdec_prefill_memory

    if frames is None:
        return model.init_cache(batch, max_len, dtype=torch.float32)
    cache = model.init_cache(batch, max_len, dtype=torch.float32,
                             mem_len=frames.shape[1])
    return encdec_prefill_memory(params, model.cfg, frames, cache)


def lm_decode(model, params, tokens, gen=0, every=False, frames=None):
    """Feed ``tokens`` (B, P) one at a time through ``model.decode_step``
    from a fresh f32 cache (``lm_cache``: the encoder-decoder's holds the
    memory of ``frames``), then ``gen`` greedy steps.  Returns the logits
    after the last prompt token (with ``every``, after each prompt token:
    (B, P, V)) and the greedy tokens (B, gen)."""
    import torch

    B, P = tokens.shape
    cache = lm_cache(model, params, B, P + gen, frames)
    out, steps = [], []
    with torch.no_grad():
        for i in range(P):
            logits, cache = model.decode_step(params, cache,
                                              token=tokens[:, i:i + 1])
            if every:
                steps.append(logits[:, -1])
        last = torch.stack(steps, 1) if every else logits[:, -1]
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        for _ in range(gen):
            out.append(tok)
            logits, cache = model.decode_step(params, cache,
                                              token=tok[:, None])
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    return last, torch.stack(out, 1) if out else None


def lm_stats(ms):
    import numpy as np

    ms = np.asarray(ms)
    return dict(mean_ms=float(ms.mean()), p50_ms=float(np.percentile(ms, 50)),
                p99_ms=float(np.percentile(ms, 99)))


def lm_trace(step, steps=LM_TRACE_STEPS):
    """``steps`` calls of a decode ``step`` under ``torch.profiler``: the
    host's top-level aten ops and the card's kernels a step, the kernels'
    busy milliseconds a step and the card's idle share of the wall time
    (None where the trace holds no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / steps
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.name.startswith("aten::")
           and (e.cpu_parent is None
                or not e.cpu_parent.name.startswith("aten::"))]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    return dict(steps=steps, wall_ms=wall_ms, host_ops=len(ops) / steps,
                kernels=len(kernels) / steps,
                busy_ms=busy_ms if kernels else None,
                idle_share=1.0 - busy_ms / wall_ms if kernels else None)


def lm_serving(dev):
    """The LM serving path at gemma3-1b's full width (module docstring,
    phase 12).  Every kernel count is set to 0 before it; returns the
    report, the counts and launch shapes after it, and the shapes after
    the serving loop's runs (whose side-car has d = 96; the embedding
    index after them has d = 64)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import count_params
    from repro_torch.models.transformer import Decoder, init_decoder
    from repro_torch.retrieval import RetrievalIndex, embed_corpus
    from repro_torch.train.step import make_prefill_step, make_serve_step

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rng = np.random.default_rng(0)
    cfg = get_config(LM_ARCH)
    rep = {}
    reset_launches()

    # 1. the model at full width from the port's own init
    t = time.perf_counter()
    params = init_decoder(0, cfg, dev)
    torch.cuda.synchronize()
    n = count_params(cfg)
    held = sum(p.numel() for p in params.parameters())
    if not n == held == LM_PARAMS:
        raise AssertionError(f"{LM_ARCH}: count_params {n}, the module holds "
                             f"{held}, the reference counts {LM_PARAMS}")
    rep["model"] = dict(
        arch=LM_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, window=cfg.sliding_window, params=n,
        f32_weight_bytes=4 * held, init_s=time.perf_counter() - t)

    # 2. f32: decode against prefill across the ring
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _, prefill = make_prefill_step(cfg32, device=dev)
    model32, _ = make_serve_step(cfg32, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, LM_PREFILL)
                            .astype(np.int32)).to(dev)
    t = time.perf_counter()
    want = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    t = time.perf_counter()
    got, _ = lm_decode(model32, params, toks)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    rep["f32_decode_vs_prefill"] = dict(
        prompts=LM_PREFILL[0], tokens=LM_PREFILL[1], prefill_s=prefill_s,
        decode_s=decode_s, decode_ms_per_step=1e3 * decode_s / LM_PREFILL[1],
        tolerance=LM_TOL, **lm_close("decode against prefill", got, want))
    del want, got, toks

    # 3. f32: the card against the CPU, one local/global super-block
    cfg6 = dataclasses.replace(cfg32, n_layers=LM_CPU_LAYERS)
    p6 = init_decoder(1, cfg6, dev)
    p6_cpu = Decoder(cfg6, device="cpu")
    p6_cpu.load_state_dict(p6.state_dict())
    prompt = rng.integers(0, cfg.vocab_size,
                          (2, LM_CPU_PROMPT)).astype(np.int32)
    outs = {}
    for where, p in (("card", p6), ("cpu", p6_cpu)):
        d = dev if where == "card" else torch.device("cpu")
        _, pre = make_prefill_step(cfg6, device=d)
        m6, _ = make_serve_step(cfg6, device=d)
        tk = torch.from_numpy(prompt).to(d)
        t = time.perf_counter()
        logits = pre(p, {"tokens": tk})
        _, greedy = lm_decode(m6, p, tk, LM_CPU_GEN)
        outs[where] = (logits.cpu(), greedy.cpu(), time.perf_counter() - t)
    if not torch.equal(outs["card"][1], outs["cpu"][1]):
        raise AssertionError(f"greedy tokens differ, card {outs['card'][1]} "
                             f"against the CPU {outs['cpu'][1]}")
    rep["card_vs_cpu"] = dict(
        layers=LM_CPU_LAYERS, prompt=LM_CPU_PROMPT, greedy=LM_CPU_GEN,
        tokens_equal=True, card_s=outs["card"][2], cpu_s=outs["cpu"][2],
        tolerance=LM_TOL,
        **lm_close("card against CPU prefill", outs["card"][0],
                   outs["cpu"][0]))
    del p6, p6_cpu, outs

    # 4. bf16 serving at the config's dtype with the side-car, twice
    args = lm_serve.parse_args(LM_SERVE_ARGV)
    runs = [lm_serve.run(args, params=params) for _ in range(2)]
    for r in runs:
        if not ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all():
            raise AssertionError("serving loop: a token outside the vocab")
    if not np.array_equal(runs[0].tokens, runs[1].tokens):
        raise AssertionError("serving loop: two runs gave other tokens")
    bf16_bytes = 2 * held
    bound = 1e3 * bf16_bytes / PEAK_BYTES_S
    warm = runs[1]
    serve_shapes = launch_shapes()
    rep["serve"] = dict(
        argv=" ".join(LM_SERVE_ARGV), tokens_equal=True,
        tokens_per_s=[r.tokens_per_s for r in runs],
        prompt_s=[r.prompt_s for r in runs], **lm_stats(warm.step_ms),
        first_run=lm_stats(runs[0].step_ms), bf16_weight_bytes=bf16_bytes,
        weight_read_bound_ms=bound,
        bound_share=bound / lm_stats(warm.step_ms)["mean_ms"],
        f32_weight_read_bound_ms=2 * bound,
        bits_per_id=warm.bits_per_id,
        search_ms_per_lookup=float(np.mean(warm.search_ms)),
        lookups=len(warm.search_ms))

    # 4b. the decode step with a bf16 cache: the config's dtype throughout
    model16, step16 = make_serve_step(cfg, device=dev)
    state = dict(cache=model16.init_cache(
        8, LM_BF16_CACHE_STEPS + LM_TRACE_STEPS, dtype=torch.bfloat16),
        tok=torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1))
                             .astype(np.int32)).to(dev))

    def decode_one():
        nxt, state["cache"] = step16(params, state["cache"],
                                     {"token": state["tok"]})
        state["tok"] = nxt[:, None]

    ms = []
    for _ in range(LM_BF16_CACHE_STEPS):
        t = time.perf_counter()
        decode_one()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    st = lm_stats(ms[LM_BF16_CACHE_STEPS // 4:])
    rep["decode_bf16_cache"] = dict(
        batch=8, steps=LM_BF16_CACHE_STEPS, **st,
        weight_read_bound_ms=bound, bound_share=bound / st["mean_ms"],
        trace=lm_trace(decode_one))
    del state, model16

    # 5. retrieval over the model's own embeddings
    docs = rng.integers(0, cfg.vocab_size,
                        (LM_DOCS, LM_DOC_LEN)).astype(np.int32)
    qdocs = rng.integers(0, cfg.vocab_size,
                         (LM_REF_QUERIES, LM_DOC_LEN)).astype(np.int32)
    t = time.perf_counter()
    emb = embed_corpus(cfg, params, np.split(docs, LM_DOCS // LM_DOC_BATCH))
    embed_s = time.perf_counter() - t
    queries = embed_corpus(cfg, params,
                           np.split(qdocs, LM_REF_QUERIES // LM_DOC_BATCH))
    if not (np.isfinite(emb).all() and emb.shape == (LM_DOCS, 64)):
        raise AssertionError(f"embeddings: shape {emb.shape} or not finite")
    t = time.perf_counter()
    ri = RetrievalIndex(nlist=64, id_codec="roc", device=dev).build(emb)
    build_s = time.perf_counter() - t
    ids, _, _ = ri.search(emb[:LM_SELF_CHECK], topk=10, nprobe=8)
    self_rate = float(np.mean(ids[:, 0] == np.arange(LM_SELF_CHECK)))
    if self_rate < LM_SELF_FLOOR:
        raise AssertionError(f"self-retrieval {self_rate} < {LM_SELF_FLOOR}")
    t = time.perf_counter()
    ids, dists, _ = ri.search(queries, topk=10, nprobe=8)
    search_s = time.perf_counter() - t
    ref_ids, ref_dists, _ = ri.search_ref(queries, nprobe=8, topk=10)
    hold_equal("embedding index against search_ref", (ids, dists),
               (ref_ids, ref_dists))
    rep["embedding_index"] = dict(
        docs=LM_DOCS, doc_len=LM_DOC_LEN, batch=LM_DOC_BATCH,
        embed_s=embed_s, docs_per_s=LM_DOCS / embed_s, build_s=build_s,
        self_retrieval=self_rate, self_checked=LM_SELF_CHECK,
        search_ref_equal_queries=LM_REF_QUERIES,
        qps=LM_REF_QUERIES / search_s,
        bits_per_id=ri.stats()["bits_per_id"])
    return rep, launch_counts(), launch_shapes(), serve_shapes


def lm_kernel_shapes(dev, gen, shapes, serve_shapes):
    """Each shape the LM path launched, held against its plain version and
    timed: ``l2_top1`` at its (K, d, rows), ``seg_topk`` at its (n, k),
    ``l2_dist`` at its (NQ, N) tiles (d = 96 for the serving loop's
    side-car, 64 for the embedding index).  Returns ({kernel: ms a run},
    the records)."""
    recs, run_ms = [], dict(l2_top1=0.0, seg_topk=0.0, l2_dist=0.0)
    for (k, d, rows), c in sorted(shapes["l2_top1"].items()):
        r = dict(check_l2_top1(dev, gen, rows, k, d),
                 name=f"l2_top1(K={k},d={d},rows={rows})", launches=c)
        run_ms["l2_top1"] += c * r["ms"]
        recs.append(r)
    seg = check_seg_topk(dev, gen, list(shapes["seg_topk"]))
    for key, c in sorted(shapes["seg_topk"].items()):
        run_ms["seg_topk"] += c * seg[key]["ms"]
        recs.append(dict(seg[key], launches=c))
    before = serve_shapes["l2_dist_tiles"]
    for (nq, n), c in sorted(shapes["l2_dist_tiles"].items()):
        for d, launches in ((96, before.get((nq, n), 0)),
                            (64, c - before.get((nq, n), 0))):
            if launches:
                r = dict(check_l2_dist(dev, gen, n=n, qb=nq, d=d),
                         name=f"l2_dist({nq}x{n},d={d})", launches=launches)
                run_ms["l2_dist"] += launches * r["ms"]
                recs.append(r)
    return run_ms, recs


def lm_free():
    """Return the card's cached blocks after a model is dropped."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def lm_check_count(cfg, params, want, want_active=None):
    """``count_params`` (and the active count) against the reference's,
    and the module holding the total; returns the report."""
    from repro_torch.models import count_params

    n = count_params(cfg)
    active = count_params(cfg, active_only=True)
    held = sum(p.numel() for p in params.parameters())
    if not n == held == want or (want_active is not None
                                 and active != want_active):
        raise AssertionError(
            f"{cfg.name}: count_params {n} (active {active}), the module "
            f"holds {held}, the reference counts {want} (active "
            f"{want_active})")
    return dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                vocab=cfg.vocab_size, params=n, active_params=active,
                f32_weight_bytes=4 * held)


def lm_full_logits(cfg, params, tokens, frames=None):
    """The whole sequence's logits of ``model.apply`` (no autograd); the
    encoder-decoder's over the memory of ``frames``."""
    import torch
    from repro_torch.models import build

    inputs = (dict(tokens=tokens) if frames is None
              else dict(frames=frames, dec_tokens=tokens))
    with torch.no_grad():
        return build(cfg, device=tokens.device).apply(params, **inputs)[0]


def lm_decode_vs_prefill(cfg, params, tokens, around=None, frames=None):
    """Each position's decode logits (the prompt fed one token at a time
    from an empty f32 cache) against the prefill's, within LM_TOL; the
    prefill runs inside the context ``around`` where one is given.  For
    the encoder-decoder, both over the memory of ``frames``, whose
    encoder pass the decode's seconds include."""
    import torch
    from repro_torch.train.step import make_serve_step

    t = time.perf_counter()
    with around or contextlib.nullcontext():
        want = lm_full_logits(cfg, params, tokens, frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    model, _ = make_serve_step(cfg, device=tokens.device)
    t = time.perf_counter()
    got, _ = lm_decode(model, params, tokens, every=True, frames=frames)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    B, P = tokens.shape
    return dict(prompts=B, tokens=P, prefill_s=prefill_s, decode_s=decode_s,
                decode_ms_per_step=1e3 * decode_s / P, tolerance=LM_TOL,
                **({} if frames is None else dict(frames=frames.shape[1])),
                **lm_close("decode against prefill", got, want))


def lm_card_vs_cpu(cfg, p_card, prompt, gen, around_prefill=None,
                   frames=None):
    """The model ``p_card`` on the card against a CPU copy of its weights:
    the prefill's logits, each prompt step's decode logits and ``gen``
    greedy tokens (the encoder-decoder's over the memory of ``frames``,
    numpy).  ``around_prefill(where)`` may give a context to run each
    side's prefill in.  Returns the report."""
    import numpy as np
    import torch
    from repro_torch.train.step import make_serve_step

    p_cpu = type(p_card)(cfg, device="cpu")
    p_cpu.load_state_dict(p_card.state_dict())
    outs = {}
    for where, p in (("card", p_card), ("cpu", p_cpu)):
        d = next(p.parameters()).device
        tk = torch.from_numpy(prompt).to(d)
        fr = None if frames is None else torch.from_numpy(frames).to(d)
        t = time.perf_counter()
        with (around_prefill(where) if around_prefill
              else contextlib.nullcontext()):
            pre = lm_full_logits(cfg, p, tk, fr)
        model, _ = make_serve_step(cfg, device=d)
        steps, greedy = lm_decode(model, p, tk, gen, every=True, frames=fr)
        outs[where] = (pre.cpu(), steps.cpu(), greedy.cpu(),
                       time.perf_counter() - t)
    del p_cpu
    card, cpu = outs["card"], outs["cpu"]
    if not torch.equal(card[2], cpu[2]):
        raise AssertionError(f"greedy tokens differ, card {card[2]} "
                             f"against the CPU {cpu[2]}")
    return dict(
        layers=cfg.n_layers, prompt=prompt.shape[1], greedy=gen,
        tokens_equal=True, card_s=card[3], cpu_s=cpu[3], tolerance=LM_TOL,
        prefill=lm_close("card against CPU prefill", card[0], cpu[0]),
        decode=lm_close("card against CPU decode", card[1], cpu[1]),
        greedy_tokens=np.asarray(card[2]).tolist())


def lm_step_trace(cfg, params, batch=8, warm=8, frames_len=None):
    """The serving loop's decode step (f32 cache, as the loop's; the
    encoder-decoder's over the memory of ``frames_len`` random frames),
    traced by ``torch.profiler`` after ``warm`` steps (see ``lm_trace``)."""
    import numpy as np
    import torch
    from repro_torch.train.step import make_serve_step

    dev = next(params.parameters()).device
    model, step = make_serve_step(cfg, device=dev)
    rng = np.random.default_rng(3)
    frames = None if frames_len is None else torch.from_numpy(
        rng.standard_normal((batch, frames_len, cfg.d_model))
        .astype(np.float32)).to(dev)
    state = dict(cache=lm_cache(model, params, batch, warm + LM_TRACE_STEPS,
                                frames),
                 tok=torch.from_numpy(rng.integers(
                     0, cfg.vocab_size, (batch, 1)).astype(np.int32)).to(dev))

    def decode_one():
        nxt, state["cache"] = step(params, state["cache"],
                                   {"token": state["tok"]})
        state["tok"] = nxt[:, None]

    for _ in range(warm):
        decode_one()
    return lm_trace(decode_one)


def lm_serve_twice(argv, params, bounds):
    """The serving loop (``launch.serve.run``) twice on ``params``: tokens
    inside the vocab and equal, tokens/s and ms a step against each
    weight-read bound of ``bounds`` ({name: bytes}), the side-car's
    lookups, and a traced decode step.  The loop's cache is f32, as the
    reference's: where an attention layer's f32 output joins the bf16
    residual stream the rest of the step runs in f32 (JAX's promotion),
    so a step past an attention layer reads f32 weights; the f32 bounds
    say what that costs."""
    import numpy as np
    from repro_torch.launch import serve as lm_serve

    cfg = params.cfg
    args = lm_serve.parse_args(argv)
    runs = [lm_serve.run(args, params=params) for _ in range(2)]
    for r in runs:
        if not ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all():
            raise AssertionError(f"{cfg.name} serving loop: a token outside "
                                 "the vocab")
    if not np.array_equal(runs[0].tokens, runs[1].tokens):
        raise AssertionError(f"{cfg.name} serving loop: two runs gave other "
                             "tokens")
    warm = runs[1]
    st = lm_stats(warm.step_ms)
    rep = dict(argv=" ".join(argv), layers=cfg.n_layers, tokens_equal=True,
               tokens_per_s=[r.tokens_per_s for r in runs],
               prompt_s=[r.prompt_s for r in runs], **st,
               first_run=lm_stats(runs[0].step_ms))
    for name, nbytes in bounds.items():
        b = 1e3 * nbytes / PEAK_BYTES_S
        rep[name] = dict(bytes=nbytes, bound_ms=b,
                         bound_share=b / st["mean_ms"])
    if warm.search_ms:
        rep.update(bits_per_id=warm.bits_per_id,
                   search_ms_per_lookup=float(np.mean(warm.search_ms)),
                   lookups=len(warm.search_ms))
    rep["trace"] = lm_step_trace(
        cfg, params, batch=args.batch,
        frames_len=args.prompt_len if cfg.encoder_decoder else None)
    return rep


@contextlib.contextmanager
def recording_routes(seen):
    """Append ``(logits, k, capacity)`` of every ``moe_route`` call made
    inside the context to ``seen``."""
    from repro_torch.models import moe

    inner = moe.moe_route

    def record(logits, k, capacity, split=None):
        seen.append((logits.detach().clone(), k, capacity))
        return inner(logits, k, capacity, split)

    moe.moe_route = record
    try:
        yield seen
    finally:
        moe.moe_route = inner


def edge_gap(logits, k):
    """The smallest gap between the k-th and (k+1)-th probability of any
    token (0.0: a tie at the edge of the top k)."""
    import torch

    p = torch.softmax(logits.float(), -1).sort(-1, descending=True).values
    return float((p[:, k - 1] - p[:, k]).min())


def moe_routing_check(card_seen, cpu_seen):
    """Each layer's routing of the card's router logits, on the card and
    on a CPU copy, bit-equal (expert ids, order, keep, slot, counts); the
    drops and the smallest k-th edge gap of each side's own logits."""
    import torch
    from repro_torch.models.moe import moe_route

    layers = []
    for (lg, k, c), (lg_cpu, _, _) in zip(card_seen, cpu_seen):
        on_card = moe_route(lg, k, c)
        on_cpu = moe_route(lg.cpu(), k, c)
        for name in ("expert_ids", "order", "keep", "slot", "counts"):
            if not torch.equal(getattr(on_card, name).cpu(),
                               getattr(on_cpu, name)):
                raise AssertionError(f"routing of the same logits: {name} "
                                     "differs between the card and the CPU")
        own_cpu = moe_route(lg_cpu, k, c)
        layers.append(dict(
            tokens=lg.shape[0], capacity=c,
            dropped_card=int((~on_card.keep).sum()),
            dropped_cpu=int((~own_cpu.keep).sum()),
            edge_gap_card=edge_gap(lg, k), edge_gap_cpu=edge_gap(lg_cpu, k),
            max_abs_logit_err=float((lg.cpu() - lg_cpu).abs().max())))
    if not layers:
        raise AssertionError("the MoE check recorded no routing")
    return dict(same_logits_bit_equal=True, layers=layers)


def moe_serving(dev, gen):
    """Phase 13 (module docstring): olmoe-1b-7b at full width and depth,
    then llama4-scout at full width cut in depth.  Every kernel count is
    set to 0 before it; returns the report, the counts, the side-car's
    kernel shapes held and timed ({kernel: ms a run}, records)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.models import count_params
    from repro_torch.models.moe import moe_route
    from repro_torch.models.transformer import Decoder, init_decoder

    rng = np.random.default_rng(13)
    cfg = get_config(MOE_ARCH)
    E, k = cfg.n_experts, cfg.experts_per_token
    rep = {}
    reset_launches()

    # (a) the parameter counts; the model at full width and depth
    t = time.perf_counter()
    params = init_decoder(0, cfg, dev)
    torch.cuda.synchronize()
    rep["model"] = dict(lm_check_count(cfg, params, MOE_PARAMS, MOE_ACTIVE),
                        experts=E, top_k=k, init_s=time.perf_counter() - t)
    scout = get_config(SCOUT_ARCH)
    counts = (count_params(scout), count_params(scout, active_only=True))
    if counts != (SCOUT_PARAMS, SCOUT_ACTIVE):
        raise AssertionError(f"{SCOUT_ARCH}: count_params {counts}, the "
                             f"reference {SCOUT_PARAMS, SCOUT_ACTIVE}")
    rep["scout_counts"] = dict(params=counts[0], active_params=counts[1])

    # (b) f32 decode against prefill with a capacity that drops nothing
    cfg_nodrop = dataclasses.replace(cfg, dtype="float32",
                                     capacity_factor=E / k)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, MOE_PREFILL)
                            .astype(np.int32)).to(dev)
    seen = []
    try:
        held = lm_decode_vs_prefill(cfg_nodrop, params, toks,
                                    recording_routes(seen))
    except AssertionError as e:
        raise AssertionError(
            f"{e}; the prefill's smallest k-th edge gap "
            f"{min(edge_gap(lg, k) for lg, _, _ in seen)}") from e
    dropped = sum(int((~moe_route(lg, k, c).keep).sum())
                  for lg, k, c in seen)
    if dropped or len(seen) != cfg.n_layers:
        raise AssertionError(f"capacity T dropped {dropped} assignments "
                             f"over {len(seen)} layers")
    rep["f32_decode_vs_prefill"] = dict(
        capacity_factor=E / k, capacity=seen[0][2], dropped=0,
        edge_gap=min(edge_gap(lg, k) for lg, _, _ in seen), **held)
    del toks, seen
    lm_free()

    # (c) f32, the card against the CPU over the first layers (drops)
    cfg_cut = dataclasses.replace(cfg, dtype="float32",
                                  n_layers=MOE_CPU_LAYERS)
    p_cut = Decoder(cfg_cut, device=dev)
    keep = set(p_cut.state_dict())
    p_cut.load_state_dict({n: v for n, v in params.state_dict().items()
                           if n in keep})
    seen = dict(card=[], cpu=[])
    prompt = rng.integers(0, cfg.vocab_size,
                          (2, MOE_CPU_PROMPT)).astype(np.int32)
    rep["card_vs_cpu"] = lm_card_vs_cpu(
        cfg_cut, p_cut, prompt, MOE_CPU_GEN,
        around_prefill=lambda where: recording_routes(seen[where]))
    rep["card_vs_cpu"]["routing"] = moe_routing_check(seen["card"],
                                                      seen["cpu"])
    del p_cut, seen
    lm_free()

    # (d) the serving loop in bf16 with the side-car, twice
    rep["serve"] = lm_serve_twice(MOE_SERVE_ARGV, params, dict(
        all_experts_bound=2 * MOE_PARAMS, active_bound=2 * MOE_ACTIVE,
        all_experts_f32_bound=4 * MOE_PARAMS,
        active_f32_bound=4 * MOE_ACTIVE))
    serve_shapes = launch_shapes()
    counts = launch_counts()
    del params
    lm_free()

    # (e) llama4-scout at full width, cut in depth: top-1 routing and a
    # shared expert
    cfg_s = dataclasses.replace(scout, n_layers=SCOUT_LAYERS)
    t = time.perf_counter()
    p_s = init_decoder(0, cfg_s, dev)
    torch.cuda.synchronize()
    held = sum(p.numel() for p in p_s.parameters())
    rep["scout"] = dict(
        layers=SCOUT_LAYERS, d_model=cfg_s.d_model, experts=cfg_s.n_experts,
        top_k=cfg_s.experts_per_token, shared_expert=cfg_s.shared_expert,
        params=held, f32_weight_bytes=4 * held,
        init_s=time.perf_counter() - t,
        serve=lm_serve_twice(SCOUT_SERVE_ARGV, p_s, dict(
            all_experts_bound=2 * held,
            active_bound=2 * count_params(cfg_s, active_only=True),
            all_experts_f32_bound=4 * held)))
    del p_s
    lm_free()
    after = launch_counts()
    if after != counts:
        raise AssertionError(f"llama4-scout's run launched kernels: "
                             f"{after} after {counts}")
    missing = [n for n in ("l2_top1", "l2_dist", "seg_topk")
               if counts[n] <= 0]
    if missing:
        raise AssertionError(f"the MoE path launched no {missing}")
    ms, recs = lm_kernel_shapes(dev, gen, serve_shapes, serve_shapes)
    return rep, counts, ms, recs


def hybrid_serving(dev):
    """Phase 14 (module docstring): zamba2-2.7b at full width and depth,
    ``lora_b`` drawn non-zero.  Counts set to 0 before, read after."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.transformer import init_decoder

    rng = np.random.default_rng(14)
    cfg = get_config(HYBRID_ARCH)
    rep = {}
    reset_launches()
    t = time.perf_counter()
    params = init_decoder(0, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for sup in params.segments[0]:
            sup.lora_b.normal_(generator=g).mul_(HYBRID_LORA_STD)
    torch.cuda.synchronize()
    rep["model"] = dict(lm_check_count(cfg, params, HYBRID_PARAMS),
                        lora_b_std=HYBRID_LORA_STD,
                        init_s=time.perf_counter() - t)

    # (b) f32 decode against prefill across the SSD chunk boundary
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, HYBRID_PREFILL)
                            .astype(np.int32)).to(dev)
    rep["f32_decode_vs_prefill"] = lm_decode_vs_prefill(cfg32, params, toks)
    del toks
    lm_free()

    # (c) one super-block at full width, the card against the CPU
    per = cfg.hybrid_attn_every
    cfg1 = dataclasses.replace(cfg32, n_layers=per)
    p1 = init_decoder(2, cfg1, dev)
    with torch.no_grad():
        p1.segments[0][0].lora_b.normal_(generator=g).mul_(HYBRID_LORA_STD)
    prompt = rng.integers(0, cfg.vocab_size,
                          (2, LM_CPU_PROMPT)).astype(np.int32)
    rep["card_vs_cpu"] = lm_card_vs_cpu(cfg1, p1, prompt, LM_CPU_GEN)
    del p1
    lm_free()

    # (d) the serving loop in bf16, twice
    rep["serve"] = lm_serve_twice(HYBRID_SERVE_ARGV, params, dict(
        weight_read_bound=2 * HYBRID_PARAMS,
        f32_weight_read_bound=4 * HYBRID_PARAMS))
    del params
    lm_free()
    return rep, launch_counts()


def xlstm_serving(dev):
    """Phase 15 (module docstring): xlstm-1.3b at full width and depth.
    Counts set to 0 before, read after."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.transformer import init_decoder

    rng = np.random.default_rng(15)
    cfg = get_config(XLSTM_ARCH)
    rep = {}
    reset_launches()
    t = time.perf_counter()
    params = init_decoder(0, cfg, dev)
    torch.cuda.synchronize()
    rep["model"] = dict(lm_check_count(cfg, params, XLSTM_PARAMS),
                        init_s=time.perf_counter() - t)

    # (b) one super-block at full width, the card against the CPU: the
    # prefill and the decode each against its own counterpart
    cfg1 = dataclasses.replace(cfg, dtype="float32",
                               n_layers=cfg.mlstm_slstm_pattern + 1)
    p1 = init_decoder(2, cfg1, dev)
    prompt = rng.integers(0, cfg.vocab_size,
                          (2, XLSTM_DECODE_STEPS)).astype(np.int32)
    rep["card_vs_cpu"] = lm_card_vs_cpu(cfg1, p1, prompt, LM_CPU_GEN)
    del p1
    lm_free()

    # (c) the serving loop in bf16, twice
    rep["serve"] = lm_serve_twice(XLSTM_SERVE_ARGV, params, dict(
        weight_read_bound=2 * XLSTM_PARAMS,
        f32_weight_read_bound=4 * XLSTM_PARAMS))
    del params
    lm_free()
    return rep, launch_counts()


def encdec_serving(dev, gen):
    """Phase 16 (module docstring): whisper-medium at full width and
    depth.  Every kernel count is set to 0 before it; returns the report,
    the counts and the side-car's kernel shapes held and timed ({kernel:
    ms a run}, records)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.models import model_flops
    from repro_torch.models.encdec import dec_len_for, init_encdec

    rng = np.random.default_rng(16)
    cfg = get_config(ENCDEC_ARCH)
    rep = {}
    reset_launches()

    # (a) the counts; the model at full width and depth
    t = time.perf_counter()
    params = init_encdec(0, cfg, dev)
    torch.cuda.synchronize()
    rep["model"] = dict(lm_check_count(cfg, params, ENCDEC_PARAMS),
                        encoder_layers=cfg.n_encoder_layers,
                        init_s=time.perf_counter() - t)
    flops = {}
    for name in ("decode_32k", "train_4k"):
        sh = SHAPES[name]
        want = (2.0 * ENCDEC_PARAMS * sh.global_batch if sh.kind == "decode"
                else 6.0 * ENCDEC_PARAMS * sh.global_batch
                * dec_len_for(sh.seq_len))
        flops[name] = model_flops(cfg, sh)
        if flops[name] != want:
            raise AssertionError(f"model_flops({name}) {flops[name]}, the "
                                 f"reference's formula {want}")
    rep["model"]["model_flops"] = flops

    # (b) f32 decode against prefill over Whisper's window, then past the
    # block threshold
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for key, n_frames, shape in (
            ("f32_decode_vs_prefill", ENCDEC_FRAMES, ENCDEC_DECODE),
            ("f32_decode_vs_prefill_blocked", ENCDEC_BLOCKED_FRAMES,
             ENCDEC_BLOCKED_DECODE)):
        frames = torch.from_numpy(rng.standard_normal(
            (shape[0], n_frames, cfg.d_model)).astype(np.float32)).to(dev)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                .astype(np.int32)).to(dev)
        rep[key] = lm_decode_vs_prefill(cfg32, params, toks, frames=frames)
        del frames, toks
        lm_free()

    # (c) f32, the card against the CPU on the first layers at full width
    cfg_cut = dataclasses.replace(cfg32, n_layers=ENCDEC_CPU_LAYERS,
                                  n_encoder_layers=ENCDEC_CPU_LAYERS)
    p_cut = init_encdec(1, cfg_cut, dev)
    frames = rng.standard_normal(
        (2, ENCDEC_FRAMES, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size,
                          (2, ENCDEC_CPU_PROMPT)).astype(np.int32)
    rep["card_vs_cpu"] = dict(
        encoder_layers=ENCDEC_CPU_LAYERS, frames=ENCDEC_FRAMES,
        **lm_card_vs_cpu(cfg_cut, p_cut, prompt, ENCDEC_CPU_GEN,
                         frames=frames))
    del p_cut
    lm_free()

    # (d) the serving loop in bf16 with the side-car, twice.  A step reads
    # the decoder's weights (not the cross keys/values' projections: their
    # products are the cache's memory), the tied table, and the f32
    # memory of every decoder layer
    step_params = sum(
        p.numel() for name, p in params.named_parameters()
        if not name.startswith(("enc_blocks.", "enc_norm."))
        and ".cross.wk." not in name and ".cross.wv." not in name)
    args_batch = int(ENCDEC_SERVE_ARGV[ENCDEC_SERVE_ARGV.index("--batch")
                                       + 1])
    memory_bytes = (2 * 4 * cfg.n_layers * args_batch * ENCDEC_FRAMES
                    * cfg.n_kv_heads * cfg.head_dim_)
    rep["serve"] = lm_serve_twice(ENCDEC_SERVE_ARGV, params, dict(
        weight_read_bound=2 * step_params,
        f32_weight_read_bound=4 * step_params,
        f32_memory_read_bound=memory_bytes,
        f32_step_read_bound=4 * step_params + memory_bytes))
    rep["serve"]["step_params"] = step_params
    serve_shapes = launch_shapes()
    counts = launch_counts()
    del params
    lm_free()
    missing = [n for n in ("l2_top1", "l2_dist", "seg_topk")
               if counts[n] <= 0]
    if missing:
        raise AssertionError(f"the encoder-decoder path launched no "
                             f"{missing}")
    ms, recs = lm_kernel_shapes(dev, gen, serve_shapes, serve_shapes)
    return rep, counts, ms, recs


def train_close(what, got, want, tol):
    """Raise unless ``got`` is within ``tol`` relative of ``want``;
    returns the relative gap."""
    gap = abs(got - want) / max(abs(want), 1e-30)
    if not gap <= tol:
        raise AssertionError(f"{what}: {got} against {want} (relative gap "
                             f"{gap}, tolerance {tol})")
    return gap


def train_grads(model, params, batch, cfg):
    """``(loss, {name: gradient})`` of ``train.step.loss_fn``, as the train
    step takes them."""
    import torch
    from repro_torch.train.step import loss_fn

    named = list(params.named_parameters())
    with torch.enable_grad():
        loss, _ = loss_fn(model, params, batch, cfg)
        grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


def train_card_vs_cpu(cfg, opt_cfg, dev):
    """One local/global super-block (LM_CPU_LAYERS layers) at full width in
    f32: one train step on the card and on a CPU copy of its weights from
    the same batch.  The loss, ce and grad_norm within TRAIN_LOSS_TOL
    relative, every gradient within TRAIN_GRAD_TOL of its tensor's
    max|g| (the CPU tests' bounds), each updated weight within lr *
    (TRAIN_UPDATE_TOL + du) as tests/_torch_train.py::hold_step holds it:
    du = |u(g_card) - u(g_cpu)|, u(g) = g / (|g| + eps) the direction of
    a first Adam step, g the gradient the step used (mu / (1 - b1)): up
    to 2 only where the two signs differ."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.models.transformer import Decoder, init_decoder
    from repro_torch.train.optim import init_opt
    from repro_torch.train.step import make_train_step

    B, S = TRAIN_CPU_BATCH
    batch = TokenPipeline(vocab=cfg.vocab_size, batch=B, seq_len=S,
                          seed=1).batch_at(0)
    p_card = init_decoder(2, cfg, dev)
    p_cpu = Decoder(cfg, device="cpu")
    p_cpu.load_state_dict(p_card.state_dict())
    out = {}
    for where, p in (("card", p_card), ("cpu", p_cpu)):
        d = next(p.parameters()).device
        model, step = make_train_step(cfg, opt_cfg, device=d)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        t = time.perf_counter()
        loss, grads = train_grads(model, p, b, cfg)
        _, opt, m = step(p, init_opt(p), b)
        m = {k: float(v) for k, v in m.items()}
        out[where] = dict(loss=loss, metrics=m, seconds=time.perf_counter()
                          - t, grads={n: g.cpu() for n, g in grads.items()},
                          used={n: u.cpu().double() / (1 - opt_cfg.b1)
                                for n, u in opt.mu.items()},
                          params={n: q.detach().cpu()
                                  for n, q in p.named_parameters()})
    card, cpu = out["card"], out["cpu"]
    rep = dict(layers=cfg.n_layers, batch=[B, S], card_s=card["seconds"],
               cpu_s=cpu["seconds"])
    for key in ("loss", "ce", "grad_norm"):
        rep[f"{key}_gap"] = train_close(
            f"card against CPU {key}", card["metrics"][key],
            cpu["metrics"][key], TRAIN_LOSS_TOL)
    rep["lr_equal"] = card["metrics"]["lr"] == cpu["metrics"]["lr"]
    gaps, upd, flips = {}, 0.0, 0
    lr, eps = cpu["metrics"]["lr"], opt_cfg.eps
    for n, want in cpu["grads"].items():
        got = card["grads"][n]
        scale = max(float(want.abs().max()), 1e-30)
        gaps[n] = float((got - want).abs().max()) / scale
        gg, gw = card["used"][n], cpu["used"][n]
        du = (gg / (gg.abs() + eps) - gw / (gw.abs() + eps)).abs()
        atol = lr * (TRAIN_UPDATE_TOL + du)
        flips += int((gg.sign() != gw.sign()).sum())
        diff = (card["params"][n] - cpu["params"][n]).abs()
        if bool((diff > atol).any()):
            raise AssertionError(f"card against CPU: updated {n} differs "
                                 f"by {float(diff.max())}")
        upd = max(upd, float(diff.max()))
    worst = max(gaps, key=gaps.get)
    if not gaps[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"card against CPU: gradient of {worst} "
                             f"{gaps[worst]} of its max (tolerance "
                             f"{TRAIN_GRAD_TOL})")
    rep.update(grad_gap=gaps[worst], grad_gap_at=worst,
               update_max_abs=upd, update_sign_flips=flips, tolerance=dict(
                   loss=TRAIN_LOSS_TOL, grad=TRAIN_GRAD_TOL,
                   update=lr * TRAIN_UPDATE_TOL), tensors=len(gaps))
    return rep


def train_resume(workdir):
    """``launch.train.main`` on the card, reduced gemma3 (the reference's
    crash-and-resume test): the unbroken 30-step run twice, and a run
    stopped after 20 steps then resumed from its checkpoint; the resumed
    losses within TRAIN_RESUME_RTOL of the unbroken run's, with whether
    the runs and their step-30 checkpoints are equal bit for bit."""
    import shutil

    import numpy as np
    from repro_torch.launch.train import main as train_main

    shutil.rmtree(workdir, ignore_errors=True)
    runs = {}
    t = time.perf_counter()
    for name in ("a", "b"):
        runs[name] = train_main(TRAIN_RESUME_ARGV + [
            "--ckpt-dir", str(workdir / name), "--resume", "never"])
    first = train_main(TRAIN_RESUME_ARGV + [
        "--ckpt-dir", str(workdir / "c"), "--resume", "never",
        "--stop-after", "20"])
    resumed = train_main(TRAIN_RESUME_ARGV + ["--ckpt-dir",
                                              str(workdir / "c")])
    seconds = time.perf_counter() - t
    full = np.asarray(runs["a"])
    if len(first) != 20 or len(resumed) != len(full) - 20:
        raise AssertionError(f"stopped run {len(first)} steps, resumed "
                             f"{len(resumed)}")
    np.testing.assert_allclose(resumed, full[20:], rtol=TRAIN_RESUME_RTOL)

    def arrays(name):
        with np.load(workdir / name / "step_00000030" / "arrays.npz") as z:
            return {k: z[k] for k in z.files}

    ck = {name: arrays(name) for name in "abc"}
    same = {f"{x}{y}": all(np.array_equal(ck[x][k], ck[y][k]) for k in ck[x])
            for x, y in ("ab", "ac")}
    shutil.rmtree(workdir, ignore_errors=True)
    return dict(
        steps=len(full), seconds=seconds, loss_first=float(full[0]),
        loss_last=float(full[-1]),
        resumed_max_rel_gap=float(np.max(np.abs(np.asarray(resumed)
                                                - full[20:]) / full[20:])),
        rtol=TRAIN_RESUME_RTOL,
        two_runs_losses_bitwise_equal=bool(np.array_equal(runs["a"],
                                                          runs["b"])),
        two_runs_checkpoints_bitwise_equal=same["ab"],
        resumed_losses_bitwise_equal=bool(np.array_equal(
            np.asarray(first + resumed), full)),
        resumed_checkpoint_bitwise_equal=same["ac"])


def train_remat(cfg, opt_cfg, dev):
    """Phase 17 (g): one TRAIN_BATCH step of ``cfg`` from the same weights
    and batch without recomputation and under each ``remat_policy``: the
    loss and each gradient against the step without (bit for bit, else
    within TRAIN_REMAT_TOL of its tensor's max, the reason printed); then
    each policy's peak GB and ms a step (TRAIN_REMAT_STEPS steps after one
    warm-up, each synchronised on its metrics)."""
    import dataclasses

    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train.optim import init_opt
    from repro_torch.train.step import loss_fn, make_train_step

    B, S = TRAIN_BATCH
    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=B, seq_len=S, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(i).items()}
               for i in range(1 + TRAIN_REMAT_STEPS)]
    params = init_decoder(0, cfg, dev)
    named = list(params.named_parameters())

    def policy_cfg(policy):
        return dataclasses.replace(
            cfg, remat_policy="full" if policy == "none" else policy)

    rep, base = {}, None
    for policy in TRAIN_REMAT_POLICIES:
        c = policy_cfg(policy)
        model, _ = make_train_step(c, opt_cfg, device=dev)
        with torch.enable_grad():
            loss, ce = loss_fn(model, params, batches[0], c,
                               remat=policy != "none")
            grads = torch.autograd.grad(loss, [p for _, p in named])
        loss, ce = loss.detach(), ce.detach()
        if base is None:
            base = (loss, ce, grads)
            rep[policy] = dict(loss=float(loss))
            continue
        equal = torch.equal(loss, base[0]) and torch.equal(ce, base[1])
        gaps = {}
        for (n, _), g, w in zip(named, grads, base[2]):
            if not torch.equal(g, w):
                gaps[n] = float((g - w).abs().max()) / max(
                    float(w.abs().max()), 1e-30)
        worst = max(gaps, key=gaps.get) if gaps else None
        if worst is not None and not gaps[worst] <= TRAIN_REMAT_TOL:
            raise AssertionError(f"remat {policy}: gradient of {worst} "
                                 f"{gaps[worst]} of its max from the step "
                                 "without recomputation")
        if not equal:
            train_close(f"remat {policy} loss", float(loss), float(base[0]),
                        TRAIN_REMAT_TOL)
        rep[policy] = dict(
            loss=float(loss), loss_bitwise_equal=equal,
            grads_bitwise_equal=not gaps, grads_differing=len(gaps),
            grad_gap=gaps[worst] if gaps else 0.0, grad_gap_at=worst,
            reason=None if not gaps and equal else (
                "the card's products are not bit-stable across a "
                "recomputation"))
        del grads
    del base
    lm_free()
    for policy in TRAIN_REMAT_POLICIES:
        _, step = make_train_step(policy_cfg(policy), opt_cfg, device=dev,
                                  remat=policy != "none")
        opt = init_opt(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for b in batches:
            t = time.perf_counter()
            _, opt, m = step(params, opt, b)
            float(m["loss"])
            ms.append(1e3 * (time.perf_counter() - t))
        rep[policy].update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                           warmup_ms=ms[0], ms_by_step=ms[1:],
                           ms_mean=sum(ms[1:]) / len(ms[1:]))
        del opt, step
        lm_free()
    return dict(batch=[B, S], steps=TRAIN_REMAT_STEPS, tol=TRAIN_REMAT_TOL,
                **rep)


def lm_training(dev):
    """Phase 17 (module docstring): gemma3-1b trained at full width and
    depth.  Counts set to 0 before, read after (no kernel of the port is
    on the path)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train.optim import AdamWConfig, apply_updates, init_opt
    from repro_torch.train.step import make_train_step

    cfg = get_config(LM_ARCH)
    B, S = TRAIN_BATCH
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          total_steps=TRAIN_STEPS)
    rep = {}
    reset_launches()
    t = time.perf_counter()
    model, step = make_train_step(cfg, opt_cfg, device=dev)
    params = init_decoder(0, cfg, dev)
    state = dict(opt=init_opt(params))
    torch.cuda.synchronize()
    rep["model"] = dict(lm_check_count(cfg, params, LM_PARAMS),
                        dtype=cfg.dtype, init_s=time.perf_counter() - t)
    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=B, seq_len=S, seed=0)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(i).items()}

    def train_one(b):
        _, state["opt"], m = step(params, state["opt"], b)
        return {k: float(v) for k, v in m.items()}

    # (a) TRAIN_STEPS steps, each synchronised on its metrics
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(TRAIN_STEPS):
        b = batch_at(i)
        t = time.perf_counter()
        m = train_one(b)
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(m["loss"])
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] \
            - TRAIN_LOSS_DROP:
        raise AssertionError(f"the loss did not fall by {TRAIN_LOSS_DROP}: "
                             f"{losses}")
    tokens = B * S
    six_nd_ms = 1e3 * 6 * LM_PARAMS * tokens / PEAK_BF16_S
    steady = lm_stats(ms[1:])
    rep["train"] = dict(
        steps=TRAIN_STEPS, batch=[B, S], lr=TRAIN_LR, losses=losses,
        loss_drop=losses[0] - losses[-1], first_step_ms=ms[0], **steady,
        tokens_per_s=1e3 * tokens / steady["mean_ms"],
        six_nd_bound_ms=six_nd_ms,
        six_nd_share=six_nd_ms / steady["mean_ms"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    # (b) the optimizer alone, on one step's gradients: against the bytes
    # AdamW must move (read p, g, m, v; write p, m, v: 28 bytes a weight)
    _, grads = train_grads(model, params, batch_at(TRAIN_STEPS), cfg)
    opt_ms = cuda_ms(lambda: apply_updates(params, grads, state["opt"],
                                           opt_cfg),
                     reps=TRAIN_OPT_REPS, warmup=1)
    del grads
    opt_bound = 1e3 * 28 * LM_PARAMS / PEAK_BYTES_S
    rep["optimizer"] = dict(ms=opt_ms, byte_bound_ms=opt_bound,
                            byte_bound_share=opt_bound / opt_ms,
                            share_of_step=opt_ms / steady["mean_ms"])

    # (c) one step traced
    b = batch_at(TRAIN_STEPS + 1)
    rep["trace"] = lm_trace(lambda: train_one(b), steps=1)

    del params, state
    lm_free()

    # (d) the checkpoint of (params, OptState) of the model cut to
    # TRAIN_CKPT_LAYERS layers after one step, written and read back: the
    # restored state trains on to the same two next losses
    cfg_ck = dataclasses.replace(cfg, n_layers=TRAIN_CKPT_LAYERS)
    _, step = make_train_step(cfg_ck, opt_cfg, device=dev)
    params = init_decoder(0, cfg_ck, dev)
    state = dict(opt=init_opt(params))
    train_one(batch_at(0))
    ck = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    nxt = [batch_at(TRAIN_STEPS + 2 + i) for i in range(2)]
    t = time.perf_counter()
    save_checkpoint(ck, int(state["opt"].step), (params, state["opt"]),
                    extra={"pipeline": pipe.state()})
    save_s = time.perf_counter() - t
    gb = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file()) / 1e9
    before = [train_one(b)["loss"] for b in nxt]
    t = time.perf_counter()
    (_, state["opt"]), manifest = restore_checkpoint(
        ck, (params, state["opt"]))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    after = [train_one(b)["loss"] for b in nxt]
    shutil.rmtree(ck, ignore_errors=True)
    for x, y in zip(after, before):
        train_close("next loss after restore", x, y, TRAIN_LOSS_TOL)
    rep["checkpoint"] = dict(
        layers=TRAIN_CKPT_LAYERS, step=manifest["step"],
        keys=len(manifest["keys"]), gb=gb, save_s=save_s,
        restore_s=restore_s, save_gb_s=gb / save_s,
        restore_gb_s=gb / restore_s, next_losses=before,
        next_losses_bitwise_equal=after == before)
    del params, state, step
    lm_free()

    # (g) one step without recomputation and under "full" and "dots"
    rep["remat"] = train_remat(cfg, opt_cfg, dev)
    print("  remat: " + json.dumps({
        k: {x: v[x] for x in ("peak_gb", "ms_mean", "loss_bitwise_equal",
                              "grads_bitwise_equal", "grad_gap",
                              "reason") if x in v}
        for k, v in rep["remat"].items() if isinstance(v, dict)}))
    lm_free()

    # (e) one super-block at full width in f32, the card against the CPU
    cfg6 = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS, dtype="float32")
    rep["card_vs_cpu"] = train_card_vs_cpu(cfg6, opt_cfg, dev)
    lm_free()

    # (f) crash and resume through launch.train.main, reduced
    rep["resume"] = train_resume(ROOT / "build" / "train_resume")
    return rep, launch_counts()


def dist_rank(rank, world, init, job, out, args):
    """One rank of phase 18, spawned by :func:`run_dist`: a world of
    ``world`` ranks on cuda:0 over gloo through ``distributed.compat``;
    runs ``DIST_JOBS[job](*args)`` with this process's launch counts set
    to 0 and saves what it returns with the counts read after.  Any
    failure raises, and the parent fails the phase."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from repro_torch.distributed import compat
    from repro_torch.kernels import launch_counts, reset_launches

    compat.init_distributed(device="cuda:0", backend="gloo",
                            init_method=f"file://{init}", world_size=world,
                            rank=rank)
    try:
        reset_launches()
        result = DIST_JOBS[job](*args)
        torch.save((result, launch_counts()), Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_dist(job, world, workdir, *args):
    """``(results, launches)``: every rank's result of ``job`` on
    ``world`` spawned ranks, in rank order, and the kernel launches the
    ranks made, summed; a failing rank stops the others and raises, and
    so does a rank still running after DIST_TIMEOUT_S."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    out = workdir / job
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    init = workdir / f"{job}.{time.monotonic_ns()}.init"
    ctx = mp.spawn(dist_rank, args=(world, str(init), job, str(out), args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + DIST_TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job}: ranks still running after "
                               f"{DIST_TIMEOUT_S} s")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    launches = {}
    for _, counts in ranks:
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
    return [result for result, _ in ranks], launches


def digest(t):
    """A hash of a tensor's bytes: ranks compare results by it."""
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def dense_decode(q, k, v, valid):
    """One-token attention over the whole cache (tests/test_distributed.py's
    dense reference)."""
    import torch

    B, _, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k) / D ** 0.5
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), torch.finfo(torch.float32).min,
                               device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, v).reshape(B, 1, H, D)


def dist_sp(dev):
    """SP decode at granite-20b's attention width over DIST_WORLD ranks
    against dense attention (phase 18, 1)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import compat, make_sp_decode
    from repro_torch.launch.mesh import make_mesh_compat

    cfg = get_config(SP_ARCH)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    B, T = SP_BATCH, SP_T
    mesh = make_mesh_compat((DIST_WORLD,), ("model",), device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    q = torch.randn((B, 1, H, D), generator=gen, device=dev)
    k = torch.randn((B, T, KV, D), generator=gen, device=dev)
    v = torch.randn((B, T, KV, D), generator=gen, device=dev)
    valid = (torch.arange(T, device=dev) < T - SP_INVALID)[None].expand(
        B, T).contiguous()
    fn = make_sp_decode(mesh)
    with torch.no_grad():
        torch.cuda.synchronize()
        out, first_s = timed(lambda: fn(q, k, v, valid))
        compat.reset_stats()
        again, s = timed(lambda: [fn(q, k, v, valid)
                                  for _ in range(SP_REPS)][-1])
        coll = compat.STATS.as_dict()
        want, dense_s = timed(lambda: [dense_decode(q, k, v, valid)
                                       for _ in range(SP_REPS)][-1])
    err = float((out - want).abs().max())
    if not torch.allclose(out, want, rtol=SP_TOL, atol=SP_TOL) or \
            not torch.equal(out, again):
        raise AssertionError(f"SP decode against dense: max |err| {err} "
                             f"(tolerance {SP_TOL}), repeat equal "
                             f"{torch.equal(out, again)}")
    return dict(arch=SP_ARCH, shape=dict(B=B, T=T, H=H, KV=KV, D=D),
                invalid=SP_INVALID, ranks=DIST_WORLD, max_abs_err=err,
                scale=float(want.abs().max()), tol=SP_TOL,
                first_ms=1e3 * first_s, ms=1e3 * s / SP_REPS,
                dense_ms=1e3 * dense_s / SP_REPS,
                collectives_per_call={op: dict(
                    calls=c["calls"] / SP_REPS, bytes=c["bytes"] / SP_REPS,
                    ms=1e3 * c["seconds"] / SP_REPS)
                    for op, c in coll.items()}, digest=digest(out))


def dist_pp(dev, rank):
    """GPipe over DIST_WORLD ranks, each stage one full-width minitron-4b
    layer (seeded by its stage), against the layers in sequence (phase
    18, 2)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import compat, pipeline_apply
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.transformer import DenseBlock, _dense_block

    cfg = dataclasses.replace(get_config(PP_ARCH), dtype="float32")
    mesh = make_mesh_compat((DIST_WORLD,), ("pod",), device=dev)
    mb, S = PP_MB

    def layer(i):
        blk = DenseBlock(cfg, device=dev)
        blk.init_(torch.Generator(device=dev).manual_seed(100 + i))
        return blk

    gen = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn((PP_MICRO, mb, S, cfg.d_model), generator=gen,
                    device=dev)
    positions = torch.arange(S, device=dev)[None].expand(mb, S)

    def stage_fn(blk, h):
        return _dense_block(blk, h, positions, cfg)

    piped = pipeline_apply(stage_fn, DIST_WORLD, PP_MICRO, mesh, axis="pod")
    mine = layer(rank)
    with torch.no_grad():
        piped(mine, x)                               # warm-up
        compat.reset_stats()
        torch.cuda.synchronize()
        out, s = timed(lambda: piped(mine, x))
        coll = compat.STATS.as_dict()
        rep = dict(arch=PP_ARCH, layer=dict(d=cfg.d_model, heads=cfg.n_heads,
                                            kv=cfg.n_kv_heads, ff=cfg.d_ff),
                   stages=DIST_WORLD, micro=PP_MICRO, micro_batch=[mb, S],
                   ms=1e3 * s, bubble_share=(DIST_WORLD - 1) / (
                       DIST_WORLD - 1 + PP_MICRO),
                   collectives={op: dict(calls=c["calls"], bytes=c["bytes"],
                                         ms=1e3 * c["seconds"])
                                for op, c in coll.items()},
                   digest=digest(out))
        if rank == 0:
            layers = [mine] + [layer(i) for i in range(1, DIST_WORLD)]

            def sequential():
                h = x
                for blk in layers:
                    h = torch.stack([stage_fn(blk, h[i])
                                     for i in range(PP_MICRO)])
                return h

            want, seq_s = timed(sequential)
            scale = float(want.abs().max())
            err = float((out - want).abs().max())
            if not err <= PP_TOL * scale:
                raise AssertionError(f"GPipe against the layers in sequence:"
                                     f" max |err| {err} at a scale of "
                                     f"{scale} (tolerance {PP_TOL})")
            rep.update(sequential_ms=1e3 * seq_s, max_abs_err=err,
                       scale=scale, tol=PP_TOL,
                       bitwise_equal=bool(torch.equal(out, want)))
    return rep


def shard_report(params, opt, mesh):
    """This rank's shards (numpy) with its coords and the specs, for the
    parent's replica check."""
    return dict(coords=mesh.coords, specs=dict(params.specs),
                **{key: {n: t.detach().cpu().numpy() for n, t in d.items()}
                   for key, d in (("params", params), ("mu", opt.mu),
                                  ("nu", opt.nu))})


def dist_small_steps(dev):
    """Reduced gemma3 on DIST_SMALL_MESH: DIST_SMALL_STEPS sharded steps
    and the plain step's losses (phase 18, 3b)."""
    import torch
    from repro_torch.checkpoint import reshard
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import param_shardings
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train.optim import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    cfg = reduced(get_config(LM_ARCH))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          total_steps=TRAIN_STEPS)
    mesh = make_mesh_compat(DIST_SMALL_MESH, ("data", "model"), device=dev)
    B, S = DIST_SMALL_BATCH
    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=B, seq_len=S, seed=0)
    losses = {}
    for name, m in (("plain", None), ("sharded", mesh)):
        p = init_decoder(0, cfg, dev)
        if m is not None:
            p = reshard(p, param_shardings(p, mesh, cfg.n_experts), mesh)
        opt = init_opt(p)
        _, step = make_train_step(cfg, opt_cfg, device=dev, mesh=m)
        losses[name] = []
        for i in range(DIST_SMALL_STEPS):
            p, opt, met = step(p, opt, pipe.batch_at(i))
            losses[name].append(float(met["loss"]))
    for got, want in zip(losses["sharded"], losses["plain"]):
        train_close("sharded against plain loss", got, want, TRAIN_LOSS_TOL)
    return dict(mesh=list(DIST_SMALL_MESH), steps=DIST_SMALL_STEPS,
                batch=[B, S], losses=losses, **shard_report(p, opt, mesh))


def dist_reshard(dev, ckpt_dir):
    """The reduced checkpoint restored on the host and resharded onto each
    of RESHARD_MESHES: every local shard bit-equal to its slice, the
    gathered state to the restored one (phase 18, 4)."""
    import numpy as np
    from repro_torch.checkpoint import reshard, restore_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import local_slice, param_shardings
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.transformer import Decoder

    cfg = reduced(get_config(LM_ARCH))
    template = Decoder(cfg, device="cpu")
    restore_checkpoint(ckpt_dir, template)
    named = dict(template.named_parameters())
    rep = []
    for shape in RESHARD_MESHES:
        mesh = make_mesh_compat(shape, ("data", "model"), device=dev)
        specs = param_shardings(template, mesh, cfg.n_experts)
        placed = reshard(template, specs, mesh)
        for n, t in named.items():
            want = local_slice(t.detach(), specs[n], mesh).numpy()
            got = placed[n].cpu().numpy()
            whole = placed.whole(n).cpu().numpy()
            if got.tobytes() != np.ascontiguousarray(want).tobytes() or \
                    whole.tobytes() != t.detach().numpy().tobytes():
                raise AssertionError(f"reshard onto {shape}: {n} is not its "
                                     "slice, or does not gather back")
        rep.append(dict(mesh=list(shape), coords=mesh.coords,
                        tensors=len(named),
                        sharded=sum(any(s) for s in specs.values()),
                        local_bytes=sum(t.numel() * t.element_size()
                                        for t in placed.values())))
    return rep


def dist_four(ckpt_dir):
    """The DIST_WORLD-rank job of phase 18: SP decode, GPipe, reduced
    sharded steps on (2, 2), reshard, and the full-width steps whose
    compute the model axis splits (gemma3-1b, olmoe-1b-7b cut to
    DIST_TP_MOE_LAYERS layers, whose loss and gradients are also
    computed twice from one state and compared bit for bit), served;
    then zamba2-2.7b's and xlstm-1.3b's super-blocks, their mixers split
    by head, trained one step, prefilled and decoded, their states where
    the rules store them."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    rank = dist.get_rank()
    rep = dict(sp=dist_sp(dev), pp=dist_pp(dev, rank),
               steps=dist_small_steps(dev),
               reshard=dist_reshard(dev, ckpt_dir))
    lm_free()
    rep["tp"] = dist_tp(dev, LM_ARCH)
    lm_free()
    rep["tp_moe"] = dist_tp(dev, MOE_ARCH, DIST_TP_MOE_LAYERS, repeat=True)
    lm_free()
    rep["serve"] = dist_serve(dev, LM_ARCH, None, ckpt_dir)
    lm_free()
    rep["serve_moe"] = dist_serve(dev, MOE_ARCH, DIST_TP_MOE_LAYERS,
                                  ckpt_dir)
    for arch in DIST_TP_MIXER_ARCHS:
        lm_free()
        rep[f"tp {arch}"] = dist_tp(
            dev, arch, DIST_TP_MIXER_LAYERS, f64=arch == XLSTM_ARCH,
            save=saved_steps(ckpt_dir) if arch == XLSTM_ARCH else None)
        lm_free()
        rep[f"serve {arch}"] = dist_serve(dev, arch, DIST_TP_MIXER_LAYERS,
                                          ckpt_dir)
    return rep


def saved_steps(ckpt_dir):
    """Where the (2, 2) xlstm case leaves its one-process steps for the
    (1, 8) case (:func:`dist_tp`'s ``save`` and ``reuse``)."""
    return Path(ckpt_dir).parent / "xlstm_steps"


def dist_eight(ckpt_dir):
    """The DIST_GROUP_WORLD-rank job of phase 18: xlstm-1.3b's super-block
    on DIST_GROUP_MESH, each of its 4 heads on a group of two model
    ranks: one sharded step against the one-process steps the (2, 2)
    case saved, then its prefill and decode as on (2, 2)."""
    import torch

    dev = torch.device("cuda", 0)
    rep = {"tp": dist_tp(dev, XLSTM_ARCH, DIST_TP_MIXER_LAYERS, f64=True,
                         mesh_shape=DIST_GROUP_MESH,
                         reuse=saved_steps(ckpt_dir))}
    lm_free()
    rep["serve"] = dist_serve(dev, XLSTM_ARCH, DIST_TP_MIXER_LAYERS,
                              ckpt_dir, mesh_shape=DIST_GROUP_MESH)
    return rep


def serve_cfg(arch, n_layers):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def serve_oracle_path(workdir, arch):
    return Path(workdir) / f"serve_{arch}.pt"


def serve_inputs(cfg, arch):
    """The serving phase's prompts (DIST_TRAIN_BATCH) and the tokens that
    fill and then drive the decode, ``(B, fill + steps)``."""
    import torch
    from repro_torch.data import TokenPipeline

    B, S = DIST_TRAIN_BATCH
    prompt = serve_prompt(cfg)
    seq = TokenPipeline(vocab=cfg.vocab_size, batch=B,
                        seq_len=DIST_SERVE_FILL[arch] + DIST_SERVE_STEPS,
                        seed=2).batch_at(0)["tokens"]
    return prompt, torch.from_numpy(seq)


def serve_prompt(cfg):
    """The serving phase's prompts, DIST_TRAIN_BATCH ``(B, S)`` tokens."""
    import torch
    from repro_torch.data import TokenPipeline

    B, S = DIST_TRAIN_BATCH
    return torch.from_numpy(TokenPipeline(
        vocab=cfg.vocab_size, batch=B, seq_len=S, seed=1).batch_at(0)[
            "tokens"])


def checked_prefill(arch, prefill, params, prompt, want, routes):
    """The sharded ``prefill`` of ``prompt`` from this rank's ``params``,
    twice: the first call gathers the step's working module, the second
    is timed with its collectives counted (``compat.STATS``) and each MoE
    routing appended to ``routes``; its logits within DIST_SERVE_TOL of
    the one-process prefill's (``want["prefill"]``; raises where not) ->
    ``(gap, first call's s, s, collectives)`` (phase 18)."""
    import torch.distributed as dist
    from repro_torch.distributed import compat

    dist.barrier()
    _, first_s = timed(lambda: prefill(params, {"tokens": prompt}))
    dist.barrier()
    compat.reset_stats()
    with recording_routing(routes):
        pre, pre_s = timed(lambda: prefill(params, {"tokens": prompt}))
    coll = compat.STATS.as_dict()
    gap = serve_gap(pre, want["prefill"])
    if not gap <= DIST_SERVE_TOL:
        raise AssertionError(f"{arch}: sharded prefill {gap} of the "
                             "logits' scale from the one-process prefill")
    return gap, first_s, pre_s, coll


def mixer_decode_calls(cfg, mesh_shape, batch):
    """The model axis's collectives a decode step of ``cfg``'s Mamba2,
    mLSTM and sLSTM layers on a (data, model) ``mesh_shape`` at ``batch``
    sequences (f32 states and activations), and the mixers' weights a
    rank holds, from the shapes; the rules split a dimension over "model"
    where tp divides it.  ``now``: ``(calls, bytes)`` with every weight at
    its stored model shard (Mamba2: ``in_proj``'s output gathered, then
    the conv on this rank's channels with its heads' ``dt`` and decay in
    one gather, the readout ``(B, H, P)`` and ``out_proj``'s row-split
    product ``(B, d)`` reduced; mLSTM: ``q``, ``k``, ``v``, ``z``, the
    gates and ``m`` in one gather, the readout ``(B, H, hd + 1)`` and
    ``wo``'s product reduced; sLSTM: the old ``h`` gathered, the
    pre-activations ``(B, 4d)`` from ``r``'s rows and ``wx``'s columns,
    the norm's sums of squares and ``wo``'s product reduced);
    ``whole_weights``: the weights whole and the states updated where
    ``cache_shardings`` stores them, as the decode was before it kept
    the weights at their shards; ``gathered``: every split state leaf
    gathered whole a layer, as before that.  Each call counts this
    rank's input bytes, as ``compat`` does.  ``held`` and ``held_whole``:
    the mixers' parameter bytes a rank at their stored shards and whole
    (phase 18)."""
    from repro_torch.models.transformer import segments_for

    dp, tp = mesh_shape
    b, f32, d = batch // dp, 4, cfg.d_model
    now, whole, gathered = [0, 0], [0, 0], [0, 0]
    held = {"held": 0, "held_whole": 0}
    kept = {"held": lambda n: n // tp if n % tp == 0 else n,
            "held_whole": lambda n: n}

    def part(n):                        # a rank's share where tp divides n
        return n // tp if n % tp == 0 else 0

    def calls(tally, sizes):
        for n in sizes:
            if n:
                tally[0] += 1
                tally[1] += b * n * f32

    def weights(count):                 # a layer's leaves, f32
        for key, c in kept.items():
            held[key] += count(c) * f32

    H, N, P = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    d_in = cfg.d_inner
    ch, cols = d_in + 2 * N, 2 * d_in + 2 * N + H
    Hx, hd = cfg.n_heads, cfg.head_dim_
    n, hb = Hx * hd, d // Hx
    for kind, n_iter, per in segments_for(cfg):
        for _ in range(n_iter):
            if kind == "mamba_hybrid":
                for _ in range(per):
                    calls(now, (part(cols), part(ch) + 2 * part(H),
                                H * P * (N % tp == 0),
                                d * (d_in % tp == 0)))
                    calls(whole, (part(ch), H * P * (N % tp == 0)))
                    calls(gathered, (H * P * part(N), 3 * part(ch)))
                    weights(lambda c: d * c(cols) + 4 * c(ch) + 3 * c(H)
                            + c(d_in) + c(d_in) * d)
            elif kind == "xlstm_super":
                for _ in range(per - 1):
                    calls(now, (4 * part(n) + part(2 * Hx) + part(Hx),
                                Hx * (hd + 1) * (hd % tp == 0),
                                d * (n % tp == 0)))
                    calls(whole, (part(Hx), Hx * (hd + 1) * (hd % tp == 0)))
                    calls(gathered, (part(Hx), Hx * (hd + 1) * part(hd)))
                    weights(lambda c: 4 * d * c(n) + d * c(2 * Hx)
                            + c(2 * Hx) + c(n) + c(n) * d)
                calls(now, (part(d),
                            4 * d * (hb % tp == 0 or 4 * d % tp == 0),
                            d % tp == 0, d * (d % tp == 0)))
                calls(whole, (part(d),) * (1 if Hx % tp == 0 else 2))
                calls(gathered, (part(d),) * 4)
                weights(lambda c: d * c(4 * d) + c(4 * d)
                        + Hx * c(hb) * 4 * hb + c(d) + c(d) * d)
    return dict(now=tuple(now), whole_weights=tuple(whole),
                gathered=tuple(gathered), **held)


def serve_oracle(dev, arch, n_layers, workdir):
    """The one-process side of the serving check (phase 18), once, in this
    process: ``arch``'s prefill of the prompts, the cache filled by
    DIST_SERVE_FILL one-process serve steps, then DIST_SERVE_STEPS more,
    each with its logits (``decode_step`` on the same cache first) and
    MoE routing, and the last cache; saved (on the host) for the ranks to
    read."""
    import os

    import torch
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg = serve_cfg(arch, n_layers)
    prompt, seq = serve_inputs(cfg, arch)
    prompt, seq = prompt.to(dev), seq.to(dev)
    B = prompt.shape[0]
    fill = DIST_SERVE_FILL[arch]
    p = init_decoder(0, cfg, dev)
    model, prefill = make_prefill_step(cfg, device=dev)
    _, serve = make_serve_step(cfg, device=dev)
    prefill(p, {"tokens": prompt})      # the process's first at this shape
    pre_routes = []
    with recording_routing(pre_routes):
        pre, pre_s = timed(lambda: prefill(p, {"tokens": prompt}))
    cache = model.init_cache(B, DIST_SERVE_MAX_LEN[arch], torch.float32)
    t = time.perf_counter()
    for i in range(fill):
        _, cache = serve(p, cache, {"token": seq[:, i:i + 1]})
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t
    cache0 = host_tree(cache)
    logits, tokens, ms, routes = [], [], [], []
    for i in range(fill, fill + DIST_SERVE_STEPS):
        inputs = {"token": seq[:, i:i + 1]}
        with torch.no_grad(), recording_routing(routes):
            logits.append(model.decode_step(p, cache, **inputs)[0][:, -1]
                          .cpu())
        (tok, cache), s = timed(lambda: serve(p, cache, inputs))
        tokens.append(tok.cpu())
        ms.append(1e3 * s)
    out = dict(prefill=pre.cpu(), prefill_ms=1e3 * pre_s, fill_s=fill_s,
               cache0=cache0, final=host_tree(cache),
               logits=torch.stack(logits),
               tokens=torch.stack(tokens), ms=ms, routes=routes,
               prefill_routes=pre_routes)
    path = serve_oracle_path(workdir, arch)
    torch.save(out, str(path) + ".part")
    os.replace(str(path) + ".part", path)
    del p, cache, cache0
    lm_free()


def host_tree(cache):
    """A copy of a cache with every tensor on the host."""
    from repro_torch.distributed import map_cache

    return map_cache(lambda t: t.detach().to("cpu", copy=True), cache)


def serve_gap(got, want):
    """max |got - want| over max(1, max |want|): the CPU serving tests'
    bound's form."""
    want = want.double()
    return float((got.double().cpu() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def dist_serve(dev, arch, n_layers, ckpt_dir, mesh_shape=DIST_TP_MESH):
    """``arch`` at full width (f32; depth cut to ``n_layers`` where given)
    served on ``mesh_shape``: the sharded prefill and DIST_SERVE_STEPS
    sharded serve steps from the one-process cache placed by
    ``cache_shardings``, against the one-process side that this script's
    own process computed (:func:`serve_oracle`): logits, tokens and each
    rank's final cache slices; with ms, the collectives' host ms and the
    recurrent mixers' model-axis calls and bytes a step against
    :func:`mixer_decode_calls` (phase 18)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import reshard
    from repro_torch.distributed import (ShardedCache, compat, map_cache,
                                         param_shardings)
    from repro_torch.distributed import sp as SP
    from repro_torch.distributed.sharding import (SPLIT, compute_split,
                                                  local_slice)
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train import step as ST

    cfg = serve_cfg(arch, n_layers)
    prompt, seq = serve_inputs(cfg, arch)
    prompt, seq = prompt.to(dev), seq.to(dev)
    B, fill = prompt.shape[0], DIST_SERVE_FILL[arch]
    mesh = make_mesh_compat(mesh_shape, ("data", "model"), device=dev)
    p = init_decoder(0, cfg, dev)
    params = reshard(p, param_shardings(p, mesh, cfg.n_experts), mesh)
    del p
    lm_free()
    want = torch.load(serve_oracle_path(Path(ckpt_dir).parent, arch),
                      weights_only=False)
    torch.cuda.reset_peak_memory_stats()
    model, prefill = ST.make_prefill_step(cfg, device=dev, mesh=mesh)
    _, serve = ST.make_serve_step(cfg, device=dev, mesh=mesh)
    pre_routes = []
    pre_gap, first_s, pre_s, pre_coll = checked_prefill(
        arch, prefill, params, prompt, want, pre_routes)
    b = B // mesh.axis_size("data")
    mine = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
    S = prompt.shape[1]
    rows = slice(mine.start * S, mine.stop * S)
    routing_equal(arch, "prefill", pre_routes, want["prefill_routes"], rows)

    def placed():
        return ShardedCache.place(want["cache0"], mesh, B, cfg.n_kv_heads)

    # the steps held against the one-process ones: each step's whole
    # logits gathered from what serve_step hands greedy_pick
    cache, got, tokens, routes, sp_calls = placed(), [], [], [], []
    pick = ST.greedy_pick

    def spy(lg, m, batch, vocab):
        got.append(ST.whole_logits(lg, m, batch, vocab).cpu())
        return pick(lg, m, batch, vocab)

    ST.greedy_pick, inner_sp = spy, SP.sp_decode_attention
    SP.sp_decode_attention = lambda *a: (sp_calls.append(1), inner_sp(*a))[1]
    try:
        with recording_routing(routes):
            for i in range(fill, fill + DIST_SERVE_STEPS):
                tok, cache = serve(params, cache, {"token": seq[:, i:i + 1]})
                tokens.append(tok.cpu())
    finally:
        ST.greedy_pick, SP.sp_decode_attention = pick, inner_sp
    gaps, checked, equal = [], 0, 0
    for lg, w, tok, wt in zip(got, want["logits"], tokens, want["tokens"]):
        gaps.append(serve_gap(lg, w))
        top2 = w.double().topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > DIST_SERVE_TOL * max(
            1.0, float(w.abs().max()))
        if not torch.equal(tok[clear], wt[clear]):
            raise AssertionError(f"{arch}: sharded tokens {tok.tolist()} "
                                 f"against {wt.tolist()}")
        checked += int(clear.sum())
        equal += int((tok == wt).sum())
    if not max(gaps) <= DIST_SERVE_TOL:
        raise AssertionError(f"{arch}: sharded decode {max(gaps)} of the "
                             "logits' scale from the one-process decode")
    cache_gaps = []
    map_cache(lambda t, w, spec: cache_gaps.append(serve_gap(
        t, local_slice(w, spec, mesh))), cache.local, want["final"],
        cache.specs)
    if not max(cache_gaps) <= DIST_SERVE_TOL:
        raise AssertionError(f"{arch}: a rank's final cache slice "
                             f"{max(cache_gaps)} of its scale from the "
                             "one-process cache's")
    routing_equal(arch, "decode", routes, want["routes"], mine)
    # the same steps again, timed alone: no logits gathered
    cache, ms, again = placed(), [], []
    torch.cuda.synchronize()
    dist.barrier()
    compat.reset_stats()
    for i in range(fill, fill + DIST_SERVE_STEPS):
        (tok, cache), s = timed(lambda: serve(
            params, cache, {"token": seq[:, i:i + 1]}))
        ms.append(1e3 * s)
        again.append(tok.cpu())
    coll = compat.STATS.as_dict()
    recurrent = compat.APART.get("recurrent")
    recurrent = {} if recurrent is None else recurrent.as_dict()
    model = [sum(c[k] for op, c in coll.items() if op.startswith("model:"))
             / DIST_SERVE_STEPS for k in ("calls", "bytes")]
    mixers = None
    if recurrent:
        got = tuple(sum(c[k] for c in recurrent.values()) / DIST_SERVE_STEPS
                    for k in ("calls", "bytes"))
        predicted = mixer_decode_calls(cfg, mesh_shape, B)
        if got != predicted["now"]:
            raise AssertionError(f"{arch}: the mixers' model-axis calls and "
                                 f"bytes a step {got} against the predicted "
                                 f"{predicted['now']}")
        # the serve step's working module: the mixers at their stored
        # model shards, every leaf's bytes against the shapes' count
        held = {k: sum(p.numel() * p.element_size() for name, p in
                       serve.held().named_parameters()
                       if (".mixer." in name or ".core." in name) == mix)
                for k, mix in (("mixers", True), ("rest", False))}
        split = compute_split(params.specs, cfg, mesh, mixers=False)
        rest = sum(4 * math.prod(params.shapes[name]) // (
            mesh.axis_size("model") if split[name] == SPLIT else 1)
            for name in params if ".mixer." not in name
            and ".core." not in name)
        if (held["mixers"], held["rest"]) != (predicted["held"], rest):
            raise AssertionError(f"{arch}: the serve step holds "
                                 f"{held['mixers']} bytes of mixer weights "
                                 f"and {held['rest']} of the rest a rank "
                                 f"against the predicted "
                                 f"{predicted['held']} and {rest}")
        mixers = dict(
            calls=got[0], mb=got[1] / 1e6, predicted_calls=predicted["now"][0],
            predicted_mb=predicted["now"][1] / 1e6,
            whole_weights_calls=predicted["whole_weights"][0],
            whole_weights_mb=predicted["whole_weights"][1] / 1e6,
            gathered_calls=predicted["gathered"][0],
            gathered_mb=predicted["gathered"][1] / 1e6,
            held_gb=(held["mixers"] + held["rest"]) / 1e9,
            predicted_held_gb=(predicted["held"] + rest) / 1e9,
            held_mixers_gb=held["mixers"] / 1e9,
            predicted_held_mixers_gb=predicted["held"] / 1e9,
            whole_mixers_gb=predicted["held_whole"] / 1e9,
            ms=1e3 * sum(c["seconds"] for c in recurrent.values())
            / DIST_SERVE_STEPS,
            ops={op: dict(calls=c["calls"] // DIST_SERVE_STEPS,
                          bytes=c["bytes"] // DIST_SERVE_STEPS)
                 for op, c in recurrent.items()})
    if not torch.equal(torch.stack(again), torch.stack(tokens)):
        raise AssertionError(f"{arch}: two sharded decodes differ")
    # one more step, its collectives and FLOPs counted alone (for the
    # dry-run of the same cell)
    cache, counted = placed(), {}
    compat.reset_stats()
    with counting_flops(counted):
        serve(params, cache, {"token": seq[:, fill:fill + 1]})
    one_step = dict(ops=op_counts(compat.STATS.as_dict()),
                    flops=counted["flops"])
    return dict(
        arch=arch, layers=cfg.n_layers, mesh=list(mesh_shape),
        prompt=list(prompt.shape), fill=fill, steps=DIST_SERVE_STEPS,
        max_len=DIST_SERVE_MAX_LEN[arch], tol=DIST_SERVE_TOL,
        prefill_gap=pre_gap, decode_gaps=gaps, decode_gap=max(gaps),
        cache_gap=max(cache_gaps), tokens_checked=checked,
        tokens_equal=equal,
        tokens=B * DIST_SERVE_STEPS, sp_calls=len(sp_calls),
        kv_specs=sorted(kv_specs(cache.specs)),
        routing_bit_equal=bool(routes) or None,
        first_prefill_ms=1e3 * first_s, prefill_ms=1e3 * pre_s,
        plain_prefill_ms=want["prefill_ms"], plain_fill_s=want["fill_s"],
        prefill_collectives=collective_report(pre_coll),
        ms_by_step=ms, ms_mean=sum(ms) / len(ms),
        plain_ms_by_step=want["ms"],
        plain_ms_mean=sum(want["ms"]) / len(want["ms"]),
        **collective_report(coll), one_step=one_step,
        model_axis_calls_a_step=model[0], model_axis_mb_a_step=model[1] / 1e6,
        mixers=mixers, peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def kv_specs(node):
    """The specs of the KV caches in a cache's spec tree, as strings."""
    if isinstance(node, tuple) and hasattr(node, "k"):
        return {str(node.k)}
    items = node.values() if isinstance(node, dict) else node
    return set().union(*(kv_specs(c) for c in items)) \
        if isinstance(node, (dict, list)) else set()


def routing_equal(arch, what, got, want, rows):
    """Each MoE routing (layer by layer, step by step) of this rank's
    tokens (``rows`` of the whole batch's) bit-equal to the one-process
    routing's rows."""
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{arch} {what}: {len(got)} MoE routings "
                             f"against {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("expert_ids", "keep", "slot"):
            if not torch.equal(g[key], w[key][rows]):
                raise AssertionError(f"{arch} {what} layer {i}: routing "
                                     f"{key} differs from the one-process "
                                     "step's")
        if not torch.equal(g["counts"], w["counts"]):
            raise AssertionError(f"{arch} {what} layer {i}: expert counts "
                                 "differ from the one-process step's")


@contextlib.contextmanager
def counting_flops(out):
    """Count the block's FLOPs (``torch.utils.flop_counter.
    FlopCounterMode``: its matmuls, in every thread the block's ops run
    in, the recomputed ones too; the dry-run's counter) into
    ``out["flops"]``.  (``torch.profiler``'s ``with_flops`` counted each
    op twice under another dispatch mode.)"""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        yield out
    out["flops"] = counter.get_total_flops()


@contextlib.contextmanager
def recording_routing(seen):
    """Append each ``moe_route`` result made inside the block to ``seen``,
    in token order (per token and choice: expert id, kept, slot) with the
    whole batch's expert counts, on the host."""
    from repro_torch.models import moe

    inner = moe.moe_route

    def record(logits, k, capacity, split=None):
        r = inner(logits, k, capacity, split)
        inv = r.order.argsort()
        seen.append(dict(expert_ids=r.expert_ids.cpu(),
                         keep=r.keep[inv].view(-1, k).cpu(),
                         slot=r.slot[inv].view(-1, k).cpu(),
                         counts=r.counts.cpu(),
                         edge_gap=edge_gap(logits.detach(), k)))
        return r

    moe.moe_route = record
    try:
        yield seen
    finally:
        moe.moe_route = inner


def one_process_turns(cfg, opt_cfg, specs, mesh, batch, dev, flops=False,
                      routes=None, save=None):
    """The one-process step of ``cfg`` from ``init_decoder(0, ...)`` on the
    whole ``batch``, run by each rank in turn on the shared card (the
    others wait at a barrier): this rank's slices by ``specs`` of the
    updated weights and of ``mu``, and the step's ms and metrics (with
    its matmul FLOPs where ``flops``; each MoE layer's routing of this
    rank's data slice of the tokens appended to ``routes``).  Where
    ``save`` is given, rank 0 writes the whole updated weights, ``mu``
    and its metrics there (:func:`saved_turns`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import local_slice
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train.optim import init_opt
    from repro_torch.train.step import make_train_step

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for r in range(world):
        if r == rank:
            p = init_decoder(0, cfg, dev)
            _, step = make_train_step(cfg, opt_cfg, device=dev)
            seen, counted = [], {}
            with recording_routing(seen), (counting_flops(counted) if flops
                                           else contextlib.nullcontext()):
                (p, opt, m), s = timed(lambda: step(p, init_opt(p), batch))
            keep = {n: local_slice(t.detach(), specs[n], mesh).clone()
                    for n, t in p.named_parameters()}
            keep_mu = {n: local_slice(t, specs[n], mesh).clone()
                       for n, t in opt.mu.items()}
            out = dict(ms=1e3 * s, **counted,
                       **{k: float(v) for k, v in m.items()})
            if save is not None and rank == 0:
                torch.save(dict(
                    params={n: t.detach().cpu()
                            for n, t in p.named_parameters()},
                    mu={n: t.cpu() for n, t in opt.mu.items()}, plain=out),
                    Path(save) / "turns.pt")
            if routes is not None:
                n, i = mesh.axis_size("data"), mesh.index("data")
                for layer in seen:
                    t = layer["expert_ids"].shape[0] // n
                    routes.append({k: v[i * t:(i + 1) * t]
                                   if k in ("expert_ids", "keep", "slot")
                                   else v for k, v in layer.items()})
            del p, opt, step
            lm_free()
        dist.barrier()
    return keep, keep_mu, out


def saved_turns(saved, specs, mesh, dev):
    """:func:`one_process_turns`' results from what its ``save`` wrote
    (the one-process step computed once, for another mesh): this rank's
    slices by ``specs`` of the updated weights and of ``mu``, and the
    step's ms, metrics and FLOPs."""
    import torch
    from repro_torch.distributed import local_slice

    got = torch.load(Path(saved) / "turns.pt", mmap=True,
                     weights_only=False)
    return ({n: local_slice(t, specs[n], mesh).to(dev, copy=True)
             for n, t in got["params"].items()},
            {n: local_slice(t, specs[n], mesh).to(dev, copy=True)
             for n, t in got["mu"].items()}, got["plain"])


def hold_against_plain(params, opt, m, keep, keep_mu, plain, opt_cfg,
                       grad_tol=TRAIN_GRAD_TOL, norm_tol=TRAIN_LOSS_TOL):
    """The sharded step's metrics, gradients (the first step's ``mu / (1 -
    b1)``) and updated weights against the one-process step's at the
    TRAIN_*_TOL bounds (``grad_tol`` for the gradients, ``norm_tol`` for
    grad_norm; raises where one is outside); returns the gaps."""
    import torch
    import torch.distributed as dist

    loss_gap = train_close("sharded against one-process loss", m["loss"],
                           plain["loss"], TRAIN_LOSS_TOL)
    ce_gap = train_close("sharded against one-process ce", m["ce"],
                         plain["ce"], TRAIN_LOSS_TOL)
    norm_gap = train_close("sharded against one-process grad_norm",
                           m["grad_norm"], plain["grad_norm"], norm_tol)
    # the first step's clipped gradient is mu / (1 - b1) on both sides;
    # each tensor's gap is taken against its whole tensor's max
    c1 = 1 - opt_cfg.b1
    scales = torch.stack([keep_mu[n].abs().max().double() / c1
                          for n in params])
    dist.all_reduce(scales, op=dist.ReduceOp.MAX)
    gaps = {}
    for n, scale in zip(params, scales.tolist()):
        gaps[n] = float((opt.mu[n].double() - keep_mu[n].double())
                        .abs().max()) / c1 / max(scale, 1e-30)
    grad_at = max(gaps, key=gaps.get)
    if not gaps[grad_at] <= grad_tol:
        raise AssertionError(f"sharded step: gradient of {grad_at} "
                             f"{gaps[grad_at]} of its max (tolerance "
                             f"{grad_tol})")
    lr, eps, worst, flips = m["lr"], opt_cfg.eps, 0.0, 0
    for n, t in params.items():
        gg = opt.mu[n].double() / c1
        gw = keep_mu[n].double() / c1
        du = (gg / (gg.abs() + eps) - gw / (gw.abs() + eps)).abs()
        diff = (t - keep[n]).abs().double()
        if bool((diff > lr * (TRAIN_UPDATE_TOL + du)).any()):
            raise AssertionError(f"sharded step: {n} differs from the "
                                 f"one-process step by {float(diff.max())}")
        worst = max(worst, float(diff.max()))
        flips += int((gg.sign() != gw.sign()).sum())
    return dict(loss_gap=loss_gap, ce_gap=ce_gap, grad_norm_gap=norm_gap,
                grad_gap=gaps[grad_at], grad_gap_at=grad_at,
                update_max_abs=worst, update_sign_flips=flips)


def op_counts(coll):
    """``{op: {"calls", "bytes"}}`` of ``compat.STATS.as_dict()``."""
    return {op: dict(calls=int(c["calls"]), bytes=int(c["bytes"]))
            for op, c in sorted(coll.items())}


def dist_dryrun(dev, tp, serve):
    """Phase 18: the dry-run (``launch.dryrun.lower_cell``) of rank 0 of
    gemma3-1b's train step (as :func:`dist_tp`) and serve step (as
    :func:`dist_serve`) on a fake world of 4 ranks on DIST_TP_MESH in
    this process, fake ``cuda`` tensors: its collective calls and bytes
    by op and its ``FlopCounterMode`` FLOPs equal to rank 0's over one
    real step of each (``tp``, ``serve``: rank 0's results), the train
    step's per-layer gathers (leaves and bytes) equal to rank 0's, its
    ``temp_bytes`` and peak beside the real ``max_memory_allocated`` and
    its most gathered bytes alive beside rank 0's."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    B, S = DIST_TRAIN_BATCH
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    cells = (
        ("train", cfg, ShapeSpec("train", S, B, "train"), tp["step_ops"],
         tp["flops"], tp["peak_gb"]),
        ("decode", serve_cfg(LM_ARCH, None),
         ShapeSpec("serve", DIST_SERVE_MAX_LEN[LM_ARCH], B, "decode"),
         serve["one_step"]["ops"], serve["one_step"]["flops"],
         serve["peak_gb"]))
    out = {}
    for kind, c, shape, ops, flops, peak in cells:
        rec = dryrun.lower_cell(LM_ARCH, shape.name, False, device=dev,
                                cfg=c, shape=shape, mesh_shape=DIST_TP_MESH,
                                cache_dtype=torch.float32)
        coll = rec["collectives"]
        # a serving step's one-time gather is in neither: rank 0's step
        # was not the first call of its serve step
        got = coll["ops"]
        if got != ops:
            raise AssertionError(f"dry-run {kind}: collectives {got} "
                                 f"against rank 0's {ops}")
        if rec["cost"]["flops"] != flops:
            raise AssertionError(f"dry-run {kind}: {rec['cost']['flops']} "
                                 f"FLOPs against rank 0's {flops}")
        gathered = coll["gathered"]
        if kind == "train" and (gathered["calls"], gathered["bytes"]) != (
                tp["gathered_calls"], tp["gathered_bytes"]):
            raise AssertionError(f"dry-run train: gathered {gathered} "
                                 f"against rank 0's {tp['gathered_calls']} "
                                 f"leaves, {tp['gathered_bytes']} bytes")
        mem = rec["memory"]
        out[kind] = dict(
            trace_s=rec["trace_s"], collectives_equal=True,
            calls=sum(v["calls"] for v in got.values()),
            bytes=sum(v["bytes"] for v in got.values()),
            recomputed_calls=sum(coll["recompute"]["counts"].values()),
            working_gather_calls=sum(
                coll["working_gather"]["counts"].values()),
            flops=rec["cost"]["flops"], flops_equal=True,
            argument_gb=mem["argument_bytes"] / 1e9,
            temp_gb=mem["temp_bytes"] / 1e9,
            peak_gb=mem["peak_bytes"] / 1e9, real_peak_gb=peak,
            peak_over_real=mem["peak_bytes"] / 1e9 / peak,
            gathered_calls=gathered["calls"],
            gathered_peak_gb=gathered["peak"] / 1e9,
            real_gathered_peak_gb=tp["gathered_peak_gb"]
            if kind == "train" else None,
            differs_from_reference=rec["differs_from_reference"])
    return out


def collective_report(coll):
    """``compat.STATS`` of a step: each collective, and the host ms of the
    data axes' and of the model axis's (``model:`` keys)."""
    model = {op: c for op, c in coll.items() if op.startswith("model:")}
    return dict(
        collectives={op: dict(calls=c["calls"], gb=c["bytes"] / 1e9,
                              ms=1e3 * c["seconds"])
                     for op, c in coll.items()},
        collective_ms=1e3 * sum(c["seconds"] for c in coll.values()),
        model_axis_ms=1e3 * sum(c["seconds"] for c in model.values()),
        model_axis_gb=sum(c["bytes"] for c in model.values()) / 1e9,
        model_axis_calls=sum(c["calls"] for c in model.values()),
        data_axis_ms=1e3 * sum(c["seconds"] for op, c in coll.items()
                               if op not in model))


def dist_two():
    """The two-rank job of phase 18: gemma3-1b at full width and depth in
    f32, one sharded step on DIST_TRAIN_MESH against the one-process step
    (each rank runs the latter in turn and keeps its own slices)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import reshard
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import compat, param_shardings
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.transformer import Decoder, init_decoder
    from repro_torch.train.optim import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          total_steps=TRAIN_STEPS)
    mesh = make_mesh_compat(DIST_TRAIN_MESH, ("data", "model"), device=dev)
    specs = param_shardings(Decoder(cfg, device="meta"), mesh)
    B, S = DIST_TRAIN_BATCH
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(
        vocab=cfg.vocab_size, batch=B, seq_len=S, seed=0).batch_at(0).items()}
    keep, keep_mu, plain = one_process_turns(cfg, opt_cfg, specs, mesh,
                                             batch, dev)
    torch.cuda.reset_peak_memory_stats()
    p = init_decoder(0, cfg, dev)
    params = reshard(p, specs, mesh)
    del p
    lm_free()
    opt = init_opt(params)
    _, mstep = make_train_step(cfg, opt_cfg, device=dev, mesh=mesh)
    before = peak_then_reset()
    torch.cuda.synchronize()
    dist.barrier()          # the ranks start the timed step together
    compat.reset_stats()
    (params, opt, m), s = timed(lambda: mstep(params, opt, batch))
    coll = compat.STATS.as_dict()
    memory = step_memory(before)
    m = {k: float(v) for k, v in m.items()}
    gaps = hold_against_plain(params, opt, m, keep, keep_mu, plain, opt_cfg)
    return dict(plain=plain, sharded=dict(
        mesh=list(DIST_TRAIN_MESH), batch=[B, S], ms=1e3 * s, **m, **gaps,
        **collective_report(coll), **memory,
        local_gb=sum(t.numel() * t.element_size()
                     for t in params.values()) / 1e9))


def step_memory(before_gb):
    """A sharded step's memory a rank, read after it: ``peak_gb``, the
    allocator's peak since the rank built its model (``before_gb``, the
    peak read and reset just before the step, and the step's own), the
    step's own peak, and ``compat.GATHERED``: the leaves the per-layer
    gather gathered and the most gathered bytes alive at once."""
    import torch
    from repro_torch.distributed import compat

    step = torch.cuda.max_memory_allocated() / 1e9
    gathered = compat.GATHERED.as_dict()
    return dict(peak_gb=max(before_gb, step), step_peak_gb=step,
                gathered_calls=gathered["calls"],
                gathered_bytes=gathered["bytes"],
                gathered_gb=gathered["bytes"] / 1e9,
                gathered_peak_gb=gathered["peak"] / 1e9,
                gathered_alive_after=gathered["alive"])


def peak_then_reset():
    """The allocator's peak so far (GB), its counter reset."""
    import torch

    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return peak


@contextlib.contextmanager
def keeping_grads(out):
    """Keep the gradients the train step hands AdamW inside the block in
    ``out`` (name -> tensor; the step leaves them as they are)."""
    from repro_torch.train import step as ST

    inner = ST.apply_updates

    def keep(params, grads, *args, **kwargs):
        out.update(grads)
        return inner(params, grads, *args, **kwargs)

    ST.apply_updates = keep
    try:
        yield out
    finally:
        ST.apply_updates = inner


def repeat_report(first, loss, grads):
    """Whether a sharded step's loss and every gradient shard equal, bit
    for bit, those of ``first`` (``(loss, grads)`` on the host: the same
    loss and gradients computed before from the same state), and
    the largest gap of a gradient that does not, against its tensor's
    max."""
    import torch

    loss0, grads0 = first
    unequal, worst, worst_at = 0, 0.0, None
    for n, g in grads.items():
        a, b = grads0[n], g.detach().cpu()
        if not torch.equal(a, b):
            unequal += 1
            gap = float((a.double() - b.double()).abs().max()) / max(
                float(b.abs().max()), 1e-30)
            if gap > worst:
                worst, worst_at = gap, n
    loss = loss.detach().cpu()
    return dict(loss_bit_equal=bool(torch.equal(loss0, loss)),
                loss_gap=abs(float(loss0) - float(loss)),
                grads_bit_equal=unequal == 0, grads_unequal=unequal,
                grads=len(grads), max_gap=worst, max_gap_at=worst_at)


def one_process_f32_f64(cfg, batch, dev):
    """The one-process gradients of ``cfg``'s loss on ``batch`` from
    ``init_decoder(0, ...)``, with the weights and activations cast to
    f64 and in f32, each leaf in f64 on the host: ``dict(f64=, f32=,
    sides=)``.  The f64 step runs first and records each mLSTM readout's
    side of its normaliser's kink (``sides``), and the f32 step takes
    those sides (``models.xlstm.NormaliserSides``)."""
    import dataclasses

    import torch
    from repro_torch.models import build
    from repro_torch.models.transformer import init_decoder
    from repro_torch.models.xlstm import NormaliserSides

    out = {}
    for key, dtype in (("f64", "float64"), ("f32", "float32")):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = init_decoder(0, cfg, dev).to(getattr(torch, dtype))
        p.cfg = c
        with NormaliserSides(out.get("sides")) as ns:
            _, grads = train_grads(build(c, device=dev), p, batch, c)
        out[key] = {n: g.double().cpu() for n, g in grads.items()}
        out.setdefault("sides", ns.seen)
        del p, grads
        lm_free()
    return out


def grad_gap(a, b):
    """``max |a - b| / max |b|``: a gradient's gap from its reference."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def sharded_against_f64(kept, specs, mesh, ref):
    """The sharded step's gradients (``kept``: this rank's shards, as the
    step hands them to AdamW) gathered whole, each leaf's gap from the
    one-process f64 gradient over that gradient's max, beside the
    one-process f32 gradient's own gap (``ref``: :func:`
    one_process_f32_f64`'s on rank 0, None on the others; the largest
    gaps broadcast from rank 0).  Every step here takes the f64 step's
    sides of the mLSTM normaliser's kink.  Raises on every rank where
    either gap exceeds TRAIN_XLSTM_GRAD_TOL (phase 18, xlstm)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import unshard

    whole = {n: unshard(g.contiguous(), specs[n], mesh)
             for n, g in kept.items()}
    gaps, at = torch.zeros(2, dtype=torch.float64), None
    if ref is not None:
        g32, g64 = ref["f32"], ref["f64"]
        one = {n: grad_gap(g32[n], g64[n]) for n in g64}
        split = {n: grad_gap(whole[n].double().cpu(), g64[n]) for n in g64}
        at = dict(one_process_f32=max(one, key=one.get),
                  sharded=max(split, key=split.get))
        gaps = torch.tensor([max(one.values()), max(split.values())],
                            dtype=torch.float64)
    dist.broadcast(gaps, src=0)
    one_gap, split_gap = gaps.tolist()
    for what, gap in (("sharded", split_gap), ("one-process f32", one_gap)):
        if not gap <= TRAIN_XLSTM_GRAD_TOL:
            raise AssertionError(f"{what} step: a gradient {gap} of its max "
                                 "from the one-process f64 gradient "
                                 f"(tolerance {TRAIN_XLSTM_GRAD_TOL})")
    return dict(one_process_f32_gap=one_gap, sharded_gap=split_gap,
                tol=TRAIN_XLSTM_GRAD_TOL, worst_leaf=at)


def dist_tp(dev, arch, n_layers=None, repeat=False, f64=False,
            mesh_shape=DIST_TP_MESH, save=None, reuse=None):
    """``arch`` at full width (f32; depth cut to ``n_layers`` where given)
    on ``mesh_shape``, its compute split over the model axis: the
    one-process step a rank at a time (its matmul FLOPs counted on rank
    0's turn), then one sharded step (each rank's matmul FLOPs counted),
    held against it at the TRAIN_*_TOL bounds; MoE routing of each
    rank's tokens bit-equal to the one-process step's; each rank's peak
    memory and the per-layer gather's counts (:func:`step_memory`); with
    ``repeat``, the loss and gradients computed twice more before the
    step from the same state, bare and under the step's two dispatch
    modes (the FLOP counter, the routing recorder), held bit for bit
    against each other and the second against the step's
    (:func:`repeat_report`; reported, not a failure); with ``f64``
    (xlstm), every step on the one-process f64 step's sides of the mLSTM
    normaliser's kink, the sharded step's and the one-process f32 step's
    gradients also held against the one-process gradients in f64
    (:func:`sharded_against_f64`), and the sharded step against the
    one-process f32 step at xlstm's train-step bound; digests of this rank's
    shards that other ranks also hold, for the parent's replica check
    (phase 18, 3d).  ``save``: a directory where rank 0 writes the
    one-process steps (the f32 step's weights, ``mu`` and metrics; with
    ``f64`` the f64 and f32 gradients and the sides); ``reuse``: one so
    written, whose steps this run takes in place of computing them."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import reshard
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import compat, param_shardings
    from repro_torch.distributed.sharding import compute_split
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.transformer import Decoder, init_decoder
    from repro_torch.models.xlstm import NormaliserSides
    from repro_torch.train.optim import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step, sharded_loss_and_grads

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          total_steps=TRAIN_STEPS)
    mesh = make_mesh_compat(mesh_shape, ("data", "model"), device=dev)
    specs = param_shardings(Decoder(cfg, device="meta"), mesh, cfg.n_experts)
    B, S = DIST_TRAIN_BATCH
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(
        vocab=cfg.vocab_size, batch=B, seq_len=S, seed=0).batch_at(0).items()}
    ref, sides = None, [None]
    if f64:
        if dist.get_rank() == 0:
            if reuse is None:
                ref = one_process_f32_f64(cfg, batch, dev)
            else:
                ref = torch.load(Path(reuse) / "f64.pt", mmap=True,
                                 weights_only=False)
            if save is not None:        # the f32 gradients in f32: exact
                torch.save(dict(ref, f32={n: g.float() for n, g in
                                          ref["f32"].items()}),
                           Path(save) / "f64.pt")
            sides = [ref["sides"]]
        dist.broadcast_object_list(sides, src=0)

    def pinned(on=None):    # every step on the f64 step's sides (xlstm)
        return NormaliserSides(sides[0], on) if f64 else \
            contextlib.nullcontext()

    want_routes = []
    if reuse is not None:
        keep, keep_mu, plain = saved_turns(reuse, specs, mesh, dev)
    else:
        with pinned():
            keep, keep_mu, plain = one_process_turns(
                cfg, opt_cfg, specs, mesh, batch, dev,
                flops=dist.get_rank() == 0, routes=want_routes, save=save)
    torch.cuda.reset_peak_memory_stats()
    p = init_decoder(0, cfg, dev)
    params = reshard(p, specs, mesh)
    del p
    lm_free()
    opt = init_opt(params)
    model, mstep = make_train_step(cfg, opt_cfg, device=dev, mesh=mesh)
    def on_host():
        loss, _, grads = sharded_loss_and_grads(model, params, batch, cfg)
        return loss.cpu(), {n: g.cpu() for n, g in grads.items()}

    bare = moded = None
    if repeat:
        bare = on_host()
        with recording_routing([]), counting_flops({}):
            moded = on_host()
    routes, counted, kept = [], {}, {}
    before = peak_then_reset()
    with recording_routing(routes), counting_flops(counted), \
            keeping_grads(kept), pinned(mesh):
        torch.cuda.synchronize()
        dist.barrier()      # the ranks start the timed step together
        compat.reset_stats()
        (params, opt, m), s = timed(lambda: mstep(params, opt, batch))
    coll = compat.STATS.as_dict()
    memory = step_memory(before)
    repeated = None if bare is None else dict(
        bare_vs_modes=repeat_report(bare, *moded),
        modes_vs_step=repeat_report(moded, m["loss"], kept))
    against_f64 = None if not f64 else sharded_against_f64(kept, specs,
                                                           mesh, ref)
    kept.clear()
    del ref
    m = {k: float(v) for k, v in m.items()}
    tols = {}
    if f64:     # xlstm: its train-step tests' bounds
        tols = dict(grad_tol=TRAIN_XLSTM_GRAD_TOL,
                    norm_tol=TRAIN_XLSTM_GRAD_TOL)
    gaps = hold_against_plain(params, opt, m, keep, keep_mu, plain, opt_cfg,
                              **tols)
    if len(routes) != len(want_routes):
        raise AssertionError(f"{arch}: {len(routes)} MoE routings against "
                             f"the one-process step's {len(want_routes)}")
    for i, (got, want) in enumerate(zip(routes, want_routes)):
        for key in ("expert_ids", "keep", "slot", "counts"):
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"{arch} layer {i}: routing {key} "
                                     "differs from the one-process step's")
    split = compute_split(specs, cfg, mesh)
    # the tensors some other rank holds the same slice of: a spec that
    # leaves a mesh axis out (the others' slices are this rank's alone)
    held = [n for n, spec in specs.items()
            if len({a for axes in spec if axes for a in (
                (axes,) if isinstance(axes, str) else axes)}) < len(
                mesh.shape)]
    return dict(
        arch=arch, layers=cfg.n_layers, mesh=list(mesh_shape),
        batch=[B, S], plain=plain, ms=1e3 * s, **m, **gaps,
        **collective_report(coll), flops=counted["flops"], **memory,
        repeat=repeated, against_f64=against_f64, step_ops=op_counts(coll),
        local_gb=sum(t.numel() * t.element_size()
                     for t in params.values()) / 1e9,
        split={k: sum(v == k for v in split.values())
               for k in ("split", "select", "gather", "replicated")},
        routing=dict(layers=len(routes), bit_equal=True,
                     edge_gap=[r["edge_gap"] for r in routes],
                     dropped=[int((~r["keep"]).sum()) for r in routes]),
        coords=mesh.coords, specs=dict(params.specs),
        **{key: {n: digest(t) for n, t in d.items() if n in held}
           for key, d in (("params", params), ("mu", opt.mu),
                          ("nu", opt.nu))})


DIST_JOBS = {"four": dist_four, "two": dist_two, "eight": dist_eight}


def replicas_equal(ranks):
    """Raise unless ranks that hold the same slice of a tensor hold the
    same bits (arrays, or their ``digest``); returns the count of
    parameter slices held by more than one rank."""
    seen, holders = {}, {}
    for r in ranks:
        for key in ("params", "mu", "nu"):
            for n, t in r[key].items():
                at = tuple(axes and tuple(r["coords"][a] for a in (
                    (axes,) if isinstance(axes, str) else axes))
                    for axes in r["specs"][n])
                b = t if isinstance(t, str) else t.tobytes()
                if seen.setdefault((key, n, at), b) != b:
                    raise AssertionError(f"replicas of {key} {n} at {at} "
                                         "differ")
                holders[(key, n, at)] = holders.get((key, n, at), 0) + 1
    return sum(c > 1 for (key, _, _), c in holders.items() if key == "params")


def tp_report(ranks):
    """Phase 18's report of a :func:`dist_tp` run from every rank's result:
    replicas bit-equal (by digest), each rank's matmul FLOPs as a share of
    the one-process step's and of a data rank's share of it (the whole
    model over 1 / data of the batch), ms, collectives, peak memory."""
    first = ranks[0]
    plain = first["plain"]
    data = first["mesh"][0]
    share = [r["flops"] / plain["flops"] for r in ranks]
    drop = ("params", "mu", "nu", "specs", "coords", "plain", "flops")
    return dict(
        {k: v for k, v in first.items() if k not in drop},
        plain=plain, replicated_slices=replicas_equal(ranks),
        replicas_bitwise_equal=True,
        flops_by_rank=[r["flops"] for r in ranks],
        flops_share_by_rank=share,
        flops_share_of_a_data_rank=[x * data for x in share],
        ms_by_rank=[r["ms"] for r in ranks],
        peak_gb_by_rank=[r["peak_gb"] for r in ranks],
        step_peak_gb_by_rank=[r["step_peak_gb"] for r in ranks],
        gathered_peak_gb_by_rank=[r["gathered_peak_gb"] for r in ranks],
        repeat_by_rank=[r["repeat"] for r in ranks],
        model_axis_ms_by_rank=[r["model_axis_ms"] for r in ranks],
        data_axis_ms_by_rank=[r["data_axis_ms"] for r in ranks])


def serve_report(ranks):
    """Phase 18's report of a :func:`dist_serve` run: rank 0's, with every
    rank's ms a step, host ms of the model axis's collectives and peak
    memory; the tokens and logits gaps must agree across ranks."""
    first = ranks[0]
    for r in ranks[1:]:
        if (r["decode_gaps"], r["tokens_equal"]) != (first["decode_gaps"],
                                                    first["tokens_equal"]):
            raise AssertionError(f"{first['arch']}: the ranks' serving "
                                 "results differ")
    return dict(first, ms_mean_by_rank=[r["ms_mean"] for r in ranks],
                prefill_ms_by_rank=[r["prefill_ms"] for r in ranks],
                cache_gap_by_rank=[r["cache_gap"] for r in ranks],
                model_axis_ms_by_rank=[r["model_axis_ms"] for r in ranks],
                sp_calls_by_rank=[r["sp_calls"] for r in ranks],
                peak_gb_by_rank=[r["peak_gb"] for r in ranks])


def mixer_report(rep):
    """The mixers in phase 18's report ``rep``: for each of
    DIST_TP_MIXER_ARCHS each rank's share of the one-process step's matmul
    FLOPs beside the prediction, ms, peak GB and the model axis's calls
    and bytes a step, the leaves' splits, the prefill's gap and ms; the
    decode's gaps, ms a step (the one-process step's beside), the
    collectives' host ms, the model axis's calls and MB a step and the
    mixers' beside the predicted (:func:`mixer_decode_calls`)."""
    out = {}
    for arch in DIST_TP_MIXER_ARCHS + (DIST_GROUP,):
        tp, pre = rep[f"tp {arch}"], rep[f"serve {arch}"]
        out[arch] = dict(
            mesh=tp["mesh"], flops_share_by_rank=tp["flops_share_by_rank"],
            predicted_share=DIST_TP_MIXER_SHARE[arch],
            ms_by_rank=tp["ms_by_rank"], plain_ms=tp["plain"]["ms"],
            peak_gb_by_rank=tp["peak_gb_by_rank"],
            model_axis_calls=tp["model_axis_calls"],
            model_axis_gb=tp["model_axis_gb"], split=tp["split"],
            loss_gap=tp["loss_gap"], grad_gap=tp["grad_gap"],
            against_f64=tp["against_f64"],
            prefill_gap=pre["prefill_gap"],
            prefill_ms_by_rank=pre["prefill_ms_by_rank"],
            plain_prefill_ms=pre["plain_prefill_ms"],
            decode=dict({k: pre[k] for k in (
                "fill", "steps", "decode_gap", "cache_gap", "tokens_checked",
                "tokens_equal", "tokens", "ms_mean", "plain_ms_mean",
                "collective_ms", "model_axis_ms", "model_axis_calls_a_step",
                "model_axis_mb_a_step", "mixers")},
                cache_gap_by_rank=pre["cache_gap_by_rank"],
                ms_mean_by_rank=pre["ms_mean_by_rank"]))
    return out


def nccl_world_of_one(dev, workdir):
    """A world of one on NCCL in this process: the collectives exact (no
    host staging), and the sharded step on a (1, 1) mesh equal to the
    plain step bit for bit over DIST_SMALL_STEPS steps (phase 18, 3c)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import reshard
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import compat, param_shardings
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train.optim import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    backend = compat.init_distributed(
        device=dev, init_method=f"file://{workdir / 'nccl.init'}",
        world_size=1, rank=0)
    try:
        mesh = make_mesh_compat((1, 1), ("data", "model"), device=dev)
        g = mesh.group(("data", "model"))
        x = torch.randn((64, 64), device=dev)
        staged = compat.host_staged(g, x, "all_gather")
        for name, y in (("psum", compat.psum(x, g)),
                        ("pmax", compat.pmax(x, g)),
                        ("all_gather", compat.all_gather(x, g)),
                        ("ppermute", compat.ppermute(x, g, [(0, 0)]))):
            if not torch.equal(y, x):
                raise AssertionError(f"NCCL world of one: {name} changed "
                                     "its input")
        cfg = reduced(get_config(LM_ARCH))
        opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
        B, S = DIST_SMALL_BATCH
        pipe = TokenPipeline(vocab=cfg.vocab_size, batch=B, seq_len=S, seed=0)
        out = {}
        for name, m in (("plain", None), ("mesh", mesh)):
            p = init_decoder(0, cfg, dev)
            if m is not None:
                p = reshard(p, param_shardings(p, mesh), mesh)
            opt = init_opt(p)
            _, step = make_train_step(cfg, opt_cfg, device=dev, mesh=m)
            losses = []
            for i in range(DIST_SMALL_STEPS):
                p, opt, met = step(p, opt, pipe.batch_at(i))
                losses.append(float(met["loss"]))
            named = dict(p.named_parameters()) if m is None else p
            out[name] = (losses, {n: digest(t) for n, t in named.items()},
                         {n: digest(t) for n, t in opt.mu.items()},
                         {n: digest(t) for n, t in opt.nu.items()})
        if out["mesh"] != out["plain"]:
            raise AssertionError("NCCL world of one: the sharded step is not "
                                 "the plain step bit for bit")
        return dict(backend=backend, host_staged=staged,
                    steps=DIST_SMALL_STEPS, losses=out["plain"][0],
                    bitwise_equal=True, tensors=len(out["plain"][1]))
    finally:
        dist.destroy_process_group()


def distributed(dev):
    """Phase 18 (module docstring): four ranks on one card."""
    import shutil

    import torch
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.transformer import init_decoder

    lm_free()
    reset_launches()
    work = ROOT / "build" / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    save_checkpoint(work / "ckpt", 0,
                    init_decoder(1, reduced(get_config(LM_ARCH)), "cpu"))
    rep = {}
    t = time.perf_counter()
    serve_oracle(torch.device(dev), LM_ARCH, None, work)
    serve_oracle(torch.device(dev), MOE_ARCH, DIST_TP_MOE_LAYERS, work)
    for arch in DIST_TP_MIXER_ARCHS:
        serve_oracle(torch.device(dev), arch, DIST_TP_MIXER_LAYERS, work)
    rep["serve_oracles_s"] = time.perf_counter() - t
    t = time.perf_counter()
    saved_steps(work / "ckpt").mkdir()
    four, four_launches = run_dist("four", DIST_WORLD, work,
                                   str(work / "ckpt"))
    rep["four_ranks_s"] = time.perf_counter() - t
    t = time.perf_counter()
    eight, eight_launches = run_dist("eight", DIST_GROUP_WORLD, work,
                                     str(work / "ckpt"))
    rep["eight_ranks_s"] = time.perf_counter() - t
    shutil.rmtree(saved_steps(work / "ckpt"))
    rep[f"tp {DIST_GROUP}"] = tp_report([r["tp"] for r in eight])
    rep[f"serve {DIST_GROUP}"] = serve_report([r["serve"] for r in eight])
    for key in ("sp", "pp"):
        if len({r[key]["digest"] for r in four}) != 1:
            raise AssertionError(f"{key}: the ranks' results differ")
        rep[key] = dict(four[0][key], per_rank_ms=[r[key]["ms"]
                                                   for r in four])
    steps = [r["steps"] for r in four]
    rep["steps"] = dict({k: steps[0][k] for k in ("mesh", "steps", "batch",
                                                  "losses")},
                        replicated_slices=replicas_equal(steps),
                        replicas_bitwise_equal=True)
    rep["reshard"] = four[0]["reshard"]
    for key in ("tp", "tp_moe"):
        rep[key] = tp_report([r[key] for r in four])
    for key in ("serve", "serve_moe"):
        rep[key] = serve_report([r[key] for r in four])
    for arch in DIST_TP_MIXER_ARCHS:
        rep[f"tp {arch}"] = tp_report([r[f"tp {arch}"] for r in four])
        rep[f"serve {arch}"] = serve_report([r[f"serve {arch}"]
                                             for r in four])
    rep["mixers"] = mixer_report(rep)
    print("  mixers' decode, weights whole (for comparison): " + json.dumps({
        arch: {k: d["decode"]["mixers"][k] for k in (
            "whole_weights_calls", "whole_weights_mb", "whole_mixers_gb")}
        for arch, d in rep["mixers"].items()}))
    print("  mixers: " + json.dumps(rep["mixers"]))
    t = time.perf_counter()
    rep["dryrun"] = dict(dist_dryrun(dev, four[0]["tp"], four[0]["serve"]),
                         seconds=time.perf_counter() - t)
    print("  dryrun: " + json.dumps(rep["dryrun"]))
    t = time.perf_counter()
    two, two_launches = run_dist("two", 2, work)
    rep["two_ranks_s"] = time.perf_counter() - t
    rep["train"] = dict(plain=two[0]["plain"], sharded=two[0]["sharded"],
                        **{f"{k}_by_rank": [r["sharded"][k] for r in two]
                           for k in ("ms", "peak_gb", "step_peak_gb",
                                     "gathered_peak_gb", "collective_ms")})
    # the per-layer gather's steps: each rank's memory and time
    rep["per_layer"] = {
        name: {k: r[f"{k}_by_rank"] for k in (
            "ms", "peak_gb", "step_peak_gb", "gathered_peak_gb")}
        for name, r in ((f"{LM_ARCH} 2x1", rep["train"]),
                        (f"{LM_ARCH} 2x2", rep["tp"]),
                        (f"{MOE_ARCH} 2x2", rep["tp_moe"]))}
    for name, r in ((f"{LM_ARCH} 2x1", two[0]["sharded"]),
                    (f"{LM_ARCH} 2x2", rep["tp"]),
                    (f"{MOE_ARCH} 2x2", rep["tp_moe"])):
        rep["per_layer"][name].update(gathered_calls=r["gathered_calls"],
                                      gathered_gb=r["gathered_gb"])
    rep["per_layer"][f"{MOE_ARCH} 2x2"]["repeat"] = rep["tp_moe"][
        "repeat_by_rank"]
    # gemma3-1b's full-width step on (2, 1) beside (2, 2)
    one, tp = two[0]["sharded"], rep["tp"]
    rep["tp_beside_2x1"] = {
        "2x1": dict(ms=one["ms"], collective_ms=one["collective_ms"],
                    peak_gb=max(rep["train"]["peak_gb_by_rank"]),
                    local_gb=one["local_gb"]),
        "2x2": dict(ms=tp["ms"], collective_ms=tp["collective_ms"],
                    data_axis_ms=tp["data_axis_ms"],
                    model_axis_ms=tp["model_axis_ms"],
                    model_axis_gb=tp["model_axis_gb"],
                    peak_gb=max(tp["peak_gb_by_rank"]),
                    local_gb=tp["local_gb"],
                    flops_share=tp["flops_share_by_rank"],
                    flops_share_of_a_data_rank=tp[
                        "flops_share_of_a_data_rank"])}
    t = time.perf_counter()
    rep["nccl_world_of_one"] = dict(nccl_world_of_one(torch.device(dev),
                                                      work),
                                    seconds=time.perf_counter() - t)
    shutil.rmtree(work, ignore_errors=True)
    # this process's launches and every spawned rank's
    launches = launch_counts()
    for counts in (four_launches, eight_launches, two_launches):
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
    return rep, launches


def examples_on_card(workdir):
    """Phase 19 (module docstring): every run of EXAMPLE_RUNS started at
    once, each ``examples/torch_*.py`` in a process of its own with
    ``--device cuda``; raises if one exits non-zero, runs past
    EXAMPLE_TIMEOUT_S or lacks an expected line, or if the runs together
    launched none of EXAMPLE_KERNELS.  Returns ``(report, launches)``:
    each run's seconds, launches and the lines it printed that hold its
    results, and the kernels' launches summed over the runs."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC) + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    procs, started, ended = {}, {}, {}
    try:
        for name, script, args, _ in EXAMPLE_RUNS:
            out = open(workdir / f"{name}.out", "w")
            err = open(workdir / f"{name}.err", "w")
            with out, err:
                started[name] = time.perf_counter()
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", EXAMPLE_RUNNER,
                     str(ROOT / "examples" / script), *args, "--device",
                     "cuda"], stdout=out, stderr=err, env=env, cwd=str(ROOT))
        t0 = time.perf_counter()
        while len(ended) < len(procs):
            if time.perf_counter() - t0 > EXAMPLE_TIMEOUT_S:
                raise AssertionError(
                    f"examples still running after {EXAMPLE_TIMEOUT_S} s: "
                    f"{sorted(set(procs) - set(ended))}")
            for name, proc in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter()
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    report, total = {}, dict.fromkeys(EXAMPLE_KERNELS, 0)
    for name, script, args, want in EXAMPLE_RUNS:
        out = (workdir / f"{name}.out").read_text()
        lines = out.splitlines()
        if procs[name].returncode != 0 or not lines or not lines[-1] \
                .startswith("LAUNCHES "):
            raise AssertionError(
                f"{script} {' '.join(args)} exited "
                f"{procs[name].returncode}:\n{out[-3000:]}\n"
                f"{(workdir / f'{name}.err').read_text()[-3000:]}")
        missing = [w for w in want if w not in out]
        if missing:
            raise AssertionError(f"{script}: no line with {missing}")
        launches = json.loads(lines[-1][len("LAUNCHES "):])
        for k in total:
            total[k] += launches.get(k, 0)
        report[name] = dict(
            argv=[script, *args], seconds=ended[name] - started[name],
            launches=launches,
            lines=[ln.strip() for ln in lines[:-1] if any(w in ln for w in (
                "bits/id", "identical", "container", "bits/edge", "recall",
                "QPS", "shards", "partial", "this server", "[train] done",
                "embeddings"))])
    if min(total.values()) <= 0:
        raise AssertionError(f"the examples launched no "
                             f"{[k for k, c in total.items() if c <= 0]}")
    return report, total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database vectors of the main path (sift-like) "
                    "and, up to GRAPH_N, of the graph paths (deep-like)")
    ap.add_argument("--queries", type=int, default=1000)
    args = ap.parse_args(argv)
    started = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase = Phases()

    with phase("environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        # the SM clock the lookup time of pq_adc is counted at
        sm_hz = 1e6 * float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0])
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        print(f"card: {smi}, max SM clock {sm_hz / 1e6:.0f} MHz")

    from repro_torch.kernels import (_build, launch_counts, launch_shapes,
                                     reset_launches)

    with phase("build"):
        libs = _build.build_all()
        for name in _build.KERNELS:
            log = _build.build_log(name) or "(prebuilt)"
            info = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"{name}: " + " | ".join(info))
            mma = sass_tensor_core_count(libs[name])
            print(f"{name}: tensor-core instructions in SASS "
                  f"{json.dumps(mma)}")
            if name in ("l2_dist", "l2_top1") and not sum(mma.values()):
                raise AssertionError(f"{name}: no tensor-core MMA in its "
                                     "SASS")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = []
    with phase("kernels vs plain"):
        results.append(check_l2_dist(dev, gen))
        results.append(check_pq_adc(dev, gen, sm_hz))
        pq256 = check_pq_adc(dev, gen, sm_hz, m=256)
        seg = check_seg_topk(dev, gen, [(n, k) for n in SEG_NS
                                        for k in SEG_KS + (n,)])
        for nq, k, d in TOP1_SHAPES:
            results.append(check_l2_top1(dev, gen, nq, k, d))
        for lanes, rows in RANS_SHAPES:
            results.append(check_rans_decode(dev, lanes, rows, sm_hz))
        rans_wide = check_rans_decode(dev, *RANS_WIDE, sm_hz)
        wt_large = dict(check_wt_rank(*wt_rank_large_args(dev, gen),
                                      "random, p = 0.5"),
                        name="wt_rank(2^24 bits)")
        for r in results + list(seg.values()) + [pq256, rans_wide,
                                                 wt_large]:
            print("  " + json.dumps(r))

    import numpy as np
    from repro_torch.data import make_dataset

    with phase(f"data sift-like n={args.n}"):
        base, queries = make_dataset("sift-like", args.n, args.queries, seed=0)
        gt = exact_topk(torch.from_numpy(base).to(dev),
                        torch.from_numpy(queries).to(dev), TOPK)
        new, _ = make_dataset("sift-like", INGEST_ADDS * INGEST_ROWS, 0,
                              seed=1)
        adds = np.split(new, INGEST_ADDS)
        shard_add, _ = make_dataset("sift-like", SHARD_ADD_ROWS, 0, seed=2)

    from repro_torch.ann.kmeans import kmeans

    with phase("determinism: k-means twice on the card"):
        runs = []
        for _ in range(2):
            t = time.perf_counter()
            runs.append(kmeans(base, NLIST, iters=8, seed=1, device=dev))
            print(f"  kmeans({args.n}, {NLIST}, iters=8): "
                  f"{time.perf_counter() - t:.3f} s")
        a, b = (torch.from_numpy(c).view(torch.int32) for c in runs)
        if not torch.equal(a, b):
            raise AssertionError(
                f"k-means centroids differ between two runs on the card in "
                f"{int((a != b).any(1).sum())} of {NLIST} rows")
        print("  centroids bitwise equal")

    main_path, shapes = {}, []
    cluster_of = ivf_idx = None
    for spec in SPECS:
        n_spec = min(args.n, PQ_MAIN_N) if "PQ" in spec else args.n
        with phase(f"main path {spec} n={n_spec}"):
            spec_gt = gt if n_spec == args.n else exact_topk(
                torch.from_numpy(base[:n_spec]).to(dev),
                torch.from_numpy(queries).to(dev), TOPK)
            report, counts, spec_shapes, assignment, idx = serve(
                spec, base[:n_spec], queries, spec_gt,
                [a[:PQ_ADD_ROWS] for a in adds[:PQ_INGEST_ADDS]]
                if "PQ" in spec else adds, dev)
            print("  " + json.dumps(report))
            for k, v in counts.items():
                main_path[k] = main_path.get(k, 0) + v
            shapes.append(spec_shapes)
            cluster_of = assignment if cluster_of is None else cluster_of
            ivf_idx = idx if ivf_idx is None else ivf_idx
            del idx

    # the Flat path and the container path, each counted on its own: every
    # count set to 0 before the path and read after it
    with phase("flat path Flat"):
        flat_report, flat_counts, flat_shapes, flat_idx = serve_flat(
            base, queries, gt, dev)
        print("  " + json.dumps(flat_report))
        print("  Flat launches: " + json.dumps(flat_counts)
              + ", seg_topk by (n, k): " + json.dumps(
                  flat_report["shapes"]["seg_topk"])
              + ", l2_dist rows: " + json.dumps(
                  flat_report["shapes"]["l2_dist"]))
    with phase("container path: save_index, load_index onto the card"):
        from repro_torch.api import index_factory

        cont_idx = index_factory(SPECS[0], device=dev).build(
            base[:CONTAINER_N], seed=1)
        for x in adds:
            cont_idx.add(x)
        cont_ivf, cont_ivf_counts, cont_ivf_shapes = container_path(
            f"{SPECS[0]} n={min(args.n, CONTAINER_N)} after {INGEST_ADDS} "
            "adds", cont_idx, dict(nprobe=NPROBE), queries, dev)
        del cont_idx
        print("  " + json.dumps(cont_ivf))
        cont_flat, cont_flat_counts, cont_flat_shapes = container_path(
            "Flat", flat_idx, {}, queries, dev)
        print("  " + json.dumps(cont_flat))
    # sharded serving over the indexes built above, each path counted on
    # its own (counts set to 0 before it, read after)
    with phase(f"sharded path {SPECS[0]} at 1, 2 and 4 shards, routed add"):
        sh_ivf, sh_ivf_counts, sh_ivf_shapes = shard_ivf_path(
            ivf_idx, queries, shard_add, dev)
        print("  " + json.dumps(sh_ivf))
        mono_qps = sh_ivf["monolith_warm"]["qps"]
        for r in sh_ivf["plans"]:
            w = r["warm"]
            print(f"  {r['nshards']} shards by {r['by']}: warm QPS "
                  f"{w['qps']:.2f} (monolith {mono_qps:.2f}, "
                  f"{r['warm_qps_over_monolith']:.3f}x), p50/p99 "
                  f"{w['p50_latency_ms']:.2f}/{w['p99_latency_ms']:.2f} ms, "
                  f"merge share {w['merge_share']:.4f}; cold QPS "
                  f"{r['cold']['qps']:.2f}")
    with phase(f"sharded path {SPECS[1]} n={min(args.n, SHARD_PQ_N)} "
               "on 2 shards"):
        sh_pq, sh_pq_counts, sh_pq_shapes = shard_pq_path(base, queries, dev)
        print("  " + json.dumps(sh_pq))
    with phase("sharded path Flat on 4 shards, plan saved and loaded"):
        sh_flat, sh_flat_counts, sh_flat_shapes = shard_flat_path(
            flat_idx, queries, dev)
        print("  " + json.dumps(sh_flat))
    with phase(f"sharded container path {SPECS[0]} "
               f"n={min(args.n, SHARD_CONTAINER_N)}: plan saved and loaded"):
        sh_cont, sh_cont_counts, sh_cont_shapes, degraded_plan = \
            shard_container_path(base, queries, dev)
        print("  " + json.dumps(sh_cont))
    sift_queries = queries

    # the block Flat's first query block hands seg_topk (its own distances,
    # lens = n on every row), for timing seg_topk at Flat's width; made
    # after every path's counts were read
    from repro_torch.kernels import l2_dist

    flat_q = torch.from_numpy(queries[:64]).to(dev)
    flat_block = (l2_dist(flat_q, flat_idx.base_dev),
                  torch.full((64,), flat_idx.n, dtype=torch.int32,
                             device=dev))
    del ivf_idx, flat_idx, flat_q
    paths = dict(main=main_path, flat=flat_counts,
                 container_ivf=cont_ivf_counts,
                 container_flat=cont_flat_counts,
                 shard_ivf=sh_ivf_counts, shard_pq=sh_pq_counts,
                 shard_flat=sh_flat_counts, shard_container=sh_cont_counts)

    # the graph paths, each counted on its own; their launches by tile
    l2_tiles, seg_tiles = {}, {}

    def graph_path(name, counts, gshapes):
        paths[name] = counts
        for tiles, key in ((l2_tiles, "l2_dist_tiles"),
                           (seg_tiles, "seg_topk_tiles")):
            for t, c in gshapes[key].items():
                tiles[t] = tiles.get(t, 0) + c

    del base, queries, gt, adds
    graph_n = min(args.n, GRAPH_N)
    with phase(f"data {GRAPH_PRESET} n={graph_n}"):
        base, queries = make_dataset(GRAPH_PRESET, graph_n, args.queries,
                                     seed=0)
        base_dev = torch.from_numpy(base).to(dev)
        queries_dev = torch.from_numpy(queries).to(dev)
        gt = exact_topk(base_dev, queries_dev, TOPK)
        new, _ = make_dataset(GRAPH_PRESET, INGEST_ADDS * GRAPH_ADD_ROWS,
                              0, seed=1)
        adds = np.split(new, INGEST_ADDS)
    with phase(f"graph path {GRAPH_SPECS[0]}"):
        nsg, counts, gshapes, nsg_idx, nsg_head = serve_graph(
            GRAPH_SPECS[0], base, queries, gt, adds, dev)
        print("  " + json.dumps(nsg))
        graph_path("graph_nsg", counts, gshapes)
    with phase("graph step tiles: device path against the host re-score"):
        step_tiles = time_step_tiles(nsg_idx, queries)
        print("  " + json.dumps(step_tiles))
    del nsg_idx
    from repro_torch.ann.graph_scan import KERNEL_MIN_CUDA

    nav_n = min(graph_n, GRAPH_NAV_N)
    with phase(f"graph path {GRAPH_SPECS[0]} n={nav_n}, navigable"):
        nav_gt = exact_topk(base_dev[:nav_n], queries_dev, TOPK)
        nav, counts, gshapes, nav_idx, _ = serve_graph(
            GRAPH_SPECS[0], base[:nav_n], queries, nav_gt, [], dev,
            floor=GRAPH_NAV_FLOOR)
        print("  " + json.dumps(nav))
        graph_path("graph_nsg_nav", counts, gshapes)
        gate_rows, gates = gate_passes(GRAPH_SPECS[0], nav_idx, queries,
                                       GRAPH_GATES, dev, GRAPH_GATE_ROUNDS)
        for r in gate_rows:
            print("  " + json.dumps(dict(r, tiles={
                f"{nq}x{n}": c for (nq, n), c in r["tiles"].items()})))
        # every step's tile, from a pass at the smallest gate
        step_tiles_all = gate_rows[0]["tiles"]
        print("  kernel_min by gate: " + json.dumps(
            {"kernel_min_cuda": KERNEL_MIN_CUDA, "step_tiles": {
                f"{nq}x{n}": c for (nq, n), c in step_tiles_all.items()},
             **{str(g): v for g, v in gates.items()}}))
    with phase(f"sharded path {GRAPH_SPECS[0]} n={nav_n} on {SHARD_GRAPH} "
               f"shards, exhaustive at n={SHARD_EXHAUSTIVE_N}"):
        sh_graph, counts, gshapes = shard_graph_path(nav_idx, queries, nav_gt,
                                                     dev)
        print("  " + json.dumps(sh_graph))
        graph_path("shard_nsg", counts, gshapes)
    del nav_idx
    with phase("graph decisions: the card against the CPU"):
        decisions = graph_decisions(base, nsg_head, dev)
        print("  " + json.dumps(decisions))
    del nsg_head
    with phase(f"graph path {GRAPH_SPECS[1]}"):
        hnsw, counts, gshapes, _, _ = serve_graph(
            GRAPH_SPECS[1], base, queries, gt, [], dev)
        print("  " + json.dumps(hnsw))
        graph_path("graph_hnsw", counts, gshapes)
    with phase("graph container path: save_index, load_index onto the card"):
        gcont, counts, gshapes = graph_container_path(
            base, queries, adds[0][:GRAPH_CONTAINER_ADD], dev)
        print("  " + json.dumps(gcont))
        graph_path("graph_container", counts, gshapes)
    with phase("sharded degraded mode: a dead shard, a flaky shard "
               "(not counted)"):
        degraded = degraded_passes(degraded_plan, sift_queries, dev)
        print("  " + json.dumps(degraded))
    del degraded_plan, sift_queries, shard_add
    with phase("graph-path shapes"):
        # the tiles of the ingest's blocks reach past n: score them against
        # the base followed by the added rows
        grown_base = torch.cat([base_dev, torch.from_numpy(new).to(dev)])
        del base_dev
        l2_ms, seg_ms, wide = time_graph_tiles(
            l2_tiles, seg_tiles, grown_base, queries_dev)
        print("  widest graph tiles: " + json.dumps(wide))
        # the graph step's most frequent tile (over every step of the
        # navigable graph's passes), with its bound and addmm
        top_tile = max(step_tiles_all, key=step_tiles_all.get)
        l2_step = check_l2_dist(dev, gen, n=top_tile[1], qb=top_tile[0],
                                d=base.shape[1])
        print("  " + json.dumps(l2_step))
        print("  l2_dist graph tiles (launches, ms): " + json.dumps(
            {f"{nq}x{n}": [c, l2_ms[(nq, n)]]
             for (nq, n), c in sorted(l2_tiles.items())}))
        print("  seg_topk graph tiles (launches, ms): " + json.dumps(
            {f"{r}x{n},k={k}": [c, seg_ms[(r, n, k)]]
             for (r, n, k), c in sorted(seg_tiles.items())}))
    del grown_base
    graph_ms = dict(
        l2_dist=sum(c * l2_ms[t] for t, c in l2_tiles.items()),
        seg_topk=sum(c * seg_ms[t] for t, c in seg_tiles.items()))

    # the main path's own shapes: seg_topk at every (n, k) and l2_top1 at
    # every (K, d, rows) it launched, pq_adc and l2_dist at its mean arena
    # rows
    seg_launches, top1 = {}, {}
    shard_shapes = [sh_ivf_shapes, sh_pq_shapes, sh_flat_shapes,
                    sh_cont_shapes]
    for sh in shapes + [flat_shapes, cont_ivf_shapes,
                        cont_flat_shapes] + shard_shapes:
        for key, c in sh["seg_topk"].items():
            seg_launches[key] = seg_launches.get(key, 0) + c
        for key, c in sh["l2_top1"].items():
            top1[key] = top1.get(key, 0) + c
    mean_rows = {name: round(sum(sh[name] for sh in shapes) / main_path[name])
                 for name in ("pq_adc", "l2_dist")}
    # l2_dist launches at Flat's padded rows (2^20 at 1M) and at the IVF
    # arenas (the main path's mean)
    flat_n = flat_shapes["l2_dist"] // flat_counts["l2_dist"]
    l2_at = dict(arena=main_path["l2_dist"] + cont_ivf_counts["l2_dist"],
                 flat=flat_counts["l2_dist"] + cont_flat_counts["l2_dist"])
    # the sharded paths: l2_dist at the IVF paths' mean arena rows (as the
    # main path) and at each padded width the Flat path launched (its
    # shards' and its monolith's), pq_adc at the PQ path's mean arena rows
    shard_arena = [(sh_ivf_counts, sh_ivf_shapes), (sh_pq_counts, sh_pq_shapes),
                   (sh_cont_counts, sh_cont_shapes)]
    arena_launches = sum(c["l2_dist"] for c, _ in shard_arena)
    shard_l2 = dict(
        arena=arena_launches,
        arena_mean_rows=round(sum(sh["l2_dist"] for _, sh in shard_arena)
                              / max(1, arena_launches)))
    flat_widths = {}
    for (_, n), c in sh_flat_shapes["l2_dist_tiles"].items():
        flat_widths[n] = flat_widths.get(n, 0) + c
    shard_pq = dict(launches=sh_pq_counts["pq_adc"],
                    mean_rows=round(sh_pq_shapes["pq_adc"]
                                    / sh_pq_counts["pq_adc"]))
    with phase("main-path shapes"):
        more = check_seg_topk(dev, gen, [s for s in seg_launches
                                         if s not in seg], flat=flat_block)
        del flat_block
        seg.update(more)
        pq_mean = check_pq_adc(dev, gen, sm_hz, n=mean_rows["pq_adc"])
        l2_mean = check_l2_dist(dev, gen, n=mean_rows["l2_dist"])
        pq_shard = check_pq_adc(dev, gen, sm_hz, n=shard_pq["mean_rows"])
        l2_shard = check_l2_dist(dev, gen, n=shard_l2["arena_mean_rows"])
        # phase 3 timed l2_dist at 2^20 rows, the monolith's width
        l2_full = next(r for r in results if r["name"] == "l2_dist")
        l2_flat_width = {n: l2_full if n == 1 << 20
                         else check_l2_dist(dev, gen, n=n)
                         for n in sorted(flat_widths)}
        top1_at = {}
        for k, d, rows in sorted(top1):
            r = check_l2_top1(dev, gen, rows, k, d)
            top1_at[(k, d, rows)] = dict(r, name=f"l2_top1(K={k},d={d},"
                                               f"rows={rows})")
        for r in (*more.values(), pq_mean, l2_mean, pq_shard, l2_shard,
                  *l2_flat_width.values(), *top1_at.values()):
            print("  " + json.dumps(r))
        print("  seg_topk launches by (n, k): " + json.dumps(
            {f"n={n},k={k}": c for (n, k), c in sorted(seg_launches.items())}))

    with phase("kernel API path: wt_rank, rans_decode"):
        level0 = wavelet_level0(cluster_of)
        wt_args = wt_rank_args(dev, gen, level0)
        streams = [rans_stream(lanes, rows, seed=lanes)
                   for lanes, rows in RANS_SHAPES]
        from repro_torch.kernels.rans_decode import rans_decode
        from repro_torch.kernels.wt_rank import wt_rank

        reset_launches()
        ranks = wt_rank(*wt_args)
        decoded = [rans_decode(*rans_args(dev, h, w, tabs), rows=len(data),
                               r=r) for data, h, w, tabs, r in streams]
        api_path = launch_counts()
        api_routes = launch_shapes()["wt_rank"]
        if not np.array_equal(ranks.cpu().numpy(),
                              level0.rank1_batch(wt_args[2].cpu().numpy())):
            raise AssertionError("wt_rank differs from BitVector.rank1_batch")
        for out, (data, *_rest) in zip(decoded, streams):
            if not np.array_equal(out.cpu().numpy(), data):
                raise AssertionError("rans_decode differs from the encoded "
                                     "symbols")
        results.append(check_wt_rank(
            wt_args, level0, f"level 0 of the IVF{NLIST} wavelet tree"))
        print("  " + json.dumps(results[-1]))
        print(f"  launches: {json.dumps(api_path)}, wt_rank by route: "
              f"{json.dumps(api_routes)}")

    with phase(f"LM serving: {LM_ARCH} at full width with the retrieval "
               "side-car"):
        lm, lm_counts, lm_shapes, lm_serve_shapes = lm_serving(dev)
        for key, r in lm.items():
            print(f"  {key}: " + json.dumps(r))
        missing = [k for k in ("l2_top1", "l2_dist", "seg_topk")
                   if lm_counts[k] <= 0]
        if missing:
            raise AssertionError(f"the LM path launched no {missing}")
        lm_ms, lm_recs = lm_kernel_shapes(dev, gen, lm_shapes,
                                          lm_serve_shapes)
        for r in lm_recs:
            print("  " + json.dumps(r))
        print(f"  LM launches: {json.dumps(lm_counts)}")
    paths["lm_serving"] = lm_counts
    # the other decoder-only families, each path counted on its own
    with phase(f"LM serving: {MOE_ARCH} at full width and depth with the "
               f"side-car, {SCOUT_ARCH} at full width on {SCOUT_LAYERS} "
               "layers"):
        moe, paths["lm_moe"], moe_ms, moe_recs = moe_serving(dev, gen)
        for key, r in moe.items():
            print(f"  {key}: " + json.dumps(r))
        for r in moe_recs:
            print("  " + json.dumps(r))
        print(f"  MoE launches: {json.dumps(paths['lm_moe'])}")
        for key, v in moe_ms.items():
            lm_ms[key] += v
    with phase(f"LM serving: {HYBRID_ARCH} at full width and depth"):
        hybrid, paths["lm_hybrid"] = hybrid_serving(dev)
        for key, r in hybrid.items():
            print(f"  {key}: " + json.dumps(r))
    with phase(f"LM serving: {XLSTM_ARCH} at full width and depth"):
        xl, paths["lm_xlstm"] = xlstm_serving(dev)
        for key, r in xl.items():
            print(f"  {key}: " + json.dumps(r))
    with phase(f"LM serving: {ENCDEC_ARCH} at full width and depth with the "
               "side-car"):
        ed, paths["lm_encdec"], ed_ms, ed_recs = encdec_serving(dev, gen)
        for key, r in ed.items():
            print(f"  {key}: " + json.dumps(r))
        for r in ed_recs:
            print("  " + json.dumps(r))
        print(f"  encoder-decoder launches: {json.dumps(paths['lm_encdec'])}")
        for key, v in ed_ms.items():
            lm_ms[key] += v
    with phase(f"LM training: {LM_ARCH} at full width and depth"):
        tr, paths["lm_training"] = lm_training(dev)
        for key, r in tr.items():
            print(f"  {key} ({smi}): " + json.dumps(r))
        print(f"  training launches: {json.dumps(paths['lm_training'])}")
    with phase("distributed: four ranks on one card"):
        dr, paths["distributed"] = distributed(dev)
        for key, r in dr.items():
            print(f"  {key} ({smi}): " + json.dumps(r))
        print(f"  distributed launches: {json.dumps(paths['distributed'])}")

    with phase("examples on the card"), \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ex, ex_counts = examples_on_card(Path(tmp))
        for key, r in ex.items():
            print(f"  {key} ({smi}): " + json.dumps(r))
        print(f"  examples launches: {json.dumps(ex_counts)}")
    paths["examples"] = dict.fromkeys(main_path, 0) | ex_counts

    on_api = ("wt_rank", "rans_decode")
    totals = {k: api_path[k] if k in on_api else
              sum(path[k] for path in paths.values()) for k in main_path}
    if min(totals.values()) <= 0:
        raise AssertionError(f"a kernel of the port never launched on its "
                             f"path: {totals}")

    # each kernel's time a run on its path: launches x time at the shape
    # launched
    by_name = {r["name"]: r for r in results}
    run_ms = dict(
        l2_dist=(l2_at["arena"] * l2_mean["ms"]
                 + l2_at["flat"] * by_name["l2_dist"]["ms"]
                 + shard_l2["arena"] * l2_shard["ms"]
                 + sum(c * l2_flat_width[n]["ms"]
                       for n, c in flat_widths.items())
                 + graph_ms["l2_dist"] + lm_ms["l2_dist"]),
        pq_adc=(main_path["pq_adc"] * pq_mean["ms"]
                + shard_pq["launches"] * pq_shard["ms"]),
        seg_topk=(sum(c * seg[s]["ms"] for s, c in seg_launches.items())
                  + graph_ms["seg_topk"] + lm_ms["seg_topk"]),
        l2_top1=(sum(c * top1_at[s]["ms"] for s, c in top1.items())
                 + lm_ms["l2_top1"]),
        wt_rank=api_path["wt_rank"] * by_name["wt_rank"]["ms"],
        rans_decode=sum(r["ms"] for r in results
                        if r["name"].startswith("rans_decode")))
    rans_rows = [r for r in results if r["name"].startswith("rans_decode")]
    keep = ("shape", "ms", "step_cycles", "plain_ms", "bound_ms")
    top_seg = max(seg_launches, key=seg_launches.get)
    shown = dict(by_name, seg_topk=seg[top_seg])
    flat_seg = {f"n={n},k={k}": dict(
        launches=c, **{key: seg[(n, k)][key] for key in (
            "ms", "bound_ms", "plain_ms", "library_ms")})
        for (n, k), c in sorted(flat_shapes["seg_topk"].items())}
    extra = dict(
        l2_dist=dict(mean_rows=mean_rows["l2_dist"],
                     mean_rows_ms=l2_mean["ms"],
                     launches_by_rows={mean_rows["l2_dist"]: l2_at["arena"],
                                       flat_n: l2_at["flat"]},
                     launches_by_path={p: c["l2_dist"]
                                       for p, c in paths.items()},
                     shard=dict(shard_l2, arena_ms=l2_shard["ms"],
                                flat_launches_by_rows={
                                    n: [c, l2_flat_width[n]["ms"]]
                                    for n, c in sorted(flat_widths.items())}),
                     graph=dict(main_path_ms=graph_ms["l2_dist"],
                                knn_tile=wide["l2_dist"],
                                step_tile={key: l2_step[key] for key in (
                                    "shape", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "band_use")},
                                step_tile_steps=step_tiles_all[top_tile],
                                step_vs_host=step_tiles,
                                kernel_min_cuda=KERNEL_MIN_CUDA,
                                gates={str(g): v for g, v in gates.items()})),
        pq_adc=dict(lookups=by_name["pq_adc"]["lookups"],
                    lookup_ms=by_name["pq_adc"]["lookup_ms"],
                    mean_rows=mean_rows["pq_adc"], mean_rows_ms=pq_mean["ms"],
                    mean_rows_lookup_ms=pq_mean["lookup_ms"],
                    shard=dict(shard_pq, ms=pq_shard["ms"]),
                    launches_by_path={p: c["pq_adc"]
                                      for p, c in paths.items()},
                    m256={key: pq256[key] for key in (
                        "shape", "chunks", "max_abs_err", "ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}),
        seg_topk=dict(shape=f"n={top_seg[0]},k={top_seg[1]}",
                      launches_by_shape={
                          f"n={n},k={k}": [c, seg[(n, k)]["ms"]]
                          for (n, k), c in sorted(seg_launches.items())},
                      flat=flat_seg,
                      launches_by_path={p: c["seg_topk"]
                                        for p, c in paths.items()},
                      graph=dict(main_path_ms=graph_ms["seg_topk"],
                                 knn_tile=wide["seg_topk"],
                                 launches_by_tile={
                                     f"{r}x{n},k={k}": [c, seg_ms[(r, n, k)]]
                                     for (r, n, k), c in
                                     sorted(seg_tiles.items())})),
        l2_top1=dict(launches_by_shape={
            f"K={k},d={d},rows={rows}": [c, top1_at[(k, d, rows)]["ms"]]
            for (k, d, rows), c in sorted(top1.items())},
            launches_by_path={p: c["l2_top1"] for p, c in paths.items()}),
        rans_decode=dict(
            step_cycles=by_name["rans_decode"]["step_cycles"],
            shapes={r["name"]: {k: r[k] for k in keep}
                    for r in rans_rows + [rans_wide]
                    if r["name"] != "rans_decode"}),
        wt_rank=dict(kernel_route=by_name["wt_rank"]["kernel_route"],
                     routes=api_routes,
                     large={k: wt_large[k] for k in (
                         "shape", "kernel_route", "ms", "plain_ms",
                         "bound_ms", "bound_by")}))
    kernels = []
    for name in _build.KERNELS:
        r = shown[name]
        kernels.append({key: r[key] for key in (
            "route", "source", "replaces")} | {
            "name": name,
            "path": "kernel API" if name in on_api else "main path",
            "launches": totals[name]} | {key: r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bound_f32_ms", "band_use") if key in r} | {
            "main_path_ms": run_ms[name]} | (
            {"lm_serving_ms": lm_ms[name]} if name in lm_ms else {})
            | extra.get(name, {}))
    run_s = time.perf_counter() - started
    print(f"phase seconds: {sum(phase.seconds):.3f} in "
          f"{len(phase.seconds)} phases, {run_s:.3f} s since main started "
          f"(limit {RUN_LIMIT_S} s, margin {RUN_LIMIT_S - run_s:.3f} s)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
