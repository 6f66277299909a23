"""The index arithmetic of ``csrc/rans_decode.cu`` and ``csrc/wt_rank.cu``,
modelled in numpy on the CPU.

The CUDA kernels cannot run here, so the parts of their design that decide
which word, table entry or bit they read are written out in numpy and held
against the port's plain versions (``repro_torch.kernels.rans_decode_ref``,
``wt_rank_ref``) and the JAX package's (``repro.kernels.rans_decode.ref.
rans_decode_ref``, ``repro.kernels.wt_rank.ops.pack_bits_u32``):

* the lane layout (S consecutive lanes a thread; one decode warp up to 64
  lanes, else up to 8 warps of as few lanes a thread as fit, or one warp
  of S <= 32 in the A/B build) and each lane's rank from S ballots,
  ``popc``, the thread's lower sub-lanes and the warp totals: the
  exclusive prefix sum of the need mask in lane order;
* the word ring: 16-byte-aligned chunks of the stream copied ahead of
  ``ptr`` into 4 stages, copied again only once ``ptr`` of an earlier step
  has left them, waited for before ``ptr + L`` reaches them, all in a
  bookkeeping call taken only when ``ptr`` reaches its threshold; on the
  ``ptr`` sequence of real ``VRans16Encoder`` streams every word read comes
  from an arrived chunk that no later copy has overwritten, the words
  outside the aligned run come from global memory and a word past the end
  reads 0;
* the packed table entry ``(cf - start, freq | sym << 17)``, and the
  entry ring's premise: a refilled head's next entry is its word's;
* ``wt_rank``'s branch-free masks, on both routes (resident: zero-padded
  in shared memory, a rank at the start of each 4-word chunk and the
  query's chunk masked; global: the superblock's 16 words masked, vector
  loads where the superblock lies inside an aligned ``words``, else
  scalar), and the route chosen by size.

    PYTHONPATH=src python -m pytest -q tests/test_torch_rans_wt_design.py
"""

import ast
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels.rans_decode.ref import rans_decode_ref as jax_rans_decode_ref
from repro.kernels.wt_rank.ops import pack_bits_u32 as jax_pack_bits_u32
from repro.kernels.wt_rank.ref import wt_rank_ref as jax_wt_rank_ref

from repro_torch.core import gap_ans
from repro_torch.core.vrans import VRans16Encoder
from repro_torch.kernels import (make_tables, pack_bits_u32, rans_decode,
                                 rans_decode_ref, wt_rank, wt_rank_ref)
from repro_torch.kernels._build import CSRC


def cu_constants(name):
    """``constexpr int NAME = expr;`` of ``csrc/<name>.cu``, evaluated, so
    the models below use the kernels' own constants."""
    out = {}
    text = (CSRC / f"{name}.cu").read_text()
    for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        tree = ast.parse(expr, mode="eval")
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        if names <= out.keys():
            out[key] = eval(compile(tree, name, "eval"),
                            {"__builtins__": {}}, dict(out))
    return out


U32 = 0xFFFFFFFF
_RANS = cu_constants("rans_decode")
_WT = cu_constants("wt_rank")
LOG_STAGE, NSTAGE = _RANS["LOG_STAGE"], _RANS["NSTAGE"]   # the word ring
GUARD = _RANS["GUARD"]             # words of stage 0 mirrored past the end
FREQ_BITS = _RANS["FREQ_BITS"]
PACKED_R_MAX = _RANS["PACKED_R_MAX"]
SMEM_LIMIT = _WT["SMEM_LIMIT"]
WPS = _WT["WPS"]                   # words a superblock
RESIDENT_MIN_QUERIES = _WT["RESIDENT_MIN_QUERIES"]


def popc(x):
    return np.bitwise_count(np.asarray(x, np.uint64)).astype(np.int64)


# ---------------------------------------------------------------------------
# rans_decode: lane layout and ranks
# ---------------------------------------------------------------------------

def layout(L, wide_one_warp=False):
    """(S lanes a thread, decode warps) of the launch: one warp up to 64
    lanes, else up to 8 warps of as few lanes a thread as fit (the A/B
    build: one warp of S = 4 .. 32)."""
    per = -(-L // 32)
    if per <= 2:
        return per, 1
    if wide_one_warp:
        return next(s for s in (4, 8, 16, 32) if per <= s), 1
    nw = min(_RANS["MAX_WARPS"], per)
    S = next(s for s in (1, 2, 4) if -(-per // nw) <= s)
    return S, -(-L // (32 * S))


def lane_ids(S, nw):
    """(nw, S, 32) lane of warp w, sub-lane j, thread t: w 32 S + S t + j."""
    w, j, t = np.meshgrid(np.arange(nw), np.arange(S), np.arange(32),
                          indexing="ij")
    return w * 32 * S + S * t + j


def ballot_ranks(need, S, nw):
    """Each lane's rank (L,) and the step's total, as the kernel gets them:
    S ballots a warp, popc against lanemask_lt, the thread's lower
    sub-lanes, warp totals."""
    L = need.shape[0]
    lid = lane_ids(S, nw)
    act = lid < L
    bit = np.where(act, need[np.minimum(lid, L - 1)], False)  # (nw, S, 32)
    ballot = (bit.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    lt = (np.uint64(1) << np.arange(32, dtype=np.uint64)) - np.uint64(1)
    lower = popc(ballot[..., None] & lt).sum(1)             # (nw, 32)
    own = np.cumsum(bit, 1) - bit                           # j' < j
    rank = lower[:, None, :] + own                          # (nw, S, 32)
    warp_tot = popc(ballot).sum(1)
    rank = rank + (np.cumsum(warp_tot) - warp_tot)[:, None, None]
    out = np.zeros(L, np.int64)
    out[lid[act]] = rank[act]
    return out, int(warp_tot.sum())


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("kind", ["random", "all", "none", "sparse"])
@pytest.mark.parametrize("L", [1, 16, 31, 33, 128, 1000, 1024])
def test_ballot_rank_is_the_exclusive_prefix_sum(L, kind, wide):
    rng = np.random.default_rng(L)
    need = {"random": rng.random(L) < 0.5, "all": np.ones(L, bool),
            "none": np.zeros(L, bool), "sparse": rng.random(L) < 0.03}[kind]
    S, nw = layout(L, wide)
    assert S * 32 * nw >= L and (L > 64 or nw == 1)
    assert (S <= 4 and nw <= 8) if not wide else (nw == 1 and S <= 32)
    rank, total = ballot_ranks(need, S, nw)
    want = np.cumsum(need) - need
    np.testing.assert_array_equal(rank[need], want[need])
    assert total == int(need.sum())


# ---------------------------------------------------------------------------
# rans_decode: the word ring and the packed table
# ---------------------------------------------------------------------------

class Ring:
    """The kernel's ring bookkeeping over one stream, with the checks the
    design rests on.  ``offset`` is the view's storage offset in words (its
    address mod 16 bytes is 4 * offset mod 16).  Chunk c is the window of
    words [c stage - m, (c + 1) stage - m), m = offset mod 4, in stage
    c mod nstage; word idx sits at ring position (idx + m) mod ring, and
    stage 0's first GUARD words are mirrored past the ring's end, so a
    step reads its words contiguously from the position of ptr."""

    def __init__(self, words, offset, L, log_stage=LOG_STAGE, nstage=NSTAGE):
        self.words = np.asarray(words, np.int64) & U32
        n = len(words)
        self.stage, self.nstage = 1 << log_stage, nstage
        self.log_stage = log_stage
        assert L <= self.stage          # ptr moves less than a stage a step
        self.m = offset % 4
        self.a0 = min(n, (4 - self.m) & 3)
        self.a_end = self.a0 + ((n - self.a0) & ~3)
        self.n_chunks = -(-(n + self.m) // self.stage) if n else 0
        self.ring = np.full(self.stage * nstage + GUARD, -1, np.int64)
        self.mirrored = -1                # chunk mirrored past the end
        self.slot = [-1] * nstage         # chunk in each stage
        self.last_read = {}               # chunk -> last step that read it
        self.ready = 0
        self.lo_seen = 0
        self.next_check = 0
        self.calls = 0
        self.copies = 0
        self.edge_words = 0               # words copied by plain stores
        for c in range(min(nstage, self.n_chunks)):
            self._copy(c, t=0)
        self.issued = min(nstage, self.n_chunks)

    def _copy(self, c, t):
        """``issue``: the window's aligned run by a bulk copy, its edge
        words by plain stores."""
        w_lo = c * self.stage - self.m
        w_hi = w_lo + self.stage
        s = c % self.nstage
        old = self.slot[s]
        # every warp has read the old chunk: its last read is two steps back
        assert old < 0 or self.last_read.get(old, -2) <= t - 2, (old, t)
        base = s * self.stage - w_lo      # word i sits at ring[base + i]
        b_lo, b_hi = max(w_lo, self.a0), min(w_hi, self.a_end)
        if b_hi > b_lo:                   # 16-byte source, size and target
            assert (self.m + b_lo) % 4 == 0 and (b_hi - b_lo) % 4 == 0
            assert (base + b_lo) % 4 == 0
            self.ring[base + b_lo:base + b_hi] = self.words[b_lo:b_hi]
        n = len(self.words)
        for i in [*range(max(w_lo, 0), min(w_hi, self.a0)),
                  *range(max(w_lo, self.a_end), min(w_hi, n))]:
            self.ring[base + i] = self.words[i]
            self.edge_words += 1
        if s == 0:                        # the mirror, by the same copies
            g = self.stage * self.nstage - w_lo
            hi = min(w_lo + GUARD, w_hi)
            self.ring[g + w_lo:g + hi] = self.ring[base + w_lo:base + hi]
            self.mirrored = c
        self.slot[s] = c
        self.copies += 1

    def begin_step(self, ptr, L, t):
        """``ring_step``, taken when ptr reaches ``next_check``."""
        if ptr < self.next_check:
            return
        self.calls += 1
        while (self.issued < self.n_chunks
               and self.issued - self.nstage < self.lo_seen):
            self._copy(self.issued, t)
            self.issued += 1
        last = min(ptr + L, len(self.words)) - 1
        need = (last + self.m) >> self.log_stage if last >= 0 else -1
        while self.ready <= need:        # wait: the chunk was copied
            assert self.ready < self.issued, "waits on a chunk never copied"
            assert self.slot[self.ready % self.nstage] == self.ready
            self.ready += 1
        self.lo_seen = (ptr + self.m) >> self.log_stage
        nxt = float("inf")
        if self.ready < self.n_chunks:
            nxt = self.ready * self.stage - self.m - L + 1
        if self.issued < self.n_chunks:
            free_at = self.issued - self.nstage + 1
            nxt = min(nxt, ptr if self.lo_seen >= free_at
                      else free_at * self.stage - self.m)
        self.next_check = nxt

    def read(self, idx, ptr, t):
        """The words at ``idx`` (array, ptr <= idx < ptr + L), as the
        step's predicated shared loads read them: from the position of ptr
        on, contiguously, where idx < n, else 0."""
        n = len(self.words)
        ok = idx < n
        ring = self.stage * self.nstage
        phys = ((ptr + self.m) & (ring - 1)) + (idx[ok] - ptr)
        assert np.all(phys < ring + GUARD)
        for c in np.unique((idx[ok] + self.m) >> self.log_stage):
            assert c < self.ready, "read before its chunk was waited for"
            assert self.slot[c % self.nstage] == c, "chunk overwritten"
            self.last_read[int(c)] = t
        if np.any(phys >= ring):
            assert self.mirrored == self.slot[0]
        got = self.ring[phys]
        np.testing.assert_array_equal(got, self.words[idx[ok]])
        out = np.zeros(idx.shape, np.int64)
        out[ok] = got
        return out


def pack_entry(sym_t, freq_t, start_t):
    """(lo, hi, fits) of the packed table: lo = i - start, hi = freq |
    sym << 17 (u32), fits where freq < 2^17 and 0 <= sym < 2^15."""
    i = np.arange(len(sym_t), dtype=np.int64)
    f = np.asarray(freq_t, np.int64) & U32
    s = np.asarray(sym_t, np.int64) & U32
    lo = (i - (np.asarray(start_t, np.int64) & U32)) & U32
    hi = (f | (s << FREQ_BITS)) & U32
    fits = bool(np.all(f < (1 << FREQ_BITS)) and
                np.all(s < (1 << (32 - FREQ_BITS))))
    return lo, hi, fits


def model_decode(heads, words, tables, rows, r, offset=0, wide=False,
                 log_stage=LOG_STAGE):
    """The kernel's decode, step by step: (symbols (rows, L), Ring)."""
    L = len(heads)
    S, nw = layout(L, wide)
    sym_t, freq_t, start_t = (np.asarray(t, np.int64) for t in tables)
    lo, hi, fits = pack_entry(sym_t, freq_t, start_t)
    packed = r <= PACKED_R_MAX and fits
    ring = Ring(words, offset, L, log_stage)
    h = np.asarray(heads, np.int64) & U32
    mask = (1 << r) - 1
    ptr = 0
    out = np.empty((rows, L), np.int32)
    for t in range(rows):
        ring.begin_step(ptr, L, t)
        cf = h & mask
        if packed:
            out[t] = (hi[cf] >> FREQ_BITS).astype(np.int32)
            h = ((hi[cf] & ((1 << FREQ_BITS) - 1)) * (h >> r) + lo[cf]) & U32
        else:
            out[t] = sym_t[cf].astype(np.int32)
            h = ((freq_t[cf] & U32) * (h >> r) + cf - (start_t[cf] & U32)) \
                & U32
        need = h < (1 << 16)
        rank, total = ballot_ranks(need, S, nw)
        got = ring.read(ptr + rank[need], ptr, t)
        h[need] = ((h[need] << 16) | got) & U32
        ptr += total
    return out, ring


def _stream(lanes, rows, seed, r=None, freqs=None):
    """Symbols on gap_ans's quotient model (or ``freqs`` at ``r``), encoded
    by the port's 32/16 coder: (data, heads, words, tables, r)."""
    if freqs is None:
        r, freqs = gap_ans._Q_PRECISION, gap_ans._QF
    freqs = np.asarray(freqs, np.int64)
    starts = np.cumsum(freqs) - freqs
    rng = np.random.default_rng(seed)
    data = rng.choice(len(freqs), size=(rows, lanes), p=freqs / freqs.sum())
    enc = VRans16Encoder(lanes)
    for t in range(rows - 1, -1, -1):
        enc.push(starts[data[t]], freqs[data[t]], r)
    heads, words = enc.finalize()
    return data, heads, words.astype(np.int32), make_tables(freqs, r), r


def _plain(heads, words, tables, rows, r):
    return rans_decode_ref(torch.from_numpy(heads.view(np.int32)),
                           torch.from_numpy(words),
                           *(torch.from_numpy(t) for t in tables),
                           rows=rows, r=r).numpy()


@pytest.mark.parametrize("lanes,rows,offset,log_stage,wide", [
    (128, 1024, 0, LOG_STAGE, False),     # the main path's lanes
    (16, 64, 0, LOG_STAGE, False),        # one IVF1024 cluster at 1M
    (1024, 128, 0, LOG_STAGE, False),     # eight decode warps
    (1024, 64, 3, LOG_STAGE, True),       # one wide warp, odd offset
    (128, 512, 1, 7, False),              # 128-word stages: many wraps
    (33, 400, 2, 6, False),
    (16, 300, 3, 4, False),               # 16-word stages, ptr +16 a step
    (1, 2000, 1, 4, False),
])
def test_ring_on_real_streams(lanes, rows, offset, log_stage, wide):
    data, heads, words, tables, r = _stream(lanes, rows, seed=lanes + rows)
    got, ring = model_decode(heads, words, tables, rows, r, offset, wide,
                             log_stage)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, _plain(heads, words, tables, rows, r))
    # the reference's oracle gathers past the end into its L slack words
    oracle = jax_rans_decode_ref(
        jnp.asarray(heads), jnp.pad(jnp.asarray(words.view(np.uint32)),
                                    (0, lanes)),
        *(jnp.asarray(t) for t in tables), rows=rows, r=r)
    np.testing.assert_array_equal(got, np.asarray(oracle))
    assert ring.n_chunks == 0 or ring.copies == ring.n_chunks
    # the bookkeeping runs at most three times a chunk: its wait, ptr
    # entering it, and the copy it frees a step later
    assert ring.calls <= 3 * ring.n_chunks + 2
    if ring.n_chunks > NSTAGE:
        assert ring.ready == ring.n_chunks   # every chunk was waited for


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_ring_reads_past_the_end_as_zero(offset):
    """Rows past the stream's end, a ragged tail and an odd offset: words
    outside the aligned run come from global memory, past the end 0."""
    data, heads, words, tables, r = _stream(16, 80, seed=offset)
    words = words[:len(words) - 1 - offset]      # a ragged, cut stream
    rows = 120
    got, ring = model_decode(heads, words, tables, rows, r, offset,
                             log_stage=4)
    np.testing.assert_array_equal(got, _plain(heads, words, tables, rows, r))
    assert ring.a_end - ring.a0 == (len(words) - ring.a0) & ~3
    assert ring.edge_words <= 6                  # at most 3 at each end
    whole = Ring(words, offset, 16, log_stage=10)  # one chunk: the stream
    whole.begin_step(0, 1 << 10, 0)
    vals = whole.read(np.arange(len(words) + 40), 0, 0)
    np.testing.assert_array_equal(vals[:len(words)], words.view(np.uint32))
    assert not vals[len(words):].any()


def test_heads_below_2_16_and_wide_words():
    """Heads outside [2^16, 2^32) and words with high bits: the u32 wrap
    and the OR of the whole word, as in the plain version."""
    rng = np.random.default_rng(5)
    r = 12
    freqs = np.maximum(1, (1 << r) >> (np.arange(24) + 1))
    freqs[0] += (1 << r) - freqs.sum()
    tables = make_tables(freqs, r)
    heads = rng.integers(0, 1 << 16, 128).astype(np.uint32)
    heads[::3] = rng.integers(0, 1 << 32, 43, dtype=np.uint64)
    words = rng.integers(-(1 << 31), 1 << 31, 3000).astype(np.int32)
    got, _ = model_decode(heads, words, tables, 200, r, offset=1)
    np.testing.assert_array_equal(got, _plain(heads, words, tables, 200, r))


def _freqs(kind, r, rng):
    n = 1 << r
    if kind == "one":
        return np.array([n], np.int64)
    if kind == "uniform":
        return np.ones(n, np.int64)
    a = int(min(r, rng.integers(1, 64)))
    f = (n >> (np.arange(a) + 1)).astype(np.int64)
    f[0] += n - f.sum()
    return f


@pytest.mark.parametrize("kind", ["one", "uniform", "geometric"])
@pytest.mark.parametrize("r", list(range(1, 17)))
def test_packed_entry_decodes_back(r, kind):
    rng = np.random.default_rng(r)
    freqs = _freqs(kind, r, rng)
    sym_t, freq_t, start_t = make_tables(freqs, r)
    lo, hi, fits = pack_entry(sym_t, freq_t, start_t)
    # every table of r <= 14 packs; 2^16 symbols at r = 16 would not, but
    # r >= 15 reads the three tables
    assert fits == (len(freqs) <= 1 << (32 - FREQ_BITS))
    assert fits or r > PACKED_R_MAX
    if not fits:
        return
    np.testing.assert_array_equal(hi >> FREQ_BITS, sym_t)
    np.testing.assert_array_equal(hi & ((1 << FREQ_BITS) - 1), freq_t)
    np.testing.assert_array_equal((np.arange(1 << r) - lo) & U32, start_t)
    if kind == "one":
        assert freq_t.max() == 1 << r         # 2^16 at r = 16: 17 bits
    h = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.int64)
    cf = h & ((1 << r) - 1)
    want = (freq_t[cf] * (h >> r) + cf - start_t[cf]) & U32
    got = ((hi[cf] & ((1 << FREQ_BITS) - 1)) * (h >> r) + lo[cf]) & U32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [1, 8, 12, 14, 16])
def test_refilled_head_selects_its_words_entry(r):
    """After a refill the head's low 16 bits are the word, so its next slot
    is w & mask: the entry ring holds tab[w & mask] for every word, high
    bits of the word included."""
    rng = np.random.default_rng(r)
    h = rng.integers(0, 1 << 16, 4096).astype(np.int64)      # need: < 2^16
    w = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.int64)
    mask = (1 << r) - 1
    refilled = ((h << 16) | w) & U32
    np.testing.assert_array_equal(refilled & mask, w & mask)


def test_tables_that_do_not_pack_take_the_global_route():
    r = 4
    sym_t, freq_t, start_t = make_tables(np.full(16, 1), r)
    for bad in ((sym_t, np.full(16, 1 << 17, np.int32), start_t),
                (np.full(16, 1 << 15, np.int32), freq_t, start_t),
                (np.full(16, -1, np.int32), freq_t, start_t)):
        assert not pack_entry(*bad)[2]
    # decoded all the same, from the three tables
    rng = np.random.default_rng(0)
    heads = rng.integers(1 << 16, 1 << 32, 8, dtype=np.uint64
                         ).astype(np.uint32)
    words = rng.integers(0, 1 << 16, 200).astype(np.int32)
    tables = (np.arange(16, dtype=np.int32) - 3, freq_t, start_t)
    got, _ = model_decode(heads, words, tables, 30, r)
    np.testing.assert_array_equal(got, _plain(heads, words, tables, 30, r))


def test_cpu_wrapper_is_the_plain_version():
    data, heads, words, tables, r = _stream(128, 256, seed=9)
    out = rans_decode(torch.from_numpy(heads.view(np.int32)),
                      torch.from_numpy(words),
                      *(torch.from_numpy(t) for t in tables), rows=256, r=r)
    np.testing.assert_array_equal(out.numpy(), data)


# ---------------------------------------------------------------------------
# wt_rank: branch-free masks and the two routes
# ---------------------------------------------------------------------------

def masks(q):
    """(len(q), 16) masks of the superblock's words for rank q."""
    q = np.asarray(q, np.int64)
    wl = (q >> 5) & (WPS - 1)
    partial = (np.int64(1) << (q & 31)) - 1
    j = np.arange(WPS)
    return np.where(j < wl[:, None], U32,
                    np.where(j == wl[:, None], partial[:, None], 0))


def resident_words(n_words, n_super):
    """Padded words of the resident route, or 0 where it does not fit
    (beside them: a rank a 4-word chunk and a 16-byte mbarrier)."""
    if n_words <= 0 or n_super <= 0:
        return 0
    n_pad = (n_words // WPS + 1) * WPS
    return n_pad if 16 + 4 * n_pad + n_pad <= SMEM_LIMIT else 0


def route_of(n_words, n_super, nq):
    """``wt_rank_route``: resident where it fits and the batch pays for the
    load."""
    return ("resident" if resident_words(n_words, n_super)
            and nq >= RESIDENT_MIN_QUERIES else "global")


def model_wt_rank(words, super_cum, q, route, aligned=True):
    """Ranks (int64) as the kernel's route computes them."""
    w = np.asarray(words, np.int64) & U32
    n, ns = len(w), len(super_cum)
    q = np.asarray(q, np.int64)
    ok = (q >= 0) & (q <= 32 * n) & ((q >> 9) < ns)
    qq = np.where(ok, q, 0)
    sb = qq >> 9
    m = masks(qq)
    if route == "resident":
        n_pad = resident_words(n, ns)
        assert n_pad and np.all((sb + 1) * WPS <= n_pad)
        padded = np.concatenate([w, np.zeros(n_pad - n, np.int64)])
        # the rank at the start of each 4-word chunk
        chunks = popc(padded.reshape(-1, 4)).sum(1).reshape(-1, 4)
        sup_c = np.asarray(super_cum, np.int64)
        base = np.where(np.arange(n_pad // WPS) < ns,
                        sup_c[np.minimum(np.arange(n_pad // WPS), ns - 1)], 0)
        chunk_rank = (base[:, None] + np.cumsum(chunks, 1) - chunks).reshape(-1)
        k = qq >> 7                       # the query's chunk
        word_masks = np.take_along_axis(m, (k % 4)[:, None] * 4
                                        + np.arange(4), 1)
        acc = chunk_rank[k] + popc(
            padded[k[:, None] * 4 + np.arange(4)] & word_masks).sum(1)
    else:
        vec = aligned & ((sb + 1) * WPS <= n)
        idx = sb[:, None] * WPS + np.arange(WPS)
        # scalar route: only the words the mask keeps are loaded
        assert np.all(idx[~vec][m[~vec] != 0] < n)
        sup = np.where(vec[:, None] | (m != 0), w[np.minimum(idx, n - 1)], 0)
        acc = np.asarray(super_cum, np.int64)[sb] + popc(sup & m).sum(1)
    return np.where(ok, acc, -1)


def test_branch_free_masks_match_the_loop():
    """Every (w mod 16, b): the 16 masked popcounts equal the first
    kernel's loop over the whole words and the partial word."""
    rng = np.random.default_rng(1)
    sup = rng.integers(0, 1 << 32, WPS, dtype=np.uint64).astype(np.int64)
    for wl in range(WPS):
        for b in range(32):
            q = 512 * 3 + 32 * wl + b
            loop = sum(popc(sup[j]) for j in range(wl))
            if b:
                loop += popc(sup[wl] & ((1 << b) - 1))
            assert popc(sup & masks([q])[0]).sum() == loop, (wl, b)


@pytest.mark.parametrize("route,unpadded,aligned", [
    ("resident", False, True), ("resident", True, True),
    ("global", False, True), ("global", True, True), ("global", True, False),
    ("global", False, False)])
@pytest.mark.parametrize("n", [1, 511, 512, 4097, 100_000])
def test_wt_rank_routes_match_plain_versions(n, route, unpadded, aligned):
    rng = np.random.default_rng(n)
    bits = (rng.random(n) < 0.4).astype(np.uint8)
    words, sup = pack_bits_u32(bits)
    jw, js = jax_pack_bits_u32(bits)
    np.testing.assert_array_equal(words, jw)
    np.testing.assert_array_equal(sup, js)
    if unpadded:                  # the entry point takes any W
        words = words[:-(-n // 32)]
    W = len(words)
    q = np.concatenate([[0, n, 32 * W, 32 * W - 1, -1, 32 * W + 1],
                        np.arange(0, 32 * W + 1, 512),
                        [max(0, 32 * W - 1 - 17), 32 * (W - 1) + 5],
                        rng.integers(0, 32 * W + 1, 500)]).astype(np.int32)
    got = model_wt_rank(words, sup, q, route, aligned)
    plain = wt_rank_ref(torch.from_numpy(words.view(np.int32)),
                        torch.from_numpy(sup), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, plain)
    wrapper = wt_rank(torch.from_numpy(words.view(np.int32)),
                      torch.from_numpy(sup), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(wrapper, plain)
    inside = (q >= 0) & (q <= n)
    np.testing.assert_array_equal(got[inside], np.asarray(jax_wt_rank_ref(
        jnp.asarray(bits), jnp.asarray(q[inside]))))


def test_route_by_size():
    """With the constants of ``csrc/wt_rank.cu``: level 0 of a 1M-id
    wavelet tree fits a block's shared memory, a bitvector of 2^24 bits
    does not, and a batch below the cut-over takes the global route."""
    assert SMEM_LIMIT == _RANS["SMEM_LIMIT"] == 232448   # sm_90's opt-in
    assert WPS == 16 and 1 <= RESIDENT_MIN_QUERIES <= 1 << 24
    for nbits, fits in ((1_048_576, True), (1_050_000, True),
                        (1 << 24, False), (32, True)):
        words, sup = pack_bits_u32(np.zeros(nbits, np.uint8))
        assert bool(resident_words(len(words), len(sup))) == fits
        assert route_of(len(words), len(sup), RESIDENT_MIN_QUERIES) == \
            ("resident" if fits else "global")
        assert route_of(len(words), len(sup),
                        RESIDENT_MIN_QUERIES - 1) == "global"
    assert resident_words(0, 1) == 0 and resident_words(16, 0) == 0
