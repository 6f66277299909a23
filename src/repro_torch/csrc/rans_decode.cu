// Interleaved-lane 32/16 rANS decode with a static pmf (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `rans_decode_pallas`
// (src/repro/kernels/rans_decode/kernel.py, body `_decode_kernel`): L
// lanes decode one symbol each per step, in lockstep, for `rows` steps.
// Per step and lane, with u32 head h and cf = h mod 2^r:
//
//     sym = sym_t[cf];  h = freq_t[cf] * (h >> r) + cf - start_t[cf]
//     if h < 2^16: h = (h << 16) | words[ptr + k]
//
// where k is the lane's rank among the lanes that need a word this step
// (an exclusive prefix sum over the need mask: the encoder wrote each
// step's words contiguous and in lane order), and ptr advances by the
// step's total.
//
// What bounds it on an H100: nothing the card has a peak for.  The steps
// form one dependent chain (each step's word index needs the previous
// step's prefix sum), and a decode of rows x L symbols moves only
// ~(2 + 4) bytes per symbol, so the time is `rows` times the latency of
// one step.  The design makes that step short:
//
// * up to 64 lanes, one decode warp, S = 1 or 2 consecutive lanes a
//   thread (lane S t + j of the warp is sub-lane j of thread t), so the
//   heads live in registers and a step takes no barrier; a thread stores
//   its S symbols as one vector where L % S == 0.  A lane's rank is
//   sum_j' popc(B_j' & lanemask_lt) over the S ballots B_j, plus the
//   refills of the thread's lower sub-lanes; the step's total is
//   sum_j popc(B_j).  Past 64 lanes, up to 8 decode warps of as few
//   lanes a thread as fit (4 warps of S = 1 at L = 128, 8 of S = 4 at
//   L = 1024) join by a named barrier (`bar.sync 1, n`) over warp totals
//   double-buffered in shared memory: at L = 128 .. 1024 they beat one
//   warp of S = 4 .. 32 in tools/ab_kernels.py's same-call A/B on an
//   H100, one warp's four lanes a thread being bound by its own issue;
// * the words come from a ring in shared memory (4 stages of 1024
//   words): one lane keeps 1-D bulk copies (`cp.async.bulk`, one
//   mbarrier a stage) in flight ahead of ptr, which is the same in every
//   thread and grows by at most L a step, so the word a lane needs is one
//   shared load, predicated off (reading 0) past the stream's end, with
//   no branch.  Stage c holds the 16-byte-aligned window of words
//   [c 1024 - m, (c + 1) 1024 - m), m being the view's offset from a
//   16-byte boundary: the bulk copy takes the window's aligned run, and
//   the at most 3 words before it (a view at an odd offset) and after it
//   (a ragged tail) are copied by plain loads, so the kernel never reads
//   out of bounds; stage 0's first 1024 words are mirrored past the
//   ring's end, so a step's words are contiguous.  The bookkeeping (copy
//   the stages every warp has left a step or more ago, wait for the
//   stages up to ptr + L) runs only when ptr reaches a threshold it
//   sets, outside the step loop;
// * one table load a step, off the chain: for r <= 14 the block packs
//   each slot into one 8-byte entry in shared memory, (cf - start,
//   freq | sym << 17), so a step does h = f * (h >> r) + bias with u32
//   wrap (r = 12 is 32 KB, r = 14 128 KB).  A refilled head's low 16
//   bits are its new word, so its next entry is tab[w & mask]: the warps
//   the decode leaves idle turn each arriving stage into an entry ring
//   (the entry each word would select), and a refilling lane loads its
//   word and that word's entry side by side, while a lane that takes no
//   word loads its own next entry as soon as its head is known.  freq
//   can be 2^16 at r = 16, so it keeps 17 bits; tables whose entries do
//   not fit (freq >= 2^17 or sym outside [0, 2^15)), and r >= 15, read
//   the three tables through the read-only cache after the word instead;
// * 512 threads load and pack the tables with 16-byte loads (one round
//   trip at r = 12) while the first bulk copies fly; after that barrier
//   the decode warps decode and the rest fill the entry ring.
//
// Heads arrive as int32 bit patterns and words as int32 values; both are
// read as u32 (a word's high bits are ORed in, as in the plain version).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int MAX_LANES = 1024;
constexpr int THREADS = 512;       // the table load; then the decode warps
constexpr int MAX_WARPS = 8;       // decode warps at L > 64
constexpr int LOG_STAGE = 10;
constexpr int STAGE = 1 << LOG_STAGE;   // words a ring stage
constexpr int NSTAGE = 4;
constexpr int RING = STAGE * NSTAGE;
constexpr int GUARD = MAX_LANES;   // words mirrored past the ring's end
constexpr int PACKED_R_MAX = 14;
constexpr int FREQ_BITS = 17;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
// shared memory: NSTAGE mbarriers for the copies and NSTAGE for the
// entries, 2 x MAX_WARPS warp totals, the decode's done flag, the word
// ring, the entry ring (the table entry each word would select), then
// the packed table
constexpr int TOTALS_AT = 64;
constexpr int DONE_AT = 128;
constexpr int RING_AT = 256;
constexpr int ENTRY_AT = RING_AT + (RING + GUARD) * 4;
constexpr int TABLE_AT = ENTRY_AT + (RING + GUARD) * 8;
static_assert(GUARD <= STAGE, "a step's words span at most two stages");
static_assert(TABLE_AT + (8 << PACKED_R_MAX) <= SMEM_LIMIT,
              "the rings and the packed table fit a block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// shared loads by 32-bit shared address, so the hot loop keeps the table's
// and the ring's addresses in registers
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

// the ring word at shared address addr where idx < n, else 0 (predicated:
// no branch)
__device__ __forceinline__ uint32_t lds32_below(uint32_t addr, int idx,
                                               int n) {
  uint32_t v;
  asm volatile(
      "{\n.reg .pred p;\nsetp.lt.s32 p, %2, %3;\nmov.u32 %0, 0;\n"
      "@p ld.shared.u32 %0, [%1];\n}\n"
      : "=r"(v)
      : "r"(addr), "r"(idx), "r"(n));
  return v;
}

// the entry at shared address addr where idx < n, else `dflt`
__device__ __forceinline__ uint2 lds64_below(uint32_t addr, int idx, int n,
                                            uint2 dflt) {
  uint2 v;
  asm volatile(
      "{\n.reg .pred p;\nsetp.lt.s32 p, %4, %5;\nmov.b32 %0, %2;\n"
      "mov.b32 %1, %3;\n@p ld.shared.v2.u32 {%0, %1}, [%6];\n}\n"
      : "=r"(v.x), "=r"(v.y)
      : "r"(dflt.x), "r"(dflt.y), "r"(idx), "r"(n), "r"(addr));
  return v;
}

// The stream in the ring: word idx lives at ring position (idx + m) mod
// RING, where m is the view's offset in words from a 16-byte boundary, so
// chunk c (ring stage c % NSTAGE) is the 16-byte-aligned window of words
// [c STAGE - m, (c + 1) STAGE - m).
struct Stream {
  const uint32_t* words;
  int n_words;
  int m;          // words from the 16-byte boundary below `words`
  int a0, a_end;  // the 16-byte-aligned run of words, bulk-copied
  int n_chunks;   // windows that hold words of [0, n_words)
};

// thread 0: copy chunk c into its stage: the window's part of [a0, a_end)
// by one bulk copy, the at most 3 words before a0 and after a_end by
// plain loads and stores; stage 0's first GUARD words also go past the
// ring's end, so a step's words are contiguous in shared memory.  Then arm
// the stage's mbarrier with the bytes of both copies.
__device__ __forceinline__ void issue(const Stream& s, uint32_t* ring,
                                     uint64_t* bars, int c) {
  const int w_lo = c * STAGE - s.m;
  uint32_t* stage = ring + (c % NSTAGE) * STAGE;
  const bool mirror = c % NSTAGE == 0;
  const uint32_t bar = smem_u32(bars + c % NSTAGE);
  // the words of [w_lo, w_hi) outside the aligned run, stored before the
  // arrive that publishes them
  auto edges = [&](uint32_t* dst, int w_hi) {
    for (int i = max(w_lo, 0); i < min(w_hi, s.a0); ++i)
      dst[i - w_lo] = __ldg(s.words + i);
    for (int i = max(w_lo, s.a_end); i < min(w_hi, s.n_words); ++i)
      dst[i - w_lo] = __ldg(s.words + i);
  };
  auto bulk_bytes = [&](int w_hi) {
    return max(0, min(w_hi, s.a_end) - max(w_lo, s.a0)) * 4;
  };
  auto bulk = [&](uint32_t* dst, int w_hi) {
    const int b_lo = max(w_lo, s.a0);
    if (bulk_bytes(w_hi))
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst + (b_lo - w_lo))),
          "l"(s.words + b_lo), "r"(bulk_bytes(w_hi)), "r"(bar)
          : "memory");
  };
  edges(stage, w_lo + STAGE);
  if (mirror) edges(ring + RING, w_lo + GUARD);
  // the stage's earlier words were read by the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bulk_bytes(w_lo + STAGE) + (mirror ? bulk_bytes(w_lo + GUARD) : 0))
      : "memory");
  bulk(stage, w_lo + STAGE);
  if (mirror) bulk(ring + RING, w_lo + GUARD);
}

// Ring bookkeeping of one decode step, taken only when ptr reaches
// next_check: copy the stages that every warp has left, wait (on
// `wait_bars`: the copies, or the entries made from them) for the
// chunks up to ptr + L, and return the ptr at which the ring next needs
// attention.  A chunk is copied again only once it lies below ptr of an
// earlier call (`lo_seen`): every warp read it a step or more before this
// one, and has passed that step's ballot or barrier since.
__device__ __noinline__ int ring_step(const Stream& s, uint32_t* ring,
                                      uint64_t* bars, uint64_t* wait_bars,
                                      int ptr, int L, bool issuer, int& ready,
                                      int& issued, int& lo_seen) {
  while (issued < s.n_chunks && issued - NSTAGE < lo_seen) {
    if (issuer) issue(s, ring, bars, issued);
    ++issued;
  }
  const int last = min(ptr + L, s.n_words) - 1;  // the last word a step reads
  const int need = last >= 0 ? (last + s.m) >> LOG_STAGE : -1;
  while (ready <= need) {
    mbar_wait(smem_u32(wait_bars + ready % NSTAGE), (ready / NSTAGE) & 1);
    ++ready;
  }
  lo_seen = (ptr + s.m) >> LOG_STAGE;
  int next = INT_MAX;
  if (ready < s.n_chunks) next = ready * STAGE - s.m - L + 1;
  if (issued < s.n_chunks) {
    const int free_at = issued - NSTAGE + 1;  // lo_seen that frees a stage
    next = min(next, lo_seen >= free_at ? ptr : free_at * STAGE - s.m);
  }
  return next;
}

// The converter warps (those the decode leaves idle): as each chunk
// arrives, the table entry each of its words would select, tab[w & mask],
// into the entry ring (the mirror too), then an arrive on the chunk's
// entry barrier, which the decode waits for in place of the copy's.  A
// word that refills a head is its new low 16 bits, so the head's next
// entry is this one.  Returns once every chunk is done or the decode
// has ended (it issues no more).
__device__ __forceinline__ void convert(const Stream& s, const uint32_t* ring,
                                        uint2* entries, const uint2* tab,
                                        uint64_t* bars,
                                        const volatile int* done, int r,
                                        int ct, int nct) {
  const uint32_t mask = (1u << r) - 1u;
  for (int c = 0; c < s.n_chunks; ++c) {
    const uint32_t full = smem_u32(bars + c % NSTAGE);
    const int parity = (c / NSTAGE) & 1;
    for (;;) {
      uint32_t ok;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(ok)
          : "r"(full), "r"(parity)
          : "memory");
      if (ok) break;
      if (*done) return;
    }
    const int base = (c % NSTAGE) * STAGE;
    for (int i = ct; i < STAGE; i += nct)
      entries[base + i] = tab[ring[base + i] & mask];
    if (c % NSTAGE == 0)
      for (int i = ct; i < GUARD; i += nct)
        entries[RING + i] = tab[ring[RING + i] & mask];
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bars + NSTAGE + c % NSTAGE))
                 : "memory");
  }
}

// The decode loop of one warp: S consecutive lanes a thread; MULTI joins nw
// warps; VEC stores a thread's S symbols as one vector (L % S == 0).
// The step's hot path has no divergent branch: every lane loads a ring
// word (and, with ENTRIES, that word's table entry from the entry ring,
// beside the entry its own head selects), and selects keep what the lane
// needs.  With ENTRIES the step's chain holds one dependent shared load:
// the next entry comes with the word, not after it.
template <int S, bool ENTRIES, bool MULTI, bool VEC>
__device__ __forceinline__ void decode(
    const Stream& s, uint32_t* ring, const uint2* entries, uint64_t* bars,
    int* totals, volatile int* done, const uint2* tab,
    const uint32_t* __restrict__ heads, const int* __restrict__ sym_t,
    const int* __restrict__ freq_t, const int* __restrict__ start_t,
    int* __restrict__ out, int L, int rows, int r, int nw) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int base = warp * 32 * S + S * lane;   // sub-lane j is base + j
  const uint32_t mask = (1u << r) - 1u;
  const uint32_t tab_at = smem_u32(tab);
  const uint32_t ring_at = smem_u32(ring);
  const uint32_t entry_at = smem_u32(entries);

  uint32_t h[S];
  bool act[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    act[j] = base + j < L;
    h[j] = act[j] ? heads[base + j] : 0u;
  }
  // each lane's current table entry; a refill past the stream's end reads
  // the word 0, which selects entry 0
  uint2 e[S];
  uint2 e_zero = make_uint2(0u, 0u);
  if (ENTRIES) {
    e_zero = lds64(tab_at);
#pragma unroll
    for (int j = 0; j < S; ++j) e[j] = lds64(tab_at + ((h[j] & mask) << 3));
  }
  int* op = out + base;   // sub-lane 0 of this thread in row t

  int ptr = 0;      // words consumed so far; the same in every thread
  int ready = 0;    // chunks waited for
  int issued = min(NSTAGE, s.n_chunks);  // chunks copied
  int lo_seen = 0;
  int t = 0;
  while (t < rows) {
    // the ring's bookkeeping, then the steps until ptr reaches next_check:
    // the step loop's own branch is its only one
    const int next_check =
        ring_step(s, ring, bars, bars + (ENTRIES ? NSTAGE : 0), ptr, L,
                  tid == 0, ready, issued, lo_seen);
    do {
      // the ring slot of word ptr; a step's words run on from it
      // contiguously (into the mirror past the ring's end)
      const int at_slot = (ptr + s.m) & (RING - 1);

      bool need[S];
      int sym[S];
      uint2 own[S];   // the next entry of a lane that takes no word
      if (ENTRIES) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          sym[j] = (int)(e[j].y >> FREQ_BITS);
          h[j] = (e[j].y & ((1u << FREQ_BITS) - 1u)) * (h[j] >> r) + e[j].x;
        }
#pragma unroll
        for (int j = 0; j < S; ++j)
          own[j] = lds64(tab_at + ((h[j] & mask) << 3));
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const uint32_t cf = h[j] & mask;
          sym[j] = __ldg(sym_t + cf);
          h[j] = (uint32_t)__ldg(freq_t + cf) * (h[j] >> r) + cf -
                 (uint32_t)__ldg(start_t + cf);
        }
      }
#pragma unroll
      for (int j = 0; j < S; ++j) need[j] = act[j] && h[j] < (1u << 16);
      if (VEC && S == 4) {   // 16 bytes: L % 4 == 0, so all 4 or none
        if (act[0])
          *reinterpret_cast<int4*>(op) =
              make_int4(sym[0], sym[1 % S], sym[2 % S], sym[3 % S]);
      } else if (VEC && S == 2) {
        if (act[0])
          *reinterpret_cast<int2*>(op) = make_int2(sym[0], sym[1 % S]);
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (act[j]) op[j] = sym[j];
      }
      op += L;
      // a lane's rank: the refills of the warp's lower threads (one ballot
      // a sub-lane, popc against lanemask_lt), then of this thread's lower
      // sub-lanes
      unsigned ballot[S];
#pragma unroll
      for (int j = 0; j < S; ++j)
        ballot[j] = __ballot_sync(0xffffffffu, need[j]);
      int lower = 0, run = 0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        lower += __popc(ballot[j] & lt);
        run += __popc(ballot[j]);
      }
      int rank[S];
      int own_refills = 0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        rank[j] = lower + own_refills;
        own_refills += need[j] ? 1 : 0;
      }
      int before = 0, total = run;
      if (MULTI) {
        int* tot = totals + (t & 1) * MAX_WARPS;
        if (lane == 0) tot[warp] = run;
        asm volatile("bar.sync 1, %0;\n" ::"r"(nw * 32) : "memory");
        const int4 a = *reinterpret_cast<const int4*>(tot);
        const int4 b = *reinterpret_cast<const int4*>(tot + 4);
        const int v[MAX_WARPS] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        total = 0;
#pragma unroll
        for (int w = 0; w < MAX_WARPS; ++w) {
          before += w < warp ? v[w] : 0;
          total += v[w];
        }
      }
      const int at = ptr + before;   // this warp's first word of the step
      const int slot = at_slot + before;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const uint32_t w = lds32_below(ring_at + 4 * (slot + rank[j]),
                                       at + rank[j], s.n_words);
        if (ENTRIES) {
          const uint2 taken = lds64_below(entry_at + 8 * (slot + rank[j]),
                                          at + rank[j], s.n_words, e_zero);
          e[j] = need[j] ? taken : own[j];
        }
        h[j] = need[j] ? (h[j] << 16) | w : h[j];
      }
      ptr += total;
      ++t;
    } while (t < rows && ptr < next_check);
  }
  // no copy may still be landing in shared memory when the block exits
  while (ready < issued) {
    mbar_wait(smem_u32(bars + ready % NSTAGE), (ready / NSTAGE) & 1);
    ++ready;
  }
  if (tid == 0) *done = 1;
}

template <int S, bool PACKED, bool MULTI, bool VEC>
__global__ void __launch_bounds__(THREADS)
rans_decode_kernel(Stream s, const uint32_t* __restrict__ heads,
                   const int* __restrict__ sym_t,
                   const int* __restrict__ freq_t,
                   const int* __restrict__ start_t, int* __restrict__ out,
                   int L, int rows, int r, int nw) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // copies, entries
  int* totals = reinterpret_cast<int*>(smem + TOTALS_AT);
  volatile int* done = reinterpret_cast<volatile int*>(smem + DONE_AT);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + RING_AT);
  uint2* entries = reinterpret_cast<uint2*>(smem + ENTRY_AT);
  uint2* tab = reinterpret_cast<uint2*>(smem + TABLE_AT);
  const int tid = threadIdx.x;
  const int nct = THREADS - nw * 32;   // converter threads

  if (tid == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(bars + i))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(bars + NSTAGE + i)),
                   "r"(nct)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(NSTAGE, s.n_chunks); ++c) issue(s, ring, bars, c);
    *done = 0;
  }
  if (tid < 2 * MAX_WARPS) totals[tid] = 0;

  // the packed table, built while the first chunks fly: slot i holds
  // (i - start, freq | sym << 17); fits is false if an entry does not
  bool fits = true;
  if (PACKED) {
    const int tsz = 1 << r;
    auto put = [&](int i, int sym, int f, int c) {
      fits &= (uint32_t)f < (1u << FREQ_BITS) &&
              (uint32_t)sym < (1u << (32 - FREQ_BITS));
      return make_uint2((uint32_t)i - (uint32_t)c,
                        (uint32_t)f | ((uint32_t)sym << FREQ_BITS));
    };
    const bool vec = tsz >= 4 &&
                     !(((uintptr_t)sym_t | (uintptr_t)freq_t |
                        (uintptr_t)start_t) & 15);
    if (vec) {
#pragma unroll 2  // both rounds' loads in flight at r = 12
      for (int q = tid; q < tsz / 4; q += THREADS) {
        const int4 sy = __ldg(reinterpret_cast<const int4*>(sym_t) + q);
        const int4 fr = __ldg(reinterpret_cast<const int4*>(freq_t) + q);
        const int4 st = __ldg(reinterpret_cast<const int4*>(start_t) + q);
        const uint2 e0 = put(4 * q, sy.x, fr.x, st.x);
        const uint2 e1 = put(4 * q + 1, sy.y, fr.y, st.y);
        const uint2 e2 = put(4 * q + 2, sy.z, fr.z, st.z);
        const uint2 e3 = put(4 * q + 3, sy.w, fr.w, st.w);
        reinterpret_cast<uint4*>(tab)[2 * q] =
            make_uint4(e0.x, e0.y, e1.x, e1.y);
        reinterpret_cast<uint4*>(tab)[2 * q + 1] =
            make_uint4(e2.x, e2.y, e3.x, e3.y);
      }
    } else {
      for (int i = tid; i < tsz; i += THREADS)
        tab[i] = put(i, __ldg(sym_t + i), __ldg(freq_t + i),
                     __ldg(start_t + i));
    }
  }
  // the one block barrier: the table, the totals, the flag and the
  // mbarriers' init; then the decode warps decode and, with the packed
  // table, the others fill the entry ring
  fits = __syncthreads_and(fits);
  if constexpr (PACKED) {
    if (fits) {
      if (tid >= nw * 32)
        convert(s, ring, entries, tab, bars, done, r, tid - nw * 32, nct);
      else
        decode<S, true, MULTI, VEC>(s, ring, entries, bars, totals, done,
                                    tab, heads, sym_t, freq_t, start_t, out,
                                    L, rows, r, nw);
      return;
    }
  }
  if (tid < nw * 32)
    decode<S, false, MULTI, VEC>(s, ring, entries, bars, totals, done, tab,
                                 heads, sym_t, freq_t, start_t, out, L, rows,
                                 r, nw);
}

template <int S, bool MULTI, bool VEC>
cudaError_t launch_as(const Stream& s, const void* heads, const void* sym_t,
                      const void* freq_t, const void* start_t, void* out,
                      int L, int rows, int r, cudaStream_t stream) {
  const bool packed = r <= PACKED_R_MAX;
  const size_t smem = TABLE_AT + (packed ? (size_t)8 << r : 0);
  auto kernel = packed ? rans_decode_kernel<S, true, MULTI, VEC>
                       : rans_decode_kernel<S, false, MULTI, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nw = MULTI ? (L + 32 * S - 1) / (32 * S) : 1;
  kernel<<<1, THREADS, smem, stream>>>(
      s, (const uint32_t*)heads, (const int*)sym_t, (const int*)freq_t,
      (const int*)start_t, (int*)out, L, rows, r, nw);
  return cudaGetLastError();
}

// S lanes a thread; vector stores where every row starts S-aligned
template <int S, bool MULTI = false>
cudaError_t launch(const Stream& s, const void* heads, const void* sym_t,
                   const void* freq_t, const void* start_t, void* out, int L,
                   int rows, int r, cudaStream_t stream) {
  const bool vec = S > 1 && L % S == 0 && !((uintptr_t)out & (4 * S - 1));
  return vec ? launch_as<S, MULTI, (S > 1)>(s, heads, sym_t, freq_t, start_t,
                                            out, L, rows, r, stream)
             : launch_as<S, MULTI, false>(s, heads, sym_t, freq_t, start_t,
                                          out, L, rows, r, stream);
}

}  // namespace

extern "C" int rans_decode_launch(const void* heads, const void* words,
                                  const void* sym_t, const void* freq_t,
                                  const void* start_t, void* out, int lanes,
                                  int n_words, int rows, int r,
                                  void* stream) {
  if (lanes < 1 || lanes > MAX_LANES || r < 1 || r > 16 || rows < 0 ||
      n_words < 0 || ((uintptr_t)words & 3))
    return (int)cudaErrorInvalidValue;
  Stream s;
  s.words = (const uint32_t*)words;
  s.n_words = n_words;
  s.m = (int)(((uintptr_t)words & 15) / 4);
  s.a0 = std::min(n_words, (4 - s.m) & 3);
  s.a_end = s.a0 + ((n_words - s.a0) & ~3);
  s.n_chunks = n_words ? (n_words + s.m + STAGE - 1) / STAGE : 0;
  cudaStream_t st = (cudaStream_t)stream;
  // up to 64 lanes, one decode warp of S = 1 or 2 lanes a thread; past
  // that, up to MAX_WARPS warps of as few lanes a thread as fit
  const int per_thread = (lanes + 31) / 32;
  cudaError_t err;
  if (per_thread <= 1) {
    err = launch<1>(s, heads, sym_t, freq_t, start_t, out, lanes, rows, r, st);
  } else if (per_thread <= 2) {
    err = launch<2>(s, heads, sym_t, freq_t, start_t, out, lanes, rows, r, st);
  } else {
    const int nw = std::min(MAX_WARPS, per_thread);
    const int per_warp_thread = (per_thread + nw - 1) / nw;
    err = per_warp_thread <= 1
              ? launch<1, true>(s, heads, sym_t, freq_t, start_t, out, lanes,
                                rows, r, st)
          : per_warp_thread <= 2
              ? launch<2, true>(s, heads, sym_t, freq_t, start_t, out, lanes,
                                rows, r, st)
              : launch<4, true>(s, heads, sym_t, freq_t, start_t, out, lanes,
                                rows, r, st);
  }
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
