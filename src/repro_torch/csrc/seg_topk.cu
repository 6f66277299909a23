// Segmented top-k select over padded distance rows (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `seg_topk_pallas`
// (src/repro/kernels/seg_topk/kernel.py, body `_seg_topk_kernel`): for
// dists (nq, n) f32 and lens (nq,) i32, return for each row the k smallest
// (value, column) pairs in lexicographic order, ascending.  Columns at or
// past min(lens[i], n) count as +inf; when k > n the row is widened with
// +inf columns n..k-1.  Ties, +inf included, go to the lower column.
//
// Keys.  Each value becomes an ordered u32 (the sign-flip map) after -0.0
// is made +0.0, and every NaN, whatever its sign and payload, becomes
// 0xffffffff, one key above +inf (0xff800000): NaNs sort last and tie by
// column, as the stable sort of the plain version puts them.  The column
// breaks ties, so (key << 32 | column) is one unique u64 per element and
// the result does not depend on how the work is split.  The value written
// back is the row's own value, so -0.0 stays -0.0 and a NaN keeps its bits.
//
// What bounds it on an H100: at the main path's shapes (1M vectors,
// nprobe = 16: 64 rows padded to 131072 or 262144 candidates, k = 32 ..
// 2048; k = n on the retry path's worst case) it reads each row's live
// prefix, at most 34 or 67 MB, at most 10 or 20 microseconds at 3.35
// TB/s, but a row is one cluster's work, so it is
// latency-bound: the cost is the number of block-wide steps.  The first
// design ran k sequential rounds of a block-wide minimum (cost linear in
// k).  This one is a radix select whose step count hardly grows with k:
//
// 1. stage: a cluster of blocks of 1024 threads a row loads its share of
//    the row's live prefix once, with 16-byte loads, as keys in shared
//    memory (up to 32768 columns, 128 KB a block).  The cluster has as
//    many blocks as staging needs (4 at n = 131072, 8 at 262144), doubled
//    while the rows' blocks fit the SMs in one wave (2 for 64 rows of
//    16384 or 32768).  Rows wider than 8 x 32768 columns are not staged:
//    each pass reads the keys from global memory (L2).  Padding columns
//    are never materialised: their count enters the +inf bin;
// 2. select: up to four 8-bit digit passes (most significant first) find
//    the k-th smallest key v*.  Each block counts the keys that match the
//    digits chosen so far into 8 sub-histograms with shared-memory
//    atomics (measured faster on the card than __match_any_sync
//    aggregation, also on all-tied rows); the leader block adds the
//    blocks' histograms through distributed shared memory, scans the 256
//    bins and picks the digit.  The passes stop as soon as the matching
//    keys are all taken, or fit the sort with the keys below them;
// 3. collect: every block writes the keys below the cut, then the matching
//    keys, into the leader's buffer (remote atomics give the slots).
//    Where the matching keys do not all fit the sort (ties of v*), the
//    first k - count(< v*) in column order are taken: a ballot and a
//    prefix of per-warp counts over warps and blocks.  Padding columns
//    follow the real ones by arithmetic.  No float atomics; the same
//    result every run;
// 4. sort: the leader sorts the selected u64 keys with a bitonic network
//    held in registers: strides under 32 are warp shuffles, strides of
//    1024 and more a thread's own registers, and only the strides between
//    go through shared memory, one barrier each.  Above 4096 entries (the
//    retry path's k = n) the buffer is a global scratch array that the
//    wrapper allocates, sorted 4096-entry chunk by chunk, the larger
//    strides in global memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int SUBH = 8;            // sub-histograms, WARPS / SUBH warps each
constexpr int CHUNK = 4096;        // u64 entries sorted in shared memory
constexpr int STAGE_MAX = 32768;   // columns staged in shared memory
constexpr int CLUSTER_MAX = 8;     // blocks a row at most (portable size)
constexpr int SLICE_MIN = 4096;    // columns a block at least, when split
constexpr uint32_t INF_KEY = 0xff800000u;
constexpr uint32_t NAN_KEY = 0xffffffffu;
constexpr unsigned long long SENTINEL = ~0ull;
// two sets of sub-histograms fit in the sort chunk's 32 KB
static_assert(2 * SUBH * RADIX * 4 <= CHUNK * 8, "hist and chunk share memory");
static_assert(WARPS % SUBH == 0, "warps share sub-histograms evenly");
static_assert(CHUNK / THREADS <= 4, "a chunk is at most 4 entries a thread");

__device__ __forceinline__ uint32_t key_of(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return NAN_KEY;   // any NaN
  if ((u << 1) == 0u) u = 0u;                             // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long entry(uint32_t key, int col) {
  return ((unsigned long long)key << 32) | (uint32_t)col;
}

__device__ __forceinline__ uint32_t lanes_below() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// one step of a bitonic sort of `cnt` entries of `a` (a power of two):
// compare-exchange (lo, lo + stride) ascending where bit `size` of the
// global index g0 + lo is 0, descending where it is 1
__device__ __forceinline__ void bitonic_step(unsigned long long* a, int cnt,
                                             int g0, int size, int stride) {
  for (int p = threadIdx.x; p < cnt / 2; p += THREADS) {
    const int lo = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
    const int hi = lo + stride;
    const bool up = ((g0 + lo) & size) == 0;
    const unsigned long long x = a[lo], y = a[hi];
    if ((x > y) == up) {
      a[lo] = y;
      a[hi] = x;
    }
  }
}

// a bitonic compare-exchange of entries e and e + J of every thread, in
// registers (entry e of thread t has index i0 + e * THREADS)
template <int E, int J>
__device__ __forceinline__ void reg_step(unsigned long long (&x)[E], int i0,
                                         int size) {
#pragma unroll
  for (int e = 0; e < E; ++e)
    if ((e & J) == 0) {
      const bool up = ((i0 + e * THREADS) & size) == 0;
      const unsigned long long a = x[e], b = x[e + J];
      if ((a > b) == up) {
        x[e] = b;
        x[e + J] = a;
      }
    }
}

// bitonic stages size_lo..size_hi (strides from min(size, cnt) / 2 down
// to 1) over cnt entries held E a thread: entry e of thread t is io[e *
// THREADS + t], global index g0 + e * THREADS + t (which sets each
// stage's direction).  Strides of THREADS and more are exchanges between a
// thread's own registers, strides under 32 shuffles inside a warp, and
// only the strides between are done in shared memory s, one block-wide
// barrier each.  io may be s, or global memory.
template <int E>
__device__ void bitonic(unsigned long long* io, unsigned long long* s,
                        int cnt, int g0, int size_lo, int size_hi) {
  const int t = threadIdx.x;
  const bool active = t < cnt;       // warp-uniform: cnt % 32 == 0
  unsigned long long x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = active ? io[e * THREADS + t] : SENTINEL;
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    int stride = min(size, cnt) >> 1;
    if constexpr (E > 2) {
      if (stride >= 2 * THREADS) {
        reg_step<E, 2>(x, g0 + t, size);
        stride >>= 1;
      }
    }
    if constexpr (E > 1) {
      if (stride >= THREADS) {
        reg_step<E, 1>(x, g0 + t, size);
        stride >>= 1;
      }
    }
    if (stride >= 32) {
      if (active)
#pragma unroll
        for (int e = 0; e < E; ++e) s[e * THREADS + t] = x[e];
      __syncthreads();
      for (; stride >= 32; stride >>= 1) {
        bitonic_step(s, cnt, g0, size, stride);
        __syncthreads();
      }
      if (active)
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = s[e * THREADS + t];
      __syncthreads();
    }
    if (active)
      for (; stride > 0; stride >>= 1)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned long long y = __shfl_xor_sync(0xffffffffu, x[e],
                                                       stride);
          const bool up = ((g0 + e * THREADS + t) & size) == 0;
          const bool low = (t & stride) == 0;
          x[e] = (low == up) ? (x[e] < y ? x[e] : y) : (x[e] < y ? y : x[e]);
        }
  }
  if (active)
#pragma unroll
    for (int e = 0; e < E; ++e) io[e * THREADS + t] = x[e];
}

__global__ void __launch_bounds__(THREADS, 1)
seg_topk_kernel(const float* __restrict__ d, const int* __restrict__ lens,
                float* __restrict__ vals, int* __restrict__ idx,
                unsigned long long* __restrict__ scratch, int n, int k,
                int kpad, int staged, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t warp_sum[WARPS];
  __shared__ uint32_t part[RADIX];   // this block's histogram of a pass
  __shared__ uint32_t chosen[3];     // digit, rank left in it, its count
  __shared__ uint32_t n_lt, n_eq, block_eq;
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool leader = rank == 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = blockIdx.x / nblk;
  const float* row = d + (size_t)r * n;
  const int len = max(0, min(lens[r], n));
  const int ncols = max(n, k);
  const int pad = ncols - len;       // implicit +inf columns len..ncols-1
  // this block's share of the live columns: [c_begin, c_end)
  const int slice = ((len + nblk - 1) / nblk + 3) & ~3;
  const int c_begin = min(len, rank * slice);
  const int c_end = min(len, c_begin + slice);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  unsigned long long* chunk =
      reinterpret_cast<unsigned long long*>(smem + stage_bytes);
  uint32_t* hists = reinterpret_cast<uint32_t*>(chunk);   // 2 x SUBH x RADIX
  uint32_t* lead_chosen = cluster.map_shared_rank(chosen, 0);

  // ---- 1. stage this block's columns as keys ----------------------------
  if (staged) {
    const float* src = row + c_begin;
    const int cnt = c_end - c_begin;
    int c = 0;
    if (((reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int i = tid; i < (cnt >> 2); i += THREADS) {
        const float4 v = __ldg(src4 + i);
        reinterpret_cast<uint4*>(keys)[i] =
            make_uint4(key_of(v.x), key_of(v.y), key_of(v.z), key_of(v.w));
      }
      c = cnt & ~3;
    }
    for (c += tid; c < cnt; c += THREADS) keys[c] = key_of(__ldg(src + c));
  }
  auto key_at = [&](int c) -> uint32_t {
    return staged ? keys[c - c_begin] : key_of(__ldg(row + c));
  };
  for (int i = tid; i < 2 * SUBH * RADIX; i += THREADS) hists[i] = 0;
  if (tid == 0) n_lt = n_eq = 0;
  cluster.sync();

  // ---- 2. radix select of the k-th smallest key ------------------------
  // each block counts its columns into hist set pass % 2 and sums its
  // sub-histograms into `part`; the leader adds every block's `part` (and
  // the padding), picks the digit, and every block reads the choice from
  // the leader.  The other hist set is cleared meanwhile for the next pass.
  // The passes stop once the keys that match (count) are all taken, or
  // they and the keys below them (k - need) fit the sort (kcap entries).
  const int kcap = max(kpad, 32);
  uint32_t prefix = 0, mask = 0;     // digits chosen so far
  int need = k;                      // rank of the k-th key among matches
  int count = ncols;                 // keys matching prefix under mask
  for (int pass = 0; pass < 4 && count != need && k - need + count > kcap;
       ++pass) {
    const int shift = 24 - 8 * pass;
    uint32_t* hset = hists + (pass & 1) * SUBH * RADIX;
    uint32_t* wh = hset + (warp % SUBH) * RADIX;
    for (int c0 = c_begin; c0 < c_end; c0 += THREADS) {
      const int c = c0 + tid;
      const uint32_t key = c < c_end ? key_at(c) : 0u;
      if (c < c_end && (key & mask) == prefix)
        atomicAdd(wh + ((key >> shift) & 255u), 1u);
    }
    __syncthreads();
    if (tid < RADIX) {
      uint32_t tot = 0;
#pragma unroll
      for (int w = 0; w < SUBH; ++w) tot += hset[w * RADIX + tid];
      part[tid] = tot;
    } else {
      uint32_t* other = hists + ((pass + 1) & 1) * SUBH * RADIX;
      for (int i = tid - RADIX; i < SUBH * RADIX; i += THREADS - RADIX)
        other[i] = 0;
    }
    cluster.sync();
    if (leader && tid < RADIX) {
      uint32_t tot = 0;
      for (int b = 0; b < nblk; ++b) tot += cluster.map_shared_rank(part, b)[tid];
      if (pad && (INF_KEY & mask) == prefix &&
          ((INF_KEY >> shift) & 255u) == (uint32_t)tid)
        tot += pad;
      uint32_t inc = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
      }
      if (lane == 31) warp_sum[warp] = inc;
      asm volatile("bar.sync 1, %0;" ::"n"(RADIX) : "memory");
      for (int w = 0; w < warp; ++w) inc += warp_sum[w];
      const uint32_t exc = inc - tot;
      if (exc < (uint32_t)need && (uint32_t)need <= inc) {
        chosen[0] = tid;
        chosen[1] = need - exc;
        chosen[2] = tot;
      }
    }
    cluster.sync();
    prefix |= lead_chosen[0] << shift;
    mask |= 255u << shift;
    need = lead_chosen[1];
    count = lead_chosen[2];
  }

  // ---- 3. collect: keys below the cut, then the matching keys ----------
  // every block writes its selected keys into the leader's buffer: keys
  // with (key & mask) < prefix (k - need of them, in any slot: the sort
  // orders them), then keys == prefix.  Where they all fit the sort
  // (count of them) they are taken in any order too, and the sort keeps
  // the first k.  Otherwise (ties of v* past the sort's size) the first
  // `need` in column order are taken: each warp owns a contiguous run of
  // its block's columns and counts its equal keys, and a prefix of the
  // counts over the warps and the blocks gives each warp its first rank.
  unsigned long long* lead_buf =
      kpad <= CHUNK ? cluster.map_shared_rank(chunk, 0)
                    : scratch + (size_t)r * kpad;
  uint32_t* lead_lt = cluster.map_shared_rank(&n_lt, 0);
  uint32_t* lead_eq = cluster.map_shared_rank(&n_eq, 0);
  const int below = k - need;
  const bool ordered = count > need && below + count > kcap;
  const int take = ordered ? need : count;   // keys == prefix taken
  const int run = ((c_end - c_begin + WARPS - 1) / WARPS + 31) & ~31;
  const int w_lo = min(c_end, c_begin + warp * run);
  const int w_hi = min(c_end, w_lo + run);
  int my_eq = 0;
  for (int c0 = w_lo; c0 < w_hi; c0 += 32) {
    const int c = c0 + lane;
    const uint32_t key = c < w_hi ? key_at(c) : 0u;
    const uint32_t km = key & mask;
    const bool lt = c < w_hi && km < prefix;
    const bool eq = c < w_hi && km == prefix;
    const uint32_t lb = __ballot_sync(0xffffffffu, lt);
    const uint32_t eb = __ballot_sync(0xffffffffu, eq);
    if (lb) {
      uint32_t base = 0;
      if (lane == 0) base = atomicAdd(lead_lt, __popc(lb));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (lt) lead_buf[base + __popc(lb & lanes_below())] = entry(key, c);
    }
    if (ordered) {
      my_eq += __popc(eb);
    } else if (eb) {
      uint32_t base = 0;
      if (lane == 0) base = atomicAdd(lead_eq, __popc(eb));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (eq)
        lead_buf[below + base + __popc(eb & lanes_below())] = entry(key, c);
    }
  }
  int eq_real = 0;                   // equal keys among the real columns
  if (ordered) {                     // block-uniform
    if (lane == 0) warp_sum[warp] = my_eq;
    __syncthreads();
    if (tid == 0) {
      int t = 0;
      for (int w = 0; w < WARPS; ++w) t += warp_sum[w];
      block_eq = t;
    }
    cluster.sync();
    int pos = 0;                     // this warp's first rank
    for (int b = 0; b < nblk; ++b) {
      const int x = *cluster.map_shared_rank(&block_eq, b);
      pos += b < rank ? x : 0;
      eq_real += x;
    }
    for (int w = 0; w < warp; ++w) pos += warp_sum[w];
    for (int c0 = w_lo; c0 < w_hi && pos < need; c0 += 32) {
      const int c = c0 + lane;
      const uint32_t key = c < w_hi ? key_at(c) : 0u;
      const bool eq = c < w_hi && (key & mask) == prefix;
      const uint32_t eb = __ballot_sync(0xffffffffu, eq);
      const int my = pos + __popc(eb & lanes_below());
      if (eq && my < need) lead_buf[below + my] = entry(key, c);
      pos += __popc(eb);
    }
  }
  // every block's writes are in the leader's buffer; the others are done
  cluster.sync();
  if (!leader) return;
  if (!ordered) eq_real = n_eq;
  unsigned long long* buf = kpad <= CHUNK ? chunk : lead_buf;
  if (pad) {
    const uint32_t km = INF_KEY & mask;
    if (km < prefix) {               // every padding column is below the cut
      const int base = n_lt;
      for (int j = tid; j < pad; j += THREADS)
        buf[base + j] = entry(INF_KEY, len + j);
    } else if (km == prefix) {       // padding continues the equal run
      for (int j = tid; j < pad && eq_real + j < take; j += THREADS)
        buf[below + eq_real + j] = entry(INF_KEY, len + j);
    }
  }
  const int total = below + take;    // entries to sort, k or more
  int nsort = 32;                    // a power of two, at least a warp
  while (nsort < total) nsort <<= 1;
  for (int s = total + tid; s < nsort; s += THREADS) buf[s] = SENTINEL;
  __syncthreads();

  // ---- 4. sort the leader's entries ascending ---------------------------
  if (nsort <= THREADS) {
    bitonic<1>(buf, chunk, nsort, 0, 2, nsort);
  } else if (nsort <= CHUNK) {
    if (nsort == 2 * THREADS)
      bitonic<2>(buf, chunk, nsort, 0, 2, nsort);
    else
      bitonic<CHUNK / THREADS>(buf, chunk, nsort, 0, 2, nsort);
  } else {
    // every chunk sorted in turn, then each larger stage's strides of
    // CHUNK and more in global memory and the rest chunk by chunk
    for (int c0 = 0; c0 < nsort; c0 += CHUNK)
      bitonic<CHUNK / THREADS>(buf + c0, chunk, CHUNK, c0, 2, CHUNK);
    __syncthreads();
    for (int size = 2 * CHUNK; size <= nsort; size <<= 1) {
      for (int stride = size >> 1; stride >= CHUNK; stride >>= 1) {
        bitonic_step(buf, nsort, 0, size, stride);
        __syncthreads();
      }
      for (int c0 = 0; c0 < nsort; c0 += CHUNK)
        bitonic<CHUNK / THREADS>(buf + c0, chunk, CHUNK, c0, size, size);
      __syncthreads();
    }
  }
  __syncthreads();

  for (int s = tid; s < k; s += THREADS) {
    const int col = (int)(uint32_t)buf[s];
    vals[(size_t)r * k + s] = col < len ? row[col] : __int_as_float(0x7f800000);
    idx[(size_t)r * k + s] = col;
  }
}

// the kernel's shared-memory limit set to the most any launch takes, and
// the SM count
struct SmCount {
  int sms = 0;
  cudaError_t err = cudaSuccess;
};

SmCount sm_count() {
  SmCount info;
  if ((info.err = cudaFuncSetAttribute(
           seg_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           STAGE_MAX * 4 + CHUNK * 8)) != cudaSuccess)
    return info;
  int dev = 0;
  if ((info.err = cudaGetDevice(&dev)) != cudaSuccess) return info;
  info.err = cudaDeviceGetAttribute(&info.sms,
                                    cudaDevAttrMultiProcessorCount, dev);
  return info;
}

}  // namespace

// scratch: (nq, kpad) u64 when kpad > 4096 (kpad = next power of two >= k),
// else unused and may be null
extern "C" int seg_topk_launch(const void* d, const void* lens, void* vals,
                               void* idx, void* scratch, int nq, int n, int k,
                               void* stream) {
  int kpad = 2;
  while (kpad < k) kpad <<= 1;
  if (kpad > CHUNK && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // the most any launch takes, and the SM count, once, by the first
  // launch: a function-local static is initialised exactly once even when
  // several threads launch at the same time (C++11), and no call that
  // stream capture refuses sits between launches
  static const SmCount info = sm_count();
  if (info.err != cudaSuccess) return (int)info.err;
  const int sms = info.sms;
  // a cluster of blocks a row: enough to stage the row, then doubled
  // while the rows' blocks still fit the SMs in one wave and each keeps
  // SLICE_MIN columns or more (two a row for 64 rows of 16384 or 32768)
  int nblk = min(CLUSTER_MAX, (n + STAGE_MAX - 1) / STAGE_MAX);
  while (nblk < CLUSTER_MAX && 2 * nblk * nq <= sms &&
         n / (2 * nblk) >= SLICE_MIN)
    nblk *= 2;
  nblk = max(1, nblk);
  const int cols = ((n + nblk - 1) / nblk + 3) & ~3;
  const int staged = cols <= STAGE_MAX;
  const int stage_bytes = staged ? cols * 4 : 0;
  const size_t smem = (size_t)stage_bytes + CHUNK * 8;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nq * nblk);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, seg_topk_kernel, (const float*)d, (const int*)lens, (float*)vals,
      (int*)idx, (unsigned long long*)scratch, n, k, kpad, staged,
      stage_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
