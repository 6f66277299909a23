// Batched PQ asymmetric-distance (ADC) scan (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `pq_adc_pallas`
// (src/repro/kernels/pq_adc/kernel.py, body `_adc_kernel`) together with
// the `vmap` over per-query tables around it (src/repro/ann/scan.py): for
// lookup tables luts (qb, m, 256) f32 and codes (n, m) u8 write
//
//     out[q, r] = sum_{j < m} luts[q, j, codes[r, j]]      (qb, n) f32
//
// with f32 adds in the order j = 0, 1, ..., m - 1 from 0.0f, so the
// output is bitwise a sequential j-ordered f32 sum.  With `accumulate`
// each sum starts from the value already in out instead of 0.0f: the
// wrapper scores m subquantizers whose tables do not fit one block
// (m >= 228) as chunks of tables, in j order, each launch adding its
// chunk onto the previous one's partial sums, which keeps the result
// bitwise the j-ordered sum over all m.  The TPU kernel turns
// the lookup into a one-hot contraction for the matrix unit; on Hopper
// that would widen the work 256-fold, so this kernel gathers.
//
// What bounds it on an H100: the output sets the byte bound (64 tables,
// m = 8, 2^20 codes: 268 MB written, 8 MB of codes read, about 0.08 ms at
// 3.35 TB/s), but the lookups (qb * n * m = 537 M shared-memory words, at
// 32 words a clock per SM about 0.07 ms conflict-free on 132 SMs) come
// close, and random codes make bank conflicts.  The first design reloaded
// its tables for every 4096-row span (half as many bytes as the output,
// behind a barrier), did 4-byte lookups with ~3.5 lanes on one bank, and
// ran 5.2 waves of blocks.  This design:
//
// * persistent blocks: one block an SM owns one group of QT queries (QT =
//   16 at m = 8, 128 KB of tables, or 8 for arenas under 2^18 rows, where
//   loading the tables would cost more than the halved passes over the
//   codes save) for its whole life and walks an equal share of the rows,
//   so the tables are loaded once a block and there is no wave tail;
// * codes by TMA: a span of rows (32 KB of codes) comes by one bulk copy
//   (`cp.async.bulk` with an mbarrier) into a two-stage ring, the next
//   span loading while this one is scored; codes that are not 16-byte
//   aligned (a view) are copied by the threads into the same ring.  Where
//   the tables leave less room (large m) the spans are shorter, and where
//   not even 16 rows fit, the codes are read from global memory;
// * vector lookups: the tables are stored query-interleaved, each
//   (j, code) entry holding the QT queries' values together, so one
//   16-byte shared load returns four queries' entries.  Tables j and j + 1
//   share each 128-byte line (even j in its first half, odd j in its
//   second).  A thread scores 4 consecutive rows for 4 queries, and the
//   two row groups of a quarter-warp read tables j and j + 1 in opposite
//   orders, so its 8 lanes always cover the line's 8 bank groups: the
//   lookups are free of bank conflicts whatever the codes.  Where m is
//   odd the last table has no partner and is stored alone, code-major,
//   so the tables take m * 256 * QT floats and a single table fits for
//   any m <= 227;
// * streaming stores: each thread writes each query's 4 results as one
//   16-byte `st.global.cs` store (the output is larger than L2); where a
//   query's row does not start on a 16-byte boundary (n % 4 != 0, as the
//   main path's arenas mostly are) the 4 aligned columns are gathered
//   from two row groups by a warp shuffle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int KSUB = 256;
constexpr int RPT = 4;               // rows a thread scores
constexpr int SPAN_BYTES = 32768;    // codes a ring stage holds
constexpr int SMEM_MAX = 232448;     // the most one H100 block may take

template <int V> struct VecT;
template <> struct VecT<1> { using T = float; };
template <> struct VecT<2> { using T = float2; };
template <> struct VecT<4> { using T = float4; };

__device__ __forceinline__ float get(const float& v, int) { return v; }
__device__ __forceinline__ float get(const float2& v, int e) {
  return e ? v.y : v.x;
}
__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

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

__host__ __device__ __forceinline__ int lut_floats(int m, int qt) {
  return m * KSUB * qt;
}

// rows per ring stage for m subquantizers and qt tables: SPAN_BYTES of
// codes (a multiple of 128 rows, at least 128), fewer where the tables
// leave less room, and 0 where not even 16 rows fit: the codes are then
// read from global memory.  A multiple of 16 rows, so every span starts
// 16-byte aligned
__host__ __device__ __forceinline__ int span_rows_of(int m, int qt) {
  const int want = max(128, (SPAN_BYTES / m) & ~127);
  const int room = SMEM_MAX - lut_floats(m, qt) * 4 - 16;
  const int fit = room > 0 ? (room / (2 * m)) & ~15 : 0;
  const int r = min(want, fit);
  return r >= 16 ? r : 0;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int m, int qt) {
  const int rows = span_rows_of(m, qt);
  return (size_t)lut_floats(m, qt) * 4 + (rows ? 2 * (size_t)rows * m + 16
                                               : 0);
}

// rows a trip scores when the codes are read from global memory
constexpr int DIRECT_ROWS = 128;

// where entry (j, code) of the tables lies, in units of QT floats: tables
// 2G and 2G + 1 interleaved code by code, and a last table without a
// partner (odd m) alone
__device__ __forceinline__ int lut_entry(int j, int code, int m) {
  return (j == m - 1 && (m & 1)) ? j * KSUB + code
                                 : ((j >> 1) * KSUB + code) * 2 + (j & 1);
}

template <int QT>
__global__ void __launch_bounds__(THREADS)
pq_adc_kernel(const float* __restrict__ luts,
              const uint8_t* __restrict__ codes, float* __restrict__ out,
              int qb, int n, int m, int blocks_per_group, int rows_per_block,
              int tma, int accumulate) {
  constexpr int VEC = QT < 4 ? QT : 4;     // floats one lookup loads
  constexpr int S = QT / VEC;              // lookups per (j, code) entry
  constexpr int GROUPS = 32 / S;           // row groups of a warp
  constexpr int RG = WARPS * GROUPS;       // row groups of a block
  using V = typename VecT<VEC>::T;

  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ring_rows = span_rows_of(m, QT);
  const bool direct = ring_rows == 0;      // codes from global memory
  const int span_rows = direct ? DIRECT_ROWS : ring_rows;
  const int stage_bytes = direct ? 0 : span_rows * m;
  float* lut = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + lut_floats(m, QT) * 4;
  const uint32_t bars = smem_u32(ring + 2 * stage_bytes);
  if (direct) tma = 0;

  const int group = blockIdx.x / blocks_per_group;
  const int part = blockIdx.x % blocks_per_group;
  const int q0 = group * QT;
  const int r_begin = part * rows_per_block;
  const int r_end = min(n, r_begin + rows_per_block);
  const int nspans =
      r_begin < r_end ? (r_end - r_begin + span_rows - 1) / span_rows : 0;

  // thread 0 copies span s's codes (its 16-byte-multiple prefix) into
  // stage s % 2 and arms that stage's mbarrier
  auto issue = [&](int s) {
    const int r0 = r_begin + s * span_rows;
    const int bytes = min(span_rows, r_end - r0) * m;
    const int tb = bytes & ~15;
    const uint32_t bar = bars + 8 * (s & 1);
    if (tb) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
          "r"(tb)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + (s & 1) * stage_bytes)),
          "l"(codes + (size_t)r0 * m), "r"(tb), "r"(bar)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                   : "memory");
    }
  };

  if (tid == 0 && !direct) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tma && tid == 0)
    for (int s = 0; s < min(2, nspans); ++s) issue(s);

  // the group's tables, query-interleaved: entry (j, code) of query t at
  // float lut_entry(j, code) * QT + t; absent queries 0
  const int tab = m * KSUB;
  for (int e = tid; e < QT * tab; e += THREADS) {
    const int t = e / tab, rem = e - t * tab;
    const int j = rem / KSUB, c = rem - j * KSUB;
    lut[lut_entry(j, c, m) * QT + t] =
        q0 + t < qb ? luts[(size_t)(q0 + t) * tab + rem] : 0.f;
  }
  __syncthreads();

  const int slot = lane % S;               // which VEC queries of the QT
  const int rg_w = lane / S;
  const int x_lane = rg_w & 1;             // table order within a pair
  const int pairs = (m + 1) / 2;
  // 8 codes of a row in one 8-byte load: the ring is aligned, global
  // codes (direct) only where the pointer is
  const bool words = (m & 7) == 0 &&
                     (!direct || (reinterpret_cast<uintptr_t>(codes) & 7) == 0);

  for (int s = 0; s < nspans; ++s) {
    const int r0 = r_begin + s * span_rows;
    const uint8_t* cs =
        direct ? codes + (size_t)r0 * m : ring + (s & 1) * stage_bytes;
    const int rows = min(span_rows, r_end - r0);
    const int bytes = rows * m;
    int from = direct ? bytes : 0;
    if (tma) {
      mbar_wait(bars + 8 * (s & 1), (s >> 1) & 1);
      from = bytes & ~15;
    }
    if (from < bytes) {                    // block-uniform
      uint8_t* dst = ring + (s & 1) * stage_bytes;
      for (int b = from + tid; b < bytes; b += THREADS)
        dst[b] = codes[(size_t)r0 * m + b];
      __syncthreads();
    }

    // warp-uniform trips: the stores below shuffle between row groups
    for (int wr = (tid >> 5) * GROUPS * RPT; wr < rows; wr += RG * RPT) {
      const int rr = wr + rg_w * RPT;
      float acc[RPT][VEC];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
      // a later chunk of tables starts from the earlier chunks' sums.  The
      // stores below may write a next row group's columns, but only after
      // the shuffle that reads its sums, so each value is read first
      if (accumulate) {                    // grid-uniform
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int q = q0 + slot * VEC + e;
          if (q >= qb) continue;
          const float* o = out + (size_t)q * n + r0 + rr;
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            if (rr + i < rows) acc[i][e] = __ldcs(o + i);
        }
      }

      // one pair of tables (2G, 2G + 1) given the codes of the 4 rows
      auto pair = [&](int G, const uint32_t (&c)[RPT][2]) {
        const bool two = 2 * G + 1 < m;
        const int x = two ? x_lane : 0;
        V v[RPT][2];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            if (pp == 1 && !two) continue;
            const int p = pp ^ x;          // table 2G + p
            const uint32_t code = p ? c[i][1] : c[i][0];
            const int at = two ? (G * KSUB + code) * 2 + p
                               : 2 * G * KSUB + code;
            v[i][pp] = *reinterpret_cast<const V*>(lut + at * QT + slot * VEC);
          }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const V a = x ? v[i][1] : v[i][0];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] += get(a, e);
          if (two) {
            const V b = x ? v[i][0] : v[i][1];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] += get(b, e);
          }
        }
      };

      if (words) {
        for (int jb = 0; jb < m; jb += 8) {
          uint2 w[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            w[i] = rr + i < rows
                       ? *reinterpret_cast<const uint2*>(cs + (rr + i) * m + jb)
                       : make_uint2(0u, 0u);
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            uint32_t c[RPT][2];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const uint32_t word = h < 2 ? w[i].x : w[i].y;
              c[i][0] = (word >> (16 * (h & 1))) & 255u;
              c[i][1] = (word >> (16 * (h & 1) + 8)) & 255u;
            }
            pair(jb / 2 + h, c);
          }
        }
      } else {
        for (int G = 0; G < pairs; ++G) {
          uint32_t c[RPT][2];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const bool ok = rr + i < rows;
            c[i][0] = ok ? cs[(rr + i) * m + 2 * G] : 0u;
            c[i][1] = ok && 2 * G + 1 < m ? cs[(rr + i) * m + 2 * G + 1] : 0u;
          }
          pair(G, c);
        }
      }

      // 16-byte stores need 16-byte-aligned columns: where a query's row
      // starts off a multiple of 4 (n % 4 != 0), a thread writes the
      // aligned 4 that start inside its rows, the last of them from the
      // next row group (a shuffle); the first row group of a warp adds its
      // leading columns, and where no next row group follows, a thread
      // writes its own trailing columns one by one
      const int r = r0 + rr;
      const bool last_rg = rg_w == GROUPS - 1;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float nx[RPT - 1] = {};
        if (n & 3) {                       // block-uniform
#pragma unroll
          for (int j = 0; j < RPT - 1; ++j)
            nx[j] = __shfl_down_sync(0xffffffffu, acc[j][e], S);
        }
        const int q = q0 + slot * VEC + e;
        if (q >= qb || rr >= rows) continue;
        float* o = out + (size_t)q * n + r;
        auto put = [&](int i, float v) {
          if (rr + i < rows) __stcs(o + i, v);
        };
        const int lead = (4 - (int)(((size_t)q * n) & 3)) & 3;
        if (lead == 0 && rr + RPT <= rows) {
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]));
          continue;
        }
        if (lead == 0) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) put(i, acc[i][e]);
          continue;
        }
        if (rg_w == 0) {
#pragma unroll
          for (int i = 0; i < RPT - 1; ++i)
            if (i < lead) put(i, acc[i][e]);
        }
        if (!last_rg && rr + RPT + lead <= rows) {
          const float4 t =
              lead == 1 ? make_float4(acc[1][e], acc[2][e], acc[3][e], nx[0])
              : lead == 2 ? make_float4(acc[2][e], acc[3][e], nx[0], nx[1])
                          : make_float4(acc[3][e], nx[0], nx[1], nx[2]);
          __stcs(reinterpret_cast<float4*>(o + lead), t);
        } else {
#pragma unroll
          for (int i = 1; i < RPT; ++i)
            if (i >= lead) put(i, acc[i][e]);
          if (!last_rg) {
#pragma unroll
            for (int j = 0; j < RPT - 1; ++j)
              if (j < lead) put(RPT + j, nx[j]);
          }
        }
      }
    }

    // every thread is done with this stage: it may be refilled
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tma && tid == 0 && s + 2 < nspans) issue(s + 2);
  }
}

// the kernel's registers, its shared-memory limit and the SM count
struct LaunchInfo {
  int sms = 0, by_regs = 1;
  cudaError_t err = cudaSuccess;
};

template <int QT>
LaunchInfo launch_info() {
  LaunchInfo info;
  auto kernel = pq_adc_kernel<QT>;
  cudaFuncAttributes attr;
  if ((info.err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
    return info;
  info.by_regs = max(1, 65536 / (max(1, attr.numRegs) * THREADS));
  if ((info.err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)) !=
      cudaSuccess)
    return info;
  int dev = 0;
  if ((info.err = cudaGetDevice(&dev)) != cudaSuccess) return info;
  info.err = cudaDeviceGetAttribute(&info.sms,
                                    cudaDevAttrMultiProcessorCount, dev);
  return info;
}

template <int QT>
int launch(const float* luts, const uint8_t* codes, float* out, int qb, int n,
           int m, int accumulate, cudaStream_t stream) {
  const size_t smem = smem_bytes(m, QT);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = pq_adc_kernel<QT>;
  // read once, by the first launch: a function-local static is initialised
  // exactly once even when several threads launch at the same time (C++11),
  // and no call that stream capture refuses sits between launches
  static const LaunchInfo info = launch_info<QT>();
  if (info.err != cudaSuccess) return (int)info.err;
  const int sms = info.sms, by_regs = info.by_regs;
  // one wave (one block an SM at the main path's m, where the tables take
  // most of its shared memory): every query group gets an equal share of
  // the resident blocks, and each block an equal share of the rows
  // (128-row multiples)
  const int groups = (qb + QT - 1) / QT;
  const int row_tiles = (n + 127) / 128;
  const int per_sm = max(1, min(by_regs, (int)(SMEM_MAX / smem)));
  int bpg = max(1, per_sm * sms / groups);
  bpg = min(bpg, row_tiles);
  const int rows_per_block = (row_tiles + bpg - 1) / bpg * 128;
  bpg = (n + rows_per_block - 1) / rows_per_block;
  const int tma = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  kernel<<<groups * bpg, THREADS, smem, stream>>>(
      luts, codes, out, qb, n, m, bpg, rows_per_block, tma, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// qt: queries a block holds (16, 8, 4, 2 or 1; the wrapper picks the
// largest whose tables fit); accumulate: add onto the sums already in out
extern "C" int pq_adc_launch(const void* luts, const void* codes, void* out,
                             int qb, int n, int m, int qt, int accumulate,
                             void* stream) {
  const float* l = (const float*)luts;
  const uint8_t* c = (const uint8_t*)codes;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (qt) {
    case 16: return launch<16>(l, c, o, qb, n, m, accumulate, st);
    case 8: return launch<8>(l, c, o, qb, n, m, accumulate, st);
    case 4: return launch<4>(l, c, o, qb, n, m, accumulate, st);
    case 2: return launch<2>(l, c, o, qb, n, m, accumulate, st);
    case 1: return launch<1>(l, c, o, qb, n, m, accumulate, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
