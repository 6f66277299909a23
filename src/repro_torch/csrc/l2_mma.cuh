// The split-TF32 tensor-core tile loop shared by l2_dist.cu and l2_top1.cu
// (Hopper, sm_90a).
//
// Both kernels need dot products q_i . a_j of f32 rows held to the scan's
// f32 contraction band (`rescore_eps`, repro_torch/ann/scan.py).  One pass
// of TF32 leaves that band (up to ~8x it when every rounding goes one way),
// so each f32 x is split into two TF32 words,
//
//     hi = rna_tf32(x),   lo = rna_tf32(x - hi)   (lo = 0 if x is not
//                                                  finite),
//
// and a dot product is (hi_q . lo_a + lo_q . hi_a) + hi_q . hi_a, three
// TF32 products with f32 accumulation, the small ones first and lo . lo
// dropped: under 0.5% of the band (tests/test_torch_split_tf32.py).
//
// The tile.  A block owns BM = 64 * WGM rows of q (one 64-row slab per
// warpgroup) and walks 128-wide tiles of a second row set a (arena rows or
// centroids) over the depth d in chunks of BK = 8, one k8 step (ragged
// rows and depth are zero-filled, which preserves dot products and
// norms).  Per chunk c:
//
//   1. wait on the chunk's mbarrier: thread 0 issued two TMA loads for it
//      (the q box and the a box, f32, rows of 8 values, swizzled) P - 1
//      chunks earlier into a ring of P raw stages;
//   2. split: one thread per staged row reads its f32 values (the swizzle
//      keeps these 16-byte reads free of bank conflicts), adds their
//      squares to the row's norm (fmaf, k ascending), and writes hi and lo
//      into a ring of 3 split stages in the no-swizzle K-major layout that
//      `wgmma` reads: core matrices of 8 rows x 16 bytes, 128 B apart
//      along k (LBO) and 256 B apart along rows (SBO);
//   3. fence.proxy.async; one barrier; thread 0 starts the TMA loads of
//      chunk c + P - 1 into the raw stage chunk c - 1 used; each
//      warpgroup issues wgmma.m64n128k8.f32.tf32.tf32 for hi.lo, lo.hi,
//      then hi.hi (A and B by descriptor), commits, and
//      waits only for chunk c - 1's group, so the next chunk's split runs
//      while these MMAs do.  Three split stages make one barrier a chunk
//      enough: a stage is written again only after every warpgroup has
//      waited for the MMAs that read it.
//
// Rows that are not 16-byte aligned (d % 4 != 0) take 4-byte `cp.async`
// copies into the same raw layout instead of TMA, and arrive on the same
// mbarrier.  After a tile's last chunk the caller's epilogue gets the 64
// accumulators in the wgmma f32 fragment (rows 16 * warp + lane / 4 + 8 h,
// columns 8 j + 2 (lane % 4) + e at index 4 j + 2 h + e) and the tile's
// row norms (q rows, then a rows).  No split-K and no atomics: every
// output has one fixed accumulation order, so results are the same bit
// for bit from run to run.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace l2mma {

constexpr int BN = 128;  // a rows per tile (the wgmma n)
constexpr int BK = 8;    // depth per chunk: one k8 step; smaller chunks
                         // keep two blocks on an SM
constexpr int S = 3;     // split stages

// WGM warpgroups, P raw stages
template <int WGM, int P>
struct Tile {
  static constexpr int NP = P;
  static constexpr int BM = 64 * WGM;          // q rows per block
  static constexpr int R = BM + BN;            // rows staged per chunk
  static constexpr int THREADS = 128 * WGM;
  static constexpr int RPT = (R + THREADS - 1) / THREADS;  // rows to split
  static constexpr int RAW = R * BK;           // floats of a raw stage
  static constexpr int HALF = R * BK;          // floats of hi (or lo)
  static constexpr int SPLIT = 2 * HALF + R;   // hi, lo, the row norms
  static constexpr int FLOATS = P * RAW + S * SPLIT;
  // dynamic shared memory: 1 KB of alignment slack, stages, mbarriers
  static constexpr size_t SMEM = 1024 + sizeof(float) * FLOATS + 8 * P;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// float offset of 16-byte unit u (k = 4u .. 4u + 3 of the chunk) of row r
// in a split stage: core matrix (r / 8, u), row r % 8
__device__ __forceinline__ int core_off(int r, int u) {
  return (r >> 3) * 64 + u * 32 + (r & 7) * 4;
}

// float offset of 16-byte unit u of row r in a raw stage: 32-byte rows,
// the units swapped on every other group of 4 rows by the TMA's 32-byte
// swizzle (address bit 4 xor bit 7)
__device__ __forceinline__ int raw_off(int r, int u) {
  return r * BK + 4 * (u ^ ((r >> 2) & 1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// round to TF32 (nearest, ties away from zero) on the f32 bits, as
// cvt.rna.tf32.f32 does for finite x
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo) with x = hi + lo up to lo's own rounding; where x is not
// finite, hi = x and lo = 0, so inf stays inf and does not become NaN
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const bool fin = isfinite(x);
  hi = fin ? tf32_rna(x) : __float_as_uint(x);
  lo = fin ? tf32_rna(__fsub_rn(x, __uint_as_float(hi))) : 0u;
}

// wgmma shared-memory descriptor: no swizzle, LBO 128 B, SBO 256 B
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A . B^T for a 64 x 8 A tile and a 128 x 8 B tile, both TF32 and
// K-major in shared memory; scale_d = 0 starts the sum from zero
__device__ __forceinline__ void mma_m64n128k8(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The tile loop.  q (nq, d) rows q0 .. q0 + BM - 1 against a (na, d) rows
// n_begin .. n_end - 1 in 128-wide tiles; after each tile's last chunk,
// epi(acc, n0, norms).  VEC: q_map and a_map are TMA maps of q and a with
// boxes of (BK, BM) and (BK, 128) (make_map); else 4-byte copies.
// smem_base is T::SMEM bytes of dynamic shared memory.
template <class T, bool VEC, class Epi>
__device__ __forceinline__ void run(const CUtensorMap* q_map,
                                    const CUtensorMap* a_map,
                                    const float* __restrict__ q,
                                    const float* __restrict__ a, int nq,
                                    int na, int d, int q0, int n_begin,
                                    int n_end, char* smem_base, Epi&& epi) {
  constexpr int R = T::R, BM = T::BM, P = T::NP;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  float* raw = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_base) + 1023) & ~uintptr_t(1023));
  float* splits = raw + P * T::RAW;
  const uint32_t bars = smem_u32(splits + S * T::SPLIT);  // P mbarriers
  const int cpt = (d + BK - 1) / BK;                      // chunks per tile
  const int total = (n_end - n_begin + BN - 1) / BN * cpt;

  if (tid == 0)
    for (int s = 0; s < P; ++s) mbar_init(bars + 8 * s, VEC ? 1 : T::THREADS);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  auto load = [&](int c) {
    if (c >= total) return;
    const int n0 = n_begin + c / cpt * BN;
    const int k0 = c % cpt * BK;
    float* st = raw + c % P * T::RAW;
    const uint32_t bar = bars + 8 * (c % P);
    if (VEC) {
      if (tid == 0) {
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar),
            "r"(T::RAW * 4)
            : "memory");
        tma_load(smem_u32(st), q_map, k0, q0, bar);
        tma_load(smem_u32(st + BM * BK), a_map, k0, n0, bar);
      }
    } else {
      for (int e = tid; e < R * BK; e += T::THREADS) {
        const int r = e / BK, kk = e % BK, k = k0 + kk;
        const int g = r < BM ? q0 + r : n0 + r - BM;
        const bool ok = (r < BM ? g < nq : g < na) && k < d;
        const float* src = (r < BM ? q : a) + (size_t)g * d + k;
        cp_async4(smem_u32(st + raw_off(r, kk >> 2) + (kk & 3)),
                  ok ? src : q, ok ? 4 : 0);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                       "r"(bar)
                   : "memory");
    }
  };

  float nrm[T::RPT];
#pragma unroll
  for (int i = 0; i < T::RPT; ++i) nrm[i] = 0.f;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int c = 0; c < P - 1; ++c) load(c);

  int c = 0;  // chunks started, over all tiles
  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    for (int kc = 0; kc < cpt; ++kc, ++c) {
      mbar_wait(bars + 8 * (c % P), (c / P) & 1);
      const float* in = raw + c % P * T::RAW;
      float* out = splits + c % S * T::SPLIT;
#pragma unroll
      for (int i = 0; i < T::RPT; ++i) {
        const int r = tid + i * T::THREADS;
        if (r < R) {
#pragma unroll
          for (int u = 0; u < BK / 4; ++u) {
            const float4 x =
                *reinterpret_cast<const float4*>(in + raw_off(r, u));
            nrm[i] = fmaf(x.x, x.x, nrm[i]);
            nrm[i] = fmaf(x.y, x.y, nrm[i]);
            nrm[i] = fmaf(x.z, x.z, nrm[i]);
            nrm[i] = fmaf(x.w, x.w, nrm[i]);
            uint4 hi, lo;
            split(x.x, hi.x, lo.x);
            split(x.y, hi.y, lo.y);
            split(x.z, hi.z, lo.z);
            split(x.w, hi.w, lo.w);
            const int o = core_off(r, u);
            *reinterpret_cast<uint4*>(out + o) = hi;
            *reinterpret_cast<uint4*>(out + T::HALF + o) = lo;
          }
          if (kc == cpt - 1) {
            out[2 * T::HALF + r] = nrm[i];
            nrm[i] = 0.f;
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // the split chunk and the norms are visible; raw stage c - 1 is read
      // by all; every warpgroup waited for chunk c - 2's MMAs
      __syncthreads();
      load(c + P - 1);

      const uint32_t base = smem_u32(out);
      const uint32_t lo = T::HALF * sizeof(float);
      const uint32_t a_row = wg * 64 / 8 * 256;  // this warpgroup's q slab
      const uint32_t b_row = BM / 8 * 256;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // hi_q . lo_a, then lo_q . hi_a, then hi_q . hi_a: small terms first
      mma_m64n128k8(acc, desc(base + a_row), desc(base + b_row + lo),
                    kc == 0 ? 0 : 1);
      mma_m64n128k8(acc, desc(base + a_row + lo), desc(base + b_row), 1);
      mma_m64n128k8(acc, desc(base + a_row), desc(base + b_row), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    epi(acc, n0, splits + (c - 1) % S * T::SPLIT + 2 * T::HALF);
  }
}

// Host side: a 2-D TMA map of a row-major (rows, d) f32 array with boxes of
// (BK, box_rows), zero fill out of bounds, and the 32-byte swizzle that
// raw_off undoes.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

struct Encoder {
  EncodeTiled encode = nullptr;
  cudaError_t err = cudaSuccess;
};

inline Encoder find_encoder() {
  Encoder e;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  e.err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                           12000, cudaEnableDefault, &found);
#else
  e.err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                  cudaEnableDefault, &found);
#endif
  if (e.err == cudaSuccess &&
      (found != cudaDriverEntryPointSuccess || fn == nullptr))
    e.err = cudaErrorNotSupported;
  if (e.err == cudaSuccess) e.encode = reinterpret_cast<EncodeTiled>(fn);
  return e;
}

// make_map's driver call (cuTensorMapEncodeTiled) needs a current context
// in the calling thread.  The runtime makes the device's primary context
// current at a thread's first runtime call that needs one, but a thread
// whose first CUDA call is a launch of these kernels has none yet (the
// sharded router's workers, say): cudaSetDevice makes it current.
inline cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

inline cudaError_t make_map(CUtensorMap* map, const float* x, int rows, int d,
                            int box_rows) {
  // looked up once, by the first call: a function-local static is
  // initialised exactly once even when several threads launch (C++11)
  static const Encoder enc = find_encoder();
  if (enc.err != cudaSuccess) return enc.err;
  const EncodeTiled encode = enc.encode;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace l2mma
