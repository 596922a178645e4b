// Nearest-code search of vector quantization:
//   codes[n] = argmin_k (|e_k|^2 - 2 z_n . e_k), scores in f32, ties to the
//   lowest index. |z_n|^2 is dropped: it cannot change the argmin.
//
// Replaces the TPU kernel hqtransformer_tpu/ops/pallas_vq.py::
// vq_argmin_pallas (kernel body `_vq_kernel`). There, a grid of (row tile,
// code tile) runs one MXU matmul per pair and carries a running (min,
// argmin) in VMEM scratch along the sequential code-tile axis, so the
// [N, K] score matrix never reaches device memory. Here the sequential axis
// becomes a loop inside each block, and the scores live only in registers.
// |e|^2 is computed first, in f32, by a small kernel of its own (one warp a
// code), so no f32 copy of the codebook is made; it is padded with +inf to
// a whole number of 256-code tiles, so padded codes never win.
//
// What bounds it on an H100: operations. The work is 2*N*K*D operations
// against (N + K) * D inputs: at the flagship bottom level at batch 128
// (N = 32768, K = 8192, D = 256) that is 137.4 GFLOP against 21 MB of bf16.
// For bf16 operands the card's rate for that work is the bf16 tensor-core
// peak, 989 TFLOP/s (0.139 ms; a bf16 x bf16 product is exact in f32, so
// wgmma with f32 accumulation gives the same scores up to summation order);
// for f32 operands it is the 67 TFLOP/s f32 peak (2.05 ms), since TF32
// would change which code wins. The bytes take 6.4 us at 3.35 TB/s.
//
// Two variants; the wrapper picks one from the dtype pair.
//
// wgmma (bf16 z and bf16 codebook, as served). A block of 384 threads owns
// 128 rows of z and walks its slice of the codebook in tiles of 256 codes.
// Warpgroup 2 is the producer: one thread issues TMA loads (128-byte
// swizzle) of a 128 x 64 chunk of z and a 256 x 64 chunk of the codebook
// into a ring of 4 stages (48 KB each), each stage guarded by a "full" and
// an "empty" mbarrier. Warpgroups 0 and 1 are consumers, 64 rows each: per
// chunk four wgmma.m64n256k16 (bf16 x bf16 -> f32, both operands read from
// shared memory) accumulate the tile's 64 x 256 products in 128 registers a
// thread, one group kept in flight while the next chunk's wait begins.
// After a tile the epilogue scores esq[k] - 2 acc and folds each thread's
// 64 codes into its two rows' running (min, argmin), codes in ascending
// order with a strict `<`; at the end the four threads of a quad (which
// share rows in the accumulator layout) reduce with shuffles, breaking
// equal scores toward the lower code. TMA zero-fills the ragged rows of N
// and K and the tail of D (which adds nothing to a score); padded codes
// score +inf through esq. What bounds it in practice: the chunks are
// re-read from L2 by every block (z per code tile, the codebook per row
// tile), about 85 operations per byte of L2 traffic, and at D = 256 the
// per-tile epilogue, which no MMA overlaps. Needs D a multiple of 8 (rows
// 16-byte aligned for TMA) and 16-byte aligned pointers.
//
// SIMT (f32 and mixed pairs): a classic f32 GEMM with the same argmin
// epilogue, exact f32 FMAs and no tensor cores. A block of 256 threads owns
// 128 rows of z and walks 128-code tiles. For each tile, D is staged
// through shared memory 16 columns at a time (z and e converted to f32,
// stored transposed), and each thread accumulates an 8 x 8 register tile:
// rows {4ty..4ty+3, 64+4ty..}, codes {4tx..4tx+3, 64+4tx..}, so a warp's
// float4 reads of shared memory are conflict-free; the 16 threads sharing a
// row reduce with shuffles. Ragged N and K are masked by index. D must be a
// multiple of 16. It runs near the f32 FMA peak.
//
// Both variants split the codebook over the grid's second axis when row
// tiles are few (64 at the flagship top, 16 at the 3-level top at batch
// 32), so that the card's SMs fill; a last kernel takes each row's minimum
// over the slices in code order.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // rows of z per block
constexpr int kBN = 128;       // codes per tile
constexpr int kBK = 16;        // columns of D per shared-memory stage
constexpr int kHalf = 64;      // second half of a tile's rows or codes
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 scores each
constexpr int kReduceThreads = 256;
constexpr int kNormThreads = 256;  // 8 codes (one warp each) per block
constexpr unsigned kFullMask = 0xffffffffu;

// The wgmma variant.
constexpr int kTcRows = 128;    // rows of z per block: two warpgroups of 64
constexpr int kTcCodes = 256;   // codes per tile: the n of m64n256k16
constexpr int kTcChunk = 64;    // columns of D per stage: one 128-byte row
constexpr int kTcStages = 4;
constexpr int kTcZBytes = kTcRows * kTcChunk * 2;
constexpr int kTcEBytes = kTcCodes * kTcChunk * 2;
constexpr int kTcStageBytes = kTcZBytes + kTcEBytes;
constexpr int kTcThreads = 384;  // warpgroups 0, 1 consume; 2 produces
// The ring, 1024 bytes of slack to align it for the swizzle, the barriers.
constexpr int kTcSmem = kTcStages * kTcStageBytes + 1024 + 2 * kTcStages * 8;
constexpr int kCodePad = 256;    // esq is padded to a multiple of this

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Stage rows [row0, row0 + 128) x columns [d0, d0 + 16) of a row-major
// [rows, D] matrix into sh[16][128] as f32, transposed. Thread t loads 8
// values of row t % 128; rows past the end are zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           int rows, int D, int row0, int d0,
                                           float (*sh)[kBM]) {
  const int r = threadIdx.x & (kBM - 1);
  const int c = (threadIdx.x >> 7) * 8;
  float v[8];
  if (row0 + r < rows) {
    load8(src + static_cast<int64_t>(row0 + r) * D + d0 + c, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) sh[c + j][r] = v[j];
}

// esq[k] = |e_k|^2 in f32 for k < K and +inf for K <= k < K_pad, one warp
// per code: each lane sums the squares of 8 values at a time, then the
// warp reduces with shuffles. D must be a multiple of 8.
template <typename TE>
__global__ void vq_code_norms(const TE* __restrict__ e, float* __restrict__ esq,
                              int K, int K_pad, int D) {
  const int code = blockIdx.x * (kNormThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (code >= K_pad) return;
  if (code >= K) {
    if (lane == 0) esq[code] = INFINITY;
    return;
  }
  const TE* row = e + static_cast<int64_t>(code) * D;
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    float v[8];
    load8(row + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(v[j], v[j], s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
  if (lane == 0) esq[code] = s;
}

__device__ __forceinline__ void unpack8(const float* lo, const float* hi,
                                        float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(lo);
  const float4 b = *reinterpret_cast<const float4*>(hi);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The tiles [t_begin, t_end) of `split` among `splits` slices of n_tiles.
__device__ __forceinline__ void slice_of(int split, int splits, int n_tiles,
                                         int& t_begin, int& t_end) {
  t_begin = static_cast<int>(static_cast<int64_t>(split) * n_tiles / splits);
  t_end = static_cast<int>(static_cast<int64_t>(split + 1) * n_tiles / splits);
}

// Keep the lesser of (v, a) and (ov, oa), the lower code on equal scores.
__device__ __forceinline__ void min_pair(float& v, int& a, float ov, int oa) {
  if (ov < v || (ov == v && oa < a)) {
    v = ov;
    a = oa;
  }
}

// Grid (row tiles, splits). Writes each row's minimum score and its code
// over this block's slice of the codebook to part_val/part_idx[split][row].
template <typename TZ, typename TE>
__global__ void __launch_bounds__(kThreads, 2)
vq_argmin_kernel(const TZ* __restrict__ z, const TE* __restrict__ e,
                 const float* __restrict__ esq, float* __restrict__ part_val,
                 int32_t* __restrict__ part_idx, int N, int K, int D,
                 int splits) {
  __shared__ __align__(16) float zs[kBK][kBM];
  __shared__ __align__(16) float es[kBK][kBN];

  const int tx = threadIdx.x & 15;  // which codes of a tile
  const int ty = threadIdx.x >> 4;  // which rows of the block
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  int t_begin, t_end;
  slice_of(split, splits, (K + kBN - 1) / kBN, t_begin, t_end);

  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    arg[i] = t_begin * kBN;
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int code0 = tile * kBN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kBK) {
      stage_tile(z, N, D, row0, d0, zs);
      stage_tile(e, K, D, code0, d0, es);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[8], b[8];
        unpack8(&zs[kk][ty * 4], &zs[kk][kHalf + ty * 4], a);
        unpack8(&es[kk][tx * 4], &es[kk][kHalf + tx * 4], b);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Fold this tile's scores into the running minimum; j runs over this
    // thread's codes in ascending order, so a strict < keeps the first.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = code0 + (j < 4 ? tx * 4 + j : kHalf + tx * 4 + j - 4);
      if (code < K) {
        const float eq = __ldg(esq + code);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float s = eq - 2.f * acc[i][j];
          if (s < best[i]) {
            best[i] = s;
            arg[i] = code;
          }
        }
      }
    }
  }

  // The 16 threads of a row group (one half-warp) hold disjoint codes of
  // the same rows: reduce to the least score, the lower code on equality.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = best[i];
    int a = arg[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      min_pair(v, a, __shfl_xor_sync(kFullMask, v, off),
               __shfl_xor_sync(kFullMask, a, off));
    const int row = row0 + (i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4);
    if (tx == 0 && row < N) {
      part_val[static_cast<int64_t>(split) * N + row] = v;
      part_idx[static_cast<int64_t>(split) * N + row] = a;
    }
  }
}

// ------------------------------------------------------------ wgmma variant

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals and, in that
// phase, as many bytes of TMA loads as were announced with mbar_expect_tx.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar),
               "r"(count)
               : "memory");
}

// Makes initialised mbarriers visible to the async proxy (TMA) and to the
// other threads; follow it with __syncthreads().
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of loads to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Load the box of a 2-D tensor map at coordinates (c0 innermost, c1) into
// shared memory; completion is counted in bytes on `bar`. Elements outside
// the tensor are filled with zeros. `map` must live in kernel parameter
// space (a __grid_constant__ argument).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" :: "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];" :: "l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Shared-memory matrix descriptor of wgmma for a K-major tile written by
// TMA with the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024
// bytes apart (the stride byte offset); the leading byte offset is unused
// for this layout. The tile must start on a 1024-byte boundary; a k-step
// of 16 bf16 within the 128-byte row adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (it cannot see that the hardware writes them late).
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define HQT_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HQT_ACC16(i) \
  HQT_ACC4(i), HQT_ACC4(i + 4), HQT_ACC4(i + 8), HQT_ACC4(i + 12)

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, bf16 in, f32 accumulate;
// A and B K-major in shared memory. scale_d = 0 overwrites d. Thread t of
// the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 j + 2 (t % 4) (+ 1): d[4j + 2r + c] is (row + 8r, column 8j + 2(t%4) + c).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : HQT_ACC16(0), HQT_ACC16(16), HQT_ACC16(32), HQT_ACC16(48),
        HQT_ACC16(64), HQT_ACC16(80), HQT_ACC16(96), HQT_ACC16(112)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef HQT_ACC16
#undef HQT_ACC4

// Grid (row tiles, splits), kTcThreads threads, kTcSmem bytes of dynamic
// shared memory. Same outputs as vq_argmin_kernel.
__global__ void __launch_bounds__(kTcThreads, 1)
vq_argmin_wgmma(const __grid_constant__ CUtensorMap zmap,
                const __grid_constant__ CUtensorMap emap,
                const float* __restrict__ esq, float* __restrict__ part_val,
                int32_t* __restrict__ part_idx, int N, int D, int n_tiles,
                int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kTcStages * kTcStageBytes;  // + 8 s
  const uint32_t empty = full + kTcStages * 8;             // + 8 s

  const int split = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int n_chunks = (D + kTcChunk - 1) / kTcChunk;
  int t_begin, t_end;
  slice_of(split, splits, n_tiles, t_begin, t_end);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      prefetch_tensormap(&zmap);
      prefetch_tensormap(&emap);
      int s = 0;
      uint32_t phase = 0;
      for (int tile = t_begin; tile < t_end; ++tile) {
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t stage = ring + s * kTcStageBytes;
          mbar_expect_tx(full + 8 * s, kTcStageBytes);
          tma_load_2d(stage, &zmap, full + 8 * s, c * kTcChunk, row0);
          tma_load_2d(stage + kTcZBytes, &emap, full + 8 * s,
                           c * kTcChunk, tile * kTcCodes);
          if (++s == kTcStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows row0 + 64 wg .. + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x & 31;
    const int quad = lane & 3;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float best0 = INFINITY, best1 = INFINITY;
    int arg0 = t_begin * kTcCodes, arg1 = t_begin * kTcCodes;
    const uint32_t a_off = wg * 64 * 128;  // this warpgroup's 64 rows
    int s = 0;
    uint32_t phase = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      int prev = 0;
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(full + 8 * s, phase);
        const uint32_t stage = ring + s * kTcStageBytes;
        const uint64_t da = sw128_desc(stage + a_off);
        const uint64_t db = sw128_desc(stage + kTcZBytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kTcChunk / 16; ++k)
          wgmma_m64n256k16(acc, da + 2 * k, db + 2 * k, c > 0 || k > 0);
        wgmma_commit();
        fence_acc(acc);
        if (c > 0) {
          // The previous chunk's products are done: release its stage.
          wgmma_wait<1>();
          fence_acc(acc);
          if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = s;
        if (++s == kTcStages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * prev);

      // Epilogue: this thread's 64 codes of the tile in ascending order.
      const int code_q = tile * kTcCodes + 2 * quad;
#pragma unroll
      for (int j = 0; j < kTcCodes / 8; ++j) {
        const int code = code_q + 8 * j;
        const float2 eq = __ldg(reinterpret_cast<const float2*>(esq + code));
        float sc = fmaf(-2.f, acc[4 * j], eq.x);
        if (sc < best0) { best0 = sc; arg0 = code; }
        sc = fmaf(-2.f, acc[4 * j + 1], eq.y);
        if (sc < best0) { best0 = sc; arg0 = code + 1; }
        sc = fmaf(-2.f, acc[4 * j + 2], eq.x);
        if (sc < best1) { best1 = sc; arg1 = code; }
        sc = fmaf(-2.f, acc[4 * j + 3], eq.y);
        if (sc < best1) { best1 = sc; arg1 = code + 1; }
      }
    }

    // The four threads of a quad hold disjoint codes of the same two rows.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      min_pair(best0, arg0, __shfl_xor_sync(kFullMask, best0, off),
               __shfl_xor_sync(kFullMask, arg0, off));
      min_pair(best1, arg1, __shfl_xor_sync(kFullMask, best1, off),
               __shfl_xor_sync(kFullMask, arg1, off));
    }
    const int row = row0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + lane / 4;
    if (quad == 0) {
      const int64_t at = static_cast<int64_t>(split) * N + row;
      if (row < N) {
        part_val[at] = best0;
        part_idx[at] = arg0;
      }
      if (row + 8 < N) {
        part_val[at + 8] = best1;
        part_idx[at + 8] = arg1;
      }
    }
  }
}

// One thread per row: the minimum over the slices, taken in ascending
// slice (and so code) order with a strict <, so the lowest code wins ties.
__global__ void vq_reduce_splits(const float* __restrict__ part_val,
                                 const int32_t* __restrict__ part_idx,
                                 int64_t* __restrict__ codes, int N,
                                 int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float v = part_val[row];
  int a = part_idx[row];
  for (int s = 1; s < splits; ++s) {
    const float w = part_val[static_cast<int64_t>(s) * N + row];
    if (w < v) {
      v = w;
      a = part_idx[static_cast<int64_t>(s) * N + row];
    }
  }
  codes[row] = a;
}

// cuTensorMapEncodeTiled, a libcuda entry point looked up through the
// runtime, so that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a row-major [rows, D] bf16 matrix, read in boxes of
// box_rows x 64 columns with the 128-byte swizzle; zeros outside.
bool bf16_rows_map(CUtensorMap* map, const void* ptr, int rows, int D,
                   int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kTcChunk, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TE>
cudaError_t launch_norms(const void* e, float* esq, int K, int K_pad, int D,
                         cudaStream_t stream) {
  constexpr int kCodesPerBlock = kNormThreads / 32;
  vq_code_norms<TE><<<(K_pad + kCodesPerBlock - 1) / kCodesPerBlock,
                      kNormThreads, 0, stream>>>(static_cast<const TE*>(e),
                                                 esq, K, K_pad, D);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* part_val, const int32_t* part_idx,
                          int64_t* codes, int N, int splits,
                          cudaStream_t stream) {
  vq_reduce_splits<<<(N + kReduceThreads - 1) / kReduceThreads,
                     kReduceThreads, 0, stream>>>(part_val, part_idx, codes,
                                                  N, splits);
  return cudaGetLastError();
}

template <typename TZ, typename TE>
int launch_simt(const void* z, const void* e, float* esq, float* part_val,
                int32_t* part_idx, int64_t* codes, int N, int K, int K_pad,
                int D, int splits, cudaStream_t stream) {
  cudaError_t err = launch_norms<TE>(e, esq, K, K_pad, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBM - 1) / kBM, splits);
  vq_argmin_kernel<TZ, TE><<<grid, kThreads, 0, stream>>>(
      static_cast<const TZ*>(z), static_cast<const TE*>(e), esq, part_val,
      part_idx, N, K, D, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part_val, part_idx, codes, N, splits,
                                        stream));
}

int launch_wgmma(const void* z, const void* e, float* esq, float* part_val,
                 int32_t* part_idx, int64_t* codes, int N, int K, int K_pad,
                 int D, int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        vq_argmin_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap zmap, emap;
  if (!bf16_rows_map(&zmap, z, N, D, kTcRows) ||
      !bf16_rows_map(&emap, e, K, D, kTcCodes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_norms<__nv_bfloat16>(e, esq, K, K_pad, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTcRows - 1) / kTcRows, splits);
  vq_argmin_wgmma<<<grid, kTcThreads, kTcSmem, stream>>>(
      zmap, emap, esq, part_val, part_idx, N, D, K_pad / kTcCodes, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part_val, part_idx, codes, N, splits,
                                        stream));
}

}  // namespace

// z_dtype, e_dtype: 0 = float32, 1 = bfloat16; bf16 with bf16 runs the
// wgmma variant, every other pair the SIMT variant. z: contiguous [N, D];
// e: contiguous [K, D]; both 16-byte aligned; D a multiple of 8 for wgmma,
// of 16 for SIMT. esq [ceil(K / 256) * 256] f32, part_val [splits, N] f32
// and part_idx [splits, N] int32 are scratch; codes: [N] int64. 1 <= splits
// <= min(number of code tiles, 65535), with tiles of 256 codes (wgmma) or
// 128 (SIMT). Returns cudaGetLastError() after the launches (0 on success).
extern "C" int hqt_vq_argmin(int z_dtype, int e_dtype, const void* z,
                             const void* e, float* esq, float* part_val,
                             int32_t* part_idx, int64_t* codes, int N, int K,
                             int D, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K_pad = (K + kCodePad - 1) / kCodePad * kCodePad;
  if (N <= 0 || K <= 0 || D <= 0 || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (z_dtype == 1 && e_dtype == 1) {
    if (D % 8 != 0 || splits > K_pad / kTcCodes)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(z, e, esq, part_val, part_idx, codes, N, K, K_pad, D,
                        splits, s);
  }
  if (D % kBK != 0 || splits > (K + kBN - 1) / kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (z_dtype == 0 && e_dtype == 0)
    return launch_simt<float, float>(z, e, esq, part_val, part_idx, codes, N,
                                     K, K_pad, D, splits, s);
  if (z_dtype == 0 && e_dtype == 1)
    return launch_simt<float, __nv_bfloat16>(z, e, esq, part_val, part_idx,
                                             codes, N, K, K_pad, D, splits, s);
  if (z_dtype == 1 && e_dtype == 0)
    return launch_simt<__nv_bfloat16, float>(z, e, esq, part_val, part_idx,
                                             codes, N, K, K_pad, D, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
