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
// code), so no f32 copy of the codebook is made.
//
// What bounds it on an H100: operations. The work is 2*N*K*D operations
// against (N + K) * D inputs: at the flagship bottom level at batch 128
// (N = 32768, K = 8192, D = 256) that is 137.4 GFLOP against 21 MB of bf16.
// For bf16 operands the card's rate for that work is the bf16 tensor-core
// peak, 989 TFLOP/s (0.14 ms; a bf16 x bf16 product is exact in f32, so
// wgmma with f32 accumulation gives the same scores up to summation order);
// for f32 operands it is the 67 TFLOP/s f32 peak (2.05 ms), since TF32
// would change which code wins. The bytes take 6.4 us at 3.35 TB/s. This
// version uses f32 FMAs for both, no tensor cores: simple and exact, and
// far from the bf16 bound (a wgmma version is later work).
//
// Design: a classic f32 SIMT GEMM with an argmin epilogue. A block of 256
// threads owns 128 rows of z and walks its slice of the codebook in tiles of
// 128 codes. For each tile, D is staged through shared memory 16 columns at
// a time (z and e converted to f32, stored transposed), and each thread
// accumulates an 8 x 8 register tile of z.e: rows {4ty..4ty+3, 64+4ty..},
// codes {4tx..4tx+3, 64+4tx..}, so a warp's float4 reads of shared memory
// are conflict-free. After a tile each thread folds its 64 scores into a
// running (min, argmin) per row with a strict `<`, codes in ascending order,
// so the first minimum wins. The 16 threads sharing a row then reduce with
// shuffles, breaking equal scores toward the lower code. Few row tiles would
// leave SMs idle (64 at the flagship top, 16 at the 3-level top at batch
// 32), so the grid's second axis splits the codebook into `splits` slices;
// a second kernel takes each row's minimum over the slices in code order.
// Ragged N and K are masked by index. D must be a multiple of 16.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

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

// esq[k] = |e_k|^2 in f32, one warp per code: each lane sums the squares of
// 8 values at a time, then the warp reduces with shuffles.
template <typename TE>
__global__ void vq_code_norms(const TE* __restrict__ e, float* __restrict__ esq,
                              int K, int D) {
  const int code = blockIdx.x * (kNormThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (code >= K) return;
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
  const int n_tiles = (K + kBN - 1) / kBN;
  const int t_begin =
      static_cast<int>(static_cast<int64_t>(split) * n_tiles / splits);
  const int t_end =
      static_cast<int>(static_cast<int64_t>(split + 1) * n_tiles / splits);

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
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, v, off);
      const int oa = __shfl_xor_sync(kFullMask, a, off);
      if (ov < v || (ov == v && oa < a)) {
        v = ov;
        a = oa;
      }
    }
    const int row = row0 + (i < 4 ? ty * 4 + i : kHalf + ty * 4 + i - 4);
    if (tx == 0 && row < N) {
      part_val[static_cast<int64_t>(split) * N + row] = v;
      part_idx[static_cast<int64_t>(split) * N + row] = a;
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

template <typename TZ, typename TE>
int launch(const void* z, const void* e, float* esq, float* part_val,
           int32_t* part_idx, int64_t* codes, int N, int K, int D,
           int splits, cudaStream_t stream) {
  constexpr int kCodesPerBlock = kNormThreads / 32;
  vq_code_norms<TE><<<(K + kCodesPerBlock - 1) / kCodesPerBlock,
                      kNormThreads, 0, stream>>>(static_cast<const TE*>(e),
                                                 esq, K, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBM - 1) / kBM, splits);
  vq_argmin_kernel<TZ, TE><<<grid, kThreads, 0, stream>>>(
      static_cast<const TZ*>(z), static_cast<const TE*>(e), esq, part_val,
      part_idx, N, K, D, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vq_reduce_splits<<<(N + kReduceThreads - 1) / kReduceThreads,
                     kReduceThreads, 0, stream>>>(part_val, part_idx, codes,
                                                  N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z_dtype, e_dtype: 0 = float32, 1 = bfloat16. z: contiguous [N, D]; e:
// contiguous [K, D]; both 16-byte aligned, D a multiple of 16. esq [K] f32
// (|e_k|^2), part_val [splits, N] f32 and part_idx [splits, N] int32 are
// scratch; codes: [N] int64. 1 <= splits <= min(ceil(K / 128), 65535).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int hqt_vq_argmin(int z_dtype, int e_dtype, const void* z,
                             const void* e, float* esq,
                             float* part_val, int32_t* part_idx,
                             int64_t* codes, int N, int K, int D, int splits,
                             void* stream) {
  const int n_tiles = (K + kBN - 1) / kBN;
  if (N <= 0 || K <= 0 || D <= 0 || D % kBK != 0 || splits < 1 ||
      splits > n_tiles || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_dtype == 0 && e_dtype == 0)
    return launch<float, float>(z, e, esq, part_val, part_idx, codes, N, K,
                                D, splits, s);
  if (z_dtype == 0 && e_dtype == 1)
    return launch<float, __nv_bfloat16>(z, e, esq, part_val, part_idx,
                                        codes, N, K, D, splits, s);
  if (z_dtype == 1 && e_dtype == 0)
    return launch<__nv_bfloat16, float>(z, e, esq, part_val, part_idx,
                                        codes, N, K, D, splits, s);
  if (z_dtype == 1 && e_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(z, e, esq, part_val,
                                                part_idx, codes, N, K, D,
                                                splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
