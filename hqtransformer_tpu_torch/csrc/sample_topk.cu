// Fused top-k filtered categorical sampling, one uniform per row.
//
// Replaces the TPU kernel hqtransformer_tpu/ops/pallas_sample.py::
// _sample_topk_2d (kernel body `_sample_kernel`) with the same arithmetic:
//   x = f32(logits) / temperature;  row_max = max(x)
//   threshold: if k < V, 26 bisection steps on [row_max - 44, row_max + 1e-6]
//     with mid = 0.5 * (lo + hi) in f32 and count(x >= mid); count >= k moves
//     lo up, else hi down; a row freezes on an exact count == k. If k >= V,
//     the threshold is min(x).
//   p = (x >= thr) ? exp(x - row_max) : 0;  cdf = inclusive prefix sum of p
//   draw = max(u * total, 1e-30);  idx0 = count(cdf < draw)
//   code = the largest index <= idx0 with p > 0 (snap down, so a rounding
//     sliver of the f32 CDF can never select a filtered token).
// Only the order of the f32 CDF sum differs from the plain version.
//
// What bounds it on an H100: operations, narrowly ahead of bytes. The kernel
// reads each logit once (16 KB a row in bf16 at V = 8192) and writes one int
// per row, but every bisection step compares and counts every logit again:
// about 2 operations per logit per step plus 6 (divide, mask, exp, running
// sum, draw count, snap). A row of random logits runs some 25 steps, so the
// f32 work outlasts the bytes at 3.35 TB/s by about 1.4x. Keeping the row in
// registers is what stops those passes from becoming bytes as well.
//
// Design: one block of 512 threads per row. The row lives in registers as
// f32 after the division by the temperature, VPT = ceil(V / 512) contiguous
// values per thread (16 at V = 8192), so the 26 bisection passes and the
// CDF never go back to device memory. Counts and maxima are block
// reductions (warp shuffles, then 16 warp partials in shared memory); the
// CDF is a per-thread running sum plus a block-wide exclusive scan of the
// thread sums. A ragged V is masked by index: values at j >= V take no part.
// The bisection stops as soon as the row freezes, which changes no result.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 26;
constexpr float kBisectRange = 44.0f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct IntMaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Block-wide reduction; every thread gets the result. `sh` holds kWarps
// entries. The leading barrier keeps a previous reduction's readers from
// seeing this one's writes.
template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, V* sh, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_xor_sync(kFullMask, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  V r = sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, sh[w]);
  return r;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
sample_topk_kernel(const T* __restrict__ logits, const float* __restrict__ u,
                   int32_t* __restrict__ out, int V, int k,
                   float temperature) {
  __shared__ float sh_f[kWarps];
  __shared__ int sh_i[kWarps];
  __shared__ float sh_scan[kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int j0 = tid * VPT;
  const T* xr = logits + static_cast<int64_t>(row) * V;

  float x[VPT];
  float local_max = -INFINITY, local_min = INFINITY;
#pragma unroll
  for (int e = 0; e < VPT; ++e) {
    const int j = j0 + e;
    if (j < V) {
      x[e] = to_f32(xr[j]) / temperature;
      local_max = fmaxf(local_max, x[e]);
      local_min = fminf(local_min, x[e]);
    } else {
      x[e] = -INFINITY;
    }
  }
  const float row_max = block_reduce(local_max, sh_f, MaxOp());

  float thr;
  if (k < V) {
    float lo = row_max - kBisectRange;
    float hi = row_max + 1e-6f;
    for (int it = 0; it < kBisectIters; ++it) {
      const float mid = 0.5f * (lo + hi);
      int c = 0;
#pragma unroll
      for (int e = 0; e < VPT; ++e) c += (j0 + e < V && x[e] >= mid) ? 1 : 0;
      c = block_reduce(c, sh_i, SumOp());
      if (c >= k) {
        lo = mid;
        if (c == k) break;  // frozen: the kept set is exactly the top k
      } else {
        hi = mid;
      }
    }
    thr = lo;
  } else {
    thr = block_reduce(local_min, sh_f, MinOp());
  }

  // Unnormalised mass and this thread's running sum over its VPT values.
  // Bit e of `mass` is set where p > 0 (exp may underflow far below the
  // max when k >= V).
  float cdf[VPT];
  float run = 0.f;
  uint32_t mass = 0;
#pragma unroll
  for (int e = 0; e < VPT; ++e) {
    const bool keep = j0 + e < V && x[e] >= thr;
    const float p = keep ? expf(x[e] - row_max) : 0.f;
    if (p > 0.f) mass |= 1u << e;
    run += p;
    cdf[e] = run;
  }

  // Block exclusive scan of the thread sums: warp inclusive scan, then the
  // warp totals.
  const int lane = tid & 31, warp = tid >> 5;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += n;
  }
  __syncthreads();
  if (lane == 31) sh_scan[warp] = incl;
  __syncthreads();
  float warp_prefix = 0.f, total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) warp_prefix += sh_scan[w];
    total += sh_scan[w];
  }
  const float before_in_warp = __shfl_up_sync(kFullMask, incl, 1);
  const float excl = warp_prefix + (lane > 0 ? before_in_warp : 0.f);

  const float draw = fmaxf(u[row] * total, 1e-30f);
  int below = 0;
#pragma unroll
  for (int e = 0; e < VPT; ++e) {
    cdf[e] += excl;
    below += (j0 + e < V && cdf[e] < draw) ? 1 : 0;
  }
  const int idx0 = block_reduce(below, sh_i, SumOp());

  int best = 0;
#pragma unroll
  for (int e = 0; e < VPT; ++e) {
    const int j = j0 + e;
    if (((mass >> e) & 1u) && j <= idx0) best = j;
  }
  best = block_reduce(best, sh_i, IntMaxOp());
  if (tid == 0) out[row] = best;
}

template <typename T, int VPT>
void launch(const void* logits, const float* u, int32_t* out, int N, int V,
            int k, float temperature, cudaStream_t stream) {
  sample_topk_kernel<T, VPT><<<N, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), u, out, V, k, temperature);
}

template <typename T>
int dispatch(const void* logits, const float* u, int32_t* out, int N, int V,
             int k, float temperature, cudaStream_t stream) {
  const int vpt = (V + kThreads - 1) / kThreads;
  if (vpt <= 1) launch<T, 1>(logits, u, out, N, V, k, temperature, stream);
  else if (vpt <= 2) launch<T, 2>(logits, u, out, N, V, k, temperature, stream);
  else if (vpt <= 4) launch<T, 4>(logits, u, out, N, V, k, temperature, stream);
  else if (vpt <= 8) launch<T, 8>(logits, u, out, N, V, k, temperature, stream);
  else if (vpt <= 16) launch<T, 16>(logits, u, out, N, V, k, temperature, stream);
  else if (vpt <= 32) launch<T, 32>(logits, u, out, N, V, k, temperature, stream);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. logits: contiguous [N, V]; u: [N] f32;
// out: [N] int32. V <= 16384, k >= 1. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int hqt_sample_topk(int dtype, const void* logits, const float* u,
                               int32_t* out, int N, int V, int k,
                               float temperature, void* stream) {
  if (N <= 0 || V <= 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) rc = dispatch<float>(logits, u, out, N, V, k, temperature, s);
  else if (dtype == 1)
    rc = dispatch<__nv_bfloat16>(logits, u, out, N, V, k, temperature, s);
  else rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
