// GroupNorm (32 groups, affine), optionally followed by swish, of
// channels-last maps: x [N, C, H, W] stored as [N, H*W, C], f32 or bf16.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses it with swish on the TPU. It was added because PyTorch's CUDA
// GroupNorm cannot keep channels-last: it copies its input to NCHW first,
// and the stage-1 convolutions (channels-last on cuDNN) then read and
// write mixed layouts around it. Run in f32 as the port's plain version
// (`ops/group_norm.py::group_norm_swish_plain`) asks, that path moved about
// 42 bytes an element of a bf16 map; this pair moves 6.
//
// Arithmetic, rounded where the plain version rounds:
//   mean, var (biased) of each (sample, group) in f32;
//   rstd = rsqrtf(var + eps); a = rstd * gamma[c]; b = -a * mean + beta[c];
//   y = round(a * x + b)                     (one fma, rounded to x's type)
//   swish: s = round(1 / (1 + exp(-y))); y = round(y * s)
// which is what F.group_norm on f32, `.to(dtype)`, torch.sigmoid and the
// product compute on the card. Only the order of the statistics' sums
// differs.
//
// What bounds it on an H100: bytes. A few operations an element against
// 295 a byte at the tensor cores' rate, so the least time is the bytes
// over 3.35 TB/s: the input read once and the output written once (4 bytes
// an element in bf16). This design reads the input twice (6 bytes an
// element in bf16, 12 in f32), since a sample's map (up to 16.8 MB at
// 256x256x128 in bf16) does not fit on chip between the statistics and
// their use.
//
// Design. Both kernels: blocks of 256 threads over (tile of pixels,
// sample); a thread owns one 16-byte column of the channels (8 bf16 or 4
// f32 values) and walks the tile's pixels R = 256 / (C / vec) apart, four
// 16-byte loads in flight. The wrapper sizes the tiles so that the grid
// holds several blocks an SM at every served shape.
//   gn_stats: each thread sums x - shift and its square per channel, the
//     shift being the channel's value at the tile's first pixel (so f32
//     does not cancel when a channel's mean is far from 0); the block adds
//     its threads' sums by channel in a fixed order, turns them into each
//     channel's (mean, M2), joins a group's channels (their M2s plus the
//     spread of their means) and writes the tile's (mean, M2) of each group
//     to a small scratch array. No atomics: the result repeats run to run.
//   gn_apply: every block first combines its sample's tile partials by
//     Chan's formula, in the same fixed order in every block (so all blocks
//     of a sample use the same mean and rstd), then makes each channel's
//     a, b once and streams its tile: one read and one write a 16-byte
//     vector.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 32;
constexpr int kSub = kThreads / kGroups;   // threads a group in reductions
constexpr int kUnroll = 4;                 // 16-byte loads in flight

template <typename T> struct Traits;

template <> struct Traits<float> {
  static constexpr int kVec = 4;
  __device__ static float round(float v) { return v; }
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // a 32-bit word holds two bf16 values, the lower address in the low half
  __device__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  // values already rounded to bf16, so the conversion is exact
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bits(f[2 * i]) | bits(f[2 * i + 1]) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float param(const void* p, int bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// Chan's update of (count, mean, M2) with another part's.
__device__ __forceinline__ void chan(float& n, float& mean, float& m2,
                                     float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float delta = mb - mean;
  mean += delta * (nb / nn);
  m2 += m2b + delta * delta * (n * nb / nn);
  n = nn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int P,
                int C, int L, int tiles, int cpg) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  __shared__ float s_sum[kThreads * V];
  __shared__ float s_sq[kThreads * V];
  const int n = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  const int ncol = C / V, R = kThreads / ncol;
  const int col = tid % ncol, r = tid / ncol;
  const int p0 = t * L, p1 = min(p0 + L, P);
  const uint4* base =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(n) * P * C) + col;
  float shift[V];
  Tr::unpack(__ldg(base + static_cast<size_t>(p0) * ncol), shift);

  if (r < R) {
    float s1[V], s2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
    int p = p0 + r;
    for (; p + (kUnroll - 1) * R < p1; p += kUnroll * R) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = __ldg(base + static_cast<size_t>(p + u * R) * ncol);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float f[V];
        Tr::unpack(v[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = f[j] - shift[j];
          s1[j] += d;
          s2[j] = fmaf(d, d, s2[j]);
        }
      }
    }
    for (; p < p1; p += R) {
      float f[V];
      Tr::unpack(__ldg(base + static_cast<size_t>(p) * ncol), f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[j] - shift[j];
        s1[j] += d;
        s2[j] = fmaf(d, d, s2[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s_sum[r * C + col * V + j] = s1[j];
      s_sq[r * C + col * V + j] = s2[j];
    }
  }
  __syncthreads();

  // each channel's mean and M2 over the tile: its R rows' sums in order;
  // the threads of row 0 hold the channel shifts, the tile's first pixel
  const float cnt = static_cast<float>(p1 - p0);
  float mean[V], m2[V];
  if (r == 0) {
    float a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    for (int rr = 0; rr < R; ++rr) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a1[j] += s_sum[rr * C + col * V + j];
        a2[j] += s_sq[rr * C + col * V + j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float md = a1[j] / cnt;
      mean[j] = shift[j] + md;
      m2[j] = fmaxf(a2[j] - a1[j] * md, 0.f);
    }
  }
  __syncthreads();
  if (r == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s_sum[col * V + j] = mean[j];
      s_sq[col * V + j] = m2[j];
    }
  }
  __syncthreads();

  // each group's: the mean of its channels' means, and their M2s plus the
  // spread of those means (every channel counts the tile's pixels)
  if (tid < kGroups) {
    const float* cm = s_sum + tid * cpg;
    const float* c2 = s_sq + tid * cpg;
    float mg = 0.f;
    for (int c = 0; c < cpg; ++c) mg += cm[c];
    mg /= static_cast<float>(cpg);
    float m2g = 0.f, dev = 0.f;
    for (int c = 0; c < cpg; ++c) {
      const float d = cm[c] - mg;
      m2g += c2[c];
      dev = fmaf(d, d, dev);
    }
    part[(static_cast<size_t>(n) * tiles + t) * kGroups + tid] =
        make_float2(mg, fmaf(dev, cnt, m2g));
  }
}

template <typename T, bool kSwish>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                const float2* __restrict__ part, const void* gamma,
                const void* beta, int param_bf16, int P, int C, int L,
                int tiles, int cpg, float eps) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  __shared__ float s_mean[kGroups], s_rstd[kGroups];
  const int n = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;

  {
    const int g = tid / kSub, k = tid % kSub;
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int tt = k; tt < tiles; tt += kSub) {
      const float2 pm =
          part[(static_cast<size_t>(n) * tiles + tt) * kGroups + g];
      chan(cnt, mean, m2, static_cast<float>(min(L, P - tt * L) * cpg), pm.x,
           pm.y);
    }
#pragma unroll
    for (int off = kSub / 2; off > 0; off /= 2) {
      const float nb = __shfl_down_sync(0xffffffffu, cnt, off, kSub);
      const float mb = __shfl_down_sync(0xffffffffu, mean, off, kSub);
      const float m2b = __shfl_down_sync(0xffffffffu, m2, off, kSub);
      chan(cnt, mean, m2, nb, mb, m2b);
    }
    if (k == 0) {
      s_mean[g] = mean;
      s_rstd[g] = rsqrtf(m2 / cnt + eps);
    }
  }
  __syncthreads();

  const int ncol = C / V, R = kThreads / ncol;
  const int col = tid % ncol, r = tid / ncol;
  if (r >= R) return;
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = col * V + j, g = c / cpg;
    a[j] = s_rstd[g] * param(gamma, param_bf16, c);
    b[j] = fmaf(-a[j], s_mean[g], param(beta, param_bf16, c));
  }
  const size_t off = static_cast<size_t>(n) * P * ncol + col;
  const uint4* src = reinterpret_cast<const uint4*>(x) + off;
  uint4* dst = reinterpret_cast<uint4*>(y) + off;
  const int p0 = t * L, p1 = min(p0 + L, P);

  auto apply = [&](const uint4& v) {
    float f[V];
    Tr::unpack(v, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float h = Tr::round(fmaf(a[j], f[j], b[j]));
      if (kSwish) h = Tr::round(h * Tr::round(1.f / (1.f + expf(-h))));
      f[j] = h;
    }
    return Tr::pack(f);
  };

  int p = p0 + r;
  for (; p + (kUnroll - 1) * R < p1; p += kUnroll * R) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = __ldg(src + static_cast<size_t>(p + u * R) * ncol);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      dst[static_cast<size_t>(p + u * R) * ncol] = apply(v[u]);
  }
  for (; p < p1; p += R)
    dst[static_cast<size_t>(p) * ncol] =
        apply(__ldg(src + static_cast<size_t>(p) * ncol));
}

template <typename T>
int launch(const void* x, void* y, void* part, const void* gamma,
           const void* beta, int param_bf16, int N, int P, int C, int L,
           int tiles, float eps, int swish, cudaStream_t s) {
  const int ncol = C / Traits<T>::kVec;
  if (C <= 0 || C % kGroups || C % Traits<T>::kVec || ncol > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpg = C / kGroups;
  const dim3 grid(tiles, N);
  const T* xt = static_cast<const T*>(x);
  float2* pt = static_cast<float2*>(part);
  gn_stats_kernel<T><<<grid, kThreads, 0, s>>>(xt, pt, P, C, L, tiles, cpg);
  if (swish)
    gn_apply_kernel<T, true><<<grid, kThreads, 0, s>>>(
        xt, static_cast<T*>(y), pt, gamma, beta, param_bf16, P, C, L, tiles,
        cpg, eps);
  else
    gn_apply_kernel<T, false><<<grid, kThreads, 0, s>>>(
        xt, static_cast<T*>(y), pt, gamma, beta, param_bf16, P, C, L, tiles,
        cpg, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype, param_dtype: 0 float32, 1 bfloat16. x, y: [N, P, C] (channels-last
// [N, C, H, W], P = H * W), 16-byte aligned; part: N * tiles * 32 float2 of
// scratch; gamma, beta: [C]. Tiles of L pixels, tiles = ceil(P / L).
// Returns a CUDA error code (0 on success).
extern "C" int hqt_group_norm(int dtype, int param_dtype, const void* x,
                              void* y, void* part, const void* gamma,
                              const void* beta, int N, int P, int C, int L,
                              int tiles, float eps, int swish, void* stream) {
  if (N <= 0 || N > 65535 || P <= 0 || L <= 0 || tiles != (P + L - 1) / L ||
      !(eps >= 0.f) || (param_dtype != 0 && param_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, part, gamma, beta, param_dtype, N, P, C, L,
                         tiles, eps, swish, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, part, gamma, beta, param_dtype, N, P,
                                 C, L, tiles, eps, swish, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
