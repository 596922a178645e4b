// Single-token decode attention over the packed [L, T, B, D] KV cache.
//
// Replaces the TPU kernel hqtransformer_tpu/ops/pallas_attention.py::
// decode_attention_step (kernel body `_kernel`). Per call: write the new K/V
// row of layer `layer` at time `pos` in place, then for every (batch row b,
// head h) attend the head's query against cache rows t < pos plus the new
// token itself: scores q.k / sqrt(hd) in f32, softmax in f32, A.V
// accumulated in f32, output written in the input dtype.
//
// What bounds it on an H100: bytes. Each call reads 2 * pos * B * D cache
// elements and does 4 flops per element read, far below the ~295 flops per
// byte where the tensor cores would become the limit, so the least time is
// the cache prefix over 3.35 TB/s.
//
// Design: one warp per (b, h). With hd = 64 a head's slice of one cache row
// is 64 contiguous elements (128 bytes in bf16), so each lane loads 2
// elements with one vector load and the warp's load is one coalesced
// 128-byte line. The warp walks t = 0 .. pos-1 only (rows at or beyond pos
// are never read, so stale rows need no masking or zeroing) with an online
// softmax: running max and sum in f32 and an f32 accumulator per lane. Rows
// are taken four at a time so that four K and four V loads are in flight
// before the first shuffle reduction waits on them. Each warp writes only
// its own slice of the new row, so no two blocks touch the same bytes.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kRowsPerIter = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// An unsigned type of exactly N bytes, for one vector load or store.
template <int N> struct Bytes;
template <> struct Bytes<2> { using type = uint16_t; };
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<8> { using type = uint2; };

template <typename T, int EPT>
using Packet = typename Bytes<EPT * static_cast<int>(sizeof(T))>::type;

// Load EPT consecutive elements (one vector load) and widen them to f32.
template <typename T, int EPT>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[EPT]) {
  const Packet<T, EPT> raw = *reinterpret_cast<const Packet<T, EPT>*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < EPT; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int EPT>
__device__ __forceinline__ void copy_raw(T* dst, const T* src) {
  *reinterpret_cast<Packet<T, EPT>*>(dst) =
      *reinterpret_cast<const Packet<T, EPT>*>(src);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// EPT = elements per lane = head_dim / 32.
template <typename T, int EPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, int64_t q_stride,
                        int64_t kn_stride, int64_t vn_stride, T* k_cache,
                        T* v_cache, T* __restrict__ y, int B, int T_max, int D,
                        int n_heads, int layer, int pos, float scale) {
  constexpr int HD = 32 * EPT;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= B * n_heads) return;
  const int b = warp / n_heads;
  const int h = warp - b * n_heads;
  const int col = h * HD + lane * EPT;

  float qf[EPT], kn[EPT], vn[EPT];
  load_f32<T, EPT>(q + b * q_stride + col, qf);
  load_f32<T, EPT>(k_new + b * kn_stride + col, kn);
  load_f32<T, EPT>(v_new + b * vn_stride + col, vn);

  // Cache element (layer, t, b, col) sits at slice + t * row.
  const int64_t row = static_cast<int64_t>(B) * D;
  const int64_t slice =
      static_cast<int64_t>(layer) * T_max * row + static_cast<int64_t>(b) * D + col;
  T* kc = k_cache + slice;
  T* vc = v_cache + slice;

  // Persist the new row bit for bit.
  copy_raw<T, EPT>(kc + pos * row, k_new + b * kn_stride + col);
  copy_raw<T, EPT>(vc + pos * row, v_new + b * vn_stride + col);

  // Start the online softmax from the new token's own score.
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) dot += qf[i] * kn[i];
  float m = warp_sum(dot) * scale;  // running max
  float l = 1.f;                    // running sum of exp(s - m)
  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = vn[i];

  for (int t0 = 0; t0 < pos; t0 += kRowsPerIter) {
    float s[kRowsPerIter];
    float vv[kRowsPerIter][EPT];
#pragma unroll
    for (int u = 0; u < kRowsPerIter; ++u) {
      const int t = t0 + u;
      float kk[EPT];
      if (t < pos) {
        load_f32<T, EPT>(kc + t * row, kk);
        load_f32<T, EPT>(vc + t * row, vv[u]);
      } else {
#pragma unroll
        for (int i = 0; i < EPT; ++i) kk[i] = vv[u][i] = 0.f;
      }
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < EPT; ++i) d += qf[i] * kk[i];
      s[u] = d;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kRowsPerIter; ++u) {
      s[u] = warp_sum(s[u]) * scale;
      if (t0 + u < pos) m_new = fmaxf(m_new, s[u]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < kRowsPerIter; ++u) {
      if (t0 + u < pos) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < EPT; ++i) acc[i] += p * vv[u][i];
      }
    }
    m = m_new;
  }

  const float inv = 1.f / l;
  alignas(sizeof(Packet<T, EPT>)) T out[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) out[i] = from_f32<T>(acc[i] * inv);
  copy_raw<T, EPT>(y + static_cast<int64_t>(b) * D + col, out);
}

template <typename T, int EPT>
void launch(const void* q, const void* k_new, const void* v_new,
            int64_t q_stride, int64_t kn_stride, int64_t vn_stride,
            void* k_cache, void* v_cache, void* y, int B, int T_max, int D,
            int n_heads, int layer, int pos, cudaStream_t stream) {
  const int warps = B * n_heads;
  const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const float scale = 1.f / sqrtf(static_cast<float>(32 * EPT));
  decode_attention_kernel<T, EPT><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), q_stride, kn_stride, vn_stride,
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), static_cast<T*>(y),
      B, T_max, D, n_heads, layer, pos, scale);
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k_new, const void* v_new,
             int64_t q_stride, int64_t kn_stride, int64_t vn_stride,
             void* k_cache, void* v_cache, void* y, int B, int T_max, int D,
             int n_heads, int layer, int pos, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      launch<T, 1>(q, k_new, v_new, q_stride, kn_stride, vn_stride, k_cache,
                   v_cache, y, B, T_max, D, n_heads, layer, pos, stream);
      return 0;
    case 64:
      launch<T, 2>(q, k_new, v_new, q_stride, kn_stride, vn_stride, k_cache,
                   v_cache, y, B, T_max, D, n_heads, layer, pos, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k_new, v_new: [B, D] with row strides
// in elements; caches: contiguous [L, T_max, B, D]; y: contiguous [B, D].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hqt_decode_attention_step(
    int dtype, const void* q, const void* k_new, const void* v_new,
    int64_t q_stride, int64_t kn_stride, int64_t vn_stride, void* k_cache,
    void* v_cache, void* y, int B, int T_max, int D, int n_heads, int layer,
    int pos, void* stream) {
  if (n_heads <= 0 || D % n_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int head_dim = D / n_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(head_dim, q, k_new, v_new, q_stride, kn_stride,
                         vn_stride, k_cache, v_cache, y, B, T_max, D, n_heads,
                         layer, pos, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(head_dim, q, k_new, v_new, q_stride,
                                 kn_stride, vn_stride, k_cache, v_cache, y, B,
                                 T_max, D, n_heads, layer, pos, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
