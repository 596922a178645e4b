// Single-token decode attention over the packed [L, T, B, D] KV cache.
//
// Replaces the TPU kernel hqtransformer_tpu/ops/pallas_attention.py::
// decode_attention_step (kernel body `_kernel`). Per call: write the new K/V
// row of layer `layer` at time `pos` in place, then for every (batch row b,
// head h) attend the head's query against cache rows t < pos plus the new
// token itself: scores q.k / sqrt(hd) in f32, softmax in f32, A.V
// accumulated in f32, output written in the query's dtype.
//
// Two element types: T of q and y (f32 or bf16) and C of the caches and the
// new rows, either T itself or int8. An int8 cache holds per-channel
// quantized K/V whose scales the caller folds outside the kernel (K's into
// q, V's into y, as the TPU kernel's caller does), so the kernel converts
// int8 to f32 on read and stays scale-free.
//
// What bounds it on an H100: bytes. Each call reads 2 * pos * B * D cache
// elements and does 4 flops per element read, far below the ~295 flops per
// byte where the tensor cores would become the limit, so the least time is
// the cache prefix over 3.35 TB/s; an int8 cache halves it against bf16.
//
// Design: one memory round trip. A block owns one batch row b and a pair
// of heads, one warp a head; for fixed (layer, t, b) the pair's slice of a
// cache row is one contiguous segment (256 bytes at hd 64 in bf16, 128 in
// int8). Before any thread computes, every thread issues 16-byte
// asynchronous copies (cp.async) of the K and V segments of rows t < pos
// into shared memory, a warp's copies covering whole segments, so the whole
// prefix the block needs is in flight at once (as the TPU kernel DMAs a
// batch tile's prefix into VMEM). Rows at or beyond pos are never read, so
// stale rows need no masking. While the copies fly, each warp loads its
// head's q, k_new and v_new and scores the new token. Once the copies land,
// a warp takes 32 / (hd / v) rows at a time, v cache elements (16 bytes) a
// lane: a score is a reduction over hd / v lanes (8 at hd 64 in bf16, 4 in
// int8), and each group of lanes keeps its own online softmax (max, sum and
// f32 accumulator, all starting from the new token's score) over the rows
// it takes. The groups then merge with a fixed butterfly of shuffles, so the
// result does not change from run to run. A prefix longer than shared
// memory holds (32 KB a round: 64 rows at hd 64 in bf16, 128 in int8) is
// taken in rounds that reuse the buffer. Each block writes only its heads'
// slice of the new row, so no two blocks touch the same bytes. Two heads a
// block and cp.async need no mbarrier and no shared-memory opt-in.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kHeadsPerBlock = 2;  // one warp each
constexpr int kThreads = 32 * kHeadsPerBlock;
constexpr int kRoundBytes = 32 * 1024;  // K and V rows staged per round
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive elements of T (a whole number of 16-byte vectors), widened
// to f32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static_assert(N % kPer == 0, "whole 16-byte vectors");
#pragma unroll
  for (int w = 0; w < N / kPer; ++w) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[w];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[w * kPer + i] = to_f32(e[i]);
  }
}

// N f32 values stored as N consecutive elements of T.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[N]) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static_assert(N % kPer == 0, "whole 16-byte vectors");
  alignas(16) T out[N];
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = from_f32<T>(in[i]);
#pragma unroll
  for (int w = 0; w < N / kPer; ++w)
    reinterpret_cast<uint4*>(p)[w] = reinterpret_cast<const uint4*>(out)[w];
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory asynchronously (both
// addresses 16-byte aligned). The copies a thread issued complete, for that
// thread, at cp_async_wait_all after cp_async_commit; a __syncthreads()
// then shows every thread's copies to the block.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rows of the cache prefix one round stages, for cache type C, head dim HD.
template <typename C, int HD>
__host__ __device__ constexpr int rows_per_round() {
  return kRoundBytes / (2 * kHeadsPerBlock * HD * static_cast<int>(sizeof(C)));
}

// T: the type of q and y; C: the type of the caches, k_new and v_new.
// Grid: B * ceil(n_heads / 2) blocks of kThreads; dynamic shared memory
// 2 * min(pos, rows_per_round) * 2 * HD * sizeof(C) bytes.
template <typename T, typename C, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const C* __restrict__ k_new,
                        const C* __restrict__ v_new, int64_t q_stride,
                        int64_t kn_stride, int64_t vn_stride, C* k_cache,
                        C* v_cache, T* __restrict__ y, int B, int T_max, int D,
                        int n_heads, int layer, int pos, float scale) {
  constexpr int kVec = 16 / sizeof(C);   // cache elements a lane loads at once
  constexpr int kLanes = HD / kVec;      // lanes per row of a head
  constexpr int kRowsAtOnce = 32 / kLanes;
  constexpr int kRound = rows_per_round<C, HD>();
  extern __shared__ __align__(16) uint8_t smem[];

  const int groups = (n_heads + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) * kHeadsPerBlock;
  const int heads = min(kHeadsPerBlock, n_heads - h0);
  const int seg = heads * HD;  // elements of the block's slice of a row
  const uint32_t seg_bytes = seg * sizeof(C);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;   // which vector of the head's row
  const int grp = lane / kLanes;   // which of the rows taken at once
  const int col = (h0 + warp) * HD + sub * kVec;

  // Element (layer, t, b, h0 * HD) sits at slice + t * row.
  const int64_t row = static_cast<int64_t>(B) * D;
  const int64_t slice = static_cast<int64_t>(layer) * T_max * row +
                        static_cast<int64_t>(b) * D + h0 * HD;
  const uint32_t k_smem = smem_u32(smem);
  const uint32_t v_smem = k_smem + min(pos, kRound) * seg_bytes;
  const C* ks = reinterpret_cast<const C*>(smem);
  const C* vs = ks + min(pos, kRound) * seg;

  // Every thread puts its share of rows [t0, t0 + n) of K and V in
  // flight, 16 bytes a copy.
  auto issue = [&](int t0, int n) {
    const int per_row = seg_bytes / 16;
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      const int64_t at = slice + (t0 + r) * row + c * kVec;
      cp_async16(k_smem + r * seg_bytes + c * 16, k_cache + at);
      cp_async16(v_smem + r * seg_bytes + c * 16, v_cache + at);
    }
    cp_async_commit();
  };
  if (pos > 0) issue(0, min(pos, kRound));

  const bool active = warp < heads;
  float qf[kVec] = {}, kn[kVec] = {}, vn[kVec] = {};
  if (active) {
    load_vec<T, kVec>(q + b * q_stride + col, qf);
    load_vec<C, kVec>(k_new + b * kn_stride + col, kn);
    load_vec<C, kVec>(v_new + b * vn_stride + col, vn);
    if (grp == 0) {
      // Persist the new row bit for bit (rows < pos are all that is read).
      const int64_t at = slice + pos * row + warp * HD + sub * kVec;
      copy16(k_cache + at, k_new + b * kn_stride + col);
      copy16(v_cache + at, v_new + b * vn_stride + col);
    }
  }

  // The new token's score, reduced over the lanes of each row group.
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) dot += qf[i] * kn[i];
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    dot += __shfl_xor_sync(kFullMask, dot, off);
  // Each row group's online softmax starts from the new token's score;
  // group 0 also holds the new token's weight and value.
  float m = dot * scale;
  float l = grp == 0 ? 1.f : 0.f;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = grp == 0 ? vn[i] : 0.f;

  for (int t0 = 0; t0 < pos; t0 += kRound) {
    const int n = min(pos - t0, kRound);
    if (t0 > 0) {
      __syncthreads();  // every warp is done with the previous round's rows
      issue(t0, n);
    }
    cp_async_wait_all();
    __syncthreads();
    if (active) {
      for (int r0 = 0; r0 < n; r0 += kRowsAtOnce) {
        const int r = r0 + grp;
        const bool valid = r < n;
        float kk[kVec], vv[kVec];
        float d = 0.f;
        if (valid) {
          load_vec<C, kVec>(ks + r * seg + warp * HD + sub * kVec, kk);
#pragma unroll
          for (int i = 0; i < kVec; ++i) d += qf[i] * kk[i];
        }
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFullMask, d, off);
        if (valid) {
          load_vec<C, kVec>(vs + r * seg + warp * HD + sub * kVec, vv);
          const float s = d * scale;
          const float m_new = fmaxf(m, s);
          const float corr = expf(m - m_new);
          const float p = expf(s - m_new);
          l = l * corr + p;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] = acc[i] * corr + p * vv[i];
          m = m_new;
        }
      }
    }
  }
  if (!active) return;

  // Merge the row groups' softmax states: a butterfly over the groups, the
  // same order in every run and symmetric, so every group ends equal.
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(kFullMask, m, off);
    const float l_o = __shfl_xor_sync(kFullMask, l, off);
    const float m_new = fmaxf(m, m_o);
    const float c = expf(m - m_new);
    const float c_o = expf(m_o - m_new);
    l = l * c + l_o * c_o;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float a_o = __shfl_xor_sync(kFullMask, acc[i], off);
      acc[i] = acc[i] * c + a_o * c_o;
    }
    m = m_new;
  }

  if (grp == 0) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= inv;
    store_vec<T, kVec>(y + static_cast<int64_t>(b) * D + col, acc);
  }
}

template <typename T, typename C, int HD>
int launch(const void* q, const void* k_new, const void* v_new,
           int64_t q_stride, int64_t kn_stride, int64_t vn_stride,
           void* k_cache, void* v_cache, void* y, int B, int T_max, int D,
           int n_heads, int layer, int pos, cudaStream_t stream) {
  const int blocks = B * ((n_heads + kHeadsPerBlock - 1) / kHeadsPerBlock);
  const int smem = 2 * std::min(pos, rows_per_round<C, HD>()) *
                   kHeadsPerBlock * HD * static_cast<int>(sizeof(C));
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  decode_attention_kernel<T, C, HD><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k_new),
      static_cast<const C*>(v_new), q_stride, kn_stride, vn_stride,
      static_cast<C*>(k_cache), static_cast<C*>(v_cache), static_cast<T*>(y),
      B, T_max, D, n_heads, layer, pos, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C>
int dispatch(int head_dim, const void* q, const void* k_new, const void* v_new,
             int64_t q_stride, int64_t kn_stride, int64_t vn_stride,
             void* k_cache, void* v_cache, void* y, int B, int T_max, int D,
             int n_heads, int layer, int pos, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, C, 32>(q, k_new, v_new, q_stride, kn_stride, vn_stride,
                              k_cache, v_cache, y, B, T_max, D, n_heads, layer,
                              pos, stream);
    case 64:
      return launch<T, C, 64>(q, k_new, v_new, q_stride, kn_stride, vn_stride,
                              k_cache, v_cache, y, B, T_max, D, n_heads, layer,
                              pos, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (of q and y): 0 = float32, 1 = bfloat16; cache_dtype (of the caches,
// k_new and v_new): the same code, or 2 = int8. q, k_new, v_new: [B, D]
// with row strides in elements; caches: contiguous [L, T_max, B, D]; y:
// contiguous [B, D]. Every pointer and row is 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int hqt_decode_attention_step(
    int dtype, int cache_dtype, const void* q, const void* k_new,
    const void* v_new, int64_t q_stride, int64_t kn_stride, int64_t vn_stride,
    void* k_cache, void* v_cache, void* y, int B, int T_max, int D,
    int n_heads, int layer, int pos, void* stream) {
  if (n_heads <= 0 || D % n_heads != 0 || pos < 0 || pos >= T_max)
    return static_cast<int>(cudaErrorInvalidValue);
  const int head_dim = D / n_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && cache_dtype == 0)
    return dispatch<float, float>(head_dim, q, k_new, v_new, q_stride,
                                  kn_stride, vn_stride, k_cache, v_cache, y,
                                  B, T_max, D, n_heads, layer, pos, s);
  if (dtype == 1 && cache_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        head_dim, q, k_new, v_new, q_stride, kn_stride, vn_stride, k_cache,
        v_cache, y, B, T_max, D, n_heads, layer, pos, s);
  if (dtype == 0 && cache_dtype == 2)
    return dispatch<float, int8_t>(head_dim, q, k_new, v_new, q_stride,
                                   kn_stride, vn_stride, k_cache, v_cache, y,
                                   B, T_max, D, n_heads, layer, pos, s);
  if (dtype == 1 && cache_dtype == 2)
    return dispatch<__nv_bfloat16, int8_t>(
        head_dim, q, k_new, v_new, q_stride, kn_stride, vn_stride, k_cache,
        v_cache, y, B, T_max, D, n_heads, layer, pos, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
