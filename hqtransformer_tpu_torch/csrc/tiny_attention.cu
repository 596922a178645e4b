// Multi-head attention over the depth chains' few tokens: q [B, Tq, D]
// against k, v [B, Tk, D] (Tq, Tk <= 32) in heads of hd channels, under an
// optional bool mask [Tq, Tk] (true = attend); y [B, Tq, D]. f32 or bf16.
//
// Replaces no TPU kernel: the JAX package's `tiny_attention` is plain jnp,
// which XLA fuses into one loop. It was added because the port's plain
// version (ops/tiny_attention.py::tiny_attention_plain, stock PyTorch)
// cannot fuse: it writes the [B, Tq, Tk, D] products q * k and weight * v
// to device memory and reads them back, 10-12 launches moving about 3.5 GB
// a depth layer of the 3-level bottom phase at batch 512 (Tq 16, Tk 21,
// d 1536), a third of that sampler's device time.
//
// Arithmetic, rounded where the plain version rounds:
//   p = round(q[i, c] * k[j, c])                   (to the activation dtype)
//   s[i, j] = (sum of p over a head's c, in f32) * (1 / sqrt(hd))
//   s[i, j] = -1e10 where the mask blocks (i, j)
//   w[i, j] = round(exp(s - max_j s) / sum_j exp(s - max_j s))  (f32 softmax)
//   y[i, c] = round(sum over j of w[i, j] * v[j, c], in f32)
// In bf16 the products w * v are exact in f32 and are not rounded (one fma);
// in f32 each product is rounded, then added. Only the order of the f32
// sums differs from the plain version.
//
// What bounds it on an H100: bytes. The least it can move is q, k and v
// read once and y written once: at the 3-level bottom phase (B 512, Tq 16,
// Tk 21, d 1536, bf16) 116 MB, 35 us at 3.35 TB/s. Its 264 M products of
// q and k, each rounded before it is summed (which a tensor core cannot
// do), and as many of w and v run on the CUDA cores, about as long again at
// the full instruction rate, so the design keeps both the copies and the
// arithmetic going: many small blocks an SM, each copying its inputs in
// two asynchronous groups.
//
// Design. One block per (batch row, group of G heads), two threads a
// (head, query) pair, rounded up to whole warps; the wrapper
// (`launch_plan`) picks G from the shapes and checks the shared memory it
// takes.
//   1. The group's rows of k, then (a second cp.async group, which lands
//      while the scores are formed) of v, are copied to shared memory in
//      16-byte pieces. Each head's columns are padded by 16 bytes and each
//      row by 16 more, so the heads and rows a warp reads at once fall in
//      different banks.
//   2. Each thread of a (head, query) pair scores half the keys, in
//      registers, 16 bytes of channels a step: q's row comes from device
//      memory one piece ahead (each is read by one pair only); in bf16 a
//      bf16x2 multiply rounds two products as the plain version does, both
//      are widened, and the 8 products of a step are added as a tree in f32
//      before they join the sum. The pair shares its maximum and its sum
//      of exponentials by one shuffle each and writes its rounded weights
//      to shared memory, over k's copy.
//   3. A thread then owns 4 channels of 4 queries of one head and sums
//      w * v over the keys in f32 (16 products a key from one 8- or
//      16-byte load of v and one 16-byte load of w), then stores 4 channels
//      of each query: neighbouring threads write neighbouring channels.
// It launches on the caller's stream, reads no device memory on the host
// and never synchronises, so a CUDA graph can capture it.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 32;           // Tq and Tk at most
constexpr int kMaxHeadDim = 128;
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;    // 227 KB, a block's opt-in limit
constexpr float kMasked = -1e10f;   // the plain version's NEG_INF in f32

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kVec = 4;    // values in 16 bytes
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The f32 values of the low and the high bf16 of a 32-bit word.
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// The sum of the products of 16 bytes of q and of k, each product rounded
// to the dtype, added in f32 as a tree.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b);
template <>
__device__ __forceinline__ float dot16<float>(const uint4& a,
                                              const uint4& b) {
  const float p0 = __fmul_rn(__uint_as_float(a.x), __uint_as_float(b.x));
  const float p1 = __fmul_rn(__uint_as_float(a.y), __uint_as_float(b.y));
  const float p2 = __fmul_rn(__uint_as_float(a.z), __uint_as_float(b.z));
  const float p3 = __fmul_rn(__uint_as_float(a.w), __uint_as_float(b.w));
  return __fadd_rn(__fadd_rn(p0, p1), __fadd_rn(p2, p3));
}
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(const uint4& a,
                                                      const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w};
  const uint32_t y[4] = {b.x, b.y, b.z, b.w};
  float pair[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t p;   // two bf16 products, each the exact product rounded
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p) : "r"(x[w]), "r"(y[w]));
    pair[w] = __fadd_rn(bf16_lo(p), bf16_hi(p));
  }
  return __fadd_rn(__fadd_rn(pair[0], pair[1]), __fadd_rn(pair[2], pair[3]));
}

// 4 values of v in f32.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// acc + w * v with the plain version's product: rounded in f32; exact (and
// so one fma) for a bf16 weight and a bf16 value.
template <typename T>
__device__ __forceinline__ float madd(float acc, float w, float v);
template <>
__device__ __forceinline__ float madd<float>(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}
template <>
__device__ __forceinline__ float madd<__nv_bfloat16>(float acc, float w,
                                                     float v) {
  return __fmaf_rn(w, v, acc);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&a)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&a)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Shared-memory layout (elements of T): a row of the group is G heads of
// hd + vec columns and vec more; k's Tk rows, whose space the weights
// [G][Tk][tqp] (f32) take after the scores, then v's Tk rows.
__host__ __device__ inline int smem_row(int G, int hd, int vec) {
  return G * (hd + vec) + vec;
}
__host__ __device__ inline int queries_padded(int Tq) {
  return (Tq + 3) & ~3;
}
template <typename T>
__host__ __device__ inline int k_region_bytes(int G, int hd, int Tq, int Tk) {
  const int k = Tk * smem_row(G, hd, Traits<T>::kVec) *
                static_cast<int>(sizeof(T));
  const int w = G * Tk * queries_padded(Tq) * 4;
  return k > w ? k : w;
}
template <typename T>
int smem_bytes(int G, int hd, int Tq, int Tk) {
  return k_region_bytes<T>(G, hd, Tq, Tk) +
         Tk * smem_row(G, hd, Traits<T>::kVec) * static_cast<int>(sizeof(T));
}

// A block: (batch row, group of G heads); thread (h, i, p) for p in {0, 1}
// forms the scores of query i of head h against the first ceil(Tk / 2)
// keys (p 0) or the rest (p 1), at most TKP.
template <typename T, int TKP>
__global__ void __launch_bounds__(kMaxThreads)
    tiny_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ y,
                          const uint8_t* __restrict__ mask, int64_t q_sb,
                          int64_t q_st, int64_t k_sb, int64_t k_st,
                          int64_t v_sb, int64_t v_st, int64_t m_s0,
                          int64_t m_s1, int Tq, int Tk, int hd, int D, int G,
                          int groups, float scale) {
  constexpr int kVec = Traits<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = hd + kVec;                  // a head's padded columns
  const int row = smem_row(G, hd, kVec);
  const int tqp = queries_padded(Tq);
  T* k_s = reinterpret_cast<T*>(smem);
  float* w_s = reinterpret_cast<float*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + k_region_bytes<T>(G, hd, Tq, Tk));
  const int b = blockIdx.x / groups;
  const int col0 = (blockIdx.x - b * groups) * G * hd;
  const int pieces = hd / kVec;              // 16-byte pieces a head's row
  const int per_row = G * pieces;
  const int tid = threadIdx.x, nt = blockDim.x;

  // A thread copies one 16-byte column c of the group's rows (several
  // columns where the threads are fewer), every rows_at_once-th row.
  const int lanes = nt < per_row ? nt : per_row;
  const int rows_at_once = nt / lanes;
  const int r0 = tid / lanes, c0 = tid - r0 * lanes;
  auto copy_rows = [&](T* dst, const T* src, int64_t sb, int64_t st) {
    if (r0 >= rows_at_once) return;
    const T* base = src + b * sb + col0;
    for (int c = c0; c < per_row; c += lanes) {
      const int to = c * kVec + (c / pieces) * kVec;   // past the padding
      for (int r = r0; r < Tk; r += rows_at_once)
        cp_async16(dst + r * row + to, base + r * st + c * kVec);
    }
  };
  copy_rows(k_s, k, k_sb, k_st);
  cp_async_commit();
  copy_rows(v_s, v, v_sb, v_st);
  cp_async_commit();

  // 2. scores and softmax: thread (h, i, p); q's row read from device
  // memory into registers, one 16-byte piece ahead
  const bool owner = tid < 2 * G * Tq;
  const int pair = tid >> 1, p = tid & 1;
  const int h = pair / Tq, i = pair - h * Tq;
  const int half = (Tk + 1) >> 1;            // <= TKP
  const int j0 = p * half, mine = p ? Tk - half : half;
  const uint4* qr = reinterpret_cast<const uint4*>(
      q + b * q_sb + (owner ? i : 0) * q_st + col0 + (owner ? h : 0) * hd);
  uint4 qa = owner ? __ldg(qr) : make_uint4(0, 0, 0, 0);
  cp_async_wait<1>();
  __syncthreads();
  float s[TKP];
#pragma unroll
  for (int jj = 0; jj < TKP; ++jj) s[jj] = 0.f;
  if (owner) {
    const T* kr = k_s + j0 * row + h * hp;
    for (int c = 0; c < pieces; ++c) {
      const uint4 qc = qa;
      if (c + 1 < pieces) qa = __ldg(qr + c + 1);
#pragma unroll
      for (int jj = 0; jj < TKP; ++jj)
        if (jj < mine)
          s[jj] = __fadd_rn(
              s[jj], dot16<T>(qc, *reinterpret_cast<const uint4*>(
                                      kr + jj * row + c * kVec)));
    }
  }
  float m = -INFINITY;
  if (owner) {
#pragma unroll
    for (int jj = 0; jj < TKP; ++jj) {
      const int j = j0 + jj;
      if (jj < mine) {
        s[jj] = __fmul_rn(s[jj], scale);
        if (mask != nullptr && !mask[i * m_s0 + j * m_s1]) s[jj] = kMasked;
        m = fmaxf(m, s[jj]);
      }
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float sum = 0.f;
  if (owner) {
#pragma unroll
    for (int jj = 0; jj < TKP; ++jj)
      if (jj < mine) {
        s[jj] = expf(__fsub_rn(s[jj], m));
        sum = __fadd_rn(sum, s[jj]);
      }
  }
  sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
  __syncthreads();   // k's copy is read: the weights go over it
  if (owner) {
    float* wr = w_s + (h * Tk + j0) * tqp + i;
#pragma unroll
    for (int jj = 0; jj < TKP; ++jj)
      if (jj < mine) wr[jj * tqp] = round_to<T>(__fdiv_rn(s[jj], sum));
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. weights times v: thread (head, 4 queries, 4 channels)
  const int quads = hd / 4, qgroups = tqp / 4;
  for (int task = tid; task < G * qgroups * quads; task += nt) {
    const int c4 = task % quads, rest = task / quads;
    const int qg = rest % qgroups, hh = rest / qgroups;
    float acc[4][4] = {};
    const T* vc = v_s + hh * hp + c4 * 4;
    const float* wc = w_s + hh * Tk * tqp + qg * 4;
#pragma unroll 4
    for (int j = 0; j < Tk; ++j) {
      const float4 w4 = *reinterpret_cast<const float4*>(wc + j * tqp);
      const float4 v4 = load4<T>(vc + j * row);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][0] = madd<T>(acc[a][0], wv[a], v4.x);
        acc[a][1] = madd<T>(acc[a][1], wv[a], v4.y);
        acc[a][2] = madd<T>(acc[a][2], wv[a], v4.z);
        acc[a][3] = madd<T>(acc[a][3], wv[a], v4.w);
      }
    }
    T* yc = y + col0 + hh * hd + c4 * 4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = qg * 4 + a;
      if (qi < Tq) store4<T>(yc + (static_cast<int64_t>(b) * Tq + qi) * D,
                             acc[a]);
    }
  }
}

template <typename T, int TKP>
int launch(const void* q, const void* k, const void* v, void* y,
           const void* mask, int64_t q_sb, int64_t q_st, int64_t k_sb,
           int64_t k_st, int64_t v_sb, int64_t v_st, int64_t m_s0,
           int64_t m_s1, int B, int Tq, int Tk, int D, int hd, int G,
           int threads, int smem, float scale, cudaStream_t stream) {
  if (smem != smem_bytes<T>(G, hd, Tq, Tk) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB a block needs the opt-in, once a device.
  static bool opted_in[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && !opted_in[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        tiny_attention_kernel<T, TKP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[device] = true;
  }
  const int groups = D / hd / G;
  tiny_attention_kernel<T, TKP><<<B * groups, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(y),
      static_cast<const uint8_t*>(mask), q_sb, q_st, k_sb, k_st, v_sb, v_st,
      m_s0, m_s1, Tq, Tk, hd, D, G, groups, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tk(int Tk, const void* q, const void* k, const void* v, void* y,
              const void* mask, int64_t q_sb, int64_t q_st, int64_t k_sb,
              int64_t k_st, int64_t v_sb, int64_t v_st, int64_t m_s0,
              int64_t m_s1, int B, int Tq, int D, int hd, int G, int threads,
              int smem, float scale, cudaStream_t s) {
#define HQT_TA_LAUNCH(TKP)                                                   \
  launch<T, TKP>(q, k, v, y, mask, q_sb, q_st, k_sb, k_st, v_sb, v_st, m_s0, \
                 m_s1, B, Tq, Tk, D, hd, G, threads, smem, scale, s)
  const int half = (Tk + 1) / 2;     // keys a thread of a pair scores
  if (half <= 4) return HQT_TA_LAUNCH(4);
  if (half <= 8) return HQT_TA_LAUNCH(8);
  if (half <= 12) return HQT_TA_LAUNCH(12);
  return HQT_TA_LAUNCH(16);
#undef HQT_TA_LAUNCH
}

}  // namespace

// dtype (of q, k, v and y): 0 float32, 1 bfloat16. q [B, Tq, D], k and v
// [B, Tk, D] with batch and row strides in elements (channels contiguous),
// every row 16-byte aligned; y contiguous [B, Tq, D]; mask: null or bool
// [Tq, Tk] bytes with strides in elements. n_heads heads of hd = D /
// n_heads channels, hd a multiple of 8 up to 128; Tq, Tk in 1..32.
// heads_per_block, threads, smem_bytes: the wrapper's launch plan
// (ops/tiny_attention.py::launch_plan), refused unless it fits the
// kernel's layout. scale: 1 / sqrt(hd) in f32. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int hqt_tiny_attention(
    int dtype, const void* q, const void* k, const void* v, void* y,
    const void* mask, int64_t q_sb, int64_t q_st, int64_t k_sb, int64_t k_st,
    int64_t v_sb, int64_t v_st, int64_t m_s0, int64_t m_s1, int B, int Tq,
    int Tk, int D, int n_heads, int heads_per_block, int threads,
    int smem_bytes, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tq > kMaxT || Tk < 1 || Tk > kMaxT ||
      n_heads < 1 || D % n_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = D / n_heads, G = heads_per_block;
  if (hd % 8 != 0 || hd > kMaxHeadDim || G < 1 || n_heads % G != 0 ||
      threads % 32 != 0 || threads < 2 * G * Tq || threads > kMaxThreads ||
      static_cast<int64_t>(B) * (n_heads / G) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tk<float>(Tk, q, k, v, y, mask, q_sb, q_st, k_sb, k_st,
                            v_sb, v_st, m_s0, m_s1, B, Tq, D, hd, G, threads,
                            smem_bytes, scale, s);
  if (dtype == 1)
    return launch_tk<__nv_bfloat16>(Tk, q, k, v, y, mask, q_sb, q_st, k_sb,
                                    k_st, v_sb, v_st, m_s0, m_s1, B, Tq, D,
                                    hd, G, threads, smem_bytes, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
