// Single-token decode attention over the packed [L, T, B, D] KV cache.
//
// Replaces the TPU kernel hqtransformer_tpu/ops/pallas_attention.py::
// decode_attention_step (kernel body `_kernel`). Per call: write the new K/V
// row of layer `layer` at time `pos` in place, then for every (batch row b,
// head h) attend the head's query against cache rows t < pos plus the new
// token itself: scores q.k / sqrt(hd) in f32, softmax in f32, A.V
// accumulated in f32, output written in the query's dtype.
//
// q and y are f32 or bf16; the caches and the new rows are of q's type or
// int8. An int8 cache holds per-channel quantized K/V whose scales the
// caller folds outside the kernel (K's into q, V's into y, as the TPU
// kernel's caller does), so the kernel computes with the int8 values
// themselves and stays scale-free.
//
// What bounds it on an H100: bytes. Each call reads 2 * pos * B * D cache
// elements and does 4 flops per element read, far below the ~295 flops per
// byte where the tensor cores would become the limit, so the least time is
// the cache prefix over 3.35 TB/s; an int8 cache halves it against bf16.
//
// Float caches (decode_attention_kernel): one memory round trip. A block
// owns one batch row b and a pair of heads, one warp a head; for fixed
// (layer, t, b) the pair's slice of a cache row is one contiguous segment
// (256 bytes at hd 64 in bf16). Before any thread computes, every thread
// issues 16-byte asynchronous copies (cp.async) of the K and V segments of
// rows t < pos into shared memory, so the whole prefix the block needs is
// in flight at once (as the TPU kernel DMAs a batch tile's prefix into
// VMEM). Rows at or beyond pos are never read, so stale rows need no
// masking. While the copies fly, each warp loads its head's q, k_new and
// v_new and scores the new token. Once the copies land, a warp takes
// 32 / (hd / v) rows at a time, v cache elements (16 bytes) a lane: a score
// is a reduction over hd / v lanes (8 at hd 64 in bf16), and each group of
// lanes keeps its own online softmax (max, sum and f32 accumulator, all
// starting from the new token's score) over the rows it takes. The groups
// then merge with a fixed butterfly of shuffles, so the result does not
// change from run to run. A prefix longer than shared memory holds (32 KB a
// round: 64 rows at hd 64 in bf16) is taken in rounds that reuse the
// buffer.
//
// int8 caches (decode_attention_int8_kernel). At batch 128 a call is one
// wave of small, identical warps, and besides the bytes its time went to
// three things, each found by timing the kernel with it taken out
// (`python3 chip_smoke.py --k1-only` sweeps every position):
// - Arrival order. Issued all at once, a warp's copies land in no useful
//   order (the memory system serves every warp's requests together), so
//   every warp computed after its last byte. Here a warp copies only its
//   own head's 64-byte slice of each row (cp.async, 16 bytes a lane) in
//   16-row stages, K's stages then V's, each its own commit group, and
//   keeps two groups in flight: waiting for group g puts group g + 2 in
//   flight, so a warp's groups land in order and each is consumed while
//   the next one flies. q and the new rows are loaded before any copy is
//   issued (issued after, they queue behind the prefix).
// - Instruction issue. Every warp of the wave runs the same code at once,
//   so the SMs' issue slots, more than latency, set the compute time.
//   Scores are exact integer sums: q becomes a fixed point of the head,
//   round(q * 2^shift) = hi * 2^16 + lo with |q| * 2^shift < 2^30 (split16
//   splits it with float adds, no conversion instruction; each lane splits
//   one column pair and shuffles gather them), and one dp2a adds two
//   16-bit x 8-bit products straight from a word of four cache bytes, so
//   K is never widened: 1 instruction an element instead of 3.25. V is
//   widened for the f32 P.V by a byte permute under the exponent of 2^23
//   and one subtraction (widen_cols, exact for all 256 bytes), not by I2F.S8,
//   which an SM issues for 16 values a clock. (Exact integer P.V, rows
//   paired by a byte permute into dp2a, needed more registers than one
//   wave allows and was slower.)
// - Fixed work per warp. The new token is row 0 of the first round's
//   buffer, scored and weighed like any cache row. Scores first, then one
//   softmax (one max, one expf a row, one sum), then P.V with each lane
//   on hd / 32 adjacent columns over every row, so y needs no reduction
//   across lanes (a reduction through shared memory at the end cost more
//   than the rows' extra loads). No per-row rescaling.
//   A prefix longer than 64 rows runs in rounds whose softmax states merge
//   (one rescale a round).
// Launch: one warp a head, hpb heads a block, chosen by the wrapper
// (ops/decode_attention.py::_launch_plan): a whole batch row (up to 24
// heads: fewer blocks, whole cache rows read) while B blocks fit one wave
// (batch 128 on 132 SMs); beyond (batch 1024), 4 heads a block, so that
// blocks of several waves overlap on an SM. The wrapper also sizes the
// shared memory, at least i8_warp_bytes a warp (up to 206 KB a block,
// opted in once a device). The wrapper's
// widen_int8_words and q_fixed_point are plain mirrors of the widening and
// the fixed point.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kHeadsPerBlock = 2;  // one warp each
constexpr int kThreads = 32 * kHeadsPerBlock;
constexpr int kRoundBytes = 32 * 1024;  // K and V rows staged per round
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

// Rows of the cache prefix one round stages, for element type T, head dim
// HD.
template <typename T, int HD>
__host__ __device__ constexpr int rows_per_round() {
  return kRoundBytes / (2 * kHeadsPerBlock * HD * static_cast<int>(sizeof(T)));
}

// T: the type of q, y, the caches, k_new and v_new (f32 or bf16).
// Grid: B * ceil(n_heads / 2) blocks of kThreads; dynamic shared memory
// 2 * min(pos, rows_per_round) * 2 * HD * sizeof(T) bytes.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, int64_t q_stride,
                        int64_t kn_stride, int64_t vn_stride, T* k_cache,
                        T* v_cache, T* __restrict__ y, int B, int T_max, int D,
                        int n_heads, int layer, int pos, float scale) {
  constexpr int kVec = 16 / sizeof(T);   // cache elements a lane loads at once
  constexpr int kLanes = HD / kVec;      // lanes per row of a head
  constexpr int kRowsAtOnce = 32 / kLanes;
  constexpr int kRound = rows_per_round<T, HD>();
  extern __shared__ __align__(16) uint8_t smem[];

  const int groups = (n_heads + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) * kHeadsPerBlock;
  const int heads = min(kHeadsPerBlock, n_heads - h0);
  const int seg = heads * HD;  // elements of the block's slice of a row
  const uint32_t seg_bytes = seg * sizeof(T);
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
  const T* ks = reinterpret_cast<const T*>(smem);
  const T* vs = ks + min(pos, kRound) * seg;

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
    load_vec<T, kVec>(k_new + b * kn_stride + col, kn);
    load_vec<T, kVec>(v_new + b * vn_stride + col, vn);
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
          load_vec<T, kVec>(ks + r * seg + warp * HD + sub * kVec, kk);
#pragma unroll
          for (int i = 0; i < kVec; ++i) d += qf[i] * kk[i];
        }
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFullMask, d, off);
        if (valid) {
          load_vec<T, kVec>(vs + r * seg + warp * HD + sub * kVec, vv);
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

// ------------------------------------------------------------ int8 caches

constexpr int kI8Heads = 24;       // heads (warps) a block, at most
constexpr int kI8RoundRows = 64;   // cache rows a warp stages per round
constexpr int kI8StageRows = 16;   // rows per cp.async commit group
constexpr int kI8Window = 2;       // commit groups a warp keeps in flight

// Shared memory of one warp for a round of `rows` buffer rows: q's 64
// words, K rows, V rows, then the rows' scores. The kernel computes its
// warps' stride from it: a stride passed in at run time, which the
// compiler cannot know to be a multiple of 16, made every call about
// 0.15 us slower at batch 128.
__host__ __device__ constexpr int i8_warp_bytes(int rows, int hd) {
  return 256 + (2 * rows * hd + 4 * rows + 15) / 16 * 16;
}

// Wait until at most kI8Window - 1 of this thread's latest cp.async groups
// are pending.
__device__ __forceinline__ void cp_async_wait_window() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kI8Window - 1) : "memory");
}

// d + a.h0 * b.b0 + a.h1 * b.b1 (lo: bytes 0, 1 of b; hi: bytes 2, 3),
// a two signed 16-bit halves, b four signed bytes.
__device__ __forceinline__ int dp2a_lo(uint32_t a, uint32_t b, int d) {
  asm("dp2a.lo.s32.s32 %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ int dp2a_hi(uint32_t a, uint32_t b, int d) {
  asm("dp2a.hi.s32.s32 %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b));
  return d;
}

// x (|x| < 2^30) rounded to the nearest integer (ties to even) as hi *
// 2^16 + lo, lo in [-2^15, 2^15), without a conversion instruction: adding
// 1.5 * 2^23 rounds a float of magnitude below 2^22 to an integer, which
// the float's low bits then hold.
__device__ __forceinline__ void split16(float x, int& hi, int& lo) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
  const float t = __fmaf_rn(x, 1.f / 65536.f, kMagic);  // round(x / 2^16)
  hi = __float_as_int(t) - __float_as_int(kMagic);
  const float rest = __fmaf_rn(-(t - kMagic), 65536.f, x);  // exact
  lo = __float_as_int(rest + kMagic) - __float_as_int(kMagic);
  if (lo == 32768) {  // round(rest) may reach 2^15: carry it into hi
    hi += 1;
    lo -= 65536;
  }
}

// N (1 or 2) int8 values at p widened to f32 without a conversion
// instruction: k ^ 0x80 is the byte k + 128; a byte permute puts it under
// the exponent byte 0x4B, the f32 2^23 + k + 128 (exact), and subtracting
// 2^23 + 128 leaves k exactly, for all 256 values.
template <int N>
__device__ __forceinline__ void widen_cols(const int8_t* p, float (&out)[N]) {
  uint32_t u;
  if constexpr (N == 2)
    u = *reinterpret_cast<const uint16_t*>(p);
  else
    u = *reinterpret_cast<const uint8_t*>(p);
  u ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) -
             8388736.f;
}

// N (1 or 2) adjacent values stored as T, in one store.
template <typename T, int N>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[N]) {
  if constexpr (N == 1) {
    p[0] = from_f32<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// T: the type of q and y; hpb heads a block. Grid: B * ceil(n_heads / hpb)
// blocks of 32 * hpb threads; dynamic shared memory at least hpb *
// i8_warp_bytes(min(pos, kI8RoundRows) + 1, HD). Warp w of a block takes
// head (block % groups) * hpb + w of batch row block / groups, alone.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kI8Heads)
decode_attention_int8_kernel(const T* __restrict__ q,
                             const int8_t* __restrict__ k_new,
                             const int8_t* __restrict__ v_new,
                             int64_t q_stride, int64_t kn_stride,
                             int64_t vn_stride, int8_t* k_cache,
                             int8_t* v_cache, T* __restrict__ y, int B,
                             int T_max, int D, int n_heads, int hpb,
                             int layer, int pos, float scale) {
  constexpr int kLanes = HD / 16;          // lanes per row of a head
  constexpr int kRowsAtOnce = 32 / kLanes;
  static_assert(kI8StageRows % kRowsAtOnce == 0, "whole row steps a stage");
  extern __shared__ __align__(16) uint8_t smem[];

  const int groups = (n_heads + hpb - 1) / hpb;
  const int b = blockIdx.x / groups;
  const int warp = threadIdx.x >> 5;
  const int h = (blockIdx.x - b * groups) * hpb + warp;
  if (h >= n_heads) return;  // no barrier spans warps
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;  // which 16 columns of the head
  const int grp = lane / kLanes;  // which of the rows taken at once
  const int col = h * HD + sub * 16;

  // Buffer rows of a round: round 0 holds the new token in row 0 and
  // cache rows 0.. after it; later rounds hold cache rows only.
  const int buf_rows = min(pos, kI8RoundRows) + 1;
  uint8_t* base = smem + warp * i8_warp_bytes(buf_rows, HD);
  uint32_t* qbuf = reinterpret_cast<uint32_t*>(base);  // q's 64 words
  int8_t* kbuf = reinterpret_cast<int8_t*>(base + 256);
  int8_t* vbuf = kbuf + buf_rows * HD;
  float* sbuf = reinterpret_cast<float*>(vbuf + buf_rows * HD);

  // Element (layer, t, b, h * HD) sits at slice + t * row.
  const int64_t row = static_cast<int64_t>(B) * D;
  const int64_t slice = static_cast<int64_t>(layer) * T_max * row +
                        static_cast<int64_t>(b) * D + h * HD;
  // A round of nb buffer rows, the first `off` of them not from the cache
  // (the new token's), is 2 * stages commit groups of kI8StageRows buffer
  // rows: K's stages, then V's. Group g in flight: lane (grp, sub) copies
  // the 16 bytes at column sub * 16 of buffer rows grp, grp + kRowsAtOnce,
  // ... of the stage (g past the last commits an empty group, so that
  // every lane has always committed the same number).
  auto issue = [&](int t0, int off, int nb, int stages, int g) {
    if (g < 2 * stages) {
      const bool is_v = g >= stages;
      const int s0 = (is_v ? g - stages : g) * kI8StageRows;
      const int end = min(nb, s0 + kI8StageRows);
      const int8_t* src = (is_v ? v_cache : k_cache) + slice + sub * 16;
      const uint32_t dst = smem_u32(is_v ? vbuf : kbuf) + sub * 16;
#pragma unroll
      for (int j = 0; j < kI8StageRows / kRowsAtOnce; ++j) {
        const int br = s0 + grp + j * kRowsAtOnce;
        if (br >= off && br < end)
          cp_async16(dst + br * HD, src + (t0 + br - off) * row);
      }
    }
    cp_async_commit();
  };
  // The window over a round's groups: the first kI8Window go in flight at
  // once; each wait for group g then puts group g + kI8Window in flight, so
  // a warp's groups land in order and each is consumed while the next
  // ones fly (issued all at once, a warp's stages land in no useful order:
  // the memory system serves every warp's requests together).
  auto open_round = [&](int t0, int off, int nb, int stages) {
#pragma unroll
    for (int g = 0; g < kI8Window; ++g) issue(t0, off, nb, stages, g);
  };
  auto next_group = [&](int t0, int off, int nb, int stages, int g) {
    cp_async_wait_window();  // groups up to g have landed
    __syncwarp();
    issue(t0, off, nb, stages, g + kI8Window);
  };
  // q and the new rows are loaded before the cache copies are issued:
  // issued after them, they would queue behind the whole prefix, and every
  // score waits for q. Each lane loads the head's column pair lane % (hd /
  // 2) of q; row group 0 alone loads the new rows.
  const int qpair = lane % (HD / 2);
  const T* qp = q + b * q_stride + h * HD + 2 * qpair;
  const float q0 = to_f32(qp[0]), q1 = to_f32(qp[1]);
  uint4 kn_raw = make_uint4(0, 0, 0, 0), vn_raw = kn_raw;
  if (grp == 0) {
    kn_raw = *reinterpret_cast<const uint4*>(k_new + b * kn_stride + col);
    vn_raw = *reinterpret_cast<const uint4*>(v_new + b * vn_stride + col);
  }
  const int nb0 = buf_rows;
  const int stages0 = (nb0 + kI8StageRows - 1) / kI8StageRows;
  open_round(0, 1, nb0, stages0);

  // q as a fixed point of the head: round(q_i * 2^shift) = hi_i * 2^16 +
  // lo_i, |q_i| * 2^shift < 2^30 (the head's largest |q| sets shift). A
  // score is then exact integer sums of 16-bit by 8-bit products (dp2a:
  // four int8 a word, no widening), scaled back once: sum * 2^-shift /
  // sqrt(hd). ops/decode_attention.py::q_fixed_point is the plain mirror.
  // Each lane splits its column pair into words qbuf[pair] (hi halves) and
  // qbuf[32 + pair] (lo halves); lane (grp, sub) then reads the 8 pairs of
  // its 16 columns.
  // The head's largest |q|, as bits: their unsigned order is that of
  // the magnitudes, then infinity, then NaN, so its biased exponent E is
  // 255 where the head holds a NaN or an infinity. Such a head gets NaN in
  // y, as its scores and softmax would give (the fixed point holds
  // neither).
  uint32_t qbits = max(__float_as_uint(q0) & 0x7FFFFFFFu,
                       __float_as_uint(q1) & 0x7FFFFFFFu);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    qbits = max(qbits, __shfl_xor_sync(kFullMask, qbits, o));
  const int biased = static_cast<int>(qbits >> 23);
  const bool finite = biased != 255;
  // max |q| = 1.f * 2^(E - 127) < 2^(E - 126); q values below 2^-70 of the
  // largest (or q all below 2^-70) keep fewer bits.
  const int shift = max(-100, min(100, 156 - biased));
  const float up = __int_as_float((127 + shift) << 23);    // 2^shift
  const float down = __int_as_float((127 - shift) << 23);  // 2^-shift
  int h0, l0, h1, l1;
  split16(q0 * up, h0, l0);
  split16(q1 * up, h1, l1);
  const uint32_t pair_hi = (static_cast<uint32_t>(h0) & 0xFFFFu) |
                           (static_cast<uint32_t>(h1) << 16);
  const uint32_t pair_lo = (static_cast<uint32_t>(l0) & 0xFFFFu) |
                           (static_cast<uint32_t>(l1) << 16);
  qbuf[qpair] = pair_hi;
  qbuf[32 + qpair] = pair_lo;
  __syncwarp();
  uint32_t qhi[8], qlo[8];
#pragma unroll
  for (int w = 0; w < 8; w += 4) {
    const uint4 a = *reinterpret_cast<const uint4*>(qbuf + sub * 8 + w);
    const uint4 c = *reinterpret_cast<const uint4*>(qbuf + 32 + sub * 8 + w);
    qhi[w] = a.x, qhi[w + 1] = a.y, qhi[w + 2] = a.z, qhi[w + 3] = a.w;
    qlo[w] = c.x, qlo[w + 1] = c.y, qlo[w + 2] = c.z, qlo[w + 3] = c.w;
  }
  const float unscale = scale * down;

  // While the copies fly: the new rows become buffer row 0 of round 0
  // (scored and weighed like any other row) and are persisted bit for bit
  // (rows < pos are all that is read).
  if (grp == 0) {
    *reinterpret_cast<uint4*>(kbuf + sub * 16) = kn_raw;
    *reinterpret_cast<uint4*>(vbuf + sub * 16) = vn_raw;
    const int64_t at = slice + pos * row + sub * 16;
    *reinterpret_cast<uint4*>(k_cache + at) = kn_raw;
    *reinterpret_cast<uint4*>(v_cache + at) = vn_raw;
  }
  // The softmax state, the same in every lane: running max and sum. P.V
  // puts each lane on kCols adjacent columns of the head, over every row,
  // so y needs no reduction across lanes.
  float m = -INFINITY, l = 0.f;
  constexpr int kCols = HD / 32;
  const int c0 = lane * kCols;
  float acc[kCols] = {};

  for (int t0 = 0, off = 1; t0 < pos || off; t0 += kI8RoundRows, off = 0) {
    const int nb = off ? nb0 : min(pos - t0, kI8RoundRows);
    const int stages = (nb + kI8StageRows - 1) / kI8StageRows;
    if (!off) {
      __syncwarp();  // every lane is done with the previous round's rows
      open_round(t0, 0, nb, stages);
    }
    // Scores of every row, a stage at a time as it lands.
    for (int s = 0; s < stages; ++s) {
      next_group(t0, off, nb, stages, s);
      const int end = min(nb, (s + 1) * kI8StageRows);
#pragma unroll
      for (int j = 0; j < kI8StageRows / kRowsAtOnce; ++j) {
        if (s * kI8StageRows + j * kRowsAtOnce >= end) break;  // uniform
        const int r = s * kI8StageRows + j * kRowsAtOnce + grp;
        int hi = 0, lo = 0;
        if (r < end) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(kbuf + r * HD + sub * 16);
          const uint32_t kw[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hi = dp2a_lo(qhi[2 * i], kw[i], hi);
            hi = dp2a_hi(qhi[2 * i + 1], kw[i], hi);
            lo = dp2a_lo(qlo[2 * i], kw[i], lo);
            lo = dp2a_hi(qlo[2 * i + 1], kw[i], lo);
          }
        }
        // |hi| <= 2^14 * 128 * 64, |lo| <= 2^15 * 128 * 64: no overflow.
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) {
          hi += __shfl_xor_sync(kFullMask, hi, o);
          lo += __shfl_xor_sync(kFullMask, lo, o);
        }
        if (r < end && sub == 0)
          sbuf[r] = __ll2float_rn((static_cast<long long>(hi) << 16) + lo) *
                    unscale;
      }
    }
    __syncwarp();
    // One softmax over the round: its max, a weight per row, its sum.
    float m_r = m;
    for (int r = lane; r < nb; r += 32) m_r = fmaxf(m_r, sbuf[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m_r = fmaxf(m_r, __shfl_xor_sync(kFullMask, m_r, o));
    float sum = 0.f;
    for (int r = lane; r < nb; r += 32) {
      const float p = expf(sbuf[r] - m_r);
      sbuf[r] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(kFullMask, sum, o);
    const float corr = expf(m - m_r);  // 0 in round 0, where m is -inf
    l = l * corr + sum;
    m = m_r;
    if (!off) {  // round 0's accumulators are still zero
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] *= corr;
    }
    __syncwarp();
    // P.V, a stage at a time as it lands: every lane takes every row, its
    // kCols bytes of the row widened and weighed by the row's p.
    for (int s = 0; s < stages; ++s) {
      next_group(t0, off, nb, stages, stages + s);
      const int end = min(nb, (s + 1) * kI8StageRows);
      for (int r = s * kI8StageRows; r < end; ++r) {
        const float p = sbuf[r];
        float vv[kCols];
        widen_cols<kCols>(vbuf + r * HD + c0, vv);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] += p * vv[j];
      }
    }
  }

  const float inv = finite ? 1.f / l : NAN;
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] *= inv;
  store_cols<T, kCols>(y + static_cast<int64_t>(b) * D + h * HD + c0, acc);
}

template <typename T, int HD>
int launch_int8(const void* q, const void* k_new, const void* v_new,
                int64_t q_stride, int64_t kn_stride, int64_t vn_stride,
                void* k_cache, void* v_cache, void* y, int B, int T_max,
                int D, int n_heads, int hpb, int smem, int layer, int pos,
                cudaStream_t stream) {
  constexpr int kMaxSmem = kI8Heads * i8_warp_bytes(kI8RoundRows + 1, HD);
  if (hpb < 1 || hpb > kI8Heads ||
      smem < hpb * i8_warp_bytes(std::min(pos, kI8RoundRows) + 1, HD) ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB a block needs the opt-in, once a device.
  static bool opted_in[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && !opted_in[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_int8_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[device] = true;
  }
  const int blocks = B * ((n_heads + hpb - 1) / hpb);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  decode_attention_int8_kernel<T, HD><<<blocks, 32 * hpb, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), q_stride, kn_stride, vn_stride,
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<T*>(y), B, T_max, D, n_heads, hpb, layer, pos, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k_new, const void* v_new,
           int64_t q_stride, int64_t kn_stride, int64_t vn_stride,
           void* k_cache, void* v_cache, void* y, int B, int T_max, int D,
           int n_heads, int layer, int pos, cudaStream_t stream) {
  const int blocks = B * ((n_heads + kHeadsPerBlock - 1) / kHeadsPerBlock);
  const int smem = 2 * std::min(pos, rows_per_round<T, HD>()) *
                   kHeadsPerBlock * HD * static_cast<int>(sizeof(T));
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  decode_attention_kernel<T, HD><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), q_stride, kn_stride, vn_stride,
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), static_cast<T*>(y),
      B, T_max, D, n_heads, layer, pos, scale);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, HD>) for the supported head dims.
template <typename F>
int with_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (of q and y): 0 = float32, 1 = bfloat16; cache_dtype (of the caches,
// k_new and v_new): the same code, or 2 = int8. q, k_new, v_new: [B, D]
// with row strides in elements; caches: contiguous [L, T_max, B, D]; y:
// contiguous [B, D]. Every pointer and row is 16-byte aligned.
// heads_per_block and smem_bytes: the int8 kernel's launch, planned by the
// wrapper (_launch_plan); 0 for float caches, whose launch is fixed.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hqt_decode_attention_step(
    int dtype, int cache_dtype, const void* q, const void* k_new,
    const void* v_new, int64_t q_stride, int64_t kn_stride, int64_t vn_stride,
    void* k_cache, void* v_cache, void* y, int B, int T_max, int D,
    int n_heads, int layer, int pos, int heads_per_block, int smem_bytes,
    void* stream) {
  if (n_heads <= 0 || D % n_heads != 0 || pos < 0 || pos >= T_max ||
      (dtype != 0 && dtype != 1) ||
      (cache_dtype != dtype && cache_dtype != 2) ||
      (cache_dtype != 2 && (heads_per_block != 0 || smem_bytes != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(D / n_heads, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    if (cache_dtype == 2)
      return dtype == 0
                 ? launch_int8<float, HD>(
                       q, k_new, v_new, q_stride, kn_stride, vn_stride,
                       k_cache, v_cache, y, B, T_max, D, n_heads,
                       heads_per_block, smem_bytes, layer, pos, s)
                 : launch_int8<__nv_bfloat16, HD>(
                       q, k_new, v_new, q_stride, kn_stride, vn_stride,
                       k_cache, v_cache, y, B, T_max, D, n_heads,
                       heads_per_block, smem_bytes, layer, pos, s);
    return dtype == 0
               ? launch<float, HD>(q, k_new, v_new, q_stride, kn_stride,
                                   vn_stride, k_cache, v_cache, y, B, T_max,
                                   D, n_heads, layer, pos, s)
               : launch<__nv_bfloat16, HD>(q, k_new, v_new, q_stride,
                                           kn_stride, vn_stride, k_cache,
                                           v_cache, y, B, T_max, D, n_heads,
                                           layer, pos, s);
  });
}
