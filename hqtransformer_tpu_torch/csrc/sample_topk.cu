// Fused top-k filtered categorical sampling, one uniform per row.
//
// Replaces the TPU kernel hqtransformer_tpu/ops/pallas_sample.py::
// _sample_topk_2d (kernel body `_sample_kernel`) with the same arithmetic:
//   x = f32(logits) / temperature;  row_max = max(x)
//   threshold: if k < V, 26 bisection steps on [row_max - 44, row_max + 1e-6]
//     with mid = 0.5 * (lo + hi) in f32 and count(x >= mid); count >= k moves
//     lo up, else hi down; a row freezes on an exact count == k. If k >= V,
//     the threshold is min(x). With `bisect3` (the TPU kernel's
//     `threshold3`), 13 passes instead, each counting at the bracket's
//     quartile points m_i = lo + {0.25, 0.5, 0.75} * (hi - lo): lo goes to
//     the largest m_i with count >= k, hi to the smallest without, and a
//     row freezes where any probe counts exactly k.
//   p = (x >= thr) ? exp(x - row_max) : 0;  cdf = inclusive prefix sum of p
//   draw = max(u * total, 1e-30);  idx0 = count(cdf < draw)
//   code = the largest index <= idx0 with p > 0 (snap down, so a rounding
//     sliver of the f32 CDF can never select a filtered token).
// Only the order of the f32 CDF sum differs from the plain version.
//
// The threshold without a count per bisection step. The bisection's path
// depends on the row through three numbers only: row_max, v_k (the k-th
// largest x counted with multiplicity) and v_{k+1}. At any mid,
// count(x >= mid) >= k exactly when mid <= v_k, and count == k exactly
// when v_{k+1} < mid <= v_k. So the kernel finds v_k exactly by a radix
// select and v_{k+1} from it (v_k again on a tie, which the select's last
// histogram shows, else the largest value below v_k, by one block
// reduction), and replays the 26 steps in one thread with the same f32
// arithmetic and the same early stop (the quartile search likewise, its
// products and sums rounded apart, as the TPU kernel's are: no fused
// multiply-add). The replay compares floats, as the
// counts do, so its threshold is bit-identical to the bisection's, ties at
// the k-th value and +-0 included (-0 and +0 have distinct keys but compare
// equal); a row whose k-th value lies below row_max - 44 comes out at
// row_max - 44, as before. IEEE division by a positive temperature is
// monotone, so the k-th largest x is the k-th largest logit divided by the
// temperature: the select and the reductions run on the logits as stored,
// and only their results and the CDF pass divide. Logits must not be NaN.
//
// The radix select works on an order-preserving key of each logit (the
// sign bit flipped for +0 and up, every bit for negatives): 16 bits for
// bf16, selected in two passes of 8 bits, 32 bits for f32, in three of 11,
// 11 and 10 bits, most significant digit first. Each pass counts the
// values whose key matches the prefix chosen so far into a shared-memory
// histogram (shared atomics, which the hardware aggregates within a warp),
// then one block suffix scan over the bins finds the bin where the count
// from the top reaches the rank still sought: three barriers a pass, 12 a
// bf16 row in all, where 26 block-wide count reductions took about 55.
// In bf16 a 256-bin histogram gives each thread one bin to clear and scan.
//
// What bounds it on an H100: bytes. The kernel reads each logit once (16 KB
// a row in bf16 at V = 8192) and writes one int per row; its f32 work is
// about 11 operations a logit (the select's passes, the max, the divide,
// mask, exp, running sum, draw count), which the f32 rate does in a quarter
// of the bytes' time. In practice the instructions a logit likely set its
// time (the split is not measured): each IEEE divide by the temperature
// takes a reciprocal on the special function unit and a range check, and
// the exp another special function.
//
// Design: one block of 256 threads per row, VPT = ceil(V / 256) contiguous
// logits per thread (32 at V = 8192), read 16 bytes at a time where the row
// is aligned and kept in registers as stored (bf16 two to a register), so
// the select never goes back to device memory; the CDF pass turns them
// into the thread's running sums. The CDF is a per-thread running sum plus
// a block-wide exclusive scan of the thread sums; only the thread where
// the draw falls compares its sums one by one. A ragged V is padded with
// a negative NaN, which every step skips.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 26;
constexpr int kBisect3Iters = 13;  // 44 / 4^13 == 44 / 2^26
constexpr float kBisectRange = 44.0f;
constexpr unsigned kFullMask = 0xffffffffu;

// A thread's VPT logits as stored, with their order-preserving keys. Slots
// past the end of the row hold the bits of a negative NaN, whose key is 0,
// below every number's: the select never reaches them (k < V), fmaxf and
// fminf skip them and `x >= thr` is false for them.
template <typename T, int VPT>
struct Row;

template <int VPT>
struct Row<float, VPT> {
  static constexpr int kKeyBits = 32;
  static constexpr int kMaxBins = 2048;  // the widest digit, 11 bits
  uint32_t w[VPT];

  __device__ __forceinline__ float value(int e) const {
    return __uint_as_float(w[e]);
  }
  __device__ __forceinline__ uint32_t key(int e) const {
    const uint32_t b = w[e];
    return b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) |
                0x80000000u);
  }
  static __device__ __forceinline__ float from_key(uint32_t key) {
    return __uint_as_float(key ^ ((key >> 31) ? 0x80000000u : 0xffffffffu));
  }
  __device__ __forceinline__ uint32_t max_key() const {
    uint32_t m = 0;
#pragma unroll
    for (int e = 0; e < VPT; ++e) m = max(m, key(e));
    return m;
  }
  __device__ __forceinline__ void load(const float* __restrict__ xr, int j0,
                                       int V, bool vec) {
    if (VPT % 4 == 0 && vec && j0 + VPT <= V) {
#pragma unroll
      for (int c = 0; c < VPT; c += 4) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(xr + j0 + c));
        w[c] = q.x;
        w[c + 1] = q.y;
        w[c + 2] = q.z;
        w[c + 3] = q.w;
      }
    } else {
      const uint32_t* raw = reinterpret_cast<const uint32_t*>(xr);
#pragma unroll
      for (int e = 0; e < VPT; ++e)
        w[e] = j0 + e < V ? __ldg(raw + j0 + e) : 0xffffffffu;
    }
  }
};

template <int VPT>
struct Row<__nv_bfloat16, VPT> {
  static constexpr int kKeyBits = 16;
  static constexpr int kMaxBins = 256;  // two digits of 8 bits
  uint32_t w[(VPT + 1) / 2];  // two bf16 a register, the lower index low

  // The keys of the two values of register i, in the same halves.
  __device__ __forceinline__ uint32_t key_pair(int i) const {
    const uint32_t b = w[i];
    return b ^ ((((b >> 15) & 0x00010001u) * 0x7fffu) | 0x80008000u);
  }
  __device__ __forceinline__ float value(int e) const {
    const uint32_t b = w[e >> 1];
    return __uint_as_float((e & 1) ? b & 0xffff0000u : b << 16);
  }
  __device__ __forceinline__ uint32_t key(int e) const {
    return (key_pair(e >> 1) >> (16 * (e & 1))) & 0xffffu;
  }
  static __device__ __forceinline__ float from_key(uint32_t key) {
    return __uint_as_float((key ^ ((key >> 15) ? 0x8000u : 0xffffu)) << 16);
  }
  __device__ __forceinline__ uint32_t max_key() const {
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < (VPT + 1) / 2; ++i) m = __vmaxu2(m, key_pair(i));
    return max(m & 0xffffu, m >> 16);
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ xr,
                                       int j0, int V, bool vec) {
    if (VPT % 8 == 0 && vec && j0 + VPT <= V) {
#pragma unroll
      for (int c = 0; c < VPT; c += 8) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(xr + j0 + c));
        w[c / 2] = q.x;
        w[c / 2 + 1] = q.y;
        w[c / 2 + 2] = q.z;
        w[c / 2 + 3] = q.w;
      }
    } else {
      const unsigned short* raw = reinterpret_cast<const unsigned short*>(xr);
#pragma unroll
      for (int e = 0; e < VPT; e += 2) {
        const uint32_t lo = j0 + e < V ? __ldg(raw + j0 + e) : 0xffffu;
        const uint32_t hi =
            e + 1 < VPT && j0 + e + 1 < V ? __ldg(raw + j0 + e + 1) : 0xffffu;
        w[e / 2] = lo | hi << 16;
      }
    }
  }
};

// One digit of the radix select: the bits [SHIFT, SHIFT + BITS) of the
// key, among the values whose higher key bits equal `prefix`. On return
// `prefix` also holds the digit of the key of rank `rank` (1 = the
// largest) among those values, `rank` the rank still sought among the
// values with that digit, and `count` how many values have it. `hist`
// holds zeros on entry and again on return; thread t owns the bins
// [t * kPerThread, (t + 1) * kPerThread).
template <int SHIFT, int BITS, int KEY_BITS, int VPT, typename R>
__device__ __forceinline__ void radix_pass(const R& row, uint32_t& prefix,
                                           int& rank, int& count, int* hist,
                                           int* sh_warp, int* sh_sel) {
  constexpr int kBins = 1 << BITS;
  constexpr int kPerThread = kBins >= kThreads ? kBins / kThreads : 1;
  constexpr uint32_t kHigh =  // the key bits above this digit
      SHIFT + BITS >= KEY_BITS ? 0u : ~0u << ((SHIFT + BITS) & 31);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int e = 0; e < VPT; ++e) {
    const uint32_t key = row.key(e);
    if ((key & kHigh) == prefix)
      atomicAdd(hist + ((key >> SHIFT) & (kBins - 1)), 1);
  }
  __syncthreads();

  // Higher bins hold larger keys, so the count from the top is a suffix
  // sum. Each thread reads its bins and zeroes them: only it reads them,
  // and the next pass adds to them after two more barriers.
  const int first = tid * kPerThread;
  int h[kPerThread] = {};
  int own = 0;
  if (first < kBins) {
    if constexpr (kPerThread % 4 == 0) {
      int4* mine = reinterpret_cast<int4*>(hist + first);
#pragma unroll
      for (int q = 0; q < kPerThread / 4; ++q) {
        const int4 v = mine[q];
        h[4 * q] = v.x;
        h[4 * q + 1] = v.y;
        h[4 * q + 2] = v.z;
        h[4 * q + 3] = v.w;
        mine[q] = make_int4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int b = 0; b < kPerThread; ++b) {
        h[b] = hist[first + b];
        hist[first + b] = 0;
      }
    }
#pragma unroll
    for (int b = 0; b < kPerThread; ++b) own += h[b];
  }
  int incl = own;  // inclusive suffix sum within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_down_sync(kFullMask, incl, off);
    if (lane + off < 32) incl += n;
  }
  if (lane == 0) sh_warp[warp] = incl;
  __syncthreads();
  int above = incl - own;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w > warp) above += sh_warp[w];
  if (above < rank && above + own >= rank) {
    // This thread's bins hold the key sought: walk them from the top.
    int acc = above, sel = 0, sel_above = 0, sel_count = 0;
    bool found = false;
#pragma unroll
    for (int b = kPerThread - 1; b >= 0; --b) {
      if (!found && acc + h[b] >= rank) {
        sel = first + b;
        sel_above = acc;
        sel_count = h[b];
        found = true;
      }
      acc += h[b];
    }
    sh_sel[0] = sel;
    sh_sel[1] = sel_above;
    sh_sel[2] = sel_count;
  }
  __syncthreads();
  prefix |= static_cast<uint32_t>(sh_sel[0]) << SHIFT;
  rank -= sh_sel[1];
  count = sh_sel[2];
}

// The key of rank k (1 = the largest) among the thread rows of the block.
// On return `rank` is its rank among the keys equal to it and `count` the
// number of those keys, so the (k+1)-th key equals it where count > rank.
template <typename T, int VPT>
__device__ __forceinline__ uint32_t select_key(const Row<T, VPT>& row, int k,
                                               int& rank, int& count,
                                               int* hist, int* sh_warp,
                                               int* sh_sel) {
  uint32_t prefix = 0;
  rank = k;
  if constexpr (Row<T, VPT>::kKeyBits == 16) {
    radix_pass<8, 8, 16, VPT>(row, prefix, rank, count, hist, sh_warp,
                               sh_sel);
    radix_pass<0, 8, 16, VPT>(row, prefix, rank, count, hist, sh_warp,
                              sh_sel);
  } else {
    radix_pass<21, 11, 32, VPT>(row, prefix, rank, count, hist, sh_warp,
                                sh_sel);
    radix_pass<10, 11, 32, VPT>(row, prefix, rank, count, hist, sh_warp,
                                sh_sel);
    radix_pass<0, 10, 32, VPT>(row, prefix, rank, count, hist, sh_warp,
                               sh_sel);
  }
  return prefix;
}

// The TPU kernel's bisection, replayed from row_max, v_k and v_{k+1}:
// count(x >= mid) >= k is mid <= v_k, and count == k is, besides,
// v_{k+1} < mid.
__device__ __forceinline__ float bisection_replay(float row_max, float vk,
                                                  float vk1) {
  float lo = row_max - kBisectRange;
  float hi = row_max + 1e-6f;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (mid <= vk) {
      lo = mid;
      if (vk1 < mid) break;  // frozen: the kept set is exactly the top k
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The TPU kernel's quartile search (`threshold3`), replayed from the same
// three numbers: count(x >= m_i) >= k is m_i <= v_k, and count == k is,
// besides, v_{k+1} < m_i. The probes are rounded as lo + (q * d) with
// each operation rounded (no contraction into an fma).
__device__ __forceinline__ float bisection3_replay(float row_max, float vk,
                                                   float vk1) {
  float lo = row_max - kBisectRange;
  float hi = row_max + 1e-6f;
  for (int it = 0; it < kBisect3Iters; ++it) {
    const float d = __fsub_rn(hi, lo);
    const float m1 = __fadd_rn(lo, __fmul_rn(0.25f, d));
    const float m2 = __fadd_rn(lo, __fmul_rn(0.5f, d));
    const float m3 = __fadd_rn(lo, __fmul_rn(0.75f, d));
    const bool g1 = m1 <= vk, g2 = m2 <= vk, g3 = m3 <= vk;
    float lo2 = g1 ? m1 : lo;
    lo2 = g2 ? m2 : lo2;
    lo2 = g3 ? m3 : lo2;
    float hi2 = g3 ? hi : m3;
    hi2 = g2 ? hi2 : m2;
    hi2 = g1 ? hi2 : m1;
    lo = lo2;
    hi = hi2;
    if ((g1 && vk1 < m1) || (g2 && vk1 < m2) || (g3 && vk1 < m3))
      break;  // frozen: a probe counted exactly k
  }
  return lo;
}

// Four blocks an SM (64 registers a thread) up to V = 8192 in bf16; two in
// f32, whose rows take twice the registers.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads,
                                  VPT <= 32 && sizeof(T) == 2 ? 4 : 2)
sample_topk_kernel(const T* __restrict__ logits, const float* __restrict__ u,
                   int32_t* __restrict__ out, float* __restrict__ thr_out,
                   int V, int k, float temperature, bool vec,
                   bool bisect3) {
  using R = Row<T, VPT>;
  __shared__ __align__(16) int hist[R::kMaxBins];
  __shared__ int sh_warp[kWarps];
  __shared__ int sh_sel[3];
  __shared__ uint32_t sh_max[kWarps], sh_below[kWarps];
  __shared__ float sh_min[kWarps];
  __shared__ float sh_thr[2];
  __shared__ float sh_scan[kWarps];
  __shared__ int sh_idx[kWarps];
  __shared__ int sh_best[kWarps];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = tid * VPT;
  const bool select = k < V;

  if (select) {
    int4* h4 = reinterpret_cast<int4*>(hist);
#pragma unroll
    for (int q = tid; q < R::kMaxBins / 4; q += kThreads)
      h4[q] = make_int4(0, 0, 0, 0);
  }
  R row;
  row.load(logits + static_cast<int64_t>(r) * V, j0, V, vec);
  const uint32_t max_key = __reduce_max_sync(kFullMask, row.max_key());
  if (lane == 0) sh_max[warp] = max_key;

  // key_k: the key of a_k, the k-th largest logit as stored, where k < V.
  uint32_t key_k = 0;
  int rank = 0, count = 0;
  if (select) {
    __syncthreads();  // hist zeroed
    key_k = select_key(row, k, rank, count, hist, sh_warp, sh_sel);
    if (count == rank) {
      // No tie at a_k: a_{k+1} is the largest logit below it.
      uint32_t below = 0;
#pragma unroll
      for (int e = 0; e < VPT; ++e) {
        const uint32_t key = row.key(e);
        if (key < key_k) below = max(below, key);
      }
      below = __reduce_max_sync(kFullMask, below);
      if (lane == 0) sh_below[warp] = below;
    }
  } else {
    float mn = INFINITY;
#pragma unroll
    for (int e = 0; e < VPT; ++e) mn = fminf(mn, row.value(e));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn = fminf(mn, __shfl_xor_sync(kFullMask, mn, off));
    if (lane == 0) sh_min[warp] = mn;
  }
  __syncthreads();
  // One thread replays the bisection; the block reads the threshold and the
  // row max after one more barrier. Division by the temperature keeps
  // order: these are the same statistics of x.
  if (tid == 0) {
    uint32_t top = sh_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) top = max(top, sh_max[w]);
    const float row_max = R::from_key(top) / temperature;
    float thr;
    if (select) {
      uint32_t key_k1 = key_k;
      if (count == rank) {
        key_k1 = sh_below[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) key_k1 = max(key_k1, sh_below[w]);
      }
      const float vk = R::from_key(key_k) / temperature;
      const float vk1 = R::from_key(key_k1) / temperature;
      thr = bisect3 ? bisection3_replay(row_max, vk, vk1)
                    : bisection_replay(row_max, vk, vk1);
    } else {
      float mn = sh_min[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mn = fminf(mn, sh_min[w]);
      thr = mn / temperature;
    }
    sh_thr[0] = thr;
    sh_thr[1] = row_max;
    if (thr_out != nullptr) thr_out[r] = thr;
  }
  __syncthreads();
  const float thr = sh_thr[0], row_max = sh_thr[1];

  // Unnormalised mass and this thread's running sums over its VPT values.
  // Bit e of `mass` is set where p > 0 (exp may underflow far below the
  // max when k >= V).
  float cdf[VPT];
  float run = 0.f;
  uint64_t mass = 0;
#pragma unroll
  for (int e = 0; e < VPT; ++e) {
    const float x = row.value(e) / temperature;
    const float p = x >= thr ? expf(x - row_max) : 0.f;
    if (p > 0.f) mass |= uint64_t{1} << e;
    run += p;
    cdf[e] = run;
  }

  // Block exclusive scan of the thread sums: warp inclusive scan, then the
  // warp totals.
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += n;
  }
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

  // count(cdf < draw). A thread's sums rise (each adds p >= 0), so one
  // whose last sum lies below the draw counts all its values and one whose
  // first does not counts none; only where the draw falls is each compared.
  const float draw = fmaxf(u[r] * total, 1e-30f);
  int below_draw = 0;
  if (run + excl < draw) {
    below_draw = min(VPT, max(V - j0, 0));
  } else if (cdf[0] + excl < draw) {
#pragma unroll
    for (int e = 0; e < VPT; ++e)
      below_draw += (j0 + e < V && cdf[e] + excl < draw) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    below_draw += __shfl_xor_sync(kFullMask, below_draw, off);
  if (lane == 0) sh_idx[warp] = below_draw;
  __syncthreads();
  int idx0 = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) idx0 += sh_idx[w];

  // The largest index <= idx0 with p > 0: this thread's highest such bit.
  const int span = idx0 - j0;  // bits 0..span qualify
  if (span < 0) mass = 0;
  else if (span < 63) mass &= (uint64_t{2} << span) - 1;
  int best = mass ? j0 + 63 - __clzll(static_cast<long long>(mass)) : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(kFullMask, best, off));
  if (lane == 0) sh_best[warp] = best;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) best = max(best, sh_best[w]);
    out[r] = best;
  }
}

template <typename T, int VPT>
void launch(const void* logits, const float* u, int32_t* out, float* thr_out,
            int N, int V, int k, float temperature, bool bisect3,
            cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                   (static_cast<int64_t>(V) * sizeof(T)) % 16 == 0;
  sample_topk_kernel<T, VPT><<<N, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), u, out, thr_out, V, k, temperature, vec,
      bisect3);
}

template <typename T>
int dispatch(const void* logits, const float* u, int32_t* out, float* thr_out,
             int N, int V, int k, float temperature, bool bisect3,
             cudaStream_t stream) {
  const int vpt = (V + kThreads - 1) / kThreads;
#define HQT_LAUNCH(n) \
  launch<T, n>(logits, u, out, thr_out, N, V, k, temperature, bisect3, \
               stream)
  if (vpt <= 1) HQT_LAUNCH(1);
  else if (vpt <= 2) HQT_LAUNCH(2);
  else if (vpt <= 4) HQT_LAUNCH(4);
  else if (vpt <= 8) HQT_LAUNCH(8);
  else if (vpt <= 16) HQT_LAUNCH(16);
  else if (vpt <= 32) HQT_LAUNCH(32);
  else if (vpt <= 64) HQT_LAUNCH(64);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef HQT_LAUNCH
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. logits: contiguous [N, V]; u: [N] f32;
// out: [N] int32; thr_out: [N] f32 or null, each row's threshold (the kept
// set is x >= thr). V <= 16384, k >= 1, temperature > 0 and finite.
// bisect3: 0 replays the binary bisection, 1 the quartile search.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hqt_sample_topk(int dtype, const void* logits, const float* u,
                               int32_t* out, float* thr_out, int N, int V,
                               int k, float temperature, int bisect3,
                               void* stream) {
  if (N <= 0 || V <= 0 || k < 1 || !(temperature > 0.f) ||
      !isfinite(temperature))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = dispatch<float>(logits, u, out, thr_out, N, V, k, temperature,
                         bisect3 != 0, s);
  else if (dtype == 1)
    rc = dispatch<__nv_bfloat16>(logits, u, out, thr_out, N, V, k,
                                 temperature, bisect3 != 0, s);
  else rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
