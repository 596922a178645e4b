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
// |e|^2 of the codebook as given (f32 or bf16) is computed first, in f32,
// one warp a code; it is padded with +inf to a whole number of 256-code
// tiles, so padded codes never win.
//
// Every dtype pair runs on the bf16 tensor cores. An f32 operand is split
// into three bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
// hi - mid), with hi + mid + lo == x exactly for normal x (3 x 8
// significant bits cover f32's 24); a bf16 operand is its own single piece.
// A bf16 x bf16 product is exact in f32, so summing the products of a list
// of piece pairs with f32 accumulation gives f32-class scores:
//   f32 x f32: 6 pairs, hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid (the
//     three dropped, mid.lo, lo.mid and lo.lo, are each <= ~2^-24 of
//     |z_i e_i|);
//   f32 x bf16 and bf16 x f32: 3 pairs;  bf16 x bf16: 1 pair.
// The pieces of an f32 operand are written by the same first pass that
// takes the norms (z's by a pass of its own), to [3, rows, D] bf16 scratch:
// 1.5x the f32 operand's bytes.
//
// What bounds it on an H100: operations. The work is 2*N*K*D operations a
// pair against (N + K) * D inputs: at the flagship bottom level at batch
// 128 (N = 32768, K = 8192, D = 256) 137.4 GFLOP a pair against 21 MB of
// bf16. The bf16 tensor-core peak, 989 TFLOP/s, does one pair in 0.139 ms;
// f32-exact scores need at least three TF32 passes at 495 TFLOP/s, the
// same time as the six bf16 pairs (0.834 ms). The bytes take 6.4 us at
// 3.35 TB/s for bf16, and the split passes move 10 bytes an f32 value.
//
// The search kernel (wgmma). A block of 384 threads owns 128 rows of z and
// walks its slice of the codebook in tiles of 256 codes. Warpgroup 2 is
// the producer: one thread issues TMA loads (128-byte swizzle) of a 128 x
// 64 chunk of a z piece and a 256 x 64 chunk of a codebook piece into a
// ring of 4 stages (48 KB each), each stage guarded by a "full" and an
// "empty" mbarrier, walking per chunk of D the pair list. The pieces are
// one 3-D tensor map (piece, row, column) an operand, so TMA zero-fills the
// ragged rows of N and K and the tail of D (which adds nothing to a score)
// in every piece. Warpgroups 0 and 1 are consumers, 64 rows each: per stage
// four wgmma.m64n256k16 (bf16 x bf16 -> f32, both operands read from
// shared memory) accumulate the tile's 64 x 256 products of every pair in
// 128 registers a thread, one group kept in flight while the next stage's
// wait begins. After a tile the epilogue scores esq[k] - 2 acc and folds
// each thread's 64 codes into its two rows' running (min, argmin), codes in
// ascending order with a strict `<`; at the end the four threads of a quad
// (which share rows in the accumulator layout) reduce with shuffles,
// breaking equal scores toward the lower code; padded codes score +inf
// through esq. What bounds it in practice: the chunks are re-read from L2
// by every block (z per code tile, the codebook per row tile), about 85
// operations per byte of L2 traffic, and with one pair at D = 256 the
// per-tile epilogue, which no MMA overlaps. Needs D a multiple of 8 (rows
// 16-byte aligned for TMA and the split pass) and 16-byte aligned pointers.
//
// The codebook is split over the grid's second axis when row tiles are few
// (64 at the flagship top, 16 at the 3-level top at batch 32), so that the
// card's SMs fill; a last kernel takes each row's minimum over the slices
// in code order.
//
// Built by hqtransformer_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kReduceThreads = 256;
constexpr int kPrepThreads = 256;  // 8 rows (one warp each) per block
constexpr unsigned kFullMask = 0xffffffffu;

// The search kernel.
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
constexpr int kMaxPieces = 3;
constexpr int kMaxPairs = 8;     // 4 bits a pair in an int

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

// hi + mid + lo == x for normal x: each residual is exact in f32.
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// One pass over a row-major [rows, D] matrix, one warp a row, 8 values a
// lane at a time. Where `pieces` is given (f32 src), writes the three bf16
// pieces of every value to pieces[0..2][row][:]; where `esq` is given,
// esq[row] = |src row|^2 in f32 for row < rows and +inf for rows <= row <
// rows_pad. D must be a multiple of 8.
template <typename T>
__global__ void vq_prepare(const T* __restrict__ src,
                           __nv_bfloat16* __restrict__ pieces,
                           float* __restrict__ esq, int rows, int rows_pad,
                           int D) {
  const int row = blockIdx.x * (kPrepThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows_pad) return;
  if (row >= rows) {
    if (lane == 0) esq[row] = INFINITY;
    return;
  }
  const int64_t base = static_cast<int64_t>(row) * D;
  const int64_t plane = static_cast<int64_t>(rows) * D;
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    float v[8];
    load8(src + base + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(v[j], v[j], s);
    if (pieces != nullptr) {
      uint32_t packed[3][4];  // piece, pair of values
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        __nv_bfloat16 a[3], b[3];
        split3(v[j], a[0], a[1], a[2]);
        split3(v[j + 1], b[0], b[1], b[2]);
#pragma unroll
        for (int q = 0; q < 3; ++q)
          packed[q][j / 2] = static_cast<uint32_t>(__bfloat16_as_ushort(a[q])) |
                             static_cast<uint32_t>(__bfloat16_as_ushort(b[q]))
                                 << 16;
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<uint4*>(pieces + q * plane + base + c) = make_uint4(
            packed[q][0], packed[q][1], packed[q][2], packed[q][3]);
    }
  }
  if (esq == nullptr) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
  if (lane == 0) esq[row] = s;
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

// ------------------------------------------------------------ search kernel

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

// Load the box of a 3-D tensor map at coordinates (c0 innermost, c1, c2)
// into shared memory; completion is counted in bytes on `bar`. Elements
// outside the tensor are filled with zeros. `map` must live in kernel
// parameter space (a __grid_constant__ argument).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" :: "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
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
// shared memory. zmap and emap: 3-D tensor maps (piece, row, column) of the
// bf16 pieces. Pair i of the n_pairs takes z piece (pairs >> 4i) & 3 and
// codebook piece (pairs >> (4i + 2)) & 3. Writes each row's minimum score
// and its code over this block's slice of the codebook to
// part_val/part_idx[split][row].
__global__ void __launch_bounds__(kTcThreads, 1)
vq_argmin_wgmma(const __grid_constant__ CUtensorMap zmap,
                const __grid_constant__ CUtensorMap emap,
                const float* __restrict__ esq, float* __restrict__ part_val,
                int32_t* __restrict__ part_idx, int N, int D, int n_tiles,
                int splits, int n_pairs, int pairs) {
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
          for (int i = 0; i < n_pairs; ++i) {
            mbar_wait(empty + 8 * s, phase ^ 1);
            const uint32_t stage = ring + s * kTcStageBytes;
            mbar_expect_tx(full + 8 * s, kTcStageBytes);
            tma_load_3d(stage, &zmap, full + 8 * s, c * kTcChunk, row0,
                        (pairs >> (4 * i)) & 3);
            tma_load_3d(stage + kTcZBytes, &emap, full + 8 * s,
                        c * kTcChunk, tile * kTcCodes,
                        (pairs >> (4 * i + 2)) & 3);
            if (++s == kTcStages) {
              s = 0;
              phase ^= 1;
            }
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
    const int n_steps = n_chunks * n_pairs;  // stages a tile
    int s = 0;
    uint32_t phase = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      int prev = 0;
      for (int c = 0; c < n_steps; ++c) {
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
          // The previous stage's products are done: release it.
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

// A tensor map of `pieces` row-major [rows, D] bf16 matrices, one after
// the other, read in boxes of one piece x box_rows x 64 columns with the
// 128-byte swizzle; zeros outside.
bool bf16_pieces_map(CUtensorMap* map, const void* ptr, int pieces, int rows,
                     int D, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(pieces)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(D) * 2,
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[3] = {kTcChunk, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The first pass over one operand: its pieces where it is f32 (`pieces`
// non-null) and, where `esq` is given, the norms of its rows padded to
// rows_pad.
cudaError_t launch_prepare(int dtype, const void* src, void* pieces,
                           float* esq, int rows, int rows_pad, int D,
                           cudaStream_t stream) {
  constexpr int kRowsPerBlock = kPrepThreads / 32;
  const int blocks = (rows_pad + kRowsPerBlock - 1) / kRowsPerBlock;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(pieces);
  if (dtype == 0)
    vq_prepare<float><<<blocks, kPrepThreads, 0, stream>>>(
        static_cast<const float*>(src), out, esq, rows, rows_pad, D);
  else
    vq_prepare<__nv_bfloat16><<<blocks, kPrepThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(src), out, esq, rows, rows_pad, D);
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

}  // namespace

// z_dtype, e_dtype: 0 = float32, 1 = bfloat16. z: contiguous [N, D]; e:
// contiguous [K, D]; both 16-byte aligned, D a multiple of 8. z_pieces [3,
// N, D] and e_pieces [3, K, D] bf16 are scratch for an f32 operand and
// unused (may be null) for a bf16 one. esq [ceil(K / 256) * 256] f32,
// part_val [splits, N] f32 and part_idx [splits, N] int32 are scratch;
// codes: [N] int64. 1 <= splits <= the number of 256-code tiles. Returns
// cudaGetLastError() after the launches (0 on success). The kernel sums the
// products of n_pairs pairs of pieces: pair i is z piece (pairs >> 4i) & 3
// and codebook piece (pairs >> (4i + 2)) & 3 (the list is the wrapper's,
// ops/vq_argmin.py::piece_pairs); a pair naming a piece the operand does
// not have is refused.
extern "C" int hqt_vq_argmin(int z_dtype, int e_dtype, const void* z,
                             const void* e, void* z_pieces, void* e_pieces,
                             float* esq, float* part_val, int32_t* part_idx,
                             int64_t* codes, int N, int K, int D, int splits,
                             int n_pairs, int pairs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K_pad = (K + kCodePad - 1) / kCodePad * kCodePad;
  if (N <= 0 || K <= 0 || D <= 0 || D % 8 != 0 || splits < 1 ||
      splits > K_pad / kTcCodes || (z_dtype != 0 && z_dtype != 1) ||
      (e_dtype != 0 && e_dtype != 1) || (z_dtype == 0 && !z_pieces) ||
      (e_dtype == 0 && !e_pieces) || n_pairs < 1 || n_pairs > kMaxPairs)
    return static_cast<int>(cudaErrorInvalidValue);
  // An f32 operand is its three pieces, a bf16 one its own single piece.
  const int pz = z_dtype == 0 ? kMaxPieces : 1;
  const int pe = e_dtype == 0 ? kMaxPieces : 1;
  for (int i = 0; i < n_pairs; ++i)
    if (((pairs >> (4 * i)) & 3) >= pz || ((pairs >> (4 * i + 2)) & 3) >= pe)
      return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        vq_argmin_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const void* zs = z_dtype == 0 ? z_pieces : z;
  const void* es = e_dtype == 0 ? e_pieces : e;
  CUtensorMap zmap, emap;
  if (!bf16_pieces_map(&zmap, zs, pz, N, D, kTcRows) ||
      !bf16_pieces_map(&emap, es, pe, K, D, kTcCodes))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = cudaSuccess;
  if (z_dtype == 0)
    err = launch_prepare(0, z, z_pieces, nullptr, N, N, D, s);
  if (err == cudaSuccess)
    err = launch_prepare(e_dtype, e, e_dtype == 0 ? e_pieces : nullptr, esq,
                         K, K_pad, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTcRows - 1) / kTcRows, splits);
  vq_argmin_wgmma<<<grid, kTcThreads, kTcSmem, s>>>(
      zmap, emap, esq, part_val, part_idx, N, D, K_pad / kTcCodes, splits,
      n_pairs, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part_val, part_idx, codes, N, splits,
                                        s));
}
