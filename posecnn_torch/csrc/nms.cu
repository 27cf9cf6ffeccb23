// Greedy non-maximum suppression keep mask, for sm_90a.
//
// The port's kernel for `posecnn_tpu/ops/nms.py:nms_jax` (a fori_loop sweep
// over an (N, N) IoU matrix; the JAX package has no Pallas kernel for it).
// The RPN's proposal layer runs it over the 6000 top-scoring proposals of
// every frame and every training step.
//
// Input: boxes (N, 4) float32 [x1, y1, x2, y2], already sorted by score,
// highest first (the wrapper does the stable sort). Output: keep (N,) uint8
// in that order, 1 where box i overlaps no kept box before it by IoU > thresh.
//
// Boxes fall into C = ceil(N/64) blocks of 64. A tile (r, c) holds 64
// 64-bit words, one for each box i of row block r: bit k is set when box
// j = 64 c + k, j > i, overlaps box i by IoU > thresh. Only tiles with
// c >= r are ever needed; they are stored row block by row block, each row
// block's tiles c = r .. C-1 one after another (`row_tile`), so that all
// the words the sweep reads at row block r are one contiguous run of
// (C - r) * 512 bytes. Inside a tile, row i's word sits at position
// (i mod 64) ^ (c mod 32): threads that read one row's words in 32
// neighbouring tiles then hit 32 different shared-memory banks.
//
// Two launches:
//   nms_mask_kernel   one 64-thread block a tile of the upper triangle,
//                     C (C + 1) / 2 of them (4465 at N = 6000), in row
//                     order. The block stages its column block's 64 boxes
//                     and their areas in shared memory; thread t tests row
//                     box 64 r + t against them (a tile off the diagonal in
//                     a loop unrolled by 8, each bit set by an immediate)
//                     and writes its word. An intersection of 0
//                     over a positive union decides without the division.
//   nms_sweep_kernel  one block of 128 threads: a walker warp and three
//                     helper warps, handing row blocks to each other through
//                     mbarriers. The walker decides row block b's boxes
//                     from the diagonal tile's words in its registers, in
//                     rounds of warp reductions: each round keeps every
//                     undecided box that no undecided box before it
//                     suppresses (they cannot suppress each other) and
//                     removes what they suppress, so a round decides several
//                     boxes. It ORs the kept boxes' words of tile (b, b+1)
//                     into a register that its next step reads, and hands
//                     the kept bits to the helpers, who OR the kept boxes'
//                     words into `removed` (one word a column block, in
//                     shared memory) for the column blocks past b+1, a
//                     thread a column block, four loads in flight. The
//                     walker waits for row block b-2's helpers before it
//                     decides b, so the chain of dependent steps holds only
//                     the rounds and one word's OR. Tiles
//                     come to shared memory by bulk copies (TMA,
//                     cp.async.bulk) on mbarriers: the walker's two a row
//                     block four row blocks ahead, the helpers' (b, b+2) ..
//                     three ahead. Where those do not all fit (more than
//                     9408 boxes), the helpers stage the first `window` of
//                     them and read the rest from global memory (L2): the
//                     second route. With window 0 they stage none. The keep
//                     bytes are written at the end, from the kept bits.
//
// Arithmetic as in nms_jax, in float32 without FMA contraction (the build
// passes -fmad=false; the expressions below are also written so that no
// product feeds an addition): areas (x2 - x1 + 1) * (y2 - y1 + 1); the
// intersection max(0, min(x2) - max(x1) + 1) for each axis, multiplied,
// with NaN-propagating min and max;
// IoU inter / ((a_i + a_j) - inter) with IEEE division; suppression on
// IoU > thresh. An IoU equal to the threshold keeps the box, as there.
//
// Bound: the function reads N boxes and writes N keep bytes, and a greedy
// sweep needs one IoU test (15 float operations) for each kept box and
// each later box that no kept box before it has removed: at N = 6000,
// 102 KB and at most 18 M tests (0.27 GFLOP), microseconds on this card.
// The mask pass does all N^2 / 2 tests, in parallel, and writes the
// triangle's words (2.3 MB at N = 6000) in place of nms_jax's (N, N) IoU
// matrix. The sweep is a chain of C dependent steps on one SM (94 at
// N = 6000); staging takes the L2's latency off that chain, the helpers
// take the OR off it, and what is left is each step's rounds and its two
// hand-offs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;
constexpr int kSweepThreads = 128;  // the sweep's walker warp and its helpers
constexpr int kHelpers = kSweepThreads - 32;
constexpr int kStages = 3;        // row blocks the sweep's helpers stage ahead
constexpr int kWalkerStages = 4;  // row blocks the sweep's walker stages ahead

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A wait that
// lasts some 10^10 cycles (seconds; a real one is microseconds) traps, so a
// broken pipeline fails its launch instead of hanging the card.
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 10000000000LL) __trap();
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// min and max that return NaN when either operand is NaN, as torch.minimum /
// maximum and jnp.minimum / maximum do (fminf and fmaxf return the other
// operand), so that every IoU decides as there, NaN operands included. The
// NaN they return is the canonical one, and the sign of a zero result may
// differ from torch's; neither changes a decision (a NaN IoU never
// suppresses, and every zero here is added to 1 or divided).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float box_area(float4 b) {
  float w = __fadd_rn(__fsub_rn(b.z, b.x), 1.0f);
  float h = __fadd_rn(__fsub_rn(b.w, b.y), 1.0f);
  return __fmul_rn(w, h);
}

// IoU(a, b) > thresh, a the earlier box (the row), with the areas given.
// `zero_gt` is 0 > thresh: the decision of an intersection of +-0 over a
// union > 0 (+inf included), whose quotient is +-0 exactly.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b, float thresh,
                                         bool zero_gt) {
  float iw = __fadd_rn(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 1.0f);
  iw = max_nan(0.0f, iw);
  ih = max_nan(0.0f, ih);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (inter == 0.0f && uni > 0.0f) return zero_gt;
  return __fdiv_rn(inter, uni) > thresh;
}

// the first tile of row block r: row blocks 0 .. r-1 hold C, C-1, ...,
// C-r+1 tiles
__host__ __device__ __forceinline__ long long row_tile(long long r, long long cb) {
  return r * cb - r * (r - 1) / 2;
}

// the row block of the tile-th tile of the upper triangle: the largest r
// with row_tile(r) <= tile, from the root of the quadratic, then corrected
// by a step for its rounding
__device__ __forceinline__ int row_of_tile(long long tile, int cb) {
  const double b = 2.0 * cb + 1.0;
  int r = static_cast<int>((b - sqrt(b * b - 8.0 * static_cast<double>(tile))) * 0.5);
  r = max(0, min(r, cb - 1));
  while (r + 1 < cb && row_tile(r + 1, cb) <= tile) ++r;
  while (r > 0 && row_tile(r, cb) > tile) --r;
  return r;
}

__global__ void __launch_bounds__(kBlock) nms_mask_kernel(const float4* __restrict__ boxes, int n, int cb,
                                                          float thresh, unsigned long long* __restrict__ mask) {
  const long long tile = blockIdx.x;
  const int r = row_of_tile(tile, cb);
  const int c = r + static_cast<int>(tile - row_tile(r, cb));
  const int row_size = min(n - r * kBlock, kBlock);
  const int col_size = min(n - c * kBlock, kBlock);
  __shared__ float4 col[kBlock];
  __shared__ float col_area[kBlock];
  const int t = threadIdx.x;
  if (t < col_size) {
    const float4 b = boxes[c * kBlock + t];
    col[t] = b;
    col_area[t] = box_area(b);
  }
  __syncthreads();
  unsigned long long bits = 0ull;
  const bool zero_gt = 0.0f > thresh;
  if (t < row_size) {
    const float4 me = boxes[r * kBlock + t];
    const float area = box_area(me);
    if (c != r && col_size == kBlock) {
      unsigned lo = 0u, hi = 0u;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        lo |= static_cast<unsigned>(overlaps(me, area, col[k], col_area[k], thresh, zero_gt)) << k;
      }
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        hi |= static_cast<unsigned>(overlaps(me, area, col[32 + k], col_area[32 + k], thresh, zero_gt)) << k;
      }
      bits = (static_cast<unsigned long long>(hi) << 32) | lo;
    } else {
      // on the diagonal only the boxes after this one; a word's rows past
      // N are written 0 and never read
      for (int k = (c == r) ? t + 1 : 0; k < col_size; ++k) {
        if (overlaps(me, area, col[k], col_area[k], thresh, zero_gt)) bits |= 1ull << k;
      }
    }
  }
  mask[tile * kBlock + (t ^ (c & 31))] = bits;
}

__global__ void __launch_bounds__(kSweepThreads) nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                                                     int n, int cb, int window,
                                                                     uint8_t* __restrict__ keep) {
  // dynamic: removed[cb] and kept[cb] (each rounded up to an even count, so
  // that what follows is 16-byte aligned), then kStages buffers of `window`
  // tiles for the helpers. static: the walker's ring of kWalkerStages
  // buffers of two tiles (the diagonal one and the next)
  extern __shared__ __align__(16) unsigned long long smem[];
  __shared__ __align__(16) unsigned long long wring[kWalkerStages][2 * kBlock];
  __shared__ __align__(8) unsigned long long full[kStages], wfull[kWalkerStages], kb_ready[2], or_done[2];
  const int cb_even = (cb + 1) & ~1;
  unsigned long long* removed = smem;
  unsigned long long* kept = smem + cb_even;
  unsigned long long* stages = smem + 2 * cb_even;
  const int tid = threadIdx.x, lane = tid & 31;

  for (int w = tid; w < cb; w += kSweepThreads) removed[w] = 0ull;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&full[s]), 1);
    for (int s = 0; s < kWalkerStages; ++s) mbar_init(smem_addr(&wfull[s]), 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(smem_addr(&kb_ready[s]), 1);
      mbar_init(smem_addr(&or_done[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the helpers' tiles of row block b, (b, b+2) .. (b, b + staged(b) + 1):
  // into buffer b % kStages, once its copy has landed; all in global memory
  auto staged = [&](int b) { return max(0, min(cb - b - 2, window)); };
  auto stage = [&](int b) {
    const uint32_t bytes = static_cast<uint32_t>(staged(b)) * kBlock * 8u;
    const uint32_t bar = smem_addr(&full[b % kStages]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_addr(stages + static_cast<size_t>(b % kStages) * window * kBlock),
              mask + (row_tile(b, cb) + 2) * kBlock, bytes, bar);
  };
  // the walker's two tiles of row block b (one for the last) into its ring
  auto stage_walker = [&](int b) {
    const uint32_t bytes = (b + 1 < cb ? 2u : 1u) * kBlock * 8u;
    const uint32_t bar = smem_addr(&wfull[b % kWalkerStages]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_addr(wring[b % kWalkerStages]), mask + row_tile(b, cb) * kBlock, bytes, bar);
  };
  if (tid == 0) {
    for (int b = 0; b < kWalkerStages && b < cb; ++b) stage_walker(b);
    // the staged row blocks are a prefix: staged(b) > 0 exactly for b < C - 2
    for (int b = 0; b < kStages && staged(b) > 0; ++b) stage(b);
  }

  if (tid < 32) {
    // the walker. Lane l holds the diagonal tile's words of boxes l and
    // 32 + l (d0: both halves, d1: the high half, the only bits past
    // 32 + l), and tile (b, b+1)'s words of the same boxes (e0, e1).
    unsigned long long carry = 0ull;  // row block b-1's kept words of tile (b-1, b)
    for (int b = 0; b < cb; ++b) {
      const int slot = b % kWalkerStages;
      mbar_wait(smem_addr(&wfull[slot]), (b / kWalkerStages) & 1);
      const unsigned long long* t = wring[slot];
      const int sw = b & 31, sw1 = (b + 1) & 31;
      const unsigned long long d0 = t[lane ^ sw];
      const unsigned d1 = static_cast<unsigned>(t[32 + (lane ^ sw)] >> 32);
      const unsigned long long e0 = b + 1 < cb ? t[kBlock + (lane ^ sw1)] : 0ull;
      const unsigned long long e1 = b + 1 < cb ? t[kBlock + 32 + (lane ^ sw1)] : 0ull;
      if (b >= 2) mbar_wait(smem_addr(&or_done[b & 1]), ((b - 2) >> 1) & 1);  // row block b-2 ORed
      const int size = min(n - b * kBlock, kBlock);
      const unsigned long long rem = removed[b] | carry;
      // the greedy keep decisions of the row block in rounds: of the boxes
      // still undecided (u), those that no undecided box before them
      // suppresses are kept (the first always is; they do not suppress each
      // other), and the boxes they suppress are removed. A round costs two
      // warp reductions, however many boxes it decides. The kept boxes'
      // words of tile (b, b+1) are ORed into the next step's carry.
      unsigned ulo = ~static_cast<unsigned>(rem) & (size >= 32 ? ~0u : (1u << size) - 1u);
      unsigned uhi = ~static_cast<unsigned>(rem >> 32);
      uhi &= size == kBlock ? ~0u : size > 32 ? (1u << (size - 32)) - 1u : 0u;
      unsigned kb_lo = 0u, kb_hi = 0u, next_lo = 0u, next_hi = 0u;
      while ((ulo | uhi) != 0u) {
        const bool u0 = (ulo >> lane) & 1u, u1 = (uhi >> lane) & 1u;
        const unsigned blo = __reduce_or_sync(0xffffffffu, u0 ? static_cast<unsigned>(d0) : 0u);
        const unsigned bhi =
            __reduce_or_sync(0xffffffffu, (u0 ? static_cast<unsigned>(d0 >> 32) : 0u) | (u1 ? d1 : 0u));
        const unsigned slo = ulo & ~blo, shi = uhi & ~bhi;
        const bool s0 = (slo >> lane) & 1u, s1 = (shi >> lane) & 1u;
        const unsigned rlo = __reduce_or_sync(0xffffffffu, s0 ? static_cast<unsigned>(d0) : 0u);
        const unsigned rhi =
            __reduce_or_sync(0xffffffffu, (s0 ? static_cast<unsigned>(d0 >> 32) : 0u) | (s1 ? d1 : 0u));
        const unsigned long long e = (s0 ? e0 : 0ull) | (s1 ? e1 : 0ull);
        next_lo |= __reduce_or_sync(0xffffffffu, static_cast<unsigned>(e));
        next_hi |= __reduce_or_sync(0xffffffffu, static_cast<unsigned>(e >> 32));
        kb_lo |= slo;
        kb_hi |= shi;
        ulo &= ~(slo | rlo);
        uhi &= ~(shi | rhi);
      }
      // the kept bits go to the helpers
      if (lane == 0) {
        kept[b] = (static_cast<unsigned long long>(kb_hi) << 32) | kb_lo;
        mbar_arrive(smem_addr(&kb_ready[b & 1]));
        // the ring's slot is read: row block b + kWalkerStages's tiles go there
        if (b + kWalkerStages < cb) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          stage_walker(b + kWalkerStages);
        }
      }
      carry = (static_cast<unsigned long long>(next_hi) << 32) | next_lo;
    }
  } else {
    // the helpers: row block b's kept words into the column blocks past b+1
    const int h = tid - 32;
    // the kept boxes' words of one tile ORed, four loads in flight: the set
    // bits of each half of kb four at a time (a bit past the last is the
    // first again), found with 32-bit scans
    auto or_kept = [](const unsigned long long* tw, unsigned long long kb, int sww) {
      unsigned long long acc = 0ull;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        for (unsigned m = static_cast<unsigned>(kb >> (32 * half)); m != 0u;) {
          const unsigned m1 = m & (m - 1u), m2 = m1 & (m1 - 1u), m3 = m2 & (m2 - 1u);
          const int k0 = 32 * half + __ffs(m) - 1;
          const int k1 = m1 ? 32 * half + __ffs(m1) - 1 : k0;
          const int k2 = m2 ? 32 * half + __ffs(m2) - 1 : k0;
          const int k3 = m3 ? 32 * half + __ffs(m3) - 1 : k0;
          acc |= (tw[k0 ^ sww] | tw[k1 ^ sww]) | (tw[k2 ^ sww] | tw[k3 ^ sww]);
          m = m3 & (m3 - 1u);
        }
      }
      return acc;
    };
    for (int b = 0; b < cb; ++b) {
      mbar_wait(smem_addr(&kb_ready[b & 1]), (b >> 1) & 1);
      const unsigned long long kb = kept[b];
      const int w0 = b + 2 + h, w_staged = b + 2 + staged(b);
      if (w0 < w_staged) {
        mbar_wait(smem_addr(&full[b % kStages]), (b / kStages) & 1);
        const unsigned long long* t = stages + static_cast<size_t>(b % kStages) * window * kBlock;
        for (int w = w0; w < w_staged; w += kHelpers) {
          removed[w] |= or_kept(t + static_cast<size_t>(w - b - 2) * kBlock, kb, w & 31);
        }
      }
      if (w_staged < cb) {
        // past the window, the same threads' words from global memory
        const unsigned long long* g = mask + row_tile(b, cb) * kBlock;
        int w = w0;
        if (w < w_staged) w += (w_staged - w0 + kHelpers - 1) / kHelpers * kHelpers;
        for (; w < cb; w += kHelpers) {
          removed[w] |= or_kept(g + static_cast<size_t>(w - b) * kBlock, kb, w & 31);
        }
      }
      // once every helper is done with row block b, the walker may read the
      // words they wrote, and buffer b % kStages takes row block
      // b + kStages's tiles
      named_sync(1, kHelpers);
      if (h == 0) {
        mbar_arrive(smem_addr(&or_done[b & 1]));
        if (staged(b + kStages) > 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          stage(b + kStages);
        }
      }
    }
  }
  // the keep bytes, from the kept bits of every row block
  __syncthreads();
  for (int i = tid; i < n; i += kSweepThreads) keep[i] = static_cast<uint8_t>((kept[i / kBlock] >> (i % kBlock)) & 1ull);
}

}  // namespace

// boxes (n, 4) float32 sorted by score, 16-byte aligned; mask scratch of
// 64 * C (C + 1) / 2 uint64 words, C = ceil(n / 64); keep (n,) uint8;
// window: the tiles past the walker's two that a row block stages in shared
// memory (0 .. C - 2; the wrapper's `sweep_window`). Returns the CUDA error
// of the launches (0 = ok).
extern "C" int nms_launch(const void* boxes, int n, float thresh, void* mask, void* keep, int window,
                          void* stream) {
  if (n <= 0) return 0;
  const int cb = (n + kBlock - 1) / kBlock;
  if (window < 0 || window > max(cb - 2, 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = row_tile(cb, cb);
  nms_mask_kernel<<<static_cast<unsigned>(tiles), kBlock, 0, s>>>(
      static_cast<const float4*>(boxes), n, cb, thresh, static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(unsigned long long) * (2 * ((cb + 1) & ~1) + kStages * static_cast<size_t>(window) * kBlock);
  // the attribute belongs to the current device: set on every launch that
  // needs more than the default 48 KB
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep_kernel<<<1, kSweepThreads, smem, s>>>(static_cast<const unsigned long long*>(mask), n, cb, window,
                                            static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
