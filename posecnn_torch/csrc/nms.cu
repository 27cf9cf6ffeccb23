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
// Two launches:
//   nms_mask_kernel   grid (ceil(N/64), ceil(N/64)), 64 threads. Block
//                     (r, c) stages column block c's 64 boxes in shared
//                     memory; thread t of row block r writes the 64-bit word
//                     mask[i * col_blocks + c] whose bit k is set when box
//                     i = 64 r + t overlaps box j = 64 c + k, j > i, by IoU
//                     > thresh. Blocks with c < r have no such pair and
//                     return (their words are never read).
//   nms_sweep_kernel  one block. `removed` (col_blocks words) lives in
//                     shared memory. For each row block b in order: 64
//                     threads load the diagonal words of the block's boxes,
//                     one thread walks them in order (a box is kept unless a
//                     kept box before it set its bit; it visits the kept
//                     ones only) and writes the block's keep bits, then the
//                     threads OR the kept boxes' rows into the words of
//                     `removed` past b, a word each.
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
// sweep needs one IoU test (15 float operations) for each kept box and each
// later box that no kept box before it has removed: at N = 6000, 102 KB and
// at most 18 M tests (0.27 GFLOP), microseconds on this card. The mask pass does all N^2 / 2 tests,
// in parallel; the design keeps nms_jax's (N, N) IoU matrix (36 MB of bools
// at N = 6000) out of device memory: the mask pass writes N * ceil(N/64)
// 64-bit words (4.5 MB at N = 6000), read back from L2. The sweep is a
// chain of ceil(N/64) dependent steps on one SM (94 at N = 6000), each a
// 64-step serial walk over shared memory plus an OR over the rest of the
// words; that chain, not bytes or operations, sets the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;

// min and max that return NaN when either operand is NaN, as torch.minimum /
// maximum and jnp.minimum / maximum do (fminf and fmaxf return the other
// operand), so that every IoU decides as there, NaN operands included.
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float box_area(const float* b) {
  float w = __fadd_rn(__fsub_rn(b[2], b[0]), 1.0f);
  float h = __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f);
  return __fmul_rn(w, h);
}

__device__ __forceinline__ bool overlaps(const float* a, const float* b, float thresh) {
  float iw = __fadd_rn(__fsub_rn(min_nan(a[2], b[2]), max_nan(a[0], b[0])), 1.0f);
  float ih = __fadd_rn(__fsub_rn(min_nan(a[3], b[3]), max_nan(a[1], b[1])), 1.0f);
  iw = max_nan(0.0f, iw);
  ih = max_nan(0.0f, ih);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(box_area(a), box_area(b)), inter);
  return __fdiv_rn(inter, uni) > thresh;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n, int col_blocks, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int r = blockIdx.y, c = blockIdx.x;
  if (c < r) return;
  const int row_size = min(n - r * kBlock, kBlock);
  const int col_size = min(n - c * kBlock, kBlock);
  __shared__ float col[kBlock * 4];
  const int t = threadIdx.x;
  if (t < col_size) {
#pragma unroll
    for (int k = 0; k < 4; ++k) col[t * 4 + k] = boxes[(c * kBlock + t) * 4 + k];
  }
  __syncthreads();
  if (t >= row_size) return;
  const int i = r * kBlock + t;
  float me[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) me[k] = boxes[i * 4 + k];
  unsigned long long bits = 0ull;
  const int start = (c == r) ? t + 1 : 0;
  for (int k = start; k < col_size; ++k) {
    if (overlaps(me, col + k * 4, thresh)) bits |= 1ull << k;
  }
  mask[(size_t)i * col_blocks + c] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask, int n, int col_blocks,
                                 uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diag[kBlock];
  __shared__ unsigned long long kept_bits;
  const int t = threadIdx.x;
  for (int w = t; w < col_blocks; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  for (int b = 0; b < col_blocks; ++b) {
    const int size = min(n - b * kBlock, kBlock);
    if (t < size) diag[t] = mask[(size_t)(b * kBlock + t) * col_blocks + b];
    __syncthreads();
    if (t == 0) {
      // in index order, the next box that no kept box has removed is kept;
      // only the kept boxes cost an iteration
      const unsigned long long in_block = size == kBlock ? ~0ull : (1ull << size) - 1ull;
      unsigned long long rem = removed[b];
      unsigned long long kb = 0ull;
      unsigned long long cand = in_block & ~rem;
      while (cand != 0ull) {
        const int k = __ffsll((long long)cand) - 1;
        kb |= 1ull << k;
        rem |= diag[k];
        cand = in_block & ~rem & (k == kBlock - 1 ? 0ull : ~0ull << (k + 1));
      }
      kept_bits = kb;
    }
    __syncthreads();
    const unsigned long long kb = kept_bits;
    if (t < size) keep[b * kBlock + t] = (uint8_t)((kb >> t) & 1ull);
    // OR the kept boxes' rows into the words past b, visiting only the set
    // bits of kb: one load a kept box, independent of each other
    for (int w = b + 1 + t; w < col_blocks; w += blockDim.x) {
      const unsigned long long* col = mask + (size_t)(b * kBlock) * col_blocks + w;
      unsigned long long acc = 0ull;
      for (unsigned long long m = kb; m != 0ull; m &= m - 1ull) {
        acc |= col[(size_t)(__ffsll((long long)m) - 1) * col_blocks];
      }
      removed[w] |= acc;
    }
    __syncthreads();
  }
}

}  // namespace

// boxes (n, 4) float32 sorted by score; mask scratch (n * ceil(n/64))
// uint64; keep (n,) uint8. Returns the CUDA error of the launches (0 = ok).
extern "C" int nms_launch(const void* boxes, int n, float thresh, void* mask, void* keep, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBlock - 1) / kBlock;
  dim3 grid(col_blocks, col_blocks);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(static_cast<const float*>(boxes), n, col_blocks, thresh,
                                          static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(unsigned long long) * col_blocks;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  nms_sweep_kernel<<<1, 256, smem, s>>>(static_cast<const unsigned long long*>(mask), n, col_blocks,
                                        static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
