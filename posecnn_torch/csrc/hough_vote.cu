// Hough vote accumulation for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces posecnn_tpu/ops/pallas/voting.py:_vote_kernel (the TPU Pallas
// kernel) and also serves the per-slot refine window that the JAX package
// runs as an XLA broadcast-reduce (posecnn_tpu/ops/hough_voting.py:363-389).
//
// What it computes, for every class slot s and candidate center c:
//   votes[s,c] = #{ p : dot > 0, dot^2 > tsq*|c-p|^2, |dx| < thr, |dy| < thr, valid > 0 }
//   dsum[s,c]  = sum of depth over the same samples
// with dx = cx - px, dy = cy - py, dot = u*dx + v*dy.
//
// Layout:
//   samples (S, 8, P) f32 rows: px, py, u, v, depth, box_thr, tsq = (t*|uv|)^2, valid
//   centers (Sc, 2, NC) f32 rows: cx, cy; Sc == 1 (one grid shared by all
//           slots, slot stride 0) or Sc == S (one set of centers per slot)
//   votes, dsum (S, NC) f32
//
// What bounds it: ALU work, not bytes. At the flagship shape (S=8, P=512,
// NC=160*120) a frame runs ~78.6 M center x sample tests (~15 instructions
// each) on 131 KB of samples and 1.2 MB of outputs.
//
// Design (simple first; speed is later work):
//   * grid (ceil(NC/256), S), 256 threads, one thread per (slot, center);
//     NC needs no padding: a thread past NC only helps stage the tiles.
//   * the slot's samples go through shared memory in tiles of 8 rows x 512
//     samples (16 KB). Every thread of the block reads the same sample at
//     the same time, so each shared load is a broadcast; staging once per
//     block instead of once per thread cuts global loads 256-fold.
//   * each thread walks the samples in index order and keeps votes and dsum
//     in f32 registers: no atomics, so the result is deterministic.
//   * every product and sum is rounded on its own (__fmul_rn/__fadd_rn; the
//     build also passes -fmad=false). A contracted FMA rounds differently
//     and flips votes at the boundaries against the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kThreads)
hough_vote_kernel(const float* __restrict__ samples,
                  const float* __restrict__ centers,
                  float* __restrict__ votes,
                  float* __restrict__ dsum,
                  int P, int NC, long long center_slot_stride) {
  __shared__ float tile[kRows][kTile];

  const int s = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < NC;
  const float* cs = centers + s * center_slot_stride;
  const float cx = live ? cs[c] : 0.0f;
  const float cy = live ? cs[NC + c] : 0.0f;
  const float* smp = samples + static_cast<long long>(s) * kRows * P;

  float n_votes = 0.0f;
  float d_sum = 0.0f;
  for (int t0 = 0; t0 < P; t0 += kTile) {
    const int n = min(kTile, P - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kRows * kTile; i += kThreads) {
      const int row = i / kTile;
      const int j = i % kTile;
      if (j < n) tile[row][j] = smp[row * P + t0 + j];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float dx = __fsub_rn(cx, tile[0][j]);
        const float dy = __fsub_rn(cy, tile[1][j]);
        const float dot = __fadd_rn(__fmul_rn(tile[2][j], dx), __fmul_rn(tile[3][j], dy));
        const float n2sq = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float thr = tile[5][j];
        const bool ok = dot > 0.0f && __fmul_rn(dot, dot) > __fmul_rn(tile[6][j], n2sq) &&
                        fabsf(dx) < thr && fabsf(dy) < thr && tile[7][j] > 0.0f;
        if (ok) {
          n_votes = __fadd_rn(n_votes, 1.0f);
          d_sum = __fadd_rn(d_sum, tile[4][j]);
        }
      }
    }
  }
  if (live) {
    votes[static_cast<long long>(s) * NC + c] = n_votes;
    dsum[static_cast<long long>(s) * NC + c] = d_sum;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// per_slot_centers != 0: centers is (S, 2, NC); else (1, 2, NC).
extern "C" int hough_vote_launch(const float* samples, const float* centers,
                                 float* votes, float* dsum, int S, int P, int NC,
                                 int per_slot_centers, void* stream) {
  if (S <= 0 || NC <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((NC + kThreads - 1) / kThreads, S);
  const long long stride = per_slot_centers ? 2LL * NC : 0LL;
  hough_vote_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      samples, centers, votes, dsum, P, NC, stride);
  return static_cast<int>(cudaGetLastError());
}
