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
// What bounds it: the pair tests that can vote. A sample votes only for
// centers inside its box (|dx|, |dy| < box_thr, 34-137 px on the path), and
// only 37-63% of the samples are valid, so on the path's inputs 1-7% of the
// coarse pass's S x NC x P pairs lie inside a valid sample's box (about 40%
// of the refine pass's). Those pairs, ~18 instructions each, are the work;
// below them come the launch and the read of samples, centers and outputs
// (~0.4 MB). Testing every pair would spend 10-30x the needed work on the
// coarse pass, and one block a slot would run the refine pass on 8 of the
// card's 132 SMs. The pairs left are few but crowded: a tile near an
// object keeps every sample of its slot, so the time goes to the blocks of
// those tiles, to launching the 2,400 blocks of the coarse pass and to each
// block's chain of dependent loads, not to the sum of the tests.
//
// Design:
//   * a block owns a tile of 64 centers: 16 x 4 points of a row-major grid
//     when the caller gives the grid's width (`grid_w`), else 64
//     consecutive centers (a 16x16 refine window is four 16x4 tiles); it
//     writes votes[s, c] at the row-major c. Small tiles prune more and
//     cut the work of the tiles near an object.
//   * per-block box pruning, exact: the block reduces its centers' min and
//     max cx, cy, then scans its samples once and keeps a sample only if it
//     is valid and none of fsub(xmin, px) >= thr, fsub(xmax, px) <= -thr
//     (and the same for y) holds. Correctly rounded subtraction is monotone
//     in its first operand, so a dropped sample fails |dx| < thr or
//     |dy| < thr at every center of the block: no vote is lost. A NaN keeps
//     the sample and the full test rejects it.
//   * the scan's loads of a chunk of 512 samples are all issued at once (the
//     first chunk's with the centers'), and the kept samples are compacted
//     into shared memory by warp ballots and prefix counts, as 4 sublists
//     (the chunk's i-th sample in sublist i % 4), each in index order; two
//     float4 a sample (px, py, u, v and depth, thr, tsq). 32 threads hold
//     the tile's centers two each, and 4 such groups walk one sublist each,
//     so a crowded tile's tests run on 4 warps with each broadcast load
//     serving two. Each center's sum over a sublist is the sequential sum of
//     the samples that vote: the same whatever the pruning dropped, so the
//     result does not depend on the tiling (`grid_w`). The sublists' sums
//     are added in sublist order.
//   * where the tiles alone would leave SMs idle (the refine pass: 32
//     blocks), the samples are split into K contiguous chunks (grid
//     (tiles, K, S), K = 8 there). The K blocks of a tile form a thread
//     block cluster; each leaves its partial votes and dsums in its shared
//     memory, and after a cluster barrier each block sums a K-th of the
//     tile's centers over the K partials in chunk order through distributed
//     shared memory. Vote counts stay exact integers; every sum runs in a
//     fixed order, so two launches are bit-equal.
//   * every product and sum is rounded on its own (__fmul_rn/__fadd_rn; the
//     build also passes -fmad=false). A contracted FMA rounds differently
//     and flips votes at the boundaries against the plain PyTorch version.
//   * no atomics, no scratch in device memory: the kernel allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCenterThreads = 32;                  // threads over the tile's centers
constexpr int kPerThread = 2;                       // centers a thread
constexpr int kSub = 4;                             // interleaved sublists of the kept samples
constexpr int kThreads = kCenterThreads * kSub;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kCenterThreads * kPerThread;  // centers a block
constexpr int kTileW = 16;                          // a 2-D tile: 16 x 4 grid points
constexpr int kTileH = kTile / kTileW;
constexpr int kChunk = 512;                         // samples scanned and staged at once (16 KB)
constexpr int kScanIters = kChunk / kThreads;
constexpr int kGroups = kChunk / 32;                // ballots a chunk, at most 32
constexpr int kMaxSplit = 8;                        // the portable cluster size
constexpr int kMinSplitSamples = 32;
static_assert(kGroups <= 32 && kScanIters <= 32 && kTile % kMaxSplit == 0, "tile and chunk shapes");
static_assert(32 % kSub == 0, "a sublist is every kSub-th lane of each warp");

// The row-major center index of the tile's l-th center, or -1 past the grid.
__device__ __forceinline__ int center_index(int l, int tile, int NC, int grid_w, int tiles_x) {
  if (grid_w > 0) {
    const int x = (tile % tiles_x) * kTileW + l % kTileW;
    const long long y = static_cast<long long>(tile / tiles_x) * kTileH + l / kTileW;
    const long long c = y * grid_w + x;
    return (x < grid_w && c < NC) ? static_cast<int>(c) : -1;
  }
  const long long c = static_cast<long long>(tile) * kTile + l;
  return c < NC ? static_cast<int>(c) : -1;
}

// One chunk's scan rows of a thread: px, py, thr, valid of samples
// q0 + it * kThreads + tid, all loads issued before any is used.
struct ScanRows {
  float px[kScanIters], py[kScanIters], thr[kScanIters], val[kScanIters];

  __device__ __forceinline__ void load(const float* smp, int P, int q0, int n, int tid) {
#pragma unroll
    for (int it = 0; it < kScanIters; ++it) {
      const int i = it * kThreads + tid;
      const bool in = i < n;
      const int j = q0 + i;
      px[it] = in ? smp[j] : 0.0f;
      py[it] = in ? smp[P + j] : 0.0f;
      thr[it] = in ? smp[5 * P + j] : 0.0f;
      val[it] = in ? smp[7 * P + j] : 0.0f;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
hough_vote_kernel(const float* __restrict__ samples,
                  const float* __restrict__ centers,
                  float* __restrict__ votes,
                  float* __restrict__ dsum,
                  int P, int NC, long long center_slot_stride,
                  int grid_w, int tiles_x, int chunk) {
  __shared__ float4 kept[2 * kChunk];  // 2 float4 a kept sample
  __shared__ unsigned ballots[kGroups];
  __shared__ int offsets[kSub][kGroups];
  __shared__ int totals[kSub];
  __shared__ float rect[4][kWarps];
  __shared__ float part[kSub][2][kTile];

  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int K = gridDim.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ct = tid % kCenterThreads;  // the thread's centers: ct + r * kCenterThreads
  const int sub = tid / kCenterThreads;  // the sublist whose samples it tests

  // the first chunk's scan loads go out with the centers' loads
  const float* smp = samples + static_cast<long long>(s) * 8 * P;
  const int p0 = min(P, k * chunk);
  const int p1 = min(P, p0 + chunk);
  ScanRows rows;
  rows.load(smp, P, p0, min(kChunk, p1 - p0), tid);

  // the block's centers and their bounding rectangle
  const float* cs = centers + s * center_slot_stride;
  float cx[kPerThread], cy[kPerThread];
  float xmin = __int_as_float(0x7f800000), ymin = xmin;
  float xmax = -xmin, ymax = -xmin;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int c = center_index(ct + r * kCenterThreads, tile, NC, grid_w, tiles_x);
    cx[r] = c >= 0 ? cs[c] : 0.0f;
    cy[r] = c >= 0 ? cs[NC + c] : 0.0f;
    if (c >= 0) {
      xmin = fminf(xmin, cx[r]);
      xmax = fmaxf(xmax, cx[r]);
      ymin = fminf(ymin, cy[r]);
      ymax = fmaxf(ymax, cy[r]);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    xmin = fminf(xmin, __shfl_xor_sync(0xffffffffu, xmin, m));
    xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, m));
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, m));
    ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, m));
  }
  if (lane == 0) {
    rect[0][warp] = xmin;
    rect[1][warp] = xmax;
    rect[2][warp] = ymin;
    rect[3][warp] = ymax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    xmin = fminf(xmin, rect[0][w]);
    xmax = fmaxf(xmax, rect[1][w]);
    ymin = fminf(ymin, rect[2][w]);
    ymax = fmaxf(ymax, rect[3][w]);
  }

  float n_votes[kPerThread], d_sum[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) n_votes[r] = d_sum[r] = 0.0f;

  const unsigned below = (1u << lane) - 1u;
  for (int q0 = p0; q0 < p1; q0 += kChunk) {
    const int n = min(kChunk, p1 - q0);
    if (q0 != p0) {
      __syncthreads();  // the previous chunk's compacted samples are no longer read
      rows.load(smp, P, q0, n, tid);
    }
    // scan: keep the valid samples whose box reaches the rectangle
    unsigned mine = 0;
#pragma unroll
    for (int it = 0; it < kScanIters; ++it) {
      const float px = rows.px[it], py = rows.py[it], thr = rows.thr[it];
      const bool keep = rows.val[it] > 0.0f && !(__fsub_rn(xmin, px) >= thr) &&
                        !(__fsub_rn(xmax, px) <= -thr) && !(__fsub_rn(ymin, py) >= thr) &&
                        !(__fsub_rn(ymax, py) <= -thr);
      const unsigned b = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) ballots[it * kWarps + warp] = b;
      mine |= static_cast<unsigned>(keep) << it;
    }
    __syncthreads();
    // the kept samples of a chunk form kSub sublists, the i-th sample of the
    // chunk going to sublist i % kSub (the lanes tid % kSub of each warp):
    // each sublist's exclusive prefix of the ballots' counts, in sample order
    const unsigned lanes = 0xffffffffu / ((1u << kSub) - 1u);  // every kSub-th lane from 0
    for (int q = warp; q < kSub; q += kWarps) {
      const int cnt = lane < kGroups ? __popc(ballots[lane] & (lanes << q)) : 0;
      int inc = cnt;
#pragma unroll
      for (int m = 1; m < 32; m <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, m);
        if (lane >= m) inc += o;
      }
      if (lane < kGroups) offsets[q][lane] = inc - cnt;
      if (lane == 31) totals[q] = inc;
    }
    __syncthreads();
    // compact each sublist into shared memory in index order, one after another
    int base = 0;
#pragma unroll
    for (int q = 0; q < kSub; ++q) base += q < tid % kSub ? totals[q] : 0;
    const unsigned mask = (lanes << (tid % kSub)) & below;
#pragma unroll
    for (int it = 0; it < kScanIters; ++it) {
      if (mine >> it & 1u) {
        const int g = it * kWarps + warp;
        const int o = base + offsets[tid % kSub][g] + __popc(ballots[g] & mask);
        const int j = q0 + it * kThreads + tid;
        kept[2 * o] = make_float4(rows.px[it], rows.py[it], smp[2 * P + j], smp[3 * P + j]);
        kept[2 * o + 1] = make_float4(smp[4 * P + j], rows.thr[it], smp[6 * P + j], 0.0f);
      }
    }
    __syncthreads();
    // the pair tests, over the kept samples only
    int first = 0;
#pragma unroll
    for (int q = 0; q < kSub; ++q) first += q < sub ? totals[q] : 0;
    for (int o = first; o < first + totals[sub]; ++o) {
      const float4 a = kept[2 * o];      // px, py, u, v
      const float4 b = kept[2 * o + 1];  // depth, thr, tsq
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const float dx = __fsub_rn(cx[r], a.x);
        const float dy = __fsub_rn(cy[r], a.y);
        const float dot = __fadd_rn(__fmul_rn(a.z, dx), __fmul_rn(a.w, dy));
        const float n2sq = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const bool ok = (dot > 0.0f) & (__fmul_rn(dot, dot) > __fmul_rn(b.z, n2sq)) & (fabsf(dx) < b.y) &
                        (fabsf(dy) < b.y);
        if (ok) {
          n_votes[r] = __fadd_rn(n_votes[r], 1.0f);
          d_sum[r] = __fadd_rn(d_sum[r], b.x);
        }
      }
    }
  }

  // the sublists' sums, added in sublist order
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    part[sub][0][ct + r * kCenterThreads] = n_votes[r];
    part[sub][1][ct + r * kCenterThreads] = d_sum[r];
  }
  __syncthreads();
  float* vout = votes + static_cast<long long>(s) * NC;
  float* dout = dsum + static_cast<long long>(s) * NC;
  for (int l = tid; l < kTile; l += kThreads) {
    float v = part[0][0][l], d = part[0][1][l];
#pragma unroll
    for (int q = 1; q < kSub; ++q) {
      v = __fadd_rn(v, part[q][0][l]);
      d = __fadd_rn(d, part[q][1][l]);
    }
    const int c = center_index(l, tile, NC, grid_w, tiles_x);
    if (K == 1 && c >= 0) {
      vout[c] = v;
      dout[c] = d;
    }
    part[0][0][l] = v;  // only this thread reads and writes part[.][.][l] here
    part[0][1][l] = d;
  }
  if (K == 1) return;
  // the K blocks of the cluster hold one tile's partial sums over K sample
  // chunks; each block sums a K-th of the centers over them in chunk order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = kTile / K;
  for (int l = k * per + tid; l < (k + 1) * per; l += kThreads) {
    float v = 0.0f, d = 0.0f;
    for (int q = 0; q < K; ++q) {
      const float* rp = cluster.map_shared_rank(&part[0][0][0], q);
      v = __fadd_rn(v, rp[l]);
      d = __fadd_rn(d, rp[kTile + l]);
    }
    const int c = center_index(l, tile, NC, grid_w, tiles_x);
    if (c >= 0) {
      vout[c] = v;
      dout[c] = d;
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = launched).
// per_slot_centers != 0: centers is (S, 2, NC); else (1, 2, NC).
// grid_w > 0: the centers are a row-major grid of that width (tiled in 2-D;
// a ragged last row is allowed); 0: no grid, consecutive centers per block.
// split: the number of sample chunks K (1, 2, 4 or 8), 0 to choose.
extern "C" int hough_vote_launch(const float* samples, const float* centers,
                                 float* votes, float* dsum, int S, int P, int NC,
                                 int per_slot_centers, int grid_w, int split, void* stream) {
  if (S <= 0 || NC <= 0) return static_cast<int>(cudaSuccess);
  if (P < 0 || grid_w < 0 || !(split == 0 || split == 1 || split == 2 || split == 4 || split == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  int tiles_x = 0;
  long long tiles;
  if (grid_w > 0) {
    tiles_x = (grid_w + kTileW - 1) / kTileW;
    const long long rows = (static_cast<long long>(NC) + grid_w - 1) / grid_w;
    tiles = tiles_x * ((rows + kTileH - 1) / kTileH);
  } else {
    tiles = (static_cast<long long>(NC) + kTile - 1) / kTile;
  }
  int K = split;
  if (K == 0) {
    int device = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    K = 1;
    // split while the grid holds under two blocks an SM and a chunk stays
    // over 32 samples
    while (K < kMaxSplit && tiles * S * K < 2LL * sms && (P + K - 1) / K > kMinSplitSamples) K *= 2;
  }
  const int chunk = (P + K - 1) / K;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), K, S);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = K;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  const long long stride = per_slot_centers ? 2LL * NC : 0LL;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, hough_vote_kernel, samples, centers, votes, dsum, P, NC,
                                           stride, grid_w, tiles_x, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
