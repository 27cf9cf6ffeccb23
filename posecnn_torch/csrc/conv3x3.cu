// Stride-1 SAME 3x3 convolution for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces posecnn_tpu/ops/pallas/conv3x3.py:_conv_kernel (the TPU Pallas
// kernel, pallas_call at conv3x3.py:102). Serves the forward of the trunk's
// full-resolution conv1_2 layer and its dgrad (the same convolution of the
// cotangent with flipped, transposed weights, as conv3x3.py:_conv3x3_bwd does).
//
// What it computes, for every image b, pixel (h, w) and output channel o:
//   y[b,h,w,o] = bf16( relu?( sum_{dy,dx,i} x[b,h+dy-1,w+dx-1,i] * w[dy,dx,i,o] + bias[o] ) )
// with x zero outside the image, products of bf16 values summed in f32,
// the bias added in f32, and one rounding to bf16 at the end.
//
// Layout (the Pallas kernel's interface):
//   x (B, H, W, Cin) bf16 NHWC; w (3, 3, Cin, Cout) bf16 HWIO; bias (Cout,) f32;
//   y (B, H, W, Cout) bf16. Cin a multiple of 16 up to 128, Cout a multiple of 64.
//
// What bounds it at conv1_2 (B=1, 480x640, 64->64): 2*9*64*64*307,200 =
// 22.6 GFLOP, about 23 us at 989 TFLOP/s bf16, and 2 x 39.3 MB of activations
// in and out, about 23 us at 3.35 TB/s: the layer is balanced between the
// tensor cores and memory. wgmma, TMA and a persistent grid are later work.
//
// Design (simple first):
//   * one block of 8 warps per strip of kRowPairs x 2 output rows x 64 output
//     columns x 64 output channels; grid (ceil(W/64), ceil(H/(2*kRowPairs)),
//     B * Cout/64).
//   * the block stages the 9 x Cin x 64 slice of the weights in shared memory
//     once, then walks its strip two output rows at a time, staging the
//     (2+2) x (64+2) x Cin halo of each pair (dynamic shared memory, 105 KB at
//     Cin=64, so two blocks fit on an SM). Pixels outside the image are staged
//     as zeros, which is the SAME padding; H and W need no padding to the tile.
//   * each warp owns 16 output pixels of one row x 64 channels: four 16x16 f32
//     accumulator fragments. For each of the 9 taps and each 16-channel step
//     of Cin it multiplies a 16x16 bf16 tile of shifted input pixels (rows of
//     the halo) by four 16x16 weight tiles on the tensor cores (WMMA
//     m16n16k16, bf16 in, f32 accumulate).
//   * shared memory holds every operand as 16-wide column blocks (halo
//     [Cin/16][pixel][16], weights [tap][Cin/16][64/16][16][16], accumulators
//     [64/16][pixel][16]), so a fragment's 16 rows are 32 (or 64) bytes apart
//     and a fragment load or store touches every bank once per wavefront; in
//     plain NHWC rows 128 bytes apart, all 16 rows hit the same 8 banks.
//   * the accumulators go through shared memory (the halo's space) to an
//     epilogue that adds the bias in f32, applies the ReLU, rounds to bf16 and
//     writes 16 bytes per thread, with the ragged image edge masked.
//   * no row slabs carried from one grid step to the next, no W padding to +8
//     and no channel padding to 128: those were the TPU's (8, 128) tiling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kTileH = 2;      // output rows per pass
constexpr int kRowPairs = 4;   // passes per block: the weights are staged once for them
constexpr int kTileW = 64;     // output columns per block
constexpr int kCoBlk = 64;     // output channels per block
constexpr int kWarps = 8;      // kTileH * kTileW / 16 warps of 16 pixels each
constexpr int kThreads = kWarps * 32;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPix = (kTileH + 2) * kHaloW;
constexpr int kPix = kTileH * kTileW;
constexpr int kNb = kCoBlk / 16;  // 16-wide output channel blocks

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory: region 0 holds the halo (bf16) while the taps run and the
// f32 accumulator tile afterwards; region 1 holds the weight slice.
__host__ __device__ inline int region0_bytes(int cin) {
  const int halo = kHaloPix * cin * 2;
  const int stage = kPix * kCoBlk * 4;
  return round_up(halo > stage ? halo : stage, 128);
}

__host__ __device__ inline int smem_bytes(int cin) { return region0_bytes(cin) + 9 * cin * kCoBlk * 2; }

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
               int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);  // [Cin/16][kHaloPix][16]
  float* stage = reinterpret_cast<float*>(smem);                  // [kNb][kPix][16]
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + region0_bytes(Cin));  // [9][Cin/16][kNb][16][16]

  const int n_co = Cout / kCoBlk;
  const int b = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * kCoBlk;
  const int x0 = blockIdx.x * kTileW;
  const int kb_n = Cin / 16;

  // weights: rows r = (tap, i) of w, columns co0 .. co0+63, 8 channels (16 B) a load, staged once
  for (int i = threadIdx.x; i < 9 * Cin * (kCoBlk / 8); i += kThreads) {
    const int v = i % (kCoBlk / 8);
    const int r = i / (kCoBlk / 8);
    const int tap = r / Cin;
    const int ci = r % Cin;
    const int off = ((tap * kb_n + ci / 16) * kNb + v / 2) * 256 + (ci % 16) * 16 + (v % 2) * 8;
    *reinterpret_cast<uint4*>(wsm + off) =
        *reinterpret_cast<const uint4*>(w + static_cast<long long>(r) * Cout + co0 + v * 8);
  }

  const int warp = threadIdx.x / 32;
  const int wr = warp / (kTileW / 16);         // output row of the pass
  const int wc = (warp % (kTileW / 16)) * 16;  // first output column of the warp
  const int vpp = Cin / 8;

  for (int pass = 0; pass < kRowPairs; ++pass) {
    const int y0 = (blockIdx.y * kRowPairs + pass) * kTileH;
    if (y0 >= H) break;
    __syncthreads();  // the previous pass's epilogue is done with region 0
    // halo: rows y0-1 .. y0+kTileH, columns x0-1 .. x0+kTileW, 8 channels (16 B) a load
    for (int i = threadIdx.x; i < kHaloPix * vpp; i += kThreads) {
      const int v = i % vpp;
      const int p = i / vpp;
      const int gy = y0 - 1 + p / kHaloW;
      const int gx = x0 - 1 + p % kHaloW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        val = *reinterpret_cast<const uint4*>(x + ((static_cast<long long>(b) * H + gy) * W + gx) * Cin + v * 8);
      }
      *reinterpret_cast<uint4*>(halo + ((v / 2) * kHaloPix + p) * 16 + (v % 2) * 8) = val;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNb];
#pragma unroll
    for (int n = 0; n < kNb; ++n) wmma::fill_fragment(acc[n], 0.0f);

    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        // A: 16 consecutive halo pixels (one per row of the fragment) x 16 channels
        const int pix = (wr + dy) * kHaloW + wc + dx;
        const __nv_bfloat16* w_tap = wsm + (dy * 3 + dx) * kb_n * kNb * 256;
        for (int kb = 0; kb < kb_n; ++kb) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, halo + (kb * kHaloPix + pix) * 16, 16);
#pragma unroll
          for (int n = 0; n < kNb; ++n) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bw;
            wmma::load_matrix_sync(bw, w_tap + (kb * kNb + n) * 256, 16);
            wmma::mma_sync(acc[n], a, bw, acc[n]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the halo: its space becomes the f32 tile

#pragma unroll
    for (int n = 0; n < kNb; ++n) {
      wmma::store_matrix_sync(stage + (n * kPix + wr * kTileW + wc) * 16, acc[n], 16, wmma::mem_row_major);
    }
    __syncthreads();

    // epilogue: bias in f32, ReLU, one rounding to bf16, 8 channels (16 B) a store
    for (int i = threadIdx.x; i < kPix * (kCoBlk / 8); i += kThreads) {
      const int v = i % (kCoBlk / 8);
      const int p = i / (kCoBlk / 8);
      const int gy = y0 + p / kTileW;
      const int gx = x0 + p % kTileW;
      if (gy >= H || gx >= W) continue;
      const float* src = stage + ((v / 2) * kPix + p) * 16 + (v % 2) * 8;
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = __fadd_rn(src[j], bias[co0 + v * 8 + j]);
        if (relu) s = fmaxf(s, 0.0f);
        out[j] = __float2bfloat16_rn(s);
      }
      *reinterpret_cast<uint4*>(y + ((static_cast<long long>(b) * H + gy) * W + gx) * Cout + co0 + v * 8) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 = launched).
// The caller checks shapes (Cin % 16 == 0, 16 <= Cin <= 128, Cout % 64 == 0)
// and 16-byte alignment of x, w and y.
extern "C" int conv3x3_launch(const void* x, const void* w, const float* bias, void* y,
                              int B, int H, int W, int Cin, int Cout, int relu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (Cin % 16 != 0 || Cin < 16 || Cin > 128 || Cout % kCoBlk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(Cin);
  // above 48 KB of dynamic shared memory only after this opt-in, which holds
  // per device: set it on every launch
  const cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int strip = kTileH * kRowPairs;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + strip - 1) / strip, B * (Cout / kCoBlk));
  conv3x3_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}
