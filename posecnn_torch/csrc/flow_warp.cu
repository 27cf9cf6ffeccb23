// The video model's flow warp: the window mean of the recurrent state over
// each pixel's matched window taps, and its backward, for sm_90a.
//
// No TPU kernel is replaced: `posecnn_tpu/ops/compute_flow.py:compute_flow`
// (:25) computes the warp in plain jnp, which XLA fuses. In eager PyTorch the
// same function is ~2,600 launches a frame at k = 3 (49 gathers of the whole
// state for the match, 49 more for the mean, 49 `index_add_`s in its
// backward, and their masks), and its backward's scatter alone took ~240 ms
// of a ~440 ms DA-RNN training step on the H100. These two kernels take its
// place for CUDA tensors (`ops/compute_flow.py:_WindowMean`); the projection
// (K^-1, pose_live2world, K, the rounding and XLA's float-to-int cast) stays
// in PyTorch, so the pixel indices are the plain version's bit for bit.
//
// Forward (`flow_warp_forward`), one block an 8 x 8 tile of pixels:
//   1. the match mask: four threads a pixel, each testing a quarter of the
//      (2k+1)^2 taps (dx outer, dy inner: tap o = (dx+k)(2k+1) + dy+k); a tap
//      matches where the pixel has depth, its window pixel (px+dx, py+dy) lies
//      in the image (int32 arithmetic that wraps as torch's does) and the
//      previous frame's stored z there is within `threshold` of the warped z
//      (|z_prev - z1| < threshold in float32, NaN never matching). The four
//      partial masks are ORed by shuffles into one 64-bit word a pixel
//      (at most 8 x 8 taps: k <= 3), written out for the backward with
//      denom = max(popcount, 1).
//   2. the mean: a pixel's [data | weights] channels are split into units of
//      4 floats (1 where C is not a multiple of 4 or a tensor is not 16-byte
//      aligned), the threads of a warp walk the pixel's set bits in tap order,
//      8 loads in flight, and add each matched tap's unit to an f32
//      accumulator: acc + x for each matched tap in the plain order, which
//      rounds as the plain version's acc + 1 * x, while a tap that did not
//      match adds nothing there either (acc + 0 * x leaves acc as it is for
//      finite x, and acc is never -0). It writes where(count > 0,
//      acc / denom, 0 for data and 1 for weights) with an IEEE divide. So the
//      outputs, the mask and denom are bit-equal to the plain version.
//
// Backward (`flow_warp_backward`), one block an 8 x 8 tile of output pixels
// and a slice of 32 of the 2C channels: for each matched tap of each pixel,
// g / denom is added to the tap's source pixel (the cotangent scattered back
// through the window). Adaptive on the indices it sees: the block takes the
// box its pixels' matched windows reach (px, py +- k, inside the image); where
// that box fits in shared memory (`kBoxCap` pixels, 46 KB), the block adds
// into it with shared atomics and then flushes each box pixel that received a
// non-zero sum once, as one global float4 atomic add a unit; otherwise (a
// tile across a depth edge or under large motion) it adds straight into
// global memory. Both do the same adds; the atomics' order differs from run
// to run, as `index_add_`'s does. The wrapper zero-fills the gradients.
//
// Bound: each way reads the state (data and weights, 2C floats a pixel),
// the indices, the mask or depths, and writes 2C floats a pixel once: at the
// DA-RNN cell's shape (480 x 640, C = 64) ~0.32 GB, ~0.1 ms at 3.35 TB/s a
// direction. The window's reuse (each source pixel is read by up to 49
// pixels, and written by as many in the backward) is what the design keeps
// out of device memory: the forward's tile reads its neighbours' rows
// through L1 (an 8 x 8 tile's 14 x 14 source box under small motion), and
// the backward sums a tile's 49 contributions a source pixel in shared
// memory, so device memory sees ~3x the state (the boxes' halo) in global
// atomics instead of 49x.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 8;
constexpr int kTileH = 8;
constexpr int kTilePixels = kTileW * kTileH;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;      // bits of a pixel's mask word
constexpr int kSliceFloats = 32;  // channels of [data | weights] a backward block takes
constexpr int kInFlight = 8;      // the forward's loads in flight a thread
// a backward block's shared memory: 32 channels of up to kBoxCap box pixels
constexpr int kBackwardSmem = 46 * 1024;
constexpr int kBoxCap = kBackwardSmem / (kSliceFloats * 4) - 1;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// global atomic add of a unit: one vector atomic on sm_90 where the toolkit
// has it, else one a float
template <int VEC>
__device__ __forceinline__ void add_global(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
#if CUDART_VERSION >= 12010
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
#else
    for (int e = 0; e < 4; ++e) atomicAdd(p + e, v[e]);
#endif
  } else {
    atomicAdd(p, v[0]);
  }
}

// The tile of block index t: (image, first row, first column).
__device__ __forceinline__ void tile_of(int t, int H, int W, int& b, int& y0, int& x0) {
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  b = t / (tiles_x * tiles_y);
  t -= b * tiles_x * tiles_y;
  y0 = (t / tiles_x) * kTileH;
  x0 = (t % tiles_x) * kTileW;
}

// Threads a pixel in the forward's mean: the units of a pixel up to a warp,
// a power of two, so a pixel's threads share a warp.
__device__ __forceinline__ int threads_per_pixel(int units) {
  int t = 1;
  while (t < units && t < 32) t <<= 1;
  return t;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) flow_warp_forward(
    const int* __restrict__ px, const int* __restrict__ py, const float* __restrict__ z1,
    const uint8_t* __restrict__ has_depth, const float* __restrict__ points, const float* __restrict__ data,
    const float* __restrict__ weights, float* __restrict__ out_data, float* __restrict__ out_weights,
    unsigned long long* __restrict__ mask_out, float* __restrict__ denom_out, int H, int W, int C, int k,
    float threshold) {
  __shared__ unsigned long long s_mask[kTilePixels];
  __shared__ int s_base[kTilePixels];  // the flat index of (py, px) where a tap matched
  __shared__ int s_off[kMaxTaps];      // tap o's dy * W + dx

  int b, y0, x0;
  tile_of(blockIdx.x, H, W, b, y0, x0);
  const int k2 = 2 * k + 1, taps = k2 * k2, tid = threadIdx.x;
  if (tid < taps) s_off[tid] = (tid % k2 - k) * W + (tid / k2 - k);

  {  // 1. the match mask, four threads a pixel
    const int p = tid >> 2, j = tid & 3;
    const int y = y0 + p / kTileW, x = x0 + p % kTileW;
    const bool inside = y < H && x < W;
    const int pix = inside ? (b * H + y) * W + x : 0;
    unsigned long long m = 0;
    int cx = 0, cy = 0;
    if (inside && has_depth[pix]) {
      cx = px[pix];
      cy = py[pix];
      const float z = z1[pix];
      for (int o = j; o < taps; o += 4) {
        const int xx = static_cast<int>(static_cast<unsigned>(cx) + static_cast<unsigned>(o / k2 - k));
        const int yy = static_cast<int>(static_cast<unsigned>(cy) + static_cast<unsigned>(o % k2 - k));
        if (xx >= 0 && xx < W && yy >= 0 && yy < H) {
          const float zp = __ldg(points + 3 * static_cast<size_t>((b * H + yy) * W + xx) + 2);
          if (fabsf(zp - z) < threshold) m |= 1ull << o;
        }
      }
    }
    m |= __shfl_xor_sync(0xffffffffu, m, 1);
    m |= __shfl_xor_sync(0xffffffffu, m, 2);
    if (j == 0) {
      s_mask[p] = m;
      // a matched tap lies in the image, so (cx, cy) lies within k of it
      s_base[p] = m ? (b * H + cy) * W + cx : 0;
      if (inside) {
        mask_out[pix] = m;
        denom_out[pix] = fmaxf(static_cast<float>(__popcll(m)), 1.0f);
      }
    }
  }
  __syncthreads();

  // 2. the mean over the matched taps
  const int half = C / VEC, units = 2 * half;
  const int tpp = threads_per_pixel(units), slots = kThreads / tpp;
  for (int p = tid / tpp; p < kTilePixels; p += slots) {
    const int y = y0 + p / kTileW, x = x0 + p % kTileW;
    if (y >= H || x >= W) continue;
    const size_t pix = static_cast<size_t>((b * H + y) * W + x);
    const unsigned long long m0 = s_mask[p];
    const int base = s_base[p];
    const float denom = fmaxf(static_cast<float>(__popcll(m0)), 1.0f);
    for (int u = tid % tpp; u < units; u += tpp) {
      const bool is_data = u < half;
      const int c = (is_data ? u : u - half) * VEC;
      const float* src = (is_data ? data : weights) + c;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
      unsigned long long m = m0;
      while (m) {
        float v[kInFlight][VEC];
        int n = 0;
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          if (m) {
            const int o = __ffsll(static_cast<long long>(m)) - 1;
            m &= m - 1;
            load<VEC>(src + static_cast<size_t>(base + s_off[o]) * C, v[i]);
            n = i + 1;
          }
        }
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          if (i < n) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = acc[e] + v[i][e];
          }
        }
      }
      float r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[e] = m0 ? acc[e] / denom : (is_data ? 0.0f : 1.0f);
      store<VEC>((is_data ? out_data : out_weights) + pix * C + c, r);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) flow_warp_backward(
    const float* __restrict__ g_data, const float* __restrict__ g_weights, const int* __restrict__ px,
    const int* __restrict__ py, const unsigned long long* __restrict__ mask, const float* __restrict__ denom,
    float* __restrict__ grad_data, float* __restrict__ grad_weights, int H, int W, int C, int k, int box_cap) {
  extern __shared__ float s_box[];  // [32 channels][stride] partial sums of the tile's box
  __shared__ unsigned long long s_mask[kTilePixels];
  __shared__ int s_cx[kTilePixels], s_cy[kTilePixels];
  __shared__ float s_den[kTilePixels];
  __shared__ int s_boff[kMaxTaps];  // tap o's dy * box width + dx
  __shared__ int s_lim[4];          // the box: x min, x max, y min, y max

  int b, y0, x0;
  tile_of(blockIdx.x, H, W, b, y0, x0);
  const int k2 = 2 * k + 1, taps = k2 * k2, tid = threadIdx.x;
  const int half = C / VEC, units = 2 * half, slice_units = kSliceFloats / VEC;
  const int u0 = blockIdx.y * slice_units, nu = min(units - u0, slice_units);
  if (tid == 0) {
    s_lim[0] = s_lim[2] = 0x7fffffff;
    s_lim[1] = s_lim[3] = -0x7fffffff - 1;
  }
  __syncthreads();
  if (tid < kTilePixels) {
    const int y = y0 + tid / kTileW, x = x0 + tid % kTileW;
    unsigned long long m = 0;
    if (y < H && x < W) {
      const int pix = (b * H + y) * W + x;
      m = mask[pix];
      if (m) {
        const int cx = px[pix], cy = py[pix];
        s_cx[tid] = cx;
        s_cy[tid] = cy;
        s_den[tid] = denom[pix];
        atomicMin(&s_lim[0], max(cx - k, 0));
        atomicMax(&s_lim[1], min(cx + k, W - 1));
        atomicMin(&s_lim[2], max(cy - k, 0));
        atomicMax(&s_lim[3], min(cy + k, H - 1));
      }
    }
    s_mask[tid] = m;
  }
  __syncthreads();
  const int xmin = s_lim[0], ymin = s_lim[2];
  if (s_lim[1] < xmin) return;  // no pixel of the tile matched: nothing to add
  const int bw = s_lim[1] - xmin + 1, box = bw * (s_lim[3] - ymin + 1);
  const bool staged = box <= box_cap;
  const int stride = box | 1;  // odd: a warp's 8 units x 4 pixels fall in 32 banks
  if (staged) {
    for (int i = tid; i < nu * VEC * stride; i += kThreads) s_box[i] = 0.0f;
    if (tid < taps) s_boff[tid] = (tid % k2 - k) * bw + (tid / k2 - k);
    __syncthreads();
  }
  for (int it = tid; it < kTilePixels * nu; it += kThreads) {
    const int p = it / nu, ul = it % nu;
    unsigned long long m = s_mask[p];
    if (!m) continue;
    const int u = u0 + ul;
    const bool is_data = u < half;
    const int c = (is_data ? u : u - half) * VEC;
    const int y = y0 + p / kTileW, x = x0 + p % kTileW;
    const size_t pix = static_cast<size_t>((b * H + y) * W + x);
    float v[VEC];
    load<VEC>((is_data ? g_data : g_weights) + pix * C + c, v);
    const float d = s_den[p];
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = v[e] / d;
    const int cx = s_cx[p], cy = s_cy[p];
    if (staged) {
      const int q0 = (cy - ymin) * bw + (cx - xmin);
      float* col = s_box + ul * VEC * stride;
      while (m) {
        const int o = __ffsll(static_cast<long long>(m)) - 1;
        m &= m - 1;
        const int q = q0 + s_boff[o];
#pragma unroll
        for (int e = 0; e < VEC; ++e) atomicAdd(col + e * stride + q, v[e]);
      }
    } else {
      float* dst = (is_data ? grad_data : grad_weights) + c;
      while (m) {
        const int o = __ffsll(static_cast<long long>(m)) - 1;
        m &= m - 1;
        const size_t src = static_cast<size_t>((b * H + cy + (o % k2 - k)) * W + cx + (o / k2 - k));
        add_global<VEC>(dst + src * C, v);
      }
    }
  }
  if (!staged) return;
  __syncthreads();
  // flush: each box pixel's non-zero units, once
  for (int it = tid; it < box * nu; it += kThreads) {
    const int q = it / nu, ul = it % nu;
    const float* col = s_box + ul * VEC * stride + q;
    float r[VEC];
    bool any = false;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      r[e] = col[e * stride];
      any |= r[e] != 0.0f;
    }
    if (!any) continue;
    const int u = u0 + ul;
    const bool is_data = u < half;
    const int c = (is_data ? u : u - half) * VEC;
    const size_t g = static_cast<size_t>((b * H + ymin + q / bw) * W + xmin + q % bw);
    add_global<VEC>((is_data ? grad_data : grad_weights) + g * C + c, r);
  }
}

bool valid_shape(int B, int H, int W, int C, int k, int vec) {
  const long long pixels = static_cast<long long>(B) * H * W;
  return B >= 0 && H >= 0 && W >= 0 && C > 0 && k >= 0 && (2 * k + 1) * (2 * k + 1) <= kMaxTaps &&
         (vec == 1 || vec == 4) && C % vec == 0 && pixels < (1ll << 31) / 3;
}

}  // namespace

extern "C" int flow_warp_forward_launch(const void* px, const void* py, const void* z1, const void* has_depth,
                                        const void* points, const void* data, const void* weights, void* out_data,
                                        void* out_weights, void* mask, void* denom, int B, int H, int W, int C,
                                        int k, float threshold, int vec, void* stream) {
  if (!valid_shape(B, H, W, C, k, vec)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int blocks = B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = vec == 4 ? flow_warp_forward<4> : flow_warp_forward<1>;
  launch<<<blocks, kThreads, 0, s>>>(
      static_cast<const int*>(px), static_cast<const int*>(py), static_cast<const float*>(z1),
      static_cast<const uint8_t*>(has_depth), static_cast<const float*>(points), static_cast<const float*>(data),
      static_cast<const float*>(weights), static_cast<float*>(out_data), static_cast<float*>(out_weights),
      static_cast<unsigned long long*>(mask), static_cast<float*>(denom), H, W, C, k, threshold);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flow_warp_backward_launch(const void* g_data, const void* g_weights, const void* px, const void* py,
                                         const void* mask, const void* denom, void* grad_data, void* grad_weights,
                                         int B, int H, int W, int C, int k, int vec, void* stream) {
  if (!valid_shape(B, H, W, C, k, vec)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int slice_units = kSliceFloats / vec;
  const dim3 grid(B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW),
                  (2 * C / vec + slice_units - 1) / slice_units);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = vec == 4 ? flow_warp_backward<4> : flow_warp_backward<1>;
  // the attribute belongs to the current device: set on every launch
  cudaError_t err = cudaFuncSetAttribute(launch, cudaFuncAttributeMaxDynamicSharedMemorySize, kBackwardSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch<<<grid, kThreads, kBackwardSmem, s>>>(
      static_cast<const float*>(g_data), static_cast<const float*>(g_weights), static_cast<const int*>(px),
      static_cast<const int*>(py), static_cast<const unsigned long long*>(mask), static_cast<const float*>(denom),
      static_cast<float*>(grad_data), static_cast<float*>(grad_weights), H, W, C, k, kBoxCap);
  return static_cast<int>(cudaGetLastError());
}
