// Stride-1 SAME 3x3 convolution for Hopper (sm_90a): wgmma fed by TMA, a
// persistent grid. Plain C entry point for ctypes.
//
// Replaces posecnn_tpu/ops/pallas/conv3x3.py:_conv_kernel (the TPU Pallas
// kernel, pallas_call at conv3x3.py:102). Serves the forward of the trunk's
// full-resolution conv1_2 layer and its dgrad (the same convolution of the
// cotangent with flipped, transposed weights, as conv3x3.py:_conv3x3_bwd does).
//
// What it computes, for every image b, pixel (h, w) and output channel o:
//   acc[b,h,w,o] = sum_{dy,dx,i} x[b,h+dy-1,w+dx-1,i] * w[dy,dx,i,o]
// with x zero outside the image and products of bf16 values summed in f32,
// then one of three epilogues (flags):
//   0: bf16(acc + bias)             bias in f32, one rounding (dgrad: no bias)
//   1: bf16(relu(acc + bias))       the Pallas module's conv3x3_bias_relu
//   3: relu(bf16(bf16(acc) + bf16(bias)))  the trunk's conv1_2, whose bias is
//      added in bf16 after the conv's own rounding (layers.py:conv3x3_manual_bwd)
//
// Layout: x (B, H, W, Cin) bf16 NHWC; y (B, H, W, Cout) bf16; bias (Cout,)
// f32 or null (zero); the weights packed by ops/conv3x3.py:pack_weights into
// the image that wgmma reads: [Cout/64][tap 9][Cin/64][64 out][64 in] bf16,
// each 64 x 64 block (8 KB) K-major with the 128-byte swizzle applied (16-byte
// chunk c of row n stored at chunk c ^ (n % 8)). Cin and Cout 64 or 128.
//
// What bounds it at conv1_2 (B=1, 480x640, 64->64): 2*9*64*64*307,200 =
// 22.6 GFLOP, 22.9 us at 989 TFLOP/s bf16, and 78.6 MB of x and y moved once,
// 23.5 us at 3.35 TB/s: the layer sits on the ridge, so the tensor cores must
// run near their rate while x streams in and y streams out, with neither
// waiting on the other. Inside the SM the third limit is shared memory's 128
// bytes a clock: the operands of every wgmma are read from it.
//
// Design:
//   * persistent grid: one block per SM (the weight image and a deep halo
//     ring take most of the 227 KB). The B*ceil(W/128)*H output tile rows of a
//     Cout/64 block are split into equal contiguous runs, one per block, so
//     there is no tail wave; a run walks down one 128-column strip, and each
//     output row then needs one new input row (x is read ~1.1 times).
//   * each block fetches its 9 x Cin x 64 weight image once, with bulk copies,
//     already in wgmma's swizzled layout (73.7 KB at Cin=64).
//   * a ring of kStages halo rows (one input row of 130 pixels x Cin each),
//     filled by TMA from one producer thread behind full/empty mbarriers. The
//     tensor map spans NHWC x with signed coordinates: the boxes at row -1,
//     row H, column -1 and past column W come back as zeros, which is the
//     SAME padding, with no padded copy and no masks on the load side.
//   * the product runs transposed: y_row^T (64 out x 128 pixels) += W_tap^T
//     (64 x 16) * x_row^T (16 x 128), wgmma m64n128k16, both operands from
//     shared memory: A the weight block of the tap, B the halo row itself,
//     K-major. Tap dx needs the row shifted by dx pixels: a descriptor that
//     starts dx 128-byte rows into the swizzle atom reads exactly that. With
//     N=128 a row's wgmmas read 221 KB of shared memory against 2,304 tensor
//     clocks; the other way round (A the pixels through ldmatrix, N=64 out
//     channels) a row reads 295 KB, as many clocks as the tensor cores'
//     own, and measured at half their rate.
//   * two consumer warpgroups take the block's rows in turn, a whole row
//     each (f32 accumulators in registers). Named barriers pass the turn to
//     issue wgmmas, handed on while the row's last tap still runs, so one
//     warpgroup's epilogue runs under the other's wgmmas.
//   * epilogue from registers: bias, rounding and ReLU per the flags, bf16
//     pairs transposed to NHWC by stmatrix into a swizzled staging row
//     (conflict-free), then one TMA store, which clips the ragged right edge.
//   * at Cin=128 the weight image is 147 KB: a tile row is then 64 pixels
//     (wgmma m64n64k16) and the ring 3 rows deep.
//   * no WMMA, no library kernel; sums in f32 in another order than the plain
//     version, so the result is within 1 bf16 ulp of it. Built -fmad=false so
//     the epilogue rounds as the plain version does.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;  // consumer warpgroups; they take output rows in turn
constexpr int kBlockBytes = 64 * 64 * 2;  // one 64 x 64 bf16 operand block
constexpr int kSmemLimit = 232448;        // what one block may opt in to
constexpr int kMaxStages = 6;
constexpr int kFlagRelu = 1, kFlagBf16Bias = 2;

template <int CIN>
struct Cfg {
  static constexpr int kKb = CIN / 64;                 // 64-channel blocks: one 128-byte swizzle span each
  static constexpr int kTileW = CIN == 64 ? 128 : 64;  // output pixels of a tile row: the wgmma's N
  static constexpr int kAcc = kTileW / 2;              // f32 accumulators a thread
  static constexpr int kHaloW = kTileW + 2;
  static constexpr int kBoxBytes = kHaloW * 128;       // one TMA box: a halo row of one channel block
  static constexpr int kRowBytes = (kBoxBytes + 1023) / 1024 * 1024;  // swizzled boxes start 1024-aligned
  static constexpr int kStageBytes = kKb * kRowBytes;
  static constexpr int kWeightBytes = 9 * kKb * kBlockBytes;
  static constexpr int kOutBytes = kConsumers * kTileW * 128;  // a staging row per warpgroup
  static constexpr int kBarBytes = 8 * (2 * kMaxStages + 1);
  static constexpr int kFixed = 1024 + kWeightBytes + kOutBytes + kBarBytes;  // 1024: aligning the base
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kStages = kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr int kSmem = kFixed + kStages * kStageBytes;
  static constexpr int kThreads = kConsumers * kWarpgroup + 32;  // + one producer warp
  static constexpr int kKsteps = CIN / 16;
  static_assert(kStages >= 3, "an output row needs three input rows resident");
};

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

// Waits for the phase of `bar` with this parity to complete. A wait that
// lasts some 10^10 cycles (seconds; the longest real one is microseconds)
// traps, so a broken pipeline fails its launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 10000000000LL) __trap();
  }
}

// bytes from global to shared memory, completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one box of the 4-D tensor map (channel, column, row, image) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int x, int y,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c, int x, int y, int b) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c), "r"(x), "r"(y), "r"(b)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the last store has read its staging tile (it may still be writing y)
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait_all() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// four 8x8 bf16 matrices of an accumulator fragment, each stored transposed:
// lane i of matrix j's 8 lanes gives the address of its column i
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across the async wgmmas
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this mode). The
// hardware takes the swizzle's phase from the address bits, as TMA does, so
// a matrix may start at any 128-byte row of a swizzle atom with the
// base-offset field 0 (setting it to that row, as the PTX ISA's formula
// for unaligned starts gives, reads the wrong chunks on the H100).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x N f32) += a (64 x 16 bf16) * b (16 x N bf16), both K-major in shared
// memory behind descriptors; scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 }, "
      "%64, %65, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 }, "
      "%32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The block's share of the output: tile rows [r0, r1) of one Cout/64 block,
// tile row r = ((b * n_strips) + strip) * H + h, cut into segments that stay
// in one (image, strip).
struct Segment {
  int b, x0, h, len;
};

__device__ __forceinline__ Segment segment_at(long long r, long long r1, int H, int n_strips, int tile_w) {
  Segment s;
  s.h = static_cast<int>(r % H);
  const long long bs = r / H;
  s.x0 = static_cast<int>(bs % n_strips) * tile_w;
  s.b = static_cast<int>(bs / n_strips);
  const long long left = r1 - r;
  s.len = left < H - s.h ? static_cast<int>(left) : H - s.h;
  return s;
}

template <int CIN>
__global__ void __launch_bounds__(Cfg<CIN>::kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
               const __nv_bfloat16* __restrict__ wpk, const float* __restrict__ bias, int B, int H, int W, int n_co,
               int flags) {
  using C = Cfg<CIN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t wsm = base;                               // weight image
  const uint32_t ring = wsm + C::kWeightBytes;             // kStages halo rows
  const uint32_t osm = ring + C::kStages * C::kStageBytes;  // output staging, one row per warpgroup
  const uint32_t bars = osm + C::kOutBytes;                // full[kStages], empty[kStages], weights
  const uint32_t wbar = bars + 16 * C::kStages;

  const int co = blockIdx.x % n_co;
  const int per_co = gridDim.x / n_co;
  const int part = blockIdx.x / n_co;
  const int n_strips = (W + C::kTileW - 1) / C::kTileW;
  const long long total = static_cast<long long>(B) * n_strips * H;
  const long long r0 = total * part / per_co, r1 = total * (part + 1) / per_co;
  if (r0 >= r1) return;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (C::kStages + s), kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers * kWarpgroup) {
    // producer: the weight image once, then the input rows of every segment in order
    if (tid == kConsumers * kWarpgroup) {
      mbar_expect_tx(wbar, C::kWeightBytes);
      const uint8_t* src = reinterpret_cast<const uint8_t*>(wpk) + static_cast<size_t>(co) * C::kWeightBytes;
      for (int t = 0; t < 9; ++t) {
        bulk_load(wsm + t * C::kKb * kBlockBytes, src + t * C::kKb * kBlockBytes, C::kKb * kBlockBytes, wbar);
      }
      int n = 0;
      for (long long r = r0; r < r1;) {
        const Segment sg = segment_at(r, r1, H, n_strips, C::kTileW);
        for (int j = 0; j < sg.len + 2; ++j, ++n) {
          const int s = n % C::kStages;
          mbar_wait(bars + 8 * (C::kStages + s), ((n / C::kStages) & 1) ^ 1);
          const uint32_t full = bars + 8 * s;
          mbar_expect_tx(full, C::kKb * C::kBoxBytes);
#pragma unroll
          for (int kb = 0; kb < C::kKb; ++kb) {
            tma_load(ring + s * C::kStageBytes + kb * C::kRowBytes, &xmap, full, kb * 64, sg.x0 - 1, sg.h - 1 + j,
                     sg.b);
          }
        }
        r += sg.len;
      }
    }
    return;
  }

  // consumers: warpgroup wg takes the block's output rows k with k % 2 == wg
  const int wg = tid / kWarpgroup;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const bool leader = tid % kWarpgroup == 0;
  const int turn_mine = 3 + wg, turn_other = 4 - wg;  // named barriers 3, 4: whose wgmmas go next

  // The accumulator is the output row transposed: 64 output channels (M)
  // x kTileW pixels (N). This thread holds channels c and c + 8 of pixel
  // pairs 8j + 2(lane%4) + {0,1}.
  const int c = warp * 16 + (lane >> 2);
  float bv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v = bias ? bias[co * 64 + c + 8 * hf] : 0.0f;
    if (flags & kFlagBf16Bias) v = __bfloat162float(__float2bfloat16_rn(v));
    bv[hf] = v;
  }
  auto epi = [&](float s, int hf) {
    if (flags & kFlagBf16Bias) s = __bfloat162float(__float2bfloat16_rn(s));
    s = __fadd_rn(s, bv[hf]);
    return (flags & kFlagRelu) ? fmaxf(s, 0.0f) : s;
  };
  auto release = [&](int q) {  // this warp is done with input row q
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + q % C::kStages));
  };

  // stmatrix: lane l stores pixel 8j' + l % 8 of matrix l / 8 = (channel
  // half hf, pixel group j') as 16 bytes, at its swizzled place in the row
  const uint32_t out = osm + wg * C::kTileW * 128;  // this warpgroup's staging row
  const int st_hf = (lane >> 3) & 1, st_j = lane >> 4, st_p = lane & 7;
  float acc[C::kAcc] = {};
  mbar_wait(wbar, 0);
  if (wg == 1) asm volatile("bar.arrive %0, %1;" ::"r"(3), "n"(2 * kWarpgroup) : "memory");  // row 0 is wg 0's
  const long long last = r1 - r0 - 1;
  long long k = 0;  // the block's output rows so far
  int n = 0;        // the block's input rows so far
  for (long long r = r0; r < r1;) {
    const Segment sg = segment_at(r, r1, H, n_strips, C::kTileW);
    int rel = 0;  // the segment's input rows this warpgroup has released
    for (int i = 0; i < sg.len; ++i, ++k) {
      if ((k & 1) != wg) continue;
      for (; rel < i; ++rel) release(n + rel);  // rows below i are the other warpgroup's alone now
      uint32_t rows[3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int q = n + i + dy;
        mbar_wait(bars + 8 * (q % C::kStages), (q / C::kStages) & 1);
        rows[dy] = ring + (q % C::kStages) * C::kStageBytes;
      }
      // in this warpgroup's turn, the 9 taps x Cin/16 k-steps: A the weights
      // of the tap, B the halo row dy shifted by dx pixels (a descriptor dx
      // 128-byte rows into its swizzle atom). Taps 0-7 and tap 8 are two
      // commit groups, so the turn passes while tap 8 still runs.
      named_sync(turn_mine, 2 * kWarpgroup);
      wg_fence();
#pragma unroll
      for (int t = 0; t < 9; ++t) {
#pragma unroll
        for (int ks = 0; ks < C::kKsteps; ++ks) {
          const uint64_t da = sw128_desc(wsm + (t * C::kKb + ks / 4) * kBlockBytes + (ks % 4) * 32);
          const uint64_t db = sw128_desc(rows[t / 3] + (ks / 4) * C::kRowBytes + (t % 3) * 128 + (ks % 4) * 32);
          wgmma_ss<C::kTileW>(acc, da, db, t > 0 || ks > 0);
        }
        if (t == 7) wg_commit();
      }
      wg_commit();
      wg_wait<1>();
      // the other warpgroup's wgmmas go next, while this one finishes and
      // writes its row (the block's last row hands over to no one)
      if (k != last) asm volatile("bar.arrive %0, %1;" ::"r"(turn_other), "n"(2 * kWarpgroup) : "memory");
      wg_wait<0>();
      fence_acc(acc);

      // epilogue: bias, rounding and ReLU per the flags, bf16 pairs
      // transposed by stmatrix into the swizzled staging row (once the last
      // store has read it), then one TMA store
      if (leader) tma_store_wait_read();
      named_sync(1 + wg, kWarpgroup);
#pragma unroll
      for (int j = 0; j < C::kTileW / 8; j += 2) {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // matrix q: channel half q % 2, pixel group j + q / 2
          const int jj = j + q / 2, hf = q % 2;
          const __nv_bfloat162 pk =
              __floats2bfloat162_rn(epi(acc[4 * jj + 2 * hf], hf), epi(acc[4 * jj + 2 * hf + 1], hf));
          v[q] = *reinterpret_cast<const uint32_t*>(&pk);
        }
        const int p = 8 * (j + st_j) + st_p;
        const int chunk = 2 * warp + st_hf;
        stsm_x4_trans(out + p * 128 + ((chunk ^ (p & 7)) << 4), v[0], v[1], v[2], v[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the TMA store reads what was written
      named_sync(1 + wg, kWarpgroup);
      if (leader) tma_store(&ymap, out, co * 64, sg.x0, sg.h + i, sg.b);
    }
    for (; rel < sg.len + 2; ++rel) release(n + rel);
    n += sg.len + 2;
    r += sg.len;
  }
  if (leader) tma_store_wait_all();
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 NHWC tensor (B, H, W, C) as a 4-D map (C, W, H, B), boxes of
// 64 channels x `box_w` pixels of one row, 128-byte swizzled
CUresult encode_nhwc(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int box_w) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2, static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_w), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kMaxDevices = 64;

template <int CIN>
int launch(const void* x, const void* wpk, const float* bias, void* y, int B, int H, int W, int Cout, int flags,
           cudaStream_t stream) {
  using C = Cfg<CIN>;
  // per device, once: the SM count and the opt-in to more than 48 KB of
  // dynamic shared memory
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(conv3x3_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    sms[dev] = n;
  }
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap, ymap;
  if (encode_nhwc(enc, &xmap, x, B, H, W, CIN, C::kHaloW) != CUDA_SUCCESS ||
      encode_nhwc(enc, &ymap, y, B, H, W, Cout, C::kTileW) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_co = Cout / 64;
  const int per_co = sms[dev] / n_co > 0 ? sms[dev] / n_co : 1;
  conv3x3_kernel<CIN><<<per_co * n_co, C::kThreads, C::kSmem, stream>>>(
      xmap, ymap, static_cast<const __nv_bfloat16*>(wpk), bias, B, H, W, n_co, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 = launched).
// x and y 16-byte aligned and contiguous; `wpk` packed by pack_weights;
// `bias` may be null (zero). flags: 1 ReLU, 2 bias added in bf16 after the
// sum's rounding (the trunk's mode, with 1).
extern "C" int conv3x3_launch(const void* x, const void* wpk, const float* bias, void* y, int B, int H, int W,
                              int Cin, int Cout, int flags, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if ((Cout != 64 && Cout != 128) || (flags & ~(kFlagRelu | kFlagBf16Bias)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin == 64) return launch<64>(x, wpk, bias, y, B, H, W, Cout, flags, s);
  if (Cin == 128) return launch<128>(x, wpk, bias, y, B, H, W, Cout, flags, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
