// Bilateral filter of a uint8 image with 3 channels: the arithmetic of
// OpenCV's bilateralFilter_8u (cv::bilateralFilter(src, d, sigmaColor,
// sigmaSpace) with the default border), on the host, for the normal-map
// input image of the training data path (posecnn_tpu/data/minibatch.py:
// normal_input_image, d = 9, sigma 75 and 75).
//
//   radius   d / 2 (d <= 0: round(1.5 * sigma_space)), at least 1
//   window   the offsets (i, j) with sqrt(i*i + j*j) <= radius, rows first
//   border   reflect-101 (the edge pixel is not repeated)
//   weights  space exp(-r^2 / (2 sigma_space^2)) with r = sqrt(i*i + j*j),
//            colour exp(-c^2 / (2 sigma_color^2)) with c the sum of the
//            three channels' absolute differences to the centre pixel; both
//            tables are computed in double and stored as float
//   sum      w = space * colour in float; each channel's sum of value * w
//            and the sum of w accumulate in float over the window, in the
//            window's order, each product added by a fused multiply-add as
//            OpenCV's vector code does; the result is round(sum * (1 / wsum))
//            with ties to even
//
// This is OpenCV's own arithmetic; cv2 wheels built with Intel's IPP run
// IPP's filter instead, which rounds about one value in 10^5 the other way.
//
// Build: g++ -O3 -shared -fPIC -ffp-contract=off (posecnn_torch/_build.py);
// the fused multiply-adds are explicit std::fma calls, so no other
// contraction may change the rounding. On x86-64 a CPU with FMA runs the
// same loop compiled for it, where each std::fma is one instruction and not
// a call into libm; std::fma is exact either way. -DBILATERAL_NO_DISPATCH
// builds the plain loop alone (chip_smoke.py times the two builds).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) {
    if (p < 0) p = -p;
    if (p >= n) p = 2 * n - 2 - p;
  }
  return p;
}

// the window sums of every output pixel (see the header); always inlined,
// so each caller below compiles it for its own instruction set
__attribute__((always_inline)) inline void filter_rows_impl(const uint8_t* pad, int pw, uint8_t* dst, int height,
                                                            int width, int radius, int maxk, const long* ofs,
                                                            const float* space_weight, const float* color_weight) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = pad + (static_cast<size_t>(y + radius) * pw + radius) * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * width * 3;
    for (int x = 0; x < width; ++x) {
      const uint8_t* c = row + static_cast<size_t>(x) * 3;
      const int b0 = c[0], g0 = c[1], r0 = c[2];
      float sum_b = 0.f, sum_g = 0.f, sum_r = 0.f, wsum = 0.f;
      for (int k = 0; k < maxk; ++k) {
        const uint8_t* q = c + ofs[k];
        const int b = q[0], g = q[1], r = q[2];
        const float w = space_weight[k] * color_weight[std::abs(b - b0) + std::abs(g - g0) + std::abs(r - r0)];
        wsum += w;
        sum_b = std::fma(static_cast<float>(b), w, sum_b);
        sum_g = std::fma(static_cast<float>(g), w, sum_g);
        sum_r = std::fma(static_cast<float>(r), w, sum_r);
      }
      const float inv = 1.f / wsum;
      out[3 * x + 0] = static_cast<uint8_t>(std::nearbyint(sum_b * inv));
      out[3 * x + 1] = static_cast<uint8_t>(std::nearbyint(sum_g * inv));
      out[3 * x + 2] = static_cast<uint8_t>(std::nearbyint(sum_r * inv));
    }
  }
}

#if defined(__x86_64__) && !defined(BILATERAL_NO_DISPATCH)
__attribute__((target("fma"))) void filter_rows_fma(const uint8_t* pad, int pw, uint8_t* dst, int height, int width,
                                                    int radius, int maxk, const long* ofs, const float* space_weight,
                                                    const float* color_weight) {
  filter_rows_impl(pad, pw, dst, height, width, radius, maxk, ofs, space_weight, color_weight);
}
#endif

void filter_rows(const uint8_t* pad, int pw, uint8_t* dst, int height, int width, int radius, int maxk,
                 const long* ofs, const float* space_weight, const float* color_weight) {
#if defined(__x86_64__) && !defined(BILATERAL_NO_DISPATCH)
  if (__builtin_cpu_supports("fma")) {
    filter_rows_fma(pad, pw, dst, height, width, radius, maxk, ofs, space_weight, color_weight);
    return;
  }
#endif
  filter_rows_impl(pad, pw, dst, height, width, radius, maxk, ofs, space_weight, color_weight);
}

}  // namespace

extern "C" int bilateral_filter_u8c3(const uint8_t* src, uint8_t* dst, int height, int width, int d,
                                     double sigma_color, double sigma_space) {
  if (height <= 0 || width <= 0) return 1;
  int radius = d <= 0 ? static_cast<int>(std::nearbyint(sigma_space * 1.5)) : d / 2;
  if (radius < 1) radius = 1;
  const double gauss_color = -0.5 / (sigma_color * sigma_color);
  const double gauss_space = -0.5 / (sigma_space * sigma_space);

  std::vector<float> color_weight(3 * 256);
  for (int i = 0; i < 3 * 256; ++i) color_weight[i] = static_cast<float>(std::exp(i * i * gauss_color));
  std::vector<float> space_weight;
  std::vector<int> dy, dx;
  for (int i = -radius; i <= radius; ++i) {
    for (int j = -radius; j <= radius; ++j) {
      double r = std::sqrt(static_cast<double>(i) * i + static_cast<double>(j) * j);
      if (r > radius) continue;
      space_weight.push_back(static_cast<float>(std::exp(r * r * gauss_space)));
      dy.push_back(i);
      dx.push_back(j);
    }
  }
  const int maxk = static_cast<int>(space_weight.size());

  // the padded image, as OpenCV's copyMakeBorder builds it
  const int pw = width + 2 * radius, ph = height + 2 * radius;
  std::vector<uint8_t> pad(static_cast<size_t>(ph) * pw * 3);
  for (int y = 0; y < ph; ++y) {
    const int sy = reflect101(y - radius, height);
    for (int x = 0; x < pw; ++x) {
      const int sx = reflect101(x - radius, width);
      const uint8_t* s = src + (static_cast<size_t>(sy) * width + sx) * 3;
      uint8_t* p = pad.data() + (static_cast<size_t>(y) * pw + x) * 3;
      p[0] = s[0];
      p[1] = s[1];
      p[2] = s[2];
    }
  }
  std::vector<long> ofs(maxk);
  for (int k = 0; k < maxk; ++k) ofs[k] = (static_cast<long>(dy[k]) * pw + dx[k]) * 3;

  filter_rows(pad.data(), pw, dst, height, width, radius, maxk, ofs.data(), space_weight.data(), color_weight.data());
  return 0;
}
