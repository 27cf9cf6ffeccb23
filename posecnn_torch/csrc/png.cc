// PNG row filters undone on the host, for the port's PNG reader
// (posecnn_torch/utils/png.py), which reads the dataset files that the JAX
// package's loaders read with cv2.imread.
//
// The inflated image data of a PNG (ISO/IEC 15948, section 9) is `height`
// rows, each one filter-type byte followed by `rowbytes` bytes. The filter
// predicts each byte from the byte `bpp` to its left (a), the byte above
// (b) and the byte above and to the left (c), all 0 outside the image:
//
//   0 None    x
//   1 Sub     x + a
//   2 Up      x + b
//   3 Average x + floor((a + b) / 2)
//   4 Paeth   x + the one of a, b, c nearest to a + b - c (ties: a, then b)
//
// all modulo 256. `bpp` is the bytes of one pixel, at least 1 (bit depths
// below 8). Sub, Average and Paeth read the byte just reconstructed to the
// left, so a row is a serial loop: that is why this is C++ and not NumPy
// (utils/png.py:unfilter_plain is the row-by-row NumPy version the tests
// hold this against).
//
// Build: g++ -O3 -shared -fPIC -ffp-contract=off (posecnn_torch/_build.py).

#include <cstddef>
#include <cstdint>
#include <cstdlib>

extern "C" {

// Undo the filters of `height` rows of `rowbytes` bytes from `src` (height
// * (1 + rowbytes) bytes) into `dst` (height * rowbytes bytes). Returns 0,
// or 1 + the index of the first row whose filter-type byte is not 0-4.
int png_unfilter(const uint8_t* src, uint8_t* dst, int height, int rowbytes, int bpp) {
  const uint8_t* prior = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = src + static_cast<size_t>(y) * (static_cast<size_t>(rowbytes) + 1);
    uint8_t* out = dst + static_cast<size_t>(y) * rowbytes;
    const int type = in[0];
    ++in;
    switch (type) {
      case 0:
        for (int i = 0; i < rowbytes; ++i) out[i] = in[i];
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i) out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i) out[i] = static_cast<uint8_t>(in[i] + (prior ? prior[i] : 0));
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
    prior = out;
  }
  return 0;
}

}  // extern "C"
