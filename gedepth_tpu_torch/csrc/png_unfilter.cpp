// PNG scanline unfiltering on the host (PNG specification, section 9).
//
// `in` holds `height` rows of 1 + `stride` bytes as zlib inflates them: a
// filter-type byte, then the filtered bytes of the row. `out` receives the
// reconstructed rows, `stride` bytes each. `bpp` is the number of bytes of
// one complete pixel, rounded up to 1. The Sub, Average and Paeth filters
// depend on the byte `bpp` to the left, which makes them sequential along a
// row: this loop is what the Python reader cannot do quickly.
//
// Returns 0, or 1 + the index of the first row with an unknown filter type.
#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* in, uint8_t* out, int64_t height,
                            int64_t stride, int bpp) {
  const uint8_t* prior = nullptr;   // the previous reconstructed row
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t type = in[y * (stride + 1)];
    const uint8_t* raw = in + y * (stride + 1) + 1;
    uint8_t* row = out + y * stride;
    switch (type) {
      case 0:   // None
        for (int64_t i = 0; i < stride; ++i) row[i] = raw[i];
        break;
      case 1:   // Sub
        for (int64_t i = 0; i < stride; ++i)
          row[i] = raw[i] + (i >= bpp ? row[i - bpp] : 0);
        break;
      case 2:   // Up
        for (int64_t i = 0; i < stride; ++i)
          row[i] = raw[i] + (prior ? prior[i] : 0);
        break;
      case 3:   // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          row[i] = raw[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:   // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = raw[i] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return static_cast<int>(y) + 1;
    }
    prior = row;
  }
  return 0;
}
