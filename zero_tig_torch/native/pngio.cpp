// PNG row unfiltering for the port's host-side PNG codec (native/__init__.py).
//
// Python's zlib inflates the IDAT stream; this undoes the five row filters
// of the PNG specification (section 9: None, Sub, Up, Average, Paeth) for
// 8-bit images, row after row. Average and Paeth depend on the byte just
// decoded to their left, so a row is serial; this loop is what numpy
// cannot do at 1080p. Built with the host C++ compiler, bound with ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

}  // namespace

// src: height rows of (1 filter byte + rowbytes bytes); dst: height x rowbytes.
// bpp: bytes per pixel (the "left" distance). Returns 0, or 1 + the index of
// the first row whose filter byte is not 0-4.
extern "C" int64_t zt_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height, int64_t rowbytes, int64_t bpp) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = src + y * (rowbytes + 1);
        const uint8_t ft = *in++;
        uint8_t* out = dst + y * rowbytes;
        switch (ft) {
            case 0:
                std::memcpy(out, in, rowbytes);
                break;
            case 1:
                for (int64_t i = 0; i < rowbytes; ++i)
                    out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < rowbytes; ++i)
                    out[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
                break;
            case 3:
                for (int64_t i = 0; i < rowbytes; ++i) {
                    const int a = i >= bpp ? out[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < rowbytes; ++i) {
                    const int a = i >= bpp ? out[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    out[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
                }
                break;
            default:
                return y + 1;
        }
        prev = out;
    }
    return 0;
}
