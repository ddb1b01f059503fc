// The port's native frame pipeline: a copy of the JAX package's
// zero_tig_tpu/native/frameio.cc (the port imports nothing of that package).
//
// libpng/libjpeg decode, separable bicubic (Catmull-Rom a=-0.75, OpenCV
// INTER_CUBIC-compatible) or bilinear resize, [0,1] float32 normalization or
// uint8 output, and an ordered multi-threaded prefetch pipeline, exposed to
// Python through a plain C ABI (ctypes, zero_tig_torch/native/frameio.py).
//
// Build: c++ -O3 -std=c++17 -shared -fPIC frameio.cc -o libzt_frameio.so -lpng -ljpeg -lpthread

#include <cstdio>  // must precede jpeglib.h (it references FILE)

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------- decoding

bool decode_png(const char* path, std::vector<unsigned char>& rgb, int& w,
                int& h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  unsigned char header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  rgb.resize(static_cast<size_t>(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = rgb.data() + static_cast<size_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jmp, 1);
}

bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb, int& w,
                 int& h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
}

bool decode(const char* path, std::vector<unsigned char>& rgb, int& w, int& h) {
  const char* dot = strrchr(path, '.');
  if (dot && (!strcasecmp(dot, ".jpg") || !strcasecmp(dot, ".jpeg")))
    return decode_jpeg(path, rgb, w, h);
  if (decode_png(path, rgb, w, h)) return true;
  return decode_jpeg(path, rgb, w, h);
}

// ----------------------------------------------------------- resizing

inline float cubic_w(float t) {  // Catmull-Rom a = -0.75 (OpenCV)
  const float a = -0.75f;
  t = t < 0 ? -t : t;
  if (t <= 1.0f) return ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
  if (t < 2.0f) return (((t - 5.0f) * t + 8.0f) * t - 4.0f) * a;
  return 0.0f;
}

// separable resize uint8 RGB -> float32 [0,1] RGB; mode 0 = bilinear,
// 1 = bicubic. Half-pixel source mapping (align_corners=False).
void resize_normalize(const unsigned char* src, int sw, int sh, float* dst,
                      int dw, int dh, int mode) {
  if (sw == dw && sh == dh) {
    const size_t n = static_cast<size_t>(dw) * dh * 3;
    for (size_t i = 0; i < n; ++i) dst[i] = src[i] * (1.0f / 255.0f);
    return;
  }
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  const int taps = mode == 1 ? 4 : 2;

  // horizontal pass into a temp (sh x dw x 3) float buffer
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  std::vector<int> xi(static_cast<size_t>(dw) * taps);
  std::vector<float> xw(static_cast<size_t>(dw) * taps);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = static_cast<int>(floorf(fx));
    float t = fx - x0;
    if (mode == 1) {
      float wsum = 0.f;
      for (int k = 0; k < 4; ++k) {
        int xs = x0 - 1 + k;
        float wgt = cubic_w(t - (k - 1));
        xs = xs < 0 ? 0 : (xs >= sw ? sw - 1 : xs);
        xi[x * 4 + k] = xs;
        xw[x * 4 + k] = wgt;
        wsum += wgt;
      }
      for (int k = 0; k < 4; ++k) xw[x * 4 + k] /= wsum;
    } else {
      int xa = x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0);
      int xb = x0 + 1 < 0 ? 0 : (x0 + 1 >= sw ? sw - 1 : x0 + 1);
      xi[x * 2] = xa;
      xi[x * 2 + 1] = xb;
      float tt = t < 0 ? 0 : (t > 1 ? 1 : t);
      xw[x * 2] = 1.0f - tt;
      xw[x * 2 + 1] = tt;
    }
  }
  for (int y = 0; y < sh; ++y) {
    const unsigned char* srow = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float r = 0, g = 0, b = 0;
      for (int k = 0; k < taps; ++k) {
        const unsigned char* p = srow + xi[x * taps + k] * 3;
        const float wgt = xw[x * taps + k];
        r += wgt * p[0];
        g += wgt * p[1];
        b += wgt * p[2];
      }
      trow[x * 3] = r;
      trow[x * 3 + 1] = g;
      trow[x * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(floorf(fy));
    float t = fy - y0;
    int yi[4];
    float yw[4];
    if (mode == 1) {
      float wsum = 0.f;
      for (int k = 0; k < 4; ++k) {
        int ys = y0 - 1 + k;
        yw[k] = cubic_w(t - (k - 1));
        yi[k] = ys < 0 ? 0 : (ys >= sh ? sh - 1 : ys);
        wsum += yw[k];
      }
      for (int k = 0; k < 4; ++k) yw[k] /= wsum;
    } else {
      int ya = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
      int yb = y0 + 1 < 0 ? 0 : (y0 + 1 >= sh ? sh - 1 : y0 + 1);
      yi[0] = ya;
      yi[1] = yb;
      float tt = t < 0 ? 0 : (t > 1 ? 1 : t);
      yw[0] = 1.0f - tt;
      yw[1] = tt;
    }
    float* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      float acc = 0;
      for (int k = 0; k < taps; ++k)
        acc += yw[k] * tmp[static_cast<size_t>(yi[k]) * dw * 3 + x];
      drow[x] = acc * (1.0f / 255.0f);
    }
  }
}

inline unsigned char quant255(float v) {
  float s = v * 255.0f + 0.5f;
  return s <= 0.f ? 0 : (s >= 255.f ? 255 : static_cast<unsigned char>(s));
}

// ----------------------------------------------------------- pipeline

struct Pipeline {
  std::vector<std::string> paths;
  int dw, dh, mode;
  int u8 = 0;                              // 1: uint8 RGB output slots
  size_t capacity;
  std::vector<std::vector<float>> slots;   // ring of decoded frames (f32)
  std::vector<std::vector<unsigned char>> slots8;  // ring (u8 mode)
  std::vector<int> status;                 // 0 empty, 1 ready, -1 error
  std::atomic<size_t> next_job{0};
  size_t next_out = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      size_t job = next_job.fetch_add(1);
      if (job >= paths.size()) return;
      // wait until the ring slot for this job is free
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || job < next_out + capacity;
        });
        if (stop.load()) return;
      }
      std::vector<unsigned char> rgb;
      int w = 0, h = 0;
      bool ok = decode(paths[job].c_str(), rgb, w, h);
      size_t slot = job % capacity;
      if (ok && u8) {
        const size_t n = static_cast<size_t>(dw) * dh * 3;
        slots8[slot].resize(n);
        if (w == dw && h == dh) {
          memcpy(slots8[slot].data(), rgb.data(), n);
        } else {
          std::vector<float> tmp(n);
          resize_normalize(rgb.data(), w, h, tmp.data(), dw, dh, mode);
          for (size_t i = 0; i < n; ++i) slots8[slot][i] = quant255(tmp[i]);
        }
      } else if (ok) {
        slots[slot].resize(static_cast<size_t>(dw) * dh * 3);
        resize_normalize(rgb.data(), w, h, slots[slot].data(), dw, dh, mode);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        status[slot] = ok ? 1 : -1;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// One-shot: decode `path`, resize to (out_w, out_h), write float32 RGB
// [0,1] into `out` (out_h*out_w*3 floats). mode: 0 bilinear, 1 bicubic.
// Returns 0 on success.
int frameio_load(const char* path, int out_w, int out_h, int mode,
                 float* out) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  if (!decode(path, rgb, w, h)) return 1;
  resize_normalize(rgb.data(), w, h, out, out_w, out_h, mode);
  return 0;
}

static void* pipeline_create_impl(const char** paths, int n_paths,
                                  int out_w, int out_h, int mode,
                                  int n_threads, int capacity, int u8) {
  auto* p = new Pipeline();
  p->paths.assign(paths, paths + n_paths);
  p->dw = out_w;
  p->dh = out_h;
  p->mode = mode;
  p->u8 = u8;
  p->capacity = capacity < 2 ? 2 : capacity;
  if (u8)
    p->slots8.resize(p->capacity);
  else
    p->slots.resize(p->capacity);
  p->status.assign(p->capacity, 0);
  int nt = n_threads < 1 ? 1 : n_threads;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Pipeline::worker, p);
  return p;
}

void* frameio_pipeline_create(const char** paths, int n_paths, int out_w,
                              int out_h, int mode, int n_threads,
                              int capacity) {
  return pipeline_create_impl(paths, n_paths, out_w, out_h, mode, n_threads,
                              capacity, 0);
}

// uint8 output variant: slots hold RGB bytes, which the device prefetch
// copies to the card as they are; a frame already at the target size skips
// the float round-trip entirely.
void* frameio_pipeline_create_u8(const char** paths, int n_paths, int out_w,
                                 int out_h, int mode, int n_threads,
                                 int capacity) {
  return pipeline_create_impl(paths, n_paths, out_w, out_h, mode, n_threads,
                              capacity, 1);
}

// Blocking ordered pop: fills `out`; returns 0 ok, 1 decode error, 2 done.
int frameio_pipeline_next(void* handle, float* out) {
  auto* p = static_cast<Pipeline*>(handle);
  if (p->next_out >= p->paths.size()) return 2;
  size_t slot = p->next_out % p->capacity;
  int st;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv.wait(lk, [&] { return p->status[slot] != 0; });
    st = p->status[slot];
  }
  if (st == 1)
    memcpy(out, p->slots[slot].data(),
           static_cast<size_t>(p->dw) * p->dh * 3 * sizeof(float));
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->status[slot] = 0;
    p->next_out += 1;
  }
  p->cv.notify_all();
  return st == 1 ? 0 : 1;
}

// Blocking ordered pop (u8 pipelines): fills out (out_h*out_w*3 bytes).
int frameio_pipeline_next_u8(void* handle, unsigned char* out) {
  auto* p = static_cast<Pipeline*>(handle);
  if (p->next_out >= p->paths.size()) return 2;
  size_t slot = p->next_out % p->capacity;
  int st;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv.wait(lk, [&] { return p->status[slot] != 0; });
    st = p->status[slot];
  }
  if (st == 1)
    memcpy(out, p->slots8[slot].data(),
           static_cast<size_t>(p->dw) * p->dh * 3);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->status[slot] = 0;
    p->next_out += 1;
  }
  p->cv.notify_all();
  return st == 1 ? 0 : 1;
}

// One-shot uint8: decode + resize + quantize (memcpy fast path at native
// size). Returns 0 on success.
int frameio_load_u8(const char* path, int out_w, int out_h, int mode,
                    unsigned char* out) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  if (!decode(path, rgb, w, h)) return 1;
  const size_t n = static_cast<size_t>(out_w) * out_h * 3;
  if (w == out_w && h == out_h) {
    memcpy(out, rgb.data(), n);
    return 0;
  }
  std::vector<float> tmp(n);
  resize_normalize(rgb.data(), w, h, tmp.data(), out_w, out_h, mode);
  for (size_t i = 0; i < n; ++i) out[i] = quant255(tmp[i]);
  return 0;
}

void frameio_pipeline_destroy(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  p->stop.store(true);
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
