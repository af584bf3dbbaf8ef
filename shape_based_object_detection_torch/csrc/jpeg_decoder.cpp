// First-party fused JPEG decode + resize for the host input pipeline.
//
// The reference family's host image path is PIL/libjpeg (SURVEY.md §2 C4,
// native-deps table: "PIL / libjpeg-turbo (C) — image decode + CPU
// transforms"). This is the TPU-native rebuild's equivalent: one C call that
// decodes a JPEG *at the smallest DCT-domain prescale that still covers the
// network input size* (libjpeg scale_num/8 — up to 8x fewer IDCT outputs
// than a full decode) and finishes with a separable triangle-filter
// resample (PIL's BILINEAR semantics) straight into the caller's
// (S, S, 3) uint8 canvas. Square-resize and letterbox (top-left content,
// zero pad bottom/right — utils/image.py::letterbox_image_host) modes.
//
// Plain C ABI (ctypes; no pybind11). Thread-safe: no globals, one
// jpeg_decompress_struct per call — the Loader's thread pool calls this
// concurrently with the GIL released.

#include <cstddef>
#include <cstdio>  // jpeglib.h needs size_t/FILE declared first

#include <jpeglib.h>

#include <setjmp.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <cmath>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void silent_output(j_common_ptr, int) {}
void silent_message(j_common_ptr) {}

// PIL-equivalent triangle ("bilinear") resample weights for one axis:
// out pixel i draws from in pixels around center (i+0.5)*scale with a
// triangle filter of half-width max(1, scale), weights normalized to 1.
void make_weights(int in_size, int out_size, std::vector<int>& bounds,
                  std::vector<float>& weights, int& ksize) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = filterscale;  // triangle filter support = 1.0 * scale
  ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  weights.assign(static_cast<size_t>(out_size) * ksize, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(
        std::min(static_cast<double>(in_size), std::ceil(center + support)));
    int n = xmax - xmin;
    double total = 0.0;
    for (int j = 0; j < n; ++j) {
      double x = (xmin + j + 0.5 - center) / filterscale;
      double w = std::fabs(x) < 1.0 ? 1.0 - std::fabs(x) : 0.0;
      weights[static_cast<size_t>(i) * ksize + j] = static_cast<float>(w);
      total += w;
    }
    if (total > 0.0) {
      for (int j = 0; j < n; ++j) {
        weights[static_cast<size_t>(i) * ksize + j] /=
            static_cast<float>(total);
      }
    }
    bounds[i * 2] = xmin;
    bounds[i * 2 + 1] = n;
  }
}

inline uint8_t clamp_u8(float v) {
  return static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v + 0.5f)));
}

}  // namespace

extern "C" {

// Decode `data[:len]` (JPEG) and resize into `out` (out_size*out_size*3,
// RGB, row-major). letterbox != 0: aspect-preserving resize into the
// top-left, zero padding bottom/right; else square resize. Writes the
// pre-resize image dimensions to *orig_w / *orig_h.
// Returns 0 on success; 1 on any libjpeg decode error (caller falls back
// to the PIL path); 2 on bad arguments.
namespace {
int decode_impl(const uint8_t* data, int len, int out_size, int letterbox,
                uint8_t* out, int* orig_w, int* orig_h);
}

int sbd_decode_jpeg_resize(const uint8_t* data, int len, int out_size,
                           int letterbox, uint8_t* out, int* orig_w,
                           int* orig_h) {
  if (data == nullptr || out == nullptr || len < 4 || out_size <= 0) {
    return 2;
  }
  // C++ exceptions (std::bad_alloc from the buffer vectors on a hostile
  // header) must not cross the C ABI into ctypes — that would be
  // std::terminate, not the rc=1 PIL fallback.
  try {
    return decode_impl(data, len, out_size, letterbox, out, orig_w, orig_h);
  } catch (...) {
    return 1;
  }
}

namespace {
int decode_impl(const uint8_t* data, int len, int out_size, int letterbox,
                uint8_t* out, int* orig_w, int* orig_h) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = silent_output;
  err.pub.output_message = silent_message;

  // Buffers live outside the setjmp region so a longjmp unwinds through a
  // normal return and their destructors still run.
  std::vector<uint8_t> decoded;
  std::vector<float> hbuf;
  std::vector<int> xb, yb;
  std::vector<float> xw, yw;

  // RAII: destroy the decompressor on EVERY exit (normal return, setjmp
  // error path, or a C++ exception unwinding to the caller's catch) so
  // libjpeg's heap pools never leak in a long-lived serving process.
  struct CinfoGuard {
    jpeg_decompress_struct* c;
    bool armed = false;
    ~CinfoGuard() {
      if (armed) jpeg_destroy_decompress(c);
    }
  } guard{&cinfo};

  if (setjmp(err.jb)) {
    return 1;
  }

  jpeg_create_decompress(&cinfo);
  guard.armed = true;
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);

  const int w = static_cast<int>(cinfo.image_width);
  const int h = static_cast<int>(cinfo.image_height);
  if (w <= 0 || h <= 0) {
    return 1;
  }
  if (orig_w != nullptr) *orig_w = w;
  if (orig_h != nullptr) *orig_h = h;

  // Content dims inside the canvas. nearbyint = round-half-even, matching
  // Python round() in letterbox_image_host so content extents agree.
  int cw = out_size, ch = out_size;
  if (letterbox) {
    double scale = static_cast<double>(out_size) / std::max(w, h);
    cw = std::max(1, static_cast<int>(std::nearbyint(w * scale)));
    ch = std::max(1, static_cast<int>(std::nearbyint(h * scale)));
  }

  // Smallest DCT prescale n/8 whose output still covers the content dims
  // (never decode-then-upscale when the source is large enough).
  int n = 8;
  for (int cand = 1; cand <= 8; ++cand) {
    long sw = (static_cast<long>(w) * cand + 7) / 8;
    long sh = (static_cast<long>(h) * cand + 7) / 8;
    if (sw >= cw && sh >= ch) {
      n = cand;
      break;
    }
  }
  cinfo.scale_num = static_cast<unsigned>(n);
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;  // gray->RGB handled; CMYK errors -> PIL

  jpeg_start_decompress(&cinfo);
  const int dw = static_cast<int>(cinfo.output_width);
  const int dh = static_cast<int>(cinfo.output_height);
  const size_t stride = static_cast<size_t>(dw) * 3;
  // Bound transient memory against hostile headers (e.g. a few-KB file
  // declaring 30x65500: hbuf alone would be ~400 MB). Real photos stay far
  // under this; oversized ones fall back to PIL.
  const size_t need = static_cast<size_t>(dh) * stride +
                      static_cast<size_t>(dh) * cw * 3 * sizeof(float);
  if (need > (256u << 20)) {
    return 1;
  }
  decoded.resize(static_cast<size_t>(dh) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = decoded.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  // (CinfoGuard destroys the decompressor on return)

  // Separable resample (dh, dw) -> (ch, cw): horizontal into float, then
  // vertical straight into the output canvas.
  int kx = 0, ky = 0;
  make_weights(dw, cw, xb, xw, kx);
  make_weights(dh, ch, yb, yw, ky);
  hbuf.assign(static_cast<size_t>(dh) * cw * 3, 0.0f);
  for (int y = 0; y < dh; ++y) {
    const uint8_t* src = decoded.data() + static_cast<size_t>(y) * stride;
    float* dst = hbuf.data() + static_cast<size_t>(y) * cw * 3;
    for (int x = 0; x < cw; ++x) {
      const int x0 = xb[x * 2], xn = xb[x * 2 + 1];
      const float* wrow = xw.data() + static_cast<size_t>(x) * kx;
      float r = 0.0f, g = 0.0f, b = 0.0f;
      for (int j = 0; j < xn; ++j) {
        const uint8_t* p = src + static_cast<size_t>(x0 + j) * 3;
        const float wj = wrow[j];
        r += wj * p[0];
        g += wj * p[1];
        b += wj * p[2];
      }
      dst[x * 3 + 0] = r;
      dst[x * 3 + 1] = g;
      dst[x * 3 + 2] = b;
    }
  }
  if (letterbox) {
    memset(out, 0, static_cast<size_t>(out_size) * out_size * 3);
  }
  // Vertical pass as row-wise AXPY: accumulate whole source rows into one
  // contiguous accumulator (sequential streams the compiler vectorizes),
  // instead of per-pixel tap loads striding cw*3 floats apart (a cache
  // miss per tap, which made large-source resizes slower than PIL).
  const int rowlen = cw * 3;
  std::vector<float> acc(static_cast<size_t>(rowlen));
  for (int y = 0; y < ch; ++y) {
    const int y0 = yb[y * 2], yn = yb[y * 2 + 1];
    const float* wcol = yw.data() + static_cast<size_t>(y) * ky;
    float* a = acc.data();
    memset(a, 0, static_cast<size_t>(rowlen) * sizeof(float));
    for (int j = 0; j < yn; ++j) {
      const float wj = wcol[j];
      const float* srcrow =
          hbuf.data() + static_cast<size_t>(y0 + j) * rowlen;
      for (int k = 0; k < rowlen; ++k) {
        a[k] += wj * srcrow[k];
      }
    }
    uint8_t* dst = out + static_cast<size_t>(y) * out_size * 3;
    for (int k = 0; k < rowlen; ++k) {
      dst[k] = clamp_u8(a[k]);
    }
  }
  return 0;
}
}  // namespace

}  // extern "C"
