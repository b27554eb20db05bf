// Native host-side image pipeline: JPEG decode + crop (+ resize + flip) +
// ImageNet normalize, the port's own copy of lss_carla_tpu/native/fastimage.cpp.
//
// The loader decodes 6 cameras x batch JPEGs a step on host threads; PIL's
// decode -> resize -> crop -> numpy normalize makes several passes over
// each image. This fuses them: libjpeg scanline decode directly into the
// cropped region, written as uint8 or normalized float32 CHW, with no
// intermediate RGB buffer for the full image.
//
// Two kernels: a crop-only path (resize == 1 and no flip) and a fused
// decode+resize+crop(+flip) path for augmented and validation samples
// (PIL-convention bicubic, within 1/255 of PIL). Arbitrary-angle rotation
// stays with PIL in Python. The crop-only path equals PIL bit for bit
// where both link the same libjpeg IDCT, since crop+normalize is the same
// arithmetic.
//
// Host code, not a device kernel: lss_carla_torch/native/fastimage.py
// builds it with g++ -O3 -march=native -shared -fPIC against the libjpeg
// that Pillow's wheel bundles, into lss_carla_torch/_build/ on first use.

#include <csetjmp>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

// Decode a JPEG from memory, crop [crop_x, crop_x+out_w) x [crop_y,
// crop_y+out_h), normalize with (mean, std) per channel, write float32 CHW
// into out (3 * out_h * out_w floats).
// src_w/src_h: expected decoded dimensions (pass -1 to skip the check).
// The crop-only kernel is only PIL-equivalent when the on-disk image
// already has the configured (W, H) — callers pass the configured dims so
// a mismatched file errors (rc 3) and falls back to the resizing path
// instead of silently cropping unresized pixels.
// Returns 0 on success, nonzero on error (1 bad jpeg, 2 crop out of
// bounds/degenerate, 3 decoded dims != (src_w, src_h)).
int decode_crop_normalize(const unsigned char* data, long len,
                          int crop_x, int crop_y, int out_w, int out_h,
                          int src_w, int src_h,
                          const float* mean, const float* inv_std,
                          float* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  unsigned char* volatile row_v = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    delete[] row_v;
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  const int W = cinfo.output_width;
  const int H = cinfo.output_height;
  if ((src_w >= 0 && W != src_w) || (src_h >= 0 && H != src_h)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  if (out_w <= 0 || out_h <= 0 ||
      crop_x < 0 || crop_y < 0 || crop_x + out_w > W || crop_y + out_h > H ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }

  unsigned char* row = new unsigned char[static_cast<size_t>(W) * 3];
  row_v = row;
  const long plane = static_cast<long>(out_h) * out_w;
  // skip rows above the crop cheaply
  if (crop_y > 0) {
    jpeg_skip_scanlines(&cinfo, crop_y);
  }
  for (int y = 0; y < out_h; ++y) {
    JSAMPROW rowptr = row;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    const unsigned char* src = row + static_cast<size_t>(crop_x) * 3;
    float* r = out + static_cast<long>(y) * out_w;
    float* g = r + plane;
    float* b = g + plane;
    for (int x = 0; x < out_w; ++x) {
      r[x] = (src[3 * x + 0] * (1.0f / 255.0f) - mean[0]) * inv_std[0];
      g[x] = (src[3 * x + 1] * (1.0f / 255.0f) - mean[1]) * inv_std[1];
      b[x] = (src[3 * x + 2] * (1.0f / 255.0f) - mean[2]) * inv_std[2];
    }
  }
  delete[] row;
  jpeg_abort_decompress(&cinfo);  // we may not have read all scanlines
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + crop only, uint8 CHW out (3 * out_h * out_w bytes) — for the
// normalize-on-device path (4x smaller host->device transfer).
// src_w/src_h and return codes as in decode_crop_normalize.
int decode_crop_u8(const unsigned char* data, long len,
                   int crop_x, int crop_y, int out_w, int out_h,
                   int src_w, int src_h,
                   unsigned char* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  unsigned char* volatile row_v = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    delete[] row_v;
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width;
  const int H = cinfo.output_height;
  if ((src_w >= 0 && W != src_w) || (src_h >= 0 && H != src_h)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  if (out_w <= 0 || out_h <= 0 ||
      crop_x < 0 || crop_y < 0 || crop_x + out_w > W || crop_y + out_h > H ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  unsigned char* row = new unsigned char[static_cast<size_t>(W) * 3];
  row_v = row;
  const long plane = static_cast<long>(out_h) * out_w;
  if (crop_y > 0) {
    jpeg_skip_scanlines(&cinfo, crop_y);
  }
  for (int y = 0; y < out_h; ++y) {
    JSAMPROW rowptr = row;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    const unsigned char* src = row + static_cast<size_t>(crop_x) * 3;
    unsigned char* r = out + static_cast<long>(y) * out_w;
    unsigned char* g = r + plane;
    unsigned char* b = g + plane;
    for (int x = 0; x < out_w; ++x) {
      r[x] = src[3 * x + 0];
      g[x] = src[3 * x + 1];
      b[x] = src[3 * x + 2];
    }
  }
  delete[] row;
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// Fused decode + resize + crop (+ flip) — the augmented-train and val paths.
//
// Resampling follows PIL's convention (separable, antialiased: the kernel is
// stretched by the scale factor when downscaling) with PIL's default BICUBIC
// kernel (Catmull-Rom, a = -0.5), so outputs track the PIL fallback to
// within rounding. Like PIL's 8bpc pipeline, the intermediate
// horizontally-resampled band is quantized to uint8 before the vertical
// pass (see the hband comment below), keeping bicubic overshoot behavior
// identical — measured parity is within 1/255 per pixel.
//
// The crop box is given in RESIZED coordinates (PIL-style l, t, r, b), and
// only the needed source rows are decoded (scanlines above are skipped,
// below are never read). The horizontal pass touches only the columns the
// crop needs. flip reverses x at write-out (matching PIL FLIP_LEFT_RIGHT
// after crop).

namespace {

struct Taps {
  int* first;     // first source index per output pixel
  int* count;     // tap count per output pixel
  float* weight;  // [out][max_taps] normalized weights
  int max_taps;
};

inline float bicubic(float x) {  // Catmull-Rom, a = -0.5 (PIL BICUBIC)
  const float a = -0.5f;
  x = x < 0 ? -x : x;
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Precompute resampling taps mapping out pixels [out_lo, out_lo+out_n) of a
// virtual resized axis of length out_total, from a source axis of length
// in_total. PIL convention: center = (i + 0.5) * in/out; support scales by
// max(1, in/out). Crop coordinates outside [0, out_total) get zero taps —
// PIL's crop() zero-pads beyond the image, and a zero tap count makes the
// resample passes emit exactly 0 there (then normalize maps it like any
// black pixel, matching the PIL fallback bit for bit).
Taps make_taps(int in_total, int out_total, int out_lo, int out_n) {
  const float scale = static_cast<float>(in_total) / out_total;
  const float filterscale = scale < 1.0f ? 1.0f : scale;
  const float support = 2.0f * filterscale;  // bicubic support = 2
  const int max_taps = static_cast<int>(support) * 2 + 3;
  Taps t;
  t.first = new int[out_n];
  t.count = new int[out_n];
  t.weight = new float[static_cast<size_t>(out_n) * max_taps]();
  t.max_taps = max_taps;
  for (int i = 0; i < out_n; ++i) {
    const int v = out_lo + i;  // virtual resized coordinate
    if (v < 0 || v >= out_total) {
      t.first[i] = 0;
      t.count[i] = 0;  // zero-pad region (PIL crop outside the image)
      continue;
    }
    const float center = (out_lo + i + 0.5f) * scale;
    int lo = static_cast<int>(center - support + 0.5f);
    int hi = static_cast<int>(center + support + 0.5f);
    if (lo < 0) lo = 0;
    if (hi > in_total) hi = in_total;
    float* w = t.weight + static_cast<size_t>(i) * max_taps;
    float sum = 0.0f;
    for (int j = lo; j < hi; ++j) {
      const float v = bicubic((j - center + 0.5f) / filterscale);
      w[j - lo] = v;
      sum += v;
    }
    if (sum != 0.0f) {
      for (int j = 0; j < hi - lo; ++j) w[j] /= sum;
    }
    t.first[i] = lo;
    t.count[i] = hi - lo;
  }
  return t;
}

void free_taps(Taps& t) {
  delete[] t.first;
  delete[] t.count;
  delete[] t.weight;
}

inline unsigned char clamp_u8(float v) {
  return v <= 0.0f ? 0 : (v >= 255.0f ? 255 : static_cast<unsigned char>(v + 0.5f));
}

// Core: decode, resample to (rw, rh), crop (crop_x, crop_y, out_w, out_h) in
// resized coords, optional horizontal flip. Writes either uint8 CHW (u8_out)
// or normalized float32 CHW (f_out); exactly one of them is non-null.
int decode_resize_crop_core(const unsigned char* data, long len,
                            int rw, int rh,
                            int crop_x, int crop_y, int out_w, int out_h,
                            int flip,
                            const float* mean, const float* inv_std,
                            unsigned char* u8_out, float* f_out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  // longjmp-safe cleanup mirrors: locals modified after setjmp must be
  // volatile-qualified to be readable in the handler (C standard), and the
  // taps allocations must be released too (a truncated JPEG erroring inside
  // jpeg_read_scanlines would otherwise leak them on every bad file).
  unsigned char* volatile row_v = nullptr;
  unsigned char* volatile hband_v = nullptr;
  int* volatile taps_ints[4] = {nullptr, nullptr, nullptr, nullptr};
  float* volatile taps_floats[2] = {nullptr, nullptr};
  if (setjmp(jerr.setjmp_buffer)) {
    delete[] row_v;
    delete[] hband_v;
    for (int i = 0; i < 4; ++i) delete[] taps_ints[i];
    for (int i = 0; i < 2; ++i) delete[] taps_floats[i];
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width;
  const int H = cinfo.output_height;
  // the crop box MAY extend beyond [0, rw) x [0, rh): PIL's crop()
  // zero-pads those regions and the taps do the same here (see make_taps)
  if (rw <= 0 || rh <= 0 || out_w <= 0 || out_h <= 0 ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }

  Taps tx = make_taps(W, rw, crop_x, out_w);
  Taps ty = make_taps(H, rh, crop_y, out_h);
  taps_ints[0] = tx.first;
  taps_ints[1] = tx.count;
  taps_ints[2] = ty.first;
  taps_ints[3] = ty.count;
  taps_floats[0] = tx.weight;
  taps_floats[1] = ty.weight;

  // source row window needed across all output rows (zero-tap pad rows
  // contribute nothing; a fully-out-of-range crop needs no decode at all)
  int src_lo = H, src_hi = 0;
  for (int y = 0; y < out_h; ++y) {
    if (ty.count[y] == 0) continue;
    if (ty.first[y] < src_lo) src_lo = ty.first[y];
    if (ty.first[y] + ty.count[y] > src_hi) src_hi = ty.first[y] + ty.count[y];
  }
  if (src_hi < src_lo) {
    src_lo = 0;
    src_hi = 0;
  }
  const int band_rows = src_hi - src_lo;

  // horizontally-resampled band, quantized to uint8 between the passes —
  // exactly PIL's data flow (its 8bpc pipeline clamps+rounds the
  // horizontal pass before the vertical pass), which keeps bicubic
  // overshoot behavior identical
  unsigned char* row = new unsigned char[static_cast<size_t>(W) * 3];
  unsigned char* hband =
      new unsigned char[static_cast<size_t>(band_rows) * out_w * 3];
  row_v = row;
  hband_v = hband;

  if (src_lo > 0) jpeg_skip_scanlines(&cinfo, src_lo);
  for (int sy = 0; sy < band_rows; ++sy) {
    JSAMPROW rowptr = row;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    unsigned char* dst = hband + static_cast<size_t>(sy) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const float* w = tx.weight + static_cast<size_t>(x) * tx.max_taps;
      const unsigned char* src = row + static_cast<size_t>(tx.first[x]) * 3;
      float r = 0.0f, g = 0.0f, b = 0.0f;
      const int n = tx.count[x];
      for (int j = 0; j < n; ++j) {
        r += w[j] * src[3 * j + 0];
        g += w[j] * src[3 * j + 1];
        b += w[j] * src[3 * j + 2];
      }
      dst[3 * x + 0] = clamp_u8(r);
      dst[3 * x + 1] = clamp_u8(g);
      dst[3 * x + 2] = clamp_u8(b);
    }
  }

  const long plane = static_cast<long>(out_h) * out_w;
  for (int y = 0; y < out_h; ++y) {
    const float* w = ty.weight + static_cast<size_t>(y) * ty.max_taps;
    const int base = ty.first[y] - src_lo;
    const int n = ty.count[y];
    for (int x = 0; x < out_w; ++x) {
      float r = 0.0f, g = 0.0f, b = 0.0f;
      for (int j = 0; j < n; ++j) {
        const unsigned char* px =
            hband + (static_cast<size_t>(base + j) * out_w + x) * 3;
        r += w[j] * px[0];
        g += w[j] * px[1];
        b += w[j] * px[2];
      }
      const int xo = flip ? (out_w - 1 - x) : x;
      const long idx = static_cast<long>(y) * out_w + xo;
      if (u8_out != nullptr) {
        u8_out[idx] = clamp_u8(r);
        u8_out[idx + plane] = clamp_u8(g);
        u8_out[idx + 2 * plane] = clamp_u8(b);
      } else {
        // match the PIL path's arithmetic: quantize to uint8 first, then
        // normalize (the PIL fallback converts to uint8 RGB before
        // normalize_img)
        f_out[idx] = (clamp_u8(r) * (1.0f / 255.0f) - mean[0]) * inv_std[0];
        f_out[idx + plane] =
            (clamp_u8(g) * (1.0f / 255.0f) - mean[1]) * inv_std[1];
        f_out[idx + 2 * plane] =
            (clamp_u8(b) * (1.0f / 255.0f) - mean[2]) * inv_std[2];
      }
    }
  }

  delete[] row;
  delete[] hband;
  free_taps(tx);
  free_taps(ty);
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

// Decode + PIL-convention bicubic resize to (rw, rh) + crop (resized coords)
// + optional horizontal flip; uint8 CHW out.
int decode_resize_crop_u8(const unsigned char* data, long len,
                          int rw, int rh,
                          int crop_x, int crop_y, int out_w, int out_h,
                          int flip, unsigned char* out) {
  return decode_resize_crop_core(data, len, rw, rh, crop_x, crop_y,
                                 out_w, out_h, flip, nullptr, nullptr,
                                 out, nullptr);
}

// Same, normalized float32 CHW out.
int decode_resize_crop_normalize(const unsigned char* data, long len,
                                 int rw, int rh,
                                 int crop_x, int crop_y, int out_w, int out_h,
                                 int flip, const float* mean,
                                 const float* inv_std, float* out) {
  return decode_resize_crop_core(data, len, rw, rh, crop_x, crop_y,
                                 out_w, out_h, flip, mean, inv_std,
                                 nullptr, out);
}

// Probe the dimensions of a JPEG without full decode.
int jpeg_dims(const unsigned char* data, long len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
