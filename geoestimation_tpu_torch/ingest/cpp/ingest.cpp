// Native ingest: threaded JPEG decode + antialiased bilinear resize +
// center crop into one preallocated uint8 buffer.
//
// The port's own copy of geoestimation_tpu/ingest/cpp/ingest.cpp: the code
// is the same, and built with the same flags (ingest/native.py) it gives the
// same pixels bit for bit (tests/test_torch_port_ingest.py). One C++ call
// per batch — no Python in the per-image loop, no worker processes — feeds
// the device pipeline (ingest/pipeline.py) with static-shape
// (N, base, base, 3) tensors. Host code, not a kernel.
//
// Resize semantics match PIL's BILINEAR resample (triangle filter whose
// support scales with the downscale factor, i.e. antialiased), so the
// Python fallback and the native path agree within rounding.
//
// API (ctypes, see ingest/native.py):
//   int geoingest_decode_batch(const char** blobs, const size_t* lens,
//                              int n, int resize_to, int base_size,
//                              uint8_t* out, uint8_t* ok, int n_threads);
// Returns the number of successfully decoded images; `ok[i]` = 1 on
// success. Undecodable blobs leave zeros (the reference tolerates rotten
// Flickr images, README.md:192-194).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG byte buffer to packed RGB. Returns false on any error.
//
// When `min_side > 0`, decodes at the smallest libjpeg DCT scale (M/8,
// M=1..8; libjpeg-turbo supports all of them) whose output shorter side
// still covers `min_side` — the IDCT then runs on up to 64x fewer
// coefficients, which is the dominant host-ingest cost for large photos.
// `orig_width/orig_height` always report the pre-scaling header dims so
// the caller can keep resize geometry identical to a full decode.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* width, int* height, int min_side, int* orig_width,
                 int* orig_height) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  *orig_width = static_cast<int>(cinfo.image_width);
  *orig_height = static_cast<int>(cinfo.image_height);
  if (min_side > 0) {
    for (unsigned int num = 1; num <= 8; ++num) {
      cinfo.scale_num = num;
      cinfo.scale_denom = 8;
      jpeg_calc_output_dimensions(&cinfo);
      if (static_cast<int>(std::min(cinfo.output_width,
                                    cinfo.output_height)) >= min_side) {
        break;  // smallest M meeting the coverage constraint wins
      }
    }
    // (if even 8/8 is below min_side the image is small; full decode)
  }
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  if (*width <= 0 || *height <= 0 || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  rgb->resize(static_cast<size_t>(*width) * *height * 3);
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = rgb->data() + static_cast<size_t>(cinfo.output_scanline) *
                            *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Precomputed resampling taps for one output axis (PIL-style triangle
// filter: support 1.0, scaled by the downscale factor for antialiasing).
struct Taps {
  std::vector<int> start;        // first source index per output pixel
  std::vector<int> count;        // taps per output pixel
  std::vector<float> weights;    // flattened [out][tap]
  int max_count = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;
  t.start.resize(out_size);
  t.count.resize(out_size);
  std::vector<std::vector<float>> rows(out_size);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    int xmax = static_cast<int>(center + support + 0.5);
    xmin = std::max(xmin, 0);
    xmax = std::min(xmax, in_size);
    std::vector<float> w;
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double v = 1.0 - std::abs((x + 0.5 - center) / filterscale);
      v = std::max(v, 0.0);
      w.push_back(static_cast<float>(v));
      total += v;
    }
    if (total > 0) {
      for (auto& v : w) v = static_cast<float>(v / total);
    }
    t.start[xx] = xmin;
    t.count[xx] = static_cast<int>(w.size());
    t.max_count = std::max(t.max_count, t.count[xx]);
    rows[xx] = std::move(w);
  }
  for (int xx = 0; xx < out_size; ++xx) {
    t.weights.insert(t.weights.end(), rows[xx].begin(), rows[xx].end());
    // pad for ragged rows (indexed via prefix offsets below)
  }
  // build prefix offsets into t.start/count-aligned weight rows
  return t;
}

// Separable triangle-filter resize RGB (in HxWx3) -> (oh x ow x 3).
void resize_bilinear(const std::vector<uint8_t>& in, int w, int h,
                     std::vector<float>* tmp, std::vector<uint8_t>* out,
                     int ow, int oh) {
  Taps tx = make_taps(w, ow);
  Taps ty = make_taps(h, oh);
  // horizontal pass: (h x w x 3) -> (h x ow x 3) in float
  tmp->assign(static_cast<size_t>(h) * ow * 3, 0.f);
  {
    size_t woff = 0;
    std::vector<size_t> offsets(ow);
    for (int xx = 0; xx < ow; ++xx) {
      offsets[xx] = woff;
      woff += tx.count[xx];
    }
    for (int y = 0; y < h; ++y) {
      const uint8_t* src = in.data() + static_cast<size_t>(y) * w * 3;
      float* dst = tmp->data() + static_cast<size_t>(y) * ow * 3;
      for (int xx = 0; xx < ow; ++xx) {
        const float* wrow = tx.weights.data() + offsets[xx];
        float r = 0, g = 0, b = 0;
        const int s = tx.start[xx];
        for (int k = 0; k < tx.count[xx]; ++k) {
          const uint8_t* p = src + static_cast<size_t>(s + k) * 3;
          r += wrow[k] * p[0];
          g += wrow[k] * p[1];
          b += wrow[k] * p[2];
        }
        dst[xx * 3 + 0] = r;
        dst[xx * 3 + 1] = g;
        dst[xx * 3 + 2] = b;
      }
    }
  }
  // vertical pass: (h x ow x 3) -> (oh x ow x 3) in uint8
  out->resize(static_cast<size_t>(oh) * ow * 3);
  {
    size_t woff = 0;
    std::vector<size_t> offsets(oh);
    for (int yy = 0; yy < oh; ++yy) {
      offsets[yy] = woff;
      woff += ty.count[yy];
    }
    for (int yy = 0; yy < oh; ++yy) {
      const float* wrow = ty.weights.data() + offsets[yy];
      uint8_t* dst = out->data() + static_cast<size_t>(yy) * ow * 3;
      const int s = ty.start[yy];
      for (int x = 0; x < ow * 3; ++x) {
        float acc = 0;
        for (int k = 0; k < ty.count[yy]; ++k) {
          acc += wrow[k] *
                 (*tmp)[static_cast<size_t>(s + k) * ow * 3 + x];
        }
        int v = static_cast<int>(acc + 0.5f);
        dst[x] = static_cast<uint8_t>(std::clamp(v, 0, 255));
      }
    }
  }
}

// Flag bits for geoingest_decode_batch_ex.
constexpr int kFlagScaledDecode = 1;

// One image: decode -> shorter-side resize -> center crop -> write.
bool process_one(const uint8_t* blob, size_t len, int resize_to,
                 int base_size, uint8_t* out, int flags) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0, ow = 0, oh = 0;
  const int min_side = (flags & kFlagScaledDecode) ? resize_to : 0;
  if (len == 0 ||
      !decode_jpeg(blob, len, &rgb, &w, &h, min_side, &ow, &oh)) {
    return false;
  }

  // Target geometry is always derived from the ORIGINAL header dims so a
  // scaled decode changes pixel values only (slightly), never shapes.
  const double scale = static_cast<double>(resize_to) / std::min(ow, oh);
  int nw = std::max(static_cast<int>(std::lround(ow * scale)), resize_to);
  int nh = std::max(static_cast<int>(std::lround(oh * scale)), resize_to);

  std::vector<float> tmp;
  std::vector<uint8_t> resized;
  resize_bilinear(rgb, w, h, &tmp, &resized, nw, nh);

  // Center crop; when base_size exceeds the resized dims (caller passed
  // base_size > resize_to) the image is centered and the rest stays
  // zero-padded, matching the PIL fallback's out-of-bounds crop behavior.
  const int copy_w = std::min(base_size, nw);
  const int copy_h = std::min(base_size, nh);
  const int src_left = std::max((nw - base_size) / 2, 0);
  const int src_top = std::max((nh - base_size) / 2, 0);
  const int dst_left = std::max((base_size - nw) / 2, 0);
  const int dst_top = std::max((base_size - nh) / 2, 0);
  for (int y = 0; y < copy_h; ++y) {
    std::memcpy(out + (static_cast<size_t>(dst_top + y) * base_size +
                       dst_left) * 3,
                resized.data() +
                    (static_cast<size_t>(src_top + y) * nw + src_left) * 3,
                static_cast<size_t>(copy_w) * 3);
  }
  return true;
}

}  // namespace

// Extended entry: `flags` bit 0 enables scaled DCT decode (decode at the
// smallest M/8 scale covering `resize_to` — typically 4-60x fewer IDCT
// pixels on real photos; slightly different pixel values than a full
// decode, so it is opt-in and OFF on the default parity path).
extern "C" int geoingest_decode_batch_ex(const char** blobs,
                                         const size_t* lens, int n,
                                         int resize_to, int base_size,
                                         uint8_t* out, uint8_t* ok,
                                         int n_threads, int flags) {
  if (n_threads <= 0) {
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  }
  n_threads = std::min(n_threads, n > 0 ? n : 1);
  const size_t img_bytes =
      static_cast<size_t>(base_size) * base_size * 3;
  std::atomic<int> next(0), good(0);

  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + static_cast<size_t>(i) * img_bytes;
      std::memset(dst, 0, img_bytes);
      const bool success = process_one(
          reinterpret_cast<const uint8_t*>(blobs[i]), lens[i], resize_to,
          base_size, dst, flags);
      ok[i] = success ? 1 : 0;
      if (success) good.fetch_add(1);
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return good.load();
}

extern "C" int geoingest_decode_batch(const char** blobs,
                                      const size_t* lens, int n,
                                      int resize_to, int base_size,
                                      uint8_t* out, uint8_t* ok,
                                      int n_threads) {
  return geoingest_decode_batch_ex(blobs, lens, n, resize_to, base_size,
                                   out, ok, n_threads, 0);
}
