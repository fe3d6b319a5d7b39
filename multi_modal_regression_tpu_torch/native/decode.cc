// Native host-side image ingest: PNG decode + PIL-exact bilinear resize.
//
// The reference feeds its GPU from torch DataLoader worker PROCESSES
// (learnGeodesicBDModel.py:78-79 num_workers=4) because Python decode is
// GIL-bound. The TPU rebuild keeps loaders in one process (threaded
// prefetch, data/loader.py) — measured at only ~150-290 img/s of PNG
// decode on a loaded host (benchmarks/bench_loader.py), 8-16x short of
// the ~2400 img/s the chip consumes. This library moves the decode+resize
// hot path to C++: libpng decode (lossless, so byte-identical to PIL) and
// a bit-exact reimplementation of Pillow's Resample.c bilinear path
// (two-pass triangle filter, 22-bit fixed-point coefficients, uint8
// intermediate), so the packed-cache build (data/packed.py) and the PNG
// loaders keep their tested pixel semantics while scaling across real
// threads.
//
// Exactness contract, enforced by tests/test_native.py:
//   - 8-bit RGB / gray / palette PNGs: byte-identical to
//     PIL.Image.open().convert("RGB").resize((S,S), BILINEAR).
//   - alpha or 16-bit PNGs: refused (return code 2) — the caller falls
//     back to PIL (alpha-drop and 16->8 conversions are PIL-specific).
//
// Build: g++ -O2 -fPIC -shared decode.cc -o libmmrnative.so -lpng -lz
// (data/native.py compiles this on first use and caches the .so).

#include <png.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Pillow Resample.c bilinear (triangle) resample, 8bpc fixed-point path.
// PRECISION_BITS and the rounding rules must match Pillow exactly.
// ---------------------------------------------------------------------
constexpr int kPrecisionBits = 32 - 8 - 2;

struct Coeffs {
  std::vector<int> bounds_min;
  std::vector<int> bounds_len;
  std::vector<int32_t> kk;  // out_size * ksize
  int ksize = 0;
};

double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

Coeffs precompute_coeffs(int in_size, int out_size) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // bilinear support = 1.0
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds_min.resize(out_size);
  c.bounds_len.resize(out_size);
  c.kk.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> k(c.ksize);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = triangle_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    c.bounds_min[xx] = xmin;
    c.bounds_len[xx] = xmax;
    int32_t* ki = &c.kk[static_cast<size_t>(xx) * c.ksize];
    for (int x = 0; x < xmax; ++x)
      ki[x] = static_cast<int32_t>(
          k[x] < 0 ? k[x] * (1 << kPrecisionBits) - 0.5
                   : k[x] * (1 << kPrecisionBits) + 0.5);
  }
  return c;
}

inline uint8_t clip8(int32_t v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

// Horizontal pass: (h, in_w, 3) u8 -> (h, out_w, 3) u8.
void resample_horizontal(const uint8_t* in, int h, int in_w, uint8_t* out,
                         int out_w, const Coeffs& c) {
  constexpr int32_t half = 1 << (kPrecisionBits - 1);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
    uint8_t* orow = out + static_cast<size_t>(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = c.bounds_min[xx];
      const int xmax = c.bounds_len[xx];
      const int32_t* k = &c.kk[static_cast<size_t>(xx) * c.ksize];
      int32_t s0 = half, s1 = half, s2 = half;
      const uint8_t* p = row + static_cast<size_t>(xmin) * 3;
      for (int x = 0; x < xmax; ++x) {
        s0 += p[0] * k[x];
        s1 += p[1] * k[x];
        s2 += p[2] * k[x];
        p += 3;
      }
      orow[xx * 3 + 0] = clip8(s0);
      orow[xx * 3 + 1] = clip8(s1);
      orow[xx * 3 + 2] = clip8(s2);
    }
  }
}

// Vertical pass: (in_h, w, 3) u8 -> (out_h, w, 3) u8.
void resample_vertical(const uint8_t* in, int in_h, int w, uint8_t* out,
                       int out_h, const Coeffs& c) {
  constexpr int32_t half = 1 << (kPrecisionBits - 1);
  const size_t stride = static_cast<size_t>(w) * 3;
  std::vector<int32_t> acc(stride);
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = c.bounds_min[yy];
    const int ymax = c.bounds_len[yy];
    const int32_t* k = &c.kk[static_cast<size_t>(yy) * c.ksize];
    std::fill(acc.begin(), acc.end(), half);
    for (int y = 0; y < ymax; ++y) {
      const uint8_t* row = in + static_cast<size_t>(ymin + y) * stride;
      const int32_t ky = k[y];
      for (size_t i = 0; i < stride; ++i) acc[i] += row[i] * ky;
    }
    uint8_t* orow = out + static_cast<size_t>(yy) * stride;
    for (size_t i = 0; i < stride; ++i) orow[i] = clip8(acc[i]);
  }
}

// PIL order: horizontal first, then vertical, uint8 between passes.
void resize_pil_bilinear(const uint8_t* in, int h, int w, uint8_t* out,
                         int size) {
  if (h == size && w == size) {
    std::memcpy(out, in, static_cast<size_t>(size) * size * 3);
    return;
  }
  const Coeffs ch = precompute_coeffs(w, size);
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * size * 3);
  resample_horizontal(in, h, w, tmp.data(), size, ch);
  const Coeffs cv = precompute_coeffs(h, size);
  resample_vertical(tmp.data(), h, size, out, size, cv);
}

// ---------------------------------------------------------------------
// libpng decode to RGB8. Returns 0 ok, 1 error, 2 unsupported-for-exact
// (alpha / 16-bit: PIL's conversions there are PIL-specific; the Python
// wrapper falls back to PIL for those files).
// ---------------------------------------------------------------------
int decode_png_rgb(const char* path, std::vector<uint8_t>* pixels, int* out_w,
                   int* out_h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return 1;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return 1;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return 1;
  }
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 1;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const png_byte color_type = png_get_color_type(png, info);
  const png_byte bit_depth = png_get_bit_depth(png, info);
  if (bit_depth == 16 || (color_type & PNG_COLOR_MASK_ALPHA) ||
      png_get_valid(png, info, PNG_INFO_tRNS)) {
    // alpha-drop / 16->8 are PIL-specific conversions; refuse for exactness
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  const int w = static_cast<int>(png_get_image_width(png, info));
  const int h = static_cast<int>(png_get_image_height(png, info));
  if (png_get_rowbytes(png, info) != static_cast<size_t>(w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  pixels->resize(static_cast<size_t>(w) * h * 3);
  rows.resize(h);
  for (int y = 0; y < h; ++y)
    rows[y] = pixels->data() + static_cast<size_t>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *out_w = w;
  *out_h = h;
  return 0;
}

// ---------------------------------------------------------------------
// libpng encode of RGB8. PNG is lossless: pixels round-trip identically
// no matter which encoder wrote them, so the prep tools can use this
// freely (only file bytes/compression differ from PIL's writer).
// ---------------------------------------------------------------------
int encode_png_rgb(const char* path, const uint8_t* data, int w, int h,
                   int compress_level) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 1;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return 1;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    std::fclose(fp);
    return 1;
  }
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    std::fclose(fp);
    return 1;
  }
  png_init_io(png, fp);
  png_set_compression_level(png, compress_level);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  rows.resize(h);
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<png_bytep>(data + static_cast<size_t>(y) * w * 3);
  png_write_image(png, rows.data());
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  std::fclose(fp);
  return 0;
}

}  // namespace

extern "C" {

// Decode `path` and resize to (size, size, 3) into `out`.
// Returns 0 ok, 1 error, 2 unsupported (caller falls back to PIL).
int mmr_decode_resize(const char* path, int size, uint8_t* out) {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  const int rc = decode_png_rgb(path, &pixels, &w, &h);
  if (rc != 0) return rc;
  resize_pil_bilinear(pixels.data(), h, w, out, size);
  return 0;
}

// Decode+resize n files in parallel with `threads` C++ threads. out must
// hold n*size*size*3 bytes; status[i] receives the per-file return code
// (0/1/2). Returns the number of files with a nonzero status.
int mmr_decode_resize_batch(const char** paths, int n, int size, uint8_t* out,
                            int threads, uint8_t* status) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t img_bytes = static_cast<size_t>(size) * size * 3;
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const int rc = mmr_decode_resize(paths[i], size, out + i * img_bytes);
      status[i] = static_cast<uint8_t>(rc);
      if (rc != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

// Write (h, w, 3) RGB8 as a PNG (zlib `compress_level`, PIL default 6).
// Returns 0 ok, 1 error.
int mmr_encode_png(const char* path, const uint8_t* data, int w, int h,
                   int compress_level) {
  return encode_png_rgb(path, data, w, h, compress_level);
}

// ABI/version handshake for the ctypes wrapper.
int mmr_native_abi_version() { return 2; }

}  // extern "C"
