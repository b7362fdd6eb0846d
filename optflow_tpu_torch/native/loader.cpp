// Native threaded image loader for the pair engine.
//
// The reference decodes on the host inside its C++ pair loop
// (cv::imread(IMREAD_GRAYSCALE) + cv::resize, src/optflow.cpp:106-125),
// serialized with GPU compute. This library provides the equivalent
// decode/resize natively (libpng/libjpeg/libtiff + bilinear resample with
// OpenCV's half-pixel convention) behind a thread pool, so the Python
// engine can prefetch upcoming pairs while the GPU solves the current
// batch — the software-pipelining design SURVEY.md §2.4 calls for.
//
// The decode and the resize are those of optflow_tpu/native/loader.cpp,
// statement for statement: built with the same compiler and flags, both
// libraries give the same bits for the same file, so the port's solver is
// fed exactly the frames the JAX package's is.
//
// C ABI (ctypes-friendly):
//   void* ofl_create(int n_threads);
//   int   ofl_submit(void* h, long id, const char* path, float scale);
//   int   ofl_wait_meta(void* h, long id, int* out_h, int* out_w);
//          -> 0 ready; <0 decode error (job consumed)
//   int   ofl_fetch(void* h, long id, float* out);  // copies + frees job
//   void  ofl_destroy(void* h);  // finishes what was submitted, then stops
//
// Build: python -m optflow_tpu_torch.ops._build loader   (g++ -O2 -fPIC
// -std=c++17 -shared, links libpng, libjpeg, libtiff, libz, pthread)

#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <tiffio.h>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> data;  // grayscale, 0..255
};

// ---------------------------------------------------------------- decode

bool decode_png(FILE* f, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // Normalize to 8-bit grayscale (cv::imread IMREAD_GRAYSCALE semantics:
  // 16-bit scaled down, RGB converted via BT.601).
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE) {
    // BT.601 luma, matching OpenCV's grayscale conversion weights
    png_set_rgb_to_gray(png, PNG_ERROR_ACTION_NONE, 0.299, 0.587);
  }
  png_read_update_info(png, info);

  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  out->h = (int)h;
  out->w = (int)w;
  out->data.resize((size_t)h * w);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data.data() + (size_t)y * w;
    for (png_uint_32 x = 0; x < w; ++x) dst[x] = (float)row[x];
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  out->h = (int)cinfo.output_height;
  out->w = (int)cinfo.output_width;
  out->data.resize((size_t)out->h * out->w);
  std::vector<uint8_t> row(out->w);
  uint8_t* rowp = row.data();
  while ((int)cinfo.output_scanline < out->h) {
    int y = (int)cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out->data.data() + (size_t)y * out->w;
    for (int x = 0; x < out->w; ++x) dst[x] = (float)row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// TIFF (the reference's cv::imread handles TIFF inputs and outputs,
// src/optflow.cpp:106,482-484). Decoded through the RGBA interface and
// reduced to BT.601 luma — identical to the 8-bit grayscale conversion
// cv::imread IMREAD_GRAYSCALE applies (16-bit data is scaled to 8 bits by
// libtiff's RGBA path, matching OpenCV's behavior for IMREAD_GRAYSCALE).
bool decode_tiff(const std::string& path, Image* out) {
  TIFFSetErrorHandler(nullptr);
  TIFFSetWarningHandler(nullptr);
  TIFF* tif = TIFFOpen(path.c_str(), "r");
  if (!tif) return false;
  uint32_t w = 0, h = 0;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &w);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &h);
  if (w == 0 || h == 0) {
    TIFFClose(tif);
    return false;
  }
  std::vector<uint32_t> rgba((size_t)w * h);
  bool ok = TIFFReadRGBAImageOriented(tif, w, h, rgba.data(),
                                      ORIENTATION_TOPLEFT, 0) != 0;
  TIFFClose(tif);
  if (!ok) return false;
  out->h = (int)h;
  out->w = (int)w;
  out->data.resize((size_t)h * w);
  for (size_t i = 0; i < rgba.size(); ++i) {
    uint32_t px = rgba[i];
    float r = (float)TIFFGetR(px);
    float g = (float)TIFFGetG(px);
    float b = (float)TIFFGetB(px);
    // round like OpenCV's fixed-point luma (gray inputs have r==g==b and
    // must reproduce the exact 8-bit value)
    out->data[i] = std::nearbyint(0.299f * r + 0.587f * g + 0.114f * b);
  }
  return true;
}

bool decode_file(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  bool is_tiff = (magic[0] == 'I' && magic[1] == 'I' && magic[2] == 0x2A) ||
                 (magic[0] == 'M' && magic[1] == 'M' && magic[3] == 0x2A);
  if (magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(f, out);
  } else if (magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  }
  fclose(f);
  if (is_tiff) ok = decode_tiff(path, out);
  return ok;
}

// ---------------------------------------------------------------- resize

// Bilinear with OpenCV's half-pixel convention: src_x = (x + 0.5)/s - 0.5.
void resize_bilinear(const Image& src, float scale, Image* dst) {
  if (scale == 1.0f) {
    *dst = src;
    return;
  }
  int nh = (int)std::lround(src.h * scale);
  int nw = (int)std::lround(src.w * scale);
  dst->h = nh;
  dst->w = nw;
  dst->data.resize((size_t)nh * nw);
  const float sy = (float)src.h / nh;
  const float sx = (float)src.w / nw;
  for (int y = 0; y < nh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > src.h - 1) fy = (float)src.h - 1;
    int y0 = (int)fy;
    if (y0 > src.h - 2) y0 = src.h - 2;
    float wy = fy - y0;
    const float* r0 = src.data.data() + (size_t)y0 * src.w;
    const float* r1 = r0 + src.w;
    float* drow = dst->data.data() + (size_t)y * nw;
    for (int x = 0; x < nw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > src.w - 1) fx = (float)src.w - 1;
      int x0 = (int)fx;
      if (x0 > src.w - 2) x0 = src.w - 2;
      float wx = fx - x0;
      float top = r0[x0] + wx * (r0[x0 + 1] - r0[x0]);
      float bot = r1[x0] + wx * (r1[x0 + 1] - r1[x0]);
      drow[x] = top + wy * (bot - top);
    }
  }
}

// ------------------------------------------------------------- scheduler

struct Job {
  long id;
  std::string path;
  float scale;
};

struct Result {
  bool ok = false;
  Image img;
};

struct Loader {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::map<long, Result> done;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  bool stopping = false;

  explicit Loader(int n_threads) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { run(); });
    }
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        job = queue.front();
        queue.pop_front();
      }
      Result res;
      Image raw;
      if (decode_file(job.path, &raw)) {
        res.ok = true;
        resize_bilinear(raw, job.scale, &res.img);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done[job.id] = std::move(res);
      }
      cv_done.notify_all();
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* ofl_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new Loader(n_threads);
}

int ofl_submit(void* h, long id, const char* path, float scale) {
  auto* loader = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(loader->mu);
    loader->queue.push_back(Job{id, path, scale});
  }
  loader->cv_work.notify_one();
  return 0;
}

int ofl_wait_meta(void* h, long id, int* out_h, int* out_w) {
  auto* loader = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(loader->mu);
  loader->cv_done.wait(lk, [&] { return loader->done.count(id) > 0; });
  Result& res = loader->done[id];
  if (!res.ok) {
    loader->done.erase(id);
    return -1;
  }
  *out_h = res.img.h;
  *out_w = res.img.w;
  return 0;
}

int ofl_fetch(void* h, long id, float* out) {
  auto* loader = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(loader->mu);
  auto it = loader->done.find(id);
  if (it == loader->done.end() || !it->second.ok) return -1;
  const Image& img = it->second.img;
  std::memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  loader->done.erase(it);
  return 0;
}

void ofl_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
