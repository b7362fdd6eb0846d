// The image loader's arithmetic without the image libraries.
//
// loader.cpp decodes PNG, JPEG and TIFF with libpng, libjpeg and libtiff and
// then resizes; on a machine without those libraries' headers it does not
// build. This library holds the loader's two pieces of arithmetic that come
// after the decode, statement for statement, and includes no image header:
//
//   - resize_bilinear (the half-pixel rule, the clamps and the std::lround
//     sizes), which every frame goes through;
//   - the BT.601 luma of decode_tiff, applied to libtiff's RGBA image, which
//     this library restates from the decoded samples: an 8-bit sample as it
//     is, a 16-bit one by libtiff's reductions (a gray sample keeps its high
//     byte, a colour sample is rounded to (v * 255 + 32767) / 65535).
//
// The caller decodes (engine/prefetch.py: cv2, whose gray PNG and JPEG
// decode equals libpng's and libjpeg's in the loader) and hands the samples
// over. Built with the loader's compiler and flags, the frames equal the
// loader's bit for bit.
//
// C ABI (ctypes-friendly):
//   void ofr_scaled_size(int h, int w, float scale, int* out_h, int* out_w);
//   int  ofr_gray_u8(const uint8_t* src, int h, int w, float scale,
//                    float* out);
//   int  ofr_tiff(const void* src, int h, int w, int channels, int bits,
//                 float scale, float* out);
//          src: h x w pixels of `channels` interleaved samples in OpenCV's
//          order (gray, BGR or BGRA), `bits` 8 or 16 each; out: the
//          ofr_scaled_size frame. Both return 0, or -1 for a shape or sample
//          they do not take.
//
// Build: python -m optflow_tpu_torch.ops._build frame   (g++ -O2 -fPIC
// -std=c++17 -shared, no library)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

// libtiff's packing of an RGBA pixel (tiffio.h)
#define TIFFGetR(abgr) ((abgr)&0xff)
#define TIFFGetG(abgr) (((abgr) >> 8) & 0xff)
#define TIFFGetB(abgr) (((abgr) >> 16) & 0xff)

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> data;  // grayscale, 0..255
};

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

// ------------------------------------------------------------------ luma

uint32_t keep8(uint32_t v) { return v; }
uint32_t gray16to8(uint32_t v) { return v >> 8; }
uint32_t color16to8(uint32_t v) { return (v * 255 + 32767) / 65535; }

// libtiff's RGBA image of the decoded samples: r, g, b in the low three
// bytes as TIFFReadRGBAImage packs them (the alpha byte is not read).
template <typename T, uint32_t (*to8)(uint32_t)>
std::vector<uint32_t> rgba_image(const T* src, size_t n, int channels) {
  std::vector<uint32_t> rgba(n);
  for (size_t i = 0; i < n; ++i) {
    const T* s = src + i * channels;
    uint32_t r, g, b;
    if (channels == 1) {
      r = g = b = to8(s[0]);
    } else {  // OpenCV's order: b, g, r
      b = to8(s[0]);
      g = to8(s[1]);
      r = to8(s[2]);
    }
    rgba[i] = r | (g << 8) | (b << 16);
  }
  return rgba;
}

// decode_tiff's reduction of the RGBA image to gray.
void tiff_luma(const std::vector<uint32_t>& rgba, Image* out) {
  for (size_t i = 0; i < rgba.size(); ++i) {
    uint32_t px = rgba[i];
    float r = (float)TIFFGetR(px);
    float g = (float)TIFFGetG(px);
    float b = (float)TIFFGetB(px);
    // round like OpenCV's fixed-point luma (gray inputs have r==g==b and
    // must reproduce the exact 8-bit value)
    out->data[i] = std::nearbyint(0.299f * r + 0.587f * g + 0.114f * b);
  }
}

void finish(const Image& raw, float scale, float* out) {
  Image img;
  resize_bilinear(raw, scale, &img);
  std::memcpy(out, img.data.data(), img.data.size() * sizeof(float));
}

}  // namespace

extern "C" {

void ofr_scaled_size(int h, int w, float scale, int* out_h, int* out_w) {
  if (scale == 1.0f) {
    *out_h = h;
    *out_w = w;
    return;
  }
  *out_h = (int)std::lround(h * scale);
  *out_w = (int)std::lround(w * scale);
}

int ofr_gray_u8(const uint8_t* src, int h, int w, float scale, float* out) {
  if (h < 1 || w < 1) return -1;
  Image raw;
  raw.h = h;
  raw.w = w;
  raw.data.resize((size_t)h * w);
  for (size_t i = 0; i < raw.data.size(); ++i) raw.data[i] = (float)src[i];
  finish(raw, scale, out);
  return 0;
}

int ofr_tiff(const void* src, int h, int w, int channels, int bits,
             float scale, float* out) {
  if (h < 1 || w < 1 || channels < 1 || channels > 4 || channels == 2)
    return -1;
  size_t n = (size_t)h * w;
  std::vector<uint32_t> rgba;
  if (bits == 8) {
    rgba = rgba_image<uint8_t, keep8>(static_cast<const uint8_t*>(src), n,
                                      channels);
  } else if (bits == 16 && channels == 1) {
    rgba = rgba_image<uint16_t, gray16to8>(
        static_cast<const uint16_t*>(src), n, channels);
  } else if (bits == 16) {
    rgba = rgba_image<uint16_t, color16to8>(
        static_cast<const uint16_t*>(src), n, channels);
  } else {
    return -1;
  }
  Image raw;
  raw.h = h;
  raw.w = w;
  raw.data.resize(n);
  tiff_luma(rgba, &raw);
  finish(raw, scale, out);
  return 0;
}

}  // extern "C"
