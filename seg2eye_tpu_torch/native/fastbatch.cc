// Fused host-side batch assembly of the OpenEDS loader (the port's copy of
// seg2eye_tpu/native/fastbatch.cc).
//
// One pass per image straight into the preallocated NHWC batch buffer:
// uint8 -> float32 in [-1, 1] with an optional horizontal flip, and the
// uint8 class-id masks with the same flip.  Built on first use by
// seg2eye_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC) and bound
// with ctypes; a build that fails raises there.

#include <cstdint>
#include <cstddef>

extern "C" {

// src: n contiguous (h, w) uint8 images (pointer array)
// dst: (n, h, w, 1) float32, value = src/127.5 - 1
// flip[i] != 0 -> mirror image i horizontally
void assemble_images(const uint8_t** src, const uint8_t* flip,
                     int64_t n, int64_t h, int64_t w, float* dst) {
  float lut[256];
  for (int v = 0; v < 256; ++v) lut[v] = (float)v / 127.5f - 1.0f;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = src[i];
    float* d = dst + i * h * w;
    if (flip[i]) {
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = s + y * w;
        float* out = d + y * w;
        for (int64_t x = 0; x < w; ++x) out[x] = lut[row[w - 1 - x]];
      }
    } else {
      const int64_t total = h * w;
      for (int64_t j = 0; j < total; ++j) d[j] = lut[s[j]];
    }
  }
}

// uint8 class-id mask copy with optional horizontal flip (no normalize)
void assemble_masks(const uint8_t** src, const uint8_t* flip,
                    int64_t n, int64_t h, int64_t w, uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = src[i];
    uint8_t* d = dst + i * h * w;
    if (flip[i]) {
      for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x)
          d[y * w + x] = s[y * w + (w - 1 - x)];
    } else {
      const int64_t total = h * w;
      for (int64_t j = 0; j < total; ++j) d[j] = s[j];
    }
  }
}

}  // extern "C"
