// Affine warps and remaps of uint8 images, equal to OpenCV 5.0's
// cv::warpAffine and cv::remap (INTER_LINEAR and INTER_NEAREST, constant
// border) byte for byte.
//
// Built with g++ on first use by d3fields_tpu_torch/native_build.py and
// called through ctypes from d3fields_tpu_torch/utils/imgwarp.py. OpenCV
// 5.0 computes these in float32 with fused multiply-adds:
//
// - warpAffine inverts the matrix in double, rounds it to float, and maps
//   each output row in blocks of 16 pixels as fma(M0, x, y*M1 + M2), the
//   last width % 16 (or 16) pixels as fma(x, M0, y*M1) + M2;
// - a linear sample is fma(beta, v1 - v0, v0) over the two rows
//   v = fma(alpha, p1 - p0, p0), rounded half to even; taps outside the
//   image read the border value;
// - a nearest sample reads the pixel at the coordinates rounded half to
//   even, or the border value.
//
// std::fmaf rounds once, as the hardware instruction does; the build
// passes -ffp-contract=off so that no other expression is fused.

#include <cmath>
#include <cstdint>

namespace {

inline uint8_t to_u8(float v) {
  const float r = std::nearbyintf(v);  // half to even under the default mode
  return static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
}

struct Image {
  const uint8_t* data;
  int64_t h, w, c;
  const double* border;
  inline float at(int64_t y, int64_t x, int64_t k) const {
    if (x < 0 || y < 0 || x >= w || y >= h) return static_cast<float>(border[k]);
    return static_cast<float>(data[(y * w + x) * c + k]);
  }
};

inline void sample(const Image& im, float sx, float sy, bool linear, uint8_t* out) {
  if (!(std::fabs(sx) < 1e9f && std::fabs(sy) < 1e9f)) {  // far outside, or NaN
    for (int64_t k = 0; k < im.c; ++k) out[k] = to_u8(static_cast<float>(im.border[k]));
    return;
  }
  if (!linear) {
    const int64_t ix = static_cast<int64_t>(std::nearbyintf(sx));
    const int64_t iy = static_cast<int64_t>(std::nearbyintf(sy));
    for (int64_t k = 0; k < im.c; ++k) {
      const float v = im.at(iy, ix, k);
      out[k] = static_cast<uint8_t>(v);
    }
    return;
  }
  const float fx = std::floor(sx), fy = std::floor(sy);
  const int64_t ix = static_cast<int64_t>(fx), iy = static_cast<int64_t>(fy);
  const float alpha = sx - fx, beta = sy - fy;
  for (int64_t k = 0; k < im.c; ++k) {
    const float p00 = im.at(iy, ix, k), p01 = im.at(iy, ix + 1, k);
    const float p10 = im.at(iy + 1, ix, k), p11 = im.at(iy + 1, ix + 1, k);
    const float v0 = std::fmaf(alpha, p01 - p00, p00);
    const float v1 = std::fmaf(alpha, p11 - p10, p10);
    out[k] = to_u8(std::fmaf(beta, v1 - v0, v0));
  }
}

}  // namespace

extern "C" {

// src: (h, w, c) uint8; m: the 2x3 forward matrix (source -> destination),
// row-major doubles; dst: (dh, dw, c) uint8; border: c doubles.
void warp_affine_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, const double* m,
                    int64_t linear, const double* border, uint8_t* dst, int64_t dh,
                    int64_t dw) {
  double M[6];
  for (int i = 0; i < 6; ++i) M[i] = m[i];
  double D = M[0] * M[4] - M[1] * M[3];
  D = D != 0 ? 1. / D : 0;
  const double A11 = M[4] * D, A22 = M[0] * D;
  M[0] = A11;
  M[1] *= -D;
  M[3] *= -D;
  M[4] = A22;
  const double b1 = -M[0] * M[2] - M[1] * M[5];
  const double b2 = -M[3] * M[2] - M[4] * M[5];
  M[2] = b1;
  M[5] = b2;
  float F[6];
  for (int i = 0; i < 6; ++i) F[i] = static_cast<float>(M[i]);
  const Image im{src, h, w, c, border};
  const int64_t block = 16;
  int64_t vec_end = 0;
  while (vec_end <= dw - block) vec_end += block;
  for (int64_t y = 0; y < dh; ++y) {
    const float yf = static_cast<float>(y);
    const float ym1 = yf * F[1], ym4 = yf * F[4];
    const float row_x = ym1 + F[2], row_y = ym4 + F[5];
    for (int64_t x = 0; x < dw; ++x) {
      const float xf = static_cast<float>(x);
      float sx, sy;
      if (x < vec_end) {
        sx = std::fmaf(F[0], xf, row_x);
        sy = std::fmaf(F[3], xf, row_y);
      } else {
        sx = std::fmaf(xf, F[0], ym1) + F[2];
        sy = std::fmaf(xf, F[3], ym4) + F[5];
      }
      sample(im, sx, sy, linear != 0, dst + (y * dw + x) * c);
    }
  }
}

// src: (h, w, c) uint8; mapx, mapy: (dh, dw) float32 source coordinates;
// dst: (dh, dw, c) uint8; border: c doubles.
void remap_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, const float* mapx,
              const float* mapy, int64_t linear, const double* border, uint8_t* dst,
              int64_t dh, int64_t dw) {
  const Image im{src, h, w, c, border};
  for (int64_t i = 0; i < dh * dw; ++i) sample(im, mapx[i], mapy[i], linear != 0, dst + i * c);
}

}  // extern "C"
