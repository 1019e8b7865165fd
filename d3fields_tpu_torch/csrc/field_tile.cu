// The point-wise work of one field-query tile, in one launch.
//
// Replaces no TPU kernel. In the JAX package this work is the XLA-fused
// part of d3fields_tpu/fields/kernels.py::eval_field_fused around the
// Pallas kernel; in the port's plain chain (fields/kernels.py::
// _eval_field_fused_plain) it is ~1,060 small torch launches a tile of
// 131,072 points: fusion._fused_distance (projection, the nearest-depth
// tap, the visibility terms), geometry.bilinear_taps for the patch grid,
// fusion._bilinear_views for the full-resolution maps, fusion._normalise.
// One thread takes one point through every view:
//
//   projection      cam = (K @ [R|t]) [p; 1], |z| < 1e-4 -> z = 1e-3 and
//                   not in front, xy = cam[:2] / z
//   depth tap       the nearest depth pixel (ties to even), zero padding
//   visibility      valid = (tap > 0) & in_front & (tap - z > -mu),
//                   weight = exp(min(mu - |tap - z|, 0) / mu),
//                   dist = clamp(tap - z, -mu, mu), vw = valid * weight
//   fused distance  denom = sum valid, dist = sum(dist * valid) /
//                   (denom + 1e-6), 1e3 where no view is valid
//   patch taps      idx (V, N, 4) int32 clamped flat indices into the
//                   (h, w) patch grid and tw (V, N, 4) their bilinear
//                   weights, out-of-bounds taps zeroed, times vw and
//                   1 / (denom + 1e-6): the descriptor kernel
//                   (csrc/fused_interp.cu) then sums normalised rows
//                   straight into the query's output, and a point no
//                   view sees sums to 0 as _normalise's where gives
//   full-resolution sum_v bilinear(map[v], xy[v]) * vw[v], over
//   maps            (denom + 1e-6), 0 where no view is valid, for every
//                   map of the image's size, any channel count
//
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), in the plain chain's order: nvcc
// contracts a*b + c into one FMA by default, and a different rounding of
// xy can move the nearest depth pixel and with it the distance. expf, not
// __expf. A float index outside int32 takes INT_MIN, as torch's
// .to(torch.int32) gives it on x86, so the taps' indices match too.
//
// What bounds it on an H100. Bytes: at V=4, N=131,072 each point reads its
// 12-byte point and writes 4 + 1 bytes of distance and validity, 2 x 64
// bytes of taps (written here once, read once by the descriptor kernel)
// and 4 * C bytes of each full-resolution map's row; the depth and map
// taps are reads of tables of a few MB that stay in L2. About 21 MB a
// tile with the 3-channel mask: ~6 us at 3.35 TB/s. The arithmetic, ~100
// float ops a view without FMAs, is as small. Every write is a whole
// 16-byte chunk of neighbouring threads where it can be (the taps), so the
// launch is bound by its stores and by the latency of the dependent depth
// tap; PERF.md has its time.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxViews = 8;  // fields/kernels.py: TILE_MAX_VIEWS
constexpr int kMaxMaps = 4;   // fields/kernels.py: TILE_MAX_MAPS

struct TileArgs {
  const float* pts;    // (N, 3)
  const float* pose;   // (V, 3, 4) world -> camera
  const float* K;      // (V, 3, 3)
  const float* depth;  // (V, H, W)
  float* dist;         // (N,)
  uint8_t* valid;      // (N,) torch.bool
  int4* idx;           // (V, N) rows of 4 taps of the patch grid, or null
  float4* tw;          // (V, N) rows of 4 tap weights
  const float* maps[kMaxMaps];  // full-resolution (V, H, W, C_m)
  float* map_out[kMaxMaps];     // (N, C_m)
  int channels[kMaxMaps];
  int num_maps;
  int V, H, W, h, w;
  int64_t N;
  float mu;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }

// geometry._unnormalize (align_corners): an image-space pixel coordinate
// of an image in_size pixels wide -> a continuous index into a map
// out_size pixels wide, in two steps as the plain version takes them
__device__ __forceinline__ float unnormalize(float coord, int in_size, int out_size) {
  const float gn = sub(mul(quot(coord, static_cast<float>(in_size - 1)), 2.f), 1.f);
  return mul(mul(add(gn, 1.f), 0.5f), static_cast<float>(out_size - 1));
}

// float -> int32 as torch converts on x86: out of range and NaN give INT_MIN
__device__ __forceinline__ int to_int32(float x) {
  return (x >= -2147483648.f && x < 2147483648.f) ? static_cast<int>(x) : INT_MIN;
}

__device__ __forceinline__ int64_t clamp(int64_t i, int64_t hi) {
  return i < 0 ? 0 : i > hi ? hi : i;
}

// geometry.bilinear_taps for one point of one view: the taps (0,0),
// (0,1), (1,0), (1,1) of a (h, w) map as clamped flat indices, and their
// bilinear weights with out-of-bounds taps zeroed
struct Taps {
  int i[4];
  float w[4];
};

__device__ __forceinline__ Taps bilinear_taps(float x, float y, int H, int W, int h, int w) {
  const float ix = unnormalize(x, W, w), iy = unnormalize(y, H, h);
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float tx = sub(ix, x0), ty = sub(iy, y0);
  const float ux = sub(1.f, tx), uy = sub(1.f, ty);
  const float wgt[4] = {mul(ux, uy), mul(tx, uy), mul(ux, ty), mul(tx, ty)};
  const int64_t x0i = to_int32(x0), y0i = to_int32(y0);
  Taps t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t xi = x0i + (k & 1), yi = y0i + (k >> 1);
    const bool in = xi >= 0 && xi <= w - 1 && yi >= 0 && yi <= h - 1;
    t.w[k] = mul(wgt[k], in ? 1.f : 0.f);
    t.i[k] = static_cast<int>(clamp(yi, h - 1) * w + clamp(xi, w - 1));
  }
  return t;
}

__global__ void __launch_bounds__(kThreads) field_tile_kernel(const TileArgs a) {
  // K @ [R|t] of each view, (a0 + a1) + a2 as the plain version sums it
  __shared__ float krt[kMaxViews * 12];
  for (int e = threadIdx.x; e < a.V * 12; e += blockDim.x) {
    const int v = e / 12, r = e % 12 / 4, c = e % 4;
    const float* K = a.K + v * 9 + r * 3;
    const float* P = a.pose + v * 12 + c;
    krt[e] = add(add(mul(K[0], P[0]), mul(K[1], P[4])), mul(K[2], P[8]));
  }
  __syncthreads();
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= a.N) return;
  const float px = a.pts[3 * n], py = a.pts[3 * n + 1], pz = a.pts[3 * n + 2];
  const float mu = a.mu;

  float x[kMaxViews], y[kMaxViews], vw[kMaxViews];
  float denom = 0.f, dsum = 0.f;
#pragma unroll
  for (int v = 0; v < kMaxViews; ++v) {
    if (v >= a.V) break;
    const float* A = krt + 12 * v;
    float cam[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      cam[r] = add(add(mul(A[4 * r], px), mul(A[4 * r + 1], py)),
                   add(mul(A[4 * r + 2], pz), A[4 * r + 3]));
    }
    const bool front = !(fabsf(cam[2]) < 1e-4f);
    const float z = front ? cam[2] : 1e-3f;
    x[v] = quot(cam[0], z);
    y[v] = quot(cam[1], z);
    const float rx = rintf(unnormalize(x[v], a.W, a.W));
    const float ry = rintf(unnormalize(y[v], a.H, a.H));
    const bool in = rx >= 0.f && rx <= a.W - 1 && ry >= 0.f && ry <= a.H - 1;
    const float tap =
        in ? __ldg(a.depth + (static_cast<int64_t>(v) * a.H + static_cast<int>(ry)) * a.W +
                   static_cast<int>(rx))
           : 0.f;
    const float raw = sub(tap, z);
    const bool valid = tap > 0.f && front && raw > -mu;
    const float ex = sub(mu, fabsf(raw));
    const float weight = expf(quot(ex > 0.f ? 0.f : ex, mu));
    const float d = fminf(fmaxf(raw, -mu), mu);
    const float vf = valid ? 1.f : 0.f;
    denom = add(denom, vf);
    dsum = add(dsum, mul(d, vf));
    vw[v] = mul(vf, weight);
  }
  const float dd = add(denom, 1e-6f);
  const bool seen = denom != 0.f;
  a.dist[n] = seen ? quot(dsum, dd) : 1e3f;
  a.valid[n] = seen;

  if (a.idx != nullptr) {
    const float r = quot(1.f, dd);
#pragma unroll
    for (int v = 0; v < kMaxViews; ++v) {
      if (v >= a.V) break;
      const Taps t = bilinear_taps(x[v], y[v], a.H, a.W, a.h, a.w);
      const int64_t row = static_cast<int64_t>(v) * a.N + n;
      a.idx[row] = make_int4(t.i[0], t.i[1], t.i[2], t.i[3]);
      a.tw[row] = make_float4(mul(mul(t.w[0], vw[v]), r), mul(mul(t.w[1], vw[v]), r),
                              mul(mul(t.w[2], vw[v]), r), mul(mul(t.w[3], vw[v]), r));
    }
  }

  const int64_t HW = static_cast<int64_t>(a.H) * a.W;
  for (int m = 0; m < a.num_maps; ++m) {
    const int C = a.channels[m];
    float* dst = a.map_out[m] + n * C;
    for (int c0 = 0; c0 < C; c0 += 4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int v = 0; v < kMaxViews; ++v) {
        if (v >= a.V) break;
        const Taps t = bilinear_taps(x[v], y[v], a.H, a.W, a.H, a.W);
        const float* view = a.maps[m] + v * HW * C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          if (c >= C) break;
          float s = mul(__ldg(view + static_cast<int64_t>(t.i[0]) * C + c), t.w[0]);
#pragma unroll
          for (int k = 1; k < 4; ++k) {
            s = add(s, mul(__ldg(view + static_cast<int64_t>(t.i[k]) * C + c), t.w[k]));
          }
          s = mul(s, vw[v]);
          acc[j] = v == 0 ? s : add(acc[j], s);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j < C) dst[c0 + j] = seen ? quot(acc[j], dd) : 0.f;
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller guarantees contiguous f32 tensors on the current device: pts
// (N, 3), pose (V, 3, 4), K (V, 3, 3), depth (V, H, W), dist (N,), valid
// (N,) bool; idx (V, N, 4) int32 and tw (V, N, 4) f32, 16-byte aligned,
// or both null where no patch-grid map is asked for (then h and w are not
// read); num_maps full-resolution maps (V, H, W, channels[m]) with their
// (N, channels[m]) outputs. V <= 8, num_maps <= 4.
extern "C" int d3f_field_tile(const void* pts, const void* pose, const void* K, const void* depth,
                              void* dist, void* valid, void* idx, void* tw,
                              const void* const* maps, void* const* map_out,
                              const int64_t* channels, int64_t num_maps, int64_t V, int64_t H,
                              int64_t W, int64_t h, int64_t w, int64_t N, double mu,
                              void* stream) {
  if (V < 1 || V > kMaxViews || num_maps < 0 || num_maps > kMaxMaps || N < 0 ||
      (idx == nullptr) != (tw == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  TileArgs a{};
  a.pts = static_cast<const float*>(pts);
  a.pose = static_cast<const float*>(pose);
  a.K = static_cast<const float*>(K);
  a.depth = static_cast<const float*>(depth);
  a.dist = static_cast<float*>(dist);
  a.valid = static_cast<uint8_t*>(valid);
  a.idx = static_cast<int4*>(idx);
  a.tw = static_cast<float4*>(tw);
  for (int m = 0; m < num_maps; ++m) {
    a.maps[m] = static_cast<const float*>(maps[m]);
    a.map_out[m] = static_cast<float*>(map_out[m]);
    a.channels[m] = static_cast<int>(channels[m]);
  }
  a.num_maps = static_cast<int>(num_maps);
  a.V = static_cast<int>(V);
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  a.h = static_cast<int>(h);
  a.w = static_cast<int>(w);
  a.N = N;
  a.mu = static_cast<float>(mu);
  const auto blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  field_tile_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
