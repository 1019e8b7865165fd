// Multi-scale deformable-attention sampling (GroundingDINO's encoder and
// decoder).
//
// Replaces the Pallas TPU kernel d3fields_tpu/models/groundingdino/
// gather_pallas.py::deformable_gather_pallas (body _make_gather_kernel,
// index and weight rules _sample_indices_weights). Same contract as
// model.py::deformable_attention_core:
//
//   out[b, q, h*hd + c] = sum_l sum_p attn[b, q, h, l, p] *
//                         bilinear(value_l[b, :, h, c], loc[b, q, h, l, p])
//
//   value (B, S, nh, hd) f32, the L levels' (h_l, w_l) maps flattened
//     row-major and stacked along S from level_start[l];
//   loc (B, Q, nh, L, P, 2) f32 (x, y) in [0, 1] (any value is allowed);
//   attn (B, Q, nh, L, P) f32  ->  out (B, Q, nh*hd) f32.
//
// bilinear() is grid_sample with align_corners=False and zeros padding,
// with the sample positions computed as the TPU kernel computes them:
// g = 2x - 1, ix = ((g + 1) * w - 1) * 0.5, the same for iy with h; the
// four corners around (floor(ix), floor(iy)) are weighted (1-tx)(1-ty),
// tx(1-ty), (1-tx)ty, tx*ty, and a corner outside the map contributes
// nothing. The arithmetic is written with round-to-nearest intrinsics so
// that nvcc does not contract it into fused multiply-adds, which would
// round the sample positions differently.
//
// What bounds it on an H100: bytes. Each output channel costs 4LP
// multiply-adds of gathered values against 4 bytes written, far below the
// card's ratio of operations to bytes. The least traffic is value, loc and
// attn read once and out written once (255.5 MB at the 4-view encoder shape,
// B=4, S=Q=17821, nh=8, hd=32, L=P=4).
//
// Design. The TPU kernel staged a zero-padded 4-corner table of every
// level in VMEM, copied the sampled rows into scratch one 8-query group at a
// time on the scalar core, and lane-packed the weights; none of that is
// carried over. Here value is read where it lies. One warp owns one
// (b, q, head); its lanes own the head's channels (a loop over channel
// blocks of 32 when hd > 32, idle lanes when hd is not a multiple of 32).
// For each of the L*P samples every lane computes the same corner
// indices and weights from the sample's broadcast loc/attn reads, then
// reads its channel of the four corner rows: with hd = 32 a warp reads
// each corner as one coalesced 128-byte row, since hd is the contiguous
// axis. An f32 register accumulator sums the 4LP weighted taps and each
// output row is written once. Nothing of size (B, Q, nh, L, P, hd) ever
// exists. Samples near each other (the encoder's queries sample around
// their own pixel) share rows through L1 and L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

// levels: (L, 3) int64 rows of (h, w, level_start)
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deform_gather_kernel(const float* __restrict__ value, const int64_t* __restrict__ levels,
                     const float* __restrict__ loc, const float* __restrict__ attn,
                     float* __restrict__ out, int64_t rows, int64_t S, int64_t Q, int nh,
                     int hd, int L, int P) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // row = (b * Q + q) * nh + h
  const int lane = threadIdx.x & 31;
  const int head = static_cast<int>(row % nh);
  const int64_t b = row / nh / Q;
  const int LP = L * P;
  const float* __restrict__ loc_row = loc + row * LP * 2;
  const float* __restrict__ attn_row = attn + row * LP;
  const int64_t pixel_stride = static_cast<int64_t>(nh) * hd;  // one pixel of one level
  const float* __restrict__ v_head = value + b * S * pixel_stride + static_cast<int64_t>(head) * hd;

  for (int c0 = 0; c0 < hd; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < hd;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int h = static_cast<int>(__ldg(levels + 3 * l));
      const int w = static_cast<int>(__ldg(levels + 3 * l + 1));
      const float* __restrict__ v_level = v_head + __ldg(levels + 3 * l + 2) * pixel_stride;
      const float fw = static_cast<float>(w), fh = static_cast<float>(h);
      for (int p = 0; p < P; ++p) {
        const int s = l * P + p;
        const float gx = __fsub_rn(__fmul_rn(2.f, __ldg(loc_row + 2 * s)), 1.f);
        const float gy = __fsub_rn(__fmul_rn(2.f, __ldg(loc_row + 2 * s + 1)), 1.f);
        const float ix = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), fw), 1.f), 0.5f);
        const float iy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), fh), 1.f), 0.5f);
        const float x0f = floorf(ix), y0f = floorf(iy);
        // a base corner outside [-1, size-1] has all four corners outside
        // the map; the test is false for NaN too, and keeps the float to
        // int conversions below in range for samples far outside [0, 1]
        if (!(x0f >= -1.f && x0f <= fw - 1.f && y0f >= -1.f && y0f <= fh - 1.f)) continue;
        if (!active) continue;
        const float tx = __fsub_rn(ix, x0f), ty = __fsub_rn(iy, y0f);
        const float ux = __fsub_rn(1.f, tx), uy = __fsub_rn(1.f, ty);
        const float a = __ldg(attn_row + s);
        const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
        const bool x0_in = x0 >= 0, x1_in = x0 + 1 < w, y0_in = y0 >= 0, y1_in = y0 + 1 < h;
        float tap = 0.f;
        if (y0_in) {
          const float* __restrict__ r = v_level + (static_cast<int64_t>(y0) * w + x0) * pixel_stride + c;
          if (x0_in) tap = __fadd_rn(tap, __fmul_rn(__fmul_rn(ux, uy), __ldg(r)));
          if (x1_in) tap = __fadd_rn(tap, __fmul_rn(__fmul_rn(tx, uy), __ldg(r + pixel_stride)));
        }
        if (y1_in) {
          const float* __restrict__ r =
              v_level + (static_cast<int64_t>(y0 + 1) * w + x0) * pixel_stride + c;
          if (x0_in) tap = __fadd_rn(tap, __fmul_rn(__fmul_rn(ux, ty), __ldg(r)));
          if (x1_in) tap = __fadd_rn(tap, __fmul_rn(__fmul_rn(tx, ty), __ldg(r + pixel_stride)));
        }
        acc = __fadd_rn(acc, __fmul_rn(a, tap));
      }
    }
    if (active) out[row * hd + c] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (B, Q, nh*hd), guarantees contiguous tensors, a
// (L, 3) int64 `levels` table of (h, w, level_start) on the device with
// sum(h*w) == S, and B*Q*nh > 0.
extern "C" int d3f_deform_gather(const void* value, const void* levels, const void* loc,
                                 const void* attn, void* out, int64_t B, int64_t S, int64_t Q,
                                 int64_t nh, int64_t hd, int64_t L, int64_t P, void* stream) {
  const int64_t rows = B * Q * nh;
  const dim3 grid(static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  deform_gather_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const int64_t*>(levels),
      static_cast<const float*>(loc), static_cast<const float*>(attn), static_cast<float*>(out),
      rows, S, Q, static_cast<int>(nh), static_cast<int>(hd), static_cast<int>(L),
      static_cast<int>(P));
  return static_cast<int>(cudaGetLastError());
}
