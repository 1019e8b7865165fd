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
// tx(1-ty), (1-tx)ty, tx*ty, and a corner outside the map samples zeros.
// A NaN (or infinite) position gives the whole (b, q, head) row NaN, as the
// JAX package and the CPU's grid_sample do (CUDA's grid_sample gives zeros
// there): its four weights are attn * (ix * 0 + iy * 0), NaN for such a
// position and attn * 0 for any finite one. The position arithmetic
// is written with round-to-nearest intrinsics so that nvcc does not
// contract it into fused multiply-adds, which would round the sample
// positions differently from XLA and grid_sample.
//
// What bounds it on an H100. The byte bound is value, loc and attn read
// once and out written once (255.5 MB at the 4-view encoder shape, B=4,
// S=Q=17821, nh=8, hd=32, L=P=4: 0.076 ms). A gather cannot reach it: every
// (q, head) reads 64 corner rows of 128 bytes, 4.67 GB through L1 at that
// shape, which at one 128-byte wavefront per clock per SM is ~0.14 ms on
// 132 SMs at the 1.98 GHz boost clock. The first design (one warp per (b, q, head), one
// channel per lane) ran at 1.33-1.48 ms: all 32 lanes repeated each
// sample's index math, two 64-bit divisions decoded each warp, and each
// corner load sat in its own branch and was consumed at once, so a warp
// had one load in flight at a time. Locality of the samples bought nothing.
//
// Design. One warp owns one (b, q, head), and its work is split in two
// phases.
//   1. Index phase, spread over the lanes: lane s reads sample s's loc and
//      attn with coalesced loads and one 16-byte load of its level's
//      (h, w, start) row, and computes the position, four corner pixels
//      and four corner weights, each already multiplied by attn. A corner
//      outside the map gets pixel -1. Samples past 32 (L*P > 32) take
//      further rounds of the same two phases.
//   2. Gather phase, branch-free: hd/4 lanes cover one corner row with
//      16-byte loads (one float per lane when hd % 4 != 0), so one warp
//      load fetches G = 32 / (hd/4) corner rows: 4 at hd = 32, 10 at
//      hd = 12 (2 lanes idle). The corners' (pixel, weight) pairs reach
//      the lanes by __shfl_sync; an idle lane or a corner outside the map
//      reads a zero row at weight 0 through a select, not a branch, so all
//      of a step's loads (and the next steps', by unrolling) are in flight
//      together. Each lane group sums its corners in an f32 register
//      accumulator; a shuffle tree over the groups finishes the sum, and
//      group 0 writes the output row once.
// The detector's hd = 32 has its own instance, with the 8 lanes of a row
// known at compile time, so that the loop over corner rows unrolls fully.
// Warps walk head-major: a block holds 8 neighbouring queries of one
// (b, head), decoded from a 3-D grid without division. That order was
// faster on the card than the heads of one query side by side, on random
// and on a request's inputs (PERF.md). Nothing of size (B, Q, nh, L, P, hd)
// ever exists. Times: PERF.md (chip_smoke.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// the row a corner outside the map reads
__device__ __align__(16) float kZeros[4] = {0.f, 0.f, 0.f, 0.f};

__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& a) { a = 0.f; }

__device__ __forceinline__ void axpy(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}
__device__ __forceinline__ void axpy(float& acc, float w, float x) { acc = fmaf(w, x, acc); }

__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }

__device__ __forceinline__ float4 shfl_down(const float4& v, int delta) {
  return make_float4(__shfl_down_sync(kFull, v.x, delta), __shfl_down_sync(kFull, v.y, delta),
                     __shfl_down_sync(kFull, v.z, delta), __shfl_down_sync(kFull, v.w, delta));
}
__device__ __forceinline__ float shfl_down(float v, int delta) {
  return __shfl_down_sync(kFull, v, delta);
}

// Sample s of one (b, q, head): its four corner pixels (indices into the
// S axis, -1 for a corner outside the map) and weights (attn times the
// bilinear weight). Corners are ordered (y0, x0), (y0, x0+1), (y0+1, x0),
// (y0+1, x0+1). As in grid_sample with zeros padding, a corner outside the
// map samples a zero row, so its weight is attn * 0 (NaN for a NaN attn, and
// for a NaN or infinite position).
__device__ __forceinline__ void sample_corners(const int4* __restrict__ levels,
                                               const float* __restrict__ loc_row,
                                               const float* __restrict__ attn_row, int s,
                                               int P, int pix[4], float wt[4]) {
  const int4 level = __ldg(levels + s / P);
  const int h = level.x, w = level.y, start = level.z;
  const float fw = static_cast<float>(w), fh = static_cast<float>(h);
  const float a = __ldg(attn_row + s);
  const float gx = __fsub_rn(__fmul_rn(2.f, __ldg(loc_row + 2 * s)), 1.f);
  const float gy = __fsub_rn(__fmul_rn(2.f, __ldg(loc_row + 2 * s + 1)), 1.f);
  const float ix = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), fw), 1.f), 0.5f);
  const float iy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), fh), 1.f), 0.5f);
  const float x0f = floorf(ix), y0f = floorf(iy);
  pix[0] = pix[1] = pix[2] = pix[3] = -1;
  // a base corner outside [-1, size-1] has all four corners outside the
  // map; the test is false for NaN too, and keeps the float to int
  // conversions below in range for samples far outside [0, 1]
  if (!(x0f >= -1.f && x0f <= fw - 1.f && y0f >= -1.f && y0f <= fh - 1.f)) {
    // 0 for a finite position, NaN for a NaN or infinite one
    const float poison = __fadd_rn(__fmul_rn(ix, 0.f), __fmul_rn(iy, 0.f));
    wt[0] = wt[1] = wt[2] = wt[3] = __fmul_rn(a, poison);
    return;
  }
  const float tx = __fsub_rn(ix, x0f), ty = __fsub_rn(iy, y0f);
  const float ux = __fsub_rn(1.f, tx), uy = __fsub_rn(1.f, ty);
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  const bool x0_in = x0 >= 0, x1_in = x0 + 1 < w, y0_in = y0 >= 0, y1_in = y0 + 1 < h;
  const int r0 = start + y0 * w + x0, r1 = r0 + w;  // pixel (y0, x0) and (y0+1, x0)
  pix[0] = x0_in && y0_in ? r0 : -1;
  pix[1] = x1_in && y0_in ? r0 + 1 : -1;
  pix[2] = x0_in && y1_in ? r1 : -1;
  pix[3] = x1_in && y1_in ? r1 + 1 : -1;
  wt[0] = __fmul_rn(a, pix[0] >= 0 ? __fmul_rn(ux, uy) : 0.f);
  wt[1] = __fmul_rn(a, pix[1] >= 0 ? __fmul_rn(tx, uy) : 0.f);
  wt[2] = __fmul_rn(a, pix[2] >= 0 ? __fmul_rn(ux, ty) : 0.f);
  wt[3] = __fmul_rn(a, pix[3] >= 0 ? __fmul_rn(tx, ty) : 0.f);
}

// Vec is float4 (hd % 4 == 0, 16-byte aligned value and out) or float.
// kRowLanes is the lanes per corner row when known at compile time (8 for
// the detector's hd = 32), else 0. levels: (L,) int4 rows of
// (h, w, level_start, 0). blockIdx.z is the batch
// row b, blockIdx.y the head, and the block's warps hold kWarpsPerBlock
// consecutive queries.
template <typename Vec, int kRowLanes>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deform_gather_kernel(const float* __restrict__ value, const int4* __restrict__ levels,
                     const float* __restrict__ loc, const float* __restrict__ attn,
                     float* __restrict__ out, int S, int Q, int nh, int hd, int L, int P) {
  const int q = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int head = blockIdx.y;
  if (q >= Q) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.z;
  const int64_t row = (b * Q + q) * nh + head;
  const int LP = L * P;
  constexpr int kWidth = sizeof(Vec) / sizeof(float);
  const int nvec = hd / kWidth;            // vectors in one corner row
  const int gw = kRowLanes ? kRowLanes : nvec < 32 ? nvec : 32;  // lanes per corner row
  const int G = 32 / gw;                   // corner rows per warp load
  const int g = lane / gw, j = lane - g * gw;
  const int64_t pixel_stride = static_cast<int64_t>(nh) * hd;  // one pixel of one level
  const float* __restrict__ v_head = value + b * S * pixel_stride + static_cast<int64_t>(head) * hd;
  const float* __restrict__ loc_row = loc + row * LP * 2;
  const float* __restrict__ attn_row = attn + row * LP;
  Vec* __restrict__ out_row = reinterpret_cast<Vec*>(out + row * hd);

  for (int cv0 = 0; cv0 < nvec; cv0 += gw) {  // one pass unless hd > 32 * kWidth
    const int cv = cv0 + j;
    const bool active = g < G && cv < nvec;
    const float* __restrict__ v_lane = v_head + static_cast<int64_t>(cv) * kWidth;
    Vec acc;
    zero(acc);
    for (int s0 = 0; s0 < LP; s0 += 32) {
      const int ns = min(32, LP - s0);
      int pix[4] = {-1, -1, -1, -1};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (lane < ns) sample_corners(levels, loc_row, attn_row, s0 + lane, P, pix, wt);
#pragma unroll 4
      for (int base = 0; base < ns; base += G) {
        // corners (base + g, k): branch-free, so that the four loads (and
        // those of the next steps) are in flight together. An idle lane and
        // a corner outside the map read a zero row.
        const int src = base + g;
        const bool take = active && src < ns;
        const float* rows[4];
        float a[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = __shfl_sync(kFull, pix[k], src & 31);
          const float wk = __shfl_sync(kFull, wt[k], src & 31);
          rows[k] = take && p >= 0 ? v_lane + p * pixel_stride : kZeros;
          a[k] = take ? wk : 0.f;
        }
        Vec v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __ldg(reinterpret_cast<const Vec*>(rows[k]));
#pragma unroll
        for (int k = 0; k < 4; ++k) axpy(acc, a[k], v[k]);
      }
    }
    // group g + stride's partial sum into group g, a tree over the G groups
    for (int stride = 1; stride < G; stride <<= 1) {
      const Vec other = shfl_down(acc, stride * gw);
      if (g % (2 * stride) == 0 && g + stride < G) add(acc, other);
    }
    if (g == 0 && cv < nvec) out_row[cv] = acc;
  }
}

template <typename Vec, int kRowLanes = 0>
void launch(const void* value, const void* levels, const void* loc, const void* attn, void* out,
            int64_t B, int64_t S, int64_t Q, int64_t nh, int64_t hd, int64_t L, int64_t P,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((Q + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  static_cast<unsigned>(nh), static_cast<unsigned>(B));
  deform_gather_kernel<Vec, kRowLanes><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(value), static_cast<const int4*>(levels),
      static_cast<const float*>(loc), static_cast<const float*>(attn), static_cast<float*>(out),
      static_cast<int>(S), static_cast<int>(Q), static_cast<int>(nh), static_cast<int>(hd),
      static_cast<int>(L), static_cast<int>(P));
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (B, Q, nh*hd), guarantees contiguous tensors, a
// (L, 4) int32 `levels` table of (h, w, level_start, 0) on the device with
// sum(h*w) == S, B, Q, nh > 0, Q * nh < 2^31, B < 2^16 and nh < 2^16.
extern "C" int d3f_deform_gather(const void* value, const void* levels, const void* loc,
                                 const void* attn, void* out, int64_t B, int64_t S, int64_t Q,
                                 int64_t nh, int64_t hd, int64_t L, int64_t P, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = hd % 4 == 0 && reinterpret_cast<uintptr_t>(value) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4 && hd == 32) {  // the detector's heads: the loop over corner rows unrolls fully
    launch<float4, 8>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
  } else if (vec4) {
    launch<float4>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
  } else {
    launch<float>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
  }
  return static_cast<int>(cudaGetLastError());
}
