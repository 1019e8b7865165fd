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
//   value (B, S, nh, hd) f32 or bf16, the L levels' (h_l, w_l) maps
//     flattened row-major and stacked along S from level_start[l];
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
//
// The bf16-table route (d3f_deform_gather_bf16): the GroundingDINO encoder
// under the bf16 compute dtype projects its values in bf16, and the TPU
// kernel then gathers bf16 tables and sums in f32. Here the same kernel
// reads bf16 rows: a lane loads a chunk of 8 bf16 (16 bytes) when
// hd % 8 == 0, of 4 (8 bytes) when hd % 4 == 0, else one, widens each pair
// with __bfloat1622float2 and accumulates exactly as the f32 route, into
// f32 registers and an f32 output. The index phase, the weights and the
// NaN and out-of-map rules are shared. At hd = 32 a 64-byte row takes 4
// lanes of 16 bytes, so one warp load fetches G = 8 corner rows (4 in the
// f32 route) and each sample round takes half the steps. On an NVIDIA H100
// 80GB HBM3 at 700 W it runs about as fast as the f32 route at the encoder
// shape (PERF.md): half the row bytes through L1 bought little, so the row
// traffic is not what bounds either route now.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// the row a corner outside the map reads: 16 zero bytes, a zero of every
// chunk type below
__device__ __align__(16) float kZeros[4] = {0.f, 0.f, 0.f, 0.f};

// kWidth consecutive table elements of type T, read by one lane in one
// load (Raw) and widened to f32.
template <typename T, int kWidth>
struct Chunk;

template <>
struct Chunk<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <>
struct Chunk<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[1]) { f[0] = r; }
};

// two bf16 packed in 32 bits (the lower one first) as two floats
__device__ __forceinline__ float2 widen2(unsigned int pair) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
}

template <>
struct Chunk<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[8]) {
    const unsigned int u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = widen2(u[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

template <>
struct Chunk<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[4]) {
    const float2 a = widen2(r.x), b = widen2(r.y);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<unsigned int>(r) << 16);  // bf16 is f32's top half
  }
};

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

// T is the table's element type (float or bf16) and kWidth the elements a
// lane reads in one load (4 or 1 for float, 8, 4 or 1 for bf16; value and
// out aligned to the load, hd % kWidth == 0). kRowLanes is the lanes per
// corner row when known at compile time (8 for the detector's hd = 32 in
// f32, 4 in bf16), else 0. levels: (L,) int4 rows of
// (h, w, level_start, 0). blockIdx.z is the batch
// row b, blockIdx.y the head, and the block's warps hold kWarpsPerBlock
// consecutive queries.
template <typename T, int kWidth, int kRowLanes>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deform_gather_kernel(const T* __restrict__ value, const int4* __restrict__ levels,
                     const float* __restrict__ loc, const float* __restrict__ attn,
                     float* __restrict__ out, int S, int Q, int nh, int hd, int L, int P) {
  using C = Chunk<T, kWidth>;
  using Raw = typename C::Raw;
  const int q = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int head = blockIdx.y;
  if (q >= Q) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.z;
  const int64_t row = (b * Q + q) * nh + head;
  const int LP = L * P;
  const int nvec = hd / kWidth;            // chunks in one corner row
  const int gw = kRowLanes ? kRowLanes : nvec < 32 ? nvec : 32;  // lanes per corner row
  const int G = 32 / gw;                   // corner rows per warp load
  const int g = lane / gw, j = lane - g * gw;
  const int64_t pixel_stride = static_cast<int64_t>(nh) * hd;  // one pixel of one level
  const T* __restrict__ v_head = value + b * S * pixel_stride + static_cast<int64_t>(head) * hd;
  const float* __restrict__ loc_row = loc + row * LP * 2;
  const float* __restrict__ attn_row = attn + row * LP;
  float* __restrict__ out_row = out + row * hd;
  const T* zeros = reinterpret_cast<const T*>(kZeros);

  for (int cv0 = 0; cv0 < nvec; cv0 += gw) {  // one pass unless hd > 32 * kWidth
    const int cv = cv0 + j;
    const bool active = g < G && cv < nvec;
    const T* __restrict__ v_lane = v_head + static_cast<int64_t>(cv) * kWidth;
    float acc[kWidth];
#pragma unroll
    for (int i = 0; i < kWidth; ++i) acc[i] = 0.f;
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
        const T* rows[4];
        float a[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = __shfl_sync(kFull, pix[k], src & 31);
          const float wk = __shfl_sync(kFull, wt[k], src & 31);
          rows[k] = take && p >= 0 ? v_lane + p * pixel_stride : zeros;
          a[k] = take ? wk : 0.f;
        }
        Raw v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __ldg(reinterpret_cast<const Raw*>(rows[k]));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float f[kWidth];
          C::widen(v[k], f);
#pragma unroll
          for (int i = 0; i < kWidth; ++i) acc[i] = fmaf(a[k], f[i], acc[i]);
        }
      }
    }
    // group g + stride's partial sum into group g, a tree over the G groups
    for (int stride = 1; stride < G; stride <<= 1) {
#pragma unroll
      for (int i = 0; i < kWidth; ++i) {
        const float other = __shfl_down_sync(kFull, acc[i], stride * gw);
        if (g % (2 * stride) == 0 && g + stride < G) acc[i] += other;
      }
    }
    if (g == 0 && cv < nvec) {
      float* dst = out_row + cv * kWidth;
      if constexpr (kWidth % 4 == 0) {
#pragma unroll
        for (int i = 0; i < kWidth; i += 4) {
          *reinterpret_cast<float4*>(dst + i) = make_float4(acc[i], acc[i + 1], acc[i + 2],
                                                            acc[i + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kWidth; ++i) dst[i] = acc[i];
      }
    }
  }
}

template <typename T, int kWidth, int kRowLanes = 0>
int launch(const void* value, const void* levels, const void* loc, const void* attn, void* out,
           int64_t B, int64_t S, int64_t Q, int64_t nh, int64_t hd, int64_t L, int64_t P,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((Q + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  static_cast<unsigned>(nh), static_cast<unsigned>(B));
  deform_gather_kernel<T, kWidth, kRowLanes><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int4*>(levels),
      static_cast<const float*>(loc), static_cast<const float*>(attn), static_cast<float*>(out),
      static_cast<int>(S), static_cast<int>(Q), static_cast<int>(nh), static_cast<int>(hd),
      static_cast<int>(L), static_cast<int>(P));
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
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
  const bool vec4 = hd % 4 == 0 && aligned(value, 16) && aligned(out, 16);
  if (vec4 && hd == 32) {  // the detector's heads: the loop over corner rows unrolls fully
    return launch<float, 4, 8>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
  }
  if (vec4) return launch<float, 4>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
  return launch<float, 1>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
}

// The bf16-table route: value (B, S, nh, hd) bf16, loc, attn and out f32 as
// above. `width` is the bf16 elements a lane loads at once, 8, 4 or 1: hd
// must be a multiple of it, `value` aligned to 2 * width bytes and `out` to
// 16 bytes (width > 1). Anything else returns cudaErrorInvalidValue and
// launches nothing: the caller picks the width and checks the pointers.
extern "C" int d3f_deform_gather_bf16(const void* value, const void* levels, const void* loc,
                                      const void* attn, void* out, int64_t B, int64_t S,
                                      int64_t Q, int64_t nh, int64_t hd, int64_t L, int64_t P,
                                      int64_t width, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (!(width == 8 || width == 4 || width == 1) || hd % width != 0 ||
      !aligned(value, 2 * width) || (width > 1 && !aligned(out, 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 8 && hd == 32) {  // the detector's heads: 4 lanes a row, unrolled
    return launch<__nv_bfloat16, 8, 4>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
  }
  if (width == 8) {
    return launch<__nv_bfloat16, 8>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
  }
  if (width == 4) {
    return launch<__nv_bfloat16, 4>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
  }
  return launch<__nv_bfloat16, 1>(value, levels, loc, attn, out, B, S, Q, nh, hd, L, P, s);
}
