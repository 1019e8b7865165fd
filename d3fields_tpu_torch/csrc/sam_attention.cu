// The vision transformers' attention in one launch a layer: every view,
// window and head. SAM's layers add decomposed relative positions (the
// bias modes); DINOv2's take none (d3f_attention_*, the bias-free mode).
//
// Replaces no TPU kernel. In the JAX package this is
// d3fields_tpu/models/sam/model.py::_vision_attention with _rel_pos_bias,
// and the attention of d3fields_tpu/models/dinov2.py::_block, which XLA
// fuses on the TPU. In the port's plain chain for SAM
// (models/attention.py::sam_attention_plain) it is a matmul writing
// the (B*nh, L, L) logits, a 5-D broadcast writing the bias at the same
// size, an in-place add, an f32 copy, a softmax, a cast back and a second
// matmul, with permuted copies of q, k, v and the output around them.
// This kernel computes, for each (b, head),
//
//   out[i] = softmax_j(scale * (q[i] . k[j] + B[i, j])) v,
//   B[i, j] = rows[i, qh - kh + h - 1] + rows[i, ph + qw - kw + w - 1]
//
// over the L = h * w tokens of a window or of the whole grid, query i at
// grid position (qh, qw) and key j at (kh, kw): scale * B is SAM's
// decomposed relative-position bias. rows (nh, B, L, ph + pw) is the
// unscaled query against every row of rel_pos_h / scale (2h - 1 rows,
// padded to ph, a multiple of 8) and of rel_pos_w / scale (to pw): one
// batched GEMM in PyTorch that reads q where it lies. The bias is gathered
// from it in registers, and the logits, the bias, their f32 copy and the
// probabilities never reach device memory. q, k and v are read with strides
// where the qkv projection wrote them, (B, L, 3, nh, hd), and the output is
// written in the layout the output projection reads, (B, L, nh, hd). A
// window's padded tokens are keys like any other (their qkv rows are the
// projection of zeros), as upstream SAM has them.
//
// The bias-free mode (models/attention.py::vit_attention, DINOv2's layers;
// its plain chain vit_attention_plain is a matmul writing the (B*nh, L, L)
// logits, an f32 copy, a scale, a softmax, a cast back and a second matmul)
// computes out[i] = softmax_j(scale * q[i] . k[j]) v over any L >= 1 (769
// for a 24x32 patch grid and its CLS token): keys past L are masked out of
// the softmax, rows past L are not stored. It takes no rows and stages no
// bias; the tile loop, the online softmax and the epilogue are the bias
// modes' own, instantiated without the bias. At DINOv2 ViT-L over 4 views
// (B=4, nh=16, L=769, hd=64): 9.69 GFLOP, 9.8 us in bf16 and 0.145 ms in
// f32 at the peaks below; q, k, v and the output are 25 MB.
//
// What bounds it on an H100. Operations: 4 * L^2 * hd a (b, head), 343.6
// GFLOP at a ViT-H global layer (B=4, nh=16, L=4096, hd=80): 0.35 ms at
// 989 TFLOP/s in bf16, 5.1 ms at 67 TFLOP/s in f32 (TF32 stays off).
// Bytes: q, k, v, the bias rows and the output moved once, ~0.2 GB, 0.06
// ms: both routes are bound by their arithmetic.
//
// Design, the bf16 route (d3f_sam_attention_bf16): flash attention with
// mma.sync.m16n8k16 (bf16 operands, f32 sums). A block of 4 warps owns the
// query rows of one (b, head), each warp one or two groups of 16 rows; it
// walks the keys in tiles of 64 rows of k and v, double buffered in shared
// memory by cp.async (rows past L zero-filled) beside the block's q, all
// read by ldmatrix (a row pitch of hd + 8 puts the 8 rows of each 8x8
// matrix on distinct banks). The logits stay in f32: scale * (q . k + B)
// in base-2 units, then an online softmax in f32 (ex2.approx); the
// probabilities are rounded to bf16 only as the operands of p v, as the
// plain chain rounds them, and the output once. Where w == 64 (SAM's 64x64
// global grid) a key tile is one row of the grid: a warp takes two row
// groups (128 rows a block), so that each k and v fragment serves both,
// keeps the rel_pos_w terms of its rows x 16 columns in registers for the
// whole loop, starts each tile's q . k sums from them, and reads one
// rel_pos_h term a row a tile. Elsewhere (14x14 windows, 196 tokens) a warp
// takes one group (64 rows a block: more and shorter blocks), the block
// stages its rows' h + w bias terms in shared memory as f32, and each logit
// finds its key's (j / w, j % w). A warp whose rows all lie past L only
// loads and waits.
//
// Design, the f32 route (d3f_sam_attention_f32): the same tiling and the
// same online softmax (expf, not exp2f of a product), in f32 FMA on the
// CUDA cores: 128 threads a block, each holding 8 rows x 4 keys of the
// logits and 8 rows x hd/16 columns of the output; q and k transposed in
// shared memory so that each step of q . k is two 16-byte loads of q (one
// address a half warp) and one of k for 32 FMAs; the probabilities go
// through shared memory to p v. The bias always comes from the staged
// tables.
//
// Head widths are a template parameter: the bias modes instantiate 16
// (SamConfig.tiny_test), 64 (ViT-B/L) and 80 (ViT-H), the bias-free mode 64
// (every DINOv2); any other width returns cudaErrorInvalidValue. Times and
// bounds: PERF.md (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBM = 64;        // query rows a block
constexpr int kBN = 64;        // keys a tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Args {
  int B, L, nh, h, w;
  int ph, pw;  // a rows entry: 2h - 1 rel_pos_h terms padded to ph, 2w - 1 rel_pos_w to pw
  int64_t sb, sl, sh;  // q, k and v strides (elements) of a batch entry, a token, a head
  float scale;
};

// How the logits get their bias: SAM's decomposed relative positions from
// registers (a grid w == kBN wide) or from tables staged in shared memory,
// or none (DINOv2).
enum class Bias { kRegisters, kStaged, kNone };

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// (j / w, j % w) for j < 2^22 / 3 without an integer division: j + 0.5 lies
// at least 0.5 / w from a multiple of w, more than the product's error
__device__ __forceinline__ int key_row(int j, float inv_w) {
  return __float2int_rz((static_cast<float>(j) + 0.5f) * inv_w);
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// The bias of a query row i = (qh, qw) of the grid against key j = (kh, kw)
// is scale * (rows[i, qh - kh + h - 1] + rows[i, ph + qw - kw + w - 1]), a
// rows entry holding q_i against every row of rel_pos_h / scale (padded to
// ph) and then of rel_pos_w / scale (to pw). The block's row r is entry
// ((head * B + b) * L + m0 + r).

// the block's kRows rows of the bias times factor / scale as two f32 tables
// in shared memory, bh [kRows][h] and bw [kRows][w] (bh[r][kh] + bw[r][kw]
// for row r against key (kh, kw)); rows past L read zeros. Eight loads are in flight
// at once a thread: a block of windowed attention is short, and this
// latency is a share of it.
template <int kRows, typename T>
__device__ __forceinline__ void stage_bias(float* bh, float* bw, const T* __restrict__ rows,
                                           int64_t tab_row0, int m0, float factor,
                                           const Args& s) {
  constexpr int kUnroll = 8;
  const float inv_h = 1.f / static_cast<float>(s.h), inv_w = 1.f / static_cast<float>(s.w);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int cols = side ? s.w : s.h, width = s.ph + s.pw;
    const float inv = side ? inv_w : inv_h;
    const T* src = rows + tab_row0 * width + (side ? s.ph : 0);
    float* dst = side ? bw : bh;
    const int n = kRows * cols;
    for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        const int r = key_row(i, inv), kc = i - r * cols, row = m0 + r;
        const int qh = key_row(row, inv_w), qc = side ? row - qh * s.w : qh;
        x[u] = i < n && row < s.L ? to_float(src[r * width + qc - kc + cols - 1]) * factor : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u * kThreads < n) dst[i0 + u * kThreads] = x[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

// 16-row groups a warp: two where the bias is aligned (the global layers,
// long loops: k and v fragments serve both), one elsewhere (the windows:
// more, shorter blocks)
constexpr int kAlignedGroups = 2;
constexpr int kGeneralGroups = 1;
// the bias-free mode (DINOv2, L = 769: short loops of 13 tiles): one group a
// warp, and blocks small enough in registers for 4 of them an SM
constexpr int kNoBiasGroups = 1;
constexpr int kNoBiasMinBlocks = 4;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int kGroups>
constexpr int bf16_smem_tiles() {
  constexpr int kBMb = 4 * 16 * kGroups;
  // q [kBMb][HD + 8], k and v [2][kBN][HD + 8]
  return (kBMb + 4 * kBN) * (HD + 8) * static_cast<int>(sizeof(bf16));
}

template <int HD, Bias kBias, int kGroups>
__global__ void __launch_bounds__(kThreads, kBias == Bias::kNone ? kNoBiasMinBlocks : 2)
    sam_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ rows,
                              bf16* __restrict__ out, Args s) {
  constexpr int kBMb = 4 * 16 * kGroups;  // query rows a block: kGroups 16-row groups a warp
  constexpr bool kAligned = kBias == Bias::kRegisters;
  constexpr int kPitch = HD + 8;
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  constexpr int kKSteps = HD / 16;
  constexpr int kDTiles = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kBMb][kPitch]
  bf16* ks = qs + kBMb * kPitch;             // [2][kBN][kPitch]
  bf16* vs = ks + 2 * kBN * kPitch;          // [2][kBN][kPitch]
  float* bh_s = reinterpret_cast<float*>(vs + 2 * kBN * kPitch);  // [kBMb][h] (general)
  float* bw_s = bh_s + kBMb * s.h;                                 // [kBMb][w] (general)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const float scale2 = s.scale * kLog2e;  // the logits in base-2 units
  const int head = blockIdx.y, b = blockIdx.z, m0 = blockIdx.x * kBMb;
  const int L = s.L;
  const int64_t base = b * s.sb + head * s.sh;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int64_t tab_row0 = (static_cast<int64_t>(head) * s.B + b) * L + m0;

  for (int c = tid; c < kBMb * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = m0 + r < L;
    cp_async16(qs + r * kPitch + ch * 8,
               q + base + static_cast<int64_t>(ok ? m0 + r : 0) * s.sl + ch * 8, ok);
  }
  static_assert(kBN * kChunks % kThreads == 0, "a tile's chunks split evenly over the threads");
  auto load_tile = [&](int tile, int buf) {
    const int n0 = tile * kBN;
#pragma unroll
    for (int it = 0; it < kBN * kChunks / kThreads; ++it) {
      const int c = tid + it * kThreads, r = c / kChunks, ch = c % kChunks;
      const bool ok = n0 + r < L;
      const int64_t off = static_cast<int64_t>(ok ? n0 + r : 0) * s.sl + ch * 8;
      cp_async16(ks + (buf * kBN + r) * kPitch + ch * 8, kb + off, ok);
      cp_async16(vs + (buf * kBN + r) * kPitch + ch * 8, vb + off, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);  // with q, in one group

  // this thread's rows: group gi, half i -> lr[gi][i] in the block
  const int warp_row0 = warp * 16 * kGroups;
  int lr[kGroups][2];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    lr[gi][0] = warp_row0 + gi * 16 + g;
    lr[gi][1] = lr[gi][0] + 8;
  }
  // a warp whose rows all lie past L (a window's last block) only loads and waits
  const bool idle = m0 + warp_row0 >= L;

  // aligned (w == kBN: key tile t is grid row t, its column c is kw): the
  // rel_pos_w terms of this thread's rows x 16 columns as bf16 pairs, and where each
  // row's rel_pos_h terms start (its term for tile t at -t)
  uint32_t bw_r[kGroups][2][8];
  int bh_off[kGroups][2];
  const bf16* rows_b = rows + tab_row0 * (s.ph + s.pw);
  if constexpr (kAligned) {
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = min(lr[gi][i], L - 1 - m0), row = m0 + r;
        const int entry = r * (s.ph + s.pw);
        const bf16* pw = rows_b + entry + s.ph + (row % kBN) + kBN - 1;
        bh_off[gi][i] = entry + row / kBN + s.h - 1;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = nt * 8 + 2 * t4;
          bw_r[gi][i][nt] = static_cast<uint32_t>(__bfloat16_as_ushort(pw[-c])) |
                            (static_cast<uint32_t>(__bfloat16_as_ushort(pw[-c - 1])) << 16);
        }
      }
    }
  } else if constexpr (kBias == Bias::kStaged) {
    stage_bias<kBMb>(bh_s, bw_s, rows, tab_row0, m0, scale2, s);
  }
  const float inv_w = 1.f / static_cast<float>(s.w);

  float o[kGroups][kDTiles][4];
  float m[kGroups][2], l[kGroups][2];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[gi][dt][0] = o[gi][dt][1] = o[gi][dt][2] = o[gi][dt][3] = 0.f;
    }
    m[gi][0] = m[gi][1] = -INFINITY;
    l[gi][0] = l[gi][1] = 0.f;
  }

  const int tiles = (L + kBN - 1) / kBN;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!idle) {
      // each row's rel_pos_h term at this tile's grid row, in base-2 units (aligned)
      float bh_t[kGroups][2];
      if constexpr (kAligned) {
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            bh_t[gi][i] = __bfloat162float(rows_b[bh_off[gi][i] - t]) * scale2;
          }
        }
      }

      // logits of 16 rows x 64 keys a group; the sums start from the
      // rel_pos_w terms where they are the same every tile (aligned), from
      // zero elsewhere
      float sc[kGroups][8][4];
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float2 w2 = make_float2(0.f, 0.f);
            if constexpr (kAligned) {
              w2 = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&bw_r[gi][i][nt]));
            }
            sc[gi][nt][2 * i] = w2.x;
            sc[gi][nt][2 * i + 1] = w2.y;
          }
        }
      }
      const bf16* kt = ks + buf * kBN * kPitch;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t qa[kGroups][4];
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          ldmatrix_x4(qa[gi], qs + (warp_row0 + gi * 16 + (mi & 1) * 8 + (lane & 7)) * kPitch +
                                  kk * 16 + (mi >> 1) * 8);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + ((2 * np + (mi >> 1)) * 8 + (lane & 7)) * kPitch + kk * 16 +
                              (mi & 1) * 8);
#pragma unroll
          for (int gi = 0; gi < kGroups; ++gi) {
            mma_bf16(sc[gi][2 * np], qa[gi], kf[0], kf[1]);
            mma_bf16(sc[gi][2 * np + 1], qa[gi], kf[2], kf[3]);
          }
        }
      }

      const int n0 = t * kBN;
      // a bias-free tile with no key past L tests none
      const bool full = kBias == Bias::kNone && n0 + kBN <= L;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = n0 + nt * 8 + 2 * t4 + e;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& x = sc[gi][nt][2 * i + e];
              if constexpr (kAligned) {
                x = fmaf(x, scale2, bh_t[gi][i]);
              } else if (full || j < L) {
                if constexpr (kBias == Bias::kStaged) {
                  const int kh = key_row(j, inv_w), r = lr[gi][i];
                  x = fmaf(x, scale2, bh_s[r * s.h + kh] + bw_s[r * s.w + (j - kh * s.w)]);
                } else {
                  x *= scale2;
                }
              } else {
                x = -INFINITY;
              }
            }
          }
        }
      }

      // online softmax in base 2, each row's 64 keys on 4 lanes
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mt = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            mt = fmaxf(mt, fmaxf(sc[gi][nt][2 * i], sc[gi][nt][2 * i + 1]));
          }
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float mn = fmaxf(m[gi][i], mt);
          const float alpha = ex2(m[gi][i] - mn);  // 0 on the first tile
          m[gi][i] = mn;
          l[gi][i] *= alpha;
#pragma unroll
          for (int dt = 0; dt < kDTiles; ++dt) {
            o[gi][dt][2 * i] *= alpha;
            o[gi][dt][2 * i + 1] *= alpha;
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = ex2(sc[gi][nt][2 * i + e] - mn);
              sc[gi][nt][2 * i + e] = p;
              l[gi][i] += p;
            }
          }
        }
      }

      // o += p v, the probabilities rounded to bf16 as the operands
      const bf16* vt = vs + buf * kBN * kPitch;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[kGroups][4];
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          pa[gi][0] = pack_bf16(sc[gi][2 * kk][0], sc[gi][2 * kk][1]);
          pa[gi][1] = pack_bf16(sc[gi][2 * kk][2], sc[gi][2 * kk][3]);
          pa[gi][2] = pack_bf16(sc[gi][2 * kk + 1][0], sc[gi][2 * kk + 1][1]);
          pa[gi][3] = pack_bf16(sc[gi][2 * kk + 1][2], sc[gi][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < kDTiles / 2; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kPitch +
                                    (2 * dp + (mi >> 1)) * 8);
#pragma unroll
          for (int gi = 0; gi < kGroups; ++gi) {
            mma_bf16(o[gi][2 * dp], pa[gi], vf[0], vf[1]);
            mma_bf16(o[gi][2 * dp + 1], pa[gi], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[gi][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = m0 + lr[gi][i];
      if (row >= L) continue;
      const float inv = 1.f / li;
      bf16* dst = out + ((static_cast<int64_t>(b) * L + row) * s.nh + head) * HD + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
            pack_bf16(o[gi][dt][2 * i] * inv, o[gi][dt][2 * i + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kQPitch = kBM + 4;  // q^T and p^T rows: 16-byte aligned
constexpr int kKPitch = kBN + 4;

template <int HD>
constexpr int f32_smem_tiles() {
  // q^T [HD][kQPitch], k^T [HD][kKPitch], v [kBN][HD], p^T [kBN][kQPitch]
  return (HD * kQPitch + HD * kKPitch + kBN * HD + kBN * kQPitch) * static_cast<int>(sizeof(float));
}

template <int HD, bool kBias>
__global__ void __launch_bounds__(kThreads)
    sam_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ rows,
                             float* __restrict__ out, Args s) {
  constexpr int kCols = HD / 16;  // output columns a thread
  constexpr int kVec = HD / 4;    // float4 chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qT = reinterpret_cast<float*>(smem);
  float* kT = qT + HD * kQPitch;
  float* vS = kT + HD * kKPitch;
  float* pT = vS + kBN * HD;
  float* bh_s = pT + kBN * kQPitch;
  float* bw_s = bh_s + kBM * s.h;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;  // rows rg*8 .. +7, keys cg*4 .. +3 of a tile
  const int head = blockIdx.y, b = blockIdx.z, m0 = blockIdx.x * kBM;
  const int L = s.L;
  const int64_t base = b * s.sb + head * s.sh;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const int64_t tab_row0 = (static_cast<int64_t>(head) * s.B + b) * L + m0;

  // neighbouring threads take neighbouring rows: the transposed stores
  // land on distinct banks
  for (int c = tid; c < kBM * kVec; c += kThreads) {
    const int r = c % kBM, d4 = c / kBM;
    const float4 x = m0 + r < L ? *reinterpret_cast<const float4*>(
                                      qb + static_cast<int64_t>(m0 + r) * s.sl + 4 * d4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    qT[(4 * d4 + 0) * kQPitch + r] = x.x;
    qT[(4 * d4 + 1) * kQPitch + r] = x.y;
    qT[(4 * d4 + 2) * kQPitch + r] = x.z;
    qT[(4 * d4 + 3) * kQPitch + r] = x.w;
  }
  if constexpr (kBias) stage_bias<kBM>(bh_s, bw_s, rows, tab_row0, m0, s.scale, s);
  const float inv_w = 1.f / static_cast<float>(s.w);

  float o[8][kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  const int tiles = (L + kBN - 1) / kBN;
  for (int t = 0; t < tiles; ++t) {
    const int n0 = t * kBN;
    __syncthreads();  // the last tile's k, v and p are read
    for (int c = tid; c < kBN * kVec; c += kThreads) {
      const int r = c % kBN, d4 = c / kBN;
      const float4 x = n0 + r < L ? *reinterpret_cast<const float4*>(
                                        kb + static_cast<int64_t>(n0 + r) * s.sl + 4 * d4)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      kT[(4 * d4 + 0) * kKPitch + r] = x.x;
      kT[(4 * d4 + 1) * kKPitch + r] = x.y;
      kT[(4 * d4 + 2) * kKPitch + r] = x.z;
      kT[(4 * d4 + 3) * kKPitch + r] = x.w;
    }
    for (int c = tid; c < kBN * kVec; c += kThreads) {
      const int r = c / kVec, d4 = c % kVec;
      *reinterpret_cast<float4*>(vS + r * HD + 4 * d4) =
          n0 + r < L ? *reinterpret_cast<const float4*>(vb + static_cast<int64_t>(n0 + r) * s.sl +
                                                        4 * d4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(qT + d * kQPitch + rg * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(qT + d * kQPitch + rg * 8 + 4);
      const float4 bk = *reinterpret_cast<const float4*>(kT + d * kKPitch + cg * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(a[i], bb[c], sc[i][c]);
      }
    }

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = n0 + cg * 4 + c;
      if constexpr (kBias) {
        const int kh = key_row(j, inv_w), kw = j - kh * s.w;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rg * 8 + i;
          sc[i][c] = j < L ? fmaf(sc[i][c], s.scale, bh_s[r * s.h + kh] + bw_s[r * s.w + kw])
                           : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) sc[i][c] = j < L ? sc[i][c] * s.scale : -INFINITY;
      }
    }

    // online softmax: a row's 64 keys on the 16 lanes of a half warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mt = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int x = 1; x < 16; x <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);  // 0 on the first tile
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[i][c] = expf(sc[i][c] - mn);
        l[i] += sc[i][c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* dst = pT + (cg * 4 + c) * kQPitch + rg * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(sc[4][c], sc[5][c], sc[6][c], sc[7][c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBN; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(pT + kk * kQPitch + rg * 8);
      const float4 p1 = *reinterpret_cast<const float4*>(pT + kk * kQPitch + rg * 8 + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vS[kk * HD + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float li = l[i];
#pragma unroll
    for (int x = 1; x < 16; x <<= 1) li += __shfl_xor_sync(0xffffffffu, li, x);
    const int r = m0 + rg * 8 + i;
    if (r >= L) continue;
    float* dst = out + ((static_cast<int64_t>(b) * L + r) * s.nh + head) * HD + cg;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[16 * c] = o[i][c] / li;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel, typename T>
int launch(Kernel kernel, int block_rows, int smem, const void* q, const void* k, const void* v,
           const void* rows, void* out, const Args& s, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s.L + block_rows - 1) / block_rows),
                  static_cast<unsigned>(s.nh), static_cast<unsigned>(s.B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(rows), static_cast<T*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* rows, void* out,
                const Args& s, cudaStream_t stream) {
  if (s.w == kBN) {
    constexpr int kG = kAlignedGroups;
    return launch<decltype(&sam_attention_bf16_kernel<HD, Bias::kRegisters, kG>), bf16>(
        sam_attention_bf16_kernel<HD, Bias::kRegisters, kG>, 64 * kG, bf16_smem_tiles<HD, kG>(),
        q, k, v, rows, out, s, stream);
  }
  constexpr int kG = kGeneralGroups;
  const int smem =
      bf16_smem_tiles<HD, kG>() + 64 * kG * (s.h + s.w) * static_cast<int>(sizeof(float));
  return launch<decltype(&sam_attention_bf16_kernel<HD, Bias::kStaged, kG>), bf16>(
      sam_attention_bf16_kernel<HD, Bias::kStaged, kG>, 64 * kG, smem, q, k, v, rows, out, s,
      stream);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* rows, void* out,
               const Args& s, cudaStream_t stream) {
  const int smem = f32_smem_tiles<HD>() + kBM * (s.h + s.w) * static_cast<int>(sizeof(float));
  return launch<decltype(&sam_attention_f32_kernel<HD, true>), float>(
      sam_attention_f32_kernel<HD, true>, kBM, smem, q, k, v, rows, out, s, stream);
}

// the bias-free mode: no rows, no tables in shared memory
template <int HD>
int launch_bf16_no_bias(const void* q, const void* k, const void* v, void* out, const Args& s,
                        cudaStream_t stream) {
  constexpr int kG = kNoBiasGroups;
  return launch<decltype(&sam_attention_bf16_kernel<HD, Bias::kNone, kG>), bf16>(
      sam_attention_bf16_kernel<HD, Bias::kNone, kG>, 64 * kG, bf16_smem_tiles<HD, kG>(), q, k,
      v, nullptr, out, s, stream);
}

template <int HD>
int launch_f32_no_bias(const void* q, const void* k, const void* v, void* out, const Args& s,
                       cudaStream_t stream) {
  return launch<decltype(&sam_attention_f32_kernel<HD, false>), float>(
      sam_attention_f32_kernel<HD, false>, kBM, f32_smem_tiles<HD>(), q, k, v, nullptr, out, s,
      stream);
}

// a bias term count padded to 8, so that every row of the GEMM's output
// starts 16-byte aligned
int64_t padded(int64_t n) { return (n + 7) / 8 * 8; }

Args make_args(int64_t B, int64_t L, int64_t nh, int64_t h, int64_t w, int64_t sb, int64_t sl,
               int64_t sh, float scale) {
  return Args{static_cast<int>(B), static_cast<int>(L), static_cast<int>(nh), static_cast<int>(h),
              static_cast<int>(w), static_cast<int>(padded(2 * h - 1)),
              static_cast<int>(padded(2 * w - 1)), sb, sl, sh, scale};
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a head width other than 16, 64 or
// 80, launching nothing. The caller guarantees: q, k, v (B, L, nh, hd) with
// strides (sb, sl, sh, 1) in elements, 16-byte aligned rows; rows
// (nh, B, L, padded(2h - 1) + padded(2w - 1)) contiguous, out (B, L, nh, hd)
// contiguous, all of the route's type; L == h * w < 2^22 / 3, h + w small
// enough that a block's rows of both bias terms fit in shared memory beside
// the tiles, B and nh < 2^16.
extern "C" int d3f_sam_attention_bf16(const void* q, const void* k, const void* v,
                                      const void* rows, void* out,
                                      int64_t B, int64_t L, int64_t nh, int64_t h, int64_t w,
                                      int64_t hd, int64_t sb, int64_t sl, int64_t sh, float scale,
                                      void* stream) {
  const Args s = make_args(B, L, nh, h, w, sb, sl, sh, scale);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_bf16<16>(q, k, v, rows, out, s, st);
    case 64: return launch_bf16<64>(q, k, v, rows, out, s, st);
    case 80: return launch_bf16<80>(q, k, v, rows, out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int d3f_sam_attention_f32(const void* q, const void* k, const void* v,
                                     const void* rows, void* out,
                                     int64_t B, int64_t L, int64_t nh, int64_t h, int64_t w,
                                     int64_t hd, int64_t sb, int64_t sl, int64_t sh, float scale,
                                     void* stream) {
  const Args s = make_args(B, L, nh, h, w, sb, sl, sh, scale);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_f32<16>(q, k, v, rows, out, s, st);
    case 64: return launch_f32<64>(q, k, v, rows, out, s, st);
    case 80: return launch_f32<80>(q, k, v, rows, out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bias-free mode, softmax(scale * q k^T) v of every (b, head), as
// above without rows, h or w: any 1 <= L < 2^30, B and nh >= 1 and < 2^16.
// Head width 64 only; another returns cudaErrorInvalidValue.
extern "C" int d3f_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                  int64_t B, int64_t L, int64_t nh, int64_t hd, int64_t sb,
                                  int64_t sl, int64_t sh, float scale, void* stream) {
  if (hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16_no_bias<64>(q, k, v, out, make_args(B, L, nh, 0, 0, sb, sl, sh, scale),
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int d3f_attention_f32(const void* q, const void* k, const void* v, void* out,
                                 int64_t B, int64_t L, int64_t nh, int64_t hd, int64_t sb,
                                 int64_t sl, int64_t sh, float scale, void* stream) {
  if (hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32_no_bias<64>(q, k, v, out, make_args(B, L, nh, 0, 0, sb, sl, sh, scale),
                                static_cast<cudaStream_t>(stream));
}
