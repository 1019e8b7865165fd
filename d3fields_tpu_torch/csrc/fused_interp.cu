// Multi-view weighted bilinear interpolation of patch-grid descriptor maps.
//
// Replaces the Pallas TPU kernel d3fields_tpu/fields/kernels.py::
// fused_weighted_interp (kernel body _fused_gather_kernel). Same contract:
//
//   out[n, :] = sum_v sum_tap w[v, n, tap] * feats[v, idx[v, n, tap], :]
//
//   feats (V, P, C) f32, idx (V, N, 4) int32, w (V, N, 4) f32 -> out (N, C) f32
//
// A tap whose index lies outside [0, P) contributes nothing, as in the
// TPU kernel, whose one-hot compare matches no row for such an index.
//
// What bounds it on an H100. The byte bound is the table and the taps read
// once and the output written once: at the field query's shape (V=4,
// P=24*32, C=1024, N=131072) about 566 MB, 0.169 ms, dominated by the
// 537 MB output. The direct gather (one row of threads per point, 16-byte
// loads of the 4V table rows it needs) reads 4V * C * 4 = 64 KB per point
// from L2, 8.6 GB per launch: at 0.89-0.95 ms it runs at the L2's rate.
//
// Shared-memory route. The (V*P, C) table is small (12.6 MB at the field
// query's shape), so a channel slice of all of its rows fits in one block's
// shared memory: 16 channels x 3,072 rows x 4 B = 192 KB. Block b stages
// slice b % slices with cp.async and then sums the points of one range of
// [0, N); the blocks of every slice walk the same points at the same time.
// Two lanes serve one point: lane tg reads taps tg and tg + 2 of each view
// (x0 and x0+1, neighbouring rows), each a whole 64-byte row slice, as four
// float4 chunks in an order rotated by the point's place in its
// quarter-warp. A 64-byte row fills half the banks, so the two lanes of a
// point fill opposite halves and the four points of a quarter-warp take
// four chunk positions: every shared-memory load touches each bank once,
// 8 wavefronts per (point, slice), the least for its 1 KB. Taps outside
// [0, P), chunks past C and views past V read a row at weight 0 through
// selects: the tap loop has no branch, so its loads stay in flight
// together. A shuffle sums the two lanes, and each store writes a whole
// 32-byte sector of the point's output slice, evict-first so the output
// stream does not push the taps out of L2.
// What bounds this route is the L1/shared-memory data path: the 8.6 GB of
// table reads alone are ~0.26 ms at 128 B per clock on 132 SMs, and the
// output's 64-byte pieces (one per point and slice) and the taps, re-read
// once per slice, share that path. Measured on the card: PERF.md.
//
// Direct route. Where no slice of 8 channels fits (V*P*32 B above the
// 227 KB a block may use), or C % 4 != 0, or the table is not 16-byte
// aligned, the wrapper picks the direct gather (4-channel slices were
// slower than it wherever they fit, on the card: PERF.md): a block owns a few points,
// the threads of one row of the block stride over the C channels, 16 bytes
// at a time where C % 4 == 0, and sum the 4V weighted table rows from L2
// in an f32 register accumulator.
//
// Either route is one launch, and writes each output row once; nothing of
// size (V, N, C) ever exists.

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreadsPerBlock = 256;  // direct route
constexpr int kSliceThreads = 1024;    // shared-memory route
constexpr int kLanesPerPoint = 2;
constexpr int kViews = 2;  // views whose taps one lane loads at once

__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& a) { a = 0.f; }

__device__ __forceinline__ void axpy(float4& acc, float w, const float4& x) {
  acc.x += w * x.x;
  acc.y += w * x.y;
  acc.z += w * x.z;
  acc.w += w * x.w;
}
__device__ __forceinline__ void axpy(float& acc, float w, const float& x) { acc += w * x; }

// ---------------------------------------------------------------------------
// direct route
// ---------------------------------------------------------------------------

template <typename Vec>
__device__ __forceinline__ void tap(Vec& acc, const Vec* __restrict__ table, int i, float w,
                                    int P, int64_t Cv, int64_t c) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(P)) {
    axpy(acc, w, __ldg(table + static_cast<int64_t>(i) * Cv + c));
  }
}

// Vec is float4 (C % 4 == 0, 16-byte aligned table) or float; Cv = C / width(Vec).
// blockDim.x threads stride over one point's Cv channel vectors; blockDim.y
// points share the block.
template <typename Vec>
__global__ void __launch_bounds__(kThreadsPerBlock)
fused_weighted_interp_kernel(const Vec* __restrict__ feats, const int4* __restrict__ idx,
                             const float4* __restrict__ w, Vec* __restrict__ out, int V, int P,
                             int64_t N, int64_t Cv) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (n >= N) return;
  for (int64_t c = threadIdx.x; c < Cv; c += blockDim.x) {
    Vec acc;
    zero(acc);
    for (int v = 0; v < V; ++v) {
      const int4 i4 = __ldg(idx + static_cast<int64_t>(v) * N + n);
      const float4 w4 = __ldg(w + static_cast<int64_t>(v) * N + n);
      const Vec* table = feats + static_cast<int64_t>(v) * P * Cv;
      tap(acc, table, i4.x, w4.x, P, Cv, c);
      tap(acc, table, i4.y, w4.y, P, Cv, c);
      tap(acc, table, i4.z, w4.z, P, Cv, c);
      tap(acc, table, i4.w, w4.w, P, Cv, c);
    }
    out[n * Cv + c] = acc;
  }
}

template <typename Vec>
void launch_direct(const void* feats, const void* idx, const void* w, void* out, int V, int P,
                   int64_t N, int64_t Cv, cudaStream_t stream) {
  // One row of threads per point, as wide as the row needs up to 128 (a
  // multiple of the warp), and as many points per block as fill 256 threads.
  const int64_t warps = (Cv + 31) / 32;
  const int bx = static_cast<int>(warps >= 4 ? 128 : 32 * warps);
  const int by = kThreadsPerBlock / bx;
  const dim3 block(bx, by);
  const dim3 grid(static_cast<unsigned>((N + by - 1) / by));
  fused_weighted_interp_kernel<Vec><<<grid, block, 0, stream>>>(
      static_cast<const Vec*>(feats), static_cast<const int4*>(idx),
      static_cast<const float4*>(w), static_cast<Vec*>(out), V, P, N, Cv);
}

// ---------------------------------------------------------------------------
// shared-memory route
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const auto dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Component t of v, for t = tt + 2m with m known at compile time: the
// compiler folds the test of bit 1, which leaves one select.
__device__ __forceinline__ int pick(const int4& v, int t) {
  return t & 2 ? (t & 1 ? v.w : v.z) : (t & 1 ? v.y : v.x);
}
__device__ __forceinline__ float pick(const float4& v, int t) {
  return t & 2 ? (t & 1 ? v.w : v.z) : (t & 1 ? v.y : v.x);
}

// K float4 chunks per staged row: slices of 4K channels. The (V*P, K)
// float4 slice lives in dynamic shared memory. Block b stages slice
// b % slices and sums the points of range b / slices, one of `splits`
// equal ranges of [0, N): the blocks of all slices walk the same points
// at the same time, so each point's taps come from L2 after the first
// read, and its output row is written whole while it is in L2.
template <int K>
__global__ void __launch_bounds__(kSliceThreads, 1)
fused_interp_slice_kernel(const float* __restrict__ feats, const int4* __restrict__ idx,
                          const float4* __restrict__ w, float* __restrict__ out, int V, int P,
                          int64_t N, int64_t C, int splits) {
  extern __shared__ float4 table[];
  constexpr int kSlice = 4 * K;  // channels per slice
  constexpr int kPointsPerPass = kSliceThreads / kLanesPerPoint;
  const int rows = V * P;
  const int lane = threadIdx.x & 31;
  const int tg = lane & 1;  // this lane's taps of each view: tg and tg + 2
  // Chunk c of a row is read at step (c - rot) mod K. The four points of a
  // quarter-warp take four rotations, and a point's two lanes read taps
  // tg = 0 and 1, neighbouring rows that fill opposite halves of the banks
  // (with 64-byte rows), so each quarter-warp load touches every bank once.
  const int rot = (lane >> 1) & (K - 1);
  const unsigned pair_mask = 0x3u << (lane & ~1);  // this point's two lanes
  const int slices = static_cast<int>((C + kSlice - 1) / kSlice);
  const int slice = blockIdx.x % slices, split = blockIdx.x / slices;
  const int64_t n0 = N * split / splits, n1 = N * (split + 1) / splits;
  const int64_t c0 = static_cast<int64_t>(slice) * kSlice;
  const int64_t left = (C - c0) / 4;  // float4s left: the last slice may be ragged
  const int kv = left < K ? static_cast<int>(left) : K;

  for (int e = threadIdx.x; e < rows * K; e += kSliceThreads) {
    const int r = e / K, c = e % K;
    if (c < kv) {
      cp_async16(table + e, feats + static_cast<int64_t>(r) * C + c0 + 4 * c);
    } else {
      zero(table[e]);  // past the last channel: read, summed, never written out
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  int chunk_of[K];  // acc[k] sums chunk (k + rot) % K
#pragma unroll
  for (int k = 0; k < K; ++k) chunk_of[k] = (k + rot) & (K - 1);

  for (int64_t n = n0 + threadIdx.x / kLanesPerPoint; n < n1; n += kPointsPerPass) {
    float4 acc[K];  // acc[k]: chunk (k + rot) % K of the slice
#pragma unroll
    for (int k = 0; k < K; ++k) zero(acc[k]);
    for (int v0 = 0; v0 < V; v0 += kViews) {
      // the taps of kViews views, loaded together so that their latency
      // is paid once; a view past V reads row 0 of view 0 at weight 0
      int4 i4[kViews];
      float4 w4[kViews];
#pragma unroll
      for (int c = 0; c < kViews; ++c) {
        if (v0 + c < V) {
          i4[c] = __ldg(idx + static_cast<int64_t>(v0 + c) * N + n);
          w4[c] = __ldg(w + static_cast<int64_t>(v0 + c) * N + n);
        } else {
          i4[c] = make_int4(-1, -1, -1, -1);
          zero(w4[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kViews; ++c) {
        const int view_row = (v0 + c < V ? v0 + c : 0) * P;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // branch-free: a tap outside [0, P) reads row 0 of its view at
          // weight 0, as the plain version does
          const int t = tg + 2 * m;
          const int i = pick(i4[c], t);
          const bool in = static_cast<unsigned>(i) < static_cast<unsigned>(P);
          const float wt = in ? pick(w4[c], t) : 0.f;
          const float4* __restrict__ r = table + (view_row + (in ? i : 0)) * K;
#pragma unroll
          for (int k = 0; k < K; ++k) axpy(acc[k], wt, r[chunk_of[k]]);
        }
      }
    }
    // sum the two lanes' taps, then write the point's slice: at step m
    // lane tg writes chunk 2m + tg, so the two lanes write one whole
    // 32-byte sector per store
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k].x += __shfl_xor_sync(pair_mask, acc[k].x, 1);
      acc[k].y += __shfl_xor_sync(pair_mask, acc[k].y, 1);
      acc[k].z += __shfl_xor_sync(pair_mask, acc[k].z, 1);
      acc[k].w += __shfl_xor_sync(pair_mask, acc[k].w, 1);
    }
    float4* __restrict__ dst = reinterpret_cast<float4*>(out + n * C + c0);
#pragma unroll
    for (int m = 0; m < (K + 1) / 2; ++m) {
      const int chunk = 2 * m + tg;
      const int from = (chunk - rot) & (K - 1);  // the acc[k] that holds it
      float4 v = acc[0];
#pragma unroll
      for (int k = 1; k < K; ++k) v = from == k ? acc[k] : v;
      if (chunk < K && chunk < kv) __stcs(dst + chunk, v);
    }
  }
}

// The blocks of `kernel` that fit on the current device at once with
// `smem` bytes of dynamic shared memory. The first launch for a (kernel,
// device, smem) opts the kernel in to the device's largest dynamic shared
// memory and asks the occupancy calculator; later launches find the answer
// here, so that a launch makes no host query but cudaGetDevice.
cudaError_t resident_blocks(const void* kernel, size_t smem, int64_t* resident) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int64_t> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, device, smem);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *resident = it->second;
    return cudaSuccess;
  }
  int optin = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSliceThreads, smem)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = known[key] = static_cast<int64_t>(sms) * per_sm;
  return cudaSuccess;
}

template <int K>
cudaError_t launch_slices(const void* feats, const void* idx, const void* w, void* out, int V,
                          int P, int64_t N, int64_t C, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(V) * P * K * sizeof(float4);
  int64_t resident = 0;
  const cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(fused_interp_slice_kernel<K>), smem, &resident);
  if (err != cudaSuccess) return err;
  // as many point ranges as let every slice's blocks fill the card once
  const int64_t slices = (C + 4 * K - 1) / (4 * K);
  int64_t splits = resident / slices;
  splits = splits < 1 ? 1 : splits > N ? N : splits;
  const auto blocks = static_cast<unsigned>(slices * splits);
  fused_interp_slice_kernel<K><<<blocks, kSliceThreads, smem, stream>>>(
      static_cast<const float*>(feats), static_cast<const int4*>(idx),
      static_cast<const float4*>(w), static_cast<float*>(out), V, P, N, C,
      static_cast<int>(splits));
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller allocates `out` (N, C) and guarantees contiguous tensors, 16-byte
// aligned idx and w, N > 0 and C > 0. `slice_channels` picks the route:
// 16 or 8 takes the shared-memory route with slices of that many
// channels (then C % 4 == 0, feats and out are 16-byte aligned and
// V*P*slice_channels*4 bytes fit in one block's shared memory), 0 the
// direct route.
extern "C" int d3f_fused_weighted_interp(const void* feats, const void* idx, const void* w,
                                         void* out, int64_t V, int64_t P, int64_t N, int64_t C,
                                         int64_t slice_channels, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int v = static_cast<int>(V), p = static_cast<int>(P);
  switch (slice_channels) {
    case 16:
      return static_cast<int>(launch_slices<4>(feats, idx, w, out, v, p, N, C, s));
    case 8:
      return static_cast<int>(launch_slices<2>(feats, idx, w, out, v, p, N, C, s));
    case 0:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    launch_direct<float4>(feats, idx, w, out, v, p, N, C / 4, s);
  } else {
    launch_direct<float>(feats, idx, w, out, v, p, N, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}
