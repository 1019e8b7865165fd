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
// bf16-table route (d3f_fused_weighted_interp_bf16): the TPU kernel at
// matmul_dtype="bfloat16", its default on the chip. feats is bf16, and
// each tap weight is rounded to bf16 (to nearest even) in a register, as
// the TPU kernel rounds its interpolation matrix; rows are widened to f32
// and the products summed in f32, into an f32 output. Every route below
// is one template over the table type T: a 16-byte chunk holds 4 f32 or
// 8 bf16 channels (Chunk<T, kWidth>), so a bf16 table's 32-channel slice
// has the 64-byte rows, the bank pattern and the shared-memory size of an
// f32 16-channel slice. Its bytes barely fall: at the field query's shape
// the f32 output is 537 of the 560 MB (the table 6.3 MB in bf16, the taps
// 16.8 MB, w read in f32).
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

#include <cuda_bf16.h>
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

// The weight a tap multiplies its row by: as given for an f32 table; for a
// bf16 table rounded to bf16, as the TPU kernel rounds its interpolation
// matrix (one tap of a view per row: each weight is rounded once).
template <typename T>
__device__ __forceinline__ float tap_weight(float w) {
  return w;
}
template <>
__device__ __forceinline__ float tap_weight<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// kWidth f32 values to dst: 16-byte stores where kWidth % 4 == 0
template <int kWidth>
__device__ __forceinline__ void store(float* dst, const float (&a)[kWidth]) {
  if constexpr (kWidth % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kWidth / 4; ++q) {
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kWidth; ++j) dst[j] = a[j];
  }
}

// ---------------------------------------------------------------------------
// direct route
// ---------------------------------------------------------------------------

template <typename T, int kWidth>
__device__ __forceinline__ void tap(float (&acc)[kWidth],
                                    const typename Chunk<T, kWidth>::Raw* __restrict__ table,
                                    int i, float w, int P, int64_t Cv, int64_t c) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(P)) {
    float f[kWidth];
    Chunk<T, kWidth>::widen(__ldg(table + static_cast<int64_t>(i) * Cv + c), f);
    const float wt = tap_weight<T>(w);
#pragma unroll
    for (int j = 0; j < kWidth; ++j) acc[j] += wt * f[j];
  }
}

// Chunk<T, kWidth> loads (kWidth = 4 where C % 4 == 0 and the table is
// aligned for it, else 1); Cv = C / kWidth. blockDim.x threads stride over
// one point's Cv chunks; blockDim.y points share the block.
template <typename T, int kWidth>
__global__ void __launch_bounds__(kThreadsPerBlock)
fused_weighted_interp_kernel(const typename Chunk<T, kWidth>::Raw* __restrict__ feats,
                             const int4* __restrict__ idx, const float4* __restrict__ w,
                             float* __restrict__ out, int V, int P, int64_t N, int64_t Cv) {
  using Raw = typename Chunk<T, kWidth>::Raw;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (n >= N) return;
  for (int64_t c = threadIdx.x; c < Cv; c += blockDim.x) {
    float acc[kWidth];
#pragma unroll
    for (int j = 0; j < kWidth; ++j) acc[j] = 0.f;
    for (int v = 0; v < V; ++v) {
      const int4 i4 = __ldg(idx + static_cast<int64_t>(v) * N + n);
      const float4 w4 = __ldg(w + static_cast<int64_t>(v) * N + n);
      const Raw* table = feats + static_cast<int64_t>(v) * P * Cv;
      tap<T, kWidth>(acc, table, i4.x, w4.x, P, Cv, c);
      tap<T, kWidth>(acc, table, i4.y, w4.y, P, Cv, c);
      tap<T, kWidth>(acc, table, i4.z, w4.z, P, Cv, c);
      tap<T, kWidth>(acc, table, i4.w, w4.w, P, Cv, c);
    }
    store<kWidth>(out + (n * Cv + c) * kWidth, acc);
  }
}

template <typename T, int kWidth>
void launch_direct(const void* feats, const void* idx, const void* w, void* out, int V, int P,
                   int64_t N, int64_t C, cudaStream_t stream) {
  // One row of threads per point, as wide as the row needs up to 128 (a
  // multiple of the warp), and as many points per block as fill 256 threads.
  const int64_t Cv = C / kWidth;
  const int64_t warps = (Cv + 31) / 32;
  const int bx = static_cast<int>(warps >= 4 ? 128 : 32 * warps);
  const int by = kThreadsPerBlock / bx;
  const dim3 block(bx, by);
  const dim3 grid(static_cast<unsigned>((N + by - 1) / by));
  fused_weighted_interp_kernel<T, kWidth><<<grid, block, 0, stream>>>(
      static_cast<const typename Chunk<T, kWidth>::Raw*>(feats), static_cast<const int4*>(idx),
      static_cast<const float4*>(w), static_cast<float*>(out), V, P, N, Cv);
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

// K 16-byte chunks per staged row, each kPer = 16 / sizeof(T) channels:
// slices of K * kPer channels. The (V*P, K) chunk slice lives in dynamic
// shared memory. Block b stages slice b % slices and sums the points of
// range b / slices, one of `splits` equal ranges of [0, N): the blocks of
// all slices walk the same points at the same time, so each point's taps
// come from L2 after the first read, and its output row is written whole
// while it is in L2.
template <typename T, int K>
__global__ void __launch_bounds__(kSliceThreads, 1)
fused_interp_slice_kernel(const T* __restrict__ feats, const int4* __restrict__ idx,
                          const float4* __restrict__ w, float* __restrict__ out, int V, int P,
                          int64_t N, int64_t C, int splits) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // channels per chunk
  using Ch = Chunk<T, kPer>;
  using Raw = typename Ch::Raw;
  // one shared array type for every instantiation, read as chunks
  extern __shared__ uint4 smem[];
  Raw* table = reinterpret_cast<Raw*>(smem);
  constexpr int kSlice = kPer * K;  // channels per slice
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
  const int64_t left = (C - c0) / kPer;  // chunks left: the last slice may be ragged
  const int kv = left < K ? static_cast<int>(left) : K;

  for (int e = threadIdx.x; e < rows * K; e += kSliceThreads) {
    const int r = e / K, c = e % K;
    if (c < kv) {
      cp_async16(table + e, feats + static_cast<int64_t>(r) * C + c0 + kPer * c);
    } else {
      table[e] = Raw{};  // past the last channel: read, summed, never written out
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  int chunk_of[K];  // acc[k] sums chunk (k + rot) % K
#pragma unroll
  for (int k = 0; k < K; ++k) chunk_of[k] = (k + rot) & (K - 1);

  for (int64_t n = n0 + threadIdx.x / kLanesPerPoint; n < n1; n += kPointsPerPass) {
    float acc[K][kPer];  // acc[k]: chunk (k + rot) % K of the slice
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[k][j] = 0.f;
    }
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
          w4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
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
          const float wt = in ? tap_weight<T>(pick(w4[c], t)) : 0.f;
          const Raw* __restrict__ r = table + (view_row + (in ? i : 0)) * K;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float f[kPer];
            Ch::widen(r[chunk_of[k]], f);
#pragma unroll
            for (int j = 0; j < kPer; ++j) acc[k][j] += wt * f[j];
          }
        }
      }
    }
    // sum the two lanes' taps, then write the point's slice: at step m
    // lane tg writes chunk 2m + tg, so the two lanes write whole 32-byte
    // sectors
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[k][j] += __shfl_xor_sync(pair_mask, acc[k][j], 1);
    }
    float* __restrict__ dst = out + n * C + c0;
#pragma unroll
    for (int m = 0; m < (K + 1) / 2; ++m) {
      const int chunk = 2 * m + tg;
      const int from = (chunk - rot) & (K - 1);  // the acc[k] that holds it
      float v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = acc[0][j];
#pragma unroll
      for (int k = 1; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[j] = from == k ? acc[k][j] : v[j];
      }
      if (chunk < K && chunk < kv) {
        float4* d4 = reinterpret_cast<float4*>(dst + chunk * kPer);
#pragma unroll
        for (int q = 0; q < kPer / 4; ++q) {
          __stcs(d4 + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
        }
      }
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

template <typename T, int K>
cudaError_t launch_slices(const void* feats, const void* idx, const void* w, void* out, int V,
                          int P, int64_t N, int64_t C, cudaStream_t stream) {
  constexpr int kSlice = K * 16 / static_cast<int>(sizeof(T));
  const size_t smem = static_cast<size_t>(V) * P * K * 16;
  int64_t resident = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(fused_interp_slice_kernel<T, K>), smem, &resident);
  if (err != cudaSuccess) return err;
  // as many point ranges as let every slice's blocks fill the card once
  const int64_t slices = (C + kSlice - 1) / kSlice;
  int64_t splits = resident / slices;
  splits = splits < 1 ? 1 : splits > N ? N : splits;
  const auto blocks = static_cast<unsigned>(slices * splits);
  fused_interp_slice_kernel<T, K><<<blocks, kSliceThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const int4*>(idx),
      static_cast<const float4*>(w), static_cast<float*>(out), V, P, N, C,
      static_cast<int>(splits));
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

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
      return static_cast<int>(launch_slices<float, 4>(feats, idx, w, out, v, p, N, C, s));
    case 8:
      return static_cast<int>(launch_slices<float, 2>(feats, idx, w, out, v, p, N, C, s));
    case 0:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C % 4 == 0 && aligned(feats, 16) && aligned(out, 16)) {
    launch_direct<float, 4>(feats, idx, w, out, v, p, N, C, s);
  } else {
    launch_direct<float, 1>(feats, idx, w, out, v, p, N, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16-table route: feats (V, P, C) bf16, the rest as above. 32 or 16
// takes the shared-memory route with slices of that many channels (then
// C % 8 == 0, feats is 16-byte aligned and V*P*slice_channels*2 bytes fit
// in one block's shared memory), 0 the direct route (8-byte loads of 4
// bf16 where C % 4 == 0 and feats is 8-byte aligned, else one at a time).
extern "C" int d3f_fused_weighted_interp_bf16(const void* feats, const void* idx, const void* w,
                                              void* out, int64_t V, int64_t P, int64_t N,
                                              int64_t C, int64_t slice_channels, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int v = static_cast<int>(V), p = static_cast<int>(P);
  switch (slice_channels) {
    case 32:
      return static_cast<int>(launch_slices<__nv_bfloat16, 4>(feats, idx, w, out, v, p, N, C, s));
    case 16:
      return static_cast<int>(launch_slices<__nv_bfloat16, 2>(feats, idx, w, out, v, p, N, C, s));
    case 0:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C % 4 == 0 && aligned(feats, 8) && aligned(out, 16)) {
    launch_direct<__nv_bfloat16, 4>(feats, idx, w, out, v, p, N, C, s);
  } else {
    launch_direct<__nv_bfloat16, 1>(feats, idx, w, out, v, p, N, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}
