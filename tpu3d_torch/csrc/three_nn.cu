// Exact 3 nearest known points of every query, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/interpolate.py::_three_nn_pallas. Same function: for
// each of the M queries of a scene, the 3 nearest of its N known points as
// (d², index), nearest first, ties to the lowest index. d² is
// (ux-kx)²+(uy-ky)²+(uz-kz)², query minus known, rounded step by step in f32
// (the __f*_rn intrinsics, and the build passes -fmad=false), exactly as the
// plain version rounds it: one rounding difference can swap two neighbours.
// The output is ordered by the pair (d², index), so it does not depend on
// the order in which a form meets the known points.
//
// Bound on the card: a brute sweep does M·N pairs of 8 float operations and
// a compare (about 0.29 ms at the split route's 16 x 32768 x 4096, 67
// TFLOP/s f32); the bytes are a few MB. With this rounding a pair costs
// some 21 instructions (no FMA: 8 rounded operations, 3 compares, 5
// min/max, 5 selects), so no brute sweep comes near that bound: the lever
// is fewer pairs. Two forms, one entry, the same result to the bit;
// ops/interpolate.py picks the form (three_nn_route):
//
// - windowed (order given): the wrapper sorts each scene's known points by
//   depth z (a stable torch.sort, ids as the payload), and pack_known writes
//   them in that order as (x, y, z, id) float4s. Each query finds its own
//   depth's position in the sorted order (the first known point whose z is
//   not below the query's) by a binary search and widens from there both
//   ways, taking next the side whose depth term fl(fl(uz - kz)²) is smaller.
//   A side stops at the first position whose depth term is strictly greater
//   than the query's current third d² (+inf until three points are held).
//   Why no point past a stop can enter: on each side of the query's
//   position uz - kz keeps its sign and grows in magnitude, so by monotone
//   rounding the depth term never falls along a side; and a point's d² is
//   fl(A + t) with A = fl(fl(dx²) + fl(dy²)) >= 0 and t its depth term, so
//   d² >= t > the third d², which only falls. An equal term can still give
//   an equal d² at a lower id, so the stop is not >=. Up to kStageMax
//   known points, each block stages its scene's sorted points in shared
//   memory (16 bytes a point); above it, it reads them from global memory;
// - brute (order null): one thread per query sweeps all N known points,
//   staged through shared memory in tiles of kTile, in ascending index.
//
// Both forms fold a point into a sorted top-3 in registers in the (d²,
// index) order: the brute form's ascending index makes that the
// branch-free strict-< network of the TPU kernel (a pair compare with an
// early exit was slower at the 16-64-point levels, which are bound by
// latency), the windowed form's depth order needs the pair. The TPU
// kernel's lane-parallel sweep and its three-step final selection exist
// because a TPU vector unit has no per-lane scalar state; one thread per
// query needs neither.

#include <cuda_runtime.h>
#include <math.h>

#include "launch_check.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
// the windowed form stages a scene's sorted points in shared memory up to
// this many (64 KB), and reads them from global memory above it
constexpr int kStageMax = 4096;

__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float depth2(float uz, float kz) {
  const float dz = __fsub_rn(uz, kz);
  return __fmul_rn(dz, dz);
}

// (da, ia) comes before (db, ib) in the output: d² first, then the index
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// The windowed form's 3 nearest so far, sorted by (d², index); empty slots
// hold (+inf, INT_MAX), after every real point.
struct Top3 {
  float d1 = INFINITY, d2 = INFINITY, d3 = INFINITY;
  int i1 = 0x7fffffff, i2 = 0x7fffffff, i3 = 0x7fffffff;

  __device__ __forceinline__ void fold(float d, int id) {
    if (!before(d, id, d3, i3)) return;
    const bool c1 = before(d, id, d1, i1), c2 = before(d, id, d2, i2);
    d3 = c2 ? d2 : d;
    i3 = c2 ? i2 : id;
    d2 = c1 ? d1 : (c2 ? d : d2);
    i2 = c1 ? i1 : (c2 ? id : i2);
    d1 = c1 ? d : d1;
    i1 = c1 ? id : i1;
  }

  __device__ __forceinline__ void store(float* od, int* oi) const {
    od[0] = d1;
    od[1] = d2;
    od[2] = d3;
    oi[0] = i1;
    oi[1] = i2;
    oi[2] = i3;
  }
};

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ unknown,
                const float* __restrict__ known, int M, int N,
                float* __restrict__ out_d2, int* __restrict__ out_idx) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* u = unknown + (size_t)b * M * 3;
  const float* k = known + (size_t)b * N * 3;
  const bool live = i < M;
  const float ux = live ? u[(size_t)3 * i] : 0.0f;
  const float uy = live ? u[(size_t)3 * i + 1] : 0.0f;
  const float uz = live ? u[(size_t)3 * i + 2] : 0.0f;
  float d1 = INFINITY, d2 = INFINITY, d3 = INFINITY;
  int i1 = 0, i2 = 0, i3 = 0;
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int cnt = min(kTile, N - t0);
    for (int s = threadIdx.x; s < cnt; s += blockDim.x) {
      const size_t q = (size_t)3 * (t0 + s);
      sx[s] = k[q];
      sy[s] = k[q + 1];
      sz[s] = k[q + 2];
    }
    __syncthreads();
    // in ascending index, the strict-< network keeps the lower index on a
    // tie: the (d², index) order without a branch
    for (int s = 0; s < cnt; ++s) {
      const float m = dist2(ux, uy, uz, sx[s], sy[s], sz[s]);
      const int pos = t0 + s;
      const bool c1 = m < d1, c2 = m < d2, c3 = m < d3;
      const float y1 = fmaxf(d1, m);
      const float y2 = fmaxf(d2, y1);
      d3 = fminf(d3, y2);
      d2 = fminf(d2, y1);
      d1 = fminf(d1, m);
      const int i1n = c1 ? pos : i1;
      const int i2n = c2 ? (c1 ? i1 : pos) : i2;
      i3 = c3 ? (c2 ? i2 : pos) : i3;
      i2 = i2n;
      i1 = i1n;
    }
    __syncthreads();
  }
  if (live) {
    const size_t r = ((size_t)b * M + i) * 3;
    out_d2[r] = d1;
    out_d2[r + 1] = d2;
    out_d2[r + 2] = d3;
    out_idx[r] = i1;
    out_idx[r + 1] = i2;
    out_idx[r + 2] = i3;
  }
}

// The windowed form's index: each scene's known points in depth order as
// (x, y, z, id), the id's bits in w.
__global__ void pack_known(const float* __restrict__ known,
                           const long long* __restrict__ order, int N,
                           float4* __restrict__ sorted) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const int id = (int)order[(size_t)b * N + p];
  const float* k = known + ((size_t)b * N + id) * 3;
  sorted[(size_t)b * N + p] =
      make_float4(k[0], k[1], k[2], __int_as_float(id));
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
three_nn_window_kernel(const float* __restrict__ unknown,
                       const float4* __restrict__ sorted, int M, int N,
                       float* __restrict__ out_d2, int* __restrict__ out_idx) {
  extern __shared__ float4 staged[];
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const float4* k = sorted + (size_t)b * N;
  if constexpr (kStage) {
    for (int s = threadIdx.x; s < N; s += blockDim.x) staged[s] = k[s];
    __syncthreads();
    k = staged;
  }
  if (t >= M) return;
  const float* u = unknown + ((size_t)b * M + t) * 3;
  const float ux = u[0], uy = u[1], uz = u[2];
  // the first sorted position whose depth is not below the query's
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k[mid].z < uz)
      lo = mid + 1;
    else
      hi = mid;
  }
  // the next candidate on each side (dn going down, up going up), its
  // point and depth term, and whether the side is still open
  int dn = lo - 1, up = lo;
  bool od = dn >= 0, ou = up < N;
  float4 pd = od ? k[dn] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 pu = ou ? k[up] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float td = depth2(uz, pd.z), tu = depth2(uz, pu.z);
  Top3 top;
  while (true) {
    od = od && !(td > top.d3);
    ou = ou && !(tu > top.d3);
    if (!(od || ou)) break;
    const bool down = od && (!ou || td <= tu);
    const float4 p = down ? pd : pu;
    top.fold(dist2(ux, uy, uz, p.x, p.y, p.z), __float_as_int(p.w));
    const int next = down ? dn - 1 : up + 1;
    const bool in = next >= 0 && next < N;
    const float4 pn = in ? k[next] : p;
    const float tn = depth2(uz, pn.z);
    if (down) {
      dn = next;
      od = in;
      pd = pn;
      td = tn;
    } else {
      up = next;
      ou = in;
      pu = pn;
      tu = tn;
    }
  }
  const size_t r = ((size_t)b * M + t) * 3;
  top.store(out_d2 + r, out_idx + r);
}

}  // namespace

// unknown (B, M, 3), known (B, N, 3) -> d2, idx (B, M, 3). The windowed
// form takes order (B, N), each scene's known ids in depth order, and
// sorted, a (B, N) float4 workspace; the brute form takes both null.
extern "C" int tpu3d_three_nn(const float* unknown, const float* known,
                              const long long* order, int B, int M, int N,
                              float4* sorted, float* d2, int* idx,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || B > 65535 || M < 1 || N < 3 ||
      (order == nullptr) != (sorted == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  if (order == nullptr) {
    three_nn_kernel<<<grid, kThreads, 0, stream>>>(unknown, known, M, N, d2,
                                                   idx);
    return (int)cudaGetLastError();
  }
  pack_known<<<dim3((N + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
      known, order, N, sorted);
  if (N <= kStageMax) {
    const size_t smem = (size_t)N * sizeof(float4);
    const cudaError_t err = cudaFuncSetAttribute(
        three_nn_window_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    three_nn_window_kernel<true><<<grid, kThreads, smem, stream>>>(
        unknown, sorted, M, N, d2, idx);
  } else {
    three_nn_window_kernel<false><<<grid, kThreads, 0, stream>>>(
        unknown, sorted, M, N, d2, idx);
  }
  return (int)cudaGetLastError();
}
