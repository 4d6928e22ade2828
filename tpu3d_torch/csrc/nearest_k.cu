// Exact radius-bounded nearest-k search, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/grouping.py::_nearest_k_pallas (as driven by
// nearest_k_windowed). For every center it returns the k nearest points
// nearest first, as d² and point id, ties to the lower id: the output is
// ordered by the pair (d², id). Points at d² >= r2max never enter the list,
// so slots past the in-radius neighbours hold d² = +inf and id N (never a
// ball-query hit); with `xyz` it also writes each slot's coordinates (0 in
// the padded slots), as the TPU kernel's with_coords does. Unlike the TPU
// kernel this search is exact: no lane collisions.
//
// d² is (cx-px)²+(cy-py)²+(cz-pz)² rounded step by step in f32 (the
// __f*_rn intrinsics; the build passes -fmad=false), never the
// |u|²+|k|²-2u·k form: coordinates reach 70 m and radii are 0.1 m.
//
// Bound on the card: a brute sweep does M·N distance evaluations of 9 f32
// operations each (0.6 G per scene at the RPN SA_0 shape, 4096 × 16384,
// about 9 us at 67 TFLOP/s); the bytes are tiny. The windowed form does
// only the evaluations inside the centers' depth windows (about 1.4% of
// them at SA_0 of the planted-cluster scenes), so its time is set by
// latency and by the depth sort, not by either bound.
//
// Two forms, one entry, the same result to the bit; ops/grouping.py picks
// the form (nearest_k_route). A warp serves each center in both:
//
// - windowed (zs and order given): the wrapper sorts each scene's points by
//   depth z (a stable torch.sort, ids as the payload: zs, order). The
//   centers are not sorted. Each center's warp finds its own window [lo, hi)
//   of sorted positions by a 33-ary search over zs, then sweeps only the
//   window, reading the points through `order`.
//   Why the window loses no hit, without a guessed margin: the search uses
//   the sweep's own rounded predicate, fl(fl(cz - pz)²) < r2max. Rounding
//   is monotone, so fl(cz - pz) is monotone in pz and its rounded square is
//   monotone in pz on each side of cz: the positions that pass form one
//   contiguous run of the sorted points, [lo, hi). And every kept point
//   passes: its d² is fl(A + fl(dz²)) with A = fl(fl(dx²) + fl(dy²)) >= 0,
//   so fl(dz²) <= d² < r2max, again by monotone rounding. lo is the first
//   position that is not "below" (pz < cz and fl(dz²) >= r2max, a prefix of
//   the sorted order) and hi the first that is "above" (not pz <= cz, and
//   fl(dz²) >= r2max not false: a suffix, NaN depths last, as torch.sort
//   puts them);
// - brute (zs and order null): a block's centers share one scene, whose
//   points are staged through shared memory in tiles of kTile (a pooled ROI
//   of the RCNN, 512 points, is one tile) and swept in full.
//
// Design: a warp serves one center (4 centers per 128-thread block), so
// small levels still fill the 132 SMs (the first form ran one thread per
// center: 64 blocks of 4 warps at SA_0) and each center's chain of
// dependent loads is short (a warp was the fastest team of 4-32 lanes, or
// within 0.01 ms of it, at every level shape swept; PERF.md). The lanes
// stride the points; each in-radius point that comes before the threshold
// (below) is appended by ballot to the center's hit list in shared memory,
// k + kSlack entries. When a round of hits would overflow it, the list is
// compacted in place to its k first entries by (d², id), found by counting
// ranks, and the k-th of them becomes the threshold: a later point must
// come before it to enter. At the end each entry's rank (the number of
// entries before it by (d², id)) is its output slot if it is below k. The
// order is the pair, never the sweep's arrival order, so the depth order of
// the windowed sweep and the lane interleaving of both forms cannot change
// a tie. Nothing is inserted into a sorted register list: the RCNN's k = 64
// costs registers only for the few hits a center has.

#include <cuda_runtime.h>
#include <math.h>

#include "launch_check.cuh"

namespace {

constexpr int kThreads = 128;  // a block: one scene's kThreads / 32 centers
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;    // brute form: points staged per tile
constexpr int kSlack = 32;     // a list holds k + kSlack >= k + 32 hits
constexpr unsigned kAll = 0xffffffffu;
constexpr int kUnroll = 4;     // windowed rounds whose loads are in flight at once

__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float depth2(float cz, float pz) {
  const float dz = __fsub_rn(cz, pz);
  return __fmul_rn(dz, dz);
}

// (da, ia) comes before (db, ib) in the output: d² first, then the id
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// This lane of the center's warp, and the mask of the lanes below it.
struct Lane {
  int lane;
  unsigned lower;

  __device__ Lane() : lane(threadIdx.x & 31), lower((1u << lane) - 1u) {}
};

// A center's hits in shared memory; n, thr_d and thr_i are warp-uniform.
struct List {
  float* d;
  int* id;
  int n, k, cap;
  float thr_d;  // a hit must come before (thr_d, thr_i) to enter: the k-th
  int thr_i;    // entry after the last compaction
};

// The rank of (d, id) among the list's entries: how many come before it.
__device__ __forceinline__ int rank_of(const List& L, float d, int id) {
  int r = 0;
  for (int j = 0; j < L.n; ++j) r += before(L.d[j], L.id[j], d, id);
  return r;
}

// Keeps the list's k first entries by (d², id), in place and in their
// order, and makes the k-th the threshold. Called with n > k entries.
__device__ void compact(List& L, const Lane& t) {
  __syncwarp();
  float kd = 0.0f;
  int ki = 0;
  bool mine = false;
  for (int e = t.lane; e < L.n; e += 32) {
    if (rank_of(L, L.d[e], L.id[e]) == L.k - 1) {  // ids are distinct
      kd = L.d[e];
      ki = L.id[e];
      mine = true;
    }
  }
  const int src = __ffs(__ballot_sync(kAll, mine)) - 1;
  kd = __shfl_sync(kAll, kd, src);
  ki = __shfl_sync(kAll, ki, src);
  // a lane writes at or below the slot it read, after the warp's reads of
  // this round, so no entry is overwritten before it is read
  int w = 0;
  for (int base = 0; base < L.n; base += 32) {
    const int e = base + t.lane;
    const bool live = e < L.n;
    const float d = live ? L.d[e] : 0.0f;
    const int id = live ? L.id[e] : 0;
    const bool keep = live && !before(kd, ki, d, id);
    const unsigned bits = __ballot_sync(kAll, keep);
    __syncwarp();
    if (keep) {
      const int pos = w + __popc(bits & t.lower);
      L.d[pos] = d;
      L.id[pos] = id;
    }
    w += __popc(bits);
    __syncwarp();
  }
  L.n = L.k;
  L.thr_d = kd;
  L.thr_i = ki;
}

// One round: each lane's point enters the list if it is a hit and comes
// before the threshold, at the slot its lower lanes' hits leave it.
__device__ __forceinline__ void offer(List& L, const Lane& t, bool hit,
                                      float d, int id) {
  bool keep = hit && before(d, id, L.thr_d, L.thr_i);
  unsigned bits = __ballot_sync(kAll, keep);
  if (bits == 0) return;
  if (L.n + __popc(bits) > L.cap) {
    compact(L, t);
    keep = keep && before(d, id, L.thr_d, L.thr_i);
    bits = __ballot_sync(kAll, keep);
  }
  if (keep) {
    const int pos = L.n + __popc(bits & t.lower);
    L.d[pos] = d;
    L.id[pos] = id;
  }
  L.n += __popc(bits);
}

// Writes the center's k slots: each entry at its rank, if below k; the
// slots past the hits hold (+inf, N) and coordinates 0.
__device__ void emit(List& L, const Lane& t, const float* p, int N,
                     float* od, int* oi, float* oxyz) {
  __syncwarp();
  for (int e = t.lane; e < L.n; e += 32) {
    const float d = L.d[e];
    const int id = L.id[e];
    const int r = rank_of(L, d, id);
    if (r < L.k) {
      od[r] = d;
      oi[r] = id;
      if (oxyz) {
        oxyz[3 * r] = p[(size_t)3 * id];
        oxyz[3 * r + 1] = p[(size_t)3 * id + 1];
        oxyz[3 * r + 2] = p[(size_t)3 * id + 2];
      }
    }
  }
  for (int s = min(L.n, L.k) + t.lane; s < L.k; s += 32) {
    od[s] = INFINITY;
    oi[s] = N;
    if (oxyz) oxyz[3 * s] = oxyz[3 * s + 1] = oxyz[3 * s + 2] = 0.0f;
  }
}

// The center's window [lo, hi) of depth-sorted positions: two 33-ary
// searches, interleaved, for the first position that is not "below" and
// the first that is "above" (see the header). Each round the 32 lanes test
// 32 points spread over the open range [a, b); the points that pass form a
// prefix of the lanes, so their count narrows the range.
__device__ void window(const Lane& t, const float* zs, int N, float cz,
                       float r2max, int& lo, int& hi) {
  constexpr int parts = 33;
  int a0 = 0, b0 = N, a1 = 0, b1 = N;
  while (a0 < b0 || a1 < b1) {
    const long long s0 = b0 - a0, s1 = b1 - a1;
    const int q0 = a0 + (int)(s0 * (t.lane + 1) / parts);
    const int q1 = a1 + (int)(s1 * (t.lane + 1) / parts);
    bool below = false, not_above = false;
    if (a0 < b0) {
      const float z = zs[q0];
      below = z < cz && !(depth2(cz, z) < r2max);
    }
    if (a1 < b1) {
      const float z = zs[q1];
      not_above = z <= cz || depth2(cz, z) < r2max;
    }
    const int c0 = __popc(__ballot_sync(kAll, below));
    const int c1 = __popc(__ballot_sync(kAll, not_above));
    if (a0 < b0) {
      const int na = c0 > 0 ? a0 + (int)(s0 * c0 / parts) + 1 : a0;
      b0 = c0 < 32 ? a0 + (int)(s0 * (c0 + 1) / parts) : b0;
      a0 = na;
    }
    if (a1 < b1) {
      const int na = c1 > 0 ? a1 + (int)(s1 * c1 / parts) + 1 : a1;
      b1 = c1 < 32 ? a1 + (int)(s1 * (c1 + 1) / parts) : b1;
      a1 = na;
    }
  }
  lo = a0;
  hi = a1;
}

template <bool kWindow>
__global__ void __launch_bounds__(kThreads)
nearest_k_kernel(const float* __restrict__ centers,
                 const float* __restrict__ pts, const float* __restrict__ zs,
                 const long long* __restrict__ order, int M, int N, int k,
                 float r2max, float* __restrict__ out_d,
                 int* __restrict__ out_i, float* __restrict__ out_xyz) {
  extern __shared__ float smem[];
  const Lane t;
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kWarps + warp;
  const bool live = m < M;
  const int stride = k + kSlack + 1;  // odd: warps' lists start on
                                      // different banks
  float* lists = smem + (kWindow ? 0 : 3 * min(N, kTile));
  List L;
  L.d = lists + warp * stride;
  L.id = reinterpret_cast<int*>(lists + kWarps * stride) + warp * stride;
  L.n = 0;
  L.k = k;
  L.cap = k + kSlack;
  L.thr_d = INFINITY;
  L.thr_i = 0x7fffffff;

  const float* c = centers + ((size_t)b * M + (live ? m : 0)) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  const float* p = pts + (size_t)b * N * 3;

  if (kWindow) {
    if (!live) return;  // no block-wide barrier in this form
    const float* z = zs + (size_t)b * N;
    const long long* o = order + (size_t)b * N;
    int lo, hi;
    window(t, z, N, cz, r2max, lo, hi);
    for (int base = lo; base < hi; base += 32 * kUnroll) {
      int id[kUnroll];
      float pz[kUnroll];
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = base + u * 32 + t.lane;
        in[u] = s < hi;
        id[u] = in[u] ? (int)o[s] : 0;
        pz[u] = in[u] ? z[s] : 0.0f;
      }
      float px[kUnroll], py[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        px[u] = in[u] ? p[(size_t)3 * id[u]] : 0.0f;
        py[u] = in[u] ? p[(size_t)3 * id[u] + 1] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float d = dist2(cx, cy, cz, px[u], py[u], pz[u]);
        offer(L, t, in[u] && d < r2max, d, id[u]);
      }
    }
  } else {
    float* sx = smem;
    float* sy = sx + min(N, kTile);
    float* sz = sy + min(N, kTile);
    for (int t0 = 0; t0 < N; t0 += kTile) {
      const int cnt = min(kTile, N - t0);
      for (int s = threadIdx.x; s < cnt; s += kThreads) {
        const size_t q = (size_t)3 * (t0 + s);
        sx[s] = p[q];
        sy[s] = p[q + 1];
        sz[s] = p[q + 2];
      }
      __syncthreads();
      if (live) {
        for (int base = 0; base < cnt; base += 32) {
          const int s = base + t.lane;
          const bool in = s < cnt;
          const float d = in ? dist2(cx, cy, cz, sx[s], sy[s], sz[s]) : 0.0f;
          offer(L, t, in && d < r2max, d, t0 + s);
        }
      }
      __syncthreads();
    }
    if (!live) return;
  }
  const size_t row = (size_t)b * M + m;
  emit(L, t, p, N, out_d + row * k, out_i + row * k,
       out_xyz ? out_xyz + row * k * 3 : nullptr);
}

}  // namespace

extern "C" int tpu3d_nearest_k(const float* centers, const float* pts,
                               const float* zs, const long long* order, int B,
                               int M, int N, int k, float r2max, float* d2,
                               int* idx, float* xyz, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || B > 65535 || M < 1 || N < 1 || k < 1 || k > 64 ||
      (zs == nullptr) != (order == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  const size_t lists = (size_t)2 * kWarps * (k + kSlack + 1) * sizeof(float);
  if (zs != nullptr)
    nearest_k_kernel<true><<<grid, kThreads, lists, stream>>>(
        centers, pts, zs, order, M, N, k, r2max, d2, idx, xyz);
  else
    nearest_k_kernel<false>
        <<<grid, kThreads, lists + 3 * min(N, kTile) * sizeof(float),
           stream>>>(centers, pts, zs, order, M, N, k, r2max, d2, idx, xyz);
  return (int)cudaGetLastError();
}
