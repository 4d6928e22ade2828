// The inverse of an id table, and a fixed-order sum of rows over it, for
// Hopper (sm_90a). Shared by the backward kernels that must add many rows
// into one destination row and give the same bits on every call:
// three_interpolate_bwd.cu (3 entries per query), group_points_bwd.cu and
// the gather form of fused_sa_bwd.cu (S entries per group).
//
// An id table idx (B, M, per) names, for each entry k = m·per + j of scene
// b, a source row idx[b, m, j] in [0, N). build_kernel writes a CSR inverse:
// off[b·N + n] the first of source n's entries (global), and keys, each
// list's in-scene keys. Block (s, b) owns scene b's sources of slice s (a
// thread each) and reads all the scene's ids twice: it counts its sources'
// entries and the scene's entries below the slice in shared memory, scans
// the counts into offsets, and fills the lists through shared-memory
// cursors, so a list's order is that of the atomics; the slice's lists go
// to shared memory and out in whole lines when they fit (kStage keys),
// since 4-byte stores scattered over device memory cost several times the
// rest of the build. A list longer than kSortMax (a repeated point, or a
// source that many queries share) is then put in ascending order through a
// bitmap of the scene's per·M keys. A shorter list is sorted by the warp
// that reads it (warp_sort), so every list is read in ascending key order.
//
// sum_rows_kernel then gives each destination row the sequential f32 sum,
// from +0.0, of the rows its keys map to, in ascending key order: one warp
// per (source, 32·V Vecs of the row), sources in scene order. The order is
// that of the plain versions' index_add_ on the CPU, which adds in source
// order, so the result is the same bits on every call, and the CPU's.

#pragma once

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

namespace csr {
// Internal linkage for all of it: each kernel library that includes the
// header keeps its own kernels and its own record of the shared memory
// granted (a function-local static of an inline function would be one
// object across every loaded library).
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBuildThreads = 1024;
constexpr int kSlice = kBuildThreads;  // sources per build block, a thread each
constexpr int kAhead = 8;     // ids a build thread loads at once
constexpr int kSortMax = 128;  // longer lists are sorted by the build
constexpr int kStage = 24576;  // keys of a slice's lists staged in shared
constexpr int kGatherThreads = 256;
// the build's static shared memory, and the most the stage or its bitmap
// may add
constexpr int kBuildStatic = 2 * kSlice * 4 + 32 * 4;
constexpr int kMaxSmem = 232448;

// Exclusive scan of v over the block (at most 32 warps); `sums` holds 32
// ints of shared memory. Every thread of the block must call it.
__device__ int block_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  total = sums[warps - 1];
  const int before = warp == 0 ? 0 : sums[warp - 1];
  __syncthreads();  // the next call may write sums again
  return before + x - v;
}

// Block (s, b): the lists of scene b's sources [lo, hi), lo = s·kSlice, of
// the table's E = per·M entries. off[b·N + n] = the first entry of source
// n's list (global), and keys = each list's in-scene keys m·per + j: in
// the order of the shared-memory atomics, except a list longer than
// kSortMax, which leaves in ascending order (a bitmap of the scene's E
// keys, read back word by word).
__global__ void __launch_bounds__(kBuildThreads)
build_kernel(const int* __restrict__ idx, int B, int N, int M, int per,
             int* __restrict__ off, int* __restrict__ keys) {
  extern __shared__ int stage[];  // the slice's lists, then the bitmap
  unsigned* bits = reinterpret_cast<unsigned*>(stage);
  __shared__ int cur[kSlice];     // counts, then cursors
  __shared__ int sums[32];
  __shared__ int long_src[kSlice];    // the slice's long lists
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lo = blockIdx.x * kSlice, hi = min(N, lo + kSlice);
  const int E = per * M;
  const int* ib = idx + (size_t)b * E;
  cur[tid] = 0;
  __syncthreads();

  // counts of the slice's sources, and the scene's entries below the slice
  int below = 0;
  for (int base = 0; base < E; base += kBuildThreads * kAhead) {
    int src[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int e = base + kBuildThreads * a + tid;
      src[a] = e < E ? ib[e] : INT_MAX;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      below += src[a] < lo;
      if (src[a] >= lo && src[a] < hi) atomicAdd(&cur[src[a] - lo], 1);
    }
  }
  __syncthreads();

  // offsets (a thread per source of the slice) and the long lists
  int n_below, n_slice, unused, n_long;
  block_scan(below, sums, n_below);
  const int n = lo + tid;
  const int count = n < hi ? cur[tid] : 0;
  const int region = b * E + n_below;  // the slice's lists start here
  const int first = region + block_scan(count, sums, n_slice);
  const bool is_long = count > kSortMax;
  const int long_at = block_scan(is_long, sums, n_long);
  if (n < hi) off[(size_t)b * N + n] = first;
  if (is_long) long_src[long_at] = tid;
  if (tid == 0 && b == B - 1 && hi == N) off[(size_t)B * N] = B * E;
  cur[tid] = first;
  __syncthreads();

  // the fill: into shared memory when the slice's lists fit there, then
  // copied out whole (scattered 4-byte stores to device memory cost far
  // more), else straight to device memory
  const bool staged = n_slice <= kStage;  // the block's every thread agrees
  for (int base = 0; base < E; base += kBuildThreads * kAhead) {
    int src[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int e = base + kBuildThreads * a + tid;
      src[a] = e < E ? ib[e] : INT_MAX;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (src[a] < lo || src[a] >= hi) continue;
      const int pos = atomicAdd(&cur[src[a] - lo], 1);
      const int e = base + kBuildThreads * a + tid;
      if (staged)
        stage[pos - region] = e;
      else
        keys[pos] = e;
    }
  }
  __syncthreads();  // every key of the fill is written
  if (staged)
    for (int i = tid; i < n_slice; i += kBuildThreads)
      keys[region + i] = stage[i];
  if (n_long == 0) return;  // the block's every thread agrees

  // the long lists, one at a time, in ascending key order
  const int words = (E + 31) / 32;
  const int wper = (words + kBuildThreads - 1) / kBuildThreads;
  const int w0 = min(words, tid * wper), w1 = min(words, w0 + wper);
  __syncthreads();  // the copy is out: the bitmap reuses the stage
  for (int i = 0; i < n_long; ++i) {
    const int t = long_src[i];
    const int from = off[(size_t)b * N + lo + t], end = cur[t];
    for (int w = tid; w < words; w += kBuildThreads) bits[w] = 0u;
    __syncthreads();
    for (int e = from + tid; e < end; e += kBuildThreads) {
      const int k = keys[e];
      atomicOr(&bits[k >> 5], 1u << (k & 31));
    }
    __syncthreads();
    int c = 0;
    for (int w = w0; w < w1; ++w) c += __popc(bits[w]);
    int pos = from + block_scan(c, sums, unused);
    for (int w = w0; w < w1; ++w) {
      for (unsigned m = bits[w]; m; m &= m - 1) keys[pos++] = w * 32 + __ffs(m) - 1;
    }
    __syncthreads();  // every bit read before the next list clears them
  }
}

// The build's dynamic shared memory for E = per·M entries a scene: the
// stage, or the bitmap of the scene's keys if larger; 0 where it does not
// fit the card.
inline size_t build_smem(long long E) {
  const size_t smem = sizeof(int) * (size_t)std::max<long long>(
      kStage, (E + 31) / 32);
  return kBuildStatic + smem > (size_t)kMaxSmem ? 0 : smem;
}

// Ints of the inverse: offsets (B·N + 1), then the lists' keys (B·E).
inline long long inverse_ints(int B, int N, long long E) {
  return (long long)B * N + 1 + (long long)B * E;
}

// Launch the build into workspace = [off | keys]; the caller checked the
// sizes (build_smem, inverse_ints, B·E < INT_MAX).
inline cudaError_t build(const int* idx, int B, int N, int M, int per,
                         int* workspace, cudaStream_t stream) {
  const size_t smem = build_smem((long long)per * M);
  // above 48 KB of shared memory in all a kernel must ask for it; the
  // largest size asked for so far stands
  static size_t smem_granted = 0;
  if (smem > smem_granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_granted = smem;
  }
  const dim3 grid((N + kSlice - 1) / kSlice, B);
  build_kernel<<<grid, kBuildThreads, smem, stream>>>(
      idx, B, N, M, per, workspace, workspace + (size_t)B * N + 1);
  return cudaGetLastError();
}

// Ascending bitonic sort of 32·K ints, element r·32 + lane in v[r] of
// lane `lane`: partners within a register through shuffles, across
// registers within the lane.
template <int K>
__device__ __forceinline__ void warp_sort(int (&v)[K], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * K; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int q = r ^ (j >> 5);
          if (q > r) {
            const bool up = ((r * 32 + lane) & k) == 0;
            const int a = min(v[r], v[q]), z = max(v[r], v[q]);
            v[r] = up ? a : z;
            v[q] = up ? z : a;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int o = __shfl_xor_sync(kFull, v[r], j);
          const int e = r * 32 + lane;
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          v[r] = keep_min ? min(v[r], o) : max(v[r], o);
        }
      }
    }
  }
}

__device__ __forceinline__ void add_to(float& acc, float x) {
  acc = __fadd_rn(acc, x);
}

__device__ __forceinline__ void add_to(float4& acc, float4 x) {
  add_to(acc.x, x.x);
  add_to(acc.y, x.y);
  add_to(acc.z, x.z);
  add_to(acc.w, x.w);
}

template <typename Vec>
__device__ __forceinline__ Vec zero_vec();
template <>
__device__ __forceinline__ float zero_vec<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero_vec<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Adds the rows that `cnt` keys (one per lane, ascending in lane order)
// map to into acc: lane l's Vecs c0 + l + 32·v of each row. map(b, key)
// gives the row (in Vecs of `width` a row, from `rows`), or -1 for a key
// that adds nothing.
template <typename Vec, int V, typename Map>
__device__ __forceinline__ void add_mapped(Vec (&acc)[V], const Vec* rows,
                                           int width, int c0, int b, int key,
                                           int cnt, int lane, const Map& map) {
  const long long row = lane < cnt ? map(b, key) : -1;
  unsigned live = __ballot_sync(kFull, row >= 0);
  while (live) {
    const int t = __ffs(live) - 1;
    live &= live - 1;
    const long long r = __shfl_sync(kFull, row, t);
    const Vec* x = rows + r * width + c0 + lane;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (c0 + lane + 32 * v < width) add_to(acc[v], __ldg(x + 32 * v));
  }
}

// a list of up to 32·K keys: loaded K per lane, sorted, summed
template <typename Vec, int V, int K, typename Map>
__device__ __forceinline__ void add_short_list(Vec (&acc)[V], const Vec* rows,
                                               int width, int c0, int b,
                                               const int* list, int L,
                                               int lane, const Map& map) {
  int key[K];
#pragma unroll
  for (int r = 0; r < K; ++r)
    key[r] = r * 32 + lane < L ? list[r * 32 + lane] : INT_MAX;
  warp_sort<K>(key, lane);
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (r * 32 < L)
      add_mapped<Vec, V>(acc, rows, width, c0, b, key[r],
                         min(32, L - r * 32), lane, map);
}

// One warp per (source, chunk of 32·V Vecs of its row), sources in scene
// order: out[src] = the sum of the rows its keys map to, in ascending key
// order, every element written. Vec is float4 when the rows are 16-byte
// aligned (width in Vecs), else float.
template <typename Vec, int V, typename Map>
__global__ void __launch_bounds__(kGatherThreads)
sum_rows_kernel(const float* __restrict__ rows, int B, int N, int width,
                const int* __restrict__ off, const int* __restrict__ keys,
                float* __restrict__ out, Map map) {
  const int lane = threadIdx.x & 31;
  const int chunks = (width + 32 * V - 1) / (32 * V);
  const long long gw = (long long)blockIdx.x * (kGatherThreads / 32) +
                       (threadIdx.x >> 5);
  if (gw >= (long long)B * N * chunks) return;
  const long long src = gw / chunks;
  const int c0 = (int)(gw % chunks) * 32 * V;
  const int b = (int)(src / N);
  const int lo = off[src], L = off[src + 1] - lo;
  const Vec* rv = reinterpret_cast<const Vec*>(rows);
  Vec acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = zero_vec<Vec>();
  if (L <= 32) {
    add_short_list<Vec, V, 1>(acc, rv, width, c0, b, keys + lo, L, lane, map);
  } else if (L <= 64) {
    add_short_list<Vec, V, 2>(acc, rv, width, c0, b, keys + lo, L, lane, map);
  } else if (L <= kSortMax) {
    add_short_list<Vec, V, 4>(acc, rv, width, c0, b, keys + lo, L, lane, map);
  } else {
    for (int base = 0; base < L; base += 32) {
      const int cnt = min(32, L - base);
      add_mapped<Vec, V>(acc, rv, width, c0, b,
                         lane < cnt ? keys[lo + base + lane] : 0, cnt, lane,
                         map);
    }
  }
  Vec* o = reinterpret_cast<Vec*>(out) + (size_t)src * width + c0;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (c0 + lane + 32 * v < width) o[lane + 32 * v] = acc[v];
}

// Launch sum_rows_kernel over an inverse built by `build`: float4 rows
// when C % 4 == 0 and both pointers are 16-byte aligned, else floats.
template <typename Map>
cudaError_t sum_rows(const float* rows, int B, int N, int C,
                     const int* workspace, float* out, const Map& map,
                     cudaStream_t stream) {
  const int* off = workspace;
  const int* keys = workspace + (size_t)B * N + 1;
  const bool vec = C % 4 == 0 && reinterpret_cast<size_t>(rows) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  const int width = vec ? C / 4 : C;
  const int V = vec ? 2 : 8;  // 256 channels a warp
  const long long chunks = (width + 32 * V - 1) / (32 * V);
  const long long warps = (long long)B * N * chunks;
  const unsigned blocks =
      (unsigned)((warps + kGatherThreads / 32 - 1) / (kGatherThreads / 32));
  if (vec)
    sum_rows_kernel<float4, 2><<<blocks, kGatherThreads, 0, stream>>>(
        rows, B, N, width, off, keys, out, map);
  else
    sum_rows_kernel<float, 8><<<blocks, kGatherThreads, 0, stream>>>(
        rows, B, N, width, off, keys, out, map);
  return cudaGetLastError();
}

}  // namespace
}  // namespace csr
