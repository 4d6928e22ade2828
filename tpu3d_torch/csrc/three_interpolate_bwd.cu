// Backward of three-point interpolation, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/interpolate.py::_ti_bwd_kernel. For the forward
//   out[b, m, :] = sum_j w[b,m,j] F[b, idx[b,m,j], :]
// and the output gradient g (B, M, C) it gives
//   d_features[b, n, :] = sum over (m, j) with idx[b,m,j] = n of w[b,m,j] g[b,m,:]
//   d_weight[b, m, j]   = <F[b, idx[b,m,j], :], g[b,m,:]>   (when asked for)
// in f32. The TPU kernel accumulates each scene's (N, C) block in VMEM
// across the M tiles in a fixed order, with bf16 one-hot rows on the MXU.
//
// Bound on the card: bytes. It reads g once and writes d_features once,
// 1-2 operations per byte moved. Design: invert the ids, then gather, as
// the forward does, so that no float is ever added by an atomic and every
// d_features row is written once (no zeroing pass):
//   1. build: a CSR inverse of the ids, each source's list of flat keys
//      k = m·3 + j. Block (s, b) owns scene b's sources of slice s (a
//      thread each) and reads all the scene's ids twice: it counts its
//      sources' entries and the scene's entries below the slice in shared
//      memory, scans the counts into offsets, and fills the lists through
//      shared-memory cursors, so a list's order is that of the atomics;
//      the slice's lists go to shared memory and out in whole lines when
//      they fit (kStage keys), since 4-byte stores scattered over device
//      memory cost several times the rest of the build. A
//      list longer than kSortMax (a repeated-point cloud, or a source that
//      is every query's nearest, gives lists as long as M) is then put in
//      ascending order through a bitmap of the scene's 3M keys;
//   2. gather: one warp per (source, 256 channels), the grid in scene
//      order so that a scene's g rows stay in L2 while its sources read
//      them. A list of up to kSortMax keys is loaded one to four per lane
//      and sorted by a bitonic network (shuffles within a register, swaps
//      across registers). The warp then adds w·g[m] over the list in
//      ascending key order, lanes across the channels with float4 loads,
//      from +0.0, the product and the sum each rounded (the build passes
//      -fmad=false), and writes its part of the row;
//   3. d_weight (when asked for): one warp per query row, the three dot
//      products summed by a shuffle tree.
// The sum of each element is a sequential sum in ascending (m·3 + j), the
// order of the plain version's index_add_ on the CPU, so the result is the
// same bits on every call, and the CPU plain version's bits.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

#include "launch_check.cuh"

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

// 1. Block (s, b): the lists of scene b's sources [lo, hi), lo = s·kSlice.
// off[b·N + n] = the first entry of source n's list (global), and keys =
// each list's in-scene keys m·3 + j: in the order of the shared-memory
// atomics, except a list longer than kSortMax, which leaves in ascending
// order (a bitmap of the scene's 3M keys, read back word by word).
__global__ void __launch_bounds__(kBuildThreads)
build_kernel(const int* __restrict__ idx, int B, int N, int M,
             int* __restrict__ off, int* __restrict__ keys) {
  extern __shared__ int stage[];  // the slice's lists, then the bitmap
  unsigned* bits = reinterpret_cast<unsigned*>(stage);
  __shared__ int cur[kSlice];     // counts, then cursors
  __shared__ int sums[32];
  __shared__ int long_src[kSlice];    // the slice's long lists
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lo = blockIdx.x * kSlice, hi = min(N, lo + kSlice);
  const int E = 3 * M;
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
  const int per = (words + kBuildThreads - 1) / kBuildThreads;
  const int w0 = min(words, tid * per), w1 = min(words, w0 + per);
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

__device__ __forceinline__ void add_product(float& acc, float w, float x) {
  acc = __fadd_rn(acc, __fmul_rn(w, x));
}

__device__ __forceinline__ void add_product(float4& acc, float w, float4 x) {
  add_product(acc.x, w, x.x);
  add_product(acc.y, w, x.y);
  add_product(acc.z, w, x.z);
  add_product(acc.w, w, x.w);
}

template <typename Vec>
__device__ __forceinline__ Vec zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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

// Adds w·g[m] into acc over the `cnt` keys held one per lane (lane order),
// their weights read from wb: lane l's Vecs c0 + l + 32·v of each row.
template <typename Vec, int V>
__device__ __forceinline__ void add_rows(Vec (&acc)[V], const Vec* gb,
                                         const float* wb, int width, int c0,
                                         int key, int cnt, int lane) {
  const bool live = lane < cnt;
  const int row = live ? key / 3 : 0;
  const float wt = live ? __ldg(wb + key) : 0.0f;
#pragma unroll 4
  for (int t = 0; t < cnt; ++t) {
    const int r = __shfl_sync(kFull, row, t);
    const float wr = __shfl_sync(kFull, wt, t);
    const Vec* x = gb + (size_t)r * width + c0 + lane;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (c0 + lane + 32 * v < width) add_product(acc[v], wr, __ldg(x + 32 * v));
  }
}

// a list of up to 32·K keys: loaded K per lane, sorted, summed
template <typename Vec, int V, int K>
__device__ __forceinline__ void add_short_list(Vec (&acc)[V], const Vec* gb,
                                               const float* wb, int width,
                                               int c0, const int* list, int L,
                                               int lane) {
  int key[K];
#pragma unroll
  for (int r = 0; r < K; ++r)
    key[r] = r * 32 + lane < L ? list[r * 32 + lane] : INT_MAX;
  warp_sort<K>(key, lane);
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (r * 32 < L) add_rows<Vec, V>(acc, gb, wb, width, c0, key[r],
                                     min(32, L - r * 32), lane);
}

// 2. One warp per (source, chunk of 32·V Vecs of its row), sources in scene
// order. Vec is float4 when the rows are 16-byte aligned (C % 4 == 0),
// else float. A list of up to kSortMax keys is sorted here, a longer one
// came sorted from the build.
template <typename Vec, int V>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ w, const float* __restrict__ g,
              int B, int N, int M, int width, const int* __restrict__ off,
              const int* __restrict__ keys, float* __restrict__ dfeats) {
  const int lane = threadIdx.x & 31;
  const int chunks = (width + 32 * V - 1) / (32 * V);
  const long long gw = (long long)blockIdx.x * (kGatherThreads / 32) +
                       (threadIdx.x >> 5);
  if (gw >= (long long)B * N * chunks) return;
  const long long src = gw / chunks;
  const int c0 = (int)(gw % chunks) * 32 * V;
  const int b = (int)(src / N);
  const int lo = off[src], L = off[src + 1] - lo;
  const Vec* gb = reinterpret_cast<const Vec*>(g) + (size_t)b * M * width;
  const float* wb = w + (size_t)b * M * 3;
  Vec acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = zero<Vec>();
  if (L <= 32) {
    add_short_list<Vec, V, 1>(acc, gb, wb, width, c0, keys + lo, L, lane);
  } else if (L <= 64) {
    add_short_list<Vec, V, 2>(acc, gb, wb, width, c0, keys + lo, L, lane);
  } else if (L <= kSortMax) {
    add_short_list<Vec, V, 4>(acc, gb, wb, width, c0, keys + lo, L, lane);
  } else {
    for (int base = 0; base < L; base += 32) {
      const int cnt = min(32, L - base);
      add_rows<Vec, V>(acc, gb, wb, width, c0,
                       lane < cnt ? keys[lo + base + lane] : 0, cnt, lane);
    }
  }
  Vec* out = reinterpret_cast<Vec*>(dfeats) + (size_t)src * width + c0;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (c0 + lane + 32 * v < width) out[lane + 32 * v] = acc[v];
}

// 3. One warp per query row: d_weight, three dot products.
__global__ void __launch_bounds__(kGatherThreads)
dweight_kernel(const float* __restrict__ feats, const int* __restrict__ idx,
               const float* __restrict__ g, int B, int N, int M, int C,
               float* __restrict__ dw) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kGatherThreads / 32) +
                        (threadIdx.x >> 5);
  if (row >= (long long)B * M) return;
  const int b = (int)(row / M);
  const int* ir = idx + row * 3;
  const float* gr = g + row * C;
  const float* fb = feats + (size_t)b * N * C;
  const float* f0 = fb + (size_t)ir[0] * C;
  const float* f1 = fb + (size_t)ir[1] * C;
  const float* f2 = fb + (size_t)ir[2] * C;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float gv = gr[c];
    add_product(s0, f0[c], gv);
    add_product(s1, f1[c], gv);
    add_product(s2, f2[c], gv);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 = __fadd_rn(s0, __shfl_xor_sync(kFull, s0, o));
    s1 = __fadd_rn(s1, __shfl_xor_sync(kFull, s1, o));
    s2 = __fadd_rn(s2, __shfl_xor_sync(kFull, s2, o));
  }
  if (lane == 0) {
    dw[row * 3] = s0;
    dw[row * 3 + 1] = s1;
    dw[row * 3 + 2] = s2;
  }
}

// V Vecs per lane: 256 channels per warp
template <typename Vec, int V>
cudaError_t launch_gather(const float* w, const float* g, int B, int N,
                          int M, int width, const int* off, const int* keys,
                          float* dfeats, cudaStream_t stream) {
  const long long chunks = (width + 32 * V - 1) / (32 * V);
  const long long warps = (long long)B * N * chunks;
  const unsigned blocks =
      (unsigned)((warps + kGatherThreads / 32 - 1) / (kGatherThreads / 32));
  gather_kernel<Vec, V><<<blocks, kGatherThreads, 0, stream>>>(
      w, g, B, N, M, width, off, keys, dfeats);
  return cudaGetLastError();
}

// Ints of workspace the entry needs: offsets (B·N + 1), then the lists'
// keys (3·B·M); ops/interpolate.py::backward_workspace gives the same.
long long workspace_ints(int B, int N, int M) {
  return (long long)B * N + 1 + 3LL * B * M;
}

}  // namespace

// feats (B, N, C), idx and w (B, M, 3), g (B, M, C) -> dfeats (B, N, C),
// every element written, and dw (B, M, 3) unless it is null; `workspace`
// holds ws_ints ints (at least workspace_ints), all written before they
// are read. An id outside [0, N) is the caller's to
// prevent (the forward's ids come from the FPS 3-NN kernel).
extern "C" int tpu3d_three_interpolate_bwd(const float* feats, const int* idx,
                                           const float* w, const float* g,
                                           int B, int N, int M, int C,
                                           float* dfeats, float* dw,
                                           int* workspace, long long ws_ints,
                                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  // the build's dynamic shared memory: the stage, or the bitmap of the
  // scene's 3M keys if larger
  const size_t smem = sizeof(int) * (size_t)std::max<long long>(
      kStage, (3LL * M + 31) / 32);
  if (B < 1 || N < 1 || M < 1 || C < 1 || 3LL * B * M >= INT_MAX ||
      (long long)B * N >= INT_MAX || kBuildStatic + smem > kMaxSmem ||
      ws_ints < workspace_ints(B, N, M))
    return (int)cudaErrorInvalidValue;
  int* off = workspace;                 // B·N + 1
  int* keys = off + (size_t)B * N + 1;  // 3·B·M

  // above 48 KB of shared memory in all a kernel must ask for it; the
  // largest size asked for so far stands
  static size_t smem_granted = 0;
  cudaError_t err = cudaSuccess;
  if (smem > smem_granted) {
    err = cudaFuncSetAttribute(build_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_granted = smem;
  }
  const dim3 grid((N + kSlice - 1) / kSlice, B);
  build_kernel<<<grid, kBuildThreads, smem, stream>>>(idx, B, N, M, off,
                                                      keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const bool vec = C % 4 == 0 && reinterpret_cast<size_t>(g) % 16 == 0 &&
                   reinterpret_cast<size_t>(dfeats) % 16 == 0;
  err = vec ? launch_gather<float4, 2>(w, g, B, N, M, C / 4, off, keys,
                                       dfeats, stream)
            : launch_gather<float, 8>(w, g, B, N, M, C, off, keys, dfeats,
                                      stream);
  if (err != cudaSuccess || dw == nullptr) return (int)err;

  const long long rows = (long long)B * M;
  const unsigned blocks = (unsigned)((rows + kGatherThreads / 32 - 1) /
                                     (kGatherThreads / 32));
  dweight_kernel<<<blocks, kGatherThreads, 0, stream>>>(feats, idx, g, B, N,
                                                        M, C, dw);
  return (int)cudaGetLastError();
}
