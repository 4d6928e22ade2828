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
//   1. build (csr_inverse.cuh, shared with the kernels that invert S
//      entries a group): a CSR inverse of the ids, each source's list of
//      flat keys k = m·3 + j. Block (s, b) owns scene b's sources of slice s (a
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
//
// The bf16 form (tpu3d_three_interpolate_bwd_bf16) is kernel 7 in its bf16
// arithmetic, as every route of tpu3d's accelerator differentiates the
// interpolation of bf16 features (_ti_bwd_kernel, :276-300; the gather
// route's MXU backward and the one-hot route's autodiff, :423-505):
// d_features = bf16(sum of bf16(w)·bf16(g)), each product exact in f32,
// summed in f32 in the same ascending order over the same inverse
// (csr_inverse.cuh's sum_rows_bf16), written in bf16; no d_weight (the FP
// levels' weights are constants). The same bits as its plain version on
// the CPU. Bound: bytes, half of the f32 form's g.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

#include "csr_inverse.cuh"
#include "launch_check.cuh"

namespace {

using csr::kFull;
using csr::kGatherThreads;
using csr::kSortMax;
using csr::warp_sort;

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

// key m·3 + j of scene b -> g's row b·M + m, weight bf16(w[b, m, j])
struct InterpRowW {
  const float* w;
  int M;
  __device__ csr::RowW operator()(int b, int key) const {
    const float wt = __ldg(w + (size_t)b * M * 3 + key);
    return csr::RowW{(long long)b * M + key / 3,
                     __bfloat162float(__float2bfloat16_rn(wt))};
  }
};

// Ints of workspace the entry needs: offsets (B·N + 1), then the lists'
// keys (3·B·M); ops/interpolate.py::backward_workspace gives the same.
long long workspace_ints(int B, int N, int M) {
  return csr::inverse_ints(B, N, 3LL * M);
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
  if (B < 1 || N < 1 || M < 1 || C < 1 || 3LL * B * M >= INT_MAX ||
      (long long)B * N >= INT_MAX || csr::build_smem(3LL * M) == 0 ||
      ws_ints < workspace_ints(B, N, M))
    return (int)cudaErrorInvalidValue;
  int* off = workspace;                 // B·N + 1
  int* keys = off + (size_t)B * N + 1;  // 3·B·M
  cudaError_t err = csr::build(idx, B, N, M, 3, workspace, stream);
  if (err != cudaSuccess) return (int)err;

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

// Kernel 7's bf16 form: idx and w (B, M, 3), g (B, M, C) bf16 -> dfeats
// (B, N, C) bf16, every element written; the workspace as above.
extern "C" int tpu3d_three_interpolate_bwd_bf16(const int* idx,
                                                const float* w,
                                                const __nv_bfloat16* g, int B,
                                                int N, int M, int C,
                                                __nv_bfloat16* dfeats,
                                                int* workspace,
                                                long long ws_ints,
                                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || N < 1 || M < 1 || C < 1 || 3LL * B * M >= INT_MAX ||
      (long long)B * N >= INT_MAX || csr::build_smem(3LL * M) == 0 ||
      ws_ints < workspace_ints(B, N, M))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = csr::build(idx, B, N, M, 3, workspace, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)csr::sum_rows_bf16(g, B, N, C, workspace, dfeats,
                                 InterpRowW{w, M}, stream);
}
