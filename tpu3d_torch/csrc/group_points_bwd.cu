// Backward of the grouping gather, for Hopper (sm_90a).
//
// No TPU kernel: it replaces torch.gather's backward (a scatter-add, float
// atomics on the card, so its sums vary in the last bit from run to run)
// for ops/grouping.py::group_points. For the forward
//   out[b, m, s, :] = F[b, idx[b, m, s], :]
// and the output gradient g (B, M, S, C) it gives
//   d_features[b, n, :] = sum over (m, s) with idx[b, m, s] = n of g[b, m, s, :]
// in f32. Pads repeat a point, so one source row may take many entries.
//
// Bound on the card: bytes (g read once, d_features written once; one add
// per float read). Design: csr_inverse.cuh's build inverts the ids (each
// source's list of keys k = m·S + s), then one warp per (source, 256
// channels) adds g[b, k, :] over its list in ascending key order from +0.0,
// each sum rounded, and writes its part of the row: no atomics, every row
// written once (no zeroing pass). The order is that of the plain version's
// index_add_ on the CPU, so every call gives the same bits, and the CPU's.
//
// The bf16 form (tpu3d_group_points_bwd_bf16; the backward of tpu3d's
// gather_mxu_bwd and onehot_bf16 routes, ops/grouping.py:559-621,
// :638-675): each value of g rounded to bf16, the same f32 sums in the
// same order, d_features in f32 or bf16 (the features' dtype); the same
// bits as its plain version on the CPU. Bound: bytes (g read once in the
// dtype it comes in, d_features written once). It reads g where and as
// autograd hands it, f32 or bf16, rows of C channels a row stride apart
// (a channel slice of a wider row), and rounds each value as it loads it:
// no cast or copy pass runs before it. After the same build, one warp per
// (source, 32·J channels), J = ceil(C / 32) up to 8, so that every lane
// has channels at C = 96 (lane l takes channels l + 32·j, each load of the
// warp a contiguous row segment), and four keys' rows loaded before they
// are added, in ascending key order.

#include <climits>

#include <cuda_runtime.h>

#include "csr_inverse.cuh"
#include "launch_check.cuh"

namespace {

// key k of scene b -> its gradient row b·M·S + k
struct GroupRow {
  long long per_scene;
  __device__ long long operator()(int b, int key) const {
    return b * per_scene + key;
  }
};

// a value of g rounded to bf16, in f32
__device__ __forceinline__ float load_r16(const float* x) {
  return __bfloat162float(__float2bfloat16_rn(__ldg(x)));
}
__device__ __forceinline__ float load_r16(const __nv_bfloat16* x) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(x))));
}

// acc[j] += bf16(g row key)[lane + 32·j] over `cnt` keys, one per lane in
// ascending lane order, added in that order; `row0` is the scene's first
// row, rows `ld` values apart, `rem` the channels from this lane's first
template <int J, typename In>
__device__ __forceinline__ void add_keys(float (&acc)[J], const In* row0,
                                         long long ld, int rem, int key,
                                         int cnt, int lane) {
  constexpr int U = 4;  // keys whose rows are loaded before they are added
  for (int t0 = 0; t0 < cnt; t0 += U) {
    float v[U][J];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = __shfl_sync(csr::kFull, key, min(t0 + u, 31));
      const In* x = row0 + k * ld;
#pragma unroll
      for (int j = 0; j < J; ++j)
        v[u][j] = t0 + u < cnt && 32 * j < rem ? load_r16(x + 32 * j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (t0 + u < cnt)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[j] = __fadd_rn(acc[j], v[u][j]);
  }
}

// a list of up to 32·K keys: loaded K a lane, sorted, summed
template <int J, int K, typename In>
__device__ __forceinline__ void add_short(float (&acc)[J], const In* row0,
                                          long long ld, int rem,
                                          const int* list, int L, int lane) {
  int key[K];
#pragma unroll
  for (int r = 0; r < K; ++r)
    key[r] = r * 32 + lane < L ? list[r * 32 + lane] : INT_MAX;
  csr::warp_sort<K>(key, lane);
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (r * 32 < L)
      add_keys<J>(acc, row0, ld, rem, key[r], min(32, L - r * 32), lane);
}

// One warp per (source, chunk of 32·J channels), sources in scene order:
// dfeats[src] = the f32 sum, from +0.0, of bf16(g[b, key]) over the
// source's keys in ascending order, written in f32 or rounded once to bf16.
template <int J, typename In, typename Out>
__global__ void __launch_bounds__(csr::kGatherThreads)
gather_bwd_kernel(const In* __restrict__ g, long long ld, long long E,
                  int B, int N, int C, const int* __restrict__ off,
                  const int* __restrict__ keys, Out* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int chunks = (C + 32 * J - 1) / (32 * J);
  const long long gw = (long long)blockIdx.x * (csr::kGatherThreads / 32) +
                       (threadIdx.x >> 5);
  if (gw >= (long long)B * N * chunks) return;
  const long long src = gw / chunks;
  const int c0 = (int)(gw % chunks) * 32 * J;
  const int b = (int)(src / N);
  const int lo = off[src], L = off[src + 1] - lo;
  const In* row0 = g + b * E * ld + c0 + lane;
  const int rem = C - c0 - lane;
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.0f;
  if (L <= 32) {
    add_short<J, 1>(acc, row0, ld, rem, keys + lo, L, lane);
  } else if (L <= 64) {
    add_short<J, 2>(acc, row0, ld, rem, keys + lo, L, lane);
  } else if (L <= csr::kSortMax) {
    add_short<J, 4>(acc, row0, ld, rem, keys + lo, L, lane);
  } else {  // the build sorted it
    for (int base = 0; base < L; base += 32) {
      const int cnt = min(32, L - base);
      add_keys<J>(acc, row0, ld, rem, lane < cnt ? keys[lo + base + lane] : 0,
                  cnt, lane);
    }
  }
  Out* o = out + src * C + c0 + lane;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (32 * j < rem) csr::put(o + 32 * j, acc[j]);
}

template <int J, typename In, typename Out>
cudaError_t launch_gather_bwd(const In* g, long long ld, long long E, int B,
                              int N, int C, const int* workspace, Out* out,
                              cudaStream_t stream) {
  const long long warps = (long long)B * N * ((C + 32 * J - 1) / (32 * J));
  constexpr int per_block = csr::kGatherThreads / 32;
  gather_bwd_kernel<J, In, Out>
      <<<(unsigned)((warps + per_block - 1) / per_block), csr::kGatherThreads,
         0, stream>>>(g, ld, E, B, N, C, workspace, workspace + (size_t)B * N + 1,
                      out);
  return cudaGetLastError();
}

// J = ceil(C / 32) channels a lane, up to 8 (chunks of 256 beyond)
template <typename In, typename Out>
cudaError_t gather_bwd(const In* g, long long ld, long long E, int B, int N,
                       int C, const int* workspace, Out* out,
                       cudaStream_t stream) {
  if (C <= 32)
    return launch_gather_bwd<1>(g, ld, E, B, N, C, workspace, out, stream);
  if (C <= 64)
    return launch_gather_bwd<2>(g, ld, E, B, N, C, workspace, out, stream);
  if (C <= 96)
    return launch_gather_bwd<3>(g, ld, E, B, N, C, workspace, out, stream);
  if (C <= 128)
    return launch_gather_bwd<4>(g, ld, E, B, N, C, workspace, out, stream);
  return launch_gather_bwd<8>(g, ld, E, B, N, C, workspace, out, stream);
}

template <typename In>
cudaError_t gather_bwd_to(const In* g, long long ld, long long E, int B,
                          int N, int C, const int* workspace, int out_bf16,
                          void* out, cudaStream_t stream) {
  if (out_bf16)
    return gather_bwd(g, ld, E, B, N, C, workspace,
                      static_cast<__nv_bfloat16*>(out), stream);
  return gather_bwd(g, ld, E, B, N, C, workspace, static_cast<float*>(out),
                    stream);
}

}  // namespace

// Ints of workspace the entry needs: offsets (B·N + 1), then the lists'
// keys (B·M·S); ops/grouping.py::group_points_workspace gives the same.
extern "C" long long tpu3d_group_points_bwd_workspace(int B, int N, int M,
                                                      int S) {
  return csr::inverse_ints(B, N, (long long)M * S);
}

// g (B, M, S, C), idx (B, M, S) -> dfeats (B, N, C), every element written;
// `workspace` holds ws_ints ints (at least the workspace's), all written
// before they are read. An id outside [0, N) is the caller's to prevent.
extern "C" int tpu3d_group_points_bwd(const float* g, const int* idx, int B,
                                      int N, int M, int S, int C,
                                      float* dfeats, int* workspace,
                                      long long ws_ints, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const long long E = (long long)M * S;
  if (B < 1 || N < 1 || M < 1 || S < 1 || C < 1 || B * E >= INT_MAX ||
      (long long)B * N >= INT_MAX || csr::build_smem(E) == 0 ||
      ws_ints < csr::inverse_ints(B, N, E))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = csr::build(idx, B, N, M, S, workspace, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)csr::sum_rows(g, B, N, C, workspace, dfeats, GroupRow{E},
                            stream);
}

// The bf16 form: g (B, M, S, C) f32 (g_bf16 0) or bf16 (1), row (b, m, s)
// at (b·M·S + m·S + s)·ld values, ld >= C; idx (B, M, S) -> dfeats (B, N,
// C), f32 (out_bf16 0) or bf16 (1), every element written; the workspace
// as above.
extern "C" int tpu3d_group_points_bwd_bf16(const void* g, int g_bf16,
                                           long long ld, const int* idx,
                                           int B, int N, int M, int S, int C,
                                           int out_bf16, void* dfeats,
                                           int* workspace, long long ws_ints,
                                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const long long E = (long long)M * S;
  if (B < 1 || N < 1 || M < 1 || S < 1 || C < 1 || ld < C ||
      B * E >= INT_MAX || (long long)B * N >= INT_MAX ||
      csr::build_smem(E) == 0 || ws_ints < csr::inverse_ints(B, N, E))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = csr::build(idx, B, N, M, S, workspace, stream);
  if (err != cudaSuccess) return (int)err;
  if (g_bf16)
    return (int)gather_bwd_to(static_cast<const __nv_bfloat16*>(g), ld, E, B,
                              N, C, workspace, out_bf16, dfeats, stream);
  return (int)gather_bwd_to(static_cast<const float*>(g), ld, E, B, N, C,
                            workspace, out_bf16, dfeats, stream);
}
