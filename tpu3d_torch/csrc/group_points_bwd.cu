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
// :638-675): g in bf16 (the wrapper rounds it), the same f32 sums in the
// same order, d_features in f32 or bf16 (the features' dtype); the same
// bits as its plain version on the CPU. Bound: bytes, half of g's.

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

// the same row, weight 1: the bf16 form
struct GroupRowW {
  long long per_scene;
  __device__ csr::RowW operator()(int b, int key) const {
    return csr::RowW{b * per_scene + key, 1.0f};
  }
};

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

// The bf16 form: g (B, M, S, C) bf16, idx (B, M, S) -> dfeats (B, N, C), f32
// (out_bf16 0) or bf16 (1), every element written; the workspace as above.
extern "C" int tpu3d_group_points_bwd_bf16(const __nv_bfloat16* g,
                                           const int* idx, int B, int N,
                                           int M, int S, int C, int out_bf16,
                                           void* dfeats, int* workspace,
                                           long long ws_ints,
                                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const long long E = (long long)M * S;
  if (B < 1 || N < 1 || M < 1 || S < 1 || C < 1 || B * E >= INT_MAX ||
      (long long)B * N >= INT_MAX || csr::build_smem(E) == 0 ||
      ws_ints < csr::inverse_ints(B, N, E))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = csr::build(idx, B, N, M, S, workspace, stream);
  if (err != cudaSuccess) return (int)err;
  if (out_bf16)
    return (int)csr::sum_rows_bf16(g, B, N, C, workspace,
                                   static_cast<__nv_bfloat16*>(dfeats),
                                   GroupRowW{E}, stream);
  return (int)csr::sum_rows_bf16(g, B, N, C, workspace,
                                 static_cast<float*>(dfeats), GroupRowW{E},
                                 stream);
}
