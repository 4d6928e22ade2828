// Exact radius-bounded nearest-k search, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/grouping.py::_nearest_k_pallas (as driven by
// nearest_k_windowed). For every center it returns the k nearest points
// nearest first, as d² and point id, ties to the lower id. Points at
// d² >= r2max never enter the list, so slots past the in-radius neighbours
// hold d² = +inf and id N (never a ball-query hit). Unlike the TPU kernel
// this search is exact: there are no lane collisions, because each center
// keeps its whole sorted list instead of one candidate per lane.
//
// d² is (cx-px)²+(cy-py)²+(cz-pz)² rounded step by step in f32 (never the
// |u|²+|k|²-2u·k form: coordinates reach 70 m and radii are 0.1 m).
//
// Bound on the card: a brute sweep does M·N distance evaluations of 8 f32
// operations each, 0.54 G per scene at the RPN SA_0 shape (4096 × 16384):
// about 8 us at 67 TFLOP/s; the bytes are tiny, so operations bound it.
// Design: one thread per
// center, its sorted list held in registers (the insertion is unrolled over
// a compile-time K so the list never spills to local memory), and the points
// staged through shared memory in tiles that every thread of the block reads
// as broadcasts. The depth-sorted window of the TPU wrapper, which skips
// most of the sweep, is a later optimisation.

#include <cuda_runtime.h>
#include <math.h>

#include "launch_check.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;

template <int K>
__global__ void __launch_bounds__(kThreads)
nearest_k_kernel(const float* __restrict__ centers,
                 const float* __restrict__ pts, int M, int N, int k,
                 float r2max, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = m < M;
  const float* c = centers + ((size_t)b * M + (live ? m : 0)) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  const float* p = pts + (size_t)b * N * 3;

  float dk[K];
  int ik[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    dk[j] = INFINITY;
    ik[j] = N;
  }
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int cnt = min(kTile, N - t0);
    for (int s = threadIdx.x; s < cnt; s += blockDim.x) {
      sx[s] = p[3 * (t0 + s)];
      sy[s] = p[3 * (t0 + s) + 1];
      sz[s] = p[3 * (t0 + s) + 2];
    }
    __syncthreads();
    for (int s = 0; s < cnt; ++s) {
      const float dx = __fsub_rn(cx, sx[s]);
      const float dy = __fsub_rn(cy, sy[s]);
      const float dz = __fsub_rn(cz, sz[s]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      // strict <: ids arrive in ascending order, so an equal d² stays
      // behind the lower id already in the list
      if (d < r2max && d < dk[K - 1]) {
        const int id = t0 + s;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          if (d < dk[j - 1]) {
            dk[j] = dk[j - 1];
            ik[j] = ik[j - 1];
          } else if (d < dk[j]) {
            dk[j] = d;
            ik[j] = id;
          }
        }
        if (d < dk[0]) {
          dk[0] = d;
          ik[0] = id;
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    const size_t r = ((size_t)b * M + m) * k;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        out_d[r + j] = dk[j];
        out_i[r + j] = ik[j];
      }
    }
  }
}

template <int K>
cudaError_t launch(const float* centers, const float* pts, int B, int M,
                   int N, int k, float r2max, float* d2, int* idx,
                   cudaStream_t stream) {
  dim3 grid((M + kThreads - 1) / kThreads, B);
  nearest_k_kernel<K><<<grid, kThreads, 0, stream>>>(centers, pts, M, N, k,
                                                     r2max, d2, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpu3d_nearest_k(const float* centers, const float* pts, int B,
                               int M, int N, int k, float r2max, float* d2,
                               int* idx, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || M < 1 || N < 1 || k < 1 || k > 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (k <= 16)
    err = launch<16>(centers, pts, B, M, N, k, r2max, d2, idx, stream);
  else if (k <= 32)
    err = launch<32>(centers, pts, B, M, N, k, r2max, d2, idx, stream);
  else
    err = launch<64>(centers, pts, B, M, N, k, r2max, d2, idx, stream);
  return (int)err;
}
