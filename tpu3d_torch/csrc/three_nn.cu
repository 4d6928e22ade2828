// Exact 3 nearest known points of every query, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/interpolate.py::_three_nn_pallas. Same function: for
// each of the M queries of a scene, the 3 nearest of its N known points as
// (d², index), nearest first, ties to the lowest index. d² is
// (ux-kx)²+(uy-ky)²+(uz-kz)², query minus known, rounded step by step in f32
// (the __f*_rn intrinsics, and the build passes -fmad=false), exactly as the
// plain version rounds it: one rounding difference can swap two neighbours.
//
// Bound on the card: M·N pairs of 8 float operations and a compare, so it is
// bound by operations (about 0.26 ms at the split route's 16 x 32768 x 4096,
// 67 TFLOP/s f32), never by its few MB of bytes. Design: one thread per
// query keeps its sorted top-3 in registers; a block of kThreads queries
// stages the scene's known coordinates through shared memory in tiles of
// kTile, so each known point is read from device memory once per block and
// then broadcast to every thread from shared memory. The fold is the
// strict-< insertion network of the TPU kernel, in ascending known index,
// so ties keep the lower index. The TPU kernel's lane-parallel sweep and its
// three-step final selection exist because a TPU vector unit has no
// per-lane scalar state; one thread per query needs neither.

#include <cuda_runtime.h>
#include <math.h>

#include "launch_check.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

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

}  // namespace

extern "C" int tpu3d_three_nn(const float* unknown, const float* known,
                              int B, int M, int N, float* d2, int* idx,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || B > 65535 || M < 1 || N < 3) return (int)cudaErrorInvalidValue;
  dim3 grid((M + kThreads - 1) / kThreads, B);
  three_nn_kernel<<<grid, kThreads, 0, stream>>>(unknown, known, M, N, d2,
                                                 idx);
  return (int)cudaGetLastError();
}
