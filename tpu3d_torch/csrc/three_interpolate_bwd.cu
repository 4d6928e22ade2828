// Backward of three-point interpolation, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/interpolate.py::_ti_bwd_kernel. For the forward
//   out[b, m, :] = sum_j w[b,m,j] F[b, idx[b,m,j], :]
// and the output gradient g (B, M, C) it gives
//   d_features[b, n, :] = sum over (m, j) with idx[b,m,j] = n of w[b,m,j] g[b,m,:]
//   d_weight[b, m, j]   = <F[b, idx[b,m,j], :], g[b,m,:]>   (when asked for)
// in f32. The TPU kernel builds bf16 one-hot rows and multiplies them by g
// on the MXU, a workaround for slow scatters and gathers there; on Hopper
// the scatter is float atomics into L2 and the gather a coalesced load.
//
// Bound on the card: bytes. Per output row it reads g once (and the three
// gathered rows when d_weight is asked for) and adds three weighted rows
// into d_features: 1-2 operations per byte moved. Design: one warp per
// output row, lanes across the channels, as in the forward; each lane adds
// its channels into the three source rows with atomicAdd (a source row
// receives about a dozen contributions at FP_0, from rows that need not be
// neighbours, so the sums cannot be plain stores), and d_weight is each
// lane's partial dot product summed by a shuffle tree. The atomics add in
// an order that changes from run to run, so d_features is held to its
// plain version with a tolerance, not to the bit.

#include <cuda_runtime.h>

#include "launch_check.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
three_interpolate_bwd_kernel(const float* __restrict__ feats,
                             const int* __restrict__ idx,
                             const float* __restrict__ w,
                             const float* __restrict__ g, int B, int N, int M,
                             int C, float* __restrict__ dfeats,
                             float* __restrict__ dw) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= (long long)B * M) return;
  const int b = (int)(row / M);
  const int* ir = idx + row * 3;
  const float* wr = w + row * 3;
  const int i0 = ir[0], i1 = ir[1], i2 = ir[2];
  const float w0 = wr[0], w1 = wr[1], w2 = wr[2];
  const float* gr = g + row * C;
  float* base = dfeats + (size_t)b * N * C;
  float* d0 = base + (size_t)i0 * C;
  float* d1 = base + (size_t)i1 * C;
  float* d2 = base + (size_t)i2 * C;
  for (int c = lane; c < C; c += 32) {
    const float gv = gr[c];
    atomicAdd(d0 + c, w0 * gv);
    atomicAdd(d1 + c, w1 * gv);
    atomicAdd(d2 + c, w2 * gv);
  }
  if (dw == nullptr) return;
  const float* fb = feats + (size_t)b * N * C;
  const float* f0 = fb + (size_t)i0 * C;
  const float* f1 = fb + (size_t)i1 * C;
  const float* f2 = fb + (size_t)i2 * C;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float gv = gr[c];
    s0 += f0[c] * gv;
    s1 += f1[c] * gv;
    s2 += f2[c] * gv;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    dw[row * 3] = s0;
    dw[row * 3 + 1] = s1;
    dw[row * 3 + 2] = s2;
  }
}

}  // namespace

// feats (B, N, C), idx and w (B, M, 3), g (B, M, C) -> dfeats (B, N, C),
// which the caller zeroes and this adds into, and dw (B, M, 3) unless it is
// null. An id outside [0, N) is the caller's to prevent (the forward's
// ids come from the FPS 3-NN kernel).
extern "C" int tpu3d_three_interpolate_bwd(const float* feats, const int* idx,
                                           const float* w, const float* g,
                                           int B, int N, int M, int C,
                                           float* dfeats, float* dw,
                                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || N < 1 || M < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * M;
  const int rows_per_block = kThreads / 32;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  three_interpolate_bwd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      feats, idx, w, g, B, N, M, C, dfeats, dw);
  return (int)cudaGetLastError();
}
