// Fused grouped gather + two-layer MLP + max-pool (no BatchNorm), for Hopper
// (sm_90a): the eval forward and the training forward.
//
// Replaces tpu3d/ops/fused_sa.py::_nobn2_eval_kernel (entry
// fused_gathered_mlp_pool(train=False)) and the forward half of training,
// _nobn2_fwd_kernel. Same function: for every (row, center),
// x0[s] = pre[row, idx[row, center, s]] - center_term[row, center], then
// ReLU -> Dense+b1 -> ReLU -> Dense+b2 -> ReLU -> max over the S slots. The
// training form also writes, per (row, center, channel), the first slot s
// that reaches the max (argmax) and the pre-ReLU value x2 there (ppre): the
// backward (fused_sa_bwd.cu) routes the pooled gradient to that one slot.
// Its pooled output is the eval form's to the bit: the same instructions
// compute it, and the argmax is found after, by comparison.
// The TPU kernel rounds to bf16 at the layer boundaries for its MXU; this
// one computes in f32 throughout (no TF32), so that it is held to the plain
// f32 version, which tpu3d's CPU path equals. Multiply-adds are contracted
// (built without -fmad=false): the kernel is held to a tolerance, not to the
// bit.
//
// Bound on the card: operations. At the RCNN's eval shapes (200 rows, 128 x
// 64 slots of 128 channels at SA_0; 32 x 64 slots, 128 -> 256 at SA_1) the
// two Dense layers are 147 GFLOP against some 60 MB of input, far above the
// f32 ridge. Design: one block per (row, center), so the S x C1 slab is
// gathered once into shared memory and never reaches device memory; eight
// warps each own S/8 slab rows, every lane 4 or 8 output columns (a register
// tile of S/8 x C_out/32), and the weights stream through shared memory in
// slices of 32 input channels that all eight warps share. The layer-1
// activations stay in shared memory for layer 2, and the max over S is a
// register max per warp, then one across the warps through shared memory.
// The training form keeps each warp's first argmax and x2 there in the
// weight buffer once layer 2 is done with it, so both forms take the same
// shared memory and two blocks fit on an SM.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_sa_common.cuh"

namespace {

using fused_sa::dense;
using fused_sa::gather_x0;
using fused_sa::kKC;
using fused_sa::kThreads;
using fused_sa::kWarps;

template <int TM, int TN2, int TN3, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 2)
fused_sa_kernel(const float* __restrict__ pre, const int* __restrict__ idx,
                const float* __restrict__ center, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, int N, int M, int C1,
                float* __restrict__ out, int* __restrict__ argmax,
                float* __restrict__ ppre) {
  constexpr int S = kWarps * TM;
  constexpr int C2 = 32 * TN2;
  constexpr int C3 = 32 * TN3;
  constexpr int kWbuf = kKC * (C2 > C3 ? C2 : C3);
  static_assert(!TRAIN || kWbuf >= 2 * kWarps * C3, "argmax scratch");
  extern __shared__ float smem[];
  float* x0 = smem;            // S x C1: ReLU(gathered pre - center)
  float* x1 = x0 + S * C1;     // S x C2: ReLU(layer 1)
  float* wbuf = x1 + S * C2;   // kKC x max(C2, C3)
  float* red = wbuf + kWbuf;   // kWarps x C3: per-warp column maxima

  const int m = blockIdx.x;
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t group = (size_t)row * M + m;
  gather_x0(pre, idx, center, group, row, N, S, C1, x0);

  {  // layer 1 (the barrier in dense() orders the gather before it)
    float acc[TM][TN2];
    dense<TM, TN2>(x0, C1, w1, wbuf, acc);
#pragma unroll
    for (int q = 0; q < TN2 / 4; ++q) {
      const int col = q * 128 + 4 * lane;
      const float4 b = *reinterpret_cast<const float4*>(b1 + col);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        *reinterpret_cast<float4*>(x1 + (warp * TM + i) * C2 + col) =
            make_float4(fmaxf(acc[i][4 * q] + b.x, 0.0f),
                        fmaxf(acc[i][4 * q + 1] + b.y, 0.0f),
                        fmaxf(acc[i][4 * q + 2] + b.z, 0.0f),
                        fmaxf(acc[i][4 * q + 3] + b.w, 0.0f));
      }
    }
  }
  {  // layer 2, then the max over this warp's rows
    float acc[TM][TN3];
    dense<TM, TN3>(x1, C2, w2, wbuf, acc);
    float4 mxs[TN3 / 4];
#pragma unroll
    for (int q = 0; q < TN3 / 4; ++q) {
      const int col = q * 128 + 4 * lane;
      const float4 b = *reinterpret_cast<const float4*>(b2 + col);
      float4 mx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // ReLU output >= 0
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        mx.x = fmaxf(mx.x, acc[i][4 * q] + b.x);
        mx.y = fmaxf(mx.y, acc[i][4 * q + 1] + b.y);
        mx.z = fmaxf(mx.z, acc[i][4 * q + 2] + b.z);
        mx.w = fmaxf(mx.w, acc[i][4 * q + 3] + b.w);
      }
      *reinterpret_cast<float4*>(red + warp * C3 + col) = mx;
      mxs[q] = mx;
    }
    if constexpr (TRAIN) {
      // the first of this warp's rows whose ReLU(x2) reaches the warp's
      // max, and x2 there, into the weight buffer
      __syncthreads();  // every warp is done with the last weight slice
      int* warg = reinterpret_cast<int*>(wbuf);
      float* wpre = wbuf + kWarps * C3;
#pragma unroll
      for (int q = 0; q < TN3 / 4; ++q) {
        const int col = q * 128 + 4 * lane;
        const float bb[4] = {b2[col], b2[col + 1], b2[col + 2], b2[col + 3]};
        const float mv[4] = {mxs[q].x, mxs[q].y, mxs[q].z, mxs[q].w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int first = -1;
          float px = 0.0f;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float v = acc[i][4 * q + r] + bb[r];
            if (first < 0 && fmaxf(v, 0.0f) == mv[r]) {
              first = i;
              px = v;
            }
          }
          warg[warp * C3 + col + r] = warp * TM + first;
          wpre[warp * C3 + col + r] = px;
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C3; c += kThreads) {
    float v = red[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w * C3 + c]);
    out[group * C3 + c] = v;
    if constexpr (TRAIN) {
      const int* warg = reinterpret_cast<const int*>(wbuf);
      const float* wpre = wbuf + kWarps * C3;
      int w = 0;
      while (w < kWarps - 1 && red[w * C3 + c] != v) ++w;
      argmax[group * C3 + c] = warg[w * C3 + c];
      ppre[group * C3 + c] = wpre[w * C3 + c];
    }
  }
}

template <int TM, int TN2, int TN3, bool TRAIN>
cudaError_t launch(const float* pre, const int* idx, const float* center,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, int R, int N, int M, int C1, float* out,
                   int* argmax, float* ppre, cudaStream_t stream) {
  constexpr int S = kWarps * TM;
  constexpr int C2 = 32 * TN2;
  constexpr int C3 = 32 * TN3;
  const size_t floats = (size_t)S * C1 + S * C2 + kKC * (C2 > C3 ? C2 : C3)
                        + kWarps * C3;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_kernel<TM, TN2, TN3, TRAIN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(M, R);
  fused_sa_kernel<TM, TN2, TN3, TRAIN><<<grid, kThreads, smem, stream>>>(
      pre, idx, center, w1, b1, w2, b2, N, M, C1, out, argmax, ppre);
  return cudaGetLastError();
}

template <int TM, bool TRAIN>
cudaError_t launch_c(const float* pre, const int* idx, const float* center,
                     const float* w1, const float* b1, const float* w2,
                     const float* b2, int R, int N, int M, int C1, int C2,
                     int C3, float* out, int* argmax, float* ppre,
                     cudaStream_t stream) {
  if (C2 == 128 && C3 == 128)
    return launch<TM, 4, 4, TRAIN>(pre, idx, center, w1, b1, w2, b2, R, N, M,
                                   C1, out, argmax, ppre, stream);
  if (C2 == 128 && C3 == 256)
    return launch<TM, 4, 8, TRAIN>(pre, idx, center, w1, b1, w2, b2, R, N, M,
                                   C1, out, argmax, ppre, stream);
  if (C2 == 256 && C3 == 128)
    return launch<TM, 8, 4, TRAIN>(pre, idx, center, w1, b1, w2, b2, R, N, M,
                                   C1, out, argmax, ppre, stream);
  return launch<TM, 8, 8, TRAIN>(pre, idx, center, w1, b1, w2, b2, R, N, M,
                                 C1, out, argmax, ppre, stream);
}

template <bool TRAIN>
int dispatch(const float* pre, const int* idx, const float* center,
             const float* w1, const float* b1, const float* w2,
             const float* b2, int R, int N, int M, int S, int C1, int C2,
             int C3, float* out, int* argmax, float* ppre,
             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool widths_ok = (C2 == 128 || C2 == 256) && (C3 == 128 || C3 == 256);
  if (R < 1 || R > 65535 || N < 1 || M < 1 || C1 < 4 || C1 > 256
      || C1 % 4 != 0 || !widths_ok)
    return (int)cudaErrorInvalidValue;
  switch (S) {
    case 16:
      return (int)launch_c<2, TRAIN>(pre, idx, center, w1, b1, w2, b2, R, N,
                                     M, C1, C2, C3, out, argmax, ppre, stream);
    case 32:
      return (int)launch_c<4, TRAIN>(pre, idx, center, w1, b1, w2, b2, R, N,
                                     M, C1, C2, C3, out, argmax, ppre, stream);
    case 64:
      return (int)launch_c<8, TRAIN>(pre, idx, center, w1, b1, w2, b2, R, N,
                                     M, C1, C2, C3, out, argmax, ppre, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tpu3d_fused_sa(const float* pre, const int* idx,
                              const float* center, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, int R, int N, int M, int S,
                              int C1, int C2, int C3, float* out,
                              void* stream_ptr) {
  return dispatch<false>(pre, idx, center, w1, b1, w2, b2, R, N, M, S, C1, C2,
                         C3, out, nullptr, nullptr, stream_ptr);
}

extern "C" int tpu3d_fused_sa_train(const float* pre, const int* idx,
                                    const float* center, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, int R, int N, int M,
                                    int S, int C1, int C2, int C3, float* out,
                                    int* argmax, float* ppre,
                                    void* stream_ptr) {
  return dispatch<true>(pre, idx, center, w1, b1, w2, b2, R, N, M, S, C1, C2,
                        C3, out, argmax, ppre, stream_ptr);
}
