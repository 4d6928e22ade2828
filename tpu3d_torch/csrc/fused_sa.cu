// Fused grouped gather + two-layer MLP + max-pool (no BatchNorm), for Hopper
// (sm_90a).
//
// Replaces tpu3d/ops/fused_sa.py::_nobn2_eval_kernel (entry
// fused_gathered_mlp_pool(train=False)). Same function: for every (row,
// center), x0[s] = pre[row, idx[row, center, s]] - center_term[row, center],
// then ReLU -> Dense+b1 -> ReLU -> Dense+b2 -> ReLU -> max over the S slots.
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 32;  // weight rows per staged slice

// acc = X @ W for this thread's tile: rows warp*TM + i of X (shared, S x cin
// row-major), columns q*128 + 4*lane + r (q < TN/4, r < 4) of W (global,
// cin x 32*TN row-major), staged kKC rows at a time through wbuf.
template <int TM, int TN>
__device__ __forceinline__ void dense(const float* __restrict__ X, int cin,
                                      const float* __restrict__ W,
                                      float* __restrict__ wbuf,
                                      float (&acc)[TM][TN]) {
  constexpr int kCout = 32 * TN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[i][t] = 0.0f;
  for (int k0 = 0; k0 < cin; k0 += kKC) {
    const int kc = min(kKC, cin - k0);
    __syncthreads();  // every warp is done with the previous slice
    const float4* src = reinterpret_cast<const float4*>(W + (size_t)k0 * kCout);
    float4* dst = reinterpret_cast<float4*>(wbuf);
    for (int q = threadIdx.x; q < kc * kCout / 4; q += kThreads) dst[q] = src[q];
    __syncthreads();
    for (int kk = 0; kk < kc; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            X + (warp * TM + i) * cin + k0 + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              wbuf + (kk + j) * kCout + q * 128 + 4 * lane);
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = j == 0 ? a[i].x : j == 1 ? a[i].y
                         : j == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int t = 0; t < TN; ++t) acc[i][t] += av * w[t];
        }
      }
    }
  }
}

template <int TM, int TN2, int TN3>
__global__ void __launch_bounds__(kThreads, 2)
fused_sa_kernel(const float* __restrict__ pre, const int* __restrict__ idx,
                const float* __restrict__ center, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, int N, int M, int C1,
                float* __restrict__ out) {
  constexpr int S = kWarps * TM;
  constexpr int C2 = 32 * TN2;
  constexpr int C3 = 32 * TN3;
  constexpr int kWbuf = kKC * (C2 > C3 ? C2 : C3);
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
  const float4* ctr = reinterpret_cast<const float4*>(center + group * C1);
  for (int s = warp; s < S; s += kWarps) {
    const int p = idx[group * S + s];
    if ((unsigned)p >= (unsigned)N) __trap();  // an id outside the row
    const float4* src =
        reinterpret_cast<const float4*>(pre + ((size_t)row * N + p) * C1);
    float4* dst = reinterpret_cast<float4*>(x0 + s * C1);
    for (int c = lane; c < C1 / 4; c += 32) {
      const float4 v = src[c];
      const float4 k = ctr[c];
      dst[c] = make_float4(fmaxf(v.x - k.x, 0.0f), fmaxf(v.y - k.y, 0.0f),
                           fmaxf(v.z - k.z, 0.0f), fmaxf(v.w - k.w, 0.0f));
    }
  }

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
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C3; c += kThreads) {
    float v = red[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w * C3 + c]);
    out[group * C3 + c] = v;
  }
}

template <int TM, int TN2, int TN3>
cudaError_t launch(const float* pre, const int* idx, const float* center,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, int R, int N, int M, int C1, float* out,
                   cudaStream_t stream) {
  constexpr int S = kWarps * TM;
  constexpr int C2 = 32 * TN2;
  constexpr int C3 = 32 * TN3;
  const size_t floats = (size_t)S * C1 + S * C2 + kKC * (C2 > C3 ? C2 : C3)
                        + kWarps * C3;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_kernel<TM, TN2, TN3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(M, R);
  fused_sa_kernel<TM, TN2, TN3><<<grid, kThreads, smem, stream>>>(
      pre, idx, center, w1, b1, w2, b2, N, M, C1, out);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_c(const float* pre, const int* idx, const float* center,
                     const float* w1, const float* b1, const float* w2,
                     const float* b2, int R, int N, int M, int C1, int C2,
                     int C3, float* out, cudaStream_t stream) {
  if (C2 == 128 && C3 == 128)
    return launch<TM, 4, 4>(pre, idx, center, w1, b1, w2, b2, R, N, M, C1,
                            out, stream);
  if (C2 == 128 && C3 == 256)
    return launch<TM, 4, 8>(pre, idx, center, w1, b1, w2, b2, R, N, M, C1,
                            out, stream);
  if (C2 == 256 && C3 == 128)
    return launch<TM, 8, 4>(pre, idx, center, w1, b1, w2, b2, R, N, M, C1,
                            out, stream);
  return launch<TM, 8, 8>(pre, idx, center, w1, b1, w2, b2, R, N, M, C1, out,
                          stream);
}

}  // namespace

extern "C" int tpu3d_fused_sa(const float* pre, const int* idx,
                              const float* center, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, int R, int N, int M, int S,
                              int C1, int C2, int C3, float* out,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool widths_ok = (C2 == 128 || C2 == 256) && (C3 == 128 || C3 == 256);
  if (R < 1 || R > 65535 || N < 1 || M < 1 || C1 < 4 || C1 > 256
      || C1 % 4 != 0 || !widths_ok)
    return (int)cudaErrorInvalidValue;
  switch (S) {
    case 16:
      return (int)launch_c<2>(pre, idx, center, w1, b1, w2, b2, R, N, M, C1,
                              C2, C3, out, stream);
    case 32:
      return (int)launch_c<4>(pre, idx, center, w1, b1, w2, b2, R, N, M, C1,
                              C2, C3, out, stream);
    case 64:
      return (int)launch_c<8>(pre, idx, center, w1, b1, w2, b2, R, N, M, C1,
                              C2, C3, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
