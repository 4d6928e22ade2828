// Shared by fused_sa.cu (forward, eval and train) and fused_sa_bwd.cu: the
// block shape, the register-tiled dense layer over a slab in shared memory,
// and the two loads of a group's x0: gathered (pre[idx] - center) or read
// from a grouped slab in device memory.

#pragma once

#include <cuda_runtime.h>

#include "launch_check.cuh"

namespace fused_sa {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 32;  // weight rows per staged slice

// acc = X @ W for this thread's tile: rows warp*TM + i of X (shared, S x cin
// row-major), columns q*128 + 4*lane + r (q < TN/4, r < 4) of W (global,
// cin x 32*TN row-major), staged kKC rows at a time through wbuf. Begins
// with a block barrier, so whatever wrote X (or last read wbuf) before the
// call is ordered before it; the caller needs another barrier before it
// reuses wbuf after the call.
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

// x0 = ReLU(pre[row, idx[group, s]] - center[group]) for every slot s of
// one (row, center) group into X (S x C1, shared), one warp per slot.
// An id outside [0, N) stops the kernel.
__device__ __forceinline__ void gather_x0(const float* __restrict__ pre,
                                          const int* __restrict__ idx,
                                          const float* __restrict__ center,
                                          size_t group, int row, int N,
                                          int S, int C1, float* X) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4* ctr = reinterpret_cast<const float4*>(center + group * C1);
  for (int s = warp; s < S; s += kWarps) {
    const int p = idx[group * S + s];
    if ((unsigned)p >= (unsigned)N) __trap();  // an id outside the row
    const float4* src =
        reinterpret_cast<const float4*>(pre + ((size_t)row * N + p) * C1);
    float4* dst = reinterpret_cast<float4*>(X + s * C1);
    for (int c = lane; c < C1 / 4; c += 32) {
      const float4 v = src[c];
      const float4 k = ctr[c];
      dst[c] = make_float4(fmaxf(v.x - k.x, 0.0f), fmaxf(v.y - k.y, 0.0f),
                           fmaxf(v.z - k.z, 0.0f), fmaxf(v.w - k.w, 0.0f));
    }
  }
}

// The slab form: x0 = ReLU(slab[group, s]·mul + add) for every slot s of one
// group, its S x C1 rows read in place from the (groups, S, C1) slab into X;
// without AFFINE (mul and add unused) x0 = ReLU(slab[group, s]).
template <bool AFFINE>
__device__ __forceinline__ void load_x0(const float* __restrict__ slab,
                                        const float* __restrict__ mul,
                                        const float* __restrict__ add,
                                        size_t group, int S, int C1,
                                        float* X) {
  const float4* src =
      reinterpret_cast<const float4*>(slab + group * (size_t)S * C1);
  float4* dst = reinterpret_cast<float4*>(X);
  for (int q = threadIdx.x; q < S * C1 / 4; q += kThreads) {
    float4 v = src[q];
    if constexpr (AFFINE) {
      const int c = (4 * q) % C1;
      const float4 m = *reinterpret_cast<const float4*>(mul + c);
      const float4 a = *reinterpret_cast<const float4*>(add + c);
      v = make_float4(fmaf(v.x, m.x, a.x), fmaf(v.y, m.y, a.y),
                      fmaf(v.z, m.z, a.z), fmaf(v.w, m.w, a.w));
    }
    dst[q] = make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f),
                         fmaxf(v.w, 0.0f));
  }
}

}  // namespace fused_sa
