// Shared by fused_sa.cu (forward, eval and train), fused_sa_bwd.cu and
// fused_sa_bn.cu: the block shape, the register-tiled dense layers over a
// slab in shared memory (dense, the shipped shapes' form; dense_ld, over
// column tiles of a wider weight), the loads of a chunk of a group's x0
// (gathered, pre[idx] - center, or read from a grouped slab in device
// memory), the cp.async helpers and the fixed-order reduction of per-block
// partials.

#pragma once

#include <cuda_runtime.h>

#include "launch_check.cuh"

namespace fused_sa {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 32;  // weight rows per staged slice
// shared memory a block may use on sm_90 (227 KB)
constexpr size_t kSmemMax = 232448;

// acc = X @ W[:, 0:32*TN] for this thread's tile: rows warp*TM + i of X
// (shared, row stride ldx floats), columns q*128 + 4*lane + r (q < TN/4,
// r < 4) of W (global, cin rows of stride ldw floats, 16-byte aligned),
// staged kKC rows at a time through wbuf (kKC x 32*TN). Begins with a block
// barrier, so whatever wrote X (or last read wbuf) before the call is
// ordered before it; the caller needs another barrier before it reuses
// wbuf after the call.
template <int TM, int TN>
__device__ __forceinline__ void dense_ld(const float* __restrict__ X,
                                         int ldx, int cin,
                                         const float* __restrict__ W,
                                         int ldw, float* __restrict__ wbuf,
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
    float4* dst = reinterpret_cast<float4*>(wbuf);
    for (int q = threadIdx.x; q < kc * kCout / 4; q += kThreads) {
      const int r = q / (kCout / 4), c = q - r * (kCout / 4);
      dst[q] = reinterpret_cast<const float4*>(W + (size_t)(k0 + r) * ldw)[c];
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            X + (warp * TM + i) * ldx + k0 + kk);
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

// x0 = ReLU(pre[row, idx[group, s0 + s]] - center[group]) for the slots
// s < rows of a chunk of one (row, center) group into X (TR x C1, shared),
// one warp per slot; rows rows..TR-1 of X are zeroed. An id outside [0, N)
// stops the kernel.
__device__ __forceinline__ void gather_x0(
    const float* __restrict__ pre, const int* __restrict__ idx,
    const float* __restrict__ center, size_t group, int row, int N, int S,
    int C1, int s0, int rows, int TR, float* X) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4* ctr = reinterpret_cast<const float4*>(center + group * C1);
  for (int s = warp; s < TR; s += kWarps) {
    float4* dst = reinterpret_cast<float4*>(X + s * C1);
    if (s >= rows) {
      for (int c = lane; c < C1 / 4; c += 32)
        dst[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const int p = idx[group * S + s0 + s];
    if ((unsigned)p >= (unsigned)N) __trap();  // an id outside the row
    const float4* src =
        reinterpret_cast<const float4*>(pre + ((size_t)row * N + p) * C1);
    for (int c = lane; c < C1 / 4; c += 32) {
      const float4 v = src[c];
      const float4 k = ctr[c];
      dst[c] = make_float4(fmaxf(v.x - k.x, 0.0f), fmaxf(v.y - k.y, 0.0f),
                           fmaxf(v.z - k.z, 0.0f), fmaxf(v.w - k.w, 0.0f));
    }
  }
}

// The slab form: x0 = ReLU(slab[group, s0 + s]·mul + add) for the slots
// s < rows of a chunk of one group, read in place from the (groups, S, C1)
// slab into X (TR x C1); rows rows..TR-1 are zeroed.
__device__ __forceinline__ void load_x0(
    const float* __restrict__ slab, const float* __restrict__ mul,
    const float* __restrict__ add, size_t group, int S, int C1, int s0,
    int rows, int TR, float* X) {
  const float4* src = reinterpret_cast<const float4*>(
      slab + (group * (size_t)S + s0) * C1);
  float4* dst = reinterpret_cast<float4*>(X);
  const int valid = rows * C1 / 4;
  for (int q = threadIdx.x; q < TR * C1 / 4; q += kThreads) {
    if (q >= valid) {
      dst[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    float4 v = src[q];
    const int c = (4 * q) % C1;
    const float4 m = *reinterpret_cast<const float4*>(mul + c);
    const float4 a = *reinterpret_cast<const float4*>(add + c);
    v = make_float4(fmaf(v.x, m.x, a.x), fmaf(v.y, m.y, a.y),
                    fmaf(v.z, m.z, a.z), fmaf(v.w, m.w, a.w));
    dst[q] = make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f),
                         fmaxf(v.w, 0.0f));
  }
}

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out[e] = the sum of the blocks' partials ws[p][e], in block order
template <typename T>
__global__ void reduce_partials(const T* __restrict__ ws, int parts,
                                long long per, T* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per) return;
  T s = 0;
  for (int p = 0; p < parts; ++p) s += ws[(size_t)p * per + e];
  out[e] = s;
}

template <typename T>
inline cudaError_t reduce(const T* ws, int parts, long long per, T* out,
                          cudaStream_t stream) {
  reduce_partials<T><<<(unsigned)((per + 255) / 256), 256, 0, stream>>>(
      ws, parts, per, out);
  return cudaGetLastError();
}

}  // namespace fused_sa
