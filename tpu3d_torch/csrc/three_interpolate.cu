// Three-point interpolation, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/interpolate.py::_ti_fwd_kernel:
//   out[b, m, :] = w[b,m,0]·F[b, idx[b,m,0], :] + w[b,m,1]·F[b, idx[b,m,1], :]
//                + w[b,m,2]·F[b, idx[b,m,2], :]
// in f32, summed in that order (the build passes -fmad=false). The TPU
// kernel builds bf16 one-hot rows and multiplies them by the table on the
// MXU because random row gathers are slow there; on Hopper a row gather is
// an ordinary coalesced load, so the port gathers and keeps f32.
//
// Bound on the card: bytes. Each output row reads 3 table rows and writes
// one, with 2 flops per gathered value: far below the card's
// flops-per-byte balance. Design: one warp per output row, lanes across the
// channels (16-byte float4 loads and stores when C % 4 == 0), so every
// gathered row is read as whole 128-byte lines. The table (4 MB at FP_0)
// stays in L2 across the rows that share a neighbour.
//
// The bf16 form (entry tpu3d_three_interpolate_bf16) is the kernel under the
// accelerator's numerics contract (tpu3d_torch/precision.py), where the FP
// levels' source features are bf16. It reads the bf16 table and computes
// each value in f32: with ROUND_W, as the TPU kernel's one-hot rows give it
// (_ti_fwd_kernel and its twin _three_interpolate_onehot), bf16(w_j) times
// the bf16 feature, whose products are exact in f32, summed in neighbour
// order and written in bf16; without, as tpu3d's gather route gives it
// (f32 weights, f32 sums, f32 output). One warp per output row, 8 channels
// (16 bytes) a lane when C % 8 == 0. Bound: bytes, half the f32 form's
// table and output traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_check.cuh"

namespace {

constexpr int kThreads = 256;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
three_interpolate_kernel(const float* __restrict__ feats,
                         const int* __restrict__ idx,
                         const float* __restrict__ w, int B, int N, int M,
                         int C, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= (long long)B * M) return;
  const int b = (int)(row / M);
  const int* ir = idx + row * 3;
  const float* wr = w + row * 3;
  const float* base = feats + (size_t)b * N * C;
  const float* f0 = base + (size_t)ir[0] * C;
  const float* f1 = base + (size_t)ir[1] * C;
  const float* f2 = base + (size_t)ir[2] * C;
  const float w0 = wr[0], w1 = wr[1], w2 = wr[2];
  float* o = out + row * C;
  if (VEC) {
    const int c4 = C >> 2;
    for (int c = lane; c < c4; c += 32) {
      const float4 a = reinterpret_cast<const float4*>(f0)[c];
      const float4 e = reinterpret_cast<const float4*>(f1)[c];
      const float4 g = reinterpret_cast<const float4*>(f2)[c];
      float4 r;
      r.x = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.x), __fmul_rn(w1, e.x)),
                      __fmul_rn(w2, g.x));
      r.y = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.y), __fmul_rn(w1, e.y)),
                      __fmul_rn(w2, g.y));
      r.z = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.z), __fmul_rn(w1, e.z)),
                      __fmul_rn(w2, g.z));
      r.w = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.w), __fmul_rn(w1, e.w)),
                      __fmul_rn(w2, g.w));
      reinterpret_cast<float4*>(o)[c] = r;
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      o[c] = __fadd_rn(__fadd_rn(__fmul_rn(w0, f0[c]), __fmul_rn(w1, f1[c])),
                       __fmul_rn(w2, f2[c]));
    }
  }
}

template <bool ROUND_W, bool VEC>
__global__ void __launch_bounds__(kThreads)
three_interpolate_bf16_kernel(const __nv_bfloat16* __restrict__ feats,
                              const int* __restrict__ idx,
                              const float* __restrict__ w, int B, int N, int M,
                              int C, void* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= (long long)B * M) return;
  const int b = (int)(row / M);
  const int* ir = idx + row * 3;
  const float* wr = w + row * 3;
  const __nv_bfloat16* base = feats + (size_t)b * N * C;
  const __nv_bfloat16* f0 = base + (size_t)ir[0] * C;
  const __nv_bfloat16* f1 = base + (size_t)ir[1] * C;
  const __nv_bfloat16* f2 = base + (size_t)ir[2] * C;
  float w0 = wr[0], w1 = wr[1], w2 = wr[2];
  if (ROUND_W) {
    w0 = __bfloat162float(__float2bfloat16_rn(w0));
    w1 = __bfloat162float(__float2bfloat16_rn(w1));
    w2 = __bfloat162float(__float2bfloat16_rn(w2));
  }
  auto value = [&](float a, float e, float g) {
    return __fadd_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, e)),
                     __fmul_rn(w2, g));
  };
  if (VEC) {
    for (int c = lane; c < (C >> 3); c += 32) {
      const uint4 ra = reinterpret_cast<const uint4*>(f0)[c];
      const uint4 re = reinterpret_cast<const uint4*>(f1)[c];
      const uint4 rg = reinterpret_cast<const uint4*>(f2)[c];
      const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(&ra);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&re);
      const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(&rg);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = value(__bfloat162float(a[j]), __bfloat162float(e[j]),
                     __bfloat162float(g[j]));
      if (ROUND_W) {
        uint4 packed;
        __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(v[j]);
        reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) +
                                 row * C)[c] = packed;
      } else {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) +
                                              row * C) + 2 * c;
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float v = value(__bfloat162float(f0[c]), __bfloat162float(f1[c]),
                            __bfloat162float(f2[c]));
      if (ROUND_W)
        static_cast<__nv_bfloat16*>(out)[row * C + c] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[row * C + c] = v;
    }
  }
}

}  // namespace

// feats (B, N, C) bf16, idx (B, M, 3) i32, w (B, M, 3) f32 -> out (B, M, C),
// bf16 with round_w, else f32.
extern "C" int tpu3d_three_interpolate_bf16(const __nv_bfloat16* feats,
                                            const int* idx, const float* w,
                                            int B, int N, int M, int C,
                                            int round_w, void* out,
                                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || N < 1 || M < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * M;
  const int rows_per_block = kThreads / 32;
  const unsigned blocks =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  const bool vec = C % 8 == 0;
  if (round_w && vec)
    three_interpolate_bf16_kernel<true, true><<<blocks, kThreads, 0, stream>>>(
        feats, idx, w, B, N, M, C, out);
  else if (round_w)
    three_interpolate_bf16_kernel<true, false><<<blocks, kThreads, 0, stream>>>(
        feats, idx, w, B, N, M, C, out);
  else if (vec)
    three_interpolate_bf16_kernel<false, true><<<blocks, kThreads, 0, stream>>>(
        feats, idx, w, B, N, M, C, out);
  else
    three_interpolate_bf16_kernel<false, false>
        <<<blocks, kThreads, 0, stream>>>(feats, idx, w, B, N, M, C, out);
  return (int)cudaGetLastError();
}

extern "C" int tpu3d_three_interpolate(const float* feats, const int* idx,
                                       const float* w, int B, int N, int M,
                                       int C, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || N < 1 || M < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * M;
  const int rows_per_block = kThreads / 32;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (C % 4 == 0)
    three_interpolate_kernel<true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        feats, idx, w, B, N, M, C, out);
  else
    three_interpolate_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        feats, idx, w, B, N, M, C, out);
  return (int)cudaGetLastError();
}
