// Fused two-layer MLP + max-pool over grouped points, for Hopper (sm_90a):
// the eval forward and the training forward, each in two forms of its input.
//
// The gather form replaces tpu3d/ops/fused_sa.py::_nobn2_eval_kernel (entry
// fused_gathered_mlp_pool(train=False)) and the forward half of training,
// _nobn2_fwd_kernel: for every (row, center),
// x0[s] = pre[row, idx[row, center, s]] - center_term[row, center], then
// ReLU -> Dense+b1 -> ReLU -> Dense+b2 -> ReLU -> max over the S slots.
//
// The slab form reads x0[s] as row s of the group in a grouped (R, M, S, C1)
// slab that the caller built in device memory, and takes one per-channel
// affine (mul, add) per layer: a_l = ReLU(x_l·mul_l + add_l), with
// x_{l+1} = a_l W_{l+1} (Dense without bias), then the max of a_2 over S.
// It replaces two TPU kernels with one: _nobn_eval_kernel and
// _nobn_fwd_kernel (entry fused_mlp_pool; the caller passes mul = 1 and
// add = (0, b1, b2)), and the BatchNorm chain's eval kernel
// _eval_chain_kernel (entry fused_bn_mlp_pool(stats=...); the caller folds
// the running statistics into (mul, add), as tpu3d's _bn_consts does).
//
// The training form also writes, per (row, center, channel), the first
// slot s that reaches the max (argmax) and a value of layer 2 there: the
// backward routes the pooled gradient to that one slot. Without BatchNorm
// (entries fused_sa_train, fused_sa_slab_train) that value is the pre-ReLU
// x2·mul2 + add2 (ppre), which fused_sa_bwd.cu reads. With BatchNorm (entry
// fused_sa_slab_bn_train, the final pass of the chain's training forward,
// replacing tpu3d's _fwd_final_kernel; the caller passes the packs of the
// batch statistics) it is the raw Dense output x2 (the RAW flag): the
// BatchNorm backward (fused_sa_bn.cu) needs x̂2 = x2·r2 − μ2·r2 there, and
// recovering x2 from the post-affine value would divide by gamma2. Its
// pooled output is the eval form's to the bit: the same instructions
// compute it, and the argmax is found after, by comparison.
// The TPU kernels round to bf16 at the layer boundaries for the MXU; this
// one computes in f32 throughout (no TF32), so that it is held to the plain
// f32 version, which tpu3d's CPU path equals. Multiply-adds are contracted
// (built without -fmad=false): the kernel is held to a tolerance, not to the
// bit.
//
// Bound on the card: operations. At the RCNN's eval shapes (200 rows, 128 x
// 64 slots of 128 channels at SA_0; 32 x 64 slots, 128 -> 256 at SA_1) the
// two Dense layers are 147 GFLOP against some 60 MB of input, far above the
// f32 ridge; the slab form reads its slab once, 128 f32 per slot against
// 2 x (128 x 128 + 128 x 256) operations, still far above it. Design: one
// block per (row, center), so the S x C1 group is loaded once into shared
// memory (gathered, or read from the slab); eight warps each own S/8 slab
// rows, every lane 4 or 8 output columns (a register tile of S/8 x
// C_out/32), and the weights stream through shared memory in slices of 32
// input channels that all eight warps share. The layer-1 activations stay
// in shared memory for layer 2, and the max over S is a register max per
// warp, then one across the warps through shared memory. The training form
// keeps each warp's first argmax and x2 there in the weight buffer once
// layer 2 is done with it, so both forms take the same shared memory and two
// blocks fit on an SM.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_sa_common.cuh"

namespace {

using fused_sa::dense;
using fused_sa::gather_x0;
using fused_sa::kKC;
using fused_sa::kThreads;
using fused_sa::kWarps;
using fused_sa::load_x0;

// The pointers of one launch. Gather form: pre (R, N, C1), idx, center;
// layer l's pre-activation is acc + b_l (mul0, add0, m1, m2 null). Slab
// form: pre is the (R, M, S, C1) slab, idx and center null; layer 0's affine
// is (mul0, add0), layer l's pre-activation fmaf(acc, m_l, b_l).
struct Args {
  const float* pre;
  const int* idx;
  const float* center;
  const float* mul0;
  const float* add0;
  const float* w1;
  const float* m1;
  const float* b1;
  const float* w2;
  const float* m2;
  const float* b2;
  float* out;
  int* argmax;
  float* ppre;
};

// the multipliers of 4 columns of a layer: 1 in the gather form
template <bool SLAB>
__device__ __forceinline__ float4 mul4(const float* m, int col) {
  if constexpr (SLAB)
    return *reinterpret_cast<const float4*>(m + col);
  else
    return make_float4(1.0f, 1.0f, 1.0f, 1.0f);
}

template <int TM, int TN2, int TN3, bool TRAIN, bool SLAB, bool RAW>
__global__ void __launch_bounds__(kThreads, 2)
fused_sa_kernel(const Args a, int N, int M, int C1) {
  constexpr int S = kWarps * TM;
  constexpr int C2 = 32 * TN2;
  constexpr int C3 = 32 * TN3;
  constexpr int kWbuf = kKC * (C2 > C3 ? C2 : C3);
  static_assert(!TRAIN || kWbuf >= 2 * kWarps * C3, "argmax scratch");
  extern __shared__ float smem[];
  float* x0 = smem;            // S x C1: layer 0's activation
  float* x1 = x0 + S * C1;     // S x C2: layer 1's activation
  float* wbuf = x1 + S * C2;   // kKC x max(C2, C3)
  float* red = wbuf + kWbuf;   // kWarps x C3: per-warp column maxima

  const int m = blockIdx.x;
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t group = (size_t)row * M + m;
  if constexpr (SLAB)
    load_x0<true>(a.pre, a.mul0, a.add0, group, S, C1, x0);
  else
    gather_x0(a.pre, a.idx, a.center, group, row, N, S, C1, x0);

  {  // layer 1 (the barrier in dense() orders the load before it)
    float acc[TM][TN2];
    dense<TM, TN2>(x0, C1, a.w1, wbuf, acc);
#pragma unroll
    for (int q = 0; q < TN2 / 4; ++q) {
      const int col = q * 128 + 4 * lane;
      const float4 b = *reinterpret_cast<const float4*>(a.b1 + col);
      const float4 k = mul4<SLAB>(a.m1, col);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        *reinterpret_cast<float4*>(x1 + (warp * TM + i) * C2 + col) =
            make_float4(fmaxf(fmaf(acc[i][4 * q], k.x, b.x), 0.0f),
                        fmaxf(fmaf(acc[i][4 * q + 1], k.y, b.y), 0.0f),
                        fmaxf(fmaf(acc[i][4 * q + 2], k.z, b.z), 0.0f),
                        fmaxf(fmaf(acc[i][4 * q + 3], k.w, b.w), 0.0f));
      }
    }
  }
  {  // layer 2, then the max over this warp's rows
    float acc[TM][TN3];
    dense<TM, TN3>(x1, C2, a.w2, wbuf, acc);
    float4 mxs[TN3 / 4];
#pragma unroll
    for (int q = 0; q < TN3 / 4; ++q) {
      const int col = q * 128 + 4 * lane;
      const float4 b = *reinterpret_cast<const float4*>(a.b2 + col);
      const float4 k = mul4<SLAB>(a.m2, col);
      float4 mx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // ReLU output >= 0
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        mx.x = fmaxf(mx.x, fmaf(acc[i][4 * q], k.x, b.x));
        mx.y = fmaxf(mx.y, fmaf(acc[i][4 * q + 1], k.y, b.y));
        mx.z = fmaxf(mx.z, fmaf(acc[i][4 * q + 2], k.z, b.z));
        mx.w = fmaxf(mx.w, fmaf(acc[i][4 * q + 3], k.w, b.w));
      }
      *reinterpret_cast<float4*>(red + warp * C3 + col) = mx;
      mxs[q] = mx;
    }
    if constexpr (TRAIN) {
      // the first of this warp's rows whose ReLU(x2·mul2 + add2) reaches
      // the warp's max, and there x2·mul2 + add2 (or x2 itself, RAW), into
      // the weight buffer
      __syncthreads();  // every warp is done with the last weight slice
      int* warg = reinterpret_cast<int*>(wbuf);
      float* wpre = wbuf + kWarps * C3;
#pragma unroll
      for (int q = 0; q < TN3 / 4; ++q) {
        const int col = q * 128 + 4 * lane;
        const float4 b = *reinterpret_cast<const float4*>(a.b2 + col);
        const float4 k = mul4<SLAB>(a.m2, col);
        const float bb[4] = {b.x, b.y, b.z, b.w};
        const float kk[4] = {k.x, k.y, k.z, k.w};
        const float mv[4] = {mxs[q].x, mxs[q].y, mxs[q].z, mxs[q].w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int first = -1;
          float px = 0.0f;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float v = fmaf(acc[i][4 * q + r], kk[r], bb[r]);
            if (first < 0 && fmaxf(v, 0.0f) == mv[r]) {
              first = i;
              px = RAW ? acc[i][4 * q + r] : v;
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
    a.out[group * C3 + c] = v;
    if constexpr (TRAIN) {
      const int* warg = reinterpret_cast<const int*>(wbuf);
      const float* wpre = wbuf + kWarps * C3;
      int w = 0;
      while (w < kWarps - 1 && red[w * C3 + c] != v) ++w;
      a.argmax[group * C3 + c] = warg[w * C3 + c];
      a.ppre[group * C3 + c] = wpre[w * C3 + c];
    }
  }
}

template <int TM, int TN2, int TN3, bool TRAIN, bool SLAB, bool RAW>
cudaError_t launch(const Args& a, int R, int N, int M, int C1,
                   cudaStream_t stream) {
  constexpr int S = kWarps * TM;
  constexpr int C2 = 32 * TN2;
  constexpr int C3 = 32 * TN3;
  const size_t floats = (size_t)S * C1 + S * C2 + kKC * (C2 > C3 ? C2 : C3)
                        + kWarps * C3;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_kernel<TM, TN2, TN3, TRAIN, SLAB, RAW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(M, R);
  fused_sa_kernel<TM, TN2, TN3, TRAIN, SLAB, RAW>
      <<<grid, kThreads, smem, stream>>>(a, N, M, C1);
  return cudaGetLastError();
}

template <int TM, bool TRAIN, bool SLAB, bool RAW>
cudaError_t launch_c(const Args& a, int R, int N, int M, int C1, int C2,
                     int C3, cudaStream_t stream) {
  if (C2 == 128 && C3 == 128)
    return launch<TM, 4, 4, TRAIN, SLAB, RAW>(a, R, N, M, C1, stream);
  if (C2 == 128 && C3 == 256)
    return launch<TM, 4, 8, TRAIN, SLAB, RAW>(a, R, N, M, C1, stream);
  if constexpr (SLAB) {  // the slab form takes C2 = 128 only
    return cudaErrorInvalidValue;
  } else {
    if (C2 == 256 && C3 == 128)
      return launch<TM, 8, 4, TRAIN, SLAB, RAW>(a, R, N, M, C1, stream);
    return launch<TM, 8, 8, TRAIN, SLAB, RAW>(a, R, N, M, C1, stream);
  }
}

template <bool TRAIN, bool SLAB, bool RAW = false>
int dispatch(const Args& a, int R, int N, int M, int S, int C1, int C2,
             int C3, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const bool widths_ok = (C2 == 128 || C2 == 256) && (C3 == 128 || C3 == 256);
  if (R < 1 || R > 65535 || (!SLAB && N < 1) || M < 1 || C1 < 4 || C1 > 256
      || C1 % 4 != 0 || !widths_ok)
    return (int)cudaErrorInvalidValue;
  switch (S) {
    case 16:
      return (int)launch_c<2, TRAIN, SLAB, RAW>(a, R, N, M, C1, C2, C3, stream);
    case 32:
      return (int)launch_c<4, TRAIN, SLAB, RAW>(a, R, N, M, C1, C2, C3, stream);
    case 64:
      return (int)launch_c<8, TRAIN, SLAB, RAW>(a, R, N, M, C1, C2, C3, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The slab form's pointers: packs = [mul0 | add0 (C1) | mul1 | add1 (C2) |
// mul2 | add2 (C3)]
Args slab_args(const float* x0, const float* packs, const float* w1,
               const float* w2, int C1, int C2, int C3, float* out,
               int* argmax, float* ppre) {
  const float* mul1 = packs + 2 * C1;
  const float* mul2 = mul1 + 2 * C2;
  return Args{x0,   nullptr, nullptr,   packs, packs + C1, w1, mul1,
              mul1 + C2, w2, mul2, mul2 + C3, out,        argmax, ppre};
}

}  // namespace

extern "C" int tpu3d_fused_sa(const float* pre, const int* idx,
                              const float* center, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, int R, int N, int M, int S,
                              int C1, int C2, int C3, float* out,
                              void* stream_ptr) {
  const Args a{pre, idx, center, nullptr, nullptr, w1, nullptr, b1, w2,
               nullptr, b2, out, nullptr, nullptr};
  return dispatch<false, false>(a, R, N, M, S, C1, C2, C3, stream_ptr);
}

extern "C" int tpu3d_fused_sa_train(const float* pre, const int* idx,
                                    const float* center, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, int R, int N, int M,
                                    int S, int C1, int C2, int C3, float* out,
                                    int* argmax, float* ppre,
                                    void* stream_ptr) {
  const Args a{pre, idx, center, nullptr, nullptr, w1, nullptr, b1, w2,
               nullptr, b2, out, argmax, ppre};
  return dispatch<true, false>(a, R, N, M, S, C1, C2, C3, stream_ptr);
}

// The slab form, eval: x0 (R, M, S, 128), packs as slab_args takes them,
// w1 (128, 128), w2 (128, C3) with C3 128 or 256 -> out (R, M, C3).
extern "C" int tpu3d_fused_sa_slab(const float* x0, const float* packs,
                                   const float* w1, const float* w2, int R,
                                   int M, int S, int C1, int C2, int C3,
                                   float* out, void* stream_ptr) {
  if (C1 != 128 || C2 != 128) return (int)cudaErrorInvalidValue;
  return dispatch<false, true>(
      slab_args(x0, packs, w1, w2, C1, C2, C3, out, nullptr, nullptr), R, 0,
      M, S, C1, C2, C3, stream_ptr);
}

// The slab form's training forward: as tpu3d_fused_sa_slab, and argmax,
// ppre (R, M, C3).
extern "C" int tpu3d_fused_sa_slab_train(const float* x0, const float* packs,
                                         const float* w1, const float* w2,
                                         int R, int M, int S, int C1, int C2,
                                         int C3, float* out, int* argmax,
                                         float* ppre, void* stream_ptr) {
  if (C1 != 128 || C2 != 128) return (int)cudaErrorInvalidValue;
  return dispatch<true, true>(
      slab_args(x0, packs, w1, w2, C1, C2, C3, out, argmax, ppre), R, 0, M,
      S, C1, C2, C3, stream_ptr);
}

// The BatchNorm chain's training forward, final pass: as
// tpu3d_fused_sa_slab_train with the packs of the batch statistics, but
// ppre holds the raw Dense output x2 at the argmax (RAW).
extern "C" int tpu3d_fused_sa_slab_bn_train(const float* x0,
                                            const float* packs,
                                            const float* w1, const float* w2,
                                            int R, int M, int S, int C1,
                                            int C2, int C3, float* out,
                                            int* argmax, float* x2,
                                            void* stream_ptr) {
  if (C1 != 128 || C2 != 128) return (int)cudaErrorInvalidValue;
  return dispatch<true, true, true>(
      slab_args(x0, packs, w1, w2, C1, C2, C3, out, argmax, x2), R, 0, M, S,
      C1, C2, C3, stream_ptr);
}
