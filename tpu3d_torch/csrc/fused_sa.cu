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
// slot s that reaches the max (argmax) and the pre-ReLU x2·mul2 + add2
// there (ppre), which fused_sa_bwd.cu reads. Its pooled output is the eval
// form's to the bit: the same instructions compute it, and the argmax is
// found after, by comparison.
// The TPU kernels round to bf16 at the layer boundaries for the MXU; this
// one computes in f32 throughout (no TF32), so that it is held to the plain
// f32 version, which tpu3d's CPU path equals. Multiply-adds are contracted
// (built without -fmad=false): the kernel is held to a tolerance, not to the
// bit.
//
// Shapes: every shape tpu3d's fused_sa_supported admits (S a multiple of 8,
// widths multiples of 128), C1 any multiple of 4, any R and M. Two kernels:
// fused_sa_kernel at the shapes the shipped configs run (S 16, 32
// or 64, C1 up to 256, C2 and C3 each 128 or 256 (C2 128 in the slab form),
// R up to 65535: a group is one chunk of slots and one tile of each layer,
// on a (center, row) grid), and fused_sa_wide_kernel at every other shape,
// on a flat grid.
//
// Bound on the card: operations. At the RCNN's eval shapes (200 rows, 128 x
// 64 slots of 128 channels at SA_0; 32 x 64 slots, 128 -> 256 at SA_1) the
// two Dense layers are 147 GFLOP against some 60 MB of input, far above the
// f32 ridge; the slab form reads its slab once, 128 f32 per slot against
// 2 x (128 x 128 + 128 x 256) operations, still far above it. Design: one
// block per (row, center) walks the group's S slots in chunks of TR = 8·TM
// rows (TR = 64 at most, fewer where the widths would overflow shared
// memory; the rows past S in the last chunk are zero and take no part in
// the max), so each chunk's TR x C1 slots are loaded once into shared
// memory (gathered, or read from the slab). Eight warps each own TM chunk
// rows; layer 1 runs in 128-column tiles of C2 into the chunk's a1 in
// shared memory, layer 2 in tiles of CT3 = 128 or 256 columns of C3 over
// it, so nothing is recomputed; every lane holds 4 or 8 output columns of a
// tile (a register tile of TM x 4 or TM x 8), and the weights stream
// through shared memory in slices of 32 input channels that all eight warps
// share. The max over the chunk is a register max per warp, then one across
// the warps through shared memory; a later chunk replaces the running
// (max, argmax, ppre) of a channel, kept in the outputs by the thread that
// owns the channel, only on a strictly greater value, so the first argmax
// holds. The training form keeps each warp's first argmax and ppre in the
// weight buffer once the tile's layer 2 is done with it. fused_sa_kernel is
// the same design with one chunk and one tile, its shapes compiled in (the
// wide kernel at those shapes ran 6-20% slower on an H100); two
// blocks fit on an SM.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_sa_common.cuh"

namespace {

using fused_sa::dense;
using fused_sa::dense_ld;
using fused_sa::gather_x0;
using fused_sa::kKC;
using fused_sa::kSmemMax;
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

// The shipped shapes' kernel: S = 8·TM slots (16, 32 or 64), C1 up to 256,
// C2 and C3 each 128 or 256 (TN2, TN3 = 4 or 8): one chunk of slots and one
// tile of each layer, its widths compiled in.
template <int TM, int TN2, int TN3, bool TRAIN, bool SLAB>
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
  if constexpr (SLAB)  // the group is one chunk
    load_x0(a.pre, a.mul0, a.add0, group, S, C1, 0, S, S, x0);
  else
    gather_x0(a.pre, a.idx, a.center, group, row, N, S, C1, 0, S, S, x0);

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
      // the warp's max, and there x2·mul2 + add2, into the weight buffer
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

template <int TM, int TN2, int TN3, bool TRAIN, bool SLAB>
cudaError_t launch_shipped(const Args& a, int R, int N, int M, int C1,
                   cudaStream_t stream) {
  constexpr int S = kWarps * TM;
  constexpr int C2 = 32 * TN2;
  constexpr int C3 = 32 * TN3;
  const size_t floats = (size_t)S * C1 + S * C2 + kKC * (C2 > C3 ? C2 : C3)
                        + kWarps * C3;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_kernel<TM, TN2, TN3, TRAIN, SLAB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(M, R);
  fused_sa_kernel<TM, TN2, TN3, TRAIN, SLAB>
      <<<grid, kThreads, smem, stream>>>(a, N, M, C1);
  return cudaGetLastError();
}

template <int TM, bool TRAIN, bool SLAB>
cudaError_t launch_shipped_c(const Args& a, int R, int N, int M, int C1,
                             int C2, int C3, cudaStream_t stream) {
  if (C2 == 128 && C3 == 128)
    return launch_shipped<TM, 4, 4, TRAIN, SLAB>(a, R, N, M, C1, stream);
  if (C2 == 128 && C3 == 256)
    return launch_shipped<TM, 4, 8, TRAIN, SLAB>(a, R, N, M, C1, stream);
  if constexpr (SLAB) {  // the slab form takes C2 = 128 only
    return cudaErrorInvalidValue;
  } else {
    if (C2 == 256 && C3 == 128)
      return launch_shipped<TM, 8, 4, TRAIN, SLAB>(a, R, N, M, C1, stream);
    return launch_shipped<TM, 8, 8, TRAIN, SLAB>(a, R, N, M, C1, stream);
  }
}

// floats of a launch's shared memory: the chunk's x0 and a1, the weight
// slices (layer 1's 128-column tiles or layer 2's CT3), the per-warp maxima
template <int TM, int TN3>
size_t smem_floats(int C1, int C2) {
  constexpr int CT3 = 32 * TN3;
  return (size_t)kWarps * TM * (C1 + C2) + kKC * (CT3 > 128 ? CT3 : 128)
         + kWarps * CT3;
}

template <int TM, int TN3, bool TRAIN, bool SLAB>
__global__ void __launch_bounds__(kThreads, 2)
fused_sa_wide_kernel(const Args a, int N, int M, int S, int C1, int C2,
                     int C3) {
  constexpr int TR = kWarps * TM;  // rows of a chunk
  constexpr int CT3 = 32 * TN3;    // columns of a layer-2 tile
  constexpr int kWbuf = kKC * (CT3 > 128 ? CT3 : 128);
  static_assert(!TRAIN || kWbuf >= 2 * kWarps * CT3, "argmax scratch");
  extern __shared__ float smem[];
  float* x0 = smem;            // TR x C1: layer 0's activation
  float* x1 = x0 + TR * C1;    // TR x C2: layer 1's activation
  float* wbuf = x1 + TR * C2;  // the weight slices
  float* red = wbuf + kWbuf;   // kWarps x CT3: per-warp column maxima

  const size_t group = blockIdx.x;
  const int row = (int)(group / M);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < S; s0 += TR) {
    const int rows = min(TR, S - s0);
    __syncthreads();  // the last chunk is done with x0
    if constexpr (SLAB)
      load_x0(a.pre, a.mul0, a.add0, group, S, C1, s0, rows, TR, x0);
    else
      gather_x0(a.pre, a.idx, a.center, group, row, N, S, C1, s0, rows, TR,
                x0);
    // layer 1 in 128-column tiles of C2 (the barrier in dense_ld() orders
    // the load, and the last chunk's reads of x1, before each tile)
    for (int c2 = 0; c2 < C2; c2 += 128) {
      float acc[TM][4];
      dense_ld<TM, 4>(x0, C1, C1, a.w1 + c2, C2, wbuf, acc);
      const int col = c2 + 4 * lane;
      const float4 b = *reinterpret_cast<const float4*>(a.b1 + col);
      const float4 k = mul4<SLAB>(a.m1, col);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(x1 + (warp * TM + i) * C2 + col) =
            make_float4(fmaxf(fmaf(acc[i][0], k.x, b.x), 0.0f),
                        fmaxf(fmaf(acc[i][1], k.y, b.y), 0.0f),
                        fmaxf(fmaf(acc[i][2], k.z, b.z), 0.0f),
                        fmaxf(fmaf(acc[i][3], k.w, b.w), 0.0f));
    }
    // layer 2 in tiles of CT3 columns of C3, then the max over the chunk
    for (int c3 = 0; c3 < C3; c3 += CT3) {
      float acc[TM][TN3];
      dense_ld<TM, TN3>(x1, C2, C2, a.w2 + c3, C3, wbuf, acc);
      float4 mxs[TN3 / 4];
#pragma unroll
      for (int q = 0; q < TN3 / 4; ++q) {
        const int col = c3 + q * 128 + 4 * lane;
        const float4 b = *reinterpret_cast<const float4*>(a.b2 + col);
        const float4 k = mul4<SLAB>(a.m2, col);
        float4 mx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // ReLU output >= 0
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (warp * TM + i >= rows) continue;  // past S
          mx.x = fmaxf(mx.x, fmaf(acc[i][4 * q], k.x, b.x));
          mx.y = fmaxf(mx.y, fmaf(acc[i][4 * q + 1], k.y, b.y));
          mx.z = fmaxf(mx.z, fmaf(acc[i][4 * q + 2], k.z, b.z));
          mx.w = fmaxf(mx.w, fmaf(acc[i][4 * q + 3], k.w, b.w));
        }
        *reinterpret_cast<float4*>(red + warp * CT3 + q * 128 + 4 * lane) =
            mx;
        mxs[q] = mx;
      }
      if constexpr (TRAIN) {
        // the first of this warp's rows whose ReLU(x2·mul2 + add2) reaches
        // the warp's max, and there x2·mul2 + add2, into the weight buffer
        __syncthreads();  // every warp is done with the last weight slice
        int* warg = reinterpret_cast<int*>(wbuf);
        float* wpre = wbuf + kWarps * CT3;
#pragma unroll
        for (int q = 0; q < TN3 / 4; ++q) {
          const int tc = q * 128 + 4 * lane;
          const float4 b = *reinterpret_cast<const float4*>(a.b2 + c3 + tc);
          const float4 k = mul4<SLAB>(a.m2, c3 + tc);
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
              if (first < 0 && warp * TM + i < rows
                  && fmaxf(v, 0.0f) == mv[r]) {
                first = i;
                px = v;
              }
            }
            warg[warp * CT3 + tc + r] = warp * TM + first;
            wpre[warp * CT3 + tc + r] = px;
          }
        }
      }
      __syncthreads();
      for (int c = threadIdx.x; c < CT3; c += kThreads) {
        float v = red[c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w * CT3 + c]);
        const size_t at = group * C3 + c3 + c;
        // a later chunk wins only on a strictly greater value; this thread
        // wrote the channel's running values for the chunks before
        if (s0 > 0 && !(v > a.out[at])) continue;
        a.out[at] = v;
        if constexpr (TRAIN) {
          const int* warg = reinterpret_cast<const int*>(wbuf);
          const float* wpre = wbuf + kWarps * CT3;
          int w = 0;
          while (w < kWarps - 1 && red[w * CT3 + c] != v) ++w;
          a.argmax[at] = s0 + warg[w * CT3 + c];
          a.ppre[at] = wpre[w * CT3 + c];
        }
      }
      // the next tile's dense_ld() begins with a barrier before it writes
      // wbuf, and red is written only after it
    }
  }
}

template <int TM, int TN3, bool TRAIN, bool SLAB>
cudaError_t launch(const Args& a, int R, int N, int M, int S, int C1, int C2,
                   int C3, cudaStream_t stream) {
  const size_t smem = smem_floats<TM, TN3>(C1, C2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_wide_kernel<TM, TN3, TRAIN, SLAB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long groups = (long long)R * M;
  fused_sa_wide_kernel<TM, TN3, TRAIN, SLAB>
      <<<(unsigned)groups, kThreads, smem, stream>>>(a, N, M, S, C1, C2, C3);
  return cudaGetLastError();
}

// The chunk rows per warp for (S, C1, C2, C3): 8 (64-row chunks) for S >
// 32, else the fewest that hold S (S = 8, 16, 24-32), halved while the
// chunk's slabs overflow shared memory; 0 where even one row per warp does
// not fit. ops/fused_sa.py::forward_rows_per_warp computes the same.
int rows_per_warp(int S, int C1, int C2, int C3) {
  int tm = S > 32 ? 8 : S > 16 ? 4 : S > 8 ? 2 : 1;
  const bool wide = C3 % 256 == 0;
  for (; tm >= 1; tm /= 2) {
    const size_t floats = (size_t)kWarps * tm * (C1 + C2)
                          + (size_t)(kKC + kWarps) * (wide ? 256 : 128);
    if (floats * sizeof(float) <= kSmemMax) return tm;
  }
  return 0;
}

template <int TM, bool TRAIN, bool SLAB>
cudaError_t launch_c(const Args& a, int R, int N, int M, int S, int C1,
                     int C2, int C3, cudaStream_t stream) {
  if (C3 % 256 == 0)
    return launch<TM, 8, TRAIN, SLAB>(a, R, N, M, S, C1, C2, C3, stream);
  return launch<TM, 4, TRAIN, SLAB>(a, R, N, M, S, C1, C2, C3, stream);
}

template <bool TRAIN, bool SLAB>
int dispatch(const Args& a, int R, int N, int M, int S, int C1, int C2,
             int C3, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (R < 1 || (!SLAB && N < 1) || M < 1 || (long long)R * M > 0x7fffffffLL
      || S < 8 || S % 8 != 0 || C1 < 4 || C1 % 4 != 0 || C2 < 128
      || C2 % 128 != 0 || C3 < 128 || C3 % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const bool shipped = (S == 16 || S == 32 || S == 64) && C1 <= 256
                       && (C2 == 128 || (!SLAB && C2 == 256))
                       && (C3 == 128 || C3 == 256) && R <= 65535;
  if (shipped) {
    if (S == 16)
      return (int)launch_shipped_c<2, TRAIN, SLAB>(a, R, N, M, C1, C2, C3,
                                                   stream);
    if (S == 32)
      return (int)launch_shipped_c<4, TRAIN, SLAB>(a, R, N, M, C1, C2, C3,
                                                   stream);
    return (int)launch_shipped_c<8, TRAIN, SLAB>(a, R, N, M, C1, C2, C3,
                                                 stream);
  }
  switch (rows_per_warp(S, C1, C2, C3)) {
    case 8:
      return (int)launch_c<8, TRAIN, SLAB>(a, R, N, M, S, C1, C2, C3, stream);
    case 4:
      return (int)launch_c<4, TRAIN, SLAB>(a, R, N, M, S, C1, C2, C3, stream);
    case 2:
      return (int)launch_c<2, TRAIN, SLAB>(a, R, N, M, S, C1, C2, C3, stream);
    case 1:
      return (int)launch_c<1, TRAIN, SLAB>(a, R, N, M, S, C1, C2, C3, stream);
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

// The slab form, eval: x0 (R, M, S, C1), packs as slab_args takes them,
// w1 (C1, C2), w2 (C2, C3) -> out (R, M, C3).
extern "C" int tpu3d_fused_sa_slab(const float* x0, const float* packs,
                                   const float* w1, const float* w2, int R,
                                   int M, int S, int C1, int C2, int C3,
                                   float* out, void* stream_ptr) {
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
  return dispatch<true, true>(
      slab_args(x0, packs, w1, w2, C1, C2, C3, out, argmax, ppre), R, 0, M,
      S, C1, C2, C3, stream_ptr);
}
