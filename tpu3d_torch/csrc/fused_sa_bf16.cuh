// Fused two-layer MLP + max-pool over grouped points in bf16, for Hopper
// (sm_90a): the eval forward under the accelerator's numerics contract
// (tpu3d_torch/precision.py), in three forms of its input, and the training
// forward of the two forms without BatchNorm.
//
// Replaces, in their bf16 arithmetic, tpu3d/ops/fused_sa.py's eval kernels:
//   - _nobn2_eval_kernel (gather form, entry tpu3d_fused_sa_bf16):
//     x0[s] = bf16(pre[row, idx[row, center, s]] - center[row, center]),
//     pre and center bf16 (_gather_x0: the one-hot product of the bf16 table
//     gives its rows exactly);
//   - _nobn_eval_kernel (slab form, entry tpu3d_fused_sa_slab_bf16): x0[s]
//     row s of the group in a grouped bf16 (R, M, S, C1) slab;
//   - _eval_chain_kernel (the slab form with BatchNorm, entry
//     tpu3d_fused_sa_slab_bn_bf16): the same slab with the running
//     statistics folded into one f32 (mul, add) per layer (_bn_consts).
// Then, as _chain_nobn and _chain_to round:
//   no BatchNorm: a0 = ReLU(x0); x1 = bf16(bf16(a0·W1) + bf16(b1));
//                 a1 = ReLU(x1); x2 = bf16(bf16(a1·W2) + bf16(b2));
//                 a2 = ReLU(x2)
//   BatchNorm:    a_k = bf16(ReLU(x_k·mul_k + add_k)) in f32;
//                 x_{k+1} = bf16(a_k·W_{k+1})
// every product of bf16 operands summed in f32, as the TPU's matrix unit
// sums them, and out = max over the S slots of a2, written in bf16.
// The training forward (TRAIN, no BatchNorm; entries tpu3d_fused_sa_train_bf16
// and tpu3d_fused_sa_slab_train_bf16) replaces _nobn2_fwd_kernel (gather
// form, :752) and _nobn_fwd_kernel (slab form, :575) in their bf16
// arithmetic: beside the max it writes each channel's first argmax slot
// (the lowest slot whose a2 reaches the max) and ppre, the pre-ReLU x2
// there, which the backward (fused_sa_bwd_bf16.cu) routes by. The
// per-channel affines and bias adds round each multiply and add (no
// contraction), as the plain version in ops/fused_sa.py does; the products'
// f32 sums run in the tensor cores' order, so the kernel is held to the
// plain version within a tolerance, not to the bit.
//
// Bound on the card: operations. At the RCNN's eval shapes the two Dense
// layers are 2·S·(C1·C2 + C2·C3) per group against 2·S·C1 bytes of input
// (a gathered or slab row of bf16 per slot), far above the bf16 ridge.
// Design, the simple one: warp-level mma.sync.m16n8k16 bf16 products with
// f32 accumulators. A block of four warps takes one (row, center) group at
// a time and walks its S slots in chunks of TM = 16, 32 or 64 rows (the
// rows past S in the last chunk are zero and take no part in the max). The
// chunk's a0 (layer 0's activation, computed while it is staged) goes to
// shared memory as bf16; each warp owns a quarter of the columns of each
// layer and holds TM x 32 of them in registers at a time, its A fragments
// read from shared memory, its B fragments (the weights, the Dense kernels
// in their (out, in) layout) from global memory through the L1 cache; layer
// 1's bf16 activations go back to shared memory for layer 2, whose columns
// are reduced over the chunk's rows in registers and across the warp's
// eight row lanes by shuffles. A later chunk of the same group folds into a
// running max in shared memory, kept by the thread that owns the channel.
// In training the running max carries its slot and x2 beside it: each thread
// walks its rows in ascending order and keeps the first strict maximum, the
// shuffles keep the lower slot of two equal maxima, and a later chunk takes
// over only above the running max.
// Which entry runs which design (each routes by the widths alone):
//   - tpu3d_fused_sa_bf16, tpu3d_fused_sa_slab_bf16 (kernels 5 and 8's
//     eval forms) and tpu3d_fused_sa_slab_bn_bf16 (kernel 9's) run
//     fused_sa_wgmma_eval.cuh's design (wgmma, weights resident in shared
//     memory, a1 and the pool in registers, short groups packed into one
//     tile, kernel 9's affines in its epilogues; its own layout: the
//     weights, per warpgroup a 64-row a0 stage, centers or packs, column
//     maxima) where it takes the widths (C1 = C2 = 128, C3 a multiple of
//     128 up to 512; tpu3d_fused_sa_bf16_design,
//     tpu3d_fused_sa_slab_bn_bf16_design), the wider ones this one;
//   - tpu3d_fused_sa_train_bf16 (kernel 6's training form) runs
//     fused_sa_wgmma.cuh's design (wgmma from shared memory, with the
//     argmax and ppre of training; its layout: the weights, per warpgroup
//     64-row a0 and a1 stages, centers and the pooling state) at C1 = C2 =
//     128 and C3 up to 384 (tpu3d_fused_sa_train_bf16_wgmma), the wider
//     ones this one;
//   - tpu3d_fused_sa_slab_train_bf16 (kernel 8's training forward) runs
//     this one at every width. Its shared memory: a chunk of TM rows of a0
//     and a1 (each row padded by kPad) and the running max (with its slot
//     and x2 in training), pick_mt.
//
// Included by fused_sa.cu (its library holds both numeric forms); the
// kernels live in namespace fused_sa_bf16, the C entries at the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_sa_wgmma.cuh"
#include "fused_sa_wgmma_eval.cuh"
#include "launch_check.cuh"

namespace fused_sa_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;  // bf16 per shared-memory row beyond the width
constexpr int kSmemMax = 232448;

__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][j] += A[m·16.., :K] · Wt[n0 + j·8.., :K]^T for the MT m-tiles of
// the chunk in shared memory (row stride lda) and 4 n-tiles of 8 columns
// from n0; Wt is (N, K) row-major bf16 in global memory.
template <int MT>
__device__ __forceinline__ void mma_cols(float (&acc)[MT][4][4],
                                         const bf16* as, int lda,
                                         const bf16* __restrict__ wt, int K,
                                         int n0, int gq, int tq) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* p = as + (m * 16 + gq) * lda + k0 + 2 * tq;
      a[m][0] = *reinterpret_cast<const uint32_t*>(p);
      a[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
      a[m][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16* q = wt + (size_t)(n0 + j * 8 + gq) * K + k0 + 2 * tq;
      const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(q));
      const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(q + 8));
#pragma unroll
      for (int m = 0; m < MT; ++m) mma16816(acc[m][j], a[m], b0, b1);
    }
  }
}

// The activation of a layer's product v at channel c: without BatchNorm
// ReLU(bf16(bf16(v) + bias[c])) (bias bf16), with it
// bf16(ReLU(bf16(v)·mul[c] + add[c])).
template <bool BN>
__device__ __forceinline__ float activate(float v, int c,
                                          const bf16* __restrict__ bias,
                                          const float* __restrict__ mul,
                                          const float* __restrict__ add) {
  const float x = bfr(v);
  if (BN)
    return bfr(fmaxf(__fadd_rn(__fmul_rn(x, __ldg(mul + c)), __ldg(add + c)),
                     0.f));
  return fmaxf(bfr(__fadd_rn(x, __bfloat162float(bias[c]))), 0.f);
}

// The first strict maximum of a channel and its slot and x2: (mx, ar, pp)
// takes (v, s, x) where v is larger, or equal at a lower slot.
__device__ __forceinline__ void keep_first_max(float& mx, int& ar, float& pp,
                                               float v, int s, float x) {
  if (v > mx || (v == mx && s < ar)) {
    mx = v;
    ar = s;
    pp = x;
  }
}

template <int MT, bool GATHER, bool BN, bool TRAIN>
__global__ void __launch_bounds__(kThreads)
fused_sa_bf16_kernel(const bf16* __restrict__ src, const int* __restrict__ idx,
                     const bf16* __restrict__ center,
                     const float* __restrict__ packs,
                     const bf16* __restrict__ w1t, const bf16* __restrict__ b1,
                     const bf16* __restrict__ w2t, const bf16* __restrict__ b2,
                     int R, int N, int M, int S, int C1, int C2, int C3,
                     bf16* __restrict__ out, int* __restrict__ argmax,
                     float* __restrict__ ppre) {
  constexpr int TM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = C1 + kPad, ldb = C2 + kPad;
  bf16* a0s = reinterpret_cast<bf16*>(smem);
  bf16* a1s = a0s + TM * lda;
  float* pool = reinterpret_cast<float*>(a1s + TM * ldb);
  int* pool_arg = reinterpret_cast<int*>(pool + C3);  // TRAIN: its slot
  float* pool_pre = pool + 2 * C3;                    // TRAIN: its x2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const long long groups = (long long)R * M;
  const int vecs = C1 / 8;  // 16-byte vectors of a row
  // BatchNorm packs: mul0 | add0 | mul1 | add1 | mul2 | add2
  const float* mul0 = packs;
  const float* add0 = BN ? packs + C1 : nullptr;
  const float* mul1 = BN ? packs + 2 * C1 : nullptr;
  const float* add1 = BN ? mul1 + C2 : nullptr;
  const float* mul2 = BN ? add1 + C2 : nullptr;
  const float* add2 = BN ? mul2 + C3 : nullptr;

  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long r = grp / M;
    for (int s0 = 0; s0 < S; s0 += TM) {
      const int valid = min(TM, S - s0);
      const bool first = s0 == 0, last = s0 + TM >= S;
      // stage the chunk's a0, bf16, zeros past the group's S slots
      for (int e = threadIdx.x; e < TM * vecs; e += kThreads) {
        const int row = e / vecs, v = e - row * vecs;
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (row < valid) {
          const int s = s0 + row;
          const bf16* xr =
              GATHER ? src + ((size_t)r * N + idx[grp * S + s]) * C1
                     : src + ((size_t)grp * S + s) * C1;
          const uint4 raw = *reinterpret_cast<const uint4*>(xr + v * 8);
          const bf16* xv = reinterpret_cast<const bf16*>(&raw);
          uint4 craw = make_uint4(0u, 0u, 0u, 0u);
          if (GATHER)
            craw = *reinterpret_cast<const uint4*>(center + (size_t)grp * C1 +
                                                   v * 8);
          const bf16* cv = reinterpret_cast<const bf16*>(&craw);
          bf16* res = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float x = __bfloat162float(xv[j]);
            if (GATHER) x = bfr(__fsub_rn(x, __bfloat162float(cv[j])));
            const int c = v * 8 + j;
            const float a =
                BN ? bfr(fmaxf(__fadd_rn(__fmul_rn(x, __ldg(mul0 + c)),
                                         __ldg(add0 + c)),
                               0.f))
                   : fmaxf(x, 0.f);
            res[j] = __float2bfloat16_rn(a);
          }
        }
        *reinterpret_cast<uint4*>(a0s + row * lda + v * 8) = packed;
      }
      __syncthreads();
      // layer 1: each warp a quarter of C2, 32 columns at a time
      const int q2 = C2 / kWarps;
      for (int n0 = warp * q2; n0 < (warp + 1) * q2; n0 += 32) {
        float acc[MT][4][4];
        mma_cols<MT>(acc, a0s, lda, w1t, C1, n0, gq, tq);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = n0 + j * 8 + 2 * tq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m * 16 + gq + 8 * h;
              __nv_bfloat162 pair;
              pair.x = __float2bfloat16_rn(
                  activate<BN>(acc[m][j][2 * h], c, b1, mul1, add1));
              pair.y = __float2bfloat16_rn(
                  activate<BN>(acc[m][j][2 * h + 1], c + 1, b1, mul1, add1));
              *reinterpret_cast<__nv_bfloat162*>(a1s + row * ldb + c) = pair;
            }
          }
      }
      __syncthreads();
      // layer 2 and the max over the chunk's valid rows
      const int q3 = C3 / kWarps;
      for (int n0 = warp * q3; n0 < (warp + 1) * q3; n0 += 32) {
        float acc[MT][4][4];
        mma_cols<MT>(acc, a1s, ldb, w2t, C2, n0, gq, tq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + j * 8 + 2 * tq;
          // every a2 is >= 0; in training the first valid row takes the
          // running max (-1) with its slot and x2
          float mx[2] = {TRAIN ? -1.f : 0.f, TRAIN ? -1.f : 0.f};
          int ar[2] = {0, 0};
          float pp[2] = {0.f, 0.f};
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m * 16 + gq + 8 * h;
              if (row < valid) {
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const float v = acc[m][j][2 * h + q];
                  if (TRAIN) {
                    // x2 = bf16(bf16(v) + bf16(b2)); a2 = ReLU(x2)
                    const float x2 = bfr(__fadd_rn(
                        bfr(v), __bfloat162float(b2[c + q])));
                    if (fmaxf(x2, 0.f) > mx[q]) {
                      mx[q] = fmaxf(x2, 0.f);
                      ar[q] = s0 + row;
                      pp[q] = x2;
                    }
                  } else {
                    mx[q] = fmaxf(mx[q], activate<BN>(v, c + q, b2, mul2,
                                                      add2));
                  }
                }
              }
            }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float om = __shfl_xor_sync(0xffffffffu, mx[q], off);
              if (TRAIN) {
                const int oa = __shfl_xor_sync(0xffffffffu, ar[q], off);
                const float op = __shfl_xor_sync(0xffffffffu, pp[q], off);
                keep_first_max(mx[q], ar[q], pp[q], om, oa, op);
              } else {
                mx[q] = fmaxf(mx[q], om);
              }
            }
          if (gq == 0) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (!first) {
                if (TRAIN) {
                  // an earlier chunk holds the lower slots: it keeps ties
                  if (pool[c + q] >= mx[q]) {
                    mx[q] = pool[c + q];
                    ar[q] = pool_arg[c + q];
                    pp[q] = pool_pre[c + q];
                  }
                } else {
                  mx[q] = fmaxf(mx[q], pool[c + q]);
                }
              }
              if (last) {
                out[(size_t)grp * C3 + c + q] = __float2bfloat16_rn(mx[q]);
                if (TRAIN) {
                  argmax[(size_t)grp * C3 + c + q] = ar[q];
                  ppre[(size_t)grp * C3 + c + q] = pp[q];
                }
              } else {
                pool[c + q] = mx[q];
                if (TRAIN) {
                  pool_arg[c + q] = ar[q];
                  pool_pre[c + q] = pp[q];
                }
              }
            }
          }
        }
      }
    }
  }
}

// TM = 16·MT rows per chunk: the fewest m-tiles that hold min(S, 64) slots,
// halved while the chunk's a0 and a1 and the running max (with its slot and
// x2 in training) overflow shared memory.
int pick_mt(int S, int C1, int C2, int C3, size_t* smem) {
  const int rows = S < 64 ? S : 64;
  int mt = rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
  for (; mt >= 1; mt >>= 1) {
    *smem = (size_t)16 * mt * (C1 + kPad + C2 + kPad) * sizeof(bf16) +
            (size_t)3 * C3 * sizeof(float);
    if (*smem <= (size_t)kSmemMax) return mt;
  }
  return 0;
}

template <int MT, bool GATHER, bool BN, bool TRAIN>
int launch_mt(const bf16* src, const int* idx, const bf16* center,
              const float* packs, const bf16* w1t, const bf16* b1,
              const bf16* w2t, const bf16* b2, int R, int N, int M, int S,
              int C1, int C2, int C3, bf16* out, int* argmax, float* ppre,
              size_t smem, cudaStream_t stream) {
  auto kern = fused_sa_bf16_kernel<MT, GATHER, BN, TRAIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (long long)R * M;
  const long long cap = 132LL * 16;
  const unsigned blocks = (unsigned)(groups < cap ? groups : cap);
  kern<<<blocks, kThreads, smem, stream>>>(src, idx, center, packs, w1t, b1,
                                           w2t, b2, R, N, M, S, C1, C2, C3,
                                           out, argmax, ppre);
  return (int)cudaGetLastError();
}

template <bool GATHER, bool BN, bool TRAIN>
int launch(const bf16* src, const int* idx, const bf16* center,
           const float* packs, const bf16* w1t, const bf16* b1,
           const bf16* w2t, const bf16* b2, int R, int N, int M, int S,
           int C1, int C2, int C3, bf16* out, int* argmax, float* ppre,
           cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (R < 1 || M < 1 || S < 1 || C1 < 16 || C1 % 16 || C2 < 128 ||
      C2 % 128 || C3 < 128 || C3 % 128 || (GATHER && N < 1))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int mt = pick_mt(S, C1, C2, C3, &smem);
  if (mt == 4)
    return launch_mt<4, GATHER, BN, TRAIN>(src, idx, center, packs, w1t, b1,
                                           w2t, b2, R, N, M, S, C1, C2, C3,
                                           out, argmax, ppre, smem, stream);
  if (mt == 2)
    return launch_mt<2, GATHER, BN, TRAIN>(src, idx, center, packs, w1t, b1,
                                           w2t, b2, R, N, M, S, C1, C2, C3,
                                           out, argmax, ppre, smem, stream);
  if (mt == 1)
    return launch_mt<1, GATHER, BN, TRAIN>(src, idx, center, packs, w1t, b1,
                                           w2t, b2, R, N, M, S, C1, C2, C3,
                                           out, argmax, ppre, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fused_sa_bf16

// pre (R, N, C1), center (R, M, C1), w1t (C2, C1), b1 (C2), w2t (C3, C2),
// b2 (C3), out (R, M, C3): bf16; idx (R, M, S) i32 in [0, N).
// The widths fused_sa_wgmma_eval.cuh takes run there, wider ones on the
// design above.
extern "C" int tpu3d_fused_sa_bf16(const __nv_bfloat16* pre, const int* idx,
                                   const __nv_bfloat16* center, const __nv_bfloat16* w1t,
                                   const __nv_bfloat16* b1, const __nv_bfloat16* w2t,
                                   const __nv_bfloat16* b2, int R, int N, int M, int S,
                                   int C1, int C2, int C3, __nv_bfloat16* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fused_sa_wgmma_eval::takes(C1, C2, C3))
    return fused_sa_bf16::launch<true, false, false>(
        pre, idx, center, nullptr, w1t, b1, w2t, b2, R, N, M, S, C1, C2, C3,
        out, nullptr, nullptr, s);
  if (const int pending = tpu3d::pending_error(s)) return pending;
  if (R < 1 || N < 1 || M < 1 || S < 1) return (int)cudaErrorInvalidValue;
  return fused_sa_wgmma_eval::launch_eval<true, false>(
      pre, idx, center, nullptr, w1t, b1, w2t, b2, R, N, M, S, C1, C2, C3,
      out, s);
}

// x0 (R, M, S, C1) bf16; weights and biases as above; routed as above.
extern "C" int tpu3d_fused_sa_slab_bf16(const __nv_bfloat16* x0, const __nv_bfloat16* w1t,
                                        const __nv_bfloat16* b1, const __nv_bfloat16* w2t,
                                        const __nv_bfloat16* b2, int R, int M, int S,
                                        int C1, int C2, int C3, __nv_bfloat16* out,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fused_sa_wgmma_eval::takes(C1, C2, C3))
    return fused_sa_bf16::launch<false, false, false>(
        x0, nullptr, nullptr, nullptr, w1t, b1, w2t, b2, R, 0, M, S, C1, C2,
        C3, out, nullptr, nullptr, s);
  if (const int pending = tpu3d::pending_error(s)) return pending;
  if (R < 1 || M < 1 || S < 1) return (int)cudaErrorInvalidValue;
  return fused_sa_wgmma_eval::launch_eval<false, false>(
      x0, nullptr, nullptr, nullptr, w1t, b1, w2t, b2, R, 0, M, S, C1, C2, C3,
      out, s);
}

// 1 where tpu3d_fused_sa_bf16 and tpu3d_fused_sa_slab_bf16 run widths C1 ->
// C2 -> C3 on the wgmma eval design, 0 where on the parent one.
extern "C" int tpu3d_fused_sa_bf16_design(int C1, int C2, int C3) {
  return fused_sa_wgmma_eval::takes(C1, C2, C3) ? 1 : 0;
}

// Groups of S slots the wgmma eval design packs into one 64-row tile.
extern "C" int tpu3d_fused_sa_bf16_groups(int S) {
  return S >= 1 ? fused_sa_wgmma_eval::groups_per_tile(S) : 0;
}

// x0 (R, M, S, C1) bf16; packs f32 [mul0 | add0 | mul1 | add1 | mul2 |
// add2]. The widths fused_sa_wgmma_eval.cuh's BatchNorm form takes run
// there, wider ones on the design above.
extern "C" int tpu3d_fused_sa_slab_bn_bf16(const __nv_bfloat16* x0, const float* packs,
                                           const __nv_bfloat16* w1t, const __nv_bfloat16* w2t,
                                           int R, int M, int S, int C1, int C2,
                                           int C3, __nv_bfloat16* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fused_sa_wgmma_eval::takes(C1, C2, C3, true))
    return fused_sa_bf16::launch<false, true, false>(
        x0, nullptr, nullptr, packs, w1t, nullptr, w2t, nullptr, R, 0, M, S,
        C1, C2, C3, out, nullptr, nullptr, s);
  if (const int pending = tpu3d::pending_error(s)) return pending;
  if (R < 1 || M < 1 || S < 1) return (int)cudaErrorInvalidValue;
  return fused_sa_wgmma_eval::launch_eval<false, true>(
      x0, nullptr, nullptr, packs, w1t, nullptr, w2t, nullptr, R, 0, M, S, C1,
      C2, C3, out, s);
}

// 1 where tpu3d_fused_sa_slab_bn_bf16 runs widths C1 -> C2 -> C3 on the
// wgmma eval design, 0 where on the parent one.
extern "C" int tpu3d_fused_sa_slab_bn_bf16_design(int C1, int C2, int C3) {
  return fused_sa_wgmma_eval::takes(C1, C2, C3, true) ? 1 : 0;
}

// Kernel 6's bf16 training forward: the gather form's inputs as
// tpu3d_fused_sa_bf16 -> out (R, M, C3) bf16, argmax (R, M, C3) i32 (the
// first slot of the max), ppre (R, M, C3) f32 (x2 there). The widths
// fused_sa_wgmma.cuh takes run there (wgmma, weights resident in shared
// memory); wider ones on the design above.
extern "C" int tpu3d_fused_sa_train_bf16(
    const __nv_bfloat16* pre, const int* idx, const __nv_bfloat16* center,
    const __nv_bfloat16* w1t, const __nv_bfloat16* b1,
    const __nv_bfloat16* w2t, const __nv_bfloat16* b2, int R, int N, int M,
    int S, int C1, int C2, int C3, __nv_bfloat16* out, int* argmax,
    float* ppre, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fused_sa_wgmma::takes(C1, C2, C3))
    return fused_sa_bf16::launch<true, false, true>(
        pre, idx, center, nullptr, w1t, b1, w2t, b2, R, N, M, S, C1, C2, C3,
        out, argmax, ppre, s);
  if (const int pending = tpu3d::pending_error(s)) return pending;
  if (R < 1 || N < 1 || M < 1 || S < 1) return (int)cudaErrorInvalidValue;
  return fused_sa_wgmma::launch_train(pre, idx, center, w1t, b1, w2t, b2, R,
                                      N, M, S, C1, C2, C3, out, argmax, ppre,
                                      s);
}

// 1 where tpu3d_fused_sa_train_bf16 runs widths C1 -> C2 -> C3 on the
// wgmma design, 0 where on the parent one.
extern "C" int tpu3d_fused_sa_train_bf16_wgmma(int C1, int C2, int C3) {
  return fused_sa_wgmma::takes(C1, C2, C3) ? 1 : 0;
}

// Kernel 8's bf16 training forward: the slab form's inputs as
// tpu3d_fused_sa_slab_bf16 -> out, argmax, ppre as above.
extern "C" int tpu3d_fused_sa_slab_train_bf16(
    const __nv_bfloat16* x0, const __nv_bfloat16* w1t,
    const __nv_bfloat16* b1, const __nv_bfloat16* w2t,
    const __nv_bfloat16* b2, int R, int M, int S, int C1, int C2, int C3,
    __nv_bfloat16* out, int* argmax, float* ppre, void* stream) {
  return fused_sa_bf16::launch<false, false, true>(
      x0, nullptr, nullptr, nullptr, w1t, b1, w2t, b2, R, 0, M, S, C1, C2, C3,
      out, argmax, ppre, static_cast<cudaStream_t>(stream));
}
