// The BatchNorm SA chain's training form, for Hopper (sm_90a): the three
// statistics passes of the forward and the three waves of the backward. The
// chain is [BN -> ReLU -> Dense] x2 -> BN -> ReLU -> max over the S slots of
// each (row, center) group, on the grouped (R, M, S, 128) slab x0 of layer
// 0's pre-activation, with batch statistics (mean and biased variance over
// every slot) in each BatchNorm.
//
// Replaces tpu3d/ops/fused_sa.py's kernels of that chain's custom VJP
// (_fused_train, :381-492):
//   entry tpu3d_fused_sa_bn_stats, depth 0 / 1 / 2: _stats0_kernel (:158),
//     _fwd_stats1_kernel (:164), _fwd_stats2_kernel (:171): per channel
//     sum x and sum x^2 of x0, x1 = a0 W1 or x2 = a1 W2, each layer before
//     it normalised with the statistics the earlier passes gave;
//   entry tpu3d_fused_sa_bn_bwd, wave 1 / 2 / 3: _bwd_wave1_kernel (:255),
//     _bwd_wave2_kernel (:272), _bwd_apply_kernel (:291).
// The fourth forward pass, _fwd_final_kernel (:178), is the slab training
// kernel of fused_sa.cu (entry tpu3d_fused_sa_slab_bn_train).
//
// Backward. The caller computes layer 2's reductions from the small
// (R, M, C3) tensors (the pooled gradient reaches x2 at the argmax slots
// only): dval = s2 * d_y2 at the argmax, c2a = s2 sum(d_y2) / P and
// c2b = s2 sum(d_y2 x̂2) / P. Every wave recomputes the chain from x0 and
//   d_x2 = [slot == argmax] dval - c2a - c2b x̂2       (dense: BatchNorm's
//          backward spreads the gradient over every slot)
//   d_y1 = (d_x2 W2^T) [y1 > 0]
// wave 1 reduces sum(d_y1), sum(d_y1 x̂1) and sums dW2 = a1^T d_x2; then
//   d_x1 = s1 d_y1 - c1a - c1b x̂1,  d_y0 = (d_x1 W1^T) [y0 > 0]
// wave 2 reduces sum(d_y0), sum(d_y0 x̂0) and sums dW1 = a0^T d_x1; wave 3
// writes d_x0 = s0 d_y0 - c0a - c0b x̂0, the only slab-sized write. Here
// y_l = x_l mul_l + add_l (the batch statistics folded), x̂_l = x_l r_l -
// mu_l r_l, r_l = 1 / sqrt(var_l + eps), s_l = gamma_l r_l. The per-channel
// vectors come in one pack: for layer l of width C_l, seven vectors of C_l
// (mul, add, r, mu r, s, ca, cb), layer 0's first.
//
// Bound on the card: operations. Each wave recomputes x1 and x2 and takes
// d_x2 W2^T: wave 1 also dW2 (one product of layer 1's size and three of
// layer 2's per slot), wave 2 d_a0 and dW1 (three and two), wave 3 d_a0
// (two and two). At SA_0 of default.yaml's train step (8.4 M slots of
// 128 -> 128 -> 128) one product over the level is 275 GFLOP, against 4.3 GB
// of slab read per pass: far above the f32 ridge. The statistics passes
// are the same but for depth 0, a pure reduction, bound by the slab read.
//
// Design. Blocks run in no order on the card, so nothing carries from one
// to the next as the TPU's grid steps do: a bounded persistent grid (one
// block per SM for the waves, two for the statistics) walks contiguous runs
// of tiles, each block sums its channels' reductions in f64 registers and
// its weight gradient in shared memory across its tiles, and writes one
// partial; a second kernel adds the blocks' partials in block order, so
// every result comes out the same from run to run. A wave's tile is one
// group's S slots (32 slots, half a group, in wave 1 at C3 = 256): a0
// (affine + ReLU of the slab rows), a1 and d_x2 live in shared memory, x1
// stays in registers from its dense layer to its use (each warp owns its
// tile rows in every dense layer of fused_sa_common.cuh), the weights
// stream through shared memory in slices of 32 rows, and dW (dW2 128 x
// C3 or dW1 128 x 128) sits in shared memory beside them: 176 KB at S = 64,
// C3 = 128; 226 KB in wave 1 (32 slots) and wave 2 at C3 = 256. x0 is read again from device
// memory (cache-resident by then) for y0 and x̂0. The statistics passes
// take 64-slot tiles over the flat slab. f32 throughout, as the slab
// forward: the kernels are held to the plain f32 version.
// Widths: C1 = C2 = 128, C3 128 or 256, S 16/32/64; offsets in size_t
// (default.yaml's SA_0 slab is 4.3 GB).

#include <cuda_runtime.h>

#include "fused_sa_common.cuh"

namespace {

using fused_sa::dense;
using fused_sa::kKC;
using fused_sa::kThreads;
using fused_sa::kWarps;

constexpr int C1 = 128;
constexpr int C2 = 128;
constexpr int kVecs = 7;  // per-channel vectors of each layer's pack
enum Vec { kMul = 0, kAdd, kR, kMuR, kS, kCa, kCb };

// vector k of layer l in the pack
template <int C3>
__device__ __forceinline__ const float* vec(const float* pk, int l, int k) {
  const int base = l == 0 ? 0 : l == 1 ? kVecs * C1 : kVecs * (C1 + C2);
  return pk + base + k * (l == 2 ? C3 : 128);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// a0 = ReLU(x0·mul0 + add0) of `rows` slab rows from `src` into X (rows x
// C1), as fused_sa_common.cuh's load_x0 computes it
__device__ __forceinline__ void load_a0(const float* __restrict__ src,
                                        const float* __restrict__ mul,
                                        const float* __restrict__ add,
                                        int rows, float* X) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(X);
  for (int q = threadIdx.x; q < rows * C1 / 4; q += kThreads) {
    const float4 v = s4[q];
    const int c = (4 * q) % C1;
    const float4 m = ld4(mul + c);
    const float4 a = ld4(add + c);
    d4[q] = make_float4(fmaxf(fmaf(v.x, m.x, a.x), 0.0f),
                        fmaxf(fmaf(v.y, m.y, a.y), 0.0f),
                        fmaxf(fmaf(v.z, m.z, a.z), 0.0f),
                        fmaxf(fmaf(v.w, m.w, a.w), 0.0f));
  }
}

// a1 = ReLU(x1·mul1 + add1) from this thread's x1 registers (rows warp*TM
// + i, columns 4*lane + r) into X (TR x C2)
template <int TM, int C3>
__device__ __forceinline__ void store_a1(const float (&x1)[TM][4],
                                         const float* pk, float* X) {
  const int warp = threadIdx.x >> 5, col = 4 * (threadIdx.x & 31);
  const float4 m = ld4(vec<C3>(pk, 1, kMul) + col);
  const float4 a = ld4(vec<C3>(pk, 1, kAdd) + col);
#pragma unroll
  for (int i = 0; i < TM; ++i)
    *reinterpret_cast<float4*>(X + (warp * TM + i) * C2 + col) =
        make_float4(fmaxf(fmaf(x1[i][0], m.x, a.x), 0.0f),
                    fmaxf(fmaf(x1[i][1], m.y, a.y), 0.0f),
                    fmaxf(fmaf(x1[i][2], m.z, a.z), 0.0f),
                    fmaxf(fmaf(x1[i][3], m.w, a.w), 0.0f));
}

// Each thread's column sums (slot f64) into the block's partial out[2][CW]:
// red (kWarps x 2 x CW doubles of shared memory) collects every warp's,
// then the warps are added in order. Column t of the thread is
// (t / 4) * 128 + 4 * lane + t % 4.
template <int TN, int CW>
__device__ __forceinline__ void block_partial(const double (&s)[TN],
                                              const double (&q)[TN],
                                              double* red, double* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red aliases buffers the tile loop used
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int c = (t / 4) * 128 + 4 * lane + t % 4;
    red[(warp * 2) * CW + c] = s[t];
    red[(warp * 2 + 1) * CW + c] = q[t];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * CW; e += kThreads) {
    const int k = e / CW, c = e % CW;
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[(w * 2 + k) * CW + c];
    out[e] = v;
  }
}

// sum[t] += the column sum of x over the TM rows, sq[t] that of x^2: each
// tile's sums in f32, their sum across tiles in f64
template <int TM, int TN>
__device__ __forceinline__ void accumulate(const float (&x)[TM][TN],
                                           double (&sum)[TN],
                                           double (&sq)[TN]) {
#pragma unroll
  for (int t = 0; t < TN; ++t) {
    float ps = 0.0f, pq = 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      ps += x[i][t];
      pq += x[i][t] * x[i][t];
    }
    sum[t] += ps;
    sq[t] += pq;
  }
}

// Statistics pass at DEPTH 0 / 1 / 2: per channel sum and sum of squares of
// x0, x1 or x2 over the block's run of 64-slot tiles -> ws[block] (2 x CD
// doubles).
template <int DEPTH, int C3>
__global__ void __launch_bounds__(kThreads, DEPTH == 2 && C3 == 256 ? 1 : 2)
bn_stats_kernel(const float* __restrict__ x0, const float* __restrict__ pk,
                const float* __restrict__ w1, const float* __restrict__ w2,
                long long tiles, long long per_block,
                double* __restrict__ ws) {
  constexpr int TM = 8;
  constexpr int TR = kWarps * TM;
  constexpr int CD = DEPTH == 0 ? C1 : DEPTH == 1 ? C2 : C3;
  constexpr int TN = CD / 32;
  extern __shared__ float smem[];
  float* A0 = smem;                // TR x C1: a0
  float* A1 = A0 + TR * C1;        // TR x C2: a1
  float* wbuf = A1 + TR * C2;      // kKC x C3
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double sum[TN], sq[TN];
#pragma unroll
  for (int t = 0; t < TN; ++t) sum[t] = sq[t] = 0.0;

  const long long t0 = (long long)blockIdx.x * per_block;
  const long long t1 = min(tiles, t0 + per_block);
  for (long long tile = t0; tile < t1; ++tile) {
    const float* src = x0 + (size_t)tile * TR * C1;
    if constexpr (DEPTH == 0) {
      float x[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = ld4(src + (warp * TM + i) * C1 + 4 * lane);
#pragma unroll
        for (int r = 0; r < 4; ++r) x[i][r] = comp(v, r);
      }
      accumulate<TM, 4>(x, sum, sq);
    } else {
      __syncthreads();  // every warp is done with A0 of the last tile
      load_a0(src, vec<C3>(pk, 0, kMul), vec<C3>(pk, 0, kAdd), TR, A0);
      float x1[TM][4];
      dense<TM, 4>(A0, C1, w1, wbuf, x1);
      if constexpr (DEPTH == 1) {
        accumulate<TM, 4>(x1, sum, sq);
      } else {
        store_a1<TM, C3>(x1, pk, A1);
        float x2[TM][TN];
        dense<TM, TN>(A1, C2, w2, wbuf, x2);
        accumulate<TM, TN>(x2, sum, sq);
      }
    }
  }
  block_partial<TN, CD>(sum, sq, reinterpret_cast<double*>(smem),
                        ws + (size_t)blockIdx.x * 2 * CD);
}

// DW (128 x NW, row-major, shared) += X^T D over TR rows: X (TR x 128) and
// D (TR x NW) in shared memory. Thread (hi, lo) owns rows 4hi + r and
// 64 + 4hi + r, and in each 128-column chunk columns 4lo + r and
// 64 + 4lo + r, so that neighbouring threads read neighbouring 16 bytes.
template <int TR, int NW>
__device__ __forceinline__ void dw_accum(const float* __restrict__ X,
                                         const float* __restrict__ D,
                                         float* __restrict__ DW) {
  const int hi = threadIdx.x >> 4, lo = threadIdx.x & 15;
#pragma unroll 1
  for (int j = 0; j < NW / 128; ++j) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.0f;
    for (int s = 0; s < TR; ++s) {
      const float4 a_lo = ld4(X + s * 128 + 4 * hi);
      const float4 a_hi = ld4(X + s * 128 + 64 + 4 * hi);
      const float4 d_lo = ld4(D + s * NW + j * 128 + 4 * lo);
      const float4 d_hi = ld4(D + s * NW + j * 128 + 64 + 4 * lo);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float d[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w,
                          d_hi.x, d_hi.y, d_hi.z, d_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] += a[i] * d[k];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = i < 4 ? 4 * hi + i : 64 + 4 * hi + (i - 4);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = j * 128 + (k < 4 ? 4 * lo + k : 64 + 4 * lo + (k - 4));
        DW[row * NW + col] += acc[i][k];
      }
    }
  }
}

// a wave's tile: one group of S <= 64 slots, but 32 slots in wave 1 at
// C3 = 256, where dW2 (128 KB) leaves no room for 64-slot buffers
template <int WAVE, int S, int C3>
__host__ __device__ constexpr int wave_rows() {
  return WAVE == 1 && C3 == 256 && S > 32 ? 32 : S;
}

// dW's columns: wave 1 sums dW2 (C2 x C3), wave 2 dW1 (C1 x C2)
template <int WAVE, int C3>
__host__ __device__ constexpr int dw_cols() {
  return WAVE == 1 ? C3 : WAVE == 2 ? C2 : 0;
}

template <int WAVE, int S, int C3>
constexpr size_t wave_smem_floats() {
  constexpr int TR = wave_rows<WAVE, S, C3>();
  return (size_t)TR * (C1 + C2 + C3) + kKC * (C3 > C2 ? C3 : C2)
         + 128 * dw_cols<WAVE, C3>() + 2 * C3;
}

// Backward wave 1 / 2 / 3 over the block's run of tiles (TR slots of one
// group each). Wave 1 -> wsf[block] = dW2 (C2 x C3), wsd[block] =
// (sum d_y1, sum d_y1 x̂1) (2 x C2); wave 2 -> dW1 (C1 x C2) and
// (sum d_y0, sum d_y0 x̂0) (2 x C1); wave 3 -> dx0, the slab's gradient.
template <int WAVE, int S, int C3>
__global__ void __launch_bounds__(kThreads, 1)
bn_wave_kernel(const float* __restrict__ x0, const float* __restrict__ pk,
               const float* __restrict__ w1, const float* __restrict__ w2,
               const float* __restrict__ w1t, const float* __restrict__ w2t,
               const float* __restrict__ dval,
               const int* __restrict__ argmax, long long tiles,
               long long per_block, float* __restrict__ dx0,
               float* __restrict__ wsf, double* __restrict__ wsd) {
  constexpr int TR = wave_rows<WAVE, S, C3>();
  constexpr int TM = TR / kWarps;
  constexpr int kTiles = S / TR;  // tiles per group
  constexpr int TN3 = C3 / 32;
  constexpr int NW = dw_cols<WAVE, C3>();
  extern __shared__ float smem[];
  float* A0 = smem;                          // TR x C1: a0
  float* A1 = A0 + TR * C1;                  // TR x C2: a1, then d_x1
  float* DX2 = A1 + TR * C2;                 // TR x C3: d_x2
  float* wbuf = DX2 + TR * C3;               // kKC x max(C2, C3)
  float* DW = wbuf + kKC * (C3 > C2 ? C3 : C2);  // 128 x NW
  float* dv = DW + 128 * NW;                 // C3: the group's dval
  int* ag = reinterpret_cast<int*>(dv + C3);  // C3: the group's argmax

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = 4 * lane;  // this thread's columns in C1 / C2
  double rsum[4], rsq[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) rsum[r] = rsq[r] = 0.0;
  for (int e = tid; e < 128 * NW; e += kThreads) DW[e] = 0.0f;

  const long long t0 = (long long)blockIdx.x * per_block;
  const long long t1 = min(tiles, t0 + per_block);
  for (long long tile = t0; tile < t1; ++tile) {
    const long long g = tile / kTiles;
    const int slot0 = (int)(tile % kTiles) * TR;  // first slot in the group
    const size_t row0 = (size_t)tile * TR;        // first slab row
    __syncthreads();  // the last tile is done with every buffer
    for (int c = tid; c < C3; c += kThreads) {
      dv[c] = dval[g * C3 + c];
      ag[c] = argmax[g * C3 + c];
    }
    load_a0(x0 + row0 * C1, vec<C3>(pk, 0, kMul), vec<C3>(pk, 0, kAdd), TR,
            A0);
    float x1[TM][4];
    dense<TM, 4>(A0, C1, w1, wbuf, x1);
    store_a1<TM, C3>(x1, pk, A1);
    {  // x2, then d_x2 into DX2
      float x2[TM][TN3];
      dense<TM, TN3>(A1, C2, w2, wbuf, x2);
#pragma unroll
      for (int q = 0; q < TN3 / 4; ++q) {
        const int c = q * 128 + col;
        const float4 r2 = ld4(vec<C3>(pk, 2, kR) + c);
        const float4 mr2 = ld4(vec<C3>(pk, 2, kMuR) + c);
        const float4 ca = ld4(vec<C3>(pk, 2, kCa) + c);
        const float4 cb = ld4(vec<C3>(pk, 2, kCb) + c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int s = slot0 + warp * TM + i;
          float d[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float xh = x2[i][4 * q + r] * comp(r2, r) - comp(mr2, r);
            const float sparse = ag[c + r] == s ? dv[c + r] : 0.0f;
            d[r] = sparse - comp(ca, r) - comp(cb, r) * xh;
          }
          *reinterpret_cast<float4*>(DX2 + (warp * TM + i) * C3 + c) =
              make_float4(d[0], d[1], d[2], d[3]);
        }
      }
    }
    // d_y1 = (d_x2 W2^T) [y1 > 0]; the barrier in dense() orders DX2
    float dy[TM][4];
    dense<TM, 4>(DX2, C3, w2t, wbuf, dy);
    {
      const float4 m1 = ld4(vec<C3>(pk, 1, kMul) + col);
      const float4 a1 = ld4(vec<C3>(pk, 1, kAdd) + col);
      const float4 r1 = ld4(vec<C3>(pk, 1, kR) + col);
      const float4 mr1 = ld4(vec<C3>(pk, 1, kMuR) + col);
      const float4 s1 = ld4(vec<C3>(pk, 1, kS) + col);
      const float4 ca = ld4(vec<C3>(pk, 1, kCa) + col);
      const float4 cb = ld4(vec<C3>(pk, 1, kCb) + col);
      float ps[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float y1 = fmaf(x1[i][r], comp(m1, r), comp(a1, r));
          const float d = y1 > 0.0f ? dy[i][r] : 0.0f;
          const float xh = x1[i][r] * comp(r1, r) - comp(mr1, r);
          if constexpr (WAVE == 1) {
            ps[r] += d;
            pq[r] += d * xh;
          } else {  // d_x1
            dy[i][r] = comp(s1, r) * d - comp(ca, r) - comp(cb, r) * xh;
          }
        }
      }
      if constexpr (WAVE == 1) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          rsum[r] += ps[r];
          rsq[r] += pq[r];
        }
        __syncthreads();  // DX2 and A1 complete in every warp
        dw_accum<TR, NW>(A1, DX2, DW);  // dW2 += a1^T d_x2
        continue;
      }
    }
    if constexpr (WAVE != 1) {
      // d_x1 in place of a1: every warp is past the x2 layer, the last
      // reader of A1 (the barrier at the start of the d_a1 layer)
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(A1 + (warp * TM + i) * C2 + col) =
            make_float4(dy[i][0], dy[i][1], dy[i][2], dy[i][3]);
      if constexpr (WAVE == 2) {
        __syncthreads();  // d_x1 complete in every warp
        dw_accum<TR, NW>(A0, A1, DW);  // dW1 += a0^T d_x1
      }
      float da[TM][4];  // d_a0 = d_x1 W1^T
      dense<TM, 4>(A1, C2, w1t, wbuf, da);
      const float4 m0 = ld4(vec<C3>(pk, 0, kMul) + col);
      const float4 a0 = ld4(vec<C3>(pk, 0, kAdd) + col);
      const float4 r0 = ld4(vec<C3>(pk, 0, kR) + col);
      const float4 mr0 = ld4(vec<C3>(pk, 0, kMuR) + col);
      const float4 s0 = ld4(vec<C3>(pk, 0, kS) + col);
      const float4 ca = ld4(vec<C3>(pk, 0, kCa) + col);
      const float4 cb = ld4(vec<C3>(pk, 0, kCb) + col);
      float ps[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const size_t at = (row0 + warp * TM + i) * C1 + col;
        const float4 xv = ld4(x0 + at);
        float o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = comp(xv, r);
          const float y0 = fmaf(x, comp(m0, r), comp(a0, r));
          const float d = y0 > 0.0f ? da[i][r] : 0.0f;
          const float xh = x * comp(r0, r) - comp(mr0, r);
          ps[r] += d;
          pq[r] += d * xh;
          o[r] = comp(s0, r) * d - comp(ca, r) - comp(cb, r) * xh;
        }
        if constexpr (WAVE == 3)
          *reinterpret_cast<float4*>(dx0 + at) =
              make_float4(o[0], o[1], o[2], o[3]);
      }
      if constexpr (WAVE == 2) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          rsum[r] += ps[r];
          rsq[r] += pq[r];
        }
      }
    }
  }
  if constexpr (WAVE != 3) {
    __syncthreads();  // DW complete
    float* out = wsf + (size_t)blockIdx.x * 128 * NW;
    for (int e = tid; e < 128 * NW; e += kThreads) out[e] = DW[e];
    block_partial<4, 128>(rsum, rsq, reinterpret_cast<double*>(smem),
                          wsd + (size_t)blockIdx.x * 2 * 128);
  }
}

// out[e] = the sum of the blocks' partials ws[p][e], in block order
template <typename T>
__global__ void reduce_partials(const T* __restrict__ ws, int parts, int per,
                                T* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per) return;
  T s = 0;
  for (int p = 0; p < parts; ++p) s += ws[(size_t)p * per + e];
  out[e] = s;
}

template <typename T>
cudaError_t reduce(const T* ws, int parts, int per, T* out,
                   cudaStream_t stream) {
  reduce_partials<T><<<(per + 255) / 256, 256, 0, stream>>>(ws, parts, per,
                                                             out);
  return cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DEPTH, int C3>
cudaError_t launch_stats(const float* x0, const float* pk, const float* w1,
                         const float* w2, long long tiles, int blocks,
                         double* ws, double* sums, cudaStream_t stream) {
  constexpr int CD = DEPTH == 0 ? C1 : DEPTH == 1 ? C2 : C3;
  const size_t smem =
      DEPTH == 0 ? (size_t)kWarps * 2 * CD * sizeof(double)
                 : ((size_t)64 * (C1 + C2) + kKC * C3) * sizeof(float);
  cudaError_t err = set_smem(bn_stats_kernel<DEPTH, C3>, smem);
  if (err != cudaSuccess) return err;
  const long long per_block = (tiles + blocks - 1) / blocks;
  bn_stats_kernel<DEPTH, C3><<<blocks, kThreads, smem, stream>>>(
      x0, pk, w1, w2, tiles, per_block, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce<double>(ws, blocks, 2 * CD, sums, stream);
}

template <int C3>
cudaError_t stats_depth(int depth, const float* x0, const float* pk,
                        const float* w1, const float* w2, long long tiles,
                        int blocks, double* ws, double* sums,
                        cudaStream_t stream) {
  if (depth == 0)
    return launch_stats<0, C3>(x0, pk, w1, w2, tiles, blocks, ws, sums,
                               stream);
  if (depth == 1)
    return launch_stats<1, C3>(x0, pk, w1, w2, tiles, blocks, ws, sums,
                               stream);
  return launch_stats<2, C3>(x0, pk, w1, w2, tiles, blocks, ws, sums, stream);
}

struct WaveArgs {
  const float* x0;
  const float* pk;
  const float* w1;
  const float* w2;
  const float* w1t;
  const float* w2t;
  const float* dval;
  const int* argmax;
  float* dx0;
  float* wsf;
  double* wsd;
  float* grads;
  double* sums;
};

template <int WAVE, int S, int C3>
cudaError_t launch_wave(const WaveArgs& a, long long groups, int blocks,
                        cudaStream_t stream) {
  constexpr int TR = wave_rows<WAVE, S, C3>();
  const long long tiles = groups * (S / TR);
  const size_t smem = wave_smem_floats<WAVE, S, C3>() * sizeof(float);
  cudaError_t err = set_smem(bn_wave_kernel<WAVE, S, C3>, smem);
  if (err != cudaSuccess) return err;
  const long long per_block = (tiles + blocks - 1) / blocks;
  bn_wave_kernel<WAVE, S, C3><<<blocks, kThreads, smem, stream>>>(
      a.x0, a.pk, a.w1, a.w2, a.w1t, a.w2t, a.dval, a.argmax, tiles,
      per_block, a.dx0, a.wsf, a.wsd);
  err = cudaGetLastError();
  if constexpr (WAVE == 3) return err;
  if (err != cudaSuccess) return err;
  err = reduce<float>(a.wsf, blocks, 128 * dw_cols<WAVE, C3>(), a.grads,
                      stream);
  if (err != cudaSuccess) return err;
  return reduce<double>(a.wsd, blocks, 2 * 128, a.sums, stream);
}

template <int S, int C3>
cudaError_t wave_s(int wave, const WaveArgs& a, long long groups, int blocks,
                   cudaStream_t stream) {
  if (wave == 1) return launch_wave<1, S, C3>(a, groups, blocks, stream);
  if (wave == 2) return launch_wave<2, S, C3>(a, groups, blocks, stream);
  return launch_wave<3, S, C3>(a, groups, blocks, stream);
}

template <int C3>
cudaError_t wave_c3(int wave, int S, const WaveArgs& a, long long groups,
                    int blocks, cudaStream_t stream) {
  if (S == 16) return wave_s<16, C3>(wave, a, groups, blocks, stream);
  if (S == 32) return wave_s<32, C3>(wave, a, groups, blocks, stream);
  return wave_s<64, C3>(wave, a, groups, blocks, stream);
}

bool shape_ok(int R, int M, int S, int C3, int blocks) {
  return R >= 1 && M >= 1 && (S == 16 || S == 32 || S == 64)
         && (C3 == 128 || C3 == 256) && blocks >= 1
         && ((long long)M * S) % 64 == 0;
}

}  // namespace

// The statistics pass at `depth` (0, 1 or 2): x0 (R, M, S, 128) the slab,
// pk the packs (7 x (128 + 128 + C3); layers before `depth` read, their mul
// and add only), w1 (128, 128), w2 (128, C3) -> sums (2, C_depth) f64, the
// per-channel sum and sum of squares of x_depth over every slot. ws holds
// blocks x 2 x C_depth doubles; blocks is the caller's grid size (two per
// SM at most is what fits), M * S a multiple of 64.
extern "C" int tpu3d_fused_sa_bn_stats(const float* x0, const float* pk,
                                       const float* w1, const float* w2,
                                       int R, int M, int S, int C3, int depth,
                                       int blocks, double* ws, double* sums,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (!shape_ok(R, M, S, C3, blocks) || depth < 0 || depth > 2)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)R * M * S / 64;
  if (blocks > tiles) return (int)cudaErrorInvalidValue;
  if (C3 == 128)
    return (int)stats_depth<128>(depth, x0, pk, w1, w2, tiles, blocks, ws,
                                 sums, stream);
  return (int)stats_depth<256>(depth, x0, pk, w1, w2, tiles, blocks, ws, sums,
                               stream);
}

// Backward wave `wave` (1, 2 or 3): x0, pk, w1, w2 as the statistics pass
// takes them (every vector of the pack read), w1t = W1^T, w2t = W2^T
// (C3, 128), dval and argmax (R, M, C3). Wave 1 -> grads = dW2 (128 x C3),
// sums = (sum d_y1, sum d_y1 x̂1) (2 x 128, f64); wave 2 -> grads = dW1
// (128 x 128), sums = (sum d_y0, sum d_y0 x̂0); wave 3 -> dx0 (R, M, S,
// 128). wsf holds blocks x 128 x C3 floats and wsd blocks x 256 doubles
// (waves 1 and 2); blocks is the caller's grid size (one per SM fits).
extern "C" int tpu3d_fused_sa_bn_bwd(const float* x0, const float* pk,
                                     const float* w1, const float* w2,
                                     const float* w1t, const float* w2t,
                                     const float* dval, const int* argmax,
                                     int R, int M, int S, int C3, int wave,
                                     int blocks, float* dx0, float* wsf,
                                     double* wsd, float* grads, double* sums,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const long long groups = (long long)R * M;
  if (!shape_ok(R, M, S, C3, blocks) || wave < 1 || wave > 3
      || blocks > groups)
    return (int)cudaErrorInvalidValue;
  const WaveArgs a{x0, pk, w1, w2, w1t, w2t, dval, argmax, dx0, wsf, wsd,
                   grads, sums};
  if (C3 == 128) return (int)wave_c3<128>(wave, S, a, groups, blocks, stream);
  return (int)wave_c3<256>(wave, S, a, groups, blocks, stream);
}
