// The BatchNorm SA chain's training form, for Hopper (sm_90a): the forward's
// statistics passes and final pass, and the backward's waves. The chain is
// [BN -> ReLU -> Dense] x2 -> BN -> ReLU -> max over the S slots of each
// (row, center) group, on the grouped (R, M, S, C1) slab x0 of layer 0's
// pre-activation, with batch statistics (mean and biased variance over
// every slot) in each BatchNorm.
//
// Replaces tpu3d/ops/fused_sa.py's kernels of that chain's custom VJP
// (_fused_train, :382-492):
//   entry tpu3d_fused_sa_bn_stats0: _stats0_kernel (:158), per channel
//     sum x and sum x^2 of x0;
//   entry tpu3d_fused_sa_bn_layer: _fwd_stats1_kernel (:164) and
//     _fwd_stats2_kernel (:171): x1 = ReLU(BN0(x0)) W1 (or x2 =
//     ReLU(BN1(x1)) W2) written to device memory, and its sums;
//   entry tpu3d_fused_sa_bn_final: _fwd_final_kernel (:178), a reduction
//     over the stored x2: per group and channel the max of ReLU(BN2(x2)),
//     its first argmax and x2 there;
//   entries tpu3d_fused_sa_bn_wave1, _wave2, _apply: _bwd_wave1_kernel
//     (:255), _bwd_wave2_kernel (:272), _bwd_apply_kernel (:291).
//
// The TPU kernels keep their slabs in VMEM and recompute the chain in every
// pass (9 layer-1 and 9 layer-2 products per slot in all). On the H100 one
// layer-1 product over default.yaml's SA_0 at B=16 (8.4 M slots of 128 ->
// 128) is 275 GFLOP, 4.1 ms at the f32 peak, while reading a 4.29 GB slab
// takes 1.28 ms: so x1 and x2 are kept in device memory, in f32, from the
// forward to the backward, and every product runs once, 3 + 3 per slot:
//   stats1  x1 = a0 W1, a0 = ReLU(x0·mul0 + add0) applied as x0 lands;
//           write x1; sum x1, x1^2
//   stats2  x2 = a1 W2 from the stored x1; write x2; sum x2, x2^2
//   final   from the stored x2 (no product)
//   wave 1  d_y1 = (d_x2 W2^T)[y1 > 0], d_x2 = [slot == argmax] dval -
//           c2a - c2b x̂2 formed from the stored x2 as it lands, the mask
//           and x̂1 from the stored x1; sum d_y1, d_y1 x̂1; write d_y1;
//           dW2 = a1^T d_x2, a second product over the slots
//   wave 2  d_y0 = (d_x1 W1^T)[y0 > 0], d_x1 = s1 d_y1 - c1a - c1b x̂1
//           formed from the stored d_y1 and x1; sum d_y0, d_y0 x̂0; write
//           d_y0 into the buffer of d_x0; dW1 = a0^T d_x1
//   apply   d_x0 = s0 d_y0 - c0a - c0b x̂0, in place: elementwise.
// Here y_l = x_l mul_l + add_l (the batch statistics folded), x̂_l = x_l r_l
// - mu_l r_l, r_l = 1 / sqrt(var_l + eps), s_l = gamma_l r_l. The caller
// computes layer 2's reductions from the small (R, M, C3) tensors (the
// pooled gradient reaches x2 at the argmax slots only): dval = s2 d_y2 at
// the argmax, c2a = s2 sum(d_y2) / P and c2b = s2 sum(d_y2 x̂2) / P. The
// per-channel vectors come in one pack: for layer l of width C_l, seven
// vectors of C_l (mul, add, r, mu r, s, ca, cb), layer 0's first.
//
// Bound on the card: operations for the products (at SA_0 each is right at
// the f32 ridge: 2·128·128 operations per slot against some 1.5 KB of slab
// read and written), bytes for stats0, final and apply. Design of the
// products, one register-tiled f32 SIMT kernel for each of their two
// shapes:
//   - bn_row_gemm: out (P x N) = pro(A) (P x K) B (K x N), B a weight (W1,
//     W2, W2^T or W1^T); 128 x 128 output tiles, 256 threads of 8 x 8
//     outputs each; A's 128 x 16 slices and B's 16 x 128 slices land in
//     shared memory by cp.async (A double-, B triple-buffered, the next
//     slice in flight while this one's products run, across tile
//     boundaries too); each thread applies the prologue (BN + ReLU, or the
//     gradient's d_x2 / d_x1 form) to 8 elements of the landed A slice and
//     stores them transposed, so the products read A and B as float4s; the
//     epilogue writes the tile and adds its column sums, f32 over 16 rows,
//     then f64 across warps and tiles, in shared memory;
//   - bn_dw_gemm: dW (Ca x Nb) = pro(A)^T pro(B) summed over the slots, 16
//     slab rows at a time, both operands as they land (BN + ReLU on A, the
//     gradient's form on B), the same 8 x 8 register tile;
// each a persistent grid (two blocks per SM) whose blocks write their
// partials once, added in block order by reduce_partials, so every result
// comes out the same from run to run. Widths: multiples of 128 up to 1024;
// any P; offsets in size_t (default.yaml's SA_0 slab is 4.3 GB).
//
// Two forms, the kernels templated on the slab type T. The f32 form (T =
// float, the entries without a suffix) is f32 throughout and held to the
// plain f32 version. The bf16 form (T = __nv_bfloat16, the *_bf16 entries)
// is tpu3d's arithmetic on its accelerator: x0, x1 and x2 are bf16 slabs
// (x1 and x2 the rounded values _chain_to makes, half the f32 form's
// bytes), every prologue's output is rounded to bf16 before it enters a
// product (a0 and a1; d_x2 and d_x1, as tpu3d rounds them at :234, :261,
// :278, :297) and the weights come rounded to bf16 (in f32), so each
// product is of two bf16 values, exact in f32, and only the order of the
// f32 sums differs from tpu3d's; the stats epilogue rounds x1 and x2 to
// bf16 before writing and summing them; final pools ReLU(BN2(x2)) rounded
// to bf16 (out in bf16); d_y1 and d_y0 stay f32 slabs (tpu3d keeps the
// gradients of the BatchNorm outputs in f32), so apply writes d_x0 into a
// bf16 slab of its own. The products run on the f32 form's register tiles
// (a tensor-core form is later work); the per-channel sums keep the f32
// form's f64 block partials in block order, so a step repeats to the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "fused_sa_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

using fused_sa::cp_async16;
using fused_sa::cp_async_commit;
using fused_sa::cp_async_wait;
using fused_sa::kThreads;
using fused_sa::reduce;

constexpr int kBM = 128;  // output tile rows (slots, or dW's rows)
constexpr int kBN = 128;  // output tile columns
constexpr int kBK = 16;   // the depth of a staged slice
constexpr int kMaxWidth = 1024;

// The per-channel vectors of one layer, each C_l floats.
struct Layer {
  const float* mul;
  const float* add;
  const float* r;
  const float* mr;
  const float* s;
  const float* ca;
  const float* cb;
};

enum Pro { kRelu = 0, kDx2, kDx1 };
enum Epi { kStats = 0, kDy };

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void to8(const float4& a, const float4& b,
                                    float (&v)[8]) {
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename T>
constexpr bool kLowp = std::is_same_v<T, bf16>;

// v in the form's precision: rounded to bf16 (kept in f32) in the bf16 form
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kLowp<T>) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// 8 consecutive values at p (16-byte aligned, shared or global), in f32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  to8(*reinterpret_cast<const float4*>(p),
      *reinterpret_cast<const float4*>(p + 4), v);
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x, v[2 * j + 1] = f.y;
  }
}

// 4 consecutive values of global memory at p, read-only, in f32
__device__ __forceinline__ float4 ld4f(const float* p) { return ld4(p); }

__device__ __forceinline__ float4 ld4f(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// 4 values (already in the form's precision) to p
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// The elementwise forms, each rounded step by step as the plain pieces'
// PyTorch operations round them (no contraction), so that a ReLU mask or an
// argmax taken here from a stored slab agrees with the plain piece's on the
// same slab to the bit: y = x·mul + add; x̂ = x·r − mr; and the gradient's
// a − ca − cb·x̂.
__device__ __forceinline__ float affine(float x, float m, float a) {
  return __fadd_rn(__fmul_rn(x, m), a);
}

__device__ __forceinline__ float xhat(float x, float r, float mr) {
  return __fsub_rn(__fmul_rn(x, r), mr);
}

__device__ __forceinline__ float grad_form(float a, float ca, float cb,
                                           float xh) {
  return __fsub_rn(__fsub_rn(a, ca), __fmul_rn(cb, xh));
}

// 8 consecutive values of vector `vec` from channel c
__device__ __forceinline__ void vec8(const float* vec, int c, float (&v)[8]) {
  to8(ld4(vec + c), ld4(vec + c + 4), v);
}

// The prologue on 8 consecutive channels c.. of one slot (row p of the
// slab; slot `slot` of group `g`): kRelu a = ReLU(x·mul + add); kDx2 d_x2 =
// [slot == argmax] dval - ca - cb (x r - mr), dval and argmax (R, M, C)
// rows of stride C; kDx1 d_x1 = s d_y - ca - cb (x1 r - mr) with x = d_y
// and x2nd = x1; each rounded to bf16 in the bf16 form, the operand of a
// product. A slot past the slab (valid false) gives 0.
template <int PRO, typename T>
__device__ __forceinline__ void prologue(float (&x)[8], const float (&x2nd)[8],
                                         const Layer& L, int c, bool valid,
                                         long long g, int slot, int C,
                                         const float* __restrict__ dval,
                                         const int* __restrict__ argmax) {
  if (!valid) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = 0.0f;
    return;
  }
  if constexpr (PRO == kRelu) {
    float m[8], a[8];
    vec8(L.mul, c, m);
    vec8(L.add, c, a);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = fmaxf(affine(x[j], m[j], a[j]), 0.0f);
  } else {
    float r[8], mr[8], ca[8], cb[8];
    vec8(L.r, c, r);
    vec8(L.mr, c, mr);
    vec8(L.ca, c, ca);
    vec8(L.cb, c, cb);
    if constexpr (PRO == kDx2) {
      float dv[8];
      const size_t at = (size_t)g * C + c;
      to8(ld4(dval + at), ld4(dval + at + 4), dv);
      const int4 a0 = __ldg(reinterpret_cast<const int4*>(argmax + at));
      const int4 a1 = __ldg(reinterpret_cast<const int4*>(argmax + at + 4));
      const int ag[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = grad_form(ag[j] == slot ? dv[j] : 0.0f, ca[j], cb[j],
                         xhat(x[j], r[j], mr[j]));
    } else {
      float s[8];
      vec8(L.s, c, s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = grad_form(__fmul_rn(s[j], x[j]), ca[j], cb[j],
                         xhat(x2nd[j], r[j], mr[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = rnd<T>(x[j]);
}

// acc += As^T Bs over one staged slice: As (kBK x 128, k-major over the
// tile's rows), Bs (kBK x 128, k-major over its columns); thread (ty, tx)
// owns rows 4ty + i and 64 + 4ty + i, columns 4tx + j and 64 + 4tx + j
__device__ __forceinline__ void mma_slice(const float* __restrict__ As,
                                          const float* __restrict__ Bs,
                                          float (&acc)[8][8]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float a[8], b[8];
    to8(*reinterpret_cast<const float4*>(As + k * kBM + 4 * ty),
        *reinterpret_cast<const float4*>(As + k * kBM + 64 + 4 * ty), a);
    to8(*reinterpret_cast<const float4*>(Bs + k * kBN + 4 * tx),
        *reinterpret_cast<const float4*>(Bs + k * kBN + 64 + 4 * tx), b);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int i) {  // row i of thread's tile
  const int ty = threadIdx.x >> 4;
  return i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4);
}

__device__ __forceinline__ int tile_col(int j) {
  const int tx = threadIdx.x & 15;
  return j < 4 ? 4 * tx + j : 64 + 4 * tx + (j - 4);
}

// --------------------------------------------------------------------------
// bn_row_gemm: Y (P x N) = pro(A) B, with the epilogue's column sums

struct RowArgs {
  const void* A;     // P x K: T (kRelu, kDx2) or f32 d_y1 (kDx1)
  const void* A2;    // P x K, T: x1 beside d_y1 (kDx1)
  const float* B;    // K x N
  const void* E;     // P x N, T: the epilogue's x (kDy)
  const float* dval;
  const int* argmax;
  Layer in;          // the prologue's layer (K channels)
  Layer out;         // the epilogue's layer (N channels, kDy)
  void* Y;           // P x N: T (kStats) or f32 (kDy)
  double* ws;        // blocks x 2 x N
  long long P;
  int K, N, S;
  long long tiles;   // ceil(P / kBM) x N / kBN
};

// the element types of a row product's A and Y in the form of slab type T
template <int PRO, typename T>
using RowA = std::conditional_t<PRO == kDx1, float, T>;
template <int EPI, typename T>
using RowY = std::conditional_t<EPI == kStats, T, float>;

// row stride of a landed A slice, in elements: kBK and 16 bytes of padding
template <typename TA>
__host__ __device__ constexpr int raw_ld() {
  return kBK + 16 / (int)sizeof(TA);
}

template <int PRO, typename T>
__host__ __device__ constexpr size_t row_raw_bytes() {
  using TA = RowA<PRO, T>;
  return (size_t)2 * kBM * raw_ld<TA>() * sizeof(TA)
         + (PRO == kDx1 ? (size_t)2 * kBM * raw_ld<T>() * sizeof(T) : 0);
}

template <int PRO, typename T>
constexpr size_t row_smem_bytes() {
  return row_raw_bytes<PRO, T>()
         + (size_t)(kBK * kBM + 3 * kBK * kBN + 8 * 2 * kBN) * sizeof(float);
}

// rows [row0, row0 + rows) of `src` (row stride ld elements, from column
// col0) into `dst` (row stride ldd), kBK / (16 / sizeof(TT)) cp.async
// chunks a row; rows at or past `end` zeroed
template <typename TT>
__device__ __forceinline__ void stage_rows(TT* dst, int ldd, const TT* src,
                                           size_t ld, int col0, int width,
                                           long long row0, int rows,
                                           long long end) {
  constexpr int e = 16 / (int)sizeof(TT);
  const int per_row = width / e;
  for (int q = threadIdx.x; q < rows * per_row; q += kThreads) {
    const int r = q / per_row, c = q % per_row;
    const long long p = row0 + r;
    TT* d = dst + r * ldd + e * c;
    if (p < end)
      cp_async16(d, src + (size_t)p * ld + col0 + e * c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int PRO, int EPI, typename T>
__global__ void __launch_bounds__(kThreads, 2) bn_row_gemm(const RowArgs a) {
  using TA = RowA<PRO, T>;
  using TY = RowY<EPI, T>;
  constexpr int lda = raw_ld<TA>(), lda2 = raw_ld<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  TA* raw = reinterpret_cast<TA*>(smem);                // 2 x kBM x lda
  T* raw2 = reinterpret_cast<T*>(                       // the same (kDx1)
      smem + (size_t)2 * kBM * lda * sizeof(TA));
  float* As = reinterpret_cast<float*>(smem + row_raw_bytes<PRO, T>());
  float* Bs = As + kBK * kBM;                    // 3 x kBK x kBN
  float* red = Bs + 3 * kBK * kBN;               // 8 warps x 2 x kBN
  double* bsum = reinterpret_cast<double*>(red + 8 * 2 * kBN);  // 2 x N
  const TA* A = static_cast<const TA*>(a.A);
  const T* A2 = static_cast<const T*>(a.A2);
  const T* E = static_cast<const T*>(a.E);
  TY* Y = static_cast<TY*>(a.Y);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = a.N, K = a.K;
  const int tiles_n = N / kBN, ksteps = K / kBK;
  for (int e = tid; e < 2 * N; e += kThreads) bsum[e] = 0.0;
  const long long my_tiles =
      blockIdx.x < a.tiles
          ? (a.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = my_tiles * ksteps;

  auto tile_of = [&](long long step) {
    return (long long)blockIdx.x + (step / ksteps) * gridDim.x;
  };
  auto issue = [&](long long step) {
    const long long t = tile_of(step);
    const int ks = (int)(step % ksteps);
    const long long p0 = (t / tiles_n) * kBM;
    const int n0 = (int)(t % tiles_n) * kBN;
    const int buf = (int)(step & 1);
    stage_rows(raw + buf * kBM * lda, lda, A, K, ks * kBK, kBK, p0, kBM,
               a.P);
    if constexpr (PRO == kDx1)
      stage_rows(raw2 + buf * kBM * lda2, lda2, A2, K, ks * kBK, kBK, p0,
                 kBM, a.P);
    float* bs = Bs + (int)(step % 3) * kBK * kBN;
    for (int q = tid; q < kBK * kBN / 4; q += kThreads) {
      const int r = q >> 5, c = q & 31;
      cp_async16(bs + r * kBN + 4 * c,
                 a.B + (size_t)(ks * kBK + r) * N + n0 + 4 * c);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  if (steps > 0) issue(0);
  cp_async_commit();
  for (long long step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the slice has landed in every thread's share
    const long long t = tile_of(step);
    const int ks = (int)(step % ksteps);
    const long long p0 = (t / tiles_n) * kBM;
    const int n0 = (int)(t % tiles_n) * kBN;
    {  // the prologue on 8 elements of the slice, stored transposed
      const int buf = (int)(step & 1);
      const int r = tid & (kBM - 1), kh = tid >> 7;
      float x[8], x2[8];
      load8(raw + (buf * kBM + r) * lda + 8 * kh, x);
      if constexpr (PRO == kDx1)
        load8(raw2 + (buf * kBM + r) * lda2 + 8 * kh, x2);
      const long long p = p0 + r;
      const long long g = p / a.S;
      prologue<PRO, T>(x, x2, a.in, ks * kBK + 8 * kh, p < a.P, g,
                       (int)(p - g * a.S), K, a.dval, a.argmax);
#pragma unroll
      for (int j = 0; j < 8; ++j) As[(8 * kh + j) * kBM + r] = x[j];
    }
    __syncthreads();  // the transposed slice is complete
    mma_slice(As, Bs + (int)(step % 3) * kBK * kBN, acc);
    if (ks != ksteps - 1) continue;
    // the epilogue: write the tile, and its column sums into bsum; the
    // tile's two column halves one after the other
    float s1[8], s2[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + tile_col(4 * h);
      float4 m4{}, a4{}, r4{}, mr4{};
      if constexpr (EPI == kDy) {
        m4 = ld4(a.out.mul + col), a4 = ld4(a.out.add + col);
        r4 = ld4(a.out.r + col), mr4 = ld4(a.out.mr + col);
      }
      const float m[4] = {m4.x, m4.y, m4.z, m4.w};
      const float ad[4] = {a4.x, a4.y, a4.z, a4.w};
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float mr[4] = {mr4.x, mr4.y, mr4.z, mr4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) s1[4 * h + j] = s2[4 * h + j] = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long p = p0 + tile_row(i);
        if (p >= a.P) continue;
        const size_t at = (size_t)p * N + col;
        float v[4];
        if constexpr (EPI == kDy) {
          const float4 e4 = ld4f(E + at);
          const float e[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = affine(e[j], m[j], ad[j]) > 0.0f ? acc[i][4 * h + j]
                                                     : 0.0f;
            s1[4 * h + j] += v[j];
            s2[4 * h + j] += v[j] * xhat(e[j], rr[j], mr[j]);
          }
        } else {  // x1 or x2, rounded to bf16 in the bf16 form
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = rnd<T>(acc[i][4 * h + j]);
            s1[4 * h + j] += v[j];
            s2[4 * h + j] += v[j] * v[j];
          }
        }
        st4(Y + at, v);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], 16);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], 16);
      acc[0][j] = acc[1][j] = acc[2][j] = acc[3][j] = 0.0f;
      acc[4][j] = acc[5][j] = acc[6][j] = acc[7][j] = 0.0f;
    }
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[(warp * 2) * kBN + tile_col(j)] = s1[j];
        red[(warp * 2 + 1) * kBN + tile_col(j)] = s2[j];
      }
    }
    __syncthreads();
    {
      const int c = tid & (kBN - 1), k = tid >> 7;
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[(w * 2 + k) * kBN + c];
      bsum[k * N + n0 + c] += s;
    }
    // red is rewritten after the next tile's slices, each behind barriers
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < 2 * N; e += kThreads)
    a.ws[(size_t)blockIdx.x * 2 * N + e] = bsum[e];
}

// --------------------------------------------------------------------------
// bn_dw_gemm: dW (Ca x Nb) = ReLU(A·mul + add)^T pro(B) over the slots

struct DwArgs {
  const void* A;     // P x Ca, T
  const void* B;     // P x Nb: T (kDx2) or f32 d_y1 (kDx1)
  const void* B2;    // P x Nb, T: x1 beside d_y1 (kDx1)
  const float* dval;
  const int* argmax;
  Layer la;          // A's layer (Ca channels)
  Layer lb;          // B's layer (Nb channels)
  float* ws;         // splits x Ca x Nb
  long long P;
  long long rows_per;  // slots per split, a multiple of kBK
  int Ca, Nb, S;
  int tiles_n, ntile;
};

// The f32 form turns its landed f32 slices into the products' operands in
// place; the bf16 form's land in their own types and are turned into two
// f32 slices beside them
template <typename T>
constexpr bool kDwInPlace = std::is_same_v<T, float>;

template <int PRO, typename T>
__host__ __device__ constexpr size_t dw_raw_bytes() {
  using TB = RowA<PRO, T>;
  return (size_t)3 * kBK * kBM * sizeof(T) + (size_t)3 * kBK * kBN * sizeof(TB)
         + (PRO == kDx1 ? (size_t)3 * kBK * kBN * sizeof(T) : 0);
}

template <int PRO, typename T>
constexpr size_t dw_smem_bytes() {
  return dw_raw_bytes<PRO, T>()
         + (kDwInPlace<T> ? 0 : (size_t)kBK * (kBM + kBN) * sizeof(float));
}

template <int PRO, typename T>
__global__ void __launch_bounds__(kThreads, 2) bn_dw_gemm(const DwArgs a) {
  using TB = RowA<PRO, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ab = reinterpret_cast<T*>(smem);                       // 3 x kBK x kBM
  TB* Bb = reinterpret_cast<TB*>(Ab + 3 * kBK * kBM);       // 3 x kBK x kBN
  T* B2b = reinterpret_cast<T*>(Bb + 3 * kBK * kBN);        // (kDx1)
  float* Af = reinterpret_cast<float*>(smem + dw_raw_bytes<PRO, T>());
  float* Bf = Af + kBK * kBM;                               // (bf16 form)
  const T* A = static_cast<const T*>(a.A);
  const TB* B = static_cast<const TB*>(a.B);
  const T* B2 = static_cast<const T*>(a.B2);
  const int tid = threadIdx.x;
  const int t = blockIdx.x % a.ntile;
  const long long split = blockIdx.x / a.ntile;
  const int m0 = (t / a.tiles_n) * kBM, n0 = (t % a.tiles_n) * kBN;
  const long long pbeg = split * a.rows_per;
  const long long pend = min(a.P, pbeg + a.rows_per);
  const long long steps = pend > pbeg ? (pend - pbeg + kBK - 1) / kBK : 0;

  // rows past the split are zeroed by the prologue
  auto issue = [&](long long step) {
    const int buf = (int)(step % 3);
    const long long p = pbeg + step * kBK;
    stage_rows(Ab + buf * kBK * kBM, kBM, A, a.Ca, m0, kBM, p, kBK, pend);
    stage_rows(Bb + buf * kBK * kBN, kBN, B, a.Nb, n0, kBN, p, kBK, pend);
    if constexpr (PRO == kDx1)
      stage_rows(B2b + buf * kBK * kBN, kBN, B2, a.Nb, n0, kBN, p, kBK, pend);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  if (steps > 0) issue(0);
  cp_async_commit();
  for (long long step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the slices have landed
    const int buf = (int)(step % 3);
    float* pa0 = kDwInPlace<T> ? reinterpret_cast<float*>(Ab) + buf * kBK * kBM
                               : Af;
    float* pb0 = kDwInPlace<T> ? reinterpret_cast<float*>(Bb) + buf * kBK * kBN
                               : Bf;
    {  // the prologues on 8 elements of each operand
      const int r = tid >> 4, c = 8 * (tid & 15);
      const long long p = pbeg + step * kBK + r;
      const bool valid = p < pend;
      const long long g = p / a.S;
      float x[8], y[8], y2[8];
      load8(Ab + (buf * kBK + r) * kBM + c, x);
      load8(Bb + (buf * kBK + r) * kBN + c, y);
      if constexpr (PRO == kDx1) load8(B2b + (buf * kBK + r) * kBN + c, y2);
      prologue<kRelu, T>(x, x, a.la, m0 + c, valid, 0, 0, 0, nullptr,
                         nullptr);
      prologue<PRO, T>(y, y2, a.lb, n0 + c, valid, g, (int)(p - g * a.S),
                       a.Nb, a.dval, a.argmax);
      float* pa = pa0 + r * kBM + c;
      float* pb = pb0 + r * kBN + c;
      *reinterpret_cast<float4*>(pa) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(pa + 4) = make_float4(x[4], x[5], x[6], x[7]);
      *reinterpret_cast<float4*>(pb) = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(pb + 4) = make_float4(y[4], y[5], y[6], y[7]);
    }
    __syncthreads();
    mma_slice(pa0, pb0, acc);
  }
  cp_async_wait<0>();
  float* out = a.ws + (size_t)split * a.Ca * a.Nb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = out + (size_t)(m0 + tile_row(i)) * a.Nb + n0;
    *reinterpret_cast<float4*>(row + tile_col(0)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + tile_col(4)) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// --------------------------------------------------------------------------
// stats0, final and apply: one pass over a slab each

// Per channel sum x and sum x^2 of x (P x C) over the block's run of rows:
// thread (quad q, phase ph) takes channels 4q.. of rows ph, ph + phases,
// ..., in f32 over 64-row chunks, f64 across them -> ws[block] (2 x C).
template <typename T>
__global__ void __launch_bounds__(kThreads) bn_stats0_kernel(
    const T* __restrict__ x, long long P, int C, long long per_block,
    double* __restrict__ ws) {
  extern __shared__ __align__(16) double dsm[];
  const int Q = C / 4, phases = kThreads / Q;
  const int q = threadIdx.x % Q, ph = threadIdx.x / Q;
  const long long r0 = (long long)blockIdx.x * per_block;
  const long long r1 = min(P, r0 + per_block);
  double s[4] = {0.0, 0.0, 0.0, 0.0}, sq[4] = {0.0, 0.0, 0.0, 0.0};
  if (ph < phases) {
    for (long long c0 = r0 + ph; c0 < r1; c0 += 64LL * phases) {
      float ps[4] = {0.f, 0.f, 0.f, 0.f}, pq[4] = {0.f, 0.f, 0.f, 0.f};
      const long long c1 = min(r1, c0 + 64LL * phases);
      for (long long p = c0; p < c1; p += phases) {
        const float4 v = ld4f(x + (size_t)p * C + 4 * q);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[j] += e[j];
          pq[j] += e[j] * e[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] += ps[j];
        sq[j] += pq[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dsm[(ph * 2) * C + 4 * q + j] = s[j];
      dsm[(ph * 2 + 1) * C + 4 * q + j] = sq[j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * C; e += kThreads) {
    const int k = e / C, c = e % C;
    double v = 0.0;
    for (int w = 0; w < phases; ++w) v += dsm[(w * 2 + k) * C + c];
    ws[(size_t)blockIdx.x * 2 * C + e] = v;
  }
}

// For each (group, channel) of x2 (groups x S x C): the max over the S
// slots of ReLU(x2·mul + add) (rounded to bf16 in the bf16 form, before the
// comparison, as tpu3d pools it), the first slot that reaches it, and x2
// there. A warp per (group, 128 channels), 4 channels a lane.
template <typename T>
__global__ void __launch_bounds__(kThreads) bn_final_kernel(
    const T* __restrict__ x2, const float* __restrict__ mul,
    const float* __restrict__ add, long long groups, int S, int C,
    T* __restrict__ out, int* __restrict__ argmax, float* __restrict__ at) {
  const long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = C / 128;
  if (w >= groups * chunks) return;
  const long long g = w / chunks;
  const int c = (int)(w % chunks) * 128 + 4 * lane;
  float m[4], a[4];
  const float4 mm = ld4(mul + c), aa = ld4(add + c);
  m[0] = mm.x, m[1] = mm.y, m[2] = mm.z, m[3] = mm.w;
  a[0] = aa.x, a[1] = aa.y, a[2] = aa.z, a[3] = aa.w;
  float best[4] = {-1.f, -1.f, -1.f, -1.f}, raw[4] = {0.f, 0.f, 0.f, 0.f};
  int arg[4] = {0, 0, 0, 0};
  const T* src = x2 + (size_t)g * S * C + c;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float4 v = ld4f(src + (size_t)s * C);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = rnd<T>(fmaxf(affine(e[j], m[j], a[j]), 0.0f));
      if (y > best[j]) {  // strictly greater: the first slot keeps a tie
        best[j] = y;
        arg[j] = s;
        raw[j] = e[j];
      }
    }
  }
  const size_t o = (size_t)g * C + c;
  st4(out + o, best);
  *reinterpret_cast<int4*>(argmax + o) = make_int4(arg[0], arg[1], arg[2],
                                                   arg[3]);
  *reinterpret_cast<float4*>(at + o) = make_float4(raw[0], raw[1], raw[2],
                                                   raw[3]);
}

// d_x0 = s0 d_y0 - ca0 - cb0 (x0 r0 - mr0) from dy (P x C, f32) into dx
// (P x C, T): the f32 form passes dx = dy, in place
template <typename T>
__global__ void __launch_bounds__(kThreads) bn_apply_kernel(
    const float* dy, const T* __restrict__ x0, const Layer L,
    long long quads, int C, T* dx) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < quads; e += (long long)gridDim.x * kThreads) {
    const int c = (int)((4 * e) % C);
    const float4 d = reinterpret_cast<const float4*>(dy)[e];
    const float4 x = ld4f(x0 + 4 * e);
    const float4 s = ld4(L.s + c), ca = ld4(L.ca + c), cb = ld4(L.cb + c);
    const float4 r = ld4(L.r + c), mr = ld4(L.mr + c);
    const float v[4] = {
        grad_form(__fmul_rn(s.x, d.x), ca.x, cb.x, xhat(x.x, r.x, mr.x)),
        grad_form(__fmul_rn(s.y, d.y), ca.y, cb.y, xhat(x.y, r.y, mr.y)),
        grad_form(__fmul_rn(s.z, d.z), ca.z, cb.z, xhat(x.z, r.z, mr.z)),
        grad_form(__fmul_rn(s.w, d.w), ca.w, cb.w, xhat(x.w, r.w, mr.w))};
    st4(dx + 4 * e, v);
  }
}

// --------------------------------------------------------------------------
// host side

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

bool width_ok(int c) { return c >= 128 && c % 128 == 0 && c <= kMaxWidth; }

// layer l's seven vectors in the pack of widths (C1, C2, C3)
Layer layer_of(const float* pk, int l, int C1, int C2, int C3) {
  const int c = l == 0 ? C1 : l == 1 ? C2 : C3;
  const float* b = pk + (l == 0 ? 0 : l == 1 ? 7 * C1 : 7 * (C1 + C2));
  return Layer{b, b + c, b + 2 * c, b + 3 * c, b + 4 * c, b + 5 * c,
               b + 6 * c};
}

// The blocks of a row product over P slots at output width N: two per SM
int row_blocks(long long P, int N) {
  const long long tiles = (P + kBM - 1) / kBM * (N / kBN);
  return (int)std::min(tiles, 2LL * sm_count());
}

template <int PRO, int EPI, typename T>
cudaError_t launch_row(const RowArgs& a, int blocks, double* sums,
                       cudaStream_t stream) {
  const size_t smem = row_smem_bytes<PRO, T>()
                      + 2 * (size_t)a.N * sizeof(double);
  cudaError_t err = set_smem(bn_row_gemm<PRO, EPI, T>, smem);
  if (err != cudaSuccess) return err;
  bn_row_gemm<PRO, EPI, T><<<blocks, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce<double>(a.ws, blocks, 2LL * a.N, sums, stream);
}

// The splits of a weight-gradient product at output tiles ntile: about
// two blocks per SM in all
int dw_splits(long long P, int ntile) {
  long long s = 2LL * sm_count() / ntile;
  s = s < 1 ? 1 : s;
  const long long most = (P + kBK - 1) / kBK;
  return (int)(s < most ? s : most);
}

template <int PRO, typename T>
cudaError_t launch_dw(DwArgs a, int splits, float* grads,
                      cudaStream_t stream) {
  a.tiles_n = a.Nb / kBN;
  a.ntile = (a.Ca / kBM) * a.tiles_n;
  a.rows_per = ((a.P + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const size_t smem = dw_smem_bytes<PRO, T>();
  cudaError_t err = set_smem(bn_dw_gemm<PRO, T>, smem);
  if (err != cudaSuccess) return err;
  bn_dw_gemm<PRO, T><<<splits * a.ntile, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce<float>(a.ws, splits, (long long)a.Ca * a.Nb, grads, stream);
}

// The entries of both forms, on slabs of type T (see the C entries below)

template <typename T>
int stats0(const T* x0, long long P, int C1, double* ws, double* sums,
           cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (P < 1 || !width_ok(C1)) return (int)cudaErrorInvalidValue;
  const int blocks = row_blocks(P, 128);
  const long long per_block = (P + blocks - 1) / blocks;
  const int phases = kThreads / (C1 / 4);
  const size_t smem = (size_t)(phases > 0 ? phases : 1) * 2 * C1 * 8;
  bn_stats0_kernel<T><<<blocks, kThreads, smem, stream>>>(x0, P, C1,
                                                          per_block, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce<double>(ws, blocks, 2LL * C1, sums, stream);
}

template <typename T>
int layer(const T* x, const float* mul, const float* add, const float* w,
          long long P, int K, int N, T* y, double* ws, double* sums,
          cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (P < 1 || !width_ok(K) || !width_ok(N)) return (int)cudaErrorInvalidValue;
  RowArgs a{};
  a.A = x, a.B = w, a.Y = y, a.ws = ws, a.P = P, a.K = K, a.N = N, a.S = 1;
  a.in.mul = mul, a.in.add = add;
  a.tiles = (P + kBM - 1) / kBM * (N / kBN);
  return (int)launch_row<kRelu, kStats, T>(a, row_blocks(P, N), sums, stream);
}

template <typename T>
int final_pass(const T* x2, const float* mul, const float* add,
               long long groups, int S, int C3, T* out, int* argmax,
               float* at, cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (groups < 1 || S < 1 || !width_ok(C3)) return (int)cudaErrorInvalidValue;
  const long long warps = groups * (C3 / 128);
  bn_final_kernel<T><<<(unsigned)((warps + 7) / 8), kThreads, 0, stream>>>(
      x2, mul, add, groups, S, C3, out, argmax, at);
  return (int)cudaGetLastError();
}

template <typename T>
int wave1(const T* x2, const T* x1, const float* pk, const float* w2t,
          const float* dval, const int* argmax, long long P, int S, int C1,
          int C2, int C3, float* dy1, double* wsr, double* sums, float* wsd,
          float* dw2, cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (P < 1 || S < 1 || P % S || !width_ok(C1) || !width_ok(C2)
      || !width_ok(C3))
    return (int)cudaErrorInvalidValue;
  const Layer l1 = layer_of(pk, 1, C1, C2, C3);
  const Layer l2 = layer_of(pk, 2, C1, C2, C3);
  RowArgs a{};
  a.A = x2, a.B = w2t, a.E = x1, a.dval = dval, a.argmax = argmax;
  a.in = l2, a.out = l1, a.Y = dy1, a.ws = wsr;
  a.P = P, a.K = C3, a.N = C2, a.S = S;
  a.tiles = (P + kBM - 1) / kBM * (C2 / kBN);
  cudaError_t err = launch_row<kDx2, kDy, T>(a, row_blocks(P, C2), sums,
                                             stream);
  if (err != cudaSuccess) return (int)err;
  DwArgs d{};
  d.A = x1, d.B = x2, d.dval = dval, d.argmax = argmax, d.la = l1, d.lb = l2;
  d.ws = wsd, d.P = P, d.Ca = C2, d.Nb = C3, d.S = S;
  return (int)launch_dw<kDx2, T>(
      d, dw_splits(P, (C2 / kBM) * (C3 / kBN)), dw2, stream);
}

template <typename T>
int wave2(const float* dy1, const T* x1, const T* x0, const float* pk,
          const float* w1t, long long P, int C1, int C2, int C3, float* dy0,
          double* wsr, double* sums, float* wsd, float* dw1,
          cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (P < 1 || !width_ok(C1) || !width_ok(C2) || !width_ok(C3))
    return (int)cudaErrorInvalidValue;
  const Layer l0 = layer_of(pk, 0, C1, C2, C3);
  const Layer l1 = layer_of(pk, 1, C1, C2, C3);
  RowArgs a{};
  a.A = dy1, a.A2 = x1, a.B = w1t, a.E = x0, a.in = l1, a.out = l0;
  a.Y = dy0, a.ws = wsr, a.P = P, a.K = C2, a.N = C1, a.S = 1;
  a.tiles = (P + kBM - 1) / kBM * (C1 / kBN);
  cudaError_t err = launch_row<kDx1, kDy, T>(a, row_blocks(P, C1), sums,
                                             stream);
  if (err != cudaSuccess) return (int)err;
  DwArgs d{};
  d.A = x0, d.B = dy1, d.B2 = x1, d.la = l0, d.lb = l1;
  d.ws = wsd, d.P = P, d.Ca = C1, d.Nb = C2, d.S = 1;
  return (int)launch_dw<kDx1, T>(
      d, dw_splits(P, (C1 / kBM) * (C2 / kBN)), dw1, stream);
}

template <typename T>
int apply(const float* dy0, const T* x0, const float* pk, long long P,
          int C1, T* dx0, cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (P < 1 || !width_ok(C1)) return (int)cudaErrorInvalidValue;
  const long long quads = P * C1 / 4;
  const long long blocks = std::min((quads + kThreads - 1) / kThreads,
                                    8LL * sm_count());
  bn_apply_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      dy0, x0, layer_of(pk, 0, C1, 128, 128), quads, C1, dx0);
  return (int)cudaGetLastError();
}

cudaStream_t as_stream(void* p) { return static_cast<cudaStream_t>(p); }

}  // namespace

// The workspace each entry needs, in bytes (both forms): row products
// blocks x 2 x N doubles; weight-gradient products splits x Ca x Nb floats;
// stats0 blocks x 2 x C doubles. kind 0: stats0 over P slots of width C (N
// unused); 1: a row product at output width N; 2: a weight gradient Ca =
// C, Nb = N.
extern "C" long long tpu3d_fused_sa_bn_workspace(int kind, long long P,
                                                 int C, int N) {
  if (kind == 0) return (long long)row_blocks(P, 128) * 2 * C * 8;
  if (kind == 1) return (long long)row_blocks(P, N) * 2 * N * 8;
  return (long long)dw_splits(P, (C / kBM) * (N / kBN)) * C * N * 4;
}

// The f32 form.

// stats0: x0 (P x C1) -> sums (2 x C1) f64, the per-channel sum and sum of
// squares over every slot.
extern "C" int tpu3d_fused_sa_bn_stats0(const float* x0, long long P, int C1,
                                        double* ws, double* sums,
                                        void* stream_ptr) {
  return stats0(x0, P, C1, ws, sums, as_stream(stream_ptr));
}

// A statistics pass's layer: y (P x N) = ReLU(x·mul + add) w, x (P x K),
// mul and add K floats, w (K x N) -> y, sums (2 x N) f64 of y and y^2.
extern "C" int tpu3d_fused_sa_bn_layer(const float* x, const float* mul,
                                       const float* add, const float* w,
                                       long long P, int K, int N, float* y,
                                       double* ws, double* sums,
                                       void* stream_ptr) {
  return layer(x, mul, add, w, P, K, N, y, ws, sums, as_stream(stream_ptr));
}

// final: x2 (groups x S x C3), mul2 and add2 -> out, argmax, x2 at the
// argmax, each (groups x C3).
extern "C" int tpu3d_fused_sa_bn_final(const float* x2, const float* mul,
                                       const float* add, long long groups,
                                       int S, int C3, float* out, int* argmax,
                                       float* at, void* stream_ptr) {
  return final_pass(x2, mul, add, groups, S, C3, out, argmax, at,
                    as_stream(stream_ptr));
}

// wave 1: x2 (P x C3), x1 (P x C2), the pack pk, w2t = W2^T (C3 x C2),
// dval and argmax (groups x C3) -> dy1 (P x C2), sums (2 x C2) f64 of d_y1
// and d_y1 x̂1, dw2 (C2 x C3). wsr, wsd: the row and the weight-gradient
// products' workspaces.
extern "C" int tpu3d_fused_sa_bn_wave1(const float* x2, const float* x1,
                                       const float* pk, const float* w2t,
                                       const float* dval, const int* argmax,
                                       long long P, int S, int C1, int C2,
                                       int C3, float* dy1, double* wsr,
                                       double* sums, float* wsd, float* dw2,
                                       void* stream_ptr) {
  return wave1(x2, x1, pk, w2t, dval, argmax, P, S, C1, C2, C3, dy1, wsr,
               sums, wsd, dw2, as_stream(stream_ptr));
}

// wave 2: dy1 (P x C2), x1 (P x C2), x0 (P x C1), pk, w1t = W1^T (C2 x C1)
// -> dy0 (P x C1), sums (2 x C1) f64 of d_y0 and d_y0 x̂0, dw1 (C1 x C2).
extern "C" int tpu3d_fused_sa_bn_wave2(const float* dy1, const float* x1,
                                       const float* x0, const float* pk,
                                       const float* w1t, long long P, int C1,
                                       int C2, int C3, float* dy0,
                                       double* wsr, double* sums, float* wsd,
                                       float* dw1, void* stream_ptr) {
  return wave2(dy1, x1, x0, pk, w1t, P, C1, C2, C3, dy0, wsr, sums, wsd, dw1,
               as_stream(stream_ptr));
}

// apply: d_x0 = s0 d_y0 - ca0 - cb0 x̂0 in place of dy0 (P x C1); pk the
// pack, whose first layer (7 x C1) is read.
extern "C" int tpu3d_fused_sa_bn_apply(float* dy0, const float* x0,
                                       const float* pk, long long P, int C1,
                                       void* stream_ptr) {
  return apply(dy0, x0, pk, P, C1, dy0, as_stream(stream_ptr));
}

// The bf16 form: the same arguments, the chain's slabs (x0, x1, x2) and
// final's out in bf16; the weights (w, w2t, w1t) f32 rounded to bf16 by
// the caller; dy1 and dy0 f32.

extern "C" int tpu3d_fused_sa_bn_stats0_bf16(const bf16* x0, long long P,
                                             int C1, double* ws, double* sums,
                                             void* stream_ptr) {
  return stats0(x0, P, C1, ws, sums, as_stream(stream_ptr));
}

extern "C" int tpu3d_fused_sa_bn_layer_bf16(const bf16* x, const float* mul,
                                            const float* add, const float* w,
                                            long long P, int K, int N,
                                            bf16* y, double* ws, double* sums,
                                            void* stream_ptr) {
  return layer(x, mul, add, w, P, K, N, y, ws, sums, as_stream(stream_ptr));
}

extern "C" int tpu3d_fused_sa_bn_final_bf16(const bf16* x2, const float* mul,
                                            const float* add,
                                            long long groups, int S, int C3,
                                            bf16* out, int* argmax, float* at,
                                            void* stream_ptr) {
  return final_pass(x2, mul, add, groups, S, C3, out, argmax, at,
                    as_stream(stream_ptr));
}

extern "C" int tpu3d_fused_sa_bn_wave1_bf16(
    const bf16* x2, const bf16* x1, const float* pk, const float* w2t,
    const float* dval, const int* argmax, long long P, int S, int C1, int C2,
    int C3, float* dy1, double* wsr, double* sums, float* wsd, float* dw2,
    void* stream_ptr) {
  return wave1(x2, x1, pk, w2t, dval, argmax, P, S, C1, C2, C3, dy1, wsr,
               sums, wsd, dw2, as_stream(stream_ptr));
}

extern "C" int tpu3d_fused_sa_bn_wave2_bf16(
    const float* dy1, const bf16* x1, const bf16* x0, const float* pk,
    const float* w1t, long long P, int C1, int C2, int C3, float* dy0,
    double* wsr, double* sums, float* wsd, float* dw1, void* stream_ptr) {
  return wave2(dy1, x1, x0, pk, w1t, P, C1, C2, C3, dy0, wsr, sums, wsd, dw1,
               as_stream(stream_ptr));
}

// apply: d_x0 from dy0 (f32) and x0 (bf16) into dx0 (P x C1, bf16), rounded
// once, as tpu3d returns it in x0's dtype
extern "C" int tpu3d_fused_sa_bn_apply_bf16(const float* dy0, const bf16* x0,
                                            const float* pk, long long P,
                                            int C1, bf16* dx0,
                                            void* stream_ptr) {
  return apply(dy0, x0, pk, P, C1, dx0, as_stream(stream_ptr));
}
