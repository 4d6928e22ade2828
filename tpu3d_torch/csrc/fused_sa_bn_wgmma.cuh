// Kernel 9's bf16 training products redesigned for Hopper (sm_90a): the
// four product entries of fused_sa_bn.cu's bf16 form (stats1, stats2,
// wave1, wave2) on warpgroup products (wgmma), the layer's weight resident
// in shared memory, each slab tile read once for the whole output width
// and, in a wave, once for both of its products.
//
// Replaces, in their bf16 arithmetic, tpu3d/ops/fused_sa.py's
// _fwd_stats1_kernel (:164), _fwd_stats2_kernel (:171), _bwd_wave1_kernel
// (:255) and _bwd_wave2_kernel (:272), in the port's split into passes
// (fused_sa_bn.cu's note: x1 and x2 stored, every product run once):
//   layer (stats1, stats2)  Y = bf16(a W), a = bf16(ReLU(x·mul + add)) of
//       the stored x0 or x1; Y (x1 or x2) written in bf16, Σ Y and Σ Y²
//       per column of the rounded values;
//   wave 1  d_y1 = (d_x2 W2ᵀ)[x1·mul1 + add1 > 0], d_x2 = bf16([slot =
//       argmax]·dval − c2a − c2b·x̂2) from the stored x2; d_y1 written in
//       f32, Σ d_y1 and Σ d_y1·x̂1; dW2 = a1ᵀ d_x2, a1 = bf16(ReLU(x1·mul1
//       + add1));
//   wave 2  d_y0 = (d_x1 W1ᵀ)[x0·mul0 + add0 > 0], d_x1 = bf16(s1·d_y1 −
//       c1a − c1b·x̂1) from the stored f32 d_y1 and x1; d_y0 in f32, Σ d_y0
//       and Σ d_y0·x̂0; dW1 = a0ᵀ d_x1.
// Every product is of bf16 values with f32 sums, rounded where the SIMT
// design and the plain pieces round (the elementwise forms are fused_sa_bn
// .cu's own: affine, xhat, grad_form, step by step). A wave's f32 outputs
// differ from theirs only by the order of the f32 sums; a layer's bf16 x1
// and x2 are the SIMT design's bits (below).
//
// Bound on the card: bytes. Per slot a layer reads its input and writes
// its output (2·(128 + N) bytes) for 2·128·N operations: at the bf16 peak
// every entry falls under its bytes (the SIMT design ran these products
// at 26-32 TFLOP/s on f32 register tiles). So the design moves each byte
// once:
//   - persistent blocks of two warpgroups (two blocks an SM for a layer of
//     width 128, else one; four warpgroups for a layer of width 256) walk
//     the 64-row slot tiles blockIdx, + gridDim, ...;
//   - the bf16 weight of the layer (K x N, as the caller hands it: W1, W2,
//     W2ᵀ, W1ᵀ) is staged once per block into shared memory, transposed
//     into wgmma's K-major B layout with N rows in the 128-byte swizzle
//     (fused_sa_wgmma.cuh's kmajor and desc), 32 or 64 KB;
//   - a tile's raw rows (the A slab, x1 beside d_y1 in wave 2, a wave's E
//     slab, x1 or x0, and wave 1's group's dval and argmax rows) arrive by
//     cp.async a tile ahead into padded rows (16 bytes, so the epilogue's
//     column reads meet no bank twice): the prologues turn them into bf16
//     operands on their way into the swizzle, which a TMA load would have
//     to leave in place (fused_sa_wgmma_eval.cuh's header gives the same
//     reason for the eval design);
//   - the prologue forms the row product's A operand (a, d_x2 or d_x1) for
//     the whole depth K, a wave also bf16(ReLU(E·mul + add)) (a1 or a0);
//     rows past the slab are zeros, so they add nothing to any product.
//     It and the epilogue are built twice: a full tile of one group tests
//     no row, so its loads run ahead;
//   - warpgroup w takes its share of the row product's columns, 64 of
//     them: wgmma.m64n64k16 from shared memory over K / 16 steps, f32
//     accumulators in registers; the whole width N from one read of the
//     tile;
//   - a wave's weight gradient from the same two operand tiles: dW (N x K)
//     += ReLU(E)ᵀ · A over the tile's 64 slots, both operands slot-major,
//     read through wgmma's transposed (MN-major) layouts of the same
//     swizzled tiles (desc_mn), no transpose pass. Warpgroup w holds dW's
//     rows [64w, 64w + 64) for all K columns in registers across the
//     block's tiles (K / 128 accumulators of 64: 128 registers a thread at
//     wave 1's C3 = 256, beside the row product's 32), so the wave reads
//     its slabs once where the SIMT design ran a second launch over them;
//   - a layer's bf16 output is the SIMT design's (and the plain piece's
//     f32 product's) rounding of one f32 chain of multiply-adds in
//     ascending k. The tensor cores sum in another order, which moves a
//     cancelled sum by many bf16 steps of its own and flips a sum near a
//     rounding boundary: T = ‖a‖·‖w_n‖ (the row's norm from the prologue,
//     the column's once a block) bounds every partial sum, and an output
//     within 2^-24 T of a bf16 rounding boundary or below 2^-14 T in size
//     (order_sensitive: about 0.2% of them) is summed again as that chain
//     from the tile in shared memory (chain_dot), the warp's such outputs
//     one a lane, so a warp runs about one chain a tile. Two orders differ
//     by far less than 2^-24 T in practice, so every other output rounds
//     as the chain's: x1 and x2 keep the SIMT design's bits but for rare
//     one-step flips (within phase 19 (f)'s bound of chip_smoke.py), and
//     so do the masks, argmaxes and statistics downstream;
//   - the epilogue works on the accumulators' own layout: a layer rounds
//     to bf16, writes Y and sums the rounded values and squares; a wave
//     masks by the stored E (read from the tile's raw rows), writes f32
//     d_y and sums d_y and d_y·x̂. The column sums: the thread's two rows
//     in f32, the warp's eight row lanes by a reduce-scatter of three
//     __shfl_xor_sync rounds, the four warps through shared memory in f64,
//     then f64 in registers across the block's tiles;
//   - each block writes its partials once (f64 sums, f32 dW), which
//     fused_sa::reduce adds in block order: no atomics, so a step repeats
//     to the bit; P need not be a multiple of 64 (the tail tile's rows past
//     P take no part), offsets in size_t (SA_0's f32 d_y is 4.3 GB).
// Shared memory (layout): the weight, the A tile (64 x K) and a wave's
// ReLU(E) tile (64 x N) in the swizzle, two stages of raw rows (and of
// wave 1's group rows), the layers' vectors, a layer's norms and chain
// sums, the warps' column sums: of the 232 448 bytes a block may take, a
// layer 95 232 at N = 128 and 137 216 at 256, wave 1 146 432 at C3 = 128
// and all 232 448 at 256, wave 2 212 992. It takes a layer at K = 128, N
// 128 or 256; wave 1 at C2 = 128, C3 128 or 256; wave 2 at C1 = C2 = 128:
// both BatchNorm levels of the shipped configs (128 -> 128 -> 128 and ->
// 256). Other widths (up to BN_MAX_WIDTH, the widened RCNN's 256 -> 384 ->
// 256) keep the SIMT design, entry by entry: takes(), mirrored by
// ops/fused_sa.py::bn_train_bf16_design.
//
// Included by fused_sa_bn.cu after its elementwise forms (Layer, load8,
// affine, xhat, grad_form), which the prologues and epilogues share with
// the SIMT design; fused_sa_bn.cu's bf16 entries route between the two.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "fused_sa_common.cuh"
#include "fused_sa_wgmma.cuh"

namespace fused_sa_bn_wgmma {

using bf16 = __nv_bfloat16;
using fused_sa_wgmma::kTile;

// the four products: a statistics pass's layer, wave 1, wave 2
enum Pass { kLayer = 0, kWave1, kWave2 };

// warpgroups a block: four for a layer of width 256 (a quarter of the
// width each, as a layer of 128 takes half in each of two blocks an SM),
// else two
__host__ __device__ constexpr int warpgroups(int pass, int N) {
  return pass == kLayer && N == 256 ? 4 : 2;
}
constexpr unsigned kBlock = 64u * 128u;  // a 64-column block of a tile
constexpr int kChains = 64;  // a warp's chain sums a tile in shared memory

// vectors of the prologue's layer (K channels) a block keeps: mul, add
// (layer); r, mr, ca, cb (wave 1); s, r, mr, ca, cb (wave 2)
__host__ __device__ constexpr int vin_count(int pass) {
  return pass == kLayer ? 2 : pass == kWave1 ? 4 : 5;
}

// byte offsets in the block's shared memory, each region 1024-aligned
struct Layout {
  unsigned w, a, ae, raw, raw2, rawe, grp, vin, vout, norm, chain, red, total;
};

// K the row product's depth, N its width
__host__ __device__ inline Layout layout(int pass, int K, int N) {
  using fused_sa_wgmma::carve;
  const bool wave = pass != kLayer;
  const unsigned ea = pass == kWave2 ? 4u : 2u;  // bytes of an A value
  Layout L;
  unsigned at = 0;
  L.w = carve(at, 2u * K * N);
  L.a = carve(at, 2u * kTile * K);
  L.ae = carve(at, wave ? 2u * kTile * N : 0u);
  L.raw = carve(at, 2u * kTile * (ea * K + 16));
  L.raw2 = carve(at, pass == kWave2 ? 2u * kTile * (2 * K + 16) : 0u);
  L.rawe = carve(at, wave ? 2u * kTile * (2 * N + 16) : 0u);
  // wave 1: two stages of a group's dval (f32) and argmax (i32) rows
  L.grp = carve(at, pass == kWave1 ? 2u * 8 * K : 0u);
  L.vin = carve(at, 4u * K * vin_count(pass));
  L.vout = carve(at, wave ? 16u * N : 0u);  // mul, add, r, mr of E's layer
  L.norm = carve(at, wave ? 0u : 4u * (kTile + N));  // ‖a‖ rows, ‖w‖ columns
  // a layer's chain sums: per warp, kChains (row, column) codes and sums
  L.chain = carve(at, wave ? 0u : 4u * warpgroups(pass, N) * 8 * kChains);
  L.red = carve(at, 32u * N);  // [warpgroup][warp][Σ, Σ·][N / 2] f32
  L.total = at;
  return L;
}

// the dynamic shared memory asked for: the layout and room to align it
inline size_t smem_bytes(int pass, int K, int N) {
  return (size_t)layout(pass, K, N).total + 1024;
}

// Whether the design takes a product of depth K and width N: a layer at K
// = 128 (x0 or x1 of C = 128), N 128 or 256; wave 1 (K = C3, N = C2) at N
// = 128, K 128 or 256; wave 2 (K = C2, N = C1) at 128 and 128: the widths
// the products are built unrolled for (a warpgroup's half of N one
// accumulator, dW's rows 64 a warpgroup), whose layout fits.
inline bool takes(int pass, int K, int N) {
  const bool shape = pass == kLayer   ? K == 128 && (N == 128 || N == 256)
                     : pass == kWave1 ? N == 128 && (K == 128 || K == 256)
                                      : K == 128 && N == 128;
  return shape && smem_bytes(pass, K, N) <= fused_sa_wgmma::kSmemMax;
}

// d (+)= A·B, A 64 x 16 and B (N = 64) both K-major in shared memory: the
// 32 accumulators of a 64 x 64 tile; scale_d 0 starts the sums from zero
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A·B, A 64 x 16 (M x K) and B 16 x 128 (K x N) both MN-major in
// shared memory (imm-trans-a and -b set: the slot-major tiles read as
// they lie): the 64 accumulators of a 64 x 128 tile
__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The shared-memory descriptor of an MN-major operand in the 128-byte
// swizzle at `addr`, read from a 64-row tile stored as kmajor lays it out
// (a row's 64-column block is 128 bytes, swizzled by the row's place in
// its 8-row atom): the tile's rows are the product's K (8-row atoms 1024
// bytes apart, SBO), its columns the M or N side (64-column blocks 8192
// bytes apart, LBO).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(kBlock >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// keep the accumulators' registers in place around the asynchronous
// products (fused_sa_wgmma::fence_operands for any count)
template <int n>
__device__ __forceinline__ void keep(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 8 values rounded to bf16, packed in order
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  return u;
}

// The weight (K x N bf16, row-major) into the B operand at dst: N rows of
// K in the K-major swizzle, by the whole block
template <int K, int N>
__device__ __forceinline__ void stage_weight(const bf16* __restrict__ w,
                                             unsigned char* dst) {
  for (int e = threadIdx.x; e < K * N / 8; e += blockDim.x) {
    const int k = e / (N / 8), n8 = e - k * (N / 8);
    const uint4 v =
        __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * N + 8 * n8));
    const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned o =
          fused_sa_wgmma::kmajor(N, 8 * n8 + i, k >> 3) + 2 * (k & 7);
      *reinterpret_cast<bf16*>(dst + o) = h[i];
    }
  }
}

// Row `row` of the A tile at `a` (64 x K) times column n of the B operand
// at `w` (N rows of K), both in the K-major swizzle, as one f32 chain of
// multiply-adds in ascending k from 0: the SIMT design's order, which the
// plain piece's f32 product meets to the bit. Not inlined: one copy for
// the epilogue's calls keeps its code small.
template <int K, int N>
__device__ __noinline__ float chain_dot(const unsigned char* a,
                                           const unsigned char* w, int row,
                                           int n) {
  float s = 0.0f;
#pragma unroll 8
  for (int lc = 0; lc < K / 8; ++lc) {
    const uint4 av = *reinterpret_cast<const uint4*>(
        a + fused_sa_wgmma::kmajor(kTile, row, lc));
    const uint4 wv = *reinterpret_cast<const uint4*>(
        w + fused_sa_wgmma::kmajor(N, n, lc));
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&av);
    const __nv_bfloat162* wh = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(ah[i]);
      const float2 y = __bfloat1622float2(wh[i]);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
  }
  return s;
}

// Whether a layer's output y, the tensor cores' f32 sum, may round to
// another bf16 value than the chain's sum of the same terms. T = ‖a‖·‖w_n‖
// (the row's and the column's Euclidean norms) bounds Σ_k |a_k w_kn| and
// so every partial sum: each f32 addition rounds at most 2^-24 of one, so
// two orders of the 128 terms differ by at most some 2^-17 T and in
// practice by far less than 2^-24 T (random rounding errors, partial sums
// well under T). So y goes to the chain where it lies within 2^-24 T of a
// midpoint of its binade's bf16 grid, or where |y| < 2^-14 T: below, the
// nearest rounding boundary may lie in the binade beneath (at least a
// quarter step of y, 2^-10 |y|, away). About 0.2% of the outputs of a
// layer of Gaussian inputs and weights.
__device__ __forceinline__ bool order_sensitive(float y, float T) {
  const float ay = fabsf(y);
  // the midpoint of y's bf16 step: its high 16 bits, then 0x8000 (in y's
  // binade, so the difference is exact); no branch
  const float mid = __uint_as_float((__float_as_uint(ay) & 0xffff0000u) |
                                    0x8000u);
  return (T > 16384.0f * ay) | (fabsf(ay - mid) < T * 0x1p-24f);
}

// rows [0, valid) of a tile (row_bytes each, from src) into the padded
// stage dst (row stride ld bytes), 16 bytes a cp.async
__device__ __forceinline__ void load_tile(unsigned char* dst, int ld,
                                          const unsigned char* src,
                                          int row_bytes, int valid) {
  const int per = row_bytes / 16;
  for (int c = threadIdx.x; c < valid * per; c += blockDim.x) {
    const int r = c / per, ch = c - r * per;
    fused_sa_wgmma::cp_async16(dst + r * ld + 16 * ch,
                               src + (size_t)r * row_bytes + 16 * ch);
  }
}

// One round of row_lane_sums: lanes whose g differ in bit o / 4 trade
// halves of their first 2n values; v[i] keeps the sum of its half
template <int V, int n, int o>
__device__ __forceinline__ void row_lane_round(float (&v)[V], int lane) {
  const bool hi = lane & o;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float send = hi ? v[i] : v[i + n];
    v[i] = (hi ? v[i + n] : v[i]) + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// The sums over a warp's eight row lanes (g = lane / 4) of each lane's V
// values, as a reduce-scatter: in each of three rounds a lane keeps half
// of its values and sends the other half to the lane whose g differs in
// one bit. Lane g is left with the sums of values g·V/8 + i in v[i], i <
// V / 8.
template <int V>
__device__ __forceinline__ void row_lane_sums(float (&v)[V], int lane) {
  row_lane_round<V, V / 2, 16>(v, lane);
  row_lane_round<V, V / 4, 8>(v, lane);
  row_lane_round<V, V / 8, 4>(v, lane);
}

struct Args {
  const void* A;       // P x K: bf16 x0 or x1 (layer), x2 (wave 1); f32
                       // d_y1 (wave 2)
  const bf16* A2;      // P x K: x1 beside d_y1 (wave 2)
  const bf16* E;       // P x N: x1 (wave 1), x0 (wave 2)
  const bf16* W;       // K x N, row-major
  const float* dval;   // groups x K (wave 1)
  const int* argmax;   // groups x K (wave 1)
  Layer in;            // the prologue's layer (K channels)
  Layer out;           // E's layer (N channels, the waves)
  void* Y;             // P x N: bf16 (layer), f32 (waves)
  double* ws;          // blocks x 2 x N: the column sums' partials
  float* wsd;          // blocks x N x K: dW's partials (waves)
  long long P;
  int S;
};

template <int PASS, int K, int N>
__global__ void __launch_bounds__(128 * warpgroups(PASS, N),
                                  PASS == kLayer && N == 128 ? 2 : 1)
bn_wgmma_kernel(const Args a) {
  using namespace fused_sa_wgmma;
  using TA = std::conditional_t<PASS == kWave2, float, bf16>;
  using TY = std::conditional_t<PASS == kLayer, bf16, float>;
  constexpr bool kWave = PASS != kLayer;
  constexpr int kWG = warpgroups(PASS, N);
  constexpr int kThreads = 128 * kWG;
  constexpr int NW = N / kWG;              // row product columns a warpgroup
  constexpr int KC = kWave ? K / 128 : 1;  // dW's 128-column accumulators
  constexpr int kRow = K * (int)sizeof(TA);  // bytes of a row of A
  constexpr int ldr = kRow + 16, ldr2 = 2 * K + 16, lde = 2 * N + 16;
  constexpr int kV = NW / 2;  // a thread's column sums: 2 x NW / 4
  static_assert(NW == 64, "64 columns a warpgroup");
  static_assert(!kWave || kWG == 2, "dW's rows, 64 a warpgroup");
  static_assert(PASS != kLayer || K == 128, "a layer's row in a half warp");
  extern __shared__ unsigned char bn_smem[];
  unsigned char* smem =
      bn_smem + ((1024u - (smem_u32(bn_smem) & 1023u)) & 1023u);
  const Layout L = layout(PASS, K, N);
  float* vin = reinterpret_cast<float*>(smem + L.vin);
  float* vout = reinterpret_cast<float*>(smem + L.vout);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* rownorm = reinterpret_cast<float*>(smem + L.norm);  // this tile's
  float* colnorm = rownorm + kTile;
  const int tid = threadIdx.x;

  // the weight and the vectors, once per block
  stage_weight<K, N>(a.W, smem + L.w);
  {
    const float* src[5] = {a.in.mul, a.in.add, nullptr, nullptr, nullptr};
    if (PASS == kWave1) {
      src[0] = a.in.r, src[1] = a.in.mr, src[2] = a.in.ca, src[3] = a.in.cb;
    } else if (PASS == kWave2) {
      src[0] = a.in.s, src[1] = a.in.r, src[2] = a.in.mr, src[3] = a.in.ca;
      src[4] = a.in.cb;
    }
#pragma unroll
    for (int v = 0; v < vin_count(PASS); ++v)
      for (int c = tid; c < K; c += kThreads) vin[v * K + c] = src[v][c];
    if (kWave) {
      const float* o[4] = {a.out.mul, a.out.add, a.out.r, a.out.mr};
#pragma unroll
      for (int v = 0; v < 4; ++v)
        for (int c = tid; c < N; c += kThreads) vout[v * N + c] = o[v][c];
    } else {  // a layer's column norms ‖w_n‖
      for (int n = tid; n < N; n += kThreads) {
        float ss = 0.0f;
        for (int k = 0; k < K; ++k) {
          const float v = __bfloat162float(a.W[(size_t)k * N + n]);
          ss = fmaf(v, v, ss);
        }
        colnorm[n] = sqrtf(ss);
      }
    }
  }
  proxy_fence();
  __syncthreads();

  // the warpgroup's index through a shuffle: uniform to the compiler, so
  // that it keeps the products asynchronous
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int n0 = wg * NW;  // the warpgroup's columns of the row product
  unsigned char* at = smem + L.a;
  unsigned char* ae = smem + L.ae;
  const uint32_t a_s = smem_u32(at), ae_s = smem_u32(ae);
  const uint32_t w_s = smem_u32(smem + L.w);
  TY* Y = static_cast<TY*>(a.Y);

  const long long P = a.P;
  const long long tiles = (P + kTile - 1) / kTile;
  auto issue = [&](long long tile, int buf) {
    const long long p0 = tile * kTile;
    const int valid = (int)min((long long)kTile, P - p0);
    load_tile(smem + L.raw + buf * (kTile * ldr), ldr,
              static_cast<const unsigned char*>(a.A) + (size_t)p0 * kRow,
              kRow, valid);
    if (PASS == kWave2)
      load_tile(smem + L.raw2 + buf * (kTile * ldr2), ldr2,
                reinterpret_cast<const unsigned char*>(a.A2) +
                    (size_t)p0 * (2 * K),
                2 * K, valid);
    if (kWave)
      load_tile(smem + L.rawe + buf * (kTile * lde), lde,
                reinterpret_cast<const unsigned char*>(a.E) +
                    (size_t)p0 * (2 * N),
                2 * N, valid);
    if (PASS == kWave1) {  // the dval and argmax rows of its first group
      const size_t o = (size_t)(p0 / a.S) * K;
      unsigned char* g = smem + L.grp + buf * (8 * K);
      load_tile(g, 0, reinterpret_cast<const unsigned char*>(a.dval + o),
                4 * K, 1);
      load_tile(g + 4 * K, 0,
                reinterpret_cast<const unsigned char*>(a.argmax + o), 4 * K,
                1);
    }
  };

  float acc[NW / 2];      // the row product's tile
  float accw[KC][64];     // dW's rows [64 wg, 64 wg + 64), all K columns
  double tot = 0.0;  // the column sums' entry t ([Σ, Σ·][NW]) of the block
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int i = 0; i < 64; ++i) accw[c][i] = 0.f;

  int buf = 0;
  long long tile = blockIdx.x;
  if (tile < tiles) issue(tile, 0);
  fused_sa_wgmma::cp_async_commit();
  for (; tile < tiles; tile += gridDim.x, buf ^= 1) {
    // the next tile's rows in flight while this one computes
    if (tile + gridDim.x < tiles) issue(tile + gridDim.x, buf ^ 1);
    fused_sa_wgmma::cp_async_commit();
    fused_sa::cp_async_wait<1>();
    __syncthreads();  // this tile's rows have landed for every thread
    const long long p0 = tile * kTile;
    const int valid = (int)min((long long)kTile, P - p0);
    const unsigned char* raw = smem + L.raw + buf * (kTile * ldr);
    const unsigned char* raw2 = smem + L.raw2 + buf * (kTile * ldr2);
    const unsigned char* rawe = smem + L.rawe + buf * (kTile * lde);

    // the prologue: the row product's A operand into the swizzle, a thread
    // on 8 channels c.. of rows r, r + 256 / (K / 8), ..; zeros past P. Its
    // channels' vectors are read once a tile; a layer also forms each row's
    // ‖a‖ (its 16 threads' sums of squares, across the half warp). Built
    // twice: for a full tile of one group (no test a row, the loads free to
    // run ahead) and for any tile
    const bool full = valid == kTile &&
                      (PASS != kWave1 || p0 / a.S == (p0 + kTile - 1) / a.S);
    auto prologue = [&](auto full_tile) {
      constexpr bool kFull = decltype(full_tile)::value;
      {  // the A operand
        constexpr int kLc = K / 8;
        const int lc = tid % kLc, c = 8 * lc;
        float v0[8], v1[8], v2[8], v3[8], v4[8];
        load8(vin + c, v0);
        load8(vin + K + c, v1);
        if constexpr (PASS != kLayer) {
          load8(vin + 2 * K + c, v2);
          load8(vin + 3 * K + c, v3);
        }
        if constexpr (PASS == kWave2) load8(vin + 4 * K + c, v4);
        // wave 1: the group's dval and argmax, from the tile's first group's
        // rows staged with it, else (a tile across groups) from memory
        long long gcur = -1;
        float dv[8];
        int ag[8];
        if constexpr (PASS == kWave1) {
          const unsigned char* gs = smem + L.grp + buf * (8 * K);
          gcur = p0 / a.S;
          load8(reinterpret_cast<const float*>(gs) + c, dv);
          const int4 a0 = *reinterpret_cast<const int4*>(gs + 4 * K + 4 * c);
          const int4 a1 =
              *reinterpret_cast<const int4*>(gs + 4 * K + 4 * c + 16);
          ag[0] = a0.x, ag[1] = a0.y, ag[2] = a0.z, ag[3] = a0.w;
          ag[4] = a1.x, ag[5] = a1.y, ag[6] = a1.z, ag[7] = a1.w;
        }
  #pragma unroll
        for (int r = tid / kLc; r < kTile; r += kThreads / kLc) {
          uint4 packed = make_uint4(0u, 0u, 0u, 0u);
          float ss = 0.0f;
          if (kFull || r < valid) {
            float x[8];
            load8(reinterpret_cast<const TA*>(raw + r * ldr) + c, x);
            if constexpr (PASS == kLayer) {
  #pragma unroll
              for (int j = 0; j < 8; ++j) {
                x[j] = rnd<bf16>(fmaxf(affine(x[j], v0[j], v1[j]), 0.0f));
                ss = fmaf(x[j], x[j], ss);
              }
            } else if constexpr (PASS == kWave1) {
              const long long p = p0 + r, gr = kFull ? gcur : p / a.S;
              const int slot = (int)(p - gr * a.S);
              if (!kFull && gr != gcur) {
                gcur = gr;
                const size_t o = (size_t)gr * K + c;
                to8(ld4(a.dval + o), ld4(a.dval + o + 4), dv);
                const int4 a0 =
                    __ldg(reinterpret_cast<const int4*>(a.argmax + o));
                const int4 a1 =
                    __ldg(reinterpret_cast<const int4*>(a.argmax + o + 4));
                ag[0] = a0.x, ag[1] = a0.y, ag[2] = a0.z, ag[3] = a0.w;
                ag[4] = a1.x, ag[5] = a1.y, ag[6] = a1.z, ag[7] = a1.w;
              }
              // v0..v3: r, mr, ca, cb of layer 2
  #pragma unroll
              for (int j = 0; j < 8; ++j)
                x[j] = grad_form(ag[j] == slot ? dv[j] : 0.0f, v2[j], v3[j],
                                 xhat(x[j], v0[j], v1[j]));
            } else {  // v0..v4: s, r, mr, ca, cb of layer 1
              float x1[8];
              load8(reinterpret_cast<const bf16*>(raw2 + r * ldr2) + c, x1);
  #pragma unroll
              for (int j = 0; j < 8; ++j)
                x[j] = grad_form(__fmul_rn(v0[j], x[j]), v3[j], v4[j],
                                 xhat(x1[j], v1[j], v2[j]));
            }
            packed = pack8(x);
          }
          *reinterpret_cast<uint4*>(at + kmajor(kTile, r, lc)) = packed;
          if constexpr (PASS == kLayer) {
  #pragma unroll
            for (int o = 8; o >= 1; o >>= 1)
              ss += __shfl_xor_sync(0xffffffffu, ss, o);
            if (lc == 0) rownorm[r] = sqrtf(ss);
          }
        }
      }
      // a wave's dW operand: ReLU(E·mul + add) in bf16 (a1, a0)
      if constexpr (kWave) {
        constexpr int kLe = N / 8;
        const int lc = tid % kLe, c = 8 * lc;
        float m[8], ad[8];
        load8(vout + c, m);
        load8(vout + N + c, ad);
#pragma unroll
        for (int r = tid / kLe; r < kTile; r += kThreads / kLe) {
          uint4 packed = make_uint4(0u, 0u, 0u, 0u);
          if (kFull || r < valid) {
            float x[8];
            load8(reinterpret_cast<const bf16*>(rawe + r * lde) + c, x);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              x[j] = fmaxf(affine(x[j], m[j], ad[j]), 0.0f);
            packed = pack8(x);
          }
          *reinterpret_cast<uint4*>(ae + kmajor(kTile, r, lc)) = packed;
        }
      }
    };
    if (full)
      prologue(std::true_type{});
    else
      prologue(std::false_type{});
    proxy_fence();
    __syncthreads();  // the operand tiles are complete

    // the row product's columns [n0, n0 + NW) over the depth K, and a
    // wave's dW rows over the tile's 64 slots: issued together, waited
    // for once
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;  // (scale-d 0 at k = 0)
    keep(acc);
#pragma unroll
    for (int c = 0; c < KC; ++c) keep(accw[c]);
    wg_fence();
#pragma unroll
    for (int k = 0; k < K / 16; ++k) {
      const uint64_t da = desc(a_s + (k >> 2) * (kTile * 128) + (k & 3) * 32);
      const uint64_t db =
          desc(w_s + (k >> 2) * (N * 128) + n0 * 128 + (k & 3) * 32);
      wgmma_m64n64k16(acc, da, db, k > 0);
    }
    if constexpr (kWave) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          wgmma_m64n128k16_mn(accw[c],
                              desc_mn(ae_s + wg * kBlock + kk * 2048),
                              desc_mn(a_s + 2 * c * kBlock + kk * 2048),
                              1);
    }
    wg_commit_wait();
    keep(acc);
#pragma unroll
    for (int c = 0; c < KC; ++c) keep(accw[c]);

    // the epilogue on the accumulators' layout: columns n0 + 8j + 2q (+1),
    // rows 16 warp + g (+ 8) of acc[4j + 2h + e]; sums[stat · kV / 2 + 2j
    // + e]. A layer first sums its order-sensitive outputs as the chain
    // does: their bits in `sent` (in acc's order); the warp's first
    // kChains, numbered lane by lane, one a lane at once (their codes and
    // sums in shared memory); any beyond those in place
    unsigned long long sent = 0;
    int first = 0;  // the number of the thread's first chain sum
    int* codes =
        reinterpret_cast<int*>(smem + L.chain) + (wg * 4 + warp) * 2 * kChains;
    float* chained = reinterpret_cast<float*>(codes + kChains);
    auto row_of = [&](int i) { return 16 * warp + g + 8 * ((i >> 1) & 1); };
    auto col_of = [&](int i) { return n0 + 8 * (i >> 2) + 2 * q + (i & 1); };
    if constexpr (PASS == kLayer) {
      const float rn[2] = {rownorm[row_of(0)], rownorm[row_of(2)]};
      const bool in[2] = {row_of(0) < valid, row_of(2) < valid};
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const float2 cn =
            *reinterpret_cast<const float2*>(colnorm + col_of(4 * j));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const bool f0 = in[h] & order_sensitive(acc[i], rn[h] * cn.x);
          const bool f1 = in[h] & order_sensitive(acc[i + 1], rn[h] * cn.y);
          sent |= (unsigned long long)f0 << i | (unsigned long long)f1
                                                    << (i + 1);
        }
      }
      const int mine = __popcll(sent);
      first = mine;  // an inclusive scan over the lanes, then exclusive
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, first, o);
        if (lane >= o) first += v;
      }
      const int total = min(__shfl_sync(0xffffffffu, first, 31), kChains);
      first -= mine;
      unsigned long long todo = sent;
      for (int k = first; todo != 0 && k < kChains; ++k) {
        const int i = __ffsll((long long)todo) - 1;
        todo &= todo - 1;
        codes[k] = row_of(i) << 16 | col_of(i);
      }
      __syncwarp();
      for (int k = lane; k < total; k += 32)
        chained[k] = chain_dot<K, N>(at, smem + L.w, codes[k] >> 16,
                                     codes[k] & 0xffff);
      __syncwarp();
    }
    // output i's chain sum (bit i of sent set)
    auto chain_of = [&](int i) {
      const int k = first + __popcll(sent & ((1ull << i) - 1));
      return k < kChains ? chained[k]
                         : chain_dot<K, N>(at, smem + L.w, row_of(i),
                                           col_of(i));
    };
    float sums[kV];
    // (built twice, as the prologue: full tiles test no row)
    auto epilogue = [&](auto full_tile) {
      constexpr bool kFull = decltype(full_tile)::value;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        float2 m2{}, a2{}, r2{}, mr2{};
        if constexpr (kWave) {
          m2 = *reinterpret_cast<const float2*>(vout + col);
          a2 = *reinterpret_cast<const float2*>(vout + N + col);
          r2 = *reinterpret_cast<const float2*>(vout + 2 * N + col);
          mr2 = *reinterpret_cast<const float2*>(vout + 3 * N + col);
        }
        float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
          if (!kFull && row >= valid) continue;
          const size_t o = (size_t)(p0 + row) * N + col;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if constexpr (PASS == kLayer) {  // x1 or x2, rounded to bf16
            // the order-sensitive sums as the chain adds them
            const int i = 4 * j + 2 * h;
            if (sent >> i & 1) v0 = chain_of(i);
            if (sent >> (i + 1) & 1) v1 = chain_of(i + 1);
            const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(Y + o) = b;
            const float2 f = __bfloat1622float2(b);
            s1[0] += f.x, s1[1] += f.y;
            s2[0] += f.x * f.x, s2[1] += f.y * f.y;
          } else {  // d_y where E's pre-activation is > 0
            const float2 e = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(rawe + row * lde +
                                                         2 * col));
            v0 = affine(e.x, m2.x, a2.x) > 0.0f ? v0 : 0.0f;
            v1 = affine(e.y, m2.y, a2.y) > 0.0f ? v1 : 0.0f;
            *reinterpret_cast<float2*>(Y + o) = make_float2(v0, v1);
            s1[0] += v0, s1[1] += v1;
            s2[0] += v0 * xhat(e.x, r2.x, mr2.x);
            s2[1] += v1 * xhat(e.y, r2.y, mr2.y);
          }
        }
        sums[2 * j] = s1[0], sums[2 * j + 1] = s1[1];
        sums[kV / 2 + 2 * j] = s2[0], sums[kV / 2 + 2 * j + 1] = s2[1];
      }
    };
    if (valid == kTile)
      epilogue(std::true_type{});
    else
      epilogue(std::false_type{});
    // the warp's 16 rows, then its four warps in f64: this warpgroup's
    // columns, entry t of [stat][NW] a thread
    row_lane_sums<kV>(sums, lane);
    float* mine = red + (wg * 4 + warp) * 2 * NW;
#pragma unroll
    for (int i = 0; i < kV / 8; ++i) {
      const int idx = g * (kV / 8) + i;
      const int stat = idx / (kV / 2), ci = idx - stat * (kV / 2);
      mine[stat * NW + 8 * (ci >> 1) + 2 * q + (ci & 1)] = sums[i];
    }
    wg_bar(1 + wg);
    {
      const float* col = red + wg * 4 * 2 * NW + t;
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < 4; ++w) s += (double)col[w * 2 * NW];
      tot += s;
    }
    __syncthreads();  // this tile's stages are read before the next loads
  }
  fused_sa::cp_async_wait<0>();

  // the block's partials, written once
  {
    const int stat = t / NW;
    a.ws[(size_t)blockIdx.x * 2 * N + stat * N + n0 + (t - stat * NW)] = tot;
  }
  if constexpr (kWave) {
    float* out = a.wsd + (size_t)blockIdx.x * N * K;
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * wg + 16 * warp + g + 8 * h;
          *reinterpret_cast<float2*>(out + (size_t)row * K + 128 * c + 8 * j +
                                     2 * q) =
              make_float2(accw[c][4 * j + 2 * h], accw[c][4 * j + 2 * h + 1]);
        }
  }
}

// Launch pass PASS at depth K and width N on at most `most` blocks (the
// workspaces' partials), then add the blocks' partials in block order:
// the column sums into sums (2 x N f64), a wave's dW into dw (N x K f32)
template <int PASS, int K, int N>
cudaError_t launch_pass(const Args& a, long long most, double* sums,
                        float* dw, cudaStream_t stream) {
  auto kern = bn_wgmma_kernel<PASS, K, N>;
  constexpr int threads = 128 * warpgroups(PASS, N);
  const size_t smem = smem_bytes(PASS, K, N);
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    resident = std::max(per_sm, 1) * sms;
  }
  const long long tiles = (a.P + kTile - 1) / kTile;
  const long long blocks =
      std::max(1LL, std::min({tiles, (long long)resident, most}));
  kern<<<(unsigned)blocks, threads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fused_sa::reduce<double>(a.ws, (int)blocks, 2LL * N, sums, stream);
  if (err != cudaSuccess || PASS == kLayer) return err;
  return fused_sa::reduce<float>(a.wsd, (int)blocks, (long long)N * K, dw,
                                 stream);
}

// The entries' launches; the caller checked takes() and the arguments,
// and gives the most blocks its workspaces hold.

// a statistics pass's layer: y (P x N) = bf16(ReLU(x·mul + add) w)
inline cudaError_t run_layer(const bf16* x, const float* mul,
                             const float* add, const bf16* w, long long P,
                             int N, bf16* y, double* ws, double* sums,
                             long long most, cudaStream_t stream) {
  Args a{};
  a.A = x, a.W = w, a.Y = y, a.ws = ws, a.P = P, a.S = 1;
  a.in.mul = mul, a.in.add = add;
  return N == 128
             ? launch_pass<kLayer, 128, 128>(a, most, sums, nullptr, stream)
             : launch_pass<kLayer, 128, 256>(a, most, sums, nullptr, stream);
}

// wave 1 at C2 = 128: x2 (P x C3), x1, the layers l1 and l2, w2t (C3 x C2)
inline cudaError_t run_wave1(const bf16* x2, const bf16* x1, const Layer& l1,
                             const Layer& l2, const bf16* w2t,
                             const float* dval, const int* argmax,
                             long long P, int S, int C3, float* dy1,
                             double* wsr, double* sums, float* wsd,
                             float* dw2, long long most,
                             cudaStream_t stream) {
  Args a{};
  a.A = x2, a.E = x1, a.W = w2t, a.dval = dval, a.argmax = argmax;
  a.in = l2, a.out = l1, a.Y = dy1, a.ws = wsr, a.wsd = wsd, a.P = P;
  a.S = S;
  return C3 == 128
             ? launch_pass<kWave1, 128, 128>(a, most, sums, dw2, stream)
             : launch_pass<kWave1, 256, 128>(a, most, sums, dw2, stream);
}

// wave 2 at C1 = C2 = 128: d_y1 (P x C2, f32), x1, x0, the layers l0 and
// l1, w1t (C2 x C1)
inline cudaError_t run_wave2(const float* dy1, const bf16* x1,
                             const bf16* x0, const Layer& l0, const Layer& l1,
                             const bf16* w1t, long long P, float* dy0,
                             double* wsr, double* sums, float* wsd,
                             float* dw1, long long most,
                             cudaStream_t stream) {
  Args a{};
  a.A = dy1, a.A2 = x1, a.E = x0, a.W = w1t, a.in = l1, a.out = l0;
  a.Y = dy0, a.ws = wsr, a.wsd = wsd, a.P = P, a.S = 1;
  return launch_pass<kWave2, 128, 128>(a, most, sums, dw1, stream);
}

}  // namespace fused_sa_bn_wgmma
