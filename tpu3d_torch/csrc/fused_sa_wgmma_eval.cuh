// The bf16 eval forms of kernels 5 and 8 (the gather and the slab form
// without BatchNorm) and of kernel 9 (the slab form with BatchNorm, on
// running statistics), redesigned for Hopper (sm_90a) on fused_sa_wgmma.cuh's
// machinery: warpgroup products (wgmma) from shared memory, the weights
// resident in shared memory for the whole launch, the pool reduced in
// registers, short groups packed into one tile.
//
// Replaces, in their bf16 arithmetic, tpu3d/ops/fused_sa.py's
//   - _nobn2_eval_kernel (:771, through _g2_call :827, called at :882;
//     entry tpu3d_fused_sa_bf16): x0 = bf16(pre[row, idx[row, center, s]]
//     - center[row, center]) (_gather_x0 :734);
//   - _nobn_eval_kernel (:594, through _slab_call :307, called at :356;
//     entry tpu3d_fused_sa_slab_bf16): x0 row s of the group in a grouped
//     bf16 (R, M, S, C1) slab;
// then _chain_nobn (:559): a0 = ReLU(x0); x1 = bf16(bf16(a0·W1) +
// bf16(b1)); a1 = ReLU(x1); x2 = bf16(bf16(a1·W2) + bf16(b2)); out = max
// over the S slots of ReLU(x2), in bf16;
//   - _eval_chain_kernel (:203, called at :516-526; entry
//     tpu3d_fused_sa_slab_bn_bf16, the BatchNorm form): the same slab, then
//     _chain_to (:142) with the running statistics folded into one f32
//     (mul, add) per layer: a_k = bf16(ReLU(x_k·mul_k + add_k)) (x0 the
//     slab, x1 = bf16(a0·W1), x2 = bf16(a1·W2)), out = max over the S
//     slots of a2, each multiply and add rounded on its own in f32 (no
//     contraction), as ops/fused_sa.py::_bf16_acts_bn rounds them;
// every product of bf16 operands summed in f32. The products' f32 sums
// run in the tensor cores' order, so the kernel is held to the plain
// versions (ops/fused_sa.py::fused_gathered_mlp_pool_bf16_plain,
// fused_mlp_pool_bf16_plain, fused_sa_slab_bn_bf16_plain) within a
// tolerance; each group's arithmetic is fixed, so two calls give the same
// bits.
//
// Bound on the card: operations (2·S·(C1·C2 + C2·C3) per group in bf16
// against 2·S·C1 bytes of input rows). The parent design
// (fused_sa_bf16.cuh) runs mma.sync with the weights' fragments read
// through L1 at every k-step, one group a block at a time, nothing
// overlapping. This one:
//   - persistent blocks, one per SM, of three consumer warpgroups where
//     their stages fit beside the weights (C3 up to 384), else two; each
//     warpgroup walks its own units (unit = WG·block + wg, stepping by
//     WG·blocks);
//   - a unit is one group or, where S is a multiple of 16 that divides 64
//     (S = 16, 32), 64 / S consecutive groups packed into one 64-row tile
//     (groups_per_tile): at S = 16 each warp's 16 rows are one group. A
//     group of more than 64 slots (S = 128) takes several tiles and a
//     running maximum; any other S pads one tile per group with rows that
//     take no part in the max. A tile's rows are consecutive rows of the
//     R·M·S slots, so its ids and its slab rows are contiguous;
//   - W1ᵀ, W2ᵀ and the biases loaded once per block into shared memory in
//     the 128-byte swizzle that wgmma reads (stage_operand);
//   - the next tile's rows in registers, in flight while the current tile
//     computes, each load of a warp two whole rows (a lane a 16-byte
//     chunk): gathered by ids loaded a tile earlier, with the centers of
//     its groups (up to four) copied by cp.async (the gather form), or read
//     in place from the slab (the slab form). A slab tile is 64 contiguous
//     rows, which a TMA 2-D load could bring; the slab form reads it
//     through registers as the gather form does instead, because ReLU then
//     costs nothing on the way into the swizzled stage (after a TMA load it
//     would take a pass over the stage in shared memory, and the tensor map
//     would have to be encoded on the host at every call), and the loads
//     already run a tile ahead;
//   - layer 1 as wgmma.m64n128k16 from shared memory (a0 in the swizzled
//     stage), its epilogue (bias, rounding, ReLU) leaving a1 in bf16 in
//     registers: an accumulator's layout at rows g, g + 8 is the A
//     fragment wgmma takes from registers, so layer 2 runs as
//     wgmma.m64n128k16 with A from registers over 128-column chunks of C3,
//     with no a1 tile in shared memory and no barrier between the layers;
//   - layer 2's epilogue pools in registers. a2 = ReLU(bf16(bf16(v) + b2))
//     is monotone in v, so the max of a2 over a group's slots is that
//     function of the max of bf16(v): each thread rounds its rows 16·warp
//     + g and + 8 to bf16 (rows past the tile's valid slots -inf), takes
//     their max, then the max over the warp's eight row lanes by a
//     reduce-scatter of three __shfl_xor_sync rounds (14 shuffles of bf16
//     pairs, each lane left with four columns): the warp's 16-row column
//     maximum. At S = 16 that is the group's, and the bias and ReLU
//     (fma.rn.relu of m·1 + b2, which rounds the exact sum once, as add.rn
//     does) turn it into the output row, written from registers; otherwise
//     the warps of a group meet in a small buffer in shared memory, a later
//     tile of the same group folds into a running max kept there by the
//     thread that owns the column pair, and the bias and ReLU are applied
//     as the group's row is written. No x2 tile, no walk down a column: a
//     max of bf16 values is exact and independent of order.
// The BatchNorm form puts its three affines where the biases go: a0's on
// the way into the stage (each loaded x0 in f32 through mul0 and add0 of
// the lane's fixed eight channels), a1's on layer 1's accumulator (mul1
// and add1 at the fragment's columns), a2's after the pool. f(v) =
// bf16(ReLU(bf16(v)·mul2 + add2)) is non-decreasing in v where mul2 >= 0
// and non-increasing where mul2 < 0 (a trained gamma can be negative), so
// the max of f over a group's slots is f of the max of bf16(v), or of its
// min: one reduction takes both, each column's bf16(v) with its sign
// flipped by mul2's sign bit (exact) before the column max, the flip
// undone and f applied as the output is written. The packs and the sign
// bits sit in shared memory in place of the centers and biases.
// Shared memory (layout): 2·(C1·C2 + C2·C3) bytes of weights, per
// warpgroup a 64-row stage of C1, two tiles' centers (four each; none in
// the BatchNorm form, which holds its packs instead), the warps' column
// maxima and the running max: of the 232 448 bytes a block may take on
// sm_90, 128 000 at the RCNN's SA_0 (128 -> 128 -> 128) and 164 864 at its
// SA_1 (-> 256), with BatchNorm 123 904 and 161 792, three warpgroups at
// all four. It takes C1 = C2 = 128 and C3 a multiple of 128 up to 512 in
// both forms (takes(), mirrored by ops/fused_sa.py::eval_bf16_design):
// every level the shipped configs fuse at eval, with BatchNorm set too;
// the widened RCNN's 256 -> 384 -> 256 keeps the parent design.
//
// Included by fused_sa_bf16.cuh, whose C entries tpu3d_fused_sa_bf16,
// tpu3d_fused_sa_slab_bf16 and tpu3d_fused_sa_slab_bn_bf16 route between
// the two designs by shape.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_sa_wgmma.cuh"

namespace fused_sa_wgmma_eval {

using bf16 = __nv_bfloat16;
using fused_sa_wgmma::carve;
using fused_sa_wgmma::kN;
using fused_sa_wgmma::kSmemMax;
using fused_sa_wgmma::kTile;

constexpr int kMaxGroups = kTile / 16;  // groups a packed tile holds

// byte offsets in the block's shared memory, each region 1024-aligned
struct Layout {
  unsigned w1, w2, stage, ctr, b1, b2, part, pool, packs, total;
};

// for `wgs` warpgroups a block; `bn` the BatchNorm form's layout: no
// centers and no biases, the packs in f32 and, where b2 lies, layer 2's
// column signs (bf16 sign bits)
__host__ __device__ inline Layout layout(int C1, int C2, int C3, int wgs,
                                         bool bn = false) {
  Layout L;
  unsigned at = 0;
  L.w1 = carve(at, 2u * C1 * C2);
  L.w2 = carve(at, 2u * C2 * C3);
  L.stage = carve(at, 2u * wgs * kTile * C1);
  // two tiles' centers
  L.ctr = carve(at, bn ? 0u : 2u * wgs * 2 * kMaxGroups * C1);
  L.b1 = carve(at, bn ? 0u : 2u * C2);
  L.b2 = carve(at, 2u * C3);
  L.part = carve(at, 2u * wgs * 4 * C3);  // each warp's column maxima
  L.pool = carve(at, 2u * wgs * C3);      // a group's running max
  L.packs = carve(at, bn ? 8u * (C1 + C2 + C3) : 0u);
  L.total = at;
  return L;
}

// the dynamic shared memory asked for: the layout and room to align it
inline size_t smem_bytes(int C1, int C2, int C3, int wgs, bool bn = false) {
  return (size_t)layout(C1, C2, C3, wgs, bn).total + 1024;
}

// Warpgroups a block: three where their stages fit beside the weights
// (C3 up to 384), else two (512), 0 where neither fits.
inline int warpgroups(int C1, int C2, int C3, bool bn = false) {
  return smem_bytes(C1, C2, C3, 3, bn) <= kSmemMax   ? 3
         : smem_bytes(C1, C2, C3, 2, bn) <= kSmemMax ? 2
                                                     : 0;
}

// Whether this design takes widths C1 -> C2 -> C3 (any S, R, M) in the
// form without BatchNorm or (bn) with it: C1 = C2 = 128 (the products'
// depth, built unrolled; layer 1's 128 columns are one accumulator, layer
// 2's operand in registers), C3 a multiple of 128 (a wgmma's columns), and
// the layout in shared memory (C3 up to 512 in both forms).
inline bool takes(int C1, int C2, int C3, bool bn = false) {
  return C1 == 128 && C2 == 128 && C3 >= 128 && C3 % 128 == 0 &&
         warpgroups(C1, C2, C3, bn) > 0;
}

// Groups a 64-row tile packs: 64 / S where S is a multiple of 16 that
// divides 64 (so that each group's rows are whole warps' rows: 4 at S 16,
// 2 at S 32, 1 at S 64), else 1.
__host__ __device__ inline int groups_per_tile(int S) {
  return S % 16 == 0 && kTile % S == 0 ? kTile / S : 1;
}

// Tile `tile` of unit `unit`: its first group, the groups it holds, its
// first row's slot in the first group, its first row in the R·M·S slot
// rows, and its rows that are slots of its groups (the rest pad it).
struct Tile {
  long long row0;
  int grp0, groups, s0, valid;
};

__device__ __forceinline__ Tile tile_at(int unit, int tile, int G, int S,
                                        int groups) {
  Tile T;
  T.grp0 = unit * G;
  T.groups = min(G, groups - T.grp0);
  T.s0 = tile * kTile;
  T.row0 = (long long)T.grp0 * S + T.s0;
  T.valid = min(kTile, T.groups * S - T.s0);
  return T;
}

// A thread's share of a tile, C1 = 128: 16-byte chunk c = lane % 16 of the
// rows 16·warp + 2i + lane / 16, i = 0 .. 7, so that each load of a warp
// takes two whole rows (512 contiguous bytes of a slab) and each of its
// rows' group is the warp's: k = warp·G / 4 of the tile's groups (G
// groups a tile: a group's rows are whole warps' rows)
constexpr int kRowsPerThread = kTile / 8;

// The id of row 16·warp + lane % 16 of tile T, or -1 past its valid rows.
// Loaded a tile ahead of its gather, which shuffles each row's id to the
// lanes that load it.
__device__ __forceinline__ int row_id(const int* __restrict__ idx,
                                      const Tile& T, int warp, int lane) {
  const int row = 16 * warp + (lane & 15);
  return row < T.valid ? __ldg(idx + T.row0 + row) : -1;
}

// The thread's share of tile T into registers, zeros past the valid rows:
// the gather form's rows (ids `id` as row_id gave them) in the scene of the
// warp's group, the slab form's rows in place
template <int C1, bool GATHER>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src,
                                          const Tile& T, int id, int G,
                                          int N, int M, int warp, int lane,
                                          uint4 (&v)[kRowsPerThread]) {
  static_assert(C1 == 128, "16 lanes a row");
  const int c = lane & 15, sub = lane >> 4;
  const bf16* base =
      GATHER ? src + (size_t)((T.grp0 + ((warp * G) >> 2)) / M) * N * C1
             : src + (size_t)T.row0 * C1;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    // the gather's row: its id (-1 past the valid rows); the slab's: its
    // place in the tile
    const int row = GATHER ? __shfl_sync(0xffffffffu, id, 2 * i + sub)
                           : (16 * warp + 2 * i + sub < T.valid
                                  ? 16 * warp + 2 * i + sub
                                  : -1);
    v[i] = row >= 0 ? __ldg(reinterpret_cast<const uint4*>(
                          base + (size_t)row * C1) + c)
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

// cp.async of the center rows of tile T's groups into ctr (16-byte chunks,
// C1 / 8 threads a center)
template <int C1>
__device__ __forceinline__ void centers_async(const bf16* __restrict__ center,
                                              const Tile& T, bf16* ctr,
                                              int t) {
  constexpr int kChunks = C1 / 8;
  const int k = t / kChunks, c = t - k * kChunks;
  if (k < T.groups)
    fused_sa_wgmma::cp_async16(ctr + k * C1 + c * 8,
                               center + (size_t)(T.grp0 + k) * C1 + c * 8);
}

// a0 of the thread's share into the stage in the swizzle, zeros past the
// tile's valid rows: ReLU(bf16(x - center)) with the warp's group's center
// (the gather form), ReLU(x) (the slab form)
template <int C1, bool GATHER>
__device__ __forceinline__ void store_a0(unsigned char* stage,
                                         const uint4 (&v)[kRowsPerThread],
                                         const bf16* ctrs, const Tile& T,
                                         int G, int warp, int lane) {
  const int c = lane & 15, sub = lane >> 4;
  uint4 craw = make_uint4(0u, 0u, 0u, 0u);
  if (GATHER)
    craw = *reinterpret_cast<const uint4*>(ctrs + ((warp * G) >> 2) * C1 +
                                           c * 8);
  const __nv_bfloat162* cv = reinterpret_cast<const __nv_bfloat162*>(&craw);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = 16 * warp + 2 * i + sub;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (row < T.valid) {
      const __nv_bfloat162* xv =
          reinterpret_cast<const __nv_bfloat162*>(&v[i]);
      __nv_bfloat162* res = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        // ReLU(bf16(x - center)): fma.rn of center·-1 + x rounds the exact
        // difference once, as sub.rn does
        res[j] = GATHER ? __hfma2_relu(cv[j], __float2bfloat162_rn(-1.f),
                                       xv[j])
                        : fused_sa_wgmma::relu2(xv[j]);
    }
    *reinterpret_cast<uint4*>(
        stage + fused_sa_wgmma::kmajor(kTile, row, c)) = packed;
  }
}

// The BatchNorm form's affine of a bf16 pair, as the plain version rounds
// it: bf16(ReLU(x·mul + add)), the multiply and the add each rounded in
// f32 (no contraction). q holds the pair's (mul, mul, add, add). The pair
// is widened by bit moves, and ReLU rides on the conversion back
// (cvt.rn.relu): x is bf16, and ReLU before the rounding gives what the
// rounding before ReLU gives.
__device__ __forceinline__ __nv_bfloat162 affine2(__nv_bfloat162 x,
                                                  float4 q) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&x);
  const float lo = __uint_as_float(u << 16);
  const float hi = __uint_as_float(u & 0xffff0000u);
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;"
      : "=r"(r)
      : "f"(__fadd_rn(__fmul_rn(hi, q.y), q.w)),
        "f"(__fadd_rn(__fmul_rn(lo, q.x), q.z)));
  return *reinterpret_cast<__nv_bfloat162*>(&r);
}

// The BatchNorm form's a0 of the thread's share into the stage in the
// swizzle, zeros past the tile's valid rows: bf16(ReLU(x·mul0 + add0)) of
// the lane's eight channels 8c .. 8c + 7 (layer 0's quads in shared
// memory)
template <int C1>
__device__ __forceinline__ void store_a0_bn(unsigned char* stage,
                                            const uint4 (&v)[kRowsPerThread],
                                            const float4* quads0,
                                            const Tile& T, int warp,
                                            int lane) {
  const int c = lane & 15, sub = lane >> 4;
  float4 q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = quads0[4 * c + j];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = 16 * warp + 2 * i + sub;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (row < T.valid) {
      const __nv_bfloat162* xv =
          reinterpret_cast<const __nv_bfloat162*>(&v[i]);
      __nv_bfloat162* res = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) res[j] = affine2(xv[j], q[j]);
    }
    *reinterpret_cast<uint4*>(
        stage + fused_sa_wgmma::kmajor(kTile, row, c)) = packed;
  }
}

// One layer's packs (mul, add: C floats each) as C / 2 quads (mul, mul,
// add, add) of its column pairs, by the whole block
__device__ __forceinline__ void stage_quads(const float* __restrict__ mul,
                                            const float* __restrict__ add,
                                            int C, float4* dst) {
  for (int p = threadIdx.x; p < C / 2; p += blockDim.x)
    dst[p] = make_float4(mul[2 * p], mul[2 * p + 1], add[2 * p],
                         add[2 * p + 1]);
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 from_bits2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// d (+)= A·Bᵀ for a 64 x 16 A tile in registers (a: the thread's four bf16
// pairs, in its warp's 16 rows as mma.sync's A fragment lays them: rows g,
// g + 8 at columns 2·q4, +1, then at 8 + 2·q4, +1) and a 128 x 16 B tile in
// shared memory (descriptor db), f32 sums in the thread's 64 accumulators;
// scale_d 0 starts the sums from zero
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// acc = A·B[n0 .. n0 + 127]ᵀ: A the K-column operand in registers (a[k]
// the k-th 16 columns), B the K-major operand of `brows` rows at `b`; K a
// multiple of 64, the products unrolled
template <int K>
__device__ __forceinline__ void product_rs(float (&acc)[64],
                                           uint32_t (&a)[K / 16][4],
                                           uint32_t b, int brows, int n0) {
  using namespace fused_sa_wgmma;
  fence_operands(acc);
#pragma unroll
  for (int k = 0; k < K / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
  wg_fence();
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    const uint32_t kb = b + (k >> 2) * (brows * 128) + n0 * 128 + (k & 3) * 32;
    wgmma_m64n128k16_rs(acc, a[k], desc(kb), k > 0);
  }
  wg_commit_wait();
  fence_operands(acc);
}

__device__ __forceinline__ __nv_bfloat162 shfl_xor2(__nv_bfloat162 v,
                                                    int off) {
  unsigned u = *reinterpret_cast<unsigned*>(&v);
  u = __shfl_xor_sync(0xffffffffu, u, off);
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// The max over the warp's eight row lanes (g = lane / 4) of each lane's 16
// column pairs m[j] (columns 8j + 2·(lane % 4), +1), as a reduce-scatter:
// in each of three rounds a lane keeps half of its pairs and sends the
// other half to the lane whose g differs in one bit. Lane g is left with
// pairs j = 2g and 2g + 1 in m[0] and m[1].
__device__ __forceinline__ void warp_column_max(__nv_bfloat162 (&m)[16],
                                                int lane) {
  const bool h2 = lane & 16, h1 = lane & 8, h0 = lane & 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 send = h2 ? m[i] : m[i + 8];
    m[i] = __hmax2(h2 ? m[i + 8] : m[i], shfl_xor2(send, 16));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 send = h1 ? m[i] : m[i + 4];
    m[i] = __hmax2(h1 ? m[i + 4] : m[i], shfl_xor2(send, 8));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat162 send = h0 ? m[i] : m[i + 2];
    m[i] = __hmax2(h0 ? m[i + 2] : m[i], shfl_xor2(send, 4));
  }
}

// the next tile of a warpgroup's walk after (u, ti)
__device__ __forceinline__ void advance(int& u, int& ti, int tiles,
                                        int stride) {
  if (++ti == tiles) {
    ti = 0;
    u += stride;
  }
}

// C1 and C2 (the products' depths) are template arguments, so that each
// product's wgmmas run unrolled; WG warpgroups a block; GATHER the gather
// form (src = pre, idx and center read), else the slab form (src = x0);
// BN the slab form with BatchNorm (packs [mul0 | add0 | mul1 | add1 | mul2
// | add2] in f32 for the biases; idx, center, b1, b2 unread)
template <int C1, int C2, int WG, bool GATHER, bool BN>
__global__ void __launch_bounds__(128 * WG, 1)
eval_kernel(const bf16* __restrict__ src, const int* __restrict__ idx,
            const bf16* __restrict__ center, const float* __restrict__ packs,
            const bf16* __restrict__ w1t, const bf16* __restrict__ b1,
            const bf16* __restrict__ w2t, const bf16* __restrict__ b2, int R,
            int N, int M, int S, int C3, bf16* __restrict__ out) {
  using namespace fused_sa_wgmma;
  static_assert(C2 == kN, "layer 1's columns are one accumulator");
  static_assert(!(GATHER && BN), "BatchNorm takes the slab form");
  extern __shared__ unsigned char eval_smem[];
  unsigned char* smem =
      eval_smem + ((1024u - (smem_u32(eval_smem) & 1023u)) & 1023u);
  const Layout L = fused_sa_wgmma_eval::layout(C1, C2, C3, WG, BN);
  bf16* b1s = reinterpret_cast<bf16*>(smem + L.b1);
  bf16* b2s = reinterpret_cast<bf16*>(smem + L.b2);
  // the BatchNorm form's packs as quads of column pairs, layer by layer
  float4* quads0 = reinterpret_cast<float4*>(smem + L.packs);
  float4* quads1 = quads0 + C1 / 2;
  float4* quads2 = quads1 + C2 / 2;
  // the weights and biases (the packs, and layer 2's column signs), once
  // per block
  stage_operand(w1t, C2, C1, smem + L.w1);
  stage_operand(w2t, C3, C2, smem + L.w2);
  if (BN) {
    const float* mul1 = packs + 2 * C1;
    const float* mul2 = mul1 + 2 * C2;
    stage_quads(packs, packs + C1, C1, quads0);
    stage_quads(mul1, mul1 + C2, C2, quads1);
    stage_quads(mul2, mul2 + C3, C3, quads2);
    // mul2's sign bit, as a bf16 sign: a column whose mul2 is negative
    // pools the min of bf16(v), the max of its negation
    unsigned short* sign = reinterpret_cast<unsigned short*>(b2s);
    for (int c = threadIdx.x; c < C3; c += 128 * WG)
      sign[c] = (unsigned short)((__float_as_uint(
                                      packs[2 * (C1 + C2) + c]) >> 16) &
                                  0x8000u);
  } else {
    for (int c = threadIdx.x; c < C2; c += 128 * WG) b1s[c] = b1[c];
    for (int c = threadIdx.x; c < C3; c += 128 * WG) b2s[c] = b2[c];
  }
  proxy_fence();
  __syncthreads();

  // the warpgroup's index through a shuffle: uniform to the compiler, so
  // that it keeps the products asynchronous in the loops it bounds
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int bar = 1 + wg;
  unsigned char* cur = smem + L.stage + wg * 2u * kTile * C1;
  const uint32_t w1s = smem_u32(smem + L.w1), w2s = smem_u32(smem + L.w2);
  const uint32_t a0s = smem_u32(cur);
  bf16* ctrs = reinterpret_cast<bf16*>(smem + L.ctr) +
               wg * 2 * kMaxGroups * C1;
  const int pairs = C3 / 2;  // bf16 pairs of an output row
  __nv_bfloat162* part =
      reinterpret_cast<__nv_bfloat162*>(smem + L.part) + wg * 4 * pairs;
  __nv_bfloat162* pool =
      reinterpret_cast<__nv_bfloat162*>(smem + L.pool) + wg * pairs;
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
  const __nv_bfloat162 lowest =
      __float2bfloat162_rn(__int_as_float((int)0xff800000u));  // -inf
  // layer 2's column signs, a pair at a time
  const uint32_t* sign2 = reinterpret_cast<const uint32_t*>(b2s);
  const __nv_bfloat162* b2p = reinterpret_cast<const __nv_bfloat162*>(b2s);
  // a group's pooled pair p (of the sign-flipped bf16(v) under BN) as the
  // output pair: ReLU(bf16(m + b2)) (fma.rn.relu of m·1 + b2, which rounds
  // the exact sum once, as add.rn does), or under BN the flip undone and
  // layer 2's affine applied
  auto finish = [&](__nv_bfloat162 m, int p) {
    if (BN) return affine2(from_bits2(bits2(m) ^ sign2[p]), quads2[p]);
    return __hfma2_relu(m, one, b2p[p]);
  };

  // R·M < 2^31 (the wrapper checks it): group indices in 32 bits
  const int groups = R * M;
  const int G = groups_per_tile(S);
  const int W = G > 1 ? 4 / G : 4;              // warps a group's rows span
  const int tiles = (S + kTile - 1) / kTile;    // tiles a unit (1 if packed)
  const int units = (groups + G - 1) / G;
  const int stride = gridDim.x * WG;
  // the walk over this warpgroup's tiles: (unit, tile) and the next two
  int unit = blockIdx.x * WG + wg;
  int tile = 0, stage = 0;
  int nunit = unit, n2unit;
  int ntile = 0, n2tile;
  advance(nunit, ntile, tiles, stride);
  uint4 rows[kRowsPerThread];  // this thread's share of the next tile
  if (unit < units) {
    const Tile T = tile_at(unit, 0, G, S, groups);
    if (GATHER) centers_async<C1>(center, T, ctrs, t);
    load_rows<C1, GATHER>(src, T, GATHER ? row_id(idx, T, warp, lane) : -1,
                          G, N, M, warp, lane, rows);
  }
  cp_async_commit();
  int p_next = -1;
  if (GATHER && nunit < units)
    p_next = row_id(idx, tile_at(nunit, ntile, G, S, groups), warp, lane);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  while (unit < units) {
    cp_async_wait_all();
    wg_bar(bar);  // this tile's centers are in, the last tile done
    const Tile T = tile_at(unit, tile, G, S, groups);
    const bool last = tile == tiles - 1;
    if (BN)
      store_a0_bn<C1>(cur, rows, quads0, T, warp, lane);
    else
      store_a0<C1, GATHER>(cur, rows, ctrs + stage * kMaxGroups * C1, T, G,
                           warp, lane);
    // the next tile: its centers by cp.async, its rows into registers
    // (from the ids loaded a tile ago), in flight while this one computes;
    // then the ids of the tile after it
    if (nunit < units) {
      const Tile NT = tile_at(nunit, ntile, G, S, groups);
      if (GATHER)
        centers_async<C1>(center, NT, ctrs + (stage ^ 1) * kMaxGroups * C1,
                          t);
      load_rows<C1, GATHER>(src, NT, p_next, G, N, M, warp, lane, rows);
    }
    cp_async_commit();
    n2unit = nunit;
    n2tile = ntile;
    advance(n2unit, n2tile, tiles, stride);
    if (GATHER)
      p_next = n2unit < units
                   ? row_id(idx, tile_at(n2unit, n2tile, G, S, groups), warp,
                            lane)
                   : -1;
    proxy_fence();
    wg_bar(bar);
    // layer 1 -> a1 in bf16, in registers as layer 2's A operand: the
    // accumulators of columns 16k .. 16k + 15 (j = 2k, 2k + 1) at rows g and
    // g + 8 are its k-th fragment, no exchange between threads
    product<C1>(acc, a0s, w1s, C2, 0);
    uint32_t a1f[C2 / 16][4];
#pragma unroll
    for (int j = 0; j < C2 / 8; ++j) {
      // the thread's columns 8j + 2·q4, + 1: their bias, or their quad
      const int c = 8 * j + 2 * q4;
      __nv_bfloat162 bias = one;
      float4 q1 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (BN)
        q1 = quads1[c >> 1];
      else
        bias = *reinterpret_cast<const __nv_bfloat162*>(b1s + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 x = __floats2bfloat162_rn(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        // a1 = ReLU(bf16(bf16(v) + b1)), two columns at once: fma.rn of
        // bf16(v)·1 + b1 rounds the exact sum once, as add.rn does; under
        // BN bf16(ReLU(bf16(v)·mul1 + add1))
        const __nv_bfloat162 v =
            BN ? affine2(x, q1) : __hfma2_relu(x, one, bias);
        a1f[j >> 1][2 * (j & 1) + h] = bits2(v);
      }
    }
    // layer 2 and the pool. The output a2 = f(bf16(v)) is monotone in v
    // (ReLU(bf16(bf16(v) + b2)); under BN bf16(ReLU(bf16(v)·mul2 + add2)),
    // non-decreasing where mul2 >= 0 and non-increasing where mul2 < 0), so
    // the max of a2 over a group's slots is f of the max of bf16(v), or of
    // its min where mul2 < 0: the rows are reduced first, as the max of
    // bf16(v) with its sign flipped where mul2 is negative (exact; rows
    // past the valid slots -inf), and f applied once to each output pair
    const int r0 = 16 * warp + g;
    const bool in0 = r0 < T.valid, in1 = r0 + 8 < T.valid;
    for (int n0 = 0; n0 < C3; n0 += kN) {
      product_rs<C2>(acc, a1f, w2s, C3, n0);
      __nv_bfloat162 m[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // bf16(v) of both rows, two columns at once
        __nv_bfloat162 x0 = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        __nv_bfloat162 x1 =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        if (BN) {
          const uint32_t flip = sign2[(n0 >> 1) + 4 * j + q4];
          x0 = from_bits2(bits2(x0) ^ flip);
          x1 = from_bits2(bits2(x1) ^ flip);
        }
        m[j] = __hmax2(in0 ? x0 : lowest, in1 ? x1 : lowest);
      }
      warp_column_max(m, lane);
      // m[0], m[1]: the column pairs n0 / 2 + 8g + q4 and + 4
      const int p0 = (n0 >> 1) + 8 * g + q4;
      if (G == kMaxGroups) {
        // S = 16: the warp's rows are one group, its maxima the output
        if (warp < T.groups) {
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              out + (size_t)(T.grp0 + warp) * C3);
          o[p0] = finish(m[0], p0);
          o[p0 + 4] = finish(m[1], p0 + 4);
        }
      } else {
        part[warp * pairs + p0] = m[0];
        part[warp * pairs + p0 + 4] = m[1];
      }
    }
    if (G != kMaxGroups) {
      wg_bar(bar);
      // each group's W warps' maxima, a column pair a thread; a group of
      // several tiles folds each into the running max, which the same
      // thread keeps (one group a tile there), and writes a2 at its last
      for (int e = t; e < T.groups * pairs; e += 128) {
        const int k = e / pairs, p = e - k * pairs;
        __nv_bfloat162 mx = part[k * W * pairs + p];
        for (int i = 1; i < W; ++i)
          mx = __hmax2(mx, part[(k * W + i) * pairs + p]);
        if (tiles > 1) {
          if (tile > 0) mx = __hmax2(mx, pool[p]);
          if (!last) {
            pool[p] = mx;
            continue;
          }
        }
        reinterpret_cast<__nv_bfloat162*>(out + (size_t)(T.grp0 + k) *
                                                    C3)[p] = finish(mx, p);
      }
    }
    unit = nunit;
    tile = ntile;
    nunit = n2unit;
    ntile = n2tile;
    stage ^= 1;
  }
}

template <int C1, int C2, int WG, bool GATHER, bool BN>
int launch_widths(const bf16* src, const int* idx, const bf16* center,
                  const float* packs, const bf16* w1t, const bf16* b1,
                  const bf16* w2t, const bf16* b2, int R, int N, int M, int S,
                  int C3, bf16* out, cudaStream_t stream) {
  auto kern = eval_kernel<C1, C2, WG, GATHER, BN>;
  const size_t smem = smem_bytes(C1, C2, C3, WG, BN);
  // above 48 KB a kernel must ask for its shared memory; the largest size
  // asked for so far stands
  static size_t granted = 0;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = groups_per_tile(S);
  const long long units = ((long long)R * M + G - 1) / G;
  const long long want = (units + WG - 1) / WG;
  const unsigned blocks = (unsigned)(want < sms ? want : sms);
  kern<<<blocks, 128 * WG, smem, stream>>>(src, idx, center, packs, w1t, b1,
                                           w2t, b2, R, N, M, S, C3, out);
  return (int)cudaGetLastError();
}

// the caller checked takes(C1, C2, C3, BN), R, M, S (and N) >= 1 and R·M <
// 2^31; GATHER the gather form (src = pre), else the slab form (src = x0),
// with BatchNorm where BN (packs, no biases)
template <bool GATHER, bool BN>
int launch_eval(const bf16* src, const int* idx, const bf16* center,
                const float* packs, const bf16* w1t, const bf16* b1,
                const bf16* w2t, const bf16* b2, int R, int N, int M, int S,
                int C1, int C2, int C3, bf16* out, cudaStream_t stream) {
  if (C1 != 128 || C2 != 128) return (int)cudaErrorInvalidValue;
  if (warpgroups(C1, C2, C3, BN) == 3)
    return launch_widths<128, 128, 3, GATHER, BN>(src, idx, center, packs,
                                                  w1t, b1, w2t, b2, R, N, M,
                                                  S, C3, out, stream);
  return launch_widths<128, 128, 2, GATHER, BN>(src, idx, center, packs, w1t,
                                                b1, w2t, b2, R, N, M, S, C3,
                                                out, stream);
}

}  // namespace fused_sa_wgmma_eval
