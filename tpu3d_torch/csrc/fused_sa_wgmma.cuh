// Kernel 6's bf16 training forward (the gather form), redesigned for
// Hopper (sm_90a): warpgroup products (wgmma) from shared memory, the
// weights resident in shared memory for the whole launch.
//
// Replaces, in its bf16 arithmetic, tpu3d/ops/fused_sa.py's
// _nobn2_fwd_kernel (:752, called at :882): for each (row, center) group of
// S slots
//   x0 = bf16(pre[row, idx[row, center, s]] - center[row, center]);
//   a0 = ReLU(x0); x1 = bf16(bf16(a0·W1) + bf16(b1)); a1 = ReLU(x1);
//   x2 = bf16(bf16(a1·W2) + bf16(b2));
//   out = max over the slots of ReLU(x2) in bf16, argmax = the first slot
//   reaching it, ppre = x2 there,
// every product of bf16 operands summed in f32, as the parent design
// (fused_sa_bf16.cuh, which keeps the shapes this one does not take) and
// the plain version (ops/fused_sa.py::fused_gathered_mlp_pool_bf16_train_plain)
// round. The products' f32 sums run in the tensor cores' order, so the
// kernel is held to the plain version within a tolerance; each group's
// arithmetic is fixed, so two calls give the same bits.
//
// Bound on the card: operations (2·S·(C1·C2 + C2·C3) per group in bf16
// against 2·S·C1 bytes of gathered rows). The parent design ran
// mma.sync.m16n8k16 with the weights' fragments read from device memory
// through L1 on every k-step, one group at a time per block with nothing
// overlapping. This one:
//   - persistent blocks, one per SM, of three consumer warpgroups where
//     their stages fit beside the weights (C3 up to 256), else two; each
//     warpgroup walks its own groups (grp = WG·block + wg, stepping by
//     WG·blocks) in 64-row tiles (S = 16 / 24 / 32 pads one tile with rows
//     that take no part in the max; S = 128 takes two);
//   - W1ᵀ, W2ᵀ (the Dense kernels in their (out, in) layout) and the biases
//     loaded once per block into shared memory, K-major in the 128-byte
//     swizzle that wgmma reads (8-row atoms of 1024 bytes, each row's
//     16-byte chunks XORed with the row's place in its atom);
//   - the gathered rows of a warpgroup's next tile loaded into registers
//     (16 bytes a load, two threads a row) and its group's center row
//     copied by cp.async while the current tile computes, from ids loaded
//     a tile earlier (TMA cannot gather arbitrary rows);
//   - a0 (bf16(x - center), ReLU) formed from those registers into the
//     warpgroup's 64-row stage in the same swizzle, then layer 1 as
//     wgmma.m64n128k16 over 128-column chunks of C2 with f32 accumulators in
//     registers; the epilogue adds the bias, rounds as the parent does and
//     writes a1 in bf16 to shared memory in the swizzle; layer 2 the same
//     over 128-column chunks of C3, whose epilogue writes x2 (bias added,
//     rounded) as a bf16 tile over the stage layer 1 has read; each
//     column's first maximum down the tile's rows is the largest of
//     integer keys (ReLU(x2)'s bits above the complement of the row: ties
//     keep the lowest slot), a column a thread in four chains of 16 rows,
//     a later tile of the same group taking over only above the running
//     max.
// Shared memory: 2·(C1·C2 + C2·C3) bytes of weights, a 64-row stage of C1
// (two center rows) and a 64-row a1 per warpgroup, the pooling state: of
// the 227 KB a block may take on sm_90, 170 KB at the RCNN's SA_0 (128 ->
// 128 -> 128) and 206 KB at its SA_1 (128 -> 128 -> 256), three
// warpgroups at both. It takes C1 = C2 = 128 and C3 up to 384 (every level
// of the shipped configs that the gather form fuses: C3 128 and 256);
// wider levels (the widened RCNN's 256 -> 384 -> 256) do not fit and keep
// the parent design: the route is the shape (takes(), mirrored by
// ops/fused_sa.py::train_bf16_design).
//
// Included by fused_sa_bf16.cuh, whose C entry tpu3d_fused_sa_train_bf16
// routes between the two designs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused_sa_wgmma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;           // rows of a tile: wgmma's M
constexpr int kN = 128;             // columns of one wgmma
constexpr size_t kSmemMax = 232448;

// byte offsets in the block's shared memory, each region 1024-aligned
struct Layout {
  unsigned w1, w2, stage, a1, ctr, b1, b2, pool, total;
};

__host__ __device__ inline unsigned carve(unsigned& at, unsigned bytes) {
  const unsigned o = at;
  at += (bytes + 1023u) & ~1023u;
  return o;
}

// for `wgs` warpgroups a block
__host__ __device__ inline Layout layout(int C1, int C2, int C3, int wgs) {
  Layout L;
  unsigned at = 0;
  L.w1 = carve(at, 2u * C1 * C2);
  L.w2 = carve(at, 2u * C2 * C3);
  L.stage = carve(at, 2u * wgs * kTile * C1);
  L.a1 = carve(at, 2u * wgs * kTile * C2);
  L.ctr = carve(at, 2u * wgs * 2 * C1);  // a center row per stage
  L.b1 = carve(at, 2u * C2);
  L.b2 = carve(at, 2u * C3);
  L.pool = carve(at, 12u * wgs * C3);
  L.total = at;
  return L;
}

// the dynamic shared memory asked for: the layout and room to align it
inline size_t smem_bytes(int C1, int C2, int C3, int wgs) {
  return (size_t)layout(C1, C2, C3, wgs).total + 1024;
}

// Warpgroups a block: three where their stages fit beside the weights
// (C3 up to 256), else two, 0 where neither fits.
inline int warpgroups(int C1, int C2, int C3) {
  return smem_bytes(C1, C2, C3, 3) <= kSmemMax   ? 3
         : smem_bytes(C1, C2, C3, 2) <= kSmemMax ? 2
                                                 : 0;
}

// Whether this design takes widths C1 -> C2 -> C3 (any S, R, M): C1 = C2
// = 128 (the products' depth, built unrolled; 256 would double the weights
// and stages), C3 a multiple of 128 (a wgmma's columns), and the layout in
// shared memory (C3 up to 384).
inline bool takes(int C1, int C2, int C3) {
  return C1 == 128 && C2 == 128 && C3 >= 128 && C3 % 128 == 0 &&
         warpgroups(C1, C2, C3) > 0;
}

// Two values at once in bf16: the difference or sum of two bf16 values
// rounded once to bf16 (add.rn.bf16x2) is bf16 of their f32 difference or
// sum, which the plain version rounds: where the f32 result is inexact (the
// exponents 17 or more apart) the smaller value lies below half a bf16 step
// of the larger and both give the larger. ReLU as max with +0.
__device__ __forceinline__ __nv_bfloat162 relu2(__nv_bfloat162 x) {
  return __hmax2(x, __float2bfloat162_rn(0.f));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk lc (8 bf16) of row `row` in a K-major
// operand of `rows` rows: its 64-column block, the row's 128 bytes there,
// the chunk XORed with the row's place in its 8-row atom (the 128-byte
// swizzle).
__device__ __forceinline__ unsigned kmajor(int rows, int row, int lc) {
  return (unsigned)(lc >> 3) * rows * 128u + row * 128u +
         ((unsigned)((lc & 7) ^ (row & 7)) << 4);
}

// The shared-memory descriptor of a K-major operand in the 128-byte swizzle
// at `addr`: 8-row atoms 1024 bytes apart (SBO), the leading offset unused.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A·Bᵀ for a 64 x 16 A tile and a 128 x 16 B tile in shared memory
// (descriptors da, db), f32 sums in the thread's 64 accumulators; scale_d 0
// starts the sums from zero.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
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
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the warpgroup's products: issued after every earlier register and
// shared-memory access of the thread, waited for in full
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory writes of the thread made visible to the products' reads
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of one warpgroup's 128 threads
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc = A·B[n0 .. n0 + 127]ᵀ: A the 64-row K-major tile at `a`, B the
// K-major operand of `brows` rows at `b`; K a multiple of 64, the
// products unrolled (a loop around them makes the compiler serialize them)
template <int K>
__device__ __forceinline__ void product(float (&acc)[64], uint32_t a,
                                        uint32_t b, int brows, int n0) {
  fence_operands(acc);
  wg_fence();
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    const uint32_t ka = a + (k >> 2) * (kTile * 128) + (k & 3) * 32;
    const uint32_t kb = b + (k >> 2) * (brows * 128) + n0 * 128 + (k & 3) * 32;
    wgmma_m64n128k16(acc, desc(ka), desc(kb), k > 0);
  }
  wg_commit_wait();
  fence_operands(acc);
}

// a (rows, K) row-major bf16 matrix into the K-major swizzled operand at
// dst, by the whole block
__device__ __forceinline__ void stage_operand(const bf16* __restrict__ w,
                                              int rows, int K,
                                              unsigned char* dst) {
  const int cpr = K / 8;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int n = e / cpr, lc = e - n * cpr;
    *reinterpret_cast<uint4*>(dst + kmajor(rows, n, lc)) =
        __ldg(reinterpret_cast<const uint4*>(w + (size_t)n * K + lc * 8));
  }
}

// The id of thread t's row in tile `tile` of group grp (two threads a
// row: row t / 2), or -1 past the tile's valid slots. Loaded a tile ahead
// of its gather, so that the load's latency hides behind a tile's work.
__device__ __forceinline__ int tile_id(const int* __restrict__ idx,
                                       int grp, int tile, int S, int t) {
  const int row = t >> 1, s = tile * kTile + row;
  return row < kTile && s < S ? __ldg(idx + (size_t)grp * S + s) : -1;
}

// Thread t's half of its row of a tile (the row of id p of group grp's
// scene; zeros for p -1) into registers, 16 bytes a load, in flight while
// the tile before it computes
template <int C1>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ pre,
                                          int grp, int p, int N, int M,
                                          int t, uint4 (&v)[C1 / 16]) {
  constexpr int kHalf = C1 / 16;
  const uint4* src = reinterpret_cast<const uint4*>(
      pre + ((size_t)(grp / M) * N + (p < 0 ? 0 : p)) * C1) +
      (t & 1) * kHalf;
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
    v[i] = p < 0 ? make_uint4(0u, 0u, 0u, 0u) : __ldg(src + i);
}

// cp.async of group grp's center row into ctr (16-byte chunks, the first
// C1 / 8 threads)
template <int C1>
__device__ __forceinline__ void center_async(const bf16* __restrict__ center,
                                             int grp, bf16* ctr, int t) {
  if (t < C1 / 8)
    cp_async16(ctr + t * 8, center + (size_t)grp * C1 + t * 8);
}

// a0 = ReLU(bf16(x - center)) of thread t's half row into the stage in the
// swizzle, zeros in the rows past the tile's valid slots
template <int C1>
__device__ __forceinline__ void store_a0(unsigned char* stage,
                                         const uint4 (&v)[C1 / 16],
                                         const bf16* ctr, int valid, int t) {
  constexpr int kHalf = C1 / 16;
  const int row = t >> 1, lc0 = (t & 1) * kHalf;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) {
      const uint4 craw =
          *reinterpret_cast<const uint4*>(ctr + (lc0 + i) * 8);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
      const __nv_bfloat162* cv =
          reinterpret_cast<const __nv_bfloat162*>(&craw);
      __nv_bfloat162* res = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) res[j] = relu2(__hsub2(xv[j], cv[j]));
    }
    *reinterpret_cast<uint4*>(stage + kmajor(kTile, row, lc0 + i)) = packed;
  }
}

// The x2 tile of a 128-column chunk in shared memory: row r's bf16 pair p
// (columns 2p, 2p + 1) at word r·64 + (p ^ 4·(r & 7)), so that a warp's
// fragment stores and a column's walk down the rows meet no bank twice.
__device__ __forceinline__ unsigned x2_word(int row, int pair) {
  return (unsigned)row * 64u + (unsigned)(pair ^ ((row & 7) << 2));
}

// C1 and C2 (the products' depths) are template arguments, so that each
// product's wgmmas run unrolled; WG warpgroups a block
template <int C1, int C2, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
train_kernel(const bf16* __restrict__ pre, const int* __restrict__ idx,
             const bf16* __restrict__ center, const bf16* __restrict__ w1t,
             const bf16* __restrict__ b1, const bf16* __restrict__ w2t,
             const bf16* __restrict__ b2, int R, int N, int M, int S,
             int C3, bf16* __restrict__ out, int* __restrict__ argmax,
             float* __restrict__ ppre) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const Layout L = layout(C1, C2, C3, WG);
  bf16* b1s = reinterpret_cast<bf16*>(smem + L.b1);
  bf16* b2s = reinterpret_cast<bf16*>(smem + L.b2);
  // the weights and biases, once per block
  stage_operand(w1t, C2, C1, smem + L.w1);
  stage_operand(w2t, C3, C2, smem + L.w2);
  for (int c = threadIdx.x; c < C2; c += 128 * WG) b1s[c] = b1[c];
  for (int c = threadIdx.x; c < C3; c += 128 * WG) b2s[c] = b2[c];
  proxy_fence();
  __syncthreads();

  // the warpgroup's index through a shuffle: uniform to the compiler, so
  // that it keeps the products asynchronous in the loops it bounds
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int bar = 1 + wg;
  unsigned char* cur = smem + L.stage + wg * 2u * kTile * C1;
  unsigned char* a1 = smem + L.a1 + wg * 2u * kTile * C2;
  const uint32_t w1s = smem_u32(smem + L.w1), w2s = smem_u32(smem + L.w2);
  const uint32_t a1s = smem_u32(a1);
  float* pool_mx = reinterpret_cast<float*>(smem + L.pool) + wg * 3 * C3;
  int* pool_ar = reinterpret_cast<int*>(pool_mx + C3);
  float* pool_pp = pool_mx + 2 * C3;
  bf16* ctrs = reinterpret_cast<bf16*>(smem + L.ctr) + wg * 2 * C1;

  const int tiles = (S + kTile - 1) / kTile;
  // R·M < 2^31 (the wrapper checks it): group indices in 32 bits
  const int groups = R * M;
  const int stride = gridDim.x * WG;
  // the walk over this warpgroup's tiles: (grp, tile) and the next two
  int grp = blockIdx.x * WG + wg;
  int tile = 0, stage = 0;
  auto step = [&](int& gr, int& ti) {
    if (++ti == tiles) {
      ti = 0;
      gr += stride;
    }
  };
  int ngrp = grp, n2grp;
  int ntile = 0, n2tile;
  step(ngrp, ntile);
  uint4 rows[C1 / 16];  // this thread's half row of the next tile
  if (grp < groups) {
    center_async<C1>(center, grp, ctrs, t);
    load_rows<C1>(pre, grp, tile_id(idx, grp, 0, S, t), N, M, t, rows);
  }
  cp_async_commit();
  int p_next = ngrp < groups ? tile_id(idx, ngrp, ntile, S, t) : -1;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  while (grp < groups) {
    cp_async_wait_all();
    wg_bar(bar);  // this tile's center row is in, the last tile done
    const int s0 = tile * kTile, valid = min(kTile, S - s0);
    const bool last = tile == tiles - 1;
    store_a0<C1>(cur, rows, ctrs + stage * C1, valid, t);
    // the next tile: its center by cp.async, its rows into registers (from
    // the ids loaded a tile ago), in flight while this one computes; then
    // the ids of the tile after it
    if (ngrp < groups) {
      center_async<C1>(center, ngrp, ctrs + (stage ^ 1) * C1, t);
      load_rows<C1>(pre, ngrp, p_next, N, M, t, rows);
    }
    cp_async_commit();
    n2grp = ngrp;
    n2tile = ntile;
    step(n2grp, n2tile);
    p_next = n2grp < groups ? tile_id(idx, n2grp, n2tile, S, t) : -1;
    proxy_fence();
    wg_bar(bar);
    const uint32_t a0s = smem_u32(cur);
    // layer 1 -> a1 in bf16, swizzled for layer 2
    for (int n0 = 0; n0 < C2; n0 += kN) {
      product<C1>(acc, a0s, w1s, C2, n0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * q4;
        const __nv_bfloat162 bias =
            *reinterpret_cast<const __nv_bfloat162*>(b1s + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
          // a1 = ReLU(bf16(bf16(v) + b1)), two columns at once
          *reinterpret_cast<__nv_bfloat162*>(
              a1 + kmajor(kTile, row, col >> 3) + 2 * (col & 7)) =
              relu2(__hadd2(__floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                  acc[4 * j + 2 * h + 1]),
                            bias));
        }
      }
    }
    proxy_fence();
    wg_bar(bar);
    // layer 2 and the pool over the tile's valid rows: each chunk's x2
    // (bf16 values) to a 64 x 128 tile over this stage, whose a0 layer 1
    // has read, then thread t walks column t down the rows in slot order
    __nv_bfloat162* x2s = reinterpret_cast<__nv_bfloat162*>(cur);
    for (int n0 = 0; n0 < C3; n0 += kN) {
      product<C2>(acc, a1s, w2s, C3, n0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(
            b2s + n0 + 8 * j + 2 * q4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
          // x2 = bf16(bf16(v) + b2), two columns at once
          x2s[x2_word(row, 4 * j + q4)] =
              __hadd2(__floats2bfloat162_rn(acc[4 * j + 2 * h],
                                            acc[4 * j + 2 * h + 1]),
                      bias);
        }
      }
      wg_bar(bar);
      {
        // the first maximum of ReLU(x2) down column n0 + t: the largest
        // key (bits of ReLU(x2) << 16 | 0xffff - row), the bits of a bf16
        // >= 0 ordered as its value, so that equal maxima keep the lowest
        // row; four chains of 16 rows, whose maximum is the column's
        const unsigned short* col =
            reinterpret_cast<const unsigned short*>(x2s) + (t & 1);
        unsigned key[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int r = 0; r < 16; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int row = 16 * k + r;
            const unsigned bits = col[2 * x2_word(row, t >> 1)];
            const unsigned a = bits & 0x8000u ? 0u : bits;  // ReLU
            if (row < valid) key[k] = max(key[k], a << 16 | (0xffffu - row));
          }
        const unsigned best = max(max(key[0], key[1]), max(key[2], key[3]));
        const int row = 0xffff - (int)(best & 0xffffu);
        const float mx =
            __bfloat162float(__ushort_as_bfloat16((unsigned short)(best >> 16)));
        // x2 there: ReLU(x2) itself where positive
        const float pp = mx > 0.f ? mx : __bfloat162float(__ushort_as_bfloat16(
                                             col[2 * x2_word(row, t >> 1)]));
        int ar = s0 + row;
        const int c = n0 + t;
        // an earlier tile of the group holds the lower slots: it keeps ties
        const bool earlier = tile > 0 && pool_mx[c] >= mx;
        const float m = earlier ? pool_mx[c] : mx;
        const float p = earlier ? pool_pp[c] : pp;
        if (earlier) ar = pool_ar[c];
        if (last) {
          const size_t o = (size_t)grp * C3 + c;
          out[o] = __float2bfloat16_rn(m);
          argmax[o] = ar;
          ppre[o] = p;
        } else {
          pool_mx[c] = m;
          pool_ar[c] = ar;
          pool_pp[c] = p;
        }
      }
      wg_bar(bar);  // the tile is read before the next chunk writes it
    }
    grp = ngrp;
    tile = ntile;
    ngrp = n2grp;
    ntile = n2tile;
    stage ^= 1;
  }
}

template <int C1, int C2, int WG>
int launch_widths(const bf16* pre, const int* idx, const bf16* center,
                  const bf16* w1t, const bf16* b1, const bf16* w2t,
                  const bf16* b2, int R, int N, int M, int S, int C3,
                  bf16* out, int* argmax, float* ppre, cudaStream_t stream) {
  auto kern = train_kernel<C1, C2, WG>;
  const size_t smem = smem_bytes(C1, C2, C3, WG);
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
  const long long groups = (long long)R * M;
  const long long want = (groups + WG - 1) / WG;
  const unsigned blocks = (unsigned)(want < sms ? want : sms);
  kern<<<blocks, 128 * WG, smem, stream>>>(pre, idx, center, w1t, b1, w2t,
                                           b2, R, N, M, S, C3, out, argmax,
                                           ppre);
  return (int)cudaGetLastError();
}

// the caller checked takes(C1, C2, C3)
inline int launch_train(const bf16* pre, const int* idx, const bf16* center,
                        const bf16* w1t, const bf16* b1, const bf16* w2t,
                        const bf16* b2, int R, int N, int M, int S, int C1,
                        int C2, int C3, bf16* out, int* argmax, float* ppre,
                        cudaStream_t stream) {
  if (C1 != 128 || C2 != 128) return (int)cudaErrorInvalidValue;
  if (warpgroups(C1, C2, C3) == 3)
    return launch_widths<128, 128, 3>(pre, idx, center, w1t, b1, w2t, b2, R,
                                      N, M, S, C3, out, argmax, ppre, stream);
  return launch_widths<128, 128, 2>(pre, idx, center, w1t, b1, w2t, b2, R, N,
                                    M, S, C3, out, argmax, ppre, stream);
}

}  // namespace fused_sa_wgmma
