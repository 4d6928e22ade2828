// The bf16 routed backward of the fused two-layer MLP + max-pool (kernels 6
// and 8 in their bf16 training arithmetic), redesigned for Hopper (sm_90a):
// products on the tensor cores, the weights resident in shared memory, the
// gradient read as the caller hands it, bf16 outputs written by the kernels.
//
// Replaces, in its bf16 arithmetic, tpu3d/ops/fused_sa.py's
// _nobn2_bwd_kernel (:782, the gather form's VJP :926-945, pallas_call
// :882) and _nobn_bwd_kernel (:604, the slab form's VJP :666-691,
// pallas_call :356). It computes what the parent walk (fused_sa_bwd.cuh on
// bf16 rows) computes, to the same rounding points: x0 = bf16(pre - center)
// (the slab's rows as they are), x1 = bf16(bf16(a0 W1) + bf16(b1))
// recomputed, dval = bf16(grad where ppre > 0) routed to each channel's
// argmax slot (D), d_a1 = D W2^T, d_x1 = d_a1 [x1 > 0] rounded to bf16
// before dW1 and d_a0 (db1 sums it unrounded), d_x0 = d_a0 [x0 > 0]
// rounded to bf16 once (d_center sums it unrounded), db2 the f32 sum of
// the unrounded dval. Every product is of bf16 values, exact in f32, so
// the tensor cores' f32 sums differ from the plain version's only in their
// order; each call's arithmetic is fixed, so two calls give the same bits.
//
// Bound on the card: at the seeded step's reach (1.7-2.0% of the slots)
// the bytes of the gradient, ppre, argmax and d_pre; at full spread the
// operations (five products of layer 1's size per reached slot, at the
// bf16 peak). The parent walk ran the products on f32 SIMT register tiles,
// widened the rows to f32 in shared memory and staged W1, W1^T or W2^T
// from device memory 32 rows at a time, two barriers a slice, for every
// product of every tile; its caller ran a dozen casts, transposes and
// roundings around it. This design:
//   - persistent blocks, one per SM, walk the plan's tiles of 64 reached
//     rows (the parent's plan: reached slots only, packed by whole parts;
//     the parent's block split and fixed-order sums);
//   - bf16 W1^T and W2^T (the Dense kernels' (out, in) layout, which the
//     model hands as transposed views) and bf16(b1) are loaded into shared
//     memory once per block, rounded as they are staged;
//   - each tile's rows arrive by cp.async in bf16 a tile ahead, into
//     padded rows (272 bytes, so ldmatrix meets no bank twice), and a0 is
//     formed in place;
//   - the five products of a tile run on mma.sync.m16n8k16 (bf16 in, f32
//     sums) fed by ldmatrix: x1 = a0 W1 and d_a0 = bf16(d_x1) W1^T from the
//     one resident W1^T (ldmatrix without and with .trans), d_a1 = D W2^T,
//     and the weight gradients dW1 += a0^T bf16(d_x1) and dW2^T += D^T a1
//     from the same tiles through .trans. mma.sync over wgmma: every
//     operand is read in both orientations (W1 and W1^T, a0 and a0^T, D
//     and D^T), which ldmatrix.trans gives from one copy, while wgmma would
//     need a second copy or its transposed swizzle layouts for each, and
//     dW1's f32 sums stay in the registers of all eight warps across the
//     block's tiles;
//   - the routing matrix D (64 x C3 bf16) is zeroed and then scattered with
//     each part's live channels, a tile at a time, from the routes the plan
//     packed (bf16(dval) and the slot in one word); the products over D cost
//     64/parts times the routed work in a tile of one part (full spread),
//     which the tensor cores' rate covers, so no tile takes a scalar route;
//   - dW1 sums in registers, db1 per thread over its rows, dW2^T in shared
//     memory at C3 = 128 and in the block's workspace slice at C3 = 256
//     (the resident weights, two row stages, a1 and D leave no room for
//     128 KB of f32), both in the fragments' own order; the slices are
//     added in block order by reduce_slices, which reads that order;
//   - d_x0 is rounded to bf16 in shared memory and written as whole rows:
//     the slab's gradient rows (the unreached ones zeroed by the plan), or
//     the gather form's reached rows, which csr_inverse.cuh adds into d_pre
//     in ascending (group·S + slot) order, bf16 out; d_center is -Σ d_x0
//     over a part's rows, in row order, written in bf16 (into an f32 row
//     that a last pass rounds where a group spans several tiles, S > 64);
//   - the gradient is read where and as it lies (bf16 or f32, any strides)
//     by the plan and db2_partials, and ppre there decides dval: no pass
//     runs before the launch.
// Shared memory: W1^T and W2^T (34 816 + C3·272 bytes), two row stages
// (34 816), D (C3 + 8 bf16 a row), a1 / bf16(d_x1) (17 408), the f32 d_x0
// tile over D and a1, dW2^T at C3 = 128 (65 536), the plans, a batch of
// 64 parts (masks, slot ids and their placement into tiles: the walk
// waits on memory once a batch, and one thread places the batch's parts
// while the block fills the plans in parallel), a tile's d_center runs
// and the db1 reduction: 229 296 bytes at C3 = 128 and 214 960 at 256 of
// the 232 448 a block may use. It takes C1 = C2 = 128 (the products built unrolled for
// them) and C3 128 or 256 (every fused level of the shipped configs);
// wider levels (the widened RCNN's 256 -> 384 -> 256) keep the parent walk:
// the route is the shape (takes(), mirrored by
// ops/fused_sa.py::backward_bf16_design).
//
// Included by fused_sa_bwd_bf16.cu, whose C entries route between the two
// designs.

#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_sa_bwd.cuh"

namespace fused_sa_mma {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;          // rows of a tile (the plan's segment)
constexpr int kC = 128;         // C1 = C2
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kC + 8;     // bf16 row stride of the 128-wide tiles
constexpr int kLdx = kC + 4;    // f32 row stride of the d_x0 tile
constexpr int kScatter = 16;    // routing entries a thread loads at once
constexpr int kBatch = 64;      // parts whose masks and ids load at once
constexpr int kDb2Parts = 256;  // group ranges of db2's partial sums
constexpr size_t kSmemMax = 232448;

__host__ __device__ inline unsigned carve(unsigned& at, unsigned bytes) {
  const unsigned o = at;
  at += (bytes + 15u) & ~15u;
  return o;
}

// A batch of kBatch consecutive parts of the plan, loaded together, and
// their placement into tiles, whole parts in order: a part joins the open
// tile while its rows fit, else it closes the tile and opens the next.
struct Batch {
  unsigned long long mask[kBatch];
  int group[kBatch], slot0[kBatch];
  int row0[kBatch];  // the part's first row among the launch's reached rows
  int tile[kBatch];  // the batch's tile k the part joins, -1 for none
  unsigned char base[kBatch], part[kBatch];  // its first row and place there
  // tile k: its first part in the batch (k > 0), and its rows and parts
  // when the batch closes it (k < closed) or ends (k = closed)
  int first[kBatch + 1], rows[kBatch + 1], parts[kBatch + 1];
  int closed;  // tiles the batch closes; tile 0 was open before it
  int ids[kBatch * kT];  // the parts' slots' ids (gather form)
};

// byte offsets of a block's shared memory
struct Layout {
  unsigned w1, w2, b1, x, dm, a1, dw2, plans, batch, runs, red, total;
};

__host__ __device__ inline Layout layout(int C3, bool dw2_shared) {
  Layout L;
  unsigned at = 0;
  L.w1 = carve(at, 2u * kC * kLd);             // W1^T: [c2][c1]
  L.w2 = carve(at, 2u * C3 * kLd);             // W2^T: [c3][c2]
  L.b1 = carve(at, 4u * kC);                   // bf16(b1) in f32
  L.x = carve(at, 2u * 2 * kT * kLd);          // two row stages
  L.dm = carve(at, 2u * kT * (C3 + 8));        // D, then the f32 d_x0 tile
  L.a1 = carve(at, 2u * kT * kLd);             // a1, then bf16(d_x1)
  L.dw2 = carve(at, dw2_shared ? 4u * C3 * kC : 0u);
  L.plans = carve(at, 2u * sizeof(Plan));
  L.batch = carve(at, sizeof(Batch));          // a batch of parts
  L.runs = carve(at, 4u * kT);                 // a tile's d_center runs
  L.red = carve(at, 4u * 4 * kC);
  L.total = at;
  return L;
}

// dW2^T sums in shared memory where the layout fits with it
__host__ __device__ inline bool dw2_shared(int C3) {
  return layout(C3, true).total + 16 <= kSmemMax;
}

// Whether this design takes widths C1 -> C2 -> C3: C1 = C2 = 128, C3 a
// multiple of 128 whose layout fits (128 and 256), the f32 d_x0 tile
// within D and a1.
__host__ __device__ inline bool takes(int C1, int C2, int C3) {
  if (C1 != kC || C2 != kC || C3 < 128 || C3 % 128 != 0) return false;
  const Layout L = layout(C3, false);
  return L.total + 16 <= kSmemMax && L.dw2 - L.dm >= 4u * kT * kLdx;
}

// The pooled gradient where and as the caller hands it (bf16 or f32, any
// strides, in elements) and ppre: dval = grad where ppre > 0, unrounded.
struct Grad {
  const void* p;
  long long sR, sM, sC;
  int is_bf16;
  int M;
  const float* ppre;
  __device__ __forceinline__ float at(int grp, int c, int C3) const {
    const int r = grp / M, m = grp - r * M;
    const long long o = r * sR + m * sM + c * sC;
    const float v =
        is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[o])
                : static_cast<const float*>(p)[o];
    return ppre[(size_t)grp * C3 + c] > 0.0f ? v : 0.0f;
  }
};

// A 2-D f32 matrix as it lies: element (i, j) at p[i·s0 + j·s1].
struct Mat {
  const float* p;
  long long s0, s1;
};

__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory, each lane the address of a
// row (lanes 8i .. 8i + 7 matrix i); .trans hands each lane a column pair
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += A·B for one 16 x 8 tile, A 16 x 16 and B 16 x 8 in bf16, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's row and column offsets in an ldmatrix.x4 of a 16 x 16 block.
// R: A in rows (m) x k, or B stored as k x n (with .trans): the matrices
// (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) give A's
// a0..a3, or the b0, b1 of n-tiles 0 and 1. S: B stored as n x k, or A
// stored as k x m (with .trans): (0-7, 0-7), (0-7, 8-15), (8-15, 0-7),
// (8-15, 8-15).
__device__ __forceinline__ int row_r(int l) { return (l & 7) + ((l >> 3) & 1) * 8; }
__device__ __forceinline__ int col_r(int l) { return (l >> 4) * 8; }
__device__ __forceinline__ int row_s(int l) { return (l & 7) + (l >> 4) * 8; }
__device__ __forceinline__ int col_s(int l) { return ((l >> 3) & 1) * 8; }

// The float of a 128-column f32 matrix's (row, col) in the fragments' own
// order: 16-row tiles, in them 64-column halves, 8-column n-tiles, each
// lane's four accumulators together (float4 per lane).
__host__ __device__ inline long long frag_at(int row, int col) {
  const int chunk = (row >> 4) * 2 + (col >> 6);
  const int lane = 4 * (row & 7) + ((col & 7) >> 1);
  return ((long long)(chunk * 8 + ((col >> 3) & 7)) * 32 + lane) * 4 +
         2 * ((row >> 3) & 1) + (col & 1);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// The shared buffers of a block.
struct Smem {
  bf16* w1;   // W1^T [c2][c1], stride kLd
  bf16* w2;   // W2^T [c3][c2], stride kLd
  float* b1;  // bf16(b1)
  bf16* x[2];  // the row stages: rows, then a0, then bf16(d_x0)
  bf16* dm;   // D [row][c3], stride C3 + 8
  float* dx;  // the f32 d_x0 tile [row][c1], stride kLdx, over D and a1
  bf16* a1;   // a1, then bf16(d_x1), stride kLd
  float* dw2;  // dW2^T sums in the fragments' order (shared or the slice)
  Plan* plans;
  Batch* batch;
  int* runs;  // per part of the tile: the end row of its group's run of
              // parts when it is the run's first, else -1
  float* red;  // db1's per-warp sums, 4 x 128
};

// Copy plan P's rows (pre[row, point] or the slab's rows) into the stage X
// with cp.async, one commit.
template <bool SLAB>
__device__ __forceinline__ void issue_copy(const Plan& P,
                                           const bf16* __restrict__ src,
                                           const Shape& sh, bf16* X) {
  for (int q = threadIdx.x; q < P.rows * (kC / 8); q += kThreads) {
    const int r = q >> 4, c = q & 15;
    const int g = P.group[P.row_part[r]];
    const size_t at = SLAB ? ((size_t)g * sh.S + P.point[r]) * kC
                           : ((size_t)(g / sh.M) * sh.N + P.point[r]) * kC;
    fused_sa::cp_async16(X + r * kLd + 8 * c, src + at + 8 * c);
  }
  fused_sa::cp_async_commit();
}

// The plan's packed route of a part's channel: bf16(dval)'s bits above the
// slot in the part's segment where the channel is live there, else 0.
__device__ __forceinline__ unsigned pack_route(float d, int slot) {
  return d != 0.0f ? (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(d))
                             << 16 | (unsigned)slot
                   : 0u;
}

// Routing entries e0 + k·kThreads + tid (k < kScatter) of plan P's parts'
// channels, as the plan packed them (routes: C3 a part).
template <int C3>
__device__ __forceinline__ void load_routes(const Plan& P,
                                            const unsigned* __restrict__ routes,
                                            int nseg, int e0,
                                            unsigned (&w)[kScatter]) {
#pragma unroll
  for (int k = 0; k < kScatter; ++k) {
    const int e = e0 + k * kThreads + threadIdx.x;
    w[k] = 0u;
    if (e < P.parts * C3) {
      const int gl = e / C3, j = e - gl * C3;
      const size_t part = (size_t)P.group[gl] * nseg + P.slot0[gl] / kT;
      w[k] = __ldg(routes + part * C3 + j);
    }
  }
}

// The products of one tile whose rows have landed in X. C3 is compiled in;
// MT = C3 / 128 the 16-row tiles of dW2^T each warp owns.
template <int C3, bool SLAB>
__device__ __forceinline__ void tile_products(
    const Plan& P, bf16* X, const Smem& s, const Shape& sh,
    const bf16* __restrict__ center, const unsigned* __restrict__ routes,
    float (&gw1)[16][4], float (&db1p)[8][2], bool first,
    bf16* __restrict__ dx, void* __restrict__ dcenter) {
  constexpr int LD = C3 + 8;  // D's row stride
  constexpr int MT = C3 / 128;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int rows = P.rows, np = P.parts;
  const int mt = warp & 3, nh = warp >> 2;  // the warp's 16 rows, 64 columns
  const bool busy = 16 * mt < rows;
  const int ksteps = (rows + 15) >> 4;  // 16-row steps over the tile's rows

  // the routing entries of D: each part's live channels (bf16(dval) != 0
  // at a slot of its segment, packed by the plan), loaded kScatter a
  // thread at a time, the first batch before the a0 pass so that the two
  // waits overlap
  unsigned rw[kScatter];
  load_routes<C3>(P, routes, sh.nseg, 0, rw);
  // a0 = ReLU(x0) in place (x0 = bf16(pre - center) in the gather form),
  // zeros past the tile's rows; D zeroed
  constexpr int kA0 = kT * (kC / 8) / kThreads;  // 16-byte chunks a thread
  uint4 ctr[kA0];  // the rows' centers (gather form), loaded together
#pragma unroll
  for (int i = 0; i < kA0; ++i) {
    const int e = tid + i * kThreads, r = e >> 4, c = e & 15;
    ctr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (!SLAB && r < rows)
      ctr[i] = __ldg(reinterpret_cast<const uint4*>(
          center + (size_t)P.group[P.row_part[r]] * kC + 8 * c));
  }
#pragma unroll
  for (int i = 0; i < kA0; ++i) {
    const int e = tid + i * kThreads, r = e >> 4, c = e & 15;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      v = *reinterpret_cast<const uint4*>(X + r * kLd + 8 * c);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162* kh =
          reinterpret_cast<const __nv_bfloat162*>(&ctr[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 x = SLAB ? h[j] : __hsub2(h[j], kh[j]);
        h[j] = __hmax2(x, __float2bfloat162_rn(0.0f));
      }
    }
    *reinterpret_cast<uint4*>(X + r * kLd + 8 * c) = v;
  }
  for (int e = tid; e < kT * (C3 / 8); e += kThreads) {
    const int r = e / (C3 / 8), c = e - r * (C3 / 8);
    *reinterpret_cast<uint4*>(s.dm + r * LD + 8 * c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // D: each live channel's bf16(dval) at its slot's row; each (row,
  // channel) is one channel's
  for (int e0 = 0; e0 < np * C3; e0 += kScatter * kThreads) {
    if (e0 > 0) load_routes<C3>(P, routes, sh.nseg, e0, rw);
#pragma unroll
    for (int k = 0; k < kScatter; ++k) {
      if (rw[k] == 0u) continue;
      const int e = e0 + k * kThreads + tid;
      const int gl = e / C3, j = e - gl * C3;
      const int slot = rw[k] & 0xffffu;
      const int row =
          P.base[gl] + __popcll(P.mask[gl] & ((1ull << slot) - 1ull));
      s.dm[row * LD + j] = __ushort_as_bfloat16((unsigned short)(rw[k] >> 16));
    }
  }
  // d_center's runs: a group's parts in the tile lie together (S > 64),
  // their rows in one run that the run's first part sums
  if constexpr (!SLAB) {
    if (tid < np) {
      const int grp = P.group[tid];
      int end = -1;
      if (tid == 0 || P.group[tid - 1] != grp) {
        int last = tid;
        while (last + 1 < np && P.group[last + 1] == grp) ++last;
        end = P.base[last] + __popcll(P.mask[last]);
      }
      s.runs[tid] = end;
    }
  }
  // x1 = a0 W1 -> a1 = ReLU(bf16(bf16(x1) + bf16(b1))), the warp's 16 x 64
  {
    float acc[8][4];
    zero(acc);
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        uint32_t a[4];
        ldsm(a, X + (16 * mt + row_r(lane)) * kLd + 16 * kk + col_r(lane));
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          ldsm(b, s.w1 + (64 * nh + 16 * p + row_s(lane)) * kLd + 16 * kk +
                      col_s(lane));
          mma(acc[2 * p], a, b[0], b[1]);
          mma(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 64 * nh + 8 * nt + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        const float v0 = fmaxf(bfr(__fadd_rn(bfr(acc[nt][2 * h]),
                                             s.b1[col])), 0.0f);
        const float v1 = fmaxf(bfr(__fadd_rn(bfr(acc[nt][2 * h + 1]),
                                             s.b1[col + 1])), 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(s.a1 + r * kLd + col) =
            busy ? __floats2bfloat162_rn(v0, v1) : __float2bfloat162_rn(0.0f);
      }
    }
  }
  __syncthreads();  // D and a1 complete
  // dW2^T += D^T a1: the warp's MT 16-row tiles of channels, in two
  // 64-column halves of C2, summed in shared memory or the block's slice
  // in the fragments' order (the block's first tile stores)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m16 = warp * MT + i;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float4* f = reinterpret_cast<float4*>(s.dw2) +
                  ((m16 * 2 + hh) * 8) * 32 + lane;
      float acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float4 v = first ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                               : f[t * 32];
        acc[t][0] = v.x;
        acc[t][1] = v.y;
        acc[t][2] = v.z;
        acc[t][3] = v.w;
      }
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t a[4];
        ldsm_t(a, s.dm + (16 * kk + row_s(lane)) * LD + 16 * m16 +
                      col_s(lane));
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          ldsm_t(b, s.a1 + (16 * kk + row_r(lane)) * kLd + 64 * hh + 16 * p +
                        col_r(lane));
          mma(acc[2 * p], a, b[0], b[1]);
          mma(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
        f[t * 32] = make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    }
  }
  // d_a1 = D W2^T, the warp's 16 x 64
  float acc[8][4];
  zero(acc);
  if (busy) {
#pragma unroll 4
    for (int kk = 0; kk < C3 / 16; ++kk) {
      uint32_t a[4];
      ldsm(a, s.dm + (16 * mt + row_r(lane)) * LD + 16 * kk + col_r(lane));
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldsm_t(b, s.w2 + (16 * kk + row_r(lane)) * kLd + 64 * nh + 16 * p +
                      col_r(lane));
        mma(acc[2 * p], a, b[0], b[1]);
        mma(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with a1 (dW2) before d_x1 lands
  // d_x1 = d_a1 [x1 > 0]: db1 sums it (a thread its two rows, tile after
  // tile), a1's place takes bf16(d_x1)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 64 * nh + 8 * nt + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
          s.a1 + (16 * mt + g + 8 * h) * kLd + col);
      const float2 x1 = __bfloat1622float2(*at);
      const float d0 = x1.x > 0.0f ? acc[nt][2 * h] : 0.0f;
      const float d1 = x1.y > 0.0f ? acc[nt][2 * h + 1] : 0.0f;
      db1p[nt][0] += d0;
      db1p[nt][1] += d1;
      *at = __floats2bfloat162_rn(d0, d1);
    }
  }
  __syncthreads();  // bf16(d_x1) complete
  // d_a0 = bf16(d_x1) W1^T, the warp's 16 x 64
  zero(acc);
  if (busy) {
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      uint32_t a[4];
      ldsm(a, s.a1 + (16 * mt + row_r(lane)) * kLd + 16 * kk + col_r(lane));
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldsm_t(b, s.w1 + (16 * kk + row_r(lane)) * kLd + 64 * nh + 16 * p +
                      col_r(lane));
        mma(acc[2 * p], a, b[0], b[1]);
        mma(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
  // dW1 += a0^T bf16(d_x1): the warp's 16 rows of C1, all 128 columns
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[4];
    ldsm_t(a, X + (16 * kk + row_s(lane)) * kLd + 16 * warp + col_s(lane));
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      uint32_t b[4];
      ldsm_t(b, s.a1 + (16 * kk + row_r(lane)) * kLd + 16 * p + col_r(lane));
      mma(gw1[2 * p], a, b[0], b[1]);
      mma(gw1[2 * p + 1], a, b[2], b[3]);
    }
  }
  __syncthreads();  // every warp is done with a0 and bf16(d_x1)
  // d_x0 = d_a0 [x0 > 0]: bf16(d_x0) over a0 in X (each thread its own
  // places), the f32 d_x0 for d_center over D and a1
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 64 * nh + 8 * nt + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h;
      __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(X + r * kLd + col);
      const float2 a0 = __bfloat1622float2(*at);
      const float d0 = a0.x > 0.0f ? acc[nt][2 * h] : 0.0f;
      const float d1 = a0.y > 0.0f ? acc[nt][2 * h + 1] : 0.0f;
      *at = __floats2bfloat162_rn(d0, d1);
      if constexpr (!SLAB)
        *reinterpret_cast<float2*>(s.dx + r * kLdx + col) = make_float2(d0, d1);
    }
  }
  __syncthreads();
  // whole rows out: the slab's gradient rows, or the reached rows in the
  // launch's order (d_pre adds them in a fixed order)
  for (int e = tid; e < rows * (kC / 8); e += kThreads) {
    const int r = e >> 4, c = e & 15;
    const size_t row = SLAB ? (size_t)P.group[P.row_part[r]] * sh.S + P.point[r]
                            : (size_t)(P.row0 + r);
    *reinterpret_cast<uint4*>(dx + row * kC + 8 * c) =
        *reinterpret_cast<const uint4*>(X + r * kLd + 8 * c);
  }
  if constexpr (!SLAB) {
    // d_center = -(the sum of d_x0 over a group's rows in the tile, four
    // interleaved partial sums in row order, then added in a fixed tree):
    // bf16 where S <= 64, else added into the group's f32 row (the plan
    // zeroed it) in tile order
    for (int e = tid; e < np * kC; e += kThreads) {
      const int gl = e >> 7, c = e & (kC - 1);
      const int r1 = s.runs[gl];
      if (r1 < 0) continue;  // not its group's first part in the tile
      const int grp = P.group[gl];
      const int r0 = P.base[gl];
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // rows r0 + 4i + k
      int r = r0;
      for (; r + 4 <= r1; r += 4)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[k] += s.dx[(r + k) * kLdx + c];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (r + k < r1) part[k] += s.dx[(r + k) * kLdx + c];
      const float sum = (part[0] + part[1]) + (part[2] + part[3]);
      if (sh.nseg == 1)
        static_cast<bf16*>(dcenter)[(size_t)grp * kC + c] =
            __float2bfloat16_rn(-sum);
      else
        static_cast<float*>(dcenter)[(size_t)grp * kC + c] -= sum;
    }
  }
  __syncthreads();  // the plan and the buffers are free for the next tile
}

// Stage an f32 matrix m (rows x cols, as it lies) as bf16 rows of stride
// kLd, rounding as it loads: 16-byte loads where its rows are contiguous
// (the Dense kernels' (out, in) weights, which the model hands as the
// transposed views W1 and W2), else element by element in its memory
// order.
__device__ __forceinline__ void stage(const Mat& m, int rows, int cols,
                                      bf16* dst) {
  constexpr int kAhead = 8;  // loads in flight a thread
  if (m.s1 == 1 && m.s0 % 4 == 0 &&
      reinterpret_cast<size_t>(m.p) % 16 == 0) {
    const int n = rows * cols / 4;
    for (int e0 = threadIdx.x; e0 < n; e0 += kAhead * kThreads) {
      float4 v[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int e = e0 + k * kThreads;
        const int r = e / (cols / 4), c = 4 * (e - r * (cols / 4));
        v[k] = e < n ? __ldg(reinterpret_cast<const float4*>(
                           m.p + r * m.s0 + c))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int e = e0 + k * kThreads;
        const int r = e / (cols / 4), c = 4 * (e - r * (cols / 4));
        if (e >= n) break;
        __nv_bfloat162* o =
            reinterpret_cast<__nv_bfloat162*>(dst + r * kLd + c);
        o[0] = __floats2bfloat162_rn(v[k].x, v[k].y);
        o[1] = __floats2bfloat162_rn(v[k].z, v[k].w);
      }
    }
  } else {
    const bool r_fast = m.s0 == 1;  // memory runs along the rows' index
    const int n = rows * cols;
    for (int e0 = threadIdx.x; e0 < n; e0 += kAhead * kThreads) {
      float v[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int e = e0 + k * kThreads;
        const int r = r_fast ? e % rows : e / cols;
        const int c = r_fast ? e / rows : e % cols;
        v[k] = e < n ? __ldg(m.p + r * m.s0 + c * m.s1) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int e = e0 + k * kThreads;
        const int r = r_fast ? e % rows : e / cols;
        const int c = r_fast ? e / rows : e % cols;
        if (e >= n) break;
        dst[r * kLd + c] = __float2bfloat16_rn(v[k]);
      }
    }
  }
}

// Persistent blocks over the plan's tiles: block k takes the parts between
// cut(k·target) and cut((k + 1)·target) (split_rows, as the parent walk),
// its tiles one after another, the next tile's rows in flight during this
// one's products. dx: the slab's gradient (SLAB) or the reached rows,
// bf16; dcenter bf16, or f32 where S > 64; w1t, w2t the views W1^T (C2 x
// C1) and W2^T (C3 x C2); ws: per block [dW1 | dW2^T | db1], slice floats
// apart, the weights' sums in the fragments' order (frag_at).
template <int C3, bool SLAB>
__global__ void __launch_bounds__(kThreads, 1)
routed_kernel(const bf16* __restrict__ src, const int* __restrict__ idx,
              const bf16* __restrict__ center, const Mat w1t, const Mat w2t,
              const float* __restrict__ b1,
              const unsigned* __restrict__ routes, const Shape sh,
              const unsigned long long* __restrict__ masks,
              const long long* __restrict__ cum, long long nparts,
              bf16* __restrict__ dx, void* __restrict__ dcenter,
              float* __restrict__ wsall, long long slice) {
  constexpr bool kShared = C3 == 128;  // dw2_shared(C3), checked by the host
  __shared__ long long range[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const Split sp = split_rows(cum, nparts, gridDim.x, kT);
    const long long k = blockIdx.x;
    range[0] = k < sp.active ? cut(cum, nparts, sh.nseg, k * sp.target) : -1;
    range[1] = k + 1 < sp.active
                   ? cut(cum, nparts, sh.nseg, (k + 1) * sp.target) : nparts;
  }
  __syncthreads();
  if (range[0] < 0) return;  // no rows left for this block
  const long long p0 = range[0], p1 = range[1];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = layout(C3, kShared);
  float* ws = wsall + (size_t)blockIdx.x * slice;
  Smem s;
  s.w1 = reinterpret_cast<bf16*>(smem_raw + L.w1);
  s.w2 = reinterpret_cast<bf16*>(smem_raw + L.w2);
  s.b1 = reinterpret_cast<float*>(smem_raw + L.b1);
  s.x[0] = reinterpret_cast<bf16*>(smem_raw + L.x);
  s.x[1] = s.x[0] + kT * kLd;
  s.dm = reinterpret_cast<bf16*>(smem_raw + L.dm);
  s.dx = reinterpret_cast<float*>(smem_raw + L.dm);
  s.a1 = reinterpret_cast<bf16*>(smem_raw + L.a1);
  s.dw2 = kShared ? reinterpret_cast<float*>(smem_raw + L.dw2)
                  : ws + kC * kC;
  s.plans = reinterpret_cast<Plan*>(smem_raw + L.plans);
  s.batch = reinterpret_cast<Batch*>(smem_raw + L.batch);
  s.runs = reinterpret_cast<int*>(smem_raw + L.runs);
  s.red = reinterpret_cast<float*>(smem_raw + L.red);

  // the weights and the bias, once, rounded to bf16
  stage(w1t, kC, kC, s.w1);
  stage(w2t, C3, kC, s.w2);
  for (int c = tid; c < kC; c += kThreads) s.b1[c] = bfr(b1[c]);
  float gw1[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gw1[i][j] = 0.0f;
  float db1p[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) db1p[i][0] = db1p[i][1] = 0.0f;

  // Tiles are numbered as they fill. A batch of parts is loaded and
  // placed into tiles at once (one thread, in part order); then each tile
  // it closes gets its plan (the block in parallel), its copy issued, and
  // the products of the tile before it run, so that a tile's rows are in
  // flight while the tile before it computes. The products have one call
  // site.
  Batch& B = *s.batch;
  int tile = 0, done = 0, rows = 0, np = 0;  // rows, parts of the open tile
  for (long long c0 = p0;; c0 += kBatch) {
    const bool last = c0 >= p1;  // no part left: close the open tile, drain
    int closed = rows > 0 ? 1 : 0;
    if (!last) {
      constexpr int kPer = kBatch * kT / kThreads;
      int id[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = k * kThreads + tid;
        const int pw = (int)c0 + e / kT;  // parts number below 2^31
        const int g = pw / sh.nseg;
        const int slot = (pw - g * sh.nseg) * kT + e % kT;
        id[k] = !SLAB && pw < p1 && slot < sh.S
                    ? idx[(size_t)g * sh.S + slot] : 0;
      }
      if (tid < kBatch) {
        const int pw = (int)c0 + tid;
        unsigned long long m = 0ull;
        int g = 0, slot0 = 0, r0 = 0;
        if (pw < p1) {
          m = masks[pw];
          g = pw / sh.nseg;
          slot0 = (pw - g * sh.nseg) * kT;
          if (!SLAB && pw > 0) r0 = (int)cum[pw - 1];
        }
        B.mask[tid] = m;
        B.group[tid] = g;
        B.slot0[tid] = slot0;
        B.row0[tid] = r0;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) B.ids[k * kThreads + tid] = id[k];
      __syncthreads();
      if (tid == 0) {  // the placement, eight parts' counts read at once
        int k = 0, r = rows, n = np;
        B.first[0] = 0;
        for (int w0 = 0; w0 < kBatch; w0 += 8) {
          int cnt[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) cnt[j] = __popcll(B.mask[w0 + j]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int w = w0 + j;
            if (cnt[j] == 0) {
              B.tile[w] = -1;
              continue;
            }
            if (r + cnt[j] > kT) {  // the part closes tile k (a non-empty one)
              B.rows[k] = r;
              B.parts[k] = n;
              B.first[++k] = w;
              r = n = 0;
            }
            B.tile[w] = k;
            B.base[w] = (unsigned char)r;
            B.part[w] = (unsigned char)n;
            r += cnt[j];
            ++n;
          }
        }
        B.rows[k] = r;
        B.parts[k] = n;
        B.closed = k;
      }
      __syncthreads();
      closed = B.closed;
    }
    for (int k = 0; k <= closed; ++k) {
      Plan& P = s.plans[tile & 1];
      if (!last) {  // tile k's parts from this batch into its plan
        const int w0 = k == 0 ? 0 : B.first[k];
        const int w1 = k < closed ? B.first[k + 1] : kBatch;
        for (int e = tid; e < (w1 - w0) * kT; e += kThreads) {
          const int w = w0 + (e >> 6), bit = e & (kT - 1);
          const unsigned long long m = B.mask[w];
          if (B.tile[w] != k || !((m >> bit) & 1ull)) continue;
          const int r = B.base[w] + __popcll(m & ((1ull << bit) - 1ull));
          if constexpr (SLAB) {
            P.point[r] = B.slot0[w] + bit;
          } else {
            const int p = B.ids[w * kT + bit];
            if ((unsigned)p >= (unsigned)sh.N) __trap();  // an id outside
            P.point[r] = p;
          }
          P.row_part[r] = B.part[w];
        }
        for (int w = w0 + tid; w < w1; w += kThreads) {
          if (B.tile[w] != k) continue;
          const int j = B.part[w];
          P.mask[j] = B.mask[w];
          P.group[j] = B.group[w];
          P.slot0[j] = B.slot0[w];
          P.base[j] = B.base[w];
          if (j == 0) P.row0 = B.row0[w];
        }
      }
      if (k < closed) {  // tile k closes: its rows in flight
        if (tid == 0) {
          P.rows = last ? rows : B.rows[k];
          P.parts = last ? np : B.parts[k];
        }
        __syncthreads();  // the plan is complete
        issue_copy<SLAB>(P, src, sh, s.x[tile & 1]);
        ++tile;
      }
      // the products of the tiles before the newest (all, at the end)
      const bool drain = last && k == closed;
      while (done < tile - (drain ? 0 : 1)) {
        if (drain) fused_sa::cp_async_wait<0>();
        else fused_sa::cp_async_wait<1>();
        __syncthreads();  // every thread's copies of the tile have landed
        tile_products<C3, SLAB>(s.plans[done & 1], s.x[done & 1], s, sh,
                                center, routes, gw1, db1p, done == 0, dx,
                                dcenter);
        ++done;
      }
    }
    if (last) break;
    rows = B.rows[closed];
    np = B.parts[closed];
    __syncthreads();  // the batch is rewritten by the next one
  }
  // the block's sums into its slice: dW1 from the registers, dW2^T from
  // shared memory (or already there; zeros where the block had no tile),
  // db1 over the lanes and the four warps of each column half in order
  float4* o = reinterpret_cast<float4*>(ws);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
    o[(warp * 16 + nt) * 32 + lane] =
        make_float4(gw1[nt][0], gw1[nt][1], gw1[nt][2], gw1[nt][3]);
  if (kShared || done == 0) {
    float4* d = reinterpret_cast<float4*>(ws + kC * kC);
    const float4* from = reinterpret_cast<const float4*>(s.dw2);
    for (int e = tid; e < C3 * kC / 4; e += kThreads)
      d[e] = done == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : from[e];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = db1p[nt][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if ((lane >> 2) == 0)
        s.red[(warp & 3) * kC + 64 * (warp >> 2) + 8 * nt + 2 * (lane & 3) +
              j] = v;
    }
  __syncthreads();
  for (int c = tid; c < kC; c += kThreads)
    ws[kC * kC + C3 * kC + c] =
        ((s.red[c] + s.red[kC + c]) + s.red[2 * kC + c]) + s.red[3 * kC + c];
}

// The plan, one warp per part (group g, segment of 64 slots from slot0),
// as the parent's (fused_sa_bwd.cuh) but for its dval, read from the
// gradient as it lies (bf16(grad where ppre > 0)): the mask of the slots
// its live channels route to, their count, and each channel's packed
// route (pack_route), which the tiles scatter into D with one load. The slab form zeroes the
// gradient rows of its segment's slots that nothing reaches; the gather
// form zeroes a group's d_center row (row_bytes each) where nothing
// reaches it (S <= 64), or at its first part (S > 64: the tiles add into
// it).
template <bool SLAB>
__global__ void __launch_bounds__(kThreads)
plan_kernel(const Grad gr, const int* __restrict__ argmax, const Shape sh,
            long long nparts, unsigned long long* __restrict__ masks,
            int* __restrict__ counts, unsigned* __restrict__ routes,
            unsigned char* __restrict__ zero_rows, int row_bytes) {
  const long long p = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= nparts) return;
  const int C3 = sh.C3, S = sh.S;
  const int g = (int)(p / sh.nseg);
  const int slot0 = (int)(p - (long long)g * sh.nseg) * kT;
  unsigned long long m = 0;
#pragma unroll 4
  for (int c = lane; c < C3; c += 32) {
    const float d = bfr(gr.at(g, c, C3));
    const int a = argmax[(size_t)g * C3 + c];
    if ((unsigned)a >= (unsigned)S) __trap();  // an argmax outside S
    const bool here = d != 0.0f && (unsigned)(a - slot0) < (unsigned)kT;
    if (here) m |= 1ull << (a - slot0);
    routes[(size_t)p * C3 + c] = here ? pack_route(d, a - slot0) : 0u;
  }
  const unsigned m_lo = __reduce_or_sync(0xffffffffu, (unsigned)m);
  const unsigned m_hi = __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
  m = ((unsigned long long)m_hi << 32) | m_lo;
  if (lane == 0) {
    masks[p] = m;
    counts[p] = __popcll(m);
  }
  const int chunks = row_bytes / 16;
  if constexpr (SLAB) {
    const int end = min(kT, S - slot0);
    for (int s = 0; s < end; ++s) {
      if ((m >> s) & 1ull) continue;
      uint4* row = reinterpret_cast<uint4*>(
          zero_rows + ((size_t)g * S + slot0 + s) * row_bytes);
      for (int c = lane; c < chunks; c += 32) row[c] = make_uint4(0u, 0u, 0u, 0u);
    }
  } else if (sh.nseg == 1 ? m == 0 : slot0 == 0) {
    uint4* row = reinterpret_cast<uint4*>(zero_rows + (size_t)g * row_bytes);
    for (int c = lane; c < chunks; c += 32) row[c] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// cum[i] = counts[0] + ... + counts[i], in one block, 8192 counts at a
// time: loaded whole lines at a time (the next 8192 in flight while these
// are scanned) and staged in shared memory, each thread then scans 8
// neighbours, a warp scan, a scan of the warps' sums; the sums go back
// through shared memory and out in whole lines, above the running carry.
constexpr int kScanThreads = 1024;
constexpr int kScanEach = 8;
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, long long n,
            long long* __restrict__ cum) {
  // a thread's 8 counts at 9·t + j: the padding keeps a warp's reads on
  // distinct banks
  __shared__ int stage[kScanThreads * (kScanEach + 1)];
  __shared__ long long wsum[kScanThreads / 32];
  constexpr int kChunk = kScanEach * kScanThreads;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int next[kScanEach];  // coalesced: count base + j·1024 + t
#pragma unroll
  for (int j = 0; j < kScanEach; ++j)
    next[j] = j * kScanThreads + t < n ? counts[j * kScanThreads + t] : 0;
  long long carry = 0;
  for (long long base = 0; base < n; base += kChunk) {
#pragma unroll
    for (int j = 0; j < kScanEach; ++j) {
      const int i = j * kScanThreads + t;
      stage[(i / kScanEach) * (kScanEach + 1) + i % kScanEach] = next[j];
    }
#pragma unroll
    for (int j = 0; j < kScanEach; ++j) {
      const long long i = base + kChunk + j * kScanThreads + t;
      next[j] = i < n ? counts[i] : 0;
    }
    __syncthreads();
    int v[kScanEach];
    int own = 0;  // a thread's counts: at most 8 x 64
#pragma unroll
    for (int j = 0; j < kScanEach; ++j) {
      v[j] = stage[t * (kScanEach + 1) + j];
      own += v[j];
    }
    long long x = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = wsum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    // the prefix sums within the chunk (below 2^31: 8192 counts of at
    // most 64) back over the counts, then out in whole lines
    int run = (int)((warp > 0 ? wsum[warp - 1] : 0) + x - own);
#pragma unroll
    for (int j = 0; j < kScanEach; ++j) {
      run += v[j];
      stage[t * (kScanEach + 1) + j] = run;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanEach; ++j) {
      const int i = j * kScanThreads + t;
      if (base + i < n)
        cum[base + i] =
            carry + stage[(i / kScanEach) * (kScanEach + 1) + i % kScanEach];
    }
    carry += wsum[kScanThreads / 32 - 1];
    __syncthreads();  // stage and wsum are rewritten by the next counts
  }
}

// out = [dW1 | dW2^T | db1] row-major: the sum of the active blocks'
// slices (split_rows), in block order, read in the fragments' order
__global__ void reduce_slices(const float* __restrict__ ws, long long slice,
                              int C3, const long long* __restrict__ cum,
                              long long nparts, int blocks,
                              float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long w1 = (long long)kC * kC, w2 = (long long)C3 * kC;
  if (e >= w1 + w2 + kC) return;
  const Split sp = split_rows(cum, nparts, blocks, kT);
  long long at = e;
  if (e < w1)
    at = frag_at((int)(e >> 7), (int)(e & (kC - 1)));
  else if (e < w1 + w2)
    at = w1 + frag_at((int)((e - w1) >> 7), (int)((e - w1) & (kC - 1)));
  float s = 0.0f;
  for (long long p = 0; p < sp.active; ++p) s += ws[p * slice + at];
  out[e] = s;
}

// db2's partial sums: block (x, y) the channels 32x + lane over the y-th
// of gridDim.y ranges of groups, warp w its groups w, w + 8, ..., the
// warps' sums added in order -> part[y][c]
__global__ void __launch_bounds__(kThreads)
db2_partials(const Grad gr, int groups, int C3, float* __restrict__ part) {
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int per = (groups + gridDim.y - 1) / gridDim.y;
  const int lo = blockIdx.y * per, hi = min(groups, lo + per);
  float acc = 0.0f;
  if (c < C3) {
#pragma unroll 4
    for (int grp = lo + warp; grp < hi; grp += kWarps)
      acc += gr.at(grp, c, C3);
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < C3) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += sums[k][lane];
    part[(size_t)blockIdx.y * C3 + c] = t;
  }
}

// db2[c] = the partials' sum in range order
__global__ void db2_reduce(const float* __restrict__ part, int parts, int C3,
                           float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C3) return;
  float s = 0.0f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * C3 + c];
  out[c] = s;
}

// y = bf16(x)
__global__ void to_bf16(const float* __restrict__ x, bf16* __restrict__ y,
                        long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __float2bfloat16_rn(x[i]);
}

// The parent walk's operands from the raw ones, in one pass: W1, W1^T, b1,
// W2^T and dval rounded to bf16 (kept f32: their products are exact in
// f32), dval from the gradient as it lies.
__global__ void prep_kernel(const Mat w1, const float* __restrict__ b1,
                            const Mat w2, const Grad gr, int C1, int C2,
                            int C3, long long groups, float* __restrict__ w1r,
                            float* __restrict__ w1t, float* __restrict__ b1r,
                            float* __restrict__ w2t,
                            float* __restrict__ dval) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n1 = (long long)C1 * C2, n2 = (long long)C3 * C2;
  if (e < n1) {
    const int i = (int)(e / C2), j = (int)(e % C2);
    w1r[e] = bfr(w1.p[i * w1.s0 + j * w1.s1]);
  } else if ((e -= n1) < n1) {
    const int i = (int)(e / C1), j = (int)(e % C1);  // W1^T[i][j] = W1[j][i]
    w1t[e] = bfr(w1.p[j * w1.s0 + i * w1.s1]);
  } else if ((e -= n1) < C2) {
    b1r[e] = bfr(b1[e]);
  } else if ((e -= C2) < n2) {
    const int i = (int)(e / C2), j = (int)(e % C2);  // W2^T[i][j] = W2[j][i]
    w2t[e] = bfr(w2.p[j * w2.s0 + i * w2.s1]);
  } else if ((e -= n2) < groups * C3) {
    dval[e] = bfr(gr.at((int)(e / C3), (int)(e % C3), C3));
  }
}

}  // namespace fused_sa_mma
