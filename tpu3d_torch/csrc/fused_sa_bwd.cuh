// The routed backward of the fused two-layer MLP + max-pool (no BatchNorm),
// for Hopper (sm_90a): the kernels, the plan and the launch, templated on
// the input rows' type. fused_sa_bwd.cu instantiates them for f32 rows
// (kernels 6 and 8, f32), fused_sa_bwd_bf16.cu for bf16 rows (their bf16
// training forms); each source is one library, built in parallel. The
// design is set out in fused_sa_bwd.cu.
//
// The bf16 form (Tin = __nv_bfloat16) keeps the f32 form's plan and walk
// and rounds where tpu3d's _nobn2_bwd_kernel / _nobn_bwd_kernel round
// (tpu3d/ops/fused_sa.py:604-632, :782-824): x0 = bf16(pre - center) (the
// slab's rows as they are), x1 = bf16(bf16(a0 W1) + b1), d_x1 rounded to
// bf16 before dW1 and d_a0 (db1 sums it unrounded), the gather form's
// reached rows' d_x0 rounded to bf16 for d_pre (d_center sums it
// unrounded). The caller hands W1, W1^T, b1, W2^T and dval rounded to bf16,
// so every product is of two bf16 values, exact in f32, and every sum f32:
// the arithmetic of tpu3d's bf16 MXU products, summed in the f32 walk's
// order. d_pre is summed in f32 and written in bf16 once; d_center and the
// slab's d_x0 come back in f32, and the caller rounds them to bf16 once.

#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "csr_inverse.cuh"
#include "fused_sa_common.cuh"

namespace {

using fused_sa::cp_async16;
using fused_sa::cp_async_commit;
using fused_sa::cp_async_wait;
using fused_sa::kKC;
using fused_sa::kSmemMax;
using fused_sa::kThreads;
using fused_sa::kWarps;

constexpr int kTileMax = 64;  // the most rows of a routed tile
constexpr int kChunk = 64;    // channels of a dense tile's D chunk
// a tile routes its channels as products when more than 1/kDenseRouting
// of its T x C3 routing matrix is live
constexpr int kDenseRouting = 8;

// floats of DA (T x max(C1, C2)): at least a weight slice, and beside a
// 128-column tile of d_x0 where C1 > 128
__host__ __device__ inline int da_floats(int T, int C1, int C2) {
  const int tile = T * (C1 > C2 ? C1 : C2);
  const int need = C1 > 128 ? T * 128 + kKC * 128 : kKC * 128;
  return tile > need ? tile : need;
}

// floats of the dense routing's scratch: a weight slice and a D chunk
__host__ __device__ inline int scratch_floats(int T) {
  return kKC * 128 + T * kChunk;
}

// whether the dense routing's scratch lies in DA: at C2 = 128, where d_a1
// stays in registers until the last chunk, and DA holds it
__host__ __device__ inline bool scratch_in_da(int T, int C1, int C2) {
  return C2 == 128 && da_floats(T, C1, C2) >= scratch_floats(T);
}
// the most bytes of workspace the blocks' slices may take in all
constexpr long long kWorkspaceMax = 512LL << 20;

// One tile: its parts (reached-slot mask, group id, first slot of the
// segment, first row) and its rows (the point id into the batch row's N
// points, or the slot in its group in the slab form; the row's part).
struct Plan {
  unsigned long long mask[kTileMax];
  int group[kTileMax];
  int slot0[kTileMax];
  int point[kTileMax];
  unsigned char base[kTileMax];
  unsigned char row_part[kTileMax];
  int rows, parts;
  int live;    // the tile's live channels (dval != 0), over its parts
  int row0;    // the tile's first row among the launch's reached rows
               // (gather form; keeps sizeof a multiple of 16)
};
static_assert(sizeof(Plan) % 16 == 0, "Plan must keep 16-byte alignment");

// The launch's shape: widths, tile rows, and where the sums live.
struct Shape {
  int N, M, S, C1, C2, C3;
  int T;         // tile rows = segment slots
  int nseg;      // segments per group
  bool narrow;   // C1 = C2 = 128: dW1 and db1 in registers across tiles
  bool dw2_shared;
};

// acc (+)= X W[:, 0:128] for a tile's rows (each thread rows warp*TM + i,
// columns 4*lane + q; W is cin rows of stride ldw, staged kKC rows at a
// time through wbuf), with two changes from fused_sa::dense_ld: each
// thread's share of the next slice is loaded into registers while the
// current slice's products run, so a tile waits for the weights once, not
// once per slice; and a warp whose rows all lie at or past `rows` only
// stages. Begins with a block barrier; the caller needs another one before
// it reuses wbuf.
template <int TM, bool ACCUM>
__device__ __forceinline__ void routed_dense(const float* __restrict__ X,
                                             int ldx, int cin,
                                             const float* __restrict__ W,
                                             int ldw,
                                             float* __restrict__ wbuf,
                                             float (&acc)[TM][4], int rows) {
  constexpr int kSlice = kKC * 128 / 4;  // float4s of one staged slice
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool idle = warp * TM >= rows;
  if constexpr (!ACCUM) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][t] = 0.0f;
  }
  auto load = [&](int k0, float4 (&next)[kSlice / kThreads]) {
#pragma unroll
    for (int q = 0; q < kSlice / kThreads; ++q) {
      const int e = threadIdx.x + q * kThreads;
      next[q] = reinterpret_cast<const float4*>(
          W + (size_t)(k0 + (e >> 5)) * ldw)[e & 31];
    }
  };
  float4 next[kSlice / kThreads];
  load(0, next);
  for (int k0 = 0; k0 < cin; k0 += kKC) {
    __syncthreads();  // every warp is done with the previous slice
#pragma unroll
    for (int q = 0; q < kSlice / kThreads; ++q)
      reinterpret_cast<float4*>(wbuf)[threadIdx.x + q * kThreads] = next[q];
    if (k0 + kKC < cin) load(k0 + kKC, next);
    __syncthreads();
    if (idle) continue;
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            X + (warp * TM + i) * ldx + k0 + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(wbuf + (kk + j) * 128 + 4 * lane);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = j == 0 ? a[i].x : j == 1 ? a[i].y
                         : j == 2 ? a[i].z : a[i].w;
          acc[i][0] += av * v.x;
          acc[i][1] += av * v.y;
          acc[i][2] += av * v.z;
          acc[i][3] += av * v.w;
        }
      }
    }
  }
}

// The row of slot s among its part's reached slots, in slot order (s
// inside the part's segment).
__device__ __forceinline__ int slot_row(const Plan& P, int gl, int s) {
  return P.base[gl]
         + __popcll(P.mask[gl] & ((1ull << (s - P.slot0[gl])) - 1ull));
}

// Whether slot a of part gl's group lies in its segment.
__device__ __forceinline__ bool in_part(const Plan& P, int gl, int a, int T) {
  return (unsigned)(a - P.slot0[gl]) < (unsigned)T;
}

// bf16 rounding of an f32 value, kept in f32
__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copy plan P's rows (pre[row, point] or the slab's rows) into X: f32 rows
// with cp.async, one commit; bf16 rows (the bf16 form) loaded 16 bytes a
// thread and widened to f32 as they are stored (an empty commit).
template <bool SLAB, typename Tin>
__device__ __forceinline__ void issue_copy(const Plan& P,
                                           const Tin* __restrict__ src,
                                           const Shape& sh, float* X) {
  const int C1 = sh.C1;
  constexpr int kVec = std::is_same<Tin, float>::value ? 4 : 8;
  for (int q = threadIdx.x; q < P.rows * (C1 / kVec); q += kThreads) {
    const int r = q / (C1 / kVec), c = q - r * (C1 / kVec);
    const int g = P.group[P.row_part[r]];
    size_t at;
    if constexpr (SLAB)
      at = ((size_t)g * sh.S + P.point[r]) * C1;
    else
      at = ((size_t)(g / sh.M) * sh.N + P.point[r]) * C1;
    if constexpr (kVec == 4) {
      cp_async16(X + r * C1 + 4 * c, src + at + 4 * c);
    } else {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(src + at + 8 * c));
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float4* dst = reinterpret_cast<float4*>(X + r * C1 + 8 * c);
      dst[0] = make_float4(__bfloat162float(v[0]), __bfloat162float(v[1]),
                           __bfloat162float(v[2]), __bfloat162float(v[3]));
      dst[1] = make_float4(__bfloat162float(v[4]), __bfloat162float(v[5]),
                           __bfloat162float(v[6]), __bfloat162float(v[7]));
    }
  }
  cp_async_commit();
}

// gw (+)= X[:, c1b:c1b+128]^T D[:, c2b:c2b+128] over `rows` rows, and, for
// the threads of hi == 0, gb (+)= the column sums of D; thread (hi, lo) owns
// rows c1 = 4*hi + r and 64 + 4*hi + r, columns c2 = 4*lo + r and
// 64 + 4*lo + r (r < 4), so that neighbouring threads read neighbouring 16
// bytes of shared memory. BF: the product takes D rounded to bf16, the sum
// gb the unrounded D (tpu3d's dW1 of bf16(d_x1), db1 of d_x1).
template <bool BF>
__device__ __forceinline__ void dw1_block(const float* X, int ldx,
                                          const float* D, int ldd, int rows,
                                          int c1b, int c2b,
                                          float (&gw)[8][8], float (&gb)[8]) {
  const int hi = threadIdx.x >> 4, lo = threadIdx.x & 15;
  for (int s = 0; s < rows; ++s) {
    const float* x = X + s * ldx + c1b;
    const float* d = D + s * ldd + c2b;
    const float4 a_lo = *reinterpret_cast<const float4*>(x + 4 * hi);
    const float4 a_hi = *reinterpret_cast<const float4*>(x + 64 + 4 * hi);
    const float4 d_lo = *reinterpret_cast<const float4*>(d + 4 * lo);
    const float4 d_hi = *reinterpret_cast<const float4*>(d + 64 + 4 * lo);
    const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                        a_hi.x, a_hi.y, a_hi.z, a_hi.w};
    const float dv[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w,
                         d_hi.x, d_hi.y, d_hi.z, d_hi.w};
    float dr[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dr[j] = BF ? bfr(dv[j]) : dv[j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) gw[i][j] += a[i] * dr[j];
    if (hi == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) gb[j] += dv[j];
    }
  }
}

// out[c1b + row(i), c2b + col(j)] (+)= gw[i][j] (row stride C2), and
// db1[c2b + col(j)] (+)= gb[j] for the threads of hi == 0 when `with_b`.
template <bool ADD>
__device__ __forceinline__ void store_dw1(const float (&gw)[8][8],
                                          const float (&gb)[8], float* out,
                                          float* db1, int C2, int c1b,
                                          int c2b, bool with_b) {
  const int hi = threadIdx.x >> 4, lo = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c1 = c1b + (i < 4 ? 4 * hi + i : 64 + 4 * hi + (i - 4));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c2 = c2b + (j < 4 ? 4 * lo + j : 64 + 4 * lo + (j - 4));
      if constexpr (ADD)
        out[(size_t)c1 * C2 + c2] += gw[i][j];
      else
        out[(size_t)c1 * C2 + c2] = gw[i][j];
    }
  }
  if (with_b && hi == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c2 = c2b + (j < 4 ? 4 * lo + j : 64 + 4 * lo + (j - 4));
      if constexpr (ADD)
        db1[c2] += gb[j];
      else
        db1[c2] = gb[j];
    }
  }
}

// The shared buffers of one launch, carved from dynamic shared memory.
struct Buffers {
  Plan* plans;   // by tile parity
  float* X0;     // NBUF x T x C1: the copied rows, then x0 = a0
  float* A1;     // T x C2: a1, then d_x1
  float* DA;     // T x max(C1, C2): d_a1; d_x0 of a 128-column tile
  float* SC;     // the dense routing's weight slice and D chunk
  float* DW2;    // C3 x C2: dW2^T (shared, or the block's workspace slice)
  unsigned long long* scan;
  int* scan_live;
};

// The products of one copied tile (X holds its rows), into the block's
// sums gw1, gb1, DW2 (and the workspace slice ws when wide), d_center and
// dx: the slab's gradient rows in the slab form, in the gather form the
// reached rows' d_x0 at their place among the launch's reached rows.
template <int TM, bool SLAB, int TN3, typename Tin>
__device__ __forceinline__ void tile_products(
    const Plan& P, float* X, const Buffers& b, const Shape& sh,
    const Tin* __restrict__ center, const float* __restrict__ w1,
    const float* __restrict__ w1t, const float* __restrict__ b1,
    const float* __restrict__ w2t, const float* __restrict__ dval,
    const int* __restrict__ argmax, float (&gw1)[8][8], float (&gb1)[8],
    float* __restrict__ ws, float* __restrict__ dx,
    float* __restrict__ dcenter) {
  constexpr int T = 8 * TM;
  // the bf16 form: bf16 rows, the rounding points of tpu3d's kernels
  constexpr bool BF = !std::is_same<Tin, float>::value;
  // TN3 > 0: the shipped widths, compiled in (C1 = C2 = 128, C3 = 32·TN3)
  const int C1 = TN3 ? 128 : sh.C1, C2 = TN3 ? 128 : sh.C2;
  const int C3 = TN3 ? 32 * TN3 : sh.C3;
  const bool narrow = TN3 ? true : sh.narrow;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = P.rows, np = P.parts;
  const int col = 4 * lane;
  float* A1 = b.A1;
  float* DA = b.DA;
  float* DW2 = b.DW2;
  // x0 = ReLU(pre - center) (or ReLU(slab)) in place; the rows past the
  // tile's are zero. BF: x0 = bf16(pre - center), both bf16
  for (int e = tid; e < T * C1 / 4; e += kThreads) {
    const int r = e / (C1 / 4), c = e - r * (C1 / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows) {
      float4 x = reinterpret_cast<const float4*>(X)[e];
      if constexpr (!SLAB && !BF) {
        const float4 k = reinterpret_cast<const float4*>(
            center + (size_t)P.group[P.row_part[r]] * C1)[c];
        x = make_float4(x.x - k.x, x.y - k.y, x.z - k.z, x.w - k.w);
      } else if constexpr (!SLAB) {
        const Tin* k = center + (size_t)P.group[P.row_part[r]] * C1 + 4 * c;
        x = make_float4(bfr(x.x - __bfloat162float(k[0])),
                        bfr(x.y - __bfloat162float(k[1])),
                        bfr(x.z - __bfloat162float(k[2])),
                        bfr(x.w - __bfloat162float(k[3])));
      }
      v = make_float4(fmaxf(x.x, 0.0f), fmaxf(x.y, 0.0f), fmaxf(x.z, 0.0f),
                      fmaxf(x.w, 0.0f));
    }
    reinterpret_cast<float4*>(X)[e] = v;
  }
  // a1 = ReLU(a0 W1 + b1) into A1 in 128-column tiles; DA stages W1's
  // slices, then holds d_a1 (zeroed). BF: a1 = ReLU(bf16(bf16(a0 W1) + b1))
  // (W1 and b1 come rounded to bf16)
  for (int c2 = 0; c2 < C2; c2 += 128) {
    float acc[TM][4];
    routed_dense<TM, false>(X, C1, C1, w1 + c2, C2, DA, acc, rows);
    const float4 bb = *reinterpret_cast<const float4*>(b1 + c2 + col);
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[q] = fmaxf(BF ? bfr(__fadd_rn(bfr(acc[i][q]), bv[q]))
                        : acc[i][q] + bv[q],
                     0.0f);
      *reinterpret_cast<float4*>(A1 + (warp * TM + i) * C2 + c2 + col) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
  __syncthreads();  // every warp is done with the weight slices in DA
  for (int e = tid; e < T * C2 / 4; e += kThreads)
    reinterpret_cast<float4*>(DA)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  if (P.live * kDenseRouting > T * C3) {
    // a dense tile (most channels live, a few rows per part): d_a1 =
    // D W2^T and dW2^T += D^T a1 as products over the routing matrix D
    // (T x C3, dval at each live channel's row), 64 channels at a time
    // staged beside a weight slice of W2^T in SC (DA itself at C2 = 128,
    // where d_a1 stays in registers until the last chunk,
    // scratch_in_da()); per 128-column tile of C2
    float* WB = b.SC;
    float* D = b.SC + kKC * 128;
    const int tj = tid >> 4, tc = tid & 15;
    for (int c2 = 0; c2 < C2; c2 += 128) {
      float acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
      for (int c0 = 0; c0 < C3; c0 += kChunk) {
        const int nc = min(kChunk, C3 - c0);
        for (int e = tid; e < T * kChunk; e += kThreads) D[e] = 0.0f;
        __syncthreads();
        for (int e0 = 0; e0 < np * nc; e0 += 8 * kThreads) {
          float d[8];  // eight loads in flight
          int a[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int e = e0 + k * kThreads + tid;
            d[k] = 0.0f;
            a[k] = 0;
            if (e < np * nc) {
              const int gl = e / nc, j = e - gl * nc;
              const size_t at = (size_t)P.group[gl] * C3 + c0 + j;
              d[k] = dval[at];
              a[k] = argmax[at];
            }
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int e = e0 + k * kThreads + tid;
            const int gl = e / nc, j = e - gl * nc;
            if (e < np * nc && d[k] != 0.0f && in_part(P, gl, a[k], T))
              D[slot_row(P, gl, a[k]) * kChunk + j] = d[k];
          }
        }
        routed_dense<TM, true>(D, kChunk, nc, w2t + (size_t)c0 * C2 + c2, C2,
                               WB, acc, rows);
        // dW2^T[c0 + 4 tj + i, c2 + c] += sum_r D[r, 4 tj + i] a1[r, c2 + c],
        // c = 4 tc + q and 64 + 4 tc + q
        if (4 * tj < nc) {
          float g2[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 8; ++q) g2[i][q] = 0.0f;
          for (int r = 0; r < rows; ++r) {
            const float4 dd = *reinterpret_cast<const float4*>(
                D + r * kChunk + 4 * tj);
            const float4 a_lo = *reinterpret_cast<const float4*>(
                A1 + r * C2 + c2 + 4 * tc);
            const float4 a_hi = *reinterpret_cast<const float4*>(
                A1 + r * C2 + c2 + 64 + 4 * tc);
            const float dv[4] = {dd.x, dd.y, dd.z, dd.w};
            const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                                 a_hi.x, a_hi.y, a_hi.z, a_hi.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int q = 0; q < 8; ++q) g2[i][q] += dv[i] * av[q];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              DW2[(size_t)(c0 + 4 * tj + i) * C2 + c2
                  + (q < 4 ? 4 * tc + q : 60 + 4 * tc + q)] += g2[i][q];
        }
        __syncthreads();  // D and the weight slices are free
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(DA + (warp * TM + i) * C2 + c2 + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
  } else {
    // a sparse tile (a few channels per row): per part, its live channels
    // 32 at a time, up to 8 x 32 loaded at once; warp w adds d_a1[r, :] +=
    // dval W2^T[c, :] for the channels routed to its rows (r % 8 == w) and
    // dW2^T[c, :] += dval a1[r, :] for its channels (c % 8 == w), four
    // channels' rows in flight together, lane l on columns 4l..4l+3 of each
    // 128-column tile of C2. Each row of d_a1 and of dW2^T is one warp's,
    // summed in channel order, so the results do not depend on timing.
    constexpr int kBatch = 8;  // 32-channel chunks whose loads fly at once
    for (int gl = 0; gl < np; ++gl) {
      const size_t g = (size_t)P.group[gl] * C3;
      const unsigned long long m = P.mask[gl];
      const int base = P.base[gl], slot0 = P.slot0[gl];
      for (int vb = 0; vb < C3; vb += 32 * kBatch) {
        float dl[kBatch];
        int rl[kBatch];  // the channel's row in the tile, or -1
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          float d = 0.0f;
          int a = -1;
          if (vb + 32 * v < C3) {
            d = dval[g + vb + 32 * v + lane];
            a = argmax[g + vb + 32 * v + lane] - slot0;
          }
          const bool here = d != 0.0f && (unsigned)a < (unsigned)T;
          dl[v] = here ? d : 0.0f;
          rl[v] = here ? base + __popcll(m & ((1ull << a) - 1ull)) : -1;
        }
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          const int v0 = vb + 32 * v;
          if (v0 >= C3) break;
          const bool live_c = rl[v] >= 0;
          unsigned to_rows = __ballot_sync(
              0xffffffffu, live_c && (rl[v] & (kWarps - 1)) == warp);
          unsigned to_dw2 = __ballot_sync(
              0xffffffffu, live_c && ((v0 + lane) & (kWarps - 1)) == warp);
          while (to_rows | to_dw2) {
            int src[4];
            bool row_role[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {  // the next four roles, in order
              row_role[k] = to_rows != 0;
              const unsigned set = to_rows ? to_rows : to_dw2;
              src[k] = set ? __ffs(set) - 1 : -1;
              if (to_rows) to_rows &= to_rows - 1;
              else to_dw2 &= to_dw2 - 1;
            }
            float d[4];
            int r[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int from = src[k] < 0 ? 0 : src[k];
              d[k] = __shfl_sync(0xffffffffu, dl[v], from);
              r[k] = __shfl_sync(0xffffffffu, rl[v], from);
            }
            for (int c2 = 0; c2 < C2; c2 += 128) {
              const int cc = c2 + 4 * lane;
              float4 w[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int c = v0 + src[k];
                w[k] = src[k] < 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                       : row_role[k]
                           ? *reinterpret_cast<const float4*>(
                                 w2t + (size_t)c * C2 + cc)
                           : *reinterpret_cast<const float4*>(
                                 A1 + r[k] * C2 + cc);
              }
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if (src[k] < 0) continue;
                float4* dst = reinterpret_cast<float4*>(
                    row_role[k] ? DA + r[k] * C2 + cc
                                : DW2 + (size_t)(v0 + src[k]) * C2 + cc);
                float4 o = *dst;
                o.x += d[k] * w[k].x;
                o.y += d[k] * w[k].y;
                o.z += d[k] * w[k].z;
                o.w += d[k] * w[k].w;
                *dst = o;
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < T * C2; e += kThreads)  // d_x1, in place of a1
    A1[e] = A1[e] > 0.0f ? DA[e] : 0.0f;
  __syncthreads();
  // dW1 += a0^T d_x1, db1 += sum d_x1: in registers at 128 x 128, else a
  // 128 x 128 block at a time added into the workspace slice (BF: dW1 of
  // bf16(d_x1), db1 of d_x1)
  if (narrow) {
    dw1_block<BF>(X, C1, A1, C2, rows, 0, 0, gw1, gb1);
  } else {
    for (int c1b = 0; c1b < C1; c1b += 128)
      for (int c2b = 0; c2b < C2; c2b += 128) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          gb1[i] = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) gw1[i][j] = 0.0f;
        }
        dw1_block<BF>(X, C1, A1, C2, rows, c1b, c2b, gw1, gb1);
        store_dw1<true>(gw1, gb1, ws, ws + (size_t)C1 * C2 + (size_t)C3 * C2,
                        C2, c1b, c2b, c1b == 0);
      }
  }
  if constexpr (BF) {  // d_a0 takes bf16(d_x1)
    __syncthreads();
    for (int e = tid; e < T * C2; e += kThreads) A1[e] = bfr(A1[e]);
  }
  // d_a0 = d_x1 W1^T in 128-column tiles of C1; the weight slices in DA
  // (past the d_x0 tile where C1 > 128)
  float* WB = C1 > 128 ? DA + T * 128 : DA;
  for (int c1 = 0; c1 < C1; c1 += 128) {
    float acc[TM][4];
    routed_dense<TM, false>(A1, C2, C2, w1t + c1, C1, WB, acc, rows);
    __syncthreads();  // every warp is done with the weight slices
    // d_x0 = d_a0 [x0 > 0]: the slab's row, or the reached row's (the
    // gather form; sum_rows adds them into d_pre in a fixed order) and the
    // tile into DA (T x 128) for d_center
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = warp * TM + i;
      const float4 x = *reinterpret_cast<const float4*>(X + r * C1 + c1 + col);
      const float v[4] = {x.x > 0.0f ? acc[i][0] : 0.0f,
                          x.y > 0.0f ? acc[i][1] : 0.0f,
                          x.z > 0.0f ? acc[i][2] : 0.0f,
                          x.w > 0.0f ? acc[i][3] : 0.0f};
      if (r >= rows) continue;
      if constexpr (SLAB) {
        const int g = P.group[P.row_part[r]];
        *reinterpret_cast<float4*>(
            dx + ((size_t)g * sh.S + P.point[r]) * C1 + c1 + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        // d_center sums d_x0; d_pre sums bf16(d_x0) in the bf16 form
        const float4 d = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(DA + r * 128 + col) = d;
        *reinterpret_cast<float4*>(
            dx + (size_t)(P.row0 + r) * C1 + c1 + col) =
            BF ? make_float4(bfr(v[0]), bfr(v[1]), bfr(v[2]), bfr(v[3])) : d;
      }
    }
    if constexpr (!SLAB) {
      __syncthreads();
      // d_center = -(the sum of d_x0 over a group's rows in the tile, in
      // row order); a group whose parts span tiles (S > T) adds each tile's
      // sum into its row, zeroed by the plan, in tile order
      for (int e = tid; e < np * 128; e += kThreads) {
        const int gl = e >> 7, c = e & 127;
        const int grp = P.group[gl];
        if (gl > 0 && P.group[gl - 1] == grp) continue;  // not its first
        int last = gl;
        while (last + 1 < np && P.group[last + 1] == grp) ++last;
        const int r1 = P.base[last] + __popcll(P.mask[last]);
        float sum = 0.0f;
        for (int r = P.base[gl]; r < r1; ++r) sum += DA[r * 128 + c];
        float* dst = dcenter + (size_t)grp * C1 + c1 + c;
        if (sh.nseg == 1)
          *dst = -sum;
        else
          *dst -= sum;
      }
    }
  }
  __syncthreads();  // the plan and the buffers are free for the next tile
}

// The plan, one warp per part (group g, segment of T slots from slot0): the
// T-bit mask of the slots its live channels route to (dval != 0 at an
// argmax inside the segment), its count of live channels and of reached
// slots. Gather form: a group's d_center row is zeroed where nothing
// reaches it (S <= T), or at its first part (S > T: the tiles add into it).
// Slab form: the segment's rows that nothing reaches get a zero gradient.
template <bool SLAB>
__global__ void __launch_bounds__(kThreads)
plan_kernel(const float* __restrict__ dval, const int* __restrict__ argmax,
            const Shape sh, long long nparts,
            unsigned long long* __restrict__ masks, int* __restrict__ live,
            int* __restrict__ counts, float* __restrict__ dx,
            float* __restrict__ dcenter) {
  const long long p = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= nparts) return;
  const int C1 = sh.C1, C3 = sh.C3, S = sh.S, T = sh.T;
  const long long g = p / sh.nseg;
  const int slot0 = (int)(p - g * sh.nseg) * T;
  unsigned long long m = 0;
  int p_live = 0;
  for (int c = lane; c < C3; c += 32) {
    const float d = dval[g * C3 + c];
    const int a = argmax[g * C3 + c];
    if ((unsigned)a >= (unsigned)S) __trap();  // an argmax outside S
    const bool here = d != 0.0f && (unsigned)(a - slot0) < (unsigned)T;
    if (here) m |= 1ull << (a - slot0);
    p_live += __popc(__ballot_sync(0xffffffffu, here));
  }
  const unsigned m_lo = __reduce_or_sync(0xffffffffu, (unsigned)m);
  const unsigned m_hi = __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
  m = ((unsigned long long)m_hi << 32) | m_lo;
  if (lane == 0) {
    masks[p] = m;
    live[p] = p_live;
    counts[p] = __popcll(m);
  }
  if constexpr (SLAB) {
    const int end = min(T, S - slot0);
    for (int s = 0; s < end; ++s) {
      if ((m >> s) & 1ull) continue;
      float4* row =
          reinterpret_cast<float4*>(dx + ((size_t)g * S + slot0 + s) * C1);
      for (int c = lane; c < C1 / 4; c += 32)
        row[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else if (sh.nseg == 1 ? m == 0 : slot0 == 0) {
    float4* row = reinterpret_cast<float4*>(dcenter + g * C1);
    for (int c = lane; c < C1 / 4; c += 32)
      row[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// cum[p] = counts[0] + ... + counts[p], in one block: each thread sums a
// contiguous run of the parts, the block scans the runs' sums, each thread
// writes its run's prefix sums.
constexpr int kScanThreads = 1024;
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, long long n,
            long long* __restrict__ cum) {
  __shared__ long long part[kScanThreads];
  const int t = threadIdx.x;
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long lo = t * per, hi = min(n, lo + per);
  long long s = 0;
  for (long long i = lo; i < hi; ++i) s += counts[i];
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan
    const long long v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - s;
  for (long long i = lo; i < hi; ++i) {
    run += counts[i];
    cum[i] = run;
  }
}

// The blocks that take part and the reached rows each takes: about an
// equal share of the plan's rows, at least a tile's worth, so a small
// problem runs on few blocks with whole tiles.
struct Split {
  long long target;  // rows per block
  long long active;  // blocks with parts
};

__device__ __forceinline__ Split split_rows(const long long* __restrict__ cum,
                                            long long nparts, int blocks,
                                            int T) {
  const long long total = cum[nparts - 1];
  long long target = (total + blocks - 1) / blocks;
  if (target < T) target = T;
  return Split{target, (total + target - 1) / target};
}

// The first part of block k: the first part whose rows before it reach
// k·target, at a group's first part.
__device__ __forceinline__ long long cut(const long long* __restrict__ cum,
                                         long long nparts, int nseg,
                                         long long at) {
  if (at <= 0) return 0;
  long long lo = 0, hi = nparts;  // the first q with cum[q] >= at
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (cum[mid] < at) lo = mid + 1;
    else hi = mid;
  }
  const long long p = (lo + 1 + nseg - 1) / nseg * nseg;
  return p < nparts ? p : nparts;
}

// TM: tile rows per warp (T = 8·TM); NBUF: tile buffers of copied rows (2:
// the next tile's copy overlaps this one's products); TN3 > 0: the shipped
// widths compiled in.
template <int TM, int NBUF, bool SLAB, int TN3, typename Tin>
__global__ void __launch_bounds__(kThreads, 1)
fused_sa_routed_bwd_kernel(const Tin* __restrict__ src,
                           const int* __restrict__ idx,
                           const Tin* __restrict__ center,
                           const float* __restrict__ w1,
                           const float* __restrict__ w1t,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2t,
                           const float* __restrict__ dval,
                           const int* __restrict__ argmax, const Shape sh,
                           const unsigned long long* __restrict__ masks,
                           const int* __restrict__ live,
                           const long long* __restrict__ cum,
                           long long nparts, float* __restrict__ dx,
                           float* __restrict__ dcenter,
                           float* __restrict__ wsall) {
  constexpr int T = 8 * TM;
  const int C1 = TN3 ? 128 : sh.C1, C2 = TN3 ? 128 : sh.C2;
  const int C3 = TN3 ? 32 * TN3 : sh.C3;
  const int S = sh.S;
  __shared__ long long range[2];
  const int tid = threadIdx.x;
  if (tid == 0) {
    const Split sp = split_rows(cum, nparts, gridDim.x, T);
    const long long k = blockIdx.x;
    range[0] = k < sp.active ? cut(cum, nparts, sh.nseg, k * sp.target) : -1;
    range[1] = k + 1 < sp.active
                   ? cut(cum, nparts, sh.nseg, (k + 1) * sp.target) : nparts;
  }
  __syncthreads();
  if (range[0] < 0) return;  // no rows left for this block
  const long long p0 = range[0], p1 = range[1];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Buffers b;
  b.plans = reinterpret_cast<Plan*>(smem_raw);
  b.X0 = reinterpret_cast<float*>(smem_raw + 2 * sizeof(Plan));
  b.A1 = b.X0 + NBUF * T * C1;
  b.DA = b.A1 + T * C2;
  float* next = b.DA + da_floats(T, C1, C2);
  b.SC = b.DA;  // the dense routing's scratch: DA itself at C2 = 128
  if (!scratch_in_da(T, C1, C2)) {
    b.SC = next;
    next += scratch_floats(T);
  }
  const size_t per = (size_t)C1 * C2 + (size_t)C3 * C2 + C2;
  float* ws = wsall + (size_t)blockIdx.x * per;
  if (sh.dw2_shared) {
    b.DW2 = next;
    next += (size_t)C3 * C2;
  } else {
    b.DW2 = ws + (size_t)C1 * C2;
  }
  b.scan = reinterpret_cast<unsigned long long*>(next);
  b.scan_live = reinterpret_cast<int*>(b.scan + kWarps);

  const bool narrow = TN3 ? true : sh.narrow;
  float gw1[8][8];
  float gb1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    gb1[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) gw1[i][j] = 0.0f;
  }
  for (size_t e = tid; e < (size_t)C3 * C2; e += kThreads) b.DW2[e] = 0.0f;
  if (!narrow) {  // dW1 and db1 are added into the slice tile by tile
    for (size_t e = tid; e < (size_t)C1 * C2; e += kThreads) ws[e] = 0.0f;
    for (int e = tid; e < C2; e += kThreads) ws[per - C2 + e] = 0.0f;
  }

  // Tiles are numbered as they fill; a filled tile's copy is issued at
  // once, and the products of tile t run once its copy may be awaited:
  // while the next tile fills (NBUF 2), or at once (NBUF 1). The products
  // have one call site, so the kernel holds one copy of their code.
  int tile = 0, done = 0, rows = 0, np = 0, live_t = 0;
  for (long long c0 = p0;; c0 += kWarps) {
    const bool last = c0 >= p1;  // no part left: fill nothing, drain
    if (!last) {  // the next eight parts' plans
      if (tid < kWarps) {
        const long long p = c0 + tid;
        b.scan[tid] = p < p1 ? masks[p] : 0ull;
        b.scan_live[tid] = p < p1 ? live[p] : 0;
      }
      __syncthreads();
    }
    for (int w = 0; w < (last ? 1 : kWarps); ++w) {
      const unsigned long long pm = last ? 0ull : b.scan[w];
      const int cnt = __popcll(pm);
      if (last ? rows > 0 : (pm != 0 && rows + cnt > T)) {
        // the tile is full (or the last): copy its rows
        Plan& P = b.plans[tile & 1];
        if (tid == 0) {
          P.rows = rows;
          P.parts = np;
          P.live = live_t;
        }
        __syncthreads();  // the plan is complete
        issue_copy<SLAB, Tin>(P, src, sh, b.X0 + (tile % NBUF) * T * C1);
        ++tile;
        rows = np = live_t = 0;
      }
      while (done < tile - (last ? 0 : NBUF - 1)) {
        if (last || NBUF == 1) cp_async_wait<0>();
        else cp_async_wait<NBUF - 1>();
        __syncthreads();  // every thread's copies of the tile have landed
        tile_products<TM, SLAB, TN3, Tin>(
            b.plans[done & 1], b.X0 + (done % NBUF) * T * C1, b, sh, center,
            w1, w1t, b1, w2t, dval, argmax, gw1, gb1, ws, dx, dcenter);
        ++done;
      }
      if (pm == 0) continue;
      Plan& P = b.plans[tile & 1];  // add the part, whole, to the tile
      const long long pw = c0 + w;
      const long long g = pw / sh.nseg;
      const int slot0 = (int)(pw - g * sh.nseg) * T;
      if (tid < T && ((pm >> tid) & 1ull)) {
        const int r = rows + __popcll(pm & ((1ull << tid) - 1ull));
        if constexpr (SLAB) {
          P.point[r] = slot0 + tid;
        } else {
          const int p = idx[g * S + slot0 + tid];
          if ((unsigned)p >= (unsigned)sh.N) __trap();  // an id outside
          P.point[r] = p;
        }
        P.row_part[r] = (unsigned char)np;
      }
      if (tid == 0) {
        P.mask[np] = pm;
        P.group[np] = (int)g;
        P.slot0[np] = slot0;
        P.base[np] = (unsigned char)rows;
        if (np == 0) P.row0 = pw > 0 ? (int)cum[pw - 1] : 0;
      }
      rows += cnt;
      live_t += b.scan_live[w];
      ++np;
    }
    if (last) break;
    __syncthreads();  // scan[] is rewritten by the next eight parts
  }
  __syncthreads();  // DW2 complete
  if (narrow)
    store_dw1<false>(gw1, gb1, ws, ws + per - C2, C2, 0, 0, true);
  if (sh.dw2_shared)
    for (size_t e = tid; e < (size_t)C3 * C2; e += kThreads)
      ws[(size_t)C1 * C2 + e] = b.DW2[e];
}

// out[e] = the sum of the active blocks' partials, in block order
__global__ void reduce_active(const float* __restrict__ ws, int blocks,
                              long long per, const long long* __restrict__ cum,
                              long long nparts, int T,
                              float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per) return;
  const Split sp = split_rows(cum, nparts, blocks, T);
  float s = 0.0f;
  for (long long p = 0; p < sp.active; ++p) s += ws[p * per + e];
  out[e] = s;
}

// bytes of a launch's shared memory
size_t smem_bytes(int TM, int NBUF, int C1, int C2, int C3, bool dw2_shared) {
  const size_t T = 8 * TM;
  size_t floats = NBUF * T * C1 + T * C2 + da_floats((int)T, C1, C2);
  if (!scratch_in_da((int)T, C1, C2)) floats += scratch_floats((int)T);
  if (dw2_shared) floats += (size_t)C3 * C2;
  return 2 * sizeof(Plan) + sizeof(float) * floats
         + (sizeof(unsigned long long) + sizeof(int)) * kWarps;
}

// the kernel's static shared memory (its part range), beside the dynamic
constexpr size_t kStaticSmem = 2 * sizeof(long long);

// The launch's tile rows per warp, tile buffers and dW2's place: the
// first of (TM, NBUF, dW2 in shared memory) = (8, 2, yes), (8, 1, yes),
// then each TM of 8, 4, 2, 1 with dW2 in the workspace, two buffers before
// one, that fits in shared memory. -> false where none fits.
bool plan_launch(int C1, int C2, int C3, int* tm, int* nbuf,
                 bool* dw2_shared) {
  for (int nb = 2; nb >= 1; --nb)
    if (smem_bytes(8, nb, C1, C2, C3, true) + kStaticSmem <= kSmemMax) {
      *tm = 8, *nbuf = nb, *dw2_shared = true;
      return true;
    }
  for (int t = 8; t >= 1; t /= 2)
    for (int nb = 2; nb >= 1; --nb)
      if (smem_bytes(t, nb, C1, C2, C3, false) + kStaticSmem <= kSmemMax) {
        *tm = t, *nbuf = nb, *dw2_shared = false;
        return true;
      }
  return false;
}

// The pointers of one launch's plan, carved from the caller's scratch:
// masks, prefix sums (8 bytes a part), live channels, reached slots (4).
struct PlanBufs {
  unsigned long long* masks;
  long long* cum;
  int* live;
  int* counts;
};

PlanBufs plan_bufs(void* scratch, long long nparts) {
  unsigned char* p = static_cast<unsigned char*>(scratch);
  return PlanBufs{reinterpret_cast<unsigned long long*>(p),
                  reinterpret_cast<long long*>(p + 8 * nparts),
                  reinterpret_cast<int*>(p + 16 * nparts),
                  reinterpret_cast<int*>(p + 20 * nparts)};
}

struct Launch {
  const void* src;  // f32, or bf16 in the bf16 form (as center)
  const int* idx;
  const void* center;
  const float* w1;
  const float* w1t;
  const float* b1;
  const float* w2t;
  const float* dval;
  const int* argmax;
  float* dx;
  float* dcenter;
  float* ws;
};

template <int TM, int NBUF, bool SLAB, int TN3, typename Tin>
cudaError_t launch_tm(const Launch& l, const Shape& sh, const PlanBufs& pb,
                      long long nparts, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(TM, NBUF, sh.C1, sh.C2, sh.C3,
                                 sh.dw2_shared);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_routed_bwd_kernel<TM, NBUF, SLAB, TN3, Tin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_sa_routed_bwd_kernel<TM, NBUF, SLAB, TN3, Tin>
      <<<blocks, kThreads, smem, stream>>>(
          static_cast<const Tin*>(l.src), l.idx,
          static_cast<const Tin*>(l.center), l.w1, l.w1t, l.b1, l.w2t,
          l.dval, l.argmax, sh, pb.masks, pb.live, pb.cum, nparts, l.dx,
          l.dcenter, l.ws);
  return cudaGetLastError();
}

template <bool SLAB, typename Tin>
cudaError_t launch_routed(int tm, int nbuf, const Launch& l, const Shape& sh,
                          const PlanBufs& pb, long long nparts, int blocks,
                          cudaStream_t stream) {
  if (sh.C1 == 128 && sh.C2 == 128 && tm == 8) {  // the shipped widths
    if (sh.C3 == 128 && nbuf == 2)
      return launch_tm<8, 2, SLAB, 4, Tin>(l, sh, pb, nparts, blocks, stream);
    if (sh.C3 == 256 && nbuf == 1)
      return launch_tm<8, 1, SLAB, 8, Tin>(l, sh, pb, nparts, blocks, stream);
  }
#define ROUTED_CASE(TM, NB)                                          \
  if (tm == TM && nbuf == NB)                                        \
    return launch_tm<TM, NB, SLAB, 0, Tin>(l, sh, pb, nparts, blocks,  \
                                           stream);
  ROUTED_CASE(8, 2)
  ROUTED_CASE(8, 1)
  ROUTED_CASE(4, 2)
  ROUTED_CASE(4, 1)
  ROUTED_CASE(2, 2)
  ROUTED_CASE(2, 1)
  ROUTED_CASE(1, 2)
  ROUTED_CASE(1, 1)
#undef ROUTED_CASE
  return cudaErrorInvalidValue;
}

long long per_floats(int C1, int C2, int C3) {
  return (long long)C1 * C2 + (long long)C3 * C2 + C2;
}

int bwd_blocks(long long groups, long long per) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = 4LL * sms;
  const long long fit = kWorkspaceMax / (per * (long long)sizeof(float));
  if (want > fit) want = fit > 1 ? fit : 1;
  const long long per_block = (groups + want - 1) / want;
  return (int)((groups + per_block - 1) / per_block);
}

// The launch's shape, or false where the kernels do not take it.
bool shape_of(int N, int M, int S, int C1, int C2, int C3, long long groups,
              bool slab, Shape* sh, int* tm, int* nbuf) {
  if (M < 1 || (!slab && N < 1) || S < 8 || S % 8 != 0 || C1 < 128
      || C1 % 128 != 0 || C2 < 128 || C2 % 128 != 0 || C3 < 32
      || C3 % 32 != 0 || groups < 1 || groups > 0x7fffffffLL)
    return false;
  bool dw2_shared;
  if (!plan_launch(C1, C2, C3, tm, nbuf, &dw2_shared)) return false;
  const int T = 8 * *tm;
  *sh = Shape{N, M, S, C1, C2, C3, T, (S + T - 1) / T,
              C1 == 128 && C2 == 128, dw2_shared};
  return groups * sh->nseg <= 0x7fffffffLL;
}

// The key m·S + s of batch row b -> its row among the launch's reached rows
// (the plan's prefix sums and the popcount of its part's mask below the
// slot), or -1 where nothing reaches the slot: the reached rows lie in
// ascending (group, slot) order, so ascending keys read them in order.
struct ReachedRow {
  const unsigned long long* masks;
  const long long* cum;
  int M, S, T, nseg;
  __device__ long long operator()(int b, int key) const {
    const int m = key / S, s = key - m * S;
    const int seg = s / T, bit = s - seg * T;
    const long long p = ((long long)b * M + m) * nseg + seg;
    const unsigned long long mk = masks[p];
    if (!((mk >> bit) & 1ull)) return -1;
    return (p > 0 ? cum[p - 1] : 0) + __popcll(mk & ((1ull << bit) - 1ull));
  }
};

// Check the arguments -> the launch's shape, or false.
template <bool SLAB>
bool checked(int R, int N, int M, int S, int C1, int C2, int C3, int blocks,
             Shape* sh, int* tm, int* nbuf) {
  const long long groups = (long long)R * M;
  if (R < 1 || !shape_of(N, M, S, C1, C2, C3, groups, SLAB, sh, tm, nbuf))
    return false;
  // the gather form numbers its reached rows and keys with ints
  if (!SLAB && (groups * S >= INT_MAX || csr::build_smem((long long)M * S) == 0))
    return false;
  return blocks >= 1 && blocks == bwd_blocks(groups, per_floats(C1, C2, C3));
}

// The plan and its prefix sums, into scratch.
template <bool SLAB>
cudaError_t run_plan(const Launch& l, const Shape& sh, long long nparts,
                     const PlanBufs& pb, cudaStream_t stream) {
  plan_kernel<SLAB><<<(unsigned)((nparts * 32 + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(l.dval, l.argmax, sh, nparts,
                                             pb.masks, pb.live, pb.counts,
                                             l.dx, l.dcenter);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<<<1, kScanThreads, 0, stream>>>(pb.counts, nparts, pb.cum);
  return cudaGetLastError();
}

// After the plan: the routed kernel and the reduction of the active blocks'
// slices into grads = [dW1 (C1 x C2) | dW2^T (C3 x C2) | db1 (C2)].
template <bool SLAB, typename Tin>
cudaError_t run_routed(const Launch& l, const Shape& sh, int tm, int nbuf,
                       long long nparts, const PlanBufs& pb, int blocks,
                       float* grads, cudaStream_t stream) {
  cudaError_t err =
      launch_routed<SLAB, Tin>(tm, nbuf, l, sh, pb, nparts, blocks, stream);
  if (err != cudaSuccess) return err;
  const long long per = per_floats(sh.C1, sh.C2, sh.C3);
  reduce_active<<<(unsigned)((per + 255) / 256), 256, 0, stream>>>(
      l.ws, blocks, per, pb.cum, nparts, sh.T, grads);
  return cudaGetLastError();
}

// The gather form after its plan (tpu3d_fused_sa_bwd and its bf16 form):
// the routed kernel, the reduction, the inverse and d_pre's fixed-order sum.
template <typename Tin>
int gather_backward(const Tin* pre, const int* idx, const Tin* center,
                    const float* w1, const float* w1t, const float* b1,
                    const float* w2t, const float* dval, const int* argmax,
                    int R, int N, int M, int S, int C1, int C2, int C3,
                    int blocks, Tin* dpre, float* dcenter, float* ws,
                    void* scratch, float* grads, float* rows, int* inv,
                    long long inv_ints, cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  Shape sh;
  int tm, nbuf;
  if (!checked<false>(R, N, M, S, C1, C2, C3, blocks, &sh, &tm, &nbuf) ||
      inv_ints < csr::inverse_ints(R, N, (long long)M * S))
    return (int)cudaErrorInvalidValue;
  const long long nparts = (long long)R * M * sh.nseg;
  const PlanBufs pb = plan_bufs(scratch, nparts);
  const Launch l{pre, idx, center, w1, w1t, b1, w2t, dval, argmax, rows,
                 dcenter, ws};
  cudaError_t err = run_routed<false, Tin>(l, sh, tm, nbuf, nparts, pb,
                                           blocks, grads, stream);
  if (err != cudaSuccess) return (int)err;
  if ((err = csr::build(idx, R, N, M, S, inv, stream)) != cudaSuccess)
    return (int)err;
  return (int)csr::sum_rows(rows, R, N, C1, inv, dpre,
                            ReachedRow{pb.masks, pb.cum, M, S, sh.T, sh.nseg},
                            stream);
}

// The slab form, plan included (tpu3d_fused_sa_slab_bwd and its bf16 form).
template <typename Tin>
int slab_backward(const Tin* x0, const float* w1, const float* w1t,
                  const float* b1, const float* w2t, const float* dval,
                  const int* argmax, int R, int M, int S, int C1, int C2,
                  int C3, int blocks, float* dx0, float* ws, void* scratch,
                  float* grads, cudaStream_t stream) {
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  Shape sh;
  int tm, nbuf;
  if (!checked<true>(R, 0, M, S, C1, C2, C3, blocks, &sh, &tm, &nbuf))
    return (int)cudaErrorInvalidValue;
  const long long nparts = (long long)R * M * sh.nseg;
  const PlanBufs pb = plan_bufs(scratch, nparts);
  const Launch l{x0, nullptr, nullptr, w1, w1t, b1, w2t, dval, argmax, dx0,
                 nullptr, ws};
  cudaError_t err = run_plan<true>(l, sh, nparts, pb, stream);
  if (err == cudaSuccess)
    err = run_routed<true, Tin>(l, sh, tm, nbuf, nparts, pb, blocks, grads,
                                stream);
  return (int)err;
}

}  // namespace
