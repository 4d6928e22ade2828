// Backward of the fused grouped gather + two-layer MLP + max-pool (no
// BatchNorm), for Hopper (sm_90a), in the forward's two forms.
//
// The gather form replaces tpu3d/ops/fused_sa.py::_nobn2_bwd_kernel (the
// VJP of fused_gathered_mlp_pool(train=True), :926-945); the slab form
// replaces _nobn_bwd_kernel (the VJP of fused_mlp_pool, :666-688), whose
// x0 is read from the grouped slab and whose d_x0 is the slab's gradient,
// stored row by row: each slot owns its slab row, so there are no atomics
// and no d_center (autograd takes the slab's gradient on to pre and
// center through the grouping). Inputs: the forward's
// inputs, dval (R, M, C3) = the pooled gradient where the pooled channel's
// pre-ReLU value is > 0 (else 0), and the forward's first argmax slot of
// each channel. Per (row, center) group: x0 = pre[idx] - center (or the
// slab's rows), x1 recomputed, dval routed to the argmax slot of each
// channel (d_x2), and then
//   d_a1 = d_x2 W2^T,  d_x1 = d_a1 [x1 > 0],  d_a0 = d_x1 W1^T,
//   d_x0 = d_a0 [x0 > 0],  d_center = -sum_s d_x0,
//   d_pre[row, idx[s]] += d_x0[s],
//   dW2 += a1^T d_x2,  dW1 += a0^T d_x1,  db1 += sum_s d_x1.
// All in f32 (the TPU kernel feeds bf16 to its MXU); db2 is the sum of dval,
// taken by the caller.
//
// Bound on the card: operations. d_x2 has exactly one non-zero slot per
// live channel, so d_a1 and dW2 cost C2 x C3 per group, and only the slots
// that some live channel routes to (the group's "reached" slots) have a
// non-zero d_x1, and so a dW1 / db1 term, a d_x0 and a d_center term. What
// is left is three products of layer 1's size per reached slot (the
// recomputed x1, d_a0 and dW1: 3 x 2 x C1 x C2 operations). The seeded
// default train step reaches 1.7% of SA_0's slots. x2 is never recomputed:
// the forward's argmax and the sign of its pre-ReLU value say all the
// backward needs of layer 2.
//
// Design of the gather form (fused_sa_routed_bwd_kernel). A persistent grid
// (about four blocks per SM) walks contiguous runs of groups, so the weight
// gradients are summed in the block across many groups: dW1 in registers
// (each thread an 8 x 8 tile), db1 in registers, dW2 in shared memory
// (transposed, C3 x C2). Each block writes its sums once to a workspace, and
// a second kernel adds the blocks' partials in a fixed order, so the weight
// gradients come out the same from run to run.
//
// The plan. The block scans its groups eight at a time, one warp each: the
// S-bit mask of the slots its live channels route to (dval != 0 at
// argmax), OR-reduced over the warp, and its count of live channels; a
// group with no reached slot gets d_center = 0 at once. Reached slots are
// packed, whole groups at a time and in slot order, into tiles of up to 64
// rows (a group has at most S <= 64 reached slots, so it always fits an
// empty tile and is never split); a row's place in its group is the
// popcount of the mask below its slot. A full tile's rows pre[row, idx] are
// gathered with cp.async into shared memory; with C3 = 128 the tile buffer
// is doubled, so the next tile's gather is in flight while this one's
// products run (at C3 = 256 the block's dW2, 128 KB, leaves room for one).
// The products of a tile have one call site, so the kernel holds one copy
// of their code.
//
// The products of a tile. x0 = ReLU(pre - center); x1 recomputed with a
// register-tiled dense layer (routed_dense: W1 staged a 32-row slice at a
// time, the next slice's loads in flight during this slice's products;
// warps whose rows all lie past the tile's skip the products). Then the
// routing, chosen by the tile's live channels. A dense tile (more than 1/8
// of its 64 x C3 routing matrix D live: most channels live and a few
// reached slots per group, as seeded weights give) takes d_a1 = D W2^T with
// the dense layer and dW2^T += D^T a1 as a register-tiled product, over
// 64-channel chunks of D staged in shared memory. A sparse tile (a few
// channels per row, as when every slot is reached) takes each group's
// channels from one load per lane by shuffles, eight at a time; every
// thread scatters dval W2^T into d_a1 at the rows of one parity and adds
// a1[row] dval into dW2 for the channels of one parity (column c2 each).
// Each sum is one thread's, in a fixed order, either way. d_x1 overwrites
// a1 in place, dW1 / db1 take a0^T d_x1 over the tile's rows, and d_a0 is
// the dense layer again with W1^T; d_x0 leaves the registers as float
// atomics into d_pre (pooled rows repeat ids, so the atomics cannot be
// plain stores) and through shared memory into d_center, summed over each
// group's rows in order. When every slot is reached (the worst case), a
// tile holds one group of about S rows, and the work is the dense kernel's
// plus the plan.
//
// The slab form (fused_sa_slab_bwd_kernel) keeps the dense walk: one S-row
// slab per group, layer 1 recomputed on every slot, d_x0 one float4 store
// per thread and slab row.
// Widths: C1 = C2 = 128 (the RCNN's SA levels), C3 128 or 256, S 16/32/64.

#include <cuda_runtime.h>

#include "fused_sa_common.cuh"

namespace {

using fused_sa::dense;
using fused_sa::kKC;
using fused_sa::kThreads;
using fused_sa::kWarps;
using fused_sa::load_x0;

constexpr int C1 = 128;
constexpr int C2 = 128;

__host__ __device__ constexpr int da_floats(int S) {
  return S * C2 > kKC * 128 ? S * C2 : kKC * 128;
}

// The dense walk of the slab form: x0 is the (R, M, S, C1) slab and dx0
// its gradient.
template <int TM, int TN3>
__global__ void __launch_bounds__(kThreads, 1)
fused_sa_slab_bwd_kernel(const float* __restrict__ x0,
                         const float* __restrict__ w1,
                         const float* __restrict__ w1t,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2t,
                         const float* __restrict__ dval,
                         const int* __restrict__ argmax, long long groups,
                         int per_block, float* __restrict__ dx0,
                         float* __restrict__ ws) {
  constexpr int S = kWarps * TM;
  constexpr int C3 = 32 * TN3;
  extern __shared__ float smem[];
  float* A0 = smem;                 // S x C1: a0 = ReLU(x0)
  float* A1 = A0 + S * C1;          // S x C2: a1, then d_x1
  float* DA = A1 + S * C2;          // d_a1; the weight slices
  float* DW2 = DA + da_floats(S);   // C3 x C2: this block's dW2, transposed
  float* dv = DW2 + C3 * C2;        // C3: dval of the group
  int* ag = reinterpret_cast<int*>(dv + C3);  // C3: argmax of the group

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // this thread's dW1 tile: rows c1 = 4*hi + r and 64 + 4*hi + r, columns
  // c2 = 4*lo + r and 64 + 4*lo + r (r < 4), so that neighbouring threads
  // read neighbouring 16 bytes of shared memory
  const int hi = tid >> 4, lo = tid & 15;
  float gw1[8][8];
  float gb1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    gb1[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) gw1[i][j] = 0.0f;
  }
  for (int e = tid; e < C3 * C2; e += kThreads) DW2[e] = 0.0f;

  const long long g0 = (long long)blockIdx.x * per_block;
  const long long g1 = min(groups, g0 + per_block);
  for (long long g = g0; g < g1; ++g) {
    __syncthreads();  // the previous group is done with every buffer
    for (int c = tid; c < C3; c += kThreads) {
      dv[c] = dval[g * C3 + c];
      ag[c] = argmax[g * C3 + c];
    }
    load_x0<false>(x0, nullptr, nullptr, (size_t)g, S, C1, A0);
    {  // recompute a1 = ReLU(a0 W1 + b1) into A1
      float acc[TM][4];
      dense<TM, 4>(A0, C1, w1, DA, acc);
      const int col = 4 * lane;
      const float4 b = *reinterpret_cast<const float4*>(b1 + col);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(A1 + (warp * TM + i) * C2 + col) =
            make_float4(fmaxf(acc[i][0] + b.x, 0.0f),
                        fmaxf(acc[i][1] + b.y, 0.0f),
                        fmaxf(acc[i][2] + b.z, 0.0f),
                        fmaxf(acc[i][3] + b.w, 0.0f));
    }
    __syncthreads();  // A1 complete, every warp done with the weight slices
    for (int e = tid; e < S * C2; e += kThreads) DA[e] = 0.0f;
    __syncthreads();
    if (tid < C2) {  // d_a1[argmax[c3], c2] += dval[c3] W2[c2, c3]
      const int c2 = tid;
      for (int c3 = 0; c3 < C3; ++c3) {
        const float d = dv[c3];
        if (d != 0.0f) DA[ag[c3] * C2 + c2] += d * w2t[c3 * C2 + c2];
      }
    } else {  // dW2[c2, c3] += a1[argmax[c3], c2] dval[c3]
      const int c2 = tid - C2;
      for (int c3 = 0; c3 < C3; ++c3) {
        const float d = dv[c3];
        if (d != 0.0f) DW2[c3 * C2 + c2] += A1[ag[c3] * C2 + c2] * d;
      }
    }
    __syncthreads();
    for (int e = tid; e < S * C2; e += kThreads)  // d_x1, in place of a1
      A1[e] = A1[e] > 0.0f ? DA[e] : 0.0f;
    __syncthreads();
    for (int s = 0; s < S; ++s) {  // dW1 += a0^T d_x1, db1 += sum d_x1
      const float4 a_lo = *reinterpret_cast<const float4*>(A0 + s * C1 + 4 * hi);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(A0 + s * C1 + 64 + 4 * hi);
      const float4 d_lo = *reinterpret_cast<const float4*>(A1 + s * C2 + 4 * lo);
      const float4 d_hi =
          *reinterpret_cast<const float4*>(A1 + s * C2 + 64 + 4 * lo);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float d[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w,
                          d_hi.x, d_hi.y, d_hi.z, d_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) gw1[i][j] += a[i] * d[j];
      if (hi == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) gb1[j] += d[j];
      }
    }
    {  // d_a0 = d_x1 W1^T; d_x0 = d_a0 [a0 > 0], the slab's gradient
      float acc[TM][4];
      dense<TM, 4>(A1, C2, w1t, DA, acc);
      const int col = 4 * lane;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int s = warp * TM + i;
        const float4 a = *reinterpret_cast<const float4*>(A0 + s * C1 + col);
        *reinterpret_cast<float4*>(dx0 + ((size_t)g * S + s) * C1 + col) =
            make_float4(a.x > 0.0f ? acc[i][0] : 0.0f,
                        a.y > 0.0f ? acc[i][1] : 0.0f,
                        a.z > 0.0f ? acc[i][2] : 0.0f,
                        a.w > 0.0f ? acc[i][3] : 0.0f);
      }
    }  // the next group's barrier orders the weight slices
  }
  __syncthreads();  // DW2 complete
  const size_t per = (size_t)C1 * C2 + (size_t)C3 * C2 + C2;
  float* out = ws + (size_t)blockIdx.x * per;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c1 = i < 4 ? 4 * hi + i : 64 + 4 * hi + (i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c2 = j < 4 ? 4 * lo + j : 64 + 4 * lo + (j - 4);
      out[c1 * C2 + c2] = gw1[i][j];
    }
  }
  for (int e = tid; e < C3 * C2; e += kThreads) out[C1 * C2 + e] = DW2[e];
  if (hi == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c2 = j < 4 ? 4 * lo + j : 64 + 4 * lo + (j - 4);
      out[C1 * C2 + C3 * C2 + c2] = gb1[j];
    }
  }
}

// ------------------------------------------------------------------------
// the gather form: only the reached slots (see the note at the top)

constexpr int kTile = 64;              // rows of a routed tile
constexpr int kChunk = 64;             // channels of a dense tile's D chunk
// a tile routes its channels as products when more than 1/kDenseRouting
// of its kTile x C3 routing matrix is live
constexpr int kDenseRouting = 8;
constexpr int kTM = kTile / kWarps;    // tile rows per warp in dense()

// One tile: its groups (reached-slot mask, group id, first row) and its
// rows (point id into the batch row's N points, the row's group).
struct Plan {
  unsigned long long mask[kTile];
  int group[kTile];
  int base[kTile];
  int point[kTile];
  unsigned char row_group[kTile];
  int rows, groups;
  int live;    // the tile's live channels (dval != 0), over its groups
  int pad;     // keeps sizeof a multiple of 16 (the float buffers follow)
};
static_assert(sizeof(Plan) % 16 == 0, "Plan must keep 16-byte alignment");

// acc (+)= X W for a tile's rows, as fused_sa::dense computes it (each
// thread rows warp*kTM + i, columns 4*lane + q; W is cin x 128, staged
// kKC rows at a time through wbuf), with two changes for the routed walk:
// each thread's share of the next slice is loaded into registers while
// the current slice's products run, so a tile waits for the weights once,
// not once per slice; and a warp whose rows all lie at or past `rows`
// only stages. Begins with a block barrier; the caller needs another one
// before it reuses wbuf.
template <bool ACCUM>
__device__ __forceinline__ void routed_dense(const float* __restrict__ X,
                                             int cin,
                                             const float* __restrict__ W,
                                             float* __restrict__ wbuf,
                                             float (&acc)[kTM][4], int rows) {
  constexpr int kSlice = kKC * 128 / 4;  // float4s of one staged slice
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool idle = warp * kTM >= rows;
  if constexpr (!ACCUM) {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][t] = 0.0f;
  }
  float4 next[kSlice / kThreads];
#pragma unroll
  for (int q = 0; q < kSlice / kThreads; ++q)
    next[q] = reinterpret_cast<const float4*>(W)[threadIdx.x + q * kThreads];
  for (int k0 = 0; k0 < cin; k0 += kKC) {
    __syncthreads();  // every warp is done with the previous slice
#pragma unroll
    for (int q = 0; q < kSlice / kThreads; ++q)
      reinterpret_cast<float4*>(wbuf)[threadIdx.x + q * kThreads] = next[q];
    if (k0 + kKC < cin) {
      const float4* src =
          reinterpret_cast<const float4*>(W + (size_t)(k0 + kKC) * 128);
#pragma unroll
      for (int q = 0; q < kSlice / kThreads; ++q)
        next[q] = src[threadIdx.x + q * kThreads];
    }
    __syncthreads();
    if (idle) continue;
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            X + (warp * kTM + i) * cin + k0 + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(wbuf + (kk + j) * 128 + 4 * lane);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
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

// The row of slot s among its group's reached slots, in slot order.
__device__ __forceinline__ int slot_row(const Plan& P, int gl, int s) {
  return P.base[gl] + __popcll(P.mask[gl] & ((1ull << s) - 1ull));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Gather plan P's rows pre[row, point] into X with cp.async, one commit.
__device__ __forceinline__ void issue_gather(const Plan& P,
                                             const float* __restrict__ pre,
                                             int N, int M, float* X) {
  for (int q = threadIdx.x; q < P.rows * (C1 / 4); q += kThreads) {
    const int r = q / (C1 / 4), c = q - r * (C1 / 4);
    const int batch_row = P.group[P.row_group[r]] / M;
    cp_async16(X + r * C1 + 4 * c,
               pre + ((size_t)batch_row * N + P.point[r]) * C1 + 4 * c);
  }
  cp_async_commit();
}

// The products of one gathered tile (X holds its pre rows), into the
// block's sums gw1, gb1 and DW2, d_pre and d_center.
template <int TN3>
__device__ __forceinline__ void tile_products(
    const Plan& P, float* X, float* A1, float* DA, float* DW2,
    const float* __restrict__ center, const float* __restrict__ w1,
    const float* __restrict__ w1t, const float* __restrict__ b1,
    const float* __restrict__ w2t, const float* __restrict__ dval,
    const int* __restrict__ argmax, int N, int M, float (&gw1)[8][8],
    float (&gb1)[8], float* __restrict__ dpre, float* __restrict__ dcenter) {
  constexpr int C3 = 32 * TN3;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hi = tid >> 4, lo = tid & 15;
  const int rows = P.rows, ng = P.groups;
  // x0 = ReLU(pre - center) in place; the rows past the tile's are zero
  for (int e = tid; e < kTile * C1 / 4; e += kThreads) {
    const int r = e / (C1 / 4), c = e - r * (C1 / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows) {
      const float4 x = reinterpret_cast<const float4*>(X)[e];
      const float4 k = reinterpret_cast<const float4*>(
          center + (size_t)P.group[P.row_group[r]] * C1)[c];
      v = make_float4(fmaxf(x.x - k.x, 0.0f), fmaxf(x.y - k.y, 0.0f),
                      fmaxf(x.z - k.z, 0.0f), fmaxf(x.w - k.w, 0.0f));
    }
    reinterpret_cast<float4*>(X)[e] = v;
  }
  const int col = 4 * lane;
  {  // a1 = ReLU(a0 W1 + b1) into A1; DA stages W1's slices, then is zeroed
    float acc[kTM][4];
    routed_dense<false>(X, C1, w1, DA, acc, rows);
    const float4 b = *reinterpret_cast<const float4*>(b1 + col);
    __syncthreads();  // every warp is done with the weight slices
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = warp * kTM + i;
      *reinterpret_cast<float4*>(A1 + r * C2 + col) =
          make_float4(fmaxf(acc[i][0] + b.x, 0.0f),
                      fmaxf(acc[i][1] + b.y, 0.0f),
                      fmaxf(acc[i][2] + b.z, 0.0f),
                      fmaxf(acc[i][3] + b.w, 0.0f));
      *reinterpret_cast<float4*>(DA + r * C2 + col) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncthreads();
  if (P.live * kDenseRouting > kTile * C3) {
    // a dense tile (most channels live, a few rows per group): d_a1 =
    // D W2^T and dW2^T += D^T a1 as products over the routing matrix D
    // (kTile x C3, dval at each live channel's row), 64 channels at a time
    // staged in half of DA while its other half stages W2^T's slices; d_a1
    // stays in registers across the chunks
    float* D = DA + kTile * kChunk;
    float acc[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    const int tj = tid >> 4, tc = tid & 15;
    for (int c0 = 0; c0 < C3; c0 += kChunk) {
      for (int e = tid; e < kTile * kChunk; e += kThreads) D[e] = 0.0f;
      __syncthreads();
      for (int e = tid; e < ng * kChunk; e += kThreads) {
        const int gl = e / kChunk, j = e - gl * kChunk;
        const size_t at = (size_t)P.group[gl] * C3 + c0 + j;
        const float d = dval[at];
        if (d != 0.0f)
          D[slot_row(P, gl, argmax[at]) * kChunk + j] = d;
      }
      routed_dense<true>(D, kChunk, w2t + (size_t)c0 * C2, DA, acc, rows);
      // dW2^T[c0 + 4 tj + i, c2] += sum_r D[r, 4 tj + i] a1[r, c2], c2 =
      // 4 tc + q and 64 + 4 tc + q
      float g2[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) g2[i][q] = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float4 dd = *reinterpret_cast<const float4*>(
            D + r * kChunk + 4 * tj);
        const float4 a_lo =
            *reinterpret_cast<const float4*>(A1 + r * C2 + 4 * tc);
        const float4 a_hi =
            *reinterpret_cast<const float4*>(A1 + r * C2 + 64 + 4 * tc);
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
          DW2[(c0 + 4 * tj + i) * C2 + (q < 4 ? 4 * tc + q : 60 + 4 * tc + q)]
              += g2[i][q];
      __syncthreads();  // D and the weight slices are free
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      *reinterpret_cast<float4*>(DA + (warp * kTM + i) * C2 + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
  } else {
    // a sparse tile: the live channels eight at a time, every thread a C2
    // column c2: d_a1[row of argmax[c3], c2] += dval[c3] W2[c2, c3] on the
    // rows of its half's parity, dW2[c2, c3] += a1[row of argmax[c3], c2]
    // dval[c3] on the channels of its half's parity; each sum is one
    // thread's, in channel order, so the results do not depend on timing
    const int c2 = tid & (C2 - 1);
    const int half = tid >> 7;
    for (int gl = 0; gl < ng; ++gl) {
      const size_t g = (size_t)P.group[gl] * C3;
      const unsigned long long m = P.mask[gl];
      const int base = P.base[gl];
      // the group's dval and argmax, one load per lane and TN3 channels
      // each; the loop below takes them from their lanes by shuffles
      float dl[TN3];
      int al[TN3];
#pragma unroll
      for (int v = 0; v < TN3; ++v) {
        dl[v] = dval[g + 32 * v + lane];
        al[v] = argmax[g + 32 * v + lane];
      }
#pragma unroll
      for (int v = 0; v < TN3; ++v) {
        if (!__any_sync(0xffffffffu, dl[v] != 0.0f)) continue;
#pragma unroll
        for (int u0 = 0; u0 < 32; u0 += 8) {
          float d[8];
          int r[8];
          float w[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            d[u] = __shfl_sync(0xffffffffu, dl[v], u0 + u);
            const int a = __shfl_sync(0xffffffffu, al[v], u0 + u);
            r[u] = base + __popcll(m & ((1ull << a) - 1ull));
            const bool mine = d[u] != 0.0f && (r[u] & 1) == half;
            w[u] = mine ? w2t[(32 * v + u0 + u) * C2 + c2] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (d[u] == 0.0f) continue;
            if ((r[u] & 1) == half) DA[r[u] * C2 + c2] += d[u] * w[u];
            if ((u & 1) == half)
              DW2[(32 * v + u0 + u) * C2 + c2] += A1[r[u] * C2 + c2] * d[u];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < kTile * C2; e += kThreads)  // d_x1, in place of a1
    A1[e] = A1[e] > 0.0f ? DA[e] : 0.0f;
  __syncthreads();
  for (int s = 0; s < rows; ++s) {  // dW1 += a0^T d_x1, db1 += sum d_x1
    const float4 a_lo = *reinterpret_cast<const float4*>(X + s * C1 + 4 * hi);
    const float4 a_hi =
        *reinterpret_cast<const float4*>(X + s * C1 + 64 + 4 * hi);
    const float4 d_lo = *reinterpret_cast<const float4*>(A1 + s * C2 + 4 * lo);
    const float4 d_hi =
        *reinterpret_cast<const float4*>(A1 + s * C2 + 64 + 4 * lo);
    const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                        a_hi.x, a_hi.y, a_hi.z, a_hi.w};
    const float d[8] = {d_lo.x, d_lo.y, d_lo.z, d_lo.w,
                        d_hi.x, d_hi.y, d_hi.z, d_hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) gw1[i][j] += a[i] * d[j];
    if (hi == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) gb1[j] += d[j];
    }
  }
  float acc[kTM][4];
  routed_dense<false>(A1, C2, w1t, DA, acc, rows);  // d_a0
  __syncthreads();  // every warp is done with the weight slices in DA
  // d_x0 = d_a0 [x0 > 0]: atomics into d_pre, and into DA for d_center
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = warp * kTM + i;
    const float4 x = *reinterpret_cast<const float4*>(X + r * C1 + col);
    const float v[4] = {x.x > 0.0f ? acc[i][0] : 0.0f,
                        x.y > 0.0f ? acc[i][1] : 0.0f,
                        x.z > 0.0f ? acc[i][2] : 0.0f,
                        x.w > 0.0f ? acc[i][3] : 0.0f};
    *reinterpret_cast<float4*>(DA + r * C1 + col) =
        make_float4(v[0], v[1], v[2], v[3]);
    if (r < rows) {
      const int batch_row = P.group[P.row_group[r]] / M;
      float* dst = dpre + ((size_t)batch_row * N + P.point[r]) * C1 + col;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (v[q] != 0.0f) atomicAdd(dst + q, v[q]);
    }
  }
  __syncthreads();
  // d_center = -sum of d_x0 over each group's rows, in row order
  for (int e = tid; e < ng * C1; e += kThreads) {
    const int gl = e / C1, c = e - gl * C1;
    const int r0 = P.base[gl], r1 = r0 + __popcll(P.mask[gl]);
    float sum = 0.0f;
    for (int r = r0; r < r1; ++r) sum += DA[r * C1 + c];
    dcenter[(size_t)P.group[gl] * C1 + c] = -sum;
  }
  __syncthreads();  // the plan and the buffers are free for the next tile
}

// NBUF: tile buffers of x0 (2: the next tile's gather overlaps this one's
// products)
template <int TN3, int NBUF>
__global__ void __launch_bounds__(kThreads, 1)
fused_sa_routed_bwd_kernel(const float* __restrict__ pre,
                           const int* __restrict__ idx,
                           const float* __restrict__ center,
                           const float* __restrict__ w1,
                           const float* __restrict__ w1t,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2t,
                           const float* __restrict__ dval,
                           const int* __restrict__ argmax, int N, int M, int S,
                           long long groups, int per_block,
                           float* __restrict__ dpre,
                           float* __restrict__ dcenter,
                           float* __restrict__ ws) {
  constexpr int C3 = 32 * TN3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Plan* plans = reinterpret_cast<Plan*>(smem_raw);  // by tile parity
  float* X0 = reinterpret_cast<float*>(smem_raw + 2 * sizeof(Plan));
  float* A1 = X0 + NBUF * kTile * C1;  // a1, then d_x1
  float* DA = A1 + kTile * C2;  // d_a1, d_x0; the weight slices
  float* DW2 = DA + kTile * C2;  // C3 x C2: this block's dW2^T
  unsigned long long* scan =
      reinterpret_cast<unsigned long long*>(DW2 + C3 * C2);
  int* scan_live = reinterpret_cast<int*>(scan + kWarps);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hi = tid >> 4, lo = tid & 15;
  float gw1[8][8];
  float gb1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    gb1[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) gw1[i][j] = 0.0f;
  }
  for (int e = tid; e < C3 * C2; e += kThreads) DW2[e] = 0.0f;

  // Tiles are numbered as they fill; a filled tile's gather is issued at
  // once, and the products of tile t run once its gather may be awaited:
  // while the next tile fills (NBUF 2), or at once (NBUF 1). The products
  // have one call site, so the kernel holds one copy of their code.
  int tile = 0, done = 0, rows = 0, ng = 0, live = 0;
  const long long g0 = (long long)blockIdx.x * per_block;
  const long long g1 = min(groups, g0 + per_block);
  for (long long c0 = g0;; c0 += kWarps) {
    const bool last = c0 >= g1;  // no group left: fill nothing, drain
    if (!last) {
      const long long g = c0 + warp;
      unsigned long long m = 0;
      int g_live = 0;
      if (g < g1) {  // the slots this group's live channels route to
        for (int c = lane; c < C3; c += 32) {
          const float d = dval[g * C3 + c];
          const int a = argmax[g * C3 + c];
          if ((unsigned)a >= (unsigned)S) __trap();  // an argmax outside S
          if (d != 0.0f) m |= 1ull << a;
          g_live += __popc(__ballot_sync(0xffffffffu, d != 0.0f));
        }
        const unsigned m_lo = __reduce_or_sync(0xffffffffu, (unsigned)m);
        const unsigned m_hi =
            __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
        m = ((unsigned long long)m_hi << 32) | m_lo;
        if (m == 0)  // no reached slot: d_center is 0
          reinterpret_cast<float4*>(dcenter + g * C1)[lane] =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      if (lane == 0) {
        scan[warp] = m;
        scan_live[warp] = g_live;
      }
      __syncthreads();
    }
    for (int w = 0; w < (last ? 1 : kWarps); ++w) {
      const unsigned long long gm = last ? 0ull : scan[w];
      const int cnt = __popcll(gm);
      if (last ? rows > 0 : (gm != 0 && rows + cnt > kTile)) {
        // the tile is full (or the last): gather its rows
        Plan& P = plans[tile & 1];
        if (tid == 0) {
          P.rows = rows;
          P.groups = ng;
          P.live = live;
        }
        __syncthreads();  // the plan is complete
        issue_gather(P, pre, N, M, X0 + (tile % NBUF) * kTile * C1);
        ++tile;
        rows = ng = live = 0;
      }
      while (done < tile - (last ? 0 : NBUF - 1)) {
        if (last || NBUF == 1) cp_async_wait<0>();
        else cp_async_wait<NBUF - 1>();
        __syncthreads();  // every thread's copies of the tile have landed
        tile_products<TN3>(plans[done & 1],
                           X0 + (done % NBUF) * kTile * C1, A1, DA, DW2,
                           center, w1, w1t, b1, w2t, dval, argmax, N, M, gw1,
                           gb1, dpre, dcenter);
        ++done;
      }
      if (gm == 0) continue;
      Plan& P = plans[tile & 1];  // add the group, whole, to the tile
      const long long gw = c0 + w;
      if (tid < S && ((gm >> tid) & 1ull)) {
        const int r = rows + __popcll(gm & ((1ull << tid) - 1ull));
        const int p = idx[gw * S + tid];
        if ((unsigned)p >= (unsigned)N) __trap();  // an id outside the row
        P.point[r] = p;
        P.row_group[r] = (unsigned char)ng;
      }
      if (tid == 0) {
        P.mask[ng] = gm;
        P.group[ng] = (int)gw;
        P.base[ng] = rows;
      }
      rows += cnt;
      live += scan_live[w];
      ++ng;
    }
    if (last) break;
    __syncthreads();  // scan[] is rewritten by the next eight groups
  }
  __syncthreads();  // DW2 complete
  const size_t per = (size_t)C1 * C2 + (size_t)C3 * C2 + C2;
  float* out = ws + (size_t)blockIdx.x * per;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c1 = i < 4 ? 4 * hi + i : 64 + 4 * hi + (i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c2 = j < 4 ? 4 * lo + j : 64 + 4 * lo + (j - 4);
      out[c1 * C2 + c2] = gw1[i][j];
    }
  }
  for (int e = tid; e < C3 * C2; e += kThreads) out[C1 * C2 + e] = DW2[e];
  if (hi == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c2 = j < 4 ? 4 * lo + j : 64 + 4 * lo + (j - 4);
      out[C1 * C2 + C3 * C2 + c2] = gb1[j];
    }
  }
}

// out[e] = sum over the blocks' partials, in block order
__global__ void reduce_partials(const float* __restrict__ ws, int parts,
                                int per, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per) return;
  float s = 0.0f;
  for (int p = 0; p < parts; ++p) s += ws[(size_t)p * per + e];
  out[e] = s;
}

cudaError_t reduce(const float* ws, int blocks, int C3, float* grads,
                   cudaStream_t stream) {
  const int per = C1 * C2 + C3 * C2 + C2;
  reduce_partials<<<(per + 255) / 256, 256, 0, stream>>>(ws, blocks, per,
                                                          grads);
  return cudaGetLastError();
}

template <int TM, int TN3>
cudaError_t launch_slab(const float* x0, const float* w1, const float* w1t,
                        const float* b1, const float* w2t, const float* dval,
                        const int* argmax, long long groups, int blocks,
                        int per_block, float* dx0, float* ws, float* grads,
                        cudaStream_t stream) {
  constexpr int S = kWarps * TM;
  constexpr int C3 = 32 * TN3;
  const size_t floats = (size_t)S * C1 + S * C2 + da_floats(S) + C3 * C2
                        + 2 * C3;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_slab_bwd_kernel<TM, TN3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_sa_slab_bwd_kernel<TM, TN3><<<blocks, kThreads, smem, stream>>>(
      x0, w1, w1t, b1, w2t, dval, argmax, groups, per_block, dx0, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(ws, blocks, C3, grads, stream);
}

template <int TN3, int NBUF>
cudaError_t launch_routed(const float* pre, const int* idx,
                          const float* center, const float* w1,
                          const float* w1t, const float* b1, const float* w2t,
                          const float* dval, const int* argmax, int N, int M,
                          int S, long long groups, int blocks, int per_block,
                          float* dpre, float* dcenter, float* ws,
                          float* grads, cudaStream_t stream) {
  constexpr int C3 = 32 * TN3;
  const size_t smem = 2 * sizeof(Plan)
      + sizeof(float) * ((size_t)NBUF * kTile * C1 + 2 * kTile * C2
                         + C3 * C2)
      + (sizeof(unsigned long long) + sizeof(int)) * kWarps;
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_routed_bwd_kernel<TN3, NBUF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_sa_routed_bwd_kernel<TN3, NBUF><<<blocks, kThreads, smem, stream>>>(
      pre, idx, center, w1, w1t, b1, w2t, dval, argmax, N, M, S, groups,
      per_block, dpre, dcenter, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(ws, blocks, C3, grads, stream);
}

int bwd_blocks(long long groups) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = 4LL * sms;
  const long long per_block = (groups + want - 1) / want;
  return (int)((groups + per_block - 1) / per_block);
}

// 0, or the error code of arguments the kernels do not take
int check_args(long long groups, int C3, int blocks) {
  if (groups < 1 || groups > 0x7fffffffLL || (C3 != 128 && C3 != 256) ||
      blocks < 1 || blocks != bwd_blocks(groups))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// The number of blocks either backward launches for R x M groups: about
// four per SM. The caller sizes the workspace from it.
extern "C" int tpu3d_fused_sa_bwd_blocks(long long groups) {
  return bwd_blocks(groups);
}

// pre (R, N, 128), idx (R, M, S), center (R, M, 128), w1 (128, 128) and its
// transpose w1t, b1 (128), w2t (C3, 128) = W2^T, dval and argmax (R, M, C3)
// -> dpre (R, N, 128) (zeroed by the caller; added into), dcenter
// (R, M, 128), grads = [dW1 (128 x 128) | dW2^T (C3 x 128) | db1 (128)];
// ws holds blocks x (128 x 128 + C3 x 128 + 128) floats.
extern "C" int tpu3d_fused_sa_bwd(const float* pre, const int* idx,
                                  const float* center, const float* w1,
                                  const float* w1t, const float* b1,
                                  const float* w2t, const float* dval,
                                  const int* argmax, int R, int N, int M,
                                  int S, int C3, int blocks, float* dpre,
                                  float* dcenter, float* ws, float* grads,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const long long groups = (long long)R * M;
  if (R < 1 || N < 1 || M < 1 || (S != 16 && S != 32 && S != 64))
    return (int)cudaErrorInvalidValue;
  if (const int bad = check_args(groups, C3, blocks)) return bad;
  const int per_block = (int)((groups + blocks - 1) / blocks);
  if (C3 == 128)
    return (int)launch_routed<4, 2>(pre, idx, center, w1, w1t, b1, w2t, dval,
                                    argmax, N, M, S, groups, blocks,
                                    per_block, dpre, dcenter, ws, grads,
                                    stream);
  return (int)launch_routed<8, 1>(pre, idx, center, w1, w1t, b1, w2t, dval,
                                  argmax, N, M, S, groups, blocks, per_block,
                                  dpre, dcenter, ws, grads, stream);
}

// The slab form: x0 (R, M, S, 128) -> dx0 (R, M, S, 128), every entry
// written; the rest as tpu3d_fused_sa_bwd.
extern "C" int tpu3d_fused_sa_slab_bwd(const float* x0, const float* w1,
                                       const float* w1t, const float* b1,
                                       const float* w2t, const float* dval,
                                       const int* argmax, int R, int M, int S,
                                       int C3, int blocks, float* dx0,
                                       float* ws, float* grads,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const long long groups = (long long)R * M;
  if (R < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (const int bad = check_args(groups, C3, blocks)) return bad;
  const int per_block = (int)((groups + blocks - 1) / blocks);
#define SLAB_CASE(TM)                                                       \
  return (int)(C3 == 128                                                    \
                   ? launch_slab<TM, 4>(x0, w1, w1t, b1, w2t, dval, argmax,  \
                                        groups, blocks, per_block, dx0, ws, \
                                        grads, stream)                      \
                   : launch_slab<TM, 8>(x0, w1, w1t, b1, w2t, dval, argmax,  \
                                        groups, blocks, per_block, dx0, ws, \
                                        grads, stream))
  switch (S) {
    case 16:
      SLAB_CASE(2);
    case 32:
      SLAB_CASE(4);
    case 64:
      SLAB_CASE(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SLAB_CASE
}
