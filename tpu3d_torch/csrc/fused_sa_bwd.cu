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
// each channel. Per (row, center) group it regathers x0 = pre[idx] - center,
// recomputes x1, routes dval to the argmax slot of each channel (d_x2),
// and then
//   d_a1 = d_x2 W2^T,  d_x1 = d_a1 [x1 > 0],  d_a0 = d_x1 W1^T,
//   d_x0 = d_a0 [x0 > 0],  d_center = -sum_s d_x0,
//   d_pre[row, idx[s]] += d_x0[s],
//   dW2 += a1^T d_x2,  dW1 += a0^T d_x1,  db1 += sum_s d_x1.
// All in f32 (the TPU kernel feeds bf16 to its MXU); db2 is the sum of dval,
// taken by the caller.
//
// Bound on the card: operations. d_x2 has exactly one non-zero slot per
// channel, so d_a1 and dW2 cost C2 x C3 per group, not S x C2 x C3; what is
// left is three products of layer 1's size per group (the recomputed x1,
// d_a0 and dW1: 3 x 2 x S x C1 x C2 operations), 825 GFLOP at SA_0 of the
// train step (1024 rows of 128 centers of 64 slots), far above the f32
// ridge. x2 is never recomputed: the forward's argmax and the sign of its
// pre-ReLU value say all the backward needs of layer 2.
//
// Design. A block walks a contiguous run of groups (about four blocks per
// SM in all), so the weight gradients are summed in the block across many
// groups: dW1 in registers (each thread an 8 x 8 tile), db1 in registers,
// dW2 in shared memory (transposed, each thread owns one C2 column). Each
// block writes its sums once to a workspace, and a second kernel adds the
// blocks' partials in a fixed order, so the weight gradients come out the
// same from run to run. Per group: the slab a0 = ReLU(x0) is gathered into
// shared memory, x1 recomputed with the forward's register-tiled dense
// layer, then half the threads scatter d_x2 W2^T into d_a1 (column c2 each,
// over the C3 channels) while the other half add a1[argmax] dval into dW2,
// d_x1 overwrites a1 in place, dW1 / db1 take a0^T d_x1, and d_a0 is the
// dense layer again with W1^T; d_x0 leaves the registers as float atomics
// into d_pre (pooled rows repeat ids, so the atomics cannot be plain
// stores) and as a per-warp partial sum for d_center; in the slab form it
// is one float4 store per thread and slab row.
// Widths: C1 = C2 = 128 (the RCNN's SA levels), C3 128 or 256, S 16/32/64.

#include <cuda_runtime.h>

#include "fused_sa_common.cuh"

namespace {

using fused_sa::dense;
using fused_sa::gather_x0;
using fused_sa::kKC;
using fused_sa::kThreads;
using fused_sa::kWarps;
using fused_sa::load_x0;

constexpr int C1 = 128;
constexpr int C2 = 128;

__host__ __device__ constexpr int da_floats(int S) {
  return S * C2 > kKC * 128 ? S * C2 : kKC * 128;
}

// SLAB: pre is the (R, M, S, C1) slab and dpre its gradient; idx, center
// and dcenter are unused
template <int TM, int TN3, bool SLAB>
__global__ void __launch_bounds__(kThreads, 1)
fused_sa_bwd_kernel(const float* __restrict__ pre, const int* __restrict__ idx,
                    const float* __restrict__ center,
                    const float* __restrict__ w1,
                    const float* __restrict__ w1t,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2t,
                    const float* __restrict__ dval,
                    const int* __restrict__ argmax, int N, int M,
                    long long groups, int per_block, float* __restrict__ dpre,
                    float* __restrict__ dcenter, float* __restrict__ ws) {
  constexpr int S = kWarps * TM;
  constexpr int C3 = 32 * TN3;
  extern __shared__ float smem[];
  float* A0 = smem;                 // S x C1: a0 = ReLU(x0)
  float* A1 = A0 + S * C1;          // S x C2: a1, then d_x1
  float* DA = A1 + S * C2;          // d_a1; the weight slices; d_center sums
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
    const int row = (int)(g / M);
    __syncthreads();  // the previous group is done with every buffer
    for (int c = tid; c < C3; c += kThreads) {
      dv[c] = dval[g * C3 + c];
      ag[c] = argmax[g * C3 + c];
    }
    if constexpr (SLAB)
      load_x0<false>(pre, nullptr, nullptr, (size_t)g, S, C1, A0);
    else
      gather_x0(pre, idx, center, (size_t)g, row, N, S, C1, A0);
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
    {  // d_a0 = d_x1 W1^T; d_x0 = d_a0 [a0 > 0] into d_pre and d_center
      float acc[TM][4];
      dense<TM, 4>(A1, C2, w1t, DA, acc);
      const int col = 4 * lane;
      if constexpr (SLAB) {  // the slab's gradient, stored in place
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int s = warp * TM + i;
          const float4 a = *reinterpret_cast<const float4*>(A0 + s * C1 + col);
          *reinterpret_cast<float4*>(dpre + ((size_t)g * S + s) * C1 + col) =
              make_float4(a.x > 0.0f ? acc[i][0] : 0.0f,
                          a.y > 0.0f ? acc[i][1] : 0.0f,
                          a.z > 0.0f ? acc[i][2] : 0.0f,
                          a.w > 0.0f ? acc[i][3] : 0.0f);
        }
        continue;  // the next group's barrier orders the weight slices
      }
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const size_t base = (size_t)row * N;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int s = warp * TM + i;
        const int p = idx[g * S + s];
        const float4 a = *reinterpret_cast<const float4*>(A0 + s * C1 + col);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float* dst = dpre + (base + p) * C1 + col;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = av[r] > 0.0f ? acc[i][r] : 0.0f;
          part[r] += v;
          if (v != 0.0f) atomicAdd(dst + r, v);
        }
      }
      __syncthreads();  // every warp is done with the last weight slice
      *reinterpret_cast<float4*>(DA + warp * C1 + col) =
          make_float4(part[0], part[1], part[2], part[3]);
    }
    __syncthreads();
    for (int c = tid; c < C1; c += kThreads) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += DA[w * C1 + c];
      dcenter[g * C1 + c] = -sum;
    }
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

template <int TM, int TN3, bool SLAB>
cudaError_t launch(const float* pre, const int* idx, const float* center,
                   const float* w1, const float* w1t, const float* b1,
                   const float* w2t, const float* dval, const int* argmax,
                   int N, int M, long long groups, int blocks, int per_block,
                   float* dpre, float* dcenter, float* ws, float* grads,
                   cudaStream_t stream) {
  constexpr int S = kWarps * TM;
  constexpr int C3 = 32 * TN3;
  const size_t floats = (size_t)S * C1 + S * C2 + da_floats(S) + C3 * C2
                        + 2 * C3;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sa_bwd_kernel<TM, TN3, SLAB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_sa_bwd_kernel<TM, TN3, SLAB><<<blocks, kThreads, smem, stream>>>(
      pre, idx, center, w1, w1t, b1, w2t, dval, argmax, N, M, groups,
      per_block, dpre, dcenter, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per = C1 * C2 + C3 * C2 + C2;
  reduce_partials<<<(per + 255) / 256, 256, 0, stream>>>(ws, blocks, per,
                                                          grads);
  return cudaGetLastError();
}

template <int TM, bool SLAB>
cudaError_t launch_c(const float* pre, const int* idx, const float* center,
                     const float* w1, const float* w1t, const float* b1,
                     const float* w2t, const float* dval, const int* argmax,
                     int N, int M, int C3, long long groups, int blocks,
                     int per_block, float* dpre, float* dcenter, float* ws,
                     float* grads, cudaStream_t stream) {
  if (C3 == 128)
    return launch<TM, 4, SLAB>(pre, idx, center, w1, w1t, b1, w2t, dval,
                               argmax, N, M, groups, blocks, per_block, dpre,
                               dcenter, ws, grads, stream);
  return launch<TM, 8, SLAB>(pre, idx, center, w1, w1t, b1, w2t, dval, argmax,
                             N, M, groups, blocks, per_block, dpre, dcenter,
                             ws, grads, stream);
}

int bwd_blocks(long long groups) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = 4LL * sms;
  const long long per_block = (groups + want - 1) / want;
  return (int)((groups + per_block - 1) / per_block);
}

template <bool SLAB>
int dispatch(const float* pre, const int* idx, const float* center,
             const float* w1, const float* w1t, const float* b1,
             const float* w2t, const float* dval, const int* argmax, int R,
             int N, int M, int S, int C3, int blocks, float* dpre,
             float* dcenter, float* ws, float* grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const long long groups = (long long)R * M;
  if (R < 1 || (!SLAB && N < 1) || M < 1 || (C3 != 128 && C3 != 256)
      || blocks < 1 || blocks != bwd_blocks(groups))
    return (int)cudaErrorInvalidValue;
  const int per_block = (int)((groups + blocks - 1) / blocks);
  switch (S) {
    case 16:
      return (int)launch_c<2, SLAB>(pre, idx, center, w1, w1t, b1, w2t, dval,
                                    argmax, N, M, C3, groups, blocks,
                                    per_block, dpre, dcenter, ws, grads,
                                    stream);
    case 32:
      return (int)launch_c<4, SLAB>(pre, idx, center, w1, w1t, b1, w2t, dval,
                                    argmax, N, M, C3, groups, blocks,
                                    per_block, dpre, dcenter, ws, grads,
                                    stream);
    case 64:
      return (int)launch_c<8, SLAB>(pre, idx, center, w1, w1t, b1, w2t, dval,
                                    argmax, N, M, C3, groups, blocks,
                                    per_block, dpre, dcenter, ws, grads,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  return dispatch<false>(pre, idx, center, w1, w1t, b1, w2t, dval, argmax, R,
                         N, M, S, C3, blocks, dpre, dcenter, ws, grads,
                         stream_ptr);
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
  return dispatch<true>(x0, nullptr, nullptr, w1, w1t, b1, w2t, dval, argmax,
                        R, 0, M, S, C3, blocks, dx0, nullptr, ws, grads,
                        stream_ptr);
}
