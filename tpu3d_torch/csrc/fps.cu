// Furthest point sampling over many short rows, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/sampling.py::_fps_pallas. Same function: pick 0 is
// point 0, every later pick is the argmax of the running min d² to the picks
// so far, ties to the lowest index. d² is (x-lx)²+(y-ly)²+(z-lz)² rounded
// step by step in f32 (the __f*_rn intrinsics, never contracted), exactly as
// the plain version rounds it: one rounding difference moves a pick.
//
// Bound on the card: FPS is a chain of npoint dependent argmax steps, so it
// is bound by the latency of one pick, not by bytes or operations. The RCNN
// gives it many short rows (200 rows of 512 or 128 points at eval), so the
// design is one warp per row, kRows rows per block: the row's coordinates in
// shared memory (12·N bytes), the running min in registers (N/32 per lane, a
// compile-time PPL so it never spills), and per pick one pass over the
// registers and one warp-shuffle argmax tree. Nothing needs a block barrier:
// each warp only ever reads its own row.

#include <cuda_runtime.h>
#include <math.h>

#include "launch_check.cuh"

namespace {

constexpr int kRows = 4;  // rows (warps) per block
constexpr int kMaxN = 2048;

__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// argmax over (value, index) pairs, ties to the lower index
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int PPL>
__global__ void __launch_bounds__(32 * kRows)
fps_rows_kernel(const float* __restrict__ xyz, int R, int N, int npoint,
                int* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + warp;
  if (row >= R) return;  // the whole warp leaves; no block barrier follows
  float* sx = smem + (size_t)warp * 3 * N;
  float* sy = sx + N;
  float* sz = sy + N;
  const float* p = xyz + (size_t)row * N * 3;
  int* o = out + (size_t)row * npoint;
  for (int i = lane; i < N; i += 32) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  float mind[PPL];
#pragma unroll
  for (int k = 0; k < PPL; ++k) mind[k] = INFINITY;
  if (lane == 0) o[0] = 0;
  __syncwarp();

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bv = -1.0f;  // below every d², so a real point always wins
    int bi = N;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int i = lane + 32 * k;
      if (i < N) {
        const float m = fminf(mind[k], dist2(sx[i], sy[i], sz[i], lx, ly, lz));
        mind[k] = m;
        if (m > bv) {  // strict: ascending i, so ties keep the lower index
          bv = m;
          bi = i;
        }
      }
    }
    warp_argmax(bv, bi);
    last = bi;
    if (lane == 0) o[j] = last;
  }
}

template <int PPL>
cudaError_t launch(const float* xyz, int R, int N, int npoint, int* idx,
                   cudaStream_t stream) {
  const size_t smem = (size_t)kRows * 12 * N;
  cudaError_t err = cudaFuncSetAttribute(
      fps_rows_kernel<PPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kRows - 1) / kRows;
  fps_rows_kernel<PPL><<<blocks, 32 * kRows, smem, stream>>>(xyz, R, N,
                                                             npoint, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpu3d_fps(const float* xyz, int R, int N, int npoint, int* idx,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (R < 1 || N < 1 || N > kMaxN || npoint < 1 || npoint > N)
    return (int)cudaErrorInvalidValue;
  const int ppl = (N + 31) / 32;
  if (ppl <= 1) return (int)launch<1>(xyz, R, N, npoint, idx, stream);
  if (ppl <= 2) return (int)launch<2>(xyz, R, N, npoint, idx, stream);
  if (ppl <= 4) return (int)launch<4>(xyz, R, N, npoint, idx, stream);
  if (ppl <= 8) return (int)launch<8>(xyz, R, N, npoint, idx, stream);
  if (ppl <= 16) return (int)launch<16>(xyz, R, N, npoint, idx, stream);
  if (ppl <= 32) return (int)launch<32>(xyz, R, N, npoint, idx, stream);
  return (int)launch<64>(xyz, R, N, npoint, idx, stream);
}
