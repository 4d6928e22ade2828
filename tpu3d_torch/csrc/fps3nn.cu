// Furthest point sampling + each point's 3 nearest picks, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/sampling.py::_fps3nn_pallas. Same function: pick 0 is
// point 0, every later pick is the argmax of the running min d² (ties go to
// the lowest index), and every point gets the sorted top-3 (d², pick
// position) among all picks, folded in pick order with strict < so that ties
// keep the earlier pick. d² is (x-lx)²+(y-ly)²+(z-lz)² rounded step by step
// in f32 (the __f*_rn intrinsics, and the build passes -fmad=false), exactly
// as the plain version rounds it: one rounding difference moves a pick.
//
// Bound on the card: FPS is a chain of npoint dependent argmax steps over
// the whole cloud, so it is bound by the latency of one block-wide reduction
// per pick, not by bytes or operations. Design: kernel 1 runs one block per
// scene with the coordinates in shared memory (12·N bytes, 192 KB at
// N = 16384) and the running min in registers (N/1024 per thread), so a pick
// costs one pass over registers, two warp-shuffle argmax trees and a single
// __syncthreads (the per-warp partials are double-buffered by pick parity).
// The top-3 search is split off into kernel 2, which is embarrassingly
// parallel (one thread per point, picks staged through shared memory): the
// fused TPU form would need 6 more registers per point, 384 KB at N = 16384.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kNNThreads = 256;
constexpr int kNNTile = 1024;

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

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int N, int npoint,
           int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + N;
  float* sz = smem + 2 * N;
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];

  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  int* o = out + (size_t)blockIdx.x * npoint;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) mind[k] = INFINITY;
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bv = -1.0f;  // below every d², so a real point always wins
    int bi = N;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
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
    const int buf = j & 1;
    if (lane == 0) {
      red_v[buf][warp] = bv;
      red_i[buf][warp] = bi;
    }
    __syncthreads();
    bv = lane < nwarps ? red_v[buf][lane] : -2.0f;
    bi = lane < nwarps ? red_i[buf][lane] : N;
    warp_argmax(bv, bi);
    last = bi;
    if (threadIdx.x == 0) o[j] = last;
  }
}

__global__ void __launch_bounds__(kNNThreads)
three_nn_to_picks_kernel(const float* __restrict__ xyz,
                         const int* __restrict__ picks, int N, int npoint,
                         float* __restrict__ nn_d2, int* __restrict__ nn_idx) {
  __shared__ float sx[kNNTile], sy[kNNTile], sz[kNNTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* p = xyz + (size_t)b * N * 3;
  const int* pk = picks + (size_t)b * npoint;
  const bool live = i < N;
  const float px = live ? p[3 * i] : 0.0f;
  const float py = live ? p[3 * i + 1] : 0.0f;
  const float pz = live ? p[3 * i + 2] : 0.0f;
  float d1 = INFINITY, d2 = INFINITY, d3 = INFINITY;
  int i1 = 0, i2 = 0, i3 = 0;
  for (int t0 = 0; t0 < npoint; t0 += kNNTile) {
    const int cnt = min(kNNTile, npoint - t0);
    for (int s = threadIdx.x; s < cnt; s += blockDim.x) {
      const int q = pk[t0 + s];
      sx[s] = p[3 * q];
      sy[s] = p[3 * q + 1];
      sz[s] = p[3 * q + 2];
    }
    __syncthreads();
    for (int s = 0; s < cnt; ++s) {
      // point minus pick, the order the TPU kernel's fold uses
      const float m = dist2(px, py, pz, sx[s], sy[s], sz[s]);
      const int pos = t0 + s;
      const bool c1 = m < d1, c2 = m < d2, c3 = m < d3;
      const float y1 = fmaxf(d1, m);
      const float y2 = fmaxf(d2, y1);
      d3 = fminf(d3, y2);
      d2 = fminf(d2, y1);
      d1 = fminf(d1, m);
      const int i1n = c1 ? pos : i1;
      const int i2n = c2 ? (c1 ? i1 : pos) : i2;
      i3 = c3 ? (c2 ? i2 : pos) : i3;
      i2 = i2n;
      i1 = i1n;
    }
    __syncthreads();
  }
  if (live) {
    const size_t r = ((size_t)b * N + i) * 3;
    nn_d2[r] = d1;
    nn_d2[r + 1] = d2;
    nn_d2[r + 2] = d3;
    nn_idx[r] = i1;
    nn_idx[r + 1] = i2;
    nn_idx[r + 2] = i3;
  }
}

template <int PPT>
cudaError_t launch_fps(const float* xyz, int B, int N, int npoint, int* idx,
                       int threads, cudaStream_t stream) {
  const size_t smem = (size_t)12 * N;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<B, threads, smem, stream>>>(xyz, N, npoint, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpu3d_fps3nn(const float* xyz, int B, int N, int npoint,
                            int* idx, float* nn_d2, int* nn_idx,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || N < 1 || N > 16 * kMaxThreads || npoint < 1 || npoint > N)
    return (int)cudaErrorInvalidValue;
  const int threads = N >= kMaxThreads ? kMaxThreads : ((N + 31) / 32) * 32;
  const int ppt = (N + threads - 1) / threads;
  cudaError_t err;
  if (ppt <= 1)
    err = launch_fps<1>(xyz, B, N, npoint, idx, threads, stream);
  else if (ppt <= 2)
    err = launch_fps<2>(xyz, B, N, npoint, idx, threads, stream);
  else if (ppt <= 4)
    err = launch_fps<4>(xyz, B, N, npoint, idx, threads, stream);
  else if (ppt <= 8)
    err = launch_fps<8>(xyz, B, N, npoint, idx, threads, stream);
  else
    err = launch_fps<16>(xyz, B, N, npoint, idx, threads, stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kNNThreads - 1) / kNNThreads, B);
  three_nn_to_picks_kernel<<<grid, kNNThreads, 0, stream>>>(
      xyz, idx, N, npoint, nn_d2, nn_idx);
  return (int)cudaGetLastError();
}
