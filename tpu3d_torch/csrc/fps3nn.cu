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
//
// Long rows (16384 < N <= 32768, configs/double.yaml's SA_0): 12·N bytes no
// longer fit one block's 227 KB, so kernel 3 runs one 2-CTA thread-block
// cluster per scene. CTA r holds points [r·H, r·H + H), H = ceil(N/2), in its
// shared memory (192 KB at N = 32768) and their running min in registers,
// and runs kernel 1's pick loop over its half. Per pick each warp publishes
// its (d², global index, coordinates) winner in its CTA's shared memory; one
// cluster barrier replaces kernel 1's block barrier, and then every warp
// reads the 32 local and the 32 remote partials (distributed shared memory,
// map_shared_rank) and reduces them with ties to the lower global index, so
// the picks equal the single-block kernel's. The winner's coordinates ride
// along in the partials, so no thread waits on a device-memory read per
// pick. The same entry serves FPS alone (tpu3d_fps_long, plain FPS for
// 2048 < N <= 32768: kernel 1 up to 16384 points, kernel 3 above).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "launch_check.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLongPPT = 16;  // points per thread in each CTA of a cluster
constexpr int kMaxLongN = 2 * kLongPPT * kMaxThreads;  // 32768
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

// Kernel 3: one scene per 2-CTA cluster (see the note at the top).
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMaxThreads)
fps_long_kernel(const float* __restrict__ xyz, int N, int npoint,
                int* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float red_v[2][32], red_x[2][32], red_y[2][32], red_z[2][32];
  __shared__ int red_i[2][32];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int H = (N + 1) / 2;
  const int base = rank * H;
  const int n = min(H, N - base);
  float* sx = smem;
  float* sy = smem + H;
  float* sz = smem + 2 * H;
  const float* p = xyz + (size_t)(blockIdx.x / 2) * N * 3;
  int* o = out + (size_t)(blockIdx.x / 2) * npoint;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t q = (size_t)3 * (base + i);
    sx[i] = p[q];
    sy[i] = p[q + 1];
    sz[i] = p[q + 2];
  }
  // the other CTA's partials, through distributed shared memory
  const unsigned other = (unsigned)(rank ^ 1);
  const float* o_v = cluster.map_shared_rank(&red_v[0][0], other);
  const float* o_x = cluster.map_shared_rank(&red_x[0][0], other);
  const float* o_y = cluster.map_shared_rank(&red_y[0][0], other);
  const float* o_z = cluster.map_shared_rank(&red_z[0][0], other);
  const int* o_i = cluster.map_shared_rank(&red_i[0][0], other);
  float mind[kLongPPT];
#pragma unroll
  for (int k = 0; k < kLongPPT; ++k) mind[k] = INFINITY;
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 1; j < npoint; ++j) {
    float bv = -1.0f;  // below every d², so a real point always wins
    int bi = N;        // global index; N marks "no point"
#pragma unroll
    for (int k = 0; k < kLongPPT; ++k) {
      const int i = threadIdx.x + k * kMaxThreads;
      if (i < n) {
        const float m = fminf(mind[k], dist2(sx[i], sy[i], sz[i], lx, ly, lz));
        mind[k] = m;
        if (m > bv) {  // strict: ascending i, so ties keep the lower index
          bv = m;
          bi = base + i;
        }
      }
    }
    warp_argmax(bv, bi);
    const int buf = j & 1;
    if (lane == 0) {
      const int li = bi < N ? bi - base : 0;
      red_v[buf][warp] = bv;
      red_i[buf][warp] = bi;
      red_x[buf][warp] = sx[li];
      red_y[buf][warp] = sy[li];
      red_z[buf][warp] = sz[li];
    }
    cluster.sync();  // both CTAs' partials of this pick are written
    const int r = buf * 32 + lane;
    float cv = red_v[buf][lane], cx = red_x[buf][lane];
    float cy = red_y[buf][lane], cz = red_z[buf][lane];
    int ci = red_i[buf][lane];
    const float ov = o_v[r];
    const int oi = o_i[r];
    if (ov > cv || (ov == cv && oi < ci)) {
      cv = ov;
      ci = oi;
      cx = o_x[r];
      cy = o_y[r];
      cz = o_z[r];
    }
    bv = cv;
    bi = ci;
    warp_argmax(bv, bi);
    const int src = __ffs(__ballot_sync(0xffffffffu, ci == bi)) - 1;
    lx = __shfl_sync(0xffffffffu, cx, src);
    ly = __shfl_sync(0xffffffffu, cy, src);
    lz = __shfl_sync(0xffffffffu, cz, src);
    if (rank == 0 && threadIdx.x == 0) o[j] = bi;
  }
  cluster.sync();  // the other CTA may still read this one's partials
}

cudaError_t launch_fps_long(const float* xyz, int B, int N, int npoint,
                            int* idx, cudaStream_t stream) {
  const size_t smem = (size_t)12 * ((N + 1) / 2);
  cudaError_t err = cudaFuncSetAttribute(
      fps_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fps_long_kernel<<<2 * B, kMaxThreads, smem, stream>>>(xyz, N, npoint, idx);
  return cudaGetLastError();
}

// FPS alone: kernel 1 up to 16384 points, kernel 3 above
cudaError_t launch_fps_any(const float* xyz, int B, int N, int npoint,
                           int* idx, cudaStream_t stream) {
  if (N > 16 * kMaxThreads)
    return launch_fps_long(xyz, B, N, npoint, idx, stream);
  const int threads = N >= kMaxThreads ? kMaxThreads : ((N + 31) / 32) * 32;
  const int ppt = (N + threads - 1) / threads;
  if (ppt <= 1) return launch_fps<1>(xyz, B, N, npoint, idx, threads, stream);
  if (ppt <= 2) return launch_fps<2>(xyz, B, N, npoint, idx, threads, stream);
  if (ppt <= 4) return launch_fps<4>(xyz, B, N, npoint, idx, threads, stream);
  if (ppt <= 8) return launch_fps<8>(xyz, B, N, npoint, idx, threads, stream);
  return launch_fps<16>(xyz, B, N, npoint, idx, threads, stream);
}

}  // namespace

extern "C" int tpu3d_fps3nn(const float* xyz, int B, int N, int npoint,
                            int* idx, float* nn_d2, int* nn_idx,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || B > 65535 || N < 1 || N > kMaxLongN || npoint < 1 ||
      npoint > N)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_fps_any(xyz, B, N, npoint, idx, stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kNNThreads - 1) / kNNThreads, B);
  three_nn_to_picks_kernel<<<grid, kNNThreads, 0, stream>>>(
      xyz, idx, N, npoint, nn_d2, nn_idx);
  return (int)cudaGetLastError();
}

extern "C" int tpu3d_fps_long(const float* xyz, int B, int N, int npoint,
                              int* idx, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (B < 1 || B > 65535 || N < 1 || N > kMaxLongN || npoint < 1 ||
      npoint > N)
    return (int)cudaErrorInvalidValue;
  return (int)launch_fps_any(xyz, B, N, npoint, idx, stream);
}
