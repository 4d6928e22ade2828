// Furthest point sampling + each point's 3 nearest picks, for Hopper (sm_90a).
//
// Replaces tpu3d/ops/sampling.py::_fps3nn_pallas, and serves FPS alone on
// rows of 2048 < N <= 32768 (tpu3d/ops/sampling.py::_fps_pallas on long
// rows). Same function: pick 0 is point 0, every later pick is the argmax
// of the running min d² (ties go to the lowest index), and every point gets
// the sorted top-3 (d², pick position) among all picks, folded in pick
// order with strict < so that ties keep the earlier pick. d² is
// (x-lx)²+(y-ly)²+(z-lz)² rounded step by step in f32 (the __f*_rn
// intrinsics, and the build passes -fmad=false), exactly as the plain
// version rounds it: one rounding difference moves a pick.
//
// Bound on the card: FPS is a chain of npoint dependent argmax steps over
// the whole cloud, so it is bound by the latency of one cloud-wide
// reduction per pick, not by bytes or operations, and the cost of a pick
// follows the points each SM sweeps and the partials each warp reads.
// Design: one thread-block cluster of k CTAs per scene (k = 1 to 16 and
// the CTA's threads and points per thread, PPT, chosen from (B, N) by the
// caller, ops/sampling.py::fps_geometry, from a sweep on the card: about
// 32 warps per scene, B·k within the SMs). CTA r holds the contiguous slice
// [r·H, r·H + H), H = ceil(N / k), PPT points per thread, with their
// coordinates and running min in registers: a pick sweeps registers only.
// Per pick each warp reduces its points (two warp reductions: the largest
// d², then the lowest global index at it) and sends its (d², global index,
// x, y, z) winner into every CTA's shared memory with st.async, which
// counts the bytes against that CTA's mbarrier (one per pick parity); a
// CTA waits on its own barrier, so there is no cluster-wide barrier per
// pick, and then every warp reduces the k × warps partials from its own
// shared memory the same way, so every CTA agrees on the pick and its
// coordinates without a device-memory round trip. A CTA is at most one
// pick ahead of another, so two buffers suffice. A thread's points ascend
// in global index and the reductions take the lower index on ties, so the
// picks equal the plain version's. k = 16 needs the non-portable cluster
// size, taken only where the card accepts it.
// The top-3 search is a second kernel, embarrassingly parallel (one thread
// per point, picks staged through shared memory).

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "launch_check.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 32768;
constexpr int kMaxWarps = 32;
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

// a key whose unsigned order is the float order of v
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's winner: the largest v, ties to the lower index i, and its
// coordinates, from the lane that held it (two warp reductions, a ballot
// and four shuffles).
__device__ __forceinline__ void warp_pick(float& v, int& i, float& x,
                                          float& y, float& z) {
  const unsigned key = ordered(v);
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  const unsigned low =
      __reduce_min_sync(0xffffffffu, key == top ? (unsigned)i : 0xffffffffu);
  const int src = __ffs(__ballot_sync(0xffffffffu,
                                      key == top && (unsigned)i == low)) - 1;
  i = (int)low;
  v = __shfl_sync(0xffffffffu, v, src);
  x = __shfl_sync(0xffffffffu, x, src);
  y = __shfl_sync(0xffffffffu, y, src);
  z = __shfl_sync(0xffffffffu, z, src);
}

// the most threads a CTA of each PPT was compiled for (its registers; the
// kernel's __launch_bounds__)
constexpr int max_threads(int ppt) {
  return ppt <= 4 ? 1024 : ppt == 8 ? 512 : 256;
}

// --- distributed shared memory and mbarriers (PTX, sm_90)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// this CTA's one arrival for the barrier's current phase, which then also
// waits for `bytes` of remote stores
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// stores into another CTA's shared memory that count against its barrier
__device__ __forceinline__ void st_async(unsigned addr, int4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z),
      "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr), "f"(v), "r"(bar) : "memory");
}

constexpr int kPartBytes = 20;  // one partial: int4 (d², i, x, y) + float z

// The pick loop: one cluster of k CTAs per scene (see the note at the top).
template <int PPT>
__global__ void __launch_bounds__(PPT <= 4 ? 1024 : PPT == 8 ? 512 : 256)
fps_cluster_kernel(const float* __restrict__ xyz, int N, int npoint,
                   int* __restrict__ out) {
  // every warp's partial of a pick, by source (rank · W + warp) and pick
  // parity, written by its CTA with st.async; one barrier per parity
  __shared__ int4 part[2][16 * kMaxWarps];
  __shared__ float part_z[2][16 * kMaxWarps];
  __shared__ __align__(8) unsigned long long bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x;
  const int W = T >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H = (N + k - 1) / k;
  const int base = rank * H + threadIdx.x;  // this thread's first point
  const int n = min(H, N - rank * H);       // points of this CTA
  const float* p = xyz + (size_t)(blockIdx.x / k) * N * 3;
  int* o = out + (size_t)(blockIdx.x / k) * npoint;
  const unsigned bytes = (unsigned)(k * W * kPartBytes);  // per pick

  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&bar[0]), 1);
    mbar_init(smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_addr(&bar[0]), bytes);  // pick 2
    mbar_expect(smem_addr(&bar[1]), bytes);  // pick 1
  }
  // lane r < k of each warp sends the warp's partial to CTA r
  unsigned dst = 0, dst_z = 0, dst_bar = 0;
  if (lane < k) {
    dst = cluster_addr(smem_addr(&part[0][rank * W + warp]), lane);
    dst_z = cluster_addr(smem_addr(&part_z[0][rank * W + warp]), lane);
    dst_bar = cluster_addr(smem_addr(&bar[0]), lane);
  }
  cluster.sync();  // every CTA's barriers are set up

  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int i = threadIdx.x + q * T;
    const bool live = i < n;
    px[q] = live ? p[3 * (base + q * T)] : 0.0f;
    py[q] = live ? p[3 * (base + q * T) + 1] : 0.0f;
    pz[q] = live ? p[3 * (base + q * T) + 2] : 0.0f;
    // a missing point's min stays -inf, below every d², and never wins
    mind[q] = live ? INFINITY : -INFINITY;
  }
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];

  for (int j = 1; j < npoint; ++j) {
    float bv = -1.0f;  // below every d², so a real point always wins
    int bi = INT_MAX;  // global index; INT_MAX marks "no point"
    float bx = 0.0f, by = 0.0f, bz = 0.0f;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const float m = fminf(mind[q], dist2(px[q], py[q], pz[q], lx, ly, lz));
      mind[q] = m;
      if (m > bv) {  // strict: ascending index, so ties keep the lower one
        bv = m;
        bi = base + q * T;
        bx = px[q];
        by = py[q];
        bz = pz[q];
      }
    }
    warp_pick(bv, bi, bx, by, bz);
    const int buf = j & 1;
    // A CTA can be at most one pick ahead of another: its pick j + 1 needs
    // every warp's partial of pick j + 1, each sent after that warp read
    // pick j's buffer, so pick j + 2 never lands on a buffer being read.
    if (lane < k) {
      const unsigned off = (unsigned)(buf * 16 * kMaxWarps);
      const unsigned b = dst_bar + buf * 8;
      st_async(dst + off * 16, make_int4(__float_as_int(bv), bi,
                                         __float_as_int(bx),
                                         __float_as_int(by)), b);
      st_async(dst_z + off * 4, bz, b);
    }
    mbar_wait(smem_addr(&bar[buf]), ((j - 1) >> 1) & 1);
    if (threadIdx.x == 0) mbar_expect(smem_addr(&bar[buf]), bytes);  // j+2
    float cv = -2.0f, cx = 0.0f, cy = 0.0f, cz = 0.0f;
    int ci = INT_MAX;
    for (int e = lane; e < k * W; e += 32) {
      const int4 q = part[buf][e];
      const float qv = __int_as_float(q.x);
      if (qv > cv || (qv == cv && q.y < ci)) {
        cv = qv;
        ci = q.y;
        cx = __int_as_float(q.z);
        cy = __int_as_float(q.w);
        cz = part_z[buf][e];
      }
    }
    warp_pick(cv, ci, cx, cy, cz);
    lx = cx;
    ly = cy;
    lz = cz;
    if (rank == 0 && threadIdx.x == 0) o[j] = ci;
  }
  cluster.sync();  // no CTA leaves while another may still write to it
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

// Whether (k, threads, ppt) is a geometry the pick loop was built for and
// that covers N points: k a power of 2 up to 16, whole warps up to the
// PPT's register budget, H = ceil(N / k) <= threads · ppt.
bool geometry_ok(int N, int k, int threads, int ppt) {
  if (k != 1 && k != 2 && k != 4 && k != 8 && k != 16) return false;
  if (ppt != 1 && ppt != 2 && ppt != 4 && ppt != 8 && ppt != 16)
    return false;
  if (threads < 32 || threads % 32 || threads > max_threads(ppt))
    return false;
  return (N + k - 1) / k <= threads * ppt;
}

template <int PPT>
cudaError_t launch_ppt(const float* xyz, int B, int N, int npoint, int k,
                       int threads, int* idx, cudaStream_t stream,
                       bool query) {
  auto kern = fps_cluster_kernel<PPT>;
  cudaError_t err = cudaSuccess;
  if (k > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * k);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  if (k > 8 || query) {  // the card must hold at least one such cluster
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &config);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidValue;
    if (query) return cudaSuccess;
  }
  err = cudaLaunchKernelEx(&config, kern, xyz, N, npoint, idx);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// FPS alone on a geometry checked by geometry_ok; with query, only whether
// the card takes that cluster (cudaErrorInvalidValue if it does not)
cudaError_t launch_picks(const float* xyz, int B, int N, int npoint, int k,
                         int threads, int ppt, int* idx, cudaStream_t stream,
                         bool query = false) {
  switch (ppt) {
    case 1:
      return launch_ppt<1>(xyz, B, N, npoint, k, threads, idx, stream, query);
    case 2:
      return launch_ppt<2>(xyz, B, N, npoint, k, threads, idx, stream, query);
    case 4:
      return launch_ppt<4>(xyz, B, N, npoint, k, threads, idx, stream, query);
    case 8:
      return launch_ppt<8>(xyz, B, N, npoint, k, threads, idx, stream, query);
    default:
      return launch_ppt<16>(xyz, B, N, npoint, k, threads, idx, stream, query);
  }
}

bool args_ok(int B, int N, int npoint, int k, int threads, int ppt) {
  return B >= 1 && B <= 65535 && N >= 1 && N <= kMaxN &&
         npoint >= 1 && npoint <= N && geometry_ok(N, k, threads, ppt);
}

}  // namespace

// 1 if the card takes a k-CTA cluster of this (threads, ppt), else 0
extern "C" int tpu3d_fps_cluster_ok(int k, int threads, int ppt) {
  if (!geometry_ok(1, k, threads, ppt)) return 0;
  return launch_picks(nullptr, 1, 1, 1, k, threads, ppt, nullptr, 0,
                      true) == cudaSuccess ? 1 : 0;
}

// xyz (B, N, 3) -> idx (B, npoint), nn_d2 and nn_idx (B, N, 3); the pick
// loop on (k, threads, ppt), which must be a geometry it was built for
extern "C" int tpu3d_fps3nn(const float* xyz, int B, int N, int npoint, int k,
                            int threads, int ppt, int* idx, float* nn_d2,
                            int* nn_idx, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (!args_ok(B, N, npoint, k, threads, ppt))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_picks(xyz, B, N, npoint, k, threads, ppt, idx,
                                 stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kNNThreads - 1) / kNNThreads, B);
  three_nn_to_picks_kernel<<<grid, kNNThreads, 0, stream>>>(
      xyz, idx, N, npoint, nn_d2, nn_idx);
  return (int)cudaGetLastError();
}

// FPS alone: xyz (B, N, 3) -> idx (B, npoint)
extern "C" int tpu3d_fps_long(const float* xyz, int B, int N, int npoint,
                              int k, int threads, int ppt, int* idx,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (!args_ok(B, N, npoint, k, threads, ppt))
    return (int)cudaErrorInvalidValue;
  return (int)launch_picks(xyz, B, N, npoint, k, threads, ppt, idx, stream);
}
