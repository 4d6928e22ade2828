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
// design keeps one pick's chain short: each row on W warps (W = 1 up to
// kMaxPPL points per lane, then as many as cover the row), each lane's
// points (PPL, a compile-time count) with their coordinates and running
// min in registers; per pick
//   1. the last pick's coordinates, one broadcast read of the row's shared
//      copy;
//   2. PPL independent distance updates;
//   3. the lane's argmax as a tree over its PPL candidates (depth log2 PPL),
//      ties to the lower index;
//   4. the warp's argmax in two redux.sync instructions: the largest key
//      (__reduce_max_sync), then the lowest index holding it
//      (__reduce_min_sync). The key is the running min's bits as a signed
//      int: d² >= +0.0 orders as its bits, +inf above every finite d², and a
//      lane's missing point keeps a min of -inf, whose bits are negative, so
//      it orders below every d²;
//   5. with W > 1, each warp's winner into shared memory (one buffer per
//      pick parity), a named barrier of the row's W warps, and the same two
//      instructions over the W winners.
// A row's warps meet only at their own named barrier, so rows of one block
// never wait for each other.

#include <climits>

#include <cuda_runtime.h>
#include <math.h>

#include "launch_check.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 2048;
constexpr int kBlock = 128;  // threads per block: 128 / (32·W) rows, or one
// points per lane before a row takes more warps: one sweep on the card
// found a warp per row of 512 points (16 per lane) fastest at the default
// train step's SA_0 and within 0.005 ms of the fastest at eval (PERF.md)
constexpr int kMaxPPL = 16;
static_assert(128 * kMaxPPL >= kMaxN, "four warps cover the longest row");

__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// bar.sync on the named barrier `id` for `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int W>
__host__ __device__ constexpr int block_threads() {
  return 32 * W > kBlock ? 32 * W : kBlock;
}

template <int W, int PPL>
__global__ void __launch_bounds__(block_threads<W>())
fps_rows_kernel(const float* __restrict__ xyz, int R, int N, int npoint,
                int* __restrict__ out) {
  constexpr int T = 32 * W;                     // threads per row
  constexpr int kRows = block_threads<W>() / T;  // rows per block
  extern __shared__ float smem[];               // per row: x, y, z of N
  __shared__ int2 part[kRows][2][W];            // warps' winners per parity
  const int lane = threadIdx.x & 31;
  const int rb = threadIdx.x / T;               // row in the block
  const int t = threadIdx.x % T;                // thread in the row
  const int warp = t >> 5;
  const int row = blockIdx.x * kRows + rb;
  if (row >= R) return;  // the row's warps all leave; no barrier spans rows
  float* sx = smem + (size_t)rb * 3 * N;
  float* sy = sx + N;
  float* sz = sy + N;
  const float* p = xyz + (size_t)row * N * 3;
  int* o = out + (size_t)row * npoint;
  for (int i = t; i < N; i += T) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  // point q·T + t: its coordinates and running min in registers
  float px[PPL], py[PPL], pz[PPL], mind[PPL];
#pragma unroll
  for (int q = 0; q < PPL; ++q) {
    const int i = q * T + t;
    const bool live = i < N;
    px[q] = live ? p[3 * i] : 0.0f;
    py[q] = live ? p[3 * i + 1] : 0.0f;
    pz[q] = live ? p[3 * i + 2] : 0.0f;
    mind[q] = live ? INFINITY : -INFINITY;  // a missing point never wins
  }
  if (W > 1)
    named_sync(1 + rb, T);
  else
    __syncwarp();
  if (t == 0) o[0] = 0;

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    int key[PPL], at[PPL];
#pragma unroll
    for (int q = 0; q < PPL; ++q) {
      mind[q] = fminf(mind[q], dist2(px[q], py[q], pz[q], lx, ly, lz));
      key[q] = __float_as_int(mind[q]);
      at[q] = q;
    }
    // the lane's argmax: a tree whose left operand always holds the lower
    // index, so a tie keeps it
#pragma unroll
    for (int s = 1; s < PPL; s <<= 1) {
#pragma unroll
      for (int q = 0; q + s < PPL; q += 2 * s) {
        if (key[q + s] > key[q]) {
          key[q] = key[q + s];
          at[q] = at[q + s];
        }
      }
    }
    const int top = __reduce_max_sync(kFull, key[0]);
    unsigned low = __reduce_min_sync(
        kFull, key[0] == top ? (unsigned)(at[0] * T + t) : UINT_MAX);
    if (W > 1) {
      const int buf = j & 1;
      if (lane == 0) part[rb][buf][warp] = make_int2(top, (int)low);
      // A warp writes this buffer again two picks on, after the next
      // pick's barrier, which every warp reaches only after reading it.
      named_sync(1 + rb, T);
      const int2 c = lane < W ? part[rb][buf][lane] : make_int2(INT_MIN, 0);
      const int top2 = __reduce_max_sync(kFull, c.x);
      low = __reduce_min_sync(kFull, c.x == top2 ? (unsigned)c.y : UINT_MAX);
    }
    last = (int)low;
    if (t == 0) o[j] = last;
  }
}

template <int W, int PPL>
cudaError_t launch(const float* xyz, int R, int N, int npoint, int* idx,
                   cudaStream_t stream) {
  constexpr int rows = block_threads<W>() / (32 * W);
  const size_t smem = (size_t)rows * 12 * N;  // at most 24 KB
  const int blocks = (R + rows - 1) / rows;
  fps_rows_kernel<W, PPL><<<blocks, block_threads<W>(), smem, stream>>>(
      xyz, R, N, npoint, idx);
  return cudaGetLastError();
}

// The fewest warps per row with at most kMaxPPL points per lane, then the
// fewest points per lane that cover the row, both powers of 2.
cudaError_t dispatch(const float* xyz, int R, int N, int npoint, int* idx,
                     cudaStream_t stream) {
  if (N <= 32) return launch<1, 1>(xyz, R, N, npoint, idx, stream);
  if (N <= 64) return launch<1, 2>(xyz, R, N, npoint, idx, stream);
  if (N <= 128) return launch<1, 4>(xyz, R, N, npoint, idx, stream);
  if (N <= 256) return launch<1, 8>(xyz, R, N, npoint, idx, stream);
  if (N <= 32 * kMaxPPL) return launch<1, kMaxPPL>(xyz, R, N, npoint, idx, stream);
  if (N <= 64 * kMaxPPL) return launch<2, kMaxPPL>(xyz, R, N, npoint, idx, stream);
  return launch<4, kMaxPPL>(xyz, R, N, npoint, idx, stream);
}

}  // namespace

extern "C" int tpu3d_fps(const float* xyz, int R, int N, int npoint, int* idx,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  if (R < 1 || N < 1 || N > kMaxN || npoint < 1 || npoint > N)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(xyz, R, N, npoint, idx, stream);
}
