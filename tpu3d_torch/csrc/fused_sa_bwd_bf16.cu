// The bf16 training forms' backward of kernels 6 and 8, for Hopper
// (sm_90a), in two designs chosen by the widths.
//
// Replaces tpu3d/ops/fused_sa.py::_nobn2_bwd_kernel (the gather form's
// VJP, :926-945) and _nobn_bwd_kernel (the slab form's, :666-691) in their
// bf16 arithmetic (fused_sa_bwd.cuh gives the rounding points): bf16
// operands, each product exact in f32, f32 sums.
//   - The tensor-core design (fused_sa_bwd_mma.cuh) at C1 = C2 = 128, C3
//     128 or 256, every fused level of the shipped configs: mma.sync
//     products, the weights resident in shared memory, the gradient read
//     as it lies, bf16 outputs. Its note gives the design and the bound.
//   - The parent walk (fused_sa_bwd.cuh on bf16 rows, the f32 form's SIMT
//     products on operands rounded to bf16) at every other width the
//     kernels take (the widened RCNN's): prep_kernel rounds its operands
//     in one pass from the same raw inputs, and its f32 d_center and
//     slab gradient are rounded to bf16 by a last pass.
// Both: the plan, reached slots only, packed by whole parts into tiles of
// up to 64 rows, the weight gradients in per-block slices added in block
// order, d_pre through the CSR inverse in ascending key order, db2 in
// fixed ranges added in order (db2_partials): every output repeats to the
// bit. The C entries take the same arguments in both designs; the
// Python wrapper sizes its buffers through the entries below.

#include "fused_sa_bwd.cuh"
#include "fused_sa_bwd_mma.cuh"

using bf16 = __nv_bfloat16;
namespace fsm = fused_sa_mma;

namespace {

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// the tensor-core design's blocks: one per SM, at most one per group
int mma_blocks(long long groups) {
  const long long sms = sm_count();
  return (int)(groups < sms ? groups : sms);
}

// floats of one block's slice: [dW1 | dW2^T | db1]
long long slice_floats(int C1, int C2, int C3) {
  return per_floats(C1, C2, C3);
}

// floats of the auxiliary buffer: db2's partials, then the plan's packed
// routes (a 4-byte word a part and channel) in the tensor-core design, or
// the parent walk's rounded operands [W1 | W1^T | b1 | W2^T | dval]
long long aux_floats(long long groups, long long nparts, int C1, int C2,
                     int C3) {
  long long n = (long long)fsm::kDb2Parts * C3;
  if (fsm::takes(C1, C2, C3)) return n + nparts * C3;
  return n + 2LL * C1 * C2 + C2 + (long long)C3 * C2 + groups * C3;
}

unsigned* routes_of(float* aux, int C3) {
  return reinterpret_cast<unsigned*>(aux + (size_t)fsm::kDb2Parts * C3);
}

struct Raw {  // the inputs as the caller hands them
  fsm::Mat w1, w2;  // W1 (C1 x C2), W2 (C2 x C3)
  const float* b1;
  fsm::Grad gr;
  const int* argmax;
};

Raw raw(const float* w1, long long w1s0, long long w1s1, const float* b1,
        const float* w2, long long w2s0, long long w2s1, const void* grad,
        int grad_bf16, long long gsR, long long gsM, long long gsC,
        const float* ppre, const int* argmax, int M) {
  return Raw{fsm::Mat{w1, w1s0, w1s1}, fsm::Mat{w2, w2s0, w2s1}, b1,
             fsm::Grad{grad, gsR, gsM, gsC, grad_bf16, M, ppre}, argmax};
}

// the parent walk's operands, carved from aux past db2's partials
struct Prepped {
  float *w1, *w1t, *b1, *w2t, *dval;
};

Prepped prepped(float* aux, int C1, int C2, int C3) {
  float* p = aux + (size_t)fsm::kDb2Parts * C3;
  Prepped o;
  o.w1 = p;
  o.w1t = o.w1 + (size_t)C1 * C2;
  o.b1 = o.w1t + (size_t)C1 * C2;
  o.w2t = o.b1 + C2;
  o.dval = o.w2t + (size_t)C3 * C2;
  return o;
}

cudaError_t prep(const Raw& in, int C1, int C2, int C3, long long groups,
                 float* aux, cudaStream_t stream) {
  const Prepped o = prepped(aux, C1, C2, C3);
  const long long n = 2LL * C1 * C2 + C2 + (long long)C3 * C2 + groups * C3;
  fsm::prep_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      in.w1, in.b1, in.w2, in.gr, C1, C2, C3, groups, o.w1, o.w1t, o.b1,
      o.w2t, o.dval);
  return cudaGetLastError();
}

// db2 = the sum over the groups of dval, unrounded, into out
cudaError_t db2(const Raw& in, long long groups, int C3, float* aux,
                float* out, cudaStream_t stream) {
  fsm::db2_partials<<<dim3((C3 + 31) / 32, fsm::kDb2Parts), fsm::kThreads,
                      0, stream>>>(in.gr, (int)groups, C3, aux);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fsm::db2_reduce<<<(C3 + 255) / 256, 256, 0, stream>>>(aux, fsm::kDb2Parts,
                                                        C3, out);
  return cudaGetLastError();
}

cudaError_t round_out(const float* x, bf16* y, long long n,
                      cudaStream_t stream) {
  fsm::to_bf16<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(x, y, n);
  return cudaGetLastError();
}

// The tensor-core design's shape, or false where it does not take it.
bool checked_mma(int R, int N, int M, int S, int C1, int C2, int C3,
                 int blocks, bool slab, Shape* sh) {
  const long long groups = (long long)R * M;
  if (R < 1 || M < 1 || (!slab && N < 1) || S < 8 || S % 8 != 0 ||
      !fsm::takes(C1, C2, C3) || groups > 0x7fffffffLL)
    return false;
  const int nseg = (S + fsm::kT - 1) / fsm::kT;
  if (groups * nseg > 0x7fffffffLL) return false;
  if (!slab &&
      (groups * S >= INT_MAX || csr::build_smem((long long)M * S) == 0))
    return false;
  *sh = Shape{N, M, S, C1, C2, C3, fsm::kT, nseg, true, C3 == 128};
  return sh->dw2_shared == fsm::dw2_shared(C3) && blocks == mma_blocks(groups);
}

cudaError_t mma_plan(bool slab, const Raw& in, const Shape& sh,
                     long long nparts, const PlanBufs& pb, unsigned* routes,
                     void* zero_rows, int row_bytes, cudaStream_t stream) {
  const unsigned grid = (unsigned)((nparts * 32 + fsm::kThreads - 1) /
                                   fsm::kThreads);
  unsigned char* z = static_cast<unsigned char*>(zero_rows);
  if (slab)
    fsm::plan_kernel<true><<<grid, fsm::kThreads, 0, stream>>>(
        in.gr, in.argmax, sh, nparts, pb.masks, pb.counts, routes, z,
        row_bytes);
  else
    fsm::plan_kernel<false><<<grid, fsm::kThreads, 0, stream>>>(
        in.gr, in.argmax, sh, nparts, pb.masks, pb.counts, routes, z,
        row_bytes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fsm::scan_kernel<<<1, fsm::kScanThreads, 0, stream>>>(pb.counts, nparts,
                                                        pb.cum);
  return cudaGetLastError();
}

template <int C3, bool SLAB>
cudaError_t launch_routed_mma(const bf16* src, const int* idx,
                              const bf16* center, const Raw& in,
                              const Shape& sh, const PlanBufs& pb,
                              long long nparts, int blocks,
                              const unsigned* routes, bf16* dx,
                              void* dcenter, float* ws, long long slice,
                              cudaStream_t stream) {
  auto kern = fsm::routed_kernel<C3, SLAB>;
  const size_t smem = fsm::layout(C3, C3 == 128).total;
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  // the views W1^T and W2^T
  const fsm::Mat w1t{in.w1.p, in.w1.s1, in.w1.s0};
  const fsm::Mat w2t{in.w2.p, in.w2.s1, in.w2.s0};
  kern<<<blocks, fsm::kThreads, smem, stream>>>(
      src, idx, center, w1t, w2t, in.b1, routes, sh, pb.masks, pb.cum,
      nparts, dx, dcenter, ws, slice);
  return cudaGetLastError();
}

// After the plan: the routed kernel, the slices' reduction into grads =
// [dW1 | dW2^T | db1 | db2] and db2.
template <bool SLAB>
cudaError_t mma_walk(const bf16* src, const int* idx, const bf16* center,
                     const Raw& in, const Shape& sh, long long nparts,
                     const PlanBufs& pb, int blocks, bf16* dx, void* dcenter,
                     float* ws, float* aux, float* grads,
                     cudaStream_t stream) {
  const long long slice = slice_floats(sh.C1, sh.C2, sh.C3);
  const unsigned* routes = routes_of(aux, sh.C3);
  cudaError_t err =
      sh.C3 == 128
          ? launch_routed_mma<128, SLAB>(src, idx, center, in, sh, pb, nparts,
                                         blocks, routes, dx, dcenter, ws,
                                         slice, stream)
          : launch_routed_mma<256, SLAB>(src, idx, center, in, sh, pb, nparts,
                                         blocks, routes, dx, dcenter, ws,
                                         slice, stream);
  if (err != cudaSuccess) return err;
  fsm::reduce_slices<<<(unsigned)((slice + 255) / 256), 256, 0, stream>>>(
      ws, slice, sh.C3, pb.cum, nparts, blocks, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return db2(in, nparts / sh.nseg, sh.C3, aux, grads + slice, stream);
}

// d_pre's map: a key's reached row, weight 1
struct ReachedRowW {
  ReachedRow r;
  __device__ csr::RowW operator()(int b, int key) const {
    return csr::RowW{r(b, key), 1.0f};
  }
};

}  // namespace

// 1 where the tensor-core design takes widths C1 -> C2 -> C3, else 0 (the
// parent walk); ops/fused_sa.py::backward_bf16_design mirrors it.
extern "C" int tpu3d_fused_sa_bwd_bf16_design(int C1, int C2, int C3) {
  return fsm::takes(C1, C2, C3) ? 1 : 0;
}

// The blocks the backward launches for `groups` (row, center) groups, and
// the floats of one block's workspace slice; the caller sizes the
// workspace from both.
extern "C" int tpu3d_fused_sa_bwd_bf16_blocks(long long groups, int C1,
                                              int C2, int C3) {
  return fsm::takes(C1, C2, C3) ? mma_blocks(groups)
                                : bwd_blocks(groups, per_floats(C1, C2, C3));
}

extern "C" long long tpu3d_fused_sa_bwd_bf16_slice(int C1, int C2, int C3) {
  return slice_floats(C1, C2, C3);
}

// The plan's parts for `groups` groups of S slots (its scratch holds 24
// bytes a part), 0 where the kernels do not take the shape; and the floats
// of the auxiliary buffer (4-byte words).
extern "C" long long tpu3d_fused_sa_bwd_bf16_parts(long long groups, int S,
                                                   int C1, int C2, int C3) {
  Shape sh;
  int tm, nbuf;
  if (fsm::takes(C1, C2, C3))
    return S >= 8 && S % 8 == 0 ? groups * ((S + fsm::kT - 1) / fsm::kT) : 0;
  if (!shape_of(1, 1, S, C1, C2, C3, groups, false, &sh, &tm, &nbuf))
    return 0;
  return groups * sh.nseg;
}

extern "C" long long tpu3d_fused_sa_bwd_bf16_aux(long long groups, int S,
                                                 int C1, int C2, int C3) {
  return aux_floats(groups, tpu3d_fused_sa_bwd_bf16_parts(groups, S, C1, C2,
                                                          C3),
                    C1, C2, C3);
}

// The gather form in two calls. First the plan: from the gradient (bf16 or
// f32, strides gsR, gsM, gsC in elements) where ppre > 0, and argmax (R, M,
// C3) -> the plan's masks, counts and prefix sums in scratch (the reached
// rows in all are its long long at byte 8·nparts + 8·(nparts - 1)), the
// d_center rows that the tiles add into or that nothing reaches zeroed
// (dcenter: bf16 in the tensor-core design at S <= 64, else the f32
// buffer). The parent walk also rounds its operands into aux here. The
// caller reads the total to size `rows`.
extern "C" int tpu3d_fused_sa_bwd_bf16_plan(
    const float* w1, long long w1s0, long long w1s1, const float* b1,
    const float* w2, long long w2s0, long long w2s1, const void* grad,
    int grad_bf16, long long gsR, long long gsM, long long gsC,
    const float* ppre, const int* argmax, int R, int N, int M, int S, int C1,
    int C2, int C3, int blocks, void* dcenter, void* scratch, float* aux,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const Raw in = raw(w1, w1s0, w1s1, b1, w2, w2s0, w2s1, grad, grad_bf16,
                     gsR, gsM, gsC, ppre, argmax, M);
  Shape sh;
  if (fsm::takes(C1, C2, C3)) {
    if (!checked_mma(R, N, M, S, C1, C2, C3, blocks, false, &sh))
      return (int)cudaErrorInvalidValue;
    const long long nparts = (long long)R * M * sh.nseg;
    return (int)mma_plan(false, in, sh, nparts, plan_bufs(scratch, nparts),
                         routes_of(aux, C3), dcenter,
                         (sh.nseg == 1 ? 2 : 4) * C1, stream);
  }
  int tm, nbuf;
  if (!checked<false>(R, N, M, S, C1, C2, C3, blocks, &sh, &tm, &nbuf))
    return (int)cudaErrorInvalidValue;
  const long long nparts = (long long)R * M * sh.nseg;
  cudaError_t err = prep(in, C1, C2, C3, (long long)R * M, aux, stream);
  if (err != cudaSuccess) return (int)err;
  const Launch l{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, prepped(aux, C1, C2, C3).dval, argmax, nullptr,
                 static_cast<float*>(dcenter), nullptr};
  return (int)run_plan<false>(l, sh, nparts, plan_bufs(scratch, nparts),
                              stream);
}

// Then the rest, on the plan's scratch and aux: pre (R, N, C1) and center
// (R, M, C1) bf16, idx (R, M, S), W1 (C1, C2) and W2 (C2, C3) f32 as they
// lie (strides in elements), b1, the gradient, ppre and argmax as the
// plan took them -> dpre (R, N, C1) and dcenter (R, M, C1) bf16, every
// entry written, grads = [dW1 (C1 x C2) | dW2^T (C3 x C2) | db1 (C2) | db2
// (C3)]; ws holds blocks x slice floats (the entries above), dcenter32 the
// f32 d_center (R, M, C1) where the plan took it (the parent walk, or S >
// 64), rows the reached rows' bf16(d_x0) (the plan's total x C1; bf16, or
// f32 in the parent walk), inv the inverse's ints
// (tpu3d_fused_sa_bwd_inverse).
extern "C" int tpu3d_fused_sa_bwd_bf16(
    const bf16* pre, const int* idx, const bf16* center, const float* w1,
    long long w1s0, long long w1s1, const float* b1, const float* w2,
    long long w2s0, long long w2s1, const void* grad, int grad_bf16,
    long long gsR, long long gsM, long long gsC, const float* ppre,
    const int* argmax, int R, int N, int M, int S, int C1, int C2, int C3,
    int blocks, bf16* dpre, bf16* dcenter, float* dcenter32, float* ws,
    void* scratch, float* aux, float* grads, void* rows, int* inv,
    long long inv_ints, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const Raw in = raw(w1, w1s0, w1s1, b1, w2, w2s0, w2s1, grad, grad_bf16,
                     gsR, gsM, gsC, ppre, argmax, M);
  const long long groups = (long long)R * M;
  if (inv_ints < csr::inverse_ints(R, N, (long long)M * S))
    return (int)cudaErrorInvalidValue;
  Shape sh;
  cudaError_t err;
  if (fsm::takes(C1, C2, C3)) {
    if (!checked_mma(R, N, M, S, C1, C2, C3, blocks, false, &sh))
      return (int)cudaErrorInvalidValue;
    const long long nparts = groups * sh.nseg;
    const PlanBufs pb = plan_bufs(scratch, nparts);
    err = mma_walk<false>(pre, idx, center, in, sh, nparts, pb, blocks,
                          static_cast<bf16*>(rows),
                          sh.nseg == 1 ? static_cast<void*>(dcenter)
                                       : static_cast<void*>(dcenter32),
                          ws, aux, grads, stream);
    if (err == cudaSuccess && sh.nseg > 1)
      err = round_out(dcenter32, dcenter, groups * C1, stream);
    if (err == cudaSuccess) err = csr::build(idx, R, N, M, S, inv, stream);
    if (err == cudaSuccess)
      err = csr::sum_rows_bf16(
          static_cast<const bf16*>(rows), R, N, C1, inv, dpre,
          ReachedRowW{ReachedRow{pb.masks, pb.cum, M, S, sh.T, sh.nseg}},
          stream);
    return (int)err;
  }
  const Prepped o = prepped(aux, C1, C2, C3);
  err = db2(in, groups, C3, aux, grads + per_floats(C1, C2, C3), stream);
  if (err != cudaSuccess) return (int)err;
  const int rc = gather_backward<bf16>(
      pre, idx, center, o.w1, o.w1t, o.b1, o.w2t, o.dval, argmax, R, N, M,
      S, C1, C2, C3, blocks, dpre, dcenter32, ws, scratch, grads,
      static_cast<float*>(rows), inv, inv_ints, stream);
  if (rc != 0) return rc;
  return (int)round_out(dcenter32, dcenter, groups * C1, stream);
}

// The slab form, plan included: x0 (R, M, S, C1) bf16 -> dx0 (R, M, S, C1)
// bf16, every entry written, and grads; dx32 the parent walk's f32
// gradient (R, M, S, C1; unused in the tensor-core design); the rest as
// tpu3d_fused_sa_bwd_bf16.
extern "C" int tpu3d_fused_sa_slab_bwd_bf16(
    const bf16* x0, const float* w1, long long w1s0, long long w1s1,
    const float* b1, const float* w2, long long w2s0, long long w2s1,
    const void* grad, int grad_bf16, long long gsR, long long gsM,
    long long gsC, const float* ppre, const int* argmax, int R, int M, int S,
    int C1, int C2, int C3, int blocks, bf16* dx0, float* dx32, float* ws,
    void* scratch, float* aux, float* grads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  const Raw in = raw(w1, w1s0, w1s1, b1, w2, w2s0, w2s1, grad, grad_bf16,
                     gsR, gsM, gsC, ppre, argmax, M);
  const long long groups = (long long)R * M;
  Shape sh;
  cudaError_t err;
  if (fsm::takes(C1, C2, C3)) {
    if (!checked_mma(R, 0, M, S, C1, C2, C3, blocks, true, &sh))
      return (int)cudaErrorInvalidValue;
    const long long nparts = groups * sh.nseg;
    const PlanBufs pb = plan_bufs(scratch, nparts);
    err = mma_plan(true, in, sh, nparts, pb, routes_of(aux, C3), dx0,
                   2 * C1, stream);
    if (err == cudaSuccess)
      err = mma_walk<true>(x0, nullptr, nullptr, in, sh, nparts, pb, blocks,
                           dx0, nullptr, ws, aux, grads, stream);
    return (int)err;
  }
  err = prep(in, C1, C2, C3, groups, aux, stream);
  if (err == cudaSuccess)
    err = db2(in, groups, C3, aux, grads + per_floats(C1, C2, C3), stream);
  if (err != cudaSuccess) return (int)err;
  const Prepped o = prepped(aux, C1, C2, C3);
  const int rc = slab_backward<bf16>(x0, o.w1, o.w1t, o.b1, o.w2t, o.dval,
                                     argmax, R, M, S, C1, C2, C3, blocks,
                                     dx32, ws, scratch, grads, stream);
  if (rc != 0) return rc;
  return (int)round_out(dx32, dx0, groups * S * C1, stream);
}
