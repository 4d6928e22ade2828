// The bf16 training forms' backward of kernels 6 and 8, for Hopper
// (sm_90a): the routed walk of fused_sa_bwd.cuh on bf16 rows.
//
// Replaces tpu3d/ops/fused_sa.py::_nobn2_bwd_kernel (the gather form's
// VJP, :900-948) and _nobn_bwd_kernel (the slab form's, :635-691) in their
// bf16 arithmetic (fused_sa_bwd.cuh gives the rounding points): bf16
// operands, each product exact in f32, f32 sums. Bound on the card:
// operations, as the f32 form's (the reached slots' three products of
// layer 1's size), at the bf16 peak. Design: the f32 form's plan, tiles
// and fixed-order sums unchanged, so the bits repeat from call to call;
// the rows come from bf16 memory (half the f32 form's bytes) and the
// products run on the f32 walk's register tiles, not on the tensor cores
// (an mma.sync or wgmma form of the walk is later work). The plan is the
// f32 library's tpu3d_fused_sa_bwd_plan: it reads dval and argmax only.

#include "fused_sa_bwd.cuh"

using bf16 = __nv_bfloat16;

// The gather form: pre (R, N, C1) and center (R, M, C1) bf16; w1, w1t, b1,
// w2t and dval f32 rounded to bf16; the rest as tpu3d_fused_sa_bwd, after
// its plan -> dpre (bf16), dcenter (f32, the caller rounds it), grads.
extern "C" int tpu3d_fused_sa_bwd_bf16(const bf16* pre, const int* idx,
                                       const bf16* center, const float* w1,
                                       const float* w1t, const float* b1,
                                       const float* w2t, const float* dval,
                                       const int* argmax, int R, int N, int M,
                                       int S, int C1, int C2, int C3,
                                       int blocks, bf16* dpre,
                                       float* dcenter, float* ws,
                                       void* scratch, float* grads,
                                       float* rows, int* inv,
                                       long long inv_ints, void* stream_ptr) {
  return gather_backward<bf16>(pre, idx, center, w1, w1t, b1, w2t, dval,
                               argmax, R, N, M, S, C1, C2, C3, blocks, dpre,
                               dcenter, ws, scratch, grads, rows, inv,
                               inv_ints,
                               static_cast<cudaStream_t>(stream_ptr));
}

// The slab form: x0 (R, M, S, C1) bf16 -> dx0 (R, M, S, C1) f32 (the caller
// rounds it), grads; the rest as tpu3d_fused_sa_slab_bwd.
extern "C" int tpu3d_fused_sa_slab_bwd_bf16(const bf16* x0, const float* w1,
                                            const float* w1t, const float* b1,
                                            const float* w2t,
                                            const float* dval,
                                            const int* argmax, int R, int M,
                                            int S, int C1, int C2, int C3,
                                            int blocks, float* dx0, float* ws,
                                            void* scratch, float* grads,
                                            void* stream_ptr) {
  return slab_backward<bf16>(x0, w1, w1t, b1, w2t, dval, argmax, R, M, S, C1,
                             C2, C3, blocks, dx0, ws, scratch, grads,
                             static_cast<cudaStream_t>(stream_ptr));
}
