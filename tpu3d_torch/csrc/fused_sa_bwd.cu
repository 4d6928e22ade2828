// Backward of the fused two-layer MLP + max-pool over grouped points (no
// BatchNorm), for Hopper (sm_90a), in the forward's two forms, on one
// routed kernel.
//
// The gather form replaces tpu3d/ops/fused_sa.py::_nobn2_bwd_kernel (the
// VJP of fused_gathered_mlp_pool(train=True), :926-945); the slab form
// replaces _nobn_bwd_kernel (the VJP of fused_mlp_pool, :666-691), whose
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
//   d_pre[row, idx[s]] += d_x0[s]  (slab: d_slab[group, s] = d_x0[s]),
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
// Design (fused_sa_routed_bwd_kernel, templated on the form: SLAB reads a
// tile's rows from the slab, else gathers them; and on the widths, compiled
// in at the shipped C1 = C2 = 128, C3 128 or 256). The weight gradients are
// summed in the block across many groups: at C1 = C2 = 128 (the RCNN's
// levels) dW1 in registers (each thread an 8 x 8 tile), db1 in registers,
// dW2 in shared memory (transposed, C3 x C2); wider layers take their
// 128 x 128 blocks of dW1 one at a time and add each tile's block into the
// block's own slice of the workspace, and dW2 lives there too where shared
// memory cannot hold it. Only that block writes its slice, each entry by
// one thread at a time in tile order, and a last kernel adds the slices in
// block order, so the weight gradients come out the same from run to run.
//
// The plan. A group's S slots are cut into segments of T slots, T the
// tile's rows (64, or 32 / 16 / 8 where wide layers would overflow shared
// memory); a (group, segment) is a "part". A plan kernel, one warp per
// part over the whole card, takes the T-bit mask of the part's slots that
// its live channels route to (dval != 0 at an argmax inside the segment),
// its count of live channels and of reached slots; it zeroes the d_center
// row of a group that nothing reaches (and, with S > T, every group's, into
// which its tiles add) and, in the slab form, the gradient rows of the
// slots nothing reaches. One block then takes the counts' prefix sums. The
// routed kernel's blocks share the reached rows: each takes a contiguous
// run of whole groups holding about an equal share, at least a tile's
// worth, so a small problem (smoke.yaml's SA_1: 512 groups, a few reached
// slots each) runs on a few blocks with full tiles, and the blocks past the
// rows stop at once; the partials of the blocks that take part are the ones
// reduced.
// Reached slots are packed, whole parts at a time and in slot order, into
// tiles of T rows (a part has at most T reached slots, so it fits an empty
// tile and is never split; a group with S > T spans several parts, and so
// maybe several tiles, whose d_center terms are added in tile order); a
// row's place in its part is the popcount of the mask below its slot. A
// full tile's rows (pre[row, idx] or slab rows) are copied with cp.async
// into shared memory; where it fits the tile buffer is doubled, so the next
// tile's copy is in flight while this one's products run. The products of
// a tile have one call site, so the kernel holds one copy of their code.
//
// The products of a tile. x0 = ReLU(pre - center) (or ReLU(slab)) in
// place; x1 recomputed in 128-column tiles of C2 with a register-tiled
// dense layer (routed_dense: W1 staged a 32-row slice at a time, the next
// slice's loads in flight during this slice's products; warps whose rows
// all lie past the tile's skip the products). Then the routing, chosen by
// the tile's live channels. A dense tile (more than 1/8 of its T x C3
// routing matrix D live: most channels live and a few reached slots per
// group, as seeded weights give) takes d_a1 = D W2^T with the dense layer
// and dW2^T += D^T a1 as a register-tiled product, over 64-channel chunks
// of D staged in shared memory. A sparse tile (a few channels per row, as
// when every slot is reached) takes each part's channels 32 at a time, up
// to 256 loaded at once; warp w adds dval W2^T[c, :] into the rows of d_a1
// with r % 8 == w and dval a1[r, :] into the rows of dW2^T with c % 8 == w,
// four channels' rows in flight together. Each sum is one thread's, in a
// fixed order, either way. d_x1 overwrites a1 in place,
// dW1 / db1 take a0^T d_x1 over the tile's rows, and d_a0 is the dense
// layer again with W1^T, in 128-column tiles of C1; d_x0 leaves the
// registers as one float4 store per thread and row: in the slab form into
// the slab's gradient row, in the gather form into the row's place among
// the launch's reached rows (a buffer of the plan's total rows, which the
// caller reads between the plan and the rest to size it) and through
// shared memory into d_center, summed over each part's rows in order. A
// group's parts all fall in one block (the cuts fall at a group's first
// part), whose tiles run one after another, so one thread at a time adds
// into a d_center row. Pooled rows repeat ids, so several reached rows
// belong to one d_pre row: csr_inverse.cuh inverts idx (each point's list
// of keys group·S + slot) and adds each point's reached rows in ascending
// key order, which is the rows' own order, from +0.0; every d_pre row is
// written once, and the same bits on every call. When every slot is reached (the worst
// case), a tile holds one part of about T rows, and the work is a dense
// walk's plus the plan.
// Widths: C1 and C2 multiples of 128, C3 a multiple of 32; S any multiple
// of 8. The kernels and the launch live in fused_sa_bwd.cuh, which
// fused_sa_bwd_bf16.cu instantiates for bf16 rows too.

#include "fused_sa_bwd.cuh"

// The number of blocks the backward launches for `groups` (row, center)
// groups at widths (C1, C2, C3): about four per SM, fewer where their
// workspace slices would pass 512 MiB; of them, the blocks that take part
// share the reached rows (a tile's worth each at least). The caller sizes the
// workspace from it: blocks x (C1 C2 + C3 C2 + C2) floats.
extern "C" int tpu3d_fused_sa_bwd_blocks(long long groups, int C1, int C2,
                                         int C3) {
  return bwd_blocks(groups, per_floats(C1, C2, C3));
}

// The bytes of the plan's scratch for `groups` groups of S slots at widths
// (C1, C2, C3), 24 a part; 0 where the kernels do not take the shape.
extern "C" long long tpu3d_fused_sa_bwd_scratch(long long groups, int S,
                                                int C1, int C2, int C3) {
  Shape sh;
  int tm, nbuf;
  if (!shape_of(1, 1, S, C1, C2, C3, groups, false, &sh, &tm, &nbuf))
    return 0;
  return 24 * groups * sh.nseg;
}

// Ints of the gather form's inverse of idx (R, N points, M groups of S):
// offsets (R·N + 1), then the keys (R·M·S).
extern "C" long long tpu3d_fused_sa_bwd_inverse(int R, int N, int M, int S) {
  return csr::inverse_ints(R, N, (long long)M * S);
}

// The gather form in two calls. First the plan: dval and argmax (R, M, C3)
// -> the plan's masks, counts and prefix sums in scratch (the reached rows
// in all are its long long at byte 8·nparts + 8·(nparts - 1), nparts =
// scratch bytes / 24), dcenter's rows that the tiles add into or that
// nothing reaches zeroed. The caller reads the total to size `rows`.
extern "C" int tpu3d_fused_sa_bwd_plan(const float* dval, const int* argmax,
                                       int R, int N, int M, int S, int C1,
                                       int C2, int C3, int blocks,
                                       float* dcenter, void* scratch,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (const int pending = tpu3d::pending_error(stream)) return pending;
  Shape sh;
  int tm, nbuf;
  if (!checked<false>(R, N, M, S, C1, C2, C3, blocks, &sh, &tm, &nbuf))
    return (int)cudaErrorInvalidValue;
  const long long nparts = (long long)R * M * sh.nseg;
  const Launch l{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, dval, argmax, nullptr, dcenter, nullptr};
  return (int)run_plan<false>(l, sh, nparts, plan_bufs(scratch, nparts),
                              stream);
}

// Then the rest, on the plan's scratch: pre (R, N, C1), idx (R, M, S),
// center (R, M, C1), w1 (C1, C2) and its transpose w1t, b1 (C2), w2t
// (C3, C2) = W2^T, dval and argmax (R, M, C3) -> dpre (R, N, C1) and
// dcenter (R, M, C1), every entry written, grads = [dW1 (C1 x C2) | dW2^T
// (C3 x C2) | db1 (C2)]; ws holds blocks x (C1 C2 + C3 C2 + C2) floats,
// rows the reached rows' d_x0 (the plan's total x C1 floats), inv the
// inverse's ints (tpu3d_fused_sa_bwd_inverse). The routed kernel writes
// each reached row's d_x0 once; csr_inverse.cuh then adds each point's
// rows into its d_pre row in ascending (group·S + slot) order, so d_pre is
// the same bits on every call.
extern "C" int tpu3d_fused_sa_bwd(const float* pre, const int* idx,
                                  const float* center, const float* w1,
                                  const float* w1t, const float* b1,
                                  const float* w2t, const float* dval,
                                  const int* argmax, int R, int N, int M,
                                  int S, int C1, int C2, int C3, int blocks,
                                  float* dpre, float* dcenter, float* ws,
                                  void* scratch, float* grads, float* rows,
                                  int* inv, long long inv_ints,
                                  void* stream_ptr) {
  return gather_backward<float>(pre, idx, center, w1, w1t, b1, w2t, dval,
                                argmax, R, N, M, S, C1, C2, C3, blocks, dpre,
                                dcenter, ws, scratch, grads, rows, inv,
                                inv_ints,
                                static_cast<cudaStream_t>(stream_ptr));
}

// The slab form: x0 (R, M, S, C1) -> dx0 (R, M, S, C1), every entry
// written; the rest as tpu3d_fused_sa_bwd.
extern "C" int tpu3d_fused_sa_slab_bwd(const float* x0, const float* w1,
                                       const float* w1t, const float* b1,
                                       const float* w2t, const float* dval,
                                       const int* argmax, int R, int M, int S,
                                       int C1, int C2, int C3, int blocks,
                                       float* dx0, float* ws, void* scratch,
                                       float* grads, void* stream_ptr) {
  return slab_backward<float>(x0, w1, w1t, b1, w2t, dval, argmax, R, M, S,
                              C1, C2, C3, blocks, dx0, ws, scratch, grads,
                              static_cast<cudaStream_t>(stream_ptr));
}
