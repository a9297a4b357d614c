// cross_bit_axis: a gate spanning two grouped axes, with one lone bit on
// one of them, as ONE contraction of depth 2S applied in place; the port's
// kernel for every CrossStep, including gates folded into the cross.
//
// Replaces the Pallas TPU kernel lower_cross
// (quantum_simulator_tpu/ops/pallas_exec.py:229-338, kernel body :289-330),
// whose einsum twin is _cross_spec (quantum_simulator_tpu/ops/plan.py:1039)
// on the _split_axis_bit view (plan.py:1064).
//
//   x[i, ., a, .] <- sum_k sum_b C[i, a, k, b] x[k, ., b, .]
//
// i and k are bit slice_pos of slice_axis; a and b run over op_axis. The
// wrapper reduces the state to a strided view (outer, bit, mid, op, inner)
// or its mirror (outer, op, mid, bit, inner) when op_axis < slice_axis, so
// each fiber is the 2S rows (k, b) and every geometry the planner emits is
// covered, a sliced bit inside the last axis included (Pallas declines it).
// Real C is (2S, 2S), complex C is two such planes (re, im).
//
// Trouble spot: the TPU kernel keeps the whole operator in VMEM. At
// S = 128 it is 256 KB real and 512 KB complex, above the 227 KB of shared
// memory a block can use, so the operator streams from L2 through a
// double-buffered slab of output rows while the block's fiber tile stays
// resident; one block owns each fiber tile.
//
// Bound: at S = 128, 64 FLOP per byte of real state; 3xTF32 on the tensor
// cores for 2S >= 32, fp32 FMA below; see fiber_matmul.cuh.

#include "fiber_matmul.cuh"

extern "C" int qs_cross_bit_axis(float* x, const float* c, int K, int cplx,
                                 int rows, int vec, long long n_outer,
                                 long long so, long long n_mid, long long sm,
                                 long long n_inner, long long S,
                                 long long op_stride, long long bit_stride,
                                 long long plane_stride, long long n_batch,
                                 long long x_batch_stride,
                                 long long op_batch_stride, void* stream) {
  if (K != 2 * S) return (int)cudaErrorInvalidValue;
  return qs::dispatch<4, 256>(x, c, K, cplx, rows, vec, n_outer, so, n_mid,
                              sm, n_inner, S, op_stride, bit_stride,
                              plane_stride, n_batch,
                              x_batch_stride, op_batch_stride, stream);
}
