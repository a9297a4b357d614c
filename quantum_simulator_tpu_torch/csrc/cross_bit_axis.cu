// cross_bit_axis: a gate spanning two grouped axes, with one lone bit on
// one of them, as ONE contraction of depth 2S; the port's kernel for every
// CrossStep, including gates folded into the cross.
//
// Replaces the Pallas TPU kernel lower_cross
// (quantum_simulator_tpu/ops/pallas_exec.py:229-338, kernel body :289-330),
// whose einsum twin is _cross_spec (quantum_simulator_tpu/ops/plan.py:1039)
// on the _split_axis_bit view (plan.py:1064).
//
//   y[i, ., a, .] = sum_k sum_b C[i, a, k, b] x[k, ., b, .]
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
// memory a block can use, so the 2S output rows are tiled: a block stages
// a 64-row x 256-deep slice of C and four row tiles cover each fiber tile.
//
// Bound: fp32 issue on CUDA cores (4S FLOPs per 8 bytes of real state, 64
// FLOP/byte at S = 128); see fiber_matmul.cuh. Out of place.

#include "fiber_matmul.cuh"

extern "C" int qs_cross_bit_axis(const float* x, float* y, const float* c,
                                 int K, int cplx, long long n_outer,
                                 long long so, long long n_mid, long long sm,
                                 long long n_inner, long long S,
                                 long long op_stride, long long bit_stride,
                                 long long plane_stride, void* stream) {
  if (K != 2 * S) return (int)cudaErrorInvalidValue;
  return qs::dispatch<4, 256>(x, y, c, K, cplx, n_outer, so, n_mid, sm,
                              n_inner, S, op_stride, bit_stride,
                              plane_stride, stream);
}
