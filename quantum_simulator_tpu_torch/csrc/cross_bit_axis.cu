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
// memory a block can use. A complex operator shared by the whole launch is
// split over the rows of a thread-block cluster, each CTA keeping its rows
// resident and every tile multicast to the cluster; otherwise the operator
// streams from L2 through a double-buffered slab of output rows while the
// block's fiber tile stays resident, one block owning each fiber tile.
//
// Bound: at S = 128, 64 FLOP per byte of real state; 3xTF32 on the tensor
// cores for 2S >= 32, fp32 FMA below; see fiber_matmul.cuh.

#include "fiber_matmul.cuh"

namespace qs {

// A launch takes the cluster kernel when its complex K = 256 operator is
// shared by the whole batch (operator stride 0) and its copies are 16
// bytes wide. The wrapper's takes_cluster (ops/cuda_exec.py) must agree.
inline bool cluster_path(int K, int cplx, long long op_batch_stride,
                         int vec) {
  return K == 256 && cplx && op_batch_stride == 0 && vec == 4;
}

// Complex K = 256: the cluster kernel where cluster_path holds, else the
// streamed tile of the primary launch_k.
template <>
inline int launch_k<256, true>(float* x, const float* w, int rows,
                               const FiberGeom& g, cudaStream_t st) {
  if (cluster_path(256, 1, g.wb, g.vec))
    return rows ? launch_cluster<true>(x, w, g, st)
                : launch_cluster<false>(x, w, g, st);
  if (rows) {
    using T = MmaTile<256, true, true>;
    static int resident = 0;
    return launch_persistent(mma_kernel<256, true, true>, T::smem_bytes,
                             g.n_batch * ((g.n_fib + T::F - 1) / T::F),
                             resident, x, w, g, st);
  }
  using T = MmaTile<256, true, false>;
  static int resident = 0;
  return launch_persistent(mma_kernel<256, true, false>, T::smem_bytes,
                           g.n_batch * ((g.n_fib + T::F - 1) / T::F),
                           resident, x, w, g, st);
}

}  // namespace qs

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

// 1 where a cross_bit_axis launch of these numbers takes the cluster
// kernel, else 0.
extern "C" int qs_cross_path(int K, int cplx, long long op_batch_stride,
                             int vec) {
  return qs::cluster_path(K, cplx, op_batch_stride, vec);
}

// Fibers per tile of the cluster kernel and its dynamic shared memory per
// CTA in either copy layout.
extern "C" int qs_cluster_tile_fibers() { return qs::ClusterTile<false>::F; }

// Clusters of the cluster kernel resident at once on this card in either
// copy layout (0 before its first launch in that layout).
extern "C" int qs_cluster_wave(int rows) {
  return rows ? qs::cluster_wave<true>() : qs::cluster_wave<false>();
}

extern "C" long long qs_cluster_smem_bytes(int rows) {
  return rows ? (long long)qs::ClusterTile<true>::smem_bytes
              : (long long)qs::ClusterTile<false>::smem_bytes;
}
