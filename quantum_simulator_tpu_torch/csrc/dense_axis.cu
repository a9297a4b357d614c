// dense_axis: one composed <= 128 x 128 operator applied along one grouped
// axis of the state, the port's kernel for every AxisMatmulStep.
//
// Replaces the Pallas TPU kernel lower_dense
// (quantum_simulator_tpu/ops/pallas_exec.py:178-222, kernel body :200-217),
// whose einsum twin is _dense_spec (quantum_simulator_tpu/ops/plan.py:1024).
//
// The state is viewed as (planes, P, S, Q): each fiber is the S-long
// column x[p, :, q], and y[p, a, q] = sum_b U[a, b] x[p, b, q]. Three
// variants, as in Pallas: a real U on a real state, a real U on a planar
// state (the two planes are just more fibers), and a complex U on a planar
// state (yre = Ure xre - Uim xim, yim = Ure xim + Uim xre, with the
// imaginary plane 2^n elements after the real one). U is staged whole in
// shared memory: 64 KB real and 128 KB complex at S = 128, above the
// 48 KB default, so the launcher raises the block's dynamic shared-memory
// limit first.
//
// Bound: fp32 issue on CUDA cores (2S FLOPs per 8 bytes of real state, 32
// FLOP/byte at S = 128, above the card's ~20 FLOP/byte fp32 ridge); see
// fiber_matmul.cuh for what the tiling does about it. Out of place.

#include "fiber_matmul.cuh"

extern "C" int qs_dense_axis(const float* x, float* y, const float* u,
                             int K, int cplx, long long n_outer,
                             long long so, long long n_mid, long long sm,
                             long long n_inner, long long S,
                             long long op_stride, long long bit_stride,
                             long long plane_stride, void* stream) {
  if (K != S || bit_stride != 0) return (int)cudaErrorInvalidValue;
  return qs::dispatch<2, 128>(x, y, u, K, cplx, n_outer, so, n_mid, sm,
                              n_inner, S, op_stride, bit_stride,
                              plane_stride, stream);
}

extern "C" const char* qs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a launch of depth K asks for (ptxas -v does not
// report it), or -1 for a depth neither kernel takes.
extern "C" long long qs_smem_bytes(int K, int cplx) {
  switch (K) {
#define QS_SMEM(KK)                                          \
  case KK:                                                   \
    return cplx ? (long long)qs::Tile<KK, true>::smem_bytes  \
                : (long long)qs::Tile<KK, false>::smem_bytes;
    QS_SMEM(2) QS_SMEM(4) QS_SMEM(8) QS_SMEM(16)
    QS_SMEM(32) QS_SMEM(64) QS_SMEM(128) QS_SMEM(256)
#undef QS_SMEM
  }
  return -1;
}
