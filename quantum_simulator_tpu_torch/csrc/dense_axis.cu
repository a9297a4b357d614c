// dense_axis: one composed <= 128 x 128 operator applied in place along
// one grouped axis of the state, the port's kernel for every
// AxisMatmulStep.
//
// Replaces the Pallas TPU kernel lower_dense
// (quantum_simulator_tpu/ops/pallas_exec.py:178-222, kernel body :200-217),
// whose einsum twin is _dense_spec (quantum_simulator_tpu/ops/plan.py:1024).
//
// The state is viewed as (planes, P, S, Q): each fiber is the S-long
// column x[p, :, q], and x[p, a, q] <- sum_b U[a, b] x[p, b, q]. Three
// variants, as in Pallas: a real U on a real state, a real U on a planar
// state (the two planes are just more fibers), and a complex U on a planar
// state (re <- Ure re - Uim im, im <- Ure im + Uim re, with the imaginary
// plane 2^n elements after the real one). U stays resident in shared
// memory: 64 KB real and 128 KB complex at S = 128.
//
// Bound: at S = 128, 32 FLOP per byte of real state; 3xTF32 on the tensor
// cores for S >= 32, fp32 FMA below; see fiber_matmul.cuh for the design.

#include "fiber_matmul.cuh"

extern "C" int qs_dense_axis(float* x, const float* u, int K, int cplx,
                             int rows, int vec, long long n_outer,
                             long long so, long long n_mid, long long sm,
                             long long n_inner, long long S,
                             long long op_stride, long long bit_stride,
                             long long plane_stride, long long n_batch,
                             long long x_batch_stride,
                             long long op_batch_stride, void* stream) {
  if (K != S || bit_stride != 0) return (int)cudaErrorInvalidValue;
  return qs::dispatch<2, 128>(x, u, K, cplx, rows, vec, n_outer, so, n_mid,
                              sm, n_inner, S, op_stride, bit_stride,
                              plane_stride, n_batch,
                              x_batch_stride, op_batch_stride, stream);
}

extern "C" const char* qs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Fibers per tile for depth K (the wrapper's TILE_FIBERS must agree), or
// -1 for a depth neither kernel takes.
extern "C" int qs_tile_fibers(int K, int cplx) {
  switch (K) {
#define QS_SIMT_F(KK) \
  case KK:            \
    return qs::SimtTile<KK, false>::F;
    QS_SIMT_F(2) QS_SIMT_F(4) QS_SIMT_F(8) QS_SIMT_F(16)
#undef QS_SIMT_F
#define QS_MMA_F(KK)                                   \
  case KK:                                             \
    return cplx ? qs::MmaTile<KK, true, false>::F      \
                : qs::MmaTile<KK, false, false>::F;
    QS_MMA_F(32) QS_MMA_F(64) QS_MMA_F(128) QS_MMA_F(256)
#undef QS_MMA_F
  }
  return -1;
}

// Dynamic shared memory a launch of depth K asks for (ptxas -v does not
// report it), or -1 for a depth neither kernel takes.
extern "C" long long qs_smem_bytes(int K, int cplx, int rows) {
  switch (K) {
#define QS_SIMT_SMEM(KK)                                        \
  case KK:                                                      \
    return cplx ? (long long)qs::SimtTile<KK, true>::smem_bytes \
                : (long long)qs::SimtTile<KK, false>::smem_bytes;
    QS_SIMT_SMEM(2) QS_SIMT_SMEM(4) QS_SIMT_SMEM(8) QS_SIMT_SMEM(16)
#undef QS_SIMT_SMEM
#define QS_MMA_SMEM(KK)                                                 \
  case KK:                                                              \
    if (rows)                                                           \
      return cplx ? (long long)qs::MmaTile<KK, true, true>::smem_bytes  \
                  : (long long)qs::MmaTile<KK, false, true>::smem_bytes; \
    return cplx ? (long long)qs::MmaTile<KK, true, false>::smem_bytes   \
                : (long long)qs::MmaTile<KK, false, false>::smem_bytes;
    QS_MMA_SMEM(32) QS_MMA_SMEM(64) QS_MMA_SMEM(128) QS_MMA_SMEM(256)
#undef QS_MMA_SMEM
  }
  return -1;
}
