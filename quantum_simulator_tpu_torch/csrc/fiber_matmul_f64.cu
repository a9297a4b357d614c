// dense_axis_f64 and cross_bit_axis_f64: the float64 forms of the two
// group-plan kernels, for the complex128 verification mode
// (config.enable_complex128). Every dense and cross step of a float64
// state on the card launches one of them.
//
// Replaces, in float64, the Pallas TPU kernels of
// quantum_simulator_tpu/ops/pallas_exec.py: lower_dense (:178, body
// :200-217) and lower_cross (:229, body :289-330), reached through _call
// (:137, pl.pallas_call at :150). The JAX package computes its complex128
// mode with the per-gate einsum off the TPU (ops/program.py:342-348); the
// port keeps its group plan and needs float64 kernels for it. They compute
// what dense_axis / cross_bit_axis compute (fiber_matmul.cuh has the
// geometry):
//   X[r, g] <- sum_c W[r, c] X[c, g],  r, c < K,
// in place along every strided fiber g, K = S (dense) or 2S (cross) from
// 2 to 256, real or complex operator, real or planar state, batched with a
// per-trajectory or shared (stride 0) operator.
//
// Bound on an H100 SXM: per output element 2K FLOPs (8K complex) for
// 16 bytes of state moved (32 complex), i.e. 16 FLOP/byte at K = 128 and
// 32 at K = 256, above the FP64 ridge (67 TFLOP/s on the tensor cores over
// 3.35 TB/s = 20 FLOP/byte at K = 256; 34 TFLOP/s of FMA), so the large-K
// steps are bound by operations: n = 28, complex K = 128 is 2.75e11 FLOP,
// 4.10 ms at 67 TFLOP/s, 8.1 ms at the FMA rate.
//
// Design: plain FP64 FMA on the CUDA cores (no TF32 in any form, no
// tensor-core DMMA yet). Trouble spot: the float32 template keeps a
// K <= 128 operator resident in shared memory; in float64 a complex
// K = 128 operator is 256 KiB and the K = 256 cross operator 1 MiB, more
// than the 227 KB a block may use. So the operator streams through shared
// memory in slabs of KC columns along the contraction, beside the matching
// KC rows of the block's fiber tile, while each thread accumulates its
// TM x TN outputs (both planes) in registers across all slabs. One block
// owns each tile of F fibers and writes its outputs only after its last
// slab, through shared memory so the stores run along the contiguous
// dimension, so the in-place write is safe (as input_output_aliases in
// Pallas). Every block streams the same operator, which stays in the
// 50 MB L2.

#include "fiber_matmul.cuh"

namespace qs {

template <int K, bool CPLX>
struct F64Tile {
  static constexpr int NP = CPLX ? 2 : 1;
  static constexpr int TM = K < 4 ? K : 4;   // output rows per thread
  static constexpr int TN = 4;               // fibers per thread
  static constexpr int F = kThreads * TM * TN / K;   // fibers per tile
  static constexpr int RG = K / TM;          // row groups
  static constexpr int FG = F / TN;          // fiber groups
  static constexpr int KC = K < 16 ? K : 16; // contraction depth of a slab
  static constexpr int WP = K + 1;           // pitch of a transposed W row
  static constexpr int XP = F + 1;           // pitch of a tile row
  static constexpr size_t slab = (size_t)NP * KC * (WP + XP);
  static constexpr size_t stage = (size_t)NP * K * XP;
  static constexpr size_t smem_bytes =
      sizeof(double) * (slab > stage ? slab : stage);
  static_assert(RG * FG == kThreads, "thread grid");
  static_assert(K % KC == 0 && F % TN == 0, "tiles");
  static_assert(smem_bytes <= 232448, "shared memory");
};

template <int K, bool CPLX>
__global__ void __launch_bounds__(kThreads)
f64_kernel(double* x, const double* __restrict__ w, FiberGeom g) {
  using T = F64Tile<K, CPLX>;
  constexpr int NP = T::NP, TM = T::TM, TN = T::TN, F = T::F, RG = T::RG,
                FG = T::FG, KC = T::KC, WP = T::WP, XP = T::XP;

  extern __shared__ __align__(16) double dsmem[];
  double* ws = dsmem;                      // [NP][KC][WP]: W slab, transposed
  double* xs = dsmem + NP * KC * WP;       // [NP][KC][XP]: tile rows of slab
  double* st = dsmem;                      // [NP][K][XP]: epilogue staging

  const int tid = threadIdx.x;
  const int rg = tid % RG;
  const int fg = tid / RG;
  // Lanes walk the fibers when a run of inner fibers is contiguous, else
  // the rows (op_stride == 1 when the op axis is last).
  const bool lanes_on_fibers = (1LL << g.li) >= 32 || (1LL << g.li) >= F;
  const long long tpt = (g.n_fib + F - 1) / F;   // tiles per trajectory
  const long long n_tiles = tpt * g.n_batch;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b = tile / tpt;
    const long long f0 = (tile - b * tpt) * F;
    double* xt = x + b * g.xb;
    const double* wt = w + b * g.wb;

    double acc[NP][TM][TN];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[p][i][j] = 0.0;

    for (int c0 = 0; c0 < K; c0 += KC) {
      // the previous slab's (or tile's staging) reads are done
      __syncthreads();
      for (int e = tid; e < NP * K * KC; e += kThreads) {
        const int p = e / (K * KC);
        const int rem = e - p * K * KC;
        const int r = rem / KC;
        const int c = rem - r * KC;
        ws[(p * KC + c) * WP + r] = wt[((long long)p * K + r) * K + c0 + c];
      }
      for (int e = tid; e < NP * KC * F; e += kThreads) {
        const int p = e / (KC * F);
        const int q = e - p * KC * F;
        const int f = lanes_on_fibers ? q % F : q / KC;
        const int c = lanes_on_fibers ? q / F : q % KC;
        const long long fib = f0 + f;
        double v = 0.0;
        if (fib < g.n_fib)
          v = xt[p * g.plane_stride + fiber_base(g, fib) +
                 row_offset(g, c0 + c)];
        xs[(p * KC + c) * XP + f] = v;
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < KC; ++c) {
        double wr[TM], xr[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) wr[i] = ws[c * WP + rg + RG * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) xr[j] = xs[c * XP + fg + FG * j];
        if constexpr (CPLX) {
          double wi[TM], xi[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            wi[i] = ws[(KC + c) * WP + rg + RG * i];
#pragma unroll
          for (int j = 0; j < TN; ++j)
            xi[j] = xs[(KC + c) * XP + fg + FG * j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc[0][i][j] = fma(wr[i], xr[j], acc[0][i][j]);
              acc[0][i][j] = fma(-wi[i], xi[j], acc[0][i][j]);
              acc[1][i][j] = fma(wr[i], xi[j], acc[1][i][j]);
              acc[1][i][j] = fma(wi[i], xr[j], acc[1][i][j]);
            }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[0][i][j] = fma(wr[i], xr[j], acc[0][i][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with the last slab

    // Epilogue: stage the tile's outputs, then store them in place along
    // the contiguous dimension.
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          st[(p * K + rg + RG * i) * XP + fg + FG * j] = acc[p][i][j];
    __syncthreads();
    for (int e = tid; e < NP * K * F; e += kThreads) {
      const int p = e / (K * F);
      const int q = e - p * K * F;
      const int f = lanes_on_fibers ? q % F : q / K;
      const int r = lanes_on_fibers ? q / F : q % K;
      const long long fib = f0 + f;
      if (fib < g.n_fib)
        xt[p * g.plane_stride + fiber_base(g, fib) + row_offset(g, r)] =
            st[(p * K + r) * XP + f];
    }
  }
}

// One persistent wave of blocks on `stream`; returns a CUDA error code
// (0 on success), never synchronises. `resident` caches blocks per card.
template <int K, bool CPLX>
int launch_f64(double* x, const double* w, const FiberGeom& g,
               cudaStream_t stream) {
  using T = F64Tile<K, CPLX>;
  static int resident = 0;
  auto kernel = f64_kernel<K, CPLX>;
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::smem_bytes);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads,
                                                        T::smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const long long n_tiles = g.n_batch * ((g.n_fib + T::F - 1) / T::F);
  const long long gx = n_tiles < resident ? n_tiles : resident;
  kernel<<<(unsigned)gx, kThreads, T::smem_bytes, stream>>>(x, w, g);
  return (int)cudaGetLastError();
}

template <int K>
int launch_f64_k(double* x, const double* w, int cplx, const FiberGeom& g,
                 cudaStream_t st) {
  return cplx ? launch_f64<K, true>(x, w, g, st)
              : launch_f64<K, false>(x, w, g, st);
}

// Validate the view, then dispatch on the depth K. The wrapper's copy
// plan (rows, vec) is checked for consistency; the kernel itself reads
// and writes one double at a time.
int dispatch_f64(double* x, const double* w, int K, int cplx, int rows,
                 int vec, long long n_outer, long long so, long long n_mid,
                 long long sm, long long n_inner, long long S,
                 long long op_stride, long long bit_stride,
                 long long plane_stride, long long n_batch,
                 long long x_batch_stride, long long op_batch_stride,
                 void* stream) {
  FiberGeom g;
  g.n_fib = n_outer * n_mid * n_inner;
  g.n_batch = n_batch;
  g.xb = x_batch_stride;
  g.wb = op_batch_stride;
  g.so = so;
  g.sm = sm;
  g.op_stride = op_stride;
  g.bit_stride = bit_stride;
  g.plane_stride = plane_stride;
  g.li = log2_exact(n_inner);
  g.lm = log2_exact(n_mid);
  g.ls = log2_exact(S);
  g.vec = vec;
  if (g.n_fib < 1 || g.li < 0 || g.lm < 0 || g.ls < 0 || n_batch < 1 ||
      x_batch_stride < 0 || op_batch_stride < 0 ||
      (vec != 1 && vec != 2 && vec != 4) ||
      (rows && (n_inner != 1 || op_stride != 1)) ||
      reinterpret_cast<uintptr_t>(x) % sizeof(double) ||
      reinterpret_cast<uintptr_t>(w) % sizeof(double))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 2: return launch_f64_k<2>(x, w, cplx, g, st);
    case 4: return launch_f64_k<4>(x, w, cplx, g, st);
    case 8: return launch_f64_k<8>(x, w, cplx, g, st);
    case 16: return launch_f64_k<16>(x, w, cplx, g, st);
    case 32: return launch_f64_k<32>(x, w, cplx, g, st);
    case 64: return launch_f64_k<64>(x, w, cplx, g, st);
    case 128: return launch_f64_k<128>(x, w, cplx, g, st);
    case 256: return launch_f64_k<256>(x, w, cplx, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace qs

extern "C" int qs_dense_axis_f64(double* x, const double* u, int K, int cplx,
                                 int rows, int vec, long long n_outer,
                                 long long so, long long n_mid, long long sm,
                                 long long n_inner, long long S,
                                 long long op_stride, long long bit_stride,
                                 long long plane_stride, long long n_batch,
                                 long long x_batch_stride,
                                 long long op_batch_stride, void* stream) {
  if (K != S || bit_stride != 0 || K > 128) return (int)cudaErrorInvalidValue;
  return qs::dispatch_f64(x, u, K, cplx, rows, vec, n_outer, so, n_mid, sm,
                          n_inner, S, op_stride, bit_stride, plane_stride,
                          n_batch, x_batch_stride, op_batch_stride, stream);
}

extern "C" int qs_cross_bit_axis_f64(double* x, const double* c, int K,
                                     int cplx, int rows, int vec,
                                     long long n_outer, long long so,
                                     long long n_mid, long long sm,
                                     long long n_inner, long long S,
                                     long long op_stride,
                                     long long bit_stride,
                                     long long plane_stride,
                                     long long n_batch,
                                     long long x_batch_stride,
                                     long long op_batch_stride,
                                     void* stream) {
  if (K != 2 * S || K < 4) return (int)cudaErrorInvalidValue;
  return qs::dispatch_f64(x, c, K, cplx, rows, vec, n_outer, so, n_mid, sm,
                          n_inner, S, op_stride, bit_stride, plane_stride,
                          n_batch, x_batch_stride, op_batch_stride, stream);
}

