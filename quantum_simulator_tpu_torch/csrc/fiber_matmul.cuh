// Shared device code of the dense_axis and cross_bit_axis kernels.
//
// Both group-plan steps are one small matrix applied along a strided
// "fiber" of the state:  Y[r, g] = sum_c W[r, c] X[c, g],  r, c < K.
// A fiber g = (outer o, mid m, inner t), t fastest, starts at element
//   o * so + m * sm + t
// and its row r sits at
//   (r >> ls) * bit_stride + (r & (S - 1)) * op_stride.
// dense_axis uses K = S (no bit term); cross_bit_axis uses K = 2S, the
// sliced bit times the op axis. n_mid, n_inner and S are powers of two.
//
// What bounds it: fp32 FMA on CUDA cores, no TF32, no wgmma / TMA. Per
// output element the kernel does 2K FLOPs (8K for a complex operator)
// and moves 8 bytes of state (16 complex), i.e. 2K/8 FLOP per byte:
// 32 at K = 128 and 64 at K = 256. The H100's fp32 CUDA-core ridge is
// about 67e12 / 3.35e12 = 20 FLOP/byte, so at the main path's widths
// these kernels are bound by fp32 issue, not by bytes. The design keeps
// the FMA units fed: each block stages an RT x K slice of W once
// (transposed, so a warp reads it without bank conflicts) and then walks
// a persistent loop of fiber tiles; each thread holds a TM x TN register
// tile, so a K-deep inner step costs TM + TN shared loads for TM * TN
// (x4 complex) FMAs. A thread keeps 16 tile loads in flight at a time
// (with one block of 256 threads per SM, loads issued one at a time left
// the SM idle on device-memory latency for most of each tile). Loads and stores go through a padded shared tile
// (pitch F + 1) so both the fiber-contiguous and the row-contiguous
// layouts are read and written coalesced.
#pragma once

#include <cuda_runtime.h>

namespace qs {

struct FiberGeom {
  long long n_fib;          // n_outer * n_mid * n_inner
  long long so, sm;         // outer and mid strides, in elements
  long long op_stride, bit_stride;
  long long plane_stride;   // offset of the imaginary plane (complex)
  int li, lm, ls;           // log2 of n_inner, n_mid and S
};

__device__ __forceinline__ long long fiber_base(const FiberGeom& g,
                                                long long f) {
  const long long t = f & ((1LL << g.li) - 1);
  const long long om = f >> g.li;
  const long long m = om & ((1LL << g.lm) - 1);
  return (om >> g.lm) * g.so + m * g.sm + t;
}

__device__ __forceinline__ long long row_offset(const FiberGeom& g, int r) {
  return (long long)(r >> g.ls) * g.bit_stride +
         (long long)(r & ((1 << g.ls) - 1)) * g.op_stride;
}

constexpr int kThreads = 256;

// Tile shape per contraction depth K: RT output rows per block (the W
// slice staged in shared memory), F fibers per tile, and a TM x TN
// register tile per thread (RT * F = 256 * TM * TN). At K = 256 the whole
// operator (256 KB real, 512 KB complex) exceeds the 227 KB a block can
// hold, so the rows are tiled: four blocks share each fiber tile.
template <int K, bool CPLX>
struct Tile {
  static constexpr int RT = K <= 128 ? K : 64;
  static constexpr int F = K <= 128 ? 4096 / K : (CPLX ? 32 : 64);
  static constexpr int TM = RT < 4 ? RT : 4;
  static constexpr int TN = RT * F / (kThreads * TM);
  static constexpr int NP = CPLX ? 2 : 1;
  static constexpr size_t smem_bytes =
      sizeof(float) * NP * ((size_t)K * RT + (size_t)K * (F + 1));
};

template <int K, bool CPLX>
__global__ void __launch_bounds__(kThreads)
fiber_matmul_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ w, FiberGeom g) {
  using T = Tile<K, CPLX>;
  constexpr int RT = T::RT, F = T::F, TM = T::TM, TN = T::TN, NP = T::NP;
  constexpr int FP = F + 1;          // padded pitch of the fiber tile
  constexpr int RG = RT / TM;        // row groups
  constexpr int FG = F / TN;         // fiber groups
  constexpr int LD = K * F / kThreads;  // tile elements each thread loads
  constexpr int CH = LD < 16 ? LD : 16; // loads in flight per thread
  static_assert(RG * FG == kThreads, "tile does not match the block");
  static_assert(LD % CH == 0 && K * F % kThreads == 0, "load batches");

  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                  // [NP][K][RT]: W slice, transposed
  float* xs = smem + NP * K * RT;    // [NP][K][FP]: fiber tile, then Y tile

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * RT;
  for (int e = tid; e < NP * RT * K; e += kThreads) {
    const int p = e / (RT * K);
    const int rem = e - p * RT * K;
    const int rr = rem / K;
    const int c = rem - rr * K;
    wt[(p * K + c) * RT + rr] = w[(long long)p * K * K +
                                  (long long)(r0 + rr) * K + c];
  }

  const int rg = tid % RG;
  const int fg = tid / RG;
  // Lanes walk the fibers when a run of inner fibers is contiguous,
  // else they walk the rows (op_stride == 1 when the op axis is last).
  const bool lanes_on_fibers = (1LL << g.li) >= 32 || (1LL << g.li) >= F;
  const long long n_tiles = (g.n_fib + F - 1) / F;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long f0 = tile * F;
    __syncthreads();  // W staged; the previous tile's stores are done
    // Each thread issues CH loads before it waits on any of them: a
    // loop that stores every load to shared memory at once would wait a
    // full device-memory latency per element.
    for (int b0 = 0; b0 < LD; b0 += CH) {
      float v0[CH], v1[CH];
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int e = tid + (b0 + u) * kThreads;
        const int f = lanes_on_fibers ? e % F : e / K;
        const int c = lanes_on_fibers ? e / F : e % K;
        const long long fib = f0 + f;
        v0[u] = 0.f;
        v1[u] = 0.f;
        if (fib < g.n_fib) {
          const long long a = fiber_base(g, fib) + row_offset(g, c);
          v0[u] = x[a];
          if constexpr (CPLX) v1[u] = x[a + g.plane_stride];
        }
      }
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int e = tid + (b0 + u) * kThreads;
        const int f = lanes_on_fibers ? e % F : e / K;
        const int c = lanes_on_fibers ? e / F : e % K;
        xs[c * FP + f] = v0[u];
        if constexpr (CPLX) xs[(K + c) * FP + f] = v1[u];
      }
    }
    __syncthreads();

    float acc[NP][TM][TN];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[p][i][j] = 0.f;

#pragma unroll 4
    for (int c = 0; c < K; ++c) {
      float wr[TM], xr[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) wr[i] = wt[c * RT + rg + RG * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) xr[j] = xs[c * FP + fg + FG * j];
      if constexpr (CPLX) {
        float wi[TM], xi[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) wi[i] = wt[(K + c) * RT + rg + RG * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) xi[j] = xs[(K + c) * FP + fg + FG * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[0][i][j] = fmaf(wr[i], xr[j], acc[0][i][j]);
            acc[0][i][j] = fmaf(-wi[i], xi[j], acc[0][i][j]);
            acc[1][i][j] = fmaf(wr[i], xi[j], acc[1][i][j]);
            acc[1][i][j] = fmaf(wi[i], xr[j], acc[1][i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[0][i][j] = fmaf(wr[i], xr[j], acc[0][i][j]);
      }
    }
    __syncthreads();  // every thread is done reading the fiber tile

#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          xs[p * K * FP + (rg + RG * i) * FP + fg + FG * j] = acc[p][i][j];
    __syncthreads();

    for (int e = tid; e < RT * F; e += kThreads) {
      const int f = lanes_on_fibers ? e % F : e / RT;
      const int rr = lanes_on_fibers ? e / F : e % RT;
      const long long fib = f0 + f;
      if (fib < g.n_fib) {
        const long long a = fiber_base(g, fib) + row_offset(g, r0 + rr);
        y[a] = xs[rr * FP + f];
        if constexpr (CPLX) y[a + g.plane_stride] = xs[K * FP + rr * FP + f];
      }
    }
  }
}

inline int log2_exact(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return (1LL << l) == v ? l : -1;
}

// Launch on `stream` with one persistent wave of blocks; returns a CUDA
// error code (0 on success), never synchronises.
template <int K, bool CPLX>
int launch(const float* x, float* y, const float* w, const FiberGeom& g,
           cudaStream_t stream) {
  using T = Tile<K, CPLX>;
  auto kernel = fiber_matmul_kernel<K, CPLX>;
  static int resident = 0;  // blocks resident on the whole card
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::smem_bytes);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, T::smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const int row_tiles = K / T::RT;
  const long long n_tiles = (g.n_fib + T::F - 1) / T::F;
  long long gx = resident / row_tiles;
  if (gx < 1) gx = 1;
  if (gx > n_tiles) gx = n_tiles;
  dim3 grid((unsigned)gx, (unsigned)row_tiles);
  kernel<<<grid, kThreads, T::smem_bytes, stream>>>(x, y, w, g);
  return (int)cudaGetLastError();
}

// One case of the K dispatch; depths outside [KMIN, KMAX] are not built.
template <int KK, int KMIN, int KMAX>
int launch_if(const float* x, float* y, const float* w, int cplx,
              const FiberGeom& g, cudaStream_t st) {
  if constexpr (KK >= KMIN && KK <= KMAX) {
    return cplx ? launch<KK, true>(x, y, w, g, st)
                : launch<KK, false>(x, y, w, g, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// Validate the view and dispatch on the contraction depth K.
template <int KMIN, int KMAX>
int dispatch(const float* x, float* y, const float* w, int K, int cplx,
             long long n_outer, long long so, long long n_mid, long long sm,
             long long n_inner, long long S, long long op_stride,
             long long bit_stride, long long plane_stride, void* stream) {
  FiberGeom g;
  g.n_fib = n_outer * n_mid * n_inner;
  g.so = so;
  g.sm = sm;
  g.op_stride = op_stride;
  g.bit_stride = bit_stride;
  g.plane_stride = plane_stride;
  g.li = log2_exact(n_inner);
  g.lm = log2_exact(n_mid);
  g.ls = log2_exact(S);
  if (g.n_fib < 1 || g.li < 0 || g.lm < 0 || g.ls < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 2: return launch_if<2, KMIN, KMAX>(x, y, w, cplx, g, st);
    case 4: return launch_if<4, KMIN, KMAX>(x, y, w, cplx, g, st);
    case 8: return launch_if<8, KMIN, KMAX>(x, y, w, cplx, g, st);
    case 16: return launch_if<16, KMIN, KMAX>(x, y, w, cplx, g, st);
    case 32: return launch_if<32, KMIN, KMAX>(x, y, w, cplx, g, st);
    case 64: return launch_if<64, KMIN, KMAX>(x, y, w, cplx, g, st);
    case 128: return launch_if<128, KMIN, KMAX>(x, y, w, cplx, g, st);
    case 256: return launch_if<256, KMIN, KMAX>(x, y, w, cplx, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace qs
