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
// 3.35 TB/s = 20 FLOP/byte), so the large-K steps are bound by operations:
// n = 28, complex K = 128 is 2.75e11 FLOP, 4.10 ms; K = 256 5.50e11 FLOP,
// 8.21 ms. Plain FP64 FMA peaks near 34 TFLOP/s, half of that.
//
// Design, K >= kF64MmaMinK (16): the products run on the FP64 tensor
// cores, mma.sync.m16n8k8.f64 (DMMA; wgmma has no float64 form). Every
// value stays float64: no TF32, no 3M trick; a complex product is four
// real products, per 8-deep step re += Wr Xr then (-Wi) Xi and im += Wi Xr
// then Wr Xi (the negation is exact), so only one plane of the fiber
// slab's fragments is live at a time. A block owns a tile of F fibers and
// keeps all K output rows of it, both planes, in registers (MT x NT m16n8
// accumulators per warp and plane, 64 doubles a thread at the large
// depths); the operator and the tile's rows stream through shared memory
// in slabs of KC = 16 columns of W and the matching 16 rows of X. The
// block writes its tile straight from the accumulators after its last
// slab, so the in-place write is safe (one owner per tile, as
// input_output_aliases in Pallas).
// * Copies: a ring of STAGES (2-4) slabs filled by cp.async, 16 bytes
//   (2 doubles) along whichever dimension is contiguous (the wrapper's
//   float64 copy plan, vec in doubles), so the next slabs are in flight
//   while the products of this one run; the ring runs on across tiles, so
//   the next tile's first slabs load during this tile's last products and
//   its stores.
// * Shared-memory layout: operator slab rows of 16 doubles, unpadded, the
//   16-byte chunk c of row r at c ^ 4 (r & 1); the fiber slab the same way
//   per fiber (rows contiguous), or as rows of F fibers at a pitch of
//   F + 2 (fibers contiguous). The contraction index of an 8-deep step is
//   paired (fragment column tig is k0 + 2 tig, column tig + 4 is
//   k0 + 2 tig + 1, for both operands), so a thread reads its two values
//   of an operator row (or of a fiber) as one 16-byte load; the swizzle
//   and the pitch keep every fragment load free of bank conflicts.
// * Tile sizes are set by the accumulators: F = 32 fibers at complex
//   K = 256, 64 at complex K = 128 (twice the FMA kernel's), 64-256
//   elsewhere.
//
// Operator traffic. Every tile streams the whole operator (NP K^2 doubles)
// once, from L2 (every block reads the same operator, and a batched walk
// is trajectory-major, so a trajectory's operator stays in the 50 MB L2
// while its tiles run). At the n = 28 Ry/Rz step shapes (a complex
// operator on a planar state of 2^28 elements a plane):
//   dense K = 128: 2^21 fibers / F 64 = 32768 tiles x 256 KiB = 8 GiB
//                  (the FMA kernel: F 32, 16 GiB);
//   cross K = 256: 2^20 fibers / F 32 = 32768 tiles x 1 MiB  = 32 GiB
//                  (the FMA kernel: F 16, 64 GiB);
// against 8 GiB of state moved to and from HBM. At half the bound
// (16.4 ms) the cross launch then reads about 2.1 TB/s of L2. A cluster
// of blocks sharing each operator slab over distributed shared memory
// would divide that by the cluster size; this design does not use one,
// because the cross launch, with four times the dense one's operator
// bytes, reaches the higher share of its bound (PERF.md's kernel table): L2 is
// not what limits either.
//
// Below kF64MmaMinK (K = 2, 4, 8: the leading axis of small n and cross
// steps on a 2- or 4-wide op axis) a step moves 16 bytes per 2K <= 16
// FLOPs, far below the ridge, and a 16-row DMMA tile would be mostly
// padding, so plain FP64 FMA serves it (F64FmaTile below).
//
// A batch of trajectories: trajectory b's state starts b * xb doubles in
// and its operator b * wb (wb = 0: one operator shared by all); tiles walk
// (trajectory, tile) pairs in trajectory-major order, a tile never spans
// two trajectories, and each trajectory's ragged last tile is masked
// (zero-filled copies, no stores).

#include "fiber_matmul.cuh"

namespace qs {

// Persistent launch of a float64 kernel: one wave of blocks on `stream`;
// returns a CUDA error code (0 on success), never synchronises.
// `resident` caches blocks per card.
template <class Kernel>
int launch_f64_persistent(Kernel kernel, size_t smem, long long n_tiles,
                          int& resident, double* x, const double* w,
                          const FiberGeom& g, cudaStream_t stream) {
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const long long gx = n_tiles < resident ? n_tiles : resident;
  kernel<<<(unsigned)gx, kThreads, smem, stream>>>(x, w, g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA path (K < kF64MmaMinK): a TM x TN register tile per thread
// ---------------------------------------------------------------------------

template <int K, bool CPLX>
struct F64FmaTile {
  static constexpr int NP = CPLX ? 2 : 1;
  static constexpr int TM = K < 4 ? K : 4;   // output rows per thread
  static constexpr int TN = 4;               // fibers per thread
  static constexpr int F = kThreads * TM * TN / K;   // fibers per tile
  static constexpr int RG = K / TM;          // row groups
  static constexpr int FG = F / TN;          // fiber groups
  static constexpr int WP = K + 1;           // pitch of a transposed W row
  static constexpr int XP = F + 1;           // pitch of a tile row
  static constexpr size_t smem_bytes =
      sizeof(double) * NP * ((size_t)K * WP + (size_t)K * XP);
  static_assert(RG * FG == kThreads, "thread grid");
  static_assert(smem_bytes <= 232448, "shared memory");
};

template <int K, bool CPLX>
__global__ void __launch_bounds__(kThreads)
f64_fma_kernel(double* x, const double* __restrict__ w, FiberGeom g) {
  using T = F64FmaTile<K, CPLX>;
  constexpr int NP = T::NP, TM = T::TM, TN = T::TN, F = T::F, RG = T::RG,
                FG = T::FG, WP = T::WP, XP = T::XP;

  extern __shared__ __align__(16) double dsmem[];
  double* ws = dsmem;                      // [NP][K][WP]: W, transposed
  double* xs = dsmem + NP * K * WP;        // [NP][K][XP]: tile, then result

  const int tid = threadIdx.x;
  const int rg = tid % RG;
  const int fg = tid / RG;
  // Lanes walk the fibers when a run of inner fibers is contiguous, else
  // the rows (op_stride == 1 when the op axis is last).
  const bool lanes_on_fibers = (1LL << g.li) >= 32 || (1LL << g.li) >= F;
  const long long tpt = (g.n_fib + F - 1) / F;   // tiles per trajectory
  const long long n_tiles = tpt * g.n_batch;
  const double* staged = nullptr;          // the operator now in ws

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b = tile / tpt;
    const long long f0 = (tile - b * tpt) * F;
    double* xt = x + b * g.xb;
    const double* wt = w + b * g.wb;
    // the previous tile's stores have read xs, and its products ws
    __syncthreads();
    if (wt != staged) {
      for (int e = tid; e < NP * K * K; e += kThreads) {
        const int p = e / (K * K);
        const int rem = e - p * K * K;
        const int r = rem / K;
        const int c = rem - r * K;
        ws[(p * K + c) * WP + r] = wt[e];
      }
      staged = wt;
    }
    for (int e = tid; e < NP * K * F; e += kThreads) {
      const int p = e / (K * F);
      const int q = e - p * K * F;
      const int f = lanes_on_fibers ? q % F : q / K;
      const int c = lanes_on_fibers ? q / F : q % K;
      const long long fib = f0 + f;
      double v = 0.0;
      if (fib < g.n_fib)
        v = xt[p * g.plane_stride + fiber_base(g, fib) + row_offset(g, c)];
      xs[(p * K + c) * XP + f] = v;
    }
    __syncthreads();

    double acc[NP][TM][TN];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[p][i][j] = 0.0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      double wr[TM], xr[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) wr[i] = ws[c * WP + rg + RG * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) xr[j] = xs[c * XP + fg + FG * j];
      if constexpr (CPLX) {
        double wi[TM], xi[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) wi[i] = ws[(K + c) * WP + rg + RG * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) xi[j] = xs[(K + c) * XP + fg + FG * j];
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
    __syncthreads();  // every thread is done reading the tile

    // Epilogue: stage over the tile, then store along the contiguous
    // dimension.
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          xs[(p * K + rg + RG * i) * XP + fg + FG * j] = acc[p][i][j];
    __syncthreads();
    for (int e = tid; e < NP * K * F; e += kThreads) {
      const int p = e / (K * F);
      const int q = e - p * K * F;
      const int f = lanes_on_fibers ? q % F : q / K;
      const int r = lanes_on_fibers ? q / F : q % K;
      const long long fib = f0 + f;
      if (fib < g.n_fib)
        xt[p * g.plane_stride + fiber_base(g, fib) + row_offset(g, r)] =
            xs[(p * K + r) * XP + f];
    }
  }
}

// ---------------------------------------------------------------------------
// DMMA path (K >= kF64MmaMinK)
// ---------------------------------------------------------------------------

constexpr int kF64MmaMinK = 16;
constexpr int kF64KC = 16;               // contraction depth of a slab
constexpr int kSmemPerBlock = 232448;    // H100: 227 KB a block

// Tile shape per depth: F fibers; a warp grid of WM row groups x WN fiber
// groups (WM WN = 8 warps), each warp MT x NT m16n8 accumulators per plane
// (MT 16 WM = K, NT 8 WN = F). Complex: 2 x 8 tiles, real: 16 tiles of
// 4 doubles a thread at K >= 64, half that below (where the fiber slab,
// not the accumulators, sets F).
struct F64Shape {
  int F, WM, MT, NT;
};

constexpr F64Shape f64_shape(int K, bool cplx) {
  if (cplx) {
    return K == 256   ? F64Shape{32, 8, 2, 4}
           : K == 128 ? F64Shape{64, 4, 2, 4}
           : K == 64  ? F64Shape{128, 2, 2, 4}
           : K == 32  ? F64Shape{256, 1, 2, 4}
                      : F64Shape{256, 1, 1, 4};
  }
  return K == 256   ? F64Shape{64, 4, 4, 4}
         : K == 128 ? F64Shape{128, 2, 4, 4}
         : K == 64  ? F64Shape{256, 1, 4, 4}
         : K == 32  ? F64Shape{256, 1, 2, 4}
                    : F64Shape{256, 1, 1, 4};
}

template <int K, bool CPLX>
struct F64MmaTile {
  static constexpr F64Shape SH = f64_shape(K, CPLX);
  static constexpr int NP = CPLX ? 2 : 1;
  static constexpr int F = SH.F, WM = SH.WM, MT = SH.MT, NT = SH.NT;
  static constexpr int WN = kThreads / 32 / WM;
  static constexpr int KC = kF64KC;
  static constexpr int NS = K / KC;        // slabs per tile
  static constexpr int WPL = K * KC;       // doubles of an operator slab plane
  static constexpr int XP = F + 2;         // pitch of a row of F fibers
  static constexpr int XPL = KC * XP;      // doubles of a fiber slab plane
  static constexpr int STAGE = NP * (WPL + XPL);
  static constexpr int FIT = kSmemPerBlock / (int)(sizeof(double) * STAGE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t smem_bytes = sizeof(double) * (size_t)STAGE * STAGES;
  static_assert(WM * WN * 32 == kThreads, "warp grid");
  static_assert(MT * 16 * WM == K && NT * 8 * WN == F, "warp tiles");
  static_assert(K % KC == 0 && F % 16 == 0, "slabs");
  static_assert(STAGES >= 2, "shared memory");
};

// Offset of element (r, k) of a slab row of KC = 16 doubles (an operator
// row, or one fiber's rows): 16-byte chunk c of row r sits at c ^ 4 (r & 1).
__device__ __forceinline__ int kmajor(int r, int k) {
  return r * kF64KC + ((((k >> 1) ^ ((r & 1) << 2))) << 1) + (k & 1);
}


template <int BYTES>
__device__ __forceinline__ void cp_async_f64(double* dst, const double* src,
                                             bool valid) {
  cp_async<BYTES>(reinterpret_cast<float*>(dst),
                  reinterpret_cast<const float*>(src), valid);
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b on the FP64 tensor cores
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Copies of one slab into a ring stage: columns [c0, c0 + KC) of every
// operator row and plane, and rows [c0, c0 + KC) of the tile's F fibers
// (fibers past n_fib are zero-filled). VEC doubles a copy, along the rows
// of a fiber (ROWS) or along a run of fibers.
template <class T, int K, int VEC, bool ROWS>
__device__ __forceinline__ void issue_slab(double* stage, const double* x,
                                           const double* w,
                                           const FiberGeom& g, long long f0,
                                           int c0) {
  constexpr int KC = T::KC, F = T::F;
  // Operator: a thread copies chunk c of rows pr, pr + 32, ... (pr = p K +
  // r over both planes), so its addresses step by a constant. The copy
  // loops stay rolled: unrolled, their addresses would be held in
  // registers the accumulators need.
  {
    constexpr int STEP = kThreads / (KC / 2);
    const int c = threadIdx.x % (KC / 2);
    int pr = threadIdx.x / (KC / 2);
    double* dst = stage + pr * KC + ((c ^ ((pr & 1) << 2)) << 1);
    const double* src = w + (long long)pr * K + c0 + 2 * c;
#pragma unroll 1
    for (; pr < T::NP * K; pr += STEP, dst += STEP * KC, src += STEP * K)
      cp_async_f64<16>(dst, src, true);
  }
  double* xs = stage + T::NP * T::WPL;
  constexpr int PER_PLANE = KC * F / VEC;
#pragma unroll 1
  for (int e = threadIdx.x; e < T::NP * PER_PLANE; e += kThreads) {
    const int p = e / PER_PLANE;
    const int q = e - p * PER_PLANE;
    int k, f;
    if constexpr (ROWS) {
      k = (q % (KC / VEC)) * VEC;
      f = q / (KC / VEC);
    } else {
      f = (q % (F / VEC)) * VEC;
      k = q / (F / VEC);
    }
    const long long fib = f0 + f;
    const bool valid = fib < g.n_fib;
    const double* src = valid ? x + p * g.plane_stride + fiber_base(g, fib) +
                                    row_offset(g, c0 + k)
                              : x;
    cp_async_f64<8 * VEC>(
        xs + p * T::XPL + (ROWS ? kmajor(f, k) : k * T::XP + f), src,
        valid);
  }
}

template <int K, bool CPLX, bool ROWS>
__global__ void __launch_bounds__(kThreads, 1)
f64_mma_kernel(double* x, const double* __restrict__ w, FiberGeom g) {
  using T = F64MmaTile<K, CPLX>;
  constexpr int NP = T::NP, F = T::F, MT = T::MT, NT = T::NT, NS = T::NS,
                KC = T::KC, STAGES = T::STAGES;

  extern __shared__ __align__(16) double dsmem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m_base = (warp % T::WM) * MT * 16;
  const int n_base = (warp / T::WM) * NT * 8;
  const long long tpt = (g.n_fib + F - 1) / F;   // tiles per trajectory
  const long long n_tiles = tpt * g.n_batch;
  // This block's tiles: blockIdx.x, + gridDim.x, ... (trajectory-major:
  // the blocks of the wave work on neighbouring tiles of one trajectory).
  const long long my_tiles =
      n_tiles > blockIdx.x ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  // The copy cursor: the next slab to copy is slab i_s of tile i_tile
  // (trajectory i_b, first fiber i_f0). issue() copies it into ring stage
  // `slot` and advances; one commit group per slab, empty past the end.
  long long i_tile = blockIdx.x;
  long long i_b = i_tile / tpt;
  long long i_f0 = (i_tile - i_b * tpt) * F;
  int i_s = 0;
  auto issue = [&](int slot) {
    if (i_tile < n_tiles) {
      double* stage = dsmem + slot * T::STAGE;
      if (g.vec == 2)
        issue_slab<T, K, 2, ROWS>(stage, x + i_b * g.xb, w + i_b * g.wb, g,
                                  i_f0, i_s * KC);
      else
        issue_slab<T, K, 1, ROWS>(stage, x + i_b * g.xb, w + i_b * g.wb, g,
                                  i_f0, i_s * KC);
      if (++i_s == NS) {
        i_s = 0;
        i_tile += gridDim.x;
        i_b = i_tile / tpt;
        i_f0 = (i_tile - i_b * tpt) * F;
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  double acc[NP][MT][NT][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] = 0.0;

  int slot = 0;                          // ring stage of the current slab
  for (long long it = 0; it < my_tiles; ++it) {
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      cp_async_wait_group<STAGES - 2>();   // this slab has landed (own copies)
      // Everyone's copies of this slab are visible, and every warp is done
      // with the previous one, whose stage the next issue refills.
      __syncthreads();
      issue(slot == 0 ? STAGES - 1 : slot - 1);

      const double* ws = dsmem + slot * T::STAGE;
      const double* xs = ws + NP * T::WPL;
      // Not unrolled: hoisting the next step's fragment loads over this
      // step's products would cost more registers than the accumulators
      // leave (64 doubles a thread); the other warp of the SM sub-partition
      // covers the load latency.
#pragma unroll 1
      for (int kk = 0; kk < KC; kk += 8) {
        // Plane h of the fiber slab against the operator: h = 0 (Xr) adds
        // Wr Xr to re and Wi Xr to im, h = 1 (Xi) adds (-Wi) Xi to re and
        // Wr Xi to im. One plane of B fragments is live at a time.
#pragma unroll
        for (int h = 0; h < NP; ++h) {
          // B fragments: rows kk + 2 tig and kk + 2 tig + 1 of fiber
          // n_base + 8 nt + gid
          const double* xp = xs + h * T::XPL;
          double b[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int f = n_base + nt * 8 + gid;
            if constexpr (ROWS) {
              const double2 v = *reinterpret_cast<const double2*>(
                  xp + kmajor(f, kk + 2 * tig));
              b[nt][0] = v.x;
              b[nt][1] = v.y;
            } else {
              b[nt][0] = xp[(kk + 2 * tig) * T::XP + f];
              b[nt][1] = xp[(kk + 2 * tig + 1) * T::XP + f];
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // A fragments: rows r and r + 8, columns kk + 2 tig (+1), of
            // each operator plane
            const int r = m_base + mt * 16 + gid;
            double a[NP][4];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const double* wp = ws + p * T::WPL;
              const double2 lo = *reinterpret_cast<const double2*>(
                  wp + kmajor(r, kk + 2 * tig));
              const double2 hi = *reinterpret_cast<const double2*>(
                  wp + kmajor(r + 8, kk + 2 * tig));
              a[p][0] = lo.x;
              a[p][1] = hi.x;
              a[p][2] = lo.y;
              a[p][3] = hi.y;
            }
            if constexpr (CPLX) {
              if (h == 1) {
#pragma unroll
                for (int i = 0; i < 4; ++i) a[1][i] = -a[1][i];
              }
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if constexpr (CPLX) {
                dmma(acc[0][mt][nt], a[h], b[nt]);     // Wr Xr, (-Wi) Xi
                dmma(acc[1][mt][nt], a[1 - h], b[nt]); // Wi Xr, Wr Xi
              } else {
                dmma(acc[0][mt][nt], a[0], b[nt]);     // W X
              }
            }
          }
        }
      }
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }

    // Epilogue: the whole tile has been read; store its K rows in place
    // from the accumulators. Accumulator i of an m16n8 tile is row
    // gid + 8 (i >> 1), fiber 2 tig + (i & 1).
    const long long tile = blockIdx.x + it * gridDim.x;
    const long long b = tile / tpt;
    const long long f0 = (tile - b * tpt) * F;
    double* xt = x + b * g.xb;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const long long fib = f0 + n_base + nt * 8 + 2 * tig;
      if (fib < g.n_fib) {
        const bool two = fib + 1 < g.n_fib;
        const long long b0 = fiber_base(g, fib);
        const long long b1 = two ? fiber_base(g, fib + 1) : b0;
        // fibers fib and fib + 1 adjacent and 16-byte aligned
        const bool pair = !ROWS && g.vec == 2;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long ro =
                  p * g.plane_stride +
                  row_offset(g, m_base + mt * 16 + gid + 8 * h);
              const double v0 = acc[p][mt][nt][2 * h];
              const double v1 = acc[p][mt][nt][2 * h + 1];
              if (pair) {
                *reinterpret_cast<double2*>(xt + ro + b0) =
                    make_double2(v0, v1);
              } else {
                xt[ro + b0] = v0;
                if (two) xt[ro + b1] = v1;
              }
            }
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] = 0.0;
  }
  cp_async_wait_group<0>();   // no copy outlives the block
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int K, bool CPLX>
int launch_f64(double* x, const double* w, int rows, const FiberGeom& g,
               cudaStream_t st) {
  if constexpr (K < kF64MmaMinK) {
    using T = F64FmaTile<K, CPLX>;
    static int resident = 0;
    return launch_f64_persistent(f64_fma_kernel<K, CPLX>, T::smem_bytes,
                                 g.n_batch * ((g.n_fib + T::F - 1) / T::F),
                                 resident, x, w, g, st);
  } else {
    using T = F64MmaTile<K, CPLX>;
    const long long n_tiles = g.n_batch * ((g.n_fib + T::F - 1) / T::F);
    if (rows) {
      static int resident = 0;
      return launch_f64_persistent(f64_mma_kernel<K, CPLX, true>,
                                   T::smem_bytes, n_tiles, resident, x, w, g,
                                   st);
    }
    static int resident = 0;
    return launch_f64_persistent(f64_mma_kernel<K, CPLX, false>,
                                 T::smem_bytes, n_tiles, resident, x, w, g,
                                 st);
  }
}

template <int K>
int launch_f64_k(double* x, const double* w, int cplx, int rows,
                 const FiberGeom& g, cudaStream_t st) {
  return cplx ? launch_f64<K, true>(x, w, rows, g, st)
              : launch_f64<K, false>(x, w, rows, g, st);
}

// Validate the view and the copy plan (rows, vec: doubles a copy, 2 or 1),
// then dispatch on the depth K.
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
      x_batch_stride < 0 || op_batch_stride < 0)
    return (int)cudaErrorInvalidValue;
  // The operator copies are 16 bytes: each trajectory's operator starts
  // 16-byte aligned (stride 0 shares one).
  if (op_batch_stride % 2 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  // A chunk of vec doubles must be contiguous and aligned: along the rows
  // of one fiber (rows) or along a run of inner fibers (otherwise).
  if (vec != 1 && vec != 2) return (int)cudaErrorInvalidValue;
  if (rows && (n_inner != 1 || op_stride != 1))
    return (int)cudaErrorInvalidValue;
  const long long run = rows ? S : n_inner;
  if (run % vec || so % vec || sm % vec || bit_stride % vec ||
      plane_stride % vec || (!rows && op_stride % vec) ||
      x_batch_stride % vec ||
      reinterpret_cast<uintptr_t>(x) % (sizeof(double) * vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 2: return launch_f64_k<2>(x, w, cplx, rows, g, st);
    case 4: return launch_f64_k<4>(x, w, cplx, rows, g, st);
    case 8: return launch_f64_k<8>(x, w, cplx, rows, g, st);
    case 16: return launch_f64_k<16>(x, w, cplx, rows, g, st);
    case 32: return launch_f64_k<32>(x, w, cplx, rows, g, st);
    case 64: return launch_f64_k<64>(x, w, cplx, rows, g, st);
    case 128: return launch_f64_k<128>(x, w, cplx, rows, g, st);
    case 256: return launch_f64_k<256>(x, w, cplx, rows, g, st);
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

// Fibers per tile of the float64 kernels at depth K (the wrapper's
// tile_fibers_f64 must agree), or -1 for a depth they do not take.
extern "C" int qs_tile_fibers_f64(int K, int cplx) {
  switch (K) {
#define QS_F64_FMA_F(KK) \
  case KK:               \
    return cplx ? qs::F64FmaTile<KK, true>::F : qs::F64FmaTile<KK, false>::F;
    QS_F64_FMA_F(2) QS_F64_FMA_F(4) QS_F64_FMA_F(8)
#undef QS_F64_FMA_F
#define QS_F64_MMA_F(KK) \
  case KK:               \
    return cplx ? qs::F64MmaTile<KK, true>::F : qs::F64MmaTile<KK, false>::F;
    QS_F64_MMA_F(16) QS_F64_MMA_F(32) QS_F64_MMA_F(64) QS_F64_MMA_F(128)
    QS_F64_MMA_F(256)
#undef QS_F64_MMA_F
  }
  return -1;
}

// Dynamic shared memory of a float64 launch at depth K, and its ring
// stages (0 on the FMA path), or -1 for a depth they do not take.
extern "C" long long qs_smem_bytes_f64(int K, int cplx) {
  switch (K) {
#define QS_F64_FMA_SMEM(KK)                                      \
  case KK:                                                       \
    return cplx ? (long long)qs::F64FmaTile<KK, true>::smem_bytes \
                : (long long)qs::F64FmaTile<KK, false>::smem_bytes;
    QS_F64_FMA_SMEM(2) QS_F64_FMA_SMEM(4) QS_F64_FMA_SMEM(8)
#undef QS_F64_FMA_SMEM
#define QS_F64_MMA_SMEM(KK)                                      \
  case KK:                                                       \
    return cplx ? (long long)qs::F64MmaTile<KK, true>::smem_bytes \
                : (long long)qs::F64MmaTile<KK, false>::smem_bytes;
    QS_F64_MMA_SMEM(16) QS_F64_MMA_SMEM(32) QS_F64_MMA_SMEM(64)
    QS_F64_MMA_SMEM(128) QS_F64_MMA_SMEM(256)
#undef QS_F64_MMA_SMEM
  }
  return -1;
}
