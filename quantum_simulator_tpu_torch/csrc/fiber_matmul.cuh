// Shared device code of the dense_axis and cross_bit_axis kernels.
//
// Replaces the two Pallas TPU kernels of quantum_simulator_tpu/ops/
// pallas_exec.py: lower_dense (:178, body :200-217) and lower_cross (:229,
// body :289-330). Both group-plan steps are one small matrix applied along
// a strided "fiber" of the state, in place:
//   X[r, g] <- sum_c W[r, c] X[c, g],  r, c < K.
// A fiber g = (outer o, mid m, inner t), t fastest, starts at element
//   o * so + m * sm + t
// and its row r sits at
//   (r >> ls) * bit_stride + (r & (S - 1)) * op_stride.
// dense_axis uses K = S (no bit term); cross_bit_axis uses K = 2S, the
// sliced bit times the op axis. n_mid, n_inner and S are powers of two.
//
// What bounds it on an H100: per output element 2K FLOPs (8K complex) for
// 8 bytes of state moved (16 complex), i.e. 32 FLOP/byte at K = 128 and 64
// at K = 256. That is above the fp32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), where an fp32-FMA kernel is bound by issue.
// On the tensor cores mma.sync reaches about 320 TFLOP/s TF32 (measured on
// an H100 80GB HBM3 at 700 W), about 107 TFLOP/s of fp32 work after the 3x
// split, so the kernels sit near the ridge: bound by mma issue and latency,
// with the bytes close behind. For K >= kMmaMinK the product runs on the
// tensor cores:
//
// * 3xTF32 through mma.sync.m16n8k8 (fp32 accuracy; single-pass TF32 is
//   never used). Each operand value v splits at fragment load into
//   hi = v rounded to TF32 as cvt.rna.tf32 rounds and lo = v - hi (the
//   tensor core reads lo as TF32, i.e. without its low 13 bits). Order of the adds, per 8-deep
//   step of the contraction: a zeroed fragment takes W_lo X_hi, then
//   W_hi X_lo, then W_hi X_hi (complex: re takes Wr Xr then (-Wi) Xi, im
//   takes Wr Xi then Wi Xr, each product in its three passes), and the
//   fp32 accumulator then adds that fragment on the CUDA cores (round to
//   nearest). The tensor core truncates as it accumulates: summing every
//   step inside it measured 2.4-3.8x the fp32 twin's error against
//   float64, the 8-deep flush 0.25-0.4x. tests/test_torch_kernels.py
//   emulates this order on the CPU.
//   mma.sync and not wgmma: its fragments are loaded by the threads, so
//   one code path reads every strided fiber view, while wgmma takes TF32
//   operands only K-major from shared memory and the fiber tile is
//   MN-major whenever fibers are contiguous.
// * One owner per fiber tile. A block copies all K rows of a tile of F
//   fibers into shared memory and computes all K output rows before the
//   tile's stage is reused, so no other block reads those fibers and the
//   kernel writes its result over its input (as Pallas does with
//   input_output_aliases).
// * A two-stage ring filled with cp.async: the next tile's copies are in
//   flight while the current tile's products run. The copy width (16, 8
//   or 4 bytes, chosen by the wrapper from the geometry) follows whichever
//   dimension is contiguous: fibers (n_inner >= 2) or rows (op_stride 1,
//   n_inner 1). The tile is stored fiber-major or row-major to match, with
//   pitches that make the mma fragment loads free of bank conflicts.
// * Persistent blocks, one wave, walking the fiber tiles; two blocks per
//   SM where shared memory allows, so one block's copies, barriers and
//   stores overlap the other's products.
// * K = 256 (every cross step on a 128-wide axis): the operator (256 KB
//   real, 512 KB complex) does not fit in one block's shared memory.
//   - Complex, one operator for the whole launch (every ideal run): a
//     thread-block cluster of kClusterCtas = 4 CTAs, one per SM, splits
//     the 256 output rows, and each CTA keeps its 64 rows of both planes
//     (135 KB) resident for the whole launch. A block of the streamed
//     kernel below reads the whole 512 KB operator from L2 again for every
//     32 fibers (64 GiB of L2 reads for an 8 GiB state at n = 30) and pays
//     three barriers and a partial-sum epilogue per 16-row slab. The
//     cluster walks tiles of F = 16 fibers. Each CTA copies a whole tile
//     into a stage with cp.async; the four CTAs read it at about the same
//     time, so it comes from device memory once and from L2 for the rest.
//     A CTA is two groups of four warps that take alternate tiles, each
//     into its own stage, and take turns on the tensor cores (named
//     barriers): one group's copies, epilogue and stores run while the
//     other's products do. Warp k of a group computes contraction group k
//     (a contiguous K / 4 range) for all 64 x 16 outputs of both planes,
//     and the epilogue sums the four partials in group order: the
//     streamed kernel's grouping, so both give the same bits.
//     What bounds it (n = 30, H100 at 700 W): the products, about 33 of
//     42 ms with one warp of a group per scheduler, then about 5 ms of
//     copies that the other group's products do not cover; 30 clusters
//     fit (120 of 132 SMs). Measured and dropped: multicasting each tile
//     with 1-D cp.async.bulk copies behind full / empty mbarriers (69 /
//     56 ms: copies, remote barriers and products ran one after another),
//     clusters of 8 CTAs (15 fit; slower), all eight warps on one tile at
//     a time (53 / 51 ms), and an epilogue through one buffer shared by
//     the groups or summed in registers, to refill stages sooner (44-48
//     ms).
//     In place with a cluster: a CTA overwrites only its own rows of a
//     tile, but every CTA reads all of the tile's rows. So each thread
//     arrives on the cluster barrier once its copies of the tile have
//     landed and waits on it before the stores: no row of a tile is
//     written until every CTA of the cluster holds the whole tile. The
//     wait falls after the products, so its latency is hidden. One
//     cluster owns each tile, so no other cluster reads those fibers, and
//     only the group that owns a stage refills it, after its stores.
//   - Otherwise (a real operator, one operator per trajectory, or copies
//     narrower than 16 bytes; the rule is cluster_path in
//     cross_bit_axis.cu and takes_cluster in ops/cuda_exec.py) the
//     operator streams from L2 (every block reads the same operator)
//     through a double-buffered slab of R output rows while the fiber
//     tile stays resident. Each
//     slab's rows are written as they finish, which is safe in place
//     because the whole input tile is already in shared memory. Part j of
//     the next tile's copies goes into the same cp.async group as slab
//     j + 1, so one wait at the top of each slab serves both streams
//     (three barriers a slab: copies visible, products done, staging
//     done). A slab is only R x F outputs, so KS warp groups split its
//     contraction (each a contiguous K / KS range, giving every warp four
//     independent accumulator tiles) and the epilogue sums their partials
//     in group order.
// * Epilogue through shared memory, so stores are full vectors along the
//   contiguous dimension in both layouts.
//
// Below kMmaMinK (the leading axis of n mod 7 qubits, cross steps on a
// small op axis) a step moves 8 bytes per 2K <= 62 FLOPs on few rows; the
// fp32 SIMT template below serves it, also with one owner per tile and in
// place.
//
// A batch of trajectories (the noisy path, where JAX vmaps the executor
// over PRNG keys): trajectory b's state starts b * xb floats in and its
// operator b * wb floats in (wb = 0: one operator shared by all). Both
// kernels walk (trajectory, tile) pairs in trajectory-major order; a tile
// never spans two trajectories and each trajectory's ragged last tile is
// masked like any ragged tile. Where trouble lies:
// * Operator staging. The SIMT path stages W once per block and the MMA
//   path keeps a K <= 128 operator resident; with one operator per
//   trajectory a block restages it when its trajectory changes, which the
//   trajectory-major order keeps to about once per trajectory per block
//   (not overlapped with the tile's copies).
// * K = 256. With one operator shared by the batch (stride 0) a complex
//   step takes the cluster kernel. Otherwise the operator streams from L2
//   in slabs and every tile of a trajectory re-reads it; a real cross
//   operator is 256 KB and a complex one 512 KB, more than a 16-qubit
//   trajectory's 256 KB state. The walk
//   keeps one trajectory's tiles adjacent in time so its operator is
//   still in the 50 MB L2 when the next of its tiles needs it.
// * Small n. At n = 10, layout (8, 128), a trajectory has 8 fibers on its
//   K = 128 axis against tiles of 32-128: each tile restages a 64 KB
//   operator for 4-8 KB of state, so such launches are bound by operator
//   bytes, T x (2 x state bytes + operator bytes).
// * In place holds per trajectory: one owner per tile, as without a batch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qs {

struct FiberGeom {
  long long n_fib;          // fibers of one trajectory: n_outer*n_mid*n_inner
  long long n_batch;        // trajectories
  long long xb, wb;         // state and operator batch strides, in floats
  long long so, sm;         // outer and mid strides, in elements
  long long op_stride, bit_stride;
  long long plane_stride;   // offset of the imaginary plane (complex)
  int li, lm, ls;           // log2 of n_inner, n_mid and S
  int vec;                  // floats per copy and store chunk: 4, 2 or 1
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
// Contraction depths from this one up take the tensor-core path.
constexpr int kMmaMinK = 32;

// ---------------------------------------------------------------------------
// SIMT path (K < kMmaMinK): fp32 FMA, a TM x TN register tile per thread
// ---------------------------------------------------------------------------

template <int K, bool CPLX>
struct SimtTile {
  static constexpr int F = 4096 / K;
  static constexpr int TM = K < 4 ? K : 4;
  static constexpr int TN = K * F / (kThreads * TM);
  static constexpr int NP = CPLX ? 2 : 1;
  static constexpr size_t smem_bytes =
      sizeof(float) * NP * ((size_t)K * K + (size_t)K * (F + 1));
};

template <int K, bool CPLX>
__global__ void __launch_bounds__(kThreads)
simt_kernel(float* x, const float* __restrict__ w, FiberGeom g) {
  using T = SimtTile<K, CPLX>;
  constexpr int F = T::F, TM = T::TM, TN = T::TN, NP = T::NP;
  constexpr int FP = F + 1;          // padded pitch of the fiber tile
  constexpr int RG = K / TM;         // row groups
  constexpr int FG = F / TN;         // fiber groups
  constexpr int LD = K * F / kThreads;  // tile elements each thread loads
  constexpr int CH = LD < 16 ? LD : 16; // loads in flight per thread
  static_assert(RG * FG == kThreads, "tile does not match the block");
  static_assert(LD % CH == 0 && K * F % kThreads == 0, "load batches");

  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                  // [NP][K][K]: W, transposed
  float* xs = smem + NP * K * K;     // [NP][K][FP]: fiber tile, then result

  const int tid = threadIdx.x;
  const int rg = tid % RG;
  const int fg = tid / RG;
  // Lanes walk the fibers when a run of inner fibers is contiguous,
  // else they walk the rows (op_stride == 1 when the op axis is last).
  const bool lanes_on_fibers = (1LL << g.li) >= 32 || (1LL << g.li) >= F;
  const long long tpt = (g.n_fib + F - 1) / F;   // tiles per trajectory
  const long long n_tiles = tpt * g.n_batch;
  const float* staged = nullptr;     // the operator now in wt

  // Tiles in trajectory-major order: a block restages W only when its
  // trajectory's operator differs from the one it holds.
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b = tile / tpt;
    const long long f0 = (tile - b * tpt) * F;
    float* xt = x + b * g.xb;
    const float* wtraj = w + b * g.wb;
    if (wtraj != staged) {
      // every thread passed the barrier after the previous tile's
      // products, so nobody still reads wt
      for (int e = tid; e < NP * K * K; e += kThreads) {
        const int p = e / (K * K);
        const int rem = e - p * K * K;
        const int rr = rem / K;
        const int c = rem - rr * K;
        wt[(p * K + c) * K + rr] = wtraj[e];
      }
      staged = wtraj;
    }
    __syncthreads();  // W staged; the previous tile's stores are done
    // Each thread issues CH loads before it waits on any of them.
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
          v0[u] = xt[a];
          if constexpr (CPLX) v1[u] = xt[a + g.plane_stride];
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
    __syncthreads();  // the whole tile is read before any of it is written

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
      for (int i = 0; i < TM; ++i) wr[i] = wt[c * K + rg + RG * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) xr[j] = xs[c * FP + fg + FG * j];
      if constexpr (CPLX) {
        float wi[TM], xi[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) wi[i] = wt[(K + c) * K + rg + RG * i];
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

    for (int e = tid; e < K * F; e += kThreads) {
      const int f = lanes_on_fibers ? e % F : e / K;
      const int rr = lanes_on_fibers ? e / F : e % K;
      const long long fib = f0 + f;
      if (fib < g.n_fib) {
        const long long a = fiber_base(g, fib) + row_offset(g, rr);
        xt[a] = xs[rr * FP + f];
        if constexpr (CPLX) xt[a + g.plane_stride] = xs[K * FP + rr * FP + f];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (K >= kMmaMinK)
// ---------------------------------------------------------------------------

// Tile shape per depth K, complex flag and layout. F fibers per tile; R
// output rows per slab (R = K: the operator stays resident); a warp grid of
// KS contraction groups x WN fiber groups x WM row groups, each warp an
// (MT * 16) x (NT * 8) tile of m16n8 accumulators per output plane (a
// complex warp computes both planes of its tile, sharing the fragments);
// MINB blocks per SM. Pitches (floats): operator rows and a row-major
// tile 8 mod 32 (paired 64-bit fragment loads hit banks 8 * gid + 2 * tig
// and the next), a fiber-major tile F + 4 (banks 8 * tig + gid). Shared memory: the operator (resident, or two slab
// buffers) and two fiber-tile stages; the epilogue stages over the
// consumed fiber tile (resident) or the consumed slab buffer (streamed).
// (F, R, KS, WM, MINB) per depth: see MmaTile.
struct MmaShape {
  int F, R, KS, WM, MINB;
};

constexpr MmaShape mma_shape(int K, bool cplx) {
  if (cplx) {
    return K == 32    ? MmaShape{64, 32, 1, 2, 2}
           : K == 64  ? MmaShape{32, 64, 1, 4, 2}
           : K == 128 ? MmaShape{32, 128, 1, 4, 1}
                      : MmaShape{32, 16, 4, 1, 1};
  }
  return K == 32    ? MmaShape{128, 32, 1, 2, 2}
         : K == 64  ? MmaShape{64, 64, 1, 2, 2}
         : K == 128 ? MmaShape{128, 128, 1, 2, 1}
                    : MmaShape{64, 32, 4, 1, 1};
}

template <int K, bool CPLX, bool ROWS>
struct MmaTile {
  static constexpr MmaShape SH = mma_shape(K, CPLX);
  static constexpr int NP = CPLX ? 2 : 1;
  static constexpr int F = SH.F;
  static constexpr int R = SH.R;
  static constexpr int NS = K / R;             // slabs per tile
  static constexpr bool RESIDENT = NS == 1;
  static constexpr int KS = SH.KS;
  static constexpr int WM = SH.WM;
  static constexpr int WN = kThreads / 32 / (KS * WM);
  static constexpr int MT = R / (16 * WM);
  static constexpr int NT = F / (8 * WN);
  static constexpr int MINB = SH.MINB;
  // Operator row pitch, 8 mod 32; a streamed slab buffer has 32 floats
  // more per row so it can also hold the KS groups' staged partials.
  static constexpr int KWP = K + (RESIDENT ? 8 : 40);
  static constexpr int WPL = R * KWP;          // operator plane, one slab
  static constexpr int WBUF = NP * WPL;        // one slab buffer
  static constexpr int W_FLOATS = RESIDENT ? WBUF : 2 * WBUF;
  static constexpr int XC = ROWS ? 1 : F + 4;  // stride of a row in a stage
  static constexpr int XF = ROWS ? K + 8 : 1;  // stride of a fiber
  static constexpr int XPL = ROWS ? F * (K + 8) : K * (F + 4);
  static constexpr int XSTAGE = NP * XPL;
  static constexpr int SC = ROWS ? 1 : F + 4;  // epilogue staging strides
  static constexpr int SF = ROWS ? R + 4 : 1;
  static constexpr int SPL = ROWS ? F * (R + 4) : R * (F + 4);
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)W_FLOATS + 2 * (size_t)XSTAGE);
  static_assert(KS * WM * WN * 32 == kThreads, "warp grid");
  static_assert(MT >= 1 && NT >= 1 && MT * 16 * WM == R &&
                NT * 8 * WN == F && K % (8 * KS) == 0, "warp tiles");
  static_assert(NS == 1 || NS % 2 == 0, "slab buffers alternate");
  static_assert(KS * NP * SPL <= (RESIDENT ? XSTAGE : WBUF), "staging");
  static_assert(smem_bytes * MINB + 1024 * MINB <= 233472, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of BYTES into shared memory; zero-fill when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v = hi + lo: hi = v rounded to TF32 (nearest, ties away: the rounding
// of cvt.rna.tf32.f32, done in two integer ops, which measured 6-10 %
// faster than the cvt), lo = the rest.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d = a b + d
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// Copy W rows [r0, r0 + T::R) of every plane (or all K rows when
// resident) into a slab buffer, 16-byte chunks.
template <class T, int K>
__device__ __forceinline__ void issue_w(float* dst, const float* w, int r0) {
  constexpr int CPR = K / 4;
  constexpr int N = T::NP * T::R * CPR;
  for (int e = threadIdx.x; e < N; e += kThreads) {
    const int c4 = e % CPR;
    const int pr = e / CPR;                  // p * R + r
    const int p = pr / T::R;
    const int r = pr - p * T::R;
    cp_async<16>(dst + p * T::WPL + r * T::KWP + c4 * 4,
                 w + ((long long)p * K + r0 + r) * K + c4 * 4, true);
  }
}

// Part `part` of `parts` of the copies of the fiber tile starting at fiber
// f0 into a stage. Chunks of VEC floats run along the fibers (fiber-major
// stage) or along the rows (row-major stage); fibers past n_fib are zero.
template <class T, int K, int VEC, bool ROWS>
__device__ __forceinline__ void issue_x(float* stage, const float* x,
                                        const FiberGeom& g, long long f0,
                                        int part, int parts) {
  constexpr int F = T::F;
  constexpr int PER_PLANE = K * F / VEC;
  constexpr int N = T::NP * PER_PLANE;
  const int e0 = part * (N / parts);
  const int e1 = e0 + N / parts;
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const int p = e / PER_PLANE;
    const int q = e - p * PER_PLANE;
    int c, f;
    if constexpr (ROWS) {
      c = (q % (K / VEC)) * VEC;
      f = q / (K / VEC);
    } else {
      f = (q % (F / VEC)) * VEC;
      c = q / (F / VEC);
    }
    const long long fib = f0 + f;
    const bool valid = fib < g.n_fib;
    const float* src = valid ? x + p * g.plane_stride + fiber_base(g, fib) +
                                   row_offset(g, c)
                             : x;
    cp_async<4 * VEC>(stage + p * T::XPL + c * T::XC + f * T::XF, src, valid);
  }
}

// Store the staged rows [row0, row0 + R) of the tile at fiber f0: the sum
// of the KS groups' partials, in group order.
template <class T, int VEC, bool ROWS>
__device__ __forceinline__ void store_slab(float* x, const float* st,
                                           const FiberGeom& g, long long f0,
                                           int row0) {
  constexpr int F = T::F, R = T::R;
  constexpr int PER_PLANE = R * F / VEC;
  for (int e = threadIdx.x; e < T::NP * PER_PLANE; e += kThreads) {
    const int p = e / PER_PLANE;
    const int q = e - p * PER_PLANE;
    int r, f;
    if constexpr (ROWS) {
      r = (q % (R / VEC)) * VEC;
      f = q / (R / VEC);
    } else {
      f = (q % (F / VEC)) * VEC;
      r = q / (F / VEC);
    }
    const long long fib = f0 + f;
    if (fib >= g.n_fib) continue;
    const float* src = st + p * T::SPL + r * T::SC + f * T::SF;
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = src[i];
#pragma unroll
    for (int kg = 1; kg < T::KS; ++kg)
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] += src[kg * T::NP * T::SPL + i];
    float* dst = x + p * g.plane_stride + fiber_base(g, fib) +
                 row_offset(g, row0 + r);
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
      *dst = v[0];
    }
  }
}

template <class T, int K, bool ROWS>
__device__ __forceinline__ void issue_x_vec(float* stage, const float* x,
                                            const FiberGeom& g, long long f0,
                                            int part, int parts) {
  if (g.vec == 4) issue_x<T, K, 4, ROWS>(stage, x, g, f0, part, parts);
  else if (g.vec == 2) issue_x<T, K, 2, ROWS>(stage, x, g, f0, part, parts);
  else issue_x<T, K, 1, ROWS>(stage, x, g, f0, part, parts);
}

template <class T, bool ROWS>
__device__ __forceinline__ void store_slab_vec(float* x, const float* st,
                                               const FiberGeom& g,
                                               long long f0, int row0) {
  if (g.vec == 4) store_slab<T, 4, ROWS>(x, st, g, f0, row0);
  else if (g.vec == 2) store_slab<T, 2, ROWS>(x, st, g, f0, row0);
  else store_slab<T, 1, ROWS>(x, st, g, f0, row0);
}

// Fragments of one 8-deep step. The step's contraction index is paired:
// fragment column tig of A (row tig of B) is k0 + 2 * tig and column
// tig + 4 is k0 + 2 * tig + 1, the same for both operands, so each
// thread's two values of an operator row (or of a row-major fiber) are
// adjacent and load as one 64-bit shared load.
template <class T>
__device__ __forceinline__ void load_a(const float* row, int tig,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 p = *reinterpret_cast<const float2*>(row + 2 * tig);
  const float2 q =
      *reinterpret_cast<const float2*>(row + 8 * T::KWP + 2 * tig);
  split_tf32(p.x, ah[0], al[0]);
  split_tf32(q.x, ah[1], al[1]);
  split_tf32(p.y, ah[2], al[2]);
  split_tf32(q.y, ah[3], al[3]);
}

template <class T>
__device__ __forceinline__ void load_b(const float* xp, int k0, int n_base,
                                       int gid, int tig,
                                       uint32_t (&bh)[T::NT][2],
                                       uint32_t (&bl)[T::NT][2]) {
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const float* c = xp + (k0 + 2 * tig) * T::XC +
                     (n_base + nt * 8 + gid) * T::XF;
    float v0, v1;
    if constexpr (T::XC == 1) {
      const float2 p = *reinterpret_cast<const float2*>(c);
      v0 = p.x;
      v1 = p.y;
    } else {
      v0 = c[0];
      v1 = c[T::XC];
    }
    split_tf32(v0, bh[nt][0], bl[nt][0]);
    split_tf32(v1, bh[nt][1], bl[nt][1]);
  }
}

template <int K, bool CPLX, bool ROWS>
__global__ void __launch_bounds__(kThreads, (MmaTile<K, CPLX, ROWS>::MINB))
mma_kernel(float* x, const float* __restrict__ w, FiberGeom g) {
  using T = MmaTile<K, CPLX, ROWS>;
  constexpr int F = T::F, R = T::R, NS = T::NS, MT = T::MT, NT = T::NT;
  constexpr int NP = T::NP;
  constexpr int KK = K / T::KS;          // contraction range of a group

  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem;                    // operator: resident or 2 slabs
  float* xbuf = smem + T::W_FLOATS;      // two fiber-tile stages

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % T::WM;
  const int wn = (warp / T::WM) % T::WN;
  const int kg = warp / (T::WM * T::WN);   // contraction group
  const int m_base = wm * MT * 16;
  const int n_base = wn * NT * 8;
  const long long tpt = (g.n_fib + F - 1) / F;   // tiles per trajectory
  const long long n_tiles = tpt * g.n_batch;

  // Prologue: the first tile and, when streamed, the first operator slab
  // of its trajectory (a resident operator is staged at the tile's top).
  // The grid never exceeds n_tiles.
  {
    const long long b0 = blockIdx.x / tpt;
    if constexpr (!T::RESIDENT) issue_w<T, K>(wbuf, w + b0 * g.wb, 0);
    issue_x_vec<T, K, ROWS>(xbuf, x + b0 * g.xb, g,
                            (blockIdx.x - b0 * tpt) * F, 0, 1);
  }
  cp_async_commit();

  // Tiles in trajectory-major order, never spanning two trajectories: a
  // block restages a resident operator only when its trajectory's
  // operator differs from the one it holds.
  const float* staged = nullptr;
  int it = 0;
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, ++it) {
    const long long b = tile / tpt;
    const long long f0 = (tile - b * tpt) * F;
    float* xt = x + b * g.xb;
    const float* wtraj = w + b * g.wb;
    const long long next = tile + gridDim.x;
    const long long bn = next / tpt;
    const long long fn0 = (next - bn * tpt) * F;
    float* xnext = x + bn * g.xb;
    float* xs = xbuf + (it & 1) * T::XSTAGE;
    float* xn = xbuf + ((it + 1) & 1) * T::XSTAGE;

    if constexpr (T::RESIDENT) {
      if (wtraj != staged) {
        // every warp passed the barrier after the previous tile's
        // products, so the resident operator is no longer read
        issue_w<T, K>(wbuf, wtraj, 0);
        cp_async_commit();
        staged = wtraj;
      }
    }

    for (int j = 0; j < NS; ++j) {
      cp_async_wait_all();  // this tile and this slab have landed
      // Everyone's copies are visible, and the previous slab's stores
      // have read their staging: its buffer may be refilled.
      __syncthreads();
      // One group: the next operator slab and part j of the next tile,
      // in flight during this slab's products and stores.
      if constexpr (!T::RESIDENT) {
        if (j + 1 < NS)
          issue_w<T, K>(wbuf + ((j + 1) & 1) * T::WBUF, wtraj, (j + 1) * R);
        else if (next < n_tiles)
          issue_w<T, K>(wbuf + ((j + 1) & 1) * T::WBUF, w + bn * g.wb, 0);
      }
      if (next < n_tiles)
        issue_x_vec<T, K, ROWS>(xn, xnext, g, fn0, j, NS);
      cp_async_commit();

      const float* ws = wbuf + (T::RESIDENT ? 0 : (j & 1) * T::WBUF);
      float acc[NP][MT][NT][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] = 0.f;

#pragma unroll 2
      for (int k0 = kg * KK; k0 < (kg + 1) * KK; k0 += 8) {
        float part[NP][MT][NT][4];   // this step's products, added to acc
        // B fragments: X plane 0 and, complex, plane 1 and its negation
        uint32_t bh[NP][NT][2], bl[NP][NT][2], nbh[NT][2], nbl[NT][2];
        load_b<T>(xs, k0, n_base, gid, tig, bh[0], bl[0]);
        if constexpr (CPLX) {
          load_b<T>(xs + T::XPL, k0, n_base, gid, tig, bh[1], bl[1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              nbh[nt][i] = bh[1][nt][i] ^ 0x80000000u;
              nbl[nt][i] = bl[1][nt][i] ^ 0x80000000u;
            }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* wrow = ws + (m_base + mt * 16 + gid) * T::KWP + k0;
          uint32_t ah[4], al[4];
          load_a<T>(wrow, tig, ah, al);        // W plane 0 (Wr)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int p = 0; p < NP; ++p) {     // re: Wr Xr; im: Wr Xi
              mma_tf32_zero(part[p][mt][nt], al, bh[p][nt]);
              mma_tf32(part[p][mt][nt], ah, bl[p][nt]);
              mma_tf32(part[p][mt][nt], ah, bh[p][nt]);
            }
          }
          if constexpr (CPLX) {
            load_a<T>(wrow + T::WPL, tig, ah, al);   // Wi
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              // re += Wi (-Xi), the same products as (-Wi) Xi; im += Wi Xr
              mma_tf32(part[0][mt][nt], al, nbh[nt]);
              mma_tf32(part[0][mt][nt], ah, nbl[nt]);
              mma_tf32(part[0][mt][nt], ah, nbh[nt]);
              mma_tf32(part[1][mt][nt], al, bh[0][nt]);
              mma_tf32(part[1][mt][nt], ah, bl[0][nt]);
              mma_tf32(part[1][mt][nt], ah, bh[0][nt]);
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
              for (int i = 0; i < 4; ++i)
                acc[p][mt][nt][i] += part[p][mt][nt][i];
      }
      __syncthreads();  // every warp is done with this slab and tile

      // Epilogue: stage over what was just consumed, then store.
      float* st = T::RESIDENT ? xs : wbuf + (j & 1) * T::WBUF;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float* sp = st + (kg * NP + p) * T::SPL;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int r = m_base + mt * 16 + gid;
            const int f = n_base + nt * 8 + 2 * tig;
            sp[r * T::SC + f * T::SF] = acc[p][mt][nt][0];
            sp[r * T::SC + (f + 1) * T::SF] = acc[p][mt][nt][1];
            sp[(r + 8) * T::SC + f * T::SF] = acc[p][mt][nt][2];
            sp[(r + 8) * T::SC + (f + 1) * T::SF] = acc[p][mt][nt][3];
          }
      }
      __syncthreads();
      store_slab_vec<T, ROWS>(xt, st, g, f0, j * R);
    }
  }
}

// ---------------------------------------------------------------------------
// Cluster path (complex K = 256, one operator for the whole launch)
// ---------------------------------------------------------------------------

constexpr int kClusterCtas = 4;

// Each of the C CTAs holds R = 256 / C operator rows of both planes; a
// tile is F fibers. The block is two groups of four warps that take
// alternate tiles of the cluster, each into its own stage; warp k of a
// group computes contraction group k of the tile, all R x F outputs of
// both planes. The operator rows and a row-major tile have pitch K + 8, a
// fiber-major tile F + 4, as in MmaTile. A stage also holds the
// epilogue's KS partials once its tile is consumed.
template <bool ROWS>
struct ClusterTile {
  static constexpr int K = 256, C = kClusterCtas, NP = 2;
  static constexpr int R = K / C;
  static constexpr int F = 16;
  static constexpr int KS = 4;
  static constexpr int MT = R / 16, NT = F / 8;  // one warp's tiles
  static constexpr int GT = kThreads / 2;      // threads of a group
  static constexpr int KWP = K + 8;
  static constexpr int WPL = R * KWP;          // operator plane
  static constexpr int XC = ROWS ? 1 : F + 4;  // stride of a row in a stage
  static constexpr int XF = ROWS ? K + 8 : 1;  // stride of a fiber
  static constexpr int XPL = ROWS ? F * (K + 8) : K * (F + 4);
  static constexpr int SC = ROWS ? 1 : F + 4;  // epilogue staging strides
  static constexpr int SF = ROWS ? R + 4 : 1;
  static constexpr int SPL = ROWS ? F * (R + 4) : R * (F + 4);
  static constexpr int XSTAGE =
      NP * XPL > KS * NP * SPL ? NP * XPL : KS * NP * SPL;
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)NP * WPL + 2 * (size_t)XSTAGE);
  static_assert(KS == GT / 32, "a contraction group per warp");
  static_assert(smem_bytes + 1024 <= 233472, "shared memory");
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Named block barriers: wait for `n` threads, or count this warp's threads
// toward them and go on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The group's cp.async copies of the tile at fiber f0 into its stage, in
// 16-byte chunks; fibers past n_fib are zero.
template <class T, bool ROWS>
__device__ __forceinline__ void copy_group_tile(float* stage, const float* x,
                                                const FiberGeom& g,
                                                long long f0, int gt) {
  constexpr int K = T::K, F = T::F;
  constexpr int PER_PLANE = K * F / 4;
  for (int e = gt; e < T::NP * PER_PLANE; e += T::GT) {
    const int p = e / PER_PLANE;
    const int q = e - p * PER_PLANE;
    const int c = ROWS ? (q % (K / 4)) * 4 : q / (F / 4);
    const int f = ROWS ? q / (K / 4) : (q % (F / 4)) * 4;
    const long long fib = f0 + f;
    const bool valid = fib < g.n_fib;
    const float* src = valid ? x + p * g.plane_stride + fiber_base(g, fib) +
                                   row_offset(g, c)
                             : x;
    cp_async<16>(stage + p * T::XPL + c * T::XC + f * T::XF, src, valid);
  }
}

// The group's stores of this CTA's rows [row0, row0 + R) of the tile at
// fiber f0: the sum of the KS partials in group order, 16 bytes a store.
template <class T, bool ROWS>
__device__ __forceinline__ void store_group_tile(float* x, const float* st,
                                                 const FiberGeom& g,
                                                 long long f0, int row0,
                                                 int gt) {
  constexpr int F = T::F, R = T::R;
  constexpr int PER_PLANE = R * F / 4;
  for (int e = gt; e < T::NP * PER_PLANE; e += T::GT) {
    const int p = e / PER_PLANE;
    const int q = e - p * PER_PLANE;
    const int r = ROWS ? (q % (R / 4)) * 4 : q / (F / 4);
    const int f = ROWS ? q / (R / 4) : (q % (F / 4)) * 4;
    const long long fib = f0 + f;
    if (fib >= g.n_fib) continue;
    const float* src = st + p * T::SPL + r * T::SC + f * T::SF;
    float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int kg = 1; kg < T::KS; ++kg) {
      const float4 u =
          *reinterpret_cast<const float4*>(src + kg * T::NP * T::SPL);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(x + p * g.plane_stride + fiber_base(g, fib) +
                               row_offset(g, row0 + r)) = v;
  }
}

template <bool ROWS>
__global__ void __launch_bounds__(kThreads, 1)
cluster_mma_kernel(float* x, const float* __restrict__ w, FiberGeom g) {
  using T = ClusterTile<ROWS>;
  constexpr int K = T::K, F = T::F, R = T::R, MT = T::MT, NT = T::NT;
  constexpr int NP = T::NP, C = T::C, GT = T::GT;
  constexpr int KK = K / T::KS;          // contraction range of a group
  // named barriers: 1 and 2 pass the tensor cores to group 0 and 1;
  // 3 and 4 are the groups' own
  constexpr int kTurn = 1, kGroup = 3;

  extern __shared__ __align__(16) float smem[];
  float* wres = smem;                    // [NP][R][KWP]: this CTA's rows

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int grp = warp >> 2;             // the warp's group
  const int gt = threadIdx.x & (GT - 1); // thread within the group
  const int kg = warp & 3;               // the warp's contraction group
  float* xs = smem + NP * T::WPL + grp * T::XSTAGE;   // the group's stage
  const int rank = (int)cluster_rank();
  const long long cid = blockIdx.x / C;    // clusters are C consecutive CTAs
  const long long ncl = gridDim.x / C;
  const long long tpt = (g.n_fib + F - 1) / F;   // tiles per trajectory
  const long long n_tiles = tpt * g.n_batch;
  // the cluster's tiles, trajectory-major; group grp takes every other one
  const long long mine = (n_tiles - cid + ncl - 1) / ncl;
  const long long rounds = (mine + 1) / 2;

  // This CTA's operator rows of both planes, resident for the whole launch.
  {
    constexpr int CPR = K / 4;
    for (int e = threadIdx.x; e < NP * R * CPR; e += kThreads) {
      const int c4 = e % CPR;
      const int pr = e / CPR;              // p * R + r
      const int p = pr / R;
      const int r = pr - p * R;
      cp_async<16>(wres + p * T::WPL + r * T::KWP + c4 * 4,
                   w + ((long long)p * K + rank * R + r) * K + c4 * 4, true);
    }
    cp_async_commit();
  }

  // Each round, group 0 takes the cluster's tile 2 rd and group 1 tile
  // 2 rd + 1 (a group past the cluster's last tile only keeps the
  // barriers). The groups take turns on the tensor cores, group 0 first:
  // one's copies, epilogue and stores run while the other's products do.
  // Every CTA of a cluster walks the same tiles and copies each whole
  // tile into its own stage; the cluster's CTAs read it at about the same
  // time, so L2 serves all but the first read.
  for (long long rd = 0; rd < rounds; ++rd) {
    const long long j = 2 * rd + grp;
    const bool has = j < mine;
    const long long tile = cid + j * ncl;
    const long long b = tile / tpt;
    const long long f0 = (tile - b * tpt) * F;
    if (has) copy_group_tile<T, ROWS>(xs, x + b * g.xb, g, f0, gt);
    cp_async_commit();
    cp_async_wait_all();   // this thread's copies (and the operator) landed
    bar_sync(kGroup + grp, GT);   // the group's copies are visible
    if (rd == 0) __syncthreads();  // and everyone's operator rows
    cluster_arrive();      // this thread's copies of the tile have landed

    float acc[NP][MT][NT][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] = 0.f;

    if (grp == 1) bar_sync(kTurn + 1, kThreads);     // group 0 is done
    else if (rd > 0) bar_sync(kTurn, kThreads);      // group 1 is done
    if (has) {
      // The products of mma_kernel's complex path, for contraction group
      // kg of the tile over all of this CTA's rows.
#pragma unroll 2
      for (int k0 = kg * KK; k0 < (kg + 1) * KK; k0 += 8) {
        float part[NP][MT][NT][4];
        uint32_t bh[NP][NT][2], bl[NP][NT][2], nbh[NT][2], nbl[NT][2];
        load_b<T>(xs, k0, 0, gid, tig, bh[0], bl[0]);
        load_b<T>(xs + T::XPL, k0, 0, gid, tig, bh[1], bl[1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            nbh[nt][i] = bh[1][nt][i] ^ 0x80000000u;
            nbl[nt][i] = bl[1][nt][i] ^ 0x80000000u;
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* wrow = wres + (mt * 16 + gid) * T::KWP + k0;
          uint32_t ah[4], al[4];
          load_a<T>(wrow, tig, ah, al);          // Wr
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int p = 0; p < NP; ++p) {       // re: Wr Xr; im: Wr Xi
              mma_tf32_zero(part[p][mt][nt], al, bh[p][nt]);
              mma_tf32(part[p][mt][nt], ah, bl[p][nt]);
              mma_tf32(part[p][mt][nt], ah, bh[p][nt]);
            }
          }
          load_a<T>(wrow + T::WPL, tig, ah, al);  // Wi
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // re += Wi (-Xi), the same products as (-Wi) Xi; im += Wi Xr
            mma_tf32(part[0][mt][nt], al, nbh[nt]);
            mma_tf32(part[0][mt][nt], ah, nbl[nt]);
            mma_tf32(part[0][mt][nt], ah, nbh[nt]);
            mma_tf32(part[1][mt][nt], al, bh[0][nt]);
            mma_tf32(part[1][mt][nt], ah, bl[0][nt]);
            mma_tf32(part[1][mt][nt], ah, bh[0][nt]);
          }
        }
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[p][mt][nt][i] += part[p][mt][nt][i];
      }
    }
    if (grp == 0) bar_arrive(kTurn + 1, kThreads);   // group 1's turn
    else if (rd + 1 < rounds) bar_arrive(kTurn, kThreads);

    if (has) {
      bar_sync(kGroup + grp, GT);   // the group is done reading its tile
      // Epilogue: the KS partials over the consumed tile.
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float* sp = xs + (kg * NP + p) * T::SPL;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int r = mt * 16 + gid;
            const int f = nt * 8 + 2 * tig;
            sp[r * T::SC + f * T::SF] = acc[p][mt][nt][0];
            sp[r * T::SC + (f + 1) * T::SF] = acc[p][mt][nt][1];
            sp[(r + 8) * T::SC + f * T::SF] = acc[p][mt][nt][2];
            sp[(r + 8) * T::SC + (f + 1) * T::SF] = acc[p][mt][nt][3];
          }
      }
      bar_sync(kGroup + grp, GT);
    }
    // Every CTA holds this round's tiles whole: their rows may change.
    cluster_wait();
    if (has) store_group_tile<T, ROWS>(x + b * g.xb, xs, g, f0, rank * R, gt);
    bar_sync(kGroup + grp, GT);   // the stores have read the stage
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

inline int log2_exact(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return (1LL << l) == v ? l : -1;
}

// One persistent wave of blocks on `stream`; returns a CUDA error code
// (0 on success), never synchronises. `resident` caches blocks per card.
template <class Kernel>
int launch_persistent(Kernel kernel, size_t smem, long long n_tiles,
                      int& resident, float* x, const float* w,
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

template <int K, bool CPLX>
int launch_k(float* x, const float* w, int rows, const FiberGeom& g,
             cudaStream_t st) {
  if constexpr (K < kMmaMinK) {
    using T = SimtTile<K, CPLX>;
    static int resident = 0;
    return launch_persistent(simt_kernel<K, CPLX>, T::smem_bytes,
                             g.n_batch * ((g.n_fib + T::F - 1) / T::F),
                             resident, x, w, g, st);
  } else if (rows) {
    using T = MmaTile<K, CPLX, true>;
    static int resident = 0;
    return launch_persistent(mma_kernel<K, CPLX, true>, T::smem_bytes,
                             g.n_batch * ((g.n_fib + T::F - 1) / T::F),
                             resident, x, w, g, st);
  } else {
    using T = MmaTile<K, CPLX, false>;
    static int resident = 0;
    return launch_persistent(mma_kernel<K, CPLX, false>, T::smem_bytes,
                             g.n_batch * ((g.n_fib + T::F - 1) / T::F),
                             resident, x, w, g, st);
  }
}

// One persistent wave of clusters of the cluster kernel on `stream`, as
// many as fit at once (cudaOccupancyMaxActiveClusters, cached per card)
// and at most one per tile; returns a CUDA error code, never synchronises.
template <bool ROWS>
int& cluster_wave() {
  static int n = 0;                     // clusters resident at once
  return n;
}

template <bool ROWS>
int launch_cluster(float* x, const float* w, const FiberGeom& g,
                   cudaStream_t stream) {
  using T = ClusterTile<ROWS>;
  int& max_clusters = cluster_wave<ROWS>();
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = T::C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T::C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_clusters == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        cluster_mma_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::smem_bytes);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, cluster_mma_kernel<ROWS>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    max_clusters = n;
  }
  const long long n_tiles = g.n_batch * ((g.n_fib + T::F - 1) / T::F);
  const long long nc = n_tiles < max_clusters ? n_tiles : max_clusters;
  cfg.gridDim = dim3((unsigned)(nc * T::C));
  cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_mma_kernel<ROWS>, x, w, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One case of the K dispatch; depths outside [KMIN, KMAX] are not built.
template <int KK, int KMIN, int KMAX>
int launch_if(float* x, const float* w, int cplx, int rows,
              const FiberGeom& g, cudaStream_t st) {
  if constexpr (KK >= KMIN && KK <= KMAX) {
    return cplx ? launch_k<KK, true>(x, w, rows, g, st)
                : launch_k<KK, false>(x, w, rows, g, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// Validate the view and the copy plan, then dispatch on the depth K.
template <int KMIN, int KMAX>
int dispatch(float* x, const float* w, int K, int cplx, int rows, int vec,
             long long n_outer, long long so, long long n_mid, long long sm,
             long long n_inner, long long S, long long op_stride,
             long long bit_stride, long long plane_stride, long long n_batch,
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
  if (g.n_fib < 1 || g.li < 0 || g.lm < 0 || g.ls < 0)
    return (int)cudaErrorInvalidValue;
  // Each trajectory's state starts vec-aligned, and its operator 16-byte
  // aligned (the operator copies are 16 bytes); stride 0 shares one.
  if (n_batch < 1 || x_batch_stride < 0 || op_batch_stride < 0 ||
      x_batch_stride % vec || op_batch_stride % 4 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  // A chunk of vec floats must be contiguous and aligned: along the rows
  // of one fiber (rows) or along a run of inner fibers (otherwise).
  if (vec != 1 && vec != 2 && vec != 4) return (int)cudaErrorInvalidValue;
  if (rows && (n_inner != 1 || op_stride != 1))
    return (int)cudaErrorInvalidValue;
  const long long run = rows ? S : n_inner;
  if (run % vec || so % vec || sm % vec || bit_stride % vec ||
      plane_stride % vec || (!rows && op_stride % vec) ||
      reinterpret_cast<uintptr_t>(x) % (4 * vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 2: return launch_if<2, KMIN, KMAX>(x, w, cplx, rows, g, st);
    case 4: return launch_if<4, KMIN, KMAX>(x, w, cplx, rows, g, st);
    case 8: return launch_if<8, KMIN, KMAX>(x, w, cplx, rows, g, st);
    case 16: return launch_if<16, KMIN, KMAX>(x, w, cplx, rows, g, st);
    case 32: return launch_if<32, KMIN, KMAX>(x, w, cplx, rows, g, st);
    case 64: return launch_if<64, KMIN, KMAX>(x, w, cplx, rows, g, st);
    case 128: return launch_if<128, KMIN, KMAX>(x, w, cplx, rows, g, st);
    case 256: return launch_if<256, KMIN, KMAX>(x, w, cplx, rows, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace qs
