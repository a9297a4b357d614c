// diag_pair: a diagonal over two grouped axes multiplied into the state in
// place, in one launch over the whole state; the port's kernel for every
// DiagPairStep (CZ, CPhase, RZZ and their runs on one axis pair).
//
// Replaces no Pallas kernel: the JAX package leaves the pair diagonal to
// XLA as an elementwise einsum (_diag_spec,
// quantum_simulator_tpu/ops/plan.py:1054). On the card that einsum became a
// permute copy, a K = 2 batched GEMM and a copy back, chunk by chunk, about
// three times the least traffic; its plain twin keeps that form.
//
//   x[i] <- d[i_a, i_b] * x[i]
//
// i_a and i_b are the indices of amplitude i on axis_a and axis_b, taken
// with shifts and masks (the layout's sizes are powers of two). The state
// is ([T,] planes, *axis_sizes); the table is ([T,] 2, S_a, S_b) complex
// planes, (re, im), or ([T,] S_a, S_b) real, one per trajectory or shared
// with batch stride 0. Three forms: a complex table on a planar state
// (re <- xr dr - xi di, im <- xr di + xi dr, fp32 or fp64 FMA), a real
// table on a planar state (both planes scaled), a real table on a real
// state.
//
// Bound: bytes. An amplitude takes 6 FLOP against 16 bytes read and
// written (float32), about 0.4 FLOP a byte, so the least time is the state
// read once and written once at the HBM bandwidth (5.13 ms at n = 30). The
// design moves each byte once at full width: a thread loads and stores 16
// bytes of each plane (4 float32 or 2 float64 consecutive amplitudes), so
// a warp covers 512 contiguous bytes a plane; the state goes through the
// streaming cache path (evict first), and the table (at most 128 x 128 x 2
// entries, 128 KiB) through the read-only path, where it stays. Where
// axis_b is the innermost axis, a thread's amplitudes read consecutive
// table entries in one 16-byte load; where axis_a is, entries S_b apart;
// elsewhere, one entry serves them all. An innermost axis shorter than a
// 16-byte pack, or a state not aligned to 16 bytes, takes one amplitude a
// thread (the wrapper decides from the shape and the pointers). Offsets
// are 64-bit: a plane holds up to 2^32 amplitudes.

#include <cuda_runtime.h>

namespace qs {

constexpr int kDiagThreads = 256;
// One pack a thread: a block for every 256 packs of a plane (2^22 at
// n = 32), each thread's loop then runs once. On an H100 at n = 30 that
// took 5.69 ms where 65536 blocks striding over the plane took 5.90. The
// loops stay for a batch wider than the grid's y limit.
constexpr long long kDiagMaxBlocks = 0x7fffffff;
constexpr int kDiagMaxBatchBlocks = 65535;

enum DiagForm { kComplexTable = 0, kRealTablePlanar = 1, kRealState = 2 };
// How the amplitudes of one pack index the table: all one entry, the next
// entries (axis_b innermost), or entries S_b apart (axis_a innermost).
enum TableStep { kOneEntry = 0, kNextEntry = 1, kRowEntry = 2 };

struct DiagGeom {
  long long n_plane;         // amplitudes in one plane of one trajectory
  int shift_a, shift_b;      // log2 of the elements after each axis
  long long mask_a, mask_b;  // axis size - 1
  long long size_b;          // table row length
  long long d_plane;         // imaginary table plane after the real one
  long long n_batch, x_batch_stride, d_batch_stride;
};

// V consecutive elements: 16 bytes in one access, or one element.
template <typename T, int V>
struct Pack {
  T v[V];
};

__device__ __forceinline__ void unpack(const float4& w, Pack<float, 4>& p) {
  p.v[0] = w.x;
  p.v[1] = w.y;
  p.v[2] = w.z;
  p.v[3] = w.w;
}
__device__ __forceinline__ void unpack(const double2& w, Pack<double, 2>& p) {
  p.v[0] = w.x;
  p.v[1] = w.y;
}
__device__ __forceinline__ float4 wide(const Pack<float, 4>& p) {
  return make_float4(p.v[0], p.v[1], p.v[2], p.v[3]);
}
__device__ __forceinline__ double2 wide(const Pack<double, 2>& p) {
  return make_double2(p.v[0], p.v[1]);
}

template <typename T>
struct Wide;
template <>
struct Wide<float> {
  using type = float4;
};
template <>
struct Wide<double> {
  using type = double2;
};

__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mul_add(double a, double b, double c) {
  return fma(a, b, c);
}

// The state streams through once: evict-first loads and stores.
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_stream(const T* p) {
  Pack<T, V> out;
  if constexpr (V == 1) {
    out.v[0] = __ldcs(p);
  } else {
    static_assert(V * sizeof(T) == 16, "a pack is 16 bytes");
    unpack(__ldcs(reinterpret_cast<const typename Wide<T>::type*>(p)), out);
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void store_stream(T* p, const Pack<T, V>& in) {
  if constexpr (V == 1) {
    __stcs(p, in.v[0]);
  } else {
    __stcs(reinterpret_cast<typename Wide<T>::type*>(p), wide(in));
  }
}

// The table stays cached: read-only loads.
template <typename T, int V, int STEP>
__device__ __forceinline__ Pack<T, V> load_table(const T* t, long long row) {
  Pack<T, V> out;
  if constexpr (STEP == kNextEntry) {
    unpack(__ldg(reinterpret_cast<const typename Wide<T>::type*>(t)), out);
  } else if constexpr (STEP == kRowEntry) {
#pragma unroll
    for (int k = 0; k < V; ++k) out.v[k] = __ldg(t + k * row);
  } else {
    const T one = __ldg(t);
#pragma unroll
    for (int k = 0; k < V; ++k) out.v[k] = one;
  }
  return out;
}

template <typename T, int V, int FORM, int STEP>
__global__ void __launch_bounds__(kDiagThreads)
    diag_pair_kernel(T* __restrict__ x, const T* __restrict__ d,
                     DiagGeom g) {
  const long long packs = g.n_plane / V;
  const long long stride = (long long)gridDim.x * kDiagThreads;
  for (long long b = blockIdx.y; b < g.n_batch; b += gridDim.y) {
    T* xb = x + b * g.x_batch_stride;
    const T* db = d + b * g.d_batch_stride;
    for (long long p = (long long)blockIdx.x * kDiagThreads + threadIdx.x;
         p < packs; p += stride) {
      const long long i = p * V;
      const long long t = ((i >> g.shift_a) & g.mask_a) * g.size_b +
                          ((i >> g.shift_b) & g.mask_b);
      const Pack<T, V> dr = load_table<T, V, STEP>(db + t, g.size_b);
      Pack<T, V> xr = load_stream<T, V>(xb + i);
      if constexpr (FORM == kComplexTable) {
        const Pack<T, V> di = load_table<T, V, STEP>(db + g.d_plane + t,
                                                     g.size_b);
        Pack<T, V> xi = load_stream<T, V>(xb + g.n_plane + i);
        Pack<T, V> yr, yi;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          yr.v[k] = mul_add(xr.v[k], dr.v[k], -xi.v[k] * di.v[k]);
          yi.v[k] = mul_add(xr.v[k], di.v[k], xi.v[k] * dr.v[k]);
        }
        store_stream<T, V>(xb + i, yr);
        store_stream<T, V>(xb + g.n_plane + i, yi);
      } else if constexpr (FORM == kRealTablePlanar) {
        Pack<T, V> xi = load_stream<T, V>(xb + g.n_plane + i);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          xr.v[k] *= dr.v[k];
          xi.v[k] *= dr.v[k];
        }
        store_stream<T, V>(xb + i, xr);
        store_stream<T, V>(xb + g.n_plane + i, xi);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) xr.v[k] *= dr.v[k];
        store_stream<T, V>(xb + i, xr);
      }
    }
  }
}

template <typename T, int V, int FORM, int STEP>
int launch_diag(T* x, const T* d, const DiagGeom& g, cudaStream_t st) {
  const long long packs = g.n_plane / V;
  long long blocks = (packs + kDiagThreads - 1) / kDiagThreads;
  if (blocks > kDiagMaxBlocks) blocks = kDiagMaxBlocks;
  const long long rows =
      g.n_batch < kDiagMaxBatchBlocks ? g.n_batch : kDiagMaxBatchBlocks;
  diag_pair_kernel<T, V, FORM, STEP>
      <<<dim3((unsigned)blocks, (unsigned)rows), kDiagThreads, 0, st>>>(x, d,
                                                                        g);
  return (int)cudaGetLastError();
}

template <typename T, int FORM>
int dispatch_step(T* x, const T* d, int vec, const DiagGeom& g,
                  cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (!vec) return launch_diag<T, 1, FORM, kOneEntry>(x, d, g, st);
  if (g.n_plane % V || g.x_batch_stride % V) return (int)cudaErrorInvalidValue;
  if (g.shift_b == 0) {
    if (g.mask_b + 1 < V || g.d_plane % V || g.d_batch_stride % V)
      return (int)cudaErrorInvalidValue;
    return launch_diag<T, V, FORM, kNextEntry>(x, d, g, st);
  }
  if (g.shift_a == 0) {
    if (g.mask_a + 1 < V) return (int)cudaErrorInvalidValue;
    return launch_diag<T, V, FORM, kRowEntry>(x, d, g, st);
  }
  if (g.shift_a < __builtin_ctz(V) || g.shift_b < __builtin_ctz(V))
    return (int)cudaErrorInvalidValue;
  return launch_diag<T, V, FORM, kOneEntry>(x, d, g, st);
}

template <typename T>
int dispatch_diag(T* x, const T* d, int form, int vec, const DiagGeom& g,
                  cudaStream_t st) {
  switch (form) {
    case kComplexTable:
      return dispatch_step<T, kComplexTable>(x, d, vec, g, st);
    case kRealTablePlanar:
      return dispatch_step<T, kRealTablePlanar>(x, d, vec, g, st);
    case kRealState:
      return dispatch_step<T, kRealState>(x, d, vec, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace qs

// x <- d[i_a, i_b] * x in place. f64: float64 state and table, else
// float32. form: 0 complex table on a planar state, 1 real table on a
// planar state, 2 real table on a real state. vec: 16-byte packs (the
// innermost axis holds whole packs and both pointers are aligned), else
// one amplitude a thread. shift_*: log2 of the elements after each axis in
// one plane; size_*: the axes' sizes (powers of two). The table of
// trajectory b starts d_batch_stride elements after trajectory b - 1's, its
// state x_batch_stride elements after.
extern "C" int qs_diag_pair(void* x, const void* d, int f64, int form,
                            int vec, long long n_plane, long long shift_a,
                            long long size_a, long long shift_b,
                            long long size_b, long long n_batch,
                            long long x_batch_stride,
                            long long d_batch_stride, void* stream) {
  if (n_plane <= 0 || n_batch <= 0) return 0;
  if (size_a < 1 || size_b < 1 ||
      (size_a & (size_a - 1)) || (size_b & (size_b - 1)) || shift_a < 0 ||
      shift_b < 0 || shift_a > 62 || shift_b > 62)
    return (int)cudaErrorInvalidValue;
  qs::DiagGeom g{n_plane,         (int)shift_a, (int)shift_b,
                 size_a - 1,      size_b - 1,   size_b,
                 size_a * size_b, n_batch,      x_batch_stride,
                 d_batch_stride};
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? qs::dispatch_diag((double*)x, (const double*)d, form, vec, g,
                                 st)
             : qs::dispatch_diag((float*)x, (const float*)d, form, vec, g,
                                 st);
}
