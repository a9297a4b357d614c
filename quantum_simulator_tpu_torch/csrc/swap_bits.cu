// swap_bits: a run of SWAP gates on disjoint qubit pairs applied to the
// state in place, in one launch over the whole state; the port's kernel for
// each run of consecutive exact-swap BitPairSteps (the QFT's closing swaps).
//
// Replaces no Pallas kernel: the JAX package runs each swap step as a
// transpose of two exposed bit dims (apply_bitpair,
// quantum_simulator_tpu/ops/plan.py:1090), which XLA lowers to a copy. On
// the card that transpose became a strided copy and a copy back, chunk by
// chunk, for every swap of the run: about four times the state's bytes a
// swap. Its plain twin in cuda_exec.py is one index map.
//
//   x[i] <- x[pi(i)]
//
// pi exchanges bits p_k and q_k of the data index i for every pair of the
// run. The pairs share no bit, so pi is an involution: the kernel exchanges
// x[i] and x[pi(i)] for each i with pi(i) != i, and leaves the rest.
//
// Bound: bytes. No arithmetic, so the least time is the state read once
// and written once at the HBM bandwidth (5.13 ms at n = 30 in float32).
// The design moves every byte once, in runs of 256 bytes. The column bits
// C are the lowest c bits of the index (64 float32 or 32 float64); the row
// bits R are the partners of the swapped bits in C, then bits that no pair
// moves, up to 64 rows. A tile is the 2^|R| x 2^c elements at fixed other
// bits; pi maps tile T onto tile pi(T), and the pairs outside C and R only
// remap the tile's base. The walk is over units of two tiles, so that
// every unit moves bytes: a tile and its partner, or two tiles pi maps
// onto themselves. A block loads a unit's tiles into padded shared memory
// (16-byte loads, one element a store to shared memory) and stores each,
// its bits permuted, in the other's place or its own. Where no pair has a
// bit in C the tiles' bits stay put, and the block exchanges the two tiles
// directly, without shared memory. Loads and stores take the streaming
// path (evict first). The leading batch and plane dims are high index bits
// that pi never moves. In-plane offsets are 32-bit (a plane holds up to
// 2^32 elements), plane offsets 64-bit.
//
// Measured on an H100 at n = 30 (the QFT's 14 swaps): 6.4 ms in float32
// (79-80 % of the bound; a plain copy of the state reaches 88-90 %) and
// 12.5 ms in float64 (81-82 %). Rows of 128 bytes took 6.6-6.8 ms (76-77
// %): the scattered rows are what costs, and exchanging 128-byte lines
// reached 76 % of the bandwidth where 256-byte runs reached 81-82 % and
// longer runs no more.
//
// The wrapper (cuda_exec.swap_geometry) computes the geometry: the tile's
// row bits, the pairs outside the tiles, the bits no pair moves and the
// permutation of the tile's own bits.

#include <cuda_runtime.h>

namespace qs {

constexpr int kSwapThreads = 256;
// A tile row: 256 bytes of consecutive elements.
constexpr int kSwapRowBytes = 256;
constexpr int kSwapMaxRowBits = 6;
constexpr int kSwapMaxFixed = 31;
constexpr int kSwapMaxPairs = 16;
constexpr int kSwapMaxTileBits = 12;
// Words of the geometry the wrapper packs (cuda_exec.SWAP_GEOM_WORDS).
constexpr int kSwapGeomWords =
    7 + 2 * kSwapMaxPairs + kSwapMaxFixed + kSwapMaxRowBits +
    kSwapMaxTileBits;

// The mode's flags: kSwapExchange, tile and partner swap places unchanged
// (else the tile's bits are permuted through shared memory); kSwapPacks,
// a thread moves 16-byte packs (else one element).
constexpr int kSwapExchange = 1;
constexpr int kSwapPacks = 2;
// Blocks launched: this many waves of the blocks the card holds at once.
// Measured on an H100 at n = 30 in float32 (128-byte rows): 4 to 32 waves
// took 76-77 % of the bound. In an earlier walk that reached 73 % at 8
// waves, one wave (each block walking its share to the end, the card
// waiting on the slowest) and a block a unit (each thread's set-up paid
// per unit) took 59-61 %.
constexpr int kSwapWaves = 8;

struct SwapGeom {
  long long n_units;  // units in the whole tensor, all planes
  long long plane;    // elements in one plane: 2^n
  int unit_shift;     // log2 units a plane
  int col_bits, row_bits;
  int n_pairs, n_fixed;
  // The pairs outside the tile and the tile bits no pair moves, one a
  // lane (unit_shift = max(n_pairs - 1, 0) + n_pairs + n_fixed).
  int pair_lo[kSwapMaxPairs], pair_hi[kSwapMaxPairs];
  int fixed_pos[kSwapMaxFixed];
  int row_pos[kSwapMaxRowBits];  // data-index bit of row bit j
  // Tile element e (row e >> col_bits, column e & (2^col_bits - 1)) takes
  // the value of element pi_tile(e): bit i of pi_tile(e) is bit perm[i]
  // of e.
  int perm[kSwapMaxTileBits];
};

// V consecutive elements: 16 bytes in one access, or one element.
template <typename T, int V>
struct SwapPack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ SwapPack<T, V> swap_load(const T* p) {
  SwapPack<T, V> out;
  if constexpr (V == 1) {
    out.v[0] = __ldcs(p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 w = __ldcs(reinterpret_cast<const float4*>(p));
    out.v[0] = w.x;
    out.v[1] = w.y;
    out.v[2] = w.z;
    out.v[3] = w.w;
  } else {
    const double2 w = __ldcs(reinterpret_cast<const double2*>(p));
    out.v[0] = w.x;
    out.v[1] = w.y;
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void swap_store(T* p, const SwapPack<T, V>& in) {
  if constexpr (V == 1) {
    __stcs(p, in.v[0]);
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(in.v[0], in.v[1], in.v[2], in.v[3]));
  } else {
    __stcs(reinterpret_cast<double2*>(p), make_double2(in.v[0], in.v[1]));
  }
}

// In-plane offset of tile element e from its tile's base.
__device__ __forceinline__ unsigned tile_offset(int e, const SwapGeom& g) {
  unsigned off = (unsigned)e & ((1u << g.col_bits) - 1u);
  const int r = e >> g.col_bits;
#pragma unroll
  for (int j = 0; j < kSwapMaxRowBits; ++j)
    if (j < g.row_bits) off |= (unsigned)((r >> j) & 1) << g.row_pos[j];
  return off;
}

__device__ __forceinline__ int tile_source(int e, const SwapGeom& g) {
  int out = 0;
#pragma unroll
  for (int i = 0; i < kSwapMaxTileBits; ++i)
    if (i < g.col_bits + g.row_bits) out |= ((e >> g.perm[i]) & 1) << i;
  return out;
}

template <typename T, bool PERMUTE, int V>
__global__ void __launch_bounds__(kSwapThreads)
    swap_bits_kernel(T* __restrict__ x, const SwapGeom g) {
  constexpr int kCols = kSwapRowBytes / (int)sizeof(T);
  constexpr int kPitch = kCols + 1;  // a padded row of shared memory
  constexpr int kPer = (kCols << kSwapMaxRowBits) / V / kSwapThreads;
  __shared__ T sm[PERMUTE ? 2 : 1][PERMUTE ? kPitch << kSwapMaxRowBits : 1];

  // This lane's share of a unit's two bases: one pair, one fixed bit.
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = 0, fixed = 0;
  bool paired = false, placed = false;
#pragma unroll
  for (int j = 0; j < kSwapMaxPairs; ++j)
    if (j == lane && j < g.n_pairs) {
      lo = g.pair_lo[j];
      hi = g.pair_hi[j];
      paired = true;
    }
#pragma unroll
  for (int j = 0; j < kSwapMaxFixed; ++j)
    if (j == lane && j < g.n_fixed) {
      fixed = g.fixed_pos[j];
      placed = true;
    }
  const int s_bits = g.n_pairs > 0 ? g.n_pairs - 1 : 0;
  const unsigned s_mask = (1u << s_bits) - 1u;
  const unsigned d_mask = (1u << g.n_pairs) - 1u;

  // This thread's packs of a tile, the same in every tile: where each
  // lies, where it goes in shared memory, and where each of its elements
  // is taken from there.
  const int tile_elems = 1 << (g.col_bits + g.row_bits);
  const int col_mask = (1 << g.col_bits) - 1;
  unsigned off[kPer];
  int put[kPer], take[kPer], step[V];
  bool live[kPer];
  // pi_tile is a bit permutation, so the element i of a pack (e's low
  // bits 0) comes from the shared-memory place of pi_tile(e) plus that of
  // pi_tile(i).
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int s = tile_source(i, g);
    step[i] = (s >> g.col_bits) * kPitch + (s & col_mask);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = (threadIdx.x + k * kSwapThreads) * V;
    live[k] = e < tile_elems;
    off[k] = tile_offset(e, g);
    put[k] = (e >> g.col_bits) * kPitch + (e & col_mask);
    const int s = tile_source(e, g);
    take[k] = (s >> g.col_bits) * kPitch + (s & col_mask);
  }

  const unsigned long long in_plane = (1ull << g.unit_shift) - 1ull;
  // With no pair outside the tiles a unit is one tile, else two.
  const bool two = g.n_pairs > 0;
  for (long long unit = blockIdx.x; unit < g.n_units; unit += gridDim.x) {
    // Unit bits: s' (the pairs' low bits but one), d (which pairs differ),
    // the fixed bits. With d != 0 the unit is the orbit {t, pi(t)} whose
    // lowest differing pair has its low bit 0 in t; with d = 0, two tiles
    // pi leaves in place (the top pair 00 and 11).
    const unsigned uin = (unsigned)((unsigned long long)unit & in_plane);
    const unsigned sp = uin & s_mask;
    const unsigned d = (uin >> s_bits) & d_mask;
    const unsigned f = uin >> (s_bits + g.n_pairs);
    const int at = d ? __ffs(d) - 1 : s_bits;
    const unsigned s = (sp & ((1u << at) - 1u)) | ((sp >> at) << (at + 1));
    const unsigned s2 = d ? s ^ d : s | (1u << at);  // the second tile
    unsigned bt = 0, bu = 0;
    if (paired) {
      const unsigned sk = (s >> lane) & 1u, dk = (d >> lane) & 1u;
      const unsigned s2k = (s2 >> lane) & 1u;
      bt = (sk << lo) | ((sk ^ dk) << hi);
      bu = (s2k << lo) | ((s2k ^ dk) << hi);
    }
    if (placed) {
      const unsigned fk = ((f >> lane) & 1u) << fixed;
      bt |= fk;
      bu |= fk;
    }
    const bool cross = d != 0;
    if (!PERMUTE && !cross) continue;  // tiles pi leaves as they are
    T* const xp = x + (unit >> g.unit_shift) * g.plane;
    T* const xt = xp + __reduce_or_sync(0xffffffffu, bt);
    T* const xu = xp + __reduce_or_sync(0xffffffffu, bu);
    if constexpr (PERMUTE) {
      SwapPack<T, V> a[kPer], b[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (live[k]) {
          a[k] = swap_load<T, V>(xt + off[k]);
          if (two) b[k] = swap_load<T, V>(xu + off[k]);
        }
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (live[k]) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            sm[0][put[k] + i] = a[k].v[i];
            if (two) sm[1][put[k] + i] = b[k].v[i];
          }
        }
      __syncthreads();
      // Each tile's permuted values go to its partner's place, or back to
      // its own where pi leaves the tile in place.
      T* const first = cross ? xu : xt;
      T* const other = cross ? xt : xu;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (live[k]) {
          SwapPack<T, V> o;
#pragma unroll
          for (int i = 0; i < V; ++i) o.v[i] = sm[0][take[k] + step[i]];
          swap_store<T, V>(first + off[k], o);
          if (two) {
#pragma unroll
            for (int i = 0; i < V; ++i) o.v[i] = sm[1][take[k] + step[i]];
            swap_store<T, V>(other + off[k], o);
          }
        }
      __syncthreads();
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (live[k]) {
          const SwapPack<T, V> a = swap_load<T, V>(xt + off[k]);
          const SwapPack<T, V> b = swap_load<T, V>(xu + off[k]);
          swap_store<T, V>(xu + off[k], a);
          swap_store<T, V>(xt + off[k], b);
        }
    }
  }
}

// kSwapWaves waves of blocks, each walking the units with a stride.
template <typename T, bool PERMUTE, int V>
int launch_swap(T* x, const SwapGeom& g, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, swap_bits_kernel<T, PERMUTE, V>, kSwapThreads, 0);
  if (rc != cudaSuccess) return (int)rc;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1) * kSwapWaves;
  if (blocks > g.n_units) blocks = g.n_units;
  swap_bits_kernel<T, PERMUTE, V>
      <<<(unsigned)blocks, kSwapThreads, 0, st>>>(x, g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_swap(T* x, int mode, const SwapGeom& g, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  switch (mode) {
    case 0:
      return launch_swap<T, true, 1>(x, g, st);
    case kSwapExchange:
      return launch_swap<T, false, 1>(x, g, st);
    case kSwapPacks:
      return launch_swap<T, true, V>(x, g, st);
    case kSwapExchange | kSwapPacks:
      return launch_swap<T, false, V>(x, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace qs

// x[i] <- x[pi(i)] in place over the whole state. f64: float64 state, else
// float32. mode: kSwapExchange where the tiles' own bits stay put, plus
// kSwapPacks for 16-byte packs (the wrapper checks the row width and the
// alignment).
// geom: n_geom = kSwapGeomWords words in SwapGeom's order, arrays padded
// to their full length.
extern "C" int qs_swap_bits(void* x, int f64, int mode, const long long* geom,
                            int n_geom, void* stream) {
  using qs::kSwapMaxPairs;
  using qs::kSwapMaxRowBits;
  using qs::kSwapMaxFixed;
  using qs::kSwapMaxTileBits;
  if (n_geom != qs::kSwapGeomWords) return (int)cudaErrorInvalidValue;
  qs::SwapGeom g;
  const long long* v = geom;
  g.n_units = *v++;
  g.plane = *v++;
  g.unit_shift = (int)*v++;
  g.col_bits = (int)*v++;
  g.row_bits = (int)*v++;
  g.n_pairs = (int)*v++;
  g.n_fixed = (int)*v++;
  for (int j = 0; j < kSwapMaxPairs; ++j) g.pair_lo[j] = (int)*v++;
  for (int j = 0; j < kSwapMaxPairs; ++j) g.pair_hi[j] = (int)*v++;
  for (int j = 0; j < kSwapMaxFixed; ++j) g.fixed_pos[j] = (int)*v++;
  for (int j = 0; j < kSwapMaxRowBits; ++j) g.row_pos[j] = (int)*v++;
  for (int j = 0; j < kSwapMaxTileBits; ++j) g.perm[j] = (int)*v++;
  const int max_cols = f64 ? 5 : 6;
  if (g.n_units <= 0) return 0;
  const int tile_shift = 2 * g.n_pairs + g.n_fixed;
  if (g.col_bits < 1 || g.col_bits > max_cols || g.row_bits < 0 ||
      g.row_bits > kSwapMaxRowBits || g.n_pairs < 0 ||
      g.n_pairs > kSwapMaxPairs || g.n_fixed < 0 ||
      g.n_fixed > kSwapMaxFixed ||
      g.unit_shift != tile_shift - (g.n_pairs > 0) ||
      g.plane != 1ll << (g.col_bits + g.row_bits + tile_shift))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? qs::dispatch_swap((double*)x, mode, g, st)
             : qs::dispatch_swap((float*)x, mode, g, st);
}
