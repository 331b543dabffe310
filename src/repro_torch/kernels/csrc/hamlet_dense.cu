// Dense-burst propagation for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hamlet_dense.py
// (dense_propagate_pallas, body _dense_kernel).  A dense burst has the
// strictly-lower all-ones adjacency, so (I - L)^{-1}[i, j] = 2^{i-j-1} and
// per column
//
//     c_i = b_i + s_{i-1},   s_i = 2 s_{i-1} + b_i,   s_{-1} = 0.
//
// What bounds it on this card: it reads base once and writes out once and
// does three operations per element, so the roofline bound is bytes.  What
// a simple kernel pays instead is the recurrence's chain: b dependent rows
// per column, each a shared-memory round trip when one thread runs a
// column row by row (~30 ns a row on an H100, 0.015 ms for 511 rows at
// (485, 512, 2) f64).
//
// Design: the row step is the affine map s -> 2 s + b_i, and a run of R rows
// composes to s -> 2^R s + t.  Maps compose associatively, so a warp scans
// them.  One warp per (batch element, chunk of C columns): C = d up to 4
// and 1 beyond, so every chunk is exactly C columns wide and C is known at
// compile time; kWarps independent warps a block (no block barrier).  Lane
// l owns the FIXED run of rows [16 l, 16 l + 16), so 32 lanes cover the 512
// rows of DENSE_B_MAX in one pass:
//   1. the warp loads its [b, C] slice with coalesced loads, all of them in
//      flight at once, into a per-warp shared-memory tile padded by one
//      element after every run (a run of 16 rows is 128 * C bytes in f64,
//      which would put every lane's run on the same banks);
//   2. each lane reads its run into registers and folds it from s = 0 into
//      t (16 dependent fma(2, t, b)); __shfl_up_sync rounds (five at
//      b = 512, none up to b = 16) scan the lanes' maps, s -> 2^{16 o} u + t,
//      into the inclusive prefix, and one more shuffle gives each lane its
//      carry-in s_{16 l - 1};
//   3. the lane replays its rows from the carry-in, c_i = b_i + s, into the
//      tile, and the warp stores the tile with coalesced stores.
// The chain per column is 16 + 16 fma and at most six shuffle rounds, where
// it was b rows.  Loads, stores (steps of 32 elements), rows and scan
// rounds stop near b, not at the 512 cap (see gate): most of the main
// path's bursts are small (b of 1-128), where a kernel's time is its launch
// and one round trip to memory, and every instruction spent on an empty
// slot shows.
//
// Why the split is fixed and not b / 32: the executor pads a burst to
// next_pow2(b) rows in a batched bucket and calls with the burst's own b
// when unbatched.  With a fixed split, row i sees the same operations
// whatever the padded length: the zero rows come after the real ones, a
// Hillis-Steele scan never reads lanes above its own, and the rounds a
// longer padding adds change no lane below the offset.  So batched equals
// per-burst and results do not change with K, bitwise.
//
// Arithmetic: in f64 for both dtypes (f32 in and out, as the plain version
// does), so no intermediate can saturate earlier than the plain version's;
// the scale 2^{16 o} is applied as an integer exponent with scalbn, never
// formed as a float (0 * 2^k must stay 0, and 2^256 is inf in f32).  Adding
// in another order than the closed form, the result is exact for
// integer-valued inputs whose sums stay below 2^53 (what COUNT feeds it)
// and within a few ulp otherwise.  Inputs are non-negative, so an inf stays
// inf through every later row, as in the sequential recurrence.
#include <cstdint>

#include "hamlet_kernels.h"

namespace {

constexpr int kRun = 16;                  // rows per lane, whatever b is
constexpr int kRowsMax = 32 * kRun;       // one warp pass: DENSE_B_MAX
constexpr int kWarps = 4;                 // warps per block
constexpr unsigned kFull = 0xffffffffu;

// Loops over steps and rows test their warp-uniform end only before index
// 2, 4, 8, 16, ...: a loop stops within twice its trip count, and a full
// one pays a handful of branches, not one per index
__host__ __device__ constexpr bool gate(int k) {
  return k >= 2 && (k & (k - 1)) == 0;
}

// a lane's run in the tile, padded by one element
template <int C>
__host__ __device__ constexpr int run_pitch() { return kRun * C + 1; }

// where element e of a chunk's [b, C] slice sits in the padded tile
template <int C>
__device__ __forceinline__ int tile_at(int e) { return e + e / (kRun * C); }

// where element e of a chunk's [b, C] slice sits in base and out, from the
// chunk's first element (e itself when the chunk is all of d)
template <int C>
__device__ __forceinline__ int64_t slice_at(int e, int d) {
  return int64_t(e / C) * d + e % C;
}

template <typename T, int C>
__global__ void __launch_bounds__(kWarps * 32)
    dense_propagate_kernel(const T* __restrict__ base, T* __restrict__ out,
                           int nb, int b, int d) {
  constexpr int kSlots = kRun * C;  // a lane's share of the largest slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t bi = int64_t(blockIdx.x) * kWarps + warp;
  if (bi >= nb) return;  // the whole warp: no shuffle is left waiting
  const int runs = (b + kRun - 1) / kRun;  // lanes that hold rows
  const int n = b * C;                     // elements of the slice
  const int steps = (n + 31) / 32;         // warp-wide steps over them
  const int64_t first = bi * b * d + int64_t(blockIdx.y) * C;
  const T* src = base + first;
  T* dst = out + first;
  T* tile = reinterpret_cast<T*>(smem_raw) + warp * runs * run_pitch<C>();

  // 1. coalesced loads, all in flight before the first store to the tile;
  //    a step past the slice reloads its last element
  T g[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (gate(k) && k >= steps) break;
    g[k] = src[slice_at<C>(min(lane + 32 * k, n - 1), d)];
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (gate(k) && k >= steps) break;
    const int e = lane + 32 * k;
    if (e < n) tile[tile_at<C>(e)] = g[k];
  }
  __syncwarp();

  // 2. this lane's run into registers; with more than one run, its map
  //    from s = 0 and the scan of the lanes' maps give its carry-in
  const int rows = max(0, min(kRun, b - lane * kRun));
  const int rmax = min(kRun, b);  // rows of a full lane
  T* run = tile + lane * run_pitch<C>();
  T v[kRun][C];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (gate(r) && r >= rmax) break;
#pragma unroll
    for (int c = 0; c < C; ++c) v[r][c] = r < rows ? run[r * C + c] : T(0);
  }
  double s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.0;
  if (runs > 1) {  // warp-uniform; then rmax == kRun and every v[r] is set
    double t[C];
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = 0.0;
#pragma unroll
    for (int r = 0; r < kRun; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c)
        t[c] = fma(2.0, t[c], static_cast<double>(v[r][c]));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      if (o >= runs) break;  // lanes below runs already hold their prefix
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const double u = __shfl_up_sync(kFull, t[c], o);
        if (lane >= o) t[c] = scalbn(u, kRun * o) + t[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double u = __shfl_up_sync(kFull, t[c], 1);
      s[c] = lane ? u : 0.0;
    }
  }

  // 3. replay the run from its carry-in into the tile, then coalesced stores
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (gate(r) && r >= rmax) break;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double x = static_cast<double>(v[r][c]);
      if (r < rows) run[r * C + c] = static_cast<T>(x + s[c]);
      s[c] = fma(2.0, s[c], x);
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (gate(k) && k >= steps) break;
    const int e = lane + 32 * k;
    if (e < n) dst[slice_at<C>(e, d)] = tile[tile_at<C>(e)];
  }
}

template <typename T, int C>
cudaError_t launch_cols(const void* base, void* out, int nb, int b, int d,
                        cudaStream_t stream) {
  auto kernel = dense_propagate_kernel<T, C>;
  constexpr int kSmemMax = kWarps * 32 * run_pitch<C>() * int(sizeof(T));
  static bool attribute_set = false;  // once per instantiation
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int chunks = d / C;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      size_t(kWarps) * ((b + kRun - 1) / kRun) * run_pitch<C>() * sizeof(T);
  const dim3 grid((nb + kWarps - 1) / kWarps, chunks);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(base), static_cast<T*>(out), nb, b, d);
  return cudaGetLastError();
}

// a chunk is all of d up to 4 columns, one column beyond: every warp's
// chunk then has exactly C columns
template <typename T>
cudaError_t launch_typed(const void* base, void* out, int nb, int b, int d,
                         cudaStream_t stream) {
  switch (d) {
    case 2: return launch_cols<T, 2>(base, out, nb, b, d, stream);
    case 3: return launch_cols<T, 3>(base, out, nb, b, d, stream);
    case 4: return launch_cols<T, 4>(base, out, nb, b, d, stream);
    default: return launch_cols<T, 1>(base, out, nb, b, d, stream);
  }
}

}  // namespace

cudaError_t launch_dense_propagate(int dtype, const void* base, void* out,
                                   int nb, int b, int d, cudaStream_t stream) {
  if (nb <= 0 || b <= 0 || d <= 0 || b > kRowsMax)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kHamletF64:
      return launch_typed<double>(base, out, nb, b, d, stream);
    case kHamletF32:
      return launch_typed<float>(base, out, nb, b, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
