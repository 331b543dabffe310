// Masked prefix propagation for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hamlet_propagate.py
// (masked_prefix_propagate_pallas, body _propagate_kernel).  Per batch
// element it solves (I - L) C = B with L strictly lower triangular:
//
//     c[i] = base[i] + sum_{j<i} mask[i, j] * c[j]
//
// What bounds it on this card: the mask is the only large operand
// (nb * b * b entries against nb * b * d for base and out, with d of 1-5 on
// every workload), and each entry is used for one multiply-add, so the
// function is bound by the bytes it must read.  But rows depend on every
// earlier row, so the work is a chain of b steps per batch element, and at
// the engine's shapes (nb <= ~80 buckets of b <= ~1100 rows) it is the
// latency of that chain, not bandwidth, that a simple kernel pays for.
//
// Design: one block per (batch element, chunk of kCols columns); the block
// walks the rows in tiles of 32.
//   1. cross-tile: each of the 32 rows of the tile takes its contribution
//      from the rows already solved (j < r0) as a warp-wide dot product over
//      j (coalesced mask reads, warp-shuffle reduction), one warp per row,
//      eight warps in parallel;
//   2. the diagonal 32 x 32 block of the mask is staged in shared memory;
//   3. one warp solves the tile by forward substitution: lane r owns row r,
//      row jj's value is broadcast with a shuffle once it is final, and every
//      later lane adds mask[r, jj] * c[jj].
// So a block pays two barriers per 32 rows instead of one per row.  Solved
// rows stay in shared memory when b * kCols values fit (b <= ~6000 in f64),
// otherwise they are read back from the output in global memory.
//
// Semantics kept from the row oracle (repro_torch.kernels.ref
// .torch_prefix_propagate_batched): only mask[i, j] with j < i is read (the
// diagonal and the upper triangle are ignored); every product is formed,
// zeros included, so 0 * inf gives NaN where the oracle's does; f64 and f32
// accumulate in their own type (no tensor cores, so no TF32); int32
// accumulates in uint32, i.e. exactly modulo 2^32 like the oracle's
// wrapping int32 arithmetic.
#include <cstdint>

#include "hamlet_kernels.h"

namespace {

constexpr int kTile = 32;   // rows per in-tile solve: one warp
constexpr int kWarps = 8;   // warps per block
constexpr int kCols = 4;    // columns per block
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may take for its solved rows
constexpr size_t kSmemSolvedMax = 200 * 1024;

template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<int32_t> {
  using type = uint32_t;  // wrapping arithmetic without signed overflow
};

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kWarps * 32)
    masked_propagate_kernel(const T* __restrict__ base,
                            const T* __restrict__ mask, T* out, int b, int d) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* solved = reinterpret_cast<Acc*>(smem_raw);  // [b][kCols] if kSmem
  __shared__ Acc ytile[kTile][kCols];
  __shared__ Acc mtile[kTile][kTile + 1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t bi = blockIdx.x;
  const int col0 = blockIdx.y * kCols;
  const int nc = min(kCols, d - col0);
  const T* B = base + bi * b * d;
  const T* M = mask + bi * b * b;
  T* O = out + bi * b * d;

  auto c_at = [&](int j, int cc) -> Acc {
    return kSmem ? solved[j * kCols + cc]
                 : static_cast<Acc>(O[int64_t(j) * d + col0 + cc]);
  };

  for (int r0 = 0; r0 < b; r0 += kTile) {
    const int rows = min(kTile, b - r0);

    // 1. contributions of the solved rows j < r0, one warp per tile row
    for (int rr = warp; rr < rows; rr += kWarps) {
      const int i = r0 + rr;
      const T* mrow = M + int64_t(i) * b;
      Acc acc[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[cc] = Acc(0);
      for (int j = lane; j < r0; j += 32) {
        const Acc m = static_cast<Acc>(mrow[j]);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          if (cc < nc) acc[cc] += m * c_at(j, cc);
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const Acc s = warp_sum(acc[cc]);
        if (lane == 0 && cc < nc)
          ytile[rr][cc] = static_cast<Acc>(B[int64_t(i) * d + col0 + cc]) + s;
      }
    }

    // 2. the tile's diagonal block, strictly lower part only
    for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
      const int rr = e / kTile;
      const int jj = e % kTile;
      mtile[rr][jj] = (rr < rows && jj < rr)
                          ? static_cast<Acc>(M[int64_t(r0 + rr) * b + r0 + jj])
                          : Acc(0);
    }
    __syncthreads();

    // 3. forward substitution inside the tile: lane rr owns row r0 + rr
    if (warp == 0) {
      Acc v[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        v[cc] = (lane < rows && cc < nc) ? ytile[lane][cc] : Acc(0);
      for (int jj = 0; jj + 1 < rows; ++jj) {
        const Acc m = mtile[lane][jj];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const Acc cj = __shfl_sync(kFull, v[cc], jj);
          // rows at or above jj are final: only later rows take the term
          if (lane > jj) v[cc] += m * cj;
        }
      }
      if (lane < rows) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          if (cc < nc) {
            if (kSmem) solved[(r0 + lane) * kCols + cc] = v[cc];
            O[int64_t(r0 + lane) * d + col0 + cc] = static_cast<T>(v[cc]);
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_typed(const void* base, const void* mask, void* out,
                         int nb, int b, int d, cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  const dim3 grid(nb, (d + kCols - 1) / kCols);
  const dim3 block(kWarps * 32);
  const size_t smem = size_t(b) * kCols * sizeof(Acc);
  const T* bp = static_cast<const T*>(base);
  const T* mp = static_cast<const T*>(mask);
  T* op = static_cast<T*>(out);
  if (smem <= kSmemSolvedMax) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_propagate_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemSolvedMax));
    if (err != cudaSuccess) return err;
    masked_propagate_kernel<T, true><<<grid, block, smem, stream>>>(
        bp, mp, op, b, d);
  } else {
    masked_propagate_kernel<T, false><<<grid, block, 0, stream>>>(
        bp, mp, op, b, d);
  }
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_masked_propagate(int dtype, const void* base,
                                    const void* mask, void* out, int nb,
                                    int b, int d, cudaStream_t stream) {
  if (nb <= 0 || b <= 0 || d <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kHamletF64:
      return launch_typed<double>(base, mask, out, nb, b, d, stream);
    case kHamletF32:
      return launch_typed<float>(base, mask, out, nb, b, d, stream);
    case kHamletI32:
      return launch_typed<int32_t>(base, mask, out, nb, b, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
