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
// does two additions per element, so it is bound by bytes; at the engine's
// shapes (nb <= ~500 bursts of b <= 512 rows, d of 1-5) the whole problem is
// a few MB and the sequential chain over b rows is what a simple kernel
// pays for.
//
// Design: one block per (batch element, chunk of kCols columns).  The block
// stages its [b, nc] slice in shared memory with coalesced loads, one thread
// per column runs the recurrence over the rows in shared memory, and the
// block writes the slice back with coalesced stores.
//
// Unlike the TPU kernel, which downcasts to f32 and carries the running sum
// across 64-row tiles with precomputed power-of-two weights, this kernel
// computes in the input's dtype (f64 on the engine's path).  Doubling is
// exact, so fl(2 s + b) = 2^i fl(t_{i-1} + 2^{-i} b_i): the recurrence rounds
// exactly like the weighted-cumsum closed form of the numpy oracle
// (repro_torch.kernels.ref.prefix_propagate_dense_np), saturation to inf and
// NaN included, for the non-negative inputs the engine feeds it.
#include <cstdint>

#include "hamlet_kernels.h"

namespace {

constexpr int kCols = 8;       // columns per block
constexpr int kThreads = 128;  // threads per block (staging and stores)
constexpr size_t kSmemMax = 200 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_propagate_kernel(const T* __restrict__ base, T* __restrict__ out,
                           int b, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [b][nc]
  const int64_t bi = blockIdx.x;
  const int col0 = blockIdx.y * kCols;
  const int nc = min(kCols, d - col0);
  const T* B = base + bi * b * d;
  T* O = out + bi * b * d;
  const int n = b * nc;

  for (int e = threadIdx.x; e < n; e += blockDim.x)
    tile[e] = B[int64_t(e / nc) * d + col0 + e % nc];
  __syncthreads();

  if (threadIdx.x < nc) {
    T* col = tile + threadIdx.x;
    T s = col[0];  // c_0 = b_0 and s_0 = b_0
    for (int i = 1; i < b; ++i) {
      const T bv = col[i * nc];
      col[i * nc] = bv + s;
      s = (s + s) + bv;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < n; e += blockDim.x)
    O[int64_t(e / nc) * d + col0 + e % nc] = tile[e];
}

template <typename T>
cudaError_t launch_typed(const void* base, void* out, int nb, int b, int d,
                         cudaStream_t stream) {
  const size_t smem = size_t(b) * (d < kCols ? d : kCols) * sizeof(T);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dense_propagate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kSmemMax));
  if (err != cudaSuccess) return err;
  const dim3 grid(nb, (d + kCols - 1) / kCols);
  dense_propagate_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(base), static_cast<T*>(out), b, d);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_dense_propagate(int dtype, const void* base, void* out,
                                   int nb, int b, int d, cudaStream_t stream) {
  if (nb <= 0 || b <= 0 || d <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kHamletF64:
      return launch_typed<double>(base, out, nb, b, d, stream);
    case kHamletF32:
      return launch_typed<float>(base, out, nb, b, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
