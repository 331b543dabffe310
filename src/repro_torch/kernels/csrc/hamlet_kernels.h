// Host-side launchers of the hand-written HAMLET kernels (sm_90a).
//
// Every launcher enqueues on the given stream, never synchronises, allocates
// nothing, and returns cudaGetLastError() after the launch so that a refused
// launch (too much shared memory, a bad grid) reaches the caller.
#pragma once

#include <cuda_runtime.h>

// dtype codes: shared with repro_torch/kernels/_build.py::DTYPE_CODES
enum HamletDtype : int { kHamletF64 = 0, kHamletF32 = 1, kHamletI32 = 2 };

// c[i] = base[i] + sum_{j<i} mask[i, j] * c[j] per batch element.
// base/out [nb, b, d] and mask [nb, b, b], contiguous, all of one dtype.
cudaError_t launch_masked_propagate(int dtype, const void* base,
                                    const void* mask, void* out, int nb,
                                    int b, int d, cudaStream_t stream);

// Dense burst closed form c_i = b_i + s_{i-1}, s_i = 2 s_{i-1} + b_i per
// column.  base/out [nb, b, d] contiguous, f64 or f32.
cudaError_t launch_dense_propagate(int dtype, const void* base, void* out,
                                   int nb, int b, int d, cudaStream_t stream);
