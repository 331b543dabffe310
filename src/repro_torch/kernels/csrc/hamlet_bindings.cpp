// Plain C interface of the HAMLET kernels, loaded from Python with ctypes
// (repro_torch/kernels/_build.py).  Pointers and the stream arrive as
// integers from torch (tensor.data_ptr(), current_stream().cuda_stream);
// every entry point returns a cudaError_t code, 0 on success.
#include <cstdint>

#include "hamlet_kernels.h"

extern "C" {

int hamlet_masked_propagate(int dtype, const void* base, const void* mask,
                            void* out, int64_t nb, int64_t b, int64_t d,
                            void* stream) {
  return static_cast<int>(launch_masked_propagate(
      dtype, base, mask, out, static_cast<int>(nb), static_cast<int>(b),
      static_cast<int>(d), static_cast<cudaStream_t>(stream)));
}

int hamlet_dense_propagate(int dtype, const void* base, void* out,
                           int64_t nb, int64_t b, int64_t d, void* stream) {
  return static_cast<int>(launch_dense_propagate(
      dtype, base, out, static_cast<int>(nb), static_cast<int>(b),
      static_cast<int>(d), static_cast<cudaStream_t>(stream)));
}

const char* hamlet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
