// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel library is a plain C shared object loaded with ctypes
// (fastdm_tpu_torch/kernels/build.py). Each launcher returns the value of
// cudaGetLastError() right after its launch, so a launch the CUDA runtime refuses
// (too many threads, too much shared memory) surfaces as a Python exception in
// the wrapper instead of a silent no-op.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FDM_EXPORT extern "C" __attribute__((visibility("default")))

// Human-readable text for an error code returned by a launcher.
#define FDM_DEFINE_ERROR_STRING(prefix)                          \
  FDM_EXPORT const char* prefix##_error_string(int code) {      \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }
