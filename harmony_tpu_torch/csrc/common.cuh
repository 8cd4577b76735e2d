// Shared by every kernel library of harmony_tpu_torch (one shared library per .cu
// source, each with a plain C interface loaded through ctypes by
// harmony_tpu_torch/ops/cuda_lib.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// The wrappers raise with this text when an entry point returns a cudaError_t other
// than cudaSuccess.
extern "C" const char* harmony_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
