// Helpers shared by the port's CUDA sources (matmul, fused_addnorm,
// bn_forward, flash_attention): the element types the kernels take, their
// conversion to and from float, and the error-string export every library
// carries.  The libraries' names hash this header too (kernels/_ext.py), so
// a change here rebuilds each of them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Element type codes passed from Python (kernels/_dispatch.py::DTYPE_CODE).
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

using bf16 = __nv_bfloat16;

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

#define REPRO_EXPORT_ERROR_STRING(prefix)                                \
  extern "C" const char* prefix##_error_string(int code) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(code));           \
  }
