// Shared helpers for the hand-written kernels: dtype codes (kept in step with
// repro_torch/kernels/_build.py DTYPE_CODES), float conversions, and the
// dynamic shared memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DTypeCode { DT_F32 = 0, DT_F64 = 1, DT_BF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ double from_f32<double>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// (a - b) rounded in the storage type, then widened: the reference's first
// pass forms x̄ − x in the input dtype before its f32 cast.
__device__ __forceinline__ float diff_f32(float a, float b) { return a - b; }
__device__ __forceinline__ float diff_f32(double a, double b) { return static_cast<float>(a - b); }
__device__ __forceinline__ float diff_f32(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __bfloat162float(__hsub(a, b));
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once per device (`devices_done` is the caller's static bit mask):
// the limit holds for every later launch, so later launches, inside a
// CUDA-graph capture too, make no further cudaFuncSetAttribute call.
template <typename Kernel>
cudaError_t smem_limit_once(Kernel kernel, int bytes, unsigned& devices_done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (devices_done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) devices_done |= bit;
  return e;
}
