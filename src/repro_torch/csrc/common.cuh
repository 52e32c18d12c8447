// Shared helpers for the hand-written kernels: dtype codes (kept in step with
// repro_torch/kernels/_build.py DTYPE_CODES) and float conversions.
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
