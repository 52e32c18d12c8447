// Shared helpers for the hand-written kernels: dtype codes (kept in step with
// repro_torch/kernels/_build.py DTYPE_CODES), float conversions, the dynamic
// shared memory limit, and the 3xTF32 products, cp.async copies and
// self-resetting tickets of the tensor-core kernels (project.cu, residual.cu).
#pragma once

#include <cstdint>

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

// ---- 3xTF32 ----------------------------------------------------------------

// a = hi + lo to 21 bits: hi is a's bits plus half a TF32 unit, which the
// tensor core truncates to a rounded to nearest (ties away, as cvt.rna);
// lo = a - tf32(a) is exact in f32 and truncated to TF32 by the same rule.
// Three integer/f32 operations, where two cvt.rna.tf32.f32 would be slower.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) + 0x1000u;
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- global -> shared ------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- tickets ---------------------------------------------------------------

// After every thread stored its part of the block's result: true in the last
// of `splits` blocks sharing `ticket` to arrive, which resets the ticket to 0
// for the next launch (so a replayed CUDA graph finds it zeroed).
__device__ __forceinline__ bool last_arrival(int* ticket, int splits) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == splits - 1;
    if (last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}
