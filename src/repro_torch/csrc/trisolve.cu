// Batched blocked triangular solve: x = op(R)^-1 y for R (J, n, n), y (J, n, k).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/trisolve/trisolve.py,
// trisolve_padded (body _trisolve_kernel + _neumann_tri_solve), which the
// reference vmaps over the J blocks and the k right-hand-side columns. Here
// one launch covers all J x k columns.
//
// What bounds it on an H100: not bytes (half of R is ~22 MB at the main
// path's n = 2327, J = 2: a few microseconds at 3.35 TB/s) and not FLOPs
// (J k n^2), but the dependency chain of substitution: n sequential pivot
// steps, each waiting on the one before. The TPU kernel ran its grid in order
// on one core and carried the partial solution in VMEM scratch; GPU blocks
// run in no order, so the sequential grid becomes a loop inside one thread
// block per (j, tile of kt <= 8 columns).
//
// Design:
//   * the loop walks TB x TB diagonal blocks in solve order (reverse for
//     upper). Each step first subtracts the off-diagonal row block's product
//     with the already-solved part of x, streaming TB x TB tiles of R and the
//     matching rows of x through shared memory; the thread holding rows
//     (lane, lane + 32) of column (warp) accumulates in registers;
//   * the diagonal block is then solved by plain substitution, one warp per
//     column: the pivot row's value is broadcast with __shfl_sync, so the
//     TB sequential steps need no block-wide barrier (the TPU kernel's Neumann
//     doubling existed to feed its matrix unit and is not needed here);
//   * ragged n is masked by bounds checks (no identity-extended copy of R);
//   * `trans` reads op(R) = R^T through swapped indices, so the wide regime's
//     lower solve on R^T needs no transposed copy;
//   * float32 accumulates in float32, float64 in float64 (the reference's
//     promote(R.dtype, f32) scratch). Shared memory is TB (TB + 1) + TB kt
//     elements: 18.7 KB in f32, 37.4 KB in f64, under the 48 KB static limit.
// No library call computes any product here.
#include "common.cuh"

namespace {

constexpr int TB = 64;  // diagonal block edge = rows per step (2 per lane)

// tile[s * (TB + 1) + r] = op(R)(row0 + r, col0 + s), zero outside [0, n).
// Loads run along R's contiguous axis; the +1 pad keeps the transposed
// store free of bank conflicts.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ Rj, int n, bool trans,
                                          int row0, int col0, T* tile) {
  for (int e = threadIdx.x; e < TB * TB; e += blockDim.x) {
    const int fast = e % TB, slow = e / TB;
    const int r = trans ? fast : slow;
    const int s = trans ? slow : fast;
    const int gr = row0 + r, gs = col0 + s;
    T val = T(0);
    if (gr < n && gs < n) {
      val = trans ? Rj[(size_t)gs * n + gr] : Rj[(size_t)gr * n + gs];
    }
    tile[s * (TB + 1) + r] = val;
  }
}

template <typename T>
__global__ void trisolve_kernel(const T* __restrict__ R, const T* __restrict__ y,
                                T* __restrict__ x, int n, int k, bool lower, bool trans) {
  const int kt = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.y;
  const int c0 = blockIdx.x * kt;
  const int c = c0 + warp;  // this warp's column
  const bool col_ok = c < k;
  const T* Rj = R + (size_t)j * n * n;
  const T* yj = y + (size_t)j * n * k;
  T* xj = x + (size_t)j * n * k;

  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [TB][TB + 1]
  T* xs = tile + TB * (TB + 1);              // [TB][kt]

  const int r0 = lane, r1 = lane + 32;
  const int nblk = (n + TB - 1) / TB;
  for (int step = 0; step < nblk; ++step) {
    const int row0 = (lower ? step : nblk - 1 - step) * TB;
    const int nb = min(TB, n - row0);

    // 1. off-diagonal row block times the solved part of x
    T acc0 = T(0), acc1 = T(0);
    const int s_lo = lower ? 0 : row0 + TB;
    const int s_hi = lower ? row0 : n;
    for (int s0 = s_lo; s0 < s_hi; s0 += TB) {
      const int ns = min(TB, s_hi - s0);
      __syncthreads();  // earlier readers of tile/xs are done; x rows visible
      load_tile(Rj, n, trans, row0, s0, tile);
      for (int e = threadIdx.x; e < TB * kt; e += blockDim.x) {
        const int s = e / kt, cc = c0 + e % kt;
        xs[e] = (s < ns && cc < k) ? xj[(size_t)(s0 + s) * k + cc] : T(0);
      }
      __syncthreads();
      for (int s = 0; s < ns; ++s) {
        const T xv = xs[s * kt + warp];
        acc0 += tile[s * (TB + 1) + r0] * xv;
        acc1 += tile[s * (TB + 1) + r1] * xv;
      }
    }

    // 2. the diagonal block, one warp per column
    __syncthreads();
    load_tile(Rj, n, trans, row0, row0, tile);
    __syncthreads();
    T v0 = (col_ok && r0 < nb) ? yj[(size_t)(row0 + r0) * k + c] - acc0 : T(0);
    T v1 = (col_ok && r1 < nb) ? yj[(size_t)(row0 + r1) * k + c] - acc1 : T(0);
    for (int t = 0; t < nb; ++t) {
      const int q = lower ? t : nb - 1 - t;
      const int owner = q & 31;
      const T vq = __shfl_sync(0xffffffffu, q < 32 ? v0 : v1, owner);
      const T xq = vq / tile[q * (TB + 1) + q];
      if (lane == owner) {
        if (q < 32) v0 = xq; else v1 = xq;
      }
      // rows not yet solved take the pivot's contribution
      if (lower ? r0 > q : r0 < q) v0 -= tile[q * (TB + 1) + r0] * xq;
      if (lower ? r1 > q : r1 < q) v1 -= tile[q * (TB + 1) + r1] * xq;
    }
    if (col_ok) {
      if (r0 < nb) xj[(size_t)(row0 + r0) * k + c] = v0;
      if (r1 < nb) xj[(size_t)(row0 + r1) * k + c] = v1;
    }
  }
}

template <typename T>
int launch(const void* R, const void* y, void* x, int J, int n, int k, bool lower,
           bool trans, cudaStream_t stream) {
  const int kt = k < 8 ? k : 8;
  const dim3 grid((k + kt - 1) / kt, J);
  const dim3 block(32 * kt);
  const size_t smem = (size_t)(TB * (TB + 1) + TB * kt) * sizeof(T);
  trisolve_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(R), static_cast<const T*>(y), static_cast<T*>(x), n, k, lower,
      trans);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int trisolve_launch(const void* R, const void* y, void* x, int J, int n, int k,
                               int lower, int trans, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return launch<float>(R, y, x, J, n, k, lower != 0, trans != 0, s);
    case DT_F64: return launch<double>(R, y, x, J, n, k, lower != 0, trans != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
