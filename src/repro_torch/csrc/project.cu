// Fused consensus update: out = x + gamma_j (v - W^T (W v)), v = xbar - x, for
// W (J, p, n), x and xbar (J, n, k), gamma a scalar or a (J,) vector. x may be
// null, meaning 0: then the call is the projection (I - W^T W) xbar.
//
// Replaces: the Pallas TPU kernels of src/repro/kernels/project/project.py,
// consensus_update_padded: pass 1 `_matvec_kernel` (u = W v, reduced over
// n-tiles) and pass 2 `_update_kernel` (out = x + gamma (v - W^T u)), which
// the reference vmaps over the J blocks and k columns. Here one launch of
// each pass covers all J x k columns.
//
// What bounds it on an H100: reading W. At the main path's W (8, 1164, 2327)
// f32 and k = 32 the two passes read W twice (173 MB, ~52 us at 3.35 TB/s)
// against 2.8 GFLOP of f32 FMAs (~41 us at 67 TFLOP/s): the k columns are
// what make W worth reading, so each W element is used for a whole k-tile.
//
// Design:
//   * pass 1: one block per (j, 32-row p-tile, 32-column k-tile); it reduces
//     over all of n in 64-wide chunks inside the block, in a fixed order, so
//     u needs no atomics and no second reduction. W is staged transposed in
//     shared memory so each thread reads its 4 rows as one broadcast float4;
//   * pass 2: one block per (j, 32-row n-tile, k-tile) reduces W^T u over p in
//     64-row chunks, then applies the update in registers;
//   * u (J, p, k) is float32 scratch allocated by the caller;
//   * W may be f32, bf16 or f64 and x/xbar f32, bf16 or f64: every product
//     accumulates in f32 and the result is stored in x's dtype, as the
//     reference casts to f32 inside its kernel bodies.
// No library call computes any product here (no cuBLAS, no torch.matmul).
#include "common.cuh"

namespace {

constexpr int KT = 32;   // k-tile: one column per lane
constexpr int RPT = 4;   // rows (pass 1) / n entries (pass 2) per thread
constexpr int ROWS = 8 * RPT;  // 8 warps x 4 = 32-row tile
constexpr int CH = 64;   // reduction chunk

template <typename TW, typename TX>
__global__ void __launch_bounds__(256) wv_kernel(const TW* __restrict__ W,
                                                 const TX* __restrict__ x,
                                                 const TX* __restrict__ xbar,
                                                 float* __restrict__ u, int p, int n, int k) {
  __shared__ __align__(16) float wt[CH][ROWS + 4];  // wt[s][r] = W[p0 + r][n0 + s]
  __shared__ float vs[CH][KT];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;
  const int j = blockIdx.z, p0 = blockIdx.x * ROWS, c = blockIdx.y * KT + tx;
  const TW* Wj = W + (size_t)j * p * n;
  const TX* xj = x ? x + (size_t)j * n * k : nullptr;
  const TX* xbj = xbar + (size_t)j * n * k;
  float acc[RPT] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < n; n0 += CH) {
    __syncthreads();
    for (int e = tid; e < ROWS * CH; e += 256) {
      const int r = e / CH, s = e % CH;  // coalesced along W's rows
      const int gr = p0 + r, gs = n0 + s;
      wt[s][r] = (gr < p && gs < n) ? to_f32(Wj[(size_t)gr * n + gs]) : 0.f;
    }
    for (int e = tid; e < CH * KT; e += 256) {
      const int s = e / KT, cc = blockIdx.y * KT + e % KT;
      const int gs = n0 + s;
      float v = 0.f;
      if (gs < n && cc < k) {
        const size_t off = (size_t)gs * k + cc;
        v = xj ? diff_f32(xbj[off], xj[off]) : to_f32(xbj[off]);
      }
      vs[s][e % KT] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < CH; ++s) {
      const float4 w4 = *reinterpret_cast<const float4*>(&wt[s][ty * RPT]);
      const float vv = vs[s][tx];
      acc[0] += w4.x * vv;
      acc[1] += w4.y * vv;
      acc[2] += w4.z * vv;
      acc[3] += w4.w * vv;
    }
  }
  if (c < k) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int gr = p0 + ty * RPT + i;
      if (gr < p) u[((size_t)j * p + gr) * k + c] = acc[i];
    }
  }
}

template <typename TW, typename TX>
__global__ void __launch_bounds__(256) update_kernel(const TW* __restrict__ W,
                                                     const TX* __restrict__ x,
                                                     const TX* __restrict__ xbar,
                                                     const float* __restrict__ u,
                                                     const float* __restrict__ gamma,
                                                     float gamma_scalar, TX* __restrict__ out,
                                                     int p, int n, int k) {
  __shared__ __align__(16) float ws[CH][ROWS + 4];  // ws[r][s] = W[r0 + r][n0 + s]
  __shared__ float us[CH][KT];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;
  const int j = blockIdx.z, n0 = blockIdx.x * ROWS, c = blockIdx.y * KT + tx;
  const TW* Wj = W + (size_t)j * p * n;
  const float* uj = u + (size_t)j * p * k;
  float acc[RPT] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = 0; r0 < p; r0 += CH) {
    __syncthreads();
    for (int e = tid; e < CH * ROWS; e += 256) {
      const int r = e / ROWS, s = e % ROWS;  // coalesced along W's rows
      const int gr = r0 + r, gs = n0 + s;
      ws[r][s] = (gr < p && gs < n) ? to_f32(Wj[(size_t)gr * n + gs]) : 0.f;
    }
    for (int e = tid; e < CH * KT; e += 256) {
      const int r = e / KT, cc = blockIdx.y * KT + e % KT;
      const int gr = r0 + r;
      us[r][e % KT] = (gr < p && cc < k) ? uj[(size_t)gr * k + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < CH; ++r) {
      const float4 w4 = *reinterpret_cast<const float4*>(&ws[r][ty * RPT]);
      const float uu = us[r][tx];
      acc[0] += w4.x * uu;
      acc[1] += w4.y * uu;
      acc[2] += w4.z * uu;
      acc[3] += w4.w * uu;
    }
  }
  if (c >= k) return;
  const float g = gamma ? gamma[j] : gamma_scalar;
  const TX* xj = x ? x + (size_t)j * n * k : nullptr;
  const TX* xbj = xbar + (size_t)j * n * k;
  TX* oj = out + (size_t)j * n * k;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gs = n0 + ty * RPT + i;
    if (gs >= n) continue;
    const size_t off = (size_t)gs * k + c;
    const float xv = xj ? to_f32(xj[off]) : 0.f;
    const float v = to_f32(xbj[off]) - xv;
    oj[off] = from_f32<TX>(xv + g * (v - acc[i]));
  }
}

template <typename TW, typename TX>
int launch(const void* W, const void* x, const void* xbar, const float* gamma,
           float gamma_scalar, float* u, void* out, int J, int p, int n, int k,
           cudaStream_t stream) {
  const dim3 block(32, 8);
  const int ktiles = (k + KT - 1) / KT;
  wv_kernel<TW, TX><<<dim3((p + ROWS - 1) / ROWS, ktiles, J), block, 0, stream>>>(
      static_cast<const TW*>(W), static_cast<const TX*>(x), static_cast<const TX*>(xbar), u,
      p, n, k);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  update_kernel<TW, TX><<<dim3((n + ROWS - 1) / ROWS, ktiles, J), block, 0, stream>>>(
      static_cast<const TW*>(W), static_cast<const TX*>(x), static_cast<const TX*>(xbar), u,
      gamma, gamma_scalar, static_cast<TX*>(out), p, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW>
int dispatch_x(int x_dtype, const void* W, const void* x, const void* xbar, const float* gamma,
               float gamma_scalar, float* u, void* out, int J, int p, int n, int k,
               cudaStream_t s) {
  switch (x_dtype) {
    case DT_F32: return launch<TW, float>(W, x, xbar, gamma, gamma_scalar, u, out, J, p, n, k, s);
    case DT_F64: return launch<TW, double>(W, x, xbar, gamma, gamma_scalar, u, out, J, p, n, k, s);
    case DT_BF16:
      return launch<TW, __nv_bfloat16>(W, x, xbar, gamma, gamma_scalar, u, out, J, p, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches both passes on `stream`; returns cudaGetLastError() (0 = launched).
// `gamma` is a (J,) float32 device vector, or null to use `gamma_scalar`.
extern "C" int consensus_update_launch(const void* W, const void* x, const void* xbar,
                                       const void* gamma, float gamma_scalar, void* u,
                                       void* out, int J, int p, int n, int k, int w_dtype,
                                       int x_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* uf = static_cast<float*>(u);
  switch (w_dtype) {
    case DT_F32: return dispatch_x<float>(x_dtype, W, x, xbar, g, gamma_scalar, uf, out, J, p, n, k, s);
    case DT_F64: return dispatch_x<double>(x_dtype, W, x, xbar, g, gamma_scalar, uf, out, J, p, n, k, s);
    case DT_BF16:
      return dispatch_x<__nv_bfloat16>(x_dtype, W, x, xbar, g, gamma_scalar, uf, out, J, p, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
