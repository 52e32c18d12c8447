// Blocked-ELL SpMM for the matrix-free path, forward and fused.
//
//   spmm:       out[j, r] = sum_s data[j, r, s] @ x[j, idx[j, r, s]]
//   spmm_fused: the same out, plus contrib[j, r, s] = data[j, r, s]^T @ y[j, r]
//
// idx (J, R, S) int32 column-block ids; data (J, R, S, bp, bn) tiles; x the
// (J, C, bn, k) tile view of the column space (its j-stride may be 0: one
// operand broadcast to every block); y (J, R, bp, k). out (J, R, bp, k) and
// contrib (J, R, S, bn, k) are written in the data type. Padding slots hold
// index 0 and zero data: they add exactly 0, and index 0 is never skipped
// (real tiles live there too).
//
// Replaces: the Pallas TPU kernels of src/repro/kernels/spmm/spmm.py,
// `spmm_padded` (body `_spmm_kernel`) and `spmm_fused_padded` (body
// `_spmm_fused_kernel`). Their grid (J, R, S) walked the slot axis in order
// on one core, revisiting the output stripe in VMEM, with the tile ids as a
// scalar-prefetch operand.
//
// What bounds it on an H100: bytes. A tile of (8, 8) float32 is 256 B and
// feeds 2 * 8 * 8 * k FLOPs per product, so at k = 32 the tiles alone need
// 16 FLOP/B against the card's 20 FLOP/B f32 balance point (67 TFLOP/s over
// 3.35 TB/s), and the gathered x rows (bn * k values per slot, read through
// L2) and, for the fused kernel, the staged contrib (as large as the gathered
// x) push it further to the memory side.
//
// Design:
//   * one thread block per (j, r, 32-column k-tile): the slot loop runs inside
//     the block, which reads its own tile ids (no scalar prefetch here);
//   * the reduction over (slot, tile column) pairs is flattened and walked in
//     chunks of 32: each chunk stages its data (transposed, rows padded to
//     bp + 1 against bank conflicts) and the 32 gathered x rows in shared
//     memory; x keeps its (C, bn, k) layout, k contiguous, so each gathered
//     row is one coalesced read by a warp;
//   * 8 warps split the bp output rows, lanes the k columns; each thread
//     accumulates its (<= 16 rows, 1 column) stripe in registers and writes
//     it once, so every output has one writer and a fixed order of sums
//     (no atomics);
//   * the fused kernel loads y[j, r] once before the slot loop and, from the
//     data chunk already in shared memory, writes each slot's contribution
//     once to its own staging slot (no atomics; the caller scatter-adds);
//   * tiles take any (bp, bn) with each side at most 128; float32 and float64,
//     each accumulated in its own type (float64 is therefore more exact than
//     the reference, which casts tiles to float32 inside its kernel).
// No library call computes any product here (no cuBLAS, no cuSPARSE).
#include "common.cuh"

namespace {

constexpr int KT = 32;             // k-tile: one column per lane
constexpr int NY = 8;              // warps per block, splitting the bp rows
constexpr int CH = 32;             // flattened (slot, tile column) chunk
constexpr int THREADS = KT * NY;
constexpr int MAX_TILE = 128;      // largest bp or bn taken

// Dynamic shared memory, in units of T:
//   ws[CH][bp + 1]  data chunk, transposed: ws[e][p] = data[s(e)][p][b(e)]
//   xs[CH][KT]      gathered x rows:       xs[e][c] = x[idx[s(e)]][b(e)][c]
//   ys[bp][KT]      fused only: the y[j, r] stripe
template <typename T, int RPT, bool FUSED>
__global__ void __launch_bounds__(THREADS) spmm_kernel(
    const int* __restrict__ idx, const T* __restrict__ data, const T* __restrict__ x,
    long long x_jstride, const T* __restrict__ y, T* __restrict__ out,
    T* __restrict__ contrib, int R, int S, int bp, int bn, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  const int wstride = bp + 1;
  T* xs = ws + CH * wstride;
  T* ys = xs + CH * KT;

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * KT + tx;
  const int r = blockIdx.x, kt0 = blockIdx.y * KT, j = blockIdx.z;
  const int kw = min(KT, k - kt0);  // live columns of this k-tile
  const size_t jr = (size_t)j * R + r;
  const int* idx_jr = idx + jr * S;
  const T* data_jr = data + jr * S * bp * bn;
  const T* xj = x + (long long)j * x_jstride;

  if (FUSED) {
    const T* y_jr = y + jr * bp * k;
    for (int t = tid; t < bp * KT; t += THREADS) {
      const int p = t / KT, cc = t % KT;
      ys[t] = cc < kw ? y_jr[(size_t)p * k + kt0 + cc] : T(0);
    }
  }

  T acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = T(0);

  const int total = S * bn;  // flattened reduction length: g = s * bn + b
  for (int e0 = 0; e0 < total; e0 += CH) {
    const int n_e = min(CH, total - e0);
    __syncthreads();  // the previous chunk is consumed (and ys is loaded)
    for (int t = tid; t < CH * bp; t += THREADS) {
      const int p = t / CH, e = t % CH;
      T v = T(0);
      if (e < n_e) {
        const int g = e0 + e, s = g / bn, b = g - s * bn;
        v = data_jr[((size_t)s * bp + p) * bn + b];
      }
      ws[e * wstride + p] = v;
    }
    for (int t = tid; t < CH * KT; t += THREADS) {
      const int e = t / KT, cc = t % KT;
      T v = T(0);
      if (e < n_e && cc < kw) {
        const int g = e0 + e, s = g / bn, b = g - s * bn;
        const int cb = __ldg(idx_jr + s);
        v = xj[((size_t)cb * bn + b) * k + kt0 + cc];
      }
      xs[t] = v;
    }
    __syncthreads();

    for (int e = 0; e < n_e; ++e) {
      const T xv = xs[e * KT + tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int p = ty + NY * i;
        if (p < bp) acc[i] += ws[e * wstride + p] * xv;
      }
    }

    if (FUSED) {
      // contrib[s][b][c] = sum_p data[s][p][b] * y[p][c]: chunk element e is
      // (s, b), and its contribution row starts at (jr * S * bn + e0 + e) * k
      for (int e = ty; e < n_e; e += NY) {
        T sum = T(0);
        for (int p = 0; p < bp; ++p) sum += ws[e * wstride + p] * ys[p * KT + tx];
        if (tx < kw) contrib[(jr * S * bn + e0 + e) * k + kt0 + tx] = sum;
      }
    }
  }

  if (tx < kw) {
    T* out_jr = out + jr * bp * k;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int p = ty + NY * i;
      if (p < bp) out_jr[(size_t)p * k + kt0 + tx] = acc[i];
    }
  }
}

template <typename T, int RPT, bool FUSED>
int launch_rpt(const int* idx, const void* data, const void* x, long long x_jstride,
               const void* y, void* out, void* contrib, int J, int R, int S, int bp, int bn,
               int k, cudaStream_t stream) {
  const size_t smem =
      (size_t)(CH * (bp + 1) + CH * KT + (FUSED ? bp * KT : 0)) * sizeof(T);
  auto kernel = spmm_kernel<T, RPT, FUSED>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(R, (k + KT - 1) / KT, J), block(KT, NY);
  kernel<<<grid, block, smem, stream>>>(
      idx, static_cast<const T*>(data), static_cast<const T*>(x), x_jstride,
      static_cast<const T*>(y), static_cast<T*>(out), static_cast<T*>(contrib), R, S, bp, bn, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FUSED>
int launch(const int* idx, const void* data, const void* x, long long x_jstride, const void* y,
           void* out, void* contrib, int J, int R, int S, int bp, int bn, int k,
           cudaStream_t s) {
  if (bp < 1 || bn < 1 || bp > MAX_TILE || bn > MAX_TILE || S < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (bp + NY - 1) / NY;  // rows per thread, rounded up to 2^i
  if (rows <= 1) return launch_rpt<T, 1, FUSED>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
  if (rows <= 2) return launch_rpt<T, 2, FUSED>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
  if (rows <= 4) return launch_rpt<T, 4, FUSED>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
  if (rows <= 8) return launch_rpt<T, 8, FUSED>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
  return launch_rpt<T, 16, FUSED>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
}

template <bool FUSED>
int dispatch(int dtype, const void* idx, const void* data, const void* x, long long x_jstride,
             const void* y, void* out, void* contrib, int J, int R, int S, int bp, int bn, int k,
             void* stream) {
  const int* ip = static_cast<const int*>(idx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<float, FUSED>(ip, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
    case DT_F64:
      return launch<double, FUSED>(ip, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
// `x_jstride` is x's stride between blocks j, in elements (0 = broadcast).
extern "C" int spmm_launch(const void* idx, const void* data, const void* x, long long x_jstride,
                           void* out, int J, int R, int S, int bp, int bn, int k, int dtype,
                           void* stream) {
  return dispatch<false>(dtype, idx, data, x, x_jstride, nullptr, out, nullptr, J, R, S, bp, bn,
                         k, stream);
}

extern "C" int spmm_fused_launch(const void* idx, const void* data, const void* x,
                                 long long x_jstride, const void* y, void* out, void* contrib,
                                 int J, int R, int S, int bp, int bn, int k, int dtype,
                                 void* stream) {
  return dispatch<true>(dtype, idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k,
                        stream);
}
