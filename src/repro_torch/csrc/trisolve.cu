// Batched blocked triangular solve: x = op(R)^-1 y for R (J, n, n), y (J, n, k).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/trisolve/trisolve.py,
// trisolve_padded (body _trisolve_kernel + _neumann_tri_solve), which the
// reference vmaps over the J blocks and the k right-hand-side columns. Here
// one launch covers all J x k columns.
//
// What bounds it on an H100: not bytes (half of R is ~22 MB at the main
// path's n = 2327, J = 2: a few microseconds at 3.35 TB/s) and not FLOPs
// (J k n^2), but the dependency chain of substitution: row block b needs every
// row block solved before it. The TPU kernel ran its grid in order on one
// core and carried the partial solution in VMEM scratch. One thread block per
// (j, 8 columns) walking the whole triangle (the first port) left 8 blocks on
// 132 SMs at J = 2, k = 32, each streaming its 703 tiles one at a time.
//
// Design (sync-free: no grid-wide barrier, no second launch):
//   * one thread block per (j, row block of TB = 64 rows, k-tile of 8
//     columns), 2 * 37 * 4 = 296 blocks at J = 2, n = 2327, k = 32;
//   * blocks take tickets in solve order from a global atomic counter and
//     read their (row block, j, k-tile) from the ticket, not from blockIdx:
//     a block waits only on row blocks of lower tickets, whose blocks have
//     started already, so the solve cannot deadlock however the card
//     schedules blocks;
//   * a block walks the solved row blocks s in solve order (the one solved
//     first comes first) and accumulates op(R)[r, s] x[s]; before each s it
//     waits on that row block's ready flag with an acquire load, then reads
//     x[s] with ld.global.cg (L1 is not coherent across SMs). The R tiles do
//     not depend on x: they stream into a shared-memory ring with cp.async
//     (4 stages in float32, 3 in float64) ahead of the flags, so only the x
//     rows wait;
//   * the diagonal block (the ring's last tile) is solved by substitution,
//     one warp per column: the pivot row's value is broadcast with
//     __shfl_sync, so the TB sequential steps need no block-wide barrier.
//     The block stores x[r], fences, and sets its flag with a release store;
//   * the off-diagonal work is spread over all blocks; the critical path is
//     ceil(n / TB) steps of one tile product, one diagonal solve and one flag
//     hop;
//   * every output sums its products in one fixed order (tiles in solve
//     order, columns in order within a tile), so repeated launches give the
//     same bits;
//   * ragged n is masked by bounds checks (no identity-extended copy of R);
//     `trans` reads op(R) = R^T through swapped indices, so the wide regime's
//     lower solve on R^T needs no transposed copy;
//   * float32 and float64 run on CUDA cores in their own type (the
//     reference's promote(R.dtype, f32) scratch): TF32 tensor cores would
//     break the 1e-4 parity, and the solve is bound by latency, not FLOPs.
// Scratch: `sync` holds the ticket counter and the (J, nblk, k-tiles) flags,
// zeroed by the caller before every launch. No library call computes any
// product here.
#include "common.cuh"

namespace {

constexpr int TB = 64;            // rows of a row block = edge of a tile (2 per lane)
constexpr int KT = 8;             // columns per thread block, one warp each
constexpr int THREADS = 32 * KT;
constexpr int TILE = TB * (TB + 1);  // one tile in shared memory, columns padded by 1

template <typename T> struct Stages;
template <> struct Stages<float> { static constexpr int value = 4; };   // 66.6 KB
template <> struct Stages<double> { static constexpr int value = 3; };  // 99.8 KB

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One element global -> shared, asynchronously; src_ok false fills a zero.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool src_ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src), "n"(BYTES),
               "r"(src_ok ? BYTES : 0)
               : "memory");
}

// Start copying tile[s * (TB + 1) + r] = op(R)(row0 + r, col0 + s), zero
// outside [0, n). Consecutive threads take consecutive elements of R's
// contiguous axis; the +1 pad keeps the transposed store free of bank
// conflicts.
template <typename T>
__device__ __forceinline__ void load_tile_async(const T* __restrict__ Rj, int n, bool trans,
                                                int row0, int col0, T* tile) {
  for (int e = threadIdx.x; e < TB * TB; e += THREADS) {
    const int fast = e % TB, slow = e / TB;
    const int r = trans ? fast : slow;
    const int s = trans ? slow : fast;
    const int gr = row0 + r, gs = col0 + s;
    const bool ok = gr < n && gs < n;
    const T* src = !ok ? Rj : trans ? Rj + (size_t)gs * n + gr : Rj + (size_t)gr * n + gs;
    cp_async<sizeof(T)>(tile + s * (TB + 1) + r, src, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) trisolve_kernel(
    const T* __restrict__ R, const T* __restrict__ y, T* x, int* sync, int J, int n, int k,
    bool lower, bool trans) {
  constexpr int ST = Stages<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [ST][TILE]
  __shared__ int ticket_s;

  const int nblk = (n + TB - 1) / TB, nkt = (k + KT - 1) / KT;
  if (threadIdx.x == 0) ticket_s = atomicAdd(sync, 1);
  __syncthreads();
  const int ticket = ticket_s;
  const int step = ticket / (J * nkt);  // solve order: all of step 0 first
  const int rest = ticket - step * J * nkt;
  const int j = rest / nkt, kt = rest - j * nkt;
  const int rb = lower ? step : nblk - 1 - step;  // this block's row block
  const int row0 = rb * TB, nb = min(TB, n - row0);
  int* flags = sync + 1 + (size_t)j * nblk * nkt + kt;  // row block b: flags[b * nkt]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = kt * KT + warp;  // this warp's column
  const bool col_ok = c < k;
  const T* Rj = R + (size_t)j * n * n;
  const T* yj = y + (size_t)j * n * k;
  T* xj = x + (size_t)j * n * k;

  // tiles i = 0..step of row block rb: column block cb(i), solve order; the
  // last one (i = step) is the diagonal block
  const int ntiles = step + 1;
  const auto cb = [&](int i) { return lower ? i : nblk - 1 - i; };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < ntiles) load_tile_async(Rj, n, trans, row0, cb(i) * TB, ring + i * TILE);
    cp_async_commit();
  }

  const int r0 = lane, r1 = lane + 32;
  T acc0 = T(0), acc1 = T(0);
  for (int i = 0;; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile i is in for every thread; slot (i - 1) % ST is free
    if (i + ST - 1 < ntiles) {
      load_tile_async(Rj, n, trans, row0, cb(i + ST - 1) * TB,
                      ring + ((i + ST - 1) % ST) * TILE);
    }
    cp_async_commit();
    if (i == step) break;  // the diagonal tile: solved below

    const T* tile = ring + (i % ST) * TILE;
    const int s0 = cb(i) * TB;
    while (ld_acquire(flags + (size_t)cb(i) * nkt) == 0) __nanosleep(32);
    T xa = T(0), xb = T(0);  // x[s0 + lane], x[s0 + lane + 32] of column c
    if (col_ok) {
      if (s0 + r0 < n) xa = __ldcg(xj + (size_t)(s0 + r0) * k + c);
      if (s0 + r1 < n) xb = __ldcg(xj + (size_t)(s0 + r1) * k + c);
    }
#pragma unroll
    for (int s = 0; s < TB; ++s) {
      const T xv = __shfl_sync(0xffffffffu, s < 32 ? xa : xb, s & 31);
      acc0 = fma(tile[s * (TB + 1) + r0], xv, acc0);
      acc1 = fma(tile[s * (TB + 1) + r1], xv, acc1);
    }
  }

  // the diagonal block, one warp per column
  const T* tile = ring + (step % ST) * TILE;
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
  __threadfence();
  __syncthreads();  // every column of the row block is stored
  if (threadIdx.x == 0) st_release(flags + (size_t)rb * nkt, 1);
}

template <typename T>
int launch(const void* R, const void* y, void* x, int* sync, int J, int n, int k, bool lower,
           bool trans, cudaStream_t stream) {
  const size_t smem = (size_t)Stages<T>::value * TILE * sizeof(T);
  auto kernel = trisolve_kernel<T>;
  static unsigned devices_done = 0;
  const cudaError_t e = smem_limit_once(kernel, (int)smem, devices_done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (long long)J * ((n + TB - 1) / TB) * ((k + KT - 1) / KT);
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(R), static_cast<const T*>(y), static_cast<T*>(x), sync, J, n, k,
      lower, trans);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `sync` holds
// 1 + J * ceil(n / 64) * ceil(k / 8) int32, all zero.
extern "C" int trisolve_launch(const void* R, const void* y, void* x, void* sync, int J, int n,
                               int k, int lower, int trans, int dtype, void* stream) {
  if (J < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sp = static_cast<int*>(sync);
  switch (dtype) {
    case DT_F32: return launch<float>(R, y, x, sp, J, n, k, lower != 0, trans != 0, s);
    case DT_F64: return launch<double>(R, y, x, sp, J, n, k, lower != 0, trans != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
