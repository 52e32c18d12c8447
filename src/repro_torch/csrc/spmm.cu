// SpMM for the matrix-free path: the packed-nonzero product, the epoch's
// fused pass on two packed forms, and the staged blocked-ELL fused pass.
//
//   spmm_packed:       out[row] = sum_{e in row} val[e] * x[j(row)][col[e]]
//   spmm_fused_packed: two spmm_packed products in one launch: A_j x over the
//                      forward shards' packed form and A_j^T y_j over the
//                      transposed shards' packed form
//   spmm_fused:        out[j, r] = sum_s data[j, r, s] @ x[j, idx[j, r, s]], plus
//                      contrib[j, r, s] = data[j, r, s]^T @ y[j, r]
//
// Replaces: the Pallas TPU kernels of src/repro/kernels/spmm/spmm.py,
// `spmm_padded` (body `_spmm_kernel`) and `spmm_fused_padded` (body
// `_spmm_fused_kernel`). Their grid (J, R, S) walked the slot axis in order
// on one core, revisiting the output stripe in VMEM, with the tile ids as a
// scalar-prefetch operand. spmm_fused keeps the second one's staged
// interface; the matrix-free path runs spmm_fused_packed in its place.
//
// x is the (J, C, bn, k) tile view of the column space, read as (J, C*bn, k)
// rows of k contiguous values; its j-stride may be 0 (one operand broadcast to
// every block). Outputs are written in the data type; float32 and float64 each
// accumulate in their own type (float64 is therefore more exact than the
// reference, which casts tiles to float32 inside its kernel).
//
// ---- spmm_packed -----------------------------------------------------------
// The forward product over a CSR of the same nonzeros (kernels/spmm/pack.py):
// row_ptr (rows + 1), col (nnz) = the x row idx * bn + b of each nonzero, val
// (nnz), rows ordered (j, r, p) and each row's entries in (slot, tile column)
// order. The (8, 8) tiles of the Schenk-like shards hold one to three
// nonzeros each (1.7% fill at n = 16384), so the ELL tiles carry 25-57x the
// bytes the product needs; the packed form carries 8 B per nonzero.
//
// What bounds it on an H100: the gathers. Each nonzero costs one read of an
// x row (k values, 128 B at k = 32 in float32), from L2: x (2.1 MB at
// n = 16384, k = 32) and the packed arrays fit the 50 MB L2 together. Device
// memory sees the packed arrays, x and the output once. Tensor cores do not
// fit: one to three nonzeros per 8x8 tile leave no dense sub-block for
// wgmma or mma.sync, so the FMAs run on CUDA cores.
//
// Design (`packed_rows`, which both packed kernels run):
//   * a group of L lanes owns one output row, 32 / L rows per warp; each lane
//     covers V consecutive columns with one 16-byte (or 8-, 4-byte) vector
//     load per gathered row, so a group reads L * V columns of an x row in
//     one coalesced access; wider k takes more column tiles (grid.y). L is
//     the smallest power of two covering k / V: at k = 32 in float32 eight
//     lanes of float4 take a row and a warp takes four rows; at k = 1 every
//     lane owns a row of its own, so no lane idles on short k;
//   * the group reads its row's (col, val) pairs P at a time with coalesced
//     loads (P = max(L, 8)), the next batch loaded before this one is used,
//     and broadcasts each pair with __shfl_sync inside the group;
//   * the gathers run eight at a time: eight x rows are loaded before their
//     FMAs, so eight L2 reads are in flight per lane instead of one;
//   * one writer per output row, fixed order, no atomics: every output is
//     summed over its row's entries in packed order, one fma per entry from
//     zero, whatever V and L are. For finite inputs this gives exactly the
//     bits of the ELL kernel below, which adds the same products in the same
//     order plus exact zeros (0 * x added to a sum changes nothing). A NaN or
//     Inf in x that only a zero coefficient touches no longer propagates (the
//     ELL sum forms 0 * Inf). A row with no entries writes zeros.
//
// ---- spmm_fused_packed -----------------------------------------------------
// The matrix-free epoch's fused pass (PartitionedBSR.fused_project): A_j x
// and A_j^T y_j from one launch, with no staged contributions and no scatter.
// On that path it replaces `spmm_fused_padded` together with its caller's
// scatter-add of the staged contributions (`_scatter_contrib` in
// `fused_project`, src/repro/sparse/bsr.py:324 and :711), which the staged
// spmm_fused below and the port's own `_scatter_contrib` still mirror. The
// TPU kernel read each tile once for both products because a tile in VMEM
// fed both contractions; here a tile holds one to three nonzeros of its 64
// entries, so the transpose is a second packed product over the CSC of the
// same nonzeros (the transposed shards' packed form) with one writer per
// output row. Nothing per slot is written (375 MB per epoch at n = 16384 in
// the staged form), nothing is read back, and no atomic reorders a sum, so
// every launch gives the same bits.
//
// One grid covers two row ranges, each with its own row pointers, columns,
// values, operand, operand j-stride and output: first the J * n_pad rows of
// the transpose, read against y (one slab per block), then the J * p_pad rows
// of the forward product, read against x (broadcast, stride 0). The transpose
// has 8x the rows (131,072 against 16,384 at n = 16384, J = 8) and writes
// most of the bytes, so the small forward range fills the tail. One vector
// width serves both ranges: the widest that both operands, both j-strides
// and both outputs allow. Each row runs `packed_rows`, so each half equals
// spmm_packed on the same packed form bit for bit.
//
// What bounds it on an H100: bytes, mostly the (J, n_pad, k) transpose output
// (16.8 MB of the ~30 MB at n = 16384, k = 32) and the gathers through L2.
// The transposed rows average ~3 nonzeros (402,369 over 131,072), so a row's
// pointer reads and its 128-byte store dominate, not its FMAs. Tensor cores
// do not fit, as for spmm_packed: one to three nonzeros per 8x8 tile.
//
// ---- spmm_fused ------------------------------------------------------------
// The staged interface of `spmm_fused_padded`, held against its plain
// version; the matrix-free path runs spmm_fused_packed in its place.
//
// What bounds it on an H100: bytes. A tile of (8, 8) float32 is 256 B and
// feeds 2 * 8 * 8 * k FLOPs per product, so at k = 32 the tiles alone need
// 16 FLOP/B against the card's 20 FLOP/B f32 balance point (67 TFLOP/s over
// 3.35 TB/s), and the gathered x rows (bn * k values per slot, read through
// L2) and the staged contrib (as large as the gathered x) push it further to
// the memory side.
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
//   * y[j, r] is loaded once before the slot loop and, from the data chunk
//     already in shared memory, each slot's contribution is written once to
//     its own staging slot (no atomics; the caller scatter-adds);
//   * tiles take any (bp, bn) with each side at most 128.
// No library call computes any product here (no cuBLAS, no cuSPARSE).
#include <cstdint>

#include "common.cuh"

namespace {

// ---- spmm_packed and spmm_fused_packed ---------------------------------------

constexpr int PK_THREADS = 256;  // 8 warps
constexpr int UNR = 8;           // gathers in flight per lane

template <typename T, int V> struct VecOf;
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<double, 1> { using type = double; };
template <> struct VecOf<double, 2> { using type = double2; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[V]) {
  const typename VecOf<T, V>::type q = __ldg(reinterpret_cast<const typename VecOf<T, V>::type*>(p));
  if constexpr (V == 1) {
    v[0] = q;
  } else if constexpr (V == 2) {
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  typename VecOf<T, V>::type q;
  if constexpr (V == 1) {
    q = v[0];
  } else if constexpr (V == 2) {
    q.x = v[0]; q.y = v[1];
  } else {
    q.x = v[0]; q.y = v[1]; q.z = v[2]; q.w = v[3];
  }
  *reinterpret_cast<typename VecOf<T, V>::type*>(p) = q;
}

// One packed product: `rows` output rows of k values; row i belongs to block
// i / block_rows and gathers its operand rows from that block's slab of x.
template <typename T>
struct PackedRange {
  const int* row_ptr;   // rows + 1
  const int* col;       // nnz: the operand row of each entry
  const T* val;         // nnz
  const T* x;           // operand rows of k contiguous values
  long long x_jstride;  // elements between the blocks' slabs of x (0 = broadcast)
  T* out;               // rows * k
  int rows;
  int block_rows;
};

// The rows of thread block `bx` of one range, in the scheme described above.
template <typename T, int V, int L>
__device__ __forceinline__ void packed_rows(const PackedRange<T> d, int bx, int k) {
  constexpr int G = 32 / L;              // rows per warp
  constexpr int P = L < UNR ? UNR : L;   // (col, val) pairs per batch
  constexpr int Q = P / L;               // pairs each lane holds
  const int lane = threadIdx.x & 31;
  const int g = lane / L, gl = lane % L;
  const int row = (bx * (PK_THREADS / 32) + threadIdx.x / 32) * G + g;
  if (row >= d.rows) return;  // a whole group leaves: shuffles below stay in-group
  const unsigned mask = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (g * L);
  const int c0 = blockIdx.y * (L * V) + gl * V;  // this lane's first column
  const bool col_ok = c0 < k;                    // k % V == 0: all V columns live
  const T* xj = d.x + (long long)(row / d.block_rows) * d.x_jstride + c0;
  const int beg = __ldg(d.row_ptr + row), end = __ldg(d.row_ptr + row + 1);

  int ci[Q];
  T vi[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int e = beg + q * L + gl;
    ci[q] = e < end ? __ldg(d.col + e) : 0;
    vi[q] = e < end ? __ldg(d.val + e) : T(0);
  }

  T acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = T(0);

  for (int e0 = beg; e0 < end; e0 += P) {
    int cn[Q];  // the next batch, in flight while this one is used
    T vn[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int e = e0 + P + q * L + gl;
      cn[q] = e < end ? __ldg(d.col + e) : 0;
      vn[q] = e < end ? __ldg(d.val + e) : T(0);
    }
    const int n_e = min(P, end - e0);
#pragma unroll
    for (int t0 = 0; t0 < P; t0 += UNR) {
      if (t0 >= n_e) break;  // uniform within the group
      T xv[UNR][V];
      T wv[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int t = t0 + u;  // pair t sits in lane t % L, slot t / L
        const int cc = __shfl_sync(mask, ci[t / L], t % L, L);
        wv[u] = __shfl_sync(mask, vi[t / L], t % L, L);
        if (col_ok && t < n_e) {
          load_vec<T, V>(xj + (size_t)cc * k, xv[u]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) xv[u][v] = T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (t0 + u < n_e) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fma(wv[u], xv[u][v], acc[v]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      ci[q] = cn[q];
      vi[q] = vn[q];
    }
  }
  if (col_ok) store_vec<T, V>(d.out + (size_t)row * k + c0, acc);
}

template <typename T, int V, int L>
__global__ void __launch_bounds__(PK_THREADS) spmm_packed_kernel(const PackedRange<T> d, int k) {
  packed_rows<T, V, L>(d, blockIdx.x, k);
}

// Blocks [0, tra_blocks) take the transpose's rows, the rest the forward's.
template <typename T, int V, int L>
__global__ void __launch_bounds__(PK_THREADS) spmm_fused_packed_kernel(
    const PackedRange<T> tra, const PackedRange<T> fwd, int tra_blocks, int k) {
  const int bx = blockIdx.x;
  if (bx < tra_blocks) {
    packed_rows<T, V, L>(tra, bx, k);
  } else {
    packed_rows<T, V, L>(fwd, bx - tra_blocks, k);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int L> constexpr int rows_per_block() { return (PK_THREADS / 32) * (32 / L); }

template <typename T>
struct LaunchPacked {
  PackedRange<T> d;
  int k;
  cudaStream_t stream;
  template <int V, int L> int go() const {
    const dim3 grid(ceil_div(d.rows, rows_per_block<L>()), ceil_div(k, L * V));
    spmm_packed_kernel<T, V, L><<<grid, PK_THREADS, 0, stream>>>(d, k);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
struct LaunchFusedPacked {
  PackedRange<T> tra, fwd;
  int k;
  cudaStream_t stream;
  template <int V, int L> int go() const {
    const int tra_blocks = ceil_div(tra.rows, rows_per_block<L>());
    const int blocks = tra_blocks + ceil_div(fwd.rows, rows_per_block<L>());
    if (blocks == 0) return static_cast<int>(cudaSuccess);
    const dim3 grid(blocks, ceil_div(k, L * V));
    spmm_fused_packed_kernel<T, V, L><<<grid, PK_THREADS, 0, stream>>>(tra, fwd, tra_blocks, k);
    return static_cast<int>(cudaGetLastError());
  }
};

// Launches with the fewest lanes per row (a power of two) whose V-wide loads
// cover k.
template <int V, typename Launch>
int by_lanes(const Launch& launch, int k) {
  const int lanes = (k + V - 1) / V;
  if (lanes <= 1) return launch.template go<V, 1>();
  if (lanes <= 2) return launch.template go<V, 2>();
  if (lanes <= 4) return launch.template go<V, 4>();
  if (lanes <= 8) return launch.template go<V, 8>();
  if (lanes <= 16) return launch.template go<V, 16>();
  return launch.template go<V, 32>();
}

// Whether V-wide vectors keep every gathered row and output row of `d`
// aligned.
template <typename T>
bool aligned(const PackedRange<T>& d, int k, int v) {
  const uintptr_t bytes = sizeof(T) * v;
  return k % v == 0 && d.x_jstride % v == 0 && reinterpret_cast<uintptr_t>(d.x) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(d.out) % bytes == 0;
}

// Launches with the widest vector (at most 16 bytes) that `ok` allows.
template <typename T, typename Launch, typename Aligned>
int by_width(const Launch& launch, int k, const Aligned& ok) {
  if constexpr (sizeof(T) == 4) {
    if (ok(4)) return by_lanes<4>(launch, k);
  }
  if (ok(2)) return by_lanes<2>(launch, k);
  return by_lanes<1>(launch, k);
}

template <typename T>
PackedRange<T> packed_range(const void* row_ptr, const void* col, const void* val, const void* x,
                            long long x_jstride, void* out, int rows, int block_rows) {
  return {static_cast<const int*>(row_ptr), static_cast<const int*>(col),
          static_cast<const T*>(val),       static_cast<const T*>(x),
          x_jstride,                        static_cast<T*>(out),
          rows,                             block_rows};
}

template <typename T>
int launch_packed(const PackedRange<T>& d, int k, cudaStream_t s) {
  return by_width<T>(LaunchPacked<T>{d, k, s}, k, [&](int v) { return aligned(d, k, v); });
}

template <typename T>
int launch_fused_packed(const PackedRange<T>& tra, const PackedRange<T>& fwd, int k,
                        cudaStream_t s) {
  return by_width<T>(LaunchFusedPacked<T>{tra, fwd, k, s}, k,
                     [&](int v) { return aligned(tra, k, v) && aligned(fwd, k, v); });
}

// ---- spmm_fused (blocked ELL) ------------------------------------------------

constexpr int KT = 32;             // k-tile: one column per lane
constexpr int NY = 8;              // warps per block, splitting the bp rows
constexpr int CH = 32;             // flattened (slot, tile column) chunk
constexpr int THREADS = KT * NY;
constexpr int MAX_TILE = 128;      // largest bp or bn taken

// Dynamic shared memory, in units of T:
//   ws[CH][bp + 1]  data chunk, transposed: ws[e][p] = data[s(e)][p][b(e)]
//   xs[CH][KT]      gathered x rows:       xs[e][c] = x[idx[s(e)]][b(e)][c]
//   ys[bp][KT]      the y[j, r] stripe
template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS) spmm_fused_kernel(
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

  const T* y_jr = y + jr * bp * k;
  for (int t = tid; t < bp * KT; t += THREADS) {
    const int p = t / KT, cc = t % KT;
    ys[t] = cc < kw ? y_jr[(size_t)p * k + kt0 + cc] : T(0);
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

    // contrib[s][b][c] = sum_p data[s][p][b] * y[p][c]: chunk element e is
    // (s, b), and its contribution row starts at (jr * S * bn + e0 + e) * k
    for (int e = ty; e < n_e; e += NY) {
      T sum = T(0);
      for (int p = 0; p < bp; ++p) sum += ws[e * wstride + p] * ys[p * KT + tx];
      if (tx < kw) contrib[(jr * S * bn + e0 + e) * k + kt0 + tx] = sum;
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

template <typename T, int RPT>
int launch_fused_rpt(const int* idx, const void* data, const void* x, long long x_jstride,
                     const void* y, void* out, void* contrib, int J, int R, int S, int bp,
                     int bn, int k, cudaStream_t stream) {
  const size_t smem = (size_t)(CH * (bp + 1) + CH * KT + bp * KT) * sizeof(T);
  auto kernel = spmm_fused_kernel<T, RPT>;
  if (smem > 48 * 1024) {  // once, to the most any tile up to MAX_TILE needs
    static unsigned devices_done = 0;
    const size_t most = (size_t)(CH * (MAX_TILE + 1) + CH * KT + MAX_TILE * KT) * sizeof(T);
    const cudaError_t e = smem_limit_once(kernel, (int)most, devices_done);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(R, (k + KT - 1) / KT, J), block(KT, NY);
  kernel<<<grid, block, smem, stream>>>(
      idx, static_cast<const T*>(data), static_cast<const T*>(x), x_jstride,
      static_cast<const T*>(y), static_cast<T*>(out), static_cast<T*>(contrib), R, S, bp, bn, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused(const int* idx, const void* data, const void* x, long long x_jstride,
                 const void* y, void* out, void* contrib, int J, int R, int S, int bp, int bn,
                 int k, cudaStream_t s) {
  if (bp < 1 || bn < 1 || bp > MAX_TILE || bn > MAX_TILE || S < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (bp + NY - 1) / NY;  // rows per thread, rounded up to 2^i
  if (rows <= 1) return launch_fused_rpt<T, 1>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
  if (rows <= 2) return launch_fused_rpt<T, 2>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
  if (rows <= 4) return launch_fused_rpt<T, 4>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
  if (rows <= 8) return launch_fused_rpt<T, 8>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
  return launch_fused_rpt<T, 16>(idx, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
}

}  // namespace

// All launch on `stream` and return cudaGetLastError() (0 = launched).
// `x_jstride` is x's stride between blocks j, in elements (0 = broadcast).

// `rows` output rows of k values; row i belongs to block i / block_rows.
extern "C" int spmm_packed_launch(const void* row_ptr, const void* col, const void* val,
                                  const void* x, long long x_jstride, void* out, int rows,
                                  int block_rows, int k, int dtype, void* stream) {
  if (rows < 0 || block_rows < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_packed<float>(
          packed_range<float>(row_ptr, col, val, x, x_jstride, out, rows, block_rows), k, s);
    case DT_F64:
      return launch_packed<double>(
          packed_range<double>(row_ptr, col, val, x, x_jstride, out, rows, block_rows), k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward range (A_j x: fwd_* against x) and the transposed range
// (A_j^T y_j: tra_* against y), each as spmm_packed_launch takes one.
extern "C" int spmm_fused_packed_launch(
    const void* fwd_row_ptr, const void* fwd_col, const void* fwd_val, const void* x,
    long long x_jstride, void* fwd_out, int fwd_rows, int fwd_block_rows,
    const void* tra_row_ptr, const void* tra_col, const void* tra_val, const void* y,
    long long y_jstride, void* tra_out, int tra_rows, int tra_block_rows, int k, int dtype,
    void* stream) {
  if (fwd_rows < 0 || tra_rows < 0 || fwd_block_rows < 1 || tra_block_rows < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_fused_packed<float>(
          packed_range<float>(tra_row_ptr, tra_col, tra_val, y, y_jstride, tra_out, tra_rows,
                              tra_block_rows),
          packed_range<float>(fwd_row_ptr, fwd_col, fwd_val, x, x_jstride, fwd_out, fwd_rows,
                              fwd_block_rows),
          k, s);
    case DT_F64:
      return launch_fused_packed<double>(
          packed_range<double>(tra_row_ptr, tra_col, tra_val, y, y_jstride, tra_out, tra_rows,
                               tra_block_rows),
          packed_range<double>(fwd_row_ptr, fwd_col, fwd_val, x, x_jstride, fwd_out, fwd_rows,
                               fwd_block_rows),
          k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int spmm_fused_launch(const void* idx, const void* data, const void* x,
                                 long long x_jstride, const void* y, void* out, void* contrib,
                                 int J, int R, int S, int bp, int bn, int k, int dtype,
                                 void* stream) {
  const int* ip = static_cast<const int*>(idx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_fused<float>(ip, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
    case DT_F64:
      return launch_fused<double>(ip, data, x, x_jstride, y, out, contrib, J, R, S, bp, bn, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
