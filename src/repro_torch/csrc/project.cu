// Fused consensus update on the tensor cores: out = x + gamma_j (v - W^T (W v)),
// v = xbar - x, for W (J, p, n), x and xbar (J, n, k), gamma a scalar or a (J,)
// vector. x may be null, meaning 0: then the call is the projection
// (I - W^T W) xbar.
//
// Replaces: the Pallas TPU kernels of src/repro/kernels/project/project.py,
// consensus_update_padded: pass 1 `_matvec_kernel` (project.py:71, u = W v,
// reduced over n-tiles) and pass 2 `_update_kernel` (project.py:84,
// out = x + gamma (v - W^T u)), which the reference vmaps over the J blocks
// and k columns. Here one launch of each pass covers all J x k columns.
//
// What bounds it on an H100: W's bytes. At the main path's W (2, 4654, 2327)
// and (8, 1164, 2327) f32, k = 32, W is 86.6 MB: 0.026 ms at 3.35 TB/s read
// once, 0.052 ms when both passes read it from HBM. The 2.77 GFLOP of f32
// products take 0.041 ms on CUDA cores (67 TFLOP/s) but 0.017 ms as three
// TF32 tensor-core products (495 TFLOP/s each): 16 f32 FLOP per W byte is
// far below TF32's ridge, so on the tensor cores the kernel is memory-bound.
//
// Design:
//   * f32 products on the tensor cores at f32 accuracy (3xTF32): each operand
//     is split as a = hi + lo with hi = tf32(a) rounded to nearest and lo the
//     rest, and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi with
//     mma.sync m16n8k8, accumulated in f32. One TF32 product alone misses the
//     1e-4 parity at these shapes (tests/test_torch_kernel_project_tf32.py
//     models both). The split is three integer/f32 operations (half a TF32
//     unit added to a's bits, which the tensor core then truncates), not two
//     cvt.rna.tf32.f32. The tensor core truncates when it accumulates, so a
//     long chain of MMAs into one accumulator drifts far beyond f32
//     rounding: each stage's products go to a zeroed fragment that is added
//     to the running sum in f32. Dispatch by W's dtype: a bf16 W is exact in
//     TF32 (its lo part is 0) and takes two products; f32 and f64 W take
//     three (an f64 W or x is rounded to f32 on its way in, as the reference
//     casts to f32 inside its kernel bodies). The output is stored in xbar's
//     dtype;
//   * W streams through a 4-stage cp.async ring of 64 x 32 (pass 1) or
//     32 x 64 (pass 2) f32 tiles, with the matching v (pass 1) or u (pass 2)
//     tile beside it, so the next tiles' copies overlap the current MMAs.
//     W's rows are 16-byte aligned only when n % 4 == 0; otherwise (the main
//     path's n = 2327) a thread copies 4-byte elements, a warp covering 128
//     contiguous bytes of one row: with enough blocks in flight this streams
//     as fast as 16-byte copies of a padded copy of W (chip_smoke.py times
//     both), so W is used as it is. Each thread's source pointer is computed
//     once per block. A bf16 or f64 W, and a v formed from x (x̄ − x rounded
//     in the storage type, as the reference's first pass forms it), are read
//     by plain loads and widened to f32 on their way into shared memory;
//   * pitches keep every fragment load free of bank conflicts: the pass-1 W
//     tile [64][32 + 8] is read along its rows, two A elements per 64-bit
//     load (each k8 step stores MMA index k = t and t + 4 side by side), the
//     pass-2 W tile [32][64 + 4] down its columns (the A operand is W^T,
//     M-major in memory, and 32-bit types have no ldmatrix.trans), the v and
//     u tiles [32][KT + 4];
//   * one block computes a 64-row output tile for all KT <= 64 columns of k
//     (k > 64 takes ceil(k / 64) column groups), so each pass reads W once
//     for any k <= 64. Its 8 warps split the tile 2 x 2 and the stage's depth
//     in two (KT = 32), or 4 x 2 (KT = 64), so that a warp splits 12 operands
//     per k8 step for 12 MMAs; the depth halves are summed in shared memory
//     at the end;
//   * split-K: each pass's reduction (n in pass 1, p in pass 2) is cut into
//     `splits` contiguous ranges, a function of the shapes chosen by the
//     wrapper, so that each pass has several waves of blocks on the 132
//     SMs. A block writes its f32 partial tile to scratch; the last block of
//     a tile to arrive (a per-tile ticket, reset to 0 by that block, so a
//     replayed CUDA graph finds it zeroed) sums the partials in split order
//     and writes u (pass 1) or applies out = x + gamma (v - sum) (pass 2).
//     Pass 1 finishes u itself rather than leave its partials to pass 2,
//     where every n-tile would read all of them again. No float atomics:
//     repeated launches give the same bits;
//   * u is kept padded, (J, ceil(p / 64) * 64, kgroups * KT) and zero outside
//     p x k, so pass 2 loads it with 16-byte copies and no masks.
// The wrapper allocates u, the partials and the tickets; at most two launches.
// No library call computes any product here (no cuBLAS, no torch.matmul).
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int BT = 64;        // output rows of a block: p (pass 1) or n (pass 2)
constexpr int BK = 32;        // reduction depth of one stage: n (pass 1) or p (pass 2)
constexpr int STAGES = 4;
// Within each k8 step, MMA index k = t and t + 4 of thread t (t = lane % 4)
// are stored at columns 2t and 2t + 1, so a pass-1 A fragment pair is one
// 64-bit load. The pitches keep every fragment load free of bank conflicts:
constexpr int PA1 = BK + 8;   // pass-1 W tile [BT][PA1], read along rows (8g + 2t)
constexpr int PA2 = BT + 4;   // pass-2 W tile [BK][PA2], read down columns (8t + g)
constexpr int A_STAGE = BT * PA1 > BK * PA2 ? BT * PA1 : BK * PA2;  // one W tile in floats

template <int KT> struct Tile {
  static constexpr int PB = KT + 4;     // v / u tile [BK][PB], read down columns (8t + g)
  static constexpr int PR = KT + 8;     // the depth warps' sums [BT][PR], float2 stores
  static constexpr int B_STAGE = BK * PB;
  // warps along rows, columns and depth: each warp has MT x NT fragments
  // and splits MT * 4 + NT * 2 operands per k8 step for 3 * MT * NT MMAs
  static constexpr int WM = KT == 32 ? 2 : 4, WN = 2, WK = 8 / (WM * WN);
  static constexpr int MT = BT / WM / 16;       // m16 fragments per warp: 2 or 1
  static constexpr int NT = KT / WN / 8;        // n8 fragments per warp: 2 or 4
  static constexpr int STEPS = BK / 8 / WK;     // k8 steps per warp per stage: 2 or 4
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE);
  static constexpr int SMEM = 4 * (RING > WK * BT * PR ? RING : WK * BT * PR);  // 59,392 / 75,776 B
};

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

// One stage of the warp's (MT * 16) x (NT * 8) tile over its STEPS k8 steps
// of the stage (k8 step s * WK + wk). The tensor core rounds toward zero
// when it accumulates, so the stage's products go to a zeroed fragment that
// is then added to `acc` in f32, which rounds to nearest. TRANS_A reads A = W^T from a
// [BK][PA2] W tile; otherwise A = W from a [BT][PA1] tile. THREE is false
// for a bf16 W, whose lo part is zero.
template <int KT, bool TRANS_A, bool THREE>
__device__ __forceinline__ void stage_mma(float (&acc)[Tile<KT>::MT][Tile<KT>::NT][4],
                                          const float* a, const float* b, int m0, int n0,
                                          int wk, int g, int t) {
  using TL = Tile<KT>;
  float part[TL::MT][TL::NT][4] = {};
#pragma unroll
  for (int s = 0; s < TL::STEPS; ++s) {
    const int k0 = (s * TL::WK + wk) * 8 + 2 * t;  // columns of k = t and t + 4
    uint32_t ah[TL::MT][4], al[TL::MT][4];
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt) {
      const int m = m0 + mt * 16 + g;
      float af[4];  // (m, t), (m + 8, t), (m, t + 4), (m + 8, t + 4)
      if (TRANS_A) {
        af[0] = a[k0 * PA2 + m];
        af[1] = a[k0 * PA2 + m + 8];
        af[2] = a[(k0 + 1) * PA2 + m];
        af[3] = a[(k0 + 1) * PA2 + m + 8];
      } else {
        const float2 lo = *reinterpret_cast<const float2*>(a + m * PA1 + k0);
        const float2 hi = *reinterpret_cast<const float2*>(a + (m + 8) * PA1 + k0);
        af[0] = lo.x;
        af[1] = hi.x;
        af[2] = lo.y;
        af[3] = hi.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split(af[i], ah[mt][i], al[mt][i]);
    }
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt) {
      uint32_t bh[2], bl[2];
      split(b[k0 * TL::PB + n0 + nt * 8 + g], bh[0], bl[0]);
      split(b[(k0 + 1) * TL::PB + n0 + nt * 8 + g], bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt) {
        if (THREE) mma(part[mt][nt], al[mt], bh);
        mma(part[mt][nt], ah[mt], bl);
        mma(part[mt][nt], ah[mt], bh);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
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

// Copies ROWS x COLS tiles of a row-major matrix (element T, row stride ld)
// into f32 shared-memory tiles of pitch P, zero outside the matrix. A
// thread owns one column (four with `vec`: 16-byte copies, ld and the
// origin multiples of 4 floats) and every RSTEP-th row; its source pointer
// is computed once and moved by tile offsets. f32 goes by cp.async; bf16
// and f64 by plain loads, widened on their way in.
template <int ROWS, int COLS, int P, typename T>
struct TileLoader {
  const T* base;  // a valid address of the matrix, read by no zero-filled copy
  const T* src;   // this thread's first element of the tile at offset 0
  size_t ld;
  int r_t, c_t;
  bool vec;

  __device__ TileLoader(const T* matrix, const T* origin, size_t ld_, bool vec_)
      : base(matrix), ld(ld_), vec(std::is_same<T, float>::value && vec_) {
    const int per_row = vec ? COLS / 4 : COLS;
    r_t = threadIdx.x / per_row;
    c_t = (threadIdx.x % per_row) * (vec ? 4 : 1);
    src = origin + r_t * ld + c_t;
  }

  // The tile at element offset `off` from the origin, of which `rows` rows
  // and `cols` columns lie inside the matrix.
  __device__ __forceinline__ void load(float* dst, size_t off, int rows, int cols) const {
    const T* s = src + off;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        constexpr int RSTEP = THREADS / (COLS / 4);
        const int bytes = 4 * max(0, min(4, cols - c_t));
#pragma unroll
        for (int it = 0; it < ROWS / RSTEP; ++it) {
          const int r = r_t + it * RSTEP, nb = r < rows ? bytes : 0;
          cp_async16(dst + r * P + c_t, nb ? s + it * RSTEP * ld : base, nb);
        }
        return;
      }
    }
    constexpr int RSTEP = THREADS / COLS;
    const bool col_ok = c_t < cols;
#pragma unroll
    for (int it = 0; it < ROWS / RSTEP; ++it) {
      const int r = r_t + it * RSTEP;
      const bool ok = col_ok && r < rows;
      if constexpr (std::is_same<T, float>::value) {
        cp_async4(dst + r * P + c_t, ok ? s + it * RSTEP * ld : base, ok);
      } else {
        dst[r * P + c_t] = ok ? to_f32(s[it * RSTEP * ld]) : 0.f;
      }
    }
  }
};

// The pass-1 v tile when v must be formed: v = x̄ − x in the storage type
// (x non-null), or x̄ widened (a non-f32 x̄), by plain loads.
template <int KT, typename TX>
__device__ __forceinline__ void load_v_tile(float* dst, const TX* __restrict__ x,
                                            const TX* __restrict__ xbar, int k, int n0, int n,
                                            int c0) {
#pragma unroll
  for (int it = 0; it < BK * KT / THREADS; ++it) {
    const int e = it * THREADS + threadIdx.x;
    const int r = e / KT, c = e % KT;
    const int gr = n0 + r, gc = c0 + c;
    float v = 0.f;
    if (gr < n && gc < k) {
      const size_t off = (size_t)gr * k + gc;
      v = x ? diff_f32(xbar[off], x[off]) : to_f32(xbar[off]);
    }
    dst[r * Tile<KT>::PB + c] = v;
  }
}

// ---- the block's sum, split-K bookkeeping ------------------------------------

// Sums the WK depth warps' accumulators through shared memory (the ring,
// free once every copy has landed) into the block's [BT][KT] tile, and
// hands float4 `e` of it (row e * 4 / KT, columns e * 4 % KT ..) to `emit`,
// depth warp 0's part first.
template <int KT, typename Emit>
__device__ __forceinline__ void block_sum(float* smem,
                                          const float (&acc)[Tile<KT>::MT][Tile<KT>::NT][4],
                                          int m0, int n0, int wk, int g, int t, Emit emit) {
  using TL = Tile<KT>;
  cp_async_wait<0>();
  __syncthreads();
  float* red = smem + wk * BT * TL::PR;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt) {
      const int r = m0 + mt * 16 + g, c = n0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(red + r * TL::PR + c) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(red + (r + 8) * TL::PR + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < BT * KT / 4 / THREADS; ++it) {
    const int e = it * THREADS + threadIdx.x, r = e * 4 / KT, c = e * 4 % KT;
    float4 v = *reinterpret_cast<const float4*>(smem + r * TL::PR + c);
#pragma unroll
    for (int q = 1; q < TL::WK; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(smem + q * BT * TL::PR + r * TL::PR + c);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    emit(e, v);
  }
}

// After every thread stored its part of the block's partial tile: true in
// the last of `splits` blocks of the tile to arrive, which resets the ticket
// to 0 for the next launch.
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

// The sum over s = 0 .. splits-1, in that order, of float4 `e` of the
// tile's `splits` consecutive [BT][KT] partials (read through L2, eight
// reads in flight).
template <int KT>
__device__ __forceinline__ float4 sum_partials(const float* parts, int splits, int e) {
  constexpr int BATCH = 8;
  const float4* src = reinterpret_cast<const float4*>(parts) + e;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0; q0 < splits; q0 += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      v[q] = q0 + q < splits ? __ldcg(src + (size_t)(q0 + q) * (BT * KT / 4))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      s.x += v[q].x;
      s.y += v[q].y;
      s.z += v[q].z;
      s.w += v[q].w;
    }
  }
  return s;
}

// Hands the block's tile to `finish` (float4 e, value): directly when the
// reduction is not split; otherwise through the tile's partials, in the
// last block of the tile to arrive.
template <int KT, typename Finish>
__device__ __forceinline__ void finish_tile(float* smem,
                                            const float (&acc)[Tile<KT>::MT][Tile<KT>::NT][4],
                                            int m0, int n0, int wk, int g, int t, float* part,
                                            int* tickets, size_t tile, int split_i, int splits,
                                            Finish finish) {
  if (splits == 1) {
    block_sum<KT>(smem, acc, m0, n0, wk, g, t, finish);
    return;
  }
  float* parts = part + tile * splits * (BT * KT);
  float4* mine = reinterpret_cast<float4*>(parts + (size_t)split_i * (BT * KT));
  block_sum<KT>(smem, acc, m0, n0, wk, g, t, [&](int e, float4 v) { __stcg(mine + e, v); });
  if (!last_arrival(tickets + tile, splits)) return;
#pragma unroll
  for (int it = 0; it < BT * KT / 4 / THREADS; ++it) {
    const int e = it * THREADS + threadIdx.x;
    finish(e, sum_partials<KT>(parts, splits, e));
  }
}

// ---- the two passes --------------------------------------------------------

struct Shape {
  int J, p, n, k;
  int kgroups, splits1, splits2;
  size_t w_batch, w_ld;  // W's block and row strides in elements: p * n, n
  bool w_vec, v_vec;     // 16-byte copies of W, and of x̄ as v
};

// The [first, last) range of BK-deep chunks of a reduction of length `len`
// that split `s` of `splits` covers.
__device__ __forceinline__ int2 chunk_range(int len, int s, int splits) {
  const int chunks = (len + BK - 1) / BK;
  const int per = (chunks + splits - 1) / splits;
  const int first = min(chunks, s * per);
  return make_int2(first, min(chunks, first + per));
}

// The ring: chunk i of nk lands in slot i % STAGES; STAGES - 1 chunks are in
// flight while one is multiplied.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int nk, Load load, Compute compute) {
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk i is in; slot (i - 1) % STAGES is free
    if (i + STAGES - 1 < nk) load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    compute(i % STAGES);
  }
}

// Pass 1: u = W v. Block (p-tile, split x kgroup, j) reduces its range of n.
template <typename TW, typename TX, int KT>
__global__ void __launch_bounds__(THREADS, 2) wv_kernel(
    const TW* __restrict__ W, const TX* __restrict__ x, const TX* __restrict__ xbar,
    float* __restrict__ u, float* __restrict__ part, int* __restrict__ tickets, Shape s) {
  using TL = Tile<KT>;
  constexpr bool THREE = !std::is_same<TW, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                     // [STAGES][BT][PA1]
  float* sB = smem + STAGES * A_STAGE;  // [STAGES][BK][PB]

  const int ptile = blockIdx.x, split_i = blockIdx.y % s.splits1, kg = blockIdx.y / s.splits1;
  const int j = blockIdx.z, p0 = ptile * BT, c0 = kg * KT;
  const int2 range = chunk_range(s.n, split_i, s.splits1);
  const TW* Wj = W + (size_t)j * s.w_batch;
  const TX* xj = x ? x + (size_t)j * s.n * s.k : nullptr;
  const TX* xbj = xbar + (size_t)j * s.n * s.k;
  const TileLoader<BT, BK, PA1, TW> wl(Wj, Wj + p0 * s.w_ld, s.w_ld, s.w_vec);
  const TileLoader<BK, KT, TL::PB, TX> vl(xbj, xbj + c0, s.k, s.v_vec);
  const bool v_direct = std::is_same<TX, float>::value && !xj;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wk = warp / (TL::WM * TL::WN);
  const int m0 = (warp % TL::WM) * (BT / TL::WM), n0 = (warp / TL::WM % TL::WN) * (KT / TL::WN);
  float acc[TL::MT][TL::NT][4] = {};
  pipeline(
      range.y - range.x,
      [&](int i, int slot) {
        const int n0c = (range.x + i) * BK;
        wl.load(sA + slot * A_STAGE, n0c, s.p - p0, s.n - n0c);
        if (v_direct) {
          vl.load(sB + slot * TL::B_STAGE, (size_t)n0c * s.k, s.n - n0c, s.k - c0);
        } else {
          load_v_tile<KT>(sB + slot * TL::B_STAGE, xj, xbj, s.k, n0c, s.n, c0);
        }
      },
      [&](int slot) {
        stage_mma<KT, false, THREE>(acc, sA + slot * A_STAGE, sB + slot * TL::B_STAGE, m0, n0,
                                    wk, g, t);
      });

  const int kp = s.kgroups * KT;
  float* uj = u + (size_t)j * gridDim.x * BT * kp;
  finish_tile<KT>(smem, acc, m0, n0, wk, g, t, part, tickets,
                  ((size_t)j * gridDim.x + ptile) * s.kgroups + kg, split_i, s.splits1,
                  [&](int e, float4 v) {
                    const int r = e * 4 / KT, c = e * 4 % KT;
                    *reinterpret_cast<float4*>(uj + (size_t)(p0 + r) * kp + c0 + c) = v;
                  });
}

// out[off] = x + gamma (v - wtu) with v = x̄ − x in f32, as the reference's
// second pass forms it.
template <typename TX>
__device__ __forceinline__ void update(TX* __restrict__ oj, const TX* __restrict__ xj,
                                       const TX* __restrict__ xbj, float gam, size_t off,
                                       float wtu) {
  const float xv = xj ? to_f32(xj[off]) : 0.f;
  const float v = to_f32(xbj[off]) - xv;
  oj[off] = from_f32<TX>(xv + gam * (v - wtu));
}

// Pass 2: out = x + gamma (v - W^T u). Block (n-tile, split x kgroup, j)
// reduces its range of p.
template <typename TW, typename TX, int KT>
__global__ void __launch_bounds__(THREADS, 2) update_kernel(
    const TW* __restrict__ W, const TX* __restrict__ x, const TX* __restrict__ xbar,
    const float* __restrict__ u, const float* __restrict__ gamma, float gamma_scalar,
    TX* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets, Shape s) {
  using TL = Tile<KT>;
  constexpr bool THREE = !std::is_same<TW, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                     // [STAGES][BK][PA2]
  float* sB = smem + STAGES * A_STAGE;  // [STAGES][BK][PB]

  const int ntile = blockIdx.x, split_i = blockIdx.y % s.splits2, kg = blockIdx.y / s.splits2;
  const int j = blockIdx.z, nb = ntile * BT, c0 = kg * KT;
  const int2 range = chunk_range(s.p, split_i, s.splits2);
  const int p_pad = (s.p + BT - 1) / BT * BT, kp = s.kgroups * KT;
  const TW* Wj = W + (size_t)j * s.w_batch;
  const float* uj = u + (size_t)j * p_pad * kp;
  const TileLoader<BK, BT, PA2, TW> wl(Wj, Wj + nb, s.w_ld, s.w_vec);
  const TileLoader<BK, KT, TL::PB, float> ul(uj, uj + c0, kp, true);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wk = warp / (TL::WM * TL::WN);
  const int m0 = (warp % TL::WM) * (BT / TL::WM), n0 = (warp / TL::WM % TL::WN) * (KT / TL::WN);
  float acc[TL::MT][TL::NT][4] = {};
  pipeline(
      range.y - range.x,
      [&](int i, int slot) {
        const int r0 = (range.x + i) * BK;
        wl.load(sA + slot * A_STAGE, (size_t)r0 * s.w_ld, s.p - r0, s.n - nb);
        ul.load(sB + slot * TL::B_STAGE, (size_t)r0 * kp, s.p - r0, kp - c0);
      },
      [&](int slot) {
        stage_mma<KT, true, THREE>(acc, sA + slot * A_STAGE, sB + slot * TL::B_STAGE, m0, n0,
                                   wk, g, t);
      });

  const float gam = gamma ? gamma[j] : gamma_scalar;
  const size_t jo = (size_t)j * s.n * s.k;
  const TX* xj = x ? x + jo : nullptr;
  const TX* xbj = xbar + jo;
  TX* oj = out + jo;
  finish_tile<KT>(smem, acc, m0, n0, wk, g, t, part, tickets,
                  ((size_t)j * gridDim.x + ntile) * s.kgroups + kg, split_i, s.splits2,
                  [&](int e, float4 v) {
                    const int r = nb + e * 4 / KT, c = c0 + e * 4 % KT;
                    if (r >= s.n) return;
                    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                      if (c + q < s.k) update(oj, xj, xbj, gam, (size_t)r * s.k + c + q, vs[q]);
                    }
                  });
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename TW, typename TX, int KT>
int launch(const void* W, const void* x, const void* xbar, const float* gamma,
           float gamma_scalar, float* u, float* part1, float* part2, int* tickets, void* out,
           Shape s, cudaStream_t stream) {
  static unsigned smem_done1 = 0, smem_done2 = 0;
  constexpr int smem = Tile<KT>::SMEM;
  s.w_vec = std::is_same<TW, float>::value && s.w_ld % 4 == 0 && s.w_batch % 4 == 0 &&
            aligned16(W);
  s.v_vec = std::is_same<TX, float>::value && !x && s.k % 4 == 0 && aligned16(xbar);
  const int ptiles = (s.p + BT - 1) / BT, ntiles = (s.n + BT - 1) / BT;
  int* tickets2 = tickets + (s.splits1 > 1 ? (size_t)s.J * ptiles * s.kgroups : 0);
  const auto* Wt = static_cast<const TW*>(W);
  const auto* xt = static_cast<const TX*>(x);
  const auto* xbt = static_cast<const TX*>(xbar);
  cudaError_t err;
  if (ptiles > 0) {  // p = 0: W has no rows, u is empty and pass 2 reduces nothing
    err = smem_limit_once(wv_kernel<TW, TX, KT>, smem, smem_done1);
    if (err != cudaSuccess) return static_cast<int>(err);
    wv_kernel<TW, TX, KT><<<dim3(ptiles, s.splits1 * s.kgroups, s.J), THREADS, smem, stream>>>(
        Wt, xt, xbt, u, part1, tickets, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = smem_limit_once(update_kernel<TW, TX, KT>, smem, smem_done2);
  if (err != cudaSuccess) return static_cast<int>(err);
  update_kernel<TW, TX, KT><<<dim3(ntiles, s.splits2 * s.kgroups, s.J), THREADS, smem, stream>>>(
      Wt, xt, xbt, u, gamma, gamma_scalar, static_cast<TX*>(out), part2, tickets2, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW, typename TX>
int dispatch_kt(int kt, const void* W, const void* x, const void* xbar, const float* gamma,
                float gamma_scalar, float* u, float* part1, float* part2, int* tickets,
                void* out, const Shape& s, cudaStream_t stream) {
  switch (kt) {
    case 32:
      return launch<TW, TX, 32>(W, x, xbar, gamma, gamma_scalar, u, part1, part2, tickets, out,
                                s, stream);
    case 64:
      return launch<TW, TX, 64>(W, x, xbar, gamma, gamma_scalar, u, part1, part2, tickets, out,
                                s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TW>
int dispatch_x(int x_dtype, int kt, const void* W, const void* x, const void* xbar,
               const float* gamma, float gamma_scalar, float* u, float* part1, float* part2,
               int* tickets, void* out, const Shape& s, cudaStream_t stream) {
  switch (x_dtype) {
    case DT_F32:
      return dispatch_kt<TW, float>(kt, W, x, xbar, gamma, gamma_scalar, u, part1, part2,
                                    tickets, out, s, stream);
    case DT_F64:
      return dispatch_kt<TW, double>(kt, W, x, xbar, gamma, gamma_scalar, u, part1, part2,
                                     tickets, out, s, stream);
    case DT_BF16:
      return dispatch_kt<TW, __nv_bfloat16>(kt, W, x, xbar, gamma, gamma_scalar, u, part1,
                                            part2, tickets, out, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches both passes on `stream`; returns cudaGetLastError() (0 = launched).
// W (J, p, n), x (may be null), x̄ and out (J, n, k) are contiguous.
// `gamma` is a (J,) float32 device vector, or null to use `gamma_scalar`.
// `kt` (32 or 64) is the column width of a block and `kgroups` =
// ceil(k / kt); u is float32 (J, ceil(p / 64) * 64, kgroups * kt); part1 and
// part2 hold `splits1` and `splits2` float32 [64][kt] tiles per output tile
// (unused when the split is 1); `tickets` holds one zeroed int32 per output
// tile of each pass that splits, pass 1's first, and is zero again after the
// call (null when neither pass splits).
extern "C" int consensus_update_launch(const void* W, const void* x, const void* xbar,
                                       const void* gamma, float gamma_scalar, void* u,
                                       void* part1, void* part2, void* tickets, void* out, int J,
                                       int p, int n, int k, int kt, int splits1, int splits2,
                                       int w_dtype, int x_dtype, void* stream) {
  if (J < 1 || p < 0 || n < 1 || k < 1 || splits1 < 1 || splits2 < 1 || (kt != 32 && kt != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{J, p, n, k, (k + kt - 1) / kt, splits1, splits2, (size_t)p * n, (size_t)n, false, false};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* uf = static_cast<float*>(u);
  float* p1 = static_cast<float*>(part1);
  float* p2 = static_cast<float*>(part2);
  int* tk = static_cast<int*>(tickets);
  switch (w_dtype) {
    case DT_F32:
      return dispatch_x<float>(x_dtype, kt, W, x, xbar, g, gamma_scalar, uf, p1, p2, tk, out, s,
                               st);
    case DT_F64:
      return dispatch_x<double>(x_dtype, kt, W, x, xbar, g, gamma_scalar, uf, p1, p2, tk, out,
                                s, st);
    case DT_BF16:
      return dispatch_x<__nv_bfloat16>(x_dtype, kt, W, x, xbar, g, gamma_scalar, uf, p1, p2, tk,
                                       out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
