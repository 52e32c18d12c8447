// The consensus loop's residual on the tensor cores: for blocks A (J, p, n),
// right-hand sides b (J, p, k) and the consensus x̄ (n, k), all float32 and
// contiguous, two launches write block_sq[j, c] = sum_i ((A_j x̄ - b_j)[i, c])^2
// (J, k) and residual_sq[c] = sum_j block_sq[j, c] (k,): xbar_split_kernel
// splits x̄ once, residual_kernel does the rest. The residual r = A x̄ - b
// itself never reaches device memory. At k <= 8, and for float64 operands,
// the wrapper keeps the library's product (kernels/residual/ops.plan).
//
// Replaces no Pallas kernel: the reference computes the residual with plain
// jnp (src/repro/core/consensus.py, block_residual_sq), and so did the port,
// as cuBLAS's float32 gemm for A x̄ and then a subtraction, a product and a
// sum in ATen, each one more pass over the (J, p, k) intermediate. Added
// because that gemm was the largest device operation of an epoch.
//
// What bounds it on an H100: at the paper's worked example, A (8, 2282, 4563)
// with k = 32, A's 333 MB against 5.3 GFLOP (16 flop a byte), so A's bytes:
// 0.100 ms at 3.35 TB/s. At Table 1's shape with a bulk batch, A (8, 1164,
// 2327) with k = 256, 87 MB against 11.1 GFLOP (128 flop a byte), so the
// products: 0.067 ms at a third of the TF32 rate (3xTF32, below).
//
// Design:
//   * float32 products at float32 accuracy on the tensor cores, as in
//     project.cu: each operand split as hi + lo in TF32, three products
//     (a_lo b_hi + a_hi b_lo + a_hi b_hi), and every four k8 steps'
//     products flushed from a fresh accumulator into the running sum in f32,
//     since the tensor core truncates when it accumulates. The products are
//     Hopper's wgmma (m64nKTk8, a warpgroup for each 64 rows of the tile):
//     project.cu's mma.sync design spent more issue slots splitting and
//     loading fragments than A's stream leaves at these shapes (0.12 ms of
//     products alone at s5). A's fragments go to the wgmma from registers,
//     split there; x̄'s hi and lo tiles are read from shared memory by
//     descriptor, K-major core matrices without swizzle;
//   * x̄ is the same operand for every block, so xbar_split_kernel splits it
//     once a call into those tiles (2 k n floats: 1.2 MB at s5), and the
//     blocks copy them as they are; splitting them in each block cost 0.076
//     ms a call at s5;
//   * A's rows are not 16-byte aligned at either shape (n = 4563, 2327), and
//     4-byte copies stream A at ~1.8 TB/s. So each row's BK-column segment
//     comes as the 16-byte-aligned chunks that cover it (BK / 4 + 1 of them,
//     cp.async.cg into the ring beside x̄'s tiles) and the fragment loads add
//     the row's misalignment; a thread's chunks are fixed up front;
//   * a block computes a tile of BM = 64 x warpgroups rows of one block A_j
//     for KT columns over the whole of n, so no partial product leaves the
//     block: its epilogue subtracts b, squares, and sums the tile's rows per
//     column in a fixed order (registers, a shuffle tree, then the warps in
//     order) and writes KT floats. The tile comes from k alone
//     (kernels/residual/ops.plan): at k <= 32 (the bytes bound it) one
//     warpgroup and two 64-column stages, so three blocks fit an SM and all
//     288 tiles of s5 stream at once, with no last partial wave; at k > 32
//     (the products bound it) KT = 64 and two warpgroups, which halves the
//     x̄ tiles copied per A byte;
//   * deterministic sums: the last tile of (j, column group) to arrive (a
//     self-resetting ticket) sums the column sums of its tiles in tile order
//     into block_sq, and the last of those sums block_sq over j in j order
//     into residual_sq. No float atomics: repeated launches give the same
//     bits.
// Measured (H100 80GB HBM3, 700 W, CUDA events over 20 calls, both
// launches): s5 0.160 ms against 0.272 ms for cuBLAS + ATen; t1 0.230 ms
// against 0.288 ms. One right-hand side at s5 took 0.146 ms in a tile of
// 8 columns against 0.132 ms for cuBLAS's gemv, so k <= 8 has no tile here;
// a float64 kernel on the CUDA cores (64 x 32 tiles, the next stage
// prefetched into registers) took 0.285 ms at t1's A with k = 32 against
// 0.096 ms for cuBLAS's float64 product plus ATen, so float64 has none.
// The wrapper allocates the outputs, x̄'s tiles, the (J, ptiles, k) tile sums
// and the tickets (J * kgroups + 1 int32, zeroed here by a memset); A is
// 16-byte aligned. No library call computes any product here.
#include <cstdint>

#include "common.cuh"

namespace {

// ---- wgmma -------------------------------------------------------------------

// d (+)= a b for the warpgroup's 64 x N tile over one k8 step: a the warp's
// m16 x k8 TF32 fragment in registers (mma.sync's layout: (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)), b a descriptor of the K-major N x 8 TF32 tile;
// scale_d = 0 overwrites d. d: (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1) of each n8 tile in turn.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The thread's copies into shared memory, before the wgmma (the async
// proxy) reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving a read of d across a wgmma wait, or a
// write of it across a wgmma issue: the wgmma writes d asynchronously.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major N x 8 TF32 tile at `tile` (shared memory): core
// matrices of 8 rows x 16 bytes, the two along K 128 bytes apart (leading
// byte offset), successive 8-row groups along N 256 bytes apart (stride byte
// offset), no swizzle.
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const auto addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// ---- the tile ----------------------------------------------------------------

// KT columns of k a block; BK columns of n a stage; STAGES of A and x̄'s
// tiles in the ring; MINB blocks an SM at least (the register budget).
template <int KT_, int BK_, int STAGES_, int MINB_, int WGS_>
struct Cfg {
  static constexpr int KT = KT_, BK = BK_, STAGES = STAGES_, MINB = MINB_, WGS = WGS_;
  static constexpr int THREADS = 128 * WGS;  // warpgroups, each 64 rows of the tile
  static constexpr int BM = 64 * WGS;
  static constexpr int CH = BK / 4 + 1;  // 16-byte chunks covering a row's segment
  static constexpr int NIT = (BM * CH + THREADS - 1) / THREADS;  // chunks a thread a stage
  static constexpr int PA = BK + 4;      // A row pitch (floats): the chunks of a row
  static constexpr int A_STAGE = BM * PA;
  static constexpr int B_TILE = BK * KT;  // x̄'s hi (or lo) tile of a stage
  static constexpr int STAGE = A_STAGE + 2 * B_TILE;
  static constexpr int NR = KT / 2;       // accumulator registers a thread
  static constexpr int SMEM = 4 * STAGES * STAGE;
  static_assert(BK % 32 == 0 && KT % 8 == 0 && 2 * B_TILE % (4 * THREADS) == 0, "tile");
};

struct Shape {
  int J, p, n, k;
  int ptiles, kgroups, nk;
};

// Block (row tile, column group, j) has the sums of squares of its tile's
// rows in v, column threadIdx.x < KT of its group: stores them, then the
// last tile of (j, column group) to arrive (a self-resetting ticket) sums
// its tiles into block_sq in tile order, and the last (j, column group) of
// all sums block_sq over j in j order into total.
template <int KT, int THREADS>
__device__ __forceinline__ void sum_tiles(float v, float* __restrict__ tile_sq,
                                          int* __restrict__ tickets, float* __restrict__ block_sq,
                                          float* __restrict__ total, const Shape& s) {
  const int ptile = blockIdx.x, kg = blockIdx.y, j = blockIdx.z;
  const int col = kg * KT + threadIdx.x;
  const bool mine = threadIdx.x < KT && col < s.k;
  if (mine) tile_sq[((size_t)j * s.ptiles + ptile) * s.k + col] = v;
  if (!last_arrival(tickets + (size_t)j * s.kgroups + kg, s.ptiles)) return;
  if (mine) {
    const float* src = tile_sq + (size_t)j * s.ptiles * s.k + col;
    float sum = 0.f;
#pragma unroll 8
    for (int q = 0; q < s.ptiles; ++q) sum += __ldcg(src + (size_t)q * s.k);
    block_sq[(size_t)j * s.k + col] = sum;
  }
  if (!last_arrival(tickets + (size_t)s.J * s.kgroups, s.J * s.kgroups)) return;
  for (int c = threadIdx.x; c < s.k; c += THREADS) {
    float sum = 0.f;
    for (int q = 0; q < s.J; ++q) sum += __ldcg(block_sq + (size_t)q * s.k + c);
    total[c] = sum;
  }
}

// x̄'s tiles, split once for every block: for column group kg and stage i,
// the hi then the lo tile, BK x KT each, in the layout the wgmma reads (a k8
// step's K-major KT x 8 tile after another: core (column group cb, K half
// kh) at (2 cb + kh) * 32 floats, element (c8, kl) at 4 c8 + kl), zero
// outside x̄.
template <class C>
__global__ void __launch_bounds__(256) xbar_split_kernel(const float* __restrict__ xbar,
                                                         float* __restrict__ xs, Shape s) {
  constexpr int KT = C::KT, BK = C::BK;
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= (size_t)s.kgroups * s.nk * C::B_TILE) return;
  const int at = (int)(e % C::B_TILE);
  const size_t tile = e / C::B_TILE;  // kg * nk + i
  const int kg = (int)(tile / s.nk), i = (int)(tile % s.nk);
  const int st = at / (8 * KT), core = at % (8 * KT) / 32, l = at % 32;
  const int cb = core / 2, kh = core % 2;
  const int row = i * BK + 8 * st + 4 * kh + l % 4, col = kg * KT + 8 * cb + l / 4;
  const float v = row < s.n && col < s.k ? xbar[(size_t)row * s.k + col] : 0.f;
  uint32_t hi, lo;
  split(v, hi, lo);
  float* dst = xs + tile * 2 * C::B_TILE + at;
  dst[0] = __uint_as_float(hi);
  dst[C::B_TILE] = __uint_as_float(lo);
}

// Block (row tile, column group, j).
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB) residual_kernel(
    const float* __restrict__ A, const float* __restrict__ b, const float* __restrict__ xs,
    float* __restrict__ tile_sq, int* __restrict__ tickets, float* __restrict__ block_sq,
    float* __restrict__ total, Shape s) {
  constexpr int KT = C::KT, BK = C::BK, PA = C::PA, BM = C::BM, THREADS = C::THREADS;
  extern __shared__ __align__(128) float smem[];  // [STAGES][A rows | x̄ hi | x̄ lo]
  __shared__ float wsum[THREADS / 32][KT];

  const int ptile = blockIdx.x, kg = blockIdx.y, j = blockIdx.z;
  const int p0 = ptile * BM, c0 = kg * KT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t row0 = (size_t)j * s.p + p0;     // the tile's first row of A, flat
  const size_t size = (size_t)s.J * s.p * s.n;  // A's floats
  const float* xk = xs + (size_t)kg * s.nk * 2 * C::B_TILE;

  // Stage i: A's segment [i * BK, i * BK + BK) of each of the tile's rows as
  // the 16-byte chunks from the row's aligned start below it, and x̄'s two
  // tiles. A thread's chunks are the same rows and columns at every stage,
  // BK floats on: their offsets from the tile's first chunk, the floats left
  // in A from each, and their places in the stage are fixed up front.
  const float* abase = A + ((row0 * s.n) & ~size_t(3));
  int a_off[C::NIT], a_left[C::NIT], a_dst[C::NIT];
#pragma unroll
  for (int it = 0; it < C::NIT; ++it) {
    const int e = it * THREADS + threadIdx.x, r = e / C::CH, q = e % C::CH;
    const size_t at = (((row0 + r) * s.n) & ~size_t(3)) + 4 * q;
    a_off[it] = (int)(at - ((row0 * s.n) & ~size_t(3)));
    a_left[it] = e < BM * C::CH && p0 + r < s.p ? (int)min(size - at, (size_t)0x7fffffff) : 0;
    a_dst[it] = r * PA + 4 * q;
  }
  auto load = [&](int i, int slot) {
    float* dst = smem + slot * C::STAGE;
#pragma unroll
    for (int it = 0; it < C::NIT; ++it) {
      if (it * THREADS + (int)threadIdx.x >= BM * C::CH) break;
      const int left = a_left[it] - i * BK;
      const int nb = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
      cp_async16(dst + a_dst[it], nb ? abase + a_off[it] + i * BK : A, nb);
    }
    const float* src = xk + (size_t)i * 2 * C::B_TILE;
#pragma unroll
    for (int e = 4 * threadIdx.x; e < 2 * C::B_TILE; e += 4 * THREADS)
      cp_async16(dst + C::A_STAGE + e, src + e, 16);
  };

  // The thread's two fragment rows and their misalignment (fixed: BK % 4 == 0).
  const int ra = 16 * warp + g, rb = ra + 8;
  const int ma = (int)(((row0 + ra) * s.n) & 3), mb = (int)(((row0 + rb) * s.n) & 3);

  float acc[C::NR] = {}, part[C::NR];
#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < s.nk) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < s.nk; ++i) {
    cp_async_wait<C::STAGES - 2>();
    fence_proxy_async();  // the copies, before the wgmma (async proxy) reads x̄'s tiles
    __syncthreads();  // stage i is in; every thread is done with stage i - 1's slot
    if (i + C::STAGES - 1 < s.nk) load(i + C::STAGES - 1, (i + C::STAGES - 1) % C::STAGES);
    cp_async_commit();
    const float* stage = smem + (i % C::STAGES) * C::STAGE;
    const float* fa = stage + ra * PA + ma + t;
    const float* fb = stage + rb * PA + mb + t;
    const float* hiT = stage + C::A_STAGE;
    const float* loT = hiT + C::B_TILE;
#pragma unroll
    for (int q = 0; q < BK / 32; ++q) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int kc = 8 * (4 * q + ks);
        split(fa[kc], ah[ks][0], al[ks][0]);
        split(fb[kc], ah[ks][1], al[ks][1]);
        split(fa[kc + 4], ah[ks][2], al[ks][2]);
        split(fb[kc + 4], ah[ks][3], al[ks][3]);
      }
      wgmma_fence();
      fence_regs(part);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int at = (4 * q + ks) * 8 * KT;
        wgmma_tf32<KT>(part, al[ks], b_desc(hiT + at), ks);
        wgmma_tf32<KT>(part, ah[ks], b_desc(loT + at), 1);
        wgmma_tf32<KT>(part, ah[ks], b_desc(hiT + at), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(part);
#pragma unroll
      for (int v = 0; v < C::NR; ++v) acc[v] += part[v];
    }
  }

  // Epilogue: (A x̄ - b)^2 of the thread's two rows, summed over the warp's
  // 16 rows by a shuffle tree, then over the warps in order.
  const float* ba = b + (row0 + ra) * s.k;
  const float* bb = b + (row0 + rb) * s.k;
#pragma unroll
  for (int v = 0; v < C::NR / 2; ++v) {
    const int col = 8 * (v / 2) + 2 * t + v % 2, gc = c0 + col;
    const int va = 4 * (v / 2) + v % 2;
    float sq = 0.f;
    if (gc < s.k) {
      if (p0 + ra < s.p) {
        const float d = acc[va] - ba[gc];
        sq = d * d;
      }
      if (p0 + rb < s.p) {
        const float d = acc[va + 2] - bb[gc];
        sq += d * d;
      }
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 4);
    sq += __shfl_xor_sync(0xffffffffu, sq, 8);
    sq += __shfl_xor_sync(0xffffffffu, sq, 16);
    if (g == 0) wsum[warp][col] = sq;
  }
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < KT) {
    v = wsum[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) v += wsum[w][threadIdx.x];
  }
  sum_tiles<KT, THREADS>(v, tile_sq, tickets, block_sq, total, s);
}

template <class C>
int launch(const float* A, const float* b, const float* xbar, float* xs, float* tile_sq,
           int* tickets, float* block_sq, float* total, Shape s, cudaStream_t stream) {
  static unsigned smem_done = 0;
  s.ptiles = (s.p + C::BM - 1) / C::BM;
  s.kgroups = (s.k + C::KT - 1) / C::KT;
  s.nk = (s.n + C::BK - 1) / C::BK;
  const cudaError_t err = smem_limit_once(residual_kernel<C>, C::SMEM, smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t ticket_bytes = sizeof(int) * ((size_t)s.J * s.kgroups + 1);
  cudaError_t e = cudaMemsetAsync(tickets, 0, ticket_bytes, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t split = (size_t)s.kgroups * s.nk * C::B_TILE;
  if (split > 0) {
    xbar_split_kernel<C><<<(unsigned)((split + 255) / 256), 256, 0, stream>>>(xbar, xs, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  residual_kernel<C><<<dim3(s.ptiles, s.kgroups, s.J), C::THREADS, C::SMEM, stream>>>(
      A, b, xs, tile_sq, tickets, block_sq, total, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() (0 =
// launched). A (J, p, n), 16-byte aligned, b (J, p, k) and x̄ (n, k) are
// float32 and contiguous; block_sq (J, k) and total (k,) are written.
// `config` picks the tile, kept in step with kernels/residual/ops.CONFIGS,
// which sizes x̄'s tiles xs (ceil(k / KT) * ceil(n / BK) * 2 * BK * KT
// floats), tile_sq (J * ceil(p / BM) * k floats) and the tickets
// (J * ceil(k / KT) + 1 int32), which the launch zeroes first.
extern "C" int residual_launch(const void* A, const void* b, const void* xbar, void* xs,
                               void* tile_sq, void* tickets, void* block_sq, void* total, int J,
                               int p, int n, int k, int config, void* stream) {
  if (J < 1 || p < 1 || n < 0 || k < 1 || (reinterpret_cast<uintptr_t>(A) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{J, p, n, k, 0, 0, 0};
  const auto* a = static_cast<const float*>(A);
  const auto* bv = static_cast<const float*>(b);
  const auto* x = static_cast<const float*>(xbar);
  auto* xsp = static_cast<float*>(xs);
  auto* ts = static_cast<float*>(tile_sq);
  auto* tk = static_cast<int*>(tickets);
  auto* bs = static_cast<float*>(block_sq);
  auto* tot = static_cast<float*>(total);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return launch<Cfg<32, 64, 2, 3, 1>>(a, bv, x, xsp, ts, tk, bs, tot, s, st);
    case 1: return launch<Cfg<64, 32, 3, 2, 2>>(a, bv, x, xsp, ts, tk, bs, tot, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
