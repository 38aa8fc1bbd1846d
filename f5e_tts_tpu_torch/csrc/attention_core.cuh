// The attention kernel family of the port, written by hand for Hopper
// (sm_90a): a forward of two kernels and a backward of three, as templates
// over
//   ROPE: whether RoPE is compiled in (heads h < rope_heads are rotated), and
//   MASK: which key columns are valid, for a per-sample length `len`:
//         kMaskPrefix  col < len                       (a padded sequence)
//         kMaskJoint   col < len || col >= n_audio     (keys [audio | text]:
//                      padded audio, then a text tail that is always valid)
// The instantiations live in rope_attention.cu (ROPE, prefix),
// masked_attention.cu (no RoPE, prefix) and joint_attention.cu (no RoPE,
// joint); each names the TPU kernels it replaces. The TPU package needed a
// kernel per way of holding a head's K/V in VMEM (per head, per head chunk,
// all heads packed); a Hopper block owns one (q-tile, head, batch) or one
// (key tile, head, batch) whatever that chunking was, so what is left to
// tell the kernels apart is the column rule and whether a head is rotated.
//
// Forward. For q, k, v (B, N, H, dh) bf16 and lens (B,) int32 it computes,
// per (batch, head),
//     out = softmax(rot(q) . rot(k)^T * dh^-0.5, valid columns) . v
// with rot(x) = x * cos + rot_half(x) * sin on rotated heads (half-split
// tables cos/sin (N, dh) fp32; rot_half(x) = concat(-x[dh/2:], x[:dh/2]))
// and rot(x) = x elsewhere. As on the TPU: q is rotated in fp32, scaled, then
// rounded to bf16; k is rotated in fp32 and rounded to bf16; masked scores
// are the finite -1e30 and keys past N count as -inf; P is rounded to bf16
// before P.V, which accumulates in fp32 and is divided by max(l, 1e-30) at
// the end. A row whose keys are all masked (prefix: len = 0; joint: len = 0
// and no text) comes out as the uniform average over the N keys, as the TPU
// kernels' does. When asked, the forward also writes each row's softmax
// statistics, m (the row max) and linv = 1 / max(l, 1e-30), fp32 (B, H, N):
// the residuals the backward needs. Without ROPE no cos/sin table is read:
// the pointers are null and the code that would read them is compiled out.
//
// Bound on this card: operations. At the synthesis shapes (B=2, N=1536,
// H=16, dh=64) the two products are ~4*B*H*N*kv*dh flops against ~26 MB of
// operands, ~600 flops per byte, above the H100's ~295 bf16 flops per byte.
// The TPU kernels keep one head's whole K/V in VMEM; K+V of one head at
// N=4096 is 1 MB against 227 KB of shared memory here, so the forward
// streams K/V tiles with an online softmax (flash-attention style), in two
// kernels on one stream:
//   0. pre-pass, the backward's without dO, O and delta: q' = bf16(sm_scale
//      * rot(q)) and, with RoPE compiled in, k' = bf16(rot(k)) into
//      head-major scratch (B, H, N, dh), so K is rotated once per call and
//      not once per q-tile (a block that rotated its own K tiles spent 43 %
//      of its time there). Without RoPE only q' is written and k is read in
//      place. Memory-bound: ~25 MB at (2, 1536, 16, 64).
//   1. main kernel, one block per (64 * fwd_groups query rows, head, batch):
//      three consumer warpgroups of 64 rows at dh 64 (two at dh 128) and one
//      producer warp. The producer loads the block's q' tiles once and
//      streams the live (K', V) tiles of 64 keys through a ring of kStages
//      in shared memory with TMA, each stage under a full and an empty
//      mbarrier. S = q'.K'^T runs on wgmma with both operands K-major in
//      shared memory. Only a tile on an edge of the valid columns (the last
//      one before len or N, the gap's ends) is masked, with selects on the
//      column's offset in the tile, not a branch per element. The online
//      softmax runs in registers (the row max across the four threads of a
//      quad at each tile, the row sum once at the end; O rescaled by
//      exp(m_old - m_new)), p = 2^(s log2(e) - m log2(e)) as one FFMA and
//      one ex2. P is rounded to bf16 straight from the S accumulators into
//      register A fragments, and O += P.V is a register-A wgmma with V read
//      MN-major through the descriptor, from its in-place map: no tile is
//      transposed by hand. S of tile j and P.V of tile j - 1 are issued as
//      two commit groups, so the softmax of tile j runs while P.V of tile
//      j - 1 is on the tensor cores. At the end O * linv is rounded to bf16
//      and written from registers, with m and linv where asked. Dead key
//      tiles are skipped: a tile none of whose columns is valid has
//      probabilities of exactly 0 in fp32, so skipping it changes no bit of
//      the result. With the prefix rule the dead tiles are those at or past
//      len, and the loop ends there; with the joint rule they are the tiles
//      inside the gap [len, n_audio), and the tiles after it are live
//      again. Rows and keys past N arrive as zeros from TMA's
//      out-of-bounds fill: those rows are not written, those keys score
//      -inf.
// q/k/v are read through batch and row strides, so the column slices of a
// fused to_qkv projection (row stride 3*H*dh) go in without a copy; the
// head stride must be dh and the last axis contiguous.
// What holds the main kernel above its bound: at dh 64 a warpgroup's tile
// of 64 rows x 64 keys is 2^20 flops, ~256 cycles of an SM's tensor cores
// at the bf16 peak, and 4096 exponentials, ~256 cycles of its 16 ex2 units,
// besides ~5 other instructions a score (max, FFMA, sum, convert, rescale).
// The exponential is a bound as tight as the products', and one block of
// three warpgroups an SM (at ~110 registers a thread) covers it only in part:
// hence one instruction a score fewer (the FFMA) and no mask on inner
// tiles. Tried and dropped (PERF.md, Findings): the serial loop (products,
// wait, softmax, products, wait), two blocks of two warpgroups an SM or one
// of four, and named-barrier turns of the warpgroups at the tensor cores.
//
// Backward. From q, k, v, the output cotangent g = dO, the forward's output
// O and its row statistics (m, linv) it forms, per (batch, head),
//     q' = bf16(sm_scale * rot(q)), k' = bf16(rot(k))       (as the forward)
//     P  = exp(q'.k'^T - m) * linv                         (masked alike)
//     dP = dO . v^T, delta = rowsum(dO * O), dS = bf16(P * (dP - delta))
//     dV = bf16(P)^T . dO
//     dQ = rot^T(sm_scale * dS . k'),  dK = rot^T(dS^T . q')
// with rot^T(x) = x * cos - rot_half(x * sin), the RoPE adjoint, applied
// once to the fp32 dQ and dK sums of rotated heads. Outputs are bf16. At
// masked keys dS is 0, the derivative of the mask; the TPU kernels form
// p(dP - delta) there too, which is also 0 unless every key of the row is
// masked: then the scores do not depend on q or k, and dQ = dK = 0 here (as
// in jax.vjp of the JAX package's XLA reference) where the TPU kernels' are
// not.
// Row statistics: the TPU kernels save only their inputs and recompute each
// row's max and sum over all keys, which they hold in VMEM. A Hopper block
// that owns a key tile never sees a whole row, so the forward writes m and
// linv as a side output (8 bytes per row and head) and the autograd Function
// saves them with O. delta = sum_j P_ij dP_ij (what the TPU kernels form)
// equals rowsum(dO * O) in exact arithmetic; with O the bf16 output it
// differs by at most one bf16 rounding of O per term, ~2^-8 * sum_d |dO * O|,
// which the bf16 tolerance of the outputs covers. Every backward
// instantiation forms delta this way.
// Accumulation across the sequence: the TPU kernels add dK and dV over
// q-blocks on their sequential grid axis. Blocks here run in no order, so
// the backward uses no atomics (two runs give identical gradients) and is
// three kernels on one stream:
//   0. pre-pass, the forward's with delta = rowsum(dO * O), fp32 (B, H, N),
//      added: q' and (with RoPE) k' once per call into the same head-major
//      scratch with the same fp32 arithmetic, so the products see the
//      forward's operands. Memory-bound: ~230 MB at (8, 2304, 16, 64).
//   1. dq kernel, one block per (192 query rows at dh 64, 128 at dh 128;
//      head, batch): three (two) consumer warpgroups of 64 rows and one
//      producer warp. The producer loads the block's q' and dO tiles once
//      and streams the live (K', V) tiles of 64 keys through a ring of 3
//      stages in shared memory with TMA, each stage under a full and an
//      empty mbarrier. S = q'.K'^T and dP = dO.V^T run on wgmma with both
//      operands K-major in shared memory, committed as two groups, so
//      P = exp(S - m) * linv is formed while dP is still on the tensor
//      cores. dS = P (dP - delta) is masked with selects on the column's
//      offset in the tile: written as a per-key test with an early return,
//      the mask compiled into a branch around every exp, and the
//      warpgroups waited on each in turn (PERF.md, Findings). dS goes back into
//      wgmma as a register A operand for dQ += dS.K', K' read MN-major
//      (transposed by the descriptor). Dead key tiles are skipped (prefix:
//      the loop ends at kv_len; joint: the gap's tiles).
//   2. dkdv kernel, one block per (128 keys, head, batch) at dh 64 (64 keys
//      and one warpgroup at dh 128, for the registers): K' and V tiles stay
//      in shared memory; q', dO and each q-tile's m, linv and delta stream
//      through the ring. S^T = K'.q'^T and dP^T = V.dO^T are K-major
//      products; dV += P^T.dO and dK += dS^T.q' take P^T and dS^T from
//      registers and read dO and q' MN-major, so no tile is ever transposed
//      by hand. A block whose key tiles are all dead writes dK = dV = 0,
//      exactly what their zero probabilities give.
// TMA maps (both directions) are 3-D, [64 rows][64 columns] boxes with
// 128-byte swizzle (a dh = 64 bf16 row is 128 bytes; dh = 128 takes two
// boxes side by side), encoded on the host at each launch: scratch as
// (dh, N, B*H), operands in place as (H*dh, N, B) through their strides, so
// the column slices of a fused to_qkv (row stride 3*H*dh) need no copy. Rows
// past N come in as 0; p = 0 there through linv = 0 (rows) and the column
// rules (keys). The RoPE adjoint and sm_scale are applied in registers at
// the end: the element at column c + dh/2 sits in the same thread's
// accumulator dh/16 n8-blocks on (the wgmma accumulator layout repeats
// mma.sync's per warp).
// Both kernels recompute S and dP: 7 products of N x N x dh per head
// against the 5 of the math, the price of no atomics. Bound on this card:
// operations (10 * B * H * N^2 * dh flops at ~1,000 flops per byte at the
// training shapes). What holds the kernels above it is latency, not the
// tensor cores' rate: a warpgroup's loop is serial (products, wait,
// softmax, products, wait), and at 120-165 registers a thread an SM holds
// one block, so two or three warpgroups, too few to cover one another's
// softmax: without it (and then at two blocks an SM) the dq kernel's three
// products come close to the card's bf16 peak. Turn-taking of the
// warpgroups at the tensor cores (named barriers) gained little, and
// deferring a group's wait to the next tile made ptxas serialize the wgmma
// chain (PERF.md, Findings).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 64;  // keys per K/V tile
constexpr float kMaskValue = -1e30f;
constexpr int kMaskPrefix = 0;  // column c valid iff c < len
constexpr int kMaskJoint = 1;   // column c valid iff c < len || c >= n_audio

// The variants the kernels are instantiated for; a profiler shows their names.
struct RopeAttn {  // RoPE on heads h < rope_heads, prefix mask
  static constexpr bool kRope = true;
  static constexpr int kMask = kMaskPrefix;
};
struct MaskedAttn {  // no RoPE, prefix mask
  static constexpr bool kRope = false;
  static constexpr int kMask = kMaskPrefix;
};
struct JointAttn {  // no RoPE, joint mask
  static constexpr bool kRope = false;
  static constexpr int kMask = kMaskJoint;
};

typedef __nv_bfloat16 bf16;

template <int MASK>
__device__ __forceinline__ bool col_valid(int col, int len, int n_audio) {
  return MASK == kMaskPrefix ? col < len : (col < len || col >= n_audio);
}

// True when no column < n is valid: the row is the uniform average.
template <int MASK>
__device__ __forceinline__ bool all_masked(int len, int n_audio, int n) {
  return MASK == kMaskPrefix ? len <= 0 : (len <= 0 && n_audio >= n);
}

// True when no column of the key tile [k0, k0 + 64) is valid although some
// column of the row is: its probabilities are exactly 0. k0 < n.
template <int MASK>
__device__ __forceinline__ bool tile_dead(int k0, int len, int n_audio, int n) {
  if (all_masked<MASK>(len, n_audio, n)) return false;
  return MASK == kMaskPrefix ? k0 >= len : (k0 >= len && min(k0 + kBlockK, n) <= n_audio);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x, the hardware's approximation (what __expf uses after its multiply).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of a 16 x 64 tile as bf16 A fragments over its 64
// columns (the m16n8k16 accumulator layout of tiles 2kk, 2kk+1 is the A
// fragment of columns [16kk, 16kk + 16)).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[kBlockK / 16][4],
                                         const float (&s)[kBlockK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    a[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// RoPE adjoint x * cos - rot_half(x * sin) of a 16 x DH accumulator tile in
// place; rows r0 (fragment elements 0, 1) and r1 (2, 3) are sequence
// positions. Column c + DH/2 is in tile j + DH/16 of the same thread.
template <int DH>
__device__ __forceinline__ void rope_adjoint(float (&x)[DH / 8][4], int r0, int r1, int n,
                                             const float* cos, const float* sin) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pos = e < 2 ? r0 : r1;
      if (pos >= n) continue;
      const int c = j * 8 + 2 * t + (e & 1);
      const float* cr = cos + static_cast<long long>(pos) * DH;
      const float* sr = sin + static_cast<long long>(pos) * DH;
      const float x1 = x[j][e], x2 = x[j + DH / 16][e];
      x[j][e] = x1 * __ldg(cr + c) + x2 * __ldg(sr + c + DH / 2);
      x[j + DH / 16][e] = x2 * __ldg(cr + c + DH / 2) - x1 * __ldg(sr + c);
    }
  }
}

// ---------------------------------------------------------------------------
// Asynchronous copies and wgmma: what the forward's main kernel and the
// backward's kernels share
// ---------------------------------------------------------------------------

constexpr int kRows = 64;               // rows of a tile: a warpgroup's M, one step of a stream
constexpr int kSubBytes = 64 * 64 * 2;  // a [64 rows][64 columns] bf16 sub-tile, 128-byte rows
constexpr int kStages = 3;              // depth of the ring of streamed tiles
constexpr int kPrepThreads = 256;
constexpr long long kWaitCycles = 20000000000LL;  // ~10 s: a wait this long is a lost arrival

// A [64][DH] tile: DH / 64 sub-tiles side by side.
template <int DH>
__host__ __device__ constexpr int tile_bytes() {
  return kRows * DH * 2;
}
// Consumer warpgroups of a dq block (64 query rows each): three at dh 64
// (one block of 416 threads at <= 157 registers fills an SM), two at dh 128.
template <int DH>
__host__ __device__ constexpr int dq_groups() {
  return DH == 64 ? 3 : 2;
}
// Of a dk/dv block (64 keys each); at dh 128 one, for the registers.
template <int DH>
__host__ __device__ constexpr int dkdv_groups() {
  return DH == 64 ? 2 : 1;
}
// Of a forward block (64 query rows each): three at dh 64 (one block of 416
// threads an SM), two at dh 128, for the registers.
template <int DH>
__host__ __device__ constexpr int fwd_groups() {
  return DH == 64 ? 3 : 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait of ~10 s
// means an arrival was lost: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      start = clock64();
    } else if ((spin & 1023) == 0 && clock64() - start > kWaitCycles) {
      __trap();
    }
  }
}

// Box (c0, c1, c2) of a 3-D tensor map into shared memory at `dst`; the
// bytes count towards barrier `bar`. Elements outside the tensor read as 0.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row, row + 64) of head h, batch b of one operand, as DH / 64
// swizzled [64][64] sub-tiles at `dst`. A head-major map is over the
// scratch (B, H, N, DH) as (DH, N, B*H); an in-place one over (B, N, H, DH)
// through its strides as (H*DH, N, B).
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, bool head_major,
                                          uint32_t bar, int row, int h, int b, int heads) {
#pragma unroll
  for (int s = 0; s < DH / 64; ++s) {
    tma_load_3d(dst + s * kSubBytes, &map, bar, (head_major ? 0 : h * DH) + s * 64, row,
                head_major ? b * heads + h : b);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 128B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ULL << 62);
}

// A [64][DH] tile as a K-major operand: its rows are M (or N), columns
// [16kk, 16kk + 16) are K; 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kSubBytes + (kk % 4) * 32, 16, 1024);
}

// A [64][DH] tile as an MN-major operand (read transposed): rows
// [16kk, 16kk + 16) are K, its DH columns are N, 64 of them per sub-tile.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, kSubBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of wgmma are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes across the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
  }
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
  }
}

// d (64 x 64 fp32) += A (64 x 16, K-major in shared memory, descriptor da) *
// B (16 x 64, K-major in shared memory, descriptor db).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers a: the m16n8k16 A fragment of
// each warp's 16 rows) * B (16 x 64, MN-major in shared memory, descriptor db).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers a: the m16n8k16 A fragment of
// each warp's 16 rows) * B (16 x 128, MN-major in shared memory, descriptor db).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 8][4], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// s = A1.B1^T and d = A2.B2^T, 64 x 64 each over depth DH, every operand a
// [64][DH] tile in shared memory read K-major: issued and committed as two
// groups, s's first, not waited for.
template <int DH>
__device__ __forceinline__ void issue_pair(float (&s)[8][4], float (&d)[8][4], uint32_t a1,
                                           uint32_t b1, uint32_t a2, uint32_t b2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = d[j][e] = 0.f;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(s, desc_kmajor(a1, kk), desc_kmajor(b1, kk));
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(d, desc_kmajor(a2, kk), desc_kmajor(b2, kk));
  wgmma_commit();
}

// acc += A.B for A 64 x 64 as register fragments and B the [64][DH] tile at
// `b` read MN-major (its 64 rows are the depth); issued, not committed.
template <int DH>
__device__ __forceinline__ void issue_rs(float (&acc)[DH / 8][4], const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(acc, a[kk], desc_mnmajor(b, kk));
}

// Pre-pass of both directions: q' = bf16(sm_scale * rot(q)) and, with RoPE
// compiled in, k' = bf16(rot(k)) into head-major scratch (B, H, N, DH),
// rotated in fp32; in the backward (DELTA) also delta = rowsum(dO * O),
// fp32 (B, H, N). A thread takes 8 values of each half of one (row, head);
// the DH / 16 threads of a (row, head) are adjacent lanes.
template <int DH, class V, bool DELTA>
__device__ __forceinline__ void prep(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ g, const bf16* __restrict__ o,
                                     long long q_bs, long long q_rs, long long k_bs,
                                     long long k_rs, long long g_bs, long long g_rs,
                                     long long o_bs, long long o_rs, const float* __restrict__ cos,
                                     const float* __restrict__ sin, bf16* __restrict__ qs,
                                     bf16* __restrict__ ks, float* __restrict__ delta, int batch,
                                     int n, int heads, int rope_heads, float sm_scale) {
  constexpr bool ROPE = V::kRope;
  constexpr int kHalf = DH / 2;
  constexpr int kChunks = kHalf / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  const bool live = idx < static_cast<long long>(batch) * n * heads * kChunks;
  const int c = static_cast<int>(idx % kChunks) * 8;
  const long long rest = idx / kChunks;
  const int h = static_cast<int>(rest % heads);
  const int pos = static_cast<int>((rest / heads) % n);
  const int b = static_cast<int>(rest / (static_cast<long long>(heads) * n));
  const long long hd = static_cast<long long>(h) * DH + c;
  const long long dst = ((static_cast<long long>(b) * heads + h) * n + pos) * DH + c;
  const bool rope = ROPE && h < rope_heads;

  auto rotate = [&](bf16* out, const bf16* src, float scale) {
    const uint4 a = *reinterpret_cast<const uint4*>(src);
    const uint4 bb = *reinterpret_cast<const uint4*>(src + kHalf);
    const bf16* ea = reinterpret_cast<const bf16*>(&a);
    const bf16* eb = reinterpret_cast<const bf16*>(&bb);
    float lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lo[i] = __bfloat162float(ea[i]);
      hi[i] = __bfloat162float(eb[i]);
    }
    if (rope) {
      const float* cr = cos + static_cast<long long>(pos) * DH;
      const float* sr = sin + static_cast<long long>(pos) * DH;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x1 = lo[i], x2 = hi[i];
        lo[i] = x1 * __ldg(cr + c + i) - x2 * __ldg(sr + c + i);
        hi[i] = x2 * __ldg(cr + c + i + kHalf) + x1 * __ldg(sr + c + i + kHalf);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lo[i] *= scale;
      hi[i] *= scale;
    }
    uint4 pa, pb;
    pa.x = pack_bf16x2(lo[0], lo[1]);
    pa.y = pack_bf16x2(lo[2], lo[3]);
    pa.z = pack_bf16x2(lo[4], lo[5]);
    pa.w = pack_bf16x2(lo[6], lo[7]);
    pb.x = pack_bf16x2(hi[0], hi[1]);
    pb.y = pack_bf16x2(hi[2], hi[3]);
    pb.z = pack_bf16x2(hi[4], hi[5]);
    pb.w = pack_bf16x2(hi[6], hi[7]);
    *reinterpret_cast<uint4*>(out) = pa;
    *reinterpret_cast<uint4*>(out + kHalf) = pb;
  };

  if (live) {
    rotate(qs + dst, q + b * q_bs + pos * q_rs + hd, sm_scale);
    if (ROPE) rotate(ks + dst, k + b * k_bs + pos * k_rs + hd, 1.f);
  }
  if (!DELTA) return;
  float acc = 0.f;
  if (live) {
    const bf16* gp = g + b * g_bs + pos * g_rs + hd;
    const bf16* op = o + b * o_bs + pos * o_rs + hd;
#pragma unroll
    for (int half = 0; half < DH; half += kHalf) {
      const uint4 gv = *reinterpret_cast<const uint4*>(gp + half);
      const uint4 ov = *reinterpret_cast<const uint4*>(op + half);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += __bfloat162float(ge[i]) * __bfloat162float(oe[i]);
    }
  }
#pragma unroll
  for (int off = 1; off < kChunks; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && c == 0) delta[(static_cast<long long>(b) * heads + h) * n + pos] = acc;
}

// The forward's pre-pass: q' and, with RoPE, k'.
template <int DH, class V>
__global__ void __launch_bounds__(kPrepThreads) attention_fwd_prep_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, const float* __restrict__ cos, const float* __restrict__ sin,
    bf16* __restrict__ qs, bf16* __restrict__ ks, int batch, int n, int heads, int rope_heads,
    float sm_scale) {
  prep<DH, V, false>(q, k, nullptr, nullptr, q_bs, q_rs, k_bs, k_rs, 0, 0, 0, 0, cos, sin, qs, ks,
                     nullptr, batch, n, heads, rope_heads, sm_scale);
}

// The backward's pre-pass: q', with RoPE k', and delta.
template <int DH, class V>
__global__ void __launch_bounds__(kPrepThreads) attention_bwd_prep_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ g,
    const bf16* __restrict__ o, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long g_bs, long long g_rs, long long o_bs, long long o_rs,
    const float* __restrict__ cos, const float* __restrict__ sin, bf16* __restrict__ qs,
    bf16* __restrict__ ks, float* __restrict__ delta, int batch, int n, int heads,
    int rope_heads, float sm_scale) {
  prep<DH, V, true>(q, k, g, o, q_bs, q_rs, k_bs, k_rs, g_bs, g_rs, o_bs, o_rs, cos, sin, qs, ks,
                    delta, batch, n, heads, rope_heads, sm_scale);
}

// Forward, main kernel: the output of 64 * fwd_groups query rows of one
// head. The last warp loads the block's q' tiles once and streams the live
// (K', V) tiles through a ring of kStages; each consumer warpgroup owns 64
// rows.
template <int DH, class V>
__global__ void __launch_bounds__(fwd_groups<DH>() * 128 + 32, 1) attention_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ lens, int n_audio,
    bf16* __restrict__ out, float* __restrict__ row_max, float* __restrict__ row_linv, int n,
    int heads) {
  constexpr bool ROPE = V::kRope;
  constexpr int MASK = V::kMask;
  constexpr int WG = fwd_groups<DH>();
  constexpr int TILE = tile_bytes<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;  // q' tiles, one per warpgroup
  const uint32_t ring = sq + WG * TILE;                   // kStages x (K' tile, V tile)
  const uint32_t bars = ring + kStages * 2 * TILE;        // q', full[kStages], empty[kStages]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int q0 = blockIdx.x * kRows * WG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lens[b];
  // dead tiles hold probabilities of exactly 0: the prefix rule's lie at or
  // past len, where the loop ends; the joint rule's inside [len, n_audio)
  const int kv_end = (MASK == kMaskPrefix && len > 0) ? min(len, n) : n;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(bars, WG * TILE);
      for (int w = 0; w < WG; ++w)
        load_tile<DH>(sq + w * TILE, tm_q, true, bars, q0 + w * kRows, h, b, heads);
      int it = 0;
      for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
        if (MASK != kMaskPrefix && tile_dead<MASK>(k0, len, n_audio, n)) continue;
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
        const uint32_t dst = ring + s * 2 * TILE;
        mbar_expect_tx(full(s), 2 * TILE);
        load_tile<DH>(dst, tm_k, ROPE, full(s), k0, h, b, heads);
        load_tile<DH>(dst + TILE, tm_v, false, full(s), k0, h, b, heads);
        ++it;
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int wr = (warp & 3) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + wg * kRows + wr + g;  // this thread's rows
  const int r1 = r0 + 8;
  const uint32_t qt = sq + wg * TILE;

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0 and r1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their running sums
  // P of the tile before as bf16 A fragments, its V tile and its stage,
  // released once P.V is done; before the first tile P = 0, which adds
  // nothing, over the first tile's V (stage 0)
  uint32_t pa[kBlockK / 16][4] = {};
  uint32_t vt = ring + TILE;
  int held = -1;
  mbar_wait(bars, 0);
  __syncwarp();

  int it = 0;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    if (MASK != kMaskPrefix && tile_dead<MASK>(k0, len, n_audio, n)) continue;
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    __syncwarp();
    const uint32_t kt = ring + s * 2 * TILE;

    // S = q' K'^T, then O += P V of the tile before: two groups, so this
    // tile's softmax runs while P V is on the tensor cores
    float sc[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(sc, desc_kmajor(qt, kk), desc_kmajor(kt, kk));
    wgmma_commit();
    issue_rs<DH>(o, pa, vt);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // column c of the tile is key k0 + c: past n not a key at all (-inf),
    // masked -1e30; only a tile on an edge of the valid columns is masked,
    // with selects, not a branch per element
    const int c_n = n - k0, c_len = len - k0, c_audio = n_audio - k0;
    const bool edge = MASK == kMaskPrefix
                          ? kBlockK > min(c_len, c_n)
                          : !(kBlockK <= c_n && (kBlockK <= c_len || c_audio <= 0));
    float tm0 = -INFINITY, tm1 = -INFINITY;
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          const bool valid = MASK == kMaskPrefix ? c < c_len : (c < c_len || c >= c_audio);
          sc[j][e] = c >= c_n ? -INFINITY : (valid ? sc[j][e] : kMaskValue);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      tm0 = fmaxf(tm0, fmaxf(sc[j][0], sc[j][1]));
      tm1 = fmaxf(tm1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
    }
    // every tile holds a key < n, so the new max is finite
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p = 2^(s log2(e) - m log2(e)): one FFMA and one ex2 a score. A row
    // whose keys are all masked so far (max -1e30) takes the scale 0, so each
    // of its masked keys gives exactly 1, as exp(s - m) does; its keys past n
    // (-inf * 0) are set to 0 below.
    const float e0 = mn0 == kMaskValue ? 0.f : kLog2e, e1 = mn1 == kMaskValue ? 0.f : kLog2e;
    const float b0 = -mn0 * e0, b1 = -mn1 * e1;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      sc[j][0] = ex2_approx(fmaf(sc[j][0], e0, b0));
      sc[j][1] = ex2_approx(fmaf(sc[j][1], e0, b0));
      sc[j][2] = ex2_approx(fmaf(sc[j][2], e1, b1));
      sc[j][3] = ex2_approx(fmaf(sc[j][3], e1, b1));
    }
    if (c_n < kBlockK) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = j * 8 + 2 * t + (e & 1) < c_n ? sc[j][e] : 0.f;
      }
    }
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      ls0 += sc[j][0] + sc[j][1];
      ls1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;

    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (held >= 0) mbar_arrive(empty(held));
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
    acc_to_a(pa, sc);
    held = s;
    vt = kt + TILE;
    ++it;
  }
  // the last tile's P V. The loop ran at least once, so vt is a loaded V
  // tile: tile_dead skips no tile of a row whose keys are all masked (the
  // joint rule's len 0 with no text included), and a row with a valid key
  // has a live tile.
  wgmma_fence();
  issue_rs<DH>(o, pa, vt);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* o0 = out + (static_cast<long long>(b) * n + r0) * heads * DH + static_cast<long long>(h) * DH;
  bf16* o1 = o0 + 8LL * heads * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n) *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16x2(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < n) *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16x2(o[j][2] * inv1, o[j][3] * inv1);
  }
  if (row_max != nullptr && t == 0) {
    const long long stat = (static_cast<long long>(b) * heads + h) * n;
    if (r0 < n) {
      row_max[stat + r0] = m0;
      row_linv[stat + r0] = inv0;
    }
    if (r1 < n) {
      row_max[stat + r1] = m1;
      row_linv[stat + r1] = inv1;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Backward, kernel 1: dQ of 64 * dq_groups query rows of one head. The last
// warp loads the block's q' and dO tiles once and streams the live (K', V)
// tiles through a ring of kStages; each consumer warpgroup owns 64 rows.
template <int DH, class V>
__global__ void __launch_bounds__(dq_groups<DH>() * 128 + 32, 1) attention_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
    const int* __restrict__ lens, int n_audio, const float* __restrict__ cos,
    const float* __restrict__ sin, const float* __restrict__ row_max,
    const float* __restrict__ row_linv, const float* __restrict__ delta, bf16* __restrict__ dq,
    int n, int heads, int rope_heads, float sm_scale) {
  constexpr bool ROPE = V::kRope;
  constexpr int MASK = V::kMask;
  constexpr int WG = dq_groups<DH>();
  constexpr int TILE = tile_bytes<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;  // q' tiles, one per warpgroup
  const uint32_t sg = sq + WG * TILE;                     // dO tiles
  const uint32_t ring = sg + WG * TILE;                   // kStages x (K' tile, V tile)
  const uint32_t bars = ring + kStages * 2 * TILE;        // q'/dO, full[kStages], empty[kStages]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int q0 = blockIdx.x * kRows * WG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lens[b];
  const int kv_end = (MASK == kMaskPrefix && len > 0) ? min(len, n) : n;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(bars, 2 * WG * TILE);
      for (int w = 0; w < WG; ++w) {
        load_tile<DH>(sq + w * TILE, tm_q, true, bars, q0 + w * kRows, h, b, heads);
        load_tile<DH>(sg + w * TILE, tm_g, false, bars, q0 + w * kRows, h, b, heads);
      }
      int it = 0;
      for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
        if (MASK != kMaskPrefix && tile_dead<MASK>(k0, len, n_audio, n)) continue;
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
        const uint32_t dst = ring + s * 2 * TILE;
        mbar_expect_tx(full(s), 2 * TILE);
        load_tile<DH>(dst, tm_k, ROPE, full(s), k0, h, b, heads);
        load_tile<DH>(dst + TILE, tm_v, false, full(s), k0, h, b, heads);
        ++it;
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int wr = (warp & 3) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool rope = ROPE && h < rope_heads;
  const int r0 = q0 + wg * kRows + wr + g;
  const int r1 = r0 + 8;
  const long long stat = (static_cast<long long>(b) * heads + h) * n;
  const float mx0 = r0 < n ? row_max[stat + r0] : 0.f, mx1 = r1 < n ? row_max[stat + r1] : 0.f;
  const float li0 = r0 < n ? row_linv[stat + r0] : 0.f, li1 = r1 < n ? row_linv[stat + r1] : 0.f;
  const float dl0 = r0 < n ? delta[stat + r0] : 0.f, dl1 = r1 < n ? delta[stat + r1] : 0.f;
  const uint32_t qt = sq + wg * TILE, gt = sg + wg * TILE;

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  mbar_wait(bars, 0);
  __syncwarp();

  int it = 0;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    if (MASK != kMaskPrefix && tile_dead<MASK>(k0, len, n_audio, n)) continue;
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    __syncwarp();
    const uint32_t kt = ring + s * 2 * TILE, vt = kt + TILE;

    // S = q' K'^T, then dP = dO V^T: 64 rows x 64 keys per warpgroup, two
    // groups, so P = exp(S - m) * linv is formed while dP is still running
    float sc[kBlockK / 8][4], dp[kBlockK / 8][4];
    issue_pair<DH>(sc, dp, qt, kt, gt, vt);
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = __expf(sc[j][e] - (e < 2 ? mx0 : mx1)) * (e < 2 ? li0 : li1);  // P
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta) at the valid keys, 0 elsewhere: column c of the
    // tile is key k0 + c; selects, not a branch per element
    const int c_n = n - k0, c_len = len - k0, c_audio = n_audio - k0;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const bool valid =
            c < c_n && (MASK == kMaskPrefix ? c < c_len : (c < c_len || c >= c_audio));
        sc[j][e] = valid ? sc[j][e] * (dp[j][e] - (e < 2 ? dl0 : dl1)) : 0.f;
      }
    }
    // dQ += dS K': dS as register A fragments, K' read transposed
    uint32_t da[kBlockK / 16][4];
    acc_to_a(da, sc);
    wgmma_fence();
    issue_rs<DH>(acc, da, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    mbar_arrive(empty(s));
    ++it;
  }

#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= sm_scale;
  }
  if (rope) rope_adjoint<DH>(acc, r0, r1, n, cos, sin);
  bf16* d0 = dq + (static_cast<long long>(b) * n + r0) * heads * DH + static_cast<long long>(h) * DH;
  bf16* d1 = d0 + 8LL * heads * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n) *reinterpret_cast<uint32_t*>(d0 + col) = pack_bf16x2(acc[j][0], acc[j][1]);
    if (r1 < n) *reinterpret_cast<uint32_t*>(d1 + col) = pack_bf16x2(acc[j][2], acc[j][3]);
  }
}

// Backward, kernel 2: dK and dV of 64 * dkdv_groups keys of one head. The
// last warp loads the block's K' and V tiles once and streams every q-tile
// (q', dO, and the rows' m, linv, delta) through a ring of kStages; each
// consumer warpgroup owns 64 keys.
template <int DH, class V>
__global__ void __launch_bounds__(dkdv_groups<DH>() * 128 + 32, 1) attention_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
    const int* __restrict__ lens, int n_audio, const float* __restrict__ cos,
    const float* __restrict__ sin, const float* __restrict__ row_max,
    const float* __restrict__ row_linv, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n, int heads, int rope_heads) {
  constexpr bool ROPE = V::kRope;
  constexpr int MASK = V::kMask;
  constexpr int WG = dkdv_groups<DH>();
  constexpr int TILE = tile_bytes<DH>();
  constexpr int STAGE = 2 * TILE + 1024;  // q' tile, dO tile, m / linv / delta of its 64 rows
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sk = (smem_u32(smem) + 1023) & ~1023u;  // K' tiles, one per warpgroup
  const uint32_t sv = sk + WG * TILE;                     // V tiles
  const uint32_t ring = sv + WG * TILE;                   // kStages x STAGE
  const uint32_t bars = ring + kStages * STAGE;           // K'/V, full[kStages], empty[kStages]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto stats = [&](int s) {
    return reinterpret_cast<float*>(smem + (ring + s * STAGE + 2 * TILE - smem_u32(smem)));
  };

  const int k0 = blockIdx.x * kRows * WG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lens[b];
  // a block whose key tiles (those < n) are all dead gets dK = dV = 0,
  // exactly what their zero probabilities give
  bool dead = true;
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    const int kt = k0 + w * kRows;
    if (kt < n && !tile_dead<MASK>(kt, len, n_audio, n)) dead = false;
  }
  if (threadIdx.x == 0 && !dead) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {  // producer
    if (dead) return;
    const long long stat = (static_cast<long long>(b) * heads + h) * n;
    if (lane == 0) {
      mbar_expect_tx(bars, 2 * WG * TILE);
      for (int w = 0; w < WG; ++w) {
        load_tile<DH>(sk + w * TILE, tm_k, ROPE, bars, k0 + w * kRows, h, b, heads);
        load_tile<DH>(sv + w * TILE, tm_v, false, bars, k0 + w * kRows, h, b, heads);
      }
    }
    int it = 0;
    for (int q0 = 0; q0 < n; q0 += kRows, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
      float* st = stats(s);
      for (int i = lane; i < kRows; i += 32) {
        const int row = q0 + i;
        st[i] = row < n ? row_max[stat + row] : 0.f;
        st[kRows + i] = row < n ? row_linv[stat + row] : 0.f;  // rows past n: p = 0
        st[2 * kRows + i] = row < n ? delta[stat + row] : 0.f;
      }
      if (lane == 0) {
        const uint32_t dst = ring + s * STAGE;
        mbar_expect_tx(full(s), 2 * TILE);
        load_tile<DH>(dst, tm_q, true, full(s), q0, h, b, heads);
        load_tile<DH>(dst + TILE, tm_g, false, full(s), q0, h, b, heads);
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int wr = (warp & 3) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool rope = ROPE && h < rope_heads;
  const int r0 = k0 + wg * kRows + wr + g;  // this thread's key rows
  const int r1 = r0 + 8;
  const long long hd = static_cast<long long>(h) * DH;

  float ak[DH / 8][4], av[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;
  }

  if (!dead) {
    const bool valid0 = col_valid<MASK>(r0, len, n_audio);
    const bool valid1 = col_valid<MASK>(r1, len, n_audio);
    const uint32_t kt = sk + wg * TILE, vt = sv + wg * TILE;
    mbar_wait(bars, 0);
    __syncwarp();
    int it = 0;
    for (int q0 = 0; q0 < n; q0 += kRows, ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      __syncwarp();
      const uint32_t qt = ring + s * STAGE, gt = qt + TILE;
      const float* m_s = stats(s);
      const float* l_s = m_s + kRows;
      const float* d_s = l_s + kRows;

      // S^T = K' q'^T and dP^T = V dO^T: 64 keys x 64 queries per warpgroup
      float st[kRows / 8][4], dpt[kRows / 8][4];
      issue_pair<DH>(st, dpt, kt, qt, vt, gt);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);  // query within the tile
          const bool valid = e < 2 ? valid0 : valid1;
          const float p = __expf((valid ? st[j][e] : kMaskValue) - m_s[qi]) * l_s[qi];
          st[j][e] = p;
          dpt[j][e] = valid ? p * (dpt[j][e] - d_s[qi]) : 0.f;  // dS^T
        }
      }
      // dV += P^T dO and dK += dS^T q': P^T and dS^T as register A
      // fragments, dO and q' read transposed
      uint32_t pa[kRows / 16][4], da[kRows / 16][4];
      acc_to_a(pa, st);
      acc_to_a(da, dpt);
      wgmma_fence();
      issue_rs<DH>(av, pa, gt);
      issue_rs<DH>(ak, da, qt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(av);
      fence_regs(ak);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(empty(s));
    }
    if (rope) rope_adjoint<DH>(ak, r0, r1, n, cos, sin);
  }

  bf16* k0p = dk + (static_cast<long long>(b) * n + r0) * heads * DH + hd;
  bf16* k1p = k0p + 8LL * heads * DH;
  bf16* v0p = dv + (static_cast<long long>(b) * n + r0) * heads * DH + hd;
  bf16* v1p = v0p + 8LL * heads * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(k0p + col) = pack_bf16x2(ak[j][0], ak[j][1]);
      *reinterpret_cast<uint32_t*>(v0p + col) = pack_bf16x2(av[j][0], av[j][1]);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(k1p + col) = pack_bf16x2(ak[j][2], ak[j][3]);
      *reinterpret_cast<uint32_t*>(v1p + col) = pack_bf16x2(av[j][2], av[j][3]);
    }
  }
}

template <int DH>
constexpr int dq_smem() {  // 1 KB to align the tiles, the tiles, the barriers
  return 1024 + (2 * dq_groups<DH>() + 2 * kStages) * tile_bytes<DH>() + 8 * (1 + 2 * kStages);
}

template <int DH>
constexpr int dkdv_smem() {
  return 1024 + 2 * dkdv_groups<DH>() * tile_bytes<DH>() +
         kStages * (2 * tile_bytes<DH>() + 1024) + 8 * (1 + 2 * kStages);
}

template <int DH>
constexpr int fwd_smem() {  // 1 KB to align the tiles, the tiles, the barriers
  return 1024 + (fwd_groups<DH>() + 2 * kStages) * tile_bytes<DH>() + 8 * (1 + 2 * kStages);
}

// What one forward or backward call passes. q/k/v, and g (= dO) and o (the
// forward's output) in the backward: device pointers to (B, N, H, dh) bf16
// with the given batch and row strides (elements), head stride dh,
// contiguous last axis, 16-byte aligned rows and batches. lens (B,) int32;
// n_audio only for the joint rule; cos/sin (N, dh) fp32 contiguous, null
// without RoPE. qs (and, with RoPE, ks) is (B, H, N, dh) bf16 scratch for q'
// (k'), written by the pre-pass of either direction. Forward: out (B, N, H,
// dh) bf16 contiguous; row_max/row_linv fp32 (B, H, N) to write the softmax
// statistics, or both null. Backward: row_max/row_linv hold the forward's
// statistics; delta fp32 (B, H, N) scratch, written by the pre-pass;
// dq/dk/dv are (B, N, H, dh) bf16 contiguous.
struct Operands {
  const void *q, *k, *v, *g, *o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, o_bs, o_rs;
  const void* lens;
  int n_audio;
  const void *cos, *sin;
  void *out, *row_max, *row_linv, *qs, *ks, *delta, *dq, *dk, *dv;
  int batch, n, heads, dh, rope_heads;
  float sm_scale;
  cudaStream_t stream;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link
// to libcuda); null where it is missing.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map of [64 rows][64 columns] boxes with 128-byte swizzle over one
// bf16 operand (see load_tile): head-major scratch (B, H, N, dh), or
// (B, N, H, dh) in place through batch and row strides bs, rs (elements).
bool tile_map(CUtensorMap* map, const void* ptr, bool head_major, long long bs, long long rs,
              const Operands& a) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[3], strides[2];
  if (head_major) {
    dims[0] = a.dh, dims[1] = a.n, dims[2] = static_cast<cuuint64_t>(a.batch) * a.heads;
    strides[0] = 2ULL * a.dh, strides[1] = 2ULL * a.n * a.dh;
  } else {
    dims[0] = static_cast<cuuint64_t>(a.heads) * a.dh, dims[1] = a.n, dims[2] = a.batch;
    strides[0] = 2ULL * rs, strides[1] = 2ULL * (a.batch > 1 ? bs : a.n * rs);
  }
  const cuuint32_t box[3] = {64, kRows, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DH, class V>
int launch_fwd(const Operands& a) {
  typedef const bf16* cb;
  const long long items = static_cast<long long>(a.batch) * a.n * a.heads * (DH / 16);
  attention_fwd_prep_kernel<DH, V>
      <<<static_cast<unsigned>((items + kPrepThreads - 1) / kPrepThreads), kPrepThreads, 0,
         a.stream>>>(static_cast<cb>(a.q), static_cast<cb>(a.k), a.q_bs, a.q_rs, a.k_bs, a.k_rs,
                     static_cast<const float*>(a.cos), static_cast<const float*>(a.sin),
                     static_cast<bf16*>(a.qs), static_cast<bf16*>(a.ks), a.batch, a.n, a.heads,
                     a.rope_heads, a.sm_scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // the maps are encoded on the host at each launch and passed by value
  CUtensorMap tq, tk, tv;
  const bool mapped = tile_map(&tq, a.qs, true, 0, 0, a) &&
                      tile_map(&tk, V::kRope ? a.ks : a.k, V::kRope, a.k_bs, a.k_rs, a) &&
                      tile_map(&tv, a.v, false, a.v_bs, a.v_rs, a);
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(
      attention_fwd_kernel<DH, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<DH>());
  if (set != cudaSuccess) return static_cast<int>(set);
  const int rows = kRows * fwd_groups<DH>();
  const dim3 grid((a.n + rows - 1) / rows, a.heads, a.batch);
  attention_fwd_kernel<DH, V><<<grid, fwd_groups<DH>() * 128 + 32, fwd_smem<DH>(), a.stream>>>(
      tq, tk, tv, static_cast<const int*>(a.lens), a.n_audio, static_cast<bf16*>(a.out),
      static_cast<float*>(a.row_max), static_cast<float*>(a.row_linv), a.n, a.heads);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, class V>
int launch_bwd(const Operands& a) {
  typedef const bf16* cb;
  typedef const float* cf;
  const int* lens = static_cast<const int*>(a.lens);
  const long long items = static_cast<long long>(a.batch) * a.n * a.heads * (DH / 16);
  attention_bwd_prep_kernel<DH, V>
      <<<static_cast<unsigned>((items + kPrepThreads - 1) / kPrepThreads), kPrepThreads, 0,
         a.stream>>>(static_cast<cb>(a.q), static_cast<cb>(a.k), static_cast<cb>(a.g),
                     static_cast<cb>(a.o), a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.g_bs, a.g_rs, a.o_bs,
                     a.o_rs, static_cast<cf>(a.cos), static_cast<cf>(a.sin),
                     static_cast<bf16*>(a.qs), static_cast<bf16*>(a.ks),
                     static_cast<float*>(a.delta), a.batch, a.n, a.heads, a.rope_heads,
                     a.sm_scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // the maps are encoded on the host at each launch and passed by value
  CUtensorMap tq, tk, tv, tg;
  const bool mapped = tile_map(&tq, a.qs, true, 0, 0, a) &&
                      tile_map(&tk, V::kRope ? a.ks : a.k, V::kRope, a.k_bs, a.k_rs, a) &&
                      tile_map(&tv, a.v, false, a.v_bs, a.v_rs, a) &&
                      tile_map(&tg, a.g, false, a.g_bs, a.g_rs, a);
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  // dynamic shared memory above 48 KB is opt-in, per kernel and per device:
  // set on every launch (a cheap host call), so any current device is ready
  cudaError_t set = cudaFuncSetAttribute(attention_bwd_dq_kernel<DH, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_smem<DH>());
  if (set == cudaSuccess)
    set = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<DH, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<DH>());
  if (set != cudaSuccess) return static_cast<int>(set);

  const int rows_q = kRows * dq_groups<DH>();
  const dim3 grid_q((a.n + rows_q - 1) / rows_q, a.heads, a.batch);
  attention_bwd_dq_kernel<DH, V><<<grid_q, dq_groups<DH>() * 128 + 32, dq_smem<DH>(), a.stream>>>(
      tq, tk, tv, tg, lens, a.n_audio, static_cast<cf>(a.cos), static_cast<cf>(a.sin),
      static_cast<cf>(a.row_max), static_cast<cf>(a.row_linv), static_cast<cf>(a.delta),
      static_cast<bf16*>(a.dq), a.n, a.heads, a.rope_heads, a.sm_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rows_k = kRows * dkdv_groups<DH>();
  const dim3 grid_k((a.n + rows_k - 1) / rows_k, a.heads, a.batch);
  attention_bwd_dkdv_kernel<DH, V>
      <<<grid_k, dkdv_groups<DH>() * 128 + 32, dkdv_smem<DH>(), a.stream>>>(
          tq, tk, tv, tg, lens, a.n_audio, static_cast<cf>(a.cos), static_cast<cf>(a.sin),
          static_cast<cf>(a.row_max), static_cast<cf>(a.row_linv), static_cast<cf>(a.delta),
          static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n, a.heads, a.rope_heads);
  return static_cast<int>(cudaGetLastError());
}

// The forward of variant V: the pre-pass, then the main kernel, on
// `a.stream`; cudaGetLastError() after them, or cudaErrorInvalidValue for
// operands the kernels do not take.
template <class V>
int attention_forward(const Operands& a) {
  if (a.batch <= 0 || a.n <= 0 || a.heads <= 0 || a.qs == nullptr ||
      (V::kRope && a.ks == nullptr) || (a.row_max == nullptr) != (a.row_linv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh == 64) return launch_fwd<64, V>(a);
  if (a.dh == 128) return launch_fwd<128, V>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of variant V: the pre-pass, the dq kernel, then the dkdv
// kernel, on `a.stream`; cudaGetLastError() after them, or
// cudaErrorInvalidValue for operands the kernels do not take.
template <class V>
int attention_backward(const Operands& a) {
  if (a.batch <= 0 || a.n <= 0 || a.heads <= 0 || a.qs == nullptr ||
      (V::kRope && a.ks == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh == 64) return launch_bwd<64, V>(a);
  if (a.dh == 128) return launch_bwd<128, V>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
