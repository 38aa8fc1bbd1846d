// The fp32 members of the attention kernel family: the forward (pre-pass +
// main kernel) and the backward (pre-pass, dq kernel, dk/dv kernel) of
// attention_core.cuh for fp32 operands, over the same variants V (RoPE in or
// out with rotated heads h < rope_heads; the prefix or the joint column rule)
// and head widths dh in {64, 128}. They replace, on fp32 operands, the TPU
// kernels the three .cu files name (f5e_tts_tpu/ops/pallas_attention.py:
// K1/K3/K11a and K4/K6/K11b through rope_attention.cu, K9/K10 through
// masked_attention.cu, K7/K8 through joint_attention.cu). The TPU kernels
// take any element type: their outputs take the operands' dtype, so a model
// run with compute_dtype float32 runs fp32 attention through them, and here.
//
// What they compute is the bf16 kernels' function with no bf16 rounding:
// q' = sm_scale * rot(q) and k' = rot(k) in fp32, scores q'.k'^T with masked
// columns at -1e30 and columns past N at -inf, P = exp(s - m) in fp32 (not
// rounded before P.V), out = (P.V) / max(l, 1e-30); the forward writes the
// row statistics (m, linv = 1 / max(l, 1e-30)) that the backward takes; the
// backward forms dS = P (dP - delta) with delta = rowsum(dO * O), 0 at masked
// keys, dV = P^T dO, dQ = rot^T(sm_scale dS k'), dK = rot^T(dS^T q'), each
// written in fp32. A row whose keys are all masked comes out as the uniform
// average, as in bf16. Dead key tiles are skipped, no atomics (two runs give
// the same bits), q/k/v read through batch and row strides.
//
// Arithmetic: three-pass TF32 on wgmma. Each fp32 operand x is split as
// hi = tf32(x), lo = tf32(x - hi) (cvt.rna: 10 explicit mantissa bits, so
// |x - hi| <= 2^-11 |x| and |x - hi - lo| <= 2^-22 |x|), and a product as
//     a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
// in three wgmma passes (m64nNk8 .tf32, products exact in the fp32
// accumulator) into one fp32 accumulator, the two small terms first. The
// dropped lo_a.lo_b and the splits' residues are <= ~2^-21 |a||b| a term,
// fp32-level next to the summation's own rounding; one pass (hi.hi) or two
// (a cross term dropped) leave ~2^-11 relative, above the fp32 tolerances
// these kernels are held to (chip_smoke.py: FP32_ATOL, FP32_RTOL,
// FP32_BWD_REL; tests/test_torch_tf32_split.py emulates the three on the
// CPU). P and dS are split in registers.
//
// Bound on this card: operations, at the three-pass TF32 rate, 495 / 3 =
// 165 TFLOP/s dense (the fp32 FMA pipe outside the tensor cores gives 67).
// The products count 2 (forward) or 5 (backward) N x keys x dh products
// per head; the kernels run 2 and 7, the backward recomputing S and dP in
// both kernels (no atomics), at 3 passes each.
//
// Layout rule. wgmma reads a .tf32 operand from shared memory only K-major
// (the transposing descriptor the bf16 kernels use for V, K', dO and q' is
// for 16-bit types), and an A operand from registers in the fragment
// acc_to_a_tf32 describes. S = q'.K'^T, dP = dO.V^T, S^T = K'.q'^T and
// dP^T = V.dO^T read their operands K-major as rows are stored; P.V, dS.K',
// P^T.dO and dS^T.q' take P, dS (and their transposes) from registers and
// need V, K', dO and q' K-major along the sequence. So the pre-pass writes,
// once per call, every operand the products read, split into hi and lo, in
// head-major fp32 scratch: row layouts (B, H, N, dh) and, for those four,
// column layouts (B, H, dh, N) whose columns run in eights in the order the
// register fragments take their k (key 2e in slot e < 4, 2(e - 4) + 1 in
// slot e >= 4), so P and dS enter wgmma straight from the accumulators.
// The forward's scratch is q', k' rows and v columns (~6 B H N dh fp32);
// the backward's q', k', v, dO rows and q', k', dO columns (~14).
//
// Pipeline, as the bf16 kernels': a producer warp streams tiles with TMA
// through a ring under full and empty mbarriers, consumer warpgroups of 64
// rows run the products and the online softmax (softmax_tile, probs,
// dscores, probs_t: the bf16 kernels' code), edge tiles masked with
// selects. Each tile holds both parts, so a tile is 4x the bf16 one:
//   forward: at dh 64 two warpgroups (128 query rows) a block and key tiles
//     of 64 through 2 stages (K' rows, V columns); at dh 128 one warpgroup,
//     key tiles of 32;
//   dq: at dh 64 two warpgroups (q' and dO rows held), key tiles of 64
//     through 1 stage (K' and V rows, K' columns; tiles of 32 through 2
//     stages ran ~8 % slower: N = 32 products); at dh 128 one warpgroup and
//     key tiles of 32;
//   dk/dv: at dh 64 two warpgroups of 64 keys (K' and V rows held), query
//     tiles of 32, each as two slots of the ring (q' and dO rows with the
//     rows' m, linv, delta for S^T and dP^T; then q' and dO columns for dV
//     and dK), 2 slots; at dh 128 one warpgroup and 1 slot.
// A warpgroup's loop is serial (products, wait, softmax and splits,
// products, wait) except that dq forms P while dP runs; at three passes a
// tile's products outweigh its softmax, and one block of one or two
// warpgroups fills an SM's shared memory. What holds the kernels above
// their bound (PERF.md, Findings): the serial loop, with too few
// warpgroups an SM to cover it (one dk/dv warpgroup and 4 slots ran ~10 %
// slower than two and 2), and in the dq kernel ptxas's serialization of
// the wgmma chain (its advisory C7520, which the bf16 dq kernel draws too;
// neither waiting for dP with S nor loading the row statistics without a
// branch removed it). Tried and dropped: the bf16 forward's overlap of a
// tile's softmax with the tile before's P.V (the hi and lo P fragments
// held across it spilled, and the main kernel ran ~30 % slower), and 3
// dk/dv slots with the statistics beside the ring (~2 % slower).

#pragma once

#include "attention_core.cuh"

namespace {

// ---------------------------------------------------------------------------
// Three-pass TF32: the split, the products and the operand tiles
// ---------------------------------------------------------------------------

// x rounded to tf32 (10 explicit mantissa bits, ties away from zero), as the
// fp32 value whose low 13 bits are 0.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u & 0xffffe000u);
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi); x - hi is
// exact in fp32.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// d (64 x 32 fp32) += A (64 x 8 tf32, K-major in shared memory, descriptor da) *
// B (8 x 32 tf32, K-major in shared memory, descriptor db).
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 8 tf32, K-major in shared memory, descriptor da) *
// B (8 x 64 tf32, K-major in shared memory, descriptor db).
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
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

// d (64 x 64 fp32) += A (64 x 8 tf32, registers a: the fragment of each warp's 16
// rows, see acc_to_a_tf32) * B (8 x 64 tf32, K-major in shared memory, descriptor db).
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

// d (64 x 128 fp32) += A (64 x 8 tf32, registers a: the fragment of each warp's 16
// rows, see acc_to_a_tf32) * B (8 x 128 tf32, K-major in shared memory, descriptor db).
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db) {
  static_assert(N == 32 || N == 64, "S tiles are 32 or 64 wide");
  if constexpr (N == 32) {
    wgmma_tf32_ss_n32(d, da, db);
  } else {
    wgmma_tf32_ss_n64(d, da, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(N == 64 || N == 128, "output tiles are dh wide");
  if constexpr (N == 64) {
    wgmma_tf32_rs_n64(d, a, db);
  } else {
    wgmma_tf32_rs_n128(d, a, db);
  }
}

// Operand tiles in shared memory, 4 bytes a value, each the tf32 hi part of
// an operand and then its lo part, each part as 128-byte-swizzled
// sub-tiles of 32 values of the depth K (a wgmma k-step of 8 is 32 bytes):
//   a row tile [R][DH] (R rows, K = DH): DH / 32 sub-tiles of [R][32];
//   a column tile [DH][C] (DH rows, K = C columns): C / 32 sub-tiles of
//   [DH][32], its columns permuted in eights (see the pre-pass).
// Both parts of either are R * DH * 4 (DH * C * 4) bytes.

// Descriptor of k-step kk of a K-major tile whose sub-tiles are `sub` bytes.
__device__ __forceinline__ uint64_t desc_tf32(uint32_t tile, int kk, int sub) {
  return smem_desc(tile + (kk / 4) * sub + (kk % 4) * 32, 16, 1024);
}

// acc (64 x N) += A.B^T over depth K, A a row tile of 64 rows and B one of
// N rows: three passes into one accumulator, the small terms first (lo.hi,
// hi.lo, then hi.hi). Issued, not committed.
template <int N, int K>
__device__ __forceinline__ void issue_ss3(float (&acc)[N / 8][4], uint32_t a, uint32_t b) {
  constexpr int A_SUB = kRows * 128, A_PART = kRows * K * 4, B_SUB = N * 128, B_PART = N * K * 4;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_tf32_ss<N>(acc, desc_tf32(a + A_PART, kk, A_SUB), desc_tf32(b, kk, B_SUB));
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_tf32_ss<N>(acc, desc_tf32(a, kk, A_SUB), desc_tf32(b + B_PART, kk, B_SUB));
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_tf32_ss<N>(acc, desc_tf32(a, kk, A_SUB), desc_tf32(b, kk, B_SUB));
}

// acc (64 x DH) += P.B, P (64 x K) as the hi and lo register fragments of
// acc_to_a_tf32 and B the column tile [DH][K] at b: lo.hi, hi.lo, hi.hi.
// Issued, not committed.
template <int DH, int K>
__device__ __forceinline__ void issue_rs3(float (&acc)[DH / 8][4], const uint32_t (&hi)[K / 8][4],
                                          const uint32_t (&lo)[K / 8][4], uint32_t b) {
  constexpr int SUB = DH * 128, PART = DH * K * 4;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) wgmma_tf32_rs<DH>(acc, lo[kk], desc_tf32(b, kk, SUB));
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) wgmma_tf32_rs<DH>(acc, hi[kk], desc_tf32(b + PART, kk, SUB));
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) wgmma_tf32_rs<DH>(acc, hi[kk], desc_tf32(b, kk, SUB));
}

// The accumulators of a 64 x K tile as the tf32 A fragments of its K / 8
// k-steps, split into hi and lo. A thread holds columns 8j + 2t and
// 8j + 2t + 1 of rows g and g + 8 of its warp's 16; an A fragment holds
// k = t and t + 4 of the same rows. So k-step kk takes column 8kk + 2t as
// its k = t and 8kk + 2t + 1 as k = t + 4: no value changes thread, and the
// B operand's K runs in that order, which the column tiles' permutation
// gives.
template <int K>
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[K / 8][4], uint32_t (&lo)[K / 8][4],
                                              const float (&s)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float x[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split_tf32(x[e], h, l);
      hi[kk][e] = __float_as_uint(h);
      lo[kk][e] = __float_as_uint(l);
    }
  }
}

// Rows [row, row + R) of (batch, head) plane bh of a row layout (DH, N,
// 2 * planes: the hi planes, then the lo planes) into the row tile at dst.
template <int R, int DH>
__device__ __forceinline__ void load_row_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                              int row, int bh, int planes) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int s = 0; s < DH / 32; ++s)
      tma_load_3d(dst + part * R * DH * 4 + s * R * 128, &map, bar, s * 32, row,
                  part * planes + bh);
  }
}

// Columns [col, col + C) of plane bh of a column layout (NP, DH, 2 * planes)
// into the column tile at dst.
template <int C, int DH>
__device__ __forceinline__ void load_col_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                              int col, int bh, int planes) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int s = 0; s < C / 32; ++s)
      tma_load_3d(dst + part * DH * C * 4 + s * DH * 128, &map, bar, col + s * 32, 0,
                  part * planes + bh);
  }
}

// Tile shapes. Forward: WG warpgroups of 64 query rows a block, key tiles
// of KT through a ring of ST stages (K' row tile, V column tile).
template <int DH>
struct FwdF32 {
  static constexpr int WG = DH == 64 ? 2 : 1, KT = DH == 64 ? 64 : 32, ST = 2;
};
// dq: WG warpgroups of 64 query rows (q' and dO row tiles held), key tiles
// of KT through ST stages (K' and V row tiles, the K' column tile).
template <int DH>
struct DqF32 {
  static constexpr int WG = DH == 64 ? 2 : 1, KT = DH == 64 ? 64 : 32, ST = 1;
};
// dk/dv: WG warpgroups of 64 keys (K' and V row tiles held), query tiles of
// QT through a ring of NS slots, two a tile: (q' and dO row tiles, the
// tile's m, linv and delta), then (q' and dO column tiles).
template <int DH>
struct DkdvF32 {
  static constexpr int WG = DH == 64 ? 2 : 1, QT = 32, NS = DH == 64 ? 2 : 1;
};

template <int DH>
constexpr int fwd_f32_smem() {  // 1 KB to align the tiles, the tiles, the barriers
  typedef FwdF32<DH> C;
  return 1024 + C::WG * 2 * kRows * DH * 4 + C::ST * 4 * C::KT * DH * 4 + 8 * (1 + 2 * C::ST);
}
template <int DH>
constexpr int dq_f32_smem() {
  typedef DqF32<DH> C;
  return 1024 + C::WG * 4 * kRows * DH * 4 + C::ST * 6 * C::KT * DH * 4 + 8 * (1 + 2 * C::ST);
}
template <int DH>
constexpr int dkdv_f32_smem() {
  typedef DkdvF32<DH> C;
  return 1024 + C::WG * 4 * kRows * DH * 4 + C::NS * (4 * C::QT * DH * 4 + 1024) +
         8 * (1 + 2 * C::NS);
}
static_assert(fwd_f32_smem<64>() <= 232448 && fwd_f32_smem<128>() <= 232448, "shared memory");
static_assert(dq_f32_smem<64>() <= 232448 && dq_f32_smem<128>() <= 232448, "shared memory");
static_assert(dkdv_f32_smem<64>() <= 232448 && dkdv_f32_smem<128>() <= 232448, "shared memory");

// ---------------------------------------------------------------------------
// Pre-pass
// ---------------------------------------------------------------------------

// Where the pre-pass writes, in the one fp32 scratch buffer of a call: row
// layouts (2, B, H, N, dh) (the hi parts, then the lo parts), then column
// layouts (2, B, H, dh, NP), NP = N rounded up to 8, columns permuted in
// eights and 0 past N. Forward: q', k' rows, then v columns. Backward: q',
// k', v, dO rows, then q', k', dO columns. Unused entries are null.
struct LayoutF32 {
  float *q, *k, *v, *g, *qc, *kc, *vc, *gc;
  int np;
};

LayoutF32 layout_f32(const Operands& a, bool backward) {
  LayoutF32 s = {};
  s.np = (a.n + 7) / 8 * 8;
  const long long rows = 2LL * a.batch * a.heads * a.n * a.dh;
  const long long cols = 2LL * a.batch * a.heads * a.dh * s.np;
  float* p = static_cast<float*>(a.qs);
  s.q = p;
  s.k = p + rows;
  if (backward) {
    s.v = p + 2 * rows;
    s.g = p + 3 * rows;
    s.qc = p + 4 * rows;
    s.kc = s.qc + cols;
    s.gc = s.kc + cols;
  } else {
    s.vc = p + 2 * rows;
  }
  return s;
}

struct PrepF32 {
  const float *q, *k, *v, *g, *o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, o_bs, o_rs;
  const float *cos, *sin;
  LayoutF32 out;
  float* delta;
  int n, heads, rope_heads;
  float sm_scale;
};

// One block a (64 rows, head, batch): each operand's rows, rotated and
// scaled where asked (the bf16 pre-pass's fp32 arithmetic), split into
// tf32 hi and lo and written to their row layout and, through shared
// memory, to their column layout; in the backward (BWD) also delta =
// rowsum(dO * O).
template <int DH, class V, bool BWD>
__device__ __forceinline__ void prep_f32(const PrepF32& p) {
  constexpr int kHalf = DH / 2;
  __shared__ float tile[DH][kRows + 1];
  const int p0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z, n = p.n, np = p.out.np;
  const long long bh = static_cast<long long>(b) * p.heads + h;
  const long long planes = static_cast<long long>(gridDim.z) * p.heads;
  const long long row_part = planes * n * DH, col_part = planes * DH * np;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool rope = V::kRope && h < p.rope_heads;

  auto put = [](float* dst, long long part, float x) {
    float hi, lo;
    split_tf32(x, hi, lo);
    dst[0] = hi;
    dst[part] = lo;
  };
  // One operand (batch stride bs, row stride rs) into the row layout `rows`
  // and the column layout `cols`, either null.
  auto pass = [&](const float* src, long long bs, long long rs, bool rot, float scale,
                  float* rows, float* cols) {
    for (int r = warp; r < kRows; r += kPrepThreads / 32) {
      const int pos = p0 + r;
      for (int c = lane; c < kHalf; c += 32) {
        float x1 = 0.f, x2 = 0.f;  // rows past n: 0, which the column layout keeps
        if (pos < n) {
          const float* row = src + b * bs + pos * rs + static_cast<long long>(h) * DH;
          x1 = row[c];
          x2 = row[c + kHalf];
          if (rot) {
            const float* cr = p.cos + static_cast<long long>(pos) * DH;
            const float* sr = p.sin + static_cast<long long>(pos) * DH;
            const float y1 = x1 * __ldg(cr + c) - x2 * __ldg(sr + c);
            x2 = x2 * __ldg(cr + c + kHalf) + x1 * __ldg(sr + c + kHalf);
            x1 = y1;
          }
          x1 *= scale;
          x2 *= scale;
          if (rows != nullptr) {
            float* dst = rows + (bh * n + pos) * DH + c;
            put(dst, row_part, x1);
            put(dst + kHalf, row_part, x2);
          }
        }
        if (cols != nullptr) {
          tile[c][r] = x1;
          tile[c + kHalf][r] = x2;
        }
      }
    }
    if (cols == nullptr) return;
    __syncthreads();
    for (int i = threadIdx.x; i < DH * kRows; i += kPrepThreads) {
      const int d = i / kRows, j = i % kRows;
      if (p0 + j >= np) continue;
      // slot e of an eight holds its key 2e (e < 4) or 2(e - 4) + 1
      const int e = j & 7, key = (j & ~7) + (e < 4 ? 2 * e : 2 * e - 7);
      put(cols + (bh * DH + d) * np + p0 + j, col_part, tile[d][key]);
    }
    __syncthreads();
  };

  if (BWD) {
    pass(p.q, p.q_bs, p.q_rs, rope, p.sm_scale, p.out.q, p.out.qc);
    pass(p.k, p.k_bs, p.k_rs, rope, 1.f, p.out.k, p.out.kc);
    pass(p.v, p.v_bs, p.v_rs, false, 1.f, p.out.v, nullptr);
    pass(p.g, p.g_bs, p.g_rs, false, 1.f, p.out.g, p.out.gc);
    for (int r = warp; r < kRows; r += kPrepThreads / 32) {
      const int pos = p0 + r;
      if (pos >= n) break;
      const float* gp = p.g + b * p.g_bs + pos * p.g_rs + static_cast<long long>(h) * DH;
      const float* op = p.o + b * p.o_bs + pos * p.o_rs + static_cast<long long>(h) * DH;
      float acc = 0.f;
      for (int d = lane; d < DH; d += 32) acc += gp[d] * op[d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) p.delta[bh * n + pos] = acc;
    }
  } else {
    pass(p.q, p.q_bs, p.q_rs, rope, p.sm_scale, p.out.q, nullptr);
    pass(p.k, p.k_bs, p.k_rs, rope, 1.f, p.out.k, nullptr);
    pass(p.v, p.v_bs, p.v_rs, false, 1.f, nullptr, p.out.vc);
  }
}

template <int DH, class V>
__global__ void __launch_bounds__(kPrepThreads) attention_fwd_prep_f32_kernel(const PrepF32 p) {
  prep_f32<DH, V, false>(p);
}

template <int DH, class V>
__global__ void __launch_bounds__(kPrepThreads) attention_bwd_prep_f32_kernel(const PrepF32 p) {
  prep_f32<DH, V, true>(p);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Forward, main kernel: the output of 64 * WG query rows of one head. The
// last warp loads the block's q' tiles once and streams the live (K', V)
// tiles through the ring; each consumer warpgroup owns 64 rows.
template <int DH, class V>
__global__ void __launch_bounds__(FwdF32<DH>::WG * 128 + 32, 1) attention_fwd_f32_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_vc, const int* __restrict__ lens, int n_audio,
    float* __restrict__ out, float* __restrict__ row_max, float* __restrict__ row_linv, int n,
    int heads) {
  constexpr int MASK = V::kMask;
  constexpr int WG = FwdF32<DH>::WG, KT = FwdF32<DH>::KT, ST = FwdF32<DH>::ST;
  constexpr int QTILE = 2 * kRows * DH * 4;  // a q' row tile, both parts
  constexpr int KTILE = 2 * KT * DH * 4;     // a K' row tile; a V column tile is as large
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;  // q' tiles, one per warpgroup
  const uint32_t ring = sq + WG * QTILE;                  // ST x (K' tile, V tile)
  const uint32_t bars = ring + ST * 2 * KTILE;            // q', full[ST], empty[ST]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int q0 = blockIdx.x * kRows * WG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * heads + h, planes = gridDim.z * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lens[b];
  const int kv_end = (MASK == kMaskPrefix && len > 0) ? min(len, n) : n;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(bars, WG * QTILE);
      for (int w = 0; w < WG; ++w)
        load_row_tile<kRows, DH>(sq + w * QTILE, tm_q, bars, q0 + w * kRows, bh, planes);
      int it = 0;
      for (int k0 = 0; k0 < kv_end; k0 += KT) {
        if (MASK != kMaskPrefix && tile_dead<MASK, KT>(k0, len, n_audio, n)) continue;
        const int s = it % ST;
        if (it >= ST) mbar_wait(empty(s), (it / ST - 1) & 1);
        const uint32_t dst = ring + s * 2 * KTILE;
        mbar_expect_tx(full(s), 2 * KTILE);
        load_row_tile<KT, DH>(dst, tm_k, full(s), k0, bh, planes);
        load_col_tile<KT, DH>(dst + KTILE, tm_vc, full(s), k0, bh, planes);
        ++it;
      }
    }
    return;
  }

  const int wg = warp >> 2, wr = (warp & 3) * 16, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * kRows + wr + g;  // this thread's rows
  const int r1 = r0 + 8;
  const uint32_t qt = sq + wg * QTILE;

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0 and r1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their running sums
  mbar_wait(bars, 0);
  __syncwarp();

  int it = 0;
  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    if (MASK != kMaskPrefix && tile_dead<MASK, KT>(k0, len, n_audio, n)) continue;
    const int s = it % ST;
    mbar_wait(full(s), (it / ST) & 1);
    __syncwarp();
    const uint32_t kt = ring + s * 2 * KTILE;

    float sc[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    wgmma_fence();
    issue_ss3<KT, DH>(sc, qt, kt);  // S = q' K'^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    float a0, a1;  // exp(m_old - m_new) of rows r0 and r1
    softmax_tile<KT, MASK>(sc, k0, n, len, n_audio, m0, m1, l0, l1, a0, a1);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
    // O += P V: P from registers, V as the column tile
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
    acc_to_a_tf32<KT>(ph, pl, sc);
    wgmma_fence();
    issue_rs3<DH, KT>(o, ph, pl, kt + KTILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(empty(s));
    ++it;
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  float* o0 = out + (static_cast<long long>(b) * n + r0) * heads * DH + static_cast<long long>(h) * DH;
  float* o1 = o0 + 8LL * heads * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n) *reinterpret_cast<float2*>(o0 + col) = make_float2(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < n) *reinterpret_cast<float2*>(o1 + col) = make_float2(o[j][2] * inv1, o[j][3] * inv1);
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

// Backward, dq kernel: dQ of 64 * WG query rows of one head. The last warp
// loads the block's q' and dO row tiles once and streams the live key tiles
// (K' and V row tiles, the K' column tile) through the ring.
template <int DH, class V>
__global__ void __launch_bounds__(DqF32<DH>::WG * 128 + 32, 1) attention_bwd_dq_f32_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_g,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_kc, const int* __restrict__ lens, int n_audio,
    const float* __restrict__ cos, const float* __restrict__ sin,
    const float* __restrict__ row_max, const float* __restrict__ row_linv,
    const float* __restrict__ delta, float* __restrict__ dq, int n, int heads, int rope_heads,
    float sm_scale) {
  constexpr bool ROPE = V::kRope;
  constexpr int MASK = V::kMask;
  constexpr int WG = DqF32<DH>::WG, KT = DqF32<DH>::KT, ST = DqF32<DH>::ST;
  constexpr int QTILE = 2 * kRows * DH * 4;  // a q' or dO row tile, both parts
  constexpr int KTILE = 2 * KT * DH * 4;     // a K' or V row tile, or the K' column tile
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;  // q' tiles, one per warpgroup
  const uint32_t sg = sq + WG * QTILE;                    // dO tiles
  const uint32_t ring = sg + WG * QTILE;                  // ST x (K', V, K' columns)
  const uint32_t bars = ring + ST * 3 * KTILE;            // q'/dO, full[ST], empty[ST]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int q0 = blockIdx.x * kRows * WG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * heads + h, planes = gridDim.z * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lens[b];
  const int kv_end = (MASK == kMaskPrefix && len > 0) ? min(len, n) : n;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(bars, 2 * WG * QTILE);
      for (int w = 0; w < WG; ++w) {
        load_row_tile<kRows, DH>(sq + w * QTILE, tm_q, bars, q0 + w * kRows, bh, planes);
        load_row_tile<kRows, DH>(sg + w * QTILE, tm_g, bars, q0 + w * kRows, bh, planes);
      }
      int it = 0;
      for (int k0 = 0; k0 < kv_end; k0 += KT) {
        if (MASK != kMaskPrefix && tile_dead<MASK, KT>(k0, len, n_audio, n)) continue;
        const int s = it % ST;
        if (it >= ST) mbar_wait(empty(s), (it / ST - 1) & 1);
        const uint32_t dst = ring + s * 3 * KTILE;
        mbar_expect_tx(full(s), 3 * KTILE);
        load_row_tile<KT, DH>(dst, tm_k, full(s), k0, bh, planes);
        load_row_tile<KT, DH>(dst + KTILE, tm_v, full(s), k0, bh, planes);
        load_col_tile<KT, DH>(dst + 2 * KTILE, tm_kc, full(s), k0, bh, planes);
        ++it;
      }
    }
    return;
  }

  const int wg = warp >> 2, wr = (warp & 3) * 16, g = lane >> 2, t = lane & 3;
  const bool rope = ROPE && h < rope_heads;
  const int r0 = q0 + wg * kRows + wr + g;
  const int r1 = r0 + 8;
  const long long stat = (static_cast<long long>(b) * heads + h) * n;
  const float mx0 = r0 < n ? row_max[stat + r0] : 0.f, mx1 = r1 < n ? row_max[stat + r1] : 0.f;
  const float li0 = r0 < n ? row_linv[stat + r0] : 0.f, li1 = r1 < n ? row_linv[stat + r1] : 0.f;
  const float dl0 = r0 < n ? delta[stat + r0] : 0.f, dl1 = r1 < n ? delta[stat + r1] : 0.f;
  const uint32_t qt = sq + wg * QTILE, gt = sg + wg * QTILE;

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  mbar_wait(bars, 0);
  __syncwarp();

  int it = 0;
  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    if (MASK != kMaskPrefix && tile_dead<MASK, KT>(k0, len, n_audio, n)) continue;
    const int s = it % ST;
    mbar_wait(full(s), (it / ST) & 1);
    __syncwarp();
    const uint32_t kt = ring + s * 3 * KTILE, vt = kt + KTILE;

    // S = q' K'^T, then dP = dO V^T: two groups, so P is formed while dP runs
    float sc[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    }
    wgmma_fence();
    issue_ss3<KT, DH>(sc, qt, kt);
    wgmma_commit();
    issue_ss3<KT, DH>(dp, gt, vt);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    probs<KT>(sc, mx0, mx1, li0, li1);
    wgmma_wait<0>();
    fence_regs(dp);
    dscores<KT, MASK>(sc, dp, k0, n, len, n_audio, dl0, dl1);
    // dQ += dS K': dS from registers, K' as the column tile
    uint32_t dh_[KT / 8][4], dl_[KT / 8][4];
    acc_to_a_tf32<KT>(dh_, dl_, sc);
    wgmma_fence();
    issue_rs3<DH, KT>(acc, dh_, dl_, kt + 2 * KTILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dh_);
    fence_regs(dl_);
    mbar_arrive(empty(s));
    ++it;
  }

#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= sm_scale;
  }
  if (rope) rope_adjoint<DH>(acc, r0, r1, n, cos, sin);
  float* d0 = dq + (static_cast<long long>(b) * n + r0) * heads * DH + static_cast<long long>(h) * DH;
  float* d1 = d0 + 8LL * heads * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n) *reinterpret_cast<float2*>(d0 + col) = make_float2(acc[j][0], acc[j][1]);
    if (r1 < n) *reinterpret_cast<float2*>(d1 + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// Backward, dk/dv kernel: dK and dV of 64 * WG keys of one head. The last
// warp loads the block's K' and V row tiles once and streams each query tile
// through the ring as two slots: its q' and dO row tiles with its rows' m,
// linv and delta (for S^T and dP^T), then its q' and dO column tiles (for
// dV and dK).
template <int DH, class V>
__global__ void __launch_bounds__(DkdvF32<DH>::WG * 128 + 32, 1) attention_bwd_dkdv_f32_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_g,
    const __grid_constant__ CUtensorMap tm_qc, const __grid_constant__ CUtensorMap tm_gc,
    const int* __restrict__ lens, int n_audio, const float* __restrict__ cos,
    const float* __restrict__ sin, const float* __restrict__ row_max,
    const float* __restrict__ row_linv, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int n, int heads, int rope_heads) {
  constexpr bool ROPE = V::kRope;
  constexpr int MASK = V::kMask;
  constexpr int WG = DkdvF32<DH>::WG, QT = DkdvF32<DH>::QT, NS = DkdvF32<DH>::NS;
  constexpr int KTILE = 2 * kRows * DH * 4;  // a K' or V row tile, both parts
  constexpr int QTILE = 2 * QT * DH * 4;     // a q' or dO row or column tile
  constexpr int SLOT = 2 * QTILE + 1024;     // two tiles, and m / linv / delta of QT rows
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sk = (smem_u32(smem) + 1023) & ~1023u;  // K' tiles, one per warpgroup
  const uint32_t sv = sk + WG * KTILE;                    // V tiles
  const uint32_t ring = sv + WG * KTILE;                  // NS x SLOT
  const uint32_t bars = ring + NS * SLOT;                 // K'/V, full[NS], empty[NS]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + NS + s); };
  auto stats = [&](int s) {
    return reinterpret_cast<float*>(smem + (ring + s * SLOT + 2 * QTILE - smem_u32(smem)));
  };

  const int k0 = blockIdx.x * kRows * WG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * heads + h, planes = gridDim.z * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
    for (int s = 0; s < NS; ++s) {
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
      mbar_expect_tx(bars, 2 * WG * KTILE);
      for (int w = 0; w < WG; ++w) {
        load_row_tile<kRows, DH>(sk + w * KTILE, tm_k, bars, k0 + w * kRows, bh, planes);
        load_row_tile<kRows, DH>(sv + w * KTILE, tm_v, bars, k0 + w * kRows, bh, planes);
      }
    }
    int it = 0;
    for (int q0 = 0; q0 < n; q0 += QT) {
      for (int half = 0; half < 2; ++half, ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(empty(s), (it / NS - 1) & 1);
        const uint32_t dst = ring + s * SLOT;
        if (half == 0) {
          float* st = stats(s);
          for (int i = lane; i < QT; i += 32) {
            const int row = q0 + i;
            st[i] = row < n ? row_max[stat + row] : 0.f;
            st[QT + i] = row < n ? row_linv[stat + row] : 0.f;  // rows past n: p = 0
            st[2 * QT + i] = row < n ? delta[stat + row] : 0.f;
          }
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * QTILE);
          if (half == 0) {
            load_row_tile<QT, DH>(dst, tm_q, full(s), q0, bh, planes);
            load_row_tile<QT, DH>(dst + QTILE, tm_g, full(s), q0, bh, planes);
          } else {
            load_col_tile<QT, DH>(dst, tm_qc, full(s), q0, bh, planes);
            load_col_tile<QT, DH>(dst + QTILE, tm_gc, full(s), q0, bh, planes);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wr = (warp & 3) * 16, g = lane >> 2, t = lane & 3;
  const bool rope = ROPE && h < rope_heads;
  const int r0 = k0 + wg * kRows + wr + g;  // this thread's keys
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
    const uint32_t kt = sk + wg * KTILE, vt = sv + wg * KTILE;
    mbar_wait(bars, 0);
    __syncwarp();
    int it = 0;
    for (int q0 = 0; q0 < n; q0 += QT) {
      // S^T = K' q'^T and dP^T = V dO^T: 64 keys x QT queries
      int s = it % NS;
      mbar_wait(full(s), (it / NS) & 1);
      __syncwarp();
      const uint32_t qr = ring + s * SLOT;
      const float* m_s = stats(s);
      float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
      wgmma_fence();
      issue_ss3<QT, DH>(st, kt, qr);
      wgmma_commit();
      issue_ss3<QT, DH>(dpt, vt, qr + QTILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      probs_t<QT>(st, dpt, valid0, valid1, m_s, m_s + QT, m_s + 2 * QT);
      mbar_arrive(empty(s));
      ++it;

      // dV += P^T dO and dK += dS^T q': P^T and dS^T from registers, dO and
      // q' as column tiles
      uint32_t ph[QT / 8][4], pl[QT / 8][4], dh_[QT / 8][4], dl_[QT / 8][4];
      acc_to_a_tf32<QT>(ph, pl, st);
      acc_to_a_tf32<QT>(dh_, dl_, dpt);
      s = it % NS;
      mbar_wait(full(s), (it / NS) & 1);
      __syncwarp();
      const uint32_t qc = ring + s * SLOT;
      wgmma_fence();
      issue_rs3<DH, QT>(av, ph, pl, qc + QTILE);
      issue_rs3<DH, QT>(ak, dh_, dl_, qc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(av);
      fence_regs(ak);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh_);
      fence_regs(dl_);
      mbar_arrive(empty(s));
      ++it;
    }
    if (rope) rope_adjoint<DH>(ak, r0, r1, n, cos, sin);
  }

  float* k0p = dk + (static_cast<long long>(b) * n + r0) * heads * DH + hd;
  float* k1p = k0p + 8LL * heads * DH;
  float* v0p = dv + (static_cast<long long>(b) * n + r0) * heads * DH + hd;
  float* v1p = v0p + 8LL * heads * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<float2*>(k0p + col) = make_float2(ak[j][0], ak[j][1]);
      *reinterpret_cast<float2*>(v0p + col) = make_float2(av[j][0], av[j][1]);
    }
    if (r1 < n) {
      *reinterpret_cast<float2*>(k1p + col) = make_float2(ak[j][2], ak[j][3]);
      *reinterpret_cast<float2*>(v1p + col) = make_float2(av[j][2], av[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// A TMA map of 128-byte-swizzled [box1][32] fp32 boxes over a (d0, d1,
// planes) layout, d0 innermost.
bool map_f32(CUtensorMap* map, const float* base, long long d0, long long d1, long long planes,
             int box1) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {4ULL * d0, 4ULL * d0 * d1};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box1), 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

PrepF32 prep_params(const Operands& a, const LayoutF32& s) {
  PrepF32 p = {};
  p.q = static_cast<const float*>(a.q), p.k = static_cast<const float*>(a.k);
  p.v = static_cast<const float*>(a.v), p.g = static_cast<const float*>(a.g);
  p.o = static_cast<const float*>(a.o);
  p.q_bs = a.q_bs, p.q_rs = a.q_rs, p.k_bs = a.k_bs, p.k_rs = a.k_rs, p.v_bs = a.v_bs;
  p.v_rs = a.v_rs, p.g_bs = a.g_bs, p.g_rs = a.g_rs, p.o_bs = a.o_bs, p.o_rs = a.o_rs;
  p.cos = static_cast<const float*>(a.cos), p.sin = static_cast<const float*>(a.sin);
  p.out = s, p.delta = static_cast<float*>(a.delta);
  p.n = a.n, p.heads = a.heads, p.rope_heads = a.rope_heads, p.sm_scale = a.sm_scale;
  return p;
}

template <int DH, class V>
int launch_fwd_f32(const Operands& a) {
  typedef FwdF32<DH> C;
  const LayoutF32 s = layout_f32(a, false);
  const dim3 grid_p((a.n + kRows - 1) / kRows, a.heads, a.batch);
  attention_fwd_prep_f32_kernel<DH, V><<<grid_p, kPrepThreads, 0, a.stream>>>(prep_params(a, s));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // the maps are encoded on the host at each launch and passed by value
  const long long planes = 2LL * a.batch * a.heads;
  CUtensorMap tq, tk, tv;
  const bool mapped = map_f32(&tq, s.q, DH, a.n, planes, kRows) &&
                      map_f32(&tk, s.k, DH, a.n, planes, C::KT) &&
                      map_f32(&tv, s.vc, s.np, DH, planes, DH);
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(
      attention_fwd_f32_kernel<DH, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_f32_smem<DH>());
  if (set != cudaSuccess) return static_cast<int>(set);
  const int rows = kRows * C::WG;
  const dim3 grid((a.n + rows - 1) / rows, a.heads, a.batch);
  attention_fwd_f32_kernel<DH, V><<<grid, C::WG * 128 + 32, fwd_f32_smem<DH>(), a.stream>>>(
      tq, tk, tv, static_cast<const int*>(a.lens), a.n_audio, static_cast<float*>(a.out),
      static_cast<float*>(a.row_max), static_cast<float*>(a.row_linv), a.n, a.heads);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, class V>
int launch_bwd_f32(const Operands& a) {
  typedef const float* cf;
  typedef DqF32<DH> Q;
  typedef DkdvF32<DH> K;
  const LayoutF32 s = layout_f32(a, true);
  const dim3 grid_p((a.n + kRows - 1) / kRows, a.heads, a.batch);
  attention_bwd_prep_f32_kernel<DH, V><<<grid_p, kPrepThreads, 0, a.stream>>>(prep_params(a, s));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const long long planes = 2LL * a.batch * a.heads;
  CUtensorMap tq, tg, tk, tv, tkc, tk64, tv64, tq32, tg32, tqc, tgc;
  const bool mapped = map_f32(&tq, s.q, DH, a.n, planes, kRows) &&
                      map_f32(&tg, s.g, DH, a.n, planes, kRows) &&
                      map_f32(&tk, s.k, DH, a.n, planes, Q::KT) &&
                      map_f32(&tv, s.v, DH, a.n, planes, Q::KT) &&
                      map_f32(&tkc, s.kc, s.np, DH, planes, DH) &&
                      map_f32(&tk64, s.k, DH, a.n, planes, kRows) &&
                      map_f32(&tv64, s.v, DH, a.n, planes, kRows) &&
                      map_f32(&tq32, s.q, DH, a.n, planes, K::QT) &&
                      map_f32(&tg32, s.g, DH, a.n, planes, K::QT) &&
                      map_f32(&tqc, s.qc, s.np, DH, planes, DH) &&
                      map_f32(&tgc, s.gc, s.np, DH, planes, DH);
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t set = cudaFuncSetAttribute(attention_bwd_dq_f32_kernel<DH, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_f32_smem<DH>());
  if (set == cudaSuccess)
    set = cudaFuncSetAttribute(attention_bwd_dkdv_f32_kernel<DH, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_f32_smem<DH>());
  if (set != cudaSuccess) return static_cast<int>(set);

  const int* lens = static_cast<const int*>(a.lens);
  const int rows_q = kRows * Q::WG;
  const dim3 grid_q((a.n + rows_q - 1) / rows_q, a.heads, a.batch);
  attention_bwd_dq_f32_kernel<DH, V><<<grid_q, Q::WG * 128 + 32, dq_f32_smem<DH>(), a.stream>>>(
      tq, tg, tk, tv, tkc, lens, a.n_audio, static_cast<cf>(a.cos), static_cast<cf>(a.sin),
      static_cast<cf>(a.row_max), static_cast<cf>(a.row_linv), static_cast<cf>(a.delta),
      static_cast<float*>(a.dq), a.n, a.heads, a.rope_heads, a.sm_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rows_k = kRows * K::WG;
  const dim3 grid_k((a.n + rows_k - 1) / rows_k, a.heads, a.batch);
  attention_bwd_dkdv_f32_kernel<DH, V>
      <<<grid_k, K::WG * 128 + 32, dkdv_f32_smem<DH>(), a.stream>>>(
      tk64, tv64, tq32, tg32, tqc, tgc, lens, a.n_audio, static_cast<cf>(a.cos),
      static_cast<cf>(a.sin), static_cast<cf>(a.row_max), static_cast<cf>(a.row_linv),
      static_cast<cf>(a.delta), static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.n,
      a.heads, a.rope_heads);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 forward of variant V: the pre-pass, then the main kernel, on
// `a.stream`; cudaGetLastError() after them, or cudaErrorInvalidValue for
// operands the kernels do not take. Pointers as `Operands`, every tensor
// fp32; `a.qs` is the one scratch buffer of `layout_f32` (`a.ks` is not
// read).
template <class V>
int attention_forward_f32(const Operands& a) {
  if (a.batch <= 0 || a.n <= 0 || a.heads <= 0 || a.qs == nullptr ||
      (a.row_max == nullptr) != (a.row_linv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh == 64) return launch_fwd_f32<64, V>(a);
  if (a.dh == 128) return launch_fwd_f32<128, V>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fp32 backward of variant V: the pre-pass, the dq kernel, then the dkdv
// kernel, on `a.stream`, as `attention_forward_f32`.
template <class V>
int attention_backward_f32(const Operands& a) {
  if (a.batch <= 0 || a.n <= 0 || a.heads <= 0 || a.qs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh == 64) return launch_bwd_f32<64, V>(a);
  if (a.dh == 128) return launch_bwd_f32<128, V>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
