// The attention kernel family of the port, written by hand for Hopper
// (sm_90a): one forward kernel and two backward kernels, as templates over
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
// rounded to bf16; each K tile is rotated in fp32 and rounded to bf16;
// masked scores are the finite -1e30; P.V accumulates in fp32 and is divided
// by max(l, 1e-30) at the end. A row whose keys are all masked (prefix: len
// = 0; joint: len = 0 and no text) comes out as the uniform average over the
// N keys, as the TPU kernels' does. When asked, the forward also writes each
// row's softmax statistics, m (the row max) and linv = 1 / max(l, 1e-30),
// fp32 (B, H, N): the residuals the backward needs. Without ROPE no cos/sin
// table is read: the pointers are null and the code that would read them is
// compiled out.
//
// Bound on this card: operations. At the synthesis shapes (B=2, N=1536,
// H=16, dh=64) the two products are ~4*B*H*N*kv*dh flops against ~26 MB of
// operands, ~600 flops per byte, above the H100's ~295 bf16 flops per byte.
// Design: the TPU kernels keep one head's whole K/V in VMEM; K+V of one head
// at N=4096 is 1 MB against 227 KB of shared memory here, so the kernel
// streams K/V tiles with an online softmax (flash-attention style) instead.
// One block per (q-tile of 64 rows, head, batch), 4 warps of 16 query rows.
// The rotated, scaled Q tile lives in registers as mma.sync A fragments for
// the whole loop; each 64-key K tile is rotated into shared memory and V is
// stored transposed so both products read 32-bit fragment words without
// bank conflicts. Scores, softmax state and the O accumulator stay in
// registers (the m16n8k16 accumulator layout of S is reused as the A
// fragment of P). Dead key tiles are skipped: a tile none of whose columns is
// valid has probabilities of exactly 0 in fp32, so skipping it changes no
// bit of the result. With the prefix rule the dead tiles are those at or past
// len, and the loop simply ends there; with the joint rule they are the
// tiles inside the gap [len, n_audio), and the tiles after it are live
// again. A tile that straddles an edge takes the per-column test. N is any
// length: rows and columns past N are guarded, not padded.
// q/k/v are read through batch and row strides, so the column slices of a
// fused to_qkv projection (row stride 3*H*dh) go in without a copy; the
// head stride must be dh and the last axis contiguous.
// This is the first, simple version: mma.sync rather than wgmma, no TMA, no
// software pipelining of the tile loads.
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
// the backward is two kernels and uses no atomics (two runs give identical
// gradients):
//   1. dq kernel, one block per (q-tile of 64 rows, head, batch): computes
//      delta for its rows (written out for kernel 2), keeps q' and dO as A
//      fragments in registers, streams the live K/V tiles and accumulates dQ
//      in registers.
//   2. dkdv kernel, one block per (key tile of 64, head, batch): keeps its
//      K and V tiles in shared memory, streams every q-tile (q', q'^T, dO,
//      dO^T, m, linv, delta) and accumulates dK and dV in registers. A dead
//      key tile gets dK = dV = 0, exactly what its zero probabilities give.
// Both recompute S and dP (7 products of N x N x dh per head against the 5
// of the math), and the RoPE adjoint of dQ and dK is done in registers: the
// element at column c + dh/2 sits in the same thread's fragment dh/16 tiles
// on. Bound on this card: operations (10 * B * H * N^2 * dh flops at
// ~1,000 flops per byte at the training shapes). Simple first version, like
// the forward: mma.sync, transposed tiles stored through shared memory, no
// TMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;  // keys per K/V tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, col-major), fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + 64) of one head of q or k into `dst`, rotated in fp32
// when `rope`, multiplied by `scale`, rounded to bf16. Rows past n are zero.
// When `dst_t` is given, the same bf16 values also go there transposed:
// dst_t[d][row].
template <int DH>
__device__ __forceinline__ void load_rotated(bf16 (*dst)[DH + 8], bf16 (*dst_t)[kBlockK + 8],
                                             const bf16* src, long long row_stride, int row0,
                                             int n, bool rope, const float* cos,
                                             const float* sin, float scale) {
  constexpr int kHalf = DH / 2;
  constexpr int kChunks = kHalf / 8;  // 8-value chunks in each half of a row
  for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int pos = row0 + r;
    float lo[8], hi[8];
    if (pos < n) {
      const uint4 a = *reinterpret_cast<const uint4*>(src + pos * row_stride + c);
      const uint4 b = *reinterpret_cast<const uint4*>(src + pos * row_stride + c + kHalf);
      const bf16* ea = reinterpret_cast<const bf16*>(&a);
      const bf16* eb = reinterpret_cast<const bf16*>(&b);
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
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) lo[i] = hi[i] = 0.f;
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
    *reinterpret_cast<uint4*>(&dst[r][c]) = pa;
    *reinterpret_cast<uint4*>(&dst[r][c + kHalf]) = pb;
    if (dst_t != nullptr) {
      const bf16* ta = reinterpret_cast<const bf16*>(&pa);
      const bf16* tb = reinterpret_cast<const bf16*>(&pb);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dst_t[c + i][r] = ta[i];
        dst_t[c + i + kHalf][r] = tb[i];
      }
    }
  }
}

// Keys [row0, row0 + 64) of one head of v, stored transposed: dst[d][key].
template <int DH>
__device__ __forceinline__ void load_v_transposed(bf16 (*dst)[kBlockK + 8], const bf16* src,
                                                  long long row_stride, int row0, int n) {
  constexpr int kChunks = DH / 8;
  for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int pos = row0 + r;
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    if (pos < n) a = *reinterpret_cast<const uint4*>(src + pos * row_stride + c);
    const bf16* e = reinterpret_cast<const bf16*>(&a);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[c + i][r] = e[i];
  }
}

// The A fragment of rows [r0, r0 + 16), columns [k0, k0 + 16) of a
// row-major bf16 tile in shared memory.
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], bf16 (*src)[W], int r0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a[0] = ld_u32(&src[r0 + g][k0 + 2 * t]);
  a[1] = ld_u32(&src[r0 + g + 8][k0 + 2 * t]);
  a[2] = ld_u32(&src[r0 + g][k0 + 2 * t + 8]);
  a[3] = ld_u32(&src[r0 + g + 8][k0 + 2 * t + 8]);
}

// acc[j] += A (16 x 16*KS, as fragments a[KS]) * B, where B's column n,
// row k is src[n][k] (a [n][k] tile in shared memory), for the NT output
// tiles of 8 columns.
template <int KS, int NT, int W>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                         bf16 (*src)[W]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mma_16816(acc[j], a[kk], ld_u32(&src[j * 8 + g][kk * 16 + 2 * t]),
                ld_u32(&src[j * 8 + g][kk * 16 + 2 * t + 8]));
    }
  }
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

template <int DH, class V>
__global__ void __launch_bounds__(kThreads) attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, const int* __restrict__ lens, int n_audio, const float* __restrict__ cos,
    const float* __restrict__ sin, bf16* __restrict__ out, float* __restrict__ row_max,
    float* __restrict__ row_linv, int n, int heads, int rope_heads, float sm_scale) {
  constexpr bool ROPE = V::kRope;
  constexpr int MASK = V::kMask;
  __shared__ __align__(16) bf16 ks[kBlockK][DH + 8];   // Q tile first, then K tiles
  __shared__ __align__(16) bf16 vts[DH][kBlockK + 8];  // V tile, transposed

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const bool rope = ROPE && h < rope_heads;
  const int len = lens[b];

  const bf16* qb = q + b * q_bs + static_cast<long long>(h) * DH;
  const bf16* kb = k + b * k_bs + static_cast<long long>(h) * DH;
  const bf16* vb = v + b * v_bs + static_cast<long long>(h) * DH;

  // Q: rotate, fold in sm_scale, round to bf16, keep as A fragments.
  load_rotated<DH>(ks, nullptr, qb, q_rs, q0, n, rope, cos, sin, sm_scale);
  __syncthreads();
  uint32_t qf[DH / 16][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) load_a(qf[kk], ks, wr, kk * 16);
  __syncthreads();

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // running sum of exp

  // dead tiles hold probabilities of exactly 0: the prefix rule's lie at or
  // past len, where the loop ends; the joint rule's inside [len, n_audio)
  const int kv_end = (MASK == kMaskPrefix && len > 0) ? min(len, n) : n;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    if (MASK != kMaskPrefix && tile_dead<MASK>(k0, len, n_audio, n)) continue;
    load_rotated<DH>(ks, nullptr, kb, k_rs, k0, n, rope, cos, sin, 1.f);
    load_v_transposed<DH>(vts, vb, v_rs, k0, n);
    __syncthreads();

    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_rows(s, qf, ks);

    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        if (col >= n) {
          s[j][e] = -INFINITY;  // past the sequence: not a key at all
        } else if (!col_valid<MASK>(col, len, n_audio)) {
          s[j][e] = kMaskValue;
        }
      }
      tm0 = fmaxf(tm0, fmaxf(s[j][0], s[j][1]));
      tm1 = fmaxf(tm1, fmaxf(s[j][2], s[j][3]));
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

    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, off);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, off);
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // O += P V: the S accumulators are exactly the A fragments of P.
    uint32_t pa[kBlockK / 16][4];
    acc_to_a(pa, s);
    mma_rows(o, pa, vts);
    __syncthreads();  // the next tile overwrites ks / vts
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
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

// Scores of masked keys take the finite mask value, keys past n are no keys
// at all; then p = exp(s - m) * linv for a row with statistics (m, linv).
__device__ __forceinline__ float masked_prob(float s, int key, bool valid, int n, float m,
                                             float linv) {
  if (key >= n) return 0.f;
  if (!valid) s = kMaskValue;
  return __expf(s - m) * linv;
}

// Backward, kernel 1: dQ of one q-tile of one head, and delta for its rows.
template <int DH, class V>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const bf16* __restrict__ o, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs, long long g_bs,
    long long g_rs, long long o_bs, long long o_rs, const int* __restrict__ lens, int n_audio,
    const float* __restrict__ cos, const float* __restrict__ sin,
    const float* __restrict__ row_max, const float* __restrict__ row_linv,
    float* __restrict__ delta, bf16* __restrict__ dq, int n, int heads, int rope_heads,
    float sm_scale) {
  constexpr bool ROPE = V::kRope;
  constexpr int MASK = V::kMask;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*ks)[DH + 8] = reinterpret_cast<bf16(*)[DH + 8]>(smem);            // K tile (rotated)
  bf16(*vs)[DH + 8] = ks + kBlockK;                                        // V tile
  bf16(*kts)[kBlockK + 8] = reinterpret_cast<bf16(*)[kBlockK + 8]>(vs + kBlockK);  // K^T
  float* delta_s = reinterpret_cast<float*>(kts + DH);

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool rope = ROPE && h < rope_heads;
  const int len = lens[b];
  const int wr = warp * 16;

  const long long hd = static_cast<long long>(h) * DH;
  const bf16* qb = q + b * q_bs + hd;
  const bf16* kb = k + b * k_bs + hd;
  const bf16* vb = v + b * v_bs + hd;
  const bf16* gb = dout + b * g_bs + hd;
  const bf16* ob = o + b * o_bs + hd;

  // delta = rowsum(dO * O) for this warp's 16 rows, lanes across dh
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + wr + i;
    float acc = 0.f;
    if (row < n) {
      for (int c = lane; c < DH; c += 32) {
        acc += __bfloat162float(gb[row * g_rs + c]) * __bfloat162float(ob[row * o_rs + c]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[wr + i] = acc;
      if (row < n) delta[(static_cast<long long>(b) * heads + h) * n + row] = acc;
    }
  }
  // q' and dO as A fragments
  load_rotated<DH>(ks, nullptr, qb, q_rs, q0, n, rope, cos, sin, sm_scale);
  load_rotated<DH>(vs, nullptr, gb, g_rs, q0, n, false, cos, sin, 1.f);
  __syncthreads();
  uint32_t qf[DH / 16][4], gf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    load_a(qf[kk], ks, wr, kk * 16);
    load_a(gf[kk], vs, wr, kk * 16);
  }
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  const long long stat = (static_cast<long long>(b) * heads + h) * n;
  const float mx0 = r0 < n ? row_max[stat + r0] : 0.f, mx1 = r1 < n ? row_max[stat + r1] : 0.f;
  const float li0 = r0 < n ? row_linv[stat + r0] : 0.f, li1 = r1 < n ? row_linv[stat + r1] : 0.f;
  const float dl0 = delta_s[wr + g], dl1 = delta_s[wr + g + 8];
  __syncthreads();

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int kv_end = (MASK == kMaskPrefix && len > 0) ? min(len, n) : n;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    if (MASK != kMaskPrefix && tile_dead<MASK>(k0, len, n_audio, n)) continue;
    load_rotated<DH>(ks, kts, kb, k_rs, k0, n, rope, cos, sin, 1.f);
    load_rotated<DH>(vs, nullptr, vb, v_rs, k0, n, false, cos, sin, 1.f);
    __syncthreads();

    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    mma_rows(s, qf, ks);
    mma_rows(dp, gf, vs);
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const bool valid = col_valid<MASK>(key, len, n_audio);
        const float p = e < 2 ? masked_prob(s[j][e], key, valid, n, mx0, li0)
                              : masked_prob(s[j][e], key, valid, n, mx1, li1);
        s[j][e] = valid ? p * (dp[j][e] - (e < 2 ? dl0 : dl1)) : 0.f;  // dS
      }
    }
    uint32_t da[kBlockK / 16][4];
    acc_to_a(da, s);
    mma_rows(acc, da, kts);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= sm_scale;
  }
  if (rope) rope_adjoint<DH>(acc, r0, r1, n, cos, sin);
  bf16* d0 = dq + (static_cast<long long>(b) * n + r0) * heads * DH + hd;
  bf16* d1 = d0 + 8LL * heads * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n) *reinterpret_cast<uint32_t*>(d0 + col) = pack_bf16x2(acc[j][0], acc[j][1]);
    if (r1 < n) *reinterpret_cast<uint32_t*>(d1 + col) = pack_bf16x2(acc[j][2], acc[j][3]);
  }
}

// Backward, kernel 2: dK and dV of one key tile of one head.
template <int DH, class V>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, long long q_bs, long long q_rs, long long k_bs,
    long long k_rs, long long v_bs, long long v_rs, long long g_bs, long long g_rs,
    const int* __restrict__ lens, int n_audio, const float* __restrict__ cos,
    const float* __restrict__ sin, const float* __restrict__ row_max,
    const float* __restrict__ row_linv, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int heads, int rope_heads,
    float sm_scale) {
  constexpr bool ROPE = V::kRope;
  constexpr int MASK = V::kMask;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*ks)[DH + 8] = reinterpret_cast<bf16(*)[DH + 8]>(smem);  // K tile (rotated)
  bf16(*vs)[DH + 8] = ks + kBlockK;                              // V tile
  bf16(*qs)[DH + 8] = vs + kBlockK;                              // q' tile
  bf16(*gs)[DH + 8] = qs + kBlockQ;                              // dO tile
  bf16(*qts)[kBlockQ + 8] = reinterpret_cast<bf16(*)[kBlockQ + 8]>(gs + kBlockQ);  // q'^T
  bf16(*gts)[kBlockQ + 8] = qts + DH;                                              // dO^T
  float* m_s = reinterpret_cast<float*>(gts + DH);
  float* l_s = m_s + kBlockQ;
  float* d_s = l_s + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool rope = ROPE && h < rope_heads;
  const int len = lens[b];
  const int wr = warp * 16;
  const int r0 = k0 + wr + g;  // this thread's key rows
  const int r1 = r0 + 8;
  const long long hd = static_cast<long long>(h) * DH;

  float ak[DH / 8][4], av[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;
  }

  if (!tile_dead<MASK>(k0, len, n_audio, n)) {
    const bf16* qb = q + b * q_bs + hd;
    const bf16* gb = dout + b * g_bs + hd;
    load_rotated<DH>(ks, nullptr, k + b * k_bs + hd, k_rs, k0, n, rope, cos, sin, 1.f);
    load_rotated<DH>(vs, nullptr, v + b * v_bs + hd, v_rs, k0, n, false, cos, sin, 1.f);
    const long long stat = (static_cast<long long>(b) * heads + h) * n;

    for (int q0 = 0; q0 < n; q0 += kBlockQ) {
      load_rotated<DH>(qs, qts, qb, q_rs, q0, n, rope, cos, sin, sm_scale);
      load_rotated<DH>(gs, gts, gb, g_rs, q0, n, false, cos, sin, 1.f);
      for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
        const int row = q0 + i;
        m_s[i] = row < n ? row_max[stat + row] : 0.f;
        l_s[i] = row < n ? row_linv[stat + row] : 0.f;  // rows past n: p = 0
        d_s[i] = row < n ? delta[stat + row] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T, 16 keys x 64 queries per warp
      float st[kBlockQ / 8][4], dpt[kBlockQ / 8][4];
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
      uint32_t kf[DH / 16][4];
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) load_a(kf[kk], ks, wr, kk * 16);
      mma_rows(st, kf, qs);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) load_a(kf[kk], vs, wr, kk * 16);
      mma_rows(dpt, kf, gs);

#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);  // query within the tile
          const int key = e < 2 ? r0 : r1;
          const bool valid = col_valid<MASK>(key, len, n_audio);
          const float p = __expf((valid ? st[j][e] : kMaskValue) - m_s[qi]) * l_s[qi];
          st[j][e] = p;
          dpt[j][e] = valid ? p * (dpt[j][e] - d_s[qi]) : 0.f;  // dS^T
        }
      }
      uint32_t pa[kBlockQ / 16][4];
      acc_to_a(pa, st);
      mma_rows(av, pa, gts);  // dV += P^T dO
      acc_to_a(pa, dpt);
      mma_rows(ak, pa, qts);  // dK += dS^T q'
      __syncthreads();        // the next q-tile overwrites the tiles
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
constexpr int dq_smem() {
  return (2 * kBlockK * (DH + 8) + DH * (kBlockK + 8)) * 2 + kBlockQ * 4;
}

template <int DH>
constexpr int dkdv_smem() {
  return (2 * kBlockK * (DH + 8) + 2 * kBlockQ * (DH + 8) + 2 * DH * (kBlockQ + 8)) * 2 +
         3 * kBlockQ * 4;
}

// What one forward or backward call passes. q/k/v, and g (= dO) and o (the
// forward's output) in the backward: device pointers to (B, N, H, dh) bf16
// with the given batch and row strides (elements), head stride dh,
// contiguous last axis, 16-byte aligned rows. lens (B,) int32; n_audio only
// for the joint rule; cos/sin (N, dh) fp32 contiguous, null without RoPE.
// Forward: out (B, N, H, dh) bf16 contiguous; row_max/row_linv fp32 (B, H, N)
// to write the softmax statistics, or both null. Backward: row_max/row_linv
// hold the forward's statistics, delta is fp32 (B, H, N) scratch, dq/dk/dv
// are (B, N, H, dh) bf16 contiguous.
struct Operands {
  const void *q, *k, *v, *g, *o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, o_bs, o_rs;
  const void* lens;
  int n_audio;
  const void *cos, *sin;
  void *out, *row_max, *row_linv, *delta, *dq, *dk, *dv;
  int batch, n, heads, dh, rope_heads;
  float sm_scale;
  cudaStream_t stream;
};

template <int DH, class V>
int launch_fwd(const Operands& a) {
  typedef const bf16* cb;
  const dim3 grid((a.n + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  attention_kernel<DH, V><<<grid, kThreads, 0, a.stream>>>(
      static_cast<cb>(a.q), static_cast<cb>(a.k), static_cast<cb>(a.v), a.q_bs, a.q_rs, a.k_bs,
      a.k_rs, a.v_bs, a.v_rs, static_cast<const int*>(a.lens), a.n_audio,
      static_cast<const float*>(a.cos), static_cast<const float*>(a.sin),
      static_cast<bf16*>(a.out), static_cast<float*>(a.row_max), static_cast<float*>(a.row_linv),
      a.n, a.heads, a.rope_heads, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, class V>
int launch_bwd(const Operands& a) {
  // dynamic shared memory above 48 KB is opt-in, per kernel and per device:
  // set on every launch (a cheap host call), so any current device is ready
  cudaError_t set = cudaFuncSetAttribute(attention_bwd_dq_kernel<DH, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_smem<DH>());
  if (set == cudaSuccess)
    set = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<DH, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<DH>());
  if (set != cudaSuccess) return static_cast<int>(set);
  typedef const bf16* cb;
  typedef const float* cf;
  const int* lens = static_cast<const int*>(a.lens);
  const dim3 grid_q((a.n + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  attention_bwd_dq_kernel<DH, V><<<grid_q, kThreads, dq_smem<DH>(), a.stream>>>(
      static_cast<cb>(a.q), static_cast<cb>(a.k), static_cast<cb>(a.v), static_cast<cb>(a.g),
      static_cast<cb>(a.o), a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.g_bs, a.g_rs,
      a.o_bs, a.o_rs, lens, a.n_audio, static_cast<cf>(a.cos), static_cast<cf>(a.sin),
      static_cast<cf>(a.row_max), static_cast<cf>(a.row_linv), static_cast<float*>(a.delta),
      static_cast<bf16*>(a.dq), a.n, a.heads, a.rope_heads, a.sm_scale);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid_k((a.n + kBlockK - 1) / kBlockK, a.heads, a.batch);
  attention_bwd_dkdv_kernel<DH, V><<<grid_k, kThreads, dkdv_smem<DH>(), a.stream>>>(
      static_cast<cb>(a.q), static_cast<cb>(a.k), static_cast<cb>(a.v), static_cast<cb>(a.g),
      a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.g_bs, a.g_rs, lens, a.n_audio,
      static_cast<cf>(a.cos), static_cast<cf>(a.sin), static_cast<cf>(a.row_max),
      static_cast<cf>(a.row_linv), static_cast<cf>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.n, a.heads, a.rope_heads, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The forward of variant V on `a.stream`: cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for sizes the kernels do not take.
template <class V>
int attention_forward(const Operands& a) {
  if (a.batch <= 0 || a.n <= 0 || a.heads <= 0 || (a.row_max == nullptr) != (a.row_linv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh == 64) return launch_fwd<64, V>(a);
  if (a.dh == 128) return launch_fwd<128, V>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of variant V: the dq kernel, then the dkdv kernel, on
// `a.stream`; cudaGetLastError() after them.
template <class V>
int attention_backward(const Operands& a) {
  if (a.batch <= 0 || a.n <= 0 || a.heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh == 64) return launch_bwd<64, V>(a);
  if (a.dh == 128) return launch_bwd<128, V>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
