// The fp32 members of the attention kernel family: the forward (pre-pass +
// main kernel) and the backward (pre-pass, dq kernel, dk/dv kernel) of
// attention_core.cuh for fp32 operands, over the same variants V (RoPE in or
// out with rotated heads h < rope_heads; the prefix or the joint column rule)
// and head widths dh in {64, 128}. The TPU kernels take any element type:
// their outputs take the operands' dtype, so a model run with
// compute_dtype float32 runs fp32 attention through them, and here.
//
// What they compute is the bf16 kernels' function with no bf16 rounding:
// q' = sm_scale * rot(q) and k' = rot(k) in fp32, scores q'.k'^T with masked
// columns at -1e30 and columns past N at -inf, P = exp(s - m) in fp32 (not
// rounded before P.V), out = (P.V) / max(l, 1e-30); the forward writes the
// row statistics (m, linv = 1 / max(l, 1e-30)) that the backward takes; the
// backward forms dS = P (dP - delta) with delta = rowsum(dO * O), 0 at masked
// keys, dV = P^T dO, dQ = rot^T(sm_scale dS k'), dK = rot^T(dS^T q'), each
// written in fp32. A row whose keys are all masked comes out as the uniform
// average, as in bf16.
//
// Bound on this card: operations, at the fp32 FMA rate outside the tensor
// cores (~67 TFLOP/s on an H100 SXM, ~1/15 of the bf16 tensor peak). No TF32
// wgmma: its 10-bit mantissa is not the fp32 arithmetic of the TPU kernels
// and the plain versions. The design is a plain SIMT one, no atomics (two
// runs give the same bits):
// - 256 threads a block as 16 x 16; a 64 x 64 tile of scores is one 4 x 4
//   block a thread, accumulated by FFMA from shared memory, with q'/K' (and
//   dO/V) held transposed ([dh][64]) so a thread reads its four rows or keys
//   as one 128-bit load. The 16 threads of a row are one half-warp, so row
//   reductions are four shuffles.
// - Forward: one block per (64 query rows, head, batch) streams K'^T and V
//   tiles of 64 keys through shared memory with an online softmax; P goes
//   through shared memory (transposed, rows padded to 68 floats) into
//   O += P.V, whose 64 x dh block a thread owns as 4 rows x dh/16 columns:
//   the columns c and c + dh/2 of the half-split RoPE pairs sit in the same
//   thread, so the backward's RoPE adjoint needs no exchange.
// - Backward, dq kernel: one block per 64 query rows streams K'^T, V^T and K'
//   tiles; S and dP in one pass over dh; dS through shared memory into dQ.
// - Backward, dk/dv kernel: one block per 64 keys holds K'^T and V^T and
//   streams q' and dO tiles (row-major, rows padded to dh + 1 floats, read a
//   value at a time) with the tiles' m, linv and delta.
// - Dead key tiles are skipped as in bf16 (their probabilities are exactly
//   0 in fp32); a dk/dv block whose keys are all dead writes zeros.
// The pre-pass of both directions is one warp per (row, head): q' (and k'
// with RoPE) into fp32 head-major scratch (B, H, N, dh); delta in the
// backward.

#pragma once

#include "attention_core.cuh"

namespace {

constexpr int kF32Tile = 64;      // query rows of a block, keys of a tile
constexpr int kF32Threads = 256;  // 16 x 16 threads, a 4 x 4 block of a 64 x 64 tile each
constexpr int kF32Pad = 68;       // row stride (floats) of the 64 x 64 tiles P and dS

// One fp32 operand: element (b, h, r, d) at p + b * bs + h * hs + r * rs + d.
struct View {
  const float* p;
  long long bs, hs, rs;
  __device__ __forceinline__ const float* row(int b, int h, int r) const {
    return p + b * bs + h * hs + static_cast<long long>(r) * rs;
  }
};

// (B, N, H, dh) in place through batch and row strides.
View in_place(const void* p, long long bs, long long rs, int dh) {
  return View{static_cast<const float*>(p), bs, dh, rs};
}
// (B, H, N, dh) scratch.
View head_major(const void* p, int heads, int n, int dh) {
  return View{static_cast<const float*>(p), static_cast<long long>(heads) * n * dh,
              static_cast<long long>(n) * dh, dh};
}

// Rows [r0, r0 + 64) of head h, batch b of `src` into dst[d * 64 + r]
// (transposed); rows past n as zeros. Lanes take neighbouring rows, so the
// stores do not conflict.
template <int DH>
__device__ __forceinline__ void load_t(float* dst, const View& src, int b, int h, int r0, int n) {
  for (int i = threadIdx.x; i < kF32Tile * DH / 4; i += kF32Threads) {
    const int r = i % kF32Tile, d = (i / kF32Tile) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = __ldg(reinterpret_cast<const float4*>(src.row(b, h, r0 + r) + d));
    dst[(d + 0) * kF32Tile + r] = x.x;
    dst[(d + 1) * kF32Tile + r] = x.y;
    dst[(d + 2) * kF32Tile + r] = x.z;
    dst[(d + 3) * kF32Tile + r] = x.w;
  }
}

// The same rows into dst[r * LD + d] (row-major, row stride LD floats).
template <int DH, int LD>
__device__ __forceinline__ void load_rows(float* dst, const View& src, int b, int h, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < kF32Tile * DH / 4; i += kF32Threads) {
    const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = __ldg(reinterpret_cast<const float4*>(src.row(b, h, r0 + r) + d));
    if constexpr (LD % 4 == 0) {
      *reinterpret_cast<float4*>(dst + r * LD + d) = x;
    } else {
      dst[r * LD + d] = x.x;
      dst[r * LD + d + 1] = x.y;
      dst[r * LD + d + 2] = x.z;
      dst[r * LD + d + 3] = x.w;
    }
  }
}

// Column e (< dh/16) of the output block of thread tx: the half-split pairs
// (c, c + dh/2) are e and e + dh/32.
template <int DH>
__device__ __forceinline__ int out_col(int tx, int e) {
  constexpr int HC = DH / 32;
  return e < HC ? tx * HC + e : DH / 2 + tx * HC + (e - HC);
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc (4 x 4) += x y^T for the four values x at `a` (a thread's rows) and
// the four y at `b` (its columns): one step of a product over the depth
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}

// RoPE adjoint x * cos - rot_half(x * sin) of the 4 rows (positions pos[i])
// of a thread's output block in place.
template <int DH>
__device__ __forceinline__ void rope_adjoint_f32(float (&x)[4][DH / 16], const int (&pos)[4],
                                                 int n, int tx, const float* cos,
                                                 const float* sin) {
  constexpr int HC = DH / 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pos[i] >= n) continue;
    const float* cr = cos + static_cast<long long>(pos[i]) * DH;
    const float* sr = sin + static_cast<long long>(pos[i]) * DH;
#pragma unroll
    for (int e = 0; e < HC; ++e) {
      const int c = tx * HC + e;
      const float x1 = x[i][e], x2 = x[i][HC + e];
      x[i][e] = x1 * __ldg(cr + c) + x2 * __ldg(sr + c + DH / 2);
      x[i][HC + e] = x2 * __ldg(cr + c + DH / 2) - x1 * __ldg(sr + c);
    }
  }
}

// Pre-pass of both directions, one warp per (row, head): q' = sm_scale *
// rot(q) and, with RoPE compiled in, k' = rot(k) into head-major scratch
// (B, H, N, DH); with DELTA also delta = rowsum(dO * O), (B, H, N).
template <int DH, class V, bool DELTA>
__global__ void __launch_bounds__(256) attention_prep_f32_kernel(
    const View q, const View k, const View g, const View o, const float* __restrict__ cos,
    const float* __restrict__ sin, float* __restrict__ qs, float* __restrict__ ks,
    float* __restrict__ delta, int batch, int n, int heads, int rope_heads, float sm_scale) {
  constexpr int kHalf = DH / 2;
  const long long w = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= static_cast<long long>(batch) * n * heads) return;
  const int h = static_cast<int>(w % heads);
  const int pos = static_cast<int>((w / heads) % n);
  const int b = static_cast<int>(w / (static_cast<long long>(heads) * n));
  const long long dst = ((static_cast<long long>(b) * heads + h) * n + pos) * DH;
  const bool rope = V::kRope && h < rope_heads;
  auto rotate = [&](float* out, const float* src, float scale) {
    for (int j = lane; j < kHalf; j += 32) {
      float lo = src[j], hi = src[j + kHalf];
      if (rope) {
        const float* cr = cos + static_cast<long long>(pos) * DH;
        const float* sr = sin + static_cast<long long>(pos) * DH;
        const float x1 = lo, x2 = hi;
        lo = x1 * __ldg(cr + j) - x2 * __ldg(sr + j);
        hi = x2 * __ldg(cr + j + kHalf) + x1 * __ldg(sr + j + kHalf);
      }
      out[j] = lo * scale;
      out[j + kHalf] = hi * scale;
    }
  };
  rotate(qs + dst, q.row(b, h, pos), sm_scale);
  if (V::kRope) rotate(ks + dst, k.row(b, h, pos), 1.f);
  if (!DELTA) return;
  const float* gp = g.row(b, h, pos);
  const float* op = o.row(b, h, pos);
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32) acc += gp[d] * op[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(static_cast<long long>(b) * heads + h) * n + pos] = acc;
}

template <int DH>
constexpr int fwd_f32_smem() {  // q'^T, K'^T, V, P^T
  return (3 * DH * kF32Tile + kF32Tile * kF32Pad) * 4;
}
template <int DH>
constexpr int dq_f32_smem() {  // q'^T, dO^T, K'^T, V^T, K', dS^T
  return (5 * DH * kF32Tile + kF32Tile * kF32Pad) * 4;
}
template <int DH>
constexpr int dkdv_f32_smem() {  // K'^T, V^T, q' and dO padded, P, dS, the rows' m, linv, delta
  return (2 * DH * kF32Tile + 2 * kF32Tile * (DH + 1) + 2 * kF32Tile * kF32Pad + 3 * kF32Tile) *
         4;
}

// Forward, main kernel: the output of 64 query rows of one head.
template <int DH, class V>
__global__ void __launch_bounds__(kF32Threads) attention_fwd_f32_kernel(
    const View q, const View k, const View v, const int* __restrict__ lens, int n_audio,
    float* __restrict__ out, float* __restrict__ row_max, float* __restrict__ row_linv, int n,
    int heads) {
  constexpr int MASK = V::kMask;
  constexpr int C = DH / 16;  // output columns a thread
  extern __shared__ float4 smem_f32[];
  float* const sq = reinterpret_cast<float*>(smem_f32);  // [DH][64] q'^T
  float* const sk = sq + DH * kF32Tile;                  // [DH][64] K'^T
  float* const sv = sk + DH * kF32Tile;                  // [64][DH] V
  float* const sp = sv + kF32Tile * DH;                  // [64 keys][kF32Pad] P^T
  const int q0 = blockIdx.x * kF32Tile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int len = lens[b];
  const int kv_end = (MASK == kMaskPrefix && len > 0) ? min(len, n) : n;
  load_t<DH>(sq, q, b, h, q0, n);

  float o[4][C] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += kF32Tile) {
    if (MASK != kMaskPrefix && tile_dead<MASK>(k0, len, n_audio, n)) continue;
    __syncthreads();  // every thread is done with the last tile
    load_t<DH>(sk, k, b, h, k0, n);
    load_rows<DH, DH>(sv, v, b, h, k0, n);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < DH; ++d) outer4(s, sq + d * kF32Tile + 4 * ty, sk + d * kF32Tile + 4 * tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + 4 * tx + j;
      const bool past = col >= n, ok = col_valid<MASK>(col, len, n_audio);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = past ? -INFINITY : (ok ? s[i][j] : kMaskValue);
    }
    // every tile holds a key < n, so the new max is finite; a row whose
    // keys are all masked so far has max -1e30 and gets exp(0) = 1 a key
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], half_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))));
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < C; ++e) o[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sp + (4 * tx + j) * kF32Pad + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kF32Tile; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(sp + kk * kF32Pad + 4 * ty);
      const float ps[4] = {p.x, p.y, p.z, p.w};
      const float* vr = sv + kk * DH;
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const float ve = vr[out_col<DH>(tx, e)];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][e] = fmaf(ps[i], ve, o[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    const float inv = 1.f / fmaxf(half_sum(l[i]), 1e-30f);
    if (r >= n) continue;
    float* orow = out + ((static_cast<long long>(b) * n + r) * heads + h) * DH;
#pragma unroll
    for (int e = 0; e < C; ++e) orow[out_col<DH>(tx, e)] = o[i][e] * inv;
    if (row_max != nullptr && tx == 0) {
      const long long stat = (static_cast<long long>(b) * heads + h) * n + r;
      row_max[stat] = m[i];
      row_linv[stat] = inv;
    }
  }
}

// Backward, dq kernel: dQ of 64 query rows of one head.
template <int DH, class V>
__global__ void __launch_bounds__(kF32Threads) attention_bwd_dq_f32_kernel(
    const View q, const View k, const View v, const View g, const int* __restrict__ lens,
    int n_audio, const float* __restrict__ cos, const float* __restrict__ sin,
    const float* __restrict__ row_max, const float* __restrict__ row_linv,
    const float* __restrict__ delta, float* __restrict__ dq, int n, int heads, int rope_heads,
    float sm_scale) {
  constexpr int MASK = V::kMask;
  constexpr int C = DH / 16;
  extern __shared__ float4 smem_f32[];
  float* const sq = reinterpret_cast<float*>(smem_f32);  // [DH][64] q'^T
  float* const sg = sq + DH * kF32Tile;                  // [DH][64] dO^T
  float* const skt = sg + DH * kF32Tile;                 // [DH][64] K'^T
  float* const svt = skt + DH * kF32Tile;                // [DH][64] V^T
  float* const sk = svt + DH * kF32Tile;                 // [64][DH] K'
  float* const sds = sk + kF32Tile * DH;                 // [64 keys][kF32Pad] dS^T
  const int q0 = blockIdx.x * kF32Tile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int len = lens[b];
  const int kv_end = (MASK == kMaskPrefix && len > 0) ? min(len, n) : n;
  load_t<DH>(sq, q, b, h, q0, n);
  load_t<DH>(sg, g, b, h, q0, n);
  float m[4], linv[4], dl[4];
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos[i] = q0 + 4 * ty + i;
    const long long stat = (static_cast<long long>(b) * heads + h) * n + pos[i];
    const bool live = pos[i] < n;
    m[i] = live ? row_max[stat] : 0.f;
    linv[i] = live ? row_linv[stat] : 0.f;
    dl[i] = live ? delta[stat] : 0.f;
  }

  float acc[4][C] = {};
  for (int k0 = 0; k0 < kv_end; k0 += kF32Tile) {
    if (MASK != kMaskPrefix && tile_dead<MASK>(k0, len, n_audio, n)) continue;
    __syncthreads();
    load_t<DH>(skt, k, b, h, k0, n);
    load_t<DH>(svt, v, b, h, k0, n);
    load_rows<DH, DH>(sk, k, b, h, k0, n);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      outer4(s, sq + d * kF32Tile + 4 * ty, skt + d * kF32Tile + 4 * tx);
      outer4(dp, sg + d * kF32Tile + 4 * ty, svt + d * kF32Tile + 4 * tx);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + 4 * tx + j;
      const bool ok = col < n && col_valid<MASK>(col, len, n_audio);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[i][j] - m[i]) * linv[i];
        s[i][j] = ok ? p * (dp[i][j] - dl[i]) : 0.f;  // dS, 0 at masked keys
      }
      *reinterpret_cast<float4*>(sds + (4 * tx + j) * kF32Pad + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kF32Tile; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(sds + kk * kF32Pad + 4 * ty);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const float* kr = sk + kk * DH;
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const float ke = kr[out_col<DH>(tx, e)];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(xs[i], ke, acc[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < C; ++e) acc[i][e] *= sm_scale;
  }
  if (V::kRope && h < rope_heads) rope_adjoint_f32<DH>(acc, pos, n, tx, cos, sin);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pos[i] >= n) continue;
    float* row = dq + ((static_cast<long long>(b) * n + pos[i]) * heads + h) * DH;
#pragma unroll
    for (int e = 0; e < C; ++e) row[out_col<DH>(tx, e)] = acc[i][e];
  }
}

// Backward, dk/dv kernel: dK and dV of 64 keys of one head.
template <int DH, class V>
__global__ void __launch_bounds__(kF32Threads) attention_bwd_dkdv_f32_kernel(
    const View q, const View k, const View v, const View g, const int* __restrict__ lens,
    int n_audio, const float* __restrict__ cos, const float* __restrict__ sin,
    const float* __restrict__ row_max, const float* __restrict__ row_linv,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int n,
    int heads, int rope_heads) {
  constexpr int MASK = V::kMask;
  constexpr int C = DH / 16;
  constexpr int LD = DH + 1;  // padded rows of q' and dO: a value at a time, few conflicts
  extern __shared__ float4 smem_f32[];
  float* const skt = reinterpret_cast<float*>(smem_f32);  // [DH][64] K'^T
  float* const svt = skt + DH * kF32Tile;                  // [DH][64] V^T
  float* const sq = svt + DH * kF32Tile;                   // [64][LD] q'
  float* const sg = sq + kF32Tile * LD;                    // [64][LD] dO
  float* const sp = sg + kF32Tile * LD;                    // [64 rows][kF32Pad] P^T
  float* const sds = sp + kF32Tile * kF32Pad;              // [64 rows][kF32Pad] dS^T
  float* const sm = sds + kF32Tile * kF32Pad;              // the rows' m, linv, delta
  float* const sl = sm + kF32Tile;
  float* const sd = sl + kF32Tile;
  const int kb = blockIdx.x * kF32Tile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int len = lens[b];
  int pos[4];
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos[i] = kb + 4 * ty + i;
    ok[i] = col_valid<MASK>(pos[i], len, n_audio);
  }
  float ak[4][C] = {}, av[4][C] = {};
  // a tile none of whose keys is valid, in a row with a valid key, has
  // probabilities of exactly 0: dK = dV = 0
  if (!tile_dead<MASK>(kb, len, n_audio, n)) {
    load_t<DH>(skt, k, b, h, kb, n);
    load_t<DH>(svt, v, b, h, kb, n);
    const long long stat0 = (static_cast<long long>(b) * heads + h) * n;
    for (int q0 = 0; q0 < n; q0 += kF32Tile) {
      __syncthreads();
      load_rows<DH, LD>(sq, q, b, h, q0, n);
      load_rows<DH, LD>(sg, g, b, h, q0, n);
      if (threadIdx.x < kF32Tile) {
        const int r = q0 + threadIdx.x;
        const bool live = r < n;
        sm[threadIdx.x] = live ? row_max[stat0 + r] : 0.f;
        sl[threadIdx.x] = live ? row_linv[stat0 + r] : 0.f;  // rows past n: P = 0
        sd[threadIdx.x] = live ? delta[stat0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};  // [key i][row j]
#pragma unroll 2
      for (int d = 0; d < DH; ++d) {
        const float4 kx = *reinterpret_cast<const float4*>(skt + d * kF32Tile + 4 * ty);
        const float4 vx = *reinterpret_cast<const float4*>(svt + d * kF32Tile + 4 * ty);
        const float ks[4] = {kx.x, kx.y, kx.z, kx.w}, vs[4] = {vx.x, vx.y, vx.z, vx.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float qj = sq[(4 * tx + j) * LD + d], gj = sg[(4 * tx + j) * LD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(ks[i], qj, s[i][j]);
            dp[i][j] = fmaf(vs[i], gj, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tx + j;
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // keys past n are not keys: p = 0 (their dK, dV are not written)
          p[i] = pos[i] < n ? expf((ok[i] ? s[i][j] : kMaskValue) - sm[r]) * sl[r] : 0.f;
          ds[i] = ok[i] ? p[i] * (dp[i][j] - sd[r]) : 0.f;
        }
        *reinterpret_cast<float4*>(sp + r * kF32Pad + 4 * ty) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(sds + r * kF32Pad + 4 * ty) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kF32Tile; ++r) {
        const float4 px = *reinterpret_cast<const float4*>(sp + r * kF32Pad + 4 * ty);
        const float4 dx = *reinterpret_cast<const float4*>(sds + r * kF32Pad + 4 * ty);
        const float ps[4] = {px.x, px.y, px.z, px.w}, dss[4] = {dx.x, dx.y, dx.z, dx.w};
#pragma unroll
        for (int e = 0; e < C; ++e) {
          const int c = out_col<DH>(tx, e);
          const float ge = sg[r * LD + c], qe = sq[r * LD + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i][e] = fmaf(ps[i], ge, av[i][e]);
            ak[i][e] = fmaf(dss[i], qe, ak[i][e]);
          }
        }
      }
    }
    if (V::kRope && h < rope_heads) rope_adjoint_f32<DH>(ak, pos, n, tx, cos, sin);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pos[i] >= n) continue;
    const long long at = ((static_cast<long long>(b) * n + pos[i]) * heads + h) * DH;
#pragma unroll
    for (int e = 0; e < C; ++e) {
      dk[at + out_col<DH>(tx, e)] = ak[i][e];
      dv[at + out_col<DH>(tx, e)] = av[i][e];
    }
  }
}

template <int DH, class V, bool DELTA>
int launch_prep_f32(const Operands& a) {
  const long long warps = static_cast<long long>(a.batch) * a.n * a.heads;
  const View q = in_place(a.q, a.q_bs, a.q_rs, DH), k = in_place(a.k, a.k_bs, a.k_rs, DH);
  const View g = DELTA ? in_place(a.g, a.g_bs, a.g_rs, DH) : View{};
  const View o = DELTA ? in_place(a.o, a.o_bs, a.o_rs, DH) : View{};
  attention_prep_f32_kernel<DH, V, DELTA><<<static_cast<unsigned>((warps + 7) / 8), 256, 0,
                                            a.stream>>>(
      q, k, g, o, static_cast<const float*>(a.cos), static_cast<const float*>(a.sin),
      static_cast<float*>(a.qs), static_cast<float*>(a.ks), static_cast<float*>(a.delta),
      a.batch, a.n, a.heads, a.rope_heads, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The operands the main kernels read: q' from scratch, k' from scratch
// with RoPE and k in place without, v (and dO) in place.
template <int DH, class V>
void kernel_views(const Operands& a, View& q, View& k, View& v) {
  q = head_major(a.qs, a.heads, a.n, DH);
  k = V::kRope ? head_major(a.ks, a.heads, a.n, DH) : in_place(a.k, a.k_bs, a.k_rs, DH);
  v = in_place(a.v, a.v_bs, a.v_rs, DH);
}

template <int DH, class V>
int launch_fwd_f32(const Operands& a) {
  int err = launch_prep_f32<DH, V, false>(a);
  if (err != 0) return err;
  View q, k, v;
  kernel_views<DH, V>(a, q, k, v);
  const cudaError_t set = cudaFuncSetAttribute(
      attention_fwd_f32_kernel<DH, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_f32_smem<DH>());
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((a.n + kF32Tile - 1) / kF32Tile, a.heads, a.batch);
  attention_fwd_f32_kernel<DH, V><<<grid, kF32Threads, fwd_f32_smem<DH>(), a.stream>>>(
      q, k, v, static_cast<const int*>(a.lens), a.n_audio, static_cast<float*>(a.out),
      static_cast<float*>(a.row_max), static_cast<float*>(a.row_linv), a.n, a.heads);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, class V>
int launch_bwd_f32(const Operands& a) {
  typedef const float* cf;
  int err = launch_prep_f32<DH, V, true>(a);
  if (err != 0) return err;
  View q, k, v;
  kernel_views<DH, V>(a, q, k, v);
  const View g = in_place(a.g, a.g_bs, a.g_rs, DH);
  cudaError_t set = cudaFuncSetAttribute(attention_bwd_dq_f32_kernel<DH, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_f32_smem<DH>());
  if (set == cudaSuccess)
    set = cudaFuncSetAttribute(attention_bwd_dkdv_f32_kernel<DH, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_f32_smem<DH>());
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((a.n + kF32Tile - 1) / kF32Tile, a.heads, a.batch);
  const int* lens = static_cast<const int*>(a.lens);
  attention_bwd_dq_f32_kernel<DH, V><<<grid, kF32Threads, dq_f32_smem<DH>(), a.stream>>>(
      q, k, v, g, lens, a.n_audio, static_cast<cf>(a.cos), static_cast<cf>(a.sin),
      static_cast<cf>(a.row_max), static_cast<cf>(a.row_linv), static_cast<cf>(a.delta),
      static_cast<float*>(a.dq), a.n, a.heads, a.rope_heads, a.sm_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  attention_bwd_dkdv_f32_kernel<DH, V><<<grid, kF32Threads, dkdv_f32_smem<DH>(), a.stream>>>(
      q, k, v, g, lens, a.n_audio, static_cast<cf>(a.cos), static_cast<cf>(a.sin),
      static_cast<cf>(a.row_max), static_cast<cf>(a.row_linv), static_cast<cf>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.n, a.heads, a.rope_heads);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 forward of variant V: the pre-pass, then the main kernel, on
// `a.stream`; cudaGetLastError() after them, or cudaErrorInvalidValue for
// operands the kernels do not take. Pointers as `Operands`, every tensor
// fp32 (the scratch qs, ks too).
template <class V>
int attention_forward_f32(const Operands& a) {
  if (a.batch <= 0 || a.n <= 0 || a.heads <= 0 || a.qs == nullptr ||
      (V::kRope && a.ks == nullptr) || (a.row_max == nullptr) != (a.row_linv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh == 64) return launch_fwd_f32<64, V>(a);
  if (a.dh == 128) return launch_fwd_f32<128, V>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fp32 backward of variant V: the pre-pass, the dq kernel, then the dkdv
// kernel, on `a.stream`, as `attention_forward_f32`.
template <class V>
int attention_backward_f32(const Operands& a) {
  if (a.batch <= 0 || a.n <= 0 || a.heads <= 0 || a.qs == nullptr ||
      (V::kRope && a.ks == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dh == 64) return launch_bwd_f32<64, V>(a);
  if (a.dh == 128) return launch_bwd_f32<128, V>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
