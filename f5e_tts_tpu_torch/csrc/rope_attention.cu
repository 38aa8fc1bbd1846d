// Fused RoPE + attention forward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel f5e_tts_tpu/ops/pallas_attention.py:
// mha_chunked_rope (body _packed_rope_kernel). For q, k, v (B, N, H, dh) bf16,
// kv_lens (B,) int32 and half-split RoPE tables cos/sin (N, dh) fp32 it
// computes, per (batch, head),
//     out = softmax(rot(q) . rot(k)^T * dh^-0.5, key c valid iff c < kv_len) . v
// with rot(x) = x * cos + rot_half(x) * sin on heads h < rope_heads, where
// rot_half(x) = concat(-x[dh/2:], x[:dh/2]). As on the TPU: q is rotated in
// fp32, scaled, then rounded to bf16; each K tile is rotated in fp32 and
// rounded to bf16; masked scores are the finite -1e30; P.V accumulates in
// fp32 and is divided by max(l, 1e-30) at the end. A row whose keys are all
// masked (kv_len = 0) comes out as the uniform average over the N keys, as
// the TPU kernel's does.
//
// Bound on this card: operations. At the main path's shapes (B=2, N=1536,
// H=16, dh=64) the two products are ~4*B*H*N*kv*dh flops against ~26 MB of
// operands, ~600 flops per byte, above the H100's ~295 bf16 flops per byte.
// Design: the TPU kernel keeps one head's whole K/V in VMEM; K+V of one head
// at N=4096 is 1 MB against 227 KB of shared memory here, so the kernel
// streams K/V tiles with an online softmax (flash-attention style) instead.
// One block per (q-tile of 64 rows, head, batch), 4 warps of 16 query rows.
// The rotated, scaled Q tile lives in registers as mma.sync A fragments for
// the whole loop; each 64-key K tile is rotated into shared memory and V is
// stored transposed so both products read 32-bit fragment words without
// bank conflicts. Scores, softmax state and the O accumulator stay in
// registers (the m16n8k16 accumulator layout of S is reused as the A
// fragment of P). Key tiles past kv_len are skipped: their probabilities are
// exactly 0 in fp32, so skipping them changes no bit of the result.
// q/k/v are read through batch and row strides, so the column slices of the
// fused to_qkv projection (row stride 3*H*dh) go in without a copy; the
// head stride must be dh and the last axis contiguous.
// This is the first, simple version: mma.sync rather than wgmma, no TMA, no
// software pipelining of the tile loads.

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

typedef __nv_bfloat16 bf16;

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
template <int DH>
__device__ __forceinline__ void load_rotated(bf16 (*dst)[DH + 8], const bf16* src,
                                             long long row_stride, int row0, int n, bool rope,
                                             const float* cos, const float* sin, float scale) {
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

template <int DH>
__global__ void __launch_bounds__(kThreads) rope_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, const int* __restrict__ kv_lens, const float* __restrict__ cos,
    const float* __restrict__ sin, bf16* __restrict__ out, int n, int heads, int rope_heads,
    float sm_scale) {
  __shared__ __align__(16) bf16 ks[kBlockK][DH + 8];   // Q tile first, then K tiles
  __shared__ __align__(16) bf16 vts[DH][kBlockK + 8];  // V tile, transposed

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const bool rope = h < rope_heads;
  const int kv_len = kv_lens[b];

  const bf16* qb = q + b * q_bs + static_cast<long long>(h) * DH;
  const bf16* kb = k + b * k_bs + static_cast<long long>(h) * DH;
  const bf16* vb = v + b * v_bs + static_cast<long long>(h) * DH;

  // Q: rotate, fold in sm_scale, round to bf16, keep as A fragments.
  load_rotated<DH>(ks, qb, q_rs, q0, n, rope, cos, sin, sm_scale);
  __syncthreads();
  uint32_t qf[DH / 16][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    qf[kk][0] = ld_u32(&ks[wr + g][kk * 16 + 2 * t]);
    qf[kk][1] = ld_u32(&ks[wr + g + 8][kk * 16 + 2 * t]);
    qf[kk][2] = ld_u32(&ks[wr + g][kk * 16 + 2 * t + 8]);
    qf[kk][3] = ld_u32(&ks[wr + g + 8][kk * 16 + 2 * t + 8]);
  }
  __syncthreads();

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // running sum of exp

  // keys at or past kv_len get probability exactly 0 unless every key is masked
  const int kv_end = kv_len > 0 ? min(kv_len, n) : n;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    load_rotated<DH>(ks, kb, k_rs, k0, n, rope, cos, sin, 1.f);
    load_v_transposed<DH>(vts, vb, v_rs, k0, n);
    __syncthreads();

    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        mma_16816(s[j], qf[kk], ld_u32(&ks[j * 8 + g][kk * 16 + 2 * t]),
                  ld_u32(&ks[j * 8 + g][kk * 16 + 2 * t + 8]));
      }
    }

    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        if (col >= n) {
          s[j][e] = -INFINITY;  // past the sequence: not a key at all
        } else if (col >= kv_len) {
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

    // O += P V: the S accumulators of key tiles 2kk and 2kk+1 are exactly
    // the A fragment of P's 16-key slice kk.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        mma_16816(o[j], pa, ld_u32(&vts[j * 8 + g][kk * 16 + 2 * t]),
                  ld_u32(&vts[j * 8 + g][kk * 16 + 2 * t + 8]));
      }
    }
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
}

template <int DH>
int launch(const void* q, const void* k, const void* v, long long q_bs, long long q_rs,
           long long k_bs, long long k_rs, long long v_bs, long long v_rs, const void* kv_lens,
           const void* cos, const void* sin, void* out, int batch, int n, int heads,
           int rope_heads, float sm_scale, cudaStream_t stream) {
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  rope_attention_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, static_cast<const int*>(kv_lens),
      static_cast<const float*>(cos), static_cast<const float*>(sin), static_cast<bf16*>(out),
      n, heads, rope_heads, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v: device pointers to (B, N, H, dh) bf16 with the given batch and row
// strides (elements), head stride dh, contiguous last axis, 16-byte aligned
// rows. kv_lens (B,) int32; cos/sin (N, dh) fp32 contiguous; out (B, N, H, dh)
// bf16 contiguous. Returns cudaGetLastError() after the launch.
extern "C" int rope_attention_fwd(const void* q, const void* k, const void* v, long long q_bs,
                                  long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                  long long v_rs, const void* kv_lens, const void* cos,
                                  const void* sin, void* out, int batch, int n, int heads, int dh,
                                  int rope_heads, float sm_scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch<64>(q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, kv_lens, cos, sin, out, batch,
                      n, heads, rope_heads, sm_scale, s);
  if (dh == 128)
    return launch<128>(q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, kv_lens, cos, sin, out,
                       batch, n, heads, rope_heads, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
