// Threefry-2x32 draws of jax.random (its default PRNG, in the partitionable
// counter layout), written by hand for Hopper (sm_90a): the f32 uniforms and
// the dropout of the DiT's training step.
//
// It replaces no TPU kernel. In the JAX package XLA fuses the threefry hash
// into the op that consumes it (dropout's `bernoulli` and `where`, the
// gumbel noise, the loss's noise), so a draw costs one pass. The port's
// plain version (ops/prng.py) emulates uint32 words in int64 torch ops, ~170
// elementwise ops an element, each moving 16-24 bytes: at the v1 step's 44
// dropout launches of (8, 2304, 1024) and (8, 2304, 2048) bf16 a micro-step
// that is terabytes of traffic. This kernel is that fused pass.
//
// What it computes, element e of a block of shape (l0, l1, l2) that sits at
// offset (o0, o1, o2) of a global array (g0, g1, g2):
//     ctr  = ((o0 + i0) g1 + o1 + i1) g2 + o2 + i2, as (hi, lo) 32-bit words
//     bits = y0 ^ y1 where (y0, y1) = threefry2x32((k0, k1), (hi, lo))
// so a block draws exactly its part of the stream of the global array (a
// rank of a mesh draws its rows or columns of the unsharded draw). Epilogues:
//     uniform: u = float((bits >> 9) | 0x3F800000) - 1, fmaxf(lo, fmaf(u, hi - lo, lo))
//              (one rounding, as XLA's fused multiply-add)
//     dropout: u < p ? x / c : 0 in x's dtype (bf16 or f32), with p = f32(1 - rate)
//              and c = 1 - rate rounded to x's dtype by the caller (JAX's weakly
//              typed scalar); the quotient is an IEEE f32 division rounded once.
// The backward of dropout is the same launch on the gradient: no mask is kept.
//
// Bound on this card: operations. An element costs the 20 rounds (add,
// funnel-shift rotate, xor) and 5 key injections of threefry, ~75 integer
// instructions, against 4-8 bytes of traffic for dropout and 4 for
// uniforms. The rotations and xors take the ALU pipe (64 lanes an SM a
// clock), while an add may issue as IMAD on the FMA pipe beside it, so the
// least time depends on how ptxas splits the adds: chip_smoke.py's
// `threefry_sass` counts the compiled loop by pipe and bounds it from that.
// Design: a grid-stride loop; each thread takes VEC consecutive elements (8
// for bf16, 4 for f32: one 16-byte load and store), walks their
// counters from the first one's (one division a group, 32-bit where the
// block has under 2^32 elements) and hashes them independently, so the
// compiler interleaves VEC hash chains. Rotations are `__funnelshift_l`.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

struct Layout {
  unsigned long long n;           // elements of the block
  unsigned long long l1, l2;      // its last two dims
  unsigned long long g1, g2;      // the global array's last two dims
  unsigned long long o0, o1, o2;  // the block's offset in the global array
};

struct Walk {  // the counter of a local element, stepped along the block
  unsigned long long ctr, i1, i2;
};

__host__ __device__ inline Walk walk_start(const Layout& L, unsigned long long e) {
  unsigned long long i0, i1, i2;
  if (L.n <= 0xFFFFFFFFull) {
    const unsigned e32 = (unsigned)e, l1 = (unsigned)L.l1, l2 = (unsigned)L.l2;
    const unsigned r = e32 / l2, q = r / l1;
    i2 = e32 - r * l2;
    i1 = r - q * l1;
    i0 = q;
  } else {
    const unsigned long long r = e / L.l2;
    i2 = e - r * L.l2;
    i0 = r / L.l1;
    i1 = r - i0 * L.l1;
  }
  Walk w;
  w.ctr = ((L.o0 + i0) * L.g1 + L.o1 + i1) * L.g2 + L.o2 + i2;
  w.i1 = i1;
  w.i2 = i2;
  return w;
}

__host__ __device__ inline void walk_next(const Layout& L, Walk& w) {
  ++w.ctr;
  if (++w.i2 == L.l2) {  // past the row: to the next row's first column of the block
    w.i2 = 0;
    w.ctr += L.g2 - L.l2;
    if (++w.i1 == L.l1) {  // past the plane: to the next plane's first row of the block
      w.i1 = 0;
      w.ctr += (L.g1 - L.l1) * L.g2;
    }
  }
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// jax/_src/prng.py: threefry2x32, 20 rounds, on the counter (hi, lo); the xor
// of the two output words (_threefry_random_bits_partitionable at 32 bits)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  unsigned long long ctr) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(ctr >> 32) + k0, x1 = (uint32_t)ctr + k1;
#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
  return x0 ^ x1;
}

__device__ __forceinline__ float unit(uint32_t bits) {  // [0, 1), as jax.random.uniform
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

struct UniformOut {
  float* out;
  float lo, span;
  template <int VEC>
  __device__ void operator()(unsigned long long e, const uint32_t (&b)[VEC], int count) const {
    float u[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) u[v] = fmaxf(lo, fmaf(unit(b[v]), span, lo));
    if (count == VEC) {
      *reinterpret_cast<float4*>(out + e) = make_float4(u[0], u[1], u[2], u[3]);
    } else {
      for (int v = 0; v < count; ++v) out[e + v] = u[v];
    }
  }
};

__device__ __forceinline__ float dropped(float x, uint32_t bits, float p, float c) {
  return unit(bits) < p ? __fdiv_rn(x, c) : 0.0f;
}

struct DropoutF32 {
  const float* x;
  float* out;
  float p, c;
  template <int VEC>
  __device__ void operator()(unsigned long long e, const uint32_t (&b)[VEC], int count) const {
    if (count == VEC) {
      const float4 v = *reinterpret_cast<const float4*>(x + e);
      *reinterpret_cast<float4*>(out + e) =
          make_float4(dropped(v.x, b[0], p, c), dropped(v.y, b[1], p, c),
                      dropped(v.z, b[2], p, c), dropped(v.w, b[3], p, c));
    } else {
      for (int v = 0; v < count; ++v) out[e + v] = dropped(x[e + v], b[v], p, c);
    }
  }
};

// bf16 vectors go through their 32-bit words (a bf16 pointer into a vector
// makes nvcc issue eight 16-bit accesses)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

struct DropoutBF16 {
  const uint16_t* x;
  uint16_t* out;
  float p, c;
  template <int VEC>
  __device__ void operator()(unsigned long long e, const uint32_t (&b)[VEC], int count) const {
    if (count == VEC) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + e);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = bf16_pack(dropped(bf16_lo(w[i]), b[2 * i], p, c),
                         dropped(bf16_hi(w[i]), b[2 * i + 1], p, c));
      }
      *reinterpret_cast<uint4*>(out + e) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      for (int v = 0; v < count; ++v) {
        const float f = __uint_as_float((uint32_t)x[e + v] << 16);
        out[e + v] = (uint16_t)bf16_bits(dropped(f, b[v], p, c));
      }
    }
  }
};

template <int VEC, class Epilogue>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(Layout L, uint32_t k0, uint32_t k1, Epilogue ep) {
  const unsigned long long groups = (L.n + VEC - 1) / VEC;
  const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
  for (unsigned long long g = (unsigned long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const unsigned long long e = g * VEC;
    Walk w = walk_start(L, e);
    uint32_t bits[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      bits[v] = threefry_bits(k0, k1, w.ctr);
      walk_next(L, w);
    }
    const unsigned long long left = L.n - e;
    ep(e, bits, left < (unsigned long long)VEC ? (int)left : VEC);
  }
}

Layout make_layout(long long l0, long long l1, long long l2, long long g1, long long g2,
                   long long o0, long long o1, long long o2) {
  Layout L;
  L.n = (unsigned long long)l0 * l1 * l2;
  L.l1 = l1;
  L.l2 = l2;
  L.g1 = g1;
  L.g2 = g2;
  L.o0 = o0;
  L.o1 = o1;
  L.o2 = o2;
  return L;
}

template <int VEC, class Epilogue>
int launch(const Layout& L, uint32_t k0, uint32_t k1, const Epilogue& ep, void* stream) {
  if (L.n == 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned long long groups = (L.n + VEC - 1) / VEC;
  const unsigned long long want = (groups + kThreads - 1) / kThreads;
  const unsigned long long cap = (unsigned long long)sms * kBlocksPerSM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  threefry_kernel<VEC><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(L, k0, k1, ep);
  return (int)cudaGetLastError();
}

}  // namespace

// Entry points: the key's two words, the output (and input), the block
// (l0, l1, l2) at offset (o0, o1, o2) of a global array whose last two dims
// are (g1, g2), and the stream. Pointers 16-byte aligned. Return the CUDA
// error of the launch (0: launched).

extern "C" int threefry_uniform(uint32_t k0, uint32_t k1, void* out, float lo, float hi,
                                long long l0, long long l1, long long l2, long long g1,
                                long long g2, long long o0, long long o1, long long o2,
                                void* stream) {
  const Layout L = make_layout(l0, l1, l2, g1, g2, o0, o1, o2);
  return launch<4>(L, k0, k1, UniformOut{static_cast<float*>(out), lo, hi - lo}, stream);
}

extern "C" int threefry_dropout_f32(uint32_t k0, uint32_t k1, const void* x, void* out, float p,
                                    float c, long long l0, long long l1, long long l2,
                                    long long g1, long long g2, long long o0, long long o1,
                                    long long o2, void* stream) {
  const Layout L = make_layout(l0, l1, l2, g1, g2, o0, o1, o2);
  return launch<4>(L, k0, k1,
                   DropoutF32{static_cast<const float*>(x), static_cast<float*>(out), p, c},
                   stream);
}

extern "C" int threefry_dropout_bf16(uint32_t k0, uint32_t k1, const void* x, void* out, float p,
                                     float c, long long l0, long long l1, long long l2,
                                     long long g1, long long g2, long long o0, long long o1,
                                     long long o2, void* stream) {
  const Layout L = make_layout(l0, l1, l2, g1, g2, o0, o1, o2);
  return launch<8>(L, k0, k1,
                   DropoutBF16{static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), p, c},
                   stream);
}
