// Gated-residual AdaLN forward (K2) and backward (K5), written by hand for
// Hopper (sm_90a).
//
// K2 replaces the TPU kernel f5e_tts_tpu/ops/pallas_norm.py:
// _gated_adaln_fwd_impl (body _gated_adaln_kernel). For x, y (B, N, D) bf16
// and gate/scale/shift (B, D) bf16 it writes, in one pass,
//     new_x = x + gate * y
//     out   = LayerNorm(new_x; eps, no affine) * (1 + scale) + shift
// with fp32 math. `out` is computed from the fp32 new_x, not from the bf16
// new_x that is stored.
//
// Bound on this card: bytes. Per row it reads 2*D and writes 2*D bf16 values
// and does ~10 flops per element, far under the H100's ~295 flops per byte,
// so the least time is (x + y + new_x + out) / 3.35 TB/s.
// Design: one block of 128 threads per row; each thread moves 16-byte
// vectors (8 bf16) and keeps its up-to-32 values in registers, so x and y
// are read from device memory once and both outputs are written once. Mean
// and variance are two block reductions over the register-resident row
// (var = mean((x - mean)^2), as the TPU kernel computes it).
//
// K5 replaces f5e_tts_tpu/ops/pallas_norm.py: _gated_adaln_bwd_impl (body
// _gated_adaln_bwd_kernel). From x, y, gate, scale and the two output
// cotangents g_newx, g_out it recomputes new_x, mean, r = rsqrt(var + eps)
// and xhat = (new_x - mean) * r in fp32, then
//     dxh  = g_out * (1 + scale)
//     dnx  = r * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) + g_newx
//     dx   = dnx,  dy = dnx * gate                       (B, N, D), bf16
//     dgate = sum_n dnx * y, dscale = sum_n g_out * xhat, dshift = sum_n g_out
// with the three (B, D) sums accumulated in fp32 and written in bf16.
// Bound on this card: bytes (x, y, g_newx, g_out read once, dx, dy written
// once; ~20 flops per element).
// Design: the TPU kernel carries the (B, D) sums over N on its sequential
// grid axis; blocks here run in no order, so the sums take two passes and
// no atomics, which keeps the result deterministic. Pass 1: one block of 256
// threads per group of kRowsPerBlock rows of one sample walks its rows one
// at a time (the row in registers, three block reductions per row) and keeps
// its columns' partial sums in registers, then writes them as fp32 partials
// (B, groups, 3, D). Pass 2: one thread per (sample, sum, column) adds the
// groups' partials in a fixed order and rounds to bf16. gate and scale are
// read through their row stride, as in K2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;        // bf16 values per 16-byte vector
constexpr int kMaxChunks = 4;  // D <= kThreads * kVec * kMaxChunks = 4096

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = kThreads / 64; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  t = __shfl_sync(0xffffffffu, t, 0);
  __syncthreads();  // `red` is reused by the next reduction
  return t;
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[kVec]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < kVec; ++i) f[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[kVec]) {
  uint4 v;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < kVec; ++i) e[i] = __float2bfloat16(f[i]);
  return v;
}

__global__ void __launch_bounds__(kThreads) gated_adaln_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ gate, const __nv_bfloat16* __restrict__ scale,
    const __nv_bfloat16* __restrict__ shift, long long gate_stride,
    long long scale_stride, long long shift_stride, __nv_bfloat16* __restrict__ new_x,
    __nv_bfloat16* __restrict__ out, int n, int d, float eps) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const long long b = row / n;
  const long long base = row * d;
  const __nv_bfloat16* g_row = gate + b * gate_stride;

  float v[kMaxChunks][kVec];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = (c * kThreads + threadIdx.x) * kVec;
    if (col < d) {
      float xf[kVec], yf[kVec], gf[kVec];
      unpack8(*reinterpret_cast<const uint4*>(x + base + col), xf);
      unpack8(*reinterpret_cast<const uint4*>(y + base + col), yf);
      unpack8(*reinterpret_cast<const uint4*>(g_row + col), gf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        v[c][i] = xf[i] + gf[i] * yf[i];
        sum += v[c][i];
      }
    }
  }
  const float mean = block_sum(sum, red) / d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = (c * kThreads + threadIdx.x) * kVec;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float t = v[c][i] - mean;
        sq += t * t;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / d + eps);

  const __nv_bfloat16* s_row = scale + b * scale_stride;
  const __nv_bfloat16* h_row = shift + b * shift_stride;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = (c * kThreads + threadIdx.x) * kVec;
    if (col < d) {
      float sf[kVec], hf[kVec], of[kVec];
      unpack8(*reinterpret_cast<const uint4*>(s_row + col), sf);
      unpack8(*reinterpret_cast<const uint4*>(h_row + col), hf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) of[i] = (v[c][i] - mean) * rstd * (1.f + sf[i]) + hf[i];
      *reinterpret_cast<uint4*>(new_x + base + col) = pack8(v[c]);
      *reinterpret_cast<uint4*>(out + base + col) = pack8(of);
    }
  }
}

constexpr int kBwdThreads = 256;
constexpr int kRowsPerBlock = 32;

// Sums of two values over the block; `red` holds 2 * kBwdThreads / 32 floats.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  constexpr int kWarps = kBwdThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  float ta = lane < kWarps ? red[lane] : 0.f;
  float tb = lane < kWarps ? red[kWarps + lane] : 0.f;
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) {
    ta += __shfl_xor_sync(0xffffffffu, ta, o);
    tb += __shfl_xor_sync(0xffffffffu, tb, o);
  }
  ta = __shfl_sync(0xffffffffu, ta, 0);
  tb = __shfl_sync(0xffffffffu, tb, 0);
  __syncthreads();  // `red` is reused by the next reduction
  return make_float2(ta, tb);
}

// Pass 1 of K5. Grid (groups, B); block b, g covers rows [g*R, g*R + R) of
// sample b. C = 16-byte chunks per thread, D <= kBwdThreads * 8 * C.
template <int C>
__global__ void __launch_bounds__(kBwdThreads) gated_adaln_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ gate, const __nv_bfloat16* __restrict__ scale,
    long long gate_stride, long long scale_stride, const __nv_bfloat16* __restrict__ g_newx,
    const __nv_bfloat16* __restrict__ g_out, __nv_bfloat16* __restrict__ dx,
    __nv_bfloat16* __restrict__ dy, float* __restrict__ partial, int n, int d, float eps) {
  __shared__ float red[2 * kBwdThreads / 32];
  const int group = blockIdx.x;
  const long long b = blockIdx.y;
  const int row_end = min(n, (group + 1) * kRowsPerBlock);
  const __nv_bfloat16* g_row = gate + b * gate_stride;
  const __nv_bfloat16* s_row = scale + b * scale_stride;

  float acc_g[C][kVec], acc_s[C][kVec], acc_h[C][kVec];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc_g[c][i] = acc_s[c][i] = acc_h[c][i] = 0.f;
  }

  for (int row = group * kRowsPerBlock; row < row_end; ++row) {
    const long long base = (b * n + row) * d;
    float nx[C][kVec];  // new_x, then xhat
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * kBwdThreads + threadIdx.x) * kVec;
      if (col < d) {
        float xf[kVec], yf[kVec], gf[kVec];
        unpack8(*reinterpret_cast<const uint4*>(x + base + col), xf);
        unpack8(*reinterpret_cast<const uint4*>(y + base + col), yf);
        unpack8(*reinterpret_cast<const uint4*>(g_row + col), gf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          nx[c][i] = xf[i] + gf[i] * yf[i];
          sum += nx[c][i];
        }
      }
    }
    const float mean = block_sum2(sum, 0.f, red).x / d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * kBwdThreads + threadIdx.x) * kVec;
      if (col < d) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float t = nx[c][i] - mean;
          sq += t * t;
        }
      }
    }
    const float r = rsqrtf(block_sum2(sq, 0.f, red).x / d + eps);

    float dxh[C][kVec];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * kBwdThreads + threadIdx.x) * kVec;
      if (col < d) {
        float go[kVec], sf[kVec];
        unpack8(*reinterpret_cast<const uint4*>(g_out + base + col), go);
        unpack8(*reinterpret_cast<const uint4*>(s_row + col), sf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          nx[c][i] = (nx[c][i] - mean) * r;  // xhat
          dxh[c][i] = go[i] * (1.f + sf[i]);
          s1 += dxh[c][i];
          s2 += dxh[c][i] * nx[c][i];
          acc_s[c][i] += go[i] * nx[c][i];
          acc_h[c][i] += go[i];
        }
      }
    }
    const float2 m = block_sum2(s1, s2, red);
    const float m1 = m.x / d, m2 = m.y / d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * kBwdThreads + threadIdx.x) * kVec;
      if (col < d) {
        float gn[kVec], yf[kVec], gf[kVec], dxo[kVec], dyo[kVec];
        unpack8(*reinterpret_cast<const uint4*>(g_newx + base + col), gn);
        unpack8(*reinterpret_cast<const uint4*>(y + base + col), yf);  // cached since pass start
        unpack8(*reinterpret_cast<const uint4*>(g_row + col), gf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float dnx = r * (dxh[c][i] - m1 - nx[c][i] * m2) + gn[i];
          dxo[i] = dnx;
          dyo[i] = dnx * gf[i];
          acc_g[c][i] += dnx * yf[i];
        }
        *reinterpret_cast<uint4*>(dx + base + col) = pack8(dxo);
        *reinterpret_cast<uint4*>(dy + base + col) = pack8(dyo);
      }
    }
  }

  const int groups = gridDim.x;
  float* p = partial + (b * groups + group) * 3LL * d;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (c * kBwdThreads + threadIdx.x) * kVec;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        p[col + i] = acc_g[c][i];
        p[d + col + i] = acc_s[c][i];
        p[2 * d + col + i] = acc_h[c][i];
      }
    }
  }
}

// Pass 2 of K5: out_k[b, col] = bf16(sum over groups of partial[b, g, k, col])
// for k = 0 (dgate), 1 (dscale), 2 (dshift); groups added in order.
__global__ void gated_adaln_bwd_reduce_kernel(const float* __restrict__ partial, int batch,
                                              int groups, int d,
                                              __nv_bfloat16* __restrict__ dgate,
                                              __nv_bfloat16* __restrict__ dscale,
                                              __nv_bfloat16* __restrict__ dshift) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 3LL * batch * d) return;
  const int col = static_cast<int>(idx % d);
  const int k = static_cast<int>((idx / d) % 3);
  const long long b = idx / (3LL * d);
  const float* p = partial + (b * groups * 3LL + k) * d + col;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += p[g * 3LL * d];
  __nv_bfloat16* out = k == 0 ? dgate : (k == 1 ? dscale : dshift);
  out[b * d + col] = __float2bfloat16(s);
}

}  // namespace

// rows = B * N. Pointers are device pointers; x, y, new_x, out are (B, N, D)
// contiguous; gate/scale/shift rows start `*_stride` elements apart. D must
// be a multiple of 8 and at most 4096, and every pointer and stride 16-byte
// aligned (the Python wrapper checks). Returns cudaGetLastError().
extern "C" int gated_adaln_fwd(const void* x, const void* y, const void* gate,
                               const void* scale, const void* shift, long long gate_stride,
                               long long scale_stride, long long shift_stride, void* new_x,
                               void* out, int rows, int n, int d, float eps, void* stream) {
  if (d % kVec != 0 || d > kThreads * kVec * kMaxChunks || rows <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gated_adaln_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(gate), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(shift), gate_stride, scale_stride, shift_stride,
      static_cast<__nv_bfloat16*>(new_x), static_cast<__nv_bfloat16*>(out), n, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// Number of row groups of K5's first pass: the caller allocates the fp32
// partials (B, groups, 3, D).
extern "C" int gated_adaln_bwd_groups(int n) { return (n + kRowsPerBlock - 1) / kRowsPerBlock; }

// K5. x, y, g_newx, g_out, dx, dy are (B, N, D) contiguous; gate/scale rows
// start `*_stride` elements apart; partial is fp32 (B, groups, 3, D);
// dgate/dscale/dshift are (B, D) contiguous. D must be a multiple of 8 and
// at most 4096, every pointer and stride 16-byte aligned. Launches both
// passes; returns cudaGetLastError() after them.
extern "C" int gated_adaln_bwd(const void* x, const void* y, const void* gate,
                               const void* scale, long long gate_stride,
                               long long scale_stride, const void* g_newx, const void* g_out,
                               void* dx, void* dy, void* partial, void* dgate, void* dscale,
                               void* dshift, int batch, int n, int d, float eps, void* stream) {
  if (d % kVec != 0 || d > kBwdThreads * kVec * 2 || batch <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef const __nv_bfloat16* cb;
  typedef __nv_bfloat16* mb;
  const int groups = gated_adaln_bwd_groups(n);
  const dim3 grid(groups, batch);
  if (d <= kBwdThreads * kVec) {
    gated_adaln_bwd_kernel<1><<<grid, kBwdThreads, 0, s>>>(
        static_cast<cb>(x), static_cast<cb>(y), static_cast<cb>(gate), static_cast<cb>(scale),
        gate_stride, scale_stride, static_cast<cb>(g_newx), static_cast<cb>(g_out),
        static_cast<mb>(dx), static_cast<mb>(dy), static_cast<float*>(partial), n, d, eps);
  } else {
    gated_adaln_bwd_kernel<2><<<grid, kBwdThreads, 0, s>>>(
        static_cast<cb>(x), static_cast<cb>(y), static_cast<cb>(gate), static_cast<cb>(scale),
        gate_stride, scale_stride, static_cast<cb>(g_newx), static_cast<cb>(g_out),
        static_cast<mb>(dx), static_cast<mb>(dy), static_cast<float*>(partial), n, d, eps);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long total = 3LL * batch * d;
  gated_adaln_bwd_reduce_kernel<<<static_cast<int>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), batch, groups, d, static_cast<mb>(dgate),
      static_cast<mb>(dscale), static_cast<mb>(dshift));
  return static_cast<int>(cudaGetLastError());
}
