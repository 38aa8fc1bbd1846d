// Gated-residual AdaLN forward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel f5e_tts_tpu/ops/pallas_norm.py:
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
