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
// and does ~11 flops per element, far under the H100's ~295 flops per byte,
// so the least time is (x + y + new_x + out) / 3.35 TB/s: 7.5 us at
// (2, 1536, 1024), 25 MB, where launch and tail costs weigh.
// Design (as K5's first pass):
// - One warp a row, no block barrier in the row loop. Lane l holds the
//   16-byte vectors c*32 + l (c < V) of its row, V = ceil(D / 256) a template
//   parameter (V = 3 at D = 768, 4 at D = 1024: no lane idles at either), in
//   registers, so x and y are read from device memory once and both outputs
//   are written once. Mean and variance are warp shuffles, the variance as
//   mean((x - mean)^2) over the register-resident row, as the TPU kernel.
// - Every load and store is one 128-bit access, unpacked and packed by bit
//   operations on the vector's four words (Vec<T>::unpack, pack): a
//   bf16 pointer into a vector makes nvcc issue eight 16-bit accesses.
// - gate, scale and shift belong to the sample, not the row: a block's
//   warps all work on rows of one sample (grid (row groups, B)), and the
//   block stages the sample's three vectors in shared memory once.
// - Up to D = 1024 the loads of a warp's next row are issued before the
//   current row's reductions, so each warp has two rows' loads in flight;
//   the host sizes the grid to the card's resident blocks (one wave), at
//   least kFwdMinRows rows a warp where N allows. At (2, 1536, 1024): 2 x
//   96 blocks of 8 warps, 2 rows a warp, 127 registers, no spill.
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
// once; ~20 flops per element). At (8, 2304, 1024) that is 226.5 MB, 0.0676
// ms at the data sheet's 3.35 TB/s.
// Design, in two passes and without atomics, so two runs give the same bits
// (blocks run in no order here, while the TPU kernel carries the (B, D) sums
// over N on its sequential grid axis):
// - Pass 1 (gated_adaln_bwd_kernel): one warp works on one row at a time,
//   its lanes on the row's columns as 16-byte vectors (V vectors a lane, a
//   template parameter, so at D = 1024 every lane has 4 and none idles).
//   The row statistics are three rounds of warp shuffles (mean; variance;
//   mean(dxh) with mean(dxh * xhat)): no block barrier inside the row loop.
//   A lane's vectors past D are staged as zeros, so the row's passes have no
//   branch on them.
// - Each lane stages its own columns of the four input rows of its warp's
//   row in shared memory with cp.async, kBwdStages rows deep: the next row's
//   loads are issued before the current row's first reduction, so every
//   warp has a row (8 KB at D = 1024) in flight, ~64 KB an SM; y is read
//   from device memory once. A lane reads back only what it copied itself,
//   so the wait for its own copies is its only synchronisation, and it reads
//   each vector back as one 128-bit load (Vec<T>::unpack). gate and scale
//   belong to the sample, not the row: they are loaded once per block.
// - Up to V = 4 a lane keeps its columns' three sums in registers across its
//   rows, and a row's new_x while it works on it; above, the sums live in
//   its own slots of shared memory and new_x is formed again from the staged
//   row each time it is needed (registers would spill). The warps' sums are
//   added in warp order in shared memory and written as one fp32 partial
//   (3, D) per block.
// - The host picks the blocks a sample from B, N and the card's block slots
//   (SM count times the kernel's occupancy, asked once a device and V by
//   `bwd_plan`), so that the grid fills the SMs in one wave where it can: at
//   (8, 2304, 1024) 8 x 16 blocks of 8 warps on 132 SMs, 18 rows a warp.
//   Warp w of block g takes rows g*W + w, then every G*W-th (G blocks of W
//   warps a sample), so any G is correct. The split depends only on the
//   shapes and the card, never on timing.
// - Pass 2 (gated_adaln_bwd_reduce_kernel): one thread per (sample, sum,
//   4 columns) adds the blocks' partials in a fixed order and rounds to bf16.
// gate and scale are read through their row stride, as in K2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kMaxDevices = 64;  // devices whose launch plans are cached

// fp32 -> bf16 (round to nearest even) of two values as one word, lo in the
// low half
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// A 16-byte vector of T as kVec fp32 values, and back, by bit operations on
// its four words: a vector stays one 128-bit access (through a pointer to
// its bf16 elements nvcc issues eight 16-bit loads)
template <class T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kVec = 8;  // element 2j in the low half of word j
  static __device__ __forceinline__ void unpack(const uint4 v, float (&f)[kVec]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

template <>
struct Vec<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const uint4 v, float (&f)[kVec]) {
    f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// K2.
constexpr int kFwdWarps = 8;     // warps of a block
constexpr int kFwdMinRows = 2;   // rows a warp at least, where N allows
constexpr int kFwdAheadMaxV = 4;  // up to this V a warp loads its next row ahead

template <class T>
struct FwdArgs {
  const T* x;  // (B, N, D)
  const T* y;
  const T* mod[3];  // gate, scale, shift: row b at mod[k] + b * mod_stride[k]
  long long mod_stride[3];
  T* new_x;  // (B, N, D)
  T* out;
  int n, d;
  float eps;
};

// Grid (G, B) of blocks of W warps: warp w of block (g, b) takes rows
// g*W + w, then every G*W-th, of sample b. Lane l holds the vectors c*32 + l
// (c < V) of a row; those past D are zeros, which add nothing to the mean,
// are masked out of the variance and are not stored. Up to V = 4 the next
// row's x and y are loaded during this row's reductions; above, the row's
// 8V values a lane of new_x fill the registers (V = 16: 128), and each row
// is loaded when its turn comes.
template <int V, class T, bool kAhead = (V <= kFwdAheadMaxV)>
__global__ void __launch_bounds__(kFwdWarps * 32) gated_adaln_kernel(
    const __grid_constant__ FwdArgs<T> a) {
  constexpr int kVec = Vec<T>::kVec;
  __shared__ uint4 mod[3][V * 32];  // the sample's gate, scale, shift vectors
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int nv = a.d / kVec;
  const long long b = blockIdx.y;
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T* row = a.mod[k] + b * a.mod_stride[k];
    for (int v = threadIdx.x; v < V * 32; v += blockDim.x) {
      mod[k][v] = v < nv ? *reinterpret_cast<const uint4*>(row + v * kVec) : zero;
    }
  }
  __syncthreads();

  const int stride = gridDim.x * warps;
  auto load = [&](int row, uint4(&xv)[V], uint4(&yv)[V]) {
    const long long base = (b * a.n + row) * a.d;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int v = c * 32 + lane;
      const bool ok = row < a.n && v < nv;
      xv[c] = ok ? *reinterpret_cast<const uint4*>(a.x + base + v * kVec) : zero;
      yv[c] = ok ? *reinterpret_cast<const uint4*>(a.y + base + v * kVec) : zero;
    }
  };
  uint4 xr[V], yr[V];
  int row = blockIdx.x * warps + warp;
  if constexpr (kAhead) load(row, xr, yr);
  for (; row < a.n; row += stride) {
    uint4 xn[kAhead ? V : 1], yn[kAhead ? V : 1];
    if constexpr (kAhead) {
      load(row + stride, xn, yn);  // in flight while this row is reduced
    } else {
      load(row, xr, yr);
    }

    float h[V][kVec];  // new_x in fp32
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float xf[kVec], yf[kVec], gf[kVec];
      Vec<T>::unpack(xr[c], xf);
      Vec<T>::unpack(yr[c], yf);
      Vec<T>::unpack(mod[0][c * 32 + lane], gf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        h[c][i] = xf[i] + gf[i] * yf[i];
        sum += h[c][i];
      }
    }
    const float mean = warp_sum(sum) / a.d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float t = h[c][i] - mean;
        part += t * t;
      }
      sq += c * 32 + lane < nv ? part : 0.f;
    }
    const float rstd = rsqrtf(warp_sum(sq) / a.d + a.eps);

    const long long base = (b * a.n + row) * a.d;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int v = c * 32 + lane;
      if (v < nv) {
        float sf[kVec], hf[kVec], of[kVec];
        Vec<T>::unpack(mod[1][v], sf);
        Vec<T>::unpack(mod[2][v], hf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) of[i] = (h[c][i] - mean) * rstd * (1.f + sf[i]) + hf[i];
        *reinterpret_cast<uint4*>(a.new_x + base + v * kVec) = Vec<T>::pack(h[c]);
        *reinterpret_cast<uint4*>(a.out + base + v * kVec) = Vec<T>::pack(of);
      }
      if constexpr (kAhead) {
        xr[c] = xn[c];
        yr[c] = yn[c];
      }
    }
  }
}

// Blocks of K2 with V vectors a lane that the current device holds at once
// (SM count times the kernel's occupancy), asked once a device and V.
template <int V, class T>
cudaError_t fwd_slots(int& slots) {
  static int cache[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gated_adaln_kernel<V, T>,
                                                          kFwdWarps * 32, 0);
    }
    if (err != cudaSuccess) return err;
    cache[dev] = std::max(1, sms * per_sm);
  }
  slots = cache[dev];
  return cudaSuccess;
}

// K2 on (batch, a.n, a.d): G blocks a sample, as many as fill the card's
// resident blocks once, with kFwdMinRows rows a warp at least where N allows
// (one above V = 4, where a warp loads no row ahead and few warps fit an SM).
template <int V, class T>
cudaError_t fwd_launch(const FwdArgs<T>& a, int batch, cudaStream_t s) {
  int slots = 0;
  const cudaError_t err = fwd_slots<V, T>(slots);
  if (err != cudaSuccess) return err;
  const int per_block = kFwdWarps * (V <= kFwdAheadMaxV ? kFwdMinRows : 1);
  const int groups = std::max(1, std::min((a.n + per_block - 1) / per_block, slots / batch));
  gated_adaln_kernel<V, T><<<dim3(groups, batch), kFwdWarps * 32, 0, s>>>(a);
  return cudaGetLastError();
}

// V = ceil(D / (32 kVec)) vectors a lane, rounded up to 8 or 16 above 4
// (at most 16: the width rule).
template <class T>
cudaError_t fwd_launch_any(const FwdArgs<T>& a, int batch, cudaStream_t s) {
  const int need = (a.d / Vec<T>::kVec + 31) / 32;
  switch (need <= 4 ? need : (need <= 8 ? 8 : 16)) {
    case 1: return fwd_launch<1, T>(a, batch, s);
    case 2: return fwd_launch<2, T>(a, batch, s);
    case 3: return fwd_launch<3, T>(a, batch, s);
    case 4: return fwd_launch<4, T>(a, batch, s);
    case 8: return fwd_launch<8, T>(a, batch, s);
    default: return fwd_launch<16, T>(a, batch, s);
  }
}

// ---------------------------------------------------------------------------
// K5, pass 1.
constexpr int kBwdStages = 2;    // staged rows a warp: the one it works on + one in flight
constexpr int kBwdMaxWarps = 8;  // warps of a block, where shared memory allows
constexpr int kBwdTensors = 4;   // x, y, g_out, g_newx, staged in this order
constexpr int kBwdRegsMaxValues = 32;  // up to this many a lane the column sums stay in registers

// Whether a lane of K5 keeps its columns' sums (and a row's new_x) in
// registers: V vectors of T are V * kVec values.
template <int V, class T>
__host__ __device__ constexpr bool bwd_regs() {
  return V * Vec<T>::kVec <= kBwdRegsMaxValues;
}

template <class T>
struct BwdArgs {
  const T* src[kBwdTensors];  // x, y, g_out, g_newx: (B, N, D)
  const T* gate;
  const T* scale;
  long long gate_stride, scale_stride;
  T* dx;
  T* dy;
  float* partial;  // (B, gridDim.x, 3, D)
  int n, d;
  float eps;
};

// 16 bytes from device to shared memory, or 16 zero bytes (nothing read)
// where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float2 warp_sum2(float a, float b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  return make_float2(a, b);
}

// Sum k (0 dgate, 1 dscale, 2 dshift) of vector c of this lane += v: in
// registers, or in the lane's float4 slots [k][c][quarter] (kVec / 4 of them
// a vector, 32 apart, one per lane, so a warp's accesses do not conflict).
template <int V, int kVec, bool kRegs>
__device__ __forceinline__ void add_sums(float (&acc)[kRegs ? 3 : 1][kRegs ? V : 1][kVec],
                                         float4* my_sums, int k, int c, const float (&v)[kVec]) {
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[k][c][i] += v[i];
  } else {
    float4* p = my_sums + (k * V + c) * (kVec / 4) * 32;
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      float4 t = p[q * 32];
      t.x += v[4 * q], t.y += v[4 * q + 1], t.z += v[4 * q + 2], t.w += v[4 * q + 3];
      p[q * 32] = t;
    }
  }
}

// Grid (G, B) of blocks of W warps: warp w of block (g, b) takes rows
// g*W + w, then every G*W-th, of sample b. Lane l holds the 16-byte vectors
// c*32 + l (c < V) of a row. Dynamic shared memory: gate and scale [2][V*32]
// uint4, each warp's ring [kBwdStages][kBwdTensors][V][32] uint4, and with
// kRegs false each warp's sums [3][V][kVec/4][32] float4 (with kRegs true the
// sums take the ring's place after the row loop).
template <int V, class T>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, 1) gated_adaln_bwd_kernel(
    const __grid_constant__ BwdArgs<T> a) {
  constexpr int kVec = Vec<T>::kVec;
  constexpr int kQuads = kVec / 4;  // float4s of sums a vector
  constexpr bool kRegs = bwd_regs<V, T>();
  extern __shared__ uint4 smem[];
  constexpr int kRow = kBwdTensors * V * 32;  // uint4 slots of one warp's staged row
  constexpr int kSums = 3 * V * kQuads * 32;  // float4 slots of one warp's sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int nv = a.d / kVec;
  const int group = blockIdx.x;
  const long long b = blockIdx.y;
  uint4* const mod = smem;
  uint4* const ring = smem + 2 * V * 32;
  uint4* const mine = ring + warp * kBwdStages * kRow + lane;
  float4* const sums = reinterpret_cast<float4*>(kRegs ? ring : ring + warps * kBwdStages * kRow);
  float4* const my_sums = sums + warp * kSums + lane;

  for (int i = threadIdx.x; i < 2 * V * 32; i += blockDim.x) {
    const int v = i % (V * 32);
    const T* row = i < V * 32 ? a.gate + b * a.gate_stride : a.scale + b * a.scale_stride;
    mod[i] = v < nv ? *reinterpret_cast<const uint4*>(row + v * kVec) : make_uint4(0, 0, 0, 0);
  }
  float acc[kRegs ? 3 : 1][kRegs ? V : 1][kVec];
  if constexpr (kRegs) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int c = 0; c < V; ++c)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[k][c][i] = 0.f;
  } else {
    for (int s = 0; s < kSums / 32; ++s) my_sums[s * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // this warp's rows: first, first + stride, ... below N; at any moment
  // the warps of a sample's blocks work on neighbouring rows
  const int first = group * warps + warp, stride = gridDim.x * warps;
  // one commit group per staged row, empty past the last row, so that
  // "all but the newest kBwdStages - 1 groups" is always the current row
  auto stage_row = [&](int row, int stage) {
    if (row < a.n) {
      const long long base = (b * a.n + row) * a.d;
      uint4* dst = mine + stage * kRow;
#pragma unroll
      for (int t = 0; t < kBwdTensors; ++t) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const int v = c * 32 + lane;
          cp_async16(dst + (t * V + c) * 32, a.src[t] + base + (v < nv ? v * kVec : 0), v < nv);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) stage_row(first + s * stride, s);

  int it = 0;
  for (int row = first; row < a.n; row += stride, ++it) {
    stage_row(row + (kBwdStages - 1) * stride, (it + kBwdStages - 1) % kBwdStages);
    cp_async_wait<kBwdStages - 1>();
    const uint4* cur = mine + (it % kBwdStages) * kRow;  // [tensor * V + c] * 32
    const long long base = (b * a.n + row) * a.d;

    // new_x of this lane's columns: held in registers on the register path,
    // else formed again from the staged x, y and gate (registers would spill)
    float held[kRegs ? V : 1][kVec];
    auto new_x = [&](int c, float (&nx)[kVec]) {
      if constexpr (kRegs) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) nx[i] = held[c][i];
      } else {
        float xf[kVec], yf[kVec], gf[kVec];
        Vec<T>::unpack(cur[c * 32], xf);
        Vec<T>::unpack(cur[(V + c) * 32], yf);
        Vec<T>::unpack(mod[c * 32 + lane], gf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) nx[i] = xf[i] + gf[i] * yf[i];
      }
    };
    // No branch on a vector's validity: a lane's vectors past D were staged
    // as zeros, so they add 0 to every sum but the variance's, which masks
    // them, and only their stores are skipped. The compiler can then
    // interleave a lane's vectors.
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float xf[kVec], yf[kVec], gf[kVec];
      Vec<T>::unpack(cur[c * 32], xf);
      Vec<T>::unpack(cur[(V + c) * 32], yf);
      Vec<T>::unpack(mod[c * 32 + lane], gf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float nx = xf[i] + gf[i] * yf[i];
        if constexpr (kRegs) held[c][i] = nx;
        sum += nx;
      }
    }
    const float mean = warp_sum(sum) / a.d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float nx[kVec], part = 0.f;
      new_x(c, nx);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float t = nx[i] - mean;
        part += t * t;
      }
      sq += c * 32 + lane < nv ? part : 0.f;
    }
    const float r = rsqrtf(warp_sum(sq) / a.d + a.eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float xh[kVec], go[kVec], sf[kVec], gx[kVec];
      new_x(c, xh);
      Vec<T>::unpack(cur[(2 * V + c) * 32], go);
      Vec<T>::unpack(mod[(V + c) * 32 + lane], sf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        xh[i] = (xh[i] - mean) * r;
        const float dxh = go[i] * (1.f + sf[i]);
        s1 += dxh;
        s2 += dxh * xh[i];
        gx[i] = go[i] * xh[i];
      }
      add_sums<V, kVec, kRegs>(acc, my_sums, 1, c, gx);
      add_sums<V, kVec, kRegs>(acc, my_sums, 2, c, go);
    }
    const float2 m = warp_sum2(s1, s2);
    const float m1 = m.x / a.d, m2 = m.y / a.d;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float nx[kVec], go[kVec], sf[kVec], gn[kVec], yf[kVec], gf[kVec];
      float dxo[kVec], dyo[kVec], dg[kVec];
      new_x(c, nx);
      Vec<T>::unpack(cur[(2 * V + c) * 32], go);
      Vec<T>::unpack(cur[(3 * V + c) * 32], gn);
      Vec<T>::unpack(cur[(V + c) * 32], yf);
      Vec<T>::unpack(mod[(V + c) * 32 + lane], sf);
      Vec<T>::unpack(mod[c * 32 + lane], gf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xhat = (nx[i] - mean) * r;
        const float dnx = r * (go[i] * (1.f + sf[i]) - m1 - xhat * m2) + gn[i];
        dxo[i] = dnx;
        dyo[i] = dnx * gf[i];
        dg[i] = dnx * yf[i];
      }
      add_sums<V, kVec, kRegs>(acc, my_sums, 0, c, dg);
      const int v = c * 32 + lane;
      if (v < nv) {
        *reinterpret_cast<uint4*>(a.dx + base + v * kVec) = Vec<T>::pack(dxo);
        *reinterpret_cast<uint4*>(a.dy + base + v * kVec) = Vec<T>::pack(dyo);
      }
    }
  }

  cp_async_wait<0>();
  if constexpr (kRegs) {
    __syncthreads();  // every warp is done with the ring, which takes the sums
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float* s = acc[k][c];
#pragma unroll
        for (int q = 0; q < kQuads; ++q)
          my_sums[((k * V + c) * kQuads + q) * 32] =
              make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      }
    }
  }
  __syncthreads();
  // float4 i of the block's (3, D) partial: sum k = i / (kQuads nv), vector
  // v = (i / kQuads) % nv, quarter i % kQuads; the warps' sums added in warp
  // order
  float4* out = reinterpret_cast<float4*>(a.partial + (b * gridDim.x + group) * 3LL * a.d);
  for (int i = threadIdx.x; i < 3 * kQuads * nv; i += blockDim.x) {
    const int k = i / (kQuads * nv), v = (i / kQuads) % nv;
    const int slot = ((k * V + v / 32) * kQuads + i % kQuads) * 32 + v % 32;
    float4 s = sums[slot];
    for (int w = 1; w < warps; ++w) {
      const float4 t = sums[w * kSums + slot];
      s.x += t.x, s.y += t.y, s.z += t.z, s.w += t.w;
    }
    out[i] = s;
  }
}

// The four sums of one thread of pass 2 as T at `out`.
__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 s) {
  __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(s.x, s.y), __floats2bfloat162_rn(s.z, s.w)};
  *reinterpret_cast<uint2*>(out) = *reinterpret_cast<const uint2*>(pair);
}
__device__ __forceinline__ void store4(float* out, float4 s) {
  *reinterpret_cast<float4*>(out) = s;
}

// Pass 2 of K5: out_k[b, col] = T(sum over groups of partial[b, g, k, col])
// for k = 0 (dgate), 1 (dscale), 2 (dshift), the groups added in order. One
// thread per 4 columns of one sum; its loads do not wait on the adds.
template <class T>
__global__ void gated_adaln_bwd_reduce_kernel(const float* __restrict__ partial, int batch,
                                              int groups, int d, T* __restrict__ dgate,
                                              T* __restrict__ dscale, T* __restrict__ dshift) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int quads = d / 4;
  if (idx >= 3LL * batch * quads) return;
  const int col = static_cast<int>(idx % quads) * 4;
  const int k = static_cast<int>((idx / quads) % 3);
  const long long b = idx / (3LL * quads);
  const float4* p = reinterpret_cast<const float4*>(partial + (b * groups * 3LL + k) * d + col);
  const long long stride = 3LL * quads;  // float4s from one group to the next
  float4 s = p[0];
  for (int g0 = 1; g0 < groups; g0 += 16) {  // 16 loads in flight, then their adds
    float4 t[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (g0 + j < groups) t[j] = p[(g0 + j) * stride];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (g0 + j < groups) s.x += t[j].x, s.y += t[j].y, s.z += t[j].z, s.w += t[j].w;
    }
  }
  store4((k == 0 ? dgate : (k == 1 ? dscale : dshift)) + b * d + col, s);
}

// Launch plan of pass 1 with V vectors of T a lane on one device.
struct BwdPlan {
  int warps;  // warps of a block; 0 until planned
  int slots;  // blocks the card runs at once
  int smem;   // dynamic shared memory of a block, bytes
};

// The plan for the current device, worked out (and the kernel's shared-memory
// limit raised) on its first call there, then read from a cache.
template <int V, class T>
cudaError_t bwd_plan(BwdPlan& plan) {
  static BwdPlan cache[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  BwdPlan& p = cache[dev];
  if (p.warps == 0) {
    constexpr bool kRegs = bwd_regs<V, T>();
    const size_t per_warp = sizeof(uint4) * kBwdStages * kBwdTensors * V * 32 +
                            (kRegs ? 0 : sizeof(float4) * 3 * V * (Vec<T>::kVec / 4) * 32);
    const size_t mod_bytes = sizeof(uint4) * 2 * V * 32;
    int sms = 0, max_smem = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return err;
    const int warps = static_cast<int>(
        std::min<size_t>(kBwdMaxWarps, (static_cast<size_t>(max_smem) - mod_bytes) / per_warp));
    if (warps < 1) return cudaErrorInvalidValue;
    const int smem = static_cast<int>(mod_bytes + warps * per_warp);
    err = cudaFuncSetAttribute(gated_adaln_bwd_kernel<V, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gated_adaln_bwd_kernel<V, T>,
                                                          warps * 32, smem);
    }
    if (err != cudaSuccess) return err;
    p = BwdPlan{warps, std::max(1, sms * per_sm), smem};
  }
  plan = p;
  return cudaSuccess;
}

// Pass 1 of K5 for (batch, n, D) with V vectors a lane on the current device.
// Without `a`, stores the plan's blocks a sample in `groups`: as many as fill
// the card's block slots once, with a row for every warp at least. With `a`,
// launches pass 1 on `s` with the `groups` the caller sized the partials for.
template <int V, class T>
cudaError_t bwd_pass1(int batch, int n, int& groups, const BwdArgs<T>* a, cudaStream_t s) {
  BwdPlan plan;
  const cudaError_t err = bwd_plan<V, T>(plan);
  if (err != cudaSuccess) return err;
  if (a == nullptr) {
    groups = std::max(1, std::min(plan.slots / batch, (n + plan.warps - 1) / plan.warps));
    return cudaSuccess;
  }
  if (groups < 1) return cudaErrorInvalidValue;
  gated_adaln_bwd_kernel<V, T><<<dim3(groups, batch), plan.warps * 32, plan.smem, s>>>(*a);
  return cudaGetLastError();
}

// Pass 1 at V = ceil(D / (32 kVec)) vectors a lane, rounded up to 8 or 16
// above 4 (at most 16: the width rule).
template <class T>
cudaError_t bwd_pass1_any(int batch, int n, int d, int& groups, const BwdArgs<T>* a = nullptr,
                          cudaStream_t s = nullptr) {
  const int need = (d / Vec<T>::kVec + 31) / 32;
  switch (need <= 4 ? need : (need <= 8 ? 8 : 16)) {
    case 1: return bwd_pass1<1, T>(batch, n, groups, a, s);
    case 2: return bwd_pass1<2, T>(batch, n, groups, a, s);
    case 3: return bwd_pass1<3, T>(batch, n, groups, a, s);
    case 4: return bwd_pass1<4, T>(batch, n, groups, a, s);
    case 8: return bwd_pass1<8, T>(batch, n, groups, a, s);
    default: return bwd_pass1<16, T>(batch, n, groups, a, s);
  }
}

// The width rule: D a whole number of 16-byte vectors, at most 16 of them a
// lane (D <= 4096 in bf16, 2048 in fp32).
template <class T>
bool width_ok(int d) {
  return d > 0 && d % Vec<T>::kVec == 0 && d <= 16 * 32 * Vec<T>::kVec;
}

template <class T>
int fwd_entry(const void* x, const void* y, const void* gate, const void* scale,
              const void* shift, long long gate_stride, long long scale_stride,
              long long shift_stride, void* new_x, void* out, int rows, int n, int d, float eps,
              void* stream) {
  if (!width_ok<T>(d) || n <= 0 || rows <= 0 || rows % n != 0 || rows / n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.y = static_cast<const T*>(y);
  a.mod[0] = static_cast<const T*>(gate);
  a.mod[1] = static_cast<const T*>(scale);
  a.mod[2] = static_cast<const T*>(shift);
  a.mod_stride[0] = gate_stride;
  a.mod_stride[1] = scale_stride;
  a.mod_stride[2] = shift_stride;
  a.new_x = static_cast<T*>(new_x);
  a.out = static_cast<T*>(out);
  a.n = n;
  a.d = d;
  a.eps = eps;
  return static_cast<int>(fwd_launch_any<T>(a, rows / n, static_cast<cudaStream_t>(stream)));
}

template <class T>
int bwd_groups_entry(int batch, int n, int d) {
  int groups = 0;
  if (!width_ok<T>(d) || batch <= 0 || n <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = bwd_pass1_any<T>(batch, n, d, groups);
  return err == cudaSuccess ? groups : -static_cast<int>(err);
}

template <class T>
int bwd_entry(const void* x, const void* y, const void* gate, const void* scale,
              long long gate_stride, long long scale_stride, const void* g_newx,
              const void* g_out, void* dx, void* dy, void* partial, int groups, void* dgate,
              void* dscale, void* dshift, int batch, int n, int d, float eps, void* stream) {
  if (!width_ok<T>(d) || batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs<T> a;
  a.src[0] = static_cast<const T*>(x);
  a.src[1] = static_cast<const T*>(y);
  a.src[2] = static_cast<const T*>(g_out);
  a.src[3] = static_cast<const T*>(g_newx);
  a.gate = static_cast<const T*>(gate);
  a.scale = static_cast<const T*>(scale);
  a.gate_stride = gate_stride;
  a.scale_stride = scale_stride;
  a.dx = static_cast<T*>(dx);
  a.dy = static_cast<T*>(dy);
  a.partial = static_cast<float*>(partial);
  a.n = n;
  a.d = d;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bwd_pass1_any<T>(batch, n, d, groups, &a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = 3LL * batch * (d / 4);
  gated_adaln_bwd_reduce_kernel<T><<<static_cast<int>((threads + 63) / 64), 64, 0, s>>>(
      static_cast<const float*>(partial), batch, groups, d, static_cast<T*>(dgate),
      static_cast<T*>(dscale), static_cast<T*>(dshift));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows = B * N, B <= 65535. Pointers are device pointers; x, y, new_x, out
// are (B, N, D) contiguous bf16; gate/scale/shift rows start `*_stride`
// elements apart. D must be a multiple of 8 and at most 4096, and every
// pointer and stride 16-byte aligned (the Python wrapper checks). Returns
// cudaGetLastError().
extern "C" int gated_adaln_fwd(const void* x, const void* y, const void* gate,
                               const void* scale, const void* shift, long long gate_stride,
                               long long scale_stride, long long shift_stride, void* new_x,
                               void* out, int rows, int n, int d, float eps, void* stream) {
  return fwd_entry<__nv_bfloat16>(x, y, gate, scale, shift, gate_stride, scale_stride,
                                  shift_stride, new_x, out, rows, n, d, eps, stream);
}

// gated_adaln_fwd for fp32 operands: D a multiple of 4, at most 2048.
extern "C" int gated_adaln_fwd_f32(const void* x, const void* y, const void* gate,
                                   const void* scale, const void* shift, long long gate_stride,
                                   long long scale_stride, long long shift_stride, void* new_x,
                                   void* out, int rows, int n, int d, float eps, void* stream) {
  return fwd_entry<float>(x, y, gate, scale, shift, gate_stride, scale_stride, shift_stride,
                          new_x, out, rows, n, d, eps, stream);
}

// Blocks a sample of K5's first pass on the current device for this shape:
// the caller allocates the fp32 partials (B, groups, 3, D) and passes the
// count back. Returns -(CUDA error) on failure.
extern "C" int gated_adaln_bwd_groups(int batch, int n, int d) {
  return bwd_groups_entry<__nv_bfloat16>(batch, n, d);
}

extern "C" int gated_adaln_bwd_groups_f32(int batch, int n, int d) {
  return bwd_groups_entry<float>(batch, n, d);
}

// K5. x, y, g_newx, g_out, dx, dy are (B, N, D) contiguous bf16; gate/scale
// rows start `*_stride` elements apart; partial is fp32 (B, groups, 3, D) for
// groups >= 1 blocks a sample (gated_adaln_bwd_groups(B, N, D) gives the count
// that fills the card once); dgate/dscale/dshift are (B, D) contiguous bf16.
// D must be a multiple of 8 and at most 4096, every pointer and stride
// 16-byte aligned. Launches both passes; returns cudaGetLastError() after
// them.
extern "C" int gated_adaln_bwd(const void* x, const void* y, const void* gate,
                               const void* scale, long long gate_stride,
                               long long scale_stride, const void* g_newx, const void* g_out,
                               void* dx, void* dy, void* partial, int groups, void* dgate,
                               void* dscale, void* dshift, int batch, int n, int d, float eps,
                               void* stream) {
  return bwd_entry<__nv_bfloat16>(x, y, gate, scale, gate_stride, scale_stride, g_newx, g_out,
                                  dx, dy, partial, groups, dgate, dscale, dshift, batch, n, d,
                                  eps, stream);
}

// gated_adaln_bwd for fp32 operands and outputs (gated_adaln_bwd_groups_f32
// gives the groups): D a multiple of 4, at most 2048.
extern "C" int gated_adaln_bwd_f32(const void* x, const void* y, const void* gate,
                                   const void* scale, long long gate_stride,
                                   long long scale_stride, const void* g_newx,
                                   const void* g_out, void* dx, void* dy, void* partial,
                                   int groups, void* dgate, void* dscale, void* dshift,
                                   int batch, int n, int d, float eps, void* stream) {
  return bwd_entry<float>(x, y, gate, scale, gate_stride, scale_stride, g_newx, g_out, dx, dy,
                          partial, groups, dgate, dscale, dshift, batch, n, d, eps, stream);
}
