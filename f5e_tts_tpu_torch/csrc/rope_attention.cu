// Fused RoPE + attention forward and backward: the instantiation of the
// kernel family in attention_core.cuh with RoPE compiled in and the prefix
// column rule (key c valid iff c < kv_len). The header says what the kernels
// compute, what bounds them on this card and how they are designed.
//
// The forward replaces the TPU kernels of f5e_tts_tpu/ops/pallas_attention.py
// that fuse RoPE into attention: mha_chunked_rope (K1, body
// _packed_rope_kernel, RoPE on all or none of the heads), mha_fullkv_rope
// (K3, body _attn_rope_kernel, RoPE on heads h < rope_heads) and
// mha_packed_rope (K11a, all heads of a batch row in one cell). They compute
// one function and differ in how a head's K/V sat in VMEM; here a block owns
// one (q-tile, head, batch) and tests h < rope_heads itself. The backward
// replaces mha_chunked_rope_bwd (K4), mha_fullkv_rope_bwd (K6, body
// _attn_bwd_rope_kernel) and mha_packed_rope_bwd (K11b) likewise.

#include "attention_core.cuh"
#include "attention_fp32.cuh"

// Forward (bf16 operands, or fp32 ones with `fp32` set: attention_fp32.cuh):
// the pre-pass (q' and k' into the head-major scratch qs, ks), then the main
// kernel, on `stream`. Operands as `Operands` in the header; returns
// cudaGetLastError() after the launches.
extern "C" int rope_attention_fwd(const void* q, const void* k, const void* v, long long q_bs,
                                  long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                  long long v_rs, const void* kv_lens, const void* cos,
                                  const void* sin, void* out, void* row_max, void* row_linv,
                                  void* qs, void* ks, int batch, int n, int heads, int dh,
                                  int rope_heads, float sm_scale, int fp32, void* stream) {
  Operands a = {};
  a.q = q, a.k = k, a.v = v;
  a.q_bs = q_bs, a.q_rs = q_rs, a.k_bs = k_bs, a.k_rs = k_rs, a.v_bs = v_bs, a.v_rs = v_rs;
  a.lens = kv_lens, a.cos = cos, a.sin = sin;
  a.out = out, a.row_max = row_max, a.row_linv = row_linv, a.qs = qs, a.ks = ks;
  a.batch = batch, a.n = n, a.heads = heads, a.dh = dh, a.rope_heads = rope_heads;
  a.sm_scale = sm_scale, a.stream = static_cast<cudaStream_t>(stream);
  return fp32 ? attention_forward_f32<RopeAttn>(a) : attention_forward<RopeAttn>(a);
}

// Backward (bf16, or fp32 with `fp32` set): the pre-pass (q' and k' into the
// head-major scratch qs, ks, and delta), the dq kernel, then the dkdv kernel,
// on `stream`; returns cudaGetLastError() after them.
extern "C" int rope_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                  const void* o, long long q_bs, long long q_rs, long long k_bs,
                                  long long k_rs, long long v_bs, long long v_rs, long long g_bs,
                                  long long g_rs, long long o_bs, long long o_rs,
                                  const void* kv_lens, const void* cos, const void* sin,
                                  const void* row_max, const void* row_linv, void* qs,
                                  void* ks, void* delta, void* dq, void* dk, void* dv, int batch,
                                  int n, int heads, int dh, int rope_heads, float sm_scale,
                                  int fp32, void* stream) {
  Operands a = {};
  a.q = q, a.k = k, a.v = v, a.g = g, a.o = o;
  a.q_bs = q_bs, a.q_rs = q_rs, a.k_bs = k_bs, a.k_rs = k_rs, a.v_bs = v_bs, a.v_rs = v_rs;
  a.g_bs = g_bs, a.g_rs = g_rs, a.o_bs = o_bs, a.o_rs = o_rs;
  a.lens = kv_lens, a.cos = cos, a.sin = sin;
  a.row_max = const_cast<void*>(row_max), a.row_linv = const_cast<void*>(row_linv);
  a.qs = qs, a.ks = ks, a.delta = delta, a.dq = dq, a.dk = dk, a.dv = dv;
  a.batch = batch, a.n = n, a.heads = heads, a.dh = dh, a.rope_heads = rope_heads;
  a.sm_scale = sm_scale, a.stream = static_cast<cudaStream_t>(stream);
  return fp32 ? attention_backward_f32<RopeAttn>(a) : attention_backward<RopeAttn>(a);
}

// Dynamic shared memory of the forward's main kernel (kernel 0), the
// backward's dq (1) or dkdv (2) kernel at head width dh, in bytes, and of
// their fp32 counterparts (3, 4, 5); -1 for what is not built.
extern "C" int attention_smem(int dh, int kernel) {
  if (dh == 64) {
    const int all[6] = {fwd_smem<64>(),     dq_smem<64>(),     dkdv_smem<64>(),
                        fwd_f32_smem<64>(), dq_f32_smem<64>(), dkdv_f32_smem<64>()};
    return kernel >= 0 && kernel < 6 ? all[kernel] : -1;
  }
  if (dh == 128) {
    const int all[6] = {fwd_smem<128>(),     dq_smem<128>(),     dkdv_smem<128>(),
                        fwd_f32_smem<128>(), dq_f32_smem<128>(), dkdv_f32_smem<128>()};
    return kernel >= 0 && kernel < 6 ? all[kernel] : -1;
  }
  return -1;
}
