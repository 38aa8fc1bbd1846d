// Attention with a key-length mask and no RoPE, forward (K9) and backward
// (K10): the instantiation of the kernel family in attention_core.cuh with
// RoPE compiled out and the prefix column rule (key c valid iff c < kv_len).
// The header says what the kernels compute, what bounds them on this card
// and how they are designed.
//
// Replaces the TPU kernels f5e_tts_tpu/ops/pallas_attention.py: mha_fullkv
// (body _attn_kernel) and mha_fullkv_bwd (body _attn_bwd_kernel), which the
// MMDiT's joint attention reaches in training, where no padding mask is
// passed and every key of the [audio | text] sequence is valid. No cos/sin
// table is taken or read.

#include "attention_core.cuh"

// Forward: the pre-pass (q' into the head-major scratch qs), then the
// main kernel, on `stream`. Operands as `Operands` in the header, without
// cos/sin; returns cudaGetLastError() after the launches.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v, long long q_bs,
                          long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                          long long v_rs, const void* kv_lens, void* out,
                          void* row_max, void* row_linv, void* qs, int batch, int n,
                          int heads, int dh, float sm_scale, void* stream) {
  Operands a = {};
  a.q = q, a.k = k, a.v = v;
  a.q_bs = q_bs, a.q_rs = q_rs, a.k_bs = k_bs, a.k_rs = k_rs, a.v_bs = v_bs, a.v_rs = v_rs;
  a.lens = kv_lens;
  a.out = out, a.row_max = row_max, a.row_linv = row_linv, a.qs = qs;
  a.batch = batch, a.n = n, a.heads = heads, a.dh = dh;
  a.sm_scale = sm_scale, a.stream = static_cast<cudaStream_t>(stream);
  return attention_forward<MaskedAttn>(a);
}

// Backward: the pre-pass (q' into the head-major scratch qs, and delta),
// the dq kernel, then the dkdv kernel, on `stream`; returns
// cudaGetLastError() after them.
extern "C" int masked_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                          const void* o, long long q_bs, long long q_rs, long long k_bs,
                          long long k_rs, long long v_bs, long long v_rs, long long g_bs,
                          long long g_rs, long long o_bs, long long o_rs, const void* kv_lens,
                          const void* row_max, const void* row_linv, void* qs, void* delta,
                          void* dq, void* dk, void* dv, int batch, int n, int heads, int dh,
                          float sm_scale, void* stream) {
  Operands a = {};
  a.q = q, a.k = k, a.v = v, a.g = g, a.o = o;
  a.q_bs = q_bs, a.q_rs = q_rs, a.k_bs = k_bs, a.k_rs = k_rs, a.v_bs = v_bs, a.v_rs = v_rs;
  a.g_bs = g_bs, a.g_rs = g_rs, a.o_bs = o_bs, a.o_rs = o_rs;
  a.lens = kv_lens;
  a.row_max = const_cast<void*>(row_max), a.row_linv = const_cast<void*>(row_linv);
  a.qs = qs, a.delta = delta, a.dq = dq, a.dk = dk, a.dv = dv;
  a.batch = batch, a.n = n, a.heads = heads, a.dh = dh;
  a.sm_scale = sm_scale, a.stream = static_cast<cudaStream_t>(stream);
  return attention_backward<MaskedAttn>(a);
}
