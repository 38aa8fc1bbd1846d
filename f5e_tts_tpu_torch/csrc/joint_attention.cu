// Joint (MMDiT) attention over keys [audio | text], forward (K7) and backward
// (K8): the instantiation of the kernel family in attention_core.cuh with
// RoPE compiled out and the joint column rule: key c is valid iff
// c < audio_len (the sample's unpadded audio) or c >= n_audio (the text
// tail, always valid). The header says what the kernels compute, what
// bounds them on this card and how they are designed; RoPE of the two
// streams is applied before the concatenation, outside the kernel, as in
// the JAX package.
//
// Replaces the TPU kernels f5e_tts_tpu/ops/pallas_attention.py:
// mha_fullkv_joint (body _attn_joint_kernel) and mha_fullkv_joint_bwd (body
// _attn_joint_bwd_kernel). The valid columns are not a prefix: the dead key
// tiles are those inside the gap [audio_len, n_audio), and the tiles after
// it are live again.

#include "attention_core.cuh"

// Forward: the pre-pass (q' into the head-major scratch qs), then the
// main kernel, on `stream`. Operands as `Operands` in the header, without
// cos/sin; returns cudaGetLastError() after the launches.
extern "C" int joint_attention_fwd(const void* q, const void* k, const void* v, long long q_bs,
                          long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                          long long v_rs, const void* audio_lens, int n_audio, void* out,
                          void* row_max, void* row_linv, void* qs, int batch, int n,
                          int heads, int dh, float sm_scale, void* stream) {
  Operands a = {};
  a.q = q, a.k = k, a.v = v;
  a.q_bs = q_bs, a.q_rs = q_rs, a.k_bs = k_bs, a.k_rs = k_rs, a.v_bs = v_bs, a.v_rs = v_rs;
  a.lens = audio_lens;
  a.n_audio = n_audio;
  a.out = out, a.row_max = row_max, a.row_linv = row_linv, a.qs = qs;
  a.batch = batch, a.n = n, a.heads = heads, a.dh = dh;
  a.sm_scale = sm_scale, a.stream = static_cast<cudaStream_t>(stream);
  return attention_forward<JointAttn>(a);
}

// Backward: the pre-pass (q' into the head-major scratch qs, and delta),
// the dq kernel, then the dkdv kernel, on `stream`; returns
// cudaGetLastError() after them.
extern "C" int joint_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                          const void* o, long long q_bs, long long q_rs, long long k_bs,
                          long long k_rs, long long v_bs, long long v_rs, long long g_bs,
                          long long g_rs, long long o_bs, long long o_rs, const void* audio_lens,
                          int n_audio, const void* row_max, const void* row_linv, void* qs,
                          void* delta, void* dq, void* dk, void* dv, int batch, int n, int heads,
                          int dh, float sm_scale, void* stream) {
  Operands a = {};
  a.q = q, a.k = k, a.v = v, a.g = g, a.o = o;
  a.q_bs = q_bs, a.q_rs = q_rs, a.k_bs = k_bs, a.k_rs = k_rs, a.v_bs = v_bs, a.v_rs = v_rs;
  a.g_bs = g_bs, a.g_rs = g_rs, a.o_bs = o_bs, a.o_rs = o_rs;
  a.lens = audio_lens;
  a.n_audio = n_audio;
  a.row_max = const_cast<void*>(row_max), a.row_linv = const_cast<void*>(row_linv);
  a.qs = qs, a.delta = delta, a.dq = dq, a.dk = dk, a.dv = dv;
  a.batch = batch, a.n = n, a.heads = heads, a.dh = dh;
  a.sm_scale = sm_scale, a.stream = static_cast<cudaStream_t>(stream);
  return attention_backward<JointAttn>(a);
}
