"""fp32 operands and head widths outside the kernels' {64, 128}, on the CPU.

- The DiT's forward and every parameter's gradient in fp32 against the JAX
  DiT (jax.value_and_grad of a weighted sum of `dit_forward`'s output, a
  padding mask on), at head width 32 with RoPE on two heads of four (the
  port's unfused route: `apply_rotary_half`, then the library's
  attention, as the JAX package's route outside Pallas), and at head width
  64 (the kernels' plain versions on the CPU). Tolerance: output atol 1e-4 +
  rtol 1e-4, gradients atol 1e-4 * max|grad| + rtol 1e-3 (fp32 on both
  sides, sums in another order; a weight's gradient sums 80 rows' terms of
  up to max|grad|, so entries near 0 carry the terms' rounding, ~1e-5 of
  the largest).
- The route: `attention` and `joint_attention` at head width 32 count one
  `unfused_calls` each and reach no kernel wrapper or plain version; at 64
  they count none. `unfused_attention` against the JAX package's
  `jax.nn.dot_product_attention` branch with a row whose keys are all
  masked (both average every key), atol 1e-5.
- The dtype dispatch: fp32 and bf16 CPU tensors take the plain versions
  through every wrapper, and no launch counter moves (the fp32 ones
  included); the kernels' operand rules in fp32 (16-byte rows: a row
  stride a multiple of 4 elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.ops import attention as jattn
from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.kernels import attention as ka
from f5e_tts_tpu_torch.kernels import gated_adaln as ga
from f5e_tts_tpu_torch.kernels import rope_attention as ra
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import attention as tattn
from f5e_tts_tpu_torch.ops import nn as tnn
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.ops.rope import rotary_cos_sin_half
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.utils.convert import dit_from_jax

B, N, MEL = 2, 40, 12
WIDTHS = {  # (dim, heads, dim_head, pe_attn_head)
    "dh32_rope_on_two_heads": (128, 4, 32, 2),
    "dh64": (128, 2, 64, None),
}
COUNTERS = ((ra, "launches"), (ra, "bwd_launches"), (ra, "partial_launches"),
            (ra, "partial_bwd_launches"), (ra, "fp32_launches"), (ra, "fp32_bwd_launches"),
            (ra, "fp32_partial_launches"), (ra, "fp32_partial_bwd_launches"),
            (ka, "masked_launches"), (ka, "masked_bwd_launches"), (ka, "joint_launches"),
            (ka, "joint_bwd_launches"), (ka, "fp32_masked_launches"),
            (ka, "fp32_masked_bwd_launches"), (ka, "fp32_joint_launches"),
            (ka, "fp32_joint_bwd_launches"), (ga, "launches"), (ga, "bwd_launches"),
            (ga, "fp32_launches"), (ga, "fp32_bwd_launches"))


def counts():
    return [getattr(m, a) for m, a in COUNTERS]


def randomized(tree, rng):
    """numpy copy of a JAX tree; zero-initialised leaves (AdaLN, proj_out,
    GRN) get seeded values so every weight shapes the output."""
    def leaf(a):
        a = np.asarray(a, np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a
    return jax.tree.map(leaf, tree)


def arch_kw(width):
    dim, heads, dh, pe = WIDTHS[width]
    return dict(dim=dim, depth=1, heads=heads, dim_head=dh, ff_mult=2, mel_dim=MEL,
                text_dim=32, conv_layers=1, dropout=0.0, pe_attn_head=pe)


def inputs(rng):
    x, cond = (rng.standard_normal((B, N, MEL)).astype(np.float32) for _ in range(2))
    ids = rng.integers(0, 16, (B, 10)).astype(np.int32)
    ids[1, 7:] = -1
    return dict(x=x, cond=cond, text_ids=ids, time=np.asarray([0.3, 0.8], np.float32),
                mask=np.arange(N)[None, :] < np.asarray([N, 27])[:, None],
                weight=rng.standard_normal((B, N, MEL)).astype(np.float32))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_fp32_dit_forward_and_grads_match_jax(width):
    arch_j, arch_t = JDiTConfig(**arch_kw(width)), DiTConfig(**arch_kw(width))
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), arch_j, 16)
    params_np = randomized(params, np.random.default_rng(0))
    inp = inputs(np.random.default_rng(1))
    no = np.zeros((B,), bool)

    def loss_j(p):
        pred, _ = jdit.dit_forward(p, {}, arch_j, x=jnp.asarray(inp["x"]),
                                   cond=jnp.asarray(inp["cond"]),
                                   text_ids=jnp.asarray(inp["text_ids"]),
                                   time=jnp.asarray(inp["time"]), drop_audio_cond=no,
                                   drop_text=no, drop_ppg=no, mask=jnp.asarray(inp["mask"]),
                                   compute_dtype=jnp.float32)
        return jnp.sum(pred * inp["weight"]), pred

    (want, pred_j), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_np)
    params_t = tstep.tree_map(lambda t: t.requires_grad_(True), dit_from_jax(params_np, arch_t))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    before, calls = counts(), tattn.unfused_calls
    pred = tdit.dit_forward(params_t, arch_t, x=t(inp["x"]), cond=t(inp["cond"]),
                            text_ids=t(inp["text_ids"]), time=t(inp["time"]),
                            drop_audio_cond=t(no), drop_text=t(no), mask=t(inp["mask"]),
                            compute_dtype=torch.float32)
    (pred * t(inp["weight"])).sum().backward()
    assert tattn.unfused_calls - calls == (0 if width == "dh64" else arch_t.depth)
    assert counts() == before  # the CPU takes no kernel
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_j), rtol=1e-4, atol=1e-4)
    want_g = dit_from_jax(jax.tree.map(np.asarray, grads_j), arch_t)
    for g, w in zip(tstep.tree_leaves(tstep.tree_map(lambda p: p.grad, params_t)),
                    tstep.tree_leaves(want_g)):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * max(np.abs(w).max(), 1e-12))


def _refuse_plain(monkeypatch):
    """Every kernel wrapper and plain version raises if called."""
    def boom(*a, **kw):
        raise AssertionError("the unfused route reached a kernel wrapper or plain version")
    for mod, names in ((ra, ("rope_attention", "rope_attention_plain", "rope_attention_bwd",
                             "rope_attention_bwd_plain")),
                       (ka, ("masked_attention", "masked_attention_plain",
                             "joint_attention_core", "joint_attention_core_plain",
                             "core_plain", "core_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)


def test_unfused_route_and_its_counter(monkeypatch):
    gen = torch.Generator().manual_seed(4)
    p = {"to_qkv": tnn.linear_init(64, 3 * 64, gen), "to_out": tnn.linear_init(64, 64, gen)}
    x = torch.randn((2, 30, 64), generator=gen, requires_grad=True)
    mask = torch.arange(30)[None, :] < torch.tensor([30, 12])[:, None]
    cos, sin = (torch.from_numpy(a) for a in rotary_cos_sin_half(32, 30))
    jp = {n: {k: jnp.asarray(v.detach().numpy()) for k, v in d.items()} for n, d in p.items()}
    _refuse_plain(monkeypatch)
    calls = tattn.unfused_calls
    got = tattn.attention(p, x, 2, mask, cos, sin, compute_dtype=torch.float32)
    got.sum().backward()
    assert tattn.unfused_calls == calls + 1 and x.grad is not None
    want = jattn.attention(jp, jnp.asarray(x.detach().numpy()), 2, mask=jnp.asarray(mask.numpy()),
                           rope_cos=jnp.asarray(cos.numpy()), rope_sin=jnp.asarray(sin.numpy()),
                           compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    # joint attention (the MMDiT's) at head width 32, with and without a mask
    jp2 = tattn.joint_attention_init(64, 48, 2, 32, tprng.prng_key(4))
    c = torch.randn((2, 9, 48), generator=gen)
    for m in (mask, None):
        xo, co = tattn.joint_attention(jp2, x.detach(), c, 2, mask=m, compute_dtype=torch.float32)
        assert xo.shape == (2, 30, 64) and co.shape == (2, 9, 48)
    assert tattn.unfused_calls == calls + 3


def test_unfused_attention_matches_jax_with_a_fully_masked_row():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((3, 20, 2, 16)).astype(np.float32) for _ in range(3))
    valid = np.arange(20)[None, :] < np.asarray([20, 7, 0])[:, None]
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        mask=jnp.asarray(valid)[:, None, None, :])
    got = tattn.unfused_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(v[2].mean(0), (20, 2, 16)),
                               atol=1e-5)  # no valid key: the average of every key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_plain_versions_on_the_cpu_in_either_dtype(dtype):
    gen = torch.Generator().manual_seed(8)
    q, k, v, g = (torch.randn((2, 24, 2, 64), generator=gen).to(dtype) for _ in range(4))
    lens = torch.tensor([24, 10], dtype=torch.int32)
    cos, sin = (torch.from_numpy(a) for a in rotary_cos_sin_half(64, 24))
    x, y = (torch.randn((2, 24, 64), generator=gen).to(dtype) for _ in range(2))
    m = torch.randn((2, 64), generator=gen).to(dtype)
    before = counts()
    pairs = [
        (ra.rope_attention(q, k, v, lens, cos, sin, 2),
         ra.rope_attention_plain(q, k, v, lens, cos, sin, 2)),
        (ra.rope_attention_bwd(q, k, v, lens, cos, sin, g, 1)[0],
         ra.rope_attention_bwd_plain(q, k, v, lens, cos, sin, g, 1)[0]),
        (ka.masked_attention(q, k, v, lens), ka.masked_attention_plain(q, k, v, lens)),
        (ka.joint_attention_core_bwd(q, k, v, lens, 20, g)[2],
         ka.joint_attention_core_bwd_plain(q, k, v, lens, 20, g)[2]),
        (ga.gated_adaln(x, y, m, m, m)[1], ga.gated_adaln_plain(x, y, m, m, m)[1]),
        (ga.gated_adaln_bwd(x, y, m, m, x, y)[2], ga.gated_adaln_bwd_plain(x, y, m, m, x, y)[2]),
    ]
    for got, want in pairs:
        assert got.dtype == dtype and torch.equal(got, want)
    assert counts() == before == [0] * len(COUNTERS)


def test_fp32_operand_rules():
    assert ka.KERNEL_DTYPES == (torch.bfloat16, torch.float32)
    assert ga.KERNEL_DTYPES[torch.float32] == ("_f32", 2048)
    qkv = torch.zeros((2, 10, 3 * 4 * 32))  # a fused projection's fp32 columns
    q = qkv.chunk(3, dim=-1)[1].unflatten(-1, (4, 32))
    assert ka.kernel_operand(q) is q  # row stride 384, offset 128 floats: 16-byte rows
    odd = torch.zeros((2, 10, 4 * 32 + 2))[..., 2:].unflatten(-1, (4, 32))
    assert ka.kernel_operand(odd) is not odd and ka.kernel_operand(odd).is_contiguous()
    assert ka.is_fp32(q) == 1 and ka.is_fp32(q.bfloat16()) == 0
    assert tattn.KERNEL_HEAD_WIDTHS == (64, 128)
