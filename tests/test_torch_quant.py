"""Int8 W8A8 serving quantization (`ops/quant.py`) in the port against the JAX
package (`f5e_tts_tpu/ops/quant.py`) on the CPU.

- `quantize_linear_params`: the int8 codes and the fp32 scales equal JAX's
  exactly (both round half to even), from fp32 and from bf16 weights (the
  API quantizes after the cast); `w_q` is stored column-major, the layout
  `torch._int_mm` takes fastest on the card.
- `int8_linear` within 1e-5 of JAX's (fp32 out; the int32 products are
  exact, the per-token scales and the fp32 rescale round alike).
- The folded-CFG sampler over a quantized DiT, MMDiT and UNetT against
  JAX's quantized sampler, with the JAX noise injected, fp32, one Euler
  step (one folded CFG forward of every block): atol 1e-5 (measured <= 2.7e-6).
  Over more steps the two drift apart at the scale of the quantization
  error itself: where an activation lies within an fp32 ulp of a rounding
  half, the two sides may round it to neighbouring codes, which moves one
  product term by s_x * w_scale, and the next step's activations carry it
  (on these weights 2e-4-1.9e-3 after two steps, 0.01-0.04 after eight,
  against a quantized-vs-fp32 gap of 0.01-0.09). So the loop is held to
  the one-step agreement, not to a loose multi-step tolerance.
- `F5TTS(quantize="int8")` on the CPU: the trunk's matmuls hold int8 codes
  and a synthesis runs; any other mode raises ValueError.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.ops import quant as jquant
from f5e_tts_tpu_torch import api as tapi
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.ops import nn as tnn
from f5e_tts_tpu_torch.ops import quant as tquant
from f5e_tts_tpu_torch.utils.convert import dit_from_jax, mmdit_from_jax, unett_from_jax
from tests import test_torch_mmdit as mm
from tests import test_torch_unett as un
from tests.test_torch_sampler_options import TINY as DIT_TINY
from tests.test_torch_sampler_options import _init


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_quantize_linear_params_codes_and_scales_equal_jax(dtype, bias):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero column takes the 1e-12 floor
    p_np = {"w": w, **({"b": rng.standard_normal(48).astype(np.float32)} if bias else {})}
    if dtype == "bfloat16":
        p_t = {k: t(v).bfloat16() for k, v in p_np.items()}
        p_j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p_np.items()}
    else:
        p_t, p_j = {k: t(v) for k, v in p_np.items()}, {k: jnp.asarray(v) for k, v in p_np.items()}
    got, want = tquant.quantize_linear_params(p_t), jquant.quantize_linear_params(p_j)
    assert sorted(got) == sorted(want)
    assert got["w_q"].dtype == torch.int8 and got["w_q"].stride() == (1, 64)  # column-major
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
    np.testing.assert_array_equal(got["w_scale"].numpy(), np.asarray(want["w_scale"]))
    if bias:
        np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


@pytest.mark.parametrize("shape", [(3, 7, 64), (40, 64), (1, 64)])
def test_int8_linear_matches_jax(shape):
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((64, 48)).astype(np.float32) * 0.1,
         "b": rng.standard_normal(48).astype(np.float32)}
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0] = 0.0 if len(shape) == 2 else x[..., 0]
    got = tquant.int8_linear(tquant.quantize_linear_params({k: t(v) for k, v in p.items()}), t(x))
    want = jquant.int8_linear(jquant.quantize_linear_params(p), jnp.asarray(x))
    assert got.shape == shape[:-1] + (48,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # fnn.linear dispatches on "w_q", as the JAX linear does
    q = tquant.quantize_linear_params({k: t(v) for k, v in p.items()})
    assert torch.equal(tnn.linear(q, t(x), torch.float32), got)
    zero = tquant.int8_linear(q, torch.zeros((2, 64)))  # the 1e-12 floor: the bias alone
    np.testing.assert_allclose(zero.numpy(), np.broadcast_to(p["b"], (2, 48)), rtol=1e-6)


def _dit():
    arch_j, arch_t = JDiTConfig(**DIT_TINY), DiTConfig(**DIT_TINY)
    params, _ = _init(arch_j, 8)
    return arch_j, arch_t, params, lambda p: dit_from_jax(p, arch_t), "DiT"


def _mmdit():
    arch_j, arch_t, params = mm._model()
    return arch_j, arch_t, params, lambda p: mmdit_from_jax(p, arch_t), "MMDiT"


def _unett():
    arch_j, arch_t, params = un._model("concat", seed=3)
    return arch_j, arch_t, params, lambda p: unett_from_jax(p, arch_t), "UNetT"


@pytest.mark.parametrize("make", [_dit, _mmdit, _unett], ids=["dit", "mmdit", "unett"])
def test_quantized_sampler_matches_jax(make):
    arch_j, arch_t, params_np, convert, backbone = make()
    mel = arch_t.mel_dim
    rng = np.random.default_rng(6)
    cond = rng.standard_normal((1, 40, mel)).astype(np.float32)
    ids = np.asarray([[1, 2, 3, 3, 4, 0, 5, -1]], np.int32)
    n, steps, key = 64, 1, jax.random.PRNGKey(1)
    j_in = jcfm.prepare_inputs(jnp.asarray(cond), jnp.asarray([40]), jnp.asarray([57]), n,
                               text_ids=jnp.asarray(ids))
    q_j = jquant.quantize_backbone_params(jax.tree.map(jnp.asarray, params_np), backbone)
    want, _ = jcfm.sample(q_j, {}, arch_j, JCFMConfig(), j_in, key, steps=steps,
                          cfg_strength=2.0, sway_coef=-1.0, compute_dtype=jnp.float32)
    y0 = t(jcfm.noise_like(key, 1, n, mel, j_in.duration))
    q_t = tquant.quantize_backbone_params(tbb.fuse_qkv(convert(params_np), arch_t), backbone)
    t_in = tcfm.prepare_inputs(t(cond), torch.tensor([40]), torch.tensor([57]), n,
                               text_ids=t(ids))
    got, _ = tcfm.sample(q_t, arch_t, CFMConfig(), t_in, steps=steps, cfg_strength=2.0,
                         sway_coef=-1.0, y0=y0, compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    keep = t_in.cond_mask[:, :, None].expand_as(got)
    assert torch.equal(got[keep], t_in.cond[keep])
    # and the quantization is not a no-op: the unquantized fp32 sampler differs
    plain, _ = tcfm.sample(tbb.fuse_qkv(convert(params_np), arch_t), arch_t, CFMConfig(), t_in,
                           steps=steps, cfg_strength=2.0, sway_coef=-1.0, y0=y0,
                           compute_dtype=torch.float32, device="cpu")
    assert (plain - got).abs().max() > 1e-4


def test_f5tts_quantize_int8_on_the_cpu(tmp_path):
    from tests.test_torch_infer_paths import TINY_F5, ref_file

    tts = tapi.F5TTS(model_cfg=TINY_F5, compute_dtype=torch.float32, device="cpu",
                     quantize="int8")
    blk = tts.engine.params["blocks"][0]
    assert "to_qkv" in blk["attn"] and "to_q" not in blk["attn"]
    for p in (blk["attn"]["to_qkv"], blk["attn"]["to_out"], blk["ff1"], blk["ff2"]):
        assert p["w_q"].dtype == torch.int8 and p["w_scale"].dtype == torch.float32
    assert "w" in tts.engine.params["proj_out"]  # the rest stays float
    tts.engine.buckets = (256,)
    wav, sr, _ = tts.infer(ref_file(tmp_path), "hello there", "Hi.", nfe_step=2, seed=1)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()


@pytest.mark.parametrize("mode", ["int4", "fp8", ""])
def test_f5tts_refuses_other_quantize_modes(mode):
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tapi.F5TTS(model_cfg={"depth": 1}, device="cpu", quantize=mode)
    with pytest.raises(ValueError, match="unknown backbone"):
        tquant.quantize_backbone_params({}, "Conformer")
    with pytest.raises(ValueError, match="DiT params"):
        tquant.quantize_dit_params({"blocks": []})


def test_quantize_dit_params_fuses_qkv_first():
    """Unfused DiT params are fused to to_qkv before quantization, as
    `dit.fuse_qkv` fuses them; every block's four matmuls hold codes."""
    _, arch_t, params_np, convert, _ = _dit()
    q = tquant.quantize_dit_params(convert(params_np))
    fused = tbb.fuse_qkv(convert(params_np), arch_t)["blocks"][0]["attn"]["to_qkv"]
    np.testing.assert_array_equal(q["blocks"][0]["attn"]["to_qkv"]["w_q"].numpy(),
                                  tquant.quantize_linear_params(fused)["w_q"].numpy())
    assert all("w_q" in blk[k] for blk in q["blocks"] for k in ("ff1", "ff2"))
