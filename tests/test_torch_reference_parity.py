"""The port's DiT and UNetT against the independent from-spec torch
implementations of the reference conventions that the JAX package's golden
tests use (tests/torch_ref.py: dit_forward_torch; tests/test_parity_unett.py:
unett_forward_torch), on the CPU in fp32.

The weights are reference-layout state dicts made by the JAX package's
exporters (seeded JAX init, zero layers de-zeroed), loaded into the port
through `dit_from_reference_state_dict` / `unett_from_reference_state_dict`:
so the port's loaders (the half-split RoPE permutation, the AdaLN chunk
order, the ConvNeXt and conv layouts, the LIFO skips) are checked against
code that shares nothing with them. The DiT runs the three configs of
tests/test_parity_torch.py under each drop case; the UNetT its concat and
add skips (the reference adds the skip whenever a layer has no skip_proj,
so it cannot stand for `none`). Both sides compute in fp32 and differ by
summation order only: atol 1e-5, rtol 1e-5 (measured <= 6.0e-7 for the DiT,
<= 2.1e-6 for the UNetT).
"""

from __future__ import annotations

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import backbone as jbb
from f5e_tts_tpu.utils.torch_ckpt import unett_to_torch
from f5e_tts_tpu_torch.config import DiTConfig, UNetTConfig
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.utils.convert import (dit_from_reference_state_dict,
                                             unett_from_reference_state_dict)
from tests.test_parity_torch import _random_torch_sd
from tests.test_parity_unett import CFG as UNETT_CFG
from tests.test_parity_unett import VOCAB as UNETT_VOCAB
from tests.test_parity_unett import unett_forward_torch
from tests.torch_ref import dit_forward_torch

DIT_CFGS = {
    "v1_style": dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=10, text_dim=32,
                     conv_layers=2, dropout=0.0),
    "legacy_pe1": dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=10, text_dim=32,
                       text_mask_padding=False, conv_layers=1, pe_attn_head=1, dropout=0.0),
    "qk_norm": dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=10, text_dim=32,
                    conv_layers=1, qk_norm="rms_norm", dropout=0.0),
}
TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=list(DIT_CFGS))
def dit_case(request):
    kw = DIT_CFGS[request.param]
    sd = _random_torch_sd(JDiTConfig(**kw), 20)
    return kw, sd


@pytest.mark.parametrize("drop_audio,drop_text", [(False, False), (True, True), (True, False)])
def test_dit_matches_the_torch_reference(dit_case, drop_audio, drop_text):
    kw, sd = dit_case
    rng = np.random.default_rng(0)
    b, n, nt, mel = 2, 24, 9, kw["mel_dim"]
    x = rng.standard_normal((b, n, mel)).astype(np.float32)
    cond = rng.standard_normal((b, n, mel)).astype(np.float32)
    text = rng.integers(0, 20, (b, nt)).astype(np.int32)
    text[1, 6:] = -1
    time = np.asarray([0.25, 0.8], np.float32)
    ref = dit_forward_torch(sd, JDiTConfig(**kw), t(x), t(cond), t(text).long(), t(time),
                            drop_audio=drop_audio, drop_text=drop_text).numpy()
    arch = DiTConfig(**kw)
    params = dit_from_reference_state_dict({k: np.asarray(v) for k, v in sd.items()}, arch)
    flags = torch.ones(b, dtype=torch.bool)
    got = tbb.forward_train(params, arch, x=t(x), cond=t(cond), text_ids=t(text), time=t(time),
                            drop_audio_cond=flags & drop_audio, drop_text=flags & drop_text,
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize("skip", ["concat", "add"])
def test_unett_matches_the_torch_reference(skip):
    cfg_j = dataclasses.replace(UNETT_CFG, skip_connect_type=skip)
    params, state = jbb.init_backbone(jax.random.PRNGKey(0), cfg_j, UNETT_VOCAB)
    sd = {k: np.asarray(v) for k, v in unett_to_torch(params, state, cfg_j).items()}
    has_skip_proj = any(re.fullmatch(r"transformer\.layers\.\d+\.0\.weight", k) for k in sd)
    assert has_skip_proj == (skip == "concat")
    rng = np.random.default_rng(0)
    b, n, nt = 2, 16, 6
    x = rng.standard_normal((b, n, cfg_j.mel_dim)).astype(np.float32)
    cond = rng.standard_normal((b, n, cfg_j.mel_dim)).astype(np.float32)
    text = rng.integers(0, UNETT_VOCAB, (b, nt)).astype(np.int32)
    time = np.asarray([0.3, 0.9], np.float32)
    ref = unett_forward_torch(sd, cfg_j, t(x), t(cond), t(text).long(), t(time)).numpy()
    arch = UNetTConfig(**{f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    tparams = unett_from_reference_state_dict(sd, arch)
    f = torch.zeros(b, dtype=torch.bool)
    got = tbb.forward_train(tparams, arch, x=t(x), cond=t(cond), text_ids=t(text), time=t(time),
                            drop_audio_cond=f, drop_text=f, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
