"""Sampler parity: the port's full `sample` against the JAX package's on a
tiny DiT, with the noise injected (JAX and torch RNG streams differ, so y0
is drawn with the JAX `noise_like` under the key the JAX sampler gets).

Tolerance atol 1e-3 over 8 fp32 Euler steps; the prompt frames must equal
the cond mel exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.utils.convert import dit_from_jax

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=1, dropout=0.0)


@pytest.fixture(scope="module")
def tiny():
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), JDiTConfig(**TINY), 8)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) if np.asarray(a).any()
        else (0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)
    cond = rng.standard_normal((1, 40, 20)).astype(np.float32)
    ids = np.asarray([[1, 2, 3, 3, 4, 0, 5, -1]], np.int32)
    return params, cond, ids


@pytest.mark.parametrize("cfg", [2.0, 0.0])
def test_sample_matches_jax_with_injected_noise(tiny, cfg):
    params, cond, ids = tiny
    n, steps = 64, 8
    key = jax.random.PRNGKey(1)
    j_in = jcfm.prepare_inputs(jnp.asarray(cond), jnp.asarray([40]), jnp.asarray([57]), n,
                               text_ids=jnp.asarray(ids))
    want, _ = jcfm.sample(params, {}, JDiTConfig(**TINY), JCFMConfig(), j_in, key, steps=steps,
                          cfg_strength=cfg, sway_coef=-1.0, compute_dtype=jnp.float32)
    y0 = np.array(jcfm.noise_like(key, 1, n, 20, j_in.duration))

    t_in = tcfm.prepare_inputs(torch.from_numpy(cond), torch.tensor([40]), torch.tensor([57]), n,
                               text_ids=torch.from_numpy(ids))
    got, traj = tcfm.sample(dit_from_jax(params, DiTConfig(**TINY)), DiTConfig(**TINY),
                            CFMConfig(), t_in, steps=steps, cfg_strength=cfg, sway_coef=-1.0,
                            y0=torch.from_numpy(y0), compute_dtype=torch.float32, device="cpu")
    assert traj.shape == (steps + 1, 1, n, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    keep = t_in.cond_mask[:, :, None].expand_as(got)
    assert torch.equal(got[keep], t_in.cond[keep])
    np.testing.assert_array_equal(t_in.cond.numpy(), np.asarray(j_in.cond))


def test_sway_grid_and_ode_methods_match_jax():
    for steps, sway in ((32, -1.0), (7, None), (16, 0.5)):
        np.testing.assert_array_equal(tcfm.sway_timesteps(steps, sway),
                                      jcfm.sway_timesteps(steps, sway))
    ts = tcfm.sway_timesteps(6, -1.0)
    y0 = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    for method in ("euler", "midpoint"):
        want, want_traj = jcfm._ode_scan(lambda t, y: jnp.sin(3 * t) * y - y ** 3,
                                         jnp.asarray(y0), jnp.asarray(ts), method)
        got, got_traj = tcfm._ode_scan(lambda t, y: math.sin(3 * t) * y - y ** 3,
                                       torch.from_numpy(y0), ts, method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_traj.numpy(), np.asarray(want_traj), rtol=1e-5, atol=1e-6)


def test_noise_is_zero_past_duration_and_seeded():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tcfm.noise_like(gen(), 2, 16, 4, torch.tensor([16, 9]))
    assert not a[1, 9:].any() and a[1, :9].abs().sum() > 0
    assert torch.equal(a, tcfm.noise_like(gen(), 2, 16, 4, torch.tensor([16, 9])))


def test_sample_refuses_cuda_without_a_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params, cond, ids = tiny
    t_in = tcfm.prepare_inputs(torch.from_numpy(cond), torch.tensor([40]), torch.tensor([57]), 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcfm.sample(dit_from_jax(params, DiTConfig(**TINY)), DiTConfig(**TINY), CFMConfig(), t_in,
                    steps=2, generator=torch.Generator().manual_seed(0))
