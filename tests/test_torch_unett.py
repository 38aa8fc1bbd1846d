"""The port's other backbones and model configs against the JAX package on
the CPU, fp32, on the same numpy-seeded inputs.

- `unett_forward` (a tiny UNetT: dim 64, depth 4, 2 x 32 heads, mel 10, RoPE
  on the first head) for each skip type (concat, add, none), with and
  without a padding mask, and every parameter's gradient vs JAX: atol 1e-4
  (fp32 both sides, other summation order); the second half's skips are
  popped in LIFO order.
- `sample` over the UNetT (noise injected from `noise_like`) at atol 1e-3
  with exact prompt frames; `cfm_loss` and its gradients with draws derived
  from the JAX key (loss rtol 1e-5, gradients atol 1e-5 * max|grad| + rtol
  1e-3).
- both UNetT reference converters: the export equals `unett_to_torch` key
  by key, the loader gives `unett_from_jax(unett_from_torch(...))`'s tensors,
  and both round-trip: exact.
The long-skip DiT, the YAML loaders, the duration predictor and the entry
points over the UNetT are in test_torch_unett_entry.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import UNetTConfig as JUNetTConfig
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import unett as junett
from f5e_tts_tpu.utils.torch_ckpt import unett_from_torch, unett_to_torch
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, UNetTConfig
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.models import unett as tunett
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.utils.convert import (backbone_from_reference_state_dict,
                                             backbone_to_reference_state_dict, unett_from_jax,
                                             unett_from_reference_state_dict,
                                             unett_to_reference_state_dict)
from tests.test_torch_convert import _flat

TINY = dict(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, mel_dim=10, pe_attn_head=1,
            dropout=0.0)
VOCAB = 16
B, N, NT = 2, 24, 10
t = torch.from_numpy


def _model(skip="concat", seed=0, **kw):
    return _made(skip, seed, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _made(skip, seed, kw):
    """One eager JAX init a configuration and seed, shared by the tests (read only)."""
    cfg = {**TINY, "skip_connect_type": skip, **dict(kw)}
    arch_j, arch_t = JUNetTConfig(**cfg), UNetTConfig(**cfg)
    params, _ = junett.init_unett(jax.random.PRNGKey(seed), arch_j, VOCAB)
    rng = np.random.default_rng(seed)

    def leaf(a):  # norm gains and zero leaves get seeded values, so each shapes the output
        a = np.asarray(a, np.float32)
        if a.ndim <= 1 and (not a.any() or np.all(a == 1)):
            return (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return arch_j, arch_t, jax.tree.map(leaf, params)


def _batch(rng, mel_dim=TINY["mel_dim"]):
    x = rng.standard_normal((B, N, mel_dim)).astype(np.float32)
    cond = rng.standard_normal((B, N, mel_dim)).astype(np.float32)
    ids = rng.integers(0, VOCAB, (B, NT)).astype(np.int32)
    ids[1, 7:] = -1
    return x, cond, ids, np.asarray([0.2, 0.8], np.float32)


def _assert_tree_close(got: dict, want: dict, rtol, atol_frac=None, atol=None):
    flat_g, flat_w = _flat(got), _flat(want)
    assert flat_g.keys() == flat_w.keys()
    for key, w in flat_w.items():
        w = w.numpy()
        a = atol if atol is not None else atol_frac * max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(flat_g[key].detach().numpy(), w, rtol=rtol, atol=a, err_msg=key)


# ---------------------------------------------------------------------------
# the UNetT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip", ["concat", "add", "none"])
@pytest.mark.parametrize("masked", [True, False])
def test_unett_forward_and_grads_match_jax(skip, masked):
    arch_j, arch_t, params_np = _model(skip)
    x, cond, ids, time = _batch(np.random.default_rng(2))
    mask = (np.arange(N)[None, :] < np.asarray([N, 17])[:, None]) if masked else None
    drop_a, drop_t = np.asarray([False, True]), np.asarray([False, False])
    target = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def fwd_j(p):
        return junett.unett_forward(
            p, {}, arch_j, x=jnp.asarray(x), cond=jnp.asarray(cond), text_ids=jnp.asarray(ids),
            time=jnp.asarray(time), drop_audio_cond=jnp.asarray(drop_a),
            drop_text=jnp.asarray(drop_t), mask=None if mask is None else jnp.asarray(mask),
            compute_dtype=jnp.float32)

    def loss_j(p):  # the forward and its gradients in one compiled function
        out = fwd_j(p)
        return jnp.mean((out - target) ** 2), out

    (_, want), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_np)
    params = tstep.tree_map(lambda a: a.requires_grad_(True), unett_from_jax(params_np, arch_t))
    assert ("skip_proj" in params["second_half"][0]) == (skip == "concat")
    got = tunett.unett_forward(params, arch_t, x=t(x), cond=t(cond), text_ids=t(ids), time=t(time),
                               drop_audio_cond=t(drop_a), drop_text=t(drop_t),
                               mask=None if mask is None else t(mask), compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    (got - t(target)).square().mean().backward()
    _assert_tree_close(tstep.tree_map(lambda p: p.grad, params),
                       unett_from_jax(jax.tree.map(np.asarray, grads_j), arch_t),
                       rtol=1e-3, atol=1e-4)


def test_unett_skips_pop_in_lifo_order():
    """Each second-half layer i merges the input of first-half layer H-1-i:
    the port matches JAX, the same layers with the skips merged first-in
    first-out do not, and scaling the second half moves the output
    (tests/test_backbones.py)."""
    arch_j, arch_t, params_np = _model("concat", seed=1)
    x, cond, ids, time = _batch(np.random.default_rng(4))
    f = np.zeros(B, bool)
    want = np.asarray(junett.unett_forward(
        params_np, {}, arch_j, x=jnp.asarray(x), cond=jnp.asarray(cond), text_ids=jnp.asarray(ids),
        time=jnp.asarray(time), drop_audio_cond=jnp.asarray(f), drop_text=jnp.asarray(f),
        compute_dtype=jnp.float32))

    def port(params):
        return tunett.unett_forward(params, arch_t, x=t(x), cond=t(cond), text_ids=t(ids),
                                    time=t(time), drop_audio_cond=t(f), drop_text=t(f),
                                    compute_dtype=torch.float32).numpy()

    params = unett_from_jax(params_np, arch_t)
    np.testing.assert_allclose(port(params), want, rtol=0, atol=1e-4)
    fifo = _fifo_forward(params, arch_t, x, cond, ids, time)
    assert np.abs(fifo - want).max() > 1e-3
    half = {**params, "second_half": tstep.tree_map(lambda a: a * 0.5, params["second_half"])}
    assert np.abs(port(half) - want).max() > 1e-6


def _fifo_forward(params, arch, x, cond, ids, time):
    """The UNetT forward with the skips merged first-in first-out: what a
    stack read in the wrong order computes."""
    f = torch.zeros(B, dtype=torch.bool)
    h = tdit.input_embed_fn(params, arch, t(x), t(cond),
                            tunett.text_embed_fn(params, arch, t(ids), B, N, f, torch.float32),
                            f, torch.float32)
    h = torch.cat([tdit.time_embed(params, t(time), torch.float32)[:, None], h], dim=1)
    cos, sin = tdit._rope_tables(arch.dim_head, N + 1, h.device)
    skips = []
    for layer in params["first_half"]:
        skips.append(h)
        h = tunett._unett_layer(layer, h, None, cos, sin, arch, torch.float32)
    for layer, skip in zip(params["second_half"], skips):
        h = tunett.fnn.linear(layer["skip_proj"], torch.cat([h, skip], dim=-1), torch.float32)
        h = tunett._unett_layer(layer, h, None, cos, sin, arch, torch.float32)
    h = tunett.fnn.rmsnorm(params["norm_out"], h, eps=tunett.RMS_EPS)[:, 1:]
    return tunett.fnn.linear(params["proj_out"], h, torch.float32).numpy()


def test_unett_dispatch_init_and_fused_qkv():
    arch_j, arch_t, params_np = _model("concat", seed=2, conv_layers=1, text_dim=16)
    assert tbb.backbone_kind(arch_t) == "unett"
    assert tbb.attention_rows(arch_t, 1536) == 1537 and tbb.attention_rows(DiTConfig(), 7) == 7
    init = tbb.init_backbone(arch_t, VOCAB, tprng.prng_key(0))
    want = _flat(unett_from_jax(params_np, arch_t))
    # init_unett's leaves and shapes are the JAX init's
    assert {k: tuple(v.shape) for k, v in _flat(init).items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in _flat(init).values())
    _, _, ids, _ = _batch(np.random.default_rng(5))
    params = unett_from_jax(params_np, arch_t)
    for drop in (False, True):
        te_j = junett.text_embed_fn(params_np, arch_j, jnp.asarray(ids), B, N,
                                    jnp.full((B,), drop), jnp.float32)
        te_t = tbb.precompute_text_embed(params, arch_t, t(ids), B, N, torch.full((B,), drop),
                                         torch.float32)
        np.testing.assert_allclose(te_t.numpy(), np.asarray(te_j), rtol=1e-6, atol=1e-6)
    # a fused to_qkv computes the same forward
    x, cond, _, time = _batch(np.random.default_rng(6))
    f = torch.zeros(B, dtype=torch.bool)
    kw = dict(x=t(x), cond=t(cond), text_ids=t(ids), time=t(time), drop_audio_cond=f,
              drop_text=f, compute_dtype=torch.float32)
    fused = tbb.fuse_qkv(params, arch_t)
    assert all("to_qkv" in layer["attn"] and "to_q" not in layer["attn"]
               for layer in fused["first_half"] + fused["second_half"])
    np.testing.assert_allclose(tbb.forward_train(fused, arch_t, **kw).numpy(),
                               tbb.forward_train(params, arch_t, **kw).numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="even"):
        tunett.init_unett(UNetTConfig(**{**TINY, "depth": 3}), VOCAB, tprng.prng_key(0))


@pytest.mark.parametrize("cfg", [2.0, 0.0])
def test_sample_with_unett_matches_jax_with_injected_noise(cfg):
    arch_j, arch_t, params_np = _model("concat", seed=3)
    rng = np.random.default_rng(6)
    cond = rng.standard_normal((1, 40, TINY["mel_dim"])).astype(np.float32)
    ids = np.asarray([[1, 2, 3, 3, 4, 0, 5, -1]], np.int32)
    n, steps = 64, 8
    key = jax.random.PRNGKey(1)
    j_in = jcfm.prepare_inputs(jnp.asarray(cond), jnp.asarray([40]), jnp.asarray([57]), n,
                               text_ids=jnp.asarray(ids))
    want, _ = jcfm.sample(params_np, {}, arch_j, JCFMConfig(), j_in, key, steps=steps,
                          cfg_strength=cfg, sway_coef=-1.0, compute_dtype=jnp.float32)
    y0 = np.array(jcfm.noise_like(key, 1, n, TINY["mel_dim"], j_in.duration))
    t_in = tcfm.prepare_inputs(t(cond), torch.tensor([40]), torch.tensor([57]), n,
                               text_ids=t(ids))
    got, traj = tcfm.sample(tbb.fuse_qkv(unett_from_jax(params_np, arch_t), arch_t), arch_t,
                            CFMConfig(), t_in, steps=steps, cfg_strength=cfg, sway_coef=-1.0,
                            y0=t(y0), compute_dtype=torch.float32, device="cpu")
    assert traj.shape == (steps + 1, 1, n, TINY["mel_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    keep = t_in.cond_mask[:, :, None].expand_as(got)
    assert torch.equal(got[keep], t_in.cond[keep])


@pytest.mark.parametrize("cfm_kw", [{}, {"cond_drop_prob": 1.0}])
def test_cfm_loss_and_grads_with_unett_match_jax(cfm_kw):
    arch_j, arch_t, params_np = _model("concat", seed=4)
    cfm_j, cfm_t = JCFMConfig(**cfm_kw), CFMConfig(**cfm_kw)
    mel, _, ids, _ = _batch(np.random.default_rng(7))
    mel_lens = np.asarray([N, 19], np.int32)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        return jcfm.cfm_loss(p, {}, arch_j, cfm_j, mel=jnp.asarray(mel),
                             mel_lens=jnp.asarray(mel_lens), text_ids=jnp.asarray(ids), rng=key,
                             training=True, compute_dtype=jnp.float32).loss

    want, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params_np)
    params = tstep.tree_map(lambda a: a.requires_grad_(True), unett_from_jax(params_np, arch_t))
    out = tcfm.cfm_loss(params, arch_t, cfm_t, mel=t(mel), mel_lens=t(mel_lens), text_ids=t(ids),
                        rng=tprng.prng_key(3), compute_dtype=torch.float32)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=1e-5)
    _assert_tree_close(tstep.tree_map(lambda a: a.grad, params),
                       unett_from_jax(jax.tree.map(np.asarray, grads_j), arch_t),
                       rtol=1e-3, atol_frac=1e-5)


@pytest.mark.parametrize("skip,conv_layers", [("concat", 0), ("add", 1), ("none", 0)])
def test_unett_converters_match_jax_and_round_trip(skip, conv_layers):
    arch_j, arch_t, params_np = _model(skip, seed=5, conv_layers=conv_layers,
                                       text_dim=16 if conv_layers else None)
    sd = unett_to_torch(params_np, {}, arch_j)
    direct = _flat(unett_from_jax(params_np, arch_t))
    via_ref = _flat(unett_from_reference_state_dict(sd, arch_t))
    want = _flat(unett_from_jax(jax.tree.map(np.asarray, unett_from_torch(sd, arch_j)[0]), arch_t))
    # the loader keeps init_unett's leaf order, and each tensor is the JAX loader's
    assert list(via_ref) == list(_flat(tunett.init_unett(arch_t, VOCAB, tprng.prng_key(0))))
    assert via_ref.keys() == direct.keys() == want.keys()
    for k in direct:
        assert via_ref[k].dtype == torch.float32 and torch.equal(via_ref[k], want[k]), k
        assert torch.equal(via_ref[k], direct[k]), k
    # the export equals the JAX package's, key by key, also from fused to_qkv params
    fused = tbb.fuse_qkv(unett_from_jax(params_np, arch_t), arch_t)
    for ours in (unett_to_reference_state_dict(unett_from_jax(params_np, arch_t), arch_t),
                 backbone_to_reference_state_dict(fused, arch_t)):
        assert ours.keys() == sd.keys()
        for k, v in sd.items():
            assert ours[k].is_contiguous() and ours[k].dtype == torch.float32
            np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    again = _flat(backbone_from_reference_state_dict(sd, arch_t))
    assert all(torch.equal(again[k], direct[k]) for k in direct)
    with pytest.raises(ValueError, match="depth"):
        unett_from_reference_state_dict(sd, UNetTConfig(**{**TINY, "depth": 6}))
