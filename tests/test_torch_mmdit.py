"""The port's MMDiT against the JAX package on the CPU, at a tiny
MMDiT (dim 64, depth 3, heads 2 x 32), fp32, on the same numpy-seeded inputs.

- `attention` without RoPE tables and with qk_norm="rms_norm", and
  `joint_attention` with and without a padding mask, with qk_norm and with
  `context_pre_only`, vs the JAX functions (whose CPU path is
  jax.nn.dot_product_attention): atol 2e-5 + rtol 1e-4 on unit-scale outputs
  (fp32 both sides, other summation order).
- `mmdit_forward` (with a mask, as the sampler calls it, and without, as
  training does) and every parameter's gradient vs JAX: atol 1e-4.
- the port's MMDiT vs the from-spec oracle of tests/test_parity_mmdit.py at
  that test's own tolerance.
- `sample` (noise injected) and `cfm_loss` (draws derived from the JAX key)
  with an MMDiT arch, at the DiT tests' tolerances: sample atol 1e-3 over 8
  Euler steps, loss rtol 1e-5, gradients atol 1e-5 * max|grad| + rtol 1e-3.
- both MMDiT loaders give identical tensors, and the reference-layout export
  equals the JAX package's mmdit_to_torch and round-trips through its
  mmdit_from_torch: exact.
- `TTSEngine` and `Trainer` with an MMDiT arch on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import MMDiTConfig as JMMDiTConfig
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import mmdit as jmmdit
from f5e_tts_tpu.ops import attention as jattn
from f5e_tts_tpu.ops.rope import rotary_cos_sin_half as j_rotary
from f5e_tts_tpu.utils.torch_ckpt import mmdit_from_torch, mmdit_to_torch
from f5e_tts_tpu_torch.config import (CFMConfig, InferConfig, MelConfig, MMDiTConfig, ModelConfig,
                                      TrainConfig, UNetTConfig)
from f5e_tts_tpu_torch.data import dataset as tdata
from f5e_tts_tpu_torch.infer import pipeline as tpipe
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.models import mmdit as tmmdit
from f5e_tts_tpu_torch.ops import attention as tattn
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train.trainer import Trainer
from f5e_tts_tpu_torch.utils.convert import (backbone_from_reference_state_dict,
                                             backbone_to_reference_state_dict, load_state_dict,
                                             mmdit_from_jax, mmdit_from_reference_state_dict,
                                             mmdit_to_reference_state_dict, to_tensors)
from f5e_tts_tpu_torch.utils.text import list_str_to_idx
from tests.test_parity_mmdit import mmdit_forward_torch
from tests.test_torch_convert import _flat
from tests.test_torch_training import _draws_from_key  # B, N and mel_dim are the same here

TINY = dict(dim=64, depth=3, heads=2, dim_head=32, ff_mult=2, mel_dim=20, dropout=0.0)
VOCAB = 16
B, N, NT = 2, 32, 12


def _randomized(tree, rng):
    """numpy copy of a JAX tree; zero-initialised leaves (AdaLN, proj_out)
    get seeded values so every weight shapes the output."""
    def leaf(a):
        a = np.asarray(a, np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a
    return jax.tree.map(leaf, tree)


def _model(qk_norm=None, seed=0):
    return _made(qk_norm, seed)


@functools.lru_cache(maxsize=None)
def _made(qk_norm, seed):
    """One eager JAX init a (qk_norm, seed), shared by the tests (read only)."""
    kw = {**TINY, "qk_norm": qk_norm}
    arch_j, arch_t = JMMDiTConfig(**kw), MMDiTConfig(**kw)
    params, _ = jmmdit.init_mmdit(jax.random.PRNGKey(seed), arch_j, VOCAB)
    params = _randomized(params, np.random.default_rng(seed))
    if qk_norm:  # the norm gains start at 1: make them differ per feature
        rng = np.random.default_rng(seed + 1)
        for blk in (params["blocks"], params["final_block"]):
            for name in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
                g = blk["attn"][name]["g"]
                blk["attn"][name]["g"] = (g + 0.2 * rng.standard_normal(g.shape)).astype(np.float32)
    return arch_j, arch_t, params


@pytest.fixture(scope="module")
def model():
    return _model()


def _batch(rng):
    x = rng.standard_normal((B, N, TINY["mel_dim"])).astype(np.float32)
    cond = rng.standard_normal((B, N, TINY["mel_dim"])).astype(np.float32)
    ids = rng.integers(0, VOCAB, (B, NT)).astype(np.int32)
    ids[1, 9:] = -1
    return x, cond, ids, np.asarray([0.2, 0.8], np.float32)


def _assert_tree_close(got: dict, want: dict, rtol, atol_frac=None, atol=None):
    flat_g, flat_w = _flat(got), _flat(want)
    assert flat_g.keys() == flat_w.keys()
    for key, w in flat_w.items():
        w = w.numpy()
        a = atol if atol is not None else atol_frac * max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(flat_g[key].detach().numpy(), w, rtol=rtol, atol=a, err_msg=key)


# ---------------------------------------------------------------------------
# attention layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rope,qk_norm", [(False, None), (False, "rms_norm"), (True, "rms_norm")])
def test_attention_without_rope_and_with_qk_norm_matches_jax(rope, qk_norm):
    rng = np.random.default_rng(0)
    dim, heads, dh, b, n = 64, 2, 32, 2, 24
    p = jax.tree.map(np.asarray, jattn.attention_init(jax.random.PRNGKey(0), dim, heads, dh,
                                                      qk_norm=qk_norm))
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name]["g"] = (1 + 0.2 * rng.standard_normal(dh)).astype(np.float32)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray([n, 17])[:, None]
    cos, sin = j_rotary(dh, n) if rope else (None, None)
    want = jattn.attention(p, jnp.asarray(x), heads, mask=jnp.asarray(mask),
                           rope_cos=None if cos is None else jnp.asarray(cos),
                           rope_sin=None if sin is None else jnp.asarray(sin),
                           qk_norm=qk_norm, compute_dtype=jnp.float32)
    got = tattn.attention(to_tensors(p), torch.from_numpy(x), heads, mask=torch.from_numpy(mask),
                          rope_cos=None if cos is None else torch.from_numpy(cos),
                          rope_sin=None if sin is None else torch.from_numpy(sin),
                          qk_norm=qk_norm, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("masked,qk_norm,pre_only", [(True, None, False), (False, None, False),
                                                     (True, "rms_norm", False),
                                                     (False, "rms_norm", True),
                                                     (True, None, True)])
def test_joint_attention_matches_jax(masked, qk_norm, pre_only):
    rng = np.random.default_rng(1)
    dim, heads, dh, b, n, nt = 64, 2, 32, 2, 24, 8
    p = jax.tree.map(np.asarray, jattn.joint_attention_init(
        jax.random.PRNGKey(1), dim, dim, heads, dh, context_pre_only=pre_only, qk_norm=qk_norm))
    if qk_norm:
        for name in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
            p[name]["g"] = (1 + 0.2 * rng.standard_normal(dh)).astype(np.float32)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    c = rng.standard_normal((b, nt, dim)).astype(np.float32)
    mask = (np.arange(n)[None, :] < np.asarray([n, 13])[:, None]) if masked else None
    (cos, sin), (ccos, csin) = j_rotary(dh, n), j_rotary(dh, nt)
    want_x, want_c = jattn.joint_attention(
        p, jnp.asarray(x), jnp.asarray(c), heads, mask=None if mask is None else jnp.asarray(mask),
        rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin), c_rope_cos=jnp.asarray(ccos),
        c_rope_sin=jnp.asarray(csin), context_pre_only=pre_only, qk_norm=qk_norm,
        compute_dtype=jnp.float32)
    t = torch.from_numpy
    got_x, got_c = tattn.joint_attention(
        to_tensors(p), t(x), t(c), heads, mask=None if mask is None else t(mask),
        rope_cos=t(cos), rope_sin=t(sin), c_rope_cos=t(ccos), c_rope_sin=t(csin),
        context_pre_only=pre_only, qk_norm=qk_norm, compute_dtype=torch.float32)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-4, atol=2e-5)
    assert (got_c is None) == (want_c is None) == pre_only
    if not pre_only:
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4, atol=2e-5)


def test_joint_attention_init_shapes():
    p = tattn.joint_attention_init(64, 48, 2, 32, torch.Generator().manual_seed(0),
                                   context_pre_only=True, qk_norm="rms_norm")
    want = jattn.joint_attention_init(jax.random.PRNGKey(0), 64, 48, 2, 32,
                                      context_pre_only=True, qk_norm="rms_norm")
    got_shapes = {k: tuple(v.shape) for k, v in _flat(p).items()}
    assert got_shapes == {k: tuple(v.shape) for k, v in _flat(jax.tree.map(np.asarray, want)).items()}
    assert "to_out_c" not in p and p["to_q_c"]["w"].abs().max() <= 48 ** -0.5
    with pytest.raises(ValueError, match="qk_norm"):
        tattn.joint_attention(p, torch.zeros(1, 4, 64), torch.zeros(1, 2, 48), 2, qk_norm="layer")


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked,qk_norm", [(True, None), (False, None), (True, "rms_norm")])
def test_mmdit_forward_and_grads_match_jax(masked, qk_norm):
    arch_j, arch_t, params_np = _model(qk_norm)
    x, cond, ids, time = _batch(np.random.default_rng(2))
    mask = (np.arange(N)[None, :] < np.asarray([N, 21])[:, None]) if masked else None
    drop_a, drop_t = np.asarray([False, True]), np.asarray([False, False])
    target = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def fwd_j(p):
        return jmmdit.mmdit_forward(
            p, {}, arch_j, x=jnp.asarray(x), cond=jnp.asarray(cond), text_ids=jnp.asarray(ids),
            time=jnp.asarray(time), drop_audio_cond=jnp.asarray(drop_a),
            drop_text=jnp.asarray(drop_t), mask=None if mask is None else jnp.asarray(mask),
            compute_dtype=jnp.float32)

    def loss_j(p):  # the forward and its gradients in one compiled function
        out = fwd_j(p)
        return jnp.mean((out - target) ** 2), out

    (_, want), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_np)
    params = tstep.tree_map(lambda t: t.requires_grad_(True), mmdit_from_jax(params_np, arch_t))
    t = torch.from_numpy
    got = tmmdit.mmdit_forward(params, arch_t, x=t(x), cond=t(cond), text_ids=t(ids), time=t(time),
                               drop_audio_cond=t(drop_a), drop_text=t(drop_t),
                               mask=None if mask is None else t(mask),
                               compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    (got - t(target)).square().mean().backward()
    _assert_tree_close(tstep.tree_map(lambda p: p.grad, params),
                       mmdit_from_jax(jax.tree.map(np.asarray, grads_j), arch_t),
                       rtol=1e-3, atol=1e-4)


def test_mmdit_matches_from_spec_oracle(model):
    _, arch_t, params_np = model
    x, cond, ids, time = _batch(np.random.default_rng(4))
    t = torch.from_numpy
    want = mmdit_forward_torch(params_np, arch_t, t(x), t(cond), t(ids).long(), t(time)).numpy()
    f = torch.zeros(B, dtype=torch.bool)
    got = tmmdit.mmdit_forward(mmdit_from_jax(params_np, arch_t), arch_t, x=t(x), cond=t(cond),
                               text_ids=t(ids), time=t(time), drop_audio_cond=f, drop_text=f,
                               compute_dtype=torch.float32).numpy()
    # the oracle test's own tolerance: the oracle builds its time embedding and
    # RoPE tables in fp32 torch, ~1e-3 from the float64 numpy tables both packages use
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=2.5e-3)


def test_text_embed_keeps_its_length_and_drops_to_filler(model):
    arch_j, arch_t, params_np = model
    _, _, ids, _ = _batch(np.random.default_rng(5))
    params = mmdit_from_jax(params_np, arch_t)
    for drop in (False, True):
        want = jmmdit.text_embed_fn(params_np, arch_j, jnp.asarray(ids), jnp.full((B,), drop),
                                    jnp.float32)
        got = tbb.precompute_text_embed(params, arch_t, torch.from_numpy(ids), B, N,
                                        torch.full((B,), drop), torch.float32)
        assert got.shape == (B, NT, TINY["dim"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert not got[1, 9:].any()  # padding rows stay zero, dropped or not


def test_backbone_dispatch_kinds():
    assert tbb.backbone_kind(MMDiTConfig()) == "mmdit"
    assert tbb.backbone_kind(UNetTConfig()) == "unett"
    with pytest.raises(TypeError):
        tbb.backbone_kind(object())
    params = tbb.init_backbone(MMDiTConfig(**TINY), VOCAB, torch.Generator().manual_seed(0))
    want, _ = jmmdit.init_mmdit(jax.random.PRNGKey(0), JMMDiTConfig(**TINY), VOCAB)
    want = _flat(mmdit_from_jax(jax.tree.map(np.asarray, want), MMDiTConfig(**TINY)))
    got = _flat(params)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    # AdaLN-zero: the same leaves start at zero
    assert {k for k, v in got.items() if not v.any()} == {k for k, v in want.items() if not v.any()}


# ---------------------------------------------------------------------------
# sampler and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [2.0, 0.0])
def test_sample_with_mmdit_matches_jax_with_injected_noise(model, cfg):
    arch_j, arch_t, params_np = model
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
    t_in = tcfm.prepare_inputs(torch.from_numpy(cond), torch.tensor([40]), torch.tensor([57]), n,
                               text_ids=torch.from_numpy(ids))
    got, traj = tcfm.sample(mmdit_from_jax(params_np, arch_t), arch_t, CFMConfig(), t_in,
                            steps=steps, cfg_strength=cfg, sway_coef=-1.0,
                            y0=torch.from_numpy(y0), compute_dtype=torch.float32, device="cpu")
    assert traj.shape == (steps + 1, 1, n, TINY["mel_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    keep = t_in.cond_mask[:, :, None].expand_as(got)
    assert torch.equal(got[keep], t_in.cond[keep])


@pytest.mark.parametrize("cfm_kw", [{}, {"cond_drop_prob": 1.0}])
def test_cfm_loss_and_grads_with_mmdit_match_jax(model, cfm_kw):
    arch_j, arch_t, params_np = model
    cfm_j, cfm_t = JCFMConfig(**cfm_kw), CFMConfig(**cfm_kw)
    mel, _, ids, _ = _batch(np.random.default_rng(7))
    mel_lens = np.asarray([N, 27], np.int32)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        return jcfm.cfm_loss(p, {}, arch_j, cfm_j, mel=jnp.asarray(mel),
                             mel_lens=jnp.asarray(mel_lens), text_ids=jnp.asarray(ids), rng=key,
                             training=True, compute_dtype=jnp.float32).loss

    want, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params_np)
    params = tstep.tree_map(lambda t: t.requires_grad_(True), mmdit_from_jax(params_np, arch_t))
    out = tcfm.cfm_loss(params, arch_t, cfm_t, mel=torch.from_numpy(mel),
                        mel_lens=torch.from_numpy(mel_lens), text_ids=torch.from_numpy(ids),
                        draws=_draws_from_key(key, cfm_j), compute_dtype=torch.float32)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=1e-5)
    _assert_tree_close(tstep.tree_map(lambda t: t.grad, params),
                       mmdit_from_jax(jax.tree.map(np.asarray, grads_j), arch_t),
                       rtol=1e-3, atol_frac=1e-5)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qk_norm", [None, "rms_norm"])
def test_mmdit_loaders_and_export_match_jax(qk_norm, tmp_path):
    arch_j, arch_t, params_np = _model(qk_norm, seed=2)
    direct = _flat(mmdit_from_jax(params_np, arch_t))
    sd = mmdit_to_torch(params_np, {}, arch_j)
    via_ref = _flat(mmdit_from_reference_state_dict(sd, arch_t))
    assert direct.keys() == via_ref.keys()
    # the loader keeps init_mmdit's leaf order, so two trees compare leaf by leaf
    assert list(via_ref) == list(_flat(tmmdit.init_mmdit(arch_t, VOCAB,
                                                         torch.Generator().manual_seed(0))))
    for k in direct:
        assert direct[k].dtype == via_ref[k].dtype == torch.float32, k
        assert torch.equal(direct[k], via_ref[k]), k
    assert len(mmdit_from_jax(params_np, arch_t)["blocks"]) == TINY["depth"] - 1

    # the export equals the JAX package's, key by key, and its loader reads it back
    ours = mmdit_to_reference_state_dict(mmdit_from_jax(params_np, arch_t), arch_t)
    assert ours.keys() == sd.keys()
    for k, v in sd.items():
        assert ours[k].is_contiguous() and ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    back, _ = mmdit_from_torch({k: v.numpy() for k, v in ours.items()}, arch_j)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 params_np, back)
    last = f"transformer.transformer_blocks.{TINY['depth'] - 1}"
    assert f"{last}.attn.to_out_c.weight" not in ours and f"{last}.ff_c.ff.2.weight" not in ours
    assert ours[f"{last}.attn_norm_c.linear.weight"].shape == (2 * TINY["dim"], TINY["dim"])

    # the dispatch by config type, and a wrong depth
    assert backbone_to_reference_state_dict(mmdit_from_jax(params_np, arch_t), arch_t).keys() == sd.keys()
    again = _flat(backbone_from_reference_state_dict(sd, arch_t))
    assert all(torch.equal(again[k], direct[k]) for k in direct)
    with pytest.raises(ValueError, match="depth"):
        mmdit_from_reference_state_dict(sd, MMDiTConfig(**{**TINY, "depth": 4}))
    with pytest.raises(NotImplementedError):
        backbone_to_reference_state_dict({}, object())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_engine_with_mmdit_pads_text_to_its_own_length(model):
    _, arch_t, params_np = model
    params = mmdit_from_jax(params_np, arch_t)
    mel = dict(n_fft=64, hop_length=16, win_length=64, n_mel_channels=20, target_sample_rate=4000)
    seen = []
    forward = tmmdit.mmdit_forward

    def recording(params, cfg, **kw):
        seen.append((kw["x"].shape, kw["text_embed"].shape, kw["mask"].sum(dim=-1).tolist()))
        return forward(params, cfg, **kw)

    eng = tpipe.TTSEngine(params=params, arch=arch_t, vocab={c: i for i, c in enumerate(" abcdefgh")},
                          tokenizer="custom", mel=MelConfig(**mel),
                          infer_cfg=InferConfig(nfe_steps=3), compute_dtype=torch.float32,
                          buckets=(128, 256), device="cpu")
    wav = (0.1 * np.random.default_rng(8).standard_normal(6000)).astype(np.float32)
    tmmdit.mmdit_forward = recording
    try:
        out, sr, gen_mel = eng.infer(wav, 6000, "abc def.", "a bad cab had a bead, fed a deaf " * 2,
                                     seed=1)
    finally:
        tmmdit.mmdit_forward = forward
    assert sr == 4000 and np.isfinite(gen_mel).all() and gen_mel.shape[1] == 20
    assert len(seen) == 3
    x_shape, te_shape, lens = seen[0]
    # CFG folded into batch 2; the text keeps its padded length (a multiple of 32), not the bucket
    assert x_shape[0] == te_shape[0] == 2 and x_shape[1] in (128, 256)
    assert te_shape[1] % tpipe.TEXT_PAD_TO == 0 and te_shape[1] < x_shape[1]
    assert lens[0] == lens[1] <= x_shape[1]


def test_trainer_with_mmdit_trains_saves_and_exports(tmp_path):
    mel_cfg = MelConfig(n_fft=256, hop_length=64, win_length=256, n_mel_channels=12,
                        target_sample_rate=8000)
    arch = MMDiTConfig(dim=32, depth=2, heads=1, dim_head=32, ff_mult=2, mel_dim=12, dropout=0.0)
    vocab = {c: i for i, c in enumerate(" abcdefgh")}
    tokenize = lambda texts: list_str_to_idx([list(t) for t in texts], vocab)  # noqa: E731
    rng = np.random.default_rng(9)
    rows = [{"audio": {"array": (0.1 * rng.standard_normal(int((0.5 + 0.1 * (i % 5)) * 8000)))
                       .astype(np.float32), "sampling_rate": 8000},
             "text": "abc def gh"[: 4 + i % 6], "duration": 0.5 + 0.1 * (i % 5)} for i in range(8)]
    ds = tdata.ArrowSpeechDataset(rows, durations=[r["duration"] for r in rows], mel=mel_cfg)
    loader = tdata.build_loader(ds, tokenize, frames_threshold=300, max_samples=2, len_multiple=32)
    train_cfg = TrainConfig(learning_rate=1e-3, num_warmup_updates=2, save_per_updates=100,
                            last_per_updates=100, save_dir=str(tmp_path / "ckpts"), seed=0)
    model_cfg = ModelConfig(name="tiny", backbone="MMDiT", arch=arch, mel=mel_cfg, cfm=CFMConfig())
    logs = []
    trainer = Trainer(model_cfg, train_cfg, vocab_size=len(vocab), tokenize=tokenize,
                      log_fn=lambda m, u: logs.append(m), device="cpu")
    ts, info = trainer.train(loader, epochs=1, resume=False, max_updates=3)
    assert ts.update == 3 and info["updates"] == 3
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logs)
    last = tmp_path / "ckpts" / "model_last.pt"
    # the EMA export is in the reference MMDiT layout and re-ingests as the EMA
    sd = load_state_dict(str(last))
    assert "transformer.transformer_blocks.0.attn.to_q_c.weight" in sd
    assert "transformer.transformer_blocks.1.attn.to_out_c.weight" not in sd
    ema, want = _flat(mmdit_from_reference_state_dict(sd, arch)), _flat(ts.ema_params)
    assert ema.keys() == want.keys() and all(torch.equal(ema[k], want[k]) for k in want)
    restored = Trainer(model_cfg, train_cfg, vocab_size=len(vocab), tokenize=tokenize,
                       device="cpu").load_checkpoint(ts)
    assert all(torch.equal(a, b) for a, b in zip(tstep.tree_leaves(restored.params),
                                                 tstep.tree_leaves(ts.params)))
    assert Trainer(ModelConfig(backbone="UNetT", arch=UNetTConfig()), train_cfg, vocab_size=8,
                   tokenize=tokenize, device="cpu").arch == UNetTConfig()
    with pytest.raises(TypeError):
        Trainer(ModelConfig(arch=object()), train_cfg, vocab_size=8, tokenize=tokenize,
                device="cpu")
