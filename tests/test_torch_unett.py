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
- the long-skip DiT forward vs JAX at atol 1e-4, and its converters exactly.
- `load_yaml` / `load_train_yaml` field by field against the JAX loaders.
- the duration predictor, its style encoder and helpers vs JAX at atol 1e-4.
- `F5TTS(config_file=<a tiny UNetT YAML>, device="cpu")`, `Trainer` over a
  UNetTConfig and the CLI's `--model_cfg` on the CPU; `F5TTS.infer` takes
  `target_rms=` as the JAX one does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from f5e_tts_tpu import config as jconfig
from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import UNetTConfig as JUNetTConfig
from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.models import durpred as jdur
from f5e_tts_tpu.models import unett as junett
from f5e_tts_tpu.utils.torch_ckpt import (dit_from_torch, dit_to_torch, unett_from_torch,
                                          unett_to_torch)
from f5e_tts_tpu_torch import api as tapi
from f5e_tts_tpu_torch import config as tconfig
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, MelConfig, ModelConfig, UNetTConfig
from f5e_tts_tpu_torch.infer import audio as taudio
from f5e_tts_tpu_torch.infer import cli as tcli
from f5e_tts_tpu_torch.models import backbone as tbb
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.models import durpred as tdur
from f5e_tts_tpu_torch.models import unett as tunett
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train.trainer import Trainer
from f5e_tts_tpu_torch.utils.convert import (backbone_from_reference_state_dict,
                                             backbone_to_reference_state_dict, dit_from_jax,
                                             dit_from_reference_state_dict,
                                             dit_to_reference_state_dict, to_tensors,
                                             unett_from_jax, unett_from_reference_state_dict,
                                             unett_to_reference_state_dict)
from f5e_tts_tpu_torch.utils.text import list_str_to_bytes
from tests.test_torch_convert import _flat

TINY = dict(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, mel_dim=10, pe_attn_head=1,
            dropout=0.0)
VOCAB = 16
B, N, NT = 2, 24, 10
t = torch.from_numpy


def _model(skip="concat", seed=0, **kw):
    cfg = {**TINY, "skip_connect_type": skip, **kw}
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


def _draws_from_key(key, cfm: JCFMConfig, b, n, mel_dim) -> tcfm.LossDraws:
    """The draws of f5e_tts_tpu.models.cfm.cfm_loss for `key`, in its split order."""
    r_frac, r_span, r_time, r_noise, r_drop1, r_drop2, _ = jax.random.split(key, 7)
    lo, hi = cfm.frac_lengths_mask
    a = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return tcfm.LossDraws(
        frac=a(jax.random.uniform(r_frac, (b,), minval=lo, maxval=hi)),
        span=a(jax.random.uniform(r_span, (b,))),
        x0=a(jax.random.normal(r_noise, (b, n, mel_dim), jnp.float32)),
        time=a(jax.random.uniform(r_time, (b,), jnp.float32)),
        u1=a(jax.random.uniform(r_drop1)), u2=a(jax.random.uniform(r_drop2)))


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

    want = jax.jit(fwd_j)(params_np)
    grads_j = jax.jit(jax.grad(lambda p: jnp.mean((fwd_j(p) - target) ** 2)))(params_np)
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
    init = tbb.init_backbone(arch_t, VOCAB, torch.Generator().manual_seed(0))
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
        tunett.init_unett(UNetTConfig(**{**TINY, "depth": 3}), VOCAB, torch.Generator())


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
                        draws=_draws_from_key(key, cfm_j, B, N, TINY["mel_dim"]),
                        generator=torch.Generator().manual_seed(0), compute_dtype=torch.float32)
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
    assert list(via_ref) == list(_flat(tunett.init_unett(arch_t, VOCAB, torch.Generator())))
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


# ---------------------------------------------------------------------------
# the long-skip DiT
# ---------------------------------------------------------------------------

LONG = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=10, text_dim=16,
            conv_layers=1, dropout=0.0, long_skip_connection=True)


def test_long_skip_dit_forward_and_converters_match_jax():
    arch_j, arch_t = JDiTConfig(**LONG), DiTConfig(**LONG)
    params_np, _ = jdit.init_dit(jax.random.PRNGKey(0), arch_j, VOCAB)
    rng = np.random.default_rng(0)
    params_np = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                             .astype(np.float32), params_np)
    assert "long_skip" in params_np and "b" not in params_np["long_skip"]
    x, cond, ids, time = _batch(np.random.default_rng(1))
    f = np.zeros(B, bool)
    mask = np.arange(N)[None, :] < np.asarray([N, 15])[:, None]
    want, _ = jdit.dit_forward(params_np, {}, arch_j, x=jnp.asarray(x), cond=jnp.asarray(cond),
                               text_ids=jnp.asarray(ids), time=jnp.asarray(time),
                               drop_audio_cond=jnp.asarray(f), drop_text=jnp.asarray(f),
                               drop_ppg=jnp.asarray(f), mask=jnp.asarray(mask),
                               compute_dtype=jnp.float32)
    params = dit_from_jax(params_np, arch_t)
    got = tdit.dit_forward(params, arch_t, x=t(x), cond=t(cond), text_ids=t(ids), time=t(time),
                           drop_audio_cond=t(f), drop_text=t(f), mask=t(mask),
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # the reference layout's long_skip_connection, both ways, and init's leaf order
    sd = dit_to_torch(params_np, {}, arch_j)
    assert "transformer.long_skip_connection.weight" in sd
    ours = dit_to_reference_state_dict(params, arch_t)
    assert ours.keys() == sd.keys()
    assert all(np.array_equal(ours[k].numpy(), v) for k, v in sd.items())
    back = _flat(dit_from_reference_state_dict(sd, arch_t))
    direct = _flat(dit_from_jax(jax.tree.map(np.asarray, dit_from_torch(sd, arch_j)[0]), arch_t))
    assert list(back) == list(_flat(tdit.init_dit(arch_t, VOCAB, torch.Generator())))
    assert back.keys() == direct.keys() and all(torch.equal(back[k], direct[k]) for k in back)


# ---------------------------------------------------------------------------
# YAML configs
# ---------------------------------------------------------------------------


def _same_fields(got, want):
    """Every field of the port's dataclass equals the JAX one's of that name."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b)
        else:
            assert a == b, (f.name, a, b)


def _write_yaml(path, data):
    path.write_text(yaml.safe_dump(data), "utf-8")
    return str(path)


UNETT_YAML = {"model": {"name": "tiny_e2", "backbone": "UNetT", "tokenizer": "byte",
                        "arch": {**{k: v for k, v in TINY.items() if k != "mel_dim"},
                                 "mel_dim": 100, "skip_connect_type": "add"},
                        "mel_spec": {"target_sample_rate": 24000, "n_mel_channels": 100}}}


@pytest.mark.parametrize("which", ["example", "unett", "mmdit_bare"])
def test_load_yaml_matches_jax_field_by_field(which, tmp_path):
    path = {"example": "configs/example.yaml",
            "unett": _write_yaml(tmp_path / "u.yaml", UNETT_YAML),
            "mmdit_bare": _write_yaml(tmp_path / "m.yaml", {"backbone": "MMDiT",
                                                            "arch": {"depth": 3}})}[which]
    got, want = tconfig.load_yaml(path), jconfig.load_yaml(path)
    assert type(got.arch).__name__ == type(want.arch).__name__
    _same_fields(got, want)
    if which == "example":  # the reference's ppg_config / codebook_config keys, mapped
        assert got.arch.ppg.use_ppg and got.arch.ppg.ppg_dim == 256
        assert got.arch.codebook.use_perplex_loss and got.arch.codebook.perplex_loss_prob == 0.1
        assert got.arch.ppg.combined_cond_drop_prob == (0.3, 0.1, 0.5, 0.1)


def test_load_train_yaml_matches_jax_field_by_field(tmp_path):
    got = tconfig.load_train_yaml("configs/example.yaml")
    want = jconfig.load_train_yaml("configs/example.yaml")
    names = {f.name for f in dataclasses.fields(want)}
    assert {f.name for f in dataclasses.fields(got)} <= names
    _same_fields(got, want)
    assert got.save_dir == "ckpts/libritts_ppg_codebook" and got.epochs == 890
    # 8-bit AdamW, sample-count batches and the logger are read as JAX reads them
    for extra in ({"optim": {"bnb_optimizer": True}}, {"datasets": {"batch_size_type": "sample"}},
                  {"ckpts": {"logger": "wandb", "log_samples_per_updates": 7}}):
        path = _write_yaml(tmp_path / "t.yaml", extra)
        _same_fields(tconfig.load_train_yaml(path), jconfig.load_train_yaml(path))
    assert tconfig.load_train_yaml(_write_yaml(tmp_path / "t.yaml", {
        "optim": {"bnb_optimizer": True}, "datasets": {"batch_size_type": "sample"}})
    ).bnb_optimizer is True
    # a mesh over more than one device still raises
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tconfig.load_train_yaml(_write_yaml(tmp_path / "t.yaml", {"mesh": {"fsdp": 2}}))
    bare = _write_yaml(tmp_path / "bare.yaml", {"mesh": None})
    _same_fields(tconfig.load_train_yaml(bare), jconfig.load_train_yaml(bare))


# ---------------------------------------------------------------------------
# entry points over the UNetT
# ---------------------------------------------------------------------------


def _ref_file(tmp_path, seconds=1.0, sr=24000):
    path = str(tmp_path / "ref.wav")
    tt = np.arange(int(seconds * sr)) / sr
    taudio.write_wav(path, (0.2 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32), sr)
    return path


def test_f5tts_from_a_unett_yaml_end_to_end(tmp_path):
    cfg_path = _write_yaml(tmp_path / "e2.yaml", UNETT_YAML)
    tts = tapi.F5TTS(config_file=cfg_path, compute_dtype=torch.float32, device="cpu")
    assert isinstance(tts.engine.arch, UNetTConfig) and tts.model_cfg.name == "tiny_e2"
    assert tts.engine.arch.skip_connect_type == "add"
    assert all("to_qkv" in layer["attn"] for layer in tts.engine.params["first_half"])
    path = _ref_file(tmp_path)
    wav, sr, spec = tts.infer(path, "hi there.", "well hello.", nfe_step=2, seed=7)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all() and spec.shape[1] == 100
    # the reference's loudness keyword is taken, as by the JAX F5TTS, and the
    # engine's InferConfig.target_rms governs either way
    again, _, _ = tts.infer(path, "hi there.", "well hello.", nfe_step=2, seed=7, target_rms=0.05)
    np.testing.assert_array_equal(again, wav)
    # model_cfg overrides reach a UNetT; a reference-layout checkpoint loads by config type
    over = tapi.F5TTS(config_file=cfg_path, model_cfg={"skip_connect_type": "concat"},
                      compute_dtype=torch.float32, device="cpu")
    assert "skip_proj" in over.engine.params["second_half"][0]
    arch_j = JUNetTConfig(**{**TINY, "mel_dim": 100, "skip_connect_type": "add"})
    params_np, _ = junett.init_unett(jax.random.PRNGKey(1), arch_j, 256)
    ckpt = str(tmp_path / "e2.pt")
    torch.save({k: t(v) for k, v in unett_to_torch(jax.tree.map(np.asarray, params_np), {},
                                                   arch_j).items()}, ckpt)
    loaded = tapi.F5TTS(config_file=cfg_path, ckpt_file=ckpt, use_ema=False,
                        compute_dtype=torch.float32, device="cpu")
    want = _flat(tbb.fuse_qkv(unett_from_jax(jax.tree.map(np.asarray, params_np),
                                             loaded.engine.arch), loaded.engine.arch))
    got = _flat(loaded.engine.params)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_f5tts_infer_takes_target_rms_like_jax(tmp_path):
    """The JAX F5TTS.infer accepts target_rms= and leaves it unused; so does
    the port's, on the same tiny YAML."""
    from f5e_tts_tpu.api import F5TTS as JF5TTS
    from f5e_tts_tpu.config import InferConfig as JInferConfig

    tiny = {"model": {"name": "tiny", "backbone": "DiT", "tokenizer": "byte",
                      "arch": {"dim": 32, "depth": 1, "heads": 1, "dim_head": 32, "ff_mult": 2,
                               "mel_dim": 100, "text_dim": 16, "conv_layers": 0,
                               "dropout": 0.0}}}
    cfg_path = _write_yaml(tmp_path / "tiny.yaml", tiny)
    path = _ref_file(tmp_path)
    jtts = JF5TTS(config_file=cfg_path, compute_dtype=jnp.float32)
    jtts.engine.infer_cfg = JInferConfig(nfe_steps=2, max_duration=256)
    jtts.engine.buckets = (128, 256)
    ttts = tapi.F5TTS(config_file=cfg_path, compute_dtype=torch.float32, device="cpu")
    for tts in (jtts, ttts):
        kw = dict(nfe_step=2, seed=3, fix_duration=1.5)
        plain = tts.infer(path, "hi there.", "well hello.", **kw)[0]
        quiet = tts.infer(path, "hi there.", "well hello.", target_rms=0.05, **kw)[0]
        assert np.isfinite(quiet).all()
        np.testing.assert_array_equal(quiet, plain)


def test_trainer_trains_a_unett_on_the_cpu(tmp_path):
    from f5e_tts_tpu_torch.config import TrainConfig
    from f5e_tts_tpu_torch.data import dataset as tdata
    from f5e_tts_tpu_torch.utils.convert import load_state_dict

    arch = UNetTConfig(**{**TINY, "mel_dim": 20})
    mel_cfg = MelConfig(n_fft=256, hop_length=64, win_length=256, n_mel_channels=20,
                        target_sample_rate=8000)
    rng = np.random.default_rng(0)
    rows = [{"audio": {"array": (0.1 * rng.standard_normal(int((0.5 + 0.1 * (i % 5)) * 8000)))
                       .astype(np.float32), "sampling_rate": 8000},
             "text": "abc def gh"[: 4 + i % 6], "duration": 0.5 + 0.1 * (i % 5)} for i in range(6)]
    ds = tdata.ArrowSpeechDataset(rows, durations=[r["duration"] for r in rows], mel=mel_cfg)
    loader = tdata.build_loader(ds, list_str_to_bytes, frames_threshold=300, max_samples=2,
                                len_multiple=32)
    train_cfg = TrainConfig(learning_rate=1e-3, num_warmup_updates=2, save_per_updates=100,
                            last_per_updates=100, save_dir=str(tmp_path / "ckpts"), seed=0)
    model_cfg = ModelConfig(name="tiny_e2", backbone="UNetT", arch=arch, mel=mel_cfg,
                            cfm=CFMConfig())
    logs = []
    trainer = Trainer(model_cfg, train_cfg, vocab_size=256, tokenize=list_str_to_bytes,
                      log_fn=lambda m, u: logs.append(m), device="cpu")
    ts, info = trainer.train(loader, epochs=1, resume=False, max_updates=2)
    assert ts.update == 2 and info["updates"] == 2
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logs)
    # the EMA export is in the reference UNetT layout and re-ingests as the EMA
    sd = load_state_dict(str(tmp_path / "ckpts" / "model_last.pt"))
    assert "transformer.layers.2.0.weight" in sd and "transformer.norm_out.g" in sd
    ema, want = _flat(unett_from_reference_state_dict(sd, arch)), _flat(ts.ema_params)
    assert ema.keys() == want.keys() and all(torch.equal(ema[k], want[k]) for k in want)


def test_cli_runs_a_model_yaml_on_the_cpu(tmp_path, monkeypatch):
    import functools
    import os

    monkeypatch.setattr(tapi, "F5TTS", functools.partial(tapi.F5TTS, compute_dtype=torch.float32))
    cfg_path = _write_yaml(tmp_path / "e2.yaml", UNETT_YAML)
    path = _ref_file(tmp_path)
    out_dir = str(tmp_path / "out")
    out = tcli.main(["-r", path, "-s", "hello there", "-t", "Hi.", "-o", out_dir, "-w", "o.wav",
                     "--nfe_step", "2", "--model_cfg", cfg_path, "--device", "cpu"])
    assert out == os.path.join(out_dir, "o.wav")
    wav, sr = taudio.read_wav(out)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    with pytest.raises(SystemExit, match="ASR weights not found at whisper"):
        tcli.main(["-r", path, "-t", "x", "--device", "cpu", "--asr_model", "whisper"])


# ---------------------------------------------------------------------------
# the duration predictor
# ---------------------------------------------------------------------------


def test_duration_predictor_and_style_encoder_match_jax():
    rng = np.random.default_rng(0)
    scfg = jdur.StyleEncoderConfig(n_mel_channels=10, style_hidden=16, style_vector_dim=12)
    dcfg = jdur.DurPredConfig(in_channels=8, filter_channels=16, style_vector_dim=12)
    sp = jax.tree.map(np.asarray, jdur.init_style_encoder(jax.random.PRNGKey(0), scfg))
    dp = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                      .astype(np.float32), jdur.init_duration_predictor(jax.random.PRNGKey(1),
                                                                          dcfg))
    mel = rng.standard_normal((2, 20, 10)).astype(np.float32)
    mel_lens = np.asarray([20, 13], np.int32)
    x = rng.standard_normal((2, 7, 8)).astype(np.float32)
    x_mask = np.arange(7)[None, :] < np.asarray([7, 5])[:, None]
    tscfg = tdur.StyleEncoderConfig(**dataclasses.asdict(scfg))
    tdcfg = tdur.DurPredConfig(**dataclasses.asdict(dcfg))
    for lens in (mel_lens, None):
        want = jdur.style_encoder(sp, scfg, jnp.asarray(mel),
                                  None if lens is None else jnp.asarray(lens))
        got = tdur.style_encoder(to_tensors(sp), tscfg, t(mel), None if lens is None else t(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    style = np.asarray(want)
    want = jdur.duration_predictor(dp, dcfg, jnp.asarray(x), jnp.asarray(x_mask),
                                   jnp.asarray(style))
    got = tdur.duration_predictor(to_tensors(dp), tdcfg, t(x), t(x_mask), t(style))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    dur = np.asarray([[2, 3, 1, 0], [1, 1, 4, 2]], np.int32)
    mask = np.ones((2, 4, 9), np.float32)
    mask[1, 3] = 0.0
    np.testing.assert_array_equal(tdur.generate_path(t(dur), t(mask)).numpy(),
                                  np.asarray(jdur.generate_path(jnp.asarray(dur), jnp.asarray(mask))))
    logw, logw_hat = rng.standard_normal((2, 4)), rng.standard_normal((2, 4))
    np.testing.assert_allclose(
        tdur.duration_loss(t(logw), t(logw_hat), torch.tensor([4, 3])).item(),
        float(jdur.duration_loss(jnp.asarray(logw), jnp.asarray(logw_hat), jnp.asarray([4, 3]))),
        rtol=1e-6)
    # init shapes follow the JAX init
    for got_p, want_p in ((tdur.init_style_encoder(tscfg, torch.Generator()), sp),
                          (tdur.init_duration_predictor(tdcfg, torch.Generator()), dp)):
        assert {k: tuple(v.shape) for k, v in _flat(got_p).items()} == \
            {k: tuple(v.shape) for k, v in _flat(to_tensors(want_p)).items()}
