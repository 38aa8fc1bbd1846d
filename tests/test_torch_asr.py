"""The PPG ASR model's training, alignment, decoder and tools in the port
against the JAX package on the CPU: a small Conformer (1 block, 16 wide, 2
heads, 32 linear units, conv kernel 7, 20 fbank bins), a small decoder (2
blocks, 16 wide, 2 heads, vocab 11), fp32, weights carried across from the
JAX inits, inputs from numpy seeds.

- `asr_loss` with CE only, CTC only, both, the speaker branch (softmax, arc
  margin, add margin), a chunk mask, and a CTC row whose labels cannot fit
  its frames (optax's floored value): every term at rtol 1e-5.
- One `make_asr_train_step` against the JAX step with optax.adamw
  (weight decay 0, eps 1e-3; the port's AdamW unclipped, the same eps): the
  loss at rtol 1e-5, every parameter at atol 2e-6.
- `grad_reverse` (value and gradient exactly), `stats_pool` and
  `center_loss_fn` at atol 1e-6.
- `ctc_forced_align`'s paths exactly, a tie case included;
  `token_spans_from_alignment` and `derive_edit_spans` exactly.
- `decoder_forward` (uni and bi), `label_smoothing_loss`, `attention_loss`
  and `th_accuracy` at atol 1e-5; `add_sos_eos` and `reverse_pad_list`
  exactly; `decoder_from_torch` equal tensors.
- `ctc_greedy_search`, `attention_greedy_decode` and `recognize` in both
  modes: equal token lists. `average_checkpoints` exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f5e_tts_tpu.infer import speech_edit as jedit
from f5e_tts_tpu.models import conformer as jconf
from f5e_tts_tpu.models import conformer_train as jtrain
from f5e_tts_tpu.models import wenet_decoder as jdec
from f5e_tts_tpu.models import wenet_tools as jtools
from f5e_tts_tpu_torch.infer import speech_edit as tedit
from f5e_tts_tpu_torch.models import conformer as tconf
from f5e_tts_tpu_torch.models import conformer_train as ttrain
from f5e_tts_tpu_torch.models import wenet_decoder as tdec
from f5e_tts_tpu_torch.models import wenet_tools as ttools
from f5e_tts_tpu_torch.train.step import AdamW, tree_leaves
from f5e_tts_tpu_torch.utils.convert import to_tensors

SMALL = dict(input_dim=20, output_size=16, attention_heads=2, linear_units=32, num_blocks=1,
             cnn_module_kernel=7)
CFG_J, CFG_T = jconf.ConformerConfig(**SMALL), tconf.ConformerConfig(**SMALL)
VOCAB = 11
DEC = dict(vocab_size=VOCAB, dim=16, attention_heads=2, linear_units=32, num_blocks=2)


def np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _encoder(seed):
    params = np_tree(jconf.init_conformer(jax.random.PRNGKey(seed), CFG_J))
    rng = np.random.default_rng(seed)
    params["cmvn_istd"] = (0.5 + rng.random(20)).astype(np.float32)
    return params


def _batch(seed=0, b=3, t=41):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 20)).astype(np.float32)
    feat_lens = np.asarray([t, t - 10, t - 16], np.int32)
    tp = (t - 1) // 2
    labels = rng.integers(0, VOCAB, (b, tp)).astype(np.int32)
    labels[1, 12:] = -1
    ctc_labels = rng.integers(1, VOCAB, (b, 14)).astype(np.int32)
    # row 2: 12 frames after subsampling cannot hold 14 labels
    ctc_lens = np.asarray([6, 4, 14], np.int32)
    return {"feats": feats, "feat_lens": feat_lens, "frame_labels": labels,
            "ctc_labels": ctc_labels, "ctc_label_lens": ctc_lens}


def _tj(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tt(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["ce", "ctc", "both", "sv_softmax", "sv_arc_margin",
                                  "sv_add_margin", "chunk_mask"])
def test_asr_loss_matches_jax(case):
    enc = _encoder(1)
    heads = np_tree(jtrain.init_asr_heads(jax.random.PRNGKey(2), CFG_J, VOCAB))
    batch = _batch(3)
    kw = {}
    if case == "ce":
        batch.pop("ctc_labels"), batch.pop("ctc_label_lens")
    elif case == "ctc":
        batch.pop("frame_labels")
    if case.startswith("sv_"):
        kind = case[3:]
        sv = np_tree(jtrain.init_sv_branch(jax.random.PRNGKey(4), CFG_J, 5, spk_dim=8,
                                           sv_loss=kind))
        kw = dict(spk_label=np.asarray([0, 3, 4], np.int32), sv_weight=0.3, sv_loss_kind=kind,
                  grl_coeff=0.7)
    if case == "chunk_mask":
        kw = dict(chunk_mask=jconf.subsequent_chunk_mask_np(20, 5))
    want = jtrain.asr_loss(jax.tree.map(jnp.asarray, enc), jax.tree.map(jnp.asarray, heads),
                           CFG_J, **_tj(batch), ppg_weight=0.4,
                           sv_params=jax.tree.map(jnp.asarray, sv) if case.startswith("sv_")
                           else None, **{k: jnp.asarray(v) if k in ("spk_label", "chunk_mask")
                                         else v for k, v in kw.items()})
    got = ttrain.asr_loss(to_tensors(enc), to_tensors(heads), CFG_T, **_tt(batch),
                          ppg_weight=0.4, sv_params=to_tensors(sv) if case.startswith("sv_")
                          else None, **{k: torch.from_numpy(v) if k in ("spk_label", "chunk_mask")
                                        else v for k, v in kw.items()})
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name), atol=1e-6)
    if case in ("ctc", "both"):
        assert float(want.ctc_loss) > 3e4  # the infeasible row's floored cost is in the mean


def test_ctc_loss_matches_optax_rowwise():
    """F.ctc_loss on the rows that fit and the floored recursion on the
    others give optax.ctc_loss row by row (repeats need a blank between)."""
    rng = np.random.default_rng(5)
    lp = jax.nn.log_softmax(jnp.asarray(rng.standard_normal((4, 6, 5)).astype(np.float32)), -1)
    labels = np.asarray([[1, 2, 3, 0, 0], [1, 1, 2, 2, 3], [1, 2, 3, 4, 1], [2, 2, 0, 0, 0]],
                        np.int32)
    llens, tlens = np.asarray([3, 5, 5, 2]), np.asarray([6, 6, 4, 3])
    pad_l = 1.0 - (np.arange(6)[None] < tlens[:, None])
    pad_u = 1.0 - (np.arange(5)[None] < llens[:, None])
    want = optax.ctc_loss(lp, jnp.asarray(pad_l, jnp.float32), jnp.asarray(labels),
                          jnp.asarray(pad_u, jnp.float32))
    args = (torch.from_numpy(np.array(lp)), torch.from_numpy(tlens), torch.from_numpy(labels),
            torch.from_numpy(llens))
    _close(ttrain.ctc_loss(*args), want)
    _close(ttrain._ctc_loss_floored(*args), want)
    assert np.asarray(want)[1] > 1e5 and np.asarray(want)[2] > 1e5


def test_asr_train_step_matches_jax():
    enc = _encoder(6)
    heads = np_tree(jtrain.init_asr_heads(jax.random.PRNGKey(7), CFG_J, VOCAB))
    batch = _batch(8)
    batch["chunk_mask"] = jconf.subsequent_chunk_mask_np(20, 6)
    batch["ctc_label_lens"] = np.asarray([6, 4, 5], np.int32)
    # eps 1e-3: the gradients that are zero analytically (linear_k's bias, the
    # position table's near-constant columns) are rounding noise, which
    # Adam's first step would scale up to lr with a tiny eps
    opt = optax.adamw(3e-3, b1=0.9, b2=0.999, eps=1e-3, weight_decay=0.0)
    pj = (jax.tree.map(jnp.asarray, enc), jax.tree.map(jnp.asarray, heads))
    step_j = jtrain.make_asr_train_step(CFG_J, opt, ppg_weight=0.3)
    new_enc, new_heads, _, out_j = step_j(pj[0], pj[1], opt.init(pj), _tj(batch))

    pt, ht = to_tensors(enc), to_tensors(heads)
    optimizer = AdamW(lambda count: 3e-3, max_grad_norm=float("inf"), eps=1e-3)
    state = optimizer.init(tree_leaves([pt, ht]))
    step_t = ttrain.make_asr_train_step(CFG_T, optimizer, ppg_weight=0.3)
    pt, ht, state, out_t = step_t(pt, ht, state, _tt(batch))
    _close(out_t.loss, out_j.loss)
    assert state.count == 1
    got_np = jax.tree.map(lambda x: x.detach().numpy(), (pt, ht), is_leaf=torch.is_tensor)
    for got, want in zip(jax.tree.leaves(got_np), jax.tree.leaves((new_enc, new_heads))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-6)


def test_grad_reverse_stats_pool_and_center_loss_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 7, 4)).astype(np.float32)
    lens = np.asarray([7, 5, 6])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ttrain.grad_reverse(xt, 0.5)
    (y * torch.arange(4.0)).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(jtrain.grad_reverse(v, 0.5) * jnp.arange(4.0)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), x)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    _close(ttrain.stats_pool(torch.from_numpy(x), torch.from_numpy(lens)),
           jtrain.stats_pool(jnp.asarray(x), jnp.asarray(lens)), rtol=0, atol=1e-6)
    cl = np_tree(jtrain.init_center_loss(jax.random.PRNGKey(3), 6, 4))
    labels = rng.integers(-1, 6, (3, 7))
    _close(ttrain.center_loss_fn(to_tensors(cl), torch.from_numpy(x), torch.from_numpy(labels)),
           jtrain.center_loss_fn(cl, jnp.asarray(x), jnp.asarray(labels)), rtol=0, atol=1e-6)
    assert set(ttrain.init_center_loss(6, 4, torch.Generator().manual_seed(0))) == {"centers"}


def test_ctc_forced_align_and_edit_spans_match_jax():
    rng = np.random.default_rng(10)
    for t_len, label in ((30, [3, 1, 4, 1, 5]), (12, [2, 2, 7]), (9, [6]), (40, [1, 2, 1, 2, 3, 3])):
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((t_len, 8)) * 2), -1))
        assert ttrain.ctc_forced_align(lp, label) == jtrain.ctc_forced_align(lp, label)
        assert (ttrain.ctc_forced_align(lp, label, return_states=True)
                == jtrain.ctc_forced_align(lp, label, return_states=True))
        assert (tedit.token_spans_from_alignment(lp, label, 0.02)
                == jedit.token_spans_from_alignment(lp, label, 0.02))
        ranges = [(0, 0), (0, len(label) - 1)] + ([(1, len(label) - 1)] if len(label) > 1 else [])
        assert (tedit.derive_edit_spans(torch.from_numpy(lp), label, ranges, 0.02)
                == jedit.derive_edit_spans(lp, label, ranges, 0.02))
    # ties: uniform posteriors make every predecessor equal; the first wins
    flat = np.full((10, 4), np.log(0.25))
    for label in ([1, 2], [1, 1], [3]):
        assert ttrain.ctc_forced_align(flat, label, return_states=True) == \
            jtrain.ctc_forced_align(flat, label, return_states=True)
    with pytest.raises(ValueError):
        tedit.derive_edit_spans(flat, [1, 2], [(1, 2)], 0.02)


def _decoder(seed, r_num_blocks=0):
    cfg_j = jdec.DecoderConfig(**DEC, r_num_blocks=r_num_blocks)
    cfg_t = tdec.DecoderConfig(**DEC, r_num_blocks=r_num_blocks)
    return cfg_j, cfg_t, np_tree(jdec.init_decoder(jax.random.PRNGKey(seed), cfg_j))


def test_target_prep_and_accuracy_match_jax():
    ys = np.asarray([[4, 5, 6, -1], [7, -1, -1, -1], [1, 2, 3, 4]], np.int64)
    for got, want in zip(tdec.add_sos_eos(ys, 9, 10), jdec.add_sos_eos(ys, 9, 10)):
        np.testing.assert_array_equal(got, want)
    lens = np.asarray([3, 1, 4])
    np.testing.assert_array_equal(tdec.reverse_pad_list(ys, lens), jdec.reverse_pad_list(ys, lens))
    logits = np.random.default_rng(11).standard_normal((3, 4, 11)).astype(np.float32)
    _close(tdec.th_accuracy(torch.from_numpy(logits), torch.from_numpy(ys)),
           jdec.th_accuracy(jnp.asarray(logits), jnp.asarray(ys)))


@pytest.mark.parametrize("bi", [False, True])
def test_decoder_forward_and_losses_match_jax(bi):
    cfg_j, cfg_t, params = _decoder(12, r_num_blocks=1 if bi else 0)
    rng = np.random.default_rng(13)
    memory = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mem_lens = np.asarray([9, 6])
    ys = np.asarray([[3, 4, 5, 6], [7, 8, -1, -1]], np.int64)
    ys_in, _ = jdec.add_sos_eos(ys, 1, 2)
    ys_in_lens = np.asarray([5, 3])
    rw = 0.3 if bi else 0.0
    r_ys_in = jdec.add_sos_eos(jdec.reverse_pad_list(ys, ys_in_lens - 1), 1, 2)[0] if bi else None
    lj, rj, oj = jdec.decoder_forward(jax.tree.map(jnp.asarray, params), cfg_j,
                                      jnp.asarray(memory), jnp.asarray(mem_lens),
                                      jnp.asarray(ys_in), jnp.asarray(ys_in_lens),
                                      r_ys_in=None if r_ys_in is None else jnp.asarray(r_ys_in),
                                      reverse_weight=rw)
    lt, rt, ot = tdec.decoder_forward(tdec.decoder_from_jax(params), cfg_t,
                                      torch.from_numpy(memory), torch.from_numpy(mem_lens),
                                      torch.from_numpy(ys_in), torch.from_numpy(ys_in_lens),
                                      r_ys_in=None if r_ys_in is None else torch.from_numpy(r_ys_in),
                                      reverse_weight=rw)
    _close(lt, lj, rtol=0, atol=1e-5)
    _close(rt, rj, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    target = np.asarray(jdec.add_sos_eos(ys, 1, 2)[1])
    for norm in (False, True):
        _close(tdec.label_smoothing_loss(lt, torch.from_numpy(target), normalize_length=norm),
               jdec.label_smoothing_loss(lj, jnp.asarray(target), normalize_length=norm),
               rtol=0, atol=1e-5)
    loss_j, acc_j = jdec.attention_loss(jax.tree.map(jnp.asarray, params), cfg_j,
                                        jnp.asarray(memory), jnp.asarray(mem_lens), ys, 1, 2,
                                        reverse_weight=rw)
    loss_t, acc_t = tdec.attention_loss(tdec.decoder_from_jax(params), cfg_t,
                                        torch.from_numpy(memory), torch.from_numpy(mem_lens),
                                        ys, 1, 2, reverse_weight=rw)
    _close(loss_t, loss_j, rtol=0, atol=1e-5)
    _close(acc_t, acc_j, rtol=0, atol=1e-5)


def _to_wenet_decoder(params, prefix):
    sd = {}
    for i, layer in enumerate(params["layers"]):
        k = f"{prefix}decoders.{i}"
        for att in ("self_attn", "src_attn"):
            for n, p in layer[att].items():
                sd[f"{k}.{att}.{n}.weight"], sd[f"{k}.{att}.{n}.bias"] = p["w"].T, p["b"]
        for src, dst in (("w1", "w_1"), ("w2", "w_2")):
            sd[f"{k}.feed_forward.{dst}.weight"] = layer["ff"][src]["w"].T
            sd[f"{k}.feed_forward.{dst}.bias"] = layer["ff"][src]["b"]
        for n in ("norm1", "norm2", "norm3"):
            sd[f"{k}.{n}.weight"], sd[f"{k}.{n}.bias"] = layer[n]["g"], layer[n]["b"]
    sd[f"{prefix}embed.0.weight"] = params["embed"]["w"]
    sd[f"{prefix}after_norm.weight"] = params["after_norm"]["g"]
    sd[f"{prefix}after_norm.bias"] = params["after_norm"]["b"]
    sd[f"{prefix}output_layer.weight"] = params["output_layer"]["w"].T
    sd[f"{prefix}output_layer.bias"] = params["output_layer"]["b"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("bi", [False, True])
def test_decoder_from_torch_matches_jax(bi):
    cfg_j, cfg_t, params = _decoder(14, r_num_blocks=1 if bi else 0)
    if bi:
        sd = {**_to_wenet_decoder(params["left"], "decoder.left_decoder."),
              **_to_wenet_decoder(params["right"], "decoder.right_decoder.")}
    else:
        sd = _to_wenet_decoder(params["left"], "decoder.")
    want = jdec.decoder_from_torch(sd, cfg_j)
    got = tdec.decoder_from_torch({k: torch.from_numpy(v) for k, v in sd.items()}, cfg_t)
    got_np = jax.tree.map(lambda x: x.numpy(), got, is_leaf=torch.is_tensor)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    assert tdec.init_decoder(cfg_t, torch.Generator().manual_seed(0)).keys() == want.keys()


def test_greedy_searches_and_recognize_match_jax():
    enc = _encoder(15)
    ext_j = jconf.PPGExtractor(params=jax.tree.map(jnp.asarray, enc), cfg=CFG_J)
    ext_t = tconf.PPGExtractor(params=tconf.conformer_from_jax(enc), cfg=CFG_T, device="cpu")
    rng = np.random.default_rng(16)
    feats = rng.standard_normal((2, 45, 20)).astype(np.float32)
    lens = np.asarray([45, 30])
    ctc = np_tree(jtrain.init_asr_heads(jax.random.PRNGKey(17), CFG_J, VOCAB))["ctc"]
    ctc["w"] = ctc["w"] * 8.0  # peaked posteriors, so the greedy path has repeats and blanks
    cfg_j, cfg_t, dec = _decoder(18)
    got = ttools.recognize(ext_t, feats, lens, mode="ctc_greedy_search", ctc_params=ctc)
    want = jtools.recognize(ext_j, feats, lens, mode="ctc_greedy_search", ctc_params=ctc)
    assert got == want and any(got)
    kw = dict(mode="attention", decoder_params=dec, sos=1, eos=2, max_len=3)
    got = ttools.recognize(ext_t, feats, lens, decoder_cfg=cfg_t, **kw)
    want = jtools.recognize(ext_j, feats, lens, decoder_cfg=cfg_j, **kw)
    assert got == want and all(len(h) <= 3 for h in got)
    logits = rng.standard_normal((3, 12, 5)) * 3
    assert (tdec.ctc_greedy_search(torch.from_numpy(logits), torch.tensor([12, 7, 0]))
            == jdec.ctc_greedy_search(logits, np.asarray([12, 7, 0])))
    memory = rng.standard_normal((2, 9, 16)).astype(np.float32)
    # an eos-heavy output layer ends every row early
    dec_eos = np_tree(dec)
    dec_eos["left"]["output_layer"]["b"][2] = 3.0
    assert (tdec.attention_greedy_decode(tdec.decoder_from_jax(dec_eos), cfg_t,
                                         torch.from_numpy(memory), torch.tensor([9, 4]), 1, 2,
                                         max_len=4)
            == jdec.attention_greedy_decode(jax.tree.map(jnp.asarray, dec_eos), cfg_j,
                                            jnp.asarray(memory), jnp.asarray([9, 4]), 1, 2,
                                            max_len=4))
    with pytest.raises(ValueError, match="unknown decode mode"):
        ttools.recognize(ext_t, feats, lens, mode="beam")


def test_average_checkpoints_matches_jax(tmp_path):
    rng = np.random.default_rng(19)
    paths = []
    for i in range(3):
        sd = {"a.weight": torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32)),
              "b.bias": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
              "n": torch.tensor(i)}
        paths.append(str(tmp_path / f"{i}.pt"))
        torch.save(sd, paths[-1])
    got, want = ttools.average_checkpoints(paths), jtools.average_checkpoints(paths)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    ttools.average_model_main(["--dst_model", str(tmp_path / "avg.pt"), "--src_paths", *paths])
    avg = torch.load(tmp_path / "avg.pt", weights_only=True)
    np.testing.assert_array_equal(avg["a.weight"].numpy(), want["a.weight"])
