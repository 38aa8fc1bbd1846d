"""The port's Trainer over meshes of four gloo ranks on the CPU, held against
the JAX package's Trainer under the same meshes on its virtual CPU devices.

One world of four processes (tests/_torch_parallel_worker.py, job "train")
runs every mesh while this process compiles the JAX steps. A tiny DiT
(dim 64, depth 2, 4 heads of 64), fp32, dropout 0, from the same seeded
params on both sides (the port reads them as a reference-layout
checkpoint: `init_state(pretrained_path=)`); two Trainer updates on one
global batch of 4 with the JAX steps' draws (its split order on
fold_in(key, micro + skipped), rows cut per rank by `row_draws`).

- DP (data 4), DP x TP (data 2 x model 2), FSDP (data 2 x fsdp 2), DP x PP
  (data 2 x pipe 2, two microbatches: JAX's gpipe_scan) and SP (data 2 x
  seq 2, ring attention engaged by min_seq 8 on both sides: JAX's
  ring_attention) against the JAX Trainer's step under the same mesh or,
  for data 4, the JAX mesh of the same replica count (`JAX_MESH`): loss
  and global gradient norm of each
  update to rtol 1e-5, the params, the EMA and Adam's first moment after
  them to 2e-6 absolute (an Adam step moves a weight by ~lr = 1e-3: 0.2 % of
  it, as tests/test_torch_training.py). The warm-up (1 update) scales by
  data x fsdp on both sides.
- Each mesh's local shards (FSDP halves a block matrix's input dim for the
  weight, its moments and its EMA; TP its output dim; PP holds depth / 2
  blocks) and its model_last.pt, gathered by rank 0 into the single-device
  layout: the single-process Trainer loads it to the same params and the
  same fixed-draw loss (1e-6).
- The 8-bit AdamW under data 2 x fsdp 2 and data 2 x model 2 against the
  JAX Trainer with `bnb_optimizer` under the same mesh: loss and gradient
  norm to rtol 1e-5; the params, the EMA and the decoded moments to 2e-6
  absolute. Its model_last.pt written under fsdp 2 resumes in the
  single-process Trainer with the same codes and scales, the same next
  loss (1e-6) and the same params after it (2e-6). Under data 2 x pipe 2
  its moments go through a checkpoint and back bit for bit.
- A PPG DiT with the codebook (align and perplexity losses, cross mask, the
  PPG in the batch) under data 2 x fsdp 2, one row a rank, against the JAX
  Trainer on the same global batch: loss, gradient norm and extra loss to
  rtol 1e-5; the params and the BatchNorm running statistics to 2e-6 (the
  statistics, the perplexity and the align loss's mean are the global
  batch's). With no injected draws, every rank's codebook branch uses the
  same permutations and cross-mask coin.
- Preemption across the ranks (JAX tests/test_multihost_trainer.py, its
  data 2 x fsdp 2 mesh): six updates; SIGTERM on every rank at update 3
  saves model_last and stops every rank; the resumed run repeats the
  uninterrupted run's losses of updates 4-6 bit for bit.
- The YAML CLI (train/train.py) in every rank under its `mesh:` section.
- The sample hook under data 2 x model 2, data 2 x fsdp 2 and data 2 x pipe
  2: rank 0's mel at update 2 against the hook run in this process on the
  EMA of that run's model_last.pt, 1e-5 absolute (the same fp32 ops, one
  thread against several).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import CFMConfig as JCFMConfig
from f5e_tts_tpu.config import CodebookConfig as JCodebookConfig
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.config import MeshConfig as JMeshConfig
from f5e_tts_tpu.config import ModelConfig as JModelConfig
from f5e_tts_tpu.config import PPGConfig as JPPGConfig
from f5e_tts_tpu.config import TrainConfig as JTrainConfig
from f5e_tts_tpu.ops.attention import set_sp_context as jset_sp
from f5e_tts_tpu.ops.attention import set_tp_context as jset_tp
from f5e_tts_tpu.parallel.pipeline import set_pp_context as jset_pp
from f5e_tts_tpu.train import adamw8bit as j8
from f5e_tts_tpu.train import trainer as jtrainer
from f5e_tts_tpu_torch.config import (CFMConfig, CodebookConfig, DiTConfig, MelConfig,
                                      ModelConfig, PPGConfig, TrainConfig)
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.parallel import mesh as pmesh
from f5e_tts_tpu_torch.train import adamw8bit as t8
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train.trainer import Trainer, loss_with_device_mel, make_sample_logger
from f5e_tts_tpu_torch.utils.convert import (dit_from_jax, dit_from_reference_state_dict,
                                             dit_to_reference_state_dict, load_state_dict)
from tests._torch_parallel_worker import collect, decoded, launch
from tests.test_torch_codebook import _dit_draws
from tests.test_torch_parallel_ops import _random_dit
from tests.test_torch_train_cli import _make_dataset_dir, _write_yaml

WORLD = 4
ARCH = dict(dim=64, depth=2, heads=4, dim_head=64, ff_mult=2, mel_dim=8, text_dim=16,
            conv_layers=1, dropout=0.0)
MEL = dict(n_fft=256, hop_length=64, win_length=256, n_mel_channels=8, target_sample_rate=8000)
TC = dict(learning_rate=1e-3, num_warmup_updates=1, compute_dtype="float32", seed=0,
          save_per_updates=10 ** 9, last_per_updates=10 ** 9, pp_microbatches=2)
B, N, NT, VOCAB, TOTAL = 4, 32, 6, 10, 10
MESHES = {"dp4": {"data": 4}, "dp2_tp2": {"data": 2, "model": 2},
          "fsdp2": {"data": 2, "fsdp": 2}, "dp2_pp2": {"data": 2, "pipe": 2},
          "dp2_sp2": {"data": 2, "seq": 2}}
# the JAX mesh each port mesh is held against: its own, but for data 4 the
# JAX mesh of its replica count (data x fsdp, which scales the warm-up),
# data 2 x fsdp 2: GSPMD's layouts leave the step's math as it is (JAX's
# tests/test_sharding.py holds its data and fsdp steps to its single-device
# one), and one JAX step costs ~15 s of tracing and compiling on the CPU
JAX_MESH = {"dp4": "fsdp2", "dp2_tp2": "dp2_tp2", "fsdp2": "fsdp2", "dp2_pp2": "dp2_pp2",
            "dp2_sp2": "dp2_sp2"}
# the 8-bit AdamW's meshes, held against the JAX Trainer's with bnb_optimizer
BNB_MESHES = ("fsdp2", "dp2_tp2")
# a PPG DiT with the codebook: the F5E model's branches at the tiny width
PPG = dict(use_ppg=True, ppg_dim=16, use_cross_mask=True, cross_mask_prob=1.0)
CB = dict(use_codebook=True, num_vars=10, groups=2, use_perplex_loss=True, perplex_loss_prob=0.25,
          perplex_loss_weight=0.1, use_align_loss=True, align_loss_weight=1.0)
NP = 20  # PPG frames
SAMPLE = {"vocab": {c: i + 1 for i, c in enumerate("abcdefghi")}, "text": "cab",
          "ref_text": "bad", "nfe": 2}
KEY = 1


def _batch(seed):
    r = np.random.default_rng(seed)
    return {"mel": r.standard_normal((B, N, ARCH["mel_dim"])).astype(np.float32),
            "mel_lens": np.asarray([32, 30, 25, 32], np.int32),
            "text_ids": r.integers(0, VOCAB, (B, NT)).astype(np.int32)}


def _draws(key) -> dict:
    """The draws of f5e_tts_tpu.models.cfm.cfm_loss for `key` over the global
    batch, in its split order (tests/test_torch_training.py)."""
    r_frac, r_span, r_time, r_noise, r_drop1, r_drop2, _ = jax.random.split(key, 7)
    lo, hi = JCFMConfig().frac_lengths_mask
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return dict(frac=t(jax.random.uniform(r_frac, (B,), minval=lo, maxval=hi)),
                span=t(jax.random.uniform(r_span, (B,))),
                x0=t(jax.random.normal(r_noise, (B, N, ARCH["mel_dim"]), jnp.float32)),
                time=t(jax.random.uniform(r_time, (B,), jnp.float32)),
                u1=t(jax.random.uniform(r_drop1)), u2=t(jax.random.uniform(r_drop2)))


def _ppg_arch(pkg_dit, pkg_ppg, pkg_cb):
    return pkg_dit(**ARCH, ppg=pkg_ppg(**PPG), codebook=pkg_cb(**CB))


def _jax_decoded(st, params):
    """JAX's 8-bit moments decoded, as two param trees (mu, nu)."""
    is_q = lambda x: isinstance(x, j8._QTensor)  # noqa: E731
    return tuple(jax.tree.map(lambda q, p, s=signed: np.asarray(
        j8._decode(q, p.shape, s) if is_q(q) else q), tree, params, is_leaf=is_q)
        for tree, signed in ((st.mu, True), (st.nu, False)))


def _jax_run(tr, batch, key, arch, bnb):
    """Two updates of a JAX Trainer: metrics, params, EMA, Adam's first
    moment of the ff1 weights (the decoded moments with `bnb`), the model
    state and, for a PPG DiT, its convs' biases after each update."""
    ts = tr.init_state(TOTAL)
    step = tr.make_step()
    sh = tr.batch_shardings()
    metrics, after = [], []
    with tr.mesh:
        for _ in range(2):
            ts, m = step(ts, {k: jax.device_put(v, sh[k]) for k, v in batch.items()},
                         jax.random.PRNGKey(key))
            metrics.append((float(m.loss), float(m.grad_norm), float(m.extra_loss)))
            after.append(jax.tree.map(np.asarray, (ts.params, ts.opt_state)))
    state = jax.tree.map(np.asarray, ts.model_state)

    def port(tree):
        tree = jax.tree.map(np.asarray, tree)
        return dit_from_jax(tree, arch, state)[0] if arch.ppg.use_ppg else dit_from_jax(tree, arch)

    ref = {"metrics": metrics, "params": port(ts.params), "ema": port(ts.ema_params),
           "state": state}
    if bnb:  # the decoded moments after the second update
        params, opt = after[-1]
        st = [s for s in opt if isinstance(s, j8.AdamW8bitState)][0]
        ref["mu2"], ref["nu2"] = (port(t) for t in _jax_decoded(st, params))
    else:
        ref["mu_ff1"] = np.asarray([x for x in jax.tree.leaves(ts.opt_state) if getattr(
            x, "shape", None) == ts.params["blocks"]["ff1"]["w"].shape][0])
    if arch.ppg.use_ppg:
        ref["biases"] = [[np.asarray(c["b"]) for c in params["ppg_embed"]["convs"]]
                         for params, _ in after]
    return ref


def _jax_steps(jobs, tmp):
    """{label: JAX reference} of jobs {label: (mesh name, arch, params_np,
    state_np, batch, bnb, key)}. The jobs over data and fsdp alone trace and
    compile in threads together; the others set the JAX package's global
    model / seq / pipe contexts, so they run one at a time after them."""
    from concurrent.futures import ThreadPoolExecutor

    inits = [(job[1], job[2], job[3]) for job in jobs.values()]

    def init_backbone(key, a, v):
        params, state = next((p, s) for arch, p, s in inits if arch is a)
        return jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)

    def run(label):
        name, arch, _, _, batch, bnb, key = jobs[label]
        model = JModelConfig(name="tiny", backbone="DiT", tokenizer="custom", tokenizer_path=None,
                             arch=arch, mel=JMelConfig(**MEL), cfm=JCFMConfig(), vocab_size=VOCAB)
        tc = JTrainConfig(**TC, save_dir=str(tmp / label), mesh=JMeshConfig(**MESHES[name]),
                          bnb_optimizer=bnb)
        tr = jtrainer.Trainer(model, tc, vocab_size=VOCAB, tokenize=lambda x: x)
        if tr.mesh.shape.get("seq", 1) > 1:
            jset_sp(tr.mesh, min_seq=8)  # the ring at N = 32, as the port's
        try:
            return _jax_run(tr, batch, key, arch, bnb)
        finally:
            jset_tp(None)
            jset_sp(None)
            jset_pp(None)

    batch_only = [k for k, job in jobs.items() if set(MESHES[job[0]]) <= {"data", "fsdp"}]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer.fbb, "init_backbone", init_backbone)
        with ThreadPoolExecutor(len(batch_only)) as pool:
            refs = dict(zip(batch_only, pool.map(run, batch_only)))
        refs.update({k: run(k) for k in jobs if k not in refs})
    return refs


def _ppg_key() -> int:
    """The first key whose two micro-steps keep both the text and the PPG
    (the align loss and the cross mask act only then; cfm.py: drop_flags)."""
    arch_t = _ppg_arch(DiTConfig, PPGConfig, CodebookConfig)
    for key in range(1, 200):
        ok = True
        for i in range(2):
            d = _draws(jax.random.fold_in(jax.random.PRNGKey(key), i))
            flags = tcfm.drop_flags(arch_t, CFMConfig(), d["u1"], d["u2"])
            ok &= not bool(flags[1]) and not bool(flags[2])
        if ok:
            return key
    raise AssertionError("no key keeps both conditions twice")


def _ppg_inputs(root):
    """The PPG DiT's reference params and BatchNorm state (a pretrained
    reference-layout file for the port, whose loader starts the update
    counts at 0), its batch with a PPG, and the JAX steps' draws, the
    codebook branch's among them."""
    arch_j = _ppg_arch(JDiTConfig, JPPGConfig, JCodebookConfig)
    arch_t = _ppg_arch(DiTConfig, PPGConfig, CodebookConfig)
    params_np, _ = _random_dit(arch_j, 5)
    rng = np.random.default_rng(6)
    state_np = {"ppg_bn": [{"mean": (0.1 * rng.standard_normal(16)).astype(np.float32),
                            "var": (1 + 0.2 * rng.random(16)).astype(np.float32),
                            "count": np.asarray(0, np.int32)} for _ in range(3)]}
    params_t, state_t = dit_from_jax(params_np, arch_j, state_np)
    sd = dit_to_reference_state_dict(params_t, arch_t, state=state_t)
    pretrained = str(root / "pretrained_ppg.pt")
    torch.save({"ema_model_state_dict": {f"ema_model.{k}": v for k, v in sd.items()}}, pretrained)
    batch = _batch(2)
    batch.update(text_lens=np.asarray([6, 4, 5, 3], np.int32),
                 ppg=rng.standard_normal((B, NP, 16)).astype(np.float32),
                 ppg_lens=np.asarray([20, 15, 18, 12], np.int32))
    key = _ppg_key()
    draws = []
    for i in range(2):
        k = jax.random.fold_in(jax.random.PRNGKey(key), i)
        draws.append({**_draws(k), **_dit_draws(jax.random.split(k, 7)[6], arch_j, B, N)._asdict()})
    return ({"arch": arch_t, "pretrained": pretrained, "batch": batch, "draws": draws},
            (params_np, state_np, batch, arch_j, key))


def _ref_mel():
    return np.random.default_rng(9).standard_normal((12, ARCH["mel_dim"])).astype(np.float32)


def _port_trainer(save_dir):
    model = ModelConfig(name="tiny", backbone="DiT", arch=DiTConfig(**ARCH), mel=MelConfig(**MEL),
                        cfm=CFMConfig())
    return Trainer(model, TrainConfig(**TC, save_dir=save_dir), vocab_size=VOCAB, tokenize=None,
                   device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_train")
    params_np, state_np = _random_dit(JDiTConfig(**ARCH), 3)
    params_t = dit_from_jax(params_np, JDiTConfig(**ARCH))
    sd = dit_to_reference_state_dict(params_t, DiTConfig(**ARCH))
    pretrained = str(root / "pretrained.pt")
    torch.save({"ema_model_state_dict": {f"ema_model.{k}": v for k, v in sd.items()}}, pretrained)
    batch = _batch(0)
    key = jax.random.PRNGKey(KEY)
    draws = [_draws(jax.random.fold_in(key, i)) for i in range(3)]  # micro 0, 1; the eval's
    loader = [_batch(1000 + i) for i in range(8)]
    data_dir = str(root / "data")
    _make_dataset_dir(data_dir)
    cli_yaml = _write_yaml(root / "cli.yaml", str(root / "cli_run"), **{
        "mesh:\n  data: 1": "mesh:\n  data: 2\n  fsdp: 2"})
    ppg_inp, ppg_ref = _ppg_inputs(root)
    torch.save({"train": {"arch": ARCH, "mel": MEL, "tc": TC, "vocab": VOCAB, "total": TOTAL,
                          "pretrained": pretrained, "batch": batch, "draws": draws[:2],
                          "eval_draws": draws[2], "meshes": MESHES, "loader": loader},
                "ppg": ppg_inp,
                "cli": {"yaml": cli_yaml, "data_dir": data_dir},
                "sample": {**SAMPLE, "ref_mel": _ref_mel()}},
               root / "inputs.pt")
    procs = launch("train", WORLD, str(root))
    # while the ranks run: the JAX Trainer under each mesh, with the 8-bit
    # AdamW, and the PPG DiT
    arch = JDiTConfig(**ARCH)
    jobs = {name: (name, arch, params_np, state_np, batch, False, KEY)
            for name in sorted(set(JAX_MESH.values()))}
    jobs.update({f"bnb_{name}": (name, arch, params_np, state_np, batch, True, KEY)
                 for name in BNB_MESHES})
    p_params, p_state, p_batch, p_arch, p_key = ppg_ref
    jobs["ppg_fsdp2"] = ("fsdp2", p_arch, p_params, p_state, p_batch, False, p_key)
    refs = _jax_steps(jobs, root / "jax")
    return refs, collect(procs, str(root), timeout=600), root, batch, draws[2], params_t


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items() for p, t in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: t for i, v in enumerate(tree) for p, t in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _tree_close(got, want, atol):
    g, w = _paths(got), _paths(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(np.asarray(g[k].detach()), np.asarray(w[k]), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(MESHES))
def test_trainer_step_under_mesh_matches_jax(world, name):
    refs, outs, *_ = world
    ref = refs[JAX_MESH[name]]
    for rank in range(WORLD):
        got = outs[rank][f"train_{name}"]
        for (loss, norm, skipped), (jl, jn, _) in zip(got["metrics"], ref["metrics"]):
            assert skipped == 0
            np.testing.assert_allclose(loss, jl, rtol=1e-5)
            np.testing.assert_allclose(norm, jn, rtol=1e-5)
    got = outs[0][f"train_{name}"]
    _tree_close(got["params"], ref["params"], 2e-6)
    _tree_close(got["ema"], ref["ema"], 2e-6)
    # Adam's first moment of block 0's ff1 weight, gathered from the shards
    at = [id(x) for x in tstep.tree_leaves(got["params"])].index(
        id(got["params"]["blocks"][0]["ff1"]["w"]))
    np.testing.assert_allclose(np.asarray(got["mu"][at]), ref["mu_ff1"][0], rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_shards_and_single_device_checkpoint(world, name):
    _, outs, root, batch, eval_draws, params_t = world
    local = outs[0][f"train_{name}"]["local"]
    dim, inner = ARCH["dim"], ARCH["heads"] * ARCH["dim_head"]
    want = {"fsdp2": (dim // 2, inner), "dp2_tp2": (dim, inner // 2)}.get(name, (dim, inner))
    assert local["q_shape"] == local["mu_shape"] == local["ema_shape"] == want
    assert local["blocks"] == (ARCH["depth"] // 2 if name == "dp2_pp2" else ARCH["depth"])
    assert outs[0][f"train_{name}"]["transport"] == "gloo"
    # the warm-up of 1 update scales to data x fsdp updates
    replicas = 4 if name in ("dp4", "fsdp2") else 2
    np.testing.assert_allclose(outs[0][f"train_{name}"]["schedule1"],
                               1e-8 + (1e-3 - 1e-8) / replicas, rtol=1e-6)
    # rank 0's model_last in the single-device layout, into the single-process Trainer
    tr = _port_trainer(str(root / "ckpts" / name))
    ts = tr.load_checkpoint(tr.init_state(TOTAL))
    assert ts.update == 2
    _tree_close(ts.params, outs[0][f"train_{name}"]["params"], 0.0)
    with torch.no_grad():
        loss = loss_with_device_mel(ts.params, tr.arch, tr.cfm, tr.model_cfg.mel,
                                    tr.device_batch(batch), draws=tcfm.LossDraws(**eval_draws),
                                    compute_dtype=torch.float32).loss
    with torch.no_grad():
        start = loss_with_device_mel(params_t, tr.arch, tr.cfm, tr.model_cfg.mel,
                                     tr.device_batch(batch),
                                     draws=tcfm.LossDraws(**eval_draws),
                                     compute_dtype=torch.float32).loss
    np.testing.assert_allclose(float(loss), outs[0][f"train_{name}"]["eval_loss"], rtol=1e-6)
    assert float(loss) != float(start)


def test_8bit_adamw_under_a_mesh(world):
    """Under data 2 x pipe 2 the 8-bit moments go through model_last and back
    bit for bit (the fsdp and model meshes: the tests below)."""
    _, outs, *_ = world
    for out in outs:
        assert out["bnb"]["roundtrip"] and np.isfinite(out["bnb"]["loss"])


def _code_steps(entries, layout):
    """Per parameter: each element's code step, its block's scale (0 for fp32 moments)."""
    ones = [{"codes": torch.ones_like(e["codes"]), "scale": e["scale"]} if isinstance(e, dict)
            else [torch.zeros_like(x) for x in e] for e in entries]
    return decoded(layout, ones, True)


def _moment_diffs(got, want, params, nu):
    """|got - want| per parameter in leaf order: the port's moments (a list
    in the leaf order of `params`) against a param-shaped tree of JAX's;
    the second moments in the sqrt domain they are coded in."""
    f = (lambda x: np.sqrt(np.asarray(x))) if nu else np.asarray
    mine = _paths(pmesh._unflatten(params, got))
    theirs = _paths(want)
    assert mine.keys() == theirs.keys()
    return [np.abs(f(mine[k]) - f(theirs[k])) for k in _paths(params)]


@pytest.mark.parametrize("name", BNB_MESHES)
def test_8bit_adamw_under_fsdp_and_model_matches_jax(world, name):
    """Loss and gradient norm to rtol 1e-5; the decoded moments (m, and v as
    the sqrt(v) it codes), the params and the EMA to 2e-6, but for the few
    elements (at most 1e-3 of them) that the two sides' gradients, which
    differ by rounding (1e-5 relative, as the norms show), move by more:
    - a value on a code's rounding boundary can go to the neighbouring code:
      in the moments such an element is held to two code steps, and its
      next step moves by a code's share;
    - the 8-bit AdamW steps from its first update (the schedule at count 1,
      where fp32 AdamW reads count 0, 1e-8), and an element whose gradient
      sits at the noise floor steps by g / (|g| + eps), a ratio of noises.
    Those params are held to one step at the peak learning rate."""
    refs, outs, *_ = world
    ref = refs[f"bnb_{name}"]
    for rank in range(WORLD):
        got = outs[rank][f"bnb_{name}"]
        for (loss, norm, skipped), (jl, jn, _) in zip(got["metrics"], ref["metrics"]):
            assert skipped == 0
            np.testing.assert_allclose(loss, jl, rtol=1e-5)
            np.testing.assert_allclose(norm, jn, rtol=1e-5)
    got = outs[0][f"bnb_{name}"]
    layout = t8.MomentLayout(got["params"])
    for which in ("mu", "nu"):
        diffs = _moment_diffs(got[which], ref[f"{which}2"], got["params"], which == "nu")
        steps = [np.asarray(s) for s in _code_steps(got[f"{which}_q"], layout)]
        assert sum(int((d > 2e-6).sum()) for d in diffs) <= 1e-3 * sum(d.size for d in diffs)
        for d, s in zip(diffs, steps):
            assert (d[d > 2e-6] <= 2 * s[d > 2e-6] + 2e-6).all()
    for tree, want in ((got["params"], ref["params"]), (got["ema"], ref["ema"])):
        mine, theirs = _paths(tree), _paths(want)
        diffs = {k: np.abs(np.asarray(mine[k]) - np.asarray(theirs[k])) for k in theirs}
        assert sum(int((d > 2e-6).sum()) for d in diffs.values()) <= 1e-3 * sum(
            d.size for d in diffs.values())
        assert max(float(d.max()) for d in diffs.values()) <= TC["learning_rate"]
    # a quantized leaf is split over the mesh: its int8 codes came back from the ranks
    assert any(isinstance(e, dict) for e in got["mu_q"])


def test_8bit_model_last_under_fsdp_resumes_in_one_process(world, tmp_path):
    _, outs, root, batch, eval_draws, _ = world
    got = outs[0]["bnb_fsdp2"]
    model = ModelConfig(name="tiny", backbone="DiT", arch=DiTConfig(**ARCH), mel=MelConfig(**MEL),
                        cfm=CFMConfig())
    # the warm-up the mesh's 4 replicas scaled (1 update x 4), on one device
    tc = {**TC, "num_warmup_updates": 4}
    tr = Trainer(model, TrainConfig(**tc, save_dir=str(root / "ckpts" / "bnb_fsdp2"),
                                    bnb_optimizer=True), vocab_size=VOCAB, tokenize=None,
                 device="cpu")
    ts = tr.load_checkpoint(tr.init_state(TOTAL))
    assert ts.update == 2
    for which in ("mu", "nu"):
        want = tstep.tree_leaves(got[f"{which}_q"])
        have = tstep.tree_leaves(getattr(ts.opt_state, which))
        assert len(have) == len(want) and all(torch.equal(a, b) for a, b in zip(have, want))
    ts, m = tr.make_step()(ts, tr.device_batch(batch), tr.step_key(ts),
                           draws=tcfm.LossDraws(**eval_draws))
    np.testing.assert_allclose(m.loss, got["next"]["loss"], rtol=1e-6)
    _tree_close(ts.params, got["next"]["params"], 2e-6)


def test_ppg_codebook_dit_under_fsdp_matches_jax(world):
    """As tests/test_torch_ppg.py's step test: each PPG conv feeds a
    training-mode BatchNorm, so its bias's gradient is zero analytically and
    rounding noise on each side, which Adam turns into steps of up to the
    learning rate. Those biases are held to 2 x lr, and each running mean,
    which adds 0.1 x the bias of the second step's forward, to 2e-6 after
    the two sides' bias difference is taken out; every other leaf to 2e-6."""
    refs, outs, *_ = world
    ref = refs["ppg_fsdp2"]
    for rank in range(WORLD):
        got = outs[rank]["ppg_fsdp2"]
        for (loss, norm, skipped, align, perplex), (jl, jn, je) in zip(got["metrics"],
                                                                         ref["metrics"]):
            assert skipped == 0 and align > 0 and perplex > 0
            np.testing.assert_allclose(loss, jl, rtol=1e-5)
            np.testing.assert_allclose(norm, jn, rtol=1e-5)
            np.testing.assert_allclose(align + perplex, je, rtol=1e-5)
    got = outs[0]["ppg_fsdp2"]
    lr = TC["learning_rate"]
    for after_t, after_j in zip(got["biases"], ref["biases"]):
        for b_t, b_j in zip(after_t, after_j):
            np.testing.assert_allclose(b_t.numpy(), b_j, rtol=0, atol=2 * lr)

    def without_conv_biases(tree):
        return {**tree, "ppg_embed": {**tree["ppg_embed"], "convs": [
            {"w": c["w"]} for c in tree["ppg_embed"]["convs"]]}}

    _tree_close(without_conv_biases(got["params"]), without_conv_biases(ref["params"]), 2e-6)
    gap = [0.1 * (b_t.numpy() - b_j) for b_t, b_j in zip(got["biases"][0], ref["biases"][0])]
    for layer, (got_l, want_l) in enumerate(zip(got["state"]["ppg_bn"], ref["state"]["ppg_bn"])):
        np.testing.assert_allclose(got_l["var"].numpy(), want_l["var"], rtol=0, atol=2e-6)
        np.testing.assert_allclose(got_l["mean"].numpy() - gap[layer], want_l["mean"], rtol=0,
                                   atol=2e-6)
        assert int(got_l["count"]) == int(want_l["count"]) == 2
    # the running statistics are the global batch's: the same on every rank
    for out in outs[1:]:
        _tree_close(out["ppg_fsdp2"]["state"], got["state"], 0.0)


def test_codebook_batch_draws_are_the_same_on_every_rank(world):
    """With no injected draws, the permutations and the cross mask's coin come
    from the key every rank shares (models/dit.py: _codebook_branch)."""
    _, outs, *_ = world
    seen = [out["ppg_fsdp2"]["batch_draws"] for out in outs]
    assert all(len(s) == 1 for s in seen)
    first = seen[0][0]
    assert first["perm_text"].shape == (N,) and first["cross_apply"].shape == ()
    for s in seen[1:]:
        for k, v in first.items():
            assert torch.equal(s[0][k], v), k


def test_dropout_under_data_and_model_matches_one_process(world, tmp_path):
    """Dropout 0.1 under data 2 x model 2, every draw from the step's key:
    each rank's rows of the loss's draws and of the attention output's
    masks, and its columns of the FF hidden's, make the update of the
    unsharded run in one process (the losses 1e-5 relative, the params 2e-6,
    as the mesh steps above). The mesh's warmup is scaled by its data x
    fsdp replicas (2), as JAX's, so the one-process run's is set to 2."""
    _, outs, root, batch, *_ = world
    model = ModelConfig(name="tiny", backbone="DiT", arch=DiTConfig(**{**ARCH, "dropout": 0.1}),
                        mel=MelConfig(**MEL), cfm=CFMConfig())
    tc = TrainConfig(**{**TC, "num_warmup_updates": 2 * TC["num_warmup_updates"]},
                     save_dir=str(tmp_path))
    tr = Trainer(model, tc, vocab_size=VOCAB, tokenize=None, device="cpu")
    ts = tr.init_state(TOTAL, pretrained_path=str(root / "pretrained.pt"))
    step = tr.make_step()
    want = []
    for _ in range(2):
        ts, m = step(ts, tr.device_batch(batch), tr.step_key(ts))
        want.append((m.loss, m.grad_norm))
    for rank in range(WORLD):
        got = outs[rank]["dropout_dp2_tp2"]
        np.testing.assert_allclose(np.asarray(got["metrics"]), np.asarray(want), rtol=1e-5)
    _tree_close(outs[0]["dropout_dp2_tp2"]["params"], tstep.tree_map(
        lambda x: x.detach(), ts.params), 2e-6)
    # dropout acted: the run at dropout 0 from the same key differs
    plain = _port_trainer(str(tmp_path / "plain"))
    ts0 = plain.init_state(TOTAL, pretrained_path=str(root / "pretrained.pt"))
    _, m0 = plain.make_step()(ts0, plain.device_batch(batch), plain.step_key(ts0))
    assert abs(m0.loss - want[0][0]) > 1e-4


def test_preemption_and_resume_across_ranks(world):
    _, outs, *_ = world
    for out in outs:
        p = out["preempt"]
        assert sorted(p["a"]) == [1, 2, 3, 4, 5, 6]
        assert p["b_preempted"] and p["b_update"] == 3 and p["b_last"]
        assert p["c_update"] == 6 and sorted(p["c"]) == [4, 5, 6]
        for u in (4, 5, 6):
            assert p["c"][u] == p["a"][u], (u, p["c"][u], p["a"][u])
    # every rank logged the same (global) losses
    assert all(out["preempt"]["a"] == outs[0]["preempt"]["a"] for out in outs)


def test_the_yaml_cli_trains_under_its_mesh_section(world):
    """train/train.py's main in every rank of the world, its YAML's `mesh:`
    data 2 x fsdp 2 (each rank its rows of every packed batch, zero-length
    rows padding a batch of one): two updates on every rank, block matrices
    split over fsdp, and rank 0's model_last at update 2."""
    _, outs, root, *_ = world
    for out in outs:
        assert out["cli"]["update"] == 2
        assert out["cli"]["local_q"] == (16, 32)  # (dim / fsdp, heads x dim_head)
    ckpt = torch.load(root / "cli_run" / "model_last.pt", map_location="cpu", weights_only=True)
    assert ckpt["update"] == 2
    assert ckpt["train_state"]["params"]["blocks"][0]["attn"]["to_q"]["w"].shape == (32, 32)


@pytest.mark.parametrize("name", ["dp2_tp2", "fsdp2", "dp2_pp2"])
def test_sample_hook_under_mesh_matches_the_single_process_hook(world, name, tmp_path):
    """The hook runs on rank 0 with the gathered EMA outside the step's mesh
    context: full heads, no collective, the single-process sample."""
    _, outs, *_ = world
    got = outs[0][f"sample_{name}"]
    assert all(out[f"sample_{name}"]["update"] == 2 for out in outs)
    mel = np.load(os.path.join(got["dir"], "update_2_gen_mel.npy"))
    model = ModelConfig(name="tiny", backbone="DiT", arch=DiTConfig(**ARCH), mel=MelConfig(**MEL),
                        cfm=CFMConfig())
    ema = dit_from_reference_state_dict(
        load_state_dict(os.path.join(got["dir"], "model_last.pt"), use_ema=True), model.arch)
    hook = make_sample_logger(model, SAMPLE["vocab"], "char", str(tmp_path), SAMPLE["text"],
                              _ref_mel(), SAMPLE["ref_text"], nfe=SAMPLE["nfe"], device="cpu")
    hook(ema, 2, {})
    want = np.load(tmp_path / "update_2_gen_mel.npy")
    assert mel.shape == want.shape == _ref_mel().shape and np.isfinite(mel).all()
    np.testing.assert_allclose(mel, want, rtol=0, atol=1e-5)
