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
- The 8-bit AdamW: refused under fsdp > 1; under data 2 x pipe 2 its moments
  go through a checkpoint and back bit for bit.
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
from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import MelConfig as JMelConfig
from f5e_tts_tpu.config import MeshConfig as JMeshConfig
from f5e_tts_tpu.config import ModelConfig as JModelConfig
from f5e_tts_tpu.config import TrainConfig as JTrainConfig
from f5e_tts_tpu.ops.attention import set_sp_context as jset_sp
from f5e_tts_tpu.ops.attention import set_tp_context as jset_tp
from f5e_tts_tpu.parallel.pipeline import set_pp_context as jset_pp
from f5e_tts_tpu.train import trainer as jtrainer
from f5e_tts_tpu_torch.config import (CFMConfig, DiTConfig, MelConfig, ModelConfig,
                                      TrainConfig)
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.train import step as tstep
from f5e_tts_tpu_torch.train.trainer import Trainer, loss_with_device_mel, make_sample_logger
from f5e_tts_tpu_torch.utils.convert import (dit_from_jax, dit_from_reference_state_dict,
                                             dit_to_reference_state_dict, load_state_dict)
from tests._torch_parallel_worker import collect, launch
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


def _jax_steps(params_np, state_np, batch, tmp):
    """Two JAX Trainer updates under each mesh: metrics, params, EMA, mu."""
    arch = JDiTConfig(**ARCH)
    model = JModelConfig(name="tiny", backbone="DiT", tokenizer="custom", tokenizer_path=None,
                         arch=arch, mel=JMelConfig(**MEL), cfm=JCFMConfig(), vocab_size=VOCAB)
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer.fbb, "init_backbone", lambda key, a, v: (
            jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, state_np)))
        for name in sorted(set(JAX_MESH.values())):
            tc = JTrainConfig(**TC, save_dir=str(tmp / name), mesh=JMeshConfig(**MESHES[name]))
            tr = jtrainer.Trainer(model, tc, vocab_size=VOCAB, tokenize=lambda x: x)
            if tr.mesh.shape.get("seq", 1) > 1:
                jset_sp(tr.mesh, min_seq=8)  # the ring at N = 32, as the port's
            try:
                ts = tr.init_state(TOTAL)
                step = tr.make_step()
                sh = tr.batch_shardings()
                metrics = []
                with tr.mesh:
                    for _ in range(2):
                        ts, m = step(ts, {k: jax.device_put(v, sh[k]) for k, v in batch.items()},
                                     jax.random.PRNGKey(KEY))
                        metrics.append((float(m.loss), float(m.grad_norm)))
                mu = [x for x in jax.tree.leaves(ts.opt_state)
                      if getattr(x, "shape", None) == ts.params["blocks"]["ff1"]["w"].shape][0]
                refs[name] = {"metrics": metrics,
                              "params": dit_from_jax(jax.tree.map(np.asarray, ts.params), arch),
                              "ema": dit_from_jax(jax.tree.map(np.asarray, ts.ema_params), arch),
                              "mu_ff1": np.asarray(mu)}
            finally:
                jset_tp(None)
                jset_sp(None)
                jset_pp(None)
    return refs


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
    torch.save({"train": {"arch": ARCH, "mel": MEL, "tc": TC, "vocab": VOCAB, "total": TOTAL,
                          "pretrained": pretrained, "batch": batch, "draws": draws[:2],
                          "eval_draws": draws[2], "meshes": MESHES, "loader": loader},
                "cli": {"yaml": cli_yaml, "data_dir": data_dir},
                "sample": {**SAMPLE, "ref_mel": _ref_mel()}},
               root / "inputs.pt")
    procs = launch("train", WORLD, str(root))
    refs = _jax_steps(params_np, state_np, batch, root / "jax")  # while the ranks run
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
        for (loss, norm, skipped), (jl, jn) in zip(got["metrics"], ref["metrics"]):
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
    _, outs, *_ = world
    for out in outs:
        assert "fsdp or model > 1" in out["bnb"]["refused"]
        assert out["bnb"]["roundtrip"] and np.isfinite(out["bnb"]["loss"])


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
