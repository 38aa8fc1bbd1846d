"""The port's parallel building blocks on four gloo ranks of the CPU, held
against the JAX package on its virtual CPU devices.

One world of four processes (tests/_torch_parallel_worker.py, job "ops")
runs every check while this process computes the JAX references; each test
reads one check's result. fp32 throughout.

- Ring attention over seq = 4 (K/V moved by send/recv, never gathered),
  with and without RoPE: output and dq/dk/dv of sum(out * w) against
  f5e_tts_tpu.ops.ring_attention on a 4-device seq mesh (jax.grad through
  its ppermute ring; its RoPE path with identity tables stands for no
  RoPE). Tolerance 2e-5 absolute + relative (the online softmax's sums in
  another order).
- The DiT forward with this rank's slices of dit_param_spec under TP (model
  4), TP x DP (data 2 x model 2), SP (seq 4, ring attention: min_seq 8),
  TP x SP, a partial-RoPE preset (pe_attn_head 1) under TP, and TP in
  training with dropout 0.3 from one seed, against the port's replicated
  forward in this process: 2e-5 absolute + 1e-5 relative (the same sums
  split over ranks, at |pred| ~ 2); that forward against the replicated JAX
  dit_forward: 5e-5 + 1e-5.
- gpipe_scan over pipe 4 (M 4 and 8) and data 2 x pipe 2 against the plain
  loop in this process: output and the gradients of every block, the
  input and the per-row conditioning, 5e-5 (the same ops per microbatch,
  one thread against this process's several);
  dropout under the pipeline draws per microbatch (JAX
  tests/test_gpipe.py:254); tp > 1 and an active seq context are refused.
- The mesh's coordinates, `shard_batch`'s zero-length padding rows, the
  shard / gather round trip of a DiT tree, `split_between_processes` and
  `broadcast_from_host0` over the ranks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.ops.ring_attention import ring_attention as jring
from f5e_tts_tpu.ops.rope import rotary_cos_sin_half
from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.models import dit as tdit
from f5e_tts_tpu_torch.ops import prng as tprng
from f5e_tts_tpu_torch.utils.convert import dit_from_jax
from tests._torch_parallel_worker import collect, launch

WORLD = 4
DIT = dict(dim=64, depth=2, heads=4, dim_head=64, ff_mult=2, mel_dim=8, text_dim=16,
           conv_layers=1, dropout=0.0)
B, N, NT, VOCAB = 4, 32, 8, 10
RING = dict(b=2, n=16, h=2, dh=8)


def _random_dit(cfg: JDiTConfig, seed: int):
    """A DiT tree of JAX's structure (no eager init) with seeded values in
    every leaf, so the zero-initialised AdaLN and projections matter."""
    shapes = jax.eval_shape(lambda k: jdit.init_dit(k, cfg, VOCAB), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
                          shapes[0])
    return params, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes[1])


def _inputs(rng):
    r = RING
    q, k, v, w = (rng.standard_normal((r["b"], r["n"], r["h"], r["dh"])).astype(np.float32)
                  for _ in range(4))
    cos, sin = rotary_cos_sin_half(r["dh"], r["n"])
    ring = dict(q=q, k=k, v=v, w=w, kv_lens=np.asarray([16, 11], np.int32), cos=cos, sin=sin)
    dit_np, _ = _random_dit(JDiTConfig(**DIT), 1)
    dit = dict(x=rng.standard_normal((B, N, DIT["mel_dim"])).astype(np.float32),
               cond=rng.standard_normal((B, N, DIT["mel_dim"])).astype(np.float32),
               text=rng.integers(0, VOCAB, (B, NT)).astype(np.int32),
               time=np.linspace(0.1, 0.9, B).astype(np.float32))
    drop_cfg = {**DIT, "depth": 4, "dropout": 0.3}
    drop_np, _ = _random_dit(JDiTConfig(**drop_cfg), 2)
    row = {k: v[:1] for k, v in dit.items()}
    drop = {k: np.repeat(row[k], 8, 0) for k in ("x", "cond", "text")}
    gp = dict(w=0.3 * rng.standard_normal((8, 16, 16)).astype(np.float32),
              b=0.1 * rng.standard_normal((8, 16)).astype(np.float32),
              h0=rng.standard_normal((8, 6, 16)).astype(np.float32),
              t_emb=rng.standard_normal((8, 16)).astype(np.float32),
              mask=rng.integers(0, 2, (8, 6)).astype(bool))
    return ring, (dit_np, dit), (drop_cfg, drop_np, drop), gp


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_refs(ring, dit_np, dit):
    """The JAX ring's output and gradients, with RoPE and without (its RoPE
    path with the identity tables cos = 1, sin = 0: one compile serves
    both), and the replicated JAX dit_forward."""
    refs = {}
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("seq",))
    lens, w = jnp.asarray(ring["kv_lens"]), jnp.asarray(ring["w"])

    @jax.jit
    def ring_grads(q, k, v, cos, sin):
        def loss(q, k, v):
            o = jring(q, k, v, lens, mesh, "seq", cos, sin)
            return jnp.sum(o * w), o

        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)

    qkv = [jnp.asarray(ring[n]) for n in ("q", "k", "v")]
    cos, sin = jnp.asarray(ring["cos"]), jnp.asarray(ring["sin"])
    for rope, tables in ((0, (jnp.ones_like(cos), jnp.zeros_like(sin))), (1, (cos, sin))):
        (_, o), grads = ring_grads(*qkv, *tables)
        refs[f"ring_rope{rope}"] = dict(out=o, dq=grads[0], dk=grads[1], dv=grads[2])
    f = jnp.zeros((B,), bool)
    pred, _ = jax.jit(lambda p, x, c, t, tm: jdit.dit_forward(
        p, {}, JDiTConfig(**DIT), x=x, cond=c, text_ids=t, time=tm, drop_audio_cond=f,
        drop_text=f, drop_ppg=f, compute_dtype=jnp.float32))(
        dit_np, *(jnp.asarray(dit[n]) for n in ("x", "cond", "text", "time")))
    refs["dit_jax"] = pred
    return jax.tree.map(np.asarray, refs)


def _port_forwards(dit_t, dit):
    """The port's replicated dit_forward (one process, no mesh), with RoPE on
    every head and on the first only, and in training with dropout 0.3 from
    a seeded generator."""
    f = torch.zeros(B, dtype=torch.bool)
    out = {}
    for name, kw in (("dit_peNone", {}), ("dit_pe1", {"pe_attn_head": 1}),
                     ("dit_dropout", {"dropout": 0.3})):
        train = dict(training=True, rng=tprng.prng_key(5)) if kw.get(
            "dropout") else {}
        with torch.no_grad():
            out[name] = tdit.dit_forward(
                dit_t, DiTConfig(**{**DIT, **kw}), x=dit["x"], cond=dit["cond"],
                text_ids=dit["text"], time=dit["time"], drop_audio_cond=f, drop_text=f,
                compute_dtype=torch.float32, **train).numpy()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_ops")
    ring, (dit_np, dit), (drop_cfg, drop_np, drop), gp = _inputs(np.random.default_rng(0))
    cfg_t = {k: v for k, v in DIT.items()}
    torch.save({"ring": _t(ring),
                "dit": {"cfg": cfg_t, "params": dit_from_jax(dit_np, JDiTConfig(**DIT)),
                        **_t(dit)},
                "pp_dropout": {"cfg": drop_cfg, "params": dit_from_jax(drop_np,
                                                                       JDiTConfig(**drop_cfg)),
                               "time": torch.full((8,), 0.5), **_t(drop)},
                "gpipe": _t(gp)}, root / "inputs.pt")
    procs = launch("ops", WORLD, str(root))
    refs = _jax_refs(ring, dit_np, dit)  # while the ranks run
    refs.update(_port_forwards(dit_from_jax(dit_np, JDiTConfig(**DIT)), _t(dit)))
    return refs, gp, collect(procs, str(root))


def _close(got, want, atol, rtol=None):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=atol if rtol is None else rtol)


@pytest.mark.parametrize("rope", [0, 1])
def test_ring_attention_and_its_gradients_match_jax(world, rope):
    refs, _, outs = world
    for rank in range(WORLD):  # replicated in and out: every rank holds the whole result
        got = outs[rank][f"ring_rope{rope}"]
        for name in ("out", "dq", "dk", "dv"):
            _close(got[name], refs[f"ring_rope{rope}"][name], 2e-5)


def test_ring_attention_moves_only_kv_shards(world):
    _, _, outs = world
    shapes = outs[0]["ring_shift_shapes"]
    assert len(shapes) == 2 * (WORLD - 1)  # K and V at each of the S - 1 moves
    assert set(shapes) == {(RING["b"], RING["n"] // WORLD, RING["h"], RING["dh"])}


def test_replicated_dit_forward_matches_jax(world):
    refs, _, _ = world
    _close(refs["dit_peNone"], refs["dit_jax"], 5e-5, 1e-5)


@pytest.mark.parametrize("name", ["tp4", "dp2_tp2", "sp4", "tp2_sp2", "tp4_partial",
                                  "dp2_tp2_partial"])
def test_dit_forward_under_mesh_matches_the_replicated_forward(world, name):
    refs, _, outs = world
    want = refs["dit_pe1" if name.endswith("partial") else "dit_peNone"]
    for rank in range(WORLD):
        _close(outs[rank][f"dit_{name}"], want, 2e-5, 1e-5)


def test_tp_dropout_draws_the_unsharded_masks(world):
    """Under TP every rank of the model axis draws the attention output's
    mask and the FF hidden's, at full width, from the same generator state
    and keeps its columns: the unsharded block's masks (2e-5, as above)."""
    refs, _, outs = world
    for rank in range(WORLD):
        _close(outs[rank]["dit_tp4_dropout"], refs["dit_dropout"], 2e-5, 1e-5)
    assert np.abs(refs["dit_dropout"] - refs["dit_peNone"]).max() > 1e-3  # dropout acted


def _plain_loop(gp):
    t = {k: torch.from_numpy(v) for k, v in gp.items()}
    w, b = t["w"].clone().requires_grad_(True), t["b"].clone().requires_grad_(True)
    h0, t_emb = t["h0"].clone().requires_grad_(True), t["t_emb"].clone().requires_grad_(True)
    h = h0
    for i in range(w.shape[0]):
        y = torch.tanh(h @ w[i] + b[i] + t_emb[:, None, :])
        h = torch.where(t["mask"][:, :, None], y, h)
    h.square().sum().backward()
    return {"y": h.detach(), "dh0": h0.grad, "dt_emb": t_emb.grad, "dw": w.grad, "db": b.grad}


@pytest.mark.parametrize("name", ["pipe4_m4", "pipe4_m8", "dp2_pipe2_m2"])
def test_gpipe_scan_and_its_gradients_match_the_plain_loop(world, name):
    _, gp, outs = world
    want = _plain_loop(gp)
    for rank in range(WORLD):
        got = outs[rank][f"gpipe_{name}"]
        for key in want:
            _close(got[key], want[key], 5e-5)


def test_gpipe_dropout_draws_per_microbatch(world):
    _, _, outs = world
    for rank in range(WORLD):
        d = outs[rank]["pp_dropout"]
        assert torch.equal(d["a"], d["b"])  # deterministic given the generator's seed
        assert not torch.equal(d["a"], d["other_seed"])
        # rows 0 and 2 are the same input in microbatches 0 and 1 (M = 4, 2 rows each)
        assert (d["a"][0] - d["a"][2]).abs().max() > 1e-6
    assert all(torch.equal(outs[0]["pp_dropout"]["a"], o["pp_dropout"]["a"]) for o in outs)


def test_gpipe_refuses_tensor_and_sequence_parallel_contexts(world):
    _, _, outs = world
    refusals = outs[0]["pp_refusals"]
    assert "requires tp == 1" in refusals["tp"]
    assert "requires seq == 1" in refusals["sp"]


def test_mesh_coordinates_and_batch_shards(world):
    _, _, outs = world
    for rank, out in enumerate(outs):
        coords, batch_index, model_peer = out["coords"]
        assert coords == {"data": rank // 2, "fsdp": 0, "model": rank % 2, "seq": 0, "pipe": 0}
        assert batch_index == rank // 2 and model_peer == 2 * (rank // 2) + 1
        sb = out["shard_batch"]  # 3 rows padded to 4 with a zero-length row
        lens = [5, 6] if rank < 2 else [7, 0]
        assert sb["mel_lens"].tolist() == lens and sb["mel"].shape == (2, 4, 2)
        assert sb["mel"][1].abs().sum() == (0 if rank >= 2 else 8)


@pytest.mark.parametrize("name", ["fsdp_tp", "pipe"])
def test_shard_and_gather_round_trip(world, name):
    _, _, outs = world
    assert all(out[f"roundtrip_{name}"] for out in outs)


def test_split_and_broadcast_over_processes(world):
    _, _, outs = world
    chunks = [[0, 1], [2, 3], [4, 5], [6]]  # Accelerate's contiguous chunks of range(7)
    for rank, out in enumerate(outs):
        plain, padded = out["split"]
        assert plain == chunks[rank]
        assert padded == (chunks[rank] if rank < 3 else [6, 6])
        assert out["broadcast"] == [0.0, 0.0]
