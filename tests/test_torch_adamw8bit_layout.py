"""The port's 8-bit AdamW on the JAX package's leaves, against
`f5e_tts_tpu.train.adamw8bit.adamw8bit` on the depth-stacked JAX tree.

The JAX package stacks a backbone's layers over depth into one leaf
(models/dit.py:101, models/unett.py:68-69, models/mmdit.py:56) and
quantizes per leaf; the port keeps a list of per-layer dicts, and its
`AdamW8bit` groups the tensors at one path of every layer into that leaf.
Three updates from seeded numpy gradients, no model forward:

- a DiT tree wide and deep enough that a stacked bias reaches the 4096
  elements of `min_quantize_size` (dim 512 x depth 8: the biases are int8
  in JAX, where one layer's 512 would keep fp32);
- a small UNetT tree and a small MMDiT tree at width 72, whose layers'
  matrices (72 x 72 = 5184 elements) are no multiple of the 256-element
  block, so blocks straddle two layers;
- the DiT at width 384 split by `dit_param_spec` over model 2 (two ranks as
  threads, the absmax all-reduced between them): a column-parallel row's
  192 local elements and a row-parallel shard's edge straddle blocks and
  ranks.

Each port update starts from the JAX optimizer's state before it, put
into the port's groups through `MomentLayout.from_items` (the path a
checkpoint takes), and is held to the flat-tree test's tolerances
(tests/test_torch_train_cli.py): params 1e-6 absolute, codes within 1,
scales rtol 1e-5; `state_bytes` equals JAX's on one device. The JAX
update is jitted, and XLA fuses `b1 * m + (1 - b1) * g` where torch rounds
each product: the fp32 moments are held to 1e-6 of their leaf's largest
(a moment that cancels can differ by 2e-6 of itself), and a code on a
rounding boundary may go to its neighbour. Starting each update from
JAX's state keeps such a code from moving the next update's step.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.config import MMDiTConfig as JMMDiTConfig
from f5e_tts_tpu.config import UNetTConfig as JUNetTConfig
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.models import mmdit as jmmdit
from f5e_tts_tpu.models import unett as junett
from f5e_tts_tpu.train import adamw8bit as j8
from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.parallel import mesh as pmesh
from f5e_tts_tpu_torch.train import adamw8bit as t8
from f5e_tts_tpu_torch.train.step import tree_leaves
from f5e_tts_tpu_torch.utils.convert import dit_from_jax, mmdit_from_jax, unett_from_jax

SMALL = dict(mel_dim=8, text_num_embeds=16, text_dim=16)
CASES = {
    "dit_512x8": (lambda: JDiTConfig(dim=512, depth=8, heads=8, dim_head=64, ff_mult=1,
                                     conv_layers=1, qk_norm="rms_norm", **SMALL),
                  jdit.init_dit, dit_from_jax, None),
    "unett_72x4": (lambda: JUNetTConfig(dim=72, depth=4, heads=2, dim_head=36, ff_mult=2,
                                        mel_dim=8, text_num_embeds=16),
                   junett.init_unett, unett_from_jax, None),
    "mmdit_72x3": (lambda: JMMDiTConfig(dim=72, depth=3, heads=2, dim_head=36, ff_mult=2,
                                        mel_dim=8, text_num_embeds=16),
                   jmmdit.init_mmdit, mmdit_from_jax, None),
    "dit_384x2_model2": (lambda: JDiTConfig(dim=384, depth=2, heads=6, dim_head=64, ff_mult=2,
                                            conv_layers=1, **SMALL),
                         jdit.init_dit, dit_from_jax, 2),
}


def _sched_j(count):
    return 1e-3 + 9e-3 * jnp.minimum(count, 10) / 10


def _sched_t(count):
    return 1e-3 + 9e-3 * min(count, 10) / 10


class _ThreadMesh:
    """A mesh of `model` ranks that are threads of this process: the
    geometry of parallel/mesh.py's Mesh and an all-reduce through shared
    slots (what the optimizer and the sharding rules call)."""

    def __init__(self, model: int, rank: int, hub: dict):
        self.shape = {a: 1 for a in pmesh.AXES}
        self.shape["model"] = model
        self.rank, self.hub = rank, hub

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.rank if "model" in axes else 0

    def all_reduce(self, t, axes, op=torch.distributed.ReduceOp.SUM):
        assert tuple(axes) == ("model",)
        slots, barrier = self.hub["slots"], self.hub["barrier"]
        slots[self.rank] = t.clone()
        barrier.wait()
        stacked = torch.stack(slots)
        out = stacked.amax(0) if op == torch.distributed.ReduceOp.MAX else stacked.sum(0)
        barrier.wait()
        return out


def _jax_run(params_np, grads):
    """JAX's params and optimizer state before and after each update."""
    opt = j8.adamw8bit(_sched_j, weight_decay=0.01)
    pj = jax.tree.map(jnp.asarray, params_np)
    # the initial state is all zeros (codes and scales too): made from its shapes
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(opt.init, pj))
    states, params = [zeros], [pj]
    update, apply = jax.jit(opt.update), jax.jit(optax.apply_updates)
    for g in grads:
        up, st = update(g, states[-1], params[-1])
        states.append(st)
        params.append(apply(params[-1], up))
    return params, states


def _jax_views(st_tree, params_np):
    """Two param-shaped numpy trees: per JAX leaf, its codes in the leaf's
    shape (int8) or its fp32 moment; and its scale, repeated over depth for
    a stacked leaf so that the port's converters unstack it (zeros when fp32)."""
    is_q = lambda x: isinstance(x, j8._QTensor)  # noqa: E731

    def codes(q, p):
        if not is_q(q):
            return np.asarray(q)
        return np.asarray(q.codes).reshape(-1)[:p.size].reshape(p.shape)

    def scale(path, q, p):
        if not is_q(q):
            return np.zeros(p.shape, np.float32)
        sc = np.asarray(q.scale)
        stacked = getattr(path[0], "key", None) in t8.STACKED
        return np.broadcast_to(sc, (p.shape[0],) + sc.shape).copy() if stacked else sc

    views = jax.tree.map(codes, st_tree, params_np, is_leaf=is_q)
    scales = jax.tree_util.tree_map_with_path(scale, st_tree, params_np, is_leaf=is_q)
    return views, scales


def _entries(layout, views, scales):
    """The layout's moment entries holding a JAX state's (views, scales)
    trees in the port's layout (this rank's slices under a mesh)."""
    items = tree_leaves(views)
    return layout.from_items(items, [tree_leaves(scales)[g.members[0]] if g.quantized else None
                                     for g in layout.groups])


def _check(layout, state, params, want_params, views, scales):
    for got, want in zip(tree_leaves(params), tree_leaves(want_params)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    n_quantized = 0
    for which in ("mu", "nu"):
        items, got_scales = layout.items(getattr(state, which))
        for got, want in zip(items, tree_leaves(views[which])):
            assert got.shape == want.shape and got.dtype == want.dtype
            if got.dtype == torch.int8:
                diff = got.numpy().astype(np.int32) - want.numpy().astype(np.int32)
                assert np.abs(diff).max() <= 1
            else:  # a sum with cancellation: 1e-6 of the leaf's largest moment
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                           atol=1e-6 * float(want.abs().max()))
        for g, scale in zip(layout.groups, got_scales):
            if g.quantized:
                n_quantized += 1
                want = tree_leaves(scales[which])[g.members[0]]
                np.testing.assert_allclose(scale.numpy(), want.numpy(), rtol=1e-5)
    return n_quantized


def _port_updates(params_t, grads_t, jax_side, mesh=None, specs=None):
    """Three port updates, each from the JAX state before it; each checked
    against JAX's after it. `jax_side(k)`: (params, views, scales) of JAX's
    k-th state in this rank's layout. Returns the optimizer and its state."""
    optimizer = t8.AdamW8bit(_sched_t, max_grad_norm=float("inf"), weight_decay=0.01,
                             mesh=mesh, specs=specs)
    state = optimizer.init(params_t)
    leaves = tree_leaves(params_t)
    for k, g in enumerate(grads_t):
        _, views, scales = jax_side(k)
        state.mu, state.nu = (_entries(optimizer.layout, views[w], scales[w]) for w in ("mu", "nu"))
        state.count = k
        assert optimizer.update_(state, leaves, tree_leaves(g))
        want_params, views, scales = jax_side(k + 1)
        assert _check(optimizer.layout, state, params_t, want_params, views, scales) > 0
    return optimizer, state


@pytest.mark.parametrize("case", list(CASES))
def test_8bit_moments_on_the_jax_leaves(case):
    make_cfg, init, from_jax, model = CASES[case]
    cfg = make_cfg()
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg, 16)[0])
    params_np = jax.tree.map(lambda s: 0.05 * rng.standard_normal(s.shape, np.float32), shapes)
    grads = [jax.tree.map(lambda p, i=i: rng.standard_normal(p.shape, np.float32) * (1 + i),
                          params_np) for i in range(3)]
    pj, states = _jax_run(params_np, grads)
    port = lambda tree: from_jax(jax.tree.map(np.asarray, tree), cfg)  # noqa: E731

    @functools.lru_cache(maxsize=None)
    def full_side(k):
        views = {w: _jax_views(getattr(states[k], w), params_np) for w in ("mu", "nu")}
        return (port(pj[k]), {w: port(v[0]) for w, v in views.items()},
                {w: port(v[1]) for w, v in views.items()})

    def jax_side(k, shard=lambda t: t):
        params, views, scales = full_side(k)
        return shard(params), {w: shard(v) for w, v in views.items()}, scales

    if model is None:
        params_t = port(params_np)
        optimizer, state = _port_updates(params_t, [port(g) for g in grads], jax_side)
        assert t8.state_bytes(state) == j8.state_bytes(states[-1])
        if case == "dit_512x8":  # a leaf's stacked size decides: the biases (8 x 512) are int8
            biases = [g for g in optimizer.layout.groups
                      if len(g.members) == 8 and g.parts[0].shape == (512,)]
            assert biases and all(g.quantized for g in biases)
        return

    # model 2: each thread a rank holding its dit_param_spec slices
    tcfg = DiTConfig(**{k: getattr(cfg, k) for k in ("dim", "depth", "heads", "dim_head",
                                                     "ff_mult", "conv_layers", "mel_dim",
                                                     "text_num_embeds", "text_dim")})
    hub = {"slots": [None] * model, "barrier": threading.Barrier(model)}
    layouts, errors = [None] * model, []

    def rank(r):
        try:
            mesh = _ThreadMesh(model, r, hub)
            shard = lambda tree: pmesh.shard_dit_params(tree, mesh, tcfg)  # noqa: E731
            params_t = shard(port(params_np))
            specs = pmesh.leaf_specs(params_t, tcfg, mesh)
            optimizer, _ = _port_updates(params_t, [shard(port(g)) for g in grads],
                                         lambda k: jax_side(k, shard), mesh, specs)
            layouts[r] = optimizer.layout
        except Exception as e:  # noqa: BLE001
            errors.append(e)
            hub["barrier"].abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(model)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for layout in layouts:
        split = [g for g in layout.groups if g.quantized and g.axes == ("model",)]
        assert split
        # a local row of a column-parallel leaf covers part of a block
        assert any(g.parts[0].shape[-1] % 256 for g in split)
