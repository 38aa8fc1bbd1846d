"""Pipeline parallelism (GPipe) over the DiT's depth (counterpart of
`f5e_tts_tpu/parallel/pipeline.py`).

The mesh's "pipe" axis splits the depth: stage s holds the blocks
[s * depth / S, (s + 1) * depth / S) (parallel/mesh.py: stage_blocks). The
batch is split into M microbatches that move stage to stage by send/recv:
microbatch m reaches stage s once stage s - 1 has run it, so stage s works
on m while stage s - 1 works on m + 1 (JAX's skewed schedule, one rank per
stage). The last stage's output is broadcast to every stage, which all go
on with the same replicated activations. The bubble is (S - 1) / (M + S - 1)
of a step: pick M >= S.

Backward, `GPipe` runs the microbatches' gradients back through the stages
by send/recv; the gradients of the stage inputs that every stage shares
(the trunk's input on stage 0, the per-row conditioning on all) are summed
over the axis, so every stage's replicated producers see the whole
gradient, as a psum does for JAX's shard_map.

Bodies that draw batch-shaped randomness (dropout) see microbatches, so the
draws differ from the unpipelined run: `fold_scanned` hands each
microbatch its own layer seeds (without it every microbatch would reuse
them). TP inside a stage and an active sequence-parallel context are
refused, as in JAX (models/dit.py:356-374). The DiT trunk pipelines while
the active mesh (parallel/mesh.py: active) has a "pipe" axis > 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from f5e_tts_tpu_torch.parallel.mesh import Mesh, _leaves, _unflatten, current


def pp_shards() -> int:
    """The pipe axis's size under the active mesh (parallel/mesh.py: active)."""
    mesh = current().over("pipe")
    return 1 if mesh is None else mesh.size("pipe")


def pp_context():
    """(mesh, axis, n_micro) of the active mesh's pipeline."""
    ctx = current()
    return ctx.mesh, "pipe", ctx.n_micro


def _check_context() -> None:
    if current().over("model") is not None:
        raise ValueError("pipeline parallelism requires tp == 1")
    if current().over("seq") is not None:
        raise ValueError("pipeline parallelism requires seq == 1 in the active mesh")


def _micro(t, m: int, mb: int):
    return None if t is None else t[m * mb:(m + 1) * mb]


class GPipe(torch.autograd.Function):
    """The stage's schedule as one autograd node. The forward builds each
    microbatch's graph through the stage (on detached inputs and parameter
    views) and keeps it; the backward runs those graphs with the gradients
    that come back from the next stage."""

    @staticmethod
    def forward(ctx, plan, h0, *flat):
        mesh, axis, S, M = plan["mesh"], plan["axis"], plan["S"], plan["M"]
        s = mesh.index(axis)
        nb = plan["n_batched"]
        batched, leaves = flat[:nb], flat[nb:]
        mb = h0.shape[0] // M
        with torch.set_grad_enabled(plan["grad"]):
            views = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
            stage = _unflatten(plan["scanned"], views)
            xs, bs, ys, sends = [], [], [], []
            for m in range(M):
                if s == 0:
                    x = _micro(h0, m, mb).detach()
                else:
                    x = mesh.recv(h0[:mb], axis, s - 1)
                x.requires_grad_(s > 0 or h0.requires_grad)
                b_m = [None if t is None else
                       _micro(t, m, mb).detach().requires_grad_(t.requires_grad) for t in batched]
                sl = stage if plan["fold"] is None else plan["fold"](stage, m)
                y = x
                for item in sl:
                    y = plan["body"](y, item, *b_m, *plan["const"])
                if s < S - 1:
                    sends.append(mesh.send(y.detach(), axis, s + 1))
                xs.append(x)
                bs.append(b_m)
                ys.append(y)
        for req, _ in sends:
            req.wait()
        out = torch.cat([y.detach() for y in ys]) if s == S - 1 else torch.zeros_like(h0)
        out = mesh.broadcast(out, S - 1, axis)
        ctx.plan, ctx.xs, ctx.bs, ctx.ys, ctx.views = plan, xs, bs, ys, views
        ctx.h0_grad = h0.requires_grad
        return out

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        mesh, axis, S, M = plan["mesh"], plan["axis"], plan["S"], plan["M"]
        s = mesh.index(axis)
        mb = g.shape[0] // M
        dxs, sends = [], []
        for m in range(M):
            y = ctx.ys[m]
            gy = _micro(g, m, mb) if s == S - 1 else mesh.recv(y, axis, s + 1)
            torch.autograd.backward(y, gy.to(y.dtype))
            x = ctx.xs[m]
            dx = torch.zeros_like(x) if x.grad is None else x.grad
            if s > 0:
                sends.append(mesh.send(dx, axis, s - 1))
            dxs.append(dx)
        for req, _ in sends:
            req.wait()
        dh0 = None
        if ctx.h0_grad:
            dh0 = torch.cat(dxs) if s == 0 else torch.zeros_like(torch.cat(dxs))
            dh0 = mesh.all_reduce(dh0, axis)
        dbatched = []
        for i in range(plan["n_batched"]):
            parts = [b[i] for b in ctx.bs]
            if parts[0] is None or not parts[0].requires_grad:
                dbatched.append(None)
                continue
            d = torch.cat([torch.zeros_like(p) if p.grad is None else p.grad for p in parts])
            dbatched.append(mesh.all_reduce(d, axis))
        dleaves = [v.grad if v.requires_grad else None for v in ctx.views]
        ctx.xs = ctx.bs = ctx.ys = ctx.views = None
        return (None, dh0, *dbatched, *dleaves)


def gpipe_scan(body, h0: torch.Tensor, scanned: list, mesh: Mesh, *, axis: str = "pipe",
               n_micro: Optional[int] = None, batched=(), const=(), fold_scanned=None):
    """Pipeline-parallel equivalent of

        for sl in scanned_full: h = body(h, sl, *batched, *const)

    body(h_micro, item, *batched_micro, *const) -> h_micro.

    - h0: (B, ...) carry entering the first block; B % n_micro == 0. It and
      `batched` are this rank's batch rows (the pipeline runs per data shard).
    - scanned: THIS stage's list of per-layer items (nested dicts/lists of
      tensors, and non-tensor leaves such as seeds): the contiguous
      depth / S slice of the full list (`parallel.mesh.stage_blocks`).
    - batched: per-row tensors (leading B) split into microbatches beside h0
      (the time embedding, a padding mask; None passes through).
    - const: passed to every stage and microbatch as it is (RoPE tables).
    - fold_scanned(stage_items, m) -> stage_items, applied per microbatch
      index m before the stage runs it: fold m into per-layer seeds so the
      microbatches draw independent masks. Not applied when S == 1, which is
      the plain loop itself.

    Returns the (B, ...) output of the last block on every stage."""
    S = mesh.size(axis)
    if S == 1:
        h = h0
        for sl in scanned:
            h = body(h, sl, *batched, *const)
        return h
    _check_context()
    M = n_micro or S
    if h0.shape[0] % M:
        raise ValueError(f"local batch {h0.shape[0]} not divisible by n_micro {M}")
    plan = {"mesh": mesh, "axis": axis, "S": S, "M": M, "body": body, "scanned": scanned,
            "fold": fold_scanned, "const": tuple(const), "n_batched": len(batched),
            "grad": torch.is_grad_enabled()}
    return GPipe.apply(plan, h0, *batched, *_leaves(scanned))
