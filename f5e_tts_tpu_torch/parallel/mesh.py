"""Device mesh, collectives and sharding rules on torch.distributed
(counterpart of `f5e_tts_tpu/parallel/mesh.py`).

One process per rank. The mesh lays the world's ranks out row-major over
the JAX package's five axes:
- "data": batch / data parallelism; gradients are reduced over it;
- "fsdp": fully-sharded data parallelism (ZeRO-3): batches shard over it as
  over "data", and the DiT's block matrices are also split on their non-TP
  dim; a block's weights are all-gathered at use and their gradients
  reduce-scattered (`FSDPGather`), so AdamW's moments and the EMA live on the
  shards;
- "model": Megatron tensor parallelism over attention heads and the FFN
  hidden (`CopyToGroup` / `ReduceFromGroup`);
- "seq": sequence parallelism, ring attention over the frames
  (ops/ring_attention.py);
- "pipe": GPipe over the DiT's depth (parallel/pipeline.py).
GSPMD inserts the JAX package's collectives; here each one is explicit, and
the ones on the autograd path are `torch.autograd.Function`s with their own
backward.

Transport: "nccl" (the default for CUDA tensors), "gloo" (the default for
CPU tensors) or "gloo-host": CUDA tensors staged through pinned host memory
for a gloo group, for ranks that share one card (NCCL refuses two ranks on
one device). The caller chooses "gloo-host"; nothing picks it by itself.

Sharded parameters are plain local tensors: each rank holds the slice of a
leaf that its coordinates select (`shard_dit_params`), and
`gather_dit_params` puts the full tree back together.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from itertools import product
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from f5e_tts_tpu_torch.config import DiTConfig, MeshConfig

AXES = ("data", "fsdp", "model", "seq", "pipe")
BATCH_AXES = ("data", "fsdp")
TRANSPORTS = ("nccl", "gloo", "gloo-host")

Axes = Union[str, Sequence[str]]


class P(tuple):
    """A partition spec: per dim of a leaf, None or the mesh axis (or tuple
    of axes) the dim is split over (jax.sharding.PartitionSpec's meaning)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def mesh_shape(cfg: MeshConfig = MeshConfig(), world: int = 1) -> Dict[str, int]:
    """{axis: size} over AXES for `world` ranks; data -1 takes the rest
    (make_mesh of the JAX package: its `need` may be under the device count)."""
    model, seq = max(cfg.model, 1), max(cfg.seq, 1)
    fsdp, pipe = max(cfg.fsdp, 1), max(cfg.pipe, 1)
    data = cfg.data if cfg.data > 0 else world // (fsdp * model * seq * pipe)
    need = data * fsdp * model * seq * pipe
    if data < 1 or need > world:
        raise ValueError(f"mesh {data}x{fsdp}x{model}x{seq}x{pipe} needs {need} ranks, "
                         f"have {world}")
    return dict(zip(AXES, (data, fsdp, model, seq, pipe)))


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """This rank's place on a mesh of the world's ranks, with a process group
    per axis (and per set of axes it reduces over) of the peers along it.

    Every rank of the world must build the same mesh, in the same order
    relative to other meshes: the groups are created collectively."""

    def __init__(self, shape: Dict[str, int], rank: int, device: torch.device,
                 transport: Optional[str] = None, every_axis: bool = False):
        """`every_axis`: build a group for every axis and run each collective
        through it, axes of one rank too (a world of one exercising its
        backend); by default an axis of one rank makes none and its
        collectives return their input."""
        self.every_axis = every_axis
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.world = int(np.prod(list(self.shape.values())))
        self.rank = rank
        self.device = torch.device(device)
        if transport is None:
            transport = "nccl" if self.device.type == "cuda" else "gloo"
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r}: one of {TRANSPORTS}")
        if transport == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl transport needs CUDA tensors; use gloo on the CPU")
        self.transport = transport
        self.staged = transport == "gloo-host" and self.device.type == "cuda"
        sizes = [self.shape[a] for a in AXES]
        self.coords = dict(zip(AXES, (int(i) for i in np.unravel_index(rank, sizes))))
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._ranks: Dict[Tuple[str, ...], List[int]] = {}
        if self.world > 1 or every_axis:
            for axes in [(a,) for a in AXES] + [BATCH_AXES, AXES]:
                self._build(axes)

    def _live(self, axes: Axes) -> bool:
        """Whether a collective over `axes` runs (else it is the identity)."""
        return self.every_axis or self.size(axes) > 1

    def _build(self, axes: Tuple[str, ...]) -> None:
        if not self._live(axes):
            return
        backend = "nccl" if self.transport == "nccl" else "gloo"
        grid = np.arange(self.world).reshape([self.shape[a] for a in AXES])
        keep = [AXES.index(a) for a in axes]
        others = [i for i in range(len(AXES)) if i not in keep]
        # one group per setting of the other axes, in a fixed order on every rank
        for fixed in product(*(range(grid.shape[i]) for i in others)):
            index = [slice(None)] * len(AXES)
            for i, v in zip(others, fixed):
                index[i] = v
            ranks = sorted(int(r) for r in grid[tuple(index)].reshape(-1))
            group = dist.new_group(ranks, backend=backend)
            if self.rank in ranks:
                self._groups[axes], self._ranks[axes] = group, ranks

    # -- geometry ----------------------------------------------------------

    def size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's index along `axes` (row-major over them)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes):
        return self._groups[_axes(axes)]

    def peer(self, axes: Axes, index: int) -> int:
        """The world rank at `index` along `axes`, this rank's other coordinates kept."""
        return self._ranks[_axes(axes)][index]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"transport={self.transport!r})")

    # -- collectives (identity over an axis of size 1) -----------------------

    def _host(self, t: torch.Tensor, copy: bool = False) -> torch.Tensor:
        """The tensor the group's backend reads: a host copy when staged; a
        fresh one when the collective writes in place (`copy`)."""
        if self.staged:
            return self._empty(t.shape, t.dtype, "cpu").copy_(t.detach())
        t = t.detach().contiguous()
        return t.clone() if copy else t

    def _empty(self, shape, dtype, device) -> torch.Tensor:
        """A buffer for the backend on `device`: in pinned host pages when
        staged (the card copies to and from them at the link's rate;
        PyTorch's host allocator keeps them for reuse)."""
        return torch.empty(shape, dtype=dtype, device=device, pin_memory=self.staged)

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(like.device) if self.staged else h

    def all_reduce(self, t: torch.Tensor, axes: Axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction over `axes`, a new tensor (t itself over size 1)."""
        if not self._live(axes):
            return t
        h = self._host(t, copy=True)
        dist.all_reduce(h, op=op, group=self.group(axes))
        return self._back(h, t)

    def all_gather(self, t: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
        """The pieces of every rank along `axes`, concatenated on `dim` in index order."""
        n = self.size(axes)
        if not self._live(axes):
            return t
        h = self._host(t.movedim(dim, 0)).contiguous()
        out = self._empty((n * h.shape[0],) + h.shape[1:], h.dtype, h.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, h, group=self.group(axes))
        return self._back(out, t).movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
        """This rank's chunk along `dim` of the sum over `axes`."""
        n = self.size(axes)
        if not self._live(axes):
            return t
        h = self._host(t.movedim(dim, 0)).contiguous()
        if h.shape[0] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks")
        out = self._empty((h.shape[0] // n,) + h.shape[1:], h.dtype, h.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, h, group=self.group(axes))
        return self._back(out, t).movedim(0, dim)

    def broadcast(self, t: torch.Tensor, src: int, axes: Axes) -> torch.Tensor:
        """The tensor of the rank at index `src` along `axes`, on every rank of them."""
        if not self._live(axes):
            return t
        h = self._host(t, copy=True)
        dist.broadcast(h, src=self.peer(axes, src), group=self.group(axes))
        return self._back(h, t)

    def shift(self, tensors: Sequence[torch.Tensor], axis: str, step: int = 1
              ) -> List[torch.Tensor]:
        """Send each tensor to index + step along `axis` (cyclically) and
        return those received from index - step: one ring step by send/recv."""
        n = self.size(axis)
        if not self._live(axis):
            return list(tensors)
        i = self.index(axis)
        dst, src = self.peer(axis, (i + step) % n), self.peer(axis, (i - step) % n)
        group = self.group(axis)
        sends = [self._host(t).contiguous() for t in tensors]
        recvs = [self._empty(s.shape, s.dtype, s.device) for s in sends]
        ops = [dist.P2POp(dist.isend, s, dst, group) for s in sends]
        ops += [dist.P2POp(dist.irecv, r, src, group) for r in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [self._back(r, t) for r, t in zip(recvs, tensors)]

    def send(self, t: torch.Tensor, axis: str, index: int):
        """Start sending `t` to the rank at `index` along `axis`; returns
        (request, buffer): wait on the request before the buffer goes."""
        h = self._host(t).contiguous()
        return dist.isend(h, self.peer(axis, index), group=self.group(axis)), h

    def recv(self, like: torch.Tensor, axis: str, index: int) -> torch.Tensor:
        """A tensor shaped as `like` from the rank at `index` along `axis`."""
        h = self._empty(like.shape, like.dtype, "cpu" if self.staged else like.device)
        dist.recv(h, self.peer(axis, index), group=self.group(axis))
        return self._back(h, like)

    def barrier(self) -> None:
        if self._live(AXES):
            dist.barrier(group=self.group(AXES))


def make_mesh(cfg: MeshConfig = MeshConfig(), device="cpu", transport: Optional[str] = None
              ) -> Mesh:
    """The mesh of `cfg` over torch.distributed's world (one rank and no
    group when no process group is up). The mesh must use every rank."""
    up = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if up else (1, 0)
    shape = mesh_shape(cfg, world)
    need = int(np.prod(list(shape.values())))
    if need != world:
        raise ValueError(f"mesh {shape} uses {need} of the world's {world} ranks")
    return Mesh(shape, rank, torch.device(device), transport)


# ---------------------------------------------------------------------------
# collectives on the autograd path
# ---------------------------------------------------------------------------


class CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated input entering a
    column-parallel region (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axes), None, None


class ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product made whole (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes):
        return mesh.all_reduce(x.contiguous(), axes).clone()

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllReduceBoth(torch.autograd.Function):
    """All-reduce forward and backward: a sum of per-rank partials that every
    rank then uses on its own shard (GRN's mean over a split channel dim)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(x.contiguous(), axes).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axes), None, None


def _chunk(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


class ScatterRows(torch.autograd.Function):
    """Take this rank's chunk of a replicated tensor along `dim`; the
    backward all-gathers the chunks' gradients (every rank's replicated
    producer gets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes, dim: int):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _chunk(x, dim, mesh.size(axes), mesh.index(axes)).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.dim, ctx.axes), None, None, None


class GatherRows(torch.autograd.Function):
    """All-gather the chunks along `dim` into a replicated tensor; the
    backward keeps this rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes, dim: int):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x.contiguous(), dim, axes)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _chunk(g, ctx.dim, m.size(ctx.axes), m.index(ctx.axes)).contiguous(), None, None, None


class FSDPGather(torch.autograd.Function):
    """A parameter shard all-gathered along `dim` for use; its gradient
    reduce-scattered back onto the shard (summed over the axis)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes, dim: int):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x.contiguous(), dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g.contiguous(), ctx.dim, ctx.axes), None, None, None


# ---------------------------------------------------------------------------
# the active mesh: what the model's ops shard over while a step runs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Active:
    """The mesh the ops read while `active` holds it (none: unsharded).

    - its batch axes (data, fsdp) split the batch dim: losses reduce over the
      global batch and draw their per-row randomness at its shape
      (models/cfm.py), and a DiT block all-gathers its fsdp-split matrices;
    - "model" splits a DiT's heads and FF hidden when `model` is set (a
      backbone other than the DiT computes replicated over it);
    - "seq" sends sequences of n >= `min_seq` frames through ring attention
      (ops/attention.py);
    - "pipe" pipelines the DiT trunk over `n_micro` microbatches
      (parallel/pipeline.py; None: one per stage)."""
    mesh: Optional[Mesh] = None
    model: bool = True
    min_seq: int = 2048
    n_micro: Optional[int] = None

    def over(self, axes: Axes) -> Optional[Mesh]:
        """The mesh when `axes` hold more than one shard under it, else None."""
        if self.mesh is None or (not self.model and "model" in _axes(axes)):
            return None
        return self.mesh if self.mesh.size(axes) > 1 else None


_ACTIVE: List[Active] = [Active()]


def current() -> Active:
    """The innermost `active` context (the unsharded one outside any)."""
    return _ACTIVE[-1]


@contextlib.contextmanager
def active(mesh: Optional[Mesh], **options):
    """Run the body with the model's ops sharded over `mesh` (options: the
    fields of `Active`). Only the training step enters it; everything
    outside, a sample hook's inference included, runs unsharded."""
    _ACTIVE.append(Active(mesh, **options))
    try:
        yield _ACTIVE[-1]
    finally:
        _ACTIVE.pop()


def batch_mesh() -> Optional[Mesh]:
    """The active mesh when its batch axes hold more than one shard."""
    return current().over(BATCH_AXES)


# ---------------------------------------------------------------------------
# the batch axes: loss reductions and draws over the global batch
# ---------------------------------------------------------------------------


def global_mean(num: torch.Tensor, den: torch.Tensor, mesh: Optional[Mesh],
                min_den: float = 0.0) -> torch.Tensor:
    """sum(num) / max(sum(den), min_den) over the batch shards. The value is
    the global quotient, the same bits on every rank; its gradient is this
    shard's num / global den, so the gradients summed over the shards are
    the global loss's."""
    if mesh is None:
        return num / torch.clamp(den, min=min_den)
    den_all = torch.clamp(mesh.all_reduce(den.detach().float(), BATCH_AXES), min=min_den)
    local = num / den_all
    total = mesh.all_reduce(local.detach().clone(), BATCH_AXES)
    return total + (local - local.detach())


def shard_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of a per-shard scalar over the batch shards, differentiable
    as x / shards on each (so the summed gradients are the mean's)."""
    if mesh is None or x is None:
        return x
    n = mesh.size(BATCH_AXES)
    local = x / n
    total = mesh.all_reduce(local.detach().clone(), BATCH_AXES)
    return total + (local - local.detach())


def fold_generator(generator: Optional[torch.Generator], index: int
                   ) -> Optional[torch.Generator]:
    """A generator of its own for shard `index`: seeded from one draw of
    `generator` (the same draw on every rank that shares its state) and the
    index, so shards and microbatches draw independent masks."""
    if generator is None:
        return None
    base = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(
        (base * 1_000_003 + index + 1) % (2 ** 63))


def local_rows(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """This rank's contiguous chunk of a global batch tensor along `dim`."""
    if mesh is None or mesh.size(BATCH_AXES) == 1:
        return x
    return _chunk(x, dim, mesh.size(BATCH_AXES), mesh.index(BATCH_AXES))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global (numpy or tensor) batch dict. A batch
    whose size the shards do not divide is first padded with rows of zeros
    whose lengths are 0: they hold no frame of the loss and take no
    gradient (the JAX trainer assembles its global batch from equal local
    shards, trainer.py:444-456)."""
    n = mesh.size(BATCH_AXES)
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        pad = -t.shape[0] % n
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        t = local_rows(t, mesh)
        out[k] = t.numpy() if isinstance(v, np.ndarray) else t
    return out


class ShardedLoader:
    """A loader of global batches seen as this rank's: each batch through
    `shard_batch`; `len` and `sampler.set_epoch` pass through."""

    def __init__(self, loader, mesh: Mesh):
        self.loader, self.mesh = loader, mesh
        self.sampler = loader.sampler

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield shard_batch(batch, self.mesh)


# ---------------------------------------------------------------------------
# DiT parameter specs
# ---------------------------------------------------------------------------


def dit_param_spec(cfg: DiTConfig, fsdp: bool = False, pipe: bool = False) -> dict:
    """The spec tree of the JAX package's `dit_param_spec` (mesh.py:63-147):
    blocks carry a leading depth entry, as JAX stacks them (the port keeps
    them as a list; `tree_map_with_spec` drops that entry per block, and
    "pipe" there splits the list).

    Megatron TP: q/k/v and ff1 column-parallel (output dim over "model"),
    to_out and ff2 row-parallel (input dim); the ConvNeXt pwconv1 / GRN /
    pwconv2 likewise. fsdp=True also splits each block matrix's other dim
    over "fsdp"; pipe=True pins the depth entry to "pipe"."""
    f = "fsdp" if fsdp else None
    col, row, vec_col = P(None, f, "model"), P(None, "model", f), P(None, "model")
    spec = {
        "time_embed": {"mlp1": {"w": P(), "b": P()}, "mlp2": {"w": P(), "b": P()}},
        "text_embed": {
            "embed": {"w": P()},
            "blocks": [
                {"dwconv": {"w": P(), "b": P()}, "norm": {"g": P(), "b": P()},
                 "pwconv1": {"w": P(None, "model"), "b": P("model")},
                 "grn": {"gamma": P("model"), "beta": P("model")},
                 "pwconv2": {"w": P("model", None), "b": P()}}
                for _ in range(cfg.conv_layers)],
        },
        "input_embed": {"proj": {"w": P(), "b": P()}, "conv1": {"w": P(), "b": P()},
                        "conv2": {"w": P(), "b": P()}},
        "blocks": {
            "attn_norm": {"w": P(), "b": P()},
            "attn": {"to_q": {"w": col, "b": vec_col}, "to_k": {"w": col, "b": vec_col},
                     "to_v": {"w": col, "b": vec_col},
                     "to_out": {"w": row, "b": P(None, None)}},
            "ff1": {"w": col, "b": vec_col},
            "ff2": {"w": row, "b": P(None, None)},
        },
        "norm_out": {"w": P(), "b": P()},
        "proj_out": {"w": P(), "b": P()},
    }
    if cfg.qk_norm == "rms_norm":
        spec["blocks"]["attn"]["q_norm"] = {"g": P(None, None)}
        spec["blocks"]["attn"]["k_norm"] = {"g": P(None, None)}
    if cfg.long_skip_connection:
        spec["long_skip"] = {"w": P()}
    if cfg.ppg.use_ppg:
        spec["ppg_embed"] = {"pre": {"w": P(), "b": P()},
                             "convs": [{"w": P(), "b": P()} for _ in range(3)],
                             "bns": [{"g": P(), "b": P()} for _ in range(3)],
                             "post": {"w": P(), "b": P()}}
    if cfg.codebook.use_codebook:
        spec["quantizer"] = {"vars": P(), "weight_proj": {"layer_0": {"w": P(), "b": P()}}}
    if pipe:
        spec["blocks"] = _map_specs(lambda s: P("pipe", *tuple(s)[1:]), spec["blocks"])
    return spec


def _map_specs(fn, spec):
    if isinstance(spec, P):
        return fn(spec)
    if isinstance(spec, dict):
        return {k: _map_specs(fn, v) for k, v in spec.items()}
    return [_map_specs(fn, v) for v in spec]


def tree_map_with_spec(fn, tree, spec):
    """fn(leaf, spec_leaf) over parallel (tree, spec) structures. The port's
    list of blocks against the stacked spec dict maps each block with the
    spec's depth entry dropped; a spec leaf over a subtree (the 8-bit
    moments' {codes, scale}) hands fn the subtree."""
    if isinstance(spec, P):
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: tree_map_with_spec(fn, tree[k], spec[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        if isinstance(spec, dict):
            block = _map_specs(lambda s: P(*tuple(s)[1:]), spec)
            return [tree_map_with_spec(fn, t, block) for t in tree]
        return [tree_map_with_spec(fn, t, s) for t, s in zip(tree, spec)]
    raise TypeError(f"structure mismatch: {type(tree)} vs {type(spec)}")


def _split_dims(spec: P, mesh: Mesh):
    """(dim, axes) of each split dim of a leaf whose axes hold > 1 rank."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(a for a in _axes(entry) if mesh.size(a) > 1)
        if axes:
            out.append((d, axes))
    return out


def shard_leaf(x, spec: P, mesh: Mesh):
    """This rank's slice of a full leaf."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, axes in _split_dims(spec, mesh):
        x = _chunk(x, d, mesh.size(axes), mesh.index(axes))
    return x.contiguous()


def gather_leaf(x, spec: P, mesh: Mesh):
    """The full leaf from every rank's slice (a collective over its axes)."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, axes in reversed(_split_dims(spec, mesh)):
        x = mesh.all_gather(x.contiguous(), d, axes)
    return x


def block_spec(cfg: DiTConfig, fsdp: bool = False) -> dict:
    """The spec of one block of the port's list (depth entry dropped)."""
    return _map_specs(lambda s: P(*tuple(s)[1:]), dit_param_spec(cfg, fsdp=fsdp)["blocks"])


def stage_blocks(blocks: list, mesh: Mesh) -> list:
    """The contiguous depth / pipe blocks of this rank's pipeline stage."""
    s, n = mesh.index("pipe"), mesh.size("pipe")
    if len(blocks) % n:
        raise ValueError(f"depth {len(blocks)} not divisible by pipe size {n}")
    per = len(blocks) // n
    return blocks[s * per:(s + 1) * per]


def check_tp_widths(cfg: DiTConfig, tp: int) -> None:
    if tp > 1 and (cfg.heads % tp or int(cfg.dim * cfg.ff_mult) % tp):
        raise ValueError(f"heads {cfg.heads} and the FF width must divide over model {tp}")


def shard_dit_params(params: dict, mesh: Mesh, cfg: DiTConfig, fsdp: Optional[bool] = None,
                     pipe: Optional[bool] = None) -> dict:
    """This rank's local tree of a full DiT tree (params, the EMA, or a tree
    of AdamW moments laid out as the params): each leaf sliced along its
    spec's axes, and under pipe the stage's blocks only. fsdp/pipe default
    to the mesh having those axes."""
    fsdp = mesh.size("fsdp") > 1 if fsdp is None else fsdp
    pipe = mesh.size("pipe") > 1 if pipe is None else pipe
    check_tp_widths(cfg, mesh.size("model"))
    spec = dit_param_spec(cfg, fsdp=fsdp, pipe=pipe)
    tree = dict(params)
    if pipe:
        tree["blocks"] = stage_blocks(list(params["blocks"]), mesh)
    return tree_map_with_spec(lambda x, s: shard_leaf(x, s, mesh), tree, spec)


def gather_dit_params(local: dict, mesh: Mesh, cfg: DiTConfig, fsdp: Optional[bool] = None,
                      pipe: Optional[bool] = None) -> dict:
    """The full tree from every rank's local tree (`shard_dit_params`'s
    inverse; a collective: every rank calls it and gets the full tree)."""
    fsdp = mesh.size("fsdp") > 1 if fsdp is None else fsdp
    pipe = mesh.size("pipe") > 1 if pipe is None else pipe
    spec = dit_param_spec(cfg, fsdp=fsdp, pipe=pipe)
    tree = tree_map_with_spec(lambda x, s: gather_leaf(x, s, mesh), local, spec)
    if pipe and mesh.size("pipe") > 1:
        stages = [[] for _ in range(mesh.size("pipe"))]
        for blk in tree["blocks"]:
            leaves = _leaves(blk)
            pieces = [mesh.all_gather(t[None], 0, "pipe") for t in leaves]
            for s in range(len(stages)):
                stages[s].append(_unflatten(blk, [p[s] for p in pieces]))
        tree["blocks"] = [blk for stage in stages for blk in stage]
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _unflatten(template, leaves: Iterable[torch.Tensor]):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it) if isinstance(t, torch.Tensor) else t

    return build(template)


def leaf_specs(params: dict, cfg: Optional[DiTConfig], mesh: Mesh) -> List[Optional[P]]:
    """The spec of each leaf of a local tree, in `tree_leaves` order; a
    block's leaves keep the stacked spec's depth entry ("pipe" under a
    pipeline). None for a backbone other than the DiT: replicated."""
    if cfg is None:
        return [None] * len(_leaves(params))
    out: List[Optional[P]] = []

    def walk(tree, spec):
        if isinstance(spec, P):
            out.extend([spec] * len(_leaves(tree)))
        elif isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k])
        elif isinstance(spec, dict):  # the list of blocks against the stacked spec
            for t in tree:
                walk(t, spec)
        else:
            for t, s in zip(tree, spec):
                walk(t, s)

    walk(params, dit_param_spec(cfg, fsdp=mesh.size("fsdp") > 1, pipe=mesh.size("pipe") > 1))
    return out


def _spec_axes(spec: Optional[P], mesh: Mesh) -> set:
    """The axes of more than one rank that split some dim of a leaf."""
    return {a for entry in (spec or ()) if entry is not None for a in _axes(entry)
            if mesh.size(a) > 1}


@dataclasses.dataclass
class GradSync:
    """What a step does with the local gradients of a sharded train state.

    Each leaf's gradient is summed over the batch axes its parameter is
    replicated on: (data, fsdp), or data alone for an fsdp-split leaf whose
    `FSDPGather` already reduce-scattered it. The global norm counts each
    distinct element once: every rank's squared norms weighted by 1 / the
    leaf's copies, summed over the world."""

    mesh: Mesh
    specs: List[Optional[P]]

    def _axes(self, spec: Optional[P]) -> Tuple[str, ...]:
        split = _spec_axes(spec, self.mesh)
        return tuple(a for a in BATCH_AXES if a not in split and self.mesh.size(a) > 1)

    def _copies(self, spec: Optional[P]) -> int:
        return self.mesh.world // self.mesh.size(tuple(_spec_axes(spec, self.mesh)))

    def reduce_(self, grads: List[torch.Tensor]) -> None:
        """Sum each gradient over its batch axes, in place, one flat buffer a group."""
        buckets: Dict[Tuple[str, ...], List[int]] = {}
        for i, s in enumerate(self.specs):
            axes = self._axes(s)
            if axes:
                buckets.setdefault(axes, []).append(i)
        for axes, idx in buckets.items():
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            flat = self.mesh.all_reduce(flat, axes)
            for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i].copy_(piece.view_as(grads[i]))

    def norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the full gradient, fp32, on every rank."""
        sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for g, s in zip(grads, self.specs):
            sq = sq + g.float().square().sum() / self._copies(s)
        return self.mesh.all_reduce(sq, AXES).sqrt()

    def mean_(self, tensors: List[torch.Tensor]) -> None:
        """The mean over the batch shards, in place (a PPG DiT's BatchNorm
        statistics, which each shard updates from its own rows)."""
        n = self.mesh.size(BATCH_AXES)
        for t in tensors:
            t.copy_(self.mesh.all_reduce(t.float(), BATCH_AXES).div_(n).to(t.dtype))
