"""8-bit AdamW: block-wise int8 optimizer moments (counterpart of
`f5e_tts_tpu/train/adamw8bit.py`).

reference: src/f5_tts/model/trainer.py:134-137 (`bnb.optim.AdamW8bit` behind
`bnb_optimizer`). Not bitsandbytes: the JAX package's own quantisation,
which this port reproduces code for code. Both moments are kept as int8
codes with one fp32 scale per 256-element block, about 2.03 bytes a
parameter against AdamW's 8:
- m (signed): per-block absmax linear int8 in [-127, 127];
- v (non-negative): the same code on sqrt(v), which keeps relative precision
  where the update divides by it;
- leaves under `min_quantize_size` elements (biases, norms) keep fp32
  moments, as bitsandbytes' min_8bit_size does.
Each update decodes a leaf's moments to fp32, updates them, computes the
step from the fp32 values, and encodes them again. torch.round, like
jnp.round, rounds half to even, and the scale is floored at 1e-20 as in JAX.
Differences from the fp32 optax.adamw that the JAX package keeps: the
schedule is read at the post-increment count, and weight decay multiplies
the learning rate (`-lr * (step + wd * p)`).

Leaves. The JAX package quantizes per leaf of its param tree, and stacks
the backbone's layers over depth into one leaf each (models/dit.py:101,
models/unett.py:68-69, models/mmdit.py:56), where the port keeps a list of
per-layer dicts. So the moments are kept per *group*: the tensors at one
path of every entry of a depth-stacked list (`STACKED`), in depth order,
form one group; every other tensor is a group of its own (the DiT's
text-embed ConvNeXt list stays a list in JAX too). A group is quantized iff
its total size reaches `min_quantize_size`, and its blocks run over the
stacked leaf's flat, depth-major order: a block may straddle two layers
when a layer's size is not a multiple of the block size.

Under a mesh (`mesh` and the leaves' `specs` of parallel/mesh.py:
leaf_specs), each rank keeps the codes of its own elements of a split
leaf, in its local order, and the scale of every block of the whole leaf:
the max, over the ranks holding a part of the block, of their local
absmax, all-reduced over the axes that split the leaf (fsdp, model, pipe;
data replicas hold the same values). A local element's block comes from its
index in the JAX leaf's flat order, so a column-parallel shard whose rows
straddle blocks is placed exactly. The decoded moments then equal the
single-device ones element for element.

State. `mu` and `nu` hold one entry per group: {"codes", "scale"} when
quantized (codes (blocks, block_size) int8 over the whole leaf, or this
rank's elements flat under a mesh; scale (blocks, 1) fp32), else the list
of the members' fp32 moments. `MomentLayout.items` / `from_items` turn the
entries into per-parameter tensors (fp32 moments, or int8 codes in the
parameter's shape) and back, which the Trainer gathers and shards as it
does the params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from f5e_tts_tpu_torch.train.step import AdamW, AdamWState, tree_leaves

# the top-level param lists that the JAX package stacks over depth: the
# DiT's and the MMDiT's blocks, the UNetT's halves
STACKED = ("blocks", "first_half", "second_half")


def leaf_groups(params) -> List[Tuple[List[int], bool]]:
    """(indices into tree_leaves(params), stacked) of each JAX leaf: a
    tensor of every entry of a `STACKED` list at one path, in depth order,
    or one other tensor. A flat list of tensors is a leaf per tensor."""
    if not isinstance(params, dict):
        return [([i], False) for i in range(len(tree_leaves(params)))]
    groups, offset = [], 0
    for key, sub in params.items():
        n = len(tree_leaves(sub))
        if key in STACKED and isinstance(sub, (list, tuple)) and sub:
            per = len(tree_leaves(sub[0]))
            if per * len(sub) != n:
                raise ValueError(f"the entries of {key!r} differ in structure")
            groups += [([offset + layer * per + j for layer in range(len(sub))], True)
                       for j in range(per)]
        else:
            groups += [([offset + j], False) for j in range(n)]
        offset += n
    return groups


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root, as XLA's and CUDA's sqrtf: the
    CPU's vectorised torch.sqrt is not always (AVX-512), so on the CPU the
    root is taken in fp64 and rounded once. An off-by-one-ulp root moves a
    code that sits on a rounding boundary."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def _encode(x: torch.Tensor, block_size: int, signed: bool) -> dict:
    """{"codes": (blocks, block_size) int8, "scale": (blocks, 1) fp32}."""
    flat = x.reshape(-1).float()
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block_size)).reshape(-1,
                                                                                      block_size)
    if not signed:
        blocks = _sqrt(blocks)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    codes = torch.round(blocks / torch.clamp(scale, min=1e-20)).clamp(-127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale}


def _decode(q: dict, n: int, signed: bool) -> torch.Tensor:
    """The first n values of the decoded blocks, flat."""
    blocks = q["codes"].float() * q["scale"]
    if not signed:
        blocks = blocks.square()
    return blocks.reshape(-1)[:n]


@dataclass
class _Part:
    """One tensor of a group: its local shape and, under a mesh, where its
    elements sit in the JAX leaf (layer, per-dim offsets, full layer shape)."""
    shape: torch.Size
    layer: int = 0
    offsets: Tuple[int, ...] = ()
    full: Tuple[int, ...] = ()

    def flat_index(self, device) -> torch.Tensor:
        """Each local element's index in the leaf's flat order, (numel,) int64."""
        n_layer = 1
        for d in self.full:
            n_layer *= d
        idx = torch.tensor(self.layer * n_layer, dtype=torch.int64, device=device)
        stride = n_layer
        for size, off, full in zip(self.shape, self.offsets, self.full):
            stride //= full
            idx = idx[..., None] + (torch.arange(size, device=device) + off) * stride
        return idx.reshape(-1)


@dataclass
class _Group:
    members: List[int]  # indices into the leaves
    parts: List[_Part]
    numel: int  # the JAX leaf's size
    quantized: bool
    axes: Tuple[str, ...] = ()  # the mesh axes that split the leaf (empty: whole here)


class MomentLayout:
    """The groups of a param tree (`leaf_groups`) and, under a mesh, where
    each rank's elements sit in them; encodes and decodes a group's moments."""

    def __init__(self, params, block_size: int = 256, min_quantize_size: int = 4096,
                 mesh=None, specs: Optional[Sequence] = None):
        self.block_size, self.mesh = block_size, mesh
        leaves = tree_leaves(params)
        self.groups: List[_Group] = []
        for members, stacked in leaf_groups(params):
            parts, axes = [], set()
            for layer, i in enumerate(members):
                m, split = self._place(leaves[i].shape, layer, len(members), stacked,
                                       None if specs is None else specs[i])
                parts.append(m)
                axes |= split
            if axes:
                n_layer = 1
                for d in parts[0].full:
                    n_layer *= d
                numel = n_layer * self._layers(len(members), stacked, specs[members[0]])
            else:
                numel = sum(leaves[i].numel() for i in members)
            self.groups.append(_Group(members, parts, numel, numel >= min_quantize_size,
                                      tuple(sorted(axes))))

    def _split(self, entry) -> Tuple[str, ...]:
        if entry is None or self.mesh is None:
            return ()
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        return tuple(a for a in names if self.mesh.size(a) > 1)

    def _layers(self, local_layers: int, stacked: bool, spec) -> int:
        depth = self._split(tuple(spec)[0]) if stacked and spec else ()
        return local_layers * (self.mesh.size(depth) if depth else 1)

    def _place(self, shape, layer: int, layers: int, stacked: bool, spec):
        """(_Part, the axes that split it) for a tensor of local `shape`,
        the `layer`-th of its group; `spec` with the depth entry first when
        `stacked` (parallel/mesh.py: leaf_specs)."""
        entries = list(spec or ())
        depth = self._split(entries.pop(0)) if stacked and entries else ()
        entries += [None] * (len(shape) - len(entries))
        offsets, full, axes = [], [], set(depth)
        for size, entry in zip(shape, entries):
            split = self._split(entry)
            n = self.mesh.size(split) if split else 1
            offsets.append(self.mesh.index(split) * size if split else 0)
            full.append(size * n)
            axes |= set(split)
        if depth:
            layer += self.mesh.index(depth) * layers
        return _Part(shape, layer, tuple(offsets), tuple(full)), axes

    # -- one group's moments ------------------------------------------------

    def zeros(self, g: _Group, device) -> object:
        if not g.quantized:
            return [torch.zeros(m.shape, dtype=torch.float32, device=device) for m in g.parts]
        if not g.axes:
            return _encode(torch.zeros(g.numel, device=device), self.block_size, True)
        blocks = -(-g.numel // self.block_size)
        return {"codes": torch.zeros(sum(m.shape.numel() for m in g.parts), dtype=torch.int8,
                                     device=device),
                "scale": torch.zeros((blocks, 1), device=device)}

    def decode(self, g: _Group, entry, signed: bool) -> List[torch.Tensor]:
        """The members' fp32 moments."""
        if not g.quantized:
            return list(entry)
        sizes = [m.shape.numel() for m in g.parts]
        if not g.axes:
            flat = _decode(entry, g.numel, signed)
        else:
            scale = entry["scale"].reshape(-1)
            flat = torch.cat([c.float() * scale[m.flat_index(c.device) // self.block_size]
                              for c, m in zip(entry["codes"].split(sizes), g.parts)])
            if not signed:
                flat = flat.square()
        return [x.reshape(m.shape) for x, m in zip(flat.split(sizes), g.parts)]

    def encode(self, g: _Group, mu: List[torch.Tensor], nu: List[torch.Tensor]):
        """(mu entry, nu entry) of the members' fp32 moments."""
        if not g.quantized:
            return mu, nu
        if not g.axes:
            return tuple(_encode(torch.cat([x.reshape(-1) for x in xs]), self.block_size, signed)
                         for xs, signed in ((mu, True), (nu, False)))
        blocks = -(-g.numel // self.block_size)
        vals = [[x.reshape(-1).float() for x in mu], [_sqrt(x.reshape(-1).float()) for x in nu]]
        ids = [m.flat_index(mu[0].device) // self.block_size for m in g.parts]
        absmax = torch.zeros((2, blocks), device=mu[0].device)
        for k in range(2):
            for v, i in zip(vals[k], ids):
                absmax[k].scatter_reduce_(0, i, v.abs(), "amax")
        absmax = self.mesh.all_reduce(absmax, g.axes, torch.distributed.ReduceOp.MAX)
        out = []
        for k in range(2):
            scale = absmax[k] / 127.0
            floor = torch.clamp(scale, min=1e-20)
            codes = torch.cat([torch.round(v / floor[i]).clamp(-127, 127).to(torch.int8)
                               for v, i in zip(vals[k], ids)])
            out.append({"codes": codes, "scale": scale[:, None]})
        return tuple(out)

    # -- per-parameter views, for gathering and sharding ---------------------

    def items(self, entries: list) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
        """(per parameter, in leaf order: its fp32 moment or its int8 codes
        in its own shape; per group: its scale, None when fp32)."""
        n = sum(len(g.members) for g in self.groups)
        items: List[Optional[torch.Tensor]] = [None] * n
        scales: List[Optional[torch.Tensor]] = []
        for g, entry in zip(self.groups, entries):
            if g.quantized:
                sizes = [m.shape.numel() for m in g.parts]
                codes = entry["codes"].reshape(-1)[:sum(sizes)]
                pieces = [c.reshape(m.shape) for c, m in zip(codes.split(sizes), g.parts)]
                scales.append(entry["scale"])
            else:
                pieces = list(entry)
                scales.append(None)
            for i, piece in zip(g.members, pieces):
                items[i] = piece
        return items, scales

    def from_items(self, items: Sequence[torch.Tensor], scales: Sequence) -> list:
        """The entries of per-parameter `items` and per-group `scales` (`items`' inverse)."""
        out = []
        for g, scale in zip(self.groups, scales):
            pieces = [items[i] for i in g.members]
            if not g.quantized:
                out.append(pieces)
                continue
            codes = torch.cat([p.reshape(-1) for p in pieces])
            if not g.axes:
                codes = torch.nn.functional.pad(codes, (0, (-codes.numel()) % self.block_size))
                codes = codes.reshape(-1, self.block_size)
            out.append({"codes": codes, "scale": scale})
        return out


class AdamW8bit(AdamW):
    """The clip / accumulate chain of `train/step.py: AdamW` around the
    block-wise 8-bit AdamW (decoupled weight decay). `init` takes the param
    tree, whose JAX leaves it learns (`leaf_groups`); under a mesh, `mesh`
    and the tree's leaf `specs` say how each leaf is split."""

    def __init__(self, schedule: Callable[[int], float], max_grad_norm: float,
                 grad_accum: int = 1, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, block_size: int = 256,
                 min_quantize_size: int = 4096, mesh=None, specs: Optional[Sequence] = None):
        super().__init__(schedule, max_grad_norm, grad_accum, b1, b2, eps)
        self.weight_decay, self.block_size = weight_decay, block_size
        self.min_quantize_size = min_quantize_size
        self.mesh, self.specs = mesh, specs
        self.layout: Optional[MomentLayout] = None

    def make_layout(self, params, single: bool = False) -> MomentLayout:
        """The layout of a param tree under this optimizer's mesh, or the
        single-device one (`single`, or no mesh)."""
        mesh, specs = (None, None) if single else (self.mesh, self.specs)
        return MomentLayout(params, self.block_size, self.min_quantize_size, mesh, specs)

    def init(self, params) -> AdamWState:
        self.layout = self.make_layout(params)
        leaves = tree_leaves(params)
        dev = leaves[0].device
        zeros = lambda: [self.layout.zeros(g, dev) for g in self.layout.groups]  # noqa: E731
        return AdamWState(mu=zeros(), nu=zeros(),
                          acc=[torch.zeros_like(p, dtype=torch.float32) for p in leaves]
                          if self.grad_accum > 1 else None)

    @torch.no_grad()
    def _adam_(self, state: AdamWState, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> None:
        state.count += 1
        c = state.count
        lr = self.schedule(c)  # the JAX update reads the schedule after the increment
        b1, b2 = self.b1, self.b2
        mu_hat, nu_hat = 1.0 / (1.0 - b1 ** c), 1.0 / (1.0 - b2 ** c)
        layout = self.layout
        for gi, g in enumerate(layout.groups):
            ms = layout.decode(g, state.mu[gi], True)
            vs = layout.decode(g, state.nu[gi], False)
            for k, i in enumerate(g.members):
                p, grad = params[i], grads[i].float()
                m = b1 * ms[k] + (1 - b1) * grad
                v = b2 * vs[k] + (1 - b2) * grad.square()
                step = (m * mu_hat) / (torch.sqrt(v * nu_hat) + self.eps)
                p.add_((-lr * (step + self.weight_decay * p.float())).to(p.dtype))
                ms[k], vs[k] = m, v
            state.mu[gi], state.nu[gi] = layout.encode(g, ms, vs)


def state_bytes(opt_state) -> int:
    """The optimizer state's bytes: every tensor of the moments (and the
    accumulator, when there is one) and the update count, an int32 as in JAX."""
    trees = [opt_state.mu, opt_state.nu] + ([opt_state.acc] if opt_state.acc is not None else [])
    return 4 + sum(t.numel() * t.element_size() for t in tree_leaves(trees))
