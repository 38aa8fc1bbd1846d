"""Weight converters into the port's parameter dicts.

- `dit_from_jax` / `unett_from_jax` / `mmdit_from_jax` / `vocos_from_jax`:
  the JAX package's parameter trees, given as nested dicts of numpy arrays.
  The port keeps the JAX layouts (linear (in, out), conv (k, in/groups,
  out)) and the JAX q/k feature order, so this is a plain copy; only the
  depth-stacked block arrays are split into a list of per-block dicts.
- A PPG DiT (`ppg.use_ppg`) also has state, its PPG embedding's BatchNorm
  running statistics: its loaders return (params, state) and its exports
  take `state=`. The codebook's `quantizer` is a parameter like any other.
- `dit_from_reference_state_dict` / `unett_from_reference_state_dict` /
  `mmdit_from_reference_state_dict`: a reference-layout F5-TTS state dict
  (`transformer.*` keys, torch layouts). Linear weights are transposed and conv weights moved (out, in/g, k) ->
  (k, in/g, out).
- `dit_to_reference_state_dict` / `unett_to_reference_state_dict` /
  `mmdit_to_reference_state_dict`: their inverses, the export the trainer's
  checkpoints carry (the port's copies of f5e_tts_tpu/utils/torch_ckpt.py:
  dit_to_torch, unett_to_torch and mmdit_to_torch);
  `backbone_to_reference_state_dict` and `backbone_from_reference_state_dict`
  pick by the config's type.

RoPE order: the reference rotates interleaved feature pairs (2j, 2j+1). The
port, like the JAX package, keeps each head's q/k features in half-split
order (pair j at (j, j + dh/2)), so the attention kernel rotates with a
contiguous rot_half. The reference loaders therefore permute the output
features of to_q/to_k (weights and biases) and q_norm/k_norm at ingest (and
of the MMDiT's text-stream to_q_c/to_k_c and c_q_norm/c_k_norm), as
f5e_tts_tpu/utils/torch_ckpt.py does, and the exports undo it; attention
scores are unchanged because q.k is invariant under a permutation shared by
q and k.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from f5e_tts_tpu_torch.config import DiTConfig, MMDiTConfig, UNetTConfig
from f5e_tts_tpu_torch.ops.rope import (half_split_perm, permute_qk_bias, permute_qk_weight,
                                        unpermute_qk_bias, unpermute_qk_weight)

_DROP_KEYS = ("initted", "step", "mel_spec.mel_stft.mel_scale.fb",
              "mel_spec.mel_stft.spectrogram.window")


def to_tensors(tree, device="cpu", dtype=None):
    """Map every array leaf of a nested dict/list to a torch tensor."""
    if isinstance(tree, Mapping):
        return {k: to_tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensors(v, device, dtype) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _unstack_blocks(params_np: Mapping, count: int, keys=("blocks",)) -> dict:
    """A JAX tree whose arrays under each of `keys` are stacked on a leading
    axis of `count` -> tensors, with each of `keys` a list of `count`
    per-layer dicts."""
    tree = to_tensors(params_np)

    def block(i, node):
        if isinstance(node, Mapping):
            return {k: block(i, v) for k, v in node.items()}
        return node[i].clone()

    return {**tree, **{key: [block(i, tree[key]) for i in range(count)] for key in keys}}


def dit_from_jax(params_np: Mapping, cfg: DiTConfig, state_np: Optional[Mapping] = None):
    """The JAX DiT tree (blocks stacked on a leading depth axis) -> port
    params; for a PPG DiT (params, state), with the JAX state tree
    `state_np` ({"ppg_bn": [{mean, var, count}] x 3})."""
    params = _unstack_blocks(params_np, cfg.depth)
    if cfg.ppg.use_ppg:
        if state_np is None:
            raise ValueError("a PPG DiT converts with its JAX state tree (state_np=)")
        return params, to_tensors(state_np)
    return params


def unett_from_jax(params_np: Mapping, cfg: UNetTConfig) -> dict:
    """The JAX UNetT tree (`first_half` / `second_half` each stacked on a
    leading axis of depth / 2) -> port params."""
    return _unstack_blocks(params_np, cfg.depth // 2, ("first_half", "second_half"))


def mmdit_from_jax(params_np: Mapping, cfg: MMDiTConfig) -> dict:
    """The JAX MMDiT tree (the first depth-1 blocks stacked, `final_block`
    apart) -> port params."""
    return _unstack_blocks(params_np, cfg.depth - 1)


def vocos_from_jax(params_np: Mapping, cfg) -> dict:
    """The JAX Vocos tree -> port params (same names and layouts)."""
    return to_tensors(params_np)


class _Reader:
    """Reads port params out of a reference state dict (`prefix` stripped,
    float32 numpy): Linear weights transposed, conv weights moved (out,
    in/g, k) -> (k, in/g, out), q/k projections and norms permuted into the
    half-split RoPE order for `heads` of `dim_head`."""

    def __init__(self, sd: Mapping, prefix: str, heads: int, dim_head: int):
        self.sd = {k[len(prefix):]: np.asarray(v, dtype=np.float32)
                   for k, v in sd.items() if k.startswith(prefix)}
        self.heads, self.perm = heads, half_split_perm(dim_head)

    def t(self, key, reshape=None):
        a = self.sd[key] if reshape is None else self.sd[key].reshape(reshape)
        return torch.from_numpy(np.ascontiguousarray(a))

    def lin(self, key, qk=False):
        w, b = self.sd[f"{key}.weight"].T, self.sd.get(f"{key}.bias")
        p = {"w": torch.from_numpy(np.ascontiguousarray(
            permute_qk_weight(w, self.heads) if qk else w))}
        if b is not None:
            p["b"] = torch.from_numpy(np.ascontiguousarray(
                permute_qk_bias(b, self.heads) if qk else b))
        return p

    def qk_norm(self, key):
        return {"g": torch.from_numpy(np.ascontiguousarray(self.sd[key][self.perm]))}

    def conv(self, key):
        return {"w": torch.from_numpy(np.ascontiguousarray(
            self.sd[f"{key}.weight"].transpose(2, 1, 0))), "b": self.t(f"{key}.bias")}

    def count(self, pattern):
        return len({m.group(1) for k in self.sd if (m := re.match(pattern, k))})

    def depth(self, pattern, want: int) -> int:
        depth = self.count(pattern)
        if depth != want:
            raise ValueError(f"checkpoint depth {depth} != config depth {want}")
        return depth

    def time_embed(self):
        return {"mlp1": self.lin("time_embed.time_mlp.0"), "mlp2": self.lin("time_embed.time_mlp.2")}

    def text_embed(self):
        """The ConvNeXtV2 text embedding of the DiT and the UNetT."""
        def convnext_v2(key):
            return {"dwconv": self.conv(f"{key}.dwconv"),
                    "norm": {"g": self.t(f"{key}.norm.weight"), "b": self.t(f"{key}.norm.bias")},
                    "pwconv1": self.lin(f"{key}.pwconv1"),
                    "grn": {"gamma": self.t(f"{key}.grn.gamma", -1),
                            "beta": self.t(f"{key}.grn.beta", -1)},
                    "pwconv2": self.lin(f"{key}.pwconv2")}

        return {"embed": {"w": self.t("text_embed.text_embed.weight")},
                "blocks": [convnext_v2(f"text_embed.text_blocks.{i}")
                           for i in range(self.count(r"text_embed\.text_blocks\.(\d+)\."))]}

    def input_embed(self, name="input_embed", proj="proj"):
        return {"proj": self.lin(f"{name}.{proj}"),
                "conv1": self.conv(f"{name}.conv_pos_embed.conv1d.0"),
                "conv2": self.conv(f"{name}.conv_pos_embed.conv1d.2")}


class _Writer:
    """Writes port params into a reference-layout state dict of contiguous
    fp32 CPU tensors: the inverse of `_Reader`."""

    def __init__(self, prefix: str, heads: int, dim_head: int):
        self.out: Dict[str, torch.Tensor] = {}
        self.prefix, self.heads = prefix, heads
        self.inv_perm = np.argsort(half_split_perm(dim_head))

    @staticmethod
    def a(t):
        return t.detach().float().cpu().numpy()

    def put(self, key, arr):
        self.out[f"{self.prefix}{key}"] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32))

    def lin(self, key, p, qk=False):
        w = unpermute_qk_weight(self.a(p["w"]), self.heads) if qk else self.a(p["w"])
        self.put(f"{key}.weight", w.T)
        if "b" in p:
            b = self.a(p["b"])
            self.put(f"{key}.bias", unpermute_qk_bias(b, self.heads) if qk else b)

    def qk_norm(self, key, p):
        self.put(key, self.a(p["g"])[self.inv_perm])

    def conv(self, key, p):
        self.put(f"{key}.weight", self.a(p["w"]).transpose(2, 1, 0))
        self.put(f"{key}.bias", self.a(p["b"]))

    def time_embed(self, p):
        self.lin("time_embed.time_mlp.0", p["mlp1"])
        self.lin("time_embed.time_mlp.2", p["mlp2"])

    def text_embed(self, p):
        self.put("text_embed.text_embed.weight", self.a(p["embed"]["w"]))
        for i, blk in enumerate(p.get("blocks", [])):
            k = f"text_embed.text_blocks.{i}"
            self.conv(f"{k}.dwconv", blk["dwconv"])
            self.put(f"{k}.norm.weight", self.a(blk["norm"]["g"]))
            self.put(f"{k}.norm.bias", self.a(blk["norm"]["b"]))
            self.lin(f"{k}.pwconv1", blk["pwconv1"])
            self.put(f"{k}.grn.gamma", self.a(blk["grn"]["gamma"]).reshape(1, 1, -1))
            self.put(f"{k}.grn.beta", self.a(blk["grn"]["beta"]).reshape(1, 1, -1))
            self.lin(f"{k}.pwconv2", blk["pwconv2"])

    def input_embed(self, p, name="input_embed", proj="proj"):
        self.lin(f"{name}.{proj}", p["proj"])
        self.conv(f"{name}.conv_pos_embed.conv1d.0", p["conv1"])
        self.conv(f"{name}.conv_pos_embed.conv1d.2", p["conv2"])


def _split_qkv(attn: Mapping) -> Mapping:
    """An attention dict with a fused `to_qkv` split back into to_q/to_k/to_v."""
    if "to_qkv" not in attn:
        return attn
    ws = attn["to_qkv"]["w"].chunk(3, dim=-1)
    bs = attn["to_qkv"]["b"].chunk(3, dim=-1) if "b" in attn["to_qkv"] else None
    return {**attn, **{name: {"w": ws[j], **({"b": bs[j]} if bs else {})}
                       for j, name in enumerate(("to_q", "to_k", "to_v"))}}


# the PPG embedding's Sequential (reference dit.py:121-138): Linear 0; Conv1d
# 2 / 6 / 10, each followed by its BatchNorm1d 3 / 7 / 11; Linear 15
_PPG_CONVS, _PPG_BNS = (2, 6, 10), (3, 7, 11)


def dit_from_reference_state_dict(sd: Mapping, cfg: DiTConfig, prefix: str = "transformer.") -> dict:
    """A reference F5-TTS DiT state dict (numpy arrays or tensors) -> port params.

    Key names follow the reference module tree (dit.py:183-271,
    modules.py:610-641). to_q/to_k and q_norm/k_norm are permuted into the
    half-split RoPE order.
    A PPG DiT returns (params, state): the PPG embedding
    (`ppg_embed.ppg_proj.*`) and its BatchNorms' running statistics (count
    0: the reference keeps num_batches_tracked, which the loaders drop). A
    codebook's `quantizer.vars` and `quantizer.weight_proj` (one Linear, or
    a Sequential of them with GELUs between) load in order
    (f5e_tts_tpu/utils/torch_ckpt.py:114-130, 182-192).
    """
    r = _Reader(sd, prefix, cfg.heads, cfg.dim_head)
    blocks = []
    for i in range(r.depth(r"transformer_blocks\.(\d+)\.", cfg.depth)):
        b = f"transformer_blocks.{i}"
        attn = {"to_q": r.lin(f"{b}.attn.to_q", qk=True), "to_k": r.lin(f"{b}.attn.to_k", qk=True),
                "to_v": r.lin(f"{b}.attn.to_v"), "to_out": r.lin(f"{b}.attn.to_out.0")}
        if cfg.qk_norm == "rms_norm":
            attn["q_norm"] = r.qk_norm(f"{b}.attn.q_norm.weight")
            attn["k_norm"] = r.qk_norm(f"{b}.attn.k_norm.weight")
        # FeedForward: Sequential(Sequential(Linear, GELU), Dropout, Linear)
        blocks.append({"attn_norm": r.lin(f"{b}.attn_norm.linear"), "attn": attn,
                       "ff1": r.lin(f"{b}.ff.ff.0.0"), "ff2": r.lin(f"{b}.ff.ff.2")})
    params = {"time_embed": r.time_embed(), "text_embed": r.text_embed()}
    state = {}
    if cfg.ppg.use_ppg:
        k = "ppg_embed.ppg_proj"
        params["ppg_embed"] = {
            "pre": r.lin(f"{k}.0"), "convs": [r.conv(f"{k}.{i}") for i in _PPG_CONVS],
            "bns": [{"g": r.t(f"{k}.{i}.weight"), "b": r.t(f"{k}.{i}.bias")} for i in _PPG_BNS],
            "post": r.lin(f"{k}.15")}
        state["ppg_bn"] = [{"mean": r.t(f"{k}.{i}.running_mean"),
                            "var": r.t(f"{k}.{i}.running_var"),
                            "count": torch.zeros((), dtype=torch.int32)} for i in _PPG_BNS]
    params["input_embed"] = r.input_embed()
    params["blocks"] = blocks
    if cfg.long_skip_connection:
        params["long_skip"] = r.lin("long_skip_connection")
    params["norm_out"] = r.lin("norm_out.linear")
    params["proj_out"] = r.lin("proj_out")
    if cfg.codebook.use_codebook:
        if "quantizer.weight_proj.weight" in r.sd:
            layers = [r.lin("quantizer.weight_proj")]
        else:
            found = (re.match(r"quantizer\.weight_proj\.(\d+)\.", key) for key in r.sd)
            layers = [r.lin(f"quantizer.weight_proj.{i}")
                      for i in sorted({int(m.group(1)) for m in found if m})]
        params["quantizer"] = {"vars": r.t("quantizer.vars"),
                               "weight_proj": {f"layer_{j}": p for j, p in enumerate(layers)}}
    return (params, state) if cfg.ppg.use_ppg else params


def dit_to_reference_state_dict(params: Mapping, cfg: DiTConfig, prefix: str = "transformer.",
                                state: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Port DiT params (and a PPG DiT's `state`) -> a reference-layout state
    dict of contiguous fp32 CPU tensors (the inverse of
    `dit_from_reference_state_dict`; the port's copy of torch_ckpt.py:
    dit_to_torch, :531-546). A fused `to_qkv` is split back into
    to_q/to_k/to_v; to_q/to_k and q_norm/k_norm go back to the reference's
    interleaved RoPE order."""
    w = _Writer(prefix, cfg.heads, cfg.dim_head)
    w.time_embed(params["time_embed"])
    w.text_embed(params["text_embed"])
    if "ppg_embed" in params:
        if not state:
            raise ValueError("a PPG DiT exports with its BatchNorm state (state=)")
        k, pe = "ppg_embed.ppg_proj", params["ppg_embed"]
        w.lin(f"{k}.0", pe["pre"])
        for j, i in enumerate(_PPG_CONVS):
            w.conv(f"{k}.{i}", pe["convs"][j])
        for j, i in enumerate(_PPG_BNS):
            w.put(f"{k}.{i}.weight", w.a(pe["bns"][j]["g"]))
            w.put(f"{k}.{i}.bias", w.a(pe["bns"][j]["b"]))
            w.put(f"{k}.{i}.running_mean", w.a(state["ppg_bn"][j]["mean"]))
            w.put(f"{k}.{i}.running_var", w.a(state["ppg_bn"][j]["var"]))
        w.lin(f"{k}.15", pe["post"])
    w.input_embed(params["input_embed"])
    for i, blk in enumerate(params["blocks"]):
        b = f"transformer_blocks.{i}"
        attn = _split_qkv(blk["attn"])
        w.lin(f"{b}.attn_norm.linear", blk["attn_norm"])
        w.lin(f"{b}.attn.to_q", attn["to_q"], qk=True)
        w.lin(f"{b}.attn.to_k", attn["to_k"], qk=True)
        w.lin(f"{b}.attn.to_v", attn["to_v"])
        w.lin(f"{b}.attn.to_out.0", attn["to_out"])
        w.lin(f"{b}.ff.ff.0.0", blk["ff1"])
        w.lin(f"{b}.ff.ff.2", blk["ff2"])
        if "q_norm" in attn:
            w.qk_norm(f"{b}.attn.q_norm.weight", attn["q_norm"])
            w.qk_norm(f"{b}.attn.k_norm.weight", attn["k_norm"])
    if cfg.long_skip_connection:
        w.lin("long_skip_connection", params["long_skip"])
    w.lin("norm_out.linear", params["norm_out"])
    w.lin("proj_out", params["proj_out"])
    if "quantizer" in params:
        q = params["quantizer"]
        w.put("quantizer.vars", w.a(q["vars"]))
        layers = sorted(q["weight_proj"], key=lambda s: int(s.split("_")[1]))
        if len(layers) == 1:
            w.lin("quantizer.weight_proj", q["weight_proj"][layers[0]])
        else:  # Sequential(Linear, GELU, ..., Linear): the linears at 0, 2, 4, ...
            for j, name in enumerate(layers):
                w.lin(f"quantizer.weight_proj.{2 * j}", q["weight_proj"][name])
    return w.out


_MMDIT_PROJ = ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c")  # in init_mmdit's order
_MMDIT_QK = ("to_q", "to_k", "to_q_c", "to_k_c")
_MMDIT_QK_NORMS = ("q_norm", "k_norm", "c_q_norm", "c_k_norm")


def mmdit_from_reference_state_dict(sd: Mapping, cfg: MMDiTConfig,
                                    prefix: str = "transformer.") -> dict:
    """A reference F5-TTS MMDiT state dict (numpy arrays or tensors) -> port
    params. Key names follow the reference module tree (mmdit.py:84-126,
    modules.py:647-685): transformer_blocks.{i}.{attn_norm_x,attn_norm_c}
    .linear, .attn.to_*_c, .ff_x/.ff_c; the last block is context_pre_only
    (2-chunk attn_norm_c, no ff_c, no to_out_c). q/k projections and norms of
    both streams are permuted into the half-split RoPE order."""
    r = _Reader(sd, prefix, cfg.heads, cfg.dim_head)
    depth = r.depth(r"transformer_blocks\.(\d+)\.", cfg.depth)

    def block(i, pre_only):
        b = f"transformer_blocks.{i}"
        attn = {name: r.lin(f"{b}.attn.{name}", qk=name in _MMDIT_QK) for name in _MMDIT_PROJ}
        attn["to_out"] = r.lin(f"{b}.attn.to_out.0")
        blk = {"attn_norm_x": r.lin(f"{b}.attn_norm_x.linear"),
               "attn_norm_c": r.lin(f"{b}.attn_norm_c.linear"), "attn": attn,
               "ff1_x": r.lin(f"{b}.ff_x.ff.0.0"), "ff2_x": r.lin(f"{b}.ff_x.ff.2")}
        if not pre_only:
            attn["to_out_c"] = r.lin(f"{b}.attn.to_out_c")
            blk["ff1_c"] = r.lin(f"{b}.ff_c.ff.0.0")
            blk["ff2_c"] = r.lin(f"{b}.ff_c.ff.2")
        if cfg.qk_norm == "rms_norm":
            for name in _MMDIT_QK_NORMS:
                attn[name] = r.qk_norm(f"{b}.attn.{name}.weight")
        return blk

    return {
        "time_embed": r.time_embed(),
        "text_embed": {"embed": {"w": r.t("text_embed.text_embed.weight")}},
        "audio_embed": r.input_embed("audio_embed", "linear"),
        "blocks": [block(i, False) for i in range(depth - 1)],
        "final_block": block(depth - 1, True),
        "norm_out": r.lin("norm_out.linear"),
        "proj_out": r.lin("proj_out"),
    }


def mmdit_to_reference_state_dict(params: Mapping, cfg: MMDiTConfig,
                                  prefix: str = "transformer.") -> Dict[str, torch.Tensor]:
    """Port MMDiT params -> a reference-layout state dict of contiguous fp32
    CPU tensors (the inverse of `mmdit_from_reference_state_dict`)."""
    w = _Writer(prefix, cfg.heads, cfg.dim_head)
    w.time_embed(params["time_embed"])
    w.text_embed(params["text_embed"])
    w.input_embed(params["audio_embed"], "audio_embed", "linear")
    for i, blk in enumerate([*params["blocks"], params["final_block"]]):
        b = f"transformer_blocks.{i}"
        attn = blk["attn"]
        w.lin(f"{b}.attn_norm_x.linear", blk["attn_norm_x"])
        w.lin(f"{b}.attn_norm_c.linear", blk["attn_norm_c"])
        for name in _MMDIT_PROJ:
            w.lin(f"{b}.attn.{name}", attn[name], qk=name in _MMDIT_QK)
        w.lin(f"{b}.attn.to_out.0", attn["to_out"])
        w.lin(f"{b}.ff_x.ff.0.0", blk["ff1_x"])
        w.lin(f"{b}.ff_x.ff.2", blk["ff2_x"])
        if "to_out_c" in attn:  # every block but the context_pre_only last one
            w.lin(f"{b}.attn.to_out_c", attn["to_out_c"])
            w.lin(f"{b}.ff_c.ff.0.0", blk["ff1_c"])
            w.lin(f"{b}.ff_c.ff.2", blk["ff2_c"])
        for name in _MMDIT_QK_NORMS:
            if name in attn:
                w.qk_norm(f"{b}.attn.{name}.weight", attn[name])
    w.lin("norm_out.linear", params["norm_out"])
    w.lin("proj_out", params["proj_out"])
    return w.out


def unett_from_reference_state_dict(sd: Mapping, cfg: UNetTConfig,
                                    prefix: str = "transformer.") -> dict:
    """A reference E2-TTS UNetT state dict (numpy arrays or tensors) -> port
    params (the port's copy of f5e_tts_tpu/utils/torch_ckpt.py:
    unett_from_torch). Key names follow the reference module tree
    (unett.py:106-250): layers.{i} is a ModuleList [skip_proj, attn_norm
    (RMSNorm .g), attn, ff_norm, ff], skip_proj only in the second half and
    only with concat skips. to_q/to_k are permuted into the half-split RoPE
    order, as the DiT loader permutes them."""
    r = _Reader(sd, prefix, cfg.heads, cfg.dim_head)
    half = r.depth(r"layers\.(\d+)\.", cfg.depth) // 2

    def layer(i):
        base = f"layers.{i}"
        p = {"attn_norm": {"g": r.t(f"{base}.1.g")},
             "attn": {"to_q": r.lin(f"{base}.2.to_q", qk=True),
                      "to_k": r.lin(f"{base}.2.to_k", qk=True),
                      "to_v": r.lin(f"{base}.2.to_v"), "to_out": r.lin(f"{base}.2.to_out.0")},
             "ff_norm": {"g": r.t(f"{base}.3.g")},
             "ff1": r.lin(f"{base}.4.ff.0.0"), "ff2": r.lin(f"{base}.4.ff.2")}
        if f"{base}.0.weight" in r.sd:
            p["skip_proj"] = r.lin(f"{base}.0")
        return p

    return {"time_embed": r.time_embed(), "text_embed": r.text_embed(),
            "input_embed": r.input_embed(),
            "first_half": [layer(i) for i in range(half)],
            "second_half": [layer(half + i) for i in range(half)],
            "norm_out": {"g": r.t("norm_out.g")}, "proj_out": r.lin("proj_out")}


def unett_to_reference_state_dict(params: Mapping, cfg: UNetTConfig,
                                  prefix: str = "transformer.") -> Dict[str, torch.Tensor]:
    """Port UNetT params -> a reference-layout state dict of contiguous fp32
    CPU tensors (the inverse of `unett_from_reference_state_dict`; the port's
    copy of torch_ckpt.py: unett_to_torch). A fused `to_qkv` is split back."""
    w = _Writer(prefix, cfg.heads, cfg.dim_head)
    w.time_embed(params["time_embed"])
    w.text_embed(params["text_embed"])
    w.input_embed(params["input_embed"])
    for i, layer in enumerate([*params["first_half"], *params["second_half"]]):
        base = f"layers.{i}"
        attn = _split_qkv(layer["attn"])
        w.put(f"{base}.1.g", w.a(layer["attn_norm"]["g"]))
        w.lin(f"{base}.2.to_q", attn["to_q"], qk=True)
        w.lin(f"{base}.2.to_k", attn["to_k"], qk=True)
        w.lin(f"{base}.2.to_v", attn["to_v"])
        w.lin(f"{base}.2.to_out.0", attn["to_out"])
        w.put(f"{base}.3.g", w.a(layer["ff_norm"]["g"]))
        w.lin(f"{base}.4.ff.0.0", layer["ff1"])
        w.lin(f"{base}.4.ff.2", layer["ff2"])
        if "skip_proj" in layer:
            w.lin(f"{base}.0", layer["skip_proj"])
    w.put("norm_out.g", w.a(params["norm_out"]["g"]))
    w.lin("proj_out", params["proj_out"])
    return w.out


def backbone_from_reference_state_dict(sd: Mapping, arch, prefix: str = "transformer."):
    """Reference state dict -> port params of the backbone `arch` configures
    (torch_ckpt.py:447-458); (params, state) for a PPG DiT."""
    if isinstance(arch, UNetTConfig):
        return unett_from_reference_state_dict(sd, arch, prefix)
    if isinstance(arch, MMDiTConfig):
        return mmdit_from_reference_state_dict(sd, arch, prefix)
    if isinstance(arch, DiTConfig):
        return dit_from_reference_state_dict(sd, arch, prefix)
    raise NotImplementedError(f"no reference loader for {type(arch).__name__}")


def backbone_to_reference_state_dict(params: Mapping, arch, prefix: str = "transformer.",
                                     state: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Port params (and a PPG DiT's `state`) of the backbone `arch`
    configures -> reference state dict."""
    if isinstance(arch, UNetTConfig):
        return unett_to_reference_state_dict(params, arch, prefix)
    if isinstance(arch, MMDiTConfig):
        return mmdit_to_reference_state_dict(params, arch, prefix)
    if isinstance(arch, DiTConfig):
        return dit_to_reference_state_dict(params, arch, prefix, state)
    raise NotImplementedError(f"no reference export for {type(arch).__name__}")


def load_state_dict(path: str, use_ema: bool = True) -> Dict[str, np.ndarray]:
    """A reference checkpoint (.safetensors EMA export or .pt training dict)
    as a flat {key: float32 numpy array} dict, EMA prefix stripped."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
        if use_ema:
            sd = {k.replace("ema_model.", ""): v for k, v in sd.items()}
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if use_ema and "ema_model_state_dict" in ckpt:
            sd = {k.replace("ema_model.", ""): v for k, v in ckpt["ema_model_state_dict"].items()}
        else:
            sd = ckpt.get("model_state_dict", ckpt)
    return {k: np.asarray(torch.as_tensor(v).float().numpy()) for k, v in sd.items()
            if k not in _DROP_KEYS and not k.endswith("num_batches_tracked")}
