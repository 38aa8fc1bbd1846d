"""Weight converters into the port's parameter dicts.

- `dit_from_jax` / `mmdit_from_jax` / `vocos_from_jax`: the JAX package's
  parameter trees, given as nested dicts of numpy arrays. The port keeps the
  JAX layouts (linear (in, out), conv (k, in/groups, out)) and the JAX q/k
  feature order, so this is a plain copy; only the depth-stacked block arrays
  are split into a list of per-block dicts.
- `dit_from_reference_state_dict` / `mmdit_from_reference_state_dict`: a
  reference-layout F5-TTS state dict (`transformer.*` keys, torch layouts).
  Linear weights are transposed and conv weights moved (out, in/g, k) ->
  (k, in/g, out).
- `dit_to_reference_state_dict` / `mmdit_to_reference_state_dict`: their
  inverses, the export the trainer's checkpoints carry (the port's copies of
  f5e_tts_tpu/utils/torch_ckpt.py: dit_to_torch and mmdit_to_torch);
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
from typing import Dict, Mapping

import numpy as np
import torch

from f5e_tts_tpu_torch.config import DiTConfig, MMDiTConfig
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


def _unstack_blocks(params_np: Mapping, count: int) -> dict:
    """A JAX tree whose `blocks` arrays are stacked on a leading axis of
    `count` -> tensors, with `blocks` a list of `count` per-block dicts."""
    tree = to_tensors(params_np)
    stacked = tree["blocks"]

    def block(i, node):
        if isinstance(node, Mapping):
            return {k: block(i, v) for k, v in node.items()}
        return node[i].clone()

    return {**tree, "blocks": [block(i, stacked) for i in range(count)]}


def dit_from_jax(params_np: Mapping, cfg: DiTConfig) -> dict:
    """The JAX DiT tree (blocks stacked on a leading depth axis) -> port params."""
    return _unstack_blocks(params_np, cfg.depth)


def mmdit_from_jax(params_np: Mapping, cfg: MMDiTConfig) -> dict:
    """The JAX MMDiT tree (the first depth-1 blocks stacked, `final_block`
    apart) -> port params."""
    return _unstack_blocks(params_np, cfg.depth - 1)


def vocos_from_jax(params_np: Mapping, cfg) -> dict:
    """The JAX Vocos tree -> port params (same names and layouts)."""
    return to_tensors(params_np)


def dit_from_reference_state_dict(sd: Mapping, cfg: DiTConfig, prefix: str = "transformer.") -> dict:
    """A reference F5-TTS DiT state dict (numpy arrays or tensors) -> port params.

    Key names follow the reference module tree (dit.py:183-271,
    modules.py:610-641). to_q/to_k and q_norm/k_norm are permuted into the
    half-split RoPE order.
    """
    if cfg.ppg.use_ppg or cfg.codebook.use_codebook or cfg.long_skip_connection:
        raise NotImplementedError("PPG, codebook and long-skip DiTs are not ported yet")
    sd = {k[len(prefix):]: np.asarray(v, dtype=np.float32)
          for k, v in sd.items() if k.startswith(prefix)}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def lin(key):
        p = {"w": t(sd[f"{key}.weight"].T)}
        if f"{key}.bias" in sd:
            p["b"] = t(sd[f"{key}.bias"])
        return p

    def qk_lin(key):
        p = {"w": t(permute_qk_weight(sd[f"{key}.weight"].T, cfg.heads))}
        if f"{key}.bias" in sd:
            p["b"] = t(permute_qk_bias(sd[f"{key}.bias"], cfg.heads))
        return p

    def conv(key):
        return {"w": t(sd[f"{key}.weight"].transpose(2, 1, 0)), "b": t(sd[f"{key}.bias"])}

    def convnext_v2(key):
        return {
            "dwconv": conv(f"{key}.dwconv"),
            "norm": {"g": t(sd[f"{key}.norm.weight"]), "b": t(sd[f"{key}.norm.bias"])},
            "pwconv1": lin(f"{key}.pwconv1"),
            "grn": {"gamma": t(sd[f"{key}.grn.gamma"].reshape(-1)),
                    "beta": t(sd[f"{key}.grn.beta"].reshape(-1))},
            "pwconv2": lin(f"{key}.pwconv2"),
        }

    def count(pattern):
        return len({m.group(1) for k in sd if (m := re.match(pattern, k))})

    depth = count(r"transformer_blocks\.(\d+)\.")
    if depth != cfg.depth:
        raise ValueError(f"checkpoint depth {depth} != config depth {cfg.depth}")
    perm = half_split_perm(cfg.dim_head)
    blocks = []
    for i in range(depth):
        b = f"transformer_blocks.{i}"
        attn = {"to_q": qk_lin(f"{b}.attn.to_q"), "to_k": qk_lin(f"{b}.attn.to_k"),
                "to_v": lin(f"{b}.attn.to_v"), "to_out": lin(f"{b}.attn.to_out.0")}
        if cfg.qk_norm == "rms_norm":
            attn["q_norm"] = {"g": t(sd[f"{b}.attn.q_norm.weight"][perm])}
            attn["k_norm"] = {"g": t(sd[f"{b}.attn.k_norm.weight"][perm])}
        # FeedForward: Sequential(Sequential(Linear, GELU), Dropout, Linear)
        blocks.append({"attn_norm": lin(f"{b}.attn_norm.linear"), "attn": attn,
                       "ff1": lin(f"{b}.ff.ff.0.0"), "ff2": lin(f"{b}.ff.ff.2")})
    return {
        "time_embed": {"mlp1": lin("time_embed.time_mlp.0"), "mlp2": lin("time_embed.time_mlp.2")},
        "text_embed": {
            "embed": {"w": t(sd["text_embed.text_embed.weight"])},
            "blocks": [convnext_v2(f"text_embed.text_blocks.{i}")
                       for i in range(count(r"text_embed\.text_blocks\.(\d+)\."))],
        },
        "input_embed": {"proj": lin("input_embed.proj"),
                        "conv1": conv("input_embed.conv_pos_embed.conv1d.0"),
                        "conv2": conv("input_embed.conv_pos_embed.conv1d.2")},
        "blocks": blocks,
        "norm_out": lin("norm_out.linear"),
        "proj_out": lin("proj_out"),
    }


def dit_to_reference_state_dict(params: Mapping, cfg: DiTConfig,
                                prefix: str = "transformer.") -> Dict[str, torch.Tensor]:
    """Port DiT params -> a reference-layout state dict of contiguous fp32 CPU
    tensors (the inverse of `dit_from_reference_state_dict`). A fused
    `to_qkv` is split back into to_q/to_k/to_v; to_q/to_k and q_norm/k_norm
    go back to the reference's interleaved RoPE order."""
    if cfg.ppg.use_ppg or cfg.codebook.use_codebook or cfg.long_skip_connection:
        raise NotImplementedError("PPG, codebook and long-skip DiTs are not ported yet")
    out: Dict[str, torch.Tensor] = {}

    def a(t):
        return t.detach().float().cpu().numpy()

    def put(key, arr):
        out[f"{prefix}{key}"] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))

    def lin(key, p, qk=False):
        w = unpermute_qk_weight(a(p["w"]), cfg.heads) if qk else a(p["w"])
        put(f"{key}.weight", w.T)
        if "b" in p:
            put(f"{key}.bias", unpermute_qk_bias(a(p["b"]), cfg.heads) if qk else a(p["b"]))

    def conv(key, p):
        put(f"{key}.weight", a(p["w"]).transpose(2, 1, 0))
        put(f"{key}.bias", a(p["b"]))

    lin("time_embed.time_mlp.0", params["time_embed"]["mlp1"])
    lin("time_embed.time_mlp.2", params["time_embed"]["mlp2"])
    put("text_embed.text_embed.weight", a(params["text_embed"]["embed"]["w"]))
    for i, blk in enumerate(params["text_embed"]["blocks"]):
        k = f"text_embed.text_blocks.{i}"
        conv(f"{k}.dwconv", blk["dwconv"])
        put(f"{k}.norm.weight", a(blk["norm"]["g"]))
        put(f"{k}.norm.bias", a(blk["norm"]["b"]))
        lin(f"{k}.pwconv1", blk["pwconv1"])
        put(f"{k}.grn.gamma", a(blk["grn"]["gamma"]).reshape(1, 1, -1))
        put(f"{k}.grn.beta", a(blk["grn"]["beta"]).reshape(1, 1, -1))
        lin(f"{k}.pwconv2", blk["pwconv2"])
    lin("input_embed.proj", params["input_embed"]["proj"])
    conv("input_embed.conv_pos_embed.conv1d.0", params["input_embed"]["conv1"])
    conv("input_embed.conv_pos_embed.conv1d.2", params["input_embed"]["conv2"])

    inv_perm = np.argsort(half_split_perm(cfg.dim_head))
    for i, blk in enumerate(params["blocks"]):
        b = f"transformer_blocks.{i}"
        attn = blk["attn"]
        if "to_qkv" in attn:
            ws = attn["to_qkv"]["w"].chunk(3, dim=-1)
            bs = attn["to_qkv"]["b"].chunk(3, dim=-1) if "b" in attn["to_qkv"] else None
            attn = {**attn, **{name: {"w": ws[j], **({"b": bs[j]} if bs else {})}
                               for j, name in enumerate(("to_q", "to_k", "to_v"))}}
        lin(f"{b}.attn_norm.linear", blk["attn_norm"])
        lin(f"{b}.attn.to_q", attn["to_q"], qk=True)
        lin(f"{b}.attn.to_k", attn["to_k"], qk=True)
        lin(f"{b}.attn.to_v", attn["to_v"])
        lin(f"{b}.attn.to_out.0", attn["to_out"])
        lin(f"{b}.ff.ff.0.0", blk["ff1"])
        lin(f"{b}.ff.ff.2", blk["ff2"])
        if "q_norm" in attn:
            put(f"{b}.attn.q_norm.weight", a(attn["q_norm"]["g"])[inv_perm])
            put(f"{b}.attn.k_norm.weight", a(attn["k_norm"]["g"])[inv_perm])
    lin("norm_out.linear", params["norm_out"])
    lin("proj_out", params["proj_out"])
    return out


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
    sd = {k[len(prefix):]: np.asarray(v, dtype=np.float32)
          for k, v in sd.items() if k.startswith(prefix)}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def lin(key, qk=False):
        w = sd[f"{key}.weight"].T
        p = {"w": t(permute_qk_weight(w, cfg.heads) if qk else w)}
        if f"{key}.bias" in sd:
            b = sd[f"{key}.bias"]
            p["b"] = t(permute_qk_bias(b, cfg.heads) if qk else b)
        return p

    def conv(key):
        return {"w": t(sd[f"{key}.weight"].transpose(2, 1, 0)), "b": t(sd[f"{key}.bias"])}

    depth = len({m.group(1) for k in sd if (m := re.match(r"transformer_blocks\.(\d+)\.", k))})
    if depth != cfg.depth:
        raise ValueError(f"checkpoint depth {depth} != config depth {cfg.depth}")
    perm = half_split_perm(cfg.dim_head)

    def block(i, pre_only):
        b = f"transformer_blocks.{i}"
        attn = {name: lin(f"{b}.attn.{name}", qk=name in _MMDIT_QK)
                for name in _MMDIT_PROJ}
        attn["to_out"] = lin(f"{b}.attn.to_out.0")
        blk = {"attn_norm_x": lin(f"{b}.attn_norm_x.linear"),
               "attn_norm_c": lin(f"{b}.attn_norm_c.linear"), "attn": attn,
               "ff1_x": lin(f"{b}.ff_x.ff.0.0"), "ff2_x": lin(f"{b}.ff_x.ff.2")}
        if not pre_only:
            attn["to_out_c"] = lin(f"{b}.attn.to_out_c")
            blk["ff1_c"] = lin(f"{b}.ff_c.ff.0.0")
            blk["ff2_c"] = lin(f"{b}.ff_c.ff.2")
        if cfg.qk_norm == "rms_norm":
            for name in _MMDIT_QK_NORMS:
                attn[name] = {"g": t(sd[f"{b}.attn.{name}.weight"][perm])}
        return blk

    return {
        "time_embed": {"mlp1": lin("time_embed.time_mlp.0"), "mlp2": lin("time_embed.time_mlp.2")},
        "text_embed": {"embed": {"w": t(sd["text_embed.text_embed.weight"])}},
        "audio_embed": {"proj": lin("audio_embed.linear"),
                        "conv1": conv("audio_embed.conv_pos_embed.conv1d.0"),
                        "conv2": conv("audio_embed.conv_pos_embed.conv1d.2")},
        "blocks": [block(i, False) for i in range(depth - 1)],
        "final_block": block(depth - 1, True),
        "norm_out": lin("norm_out.linear"),
        "proj_out": lin("proj_out"),
    }


def mmdit_to_reference_state_dict(params: Mapping, cfg: MMDiTConfig,
                                  prefix: str = "transformer.") -> Dict[str, torch.Tensor]:
    """Port MMDiT params -> a reference-layout state dict of contiguous fp32
    CPU tensors (the inverse of `mmdit_from_reference_state_dict`)."""
    out: Dict[str, torch.Tensor] = {}

    def a(t):
        return t.detach().float().cpu().numpy()

    def put(key, arr):
        out[f"{prefix}{key}"] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))

    def lin(key, p, qk=False):
        w = unpermute_qk_weight(a(p["w"]), cfg.heads) if qk else a(p["w"])
        put(f"{key}.weight", w.T)
        if "b" in p:
            put(f"{key}.bias", unpermute_qk_bias(a(p["b"]), cfg.heads) if qk else a(p["b"]))

    def conv(key, p):
        put(f"{key}.weight", a(p["w"]).transpose(2, 1, 0))
        put(f"{key}.bias", a(p["b"]))

    lin("time_embed.time_mlp.0", params["time_embed"]["mlp1"])
    lin("time_embed.time_mlp.2", params["time_embed"]["mlp2"])
    put("text_embed.text_embed.weight", a(params["text_embed"]["embed"]["w"]))
    lin("audio_embed.linear", params["audio_embed"]["proj"])
    conv("audio_embed.conv_pos_embed.conv1d.0", params["audio_embed"]["conv1"])
    conv("audio_embed.conv_pos_embed.conv1d.2", params["audio_embed"]["conv2"])

    inv_perm = np.argsort(half_split_perm(cfg.dim_head))
    for i, blk in enumerate([*params["blocks"], params["final_block"]]):
        b = f"transformer_blocks.{i}"
        attn = blk["attn"]
        lin(f"{b}.attn_norm_x.linear", blk["attn_norm_x"])
        lin(f"{b}.attn_norm_c.linear", blk["attn_norm_c"])
        for name in _MMDIT_PROJ:
            lin(f"{b}.attn.{name}", attn[name], qk=name in _MMDIT_QK)
        lin(f"{b}.attn.to_out.0", attn["to_out"])
        lin(f"{b}.ff_x.ff.0.0", blk["ff1_x"])
        lin(f"{b}.ff_x.ff.2", blk["ff2_x"])
        if "to_out_c" in attn:  # every block but the context_pre_only last one
            lin(f"{b}.attn.to_out_c", attn["to_out_c"])
            lin(f"{b}.ff_c.ff.0.0", blk["ff1_c"])
            lin(f"{b}.ff_c.ff.2", blk["ff2_c"])
        for name in _MMDIT_QK_NORMS:
            if name in attn:
                put(f"{b}.attn.{name}.weight", a(attn[name]["g"])[inv_perm])
    lin("norm_out.linear", params["norm_out"])
    lin("proj_out", params["proj_out"])
    return out


def backbone_from_reference_state_dict(sd: Mapping, arch, prefix: str = "transformer.") -> dict:
    """Reference state dict -> port params of the backbone `arch` configures."""
    if isinstance(arch, MMDiTConfig):
        return mmdit_from_reference_state_dict(sd, arch, prefix)
    if isinstance(arch, DiTConfig):
        return dit_from_reference_state_dict(sd, arch, prefix)
    raise NotImplementedError(f"no reference loader for {type(arch).__name__}")


def backbone_to_reference_state_dict(params: Mapping, arch,
                                     prefix: str = "transformer.") -> Dict[str, torch.Tensor]:
    """Port params of the backbone `arch` configures -> reference state dict."""
    if isinstance(arch, MMDiTConfig):
        return mmdit_to_reference_state_dict(params, arch, prefix)
    if isinstance(arch, DiTConfig):
        return dit_to_reference_state_dict(params, arch, prefix)
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
