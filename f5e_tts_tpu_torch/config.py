"""Configuration dataclasses, model presets and the YAML loaders (the port's
copy of `f5e_tts_tpu/config.py`).

The inference configs and the training config with its device mesh
(`MeshConfig`: data, fsdp, model, seq and pipe axes over torch.distributed's
ranks, parallel/mesh.py) and pipeline microbatching are kept; the JAX PRNG
choice for training (`prng_impl`) has no field: every draw of the port,
training's and the seeded init's as inference's, is the stream of JAX's
default threefry (ops/prng.py); "rbg", the TPU's hardware generator, has
no counterpart.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class MelConfig:
    """Log-mel frontend (reference: src/f5_tts/model/modules.py:104-143)."""

    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 100
    target_sample_rate: int = 24_000
    mel_spec_type: str = "vocos"  # "vocos" (HTK mel, center=True) | "bigvgan"


@dataclass(frozen=True)
class PPGConfig:
    """PPG conditioning path (not run by the port yet; kept so DiTConfig
    matches the reference's fields)."""

    use_ppg: bool = False
    ppg_dim: int = 256
    use_transformer: bool = False
    transformer_nhead: int = 4
    transformer_dim_feedforward: int = 1024
    transformer_dropout: float = 0.1
    transformer_num_layers: int = 2
    combined_cond_drop_prob: Tuple[float, float, float, float] = (0.3, 0.1, 0.5, 0.1)
    use_cross_mask: bool = False
    cross_mask_prob: float = 0.5
    frame_length: int = 20
    mel_frame_shift: int = 10
    output_type: str = "ppg"
    map_mix_ratio: float = 1.0


@dataclass(frozen=True)
class CodebookConfig:
    """Shared Gumbel-VQ codebook (training only; kept for field parity)."""

    use_codebook: bool = False
    num_vars: int = 100
    temp_start: float = 2.0
    temp_stop: float = 0.5
    temp_decay: float = 0.999995
    groups: int = 2
    combine_groups: bool = False
    weight_proj_depth: int = 1
    weight_proj_factor: int = 1
    use_perplex_loss: bool = False
    perplex_loss_prob: float = 0.1
    perplex_loss_weight: float = 0.1
    use_align_loss: bool = False
    align_loss_weight: float = 1.0


@dataclass(frozen=True)
class DiTConfig:
    """DiT backbone (reference: src/f5_tts/model/backbones/dit.py:183-271)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_dim: int = 512
    text_mask_padding: bool = True
    qk_norm: Optional[str] = None  # None | "rms_norm"
    conv_layers: int = 4
    pe_attn_head: Optional[int] = None  # rope only on the first N heads
    long_skip_connection: bool = False
    checkpoint_activations: bool = False
    remat_policy: str = "block"
    dropout: float = 0.1
    ppg: PPGConfig = field(default_factory=PPGConfig)
    codebook: CodebookConfig = field(default_factory=CodebookConfig)
    max_pos: int = 4096  # abs/rope position table length
    scan_unroll: int = 1


@dataclass(frozen=True)
class UNetTConfig:
    """UNetT (E2-TTS flat UNet transformer) hyperparameters
    (reference: src/f5_tts/model/backbones/unett.py:106-250). The forward
    applies no dropout, as the JAX one: `dropout` is kept for field parity."""

    dim: int = 1024
    depth: int = 24
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 4
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_dim: Optional[int] = None
    text_mask_padding: bool = False
    qk_norm: Optional[str] = None
    conv_layers: int = 0
    pe_attn_head: Optional[int] = 1
    skip_connect_type: str = "concat"
    dropout: float = 0.1
    max_pos: int = 4096
    scan_unroll: int = 1


@dataclass(frozen=True)
class MMDiTConfig:
    """MMDiT (SD3-style dual stream) hyperparameters
    (reference: src/f5_tts/model/backbones/mmdit.py:84-188)."""

    dim: int = 1024
    depth: int = 8
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_depth: int = 0  # unused placeholder for parity with upstream kwargs
    qk_norm: Optional[str] = None
    dropout: float = 0.1  # kept for field parity: the MMDiT forward applies none
    max_pos: int = 4096
    scan_unroll: int = 1


@dataclass(frozen=True)
class CFMConfig:
    """Conditional flow matching (reference: src/f5_tts/model/cfm.py:34-87)."""

    sigma: float = 0.0
    audio_drop_prob: float = 0.3
    cond_drop_prob: float = 0.2
    frac_lengths_mask: Tuple[float, float] = (0.7, 1.0)
    ode_method: str = "euler"  # "euler" | "midpoint"
    ode_unroll: int = 1


@dataclass(frozen=True)
class InferConfig:
    """Inference defaults (reference: src/f5_tts/infer/utils_infer.py:49-62)."""

    nfe_steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float = -1.0
    speed: float = 1.0
    max_duration: int = 4096
    cross_fade_duration: float = 0.15
    target_rms: float = 0.1


@dataclass(frozen=True)
class MeshConfig:
    """The mesh's axes over the world's ranks (f5e_tts_tpu/config.py:
    MeshConfig): data = DP, fsdp = ZeRO-3-style fully sharded DP (the DiT's
    block matrices, their gradients, AdamW moments and EMA split over it,
    all-gathered per block), model = TP, seq = sequence parallelism (ring
    attention), pipe = GPipe stages over the DiT's depth. Batches shard
    over (data, fsdp) jointly."""

    data: int = -1  # -1: all remaining ranks
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """Training loop config (reference: src/f5_tts/model/trainer.py:25-141 and
    src/f5_tts/configs/example.yaml optim/ckpts sections); `mesh` lays the
    training out over torch.distributed's ranks (one rank by default)."""

    epochs: int = 100
    learning_rate: float = 7.5e-5
    num_warmup_updates: int = 20_000
    # `update` counts OPTIMIZER updates (micro-steps / accumulation), like the
    # reference's global_update (trainer.py:416); save cadence, EMA gating and
    # the LR schedule run in update units.
    grad_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    # 8-bit Adam moments (reference trainer.py:134-137 bnb.optim.AdamW8bit;
    # here train/adamw8bit.py, the JAX package's int8 block quantisation)
    bnb_optimizer: bool = False
    batch_size_per_device: int = 19_200
    batch_size_type: str = "frame"  # "frame" | "sample"
    max_samples: int = 64
    # EMA: ema_pytorch defaults, which the reference trainer uses unmodified
    # (trainer.py:104); see train/step.py
    ema_beta: float = 0.9999
    ema_update_after_step: int = 100
    ema_update_every: int = 10
    ema_inv_gamma: float = 1.0
    ema_power: float = 2.0 / 3.0
    ema_min_value: float = 0.0
    # GPipe microbatch count when mesh.pipe > 1 (None -> one per stage)
    pp_microbatches: Optional[int] = None
    save_per_updates: int = 50_000
    last_per_updates: int = 5_000
    keep_last_n_checkpoints: int = -1
    log_samples_per_updates: int = 10_000
    save_dir: str = "ckpts"
    logger: Optional[str] = None  # "tensorboard" | "wandb" | None
    seed: int = 666
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # numerics: fp32 master weights, matmuls in the compute dtype
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class ModelConfig:
    """Top-level bundle: backbone + mel + cfm + tokenizer."""

    name: str = "F5TTS_v1_Base"
    backbone: str = "DiT"  # "DiT" | "UNetT" | "MMDiT"; `arch` is its config
    tokenizer: str = "pinyin"
    tokenizer_path: Optional[str] = None
    vocab_size: int = 2545  # F5TTS_v1_Base vocab.txt size
    arch: Any = field(default_factory=DiTConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    cfm: CFMConfig = field(default_factory=CFMConfig)
    infer: InferConfig = field(default_factory=InferConfig)


def preset(name: str) -> ModelConfig:
    """Architecture presets (reference: src/f5_tts/train/finetune_cli.py:88-139)."""
    if name == "F5TTS_v1_Base":
        return ModelConfig(
            name=name, backbone="DiT",
            arch=DiTConfig(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512, conv_layers=4),
        )
    if name == "F5TTS_Base":
        return ModelConfig(
            name=name, backbone="DiT",
            arch=DiTConfig(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
                           text_mask_padding=False, conv_layers=4, pe_attn_head=1),
        )
    if name == "F5TTS_Small":
        return ModelConfig(
            name=name, backbone="DiT",
            arch=DiTConfig(dim=768, depth=18, heads=12, ff_mult=2, text_dim=512,
                           text_mask_padding=False, conv_layers=4, pe_attn_head=1,
                           checkpoint_activations=True),
        )
    if name == "E2TTS_Base":
        return ModelConfig(
            name=name, backbone="UNetT",
            arch=UNetTConfig(dim=1024, depth=24, heads=16, ff_mult=4,
                             text_mask_padding=False, pe_attn_head=1),
        )
    raise ValueError(f"unknown preset {name!r}")


def _build(cls, data: dict):
    """Recursively build a dataclass from a plain dict, ignoring unknown keys;
    lists become tuples."""
    if not dataclasses.is_dataclass(cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            continue
        factory = fields[key].default_factory
        default = factory() if factory is not dataclasses.MISSING else None
        if isinstance(value, dict) and default is not None and dataclasses.is_dataclass(default):
            kwargs[key] = _build(type(default), value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _read_yaml(path: str) -> dict:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def load_yaml(path: str) -> ModelConfig:
    """A training/inference YAML (configs/example.yaml layout) -> ModelConfig.
    The reference's `ppg_config` / `codebook_config` keys map onto PPGConfig
    and CodebookConfig (`dim` -> `ppg_dim`, `codebook_prob` ->
    `perplex_loss_prob` with the perplexity loss on, `codebook_loss_weight`
    -> `perplex_loss_weight`), as the JAX loader maps them."""
    raw = _read_yaml(path)
    model = raw.get("model", raw)
    arch_cls = {"DiT": DiTConfig, "UNetT": UNetTConfig, "MMDiT": MMDiTConfig}[
        model.get("backbone", "DiT")]
    arch_raw = dict(model.get("arch", {}))
    if "ppg_config" in model or "use_ppg" in model:
        ppg_raw = dict(model.get("ppg_config", {}))
        ppg_raw["use_ppg"] = model.get("use_ppg", False)
        if "dim" in ppg_raw:
            ppg_raw["ppg_dim"] = ppg_raw.pop("dim")
        arch_raw["ppg"] = ppg_raw
    if "codebook_config" in model or "use_codebook" in model:
        cb_raw = dict(model.get("codebook_config", {}))
        cb_raw["use_codebook"] = model.get("use_codebook", False)
        if "codebook_prob" in cb_raw:
            cb_raw["perplex_loss_prob"] = cb_raw.pop("codebook_prob")
            cb_raw["use_perplex_loss"] = True
        if "codebook_loss_weight" in cb_raw:
            cb_raw["perplex_loss_weight"] = cb_raw.pop("codebook_loss_weight")
        arch_raw["codebook"] = cb_raw
    return ModelConfig(
        name=model.get("name", "custom"),
        backbone=model.get("backbone", "DiT"),
        tokenizer=model.get("tokenizer", "pinyin"),
        tokenizer_path=model.get("tokenizer_path"),
        arch=_build(arch_cls, arch_raw),
        mel=_build(MelConfig, model.get("mel_spec", {})),
    )


def load_train_yaml(path: str) -> TrainConfig:
    """The optim / ckpts / datasets sections of a training YAML -> TrainConfig,
    key for key as the JAX loader reads them (config.py:359-391), with the
    optional `mesh:` section ({data, fsdp, model, seq, pipe}; a bare `mesh:`
    is the default mesh)."""
    raw = _read_yaml(path)
    optim = raw.get("optim", {})
    ckpts = raw.get("ckpts", {})
    ds = raw.get("datasets", {})
    mesh_raw = raw.get("mesh") or {}  # a bare `mesh:` key parses as None
    mesh = MeshConfig(
        data=mesh_raw.get("data", -1), fsdp=mesh_raw.get("fsdp", 1),
        model=mesh_raw.get("model", 1), seq=mesh_raw.get("seq", 1),
        pipe=mesh_raw.get("pipe", 1))
    return TrainConfig(
        mesh=mesh,
        epochs=optim.get("epochs", 100),
        learning_rate=optim.get("learning_rate", 7.5e-5),
        num_warmup_updates=optim.get("num_warmup_updates", 20_000),
        grad_accumulation_steps=optim.get("grad_accumulation_steps", 1),
        max_grad_norm=optim.get("max_grad_norm", 1.0),
        bnb_optimizer=optim.get("bnb_optimizer", False),
        batch_size_per_device=ds.get("batch_size_per_gpu", 19_200),
        batch_size_type=ds.get("batch_size_type", "frame"),
        max_samples=ds.get("max_samples", 64),
        save_per_updates=ckpts.get("save_per_updates", 50_000),
        last_per_updates=ckpts.get("last_per_updates", 5_000),
        keep_last_n_checkpoints=ckpts.get("keep_last_n_checkpoints", -1),
        log_samples_per_updates=ckpts.get("log_samples_per_updates", 10_000),
        save_dir=ckpts.get("save_dir", "ckpts"),
        logger=ckpts.get("logger"),
    )
