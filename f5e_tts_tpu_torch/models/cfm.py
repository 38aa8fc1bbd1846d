"""Conditional flow matching (counterpart of `f5e_tts_tpu/models/cfm.py`):
the sampler and the training loss `cfm_loss`.

The ODE over the sway-sampled grid (or an explicit one, e.g. an EPSS-pruned
grid) is a Python loop; the CFG branches (cond and audio+text dropped for
`sample`; null, text and speaker+text for the dual-alpha `sample_tts`) are
folded into one (K*B)-batch backbone call per step with per-sample drop
flags; the text embeddings are computed once, before the loop
(`fold_inputs`), so the loop itself (`folded_step_fn` under `_ode_scan`)
holds no host work and can be captured as a CUDA graph (utils/aot.py).

reference: src/f5_tts/model/cfm.py:348-482 (CFM.sample).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.config import CFMConfig
from f5e_tts_tpu_torch.models import backbone as fbb
from f5e_tts_tpu_torch.utils.device import resolve_device
from f5e_tts_tpu_torch.utils.masks import lens_to_mask, mask_from_frac_lengths


def sway_timesteps(steps: int, sway_coef: Optional[float], t_start: float = 0.0) -> np.ndarray:
    """t = linspace + sway * (cos(pi/2 t) - 1 + t), in float64, cast to
    float32 (reference: cfm.py:467-469)."""
    t = np.linspace(t_start, 1.0, steps + 1, dtype=np.float64)
    if sway_coef is not None:
        t = t + sway_coef * (np.cos(np.pi / 2 * t) - 1 + t)
    return t.astype(np.float32)


def pruned_sway_timesteps(keep, base_steps: int = 32, sway_coef: Optional[float] = -1.0,
                          t_start: float = 0.0) -> tuple:
    """EPSS-style pruned grid (arXiv 2505.19931): the `base_steps` sway grid
    taken at the indices `keep`, which must start at 0, end at `base_steps`
    and increase strictly. A hashable tuple of floats, the `timesteps=` of
    `sample` (reference: f5e_tts_tpu cfm.py:46-62)."""
    keep = tuple(int(i) for i in keep)
    if keep[0] != 0 or keep[-1] != base_steps or list(keep) != sorted(set(keep)):
        raise ValueError(f"keep must be strictly increasing 0..{base_steps}, got {keep}")
    grid = sway_timesteps(base_steps, sway_coef, t_start)
    return tuple(float(grid[i]) for i in keep)


def noise_like(generator: torch.Generator, batch: int, length: int, channels: int,
               durations: torch.Tensor) -> torch.Tensor:
    """Standard normal (B, length, channels) noise from `generator` (on the
    generator's device), zero past each sample's duration."""
    y0 = torch.randn((batch, length, channels), generator=generator,
                     device=generator.device, dtype=torch.float32)
    keep = lens_to_mask(durations.to(generator.device), length)
    return y0.masked_fill(~keep[:, :, None], 0.0)


def _ode_scan(step_fn: Callable, y0: torch.Tensor, ts: np.ndarray, method: str = "euler",
              trajectory: bool = True):
    """Integrate dy/dt = step_fn(t, y) over the float32 grid ts.

    Euler: y += (t1 - t0) * f(t0, y). Midpoint: classic RK2. Returns
    (y_final, trajectory (steps + 1, ...) including y0), as torchdiffeq's
    odeint does (reference: cfm.py:471); the trajectory is None when not
    asked for (the captured sampler keeps only y_final).
    """
    ts = np.asarray(ts, np.float32)
    y = y0
    traj = [y0] if trajectory else None
    for t0, t1 in zip(ts[:-1], ts[1:]):
        dt = t1 - t0  # float32 arithmetic, as on the JAX grid
        if method == "euler":
            y = y + float(dt) * step_fn(float(t0), y)
        elif method == "midpoint":
            half = np.float32(0.5) * dt
            k1 = step_fn(float(t0), y)
            y_mid = y + float(half) * k1
            y = y + float(dt) * step_fn(float(t0 + half), y_mid)
        else:
            raise ValueError(f"unknown ode method {method!r}")
        if trajectory:
            traj.append(y)
    return y, torch.stack(traj) if trajectory else None


class SamplerInputs(NamedTuple):
    cond: torch.Tensor  # (B, N, mel) reference mel padded to N, zero outside the prompt
    cond_mask: torch.Tensor  # (B, N) True where the prompt is kept
    duration: torch.Tensor  # (B,) total output frames
    text_ids: Optional[torch.Tensor]  # (B, NT), pad -1, or None


def prepare_inputs(cond: torch.Tensor, lens: torch.Tensor, duration: torch.Tensor,
                   max_duration: int, text_ids: Optional[torch.Tensor] = None,
                   edit_mask: Optional[torch.Tensor] = None,
                   no_ref_audio: bool = False) -> SamplerInputs:
    """Pad cond to the bucket length and build the prompt-keep mask
    (reference: cfm.py:393-428). `edit_mask` (B, <= max_duration), True
    where the prompt is kept, is padded with False and ANDed into the mask
    (speech editing); `no_ref_audio` zeroes the cond mel."""
    cond_len = cond.shape[1]
    if cond_len < max_duration:
        cond = F.pad(cond, (0, 0, 0, max_duration - cond_len))
    else:
        cond = cond[:, :max_duration]
    cond_mask = lens_to_mask(lens.to(cond.device), max_duration)
    if edit_mask is not None:
        edit_mask = edit_mask.to(device=cond.device, dtype=torch.bool)
        cond_mask = cond_mask & F.pad(edit_mask, (0, max_duration - edit_mask.shape[1]))
    if no_ref_audio:
        cond = torch.zeros_like(cond)
    step_cond = cond.masked_fill(~cond_mask[:, :, None], 0.0)
    return SamplerInputs(cond=step_cond, cond_mask=cond_mask, duration=duration,
                         text_ids=text_ids)


def cfg_branches(cfg_strength: float):
    """(branches, weights) of the plain CFG sampler: (1 + cfg) * cond_flow -
    cfg * null_flow, or the cond branch alone when cfg < 1e-5."""
    if cfg_strength < 1e-5:
        return [dict(drop_audio=False, drop_text=False)], [1.0]
    return ([dict(drop_audio=False, drop_text=False), dict(drop_audio=True, drop_text=True)],
            [1.0 + cfg_strength, -cfg_strength])


def tts_branches(alpha_spk: float, alpha_txt: float):
    """(branches, weights) of the dual-alpha TTS sampler: the null, text and
    speaker+text branches, flow = a_spk (spk_txt - txt) + a_txt (txt - null)
    + null, i.e. weights [1 - a_txt, a_txt - a_spk, a_spk] (reference:
    f5e_tts_tpu cfm.py:304-312)."""
    return ([dict(drop_audio=True, drop_text=True), dict(drop_audio=True, drop_text=False),
             dict(drop_audio=False, drop_text=False)],
            [1.0 - alpha_txt, alpha_txt - alpha_spk, alpha_spk])


class FoldedInputs(NamedTuple):
    """The time-independent inputs of the K CFG branches, folded into one
    (K*B) batch; what the ODE loop reads at every step."""

    text_embed: torch.Tensor  # (K*B, N, text_dim) DiT, (K*B, Nt, dim) MMDiT
    cond: torch.Tensor  # (K*B, N, mel)
    drop_audio: torch.Tensor  # (K*B,) bool
    mask: torch.Tensor  # (K*B, N) bool, True inside each sample's duration
    weights: torch.Tensor  # (K,) fp32 branch weights


def fold_inputs(params, arch, inputs: SamplerInputs, branches: Sequence[dict],
                weights: Sequence[float], compute_dtype) -> FoldedInputs:
    """Text embeddings of every branch (once a request), the repeated cond
    and mask, the drop flags and the weights. Runs eagerly: it copies the
    weights from the host. The folded text embedding is (K*B, N, D) for the
    DiT and the UNetT and (K*B, Nt, D) for the MMDiT, whose dropped branch
    keeps the text length."""
    b, n, _ = inputs.cond.shape
    k = len(branches)
    device = inputs.cond.device
    text_embed_k = torch.cat([
        fbb.precompute_text_embed(params, arch, inputs.text_ids, b, n,
                                  torch.full((b,), br["drop_text"], device=device),
                                  compute_dtype)
        for br in branches])
    drop_audio_k = torch.cat([torch.full((b,), br["drop_audio"], device=device)
                              for br in branches])
    return FoldedInputs(text_embed=text_embed_k, cond=inputs.cond.repeat(k, 1, 1),
                        drop_audio=drop_audio_k,
                        mask=lens_to_mask(inputs.duration, n).repeat(k, 1),
                        weights=torch.tensor(weights, dtype=torch.float32, device=device))


def folded_step_fn(params, arch, folded: FoldedInputs, compute_dtype) -> Callable:
    """step_fn(t, x) evaluating all K CFG branches in ONE (K*B)-batch call;
    the flow is sum_k weights[k] * flow_k. `arch` is any backbone config the
    dispatch knows. No host work: every operand is on the device already."""
    k = folded.weights.shape[0]
    device = folded.cond.device

    def step_fn(t: float, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        pred = fbb.sample_step(
            params, arch, x=x.repeat(k, 1, 1).to(compute_dtype), cond=folded.cond,
            text_embed=folded.text_embed,
            time=torch.full((k * b,), t, dtype=torch.float32, device=device),
            drop_audio_cond=folded.drop_audio, mask=folded.mask, compute_dtype=compute_dtype)
        return torch.einsum("k,kbnd->bnd", folded.weights, pred.reshape(k, b, n, -1))

    return step_fn


def sample(params, arch, cfm: CFMConfig, inputs: SamplerInputs, *,
           steps: int = 32, cfg_strength: float = 2.0, sway_coef: Optional[float] = -1.0,
           generator: Optional[torch.Generator] = None, y0: Optional[torch.Tensor] = None,
           timesteps: Optional[Sequence[float]] = None,
           compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """2-branch CFG sampler: (1 + cfg) * cond_flow - cfg * null_flow; a single
    branch when cfg < 1e-5. The ODE runs over `timesteps` when given (an
    explicit grid such as `pruned_sway_timesteps`; it overrides `steps` and
    `sway_coef`, NFE = len - 1), else over the `steps`-step sway grid. The
    noise is `y0` when given, else drawn from `generator`. Returns (out,
    trajectory); the prompt frames of `out` are the conditioning mel
    (reference: cfm.py:476)."""
    return _sample_branches(params, arch, cfm, inputs, *cfg_branches(cfg_strength), steps=steps,
                            sway_coef=sway_coef, generator=generator, y0=y0,
                            timesteps=timesteps, compute_dtype=compute_dtype, device=device)


def sample_tts(params, arch, cfm: CFMConfig, inputs: SamplerInputs, *,
               steps: int = 32, alpha_spk: float = 1.0, alpha_txt: float = 1.0,
               sway_coef: Optional[float] = None, generator: Optional[torch.Generator] = None,
               y0: Optional[torch.Tensor] = None, timesteps: Optional[Sequence[float]] = None,
               compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """MegaTTS3-style dual-alpha TTS CFG: the null, text and speaker+text
    branches folded into one (3B) batch a step (`tts_branches`). Noise,
    grid and output as `sample` (reference: f5e_tts_tpu cfm.py:285-327,
    whose sway defaults to None, a plain linspace grid)."""
    return _sample_branches(params, arch, cfm, inputs, *tts_branches(alpha_spk, alpha_txt),
                            steps=steps, sway_coef=sway_coef, generator=generator, y0=y0,
                            timesteps=timesteps, compute_dtype=compute_dtype, device=device)


def _sample_branches(params, arch, cfm: CFMConfig, inputs: SamplerInputs, branches, weights, *,
                     steps, sway_coef, generator, y0, timesteps, compute_dtype, device):
    """The ODE over the flow sum_k weights[k] * flow_k of the folded
    branches; returns (out, trajectory) as `sample` does."""
    if fbb.uses_ppg(arch):
        raise NotImplementedError("PPG conditioning is not ported yet (ROADMAP queue 1 item 6)")
    dev = resolve_device(device)
    param_dev = params["proj_out"]["w"].device
    if param_dev.type != dev.type:
        raise ValueError(f"params are on {param_dev}, sampling on {dev}")
    inputs = SamplerInputs(*(None if t is None else t.to(dev) for t in inputs))
    b, n, mel_dim = inputs.cond.shape
    step_fn = folded_step_fn(params, arch, fold_inputs(params, arch, inputs, branches, weights,
                                                       compute_dtype), compute_dtype)

    if y0 is None:
        if generator is None:
            raise ValueError("sample needs a generator or an explicit y0")
        y0 = noise_like(generator, b, n, mel_dim, inputs.duration)
    y0 = y0.to(device=dev, dtype=torch.float32)
    ts = (np.asarray(timesteps, np.float32) if timesteps is not None
          else sway_timesteps(steps, sway_coef))
    y_final, traj = _ode_scan(step_fn, y0, ts, cfm.ode_method)
    out = torch.where(inputs.cond_mask[:, :, None], inputs.cond, y_final)
    return out, traj


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------


class CFMLossOut(NamedTuple):
    loss: torch.Tensor  # fp32 scalar
    flow_loss: torch.Tensor  # fp32 scalar (equal to loss: no extra losses are ported)
    cond: torch.Tensor  # (B, N, mel) the masked conditioning mel
    pred: torch.Tensor  # (B, N, mel) fp32 predicted flow


class LossDraws(NamedTuple):
    """The random draws of one `cfm_loss` call. Fields left None are drawn
    from the call's generator; tests hand over draws made from a JAX key."""

    frac: Optional[torch.Tensor] = None  # (B,) span fraction in [frac_lo, frac_hi)
    span: Optional[torch.Tensor] = None  # (B,) U[0, 1) placing each span's start
    x0: Optional[torch.Tensor] = None  # (B, N, mel) standard normal noise
    time: Optional[torch.Tensor] = None  # (B,) U[0, 1) flow time
    u1: Optional[torch.Tensor] = None  # () U[0, 1): audio drop when < audio_drop_prob
    u2: Optional[torch.Tensor] = None  # () U[0, 1): drop all when < cond_drop_prob


def cfm_loss(params, arch, cfm: CFMConfig, *, mel: torch.Tensor,
             mel_lens: torch.Tensor, text_ids: Optional[torch.Tensor],
             generator: Optional[torch.Generator] = None, draws: Optional[LossDraws] = None,
             training: bool = True, compute_dtype=torch.bfloat16) -> CFMLossOut:
    """Flow-matching infilling loss (reference: cfm.py:484-590, CFM.forward).

    One random span per sample covering frac (70-100 %) of its valid frames
    is hidden from the conditioning; x_t = (1 - t) x0 + t x1; the
    condition-drop decision is one draw for the whole batch (audio drop with
    p = audio_drop_prob, everything dropped with p = cond_drop_prob); the
    loss is the MSE of the predicted flow x1 - x0 over the span only. As the
    reference, training passes no attention mask, so every key is valid,
    padding included. Draws missing from `draws` come from `generator`, as
    does the trunk's dropout.
    """
    if fbb.uses_ppg(arch):
        raise NotImplementedError("PPG conditioning is not ported yet")
    b, n, mel_dim = mel.shape
    dev = mel.device
    d = draws or LossDraws()

    def uniform(value, shape):
        if value is not None:
            return torch.as_tensor(value, dtype=torch.float32).to(dev)
        return torch.rand(shape, generator=generator, device=dev)

    mask = lens_to_mask(mel_lens.to(dev), n)
    lo, hi = cfm.frac_lengths_mask
    frac = d.frac.to(dev).float() if d.frac is not None else lo + (hi - lo) * uniform(None, (b,))
    span = mask_from_frac_lengths(mel_lens.to(dev), frac, n, rand=uniform(d.span, (b,))) & mask

    x1 = mel.float()
    x0 = (d.x0.to(dev).float() if d.x0 is not None
          else torch.randn(x1.shape, generator=generator, device=dev))
    time = uniform(d.time, (b,))
    t = time[:, None, None]
    phi = (1 - t) * x0 + t * x1
    flow = x1 - x0
    cond = x1.masked_fill(span[:, :, None], 0.0)

    drop_all = uniform(d.u2, ()) < cfm.cond_drop_prob
    drop_audio = (uniform(d.u1, ()) < cfm.audio_drop_prob) | drop_all
    pred = fbb.forward_train(
        params, arch, x=phi.to(compute_dtype), cond=cond.to(compute_dtype), text_ids=text_ids,
        time=time, drop_audio_cond=drop_audio.expand(b), drop_text=drop_all.expand(b),
        mask=None, training=training, generator=generator, compute_dtype=compute_dtype)

    se = (pred.float() - flow).square()
    w = span[:, :, None].float()
    flow_loss = (se * w).sum() / torch.clamp(w.sum() * mel_dim, min=1.0)
    return CFMLossOut(loss=flow_loss, flow_loss=flow_loss, cond=cond, pred=pred)
