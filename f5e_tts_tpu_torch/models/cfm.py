"""Conditional flow matching (counterpart of `f5e_tts_tpu/models/cfm.py`):
the sampler and the training loss `cfm_loss`.

The ODE over the sway-sampled grid (or an explicit one, e.g. an EPSS-pruned
grid) is a Python loop; the CFG branches (cond and everything dropped for
`sample`; null, text and speaker+text for the dual-alpha `sample_tts`; null,
PPG and speaker+PPG for the voice-conversion `sample_vc`) are folded into
one (K*B)-batch backbone call per step with per-sample drop flags; the text
and PPG embeddings are computed once, before the loop (`fold_inputs`), so
the loop itself (`folded_step_fn` under `_ode_scan`) holds no host work and
can be captured as a CUDA graph (utils/aot.py).

reference: src/f5_tts/model/cfm.py:348-482 (CFM.sample).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.config import CFMConfig
from f5e_tts_tpu_torch.models import backbone as fbb
from f5e_tts_tpu_torch.models import dit as fdit
from f5e_tts_tpu_torch.parallel import mesh as pmesh
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


def noise_like(generator: Optional[torch.Generator], batch: int, length: int, channels: int,
               durations: torch.Tensor, seeds=None) -> torch.Tensor:
    """Standard normal (B, length, channels) noise, zero past each sample's
    duration: drawn from `generator` on its device, or with `seeds` (B,)
    sample i's from its own `torch.Generator(device).manual_seed(seeds[i])`
    as one (length, channels) draw, on the durations' device.

    A seeded sample's noise then depends on its seed alone, not on its
    batch-mates or its slot: it has the bits of the batch-of-one draw
    `noise_like(torch.Generator(device).manual_seed(seed), 1, ...)` that
    `TTSEngine.synthesize_chunk(seed=)` makes (the contract of
    f5e_tts_tpu/models/cfm.py: noise_like; torch's streams are not JAX's)."""
    if seeds is not None:
        device = durations.device
        seeds = [int(s) for s in (seeds.tolist() if torch.is_tensor(seeds) else seeds)]
        if len(seeds) != batch:
            raise ValueError(f"{len(seeds)} seeds for a batch of {batch}")
        y0 = torch.stack([torch.randn((length, channels), dtype=torch.float32, device=device,
                                      generator=torch.Generator(device=device).manual_seed(s))
                          for s in seeds])
    else:
        device = generator.device
        y0 = torch.randn((batch, length, channels), generator=generator, device=device,
                         dtype=torch.float32)
    keep = lens_to_mask(durations.to(device), length)
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
    ppg: Optional[torch.Tensor] = None  # (B, NP, ppg_dim) or None (a PPG DiT reads zeros)


def prepare_inputs(cond: torch.Tensor, lens: torch.Tensor, duration: torch.Tensor,
                   max_duration: int, text_ids: Optional[torch.Tensor] = None,
                   edit_mask: Optional[torch.Tensor] = None,
                   no_ref_audio: bool = False,
                   ppg: Optional[torch.Tensor] = None) -> SamplerInputs:
    """Pad cond to the bucket length and build the prompt-keep mask
    (reference: cfm.py:393-428). `edit_mask` (B, <= max_duration), True
    where the prompt is kept, is padded with False and ANDed into the mask
    (speech editing); `no_ref_audio` zeroes the cond mel. `ppg` passes as it
    is: the PPG embedding pads or truncates it to the bucket."""
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
                         text_ids=text_ids, ppg=ppg)


def _branch(audio: bool, text: bool, ppg: bool) -> dict:
    return dict(drop_audio=audio, drop_text=text, drop_ppg=ppg)


def cfg_branches(cfg_strength: float):
    """(branches, weights) of the plain CFG sampler: (1 + cfg) * cond_flow -
    cfg * null_flow (the null branch drops audio, text and PPG), or the cond
    branch alone when cfg < 1e-5."""
    if cfg_strength < 1e-5:
        return [_branch(False, False, False)], [1.0]
    return ([_branch(False, False, False), _branch(True, True, True)],
            [1.0 + cfg_strength, -cfg_strength])


def tts_branches(alpha_spk: float, alpha_txt: float):
    """(branches, weights) of the dual-alpha TTS sampler: the null, text and
    speaker+text branches, all with the PPG dropped, flow = a_spk (spk_txt -
    txt) + a_txt (txt - null) + null, i.e. weights [1 - a_txt, a_txt -
    a_spk, a_spk] (reference: f5e_tts_tpu cfm.py:304-312)."""
    return ([_branch(True, True, True), _branch(True, False, True), _branch(False, False, True)],
            [1.0 - alpha_txt, alpha_txt - alpha_spk, alpha_spk])


def vc_branches(alpha_spk: float, alpha_ppg: float):
    """(branches, weights) of the voice-conversion sampler: the null, PPG and
    speaker+PPG branches, all with the text dropped, flow = a_spk (spk_ppg -
    ppg) + a_ppg (ppg - null) + null, i.e. weights [1 - a_ppg, a_ppg -
    a_spk, a_spk] (reference: f5e_tts_tpu cfm.py:330-373)."""
    return ([_branch(True, True, True), _branch(True, True, False), _branch(False, True, False)],
            [1.0 - alpha_ppg, alpha_ppg - alpha_spk, alpha_spk])


class FoldedInputs(NamedTuple):
    """The time-independent inputs of the K CFG branches, folded into one
    (K*B) batch; what the ODE loop reads at every step."""

    text_embed: torch.Tensor  # (K*B, N, text_dim) DiT, (K*B, Nt, dim) MMDiT
    cond: torch.Tensor  # (K*B, N, mel)
    drop_audio: torch.Tensor  # (K*B,) bool
    mask: Optional[torch.Tensor]  # (K*B, N) bool, True inside each sample's duration
    weights: torch.Tensor  # (K,) fp32 branch weights
    ppg_embed: Optional[torch.Tensor] = None  # (K*B, N, text_dim) of a PPG DiT, else None


def fold_inputs(params, arch, inputs: SamplerInputs, branches: Sequence[dict],
                weights: Sequence[float], compute_dtype, state=None,
                use_mask: bool = True) -> FoldedInputs:
    """Text (and a PPG DiT's PPG) embeddings of every branch (once a
    request), the repeated cond and mask (None without `use_mask`: every
    frame of the bucket is a key), the drop flags and the weights.
    Runs eagerly: it copies the weights from the host. The folded text
    embedding is (K*B, N, D) for the DiT and the UNetT and (K*B, Nt, D) for
    the MMDiT, whose dropped branch keeps the text length. A PPG DiT's PPG
    embedding runs its BatchNorms on `state`'s running statistics."""
    b, n, _ = inputs.cond.shape
    k = len(branches)
    device = inputs.cond.device

    def flags(name):
        return [torch.full((b,), br[name], device=device) for br in branches]

    text_embed_k = torch.cat([
        fbb.precompute_text_embed(params, arch, inputs.text_ids, b, n, drop, compute_dtype)
        for drop in flags("drop_text")])
    ppg_embed_k = None
    if fbb.uses_ppg(arch):
        ppg_embed_k = torch.cat([
            fbb.precompute_ppg_embed(params, state, arch, inputs.ppg, b, n, drop, compute_dtype)
            for drop in flags("drop_ppg")])
    return FoldedInputs(text_embed=text_embed_k, cond=inputs.cond.repeat(k, 1, 1),
                        drop_audio=torch.cat(flags("drop_audio")),
                        mask=lens_to_mask(inputs.duration, n).repeat(k, 1) if use_mask else None,
                        weights=torch.tensor(weights, dtype=torch.float32, device=device),
                        ppg_embed=ppg_embed_k)


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
            drop_audio_cond=folded.drop_audio, mask=folded.mask, compute_dtype=compute_dtype,
            ppg_embed=folded.ppg_embed)
        return torch.einsum("k,kbnd->bnd", folded.weights, pred.reshape(k, b, n, -1))

    return step_fn


def sample(params, arch, cfm: CFMConfig, inputs: SamplerInputs, *,
           steps: int = 32, cfg_strength: float = 2.0, sway_coef: Optional[float] = -1.0,
           use_mask: bool = True, t_start: float = 0.0, test_cond: Optional[torch.Tensor] = None,
           seeds=None, generator: Optional[torch.Generator] = None,
           y0: Optional[torch.Tensor] = None, timesteps: Optional[Sequence[float]] = None,
           compute_dtype: torch.dtype = torch.bfloat16, device="cuda", state=None):
    """2-branch CFG sampler: (1 + cfg) * cond_flow - cfg * null_flow; a single
    branch when cfg < 1e-5 (reference: f5e_tts_tpu cfm.py:227-282). The ODE
    runs over `timesteps` when given (an explicit grid such as
    `pruned_sway_timesteps`; it overrides `steps` and `sway_coef`, NFE =
    len - 1), else over the `steps`-step sway grid from `t_start`.

    The noise is `y0` when given, else drawn per sample from `seeds` (B,)
    (`noise_like`), else from `generator`. `use_mask=False` passes no key
    mask to the trunk. The duplicate_test probe: `t_start` > 0 cuts the
    steps to max(int(steps (1 - t_start)), 1) so the step density matches
    the full [0, 1] grid, and with `test_cond` (B, N, mel) the ODE starts
    from (1 - t_start) y0 + t_start test_cond. `state` is a PPG DiT's
    BatchNorm state. Returns (out, trajectory); the prompt frames of `out`
    are the conditioning mel (reference: cfm.py:476)."""
    if t_start > 0.0:
        steps = max(int(steps * (1.0 - t_start)), 1)
    return _sample_branches(params, arch, cfm, inputs, *cfg_branches(cfg_strength), steps=steps,
                            sway_coef=sway_coef, use_mask=use_mask, t_start=t_start,
                            test_cond=test_cond, seeds=seeds, generator=generator, y0=y0,
                            timesteps=timesteps, compute_dtype=compute_dtype, device=device,
                            state=state)


def sample_tts(params, arch, cfm: CFMConfig, inputs: SamplerInputs, *,
               steps: int = 32, alpha_spk: float = 1.0, alpha_txt: float = 1.0,
               sway_coef: Optional[float] = None, use_mask: bool = True, seeds=None,
               generator: Optional[torch.Generator] = None, y0: Optional[torch.Tensor] = None,
               timesteps: Optional[Sequence[float]] = None,
               compute_dtype: torch.dtype = torch.bfloat16, device="cuda", state=None):
    """MegaTTS3-style dual-alpha TTS CFG: the null, text and speaker+text
    branches folded into one (3B) batch a step (`tts_branches`). Noise
    (`y0`, `seeds`, `generator`), mask, grid and output as `sample`
    (reference: f5e_tts_tpu cfm.py:285-327, whose sway defaults to None, a
    plain linspace grid)."""
    return _sample_branches(params, arch, cfm, inputs, *tts_branches(alpha_spk, alpha_txt),
                            steps=steps, sway_coef=sway_coef, use_mask=use_mask, seeds=seeds,
                            generator=generator, y0=y0, timesteps=timesteps,
                            compute_dtype=compute_dtype, device=device, state=state)


def sample_vc(params, arch, cfm: CFMConfig, inputs: SamplerInputs, *,
              steps: int = 32, alpha_spk: float = 1.0, alpha_ppg: float = 1.0,
              sway_coef: Optional[float] = None, use_mask: bool = True, seeds=None,
              generator: Optional[torch.Generator] = None, y0: Optional[torch.Tensor] = None,
              timesteps: Optional[Sequence[float]] = None,
              compute_dtype: torch.dtype = torch.bfloat16, device="cuda", state=None):
    """Voice-conversion CFG over the PPG, the text dropped in every branch:
    the null, PPG and speaker+PPG branches folded into one (3B) batch a step
    (`vc_branches`). Needs a PPG DiT and its `state`. Noise, mask, grid and
    output as `sample` (reference: f5e_tts_tpu cfm.py:330-373)."""
    if not fbb.uses_ppg(arch):
        raise ValueError("sample_vc needs a PPG DiT (arch.ppg.use_ppg)")
    return _sample_branches(params, arch, cfm, inputs, *vc_branches(alpha_spk, alpha_ppg),
                            steps=steps, sway_coef=sway_coef, use_mask=use_mask, seeds=seeds,
                            generator=generator, y0=y0, timesteps=timesteps,
                            compute_dtype=compute_dtype, device=device, state=state)


def _sample_branches(params, arch, cfm: CFMConfig, inputs: SamplerInputs, branches, weights, *,
                     steps, sway_coef, use_mask, seeds, generator, y0, timesteps, compute_dtype,
                     device, state, t_start: float = 0.0, test_cond=None):
    """The ODE over the flow sum_k weights[k] * flow_k of the folded
    branches; returns (out, trajectory) as `sample` does."""
    dev = resolve_device(device)
    param_dev = params["proj_out"]["w"].device
    if param_dev.type != dev.type:
        raise ValueError(f"params are on {param_dev}, sampling on {dev}")
    if fbb.uses_ppg(arch) and not state:
        raise ValueError("a PPG DiT samples with its BatchNorm state (state=)")
    inputs = SamplerInputs(*(None if t is None else t.to(dev) for t in inputs))
    b, n, mel_dim = inputs.cond.shape
    folded = fold_inputs(params, arch, inputs, branches, weights, compute_dtype, state, use_mask)
    step_fn = folded_step_fn(params, arch, folded, compute_dtype)

    if y0 is None:
        if seeds is None and generator is None:
            raise ValueError("sample needs seeds, a generator or an explicit y0")
        y0 = noise_like(generator, b, n, mel_dim, inputs.duration, seeds=seeds)
    y0 = y0.to(device=dev, dtype=torch.float32)
    if test_cond is not None:
        y0 = (1.0 - t_start) * y0 + t_start * test_cond.to(device=dev, dtype=torch.float32)
    ts = (np.asarray(timesteps, np.float32) if timesteps is not None
          else sway_timesteps(steps, sway_coef, t_start))
    y_final, traj = _ode_scan(step_fn, y0, ts, cfm.ode_method)
    out = torch.where(inputs.cond_mask[:, :, None], inputs.cond, y_final)
    return out, traj


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------


class CFMLossOut(NamedTuple):
    loss: torch.Tensor  # fp32 scalar: flow_loss + extra_loss
    flow_loss: torch.Tensor  # fp32 scalar
    cond: torch.Tensor  # (B, N, mel) the masked conditioning mel
    pred: torch.Tensor  # (B, N, mel) fp32 predicted flow
    extra_loss: Optional[torch.Tensor] = None  # () the codebook losses (0 without a codebook)
    new_state: Optional[dict] = None  # a PPG DiT's BatchNorm state after the step, else {}
    align_loss: Optional[torch.Tensor] = None  # ()
    perplex_loss: Optional[torch.Tensor] = None  # ()


class LossDraws(NamedTuple):
    """The random draws of one `cfm_loss` call. Fields left None are drawn
    from the call's generator; tests hand over draws made from a JAX key.
    The fields after u2 are the PPG DiT's (see `dit.DiTDraws`)."""

    frac: Optional[torch.Tensor] = None  # (B,) span fraction in [frac_lo, frac_hi)
    span: Optional[torch.Tensor] = None  # (B,) U[0, 1) placing each span's start
    x0: Optional[torch.Tensor] = None  # (B, N, mel) standard normal noise
    time: Optional[torch.Tensor] = None  # (B,) U[0, 1) flow time
    u1: Optional[torch.Tensor] = None  # () U[0, 1): audio drop when < audio_drop_prob
    u2: Optional[torch.Tensor] = None  # () U[0, 1): the drop table's cell
    ppg_keep: Optional[Sequence[torch.Tensor]] = None  # 3 x (B, N, ppg_dim) PPG dropout keeps
    gumbel_text: Optional[torch.Tensor] = None  # (B * N * groups, num_vars) U[1e-10, 1)
    gumbel_ppg: Optional[torch.Tensor] = None
    perm_text: Optional[torch.Tensor] = None  # (N,) permutations of the perplexity loss
    perm_ppg: Optional[torch.Tensor] = None
    cross_apply: Optional[torch.Tensor] = None  # () U[0, 1) of the cross mask
    cross_ratio: Optional[torch.Tensor] = None  # (B,)
    cross_start: Optional[torch.Tensor] = None  # (B,)


def drop_flags(arch, cfm: CFMConfig, u1: torch.Tensor, u2: torch.Tensor):
    """The batch-shared condition drops (drop_audio, drop_text, drop_ppg) as
    0-d bool tensors (reference: cfm.py:549-569). Audio drops when u1 <
    audio_drop_prob. Without PPG, u2 < cond_drop_prob drops text and audio
    (and the PPG, which there is none of). With PPG, u2 picks a cell of
    combined_cond_drop_prob = (keep both, drop the text, drop the PPG, drop
    everything)."""
    drop_audio = u1 < cfm.audio_drop_prob
    if fbb.uses_ppg(arch):
        p = arch.ppg.combined_cond_drop_prob
        c1, c2, c3 = p[0], p[0] + p[1], p[0] + p[1] + p[2]
        drop_text = ((u2 >= c1) & (u2 < c2)) | (u2 >= c3)
        return drop_audio | (u2 >= c3), drop_text, u2 >= c2
    drop_all = u2 < cfm.cond_drop_prob
    return drop_audio | drop_all, drop_all, torch.ones_like(drop_all)


def row_draws(d: LossDraws, b: int, n: int, mel_dim: int, mel_lens: torch.Tensor,
              cfm: CFMConfig, generator: Optional[torch.Generator], dev):
    """(span mask, x0, time) of a loss call, drawn in the reference's order
    (frac, span, x0, time) from `generator` where `d` gives none. Under a batch mesh
    (parallel/mesh.py: active) each is drawn at the global
    batch's shape (this rank's b rows times the shards), as the
    single-process run of the global batch draws it, and sliced to this
    shard's rows; given draws are global too."""
    bm = pmesh.batch_mesh()
    bg = b * (1 if bm is None else bm.size(pmesh.BATCH_AXES))

    def draw(value, shape, normal=False):
        if value is not None:
            t = torch.as_tensor(value, dtype=torch.float32).to(dev)
        elif normal:
            t = torch.randn(shape, generator=generator, device=dev)
        else:
            t = torch.rand(shape, generator=generator, device=dev)
        return pmesh.local_rows(t, bm)

    lo, hi = cfm.frac_lengths_mask
    frac = (pmesh.local_rows(d.frac.to(dev).float(), bm) if d.frac is not None
            else pmesh.local_rows(lo + (hi - lo) * torch.rand((bg,), generator=generator,
                                                                device=dev), bm))
    span = mask_from_frac_lengths(mel_lens.to(dev), frac, n, rand=draw(d.span, (bg,))) \
        & lens_to_mask(mel_lens.to(dev), n)
    x0 = draw(d.x0, (bg, n, mel_dim), normal=True)
    return span, x0, draw(d.time, (bg,))


def _local_dit_draws(d: LossDraws, bm) -> dict:
    """The DiT's draws of `d` with the per-row ones cut to this shard's rows
    under a batch mesh (the permutations and the cross mask's coin are the
    batch's)."""
    out = {f: getattr(d, f) for f in fdit.DiTDraws._fields}
    if bm is None:
        return out
    for f in ("gumbel_text", "gumbel_ppg", "cross_ratio", "cross_start"):
        if out[f] is not None:
            out[f] = pmesh.local_rows(out[f], bm)
    if out["ppg_keep"] is not None:
        out["ppg_keep"] = [pmesh.local_rows(k, bm) for k in out["ppg_keep"]]
    return out


def cfm_loss(params, arch, cfm: CFMConfig, *, mel: torch.Tensor,
             mel_lens: torch.Tensor, text_ids: Optional[torch.Tensor],
             generator: Optional[torch.Generator] = None, draws: Optional[LossDraws] = None,
             training: bool = True, compute_dtype=torch.bfloat16, state=None,
             text_lens: Optional[torch.Tensor] = None, ppg: Optional[torch.Tensor] = None,
             ppg_lens: Optional[torch.Tensor] = None, vq_temperature: float = 2.0) -> CFMLossOut:
    """Flow-matching infilling loss (reference: cfm.py:484-590, CFM.forward).

    One random span per sample covering frac (70-100 %) of its valid frames
    is hidden from the conditioning; x_t = (1 - t) x0 + t x1; the
    condition-drop decision is one draw for the whole batch (`drop_flags`);
    the flow loss is the MSE of the predicted flow x1 - x0 over the span
    only, and the loss adds the backbone's extra (codebook) losses. A PPG
    DiT takes its BatchNorm `state`, the PPG and the lengths (`text_lens`,
    `ppg_lens`: the codebook branch's); `new_state` is the state after the
    step. As the reference, training passes no attention mask, so every key
    is valid, padding included. Draws missing from `draws` come from
    `generator`, as does the trunk's dropout.

    Under a batch mesh (parallel/mesh.py: active) the batch is
    this rank's rows of the global batch: the per-row draws are the global
    run's (`row_draws`), the two batch-shared ones alike on every rank, the
    flow loss the global span-frame mean (`global_mean`: its gradients
    summed over the shards are the global loss's), and the forward's
    dropout draws from a generator folded with the shard's index. The
    codebook's extra losses are the mean of the shards' (JAX takes them
    over the global batch) and each shard updates the BatchNorm statistics
    from its own rows.
    """
    b, n, mel_dim = mel.shape
    dev = mel.device
    d = draws or LossDraws()
    bm = pmesh.batch_mesh()

    def uniform(value, shape):
        if value is not None:
            return torch.as_tensor(value, dtype=torch.float32).to(dev)
        return torch.rand(shape, generator=generator, device=dev)

    span, x0, time = row_draws(d, b, n, mel_dim, mel_lens, cfm, generator, dev)
    x1 = mel.float()
    x0 = x0.float()
    t = time[:, None, None]
    phi = (1 - t) * x0 + t * x1
    flow = x1 - x0
    cond = x1.masked_fill(span[:, :, None], 0.0)

    drop_audio, drop_text, drop_ppg = drop_flags(arch, cfm, uniform(d.u1, ()), uniform(d.u2, ()))
    dit_kw = {}
    if fbb.uses_ppg(arch):
        dit_kw = dict(ppg=ppg, drop_ppg=drop_ppg.expand(b), text_len=text_lens, ppg_len=ppg_lens,
                      vq_temperature=vq_temperature,
                      draws=fdit.DiTDraws(**_local_dit_draws(d, bm)))
    if bm is not None:
        generator = pmesh.fold_generator(generator, bm.index(pmesh.BATCH_AXES))
    pred, extras = fbb.forward_train(
        params, arch, x=phi.to(compute_dtype), cond=cond.to(compute_dtype), text_ids=text_ids,
        time=time, drop_audio_cond=drop_audio.expand(b), drop_text=drop_text.expand(b),
        mask=None, training=training, generator=generator, compute_dtype=compute_dtype,
        return_extras=True, state=state, **dit_kw)

    se = (pred.float() - flow).square()
    w = span[:, :, None].float()
    flow_loss = pmesh.global_mean((se * w).sum(), w.sum() * mel_dim, bm, min_den=1.0)
    extra, align, perplex = (pmesh.shard_mean(x, bm) for x in (
        extras.extra_loss, extras.align_loss, extras.perplex_loss))
    return CFMLossOut(loss=flow_loss + extra, flow_loss=flow_loss, cond=cond,
                      pred=pred, extra_loss=extra, new_state=extras.new_state,
                      align_loss=align, perplex_loss=perplex)
