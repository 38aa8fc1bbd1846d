"""Per-bucket sampler engines as CUDA graphs (counterpart of
`f5e_tts_tpu/utils/aot.py` and of `TTSEngine.engine_dir` / `_aot_sampler`).

The JAX package exports the jitted sampler of each duration bucket into an
engine file, so serving skips compilation. The port's sampler is eager
PyTorch, and what a synthesis pays for is the host: some 30k kernel
launches, one at a time from Python. `capture_sampler_buckets` records the
ODE loop of `cfm.sample` once per bucket as a `torch.cuda.CUDAGraph`, which
then replays every launch of the loop in one call. A graph cannot be
written to a file, so an engine lives in memory, in `TTSEngine.engines`,
under a name built like the JAX file names:
`sampler_nfe{nfe}{tag}_b{bucket}` (`variant_tag`), with `_t{text_len}` for
an MMDiT. An engine of a batch of b > 1 requests (the serving batcher's,
`serving/batcher.py`) adds `_x{b}`: the JAX batcher jit-compiles each
(batch, bucket), the port captures one graph for each.

What the graph holds is the loop only: NFE folded-CFG backbone calls and the
Euler (or midpoint) updates, each step's time fixed in it. The text
embedding (and a PPG DiT's PPG embedding of no PPG: the JAX engines serve
plain CFG without a PPG), cond, mask, drop flags and CFG weights
(`cfm.fold_inputs`) and the noise are computed eagerly for each request and
copied into the engine's static input buffers. The prompt length and the duration are data, not
shape, so one graph serves every reference length in its bucket (the JAX
files are keyed on the prompt length because their shapes are static). The
text is no shape of the DiT's graph: its embedding is computed eagerly,
padded to the bucket's length, so any request of the bucket matches. The
same holds for the UNetT, whose text embedding is the DiT's.

The MMDiT's text stream keeps its own length through every block, so its
text length is a shape of the graph, as it is of the JAX engine files
(`sampler_..._t{text_len}`, 256 by default): one graph per (bucket, text
length). A request of padded text length nt replays the engine of the
smallest text length >= nt, its ids widened with -1 to that length
(`infer/pipeline.py: widen_text_ids`), the JAX rule. The widened text is
not filler for the MMDiT: its padded positions have a zero embedding but
enter the joint attention after the AdaLN shift, so the engine gives the
eager sampler's output at the widened text, not at nt (the JAX engine file
gives the same).

Every graph reads the params by address: update them in place, never
rebind them.

Memory: every engine of a TTSEngine is captured into one pool
(`TTSEngine.graph_pool`), so the engines share their intermediates. That is
safe because replays run one at a time on one stream: `SamplerGraph.sample`
holds the TTSEngine's `graph_lock` from copying its inputs in to copying
its output out (into a fresh tensor), and raises when it is called on
another stream than the one its engines were captured from, whose order
keeps a replay's work behind the last one's. Each engine's static inputs are
allocated outside the pool, so no replay of any engine can overwrite a
result or an input. Threads on the default stream may share an engine.

Launch counts: each kernel wrapper counts once for each launch the graph
records while the loop is captured, and not at all on replay. A capture
runs one eager step first (the warm-up CUDA graphs need), which counts as
one step's launches.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from f5e_tts_tpu_torch.models import backbone as fbb
from f5e_tts_tpu_torch.models import cfm as fcfm
from f5e_tts_tpu_torch.models import dit as fdit

CAPTURED_KINDS = ("dit", "unett", "mmdit")
# the text length an MMDiT engine is captured for unless asked otherwise:
# export_sampler_buckets' default (f5e_tts_tpu/utils/aot.py:55-58)
DEFAULT_TEXT_LEN = 256


def text_shaped(arch) -> bool:
    """Whether the text length is a shape of the sampler's graph: the MMDiT's
    text stream keeps it, the DiT and UNetT pad the text to the bucket."""
    return fbb.backbone_kind(arch) == "mmdit"


def variant_tag(timesteps=None, cfg_strength=None) -> str:
    """Name tag of a non-default sampler variant: an explicit grid tags by a
    hash of its values, a guidance weight by its value; the default sampler
    has no tag (reference: f5e_tts_tpu/utils/aot.py:38-52)."""
    tag = ""
    if timesteps is not None:
        key = ",".join(f"{float(t):.9e}" for t in timesteps)
        tag += "_ts" + hashlib.sha1(key.encode()).hexdigest()[:8]
    if cfg_strength is not None:
        tag += f"_cfg{float(cfg_strength):g}"
    return tag


def engine_name(nfe: int, bucket: int, timesteps: Optional[Sequence[float]] = None,
                cfg_strength: Optional[float] = None, batch: int = 1,
                text_len: Optional[int] = None) -> str:
    """The name of the engine for (nfe, bucket, variant, batch) and, for an
    MMDiT, its text length. With `timesteps`, nfe is len(timesteps) - 1; a
    batch of one has no suffix, nor has a DiT or UNetT engine (`text_len`
    None) a text length."""
    if timesteps is not None:
        nfe = len(tuple(timesteps)) - 1
    tl = f"_t{text_len}" if text_len is not None else ""
    suffix = f"_x{batch}" if batch != 1 else ""
    return f"sampler_nfe{nfe}{variant_tag(timesteps, cfg_strength)}_b{bucket}{tl}{suffix}"


def find_sampler_engine(engines: Mapping[str, object], nfe: int, bucket: int,
                        timesteps: Optional[Sequence[float]] = None,
                        cfg_strength: Optional[float] = None, batch: int = 1,
                        text_len: Optional[int] = None) -> Optional[str]:
    """The name of the engine for (nfe, bucket, variant, batch) in `engines`,
    or None (reference: f5e_tts_tpu/utils/aot.py:107-134, without the
    prompt length, which is data here, not shape).

    `text_len` is an MMDiT request's padded text length nt: the engine of
    the smallest text length >= nt is found, JAX's rule. None (a DiT or
    UNetT) finds the engine without a text length."""
    if text_len is None:
        name = engine_name(nfe, bucket, timesteps, cfg_strength, batch)
        return name if name in engines else None
    # the name with the text length as a group: engine_name's fields around it
    head, tail = engine_name(nfe, bucket, timesteps, cfg_strength, batch, text_len=0).rsplit(
        "_t0", 1)
    pat = re.compile(rf"^{re.escape(head)}_t(\d+){re.escape(tail)}$")
    best = None
    for name in engines:
        m = pat.match(name)
        if m and int(m.group(1)) >= text_len and (best is None or int(m.group(1)) < best[1]):
            best = (name, int(m.group(1)))
    return best[0] if best else None


class SamplerGraph:
    """The captured ODE loop of one (bucket, grid, guidance, batch) on a DiT,
    UNetT or MMDiT engine, for an MMDiT at one text length `text_len`: the
    folded CFG loop of `batch` requests, 2 x batch rows with guidance.
    `sample(inputs, y0)` is `cfm.sample(..., y0=y0)` for `batch` requests in
    this bucket (an MMDiT's text ids at `text_len`), with the same bits.
    `text_len` is None for a DiT or UNetT engine."""

    def __init__(self, engine, bucket: int, grid: np.ndarray, cfg_strength: float,
                 batch: int = 1, text_len: Optional[int] = None):
        if engine.device.type != "cuda":
            raise RuntimeError(f"CUDA-graph capture needs an engine on a CUDA device, not "
                               f"{engine.device}")
        if text_shaped(engine.arch) != (text_len is not None):
            raise ValueError("an MMDiT engine is captured at a text length, a DiT or UNetT "
                             f"engine at none (text_len={text_len})")
        self.bucket, self.grid, self.cfg_strength, self.batch = bucket, grid, cfg_strength, batch
        self.text_len = text_len
        self._lock = engine.graph_lock
        self.params, self.arch, self.compute_dtype = engine.params, engine.arch, engine.compute_dtype
        self.state = engine.state
        self._capture(engine)

    @torch.inference_mode()
    def _capture(self, engine) -> None:
        dev = engine.device
        b, n, mel_dim = self.batch, self.bucket, self.arch.mel_dim
        placeholder = fcfm.prepare_inputs(
            torch.zeros((b, 1, mel_dim), device=dev), torch.ones(b, dtype=torch.long, device=dev),
            torch.full((b,), n, device=dev), n,
            text_ids=torch.full((b, self.text_len or 1), -1, dtype=torch.int32, device=dev))
        # the static inputs, allocated outside the graph's pool
        self._inputs = self._fold(placeholder)
        self._y0 = torch.zeros((b, n, mel_dim), device=dev)
        step_fn = fcfm.folded_step_fn(self.params, self.arch, self._inputs, self.compute_dtype)
        # one eager step first, on a side stream: it builds what is built on
        # first use (kernel libraries, library handles and workspaces, the
        # RoPE tables of this length), none of which may happen in a capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step_fn(float(self.grid[0]), self._y0)
        torch.cuda.current_stream(dev).wait_stream(side)
        # the graph reads the cached RoPE tables by address (N+1 rows long for
        # the UNetT's time token; the MMDiT's text stream has its own, text_len
        # rows): hold them, so a cache eviction cannot free them
        rows = [fbb.attention_rows(self.arch, n)] + ([self.text_len] if self.text_len else [])
        self._rope = [fdit._rope_tables(self.arch.dim_head, r, self.params["proj_out"]["w"].device)
                      for r in rows]
        if engine.graph_pool is None:
            engine.graph_pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.current_stream(dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=engine.graph_pool):
            self._out, _ = fcfm._ode_scan(step_fn, self._y0, self.grid, engine.cfm.ode_method,
                                          trajectory=False)

    def _fold(self, inputs: fcfm.SamplerInputs) -> fcfm.FoldedInputs:
        branches, weights = fcfm.cfg_branches(self.cfg_strength)
        return fcfm.fold_inputs(self.params, self.arch, inputs, branches, weights,
                                self.compute_dtype, self.state)

    @torch.inference_mode()
    def sample(self, inputs: fcfm.SamplerInputs, y0: torch.Tensor) -> torch.Tensor:
        """(batch, bucket, mel) out: the replayed loop from the noise `y0`,
        the prompt frames replaced by the cond mel, as `cfm.sample` returns it."""
        if tuple(inputs.cond.shape[:2]) != (self.batch, self.bucket):
            raise ValueError(f"engine of batch {self.batch}, bucket {self.bucket} got cond "
                             f"{tuple(inputs.cond.shape)}")
        if self.text_len is not None and inputs.text_ids.shape[1] != self.text_len:
            raise ValueError(f"MMDiT engine of text length {self.text_len} got text ids "
                             f"{tuple(inputs.text_ids.shape)}: widen them first "
                             "(infer.pipeline.widen_text_ids)")
        stream = torch.cuda.current_stream(self._y0.device)
        if stream != self._stream:
            raise RuntimeError(f"engine captured on {self._stream} replayed on {stream}: the "
                               "engines of one pool replay on one stream")
        folded = self._fold(inputs)
        with self._lock:
            for static, value in zip(self._inputs, folded):
                if static is not None:  # ppg_embed of a model without PPG
                    static.copy_(value)
            self._y0.copy_(y0)
            self.graph.replay()
            return torch.where(inputs.cond_mask[:, :, None], inputs.cond, self._out)


def capture_sampler_buckets(engine, buckets: Optional[Sequence[int]] = None, nfe: int = 32,
                            timesteps: Optional[Sequence[float]] = None,
                            cfg_strength: Optional[float] = None,
                            batches: Sequence[int] = (1,),
                            text_len: int = DEFAULT_TEXT_LEN) -> list:
    """Capture the folded-CFG sampler of `engine` (a TTSEngine on the card
    with a DiT, a UNetT or an MMDiT) for each bucket (default:
    `engine.buckets`) and each batch size in `batches` into
    `engine.engines`; returns the engines' names. `timesteps` bakes an
    explicit grid (nfe becomes len - 1), `cfg_strength` a non-default
    guidance weight; the sway is the engine's default. An MMDiT's engines
    take the text length `text_len` (JAX's export parameter and default); a
    DiT or UNetT ignores it. A capture that fails raises (reference:
    f5e_tts_tpu/utils/aot.py:55-105).

    A capture records in CUDA's global mode: a CUDA call from any other
    thread while it runs fails it. Capture before a server takes requests."""
    if engine.device.type != "cuda":
        raise RuntimeError(f"CUDA-graph capture needs an engine on a CUDA device, not {engine.device}")
    tl = text_len if text_shaped(engine.arch) else None
    ts_grid = tuple(float(t) for t in timesteps) if timesteps is not None else None
    cfg = engine.infer_cfg.cfg_strength if cfg_strength is None else cfg_strength
    if ts_grid is not None:
        grid = np.asarray(ts_grid, np.float32)
    else:
        grid = fcfm.sway_timesteps(nfe, engine.infer_cfg.sway_sampling_coef)
    stream = torch.cuda.current_stream(engine.device)
    if any(g._stream != stream for g in engine.engines.values()):
        raise RuntimeError("the engines of one pool are captured and replayed on one stream")
    names = []
    with engine.graph_lock:
        for bucket in buckets or engine.buckets:
            for batch in batches:
                name = engine_name(len(grid) - 1, bucket, ts_grid, cfg_strength, batch, tl)
                engine.engines[name] = SamplerGraph(engine, bucket, grid, cfg, batch, tl)
                names.append(name)
    return names


# ---------------------------------------------------------------------------
# engine directories: the buckets and variants a JAX engine directory names
# ---------------------------------------------------------------------------

# f5e_tts_tpu/utils/aot.py: export_sampler_buckets names each engine file
# sampler_nfe{nfe}{tag}_ref{ref}_b{bucket}_t{text}.jaxexport, the tag as
# `variant_tag` makes it
JAX_ENGINE_FILE = re.compile(r"^sampler_nfe(?P<nfe>\d+)(?P<ts>_ts[0-9a-f]{8})?"
                             r"(?:_cfg(?P<cfg>[^_]+))?_ref\d+_b(?P<bucket>\d+)_t(?P<tl>\d+)"
                             r"\.jaxexport$")
# the EPSS grids (keep indices into the 32-step sway grid) that the JAX
# package's scripts name: scripts/quality_proxy.py's epss16 and epss8
EPSS_KEEPS = (tuple(range(0, 33, 2)), (0, 1, 2, 3, 4, 6, 10, 18, 32))


def engine_dir_variants(engine_dir: str, text_lengths: bool = False) -> list:
    """The distinct (nfe, bucket, timesteps, cfg_strength) of the sampler
    engines a JAX engine directory names, sorted; timesteps and
    cfg_strength are None for the default variant. With `text_lengths` (an
    MMDiT's directory) each variant also carries its text length, a fifth
    element: the distinct (nfe, bucket, timesteps, cfg_strength, text_len).
    Without, the files of one variant at several text lengths are one.

    A `_ts<hash>` tag is matched against the grids the port builds: the
    EPSS_KEEPS grids of `pruned_sway_timesteps`. A CUDA graph cannot be
    written to a file, so the files are read for their names only. Raises
    when the directory names no engine, or a grid that matches none of
    those (capture_sampler_buckets(timesteps=) captures any grid)."""
    names = sorted(os.listdir(engine_dir))
    found = [m for m in map(JAX_ENGINE_FILE.match, names) if m]
    if not found:
        raise ValueError(f"{engine_dir} names no sampler engine "
                         "(sampler_nfe<n>[_ts<hash>][_cfg<w>]_ref<r>_b<bucket>_t<n>.jaxexport); "
                         "capture the buckets with F5TTS(capture_buckets=) or "
                         "utils.aot.capture_sampler_buckets")
    known = {variant_tag(grid): grid
             for grid in (fcfm.pruned_sway_timesteps(keep) for keep in EPSS_KEEPS)}
    variants = set()
    for m in found:
        nfe, bucket, ts = int(m["nfe"]), int(m["bucket"]), None
        if m["ts"]:
            ts = known.get(m["ts"])
            if ts is None or len(ts) - 1 != nfe:
                raise ValueError(f"{m.string}: its grid {m['ts'][1:]} is none the port builds "
                                 "(utils.aot.EPSS_KEEPS); capture it with "
                                 "utils.aot.capture_sampler_buckets(engine, timesteps=...); "
                                 "F5TTS(capture_buckets=) captures the default grid")
        variant = (nfe, bucket, ts, float(m["cfg"]) if m["cfg"] is not None else None)
        variants.add(variant + (int(m["tl"]),) if text_lengths else variant)
    return sorted(variants, key=lambda v: (v[0], v[1], v[2] or (),
                                           -1.0 if v[3] is None else v[3], *v[4:]))


def capture_engine_dir(engine, engine_dir: str) -> list:
    """Capture, on the card, a `SamplerGraph` for each (nfe, bucket, grid,
    guidance) that the JAX engine directory `engine_dir` names, and for an
    MMDiT each (nfe, bucket, grid, guidance, text length)
    (`engine_dir_variants`), the counterpart of `TTSEngine(engine_dir=)`;
    returns the engines' names. Raises as `engine_dir_variants` and
    `capture_sampler_buckets` do, so a directory the port cannot serve is
    never taken for one that leaves every request to the eager sampler."""
    groups: dict = {}
    for nfe, bucket, ts, cfg, *tl in engine_dir_variants(engine_dir, text_shaped(engine.arch)):
        groups.setdefault((nfe, ts, cfg, *tl), []).append(bucket)
    names = []
    for (nfe, ts, cfg, *tl), buckets in groups.items():
        kw = {"text_len": tl[0]} if tl else {}
        names += capture_sampler_buckets(engine, buckets, nfe=nfe, timesteps=ts, cfg_strength=cfg,
                                         **kw)
    return names


# ---------------------------------------------------------------------------
# PPG engines: the frozen extractor's mel -> PPG per fbank-length bucket
# ---------------------------------------------------------------------------


def ppg_engine_name(batch: int, t: int) -> str:
    """The name of the PPG engine of (batch, fbank frames), as the JAX
    engine files are named without their extension."""
    return f"ppg_b{batch}_t{t}"


def find_ppg_engine(engines: Mapping[str, object], batch: int, t: int):
    """(name, bucket frames) of the smallest PPG engine in `engines` at this
    batch whose bucket covers `t` fbank frames, or None; the caller pads its
    features to the bucket (reference: f5e_tts_tpu/utils/aot.py:167-183)."""
    import re

    pat = re.compile(rf"^ppg_b{batch}_t(\d+)$")
    best = None
    for name in engines:
        m = pat.match(name)
        if m and int(m.group(1)) >= t and (best is None or int(m.group(1)) < best[1]):
            best = (name, int(m.group(1)))
    return best


class PPGGraph:
    """`extractor.mel_to_ppg` of one (batch, fbank frames) bucket captured as
    a CUDA graph: `run(feats, feat_lens)` gives mel_to_ppg's (PPG, true
    lengths) of features padded to the bucket, with the same bits.

    The extractor's params and the map mode's tensors are read by address
    (update them in place, never rebind them), and the encoder's position
    table is the device copy cached by `models/conformer.py: _pos_table`,
    so nothing in the graph copies from the host or reads a length on it."""

    def __init__(self, extractor, t: int, batch: int = 1, pool=None, lock=None):
        import threading

        self.extractor, self.t, self.batch = extractor, t, batch
        self._lock = lock or threading.Lock()
        dev = extractor.device
        # the static inputs, allocated outside the graph's pool
        self._feats = torch.zeros((batch, t, extractor.cfg.input_dim), device=dev)
        self._lens = torch.full((batch,), t, dtype=torch.int32, device=dev)
        # one eager call first, on a side stream: library handles, workspaces
        # and the cached position table are built then, never in a capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            extractor.mel_to_ppg(self._feats, self._lens)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._stream = torch.cuda.current_stream(dev)
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=self.pool):
            self._ppg, self._true_len = extractor.mel_to_ppg(self._feats, self._lens)

    @torch.no_grad()
    def run(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """((batch, t', 256) PPG, (batch,) true lengths) of (batch, t, 80)
        features and their lengths, as fresh tensors."""
        if tuple(feats.shape) != tuple(self._feats.shape):
            raise ValueError(f"PPG engine of shape {tuple(self._feats.shape)} got "
                             f"{tuple(feats.shape)}")
        if torch.cuda.current_stream(self._feats.device) != self._stream:
            raise RuntimeError("a PPG engine replays on the stream it was captured on")
        with self._lock:
            self._feats.copy_(feats)
            self._lens.copy_(feat_lens)
            self.graph.replay()
            return self._ppg.clone(), self._true_len.clone()


def capture_ppg_buckets(extractor, frame_buckets: Sequence[int] = (400, 800, 1600, 3200),
                        batch: int = 1) -> dict:
    """One `PPGGraph` per fbank-length bucket of a `PPGExtractor` on the
    card, all in one pool -> {ppg_engine_name(batch, t): engine}. The
    counterpart of the JAX package's `export_ppg_buckets` (the exported
    mel -> PPG computation per bucket, f5e_tts_tpu/utils/aot.py:137-164).
    A capture that fails raises."""
    import threading

    if extractor.device.type != "cuda":
        raise RuntimeError(f"CUDA-graph capture needs an extractor on a CUDA device, not "
                           f"{extractor.device}")
    pool, lock = torch.cuda.graph_pool_handle(), threading.Lock()
    return {ppg_engine_name(batch, t): PPGGraph(extractor, t, batch, pool, lock)
            for t in frame_buckets}
