"""Dynamic request batcher (counterpart of `f5e_tts_tpu/serving/batcher.py`).

reference: the Triton config (model_repo_f5_tts/f5_tts/config.pbtxt:15-18,
max_batch 4 + dynamic batching) in front of the TRT-LLM engine. A worker
thread collects concurrent requests for up to `window_ms`, pads them into
one (b, bucket) sampler call, b the next power of two >= the requests and at
most `max_batch`, and a finisher thread decodes the batch and resolves each
request's future.

The sampler of a batch: on the card, the captured (b, bucket) engine of the
batcher's configuration when the TTSEngine holds one (`utils/aot.py:
capture_sampler_buckets(batches=)`; the servers' `warm_up_buckets` captures
them before serving), else `cfm.sample` eagerly. An MMDiT's engine is
replayed only when its text length is the batch's padded text length nt:
the JAX batcher computes at nt and never widens the text, which would
change an MMDiT's output. Either way each request's
noise comes from its own seed (`cfm.noise_like(seeds=)`, JAX's threefry
stream), so a request's output does not depend on its batch-mates or its
slot, and equals the direct path's (`TTSEngine.synthesize_chunk(seed=)`
draws the same bits) and the JAX batcher's for the same seed. The JAX
batcher jit-compiles each (b, bucket) instead.

Threads: inference mode and the current CUDA stream belong to a thread, so
both threads enter inference mode. The worker launches on its default
stream, the one the engines are captured on, and records a CUDA event after
the sampler's launch; the finisher waits on that event, not on the device,
and decodes on a stream of its own, so batch k decodes on the card while
batch k+1's sampler runs (on one stream it would wait behind that whole
replay). A batch's `stage_times["sampler_s"]` is the device time between
events recorded before and after its sampler's launch (on the CPU, the
sampler's host time).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from f5e_tts_tpu_torch.infer.pipeline import MEL_FLOOR, pick_bucket, slice_gen
from f5e_tts_tpu_torch.models import cfm as fcfm
from f5e_tts_tpu_torch.utils.aot import engine_name, text_shaped


def batch_sizes_served(max_batch: int) -> List[int]:
    """The sampler batch sizes a batcher of `max_batch` runs: the powers of
    two below it, then `max_batch` itself."""
    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    return sizes + [max_batch]


@dataclass
class _Request:
    ref_mel: np.ndarray  # (ref_frames, mel)
    text_ids: np.ndarray  # (NT,)
    duration: int
    seed: int
    future: Future


class _SamplerClock:
    """The sampler's time: CUDA events around its launch on the card (the
    finisher waits on the end event), the host's clock on the CPU, where
    the sampler returns when it is done."""

    def __init__(self, device: torch.device):
        self.events = None
        if device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.seconds = 0.0

    def start(self) -> None:
        self.t0 = time.perf_counter()
        if self.events:
            self.events[0].record()

    def stop(self) -> None:
        if self.events:
            self.events[1].record()
        else:
            self.seconds = time.perf_counter() - self.t0

    def wait(self) -> float:
        """Block until the sampler is done; its seconds."""
        if self.events:
            self.events[1].synchronize()
            return self.events[0].elapsed_time(self.events[1]) / 1e3
        return self.seconds


def _host_f32(wav: torch.Tensor) -> np.ndarray:
    """A wav tensor on the host in float32; PCM16 scaled back by 1/32767."""
    if wav.dtype == torch.int16:
        return wav.cpu().numpy().astype(np.float32) / 32767.0
    return wav.float().cpu().numpy()


class DynamicBatcher:
    def __init__(self, engine, max_batch: int = 4, window_ms: float = 20.0,
                 nfe_steps: Optional[int] = None, cfg_strength: Optional[float] = None,
                 sway: Optional[float] = None, text_pad_to: int = 64,
                 return_mel: bool = True, wire_dtype: str = "float32",
                 xfer_chunks: int = 1, timesteps: Optional[Sequence[float]] = None):
        """A batcher over `engine` (a TTSEngine). `wire_dtype="int16"` rounds
        the wav to PCM16 on the card, inside the fused slice + decode, so the
        copy to the host moves half the bytes; the futures still resolve
        float32 wavs. `xfer_chunks` > 1 (with `return_mel=False`) copies the
        batch's wavs in that many row chunks, so early requests resolve
        while later rows still cross. `return_mel=False` resolves (wav,
        None). nfe, cfg, sway and the explicit grid `timesteps` (which
        overrides nfe) are the one sampler configuration it serves."""
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype {wire_dtype!r} (use 'float32' or 'int16')")
        self.engine = engine
        self.wire_dtype = wire_dtype
        self.xfer_chunks = xfer_chunks
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        icfg = engine.infer_cfg
        self.nfe = nfe_steps if nfe_steps is not None else icfg.nfe_steps
        self.cfg_strength = cfg_strength if cfg_strength is not None else icfg.cfg_strength
        self.sway = sway if sway is not None else icfg.sway_sampling_coef
        self.timesteps = tuple(timesteps) if timesteps is not None else None
        if self.timesteps is not None:
            self.nfe = len(self.timesteps) - 1
        self.text_pad_to = text_pad_to
        self.return_mel = return_mel
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = False
        # the size of every batch run (tests and the benchmark check that
        # concurrent requests co-batch)
        self.batch_sizes: List[int] = []
        # per batch, seconds: sampler (device), mel copy to the host, vocoder
        # (device), wav copy to the host, host packing and slicing
        self.stage_times: List[dict] = []
        # at most two launched batches wait for the finisher
        self.finish_queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._decode_stream = (torch.cuda.Stream(engine.device)
                               if engine.device.type == "cuda" else None)
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()
        self.finisher = threading.Thread(target=self._finish_loop, daemon=True)
        self.finisher.start()

    def submit(self, ref_mel: np.ndarray, text_ids: np.ndarray, duration: int,
               seed: int = 0) -> Future:
        """Queue one request: ref_mel (ref_frames, mel), text_ids (NT,) without
        padding, total frames `duration`; the future resolves (wav, generated
        mel or None)."""
        fut: Future = Future()
        self.queue.put(_Request(ref_mel, text_ids, duration, seed, fut))
        return fut

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the worker after its current batch, then the finisher after
        the batches it holds."""
        self._stop = True
        self.worker.join(timeout)
        self.finish_queue.put(None)
        self.finisher.join(timeout)

    def engine_for(self, batch: int, bucket: int, text_len: int):
        """The captured sampler engine of (batch, bucket) at this batcher's
        configuration, for an MMDiT of exactly the batch's padded text
        length `text_len`, or None. Engines are captured at the engine's
        default sway, and name a non-default guidance weight."""
        icfg = self.engine.infer_cfg
        if self.sway != icfg.sway_sampling_coef:
            return None
        cfg = None if self.cfg_strength == icfg.cfg_strength else self.cfg_strength
        tl = text_len if text_shaped(self.engine.arch) else None
        return self.engine.engines.get(
            engine_name(self.nfe, bucket, self.timesteps, cfg, batch, tl))

    # ------------------------------------------------------------------

    def _collect(self) -> List[_Request]:
        try:
            first = self.queue.get(timeout=0.25)
        except queue.Empty:
            return []
        batch = [first]
        t0 = time.perf_counter()
        while len(batch) < self.max_batch:
            remaining = self.window_s - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self):
        with torch.inference_mode():
            while not self._stop:
                batch = self._collect()
                if not batch:
                    continue
                try:
                    self._process(batch)
                except Exception as e:  # noqa: BLE001 -- the worker serves on
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)

    def _finish_loop(self):
        on_stream = (torch.cuda.stream(self._decode_stream) if self._decode_stream is not None
                     else contextlib.nullcontext())
        with torch.inference_mode(), on_stream:
            while True:
                item = self.finish_queue.get()
                if item is None:  # stop sentinel
                    return
                try:
                    self._finish(*item)
                except Exception as e:  # noqa: BLE001 -- the finisher serves on
                    for r in item[0]:
                        if not r.future.done():
                            r.future.set_exception(e)

    def _process(self, batch: List[_Request]):
        self.batch_sizes.append(len(batch))
        eng = self.engine
        dev = eng.device
        mel_dim = eng.mel.n_mel_channels
        # the next power of two >= the requests: a lone request costs a batch
        # of one, and each bucket has log2(max_batch) + 1 sampler shapes
        b = next(s for s in batch_sizes_served(self.max_batch) if s >= len(batch))
        bucket = pick_bucket(max(r.duration for r in batch), eng.buckets)
        nt = -(-max(len(r.text_ids) for r in batch) // self.text_pad_to) * self.text_pad_to

        # a padding slot: an empty prompt of one frame, duration 2, no text, seed 0
        conds = np.zeros((b, bucket, mel_dim), np.float32)
        lens = np.ones((b,), np.int32)
        durations = np.full((b,), 2, np.int32)
        ids = np.full((b, nt), -1, np.int32)
        seeds = [0] * b
        for i, r in enumerate(batch):
            rf = min(r.ref_mel.shape[0], bucket)
            conds[i, :rf] = r.ref_mel[:rf]
            lens[i] = rf
            durations[i] = min(max(r.duration, rf + 1, len(r.text_ids) + 1), bucket)
            ids[i, : min(len(r.text_ids), nt)] = r.text_ids[:nt]
            seeds[i] = int(r.seed) & 0x7FFFFFFF

        inputs = fcfm.prepare_inputs(torch.as_tensor(conds, device=dev),
                                     torch.as_tensor(lens, device=dev),
                                     torch.as_tensor(durations, device=dev), bucket,
                                     text_ids=torch.as_tensor(ids, device=dev))
        clock = _SamplerClock(dev)
        clock.start()
        y0 = fcfm.noise_like(None, b, bucket, mel_dim, inputs.duration, seeds=seeds)
        graph = self.engine_for(b, bucket, nt)
        if graph is not None:
            out = graph.sample(inputs, y0)
        else:
            out, _ = fcfm.sample(eng.params, eng.arch, eng.cfm, inputs, steps=self.nfe,
                                 cfg_strength=self.cfg_strength, sway_coef=self.sway,
                                 use_mask=True, y0=y0, timesteps=self.timesteps,
                                 compute_dtype=eng.compute_dtype, device=dev, state=eng.state)
        clock.stop()
        # hand the batch to the finisher while the card runs its sampler
        self.finish_queue.put((batch, out, lens, durations, clock))

    def _finish(self, batch: List[_Request], out: torch.Tensor, lens: np.ndarray,
                durations: np.ndarray, clock: _SamplerClock):
        if getattr(self.engine.vocoder_decode, "device", None) is not None:
            return self._finish_on_device(batch, out, lens, durations, clock)
        eng = self.engine
        sampler_s = clock.wait()
        t_ready = time.perf_counter()
        out = out.float().cpu().numpy()
        t_mel = time.perf_counter()
        # one vocoder call for the batch at a common length, padded with the
        # mel silence floor (decode_mel pads it on to the vocoder ladder)
        mel_gens = [out[i, int(lens[i]): int(durations[i])] for i in range(len(batch))]
        lmax = max(m.shape[0] for m in mel_gens)
        stacked = np.full((len(batch), lmax, eng.mel.n_mel_channels), MEL_FLOOR, np.float32)
        for i, m in enumerate(mel_gens):
            stacked[i, : m.shape[0]] = m
        t_pack = time.perf_counter()
        wavs = eng.decode_mel(stacked)  # a host vocoder: the decode returns the wav on the host
        t_voc = time.perf_counter()
        hop = eng.mel.hop_length
        for i, r in enumerate(batch):
            r.future.set_result((wavs[i, : mel_gens[i].shape[0] * hop], mel_gens[i]))
        self.stage_times.append({
            "fold": len(batch),
            "sampler_s": sampler_s,
            "mel_xfer_s": t_mel - t_ready,
            "host_s": t_pack - t_mel,
            "vocode_s": t_voc - t_pack,
            "wav_xfer_s": 0.0,
        })

    def _finish_on_device(self, batch: List[_Request], out: torch.Tensor, lens: np.ndarray,
                          durations: np.ndarray, clock: _SamplerClock):
        """Slice each row's generated window out of the sampler output and
        decode it on the card (one fused call where the vocoder has one),
        then copy the wavs (and the mels) to the host."""
        eng = self.engine
        dev = out.device
        sampler_s = clock.wait()
        t_ready = time.perf_counter()

        # at least one frame for the slice; results are trimmed to the true
        # generated length, so a degenerate request returns an empty wav and mel
        true_gen = np.maximum(durations - lens, 0).astype(np.int32)
        gen = np.maximum(true_gen, 1)
        pad = eng.vocoder_pad_to or 1
        L = max(-(-int(gen.max()) // pad) * pad, pad)
        starts, gen_t = torch.as_tensor(lens, device=dev), torch.as_tensor(gen, device=dev)
        decode = eng.vocoder_decode
        i16 = getattr(decode, "device_sliced_i16", None) if self.wire_dtype == "int16" else None
        fused = i16 or getattr(decode, "device_sliced", None)
        if fused is not None:
            wav_dev, mel_dev = fused(out, starts, gen_t, L)
        else:
            mel_dev = slice_gen(out, starts, gen_t, L)
            wav_dev = decode.device(mel_dev)
        if dev.type == "cuda":  # the decode, on the finisher's stream
            torch.cuda.current_stream(dev).synchronize()
        t_voc = time.perf_counter()
        hop = eng.mel.hop_length

        if self.xfer_chunks > 1 and not self.return_mel and len(batch) > 1:
            bounds = np.linspace(0, len(batch), self.xfer_chunks + 1).astype(int)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                if lo == hi:
                    continue
                part = _host_f32(wav_dev[int(lo):int(hi)])
                for j in range(int(lo), int(hi)):
                    batch[j].future.set_result((part[j - int(lo), : true_gen[j] * hop], None))
            t_wav = time.perf_counter()
            self.stage_times.append({
                "fold": len(batch),
                "sampler_s": sampler_s,
                "mel_xfer_s": 0.0,
                "host_s": time.perf_counter() - t_wav,
                "vocode_s": t_voc - t_ready,
                "wav_xfer_s": t_wav - t_voc,
            })
            return

        wavs = _host_f32(wav_dev)
        t_wav = time.perf_counter()
        mels = mel_dev.float().cpu().numpy() if self.return_mel else None
        t_mel = time.perf_counter()
        for i, r in enumerate(batch):
            mel_i = mels[i, : true_gen[i]] if mels is not None else None
            r.future.set_result((wavs[i, : true_gen[i] * hop], mel_i))
        self.stage_times.append({
            "fold": len(batch),
            "sampler_s": sampler_s,
            "mel_xfer_s": t_mel - t_wav,
            "host_s": time.perf_counter() - t_mel,
            "vocode_s": t_voc - t_ready,
            "wav_xfer_s": t_wav - t_voc,
        })
