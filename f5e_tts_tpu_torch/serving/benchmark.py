"""Serving benchmark harness (counterpart of `f5e_tts_tpu/serving/benchmark.py`):
RTF and latency percentiles, offline, concurrent, open-loop or client-server.

reference: src/f5_tts/runtime/triton_trtllm/benchmark.py (warm-up, RTF =
decode_time / audio_duration :542-552) and client_grpc.py's latency
percentiles. Warm-up runs the workload once first (with captured engines
attached that replays them; without, the eager path's first-use work);
offline mode times the engine directly; server mode drives the socket
server like a fleet of clients (threads). Every thread that runs the engine
runs it in inference mode.

    python -m f5e_tts_tpu_torch.serving.benchmark offline --ref_audio ref.wav --nfe 16
    python -m f5e_tts_tpu_torch.serving.benchmark server --host 127.0.0.1 --port 9998 \\
        --concurrency 2 --requests 26
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import List

import numpy as np
import torch


def percentile_stats(latencies: List[float]) -> dict:
    a = np.asarray(latencies)
    if a.size == 0:
        return {}
    return {
        "p50_ms": float(np.percentile(a, 50) * 1e3),
        "p90_ms": float(np.percentile(a, 90) * 1e3),
        "p95_ms": float(np.percentile(a, 95) * 1e3),
        "p99_ms": float(np.percentile(a, 99) * 1e3),
        "mean_ms": float(a.mean() * 1e3),
    }


def _infer(engine, *args, **kwargs):
    """engine.infer in inference mode (a mode of the calling thread)."""
    with torch.inference_mode():
        return engine.infer(*args, **kwargs)


def bench_offline(engine, ref_wav: np.ndarray, ref_sr: int, ref_text: str,
                  texts: List[str], nfe: int, warmup: bool = True) -> dict:
    """Offline RTF over a list of prompts (benchmark.py offline mode)."""
    if warmup:
        _ = _infer(engine, ref_wav, ref_sr, ref_text, texts[0], nfe_steps=nfe)
    t0 = time.perf_counter()
    total_audio = 0.0
    latencies = []
    for text in texts:
        t1 = time.perf_counter()
        wav, sr, _ = _infer(engine, ref_wav, ref_sr, ref_text, text, nfe_steps=nfe)
        latencies.append(time.perf_counter() - t1)
        total_audio += len(wav) / sr
    wall = time.perf_counter() - t0
    return {"mode": "offline", "nfe": nfe, "n": len(texts),
            "rtf": wall / max(total_audio, 1e-9),
            "audio_s": total_audio, "wall_s": wall, **percentile_stats(latencies)}


def bench_concurrent(engine, ref_wav: np.ndarray, ref_sr: int, ref_text: str,
                     texts: List[str], nfe: int, concurrency: int = 4,
                     warmup: bool = True, timesteps=None,
                     cfg_strength=None) -> dict:
    """Concurrent offline benchmark: N client threads against one engine.

    With a DynamicBatcher attached (engine.enable_batching) concurrent
    requests coalesce into folded sampler batches — the Triton
    dynamic_batching scenario (runtime/triton_trtllm/README.md:64,
    concurrency 2). Reports RTF, latency percentiles, and the observed batch
    size distribution."""
    if warmup:
        # warm pass: run the full workload once at the measured concurrency,
        # so every (bucket, batch size) and vocoder length the timed run
        # meets has run once before timing
        warm_q = list(texts)
        wlock = threading.Lock()

        def warm_worker():
            while True:
                with wlock:
                    if not warm_q:
                        return
                    t = warm_q.pop()
                _infer(engine, ref_wav, ref_sr, ref_text, t, nfe_steps=nfe,
                       timesteps=timesteps, cfg_strength=cfg_strength)

        ths = [threading.Thread(target=warm_worker) for _ in range(concurrency)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
    if engine.batcher is not None:
        engine.batcher.batch_sizes.clear()
        engine.batcher.stage_times.clear()

    results = []
    lock = threading.Lock()
    queue = list(texts)

    def worker():
        while True:
            with lock:
                if not queue:
                    return
                text = queue.pop()
            t1 = time.perf_counter()
            wav, sr, _ = _infer(engine, ref_wav, ref_sr, ref_text, text,
                                      nfe_steps=nfe, timesteps=timesteps,
                                      cfg_strength=cfg_strength)
            with lock:
                results.append((time.perf_counter() - t1, len(wav) / sr))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total_audio = sum(r[1] for r in results)
    sizes = list(engine.batcher.batch_sizes) if engine.batcher is not None else []
    out = {"mode": "concurrent", "concurrency": concurrency, "nfe": nfe,
           "n": len(results), "rtf": wall / max(total_audio, 1e-9),
           "audio_s": total_audio, "wall_s": wall,
           "batch_sizes": sizes,
           "mean_batch": float(np.mean(sizes)) if sizes else 1.0,
           **percentile_stats([r[0] for r in results])}
    out.update(stage_summary(engine, wall, total_audio))
    return out


def stage_summary(engine, wall: float, total_audio: float) -> dict:
    """Aggregate the batcher's per-batch stage timeline into totals plus an
    RTF net of the copies to the host (`mel_xfer` + `wav_xfer`, the time to
    fetch the results). Conservative: overlapped copies (the two-thread
    pipeline) are subtracted in full even where they added no wall time."""
    if engine.batcher is None or not engine.batcher.stage_times:
        return {}
    st = engine.batcher.stage_times
    tot = {k: float(sum(s[k] for s in st))
           for k in ("sampler_s", "mel_xfer_s", "host_s", "vocode_s", "wav_xfer_s")}
    xfer = tot["mel_xfer_s"] + tot["wav_xfer_s"]
    return {"stage_totals": {k: round(v, 4) for k, v in tot.items()},
            "transfer_s": round(xfer, 4),
            "rtf_net_of_transfer": round(max(wall - xfer, 0.0) / max(total_audio, 1e-9), 5)}


def bench_openloop(engine, ref_wav: np.ndarray, ref_sr: int, ref_text: str,
                   texts: List[str], nfe: int, qps: float,
                   seed: int = 0, warmup: bool = True, timesteps=None,
                   cfg_strength=None) -> dict:
    """Open-loop benchmark: Poisson arrivals at a target QPS.

    The reference's benchmark (runtime/triton_trtllm/benchmark.py) and our
    `concurrent` mode are closed-loop: N workers, next request only after the
    previous returns, so concurrency == fold size and the two-stage pipeline
    never has a queued next batch to overlap with. Real serving is open-loop —
    requests arrive on their own clock while a batch is in flight. Each
    request is launched at its scheduled arrival time regardless of
    completion; latency is measured from the SCHEDULED arrival (so queueing
    delay counts, the standard open-loop convention)."""
    if warmup:
        # batch 1 per distinct text (covers every bucket the workload hits)
        for t in set(texts):
            _infer(engine, ref_wav, ref_sr, ref_text, t, nfe_steps=nfe,
                   timesteps=timesteps, cfg_strength=cfg_strength)
        # then every power-of-two batch the batcher can run (open-loop
        # arrivals make batches of 1..max_batch)
        k = 2
        while engine.batcher is not None and k <= engine.batcher.max_batch:
            ths = [threading.Thread(target=_infer,
                                    args=(engine, ref_wav, ref_sr, ref_text,
                                          texts[i % len(texts)]),
                                    kwargs={"nfe_steps": nfe,
                                            "timesteps": timesteps,
                                            "cfg_strength": cfg_strength})
                   for i in range(k)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            k *= 2
    if engine.batcher is not None:
        engine.batcher.batch_sizes.clear()
        engine.batcher.stage_times.clear()

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, size=len(texts)))
    results = []
    lock = threading.Lock()

    def worker(i, text, arrive_at, t0):
        now = time.perf_counter() - t0
        if arrive_at > now:
            time.sleep(arrive_at - now)
        wav, sr, _ = _infer(engine, ref_wav, ref_sr, ref_text, text, nfe_steps=nfe,
                                  timesteps=timesteps, cfg_strength=cfg_strength)
        done = time.perf_counter() - t0
        with lock:
            results.append((done - arrive_at, len(wav) / sr))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i, t, a, t0))
               for i, (t, a) in enumerate(zip(texts, arrivals))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total_audio = sum(r[1] for r in results)
    sizes = list(engine.batcher.batch_sizes) if engine.batcher is not None else []
    out = {"mode": "openloop", "qps_offered": qps,
           "qps_achieved": len(results) / wall, "nfe": nfe,
           "n": len(results), "rtf": wall / max(total_audio, 1e-9),
           "audio_s": total_audio, "wall_s": wall,
           "throughput_utt_s": len(results) / wall,
           "batch_sizes": sizes,
           "mean_batch": float(np.mean(sizes)) if sizes else 1.0,
           **percentile_stats([r[0] for r in results])}
    out.update(stage_summary(engine, wall, total_audio))
    return out


def bench_server(host: str, port: int, texts: List[str], concurrency: int = 2,
                 sample_rate: int = 24_000) -> dict:
    """Client-server benchmark (client_grpc.py / benchmark.py client mode)."""
    from f5e_tts_tpu_torch.serving.socket_client import request

    results = []
    lock = threading.Lock()
    queue = list(texts)

    def worker():
        while True:
            with lock:
                if not queue:
                    return
                text = queue.pop()
            t0 = time.perf_counter()
            wav, first = request(host, port, text)
            total = time.perf_counter() - t0
            with lock:
                results.append((total, first, len(wav) / sample_rate))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total_audio = sum(r[2] for r in results)
    return {"mode": "server", "concurrency": concurrency, "n": len(results),
            "rtf": wall / max(total_audio, 1e-9),
            "first_chunk": percentile_stats([r[1] for r in results if r[1]]),
            "total": percentile_stats([r[0] for r in results])}


DEFAULT_TEXTS = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Machine learning systems convert text into natural sounding speech.",
    "A journey of a thousand miles begins with a single step forward.",
] * 9  # ~26 prompts, matching the reference benchmark set size


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)
    po = sub.add_parser("offline")
    po.add_argument("--model", default="F5TTS_v1_Base")
    po.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    po.add_argument("--ckpt", default="")
    po.add_argument("--vocab", default="")
    po.add_argument("--vocoder_local_path", default=None)
    po.add_argument("--ref_audio", required=True)
    po.add_argument("--ref_text", default="some call me nature.")
    po.add_argument("--nfe", type=int, default=16)
    pc = sub.add_parser("concurrent")
    pc.add_argument("--model", default="F5TTS_v1_Base")
    pc.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pc.add_argument("--ckpt", default="")
    pc.add_argument("--vocab", default="")
    pc.add_argument("--vocoder_local_path", default=None)
    pc.add_argument("--ref_audio", required=True)
    pc.add_argument("--ref_text", default="some call me nature.")
    pc.add_argument("--nfe", type=int, default=16)
    pc.add_argument("--concurrency", type=int, default=4)
    pc.add_argument("--max_batch", type=int, default=4)
    pc.add_argument("--batch_window_ms", type=float, default=20.0)
    pc.add_argument("--wav_only", action="store_true",
                    help="return_mel=False: skip the generated-mel device "
                         "fetch (the wav-only server config)")
    pc.add_argument("--wire", choices=["float32", "int16"], default="float32",
                    help="int16: pcm16-quantize the wav on device, halving "
                         "the device->host fetch bytes")
    pc.add_argument("--prune", default=None,
                    help="EPSS keep indices into the --nfe sway grid "
                         "(comma-separated, e.g. '0,1,2,3,5,9,17,32'); bakes "
                         "the pruned grid into the batcher")
    pc.add_argument("--cfg", type=float, default=None,
                    help="cfg_strength override; 0 = CFG-distilled "
                         "single-pass serving (train/distill.py)")
    pc.add_argument("--xfer-chunks", type=int, default=1,
                    help=">1 (with --wav-only): fetch the batch's wavs in "
                         "row chunks so early requests resolve before the "
                         "whole batch has crossed the device link")
    pl = sub.add_parser("openloop")
    pl.add_argument("--model", default="F5TTS_v1_Base")
    pl.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pl.add_argument("--ckpt", default="")
    pl.add_argument("--vocab", default="")
    pl.add_argument("--vocoder_local_path", default=None)
    pl.add_argument("--ref_audio", required=True)
    pl.add_argument("--ref_text", default="some call me nature.")
    pl.add_argument("--nfe", type=int, default=16)
    pl.add_argument("--qps", type=float, default=2.0)
    pl.add_argument("--requests", type=int, default=26)
    pl.add_argument("--max_batch", type=int, default=4)
    pl.add_argument("--batch_window_ms", type=float, default=20.0)
    pl.add_argument("--wav_only", action="store_true",
                    help="return_mel=False: skip the generated-mel device "
                         "fetch (the wav-only server config)")
    pl.add_argument("--wire", choices=["float32", "int16"], default="float32",
                    help="int16: pcm16-quantize the wav on device, halving "
                         "the device->host fetch bytes")
    pl.add_argument("--prune", default=None,
                    help="EPSS keep indices into the --nfe sway grid "
                         "(comma-separated, e.g. '0,1,2,3,5,9,17,32'); bakes "
                         "the pruned grid into the batcher")
    pl.add_argument("--cfg", type=float, default=None,
                    help="cfg_strength override; 0 = CFG-distilled "
                         "single-pass serving (train/distill.py)")
    pl.add_argument("--xfer-chunks", type=int, default=1,
                    help=">1 (with --wav-only): fetch the batch's wavs in "
                         "row chunks so early requests resolve before the "
                         "whole batch has crossed the device link")
    ps = sub.add_parser("server")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=9998)
    ps.add_argument("--concurrency", type=int, default=2)
    ps.add_argument("--requests", type=int, default=26)
    args = p.parse_args(argv)

    if args.mode == "offline":
        from f5e_tts_tpu_torch.api import F5TTS
        from f5e_tts_tpu_torch.infer.audio import read_wav

        tts = F5TTS(model=args.model, ckpt_file=args.ckpt, vocab_file=args.vocab,
                    vocoder_local_path=args.vocoder_local_path, device=args.device)
        wav, sr = read_wav(args.ref_audio)
        stats = bench_offline(tts.engine, wav, sr, args.ref_text,
                              DEFAULT_TEXTS[:26], args.nfe)
    elif args.mode == "concurrent":
        from f5e_tts_tpu_torch.api import F5TTS
        from f5e_tts_tpu_torch.infer.audio import read_wav

        tts = F5TTS(model=args.model, ckpt_file=args.ckpt, vocab_file=args.vocab,
                    vocoder_local_path=args.vocoder_local_path, device=args.device)
        grid = None
        if args.prune:
            from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps
            grid = pruned_sway_timesteps([int(i) for i in args.prune.split(",")],
                                         base_steps=args.nfe)
        if args.max_batch > 0:
            tts.engine.enable_batching(max_batch=args.max_batch,
                                       window_ms=args.batch_window_ms,
                                       nfe_steps=args.nfe,
                                       return_mel=not args.wav_only,
                                       wire_dtype=args.wire,
                                       xfer_chunks=args.xfer_chunks,
                                       timesteps=grid, cfg_strength=args.cfg)
        wav, sr = read_wav(args.ref_audio)
        stats = bench_concurrent(tts.engine, wav, sr, args.ref_text,
                                 DEFAULT_TEXTS[:26], args.nfe,
                                 concurrency=args.concurrency, timesteps=grid,
                                 cfg_strength=args.cfg)
    elif args.mode == "openloop":
        from f5e_tts_tpu_torch.api import F5TTS
        from f5e_tts_tpu_torch.infer.audio import read_wav

        tts = F5TTS(model=args.model, ckpt_file=args.ckpt, vocab_file=args.vocab,
                    vocoder_local_path=args.vocoder_local_path, device=args.device)
        grid = None
        if args.prune:
            from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps
            grid = pruned_sway_timesteps([int(i) for i in args.prune.split(",")],
                                         base_steps=args.nfe)
        if args.max_batch > 0:
            tts.engine.enable_batching(max_batch=args.max_batch,
                                       window_ms=args.batch_window_ms,
                                       nfe_steps=args.nfe,
                                       return_mel=not args.wav_only,
                                       wire_dtype=args.wire,
                                       xfer_chunks=args.xfer_chunks,
                                       timesteps=grid, cfg_strength=args.cfg)
        wav, sr = read_wav(args.ref_audio)
        texts = (DEFAULT_TEXTS * (args.requests // len(DEFAULT_TEXTS) + 1))[: args.requests]
        stats = bench_openloop(tts.engine, wav, sr, args.ref_text, texts,
                               args.nfe, qps=args.qps, timesteps=grid,
                               cfg_strength=args.cfg)
    else:
        stats = bench_server(args.host, args.port, DEFAULT_TEXTS[: args.requests],
                             args.concurrency)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
