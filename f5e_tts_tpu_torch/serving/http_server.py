"""HTTP JSON/wav TTS endpoint (counterpart of `f5e_tts_tpu/serving/http_server.py`).

reference: the Triton python-backend + HTTP client pair
(src/f5_tts/runtime/triton_trtllm/model_repo_f5_tts/f5_tts/1/model.py +
client_http.py). Requests POST JSON {"text": ..., ["nfe": N], ["seed": S]}
to /tts and receive a 16-bit PCM wav body; GET /health answers "ok".

Warm-up is the port's capture: before the server takes a request,
`warm_up_buckets` captures the sampler of every duration bucket as CUDA
graphs (and with a batcher, every batch size it runs), so no request pays
for eager launches or a capture. The JAX server's persistent compilation
cache has no counterpart: a CUDA graph cannot be written to disk.

    python -m f5e_tts_tpu_torch.serving.http_server --ref_audio ref.wav \\
        --ref_text "..." [--port 8000] [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from f5e_tts_tpu_torch.serving.batcher import batch_sizes_served
from f5e_tts_tpu_torch.utils.aot import capture_sampler_buckets


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """A mono 16-bit PCM wav file of float samples in [-1, 1]."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def warm_up_buckets(engine, ref_mel: np.ndarray, ref_text: str, nfe: int,
                    buckets: Optional[Sequence[int]] = None,
                    timesteps: Optional[Sequence[float]] = None,
                    cfg_strength: Optional[float] = None) -> list:
    """Capture, then run once, the sampler of every duration bucket longer
    than the prompt (default: `engine.buckets`); returns the names of the
    engines captured. The JAX warm-up jit-compiles these shapes.

    With a batcher attached whose nfe is `nfe`, its configuration is
    captured for every batch size it runs (1, 2, 4, ..., max_batch) and
    each is run through the batcher by that many requests at once;
    otherwise the direct path's batch of one. An MMDiT's engines take a
    text length: the direct path's the JAX export's default (256, which
    holds every text of up to 256 padded ids), the batcher's the padded
    length of the warm-up text, the shape the JAX warm-up compiles (the
    batcher replays an engine only at its batch's own text length). A
    capture records in CUDA's global mode, so this must run before a
    server takes requests, and a failed capture raises. On the CPU nothing
    is captured and the requests run eagerly. `ref_mel` is (1, frames,
    mel)."""
    buckets = buckets or engine.buckets
    ref_frames = ref_mel.shape[1]
    icfg = engine.infer_cfg
    bt = engine.batcher if engine.batcher is not None and nfe == engine.batcher.nfe else None
    capture = engine.device.type == "cuda"
    names = []
    for bucket in buckets:
        if bucket <= ref_frames:
            continue
        duration = min(bucket, icfg.max_duration)
        if bt is not None:
            sizes = batch_sizes_served(bt.max_batch)
            ids = engine.tokenize([ref_text + " warm up."])[0]
            ids = ids[ids >= 0]
            if capture and bt.sway == icfg.sway_sampling_coef:
                cfg = None if bt.cfg_strength == icfg.cfg_strength else bt.cfg_strength
                nt = -(-len(ids) // bt.text_pad_to) * bt.text_pad_to  # the batcher's text length
                names += capture_sampler_buckets(engine, [bucket], nfe=bt.nfe,
                                                 timesteps=bt.timesteps, cfg_strength=cfg,
                                                 batches=sizes, text_len=nt)
            for k in sizes:
                futs = [bt.submit(ref_mel[0], ids, duration, seed=0) for _ in range(k)]
                for f in futs:
                    f.result()
        else:
            if capture:
                names += capture_sampler_buckets(engine, [bucket], nfe=nfe, timesteps=timesteps,
                                                 cfg_strength=cfg_strength)
            with torch.inference_mode():
                engine.synthesize_chunk(ref_mel, ref_text + " warm up.", duration,
                                        nfe_steps=nfe, timesteps=timesteps,
                                        cfg_strength=cfg_strength, seed=0)
    return names


def enable_compilation_cache(path: str) -> None:
    """The JAX server's persistent XLA compilation cache has no counterpart
    in the port: its engines are CUDA graphs, which cannot be written to
    disk. Raises; the servers capture their engines at start instead
    (`warm_up_buckets`)."""
    raise NotImplementedError(
        f"no compilation cache ({path!r}): the port's sampler engines are CUDA graphs, which "
        "cannot be written to disk; the server captures them at start (warm_up_buckets)")


class TTSHandler(BaseHTTPRequestHandler):
    """Handlers run concurrently (ThreadingHTTPServer), each in inference
    mode; concurrent /tts requests co-batch in the engine's batcher when one
    is attached. `make_server` binds the class attributes in a subclass of
    its own."""

    engine = None
    ref_audio = None
    ref_sr = None
    ref_text = ""
    nfe = 32
    timesteps = None  # an explicit grid baked at serve() time
    cfg_strength = None  # a non-default guidance weight

    def log_message(self, fmt, *args):  # quiet
        pass

    def do_GET(self):
        if self.path == "/health":
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")
        else:
            self.send_response(404)
            self.end_headers()

    def do_POST(self):
        if self.path != "/tts":
            self.send_response(404)
            self.end_headers()
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            text = req["text"]
            nfe = int(req.get("nfe", self.nfe))
            with torch.inference_mode():
                out, sr, _ = self.engine.infer(
                    self.ref_audio, self.ref_sr, self.ref_text, text, nfe_steps=nfe,
                    timesteps=self.timesteps, cfg_strength=self.cfg_strength,
                    seed=int(req.get("seed", 0)))
            body = wav_bytes(out, sr)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except Exception as e:  # noqa: BLE001 -- the request fails, the server serves on
            msg = json.dumps({"error": str(e)}).encode()
            self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(msg)))
            self.end_headers()
            self.wfile.write(msg)


def make_server(engine, ref_audio: np.ndarray, ref_sr: int, ref_text: str,
                host: str = "0.0.0.0", port: int = 8000, nfe: int = 32, warm: bool = True,
                max_batch: int = 4, batch_window_ms: float = 20.0,
                wire_device: str = "float32", xfer_chunks: int = 1,
                timesteps: Optional[Sequence[float]] = None,
                cfg_strength: Optional[float] = None) -> ThreadingHTTPServer:
    """Attach a batcher (`max_batch` > 0, wav only), warm up (capture) and
    bind the server, not yet serving; port 0 binds a free port
    (`server.server_address`)."""
    if timesteps is not None:
        nfe = len(timesteps) - 1  # the grid subsumes nfe
    if max_batch > 0 and engine.batcher is None:
        engine.enable_batching(max_batch=max_batch, window_ms=batch_window_ms, nfe_steps=nfe,
                               return_mel=False, wire_dtype=wire_device,
                               xfer_chunks=xfer_chunks, timesteps=timesteps,
                               cfg_strength=cfg_strength)
    if warm:
        ref_mel = engine._reference(np.asarray(ref_audio, np.float32), ref_sr)[2]
        warm_up_buckets(engine, ref_mel, ref_text, nfe, timesteps=timesteps,
                        cfg_strength=cfg_strength)
    handler = type("BoundTTSHandler", (TTSHandler,), dict(
        engine=engine, ref_audio=ref_audio, ref_sr=ref_sr, ref_text=ref_text, nfe=nfe,
        timesteps=tuple(timesteps) if timesteps is not None else None,
        cfg_strength=cfg_strength))
    return ThreadingHTTPServer((host, port), handler)


def serve(engine, ref_audio, ref_sr, ref_text, host="0.0.0.0", port=8000, nfe=32,
          warm=True, max_batch: int = 4, batch_window_ms: float = 20.0,
          wire_device: str = "float32", xfer_chunks: int = 1,
          timesteps=None, cfg_strength=None):
    """`make_server`, then serve until interrupted."""
    srv = make_server(engine, ref_audio, ref_sr, ref_text, host, port, nfe, warm, max_batch,
                      batch_window_ms, wire_device, xfer_chunks, timesteps, cfg_strength)
    print(f"HTTP TTS on {host}:{srv.server_address[1]} (POST /tts)", flush=True)
    with srv:
        srv.serve_forever()


def main(argv=None):
    from f5e_tts_tpu_torch.api import F5TTS
    from f5e_tts_tpu_torch.infer.audio import read_wav

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--nfe", type=int, default=32)
    p.add_argument("--no_warm", action="store_true")
    p.add_argument("--max_batch", type=int, default=4,
                   help="dynamic-batching max batch (0 disables the batcher)")
    p.add_argument("--batch_window_ms", type=float, default=20.0)
    p.add_argument("--wire_device", choices=["float32", "int16"], default="float32",
                   help="int16: round the wav to PCM16 on the card in the batcher, halving "
                        "the bytes copied to the host")
    p.add_argument("--xfer_chunks", type=int, default=1,
                   help=">1: copy the batch's wavs in row chunks so early requests resolve "
                        "before the whole batch has crossed")
    p.add_argument("--prune", default=None,
                   help="EPSS keep indices into the --nfe sway grid (comma-separated); "
                        "bakes the pruned ODE schedule")
    p.add_argument("--cfg", type=float, default=None, help="cfg_strength override")
    p.add_argument("--compilation_cache", default="",
                   help="not available in the port (CUDA graphs cannot be written to disk): "
                        "raises; warm-up captures the engines at start")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.compilation_cache:
        enable_compilation_cache(args.compilation_cache)
    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                vocoder_local_path=args.vocoder_local_path, device=args.device)
    wav, sr = read_wav(args.ref_audio)
    grid = None
    if args.prune:
        from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps

        grid = pruned_sway_timesteps([int(i) for i in args.prune.split(",")],
                                     base_steps=args.nfe)
    serve(tts.engine, wav, sr, args.ref_text, args.host, args.port, args.nfe,
          warm=not args.no_warm, max_batch=args.max_batch,
          batch_window_ms=args.batch_window_ms, wire_device=args.wire_device,
          xfer_chunks=args.xfer_chunks, timesteps=grid, cfg_strength=args.cfg)


if __name__ == "__main__":
    main()
