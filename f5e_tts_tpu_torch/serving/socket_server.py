"""Raw-socket streaming TTS server (counterpart of
`f5e_tts_tpu/serving/socket_server.py`).

reference: src/f5_tts/socket_server.py:72-215 -- a TCP server; each
connection sends UTF-8 text and receives float32 PCM chunks (int16 with
`wire="pcm16"`) followed by a b"END" sentinel. The processor warms up
(captures the bucket ladder, `http_server.warm_up_buckets`) before serving,
so a first request's latency is serving latency.

    python -m f5e_tts_tpu_torch.serving.socket_server --ref_audio ref.wav \\
        --ref_text "..." [--port 9998] [--device cpu]
"""

from __future__ import annotations

import argparse
import queue
import socket
import threading
import traceback
from typing import Optional, Sequence

import numpy as np
import torch

from f5e_tts_tpu_torch.infer.audio import write_wav
from f5e_tts_tpu_torch.serving.http_server import enable_compilation_cache, warm_up_buckets
from f5e_tts_tpu_torch.serving.pcm import f32_to_pcm16_bytes


class AudioFileWriterThread(threading.Thread):
    """Background wav writer (reference: socket_server.py:32-69)."""

    def __init__(self, output_file: str, sample_rate: int):
        super().__init__(daemon=True)
        self.output_file = output_file
        self.sample_rate = sample_rate
        self.queue: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        self.chunks = []

    def run(self):
        while True:
            item = self.queue.get()
            if item is None:
                break
            self.chunks.append(item)
        if self.chunks and self.output_file:
            write_wav(self.output_file, np.concatenate(self.chunks), self.sample_rate)

    def add_chunk(self, chunk: np.ndarray):
        self.queue.put(chunk)

    def stop(self):
        self.queue.put(None)
        self.join()


class TTSStreamingProcessor:
    """The engine and the reference; streams PCM chunks per request
    (reference: socket_server.py:72-178, init + warm-up + generate_stream)."""

    def __init__(self, engine, ref_audio: np.ndarray, ref_sr: int, ref_text: str,
                 chunk_size: int = 2048, nfe_steps: Optional[int] = None,
                 warm_up: bool = True, wire: str = "f32",
                 timesteps: Optional[Sequence[float]] = None,
                 cfg_strength: Optional[float] = None):
        """`wire="pcm16"` streams int16 PCM (half the bytes) in place of the
        reference protocol's float32. An explicit grid `timesteps` overrides
        `nfe_steps`; `cfg_strength` a non-default guidance weight."""
        if wire not in ("f32", "pcm16"):
            raise ValueError(f"wire {wire!r} (use 'f32' or 'pcm16')")
        self.wire = wire
        self.engine = engine
        self.ref_audio = ref_audio
        self.ref_sr = ref_sr
        self.ref_text = ref_text
        self.chunk_size = chunk_size
        self.timesteps = tuple(timesteps) if timesteps is not None else None
        self.cfg_strength = cfg_strength
        if self.timesteps is not None:
            nfe_steps = len(self.timesteps) - 1
        self.nfe_steps = nfe_steps
        if warm_up:
            self._warm_up()

    def _warm_up(self):
        """Capture the whole duration-bucket ladder before serving
        (socket_server.py:122-136 warms one shape)."""
        ref_mel = self.engine._reference(np.asarray(self.ref_audio, np.float32), self.ref_sr)[2]
        warm_up_buckets(self.engine, ref_mel, self.ref_text or "warm up.",
                        self.nfe_steps or self.engine.infer_cfg.nfe_steps,
                        timesteps=self.timesteps, cfg_strength=self.cfg_strength)

    def generate_stream(self, text: str, send):
        """Synthesize `text`, calling send(bytes) for each chunk, then
        send(b"END"). Concurrent connections co-batch in the engine's
        batcher when one is attached."""
        with torch.inference_mode():
            stream = self.engine.infer(self.ref_audio, self.ref_sr, self.ref_text, text,
                                       nfe_steps=self.nfe_steps, streaming=True,
                                       timesteps=self.timesteps,
                                       cfg_strength=self.cfg_strength,
                                       chunk_size=self.chunk_size)
            for chunk, _sr in stream:
                if len(chunk):
                    if self.wire == "pcm16":
                        send(f32_to_pcm16_bytes(np.asarray(chunk, np.float32)))
                    else:
                        send(np.asarray(chunk, np.float32).tobytes())
        send(b"END")


def handle_client(conn: socket.socket, processor: TTSStreamingProcessor):
    try:
        with conn:
            while True:
                data = conn.recv(1024)
                if not data:
                    break
                text = data.decode("utf-8").strip()
                if not text:
                    continue
                processor.generate_stream(text, conn.sendall)
    except Exception:  # noqa: BLE001 -- one connection fails, the server serves on
        traceback.print_exc()


def listen(host: str = "0.0.0.0", port: int = 9998) -> socket.socket:
    """A listening TCP socket; port 0 binds a free one (`getsockname()[1]`)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(5)
    return srv


def serve(processor: TTSStreamingProcessor, host: str = "0.0.0.0", port: int = 9998,
          srv: Optional[socket.socket] = None):
    """Accept connections, each in a thread of its own, until the listening
    socket (`srv`, from `listen`, else bound here) is shut down; closes it
    (reference: socket_server.py:203-215)."""
    srv = srv or listen(host, port)
    print("listening on {}:{}".format(*srv.getsockname()), flush=True)
    with srv:
        while True:
            try:
                conn, _addr = srv.accept()
            except OSError:  # shut down: stop serving
                return
            threading.Thread(target=handle_client, args=(conn, processor), daemon=True).start()


def main(argv=None):
    from f5e_tts_tpu_torch.api import F5TTS
    from f5e_tts_tpu_torch.infer.audio import read_wav

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--engine_dir", default=None,
                   help="a JAX engine directory: the engines its file names list are "
                        "captured at start")
    p.add_argument("--max_batch", type=int, default=4,
                   help="dynamic-batching max batch (0 disables the batcher); concurrent "
                        "connections co-batch")
    p.add_argument("--batch_window_ms", type=float, default=20.0)
    p.add_argument("--wire", choices=["f32", "pcm16"], default="f32",
                   help="pcm16: stream int16 PCM (half the bytes per chunk); f32 matches the "
                        "reference client protocol")
    p.add_argument("--wire_device", choices=["float32", "int16"], default="float32",
                   help="int16: round the wav to PCM16 on the card in the batcher")
    p.add_argument("--xfer_chunks", type=int, default=1,
                   help=">1: copy the batch's wavs in row chunks so early requests resolve "
                        "before the whole batch has crossed")
    p.add_argument("--prune", default=None,
                   help="EPSS keep indices into the --nfe_step sway grid (comma-separated)")
    p.add_argument("--cfg", type=float, default=None, help="cfg_strength override")
    p.add_argument("--compilation_cache", default="",
                   help="not available in the port (CUDA graphs cannot be written to disk): "
                        "raises; warm-up captures the engines at start")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.compilation_cache:
        enable_compilation_cache(args.compilation_cache)

    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                vocoder_local_path=args.vocoder_local_path, engine_dir=args.engine_dir,
                device=args.device)
    wav, sr = read_wav(args.ref_audio)
    grid = None
    if args.prune:
        from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps

        grid = pruned_sway_timesteps([int(i) for i in args.prune.split(",")],
                                     base_steps=args.nfe_step)
    if args.max_batch > 0:
        # attach before the warm-up, so it captures each batch size
        tts.engine.enable_batching(max_batch=args.max_batch, window_ms=args.batch_window_ms,
                                   nfe_steps=args.nfe_step, return_mel=False,
                                   wire_dtype=args.wire_device, xfer_chunks=args.xfer_chunks,
                                   timesteps=grid, cfg_strength=args.cfg)
    processor = TTSStreamingProcessor(tts.engine, wav, sr, args.ref_text,
                                      nfe_steps=args.nfe_step, wire=args.wire,
                                      timesteps=grid, cfg_strength=args.cfg)
    serve(processor, args.host, args.port)


if __name__ == "__main__":
    main()
