"""Socket client (counterpart of `f5e_tts_tpu/serving/socket_client.py`):
sends text, receives PCM chunks up to the b"END" sentinel, measures the
first chunk's latency. reference: src/f5_tts/socket_client.py:14-63 (its
pyaudio playback replaced by a wav file).

    python -m f5e_tts_tpu_torch.serving.socket_client --text "hello" [--port 9998]
"""

from __future__ import annotations

import argparse
import socket
import time

import numpy as np

from f5e_tts_tpu_torch.serving.pcm import pcm16_bytes_to_f32


def request(host: str, port: int, text: str, timeout: float = 120.0, wire: str = "f32"):
    """Send one text request; return (float32 waveform, first chunk's
    latency in s). `wire` is the server's: "f32" or "pcm16"."""
    t0 = time.perf_counter()
    first_latency = None
    buf = b""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(text.encode("utf-8"))
        while True:
            data = sock.recv(65536)
            if not data:
                break
            buf += data
            if first_latency is None:
                first_latency = time.perf_counter() - t0
            if buf.endswith(b"END"):
                buf = buf[:-3]
                break
    if wire == "pcm16":
        return pcm16_bytes_to_f32(buf), first_latency
    return np.frombuffer(buf, dtype=np.float32).copy(), first_latency


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--text", required=True)
    p.add_argument("--output", default="client_out.wav")
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--wire", choices=["f32", "pcm16"], default="f32")
    args = p.parse_args(argv)

    wav, latency = request(args.host, args.port, args.text, wire=args.wire)
    print(f"received {len(wav) / args.sample_rate:.2f}s audio, "
          f"first-chunk latency {latency * 1e3:.0f} ms")
    if len(wav):
        from f5e_tts_tpu_torch.infer.audio import write_wav

        write_wav(args.output, wav, args.sample_rate)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
