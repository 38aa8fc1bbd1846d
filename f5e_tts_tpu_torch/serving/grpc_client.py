"""gRPC TTS client with latency statistics (counterpart of
`f5e_tts_tpu/serving/grpc_client.py`).

reference: src/f5_tts/runtime/triton_trtllm/client_grpc.py -- streaming and
offline modes, first-chunk latency, total latency, RTF, and latency
percentiles over repeated runs.

    python -m f5e_tts_tpu_torch.serving.grpc_client --target localhost:50051 \\
        --text "hello world" [--runs 4] [--offline] [--out out.wav]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from f5e_tts_tpu_torch.serving.grpc_server import SERVICE


def _stubs(channel):
    from f5e_tts_tpu_torch.serving import tts_pb2

    stream = channel.unary_stream(
        f"/{SERVICE}/Synthesize",
        request_serializer=tts_pb2.TTSRequest.SerializeToString,
        response_deserializer=tts_pb2.AudioChunk.FromString)
    offline = channel.unary_unary(
        f"/{SERVICE}/SynthesizeOffline",
        request_serializer=tts_pb2.TTSRequest.SerializeToString,
        response_deserializer=tts_pb2.AudioChunk.FromString)
    return stream, offline


def run_once(stream_stub, offline_stub, request, offline: bool = False):
    """One synthesis -> {first_chunk_s, total_s, audio_s, rtf, wav, sample_rate}."""
    t0 = time.perf_counter()
    first = None
    chunks = []
    sr = 24000
    if offline:
        resp = offline_stub(request)
        first = time.perf_counter() - t0
        sr = resp.sample_rate
        chunks.append(np.frombuffer(resp.pcm_f32, np.float32))
    else:
        for chunk in stream_stub(request):
            if first is None:
                first = time.perf_counter() - t0
            sr = chunk.sample_rate
            if len(chunk.pcm_f32):
                chunks.append(np.frombuffer(chunk.pcm_f32, np.float32))
    total = time.perf_counter() - t0
    wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    audio_s = len(wav) / sr if sr else 0.0
    return {"first_chunk_s": first, "total_s": total, "audio_s": audio_s,
            "rtf": total / audio_s if audio_s else float("inf"),
            "wav": wav, "sample_rate": sr}


def percentile_stats(values):
    arr = np.asarray(values, np.float64)
    return {"mean": float(arr.mean()), "p50": float(np.percentile(arr, 50)),
            "p90": float(np.percentile(arr, 90)), "p99": float(np.percentile(arr, 99)),
            "max": float(arr.max())}


def main(argv=None):
    import grpc

    from f5e_tts_tpu_torch.serving import tts_pb2

    p = argparse.ArgumentParser()
    p.add_argument("--target", default="localhost:50051")
    p.add_argument("--text", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--ref_audio", default=None, help="wav file to send as prompt")
    p.add_argument("--nfe_step", type=int, default=0)
    p.add_argument("--speed", type=float, default=0.0)
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--offline", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    req = tts_pb2.TTSRequest(gen_text=args.text, ref_text=args.ref_text,
                             nfe_steps=args.nfe_step, speed=args.speed)
    if args.ref_audio:
        from f5e_tts_tpu_torch.infer.audio import read_wav

        wav, sr = read_wav(args.ref_audio)
        req.ref_pcm_f32 = np.asarray(wav, np.float32).tobytes()
        req.ref_sample_rate = sr

    with grpc.insecure_channel(args.target) as channel:
        stream_stub, offline_stub = _stubs(channel)
        results = [run_once(stream_stub, offline_stub, req, args.offline)
                   for _ in range(args.runs)]

    if args.out and results[-1]["wav"].size:
        from f5e_tts_tpu_torch.infer.audio import write_wav

        write_wav(args.out, results[-1]["wav"], results[-1]["sample_rate"])

    report = {
        "runs": args.runs,
        "mode": "offline" if args.offline else "streaming",
        "audio_s": results[-1]["audio_s"],
        "first_chunk_latency": percentile_stats([r["first_chunk_s"] for r in results]),
        "total_latency": percentile_stats([r["total_s"] for r in results]),
        "rtf": percentile_stats([r["rtf"] for r in results]),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
