"""The port's servers and clients (`f5e_tts_tpu_torch/serving/`) on the CPU,
at the JAX tests' tiny sizes (tests/test_{http_server,grpc_server,
serving}.py: a 1-block DiT of width 32, 12 mel channels, NFE 2), each bound
to 127.0.0.1 on a free port (port 0): HTTP, raw socket (float32 and PCM16
wires) and gRPC (streaming, offline, a per-request reference) round trips,
concurrent clients co-batching, the warm-up running every batch size the
batcher runs, the load generator, and the wire: the port's `tts_pb2`
messages serialise to the JAX package's bytes, and the JAX package's gRPC
client talks to the port's server. Comparisons are exact (the same port
arithmetic down two paths) unless a test states a tolerance.
"""

from __future__ import annotations

import io
import json
import socket
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

grpc = pytest.importorskip("grpc")

from f5e_tts_tpu.serving import grpc_client as jgrpc_client  # noqa: E402
from f5e_tts_tpu.serving import tts_pb2 as jtts_pb2  # noqa: E402
from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, InferConfig, MelConfig  # noqa: E402
from f5e_tts_tpu_torch.infer.pipeline import TTSEngine  # noqa: E402
from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps  # noqa: E402
from f5e_tts_tpu_torch.models.dit import init_dit  # noqa: E402
from f5e_tts_tpu_torch.ops import prng  # noqa: E402
from f5e_tts_tpu_torch.serving import benchmark as tbench  # noqa: E402
from f5e_tts_tpu_torch.serving import grpc_client as tgrpc_client  # noqa: E402
from f5e_tts_tpu_torch.serving import http_server as thttp  # noqa: E402
from f5e_tts_tpu_torch.serving import socket_client as tsocket_client  # noqa: E402
from f5e_tts_tpu_torch.serving import socket_server as tsocket_server  # noqa: E402
from f5e_tts_tpu_torch.serving import tts_pb2 as ttts_pb2  # noqa: E402

MEL = MelConfig(n_fft=256, hop_length=64, win_length=256, n_mel_channels=12,
                target_sample_rate=8000)
ARCH = DiTConfig(dim=32, depth=1, heads=1, dim_head=32, ff_mult=2, mel_dim=12, text_dim=16,
                 conv_layers=0, dropout=0.0)
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.")}
SR = 8000


def _vocoder(m):
    """A host vocoder: the mel's mean per frame, 64 samples a frame, scaled
    into [-1, 1] (not silent)."""
    return np.tanh(np.asarray(m, np.float32).mean(-1)).repeat(64, -1) * 0.5 + 0.02


def make_engine(buckets=(128, 256, 512)):
    gen = torch.Generator().manual_seed(0)
    params = init_dit(ARCH, len(VOCAB), prng.prng_key(0), "cpu")
    params["proj_out"]["w"].normal_(0.0, 0.05, generator=gen)
    return TTSEngine(params=params, arch=ARCH, vocab=VOCAB, mel=MEL, cfm=CFMConfig(),
                     infer_cfg=InferConfig(nfe_steps=2, max_duration=512), tokenizer="char",
                     vocoder_decode=_vocoder, compute_dtype=torch.float32, buckets=buckets,
                     device="cpu")


def ref_audio(seconds=0.75, hz=220.0):
    t = np.arange(int(seconds * SR)) / SR
    return (0.2 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def _audible(wav):
    return len(wav) > 0 and np.isfinite(wav).all() and float(np.sqrt(np.mean(wav ** 2))) > 0


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


@pytest.fixture
def http_server():
    engine = make_engine()
    srv = thttp.make_server(engine, ref_audio(), SR, "a ref.", host="127.0.0.1", port=0, nfe=2,
                            warm=False, max_batch=4, batch_window_ms=300)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield engine, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    engine.batcher.stop()


def _post(url, body, timeout=300):
    req = urllib.request.Request(url + "/tts", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        data = r.read()
    with wave.open(io.BytesIO(data)) as f:
        assert f.getframerate() == SR and f.getsampwidth() == 2
        return np.frombuffer(f.readframes(f.getnframes()), np.int16).astype(np.float32) / 32767


def test_http_roundtrip_health_and_error(http_server):
    engine, url = http_server
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        assert r.read() == b"ok"
    wav = _post(url, {"text": "hello from http.", "seed": 3})
    assert _audible(wav)
    assert engine.batcher.batch_sizes == [1]
    # the direct path's wav, as the wire rounds it
    direct = make_engine().infer(ref_audio(), SR, "a ref.", "hello from http.", seed=3)[0]
    np.testing.assert_array_equal(np.round(wav * 32767).astype(np.int16),
                                  (np.clip(direct, -1, 1) * 32767).astype(np.int16))
    with pytest.raises(urllib.error.HTTPError) as err:  # no text
        urllib.request.urlopen(urllib.request.Request(url + "/tts", data=b"{}"), timeout=30)
    assert err.value.code == 500 and "error" in json.loads(err.value.read())
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + "/nowhere", timeout=30)
    assert err.value.code == 404


def test_http_concurrent_requests_cobatch(http_server):
    engine, url = http_server
    barrier, outs = threading.Barrier(3), {}

    def client(i):
        barrier.wait()
        outs[i] = _post(url, {"text": ["one more.", "and two.", "three it is."][i], "seed": i})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(_audible(outs[i]) for i in range(3))
    assert engine.batcher.batch_sizes == [3], engine.batcher.batch_sizes


def test_compilation_cache_raises_and_names_the_capture(tmp_path):
    with pytest.raises(NotImplementedError, match="warm_up_buckets"):
        thttp.enable_compilation_cache(str(tmp_path))
    wav = tmp_path / "ref.wav"
    from f5e_tts_tpu_torch.infer.audio import write_wav

    write_wav(str(wav), ref_audio(), SR)
    for main in (thttp.main, tsocket_server.main):
        with pytest.raises(NotImplementedError, match="cannot be written to disk"):
            main(["--ref_audio", str(wav), "--compilation_cache", str(tmp_path), "--device",
                  "cpu"])


def test_wav_bytes_is_pcm16_mono():
    wav = np.array([0.0, 0.5, -0.5, 1.5, -1.5], np.float32)
    with wave.open(io.BytesIO(thttp.wav_bytes(wav, 123))) as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 2, 123)
        got = np.frombuffer(f.readframes(5), np.int16)
    np.testing.assert_array_equal(got, [0, 16383, -16383, 32767, -32767])


# ---------------------------------------------------------------------------
# warm-up
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_batch,sizes", [(4, [1, 2, 4]), (3, [1, 2, 3]), (1, [1])])
def test_warm_up_runs_every_batch_size_of_the_batcher(max_batch, sizes, rng):
    eng = make_engine(buckets=(128,))
    eng.enable_batching(max_batch=max_batch, window_ms=300, nfe_steps=2)
    ref_mel = rng.standard_normal((1, 40, 12)).astype(np.float32)
    names = thttp.warm_up_buckets(eng, ref_mel, "warm", nfe=2)
    eng.batcher.stop()
    assert names == []  # nothing is captured on the CPU
    assert eng.batcher.batch_sizes == sizes


def test_warm_up_without_a_batcher_and_past_the_prompt(rng):
    eng = make_engine(buckets=(128, 256))
    seen = []
    sc = eng.synthesize_chunk
    eng.synthesize_chunk = lambda *a, **k: seen.append(a[2]) or sc(*a, **k)
    # a prompt of 130 frames: bucket 128 cannot hold it and is skipped
    thttp.warm_up_buckets(eng, rng.standard_normal((1, 130, 12)).astype(np.float32), "warm",
                          nfe=2)
    assert seen == [256]
    # a batcher of another nfe is not warmed; the direct path is
    eng.enable_batching(max_batch=2, nfe_steps=4)
    thttp.warm_up_buckets(eng, rng.standard_normal((1, 40, 12)).astype(np.float32), "warm",
                          nfe=2)
    eng.batcher.stop()
    assert seen == [256, 128, 256] and eng.batcher.batch_sizes == []


# ---------------------------------------------------------------------------
# raw socket
# ---------------------------------------------------------------------------


@pytest.fixture
def socket_server():
    engine = make_engine()
    engine.enable_batching(max_batch=4, window_ms=300, nfe_steps=2)
    servers = []

    def start(**kw):
        proc = tsocket_server.TTSStreamingProcessor(engine, ref_audio(), SR, "hello there.",
                                                    chunk_size=500, nfe_steps=2, **kw)
        srv = tsocket_server.listen("127.0.0.1", 0)
        threading.Thread(target=tsocket_server.serve, args=(proc,), kwargs=dict(srv=srv),
                         daemon=True).start()
        servers.append(srv)
        return srv.getsockname()[1]

    yield engine, start
    for srv in servers:
        srv.shutdown(socket.SHUT_RDWR)
    engine.batcher.stop()


@pytest.mark.parametrize("wire", ["f32", "pcm16"])
def test_socket_stream_roundtrip(socket_server, wire):
    engine, start = socket_server
    port = start(wire=wire, warm_up=True)
    assert engine.batcher.batch_sizes == [1, 2, 4] * 3  # warm-up: three buckets
    engine.batcher.batch_sizes.clear()
    out, latency = tsocket_client.request("127.0.0.1", port, "a short test sentence.",
                                          timeout=120, wire=wire)
    assert _audible(out) and latency is not None and latency > 0
    want = make_engine().infer(ref_audio(), SR, "hello there.", "a short test sentence.",
                               nfe_steps=2)[0]
    assert out.shape == want.shape
    if wire == "f32":
        np.testing.assert_array_equal(out, want)
    else:  # truncated to int16 by 32767, read back by 32768
        assert np.abs(out - want).max() <= 2 / 32767
    assert engine.batcher.batch_sizes == [1]


def test_socket_concurrent_clients_cobatch(socket_server):
    engine, start = socket_server
    port = start(warm_up=False)
    barrier, outs = threading.Barrier(2), {}

    def client(tag, text):
        barrier.wait()
        outs[tag] = tsocket_client.request("127.0.0.1", port, text, timeout=240)

    threads = [threading.Thread(target=client, args=a)
               for a in (("a", "a short test sentence."), ("b", "another test phrase."))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(_audible(outs[k][0]) for k in "ab")
    assert engine.batcher.batch_sizes == [2]


def test_processor_grid_and_cfg_reach_the_sampler():
    """A processor armed with a pruned grid and cfg 0 streams what the engine
    gives directly with the same options; the grid subsumes nfe."""
    engine = make_engine()
    grid = pruned_sway_timesteps([0, 1, 4], base_steps=4)
    proc = tsocket_server.TTSStreamingProcessor(engine, ref_audio(), SR, "hello there.",
                                                chunk_size=500, nfe_steps=4, warm_up=False,
                                                timesteps=grid, cfg_strength=0.0)
    assert proc.nfe_steps == 2
    got = []
    proc.generate_stream("a short test sentence.", got.append)
    assert got[-1] == b"END" and len(got) > 2
    streamed = np.concatenate([np.frombuffer(b, np.float32) for b in got[:-1]])
    direct, _, mel_d = engine.infer(ref_audio(), SR, "hello there.", "a short test sentence.",
                                    nfe_steps=2, timesteps=grid, cfg_strength=0.0)
    np.testing.assert_array_equal(streamed, direct)
    mel_default = engine.infer(ref_audio(), SR, "hello there.", "a short test sentence.",
                               nfe_steps=2)[2]
    assert not np.array_equal(mel_d, mel_default)
    with pytest.raises(ValueError, match="wire"):
        tsocket_server.TTSStreamingProcessor(engine, ref_audio(), SR, "r", wire="f16",
                                             warm_up=False)


def test_audio_file_writer_thread(tmp_path):
    from f5e_tts_tpu_torch.infer.audio import read_wav

    path = str(tmp_path / "out.wav")
    w = tsocket_server.AudioFileWriterThread(path, SR)
    w.start()
    for chunk in np.split(ref_audio(0.5), 4):
        w.add_chunk(chunk)
    w.stop()
    wav, sr = read_wav(path)
    assert sr == SR and wav.shape == (SR // 2,)
    # written truncated by 32767, read back by 32768
    np.testing.assert_allclose(wav, ref_audio(0.5), rtol=0, atol=2 / 32767)


# ---------------------------------------------------------------------------
# gRPC
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grpc_server():
    engine = make_engine()
    engine.enable_batching(max_batch=4, window_ms=300, nfe_steps=2)
    proc = tsocket_server.TTSStreamingProcessor(engine, ref_audio(), SR, "a ref.", nfe_steps=2,
                                                warm_up=False)
    from f5e_tts_tpu_torch.serving.grpc_server import make_server

    srv, port = make_server(proc, host="127.0.0.1", port=0)
    srv.start()
    yield engine, f"127.0.0.1:{port}"
    srv.stop(grace=None)
    engine.batcher.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_grpc_streaming_and_offline(grpc_server, client):
    engine, target = grpc_server
    mod, pb2 = (tgrpc_client, ttts_pb2) if client == "port" else (jgrpc_client, jtts_pb2)
    with grpc.insecure_channel(target) as channel:
        stream_stub, offline_stub = mod._stubs(channel)
        req = pb2.TTSRequest(gen_text="hello over grpc.", nfe_steps=2)
        streamed = mod.run_once(stream_stub, offline_stub, req)
        offline = [mod.run_once(stream_stub, offline_stub, req, offline=True)
                   for _ in range(2)]
    assert streamed["sample_rate"] == SR and _audible(streamed["wav"])
    assert streamed["first_chunk_s"] is not None
    assert streamed["first_chunk_s"] <= streamed["total_s"]
    for r in offline:
        np.testing.assert_array_equal(r["wav"], streamed["wav"])
    stats = mod.percentile_stats([r["total_s"] for r in offline])
    assert stats["p50"] <= stats["p99"] <= stats["max"] + 1e-9


def test_grpc_per_request_reference(grpc_server):
    _, target = grpc_server
    other = ref_audio(0.5, 440.0)
    with grpc.insecure_channel(target) as channel:
        stream_stub, offline_stub = tgrpc_client._stubs(channel)
        req = ttts_pb2.TTSRequest(gen_text="custom prompt.", ref_text="other ref.",
                                  ref_pcm_f32=other.tobytes(), ref_sample_rate=SR, nfe_steps=2)
        r = tgrpc_client.run_once(stream_stub, offline_stub, req, offline=True)
    want = make_engine().infer(other, SR, "other ref.", "custom prompt.", nfe_steps=2)[0]
    np.testing.assert_array_equal(r["wav"], want)


def test_grpc_concurrent_requests_cobatch(grpc_server):
    engine, target = grpc_server
    engine.batcher.batch_sizes.clear()
    barrier, outs = threading.Barrier(2), {}

    def client(i):
        with grpc.insecure_channel(target) as channel:
            stream_stub, offline_stub = tgrpc_client._stubs(channel)
            req = ttts_pb2.TTSRequest(gen_text=["first one.", "second one."][i], nfe_steps=2)
            barrier.wait()
            outs[i] = tgrpc_client.run_once(stream_stub, offline_stub, req, offline=True)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(_audible(outs[i]["wav"]) for i in range(2))
    assert engine.batcher.batch_sizes == [2]


@pytest.mark.parametrize("message,fields", [
    ("TTSRequest", dict(gen_text="hello", ref_text="ref.", ref_pcm_f32=b"\x00\x01\x02\x03",
                        ref_sample_rate=24000, nfe_steps=16, speed=1.25)),
    ("TTSRequest", dict(gen_text="only text")),
    ("AudioChunk", dict(pcm_f32=np.arange(5, dtype=np.float32).tobytes(), sample_rate=8000,
                        is_final=True)),
])
def test_tts_pb2_serialises_as_the_jax_module(message, fields):
    got = getattr(ttts_pb2, message)(**fields).SerializeToString()
    assert got == getattr(jtts_pb2, message)(**fields).SerializeToString()
    assert getattr(ttts_pb2, message).FromString(got) == getattr(ttts_pb2, message)(**fields)
    assert ttts_pb2.DESCRIPTOR.serialized_pb == jtts_pb2.DESCRIPTOR.serialized_pb


# ---------------------------------------------------------------------------
# the load generator
# ---------------------------------------------------------------------------

TEXTS = ["gh abc.", "cba hg.", "abc gh.", "ha bc.", "bc ha.", "gach b."]


def test_bench_concurrent_reports_cobatching():
    eng = make_engine()
    eng.enable_batching(max_batch=4, window_ms=300)
    stats = tbench.bench_concurrent(eng, ref_audio(), SR, "abc def.", TEXTS, nfe=2,
                                    concurrency=4)
    eng.batcher.stop()
    assert stats["n"] == len(TEXTS) and stats["rtf"] > 0
    assert max(stats["batch_sizes"]) >= 2 and stats["mean_batch"] > 1.0
    assert stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"]
    assert stats["stage_totals"]["sampler_s"] > 0
    # rtf_net_of_transfer is rounded to 5 decimals (stage_summary), rtf is not
    assert 0 < stats["rtf_net_of_transfer"] <= stats["rtf"] + 5e-6


def test_bench_openloop_and_offline():
    eng = make_engine()
    offline = tbench.bench_offline(eng, ref_audio(), SR, "abc def.", TEXTS[:2], nfe=2)
    assert offline["n"] == 2 and offline["rtf"] > 0 and offline["p50_ms"] > 0
    eng.enable_batching(max_batch=4, window_ms=100)
    stats = tbench.bench_openloop(eng, ref_audio(), SR, "abc def.", TEXTS, nfe=2, qps=20.0,
                                  seed=1)
    eng.batcher.stop()
    assert stats["n"] == len(TEXTS) and stats["qps_achieved"] > 0 and stats["p50_ms"] > 0
    assert stats["batch_sizes"]
    # rtf_net_of_transfer is rounded to 5 decimals (stage_summary), rtf is not
    assert 0 < stats["rtf_net_of_transfer"] <= stats["rtf"] + 5e-6


def test_bench_server_against_the_socket_server(socket_server):
    _, start = socket_server
    port = start(warm_up=False)
    stats = tbench.bench_server("127.0.0.1", port, TEXTS[:3], concurrency=2, sample_rate=SR)
    assert stats["n"] == 3 and stats["rtf"] > 0
    assert stats["total"]["p50_ms"] > 0 and stats["first_chunk"]["p50_ms"] > 0


# ---------------------------------------------------------------------------
# the servers' threads run in inference mode: the port's cached tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", ["rope", "abs_pos", "conformer_pos", "kaldi"])
def test_a_table_first_built_in_inference_mode_serves_training(table):
    """A cached table first built by a thread in inference mode (a server's
    request) is no inference tensor, so a later training step in the same
    process can save it for its backward; before, the RoPE table made the
    Trainer fail ("Inference tensors cannot be saved for backward")."""
    from f5e_tts_tpu_torch.kernels.rope_attention import RopeAttention
    from f5e_tts_tpu_torch.models import conformer as tconformer
    from f5e_tts_tpu_torch.models import dit as tdit
    from f5e_tts_tpu_torch.ops import kaldi as tkaldi

    cpu = torch.device("cpu")
    build = {"rope": lambda: tdit._rope_tables(32, 93, cpu),
             "abs_pos": lambda: (tdit._abs_pos_table(16, 93),),
             "conformer_pos": lambda: (tconformer._pos_table(16, 93, cpu),),
             "kaldi": lambda: tkaldi._tables(400, 512, 80, 16000)}[table]
    with torch.inference_mode():
        tables = build()
    assert not any(t.is_inference() for t in tables)
    if table == "rope":
        cos, sin = tables
        q, k, v = (torch.randn((1, 93, 2, 32), requires_grad=True) for _ in range(3))
        out = RopeAttention.apply(q, k, v, torch.tensor([93], dtype=torch.int32), cos, sin, 2,
                                  None)
        out.sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()
