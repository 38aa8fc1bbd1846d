"""gRPC streaming TTS server (counterpart of `f5e_tts_tpu/serving/grpc_server.py`).

reference: src/f5_tts/runtime/triton_trtllm (Triton gRPC endpoint +
client_grpc.py). A grpc service over the same TTSEngine the socket and HTTP
servers use; its messages are in serving/tts.proto (tts_pb2.py, generated;
the service's handlers are registered by hand, as protoc's grpc plugin is
not used). The proto and its module are byte-for-byte copies of the JAX
package's, so the two packages' clients and servers talk to each other.

    python -m f5e_tts_tpu_torch.serving.grpc_server --ref_audio ref.wav \\
        [--ref_text "..."] [--port 50051] [--model F5TTS_v1_Base] [--device cpu]
"""

from __future__ import annotations

import argparse
from concurrent import futures

import numpy as np
import torch

SERVICE = "f5e_tts.TTS"


class GrpcTTS:
    """Request handling around a warm TTSStreamingProcessor. Requests run in
    the gRPC thread pool, each in inference mode, and co-batch in the
    engine's batcher when one is attached."""

    def __init__(self, processor):
        self.processor = processor  # serving.socket_server.TTSStreamingProcessor

    def _ref(self, request):
        if len(request.ref_pcm_f32):
            ref = np.frombuffer(request.ref_pcm_f32, np.float32)
            sr = request.ref_sample_rate or self.processor.engine.mel.target_sample_rate
            text = request.ref_text
        else:
            ref, sr, text = (self.processor.ref_audio, self.processor.ref_sr,
                             request.ref_text or self.processor.ref_text)
        return ref, sr, text

    def synthesize(self, request, context):
        from f5e_tts_tpu_torch.serving import tts_pb2

        ref, sr, ref_text = self._ref(request)
        nfe = request.nfe_steps or self.processor.nfe_steps
        speed = request.speed or 1.0
        out_sr = self.processor.engine.mel.target_sample_rate
        with torch.inference_mode():
            stream = self.processor.engine.infer(
                ref, sr, ref_text, request.gen_text, nfe_steps=nfe, speed=speed,
                timesteps=self.processor.timesteps, cfg_strength=self.processor.cfg_strength,
                streaming=True, chunk_size=self.processor.chunk_size)
            for chunk, _sr in stream:
                if len(chunk):
                    yield tts_pb2.AudioChunk(pcm_f32=np.asarray(chunk, np.float32).tobytes(),
                                             sample_rate=out_sr, is_final=False)
        yield tts_pb2.AudioChunk(pcm_f32=b"", sample_rate=out_sr, is_final=True)

    def synthesize_offline(self, request, context):
        from f5e_tts_tpu_torch.serving import tts_pb2

        ref, sr, ref_text = self._ref(request)
        nfe = request.nfe_steps or self.processor.nfe_steps
        speed = request.speed or 1.0
        with torch.inference_mode():
            wav, out_sr, _mel = self.processor.engine.infer(
                ref, sr, ref_text, request.gen_text, nfe_steps=nfe, speed=speed,
                timesteps=self.processor.timesteps, cfg_strength=self.processor.cfg_strength)
        return tts_pb2.AudioChunk(pcm_f32=np.asarray(wav, np.float32).tobytes(),
                                  sample_rate=out_sr, is_final=True)


def make_server(processor, host: str = "0.0.0.0", port: int = 50051, max_workers: int = 4):
    """Build (not start) the grpc server; returns (server, bound port). Port
    0 binds a free one."""
    import grpc

    from f5e_tts_tpu_torch.serving import tts_pb2

    svc = GrpcTTS(processor)
    handlers = {
        "Synthesize": grpc.unary_stream_rpc_method_handler(
            svc.synthesize,
            request_deserializer=tts_pb2.TTSRequest.FromString,
            response_serializer=tts_pb2.AudioChunk.SerializeToString),
        "SynthesizeOffline": grpc.unary_unary_rpc_method_handler(
            svc.synthesize_offline,
            request_deserializer=tts_pb2.TTSRequest.FromString,
            response_serializer=tts_pb2.AudioChunk.SerializeToString),
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, handlers),))
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


def main(argv=None):
    from f5e_tts_tpu_torch.api import F5TTS
    from f5e_tts_tpu_torch.infer.audio import read_wav
    from f5e_tts_tpu_torch.serving.http_server import enable_compilation_cache
    from f5e_tts_tpu_torch.serving.socket_server import TTSStreamingProcessor

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--config_file", default=None)
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the bucket-ladder capture (debug only)")
    p.add_argument("--engine_dir", default=None,
                   help="a JAX engine directory: the engines its file names list are "
                        "captured at start")
    p.add_argument("--max_batch", type=int, default=4,
                   help="dynamic-batching max batch (0 disables the batcher)")
    p.add_argument("--batch_window_ms", type=float, default=20.0)
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

    tts = F5TTS(model=args.model, config_file=args.config_file, ckpt_file=args.ckpt_file,
                vocab_file=args.vocab_file, vocoder_local_path=args.vocoder_local_path,
                engine_dir=args.engine_dir, device=args.device)
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
                                      nfe_steps=args.nfe_step, warm_up=not args.no_warmup,
                                      timesteps=grid, cfg_strength=args.cfg)
    server, bound = make_server(processor, args.host, args.port)
    server.start()
    print(f"grpc listening on {args.host}:{bound}", flush=True)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
