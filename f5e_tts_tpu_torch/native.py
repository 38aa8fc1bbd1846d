"""The host helpers of `f5e_tts_tpu/native.py` under its names, in Python.

The JAX package binds a C++ host library (native/f5e_host.cpp) with ctypes
and falls back to Python where it is not built. That library is host code,
no TPU kernel, so the port keeps the Python versions alone: each name below
is the port's copy of the JAX fallback it names.
"""

from f5e_tts_tpu_torch.data.dataset import pack_batches
from f5e_tts_tpu_torch.infer.audio import resample
from f5e_tts_tpu_torch.infer.pipeline import cross_fade_stitch as crossfade_stitch
from f5e_tts_tpu_torch.serving.pcm import f32_to_pcm16_bytes, pcm16_bytes_to_f32

__all__ = ["resample", "crossfade_stitch", "pack_batches", "pcm16_bytes_to_f32",
           "f32_to_pcm16_bytes"]
