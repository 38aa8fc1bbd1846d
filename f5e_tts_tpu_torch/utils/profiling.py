"""Profiling and tracing hooks and FLOPs accounting (counterpart of
`f5e_tts_tpu/utils/profiling.py`).

reference: the reference traces with NVTX ranges and cudaProfilerStart
(benchmark.py:471-479) and counts FLOPs with thop
(scripts/count_params_gflops.py:26-40). Here: a `torch.profiler` trace of
the CPU and the card written as a Chrome trace, named ranges
(`torch.profiler.record_function`), and the analytic FLOPs and params
counter of the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block (host and, when there is one, the card) with
    torch.profiler; the Chrome trace goes to `log_dir`/trace.json (open it
    in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range in the trace (the NVTX-range equivalent)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def wallclock(label: str, results: Optional[dict] = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[{label}] {dt * 1e3:.1f} ms")


def start_server(port: int = 9999) -> None:
    """The JAX package's on-demand profiling server has no torch.profiler
    counterpart: trace a block with `trace` instead."""
    raise NotImplementedError(
        "torch.profiler has no on-demand profiling server; wrap the work in "
        "f5e_tts_tpu_torch.utils.profiling.trace(log_dir) instead")


def count_params(params) -> int:
    """Elements of every tensor of a nested dict/list tree of parameters."""
    from f5e_tts_tpu_torch.train.step import tree_leaves

    return sum(t.numel() for t in tree_leaves(params))


def dit_flops(cfg, seq_len: int, text_len: int = 150) -> float:
    """Analytic forward FLOPs for one DiT call (counts multiply-adds as 2 ops,
    matching thop conventions — scripts/count_params_gflops.py:26-40)."""
    d, depth, dh = cfg.dim, cfg.depth, cfg.heads * cfg.dim_head
    n = seq_len
    per_layer = (
        2 * n * d * (3 * dh)  # qkv proj
        + 2 * n * d * dh  # out proj
        + 2 * 2 * n * n * dh  # qk^T + av
        + 2 * 2 * n * d * (d * cfg.ff_mult)  # ff1 + ff2
        + 2 * d * 6 * d  # adaLN modulation (per sample, not per token)
    )
    # the reference's "363.4 GFLOPs" (count_params_gflops.py) is thop output,
    # multiply-accumulates, and thop does not see the functional
    # F.scaled_dot_product_attention: true forward FLOPs are ~2.8x that
    text_dim = cfg.text_dim if cfg.text_dim is not None else cfg.mel_dim
    embed = (
        2 * n * (2 * cfg.mel_dim + text_dim) * d  # input proj
        + 2 * 2 * n * d * 31 * (d // 16)  # conv pos embed (2 taps convs)
        + cfg.conv_layers * (2 * n * text_dim * 7 + 2 * 2 * n * text_dim * text_dim * 2)
    )
    out = 2 * n * d * cfg.mel_dim + 2 * n * d * 2 * d
    return float(depth * per_layer + embed + out)


def report_model_stats(cfg, vocab_size: int = 2545, seconds: float = 20.0,
                       hop: int = 256, sr: int = 24000, device="cuda") -> dict:
    """Params and forward GFLOPs of the backbone `cfg` for `seconds` of audio
    (the reference prints DiT-Base 335.8M / 363.4 GFLOPs at 20 s); the params
    are made from a seed on `device` to be counted."""
    from f5e_tts_tpu_torch.models import backbone as fbb
    from f5e_tts_tpu_torch.ops import prng
    from f5e_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    made = fbb.init_backbone(cfg, vocab_size, prng.prng_key(0), dev)
    params = made[0] if isinstance(made, tuple) else made
    n = int(seconds * sr / hop)
    return {"params_m": count_params(params) / 1e6, "gflops_fwd": dit_flops(cfg, n) / 1e9,
            "seq_len": n}
