"""`F5TTS(engine_dir=)` and `utils.aot.capture_engine_dir` on the CPU.

A CUDA graph cannot be written to a file, so the port reads a JAX engine
directory for its file names only (f5e_tts_tpu/utils/aot.py:
export_sampler_buckets names them sampler_nfe{nfe}{tag}_ref{ref}_b{bucket}_
t{text}.jaxexport) and captures one `SamplerGraph` for each distinct (nfe,
bucket, grid, guidance) they name. Held here, with empty files named by the
JAX package's own tag function:
- the variants parsed, the prompt and text lengths collapsed, other files
  ignored; each name found by the JAX engine-file match;
- a `_ts<hash>` tag matched against the grids the port builds
  (`pruned_sway_timesteps` of `EPSS_KEEPS`);
- the errors (no engine name, a grid the port does not build), which name
  `capture_buckets=` and `capture_sampler_buckets`;
- the captures asked for, in groups of one (nfe, grid, guidance), with the
  capture stubbed (the CPU cannot capture; there `F5TTS(engine_dir=)`
  raises as `capture_buckets=` does).
"""

from __future__ import annotations

import pytest

from f5e_tts_tpu.models import cfm as jcfm
from f5e_tts_tpu.utils import aot as jaot
from f5e_tts_tpu_torch.models import cfm as tcfm
from f5e_tts_tpu_torch.utils import aot as taot
from tests.test_torch_infer_paths import tiny_f5tts

EPSS8, EPSS16 = (0, 1, 2, 3, 4, 6, 10, 18, 32), tuple(range(0, 33, 2))


def _write(tmp_path, entries, extra=("ppg_b1_t400.jaxexport", "README.md")):
    """Empty files named as the JAX exporter names them: (nfe, grid keep or
    None, cfg or None, ref frames, bucket, text length)."""
    for nfe, keep, cfg, ref, bucket, text in entries:
        ts = jcfm.pruned_sway_timesteps(keep) if keep is not None else None
        nfe = len(ts) - 1 if ts is not None else nfe
        (tmp_path / f"sampler_nfe{nfe}{jaot._variant_tag(ts, cfg)}_ref{ref}_b{bucket}_t{text}"
                    ".jaxexport").touch()
    for name in extra:
        (tmp_path / name).touch()
    return str(tmp_path)


ENTRIES = [(32, None, None, 100, 1536, 256), (32, None, None, 472, 1536, 512),  # one variant
           (32, None, None, 100, 1024, 256), (32, None, 0.0, 100, 1536, 256),
           (32, None, 2.5, 100, 768, 256), (0, EPSS8, None, 100, 1536, 256),
           (0, EPSS16, None, 90, 1536, 128), (0, EPSS8, 0.0, 100, 2048, 256)]


def test_engine_dir_variants_parse_jax_names(tmp_path):
    engine_dir = _write(tmp_path, ENTRIES)
    got = taot.engine_dir_variants(engine_dir)
    e8 = tcfm.pruned_sway_timesteps(EPSS8)
    e16 = tcfm.pruned_sway_timesteps(EPSS16)
    assert got == [(8, 1536, e8, None), (8, 2048, e8, 0.0), (16, 1536, e16, None),
                   (32, 768, None, 2.5), (32, 1024, None, None), (32, 1536, None, None),
                   (32, 1536, None, 0.0)]
    for nfe, bucket, ts, cfg in got:  # the JAX package finds each variant among the files
        assert jaot.find_sampler_engine(engine_dir, nfe, 90 if ts == e16 else 100, bucket, 1,
                                        timesteps=ts, cfg_strength=cfg) is not None
        # the grids hash as the JAX grids do
        if ts is not None:
            keep = EPSS8 if len(ts) == 9 else EPSS16
            assert taot.variant_tag(ts) == jaot._variant_tag(jcfm.pruned_sway_timesteps(keep))


def test_a_grid_the_port_does_not_build_raises(tmp_path):
    custom = jcfm.pruned_sway_timesteps((0, 5, 32))
    engine_dir = _write(tmp_path, [(32, None, None, 100, 1536, 256)])
    (tmp_path / f"sampler_nfe2{jaot._variant_tag(custom)}_ref100_b1536_t256.jaxexport").touch()
    with pytest.raises(ValueError, match="capture_sampler_buckets") as err:
        taot.engine_dir_variants(engine_dir)
    assert "capture_buckets=" in str(err.value)
    # a known hash under another nfe is no match either
    (tmp_path / f"sampler_nfe2{jaot._variant_tag(custom)}_ref100_b1536_t256.jaxexport").unlink()
    (tmp_path / f"sampler_nfe9{jaot._variant_tag(jcfm.pruned_sway_timesteps(EPSS8))}"
                "_ref1_b1536_t1.jaxexport").touch()
    with pytest.raises(ValueError, match="none the port builds"):
        taot.engine_dir_variants(engine_dir)


def test_a_directory_without_engine_names_raises(tmp_path):
    engine_dir = _write(tmp_path, [])
    with pytest.raises(ValueError, match="capture_buckets=") as err:
        taot.engine_dir_variants(engine_dir)
    assert "capture_sampler_buckets" in str(err.value)
    with pytest.raises(FileNotFoundError):
        taot.engine_dir_variants(str(tmp_path / "missing"))


def test_capture_engine_dir_captures_each_named_variant(tmp_path, monkeypatch):
    engine_dir = _write(tmp_path, ENTRIES)
    calls = []

    def capture(engine, buckets=None, nfe=32, timesteps=None, cfg_strength=None):
        calls.append((tuple(buckets), nfe, timesteps, cfg_strength))
        names = [taot.engine_name(nfe, b, timesteps, cfg_strength) for b in buckets]
        engine.engines.update({n: object() for n in names})
        return names

    monkeypatch.setattr(taot, "capture_sampler_buckets", capture)
    tts = tiny_f5tts(engine_dir=engine_dir)  # on the CPU, with the capture stubbed
    e8, e16 = (tcfm.pruned_sway_timesteps(k) for k in (EPSS8, EPSS16))
    assert sorted(calls, key=repr) == sorted([
        ((1536,), 8, e8, None), ((2048,), 8, e8, 0.0), ((1536,), 16, e16, None),
        ((768,), 32, None, 2.5), ((1024, 1536), 32, None, None), ((1536,), 32, None, 0.0)],
        key=repr)
    # what a request looks up is there: the default, a cfg override, an EPSS grid
    eng = tts.engine
    assert taot.find_sampler_engine(eng.engines, 32, 1024) is not None
    assert taot.find_sampler_engine(eng.engines, 32, 1536, cfg_strength=0.0) is not None
    assert taot.find_sampler_engine(eng.engines, 0, 1536, timesteps=e16) is not None
    assert taot.find_sampler_engine(eng.engines, 32, 2048) is None
    assert len(eng.engines) == 7


def test_f5tts_engine_dir_on_the_cpu_raises(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA device"):
        tiny_f5tts(engine_dir=_write(tmp_path, ENTRIES[:1]))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="names no sampler engine"):
        tiny_f5tts(engine_dir=str(empty))
    assert taot.EPSS_KEEPS == (EPSS16, EPSS8)
