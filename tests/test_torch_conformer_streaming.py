"""The Conformer's chunk paths and its checkpoint loader in the port against
the JAX package on the CPU, at a small Conformer (2 blocks, 32 wide, 2
heads, 64 linear units), fp32, weights carried across from the JAX init.

- `subsequent_chunk_mask_np`, `make_chunk_mask`, `dynamic_chunk_size` and
  `sample_train_chunk_mask`: equal to JAX's exactly, for the same seeds.
- `conformer_encode(chunk_size=, num_left_chunks=)` and
  `conformer_encode(chunk_mask=)` per subsampling (conv2d, conv2d4, conv2d6),
  with padding: the valid frames at atol 1e-5, the lengths exactly.
- `conformer_encode_chunk_by_chunk` at conv kernel 15 with left chunks -1
  and 1 (each chunk's conv zero-padded at its edges, so it is held against
  JAX's streaming function, not the full encode): atol 1e-5.
- `find_ppg_engine` picks the bucket the JAX lookup picks (the replay
  itself: tests/test_torch_graphs_gpu.py, on the card).
- `load_ppg_extractor` from a wenet checkpoint, train.yaml and global_cmvn
  written here (the recipe of tests/test_wenet_ingest.py), in the ppg and
  map modes: the same tensors as the JAX loader's, exactly; the PPG of both
  at atol 1e-4 (the 80-bin fbank's tolerance of tests/test_torch_conformer.py).
- `ppg_extract_cli.main` and `wenet_tools.recognize_main` with --device cpu
  against the JAX CLIs over those artifacts: the .npy rows at atol 1e-4, the
  CTC hypotheses equal.
"""

from __future__ import annotations

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from f5e_tts_tpu.models import conformer as jconf
from f5e_tts_tpu_torch.models import conformer as tconf
from tests.test_torch_conformer import SMALL, _params, _speechy, _to_wenet, _tree_equal, t


def _cfgs(**kw):
    return jconf.ConformerConfig(**SMALL, **kw), tconf.ConformerConfig(**SMALL, **kw)


def test_chunk_masks_and_dynamic_chunk_sizes_match_jax():
    for size, chunk, left in ((4, 2, -1), (6, 2, 1), (37, 4, -1), (37, 5, 3), (9, 16, 0)):
        np.testing.assert_array_equal(tconf.subsequent_chunk_mask_np(size, chunk, left),
                                      jconf.subsequent_chunk_mask_np(size, chunk, left))
    lens = np.asarray([12, 7, 1])
    pad = np.arange(12)[None, :] < lens[:, None]
    for chunk, left in ((3, -1), (3, 1), (0, -1)):
        np.testing.assert_array_equal(
            tconf.make_chunk_mask(t(pad), chunk, left).numpy(),
            np.asarray(jconf.make_chunk_mask(jnp.asarray(pad), chunk, left)))
    for seed in range(5):
        got = [tconf.dynamic_chunk_size(50, np.random.default_rng(seed)) for _ in range(3)]
        want = [jconf.dynamic_chunk_size(50, np.random.default_rng(seed)) for _ in range(3)]
        assert got == want
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        _, cfg_t = _cfgs(input_dim=20)
        cfg_j, _ = _cfgs(input_dim=20)
        for frames in (61, 120, 33):
            np.testing.assert_array_equal(tconf.sample_train_chunk_mask(cfg_t, frames, rt),
                                          jconf.sample_train_chunk_mask(cfg_j, frames, rj))


@pytest.mark.parametrize("subsampling", ["conv2d", "conv2d4", "conv2d6"])
def test_chunked_encode_matches_jax(subsampling):
    cfg_j, cfg_t = _cfgs(input_dim=20, subsampling=subsampling)
    params = _params(cfg_j, 7)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 73, 20)).astype(np.float32)
    lens = np.asarray([73, 50], np.int32)
    jp, tp = jax.tree.map(jnp.asarray, params), tconf.conformer_from_jax(params)
    tt = tconf.subsampled_time(subsampling, 73)
    chunk_mask = tconf.subsequent_chunk_mask_np(tt, 3)
    for kw in (dict(chunk_size=2), dict(chunk_size=3, num_left_chunks=1),
               dict(chunk_mask=chunk_mask)):
        want, want_lens = jconf.conformer_encode(
            jp, cfg_j, jnp.asarray(feats), jnp.asarray(lens),
            **{k: jnp.asarray(v) if k == "chunk_mask" else v for k, v in kw.items()})
        got, got_lens = tconf.conformer_encode(tp, cfg_t, t(feats), t(lens), **kw)
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        valid = (np.arange(tt)[None, :] < np.asarray(want_lens)[:, None])[:, :, None]
        np.testing.assert_allclose(np.where(valid, got.numpy(), 0), np.where(valid, want, 0),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("left_chunks", [-1, 1])
def test_chunk_by_chunk_decode_matches_jax_streaming(left_chunks):
    cfg_j = jconf.ConformerConfig(**{**SMALL, "cnn_module_kernel": 15}, input_dim=20)
    cfg_t = tconf.ConformerConfig(**{**SMALL, "cnn_module_kernel": 15}, input_dim=20)
    params = _params(cfg_j, 9)
    feats = np.random.default_rng(10).standard_normal((1, 45, 20)).astype(np.float32)
    want = jconf.conformer_encode_chunk_by_chunk(jax.tree.map(jnp.asarray, params), cfg_j,
                                                 jnp.asarray(feats), 4,
                                                 num_decoding_left_chunks=left_chunks)
    got = tconf.conformer_encode_chunk_by_chunk(tconf.conformer_from_jax(params), cfg_t,
                                                t(feats), 4, num_decoding_left_chunks=left_chunks)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # one chunk with no cache is the encode of its window without padding
    window = feats[:, :9]
    y, caches = tconf.conformer_forward_chunk(tconf.conformer_from_jax(params), cfg_t, t(window),
                                              0, 4 * left_chunks)
    full, _ = tconf.conformer_encode(tconf.conformer_from_jax(params), cfg_t, t(window),
                                     torch.tensor([9]))
    np.testing.assert_allclose(y.numpy(), full.numpy(), rtol=0, atol=1e-5)
    assert len(caches["layers"]) == 2 and caches["sub"].shape[1] == 4


def _write_wenet_artifacts(tmp_path, params, cfg_j):
    """A wenet checkpoint (with the decoder / CTC keys the loader skips, and
    num_batches_tracked), its train.yaml with a global_cmvn JSON, and the
    map mode's phn_center.npy and ce_layer.pkl."""
    sd = {k: torch.from_numpy(v) for k, v in _to_wenet(params, cfg_j).items()}
    for i in range(cfg_j.num_blocks):
        sd[f"encoder.encoders.{i}.conv_module.norm.num_batches_tracked"] = torch.tensor(3)
    sd["ctc.ctc_lo.weight"] = torch.ones(7, cfg_j.output_size)
    torch.save(sd, tmp_path / "33.pt")
    rng = np.random.default_rng(11)
    mean_stat = rng.standard_normal(80) * 1000
    var_stat = (np.abs(rng.standard_normal(80)) + 1.0) * 1000 + (mean_stat / 1000) ** 2 * 1000
    (tmp_path / "global_cmvn").write_text(json.dumps(
        {"mean_stat": mean_stat.tolist(), "var_stat": var_stat.tolist(), "frame_num": 1000}))
    conf = {"input_dim": 80, "cmvn_file": str(tmp_path / "missing_cmvn"),
            "encoder_conf": {"output_size": SMALL["output_size"],
                             "attention_heads": SMALL["attention_heads"],
                             "linear_units": SMALL["linear_units"],
                             "num_blocks": SMALL["num_blocks"],
                             "cnn_module_kernel": SMALL["cnn_module_kernel"],
                             "input_layer": "conv2d2"}}
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(conf))
    np.save(tmp_path / "phn_center.npy", rng.standard_normal((9, 32)).astype(np.float32))
    with open(tmp_path / "ce_layer.pkl", "wb") as f:
        pickle.dump({"w": rng.standard_normal((9, 32)).astype(np.float32),
                     "b": rng.standard_normal(9).astype(np.float32)}, f)


@pytest.mark.parametrize("output_type", ["ppg", "map"])
def test_load_ppg_extractor_matches_jax(tmp_path, output_type):
    cfg_j = jconf.ConformerConfig(input_dim=80, **SMALL)
    params = _params(cfg_j, 12)
    _write_wenet_artifacts(tmp_path, params, cfg_j)
    kw = dict(output_type=output_type, map_mix_ratio=0.6,
              phn_center_path=str(tmp_path / "phn_center.npy"),
              ce_layer_path=str(tmp_path / "ce_layer.pkl"))
    ext_j = jconf.load_ppg_extractor(str(tmp_path / "33.pt"), str(tmp_path / "train.yaml"), **kw)
    ext_t = tconf.load_ppg_extractor(str(tmp_path / "33.pt"), str(tmp_path / "train.yaml"),
                                     device="cpu", **kw)
    assert ext_t.cfg == tconf.ConformerConfig(**{**SMALL, "subsampling": "conv2d2"})
    assert float(np.abs(np.asarray(ext_j.params["cmvn_mean"])).max()) > 0  # global_cmvn read
    _tree_equal(jax.tree.map(lambda x: x.numpy(), ext_t.params, is_leaf=torch.is_tensor),
                jax.tree.map(np.asarray, ext_j.params))
    for name in ("phn_center", "ce_w", "ce_b"):
        if output_type == "map":
            np.testing.assert_array_equal(getattr(ext_t, name), getattr(ext_j, name))
        else:
            assert getattr(ext_t, name) is None and getattr(ext_j, name) is None
    wav = np.stack([_speechy(16_000, 5), _speechy(16_000, 6)])
    want, want_lens = ext_j.audio_to_ppg(jnp.asarray(wav), jnp.asarray([16_000, 12_000]))
    got, got_lens = ext_t.audio_to_ppg(wav, np.asarray([16_000, 12_000]))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tconf.load_ppg_extractor(str(tmp_path / "33.pt"), str(tmp_path / "train.yaml"))


def test_position_table_is_cached_on_the_device():
    """The encoder's sinusoid table is built once per (d, max_pos, device)
    and holds `_sinus_table`'s values."""
    a = tconf._pos_table(32, 100, torch.device("cpu"))
    assert tconf._pos_table(32, 100, torch.device("cpu")) is a
    np.testing.assert_array_equal(a.numpy(), tconf._sinus_table(32, 100))


def test_ppg_engine_lookup_matches_jax_and_capture_needs_the_card(tmp_path):
    """find_ppg_engine picks what the JAX lookup picks from engine files of
    the same names; a capture on the CPU raises (replays: the gpu tests)."""
    from f5e_tts_tpu.utils import aot as jaot
    from f5e_tts_tpu_torch.utils import aot as taot

    names = [taot.ppg_engine_name(b, t) for b, t in ((1, 400), (1, 800), (1, 3200), (2, 800))]
    for name in names:
        (tmp_path / f"{name}.jaxexport").write_text("")
    engines = dict.fromkeys(names)
    for batch, t in ((1, 1), (1, 400), (1, 401), (1, 3200), (1, 3201), (2, 10), (4, 10)):
        want = jaot.find_ppg_engine(str(tmp_path), batch, t)
        got = taot.find_ppg_engine(engines, batch, t)
        assert (got is None) == (want is None)
        if got is not None:
            assert got == (os.path.basename(want[0])[: -len(".jaxexport")], want[1])
    cfg = tconf.ConformerConfig(**SMALL)
    ext = tconf.PPGExtractor(params=tconf.init_conformer(cfg, torch.Generator().manual_seed(0)),
                             cfg=cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        taot.capture_ppg_buckets(ext)


def test_extraction_and_recognition_clis_match_jax(tmp_path):
    """ppg_extract_cli.main and wenet_tools.recognize_main with --device cpu
    over the written artifacts, against the JAX CLIs: every .npy has the same
    rows at atol 1e-4 (the PPG tolerance above), the CTC hypotheses are equal."""
    from f5e_tts_tpu.models import ppg_extract_cli as jcli
    from f5e_tts_tpu.models import wenet_tools as jtools
    from f5e_tts_tpu_torch.infer.audio import write_wav
    from f5e_tts_tpu_torch.models import ppg_extract_cli as tcli
    from f5e_tts_tpu_torch.models import wenet_tools as ttools

    cfg_j = jconf.ConformerConfig(input_dim=80, **SMALL)
    params = _params(cfg_j, 13)
    _write_wenet_artifacts(tmp_path, params, cfg_j)
    sd = torch.load(tmp_path / "33.pt", weights_only=True)
    rng = np.random.default_rng(14)
    sd["ctc.ctc_lo.weight"] = torch.from_numpy(rng.standard_normal((7, 32)).astype(np.float32) * 3)
    sd["ctc.ctc_lo.bias"] = torch.from_numpy(rng.standard_normal(7).astype(np.float32))
    torch.save(sd, tmp_path / "33.pt")
    wavs = []
    for i, (n, sr) in enumerate(((20_000, 16_000), (30_000, 24_000))):
        wavs.append(str(tmp_path / f"w{i}.wav"))
        write_wav(wavs[-1], _speechy(n, 7 + i), sr)
    (tmp_path / "list.txt").write_text("\n".join(wavs) + "\n")
    common = ["--ckpt", str(tmp_path / "33.pt"), "--config", str(tmp_path / "train.yaml"),
              "--filelist", str(tmp_path / "list.txt"), "--bucket_seconds", "1.0"]
    jcli.main(common + ["--output_dir", str(tmp_path / "j")])
    tcli.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    for i in range(2):
        got, want = np.load(tmp_path / "t" / f"w{i}.npy"), np.load(tmp_path / "j" / f"w{i}.npy")
        assert got.shape == want.shape and got.shape[1] == 32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    feats = []
    for i in range(2):
        feats.append(str(tmp_path / f"f{i}.npy"))
        np.save(feats[-1], rng.standard_normal((60 + 20 * i, 80)).astype(np.float32) * 3 + 8)
    args = ["--checkpoint", str(tmp_path / "33.pt"), "--config", str(tmp_path / "train.yaml"),
            "--feats", *feats]
    got = ttools.recognize_main(args + ["--device", "cpu",
                                        "--result_file", str(tmp_path / "t.jsonl")])
    want = jtools.recognize_main(args)
    assert [r["ids"] for r in got] == [r["ids"] for r in want] and any(r["ids"] for r in got)
    assert len((tmp_path / "t.jsonl").read_text().splitlines()) == 2
