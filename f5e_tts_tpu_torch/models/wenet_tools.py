"""WeNet ASR tools: checkpoint averaging and recognition (counterpart of
`f5e_tts_tpu/models/wenet_tools.py`).

reference: src/f5_tts/ppg/wenet/bin/average_model.py (the value-wise mean of
N checkpoints) and bin/recognize.py (decode a test set with --mode attention
or ctc_greedy_search).

Recognition runs the frozen Conformer encoder (models/conformer.py) and the
CTC head or the attention decoder (models/wenet_decoder.py) on the
extractor's device, the card unless the caller asks for the CPU; file IO and
the searches' bookkeeping stay on the host.

    python -m f5e_tts_tpu_torch.models.wenet_tools --checkpoint 33.pt \\
        --config train.yaml --feats a.npy b.npy [--mode attention] [--device cpu]
    python -m f5e_tts_tpu_torch.models.wenet_tools average --dst_model avg.pt \\
        --src_paths 1.pt 2.pt
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch


def average_checkpoints(paths: List[str]) -> Dict[str, np.ndarray]:
    """The value-wise mean of the tensors of N torch checkpoints, summed in
    float64, as float32 (average_model.py:67-84)."""
    avg: Dict[str, np.ndarray] = {}
    for path in paths:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for k, v in sd.items():
            if not torch.is_tensor(v):
                continue
            arr = v.numpy()
            avg[k] = avg[k] + arr if k in avg else arr.astype(np.float64)
    n = float(len(paths))
    return {k: np.asarray(v / n, np.float32) for k, v in avg.items()}


def average_model_main(argv=None):
    p = argparse.ArgumentParser(description="average the chosen checkpoints")
    p.add_argument("--dst_model", required=True)
    p.add_argument("--src_paths", nargs="+", required=True,
                   help="the checkpoints (the reference can also pick them by validation loss; "
                        "pass the chosen files)")
    args = p.parse_args(argv)
    avg = average_checkpoints(args.src_paths)
    torch.save({k: torch.from_numpy(v) for k, v in avg.items()}, args.dst_model)
    print(f"averaged {len(args.src_paths)} checkpoints -> {args.dst_model}")


def recognize(extractor, feats, feat_lens, *, mode: str = "ctc_greedy_search",
              ctc_params: Optional[dict] = None, decoder_params: Optional[dict] = None,
              decoder_cfg=None, sos: int = 1, eos: int = 2, blank: int = 0,
              max_len: int = 100) -> List[List[int]]:
    """(B, T, 80) kaldi fbank and (B,) lengths -> token-id hypotheses, on
    `extractor.device` (a `PPGExtractor`: its encoder params and config).
    mode "ctc_greedy_search" over the CTC head `ctc_params` {"w", "b"}, or
    "attention": greedy decoding with `decoder_params` (bin/recognize.py:198-230)."""
    from f5e_tts_tpu_torch.models import wenet_decoder as wd
    from f5e_tts_tpu_torch.models.conformer import conformer_encode
    from f5e_tts_tpu_torch.ops import nn as fnn
    from f5e_tts_tpu_torch.utils.convert import to_tensors

    dev = extractor.device
    with torch.no_grad():
        enc, enc_lens = conformer_encode(extractor.params, extractor.cfg,
                                         torch.as_tensor(feats, device=dev),
                                         torch.as_tensor(feat_lens, device=dev))
        if mode == "ctc_greedy_search":
            if ctc_params is None:
                raise ValueError("ctc_greedy_search needs the CTC head (ctc_params)")
            logits = fnn.linear(to_tensors(ctc_params, dev), enc)
            return wd.ctc_greedy_search(logits, enc_lens, blank=blank)
        if mode == "attention":
            if decoder_params is None or decoder_cfg is None:
                raise ValueError("attention decoding needs decoder_params and decoder_cfg")
            return wd.attention_greedy_decode(to_tensors(decoder_params, dev), decoder_cfg, enc,
                                              enc_lens, sos, eos, max_len=max_len)
    raise ValueError(f"unknown decode mode {mode!r} (attention | ctc_greedy_search)")


def recognize_main(argv=None):
    """Recognise a list of fbank .npy files ((T, 80) or (B, T, 80)) with a
    wenet checkpoint and its train.yaml; prints `path<TAB>text` lines and,
    with --result_file, writes one JSON line per file."""
    import yaml

    from f5e_tts_tpu_torch.models import wenet_decoder as wd
    from f5e_tts_tpu_torch.models.conformer import load_ppg_extractor

    p = argparse.ArgumentParser(description="wenet-style recognition")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--config", required=True, help="train.yaml")
    p.add_argument("--feats", nargs="+", required=True, help="fbank .npy files")
    p.add_argument("--mode", default="ctc_greedy_search",
                   choices=["ctc_greedy_search", "attention"])
    p.add_argument("--dict", default=None, help="vocab file: 'token id' lines")
    p.add_argument("--result_file", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    extractor = load_ppg_extractor(args.checkpoint, args.config, device=args.device)
    sd = {k: v.float().numpy() for k, v in torch.load(args.checkpoint, map_location="cpu",
                                                       weights_only=True).items()
          if torch.is_tensor(v)}
    ctc_params = decoder_params = decoder_cfg = None
    if args.mode == "ctc_greedy_search":
        ctc_params = {"w": np.ascontiguousarray(sd["ctc.ctc_lo.weight"].T),
                      "b": sd["ctc.ctc_lo.bias"]}
    else:
        with open(args.config, "r", encoding="utf-8") as f:
            dcfg = yaml.safe_load(f).get("decoder_conf", {})
        key = ("decoder.output_layer.weight" if "decoder.output_layer.weight" in sd
               else "decoder.left_decoder.output_layer.weight")
        decoder_cfg = wd.DecoderConfig(
            vocab_size=sd[key].shape[0], dim=extractor.cfg.output_size,
            attention_heads=dcfg.get("attention_heads", 4),
            linear_units=dcfg.get("linear_units", 2048), num_blocks=dcfg.get("num_blocks", 6),
            r_num_blocks=dcfg.get("r_num_blocks", 0))
        decoder_params = wd.decoder_from_torch(sd, decoder_cfg)

    id2tok = None
    if args.dict:
        id2tok = {}
        with open(args.dict, "r", encoding="utf-8") as f:
            for line in f:
                tok, idx = line.strip().split()
                id2tok[int(idx)] = tok

    results = []
    for path in args.feats:
        feats = np.load(path).astype(np.float32)
        if feats.ndim == 2:
            feats = feats[None]
        hyps = recognize(extractor, feats, np.asarray([feats.shape[1]]), mode=args.mode,
                         ctc_params=ctc_params, decoder_params=decoder_params,
                         decoder_cfg=decoder_cfg)
        text = ("".join(id2tok.get(t, f"<{t}>") for t in hyps[0]) if id2tok
                else " ".join(map(str, hyps[0])))
        results.append({"feats": path, "ids": hyps[0], "text": text})
        print(f"{path}\t{text}")
    if args.result_file:
        with open(args.result_file, "w", encoding="utf-8") as f:
            for r in results:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return results


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "average":
        average_model_main(sys.argv[2:])
    else:
        recognize_main()
