"""Weight converters and import hygiene of the PyTorch port.

- `dit_from_jax(params)` and `dit_from_reference_state_dict(dit_to_torch(params))`
  must give identical port tensors: the reference loader undoes the torch
  layouts and re-applies the half-split q/k permutation that `dit_to_torch`
  removed.
- The port imports neither JAX nor the JAX package.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from f5e_tts_tpu.config import DiTConfig as JDiTConfig
from f5e_tts_tpu.models import dit as jdit
from f5e_tts_tpu.utils.torch_ckpt import dit_to_torch
from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.utils.convert import (dit_from_jax, dit_from_reference_state_dict,
                                             load_state_dict)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(dim=64, depth=3, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_dim=32,
            conv_layers=2, dropout=0.0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def jax_params():
    params, _ = jdit.init_dit(jax.random.PRNGKey(0), JDiTConfig(**TINY), 32)
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32)
                        * 0.01, params)


def test_jax_and_reference_loaders_give_identical_tensors(jax_params, tmp_path):
    cfg = DiTConfig(**TINY)
    direct = _flat(dit_from_jax(jax_params, cfg))
    sd = dit_to_torch(jax_params, {}, JDiTConfig(**TINY))
    via_ref = _flat(dit_from_reference_state_dict(sd, cfg))
    assert direct.keys() == via_ref.keys()
    for k in direct:
        assert direct[k].dtype == via_ref[k].dtype == torch.float32, k
        assert torch.equal(direct[k], via_ref[k]), k
    assert len(dit_from_jax(jax_params, cfg)["blocks"]) == TINY["depth"]

    # the same state dict through a .pt file and the checkpoint loader
    path = tmp_path / "model.pt"
    torch.save({"ema_model_state_dict": {**{f"ema_model.{k}": torch.from_numpy(v)
                                            for k, v in sd.items()}, "initted": torch.tensor(True),
                                         "step": torch.tensor(5)}}, path)
    loaded = _flat(dit_from_reference_state_dict(load_state_dict(str(path)), cfg))
    assert all(torch.equal(loaded[k], direct[k]) for k in direct)


def test_reference_loader_refuses_wrong_depth(jax_params):
    sd = dit_to_torch(jax_params, {}, JDiTConfig(**TINY))
    with pytest.raises(ValueError, match="depth"):
        dit_from_reference_state_dict(sd, DiTConfig(**{**TINY, "depth": 4}))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import f5e_tts_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'f5e_tts_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'f5e_tts_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 80, mods\n"
        "new = ('kernels.attention', 'models.mmdit', 'models.backbone', 'ops.attention',\n"
        "       'models.unett', 'models.durpred', 'infer.speech_edit', 'utils.aot',\n"
        "       'ops.vq', 'ops.mas', 'ops.kaldi', 'models.conformer',\n"
        "       'models.conformer_train', 'models.wenet_decoder', 'models.wenet_tools',\n"
        "       'models.ppg_extract_cli', 'data.asr_dataset', 'data.wav_augment',\n"
        "       'train.adamw8bit', 'train.train', 'ops.quant', 'infer.transcribe',\n"
        "       'serving.batcher', 'serving.http_server', 'serving.socket_server',\n"
        "       'serving.socket_client', 'serving.grpc_server', 'serving.grpc_client',\n"
        "       'serving.tts_pb2', 'serving.benchmark', 'serving.pcm',\n"
        "       'train.distill', 'train.distill_cli', 'train.finetune_cli', 'models.bigvgan',\n"
        "       'eval.ecapa', 'eval.utmos', 'eval.harness', 'eval.vc', 'eval.eval_infer_batch',\n"
        "       'eval.scorers', 'eval.score_cli', 'eval.proxy_quality',\n"
        "       'eval.quality_proxy_cli', 'utils.seed', 'utils.profiling', 'scripts',\n"
        "       'data.prepare', 'infer.voice_chat', 'native', 'parallel.mesh',\n"
        "       'parallel.multihost', 'parallel.pipeline', 'ops.ring_attention')\n"
        "assert all('f5e_tts_tpu_torch.' + m in mods for m in new), mods\n"
        "assert 'transformers' not in sys.modules  # imported only to build the ASR pipeline\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
