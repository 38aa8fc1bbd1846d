"""The port's mesh layout against the JAX package's, in this process (no
process group): mesh shapes, the DiT's partition specs, the YAML `mesh:`
section, the replica-scaled warmup and the per-process split. All exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import yaml
from jax.sharding import PartitionSpec

from f5e_tts_tpu import config as jconfig
from f5e_tts_tpu.parallel import make_mesh as jmake_mesh
from f5e_tts_tpu.parallel import multihost as jmultihost
from f5e_tts_tpu.parallel.mesh import dit_param_spec as jdit_param_spec
from f5e_tts_tpu.train import step as jstep
from f5e_tts_tpu_torch import config as tconfig
from f5e_tts_tpu_torch.parallel import mesh as pmesh
from f5e_tts_tpu_torch.parallel import multihost as tmultihost
from f5e_tts_tpu_torch.train import step as tstep

MESHES = [dict(data=4, model=2, seq=1), dict(data=-1, model=2), dict(data=2, fsdp=2, model=2),
          dict(data=2, pipe=4), dict(seq=8), dict(fsdp=2, pipe=2), dict()]


@pytest.mark.parametrize("axes", MESHES)
def test_mesh_shape_matches_jax(axes):
    want = jmake_mesh(jconfig.MeshConfig(**axes)).shape
    assert pmesh.mesh_shape(tconfig.MeshConfig(**axes), world=8) == dict(want)


def test_mesh_needing_more_ranks_than_the_world_raises():
    with pytest.raises(ValueError, match="needs 16 ranks"):
        pmesh.mesh_shape(tconfig.MeshConfig(data=2, model=8), world=8)
    with pytest.raises(AssertionError):
        jmake_mesh(jconfig.MeshConfig(data=2, model=8))


def _specs(tree):
    if isinstance(tree, (PartitionSpec, pmesh.P)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return [_specs(v) for v in tree]


@pytest.mark.parametrize("fsdp,pipe", [(False, False), (True, False), (False, True),
                                       (True, True)])
@pytest.mark.parametrize("extras", [{}, {"qk_norm": "rms_norm", "long_skip_connection": True},
                                    {"ppg": {"use_ppg": True},
                                     "codebook": {"use_codebook": True}}])
def test_dit_param_spec_matches_jax(fsdp, pipe, extras):
    kw = dict(dim=64, depth=2, heads=2, dim_head=32, conv_layers=2,
              **{k: v for k, v in extras.items() if k in ("qk_norm", "long_skip_connection")})
    jcfg = jconfig.DiTConfig(**kw, **{k: (jconfig.PPGConfig if k == "ppg" else
                                          jconfig.CodebookConfig)(**v)
                                      for k, v in extras.items() if k in ("ppg", "codebook")})
    tcfg = tconfig.DiTConfig(**kw, **{k: (tconfig.PPGConfig if k == "ppg" else
                                          tconfig.CodebookConfig)(**v)
                                      for k, v in extras.items() if k in ("ppg", "codebook")})
    assert _specs(pmesh.dit_param_spec(tcfg, fsdp=fsdp, pipe=pipe)) == \
        _specs(jdit_param_spec(jcfg, fsdp=fsdp, pipe=pipe))


def _write(path, data):
    path.write_text(yaml.safe_dump(data), "utf-8")
    return str(path)


@pytest.mark.parametrize("mesh", [None, {"fsdp": 2}, {"data": 2, "model": 2},
                                  {"data": -1, "seq": 4, "pipe": 2},
                                  {"data": 1, "fsdp": 2, "model": 2, "seq": 2, "pipe": 2}])
def test_load_train_yaml_reads_the_mesh_section_as_jax(tmp_path, mesh):
    path = _write(tmp_path / "t.yaml", {"optim": {"learning_rate": 1e-4}, "mesh": mesh})
    got, want = tconfig.load_train_yaml(path), jconfig.load_train_yaml(path)
    assert dataclasses.asdict(got.mesh) == dataclasses.asdict(want.mesh)
    assert got.pp_microbatches is want.pp_microbatches is None


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_warmup_scales_by_the_replica_count_as_jax(replicas):
    tc = dict(learning_rate=1e-3, num_warmup_updates=3)
    got = tstep.make_schedule(tconfig.TrainConfig(**tc), 20, num_replicas=replicas)
    want = jstep.make_schedule(jconfig.TrainConfig(**tc), 20, num_replicas=replicas)
    for c in range(22):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6, atol=1e-10)
    assert tstep.make_optimizer(tconfig.TrainConfig(**tc), 20, num_replicas=replicas
                                ).schedule(1) == got(1)


def test_split_between_processes_as_jax_in_one_process():
    # one process takes everything, as JAX's (the split over four ranks:
    # tests/test_torch_parallel_ops.py)
    items = list(range(7))
    for pad in (False, True):
        assert tmultihost.split_between_processes(items, pad) == \
            jmultihost.split_between_processes(items, pad) == items
    assert tmultihost.process_count() == jax.process_count() == 1
    assert tmultihost.process_index() == jax.process_index() == 0


def test_world_of_one_trainer_and_the_trainer_refusals(tmp_path):
    from f5e_tts_tpu_torch.train.trainer import Trainer

    dit = tconfig.ModelConfig(name="t", backbone="DiT", arch=tconfig.DiTConfig(
        dim=32, depth=2, heads=1, dim_head=32, ff_mult=2, mel_dim=8, text_dim=8, conv_layers=0))
    tr = Trainer(dit, tconfig.TrainConfig(save_dir=str(tmp_path)), vocab_size=8, tokenize=None,
                 device="cpu")
    assert tr.mesh.world == 1 and tr.mesh.shape["data"] == 1 and tr.sharded_cfg is None
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        pmesh.make_mesh(tconfig.MeshConfig(data=2))
    # refused from the config, before any group: a pipeline over a UNetT (the
    # JAX trainer asserts the same, trainer.py:122-133); the 8-bit AdamW under
    # a mesh that splits tensors
    unett = tconfig.ModelConfig(name="t", backbone="UNetT", arch=tconfig.UNetTConfig(
        dim=32, depth=2, heads=1, dim_head=32))
    with pytest.raises(ValueError, match="only supported for the DiT"):
        Trainer(unett, tconfig.TrainConfig(save_dir=str(tmp_path),
                                           mesh=tconfig.MeshConfig(pipe=2)),
                vocab_size=8, tokenize=None, device="cpu")
    for axes in ({"fsdp": 2}, {"model": 2}):
        with pytest.raises(NotImplementedError, match="8-bit AdamW"):
            Trainer(dit, tconfig.TrainConfig(save_dir=str(tmp_path), bnb_optimizer=True,
                                             mesh=tconfig.MeshConfig(**axes)),
                    vocab_size=8, tokenize=None, device="cpu")
