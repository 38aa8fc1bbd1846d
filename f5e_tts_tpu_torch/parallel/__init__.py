"""Parallel training on torch.distributed (counterpart of
`f5e_tts_tpu/parallel/`): the five-axis mesh and its sharding rules
(mesh.py), GPipe over the DiT's depth (pipeline.py) and the process-group
utilities (multihost.py). Ring attention is ops/ring_attention.py."""

from f5e_tts_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    dit_param_spec,
    gather_dit_params,
    make_mesh,
    shard_batch,
    shard_dit_params,
)
