"""PyTorch/CUDA port of f5e_tts_tpu for one NVIDIA H100.

The JAX package (`f5e_tts_tpu`) is the reference; this package mirrors its
layout (`config`, `ops`, `models`, `infer`, `train`, `data`, `utils`, `api`)
and never imports it or JAX. Hand-written Hopper kernels live in `csrc/` and
are bound through `kernels/`. Entry points run on the card unless the caller
passes `device="cpu"`.
"""
