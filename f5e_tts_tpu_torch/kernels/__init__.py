"""Wrappers of the hand-written Hopper kernels.

Each wrapper takes its plain PyTorch version for tensors on the CPU and, for
CUDA tensors, launches its kernel or raises; it never falls back. Each keeps a
plain-integer count of its launches (`<module>.launches`, and
`<module>.bwd_launches` for a backward kernel). Each module's autograd
Function joins a forward kernel to its backward kernel.
"""
