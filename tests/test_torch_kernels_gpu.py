"""Hand-written CUDA kernels of the PyTorch port vs their plain versions.

These need a CUDA device and nvcc and skip without one. On a machine with
the card (which has no JAX, so the suite's conftest is left out):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance: bf16 outputs of unit-scale inputs; kernel and plain version round
the same fp32 values, so they differ by summation order and at most ~1 bf16
ulp: |diff| <= 2e-2 + 1e-2 * |plain|.
"""

import pytest
import torch

from f5e_tts_tpu_torch.kernels import gated_adaln as ga
from f5e_tts_tpu_torch.kernels import rope_attention as ra
from f5e_tts_tpu_torch.ops.rope import rotary_cos_sin_half

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= 2e-2 + 1e-2 * ref.abs()).all(), (got - ref).abs().max().item()


@pytest.mark.parametrize("b,n,h,dh,kv,rope_heads,fused", [
    (2, 1536, 16, 64, (1416, 1100), 16, True),  # the main path's shape, qkv slices
    (2, 130, 3, 64, (130, 1), 3, False),        # ragged last tile, one valid key
    (1, 200, 2, 128, (0,), 2, False),           # dh 128, every key masked
    (2, 256, 4, 64, (256, 77), 1, True),        # RoPE on the first head only
])
def test_rope_attention_kernel_matches_plain(cuda, b, n, h, dh, kv, rope_heads, fused):
    if fused:
        qkv = torch.randn((b, n, 3 * h * dh), generator=cuda, device="cuda").bfloat16()
        q, k, v = (t.unflatten(-1, (h, dh)) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn((b, n, h, dh), generator=cuda, device="cuda").bfloat16()
                   for _ in range(3))
    kv_lens = torch.tensor(kv, dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))
    before = ra.launches
    out = ra.rope_attention(q, k, v, kv_lens, cos, sin, rope_heads)
    torch.cuda.synchronize()
    assert ra.launches == before + 1
    _close(out, ra.rope_attention_plain(q, k, v, kv_lens, cos, sin, rope_heads))


@pytest.mark.parametrize("b,n,d,strided", [(2, 1536, 1024, True), (1, 100, 520, False)])
def test_gated_adaln_kernel_matches_plain(cuda, b, n, d, strided):
    x, y = (torch.randn((b, n, d), generator=cuda, device="cuda").bfloat16() for _ in range(2))
    if strided:  # gate/scale/shift as column slices of the (B, 6D) modulation
        mod = torch.randn((b, 6 * d), generator=cuda, device="cuda").bfloat16()
        gate, scale, shift = mod[:, 2 * d:3 * d], mod[:, 4 * d:5 * d], mod[:, 3 * d:4 * d]
    else:
        gate, scale, shift = (torch.randn((b, d), generator=cuda, device="cuda").bfloat16()
                              for _ in range(3))
    before = ga.launches
    new_x, out = ga.gated_adaln(x, y, gate, scale, shift)
    torch.cuda.synchronize()
    assert ga.launches == before + 1
    ref_x, ref_out = ga.gated_adaln_plain(x, y, gate, scale, shift)
    _close(new_x, ref_x)
    _close(out, ref_out)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((1, 64, 2, 64), device="cuda")  # fp32
    lens = torch.tensor([64], dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(64, 64))
    with pytest.raises(ValueError):
        ra.rope_attention(x, x, x, lens, cos, sin, 2)
    with pytest.raises(ValueError):
        ga.gated_adaln(x[..., 0, :], x[..., 0, :], x[:, 0, 0], x[:, 0, 0], x[:, 0, 0])
