"""Hand-written CUDA kernels of the PyTorch port vs their plain versions:
K1 and K4 (RoPE attention forward and backward), K2 and K5 (gated AdaLN
forward and backward), and the autograd Functions that join them.

These need a CUDA device and nvcc and skip without one. On a machine with
the card (which has no JAX, so the suite's conftest is left out):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: bf16 outputs of unit-scale inputs; kernel and plain version round
the same fp32 values, so they differ by summation order and at most ~1 bf16
ulp: |diff| <= 2e-2 + 1e-2 * |plain| (K1, K2, K5). K4's gradients are small
sums of many rounded terms, and the kernel forms delta from the bf16 output
where the plain version sums P * dP in fp32, so K4 is held to
max |diff| <= 2e-2 * max |plain| per output.
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


def _close_rel(got, ref, rel=2e-2):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err, top = (got - ref).abs().max().item(), ref.abs().max().item()
    assert err <= rel * top, (err, top)


@pytest.mark.parametrize("b,n,h,dh,kv,rope_heads,fused", [
    (2, 1024, 16, 64, (1024, 1024), 16, True),  # training: every key valid, qkv slices
    (2, 130, 3, 64, (130, 1), 3, False),        # ragged last tile, one valid key
    (1, 200, 2, 128, (0,), 2, False),           # dh 128, every key masked
    (2, 256, 4, 64, (256, 77), 1, True),        # RoPE on the first head only
])
def test_rope_attention_bwd_kernel_matches_plain(cuda, b, n, h, dh, kv, rope_heads, fused):
    if fused:
        qkv = torch.randn((b, n, 3 * h * dh), generator=cuda, device="cuda").bfloat16()
        q, k, v = (t.unflatten(-1, (h, dh)) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn((b, n, h, dh), generator=cuda, device="cuda").bfloat16()
                   for _ in range(3))
    g = torch.randn((b, n, h, dh), generator=cuda, device="cuda").bfloat16()
    kv_lens = torch.tensor(kv, dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))
    out, stats = ra.rope_attention(q, k, v, kv_lens, cos, sin, rope_heads, return_stats=True)
    before = ra.bwd_launches
    got = ra.rope_attention_bwd(q, k, v, kv_lens, cos, sin, g, rope_heads, out, stats)
    torch.cuda.synchronize()
    assert ra.bwd_launches == before + 1
    want = ra.rope_attention_bwd_plain(q, k, v, kv_lens, cos, sin, g, rope_heads)
    for x, y in zip(got, want):
        _close_rel(x, y)
    # no atomics: a second run gives the same bits
    again = ra.rope_attention_bwd(q, k, v, kv_lens, cos, sin, g, rope_heads, out, stats)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("b,n,d,strided", [(2, 2304, 1024, True), (1, 100, 520, False),
                                           (2, 33, 3072, True)])
def test_gated_adaln_bwd_kernel_matches_plain(cuda, b, n, d, strided):
    x, y, g_newx, g_out = (torch.randn((b, n, d), generator=cuda, device="cuda").bfloat16()
                           for _ in range(4))
    if strided:
        mod = torch.randn((b, 6 * d), generator=cuda, device="cuda").bfloat16()
        gate, scale = mod[:, 2 * d:3 * d], mod[:, 4 * d:5 * d]
    else:
        gate, scale = (torch.randn((b, d), generator=cuda, device="cuda").bfloat16()
                       for _ in range(2))
    before = ga.bwd_launches
    got = ga.gated_adaln_bwd(x, y, gate, scale, g_newx, g_out)
    torch.cuda.synchronize()
    assert ga.bwd_launches == before + 1
    for x_, y_ in zip(got, ga.gated_adaln_bwd_plain(x, y, gate, scale, g_newx, g_out)):
        _close(x_, y_)


def test_functions_launch_one_forward_and_one_backward_kernel(cuda):
    b, n, h, dh = 2, 192, 4, 64
    qkv = torch.randn((b, n, 3 * h * dh), generator=cuda, device="cuda").bfloat16()
    qkv.requires_grad_(True)
    q, k, v = (t.unflatten(-1, (h, dh)) for t in qkv.chunk(3, dim=-1))
    lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))
    x, y = (torch.randn((b, n, 256), generator=cuda, device="cuda").bfloat16().requires_grad_()
            for _ in range(2))
    mod = torch.randn((b, 3 * 256), generator=cuda, device="cuda").bfloat16().requires_grad_()
    gate, scale, shift = mod.chunk(3, dim=-1)
    counts = (ra.launches, ra.bwd_launches, ga.launches, ga.bwd_launches)
    o = ra.RopeAttention.apply(q, k, v, lens, cos, sin, h)
    new_x, out = ga.GatedAdaLN.apply(x, y, gate, scale, shift)
    (o.float().square().sum() + (new_x.float() * out.float()).sum()).backward()
    torch.cuda.synchronize()
    assert (ra.launches, ra.bwd_launches, ga.launches, ga.bwd_launches) == tuple(
        c + 1 for c in counts)
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all()
               for t in (qkv, x, y, mod))


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((1, 64, 2, 64), device="cuda")  # fp32
    lens = torch.tensor([64], dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(64, 64))
    with pytest.raises(ValueError):
        ra.rope_attention(x, x, x, lens, cos, sin, 2)
    with pytest.raises(ValueError):
        ga.gated_adaln(x[..., 0, :], x[..., 0, :], x[:, 0, 0], x[:, 0, 0], x[:, 0, 0])
    xb = x.bfloat16()
    with pytest.raises(ValueError):  # K4 needs K1's output and statistics
        ra.rope_attention_bwd(xb, xb, xb, lens, cos, sin, xb, 2)
    with pytest.raises(ValueError):
        ga.gated_adaln_bwd(x[..., 0, :], x[..., 0, :], x[:, 0, 0], x[:, 0, 0], x[..., 0, :],
                           x[..., 0, :])
