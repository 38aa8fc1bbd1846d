"""Hand-written CUDA kernels of the PyTorch port vs their plain versions:
K1/K3 and K4/K6 (RoPE attention forward and backward, on all or some of the
heads), K9 and K10 (key-length-masked attention without RoPE), K7 and K8
(joint [audio | text] attention), K2 and K5 (gated AdaLN forward and
backward), and the autograd Functions that join them.

These need a CUDA device and nvcc and skip without one. On a machine with
the card (which has no JAX, so the suite's conftest is left out):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: bf16 outputs of unit-scale inputs; kernel and plain version round
the same fp32 values, so they differ by summation order and at most ~1 bf16
ulp: |diff| <= 2e-2 + 1e-2 * |plain| (K1, K2, K5; K5 adds its (B, D) sums
in a fixed order, so two runs give the same bits). K4's gradients are small
sums of many rounded terms, and the kernel forms delta from the bf16 output
where the plain version sums P * dP in fp32, so K4 is held to
max |diff| <= 2e-2 * max |plain| per output; K10 and K8 are the same kernels
without RoPE and with another column rule, and are held to the same limits.
The pre-pass of either direction against its plain twin: q' and k' within
one bf16 ulp (bitwise where nvcc does not contract the rotation's products;
the tests record which as the `prepass_bitwise` property; the forward's
edge cases also take 2^-20 absolute, the fp32 rounding of the rotation's
products of unit-scale inputs where the two cancel near 0, which the
contraction changes by more than one ulp of the small result), delta within
1e-5 * (1 + sum_d |dO * O|) per row (fp32 summation order). The forward's
row statistics against `attention_stats_plain` on the same q', k': m within
1e-2 absolute, linv within 1e-2 relative (fp32 sums in another order, over
scores of bf16 operands; a row with every key masked has m = -1e30 on both
sides).

fp32 operands launch the fp32 kernels (csrc/attention_fp32.cuh, and K2/K5's
fp32 instantiations), held 100x tighter than bf16: |diff| <= 2e-4 + 1e-4 *
|plain| (forwards, K2, K5), max |diff| <= 2e-4 * max |plain| (attention
backwards). K2/K5 differ from their plain versions by summation order alone;
the attention kernels sum each product in three TF32 passes (hi.lo + lo.hi +
hi.hi, ~2^-21 relative a product), which a case with scores of about +-30
holds to those limits where one or two passes would fail them.
"""

import pytest
import torch

from f5e_tts_tpu_torch.kernels import attention as ka
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
    (2, 1536, 12, 64, (1416, 1100), 1, True),   # the F5E model's sampler: 12 heads, K3
    (3, 200, 12, 64, (200, 57, 0), 1, True),    # 12 heads, ragged, one row all masked
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
    partial = 0 < rope_heads < h  # counted as the partial-RoPE kernel's launch
    before = (ra.launches, ra.partial_launches)
    out = ra.rope_attention(q, k, v, kv_lens, cos, sin, rope_heads)
    torch.cuda.synchronize()
    assert (ra.launches, ra.partial_launches) == (before[0] + (not partial), before[1] + partial)
    _close(out, ra.rope_attention_plain(q, k, v, kv_lens, cos, sin, rope_heads))


@pytest.mark.parametrize("b,n,d,strided", [(2, 1536, 1024, True), (1, 100, 520, False),
                                           (2, 1536, 768, True),   # the F5E model's width
                                           (3, 77, 768, False),
                                           # one warp a row, V = ceil(D / 256) vectors a lane:
                                           (2, 333, 768, True),    # V 3, odd row count
                                           (3, 257, 1024, True),   # V 4, odd row count
                                           (2, 50, 64, True),      # V 1, 24 lanes idle
                                           (2, 301, 1000, True),   # V 4, D not a multiple of 256
                                           (2, 130, 4096, True),   # V 16, the widest
                                           (1, 1, 1024, False),    # one row
                                           (40, 3, 768, True)])    # many samples, few rows
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
    (8, 2304, 12, 64, (2304,) * 8, 1, True),    # the F5E training step: 12 heads, K6
    (2, 2304, 12, 64, (2304, 1337), 1, True),   # 12 heads, a ragged key length
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
    partial = 0 < rope_heads < h
    before = (ra.bwd_launches, ra.partial_bwd_launches)
    got = ra.rope_attention_bwd(q, k, v, kv_lens, cos, sin, g, rope_heads, out, stats)
    torch.cuda.synchronize()
    assert (ra.bwd_launches, ra.partial_bwd_launches) == (before[0] + (not partial),
                                                          before[1] + partial)
    want = ra.rope_attention_bwd_plain(q, k, v, kv_lens, cos, sin, g, rope_heads)
    for x, y in zip(got, want):
        _close_rel(x, y)
    # no atomics: a second run gives the same bits
    again = ra.rope_attention_bwd(q, k, v, kv_lens, cos, sin, g, rope_heads, out, stats)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _adaln_bwd_inputs(gen, b, n, d, strided):
    x, y, g_newx, g_out = (torch.randn((b, n, d), generator=gen, device="cuda").bfloat16()
                           for _ in range(4))
    if strided:  # column slices of the (B, 6D) modulation, as in the DiT block
        mod = torch.randn((b, 6 * d), generator=gen, device="cuda").bfloat16()
        gate, scale = mod[:, 2 * d:3 * d], mod[:, 4 * d:5 * d]
    else:
        gate, scale = (torch.randn((b, d), generator=gen, device="cuda").bfloat16()
                       for _ in range(2))
    return x, y, gate, scale, g_newx, g_out


@pytest.mark.parametrize("b,n,d,strided", [
    (2, 2304, 1024, True), (1, 100, 520, False), (2, 33, 3072, True),
    (8, 2304, 1024, True),   # the training step's shape
    (3, 1000, 1024, False),  # N not a multiple of the rows per block
    (1, 1, 1024, False),     # one row: one warp of one block works
    (2, 77, 520, True),      # D = 520: lanes with 3 vectors beside lanes with 2
    (2, 130, 4096, True),    # the widest D: column sums in shared memory
    (8, 2305, 768, True),    # F5TTS_Small's width, one row past the step's N
    (8, 2304, 768, True),    # the F5E training step's shape
])
def test_gated_adaln_bwd_kernel_matches_plain(cuda, b, n, d, strided):
    args = _adaln_bwd_inputs(cuda, b, n, d, strided)
    before = ga.bwd_launches
    got = ga.gated_adaln_bwd(*args)
    torch.cuda.synchronize()
    assert ga.bwd_launches == before + 1
    for x_, y_ in zip(got, ga.gated_adaln_bwd_plain(*args)):
        _close(x_, y_)


@pytest.mark.parametrize("b,n,d", [(8, 2304, 1024), (3, 1000, 1024), (2, 130, 4096),
                                   (8, 2304, 768)])
def test_gated_adaln_bwd_kernel_gives_the_same_bits_twice(cuda, b, n, d):
    args = _adaln_bwd_inputs(cuda, b, n, d, True)
    first = ga.gated_adaln_bwd(*args)
    again = ga.gated_adaln_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, again))


def test_gated_adaln_bwd_split_fills_the_card_in_one_wave(cuda):
    """At the training step's shape a block of 8 warps takes one SM, and each
    sample's rows go to as many blocks as fill the SMs once."""
    b, n, d = 8, 2304, 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = ga._lib().gated_adaln_bwd_groups(b, n, d)
    assert b * groups <= sms < b * (groups + 1)


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
    x = torch.zeros((1, 64, 2, 64), device="cuda", dtype=torch.float16)  # neither bf16 nor fp32
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


@pytest.mark.parametrize("d", [4104, 1020, 12])
def test_gated_adaln_refuses_widths_it_does_not_take(cuda, d):
    """K2 takes D <= 4096 and a multiple of 8 (whole 16-byte vectors)."""
    x = torch.zeros((2, 8, d), device="cuda", dtype=torch.bfloat16)
    m = torch.zeros((2, d), device="cuda", dtype=torch.bfloat16)
    before = ga.launches
    with pytest.raises(ValueError, match="D % 8 == 0 and D <= 4096"):
        ga.gated_adaln(x, x, m, m, m)
    assert ga.launches == before


def _qkv(gen, b, n, h, dh, fused):
    if fused:  # column slices of one projection's output, read through row strides
        qkv = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda").bfloat16()
        return tuple(t.unflatten(-1, (h, dh)) for t in qkv.chunk(3, dim=-1))
    return tuple(torch.randn((b, n, h, dh), generator=gen, device="cuda").bfloat16()
                 for _ in range(3))


# (b, n, h, dh, lens, n_audio, fused); n_audio None: the key-length mask (K9/K10)
ATTENTION_CASES = [
    (2, 2432, 16, 64, (2432, 2432), None, False),  # MMDiT training: every key valid
    (2, 130, 3, 64, (130, 1), None, True),         # ragged last tile, one valid key
    (1, 200, 2, 128, (0,), None, False),           # dh 128, every key masked
    (2, 1664, 16, 64, (1416, 1100), 1536, False),  # MMDiT synthesis: 1536 audio + 128 text
    (2, 1632, 4, 64, (1536, 70), 1536, False),     # N + Nt = 1536 + 96: a multiple of 32 only
    (3, 232, 2, 64, (0, 200, 57), 200, False),     # audio_len 0 and n_audio, n_audio % 64 != 0, Nt 32
    (2, 160, 2, 128, (128, 5), 128, True),         # dh 128, Nt 32
    (1, 192, 2, 64, (0,), 192, False),             # no text and no audio: every key masked
]


def _forward_and_plain(q, k, v, lens, n_audio, return_stats=False):
    if n_audio is None:
        return (ka.masked_attention(q, k, v, lens, return_stats=return_stats),
                ka.masked_attention_plain(q, k, v, lens))
    return (ka.joint_attention_core(q, k, v, lens, n_audio, return_stats=return_stats),
            ka.joint_attention_core_plain(q, k, v, lens, n_audio))


@pytest.mark.parametrize("b,n,h,dh,lens,n_audio,fused", ATTENTION_CASES)
def test_attention_kernel_matches_plain(cuda, b, n, h, dh, lens, n_audio, fused):
    q, k, v = _qkv(cuda, b, n, h, dh, fused)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = (ka.masked_launches, ka.joint_launches)
    out, ref = _forward_and_plain(q, k, v, lens, n_audio)
    torch.cuda.synchronize()
    assert (ka.masked_launches, ka.joint_launches) == (
        before[0] + (n_audio is None), before[1] + (n_audio is not None))
    _close(out, ref)


@pytest.mark.parametrize("b,n,h,dh,lens,n_audio,fused", ATTENTION_CASES)
def test_attention_bwd_kernel_matches_plain(cuda, b, n, h, dh, lens, n_audio, fused):
    q, k, v = _qkv(cuda, b, n, h, dh, fused)
    g = torch.randn((b, n, h, dh), generator=cuda, device="cuda").bfloat16()
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    (out, stats), _ = _forward_and_plain(q, k, v, lens, n_audio, return_stats=True)
    before = (ka.masked_bwd_launches, ka.joint_bwd_launches)
    if n_audio is None:
        run = lambda: ka.masked_attention_bwd(q, k, v, lens, g, out, stats)  # noqa: E731
        want = ka.masked_attention_bwd_plain(q, k, v, lens, g)
    else:
        run = lambda: ka.joint_attention_core_bwd(q, k, v, lens, n_audio, g, out, stats)  # noqa: E731
        want = ka.joint_attention_core_bwd_plain(q, k, v, lens, n_audio, g)
    got = run()
    torch.cuda.synchronize()
    assert (ka.masked_bwd_launches, ka.joint_bwd_launches) == (
        before[0] + (n_audio is None), before[1] + (n_audio is not None))
    for x, y in zip(got, want):
        _close_rel(x, y)
    # a fully masked row: the scores depend on neither q nor k
    for i, length in enumerate(lens.tolist()):
        if length == 0 and (n_audio is None or n_audio >= n):
            assert not got[0][i].any() and not got[1][i].any()
    # no atomics: a second run gives the same bits
    assert all(torch.equal(x, y) for x, y in zip(got, run()))


def test_padded_audio_keys_do_not_reach_the_joint_output(cuda):
    b, n_audio, nt, h, dh = 2, 192, 64, 2, 64
    q, k, v = _qkv(cuda, b, n_audio + nt, h, dh, False)
    lens = torch.tensor([n_audio, 100], dtype=torch.int32, device="cuda")
    out = ka.joint_attention_core(q, k, v, lens, n_audio)
    k2, v2 = k.clone(), v.clone()
    k2[1, 100:n_audio] = 99.0
    v2[1, 100:n_audio] = -99.0
    assert torch.equal(out, ka.joint_attention_core(q, k2, v2, lens, n_audio))


def test_partial_rope_launches_count_as_their_own_kernels(cuda):
    b, n, h, dh = 1, 128, 4, 64
    q, k, v = _qkv(cuda, b, n, h, dh, True)
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))
    counts = lambda: (ra.launches, ra.partial_launches, ra.bwd_launches,  # noqa: E731
                      ra.partial_bwd_launches)
    for rope_heads, moved in ((h, (1, 0, 1, 0)), (1, (0, 1, 0, 1)), (0, (1, 0, 1, 0))):
        before = counts()
        out, stats = ra.rope_attention(q, k, v, lens, cos, sin, rope_heads, return_stats=True)
        ra.rope_attention_bwd(q, k, v, lens, cos, sin, out, rope_heads, out, stats)
        assert counts() == tuple(x + y for x, y in zip(before, moved))


def test_attention_functions_launch_one_forward_and_one_backward_kernel(cuda):
    b, n_audio, nt, h, dh = 2, 160, 32, 4, 64
    q, k, v = (t.detach().requires_grad_() for t in _qkv(cuda, b, n_audio + nt, h, dh, False))
    lens = torch.tensor([160, 90], dtype=torch.int32, device="cuda")
    counts = lambda: (ka.masked_launches, ka.masked_bwd_launches, ka.joint_launches,  # noqa: E731
                      ka.joint_bwd_launches)
    before = counts()
    o1 = ka.MaskedAttention.apply(q, k, v, torch.full_like(lens, n_audio + nt))
    o2 = ka.JointAttention.apply(q, k, v, lens, n_audio)
    (o1.float().square().sum() + o2.float().square().sum()).backward()
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))
    with torch.no_grad():  # no gradient wanted: no statistics, still one launch
        ka.JointAttention.apply(q, k, v, lens, n_audio)
    assert counts()[2] == before[2] + 2


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((1, 64, 2, 64), device="cuda", dtype=torch.float16)  # neither bf16 nor fp32
    lens = torch.tensor([64], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        ka.masked_attention(x, x, x, lens)
    xb = x.bfloat16()
    with pytest.raises(ValueError):
        ka.joint_attention_core(xb, xb, xb, lens, 65)
    with pytest.raises(ValueError):  # K10 needs K9's output and statistics
        ka.masked_attention_bwd(xb, xb, xb, lens, xb)
    with pytest.raises(ValueError):
        ka.joint_attention_core(xb[..., :32], xb[..., :32], xb[..., :32], lens, 32)


# (kind, b, n, h, dh, lens, rope_heads or n_audio, fused): the edges of the
# backward's tiles and maps
BWD_EDGE_CASES = [
    ("rope", 2, 2305, 2, 64, (2305, 2000), 2, False),   # a one-row last tile
    ("rope", 2, 40, 2, 64, (40, 17), 2, False),         # under one tile
    ("rope", 2, 1000, 2, 128, (1000, 999), 2, False),   # dh 128
    ("rope", 2, 1024, 16, 64, (1024, 700), 1, True),    # fused to_qkv slices, RoPE on head 0
    ("joint", 2, 240, 2, 64, (10, 200), 200, False),    # text from mid-tile, gap over two tiles
    ("joint", 2, 200, 2, 64, (0, 150), 200, False),     # no text, len = 0: the uniform average
    ("masked", 3, 300, 2, 64, (300, 0, 129), 0, True),  # a row with len = 0
    ("rope", 8, 2304, 16, 64, (2304,) * 8, 16, True),   # T: the v1 training step's shape
    ("rope", 8, 2305, 16, 64, (2305,) * 8, 1, True),    # the E2 step: N+1 rows, RoPE on head 0
]


def _bwd_case(gen, kind, b, n, h, dh, lens, extra, fused):
    """(run, plain, twin, g, out): the backward kernel, its plain version,
    the pre-pass's plain twin, the cotangent and the forward kernel's output."""
    q, k, v = _qkv(gen, b, n, h, dh, fused)
    g = torch.randn((b, n, h, dh), generator=gen, device="cuda").bfloat16()
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if kind == "rope":
        cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))
        out, stats = ra.rope_attention(q, k, v, lens, cos, sin, extra, return_stats=True)
        return (lambda: ra.rope_attention_bwd(q, k, v, lens, cos, sin, g, extra, out, stats),
                lambda: ra.rope_attention_bwd_plain(q, k, v, lens, cos, sin, g, extra),
                lambda: ka.attention_prep_plain(q, k, g, out, cos, sin, extra), g, out)
    if kind == "masked":
        out, stats = ka.masked_attention(q, k, v, lens, return_stats=True)
        return (lambda: ka.masked_attention_bwd(q, k, v, lens, g, out, stats),
                lambda: ka.masked_attention_bwd_plain(q, k, v, lens, g),
                lambda: ka.attention_prep_plain(q, k, g, out), g, out)
    out, stats = ka.joint_attention_core(q, k, v, lens, extra, return_stats=True)
    return (lambda: ka.joint_attention_core_bwd(q, k, v, lens, extra, g, out, stats),
            lambda: ka.joint_attention_core_bwd_plain(q, k, v, lens, extra, g),
            lambda: ka.attention_prep_plain(q, k, g, out), g, out)


@pytest.mark.parametrize("kind,b,n,h,dh,lens,extra,fused", BWD_EDGE_CASES)
def test_bwd_kernel_edges_match_plain(cuda, kind, b, n, h, dh, lens, extra, fused):
    run, plain, *_ = _bwd_case(cuda, kind, b, n, h, dh, lens, extra, fused)
    got = run()
    torch.cuda.synchronize()
    for x, y in zip(got, plain()):
        _close_rel(x, y)
    assert all(torch.equal(x, y) for x, y in zip(got, run()))  # no atomics: the same bits


def _within_one_ulp(got, want, atol: float = 0.0):
    """bf16 tensors equal or adjacent representable values, or within `atol`."""
    steps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    near = (got.float() - want.float()).abs() <= atol
    return bool(((got == want) | (steps <= 1) | near).all())


@pytest.mark.parametrize("kind,rope_heads", [("rope", 4), ("rope", 1), ("masked", 0)])
def test_bwd_prepass_matches_its_twin(cuda, monkeypatch, record_property, kind, rope_heads):
    run, _, twin, g, out = _bwd_case(cuda, kind, 2, 333, 4, 64, (333, 200), rope_heads, True)
    scratch, written = ka.prep_scratch, []

    def capture(q, rotated, delta=False):  # the buffers the pre-pass writes
        written.append(scratch(q, rotated, delta))
        return written[-1]

    monkeypatch.setattr(ka, "prep_scratch", capture)
    monkeypatch.setattr(ra, "prep_scratch", capture)
    run()
    torch.cuda.synchronize()
    *rotated, delta = written[0]
    qs, ks, want_delta = twin()
    assert len(rotated) == (2 if kind == "rope" else 1)  # k' only where RoPE is compiled in
    bitwise = True
    for got, want in zip(rotated, (qs, ks)):
        want = want.transpose(1, 2).bfloat16()
        assert _within_one_ulp(got, want)
        bitwise = bitwise and torch.equal(got, want)
    record_property("prepass_bitwise", bitwise)
    print(f"pre-pass q'/k' bitwise equal to the twin: {bitwise}")
    terms = (g.float() * out.float()).abs().sum(dim=-1).transpose(1, 2)
    assert ((delta - want_delta).abs() <= 1e-5 * (1 + terms)).all()


# (kind, b, n, h, dh, lens, rope_heads or n_audio, fused): the edges of the
# forward's tiles and maps
FWD_EDGE_CASES = [
    ("rope", 2, 2305, 2, 64, (2305, 2000), 2, False),   # a one-row last tile
    ("rope", 2, 40, 2, 64, (40, 17), 2, False),         # under one tile
    ("rope", 2, 1000, 2, 128, (1000, 999), 2, False),   # dh 128
    ("rope", 2, 1024, 16, 64, (1024, 700), 1, True),    # fused to_qkv slices, RoPE on head 0
    ("joint", 2, 240, 2, 64, (10, 200), 200, False),    # text from mid-tile, gap over two tiles
    ("joint", 2, 200, 2, 64, (0, 150), 200, False),     # no text, len = 0: the uniform average
    ("masked", 3, 300, 2, 64, (300, 0, 129), 0, True),  # a row with len = 0
    ("rope", 8, 2304, 16, 64, (2304,) * 8, 16, True),   # T: the v1 training step's shape
    ("rope", 2, 1537, 16, 64, (1537, 1101), 1, True),   # E2 synthesis: N+1 = 1 mod 64 rows
]


def _fwd_case(gen, kind, b, n, h, dh, lens, extra, fused):
    """(run, plain, twin, valid): the forward kernel with its statistics, its
    plain version, the pre-pass's plain twin and the valid key columns."""
    q, k, v = _qkv(gen, b, n, h, dh, fused)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if kind == "rope":
        cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))
        return (lambda: ra.rope_attention(q, k, v, lens, cos, sin, extra, return_stats=True),
                lambda: ra.rope_attention_plain(q, k, v, lens, cos, sin, extra),
                lambda: ka.attention_prep_plain(q, k, cos=cos, sin=sin, rope_heads=extra),
                ka.prefix_valid(lens, n, q.device))
    if kind == "masked":
        return (lambda: ka.masked_attention(q, k, v, lens, return_stats=True),
                lambda: ka.masked_attention_plain(q, k, v, lens),
                lambda: ka.attention_prep_plain(q, k), ka.prefix_valid(lens, n, q.device))
    return (lambda: ka.joint_attention_core(q, k, v, lens, extra, return_stats=True),
            lambda: ka.joint_attention_core_plain(q, k, v, lens, extra),
            lambda: ka.attention_prep_plain(q, k),
            ka.joint_valid(lens, extra, n, q.device))


@pytest.mark.parametrize("kind,b,n,h,dh,lens,extra,fused", FWD_EDGE_CASES)
def test_fwd_kernel_edges_match_plain(cuda, monkeypatch, record_property, kind, b, n, h, dh,
                                      lens, extra, fused):
    run, plain, twin, valid = _fwd_case(cuda, kind, b, n, h, dh, lens, extra, fused)
    scratch, written = ka.prep_scratch, []

    def capture(q, rotated, delta=False):  # the buffers the pre-pass writes
        written.append(scratch(q, rotated, delta))
        return written[-1]

    monkeypatch.setattr(ka, "prep_scratch", capture)
    monkeypatch.setattr(ra, "prep_scratch", capture)
    out, (m, linv) = run()
    torch.cuda.synchronize()
    _close(out, plain())
    qs, ks, _ = twin()
    want_m, want_linv = ka.attention_stats_plain(qs, ks, valid)
    assert (m - want_m).abs().max().item() <= 1e-2
    assert ((linv - want_linv).abs() <= 1e-2 * want_linv.abs()).all()
    # the pre-pass: q' (and k' where RoPE is compiled in) within one bf16 ulp,
    # or within 2^-20 where the rotation's two fp32 products cancel
    *rotated, delta = written[0]
    assert len(rotated) == (2 if kind == "rope" else 1) and delta is None
    bitwise = True
    for got, want in zip(rotated, (qs, ks)):
        want = want.transpose(1, 2).bfloat16()
        assert _within_one_ulp(got, want, atol=2**-20), (got.float() - want.float()).abs().max()
        bitwise = bitwise and torch.equal(got, want)
    record_property("prepass_bitwise", bitwise)
    # no atomics: a second run gives the same bits
    again, (m2, linv2) = run()
    assert torch.equal(out, again) and torch.equal(m, m2) and torch.equal(linv, linv2)


# ---------------------------------------------------------------------------
# fp32 operands: the fp32 kernels, counted apart
# ---------------------------------------------------------------------------

FP32_ATOL, FP32_RTOL, FP32_BWD_REL = 2e-4, 1e-4, 2e-4


def _close32(got, ref):
    assert got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    assert (err <= FP32_ATOL + FP32_RTOL * ref.abs()).all(), err.max().item()


def _counts32():
    return (ra.fp32_launches, ra.fp32_partial_launches, ra.fp32_bwd_launches,
            ra.fp32_partial_bwd_launches, ka.fp32_masked_launches, ka.fp32_masked_bwd_launches,
            ka.fp32_joint_launches, ka.fp32_joint_bwd_launches, ga.fp32_launches,
            ga.fp32_bwd_launches)


def _counts16():
    return (ra.launches, ra.partial_launches, ra.bwd_launches, ra.partial_bwd_launches,
            ka.masked_launches, ka.masked_bwd_launches, ka.joint_launches,
            ka.joint_bwd_launches, ga.launches, ga.bwd_launches)


# (kind, b, n, h, dh, lens, rope_heads or n_audio, fused)
# (kind, b, n, h, dh, lens, rope_heads or n_audio, fused, scale of q and k)
FP32_CASES = [
    ("rope", 2, 1536, 16, 64, (1416, 1100), 16, True, 1.0),  # S, the v1 sampler hook's shape
    ("rope", 2, 130, 3, 128, (130, 1), 3, False, 1.0),       # dh 128, ragged tile, one valid key
    ("rope", 2, 256, 4, 64, (256, 77), 1, True, 1.0),        # RoPE on the first head (K3/K6)
    ("rope", 1, 200, 2, 64, (0,), 2, False, 1.0),            # every key masked
    ("masked", 3, 300, 2, 64, (300, 0, 129), 0, True, 1.0),  # K9/K10, a row with len 0
    ("masked", 2, 96, 2, 128, (96, 40), 0, False, 1.0),      # dh 128
    ("joint", 2, 240, 2, 64, (10, 200), 200, False, 1.0),    # K7/K8, text from mid-tile
    ("joint", 3, 232, 2, 128, (0, 200, 57), 200, False, 1.0),  # dh 128, audio_len 0
    # q and k of standard deviation 2.5: scores of deviation ~6 spanning about
    # +-30, where one or two TF32 passes err by ~2^-11 x 30 (test_torch_tf32_split.py)
    ("rope", 2, 512, 4, 64, (512, 389), 4, True, 2.5),
    ("rope", 2, 2305, 2, 64, (2305, 2000), 2, False, 1.0),   # a one-row last tile
]


def _fp32_case(gen, kind, b, n, h, dh, lens, extra, fused, scale=1.0):
    """(forward(return_stats), plain, backward(out, stats), plain backward);
    q and k times `scale`."""
    if fused:
        qkv = torch.randn((b, n, 3 * h * dh), generator=gen, device="cuda")
        qkv[..., :2 * h * dh] *= scale
        q, k, v = (t.unflatten(-1, (h, dh)) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn((b, n, h, dh), generator=gen, device="cuda") for _ in range(3))
        q, k = q * scale, k * scale
    g = torch.randn((b, n, h, dh), generator=gen, device="cuda")
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if kind == "rope":
        cos, sin = (torch.from_numpy(t).cuda() for t in rotary_cos_sin_half(dh, n))
        return (lambda **kw: ra.rope_attention(q, k, v, lens, cos, sin, extra, **kw),
                lambda: ra.rope_attention_plain(q, k, v, lens, cos, sin, extra),
                lambda out, st: ra.rope_attention_bwd(q, k, v, lens, cos, sin, g, extra, out, st),
                lambda: ra.rope_attention_bwd_plain(q, k, v, lens, cos, sin, g, extra))
    if kind == "masked":
        return (lambda **kw: ka.masked_attention(q, k, v, lens, **kw),
                lambda: ka.masked_attention_plain(q, k, v, lens),
                lambda out, st: ka.masked_attention_bwd(q, k, v, lens, g, out, st),
                lambda: ka.masked_attention_bwd_plain(q, k, v, lens, g))
    return (lambda **kw: ka.joint_attention_core(q, k, v, lens, extra, **kw),
            lambda: ka.joint_attention_core_plain(q, k, v, lens, extra),
            lambda out, st: ka.joint_attention_core_bwd(q, k, v, lens, extra, g, out, st),
            lambda: ka.joint_attention_core_bwd_plain(q, k, v, lens, extra, g))


@pytest.mark.parametrize("kind,b,n,h,dh,lens,extra,fused,scale", FP32_CASES)
def test_fp32_attention_kernels_match_plain(cuda, kind, b, n, h, dh, lens, extra, fused, scale):
    fwd, plain, bwd, bwd_plain = _fp32_case(cuda, kind, b, n, h, dh, lens, extra, fused, scale)
    before32, before16 = _counts32(), _counts16()
    out, stats = fwd(return_stats=True)
    torch.cuda.synchronize()
    _close32(out, plain())
    got = bwd(out, stats)
    torch.cuda.synchronize()
    for x, y in zip(got, bwd_plain()):
        assert x.dtype == torch.float32 and torch.isfinite(x).all()
        assert (x - y).abs().max().item() <= FP32_BWD_REL * y.abs().max().item()
    assert all(torch.equal(x, y) for x, y in zip(got, bwd(out, stats)))  # no atomics
    assert _counts16() == before16  # no bf16 kernel ran
    moved = [a - b_ for a, b_ in zip(_counts32(), before32)]
    partial = kind == "rope" and 0 < extra < h
    want = {"rope": (0 if partial else 1, 1 if partial else 0, 0 if partial else 2,
                     2 if partial else 0, 0, 0, 0, 0),
            "masked": (0, 0, 0, 0, 1, 2, 0, 0), "joint": (0, 0, 0, 0, 0, 0, 1, 2)}[kind]
    assert moved == [*want, 0, 0]


@pytest.mark.parametrize("kind,extra", [("rope", 16), ("rope", 1), ("masked", 0), ("joint", 2304)])
def test_fp32_attention_kernels_repeat_bits(cuda, kind, extra):
    """The fp32 forward, its row statistics and the backward give the same
    bits in two runs (no atomics; every sum in a fixed order), at the v1
    training step's shape T (the joint rule over T's audio and 128 text keys)."""
    n = 2304 + (128 if kind == "joint" else 0)
    lens = (2304, 2000, 1337, 2304, 900, 1, 2303, 64)
    fwd, _, bwd, _ = _fp32_case(cuda, kind, 8, n, 16, 64, lens, extra, kind == "rope")
    out, stats = fwd(return_stats=True)
    grads = bwd(out, stats)
    out2, stats2 = fwd(return_stats=True)
    grads2 = bwd(out2, stats2)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and all(torch.equal(x, y) for x, y in zip(stats, stats2))
    assert all(torch.equal(x, y) for x, y in zip(grads, grads2))
    assert all(torch.isfinite(x).all() for x in (out, *grads))


@pytest.mark.parametrize("b,n,d,strided", [
    (16, 168, 128, True),    # the quality proxy's training step: D = 128, V 1
    (128, 192, 128, False),  # its folded evaluation batch
    (2, 1536, 1024, True),   # the v1 width: V 8, no row loaded ahead
    (8, 2304, 1024, True),   # the v1 training step's shape
    (2, 77, 100, True),      # D a multiple of 4, not of 8
    (2, 33, 2048, False),    # the widest fp32 D: V 16, sums in shared memory
])
def test_fp32_gated_adaln_kernels_match_plain(cuda, b, n, d, strided):
    x, y, gate, scale, g_newx, g_out = (t.float() for t in _adaln_bwd_inputs(cuda, b, n, d,
                                                                             strided))
    if strided:  # keep the modulation rows strided, as column slices in fp32
        mod = torch.randn((b, 6 * d), generator=cuda, device="cuda")
        gate, scale, shift = mod[:, 2 * d:3 * d], mod[:, 4 * d:5 * d], mod[:, 3 * d:4 * d]
    else:
        shift = torch.randn((b, d), generator=cuda, device="cuda")
    before32, before16 = _counts32(), _counts16()
    got = ga.gated_adaln(x, y, gate, scale, shift)
    grads = ga.gated_adaln_bwd(x, y, gate, scale, g_newx, g_out)
    torch.cuda.synchronize()
    for u, w in zip(got, ga.gated_adaln_plain(x, y, gate, scale, shift)):
        _close32(u, w)
    for u, w in zip(grads, ga.gated_adaln_bwd_plain(x, y, gate, scale, g_newx, g_out)):
        _close32(u, w)
    assert all(torch.equal(u, w) for u, w in
               zip(grads, ga.gated_adaln_bwd(x, y, gate, scale, g_newx, g_out)))
    assert _counts16() == before16
    assert [a - b_ for a, b_ in zip(_counts32(), before32)][-2:] == [1, 2]


@pytest.mark.parametrize("d", [2052, 102])
def test_fp32_gated_adaln_refuses_widths_it_does_not_take(cuda, d):
    x = torch.zeros((2, 8, d), device="cuda")
    m = torch.zeros((2, d), device="cuda")
    with pytest.raises(ValueError, match="D % 4 == 0 and D <= 2048"):
        ga.gated_adaln(x, x, m, m, m)


def test_head_width_32_takes_the_unfused_route(cuda):
    """dh 32 (the quality proxy's model) runs outside the kernels in either
    dtype, forward and backward, and matches the CPU."""
    from f5e_tts_tpu_torch.ops import attention as fattn
    from f5e_tts_tpu_torch.ops import nn as fnn

    gen = torch.Generator().manual_seed(3)
    p = {"to_qkv": fnn.linear_init(128, 3 * 128, gen), "to_out": fnn.linear_init(128, 128, gen)}
    x = torch.randn((2, 50, 128), generator=gen)
    mask = torch.arange(50)[None, :] < torch.tensor([50, 31])[:, None]
    cos, sin = (torch.from_numpy(t) for t in rotary_cos_sin_half(32, 50))
    want = fattn.attention(p, x, 4, mask, cos, sin, compute_dtype=torch.float32)
    pc = {k: {n: t.cuda() for n, t in v.items()} for k, v in p.items()}
    xc = x.cuda().requires_grad_()
    before16, before32, calls = _counts16(), _counts32(), fattn.unfused_calls
    got = fattn.attention(pc, xc, 4, mask.cuda(), cos.cuda(), sin.cuda(),
                          compute_dtype=torch.float32)
    got.sum().backward()
    torch.cuda.synchronize()
    assert fattn.unfused_calls == calls + 1
    assert _counts16() == before16 and _counts32() == before32
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    assert torch.isfinite(xc.grad).all()


# ---------------------------------------------------------------------------
# the threefry kernel (kernels/threefry.py) against its plain versions
# (ops/prng.py), on the card and on the CPU: bit for bit
# ---------------------------------------------------------------------------

THREEFRY_CASES = [  # (shape, global shape, offset)
    ((1,), None, None),  # one element
    ((3, 5, 7), None, None),  # 105: not a multiple of the vector width
    ((7, 13), (9, 40), (2, 27)),  # a ragged block inside a larger array
    ((3, 2, 3), (2**20, 2**7, 2**9), (2**19 + 5, 100, 400)),  # counters past 2^32
    ((2, 64, 1024), (8, 64, 1024), (4, 0, 0)),  # a rank's rows of a batch
    ((2, 64, 512), (2, 64, 2048), (0, 0, 1024)),  # a rank's columns of an FF hidden
]


def _threefry_key(seed):
    from f5e_tts_tpu_torch.ops import prng

    return prng.fold_in(prng.prng_key(seed), 7)


@pytest.mark.parametrize("shape,glob,off", THREEFRY_CASES, ids=str)
def test_threefry_kernel_matches_its_twins_bitwise(cuda, shape, glob, off):
    from f5e_tts_tpu_torch.kernels import threefry as tf
    from f5e_tts_tpu_torch.ops import prng

    key = _threefry_key(len(shape) + shape[0])
    ckey = key.cuda()
    for lo, hi in ((0.0, 1.0), (1e-10, 1.0), (-0.125, 0.125), (-2.0, 3.0)):
        u = tf.uniform(key, shape, "cuda", lo, hi, glob, off)
        assert torch.equal(u.view(torch.int32), prng.uniform(ckey, shape, lo, hi, glob,
                                                             off).view(torch.int32))
        assert torch.equal(u.cpu().view(torch.int32),
                           prng.uniform(key, shape, lo, hi, glob, off).view(torch.int32))
    assert torch.equal(tf.normal(key, shape, "cuda", glob, off),
                       prng.normal(ckey, shape, glob, off))
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
        for rate in (0.1, 0.5):
            got = tf.dropout(key, x, rate, glob, off)
            assert got.dtype == dtype
            assert torch.equal(got, prng.dropout(ckey, x, rate, glob, off))
            assert torch.equal(got.cpu(), prng.dropout(key, x.cpu(), rate, glob, off))


def test_threefry_dropout_backward_redraws_the_mask(cuda):
    from f5e_tts_tpu_torch.kernels import threefry as tf
    from f5e_tts_tpu_torch.ops import prng

    key = _threefry_key(1)
    x = torch.randn((4, 96, 1024), generator=cuda, device="cuda").bfloat16().requires_grad_(True)
    g = torch.randn((4, 96, 1024), generator=cuda, device="cuda").bfloat16()
    fwd, bwd = tf.dropout_launches, tf.dropout_bwd_launches
    y = tf.ThreefryDropout.apply(x, key, 0.1, None, None)
    y.backward(g)
    assert (tf.dropout_launches, tf.dropout_bwd_launches) == (fwd + 1, bwd + 1)
    assert torch.equal(x.grad, prng.dropout(key.cuda(), g, 0.1))
    assert torch.equal(y, prng.dropout(key.cuda(), x.detach(), 0.1))


def test_threefry_kernel_refuses_what_it_does_not_take(cuda):
    from f5e_tts_tpu_torch.kernels import threefry as tf

    key = _threefry_key(2)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tf.dropout(key, torch.ones(8, device="cuda", dtype=torch.float16), 0.1)
    with pytest.raises(ValueError, match="one key"):
        tf.uniform(key[None], (4,), "cuda")
    with pytest.raises(ValueError, match="three dims"):
        tf.uniform(key, (2, 2, 2, 2), "cuda", 0.0, 1.0, (2, 4, 2, 2), (0, 1, 0, 0))
