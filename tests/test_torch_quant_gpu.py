"""`ops/quant.py: int8_linear` on the card (torch._int_mm, cuBLASLt s8 x s8 ->
s32) against the same function on the CPU. Skips without a CUDA device; on
the card: `python -m pytest --noconftest -m gpu tests/test_torch_quant_gpu.py`.

The int32 products are exact on both, and the per-token scales and the fp32
rescale are the same elementwise operations, so the outputs agree to fp32
rounding (atol 1e-6): at the sampler's row count, under the card's 17-row
minimum (padded with zero rows) and at a single row. Widths that are not
multiples of 8 are refused on the card.
"""

from __future__ import annotations

import pytest
import torch

from f5e_tts_tpu_torch.ops import quant as fq

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cpu").manual_seed(0)


@pytest.mark.parametrize("rows,d_in,d_out", [(3072, 1024, 3072), (3072, 2048, 1024), (16, 1024, 2048),
                                             (1, 64, 48), (17, 768, 2304)])
def test_int8_linear_on_the_card_matches_the_cpu(cuda, rows, d_in, d_out):
    p = {"w": 0.05 * torch.randn((d_in, d_out), generator=cuda),
         "b": torch.randn(d_out, generator=cuda)}
    x = torch.randn((rows, d_in), generator=cuda)
    q = fq.quantize_linear_params(p)
    q_gpu = fq.quantize_linear_params({k: v.cuda() for k, v in p.items()})
    assert all(torch.equal(q[k], q_gpu[k].cpu()) for k in q)
    assert q_gpu["w_q"].stride() == (1, d_in)
    want = fq.int8_linear(q, x)
    got = fq.int8_linear(q_gpu, x.cuda())
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    bf = fq.int8_linear(q_gpu, x.cuda().bfloat16(), torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.isfinite(bf).all()


def test_int8_linear_refuses_widths_the_card_does_not_take(cuda):
    q = fq.quantize_linear_params({"w": torch.randn((20, 16), device="cuda")})
    with pytest.raises(ValueError, match="multiples of 8"):
        fq.int8_linear(q, torch.randn((32, 20), device="cuda"))
