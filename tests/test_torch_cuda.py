"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip without one.  This file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: o atol 2e-2 (p is rounded to bf16 against the kernel's running
max, not the final one), lse atol 1e-3; float32 inputs 1e-5.
"""

import pytest
import torch

from polyaxon_tpu_torch.parallel import flash

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "BH, Tq, Tk, d, dtype, causal",
    [
        (128, 512, 512, 64, torch.bfloat16, True),  # 671M prefill: B=4 x H=32, T=512
        (8, 1000, 1000, 64, torch.bfloat16, True),  # ragged tail
        (8, 300, 200, 64, torch.bfloat16, False),
        (16, 512, 512, 128, torch.bfloat16, True),
        (4, 100, 100, 64, torch.float32, True),
        (4, 70, 0, 128, torch.float32, False),  # empty key block
    ],
)
def test_flash_fwd_kernel_matches_plain(cuda, BH, Tq, Tk, d, dtype, causal):
    g = torch.Generator(device=cuda).manual_seed(Tq)
    q, k, v = (torch.randn(BH, t, d, generator=g, device=cuda).to(dtype) for t in (Tq, Tk, Tk))
    before = flash.flash_block_fwd.launches
    o, lse = flash.flash_block_fwd(q, k, v, causal=causal, sm_scale=d**-0.5)
    torch.cuda.synchronize()
    assert flash.flash_block_fwd.launches == before + 1
    ro, rlse = flash.flash_block_fwd_reference(q, k, v, causal=causal, sm_scale=d**-0.5)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(o, ro, atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)


def test_flash_fwd_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_block_fwd(q, q, q, causal=True, sm_scale=1.0)
    q = torch.zeros(2, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash.flash_attention(q.view(2, 8, 1, 64), q.view(2, 8, 1, 64), q.view(2, 8, 1, 64), 1.0)
