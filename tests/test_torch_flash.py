"""Parity of the port's flash attention (polyaxon_tpu_torch.parallel.flash)
with the JAX package's Pallas kernel, run in interpret mode on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances: o atol 2e-5 and lse atol 1e-5 in float32 — both sides compute
the same softmax in float32 and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.parallel import flash as jflash
from polyaxon_tpu_torch.parallel import flash as tflash


def _qkv(seed, BH, T, d, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = T if Tk is None else Tk
    return (
        rng.standard_normal((BH, T, d)).astype(np.float32),
        rng.standard_normal((BH, Tk, d)).astype(np.float32),
        rng.standard_normal((BH, Tk, d)).astype(np.float32),
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [64, 48])
def test_reference_matches_jax_kernel(causal, T):
    q, k, v = _qkv(T + causal, 3, T, 16)
    scale = 16**-0.5
    jo, jl = jflash.flash_block_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, sm_scale=scale, interpret=True,
    )
    to, tl = tflash.flash_block_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=scale,
    )
    assert to.dtype == torch.float32 and tuple(tl.shape) == (3, T)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


def test_multi_block_jax_kernel_matches_one_pass_reference():
    """The TPU kernel's online softmax over several k-blocks (block 16 of
    T=64) agrees with the port's one-pass plain version."""
    q, k, v = _qkv(7, 2, 64, 16)
    jo, jl = jflash.flash_block_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sm_scale=0.25, block_q=16, block_k=16, interpret=True,
    )
    to, tl = tflash.flash_block_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, sm_scale=0.25,
    )
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows(causal):
    """Rows that see no key get lse = -inf and o = 0 (the merge identity the
    ring starts from).  Every row of the JAX wrapper sees key 0, so this
    contract is checked on the port alone, with an empty key block."""
    q, k, v = _qkv(3, 2, 8, 16, Tk=0)
    o, lse = tflash.flash_block_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=0.25,
    )
    assert tuple(o.shape) == (2, 8, 16) and tuple(lse.shape) == (2, 8)
    assert torch.all(o == 0)
    assert torch.all(torch.isneginf(lse))


def test_bf16_inputs_round_p_like_the_kernel():
    """bf16 q/k/v: the plain version rounds p to bf16 before P·V as the TPU
    kernel does; against the JAX kernel on the same bf16 inputs the outputs
    agree to bf16 rounding of p (atol 2e-2, lse 1e-3)."""
    q, k, v = _qkv(11, 2, 32, 16)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, jl = jflash.flash_block_fwd(jq, jk, jv, causal=True, sm_scale=0.25, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    to, tl = tflash.flash_block_fwd_reference(tq, tk, tv, causal=True, sm_scale=0.25)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3)


def test_flash_attention_matches_jax_and_never_launches_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 48, 3, 16)).astype(np.float32) for _ in range(3))
    scale = 16**-0.5
    jout = jflash.flash_attention(
        (scale, 1024, 1024, True), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    before = tflash.flash_block_fwd.launches
    tout = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale, device="cpu"
    )
    assert tflash.flash_block_fwd.launches == before
    assert tout.shape == (2, 48, 3, 16) and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5)


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-absent path; a card is present")
    q = torch.zeros((1, 4, 1, 64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflash.flash_attention(q, q, q, 0.125)


def test_entry_point_rejects_tensors_on_another_device():
    q = torch.zeros((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError, match="expected cpu"):
        tflash.flash_attention(q, q, q, 0.125, device="cpu")


@pytest.mark.parametrize(
    "make, err",
    [
        (lambda: [torch.zeros(2, 8, 16)] * 3, ValueError),  # head_dim 16
        (lambda: [torch.zeros(2, 8, 64, dtype=torch.float16)] * 3, TypeError),
        (lambda: [torch.zeros(2, 64, 8).transpose(1, 2)] * 3, ValueError),  # strided
        (lambda: [torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), torch.zeros(2, 9, 64)], ValueError),
        (lambda: [torch.zeros(2, 8, 64), torch.zeros(2, 8, 64, dtype=torch.bfloat16),
                  torch.zeros(2, 8, 64)], TypeError),
        (lambda: [torch.zeros(2 * 8 * 64 + 1)[1:].view(2, 8, 64)] * 3, ValueError),  # unaligned
    ],
)
def test_kernel_input_checks(make, err):
    """What the CUDA branch refuses before it launches."""
    q, k, v = make()
    with pytest.raises(err):
        tflash.check_kernel_inputs(q, k, v)
    tflash.check_kernel_inputs(*(torch.zeros(2, 8, 64) for _ in range(3)))
