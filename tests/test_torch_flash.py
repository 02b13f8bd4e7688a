"""Parity of the port's flash attention (polyaxon_tpu_torch.parallel.flash)
with the JAX package's Pallas kernel, run in interpret mode on the CPU; and
what ``attention_impl="auto"`` picks (the kernels only where they take the
head_dim, 1 to 256, and dtype), with the JAX outputs at head_dim 8 that the
card's test of that choice compares with.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances: o atol 2e-5 and lse atol 1e-5 in float32 — both sides compute
the same softmax in float32 and differ only in summation order.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import decode as jdec
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.parallel import flash as jflash
from polyaxon_tpu_torch.models import decode as tdec
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel import flash as tflash
from tests import torch_head_dim8 as hd8


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
        (lambda: [torch.zeros(2, 8, 257)] * 3, ValueError),  # head_dim 257
        (lambda: [torch.zeros(2, 8, 64, dtype=torch.float16)] * 3, TypeError),
        (lambda: [torch.zeros(2, 64, 8).transpose(1, 2)] * 3, ValueError),  # strided
        (lambda: [torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), torch.zeros(2, 9, 64)], ValueError),
        (lambda: [torch.zeros(2, 8, 64), torch.zeros(2, 8, 64, dtype=torch.bfloat16),
                  torch.zeros(2, 8, 64)], TypeError),
        (lambda: [torch.zeros(2 * 8 * 64 + 1)[1:].view(2, 8, 64)] * 3, ValueError),  # unaligned
        (lambda: [torch.zeros(2, 8, 512)] * 3, ValueError),  # head_dim 512
        (lambda: [torch.zeros(2, 8, 0)] * 3, ValueError),  # head_dim 0
    ],
)
def test_kernel_input_checks(make, err):
    """What the CUDA branch refuses before it launches."""
    q, k, v = make()
    with pytest.raises(err):
        tflash.check_kernel_inputs(q, k, v)
    tflash.check_kernel_inputs(*(torch.zeros(2, 8, 64) for _ in range(3)))


@pytest.mark.parametrize("B", [1, 2])
def test_head_major_copies_are_contiguous(B):
    """What the attention op and the ring hand the kernels is contiguous,
    a batch of one included (a reshape alone returns a strided view there,
    which the kernels refuse)."""
    x = torch.arange(B * 5 * 3 * 8, dtype=torch.float32).reshape(B, 5, 3, 8)
    y = tflash._bhd(x)
    assert y.is_contiguous() and torch.equal(y, x.permute(0, 2, 1, 3).reshape(B * 3, 5, 8))
    assert torch.equal(tflash._unbhd(y, B, 3), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 96, 128, 256, 1, 12, 80, 257, 512])
def test_kernel_takes_what_check_kernel_inputs_takes(d, dtype):
    """``attention_impl="auto"``'s predicate says yes exactly where the
    kernels' input check accepts well-formed tensors of that head_dim and
    dtype: float32 and bf16 at every head_dim from 1 to 256."""
    q = torch.zeros(2, 8, d, dtype=dtype)
    try:
        tflash.check_kernel_inputs(q, q.clone(), q.clone())
        accepted = True
    except (TypeError, ValueError):
        accepted = False
    assert tflash.kernel_takes(q.shape, dtype) is accepted
    assert accepted is (dtype in (torch.float32, torch.bfloat16) and d <= 256)


@pytest.mark.parametrize("impl, d, dtype, want", [
    ("auto", 64, torch.bfloat16, True), ("auto", 128, torch.float32, True),
    ("auto", 8, torch.float32, True), ("auto", 32, torch.bfloat16, True),
    ("auto", 64, torch.float16, False), ("flash", 8, torch.float32, True),
    ("dense", 64, torch.bfloat16, False), ("auto", 96, torch.bfloat16, True),
    ("auto", 256, torch.bfloat16, True), ("auto", 257, torch.bfloat16, False),
    ("auto", 512, torch.float32, False), ("dense", 256, torch.bfloat16, False),
])
def test_auto_takes_the_kernels_only_where_they_take_the_shape(impl, d, dtype, want):
    """On a CUDA tensor ``"auto"`` picks the kernels from head_dim and dtype
    alone, before any launch; ``"flash"`` keeps them (and raises there if
    they refuse).  The tensor only stands in for a card's."""
    from types import SimpleNamespace

    cfg = ttr_config(head_dim=d, attention_impl=impl)
    x = SimpleNamespace(shape=(2, 16, cfg.d_model), dtype=dtype, device=torch.device("cuda"))
    assert ttr._use_flash(cfg, x) is want
    cpu = SimpleNamespace(shape=x.shape, dtype=dtype, device=torch.device("cpu"))
    assert ttr._use_flash(cfg, cpu) is (impl == "flash")


def ttr_config(**kw):
    return ttr.TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=4, d_ff=64, **kw)


def jax_head_dim8_outputs():
    """The JAX package's logits and greedy tokens for the head_dim-8 model
    of ``tests/torch_head_dim8.py`` (float32, its auto attention)."""
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **hd8.CFG)
    params = jax.tree.map(jnp.asarray, hd8.numpy_params())
    prompt = jnp.asarray(hd8.prompt())
    logits = jtr.forward(params, prompt, jcfg)
    tokens = jdec.generate(params, prompt, jcfg, max_new_tokens=hd8.NEW_TOKENS)
    return np.asarray(logits), np.asarray(tokens)


def test_head_dim8_fixture_holds_the_jax_outputs():
    """The stored JAX outputs the card's fault-1 test compares with are what
    the JAX package gives, and the port on the CPU gives them too."""
    logits, tokens = jax_head_dim8_outputs()
    stored = np.load(hd8.JAX_OUTPUTS)
    np.testing.assert_allclose(stored["logits"], logits, atol=1e-6)
    np.testing.assert_array_equal(stored["tokens"], tokens)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **hd8.CFG)
    params = params_from_jax(hd8.numpy_params(), "cpu")
    prompt = torch.from_numpy(hd8.prompt())
    with torch.inference_mode():
        np.testing.assert_allclose(ttr.forward(params, prompt, tcfg, device="cpu").numpy(),
                                   logits, atol=1e-4)
    out = tdec.generate(params, prompt, tcfg, max_new_tokens=hd8.NEW_TOKENS, device="cpu")
    np.testing.assert_array_equal(out.numpy(), tokens)
