"""Parity of the port's flash attention backward (``flash_block_bwd`` and the
grads of ``flash_attention``) with the JAX package's Pallas kernels, run in
interpret mode on the CPU.

Inputs come from numpy with a fixed seed and go through both packages; lse
and delta come from a dense float32 forward and are handed to both.  Tolerances:

- float32 inputs, atol 1e-5 on dq/dk/dv: both sides compute the same
  float32 arithmetic and differ only in summation order;
- bf16 inputs, atol 1e-3: both round ds and p to bf16 before the products,
  but an ulp of difference in float32 can land one ds on the other side of
  a bf16 rounding boundary (2**-8 relative on a term of order 0.1);
- ``flash_attention`` grads against ``jax.grad``: float32 atol 1e-4; bf16
  atol 3e-2 (two bf16 ulps at the grads' magnitude of 2 to 4), since the
  grads themselves come back rounded to bf16 and the forward rounds p
  against its running max in the TPU kernel but the final one in the
  plain version, which moves o, and with it delta, by bf16 roundings.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.parallel import flash as jflash
from polyaxon_tpu_torch.parallel import flash as tflash


def _inputs(seed, BH, Tq, d, Tk=None, causal=True, dtype=jnp.float32):
    """q, k, v, do and the forward's lse and delta = rowsum(do ⊙ o), numpy."""
    rng = np.random.default_rng(seed)
    Tk = Tq if Tk is None else Tk
    q, do = (rng.standard_normal((BH, Tq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((BH, Tk, d)).astype(np.float32) for _ in range(2))
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    f32 = [x.astype(jnp.float32) for x in (jq, jk, jv, jdo)]
    s = jnp.einsum("bqd,bkd->bqk", f32[0], f32[1]) * d**-0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((Tq, Tk), bool)), s, -1e30)
    lse = jax.nn.logsumexp(s, axis=-1)
    o = jnp.einsum("bqk,bkd->bqd", jnp.exp(s - lse[..., None]), f32[2])
    delta = jnp.sum(f32[3] * o.astype(dtype).astype(jnp.float32), axis=-1)
    return (jq, jk, jv, jdo), np.asarray(lse), np.asarray(delta)


def _torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _both(seed, BH, Tq, d, *, Tk=None, causal=True, dtype=jnp.float32, block=1024):
    (jq, jk, jv, jdo), lse, delta = _inputs(seed, BH, Tq, d, Tk, causal, dtype)
    scale = d**-0.5
    jgrads = jflash.flash_block_bwd(
        jq, jk, jv, jdo, jnp.asarray(lse), jnp.asarray(delta), causal=causal, sm_scale=scale,
        block_q=block, block_k=block, interpret=True,
    )
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tgrads = tflash.flash_block_bwd_reference(
        *(_torch(x, tdtype) for x in (jq, jk, jv, jdo)),
        torch.from_numpy(lse.copy()), torch.from_numpy(delta.copy()), causal=causal,
        sm_scale=scale,
    )
    return [np.asarray(g) for g in jgrads], tgrads


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [64, 48], ids=["T64", "ragged-T48"])
def test_reference_matches_jax_kernels(causal, T):
    jgrads, tgrads = _both(T + causal, 3, T, 16, causal=causal)
    for name, j, t in zip(("dq", "dk", "dv"), jgrads, tgrads):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, name
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_multi_block_jax_kernels_match_one_pass_reference(causal):
    """The TPU kernels' accumulation over several blocks (16 of T=64, the
    dq pass over k blocks, the dk/dv pass over q blocks) agrees with the
    port's one-pass plain version."""
    jgrads, tgrads = _both(7, 2, 64, 16, causal=causal, block=16)
    for name, j, t in zip(("dq", "dk", "dv"), jgrads, tgrads):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5, err_msg=name)


def test_non_causal_with_more_queries_than_keys():
    """The ring's full blocks: non-causal, Tq != Tk."""
    jgrads, tgrads = _both(5, 2, 40, 16, Tk=24, causal=False)
    assert tuple(tgrads[0].shape) == (2, 40, 16) and tuple(tgrads[1].shape) == (2, 24, 16)
    for name, j, t in zip(("dq", "dk", "dv"), jgrads, tgrads):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_inputs_round_ds_and_p_like_the_kernels(causal):
    jgrads, tgrads = _both(11, 2, 48, 16, causal=causal, dtype=jnp.bfloat16)
    for name, j, t in zip(("dq", "dk", "dv"), jgrads, tgrads):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-3, err_msg=name)


def test_rows_with_lse_minus_inf_contribute_nothing():
    """A row that saw no key (lse = -inf) gives dq = 0 and adds nothing to
    dk/dv, where exp(s - lse) would overflow to inf and then NaN."""
    (jq, jk, jv, jdo), lse, delta = _inputs(3, 2, 16, 16, causal=False)
    q, k, v, do = (_torch(x, torch.float32) for x in (jq, jk, jv, jdo))
    lse, delta = torch.from_numpy(lse.copy()), torch.from_numpy(delta.copy())
    dead = torch.zeros((2, 16), dtype=torch.bool)
    dead[0, 3] = dead[1, 10:] = True
    lse[dead] = float("-inf")
    dq, dk, dv = tflash.flash_block_bwd(q, k, v, do, lse, delta, causal=False, sm_scale=0.25)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert torch.all(dq[dead] == 0)
    live = ~dead
    for b in range(2):  # the same grads as with the dead rows removed
        sel = live[b]
        rq, rk, rv = tflash.flash_block_bwd_reference(
            q[b:b + 1, sel], k[b:b + 1], v[b:b + 1], do[b:b + 1, sel], lse[b:b + 1, sel],
            delta[b:b + 1, sel], causal=False, sm_scale=0.25,
        )
        torch.testing.assert_close(dq[b:b + 1, sel], rq, atol=1e-6, rtol=0)
        torch.testing.assert_close(dk[b:b + 1], rk, atol=1e-6, rtol=0)
        torch.testing.assert_close(dv[b:b + 1], rv, atol=1e-6, rtol=0)


def test_empty_blocks():
    q = torch.randn(2, 5, 16)
    empty = torch.zeros(2, 0, 16)
    dq, dk, dv = tflash.flash_block_bwd(q, empty, empty, q, torch.full((2, 5), float("-inf")),
                                        torch.zeros(2, 5), causal=False, sm_scale=0.25)
    assert torch.all(dq == 0) and tuple(dk.shape) == (2, 0, 16)
    dq, dk, dv = tflash.flash_block_bwd(empty, q, q, empty, torch.zeros(2, 0), torch.zeros(2, 0),
                                        causal=True, sm_scale=0.25)
    assert tuple(dq.shape) == (2, 0, 16) and torch.all(dk == 0) and torch.all(dv == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grads_match_jax_grad(dtype):
    """Grads of the port's flash_attention on the CPU (its plain versions)
    against jax.grad of the JAX flash_attention's custom VJP (two blocks of
    20 in T=40), on the same inputs in the same dtype."""
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.standard_normal((2, 40, 3, 16)).astype(np.float32) for _ in range(4))
    scale = 16**-0.5
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def jloss(q, k, v):
        out = jflash.flash_attention((scale, 20, 20, True), q, k, v)
        return jnp.sum(out.astype(jnp.float32) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdtype) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    before = (tflash.flash_block_fwd.launches, tflash.flash_block_dq.launches,
              tflash.flash_block_dkv.launches)
    out = tflash.flash_attention(tq, tk, tv, scale, device="cpu")
    tgrads = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert (tflash.flash_block_fwd.launches, tflash.flash_block_dq.launches,
            tflash.flash_block_dkv.launches) == before  # the CPU never launches
    atol = 1e-4 if dtype == torch.float32 else 3e-2
    for name, j, t in zip(("dq", "dk", "dv"), jgrads, tgrads):
        assert t.dtype == dtype and tuple(t.shape) == (2, 40, 3, 16), name
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize(
    "change, err",
    [
        (dict(do=torch.zeros(2, 9, 64)), ValueError),  # do shaped unlike q
        (dict(do=torch.zeros(2, 8, 64, dtype=torch.bfloat16)), ValueError),
        (dict(lse=torch.zeros(2, 8, dtype=torch.float64)), ValueError),
        (dict(delta=torch.zeros(2, 9)), ValueError),
        (dict(do=torch.zeros(2, 64, 8).transpose(1, 2)), ValueError),  # strided
        (dict(q=torch.zeros(2, 8, 32), do=torch.zeros(2, 8, 32)), ValueError),  # head_dim 32
    ],
)
def test_bwd_kernel_input_checks(change, err):
    """What the CUDA branch refuses before it launches: the forward's
    checks on q, k, v, and do / lse / delta shaped and typed for them."""
    args = dict(q=torch.zeros(2, 8, 64), k=torch.zeros(2, 8, 64), v=torch.zeros(2, 8, 64),
                do=torch.zeros(2, 8, 64), lse=torch.zeros(2, 8), delta=torch.zeros(2, 8))
    tflash.check_bwd_inputs(**args)
    with pytest.raises(err):
        tflash.check_bwd_inputs(**dict(args, **change))
