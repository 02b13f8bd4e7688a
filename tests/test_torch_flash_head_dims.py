"""The flash kernels at every head width the Pallas kernels take: the port's
``flash_block_fwd`` and ``flash_block_bwd`` (their plain versions, on the
CPU) against the JAX package's Pallas kernels in interpret mode, at head
dims from 8 to 256; the wrappers' padding of a head_dim that is not a
multiple of 8; and a small model at head_dim 96 and 256 through
``attention_impl="flash"`` against the JAX ``loss_fn``.

Inputs come from numpy with a fixed seed, float32 on both sides, which
differ only in summation order: o atol 2e-5, lse 1e-5, dq/dk/dv 1e-5 (the
tolerances of ``test_torch_flash.py`` and ``test_torch_flash_bwd.py``);
the model's loss and grads 1e-5.  About 35 worker-seconds in all, most of it
the Pallas kernels' interpret-mode traces.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.parallel import flash as jflash
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.parallel import flash as tflash
from tests.torch_parity import assert_tree_close, carried, grads_of

HEAD_DIMS = [8, 12, 24, 80, 96, 160, 256]
BH, TQ, TK = 2, 40, 24  # Tq != Tk; with causal, rows past Tk see every key


def _inputs(seed, d, causal):
    """q, do [BH, TQ, d], k, v [BH, TK, d] and the forward's lse and
    delta = rowsum(do ⊙ o), numpy float32."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((BH, TQ, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((BH, TK, d)).astype(np.float32) for _ in range(2))
    o, lse = tflash.flash_block_fwd_reference(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                              sm_scale=d**-0.5)
    delta = (torch.from_numpy(do) * o).sum(-1)
    return q, k, v, do, lse.numpy(), delta.numpy()


def _jax_fwd(q, k, v, causal, scale):
    o, lse = jflash.flash_block_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, sm_scale=scale, interpret=True)
    return np.asarray(o), np.asarray(lse)


def _jax_bwd(q, k, v, do, lse, delta, causal, scale):
    grads = jflash.flash_block_bwd(*map(jnp.asarray, (q, k, v, do, lse, delta)), causal=causal,
                                   sm_scale=scale, interpret=True)
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_block_fwd_and_bwd_match_the_pallas_kernels(d, causal):
    q, k, v, do, lse, delta = _inputs(d, d, causal)
    scale = d**-0.5
    jo, jlse = _jax_fwd(q, k, v, causal, scale)
    to, tlse = tflash.flash_block_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                      sm_scale=scale)
    assert tuple(to.shape) == (BH, TQ, d) and tuple(tlse.shape) == (BH, TQ)
    np.testing.assert_allclose(to.numpy(), jo, atol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=1e-5)
    jgrads = _jax_bwd(q, k, v, do, lse, delta, causal, scale)
    tgrads = tflash.flash_block_bwd(*map(torch.from_numpy, (q, k, v, do, lse, delta)),
                                    causal=causal, sm_scale=scale)
    for name, j, t in zip(("dq", "dk", "dv"), jgrads, tgrads):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, name
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("d", [12, 1, 20])
def test_zero_columns_to_a_multiple_of_8_change_nothing(d):
    """The kernels run a head_dim that is not a multiple of 8 at the next
    one, on inputs padded with zero columns: the plain versions on the
    padded inputs, sliced, give the unpadded result (atol 1e-6) and the
    Pallas kernels' (the tolerances above)."""
    q, k, v, do, lse, delta = _inputs(d + 1, d, True)
    w = tflash._padded_dim(d)
    assert w % 8 == 0 and 0 < w - d < 8
    scale = d**-0.5
    tq, tk, tv, tdo, tlse, tdelta = map(torch.from_numpy, (q, k, v, do, lse, delta))
    padded = [tflash._pad(x, w) for x in (tq, tk, tv, tdo)]
    assert all(x.shape[-1] == w and torch.all(x[..., d:] == 0) for x in padded)
    o, plse = tflash.flash_block_fwd_reference(*padded[:3], causal=True, sm_scale=scale)
    grads = tflash.flash_block_bwd_reference(*padded, tlse, tdelta, causal=True, sm_scale=scale)
    assert torch.all(o[..., d:] == 0) and all(torch.all(g[..., d:] == 0) for g in grads)
    ro, rlse = tflash.flash_block_fwd_reference(tq, tk, tv, causal=True, sm_scale=scale)
    rgrads = tflash.flash_block_bwd_reference(tq, tk, tv, tdo, tlse, tdelta, causal=True,
                                              sm_scale=scale)
    torch.testing.assert_close(o[..., :d], ro, atol=1e-6, rtol=0)
    torch.testing.assert_close(plse, rlse, atol=1e-6, rtol=0)
    for g, r in zip(grads, rgrads):
        torch.testing.assert_close(g[..., :d], r, atol=1e-6, rtol=0)
    jo, jlse = _jax_fwd(q, k, v, True, scale)
    np.testing.assert_allclose(o[..., :d].numpy(), jo, atol=2e-5)
    np.testing.assert_allclose(plse.numpy(), jlse, atol=1e-5)
    for g, j in zip(grads, _jax_bwd(q, k, v, do, lse, delta, True, scale)):
        np.testing.assert_allclose(g[..., :d].numpy(), j, atol=1e-5)


def test_the_wrappers_pad_launch_at_a_multiple_of_8_and_slice(monkeypatch):
    """The CUDA branches of the three wrappers, on CPU tensors with each
    launch replaced by the plain version written into the outputs it is
    given: at head_dim 12 every launch sees q, k, v (and do) padded to 16,
    the outputs come back [.., 12] and contiguous, equal to the plain
    versions', and each wrapper counts the launch and the padding; at head
    dim 16 nothing is padded."""
    widths = []

    def fake_fwd(q, k, v, o, lse, causal, sm_scale):
        widths.append({x.shape[-1] for x in (q, k, v, o)})
        ro, rlse = tflash.flash_block_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale)
        o.copy_(ro)
        lse.copy_(rlse)

    def fake_bwd(fn, name, q, k, v, do, lse, delta, outs, causal, sm_scale):
        widths.append({x.shape[-1] for x in (q, k, v, do, *outs)})
        grads = tflash.flash_block_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                                 sm_scale=sm_scale)
        for out, g in zip(outs, grads[:1] if fn == "dq" else grads[1:]):
            out.copy_(g)

    monkeypatch.setattr(tflash, "_launch_fwd", fake_fwd)
    monkeypatch.setattr(tflash, "_launch_bwd", fake_bwd)
    monkeypatch.setattr(tflash, "_bwd_kernel_fns", lambda: ("dq", "dkv"))
    for d, padded in ((12, True), (16, False)):
        q, k, v, do, lse, delta = map(torch.from_numpy, _inputs(d + 2, d, False))
        kw = dict(causal=False, sm_scale=d**-0.5)
        before = (tflash.launch_counts(), tflash.padded_counts())
        widths.clear()
        o, got_lse = tflash._kernel_fwd(q, k, v, kw["causal"], kw["sm_scale"])
        dq = tflash._kernel_dq(q, k, v, do, lse, delta, kw["causal"], kw["sm_scale"])
        dk, dv = tflash._kernel_dkv(q, k, v, do, lse, delta, kw["causal"], kw["sm_scale"])
        assert widths == [{16}] * 3
        added = {name: n - before[0][name] for name, n in tflash.launch_counts().items()}
        added_padded = {name: n - before[1][name] for name, n in tflash.padded_counts().items()}
        assert added == dict.fromkeys(added, 1)
        assert added_padded == dict.fromkeys(added_padded, int(padded))
        ro, rlse = tflash.flash_block_fwd_reference(q, k, v, **kw)
        rgrads = tflash.flash_block_bwd_reference(q, k, v, do, lse, delta, **kw)
        for got, want in zip((o, got_lse, dq, dk, dv), (ro, rlse, *rgrads)):
            assert got.is_contiguous() and got.shape == want.shape
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2, d_ff=128, max_seq=32,
             attention_impl="flash")


@pytest.mark.parametrize("heads", [dict(head_dim=96), dict(head_dim=256, n_kv_heads=1)],
                         ids=["hd96", "hd256-kv1"])
def test_small_model_loss_and_grads_through_flash_match_jax(heads):
    """The slice as a whole: the JAX ``loss_fn`` through its Pallas kernels
    (interpret mode) and the port's through its flash op (the kernels' plain
    versions on the CPU), on the JAX weights carried over: loss and every
    grad within 1e-5."""
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **MODEL, **heads)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **MODEL, **heads)
    jp = jtr.init_params(jax.random.PRNGKey(3), jcfg)
    toks = np.random.default_rng(4).integers(0, 256, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tp = carried(jp)
    before = tflash.launch_counts()
    tloss = ttr.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                        device="cpu")
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=1e-5)
    assert_tree_close(grads_of(tloss, tp), jgrads, atol=1e-5)
    assert tflash.launch_counts() == before  # the CPU never launches
