"""Parity of the port's KV-cache decoding with the JAX package's.

Same small float32 config as the forward parity tests (MHA and GQA), JAX
weights carried over through numpy, prompts from numpy.  Logits: atol 1e-4
(float32, different summation order).  Greedy tokens: identical.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import decode as jdec
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu_torch.models import decode as tdec
from polyaxon_tpu_torch.models.weights import params_from_jax
from tests.test_torch_transformer import configs, jax_params, tokens


def _qweights(jp, tp, quantize):
    if not quantize:
        return None, None
    return jdec.quantize_weights(jp), tdec.quantize_weights(tp)


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_prefill_and_decode_step_match_jax(variant):
    jcfg, tcfg = configs(variant, "flash")
    jp, tp = jax_params(jcfg, seed=1)
    prompt = tokens(2, B=2, T=10)
    jcache = jdec.init_cache(jcfg, 2, 16)
    tcache = tdec.init_cache(tcfg, 2, 16, "cpu")
    jl, jcache = jdec.prefill(jp, jnp.asarray(prompt), jcache, jcfg)
    tl, tcache = tdec.prefill(tp, torch.from_numpy(prompt).long(), tcache, tcfg, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), atol=1e-4)
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    for pos in (10, 11):
        jl, jcache = jdec.decode_step(jp, jcache, jnp.asarray(tok), pos, jcfg)
        tl, tcache = tdec.decode_step(tp, tcache, torch.tensor(tok).long(), pos, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-4)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_greedy_generate_is_token_identical_to_jax(variant, quantize):
    jcfg, tcfg = configs(variant, "flash")
    jp, tp = jax_params(jcfg, seed=4)
    jq, tq = _qweights(jp, tp, quantize)
    prompt = tokens(6, B=2, T=12)
    jout = jdec.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=16, qweights=jq)
    tout = tdec.generate(tp, torch.from_numpy(prompt).long(), tcfg, max_new_tokens=16,
                         qweights=tq, device="cpu")
    assert tuple(tout.shape) == (2, 16)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_quantized_weights_equal_jax():
    jcfg, tcfg = configs("gqa", "dense")
    jp, tp = jax_params(jcfg, seed=5)
    jq, tq = _qweights(jp, tp, True)
    assert set(tq) == set(jq)
    for name in jq:
        assert tq[name][0].dtype == torch.int8
        np.testing.assert_array_equal(tq[name][0].numpy(), np.asarray(jq[name][0]))
        np.testing.assert_allclose(tq[name][1].numpy(), np.asarray(jq[name][1]), rtol=1e-6)


def test_sampled_generate_is_deterministic_per_generator():
    _, tcfg = configs("mha", "dense")
    jcfg, _ = configs("mha", "dense")
    _, tp = jax_params(jcfg, seed=7)
    prompt = torch.from_numpy(tokens(8, B=3, T=6)).long()

    def run(seed):
        return tdec.generate(tp, prompt, tcfg, max_new_tokens=12, temperature=1.0,
                             generator=torch.Generator().manual_seed(seed), device="cpu")

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


def test_generate_over_max_seq_raises():
    jcfg, tcfg = configs("mha", "dense")
    _, tp = jax_params(jcfg)
    prompt = torch.zeros((1, 60), dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tdec.generate(tp, prompt, tcfg, max_new_tokens=5, device="cpu")


def test_bf16_generate_runs_from_bf16_weights():
    """The compute dtype the card uses (bf16), on bf16 weights that cross
    from JAX through the int16 view; finite logits, tokens in range."""
    jcfg, _ = configs("gqa", "dense")
    tcfg = configs("gqa", "dense")[1].scaled(dtype=torch.bfloat16)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    out = tdec.generate(tp, torch.from_numpy(tokens(1, B=1, T=5)).long(), tcfg,
                        max_new_tokens=4, device="cpu")
    assert tuple(out.shape) == (1, 4) and int(out.max()) < tcfg.vocab_size
