"""The port's step family and warmup against the JAX package's.

Counterparts of ``tests/test_serving/test_warmup.py`` for the port's engine
on the CPU, where each member of the family is the eager step bound to its
key (on the card each is a CUDA graph; ``tests/test_torch_cuda.py``):
``start()`` builds and runs the decode step, every prefill chunk bucket,
every verify width and the COW copy before the ready gate opens; after it,
traffic builds nothing (``_compiled_count()`` unchanged,
``steady_state_compiles`` 0); with ``warmup=False`` the lazily built
entries land on that counter.  The warmup total equals the JAX engine's for
the same configuration.  Then the steps the family is made of, with their
bounds as device tensors: ``paged_prefill_chunk`` at every bucket against
the JAX chunk's logits and pool, ``decode_step`` and ``generate`` against
the JAX ones, and ``cast_weights`` leaving every logit bit for bit as it
was.  Small float32 model of the reference tests (vocab 64, d_model 32, 2
layers, 4 heads x 8, d_ff 64, max_seq 48); logits atol 1e-4.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import decode as jdec
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.serving import ServingEngine as JaxEngine
from polyaxon_tpu_torch.models import decode as tdec
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.serving import ServingEngine

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=48)
CFG = ttr.TransformerConfig(dtype=torch.float32, **SMALL)
JCFG = jtr.TransformerConfig(dtype=jnp.float32, **SMALL)


@pytest.fixture(scope="module")
def params():
    jp = jtr.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def warm_engine(params):
    eng = ServingEngine(params[1], CFG, slots=2, max_len=48, warmup=True, device="cpu").start()
    assert eng.wait_ready(timeout=120), "warmup never finished"
    yield eng
    eng.stop()


def _jax_generate(jp, prompt, n):
    return np.asarray(jdec.generate(jp, jnp.asarray([prompt]), JCFG, max_new_tokens=n))[0].tolist()


def test_env_knob_resolves_default(params, monkeypatch):
    tp = params[1]
    monkeypatch.setenv("POLYAXON_TPU_SERVING_WARMUP", "0")
    assert ServingEngine(tp, CFG, slots=2, max_len=48, device="cpu")._warmup is False
    monkeypatch.setenv("POLYAXON_TPU_SERVING_WARMUP", "1")
    assert ServingEngine(tp, CFG, slots=2, max_len=48, device="cpu")._warmup is True
    monkeypatch.setenv("POLYAXON_TPU_SERVING_WARMUP", "0")
    assert ServingEngine(tp, CFG, slots=2, max_len=48, warmup=True, device="cpu")._warmup is True


def test_warming_until_warmup_completes(params):
    eng = ServingEngine(params[1], CFG, slots=2, max_len=48, warmup=True, device="cpu")
    assert eng.stats()["state"] == "warming"
    assert eng.wait_ready(timeout=0.05) is False
    eng.start()
    try:
        assert eng.wait_ready(timeout=120)
        st = eng.stats()
        assert st["state"] == "ready"
        assert st["warmup"]["total"] > 0
        assert st["warmup"]["done"] == st["warmup"]["total"]
        assert st["warmup"]["ready_s"] > 0
        # the warmup wrote only the trash block
        assert st["blocks_free"] == st["blocks_total"] and st["steady_state_compiles"] == 0
    finally:
        eng.stop()


def test_first_request_after_ready_compiles_nothing(params, warm_engine):
    baseline = warm_engine._compiled_count()
    # the decode step and the chunk buckets 8, 16, 32 and 48
    assert baseline == 5
    rng = np.random.default_rng(7)
    prompt = [int(t) for t in rng.integers(0, CFG.vocab_size, 9)]
    out = warm_engine.submit(prompt, 6).wait(timeout=120)
    assert out == _jax_generate(params[0], prompt, 6)
    assert warm_engine._compiled_count() == baseline
    assert warm_engine.stats()["steady_state_compiles"] == 0


def test_mixed_lengths_after_ready_compile_nothing(params, warm_engine):
    baseline = warm_engine._compiled_count()
    rng = np.random.default_rng(8)
    traffic = [([int(t) for t in rng.integers(0, CFG.vocab_size, t)], n)
               for t, n in [(3, 4), (17, 2), (30, 3)]]
    reqs = [warm_engine.submit(p, n) for p, n in traffic]
    outs = [r.wait(timeout=120) for r in reqs]
    assert outs == [_jax_generate(params[0], p, n) for p, n in traffic]
    assert warm_engine._compiled_count() == baseline
    assert warm_engine.stats()["steady_state_compiles"] == 0


def test_quantized_pool_warmup_compiles_nothing_after_ready(params):
    eng = ServingEngine(params[1], CFG, slots=2, max_len=48, kv_quantize="int8", warmup=True,
                        device="cpu").start()
    try:
        assert eng.wait_ready(timeout=120), "warmup never finished"
        baseline = eng._compiled_count()
        assert baseline > 0
        rng = np.random.default_rng(9)
        reqs = [eng.submit([int(t) for t in rng.integers(0, CFG.vocab_size, t)], n)
                for t, n in [(3, 4), (9, 6), (17, 2), (30, 3)]]
        for r in reqs:
            out = r.wait(timeout=120)
            assert out and all(0 <= t < CFG.vocab_size for t in out)
        assert eng._compiled_count() == baseline
        assert eng.stats()["steady_state_compiles"] == 0
    finally:
        eng.stop()


def test_no_warmup_counts_lazy_compiles(params):
    eng = ServingEngine(params[1], CFG, slots=2, max_len=48, warmup=False, device="cpu").start()
    try:
        assert eng.wait_ready(timeout=30)
        st = eng.stats()
        assert st["state"] == "ready" and st["warmup"]["total"] == 0
        assert eng._compiled_count() == 0
        eng.submit([1, 2, 3], 4).wait(timeout=120)
        # the 8-row chunk and the decode step, each built on first use
        assert eng.stats()["steady_state_compiles"] == eng._compiled_count() == 2
        assert eng.stats_registry.snapshot()["counters"]["serving.steady_state_compiles"] == 2
    finally:
        eng.stop()


WARMUP_CONFIGS = {
    "whole_prompts": dict(slots=2, max_len=48),
    "chunk16": dict(slots=2, max_len=48, prefill_chunk=16),
    "chunk5_len40": dict(slots=3, max_len=40, prefill_chunk=5),
    "spec_k4": dict(slots=2, max_len=48, prefill_chunk=16, spec_decode=True, spec_k=4),
    "spec_k6_int8": dict(slots=2, max_len=48, spec_decode=True, spec_k=6, kv_quantize="int8"),
    "spec_k1": dict(slots=2, max_len=32, prefill_chunk=8, spec_decode=True, spec_k=1),
}


@pytest.mark.parametrize("name", sorted(WARMUP_CONFIGS))
def test_warmup_family_equals_the_jax_engine(params, name):
    jp, tp = params
    kw = WARMUP_CONFIGS[name]
    cfg, jcfg = CFG.scaled(max_seq=kw["max_len"]), JCFG.scaled(max_seq=kw["max_len"])
    je = JaxEngine(jp, jcfg, warmup=True, **kw)
    te = ServingEngine(tp, cfg, warmup=True, device="cpu", **kw)
    assert te._warmup_buckets() == je._warmup_buckets()
    assert te._spec_widths() == je._spec_widths()
    for t in (1, 5, 8, 9, 17, 33, kw["max_len"]):
        assert te._bucket(t, te.max_len) == je._bucket(t, je.max_len)
    for draft in range(1, te.spec_k + 1):
        assert te._width_for(draft) == je._width_for(draft)
    totals = []
    for eng in (je, te):
        eng.start()
        try:
            assert eng.wait_ready(timeout=300)
            st = eng.stats()
            assert st["warmup"]["done"] == st["warmup"]["total"]
            totals.append(st["warmup"]["total"])
        finally:
            eng.stop()
    assert totals[0] == totals[1] == len(je._warmup_buckets()) + len(je._spec_widths()) + 2
    # every entry but the COW copy, which stays one eager op
    assert te._compiled_count() == totals[1] - 1


@pytest.mark.parametrize("c_pad", [8, 16, 32, 48])
def test_paged_prefill_chunk_with_device_bounds_equals_jax_at_every_bucket(params, c_pad):
    """A first chunk fills positions [0, 11), then a chunk of the bucket
    ``c_pad`` with fewer real rows than its width (the engine's padding) at
    position 11, into blocks in a shuffled order; start and length are 0-d
    tensors.  Logits and every pool block but the trash block 0 equal the
    JAX chunk's."""
    jp, tp = params
    bs, W, first = 4, 12, 11
    n = min(c_pad, 48 - first) - 3
    rng = np.random.default_rng(c_pad)
    table = (1 + rng.permutation(W)).astype(np.int32)
    prompt = rng.integers(0, 64, first + n).astype(np.int32)
    jpool = jdec.init_block_pool(JCFG, 1 + W, bs)
    tpool = tdec.init_block_pool(CFG, 1 + W, bs, device="cpu")
    for start, length, width in ((0, first, 16), (first, n, c_pad)):
        chunk = np.zeros(width, np.int32)
        chunk[:length] = prompt[start:start + length]
        jl, jpool = jdec.paged_prefill_chunk(jp, jpool, jnp.asarray(table), jnp.asarray(chunk),
                                             jnp.int32(start), jnp.int32(length), JCFG)
        tl, tpool = tdec.paged_prefill_chunk(
            tp, tpool, torch.from_numpy(table).long(), torch.from_numpy(chunk).long(),
            torch.tensor(start), torch.tensor(length), CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name, leaf in tpool.items():
        np.testing.assert_allclose(leaf[:, 1:].numpy(), np.asarray(jpool[name][:, 1:]),
                                   atol=1e-4)


def test_paged_prefill_chunk_of_length_zero_writes_only_the_trash_block(params):
    tp = params[1]
    pool = tdec.init_block_pool(CFG, 5, 4, device="cpu")
    logits, pool = tdec.paged_prefill_chunk(tp, pool, torch.arange(1, 5), torch.arange(8),
                                            torch.tensor(0), torch.tensor(0), CFG)
    assert bool(torch.isfinite(logits).all())
    assert all(not leaf[:, 1:].any() for leaf in pool.values())


def test_decode_step_with_a_device_position_equals_jax(params):
    jp, tp = params
    prompt = np.random.default_rng(3).integers(0, 64, (2, 10)).astype(np.int32)
    jcache, tcache = jdec.init_cache(JCFG, 2, 16), tdec.init_cache(CFG, 2, 16, "cpu")
    jl, jcache = jdec.prefill(jp, jnp.asarray(prompt), jcache, JCFG)
    tl, tcache = tdec.prefill(tp, torch.from_numpy(prompt).long(), tcache, CFG, device="cpu")
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    for pos in (10, 11, 12):
        jl, jcache = jdec.decode_step(jp, jcache, jnp.asarray(tok), pos, JCFG)
        tl, tcache = tdec.decode_step(tp, tcache, torch.tensor(tok).long(), torch.tensor(pos),
                                      CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), atol=1e-4)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_generate_with_device_positions_equals_jax_generate(params, quantize):
    jp, tp = params
    jq = jdec.quantize_weights(jp) if quantize else None
    tq = tdec.quantize_weights(tp) if quantize else None
    prompt = np.random.default_rng(4).integers(0, 64, (3, 9)).astype(np.int32)
    for n in (1, 2, 20):
        jout = jdec.generate(jp, jnp.asarray(prompt), JCFG, max_new_tokens=n, qweights=jq)
        tout = tdec.generate(tp, torch.from_numpy(prompt).long(), CFG, max_new_tokens=n,
                             qweights=tq, device="cpu")
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_sampled_generate_draws_as_an_eager_loop_of_int_positions(params):
    """Sampling picks outside the step, on the device, from the caller's
    generator: the draws equal a loop of one-token steps at int positions
    that picks after each step."""
    tp = params[1]
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, 64, (2, 7)))
    out = tdec.generate(tp, prompt, CFG, max_new_tokens=12, temperature=0.9,
                        generator=torch.Generator().manual_seed(11), device="cpu")
    gen = torch.Generator().manual_seed(11)
    cache = tdec.init_cache(CFG, 2, 19, "cpu")
    logits, cache = tdec.prefill(tp, prompt, cache, CFG, device="cpu")
    want = []
    for i in range(12):
        probs = torch.softmax(logits / 0.9, dim=-1)
        want.append(torch.multinomial(probs, 1, generator=gen)[:, 0])
        if i < 11:
            logits, cache = tdec.decode_step(tp, cache, want[-1], 7 + i, CFG)
    assert torch.equal(out, torch.stack(want, dim=1))


def test_cast_weights_leaves_every_logit_as_it_was(params):
    """bf16 compute over float32 weights: the steps on the cast tree give the
    uncast tree's logits bit for bit (the same cast, made once), and the
    steps' own casts return the cast leaves themselves."""
    tp = params[1]
    cfg = CFG.scaled(dtype=torch.bfloat16)
    cast = tdec.cast_weights(tp, cfg)
    for name in ("embed", "unembed"):
        assert cast[name].dtype == torch.bfloat16 and cast[name].to(cfg.dtype) is cast[name]
    for name in tdec.QUANTIZED_BLOCK_WEIGHTS:
        assert tdec._wdq(cast["block"][name], cfg.dtype) is cast["block"][name]
    for name in ("attn_norm", "mlp_norm"):
        assert cast["block"][name] is tp["block"][name]
    assert cast["final_norm"] is tp["final_norm"]
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, 64, (2, 8)))
    outs = []
    for p in (tp, cast):
        cache = tdec.init_cache(cfg, 2, 12, "cpu")
        first, cache = tdec.prefill(p, prompt, cache, cfg, device="cpu")
        step, cache = tdec.decode_step(p, cache, first.argmax(-1), 8, cfg)
        pool = tdec.init_block_pool(cfg, 5, 4, device="cpu")
        chunk, pool = tdec.paged_prefill_chunk(p, pool, torch.arange(1, 5), prompt[0], 0, 8, cfg)
        outs.append((first, step, chunk, tdec.generate(p, prompt, cfg, max_new_tokens=4,
                                                        device="cpu")))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
