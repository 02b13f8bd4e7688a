"""The port's paged serving engine against the JAX package's engine.

Both engines get the same weights (JAX init, carried over through numpy),
the same configuration and the same requests, on the CPU in float32, at the
reference tests' small size (vocab 64, d_model 32, 2 layers, 4 heads x 8,
d_ff 64, max_seq 48) and a GQA variant.  Greedy tokens must be identical,
request for request; with a float32 pool they must also equal the port's
static ``decode.generate`` (the reference's own guarantee).  The JAX engine
runs with ``warmup=False`` (the compile warmup of its own tests is off too).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import time

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
from polyaxon_tpu_torch.serving import EngineDrainingError, ServingEngine, SlotAllocator

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=48)
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, extra in VARIANTS.items():
        kw = dict(SMALL, **extra)
        jcfg = jtr.TransformerConfig(dtype=jnp.float32, **kw)
        tcfg = ttr.TransformerConfig(dtype=torch.float32, **kw)
        jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 64, t)] for t in lengths]


def _serve(engine, traffic, together=True):
    """Run (prompt, max_new) requests through an engine (all submitted before
    it starts when ``together``, else one after another); stop it and return
    (outputs, stats)."""
    try:
        if together:
            reqs = [engine.submit(p, n) for p, n in traffic]
            engine.start()
            outs = [r.wait(timeout=120) for r in reqs]
        else:
            engine.start()
            outs = [engine.submit(p, n).wait(timeout=120) for p, n in traffic]
        return outs, engine.stats()
    finally:
        engine.stop()


def _engines(models, variant, quantize=False, **kw):
    jcfg, tcfg, jp, tp = models[variant]
    jq = tq = None
    if quantize:
        jq, tq = jdec.quantize_weights(jp), tdec.quantize_weights(tp)
    je = JaxEngine(jp, jcfg, qweights=jq, warmup=False, **kw)
    te = ServingEngine(tp, tcfg, qweights=tq, device="cpu", **kw)
    return je, te, (tp, tcfg, tq)


def _static(port, prompt, max_new, eos_id=None):
    tp, tcfg, tq = port
    out = tdec.generate(tp, torch.tensor([prompt]), tcfg, max_new_tokens=max_new, qweights=tq,
                        device="cpu")[0].tolist()
    if eos_id is not None and eos_id in out:
        out = out[: out.index(eos_id) + 1]
    return out


def _shared_prefix_traffic():
    pre, a, b = _prompts(21, 16, 5, 4)
    # Two requests share two full 8-token blocks and diverge inside the
    # third; the bare prefix is then a block-aligned full hit (COW).
    return [(pre + a, 6), (pre + a[:2] + b, 7), (pre, 5), (pre, 4)]


def _templated_traffic():
    loop = [5, 9, 13, 2, 40, 7]
    return [(loop * 3, 12), (_prompts(31, 5)[0] + loop * 2, 10), (loop * 2 + [5, 9], 14)]


CASES = {
    # name: (variant, engine kwargs, traffic, submitted together, weights int8)
    "mixed": ("mha", dict(slots=2, block_size=8),
              [(p, n) for p, n in zip(_prompts(11, 3, 9, 17, 12, 25), (8, 5, 12, 4, 9))], True,
              False),
    "cow": ("mha", dict(slots=2, block_size=8), _shared_prefix_traffic(), False, False),
    "chunk8": ("mha", dict(slots=2, block_size=4, prefill_chunk=8),
               [(p, n) for p, n in zip(_prompts(12, 30, 6, 19), (6, 9, 7))], True, False),
    "int8_kv": ("mha", dict(slots=2, block_size=8, kv_quantize="int8"),
                _shared_prefix_traffic(), False, False),
    "qweights": ("mha", dict(slots=2, block_size=8),
                 [(p, n) for p, n in zip(_prompts(13, 7, 14, 21), (8, 6, 9))], True, True),
    "gqa": ("gqa", dict(slots=3, block_size=4, prefill_chunk=8),
            [(p, n) for p, n in zip(_prompts(14, 5, 23, 11, 16), (7, 8, 6, 10))], True, False),
    "spec": ("mha", dict(slots=2, block_size=4, spec_decode=True, spec_k=4),
             _templated_traffic(), False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_equal_the_jax_engine(models, case):
    variant, kw, traffic, together, quantize = CASES[case]
    je, te, port = _engines(models, variant, quantize=quantize, max_len=48, **kw)
    jout, jstats = _serve(je, traffic, together)
    tout, tstats = _serve(te, traffic, together)
    assert tout == jout
    assert [len(t) for t in tout] == [n for _, n in traffic]
    if not kw.get("kv_quantize"):  # an int8 pool is near, not bit-identical
        assert tout == [_static(port, p, n) for p, n in traffic]
    for key in ("cow_copies", "prefix_cache_hits", "prefix_cache_misses", "tokens_generated",
                "spec_proposed_total", "spec_accepted_total", "kv_pool_bytes"):
        assert tstats[key] == jstats[key], key
    if case in ("cow", "int8_kv"):
        assert tstats["cow_copies"] >= 1 and tstats["prefix_cache_hits"] >= 4
    if case == "spec":
        assert tstats["spec_accepted_total"] > 0


def test_eos_retires_early_like_the_jax_engine(models):
    traffic = [(p, 12) for p in _prompts(15, 6, 10)]
    jcfg, tcfg, jp, tp = models["mha"]
    eos = _static((tp, tcfg, None), traffic[0][0], 12)[3]
    je, te, port = _engines(models, "mha", slots=2, block_size=8, max_len=48, eos_id=eos)
    jout, _ = _serve(je, traffic)
    tout, _ = _serve(te, traffic)
    assert tout == jout == [_static(port, p, n, eos_id=eos) for p, n in traffic]
    assert tout[0][-1] == eos and len(tout[0]) == 4


def test_pool_pressure_parks_and_resumes_like_the_jax_engine(models):
    """A pool too small for both spans: one request parks at a block
    boundary and resumes when its neighbour retires (the reference's own
    scenario); both engines park as often and give the same tokens."""
    pa, pb = _prompts(24, 24, 4)
    traffic = [(pa, 8), (pb, 4)]
    je, te, port = _engines(models, "mha", slots=2, max_len=48, block_size=4, num_blocks=9,
                            prefix_cache=False)
    jout, jstats = _serve(je, traffic)
    tout, tstats = _serve(te, traffic)
    assert tout == jout == [_static(port, p, n) for p, n in traffic]
    assert tstats["block_parks"] == jstats["block_parks"] >= 1
    assert tstats["blocks_free"] == tstats["blocks_total"]


def test_deadlock_sheds_the_same_request_as_the_jax_engine(models):
    traffic = [(p, 24) for p in _prompts(30, 4, 4)]  # 7 blocks each; 8 usable

    def outcomes(engine):
        reqs = [engine.submit(p, n) for p, n in traffic]
        engine.start()
        try:
            got = []
            for r in reqs:
                try:
                    got.append(r.wait(timeout=120))
                except RuntimeError as e:
                    assert "pool exhausted" in str(e) and r.error_kind == "shed"
                    got.append("shed")
            return got, engine.stats()["requests_shed"]
        finally:
            engine.stop()

    je, te, _ = _engines(models, "mha", slots=2, max_len=48, block_size=4, num_blocks=9,
                         prefix_cache=False)
    jres, tres = outcomes(je), outcomes(te)
    assert tres == jres
    assert tres[0].count("shed") == 1 and tres[1] == 1


def test_sampling_is_seeded_and_leaves_greedy_neighbours_alone(models):
    jcfg, tcfg, jp, tp = models["mha"]
    greedy_p, sampled_p = _prompts(40, 9, 7)

    def run(seed):
        eng = ServingEngine(tp, tcfg, slots=2, max_len=48, seed=seed, device="cpu")
        reqs = [eng.submit(greedy_p, 10), eng.submit(sampled_p, 10, temperature=0.8)]
        eng.start()
        try:
            return [r.wait(timeout=120) for r in reqs]
        finally:
            eng.stop()

    a, b, c = run(0), run(0), run(1)
    assert a == b and a[1] != c[1]
    assert a[0] == c[0] == _static((tp, tcfg, None), greedy_p, 10)
    assert all(0 <= t < 64 for t in a[1] + c[1])


def _long_engine(models, **kw):
    """One slot with room for 400-token generations, so a request is still
    running when the test acts on it (the weights do not depend on max_seq)."""
    _, tcfg, _, tp = models["mha"]
    return ServingEngine(tp, tcfg.scaled(max_seq=512), slots=1, device="cpu", **kw).start()


def test_cancel_frees_slot_and_blocks(models):
    _, tcfg, _, tp = models["mha"]
    eng = _long_engine(models)
    try:
        req = eng.submit([1, 2, 3, 4], 400)
        queued = eng.submit([5, 6], 30)
        assert eng.cancel(queued.id) is True
        with pytest.raises(RuntimeError, match="cancelled"):
            queued.wait(timeout=10)
        assert req.stream.get(timeout=60) is not None  # decoding now
        assert eng.cancel(req.id) is True
        with pytest.raises(RuntimeError, match="cancelled"):
            req.wait(timeout=30)
        deadline = time.time() + 30
        while time.time() < deadline:
            s = eng.stats()
            if s["slots_active"] == 0 and s["blocks_free"] == s["blocks_total"]:
                break
            time.sleep(0.02)
        assert s["slots_active"] == 0 and s["blocks_free"] == s["blocks_total"]
        assert s["requests_cancelled"] == 2
        assert eng.cancel(req.id) is False and eng.cancel(10**9) is False
        assert eng.submit([7, 8], 3).wait(timeout=60) == _static((tp, tcfg, None), [7, 8], 3)
    finally:
        eng.stop()


def test_stats_keys_match_the_jax_engine(models):
    jcfg, tcfg, jp, tp = models["gqa"]
    for kvq in (None, "int8"):
        je = JaxEngine(jp, jcfg, slots=2, max_len=48, block_size=4, kv_quantize=kvq, warmup=False)
        te = ServingEngine(tp, tcfg, slots=2, max_len=48, block_size=4, kv_quantize=kvq,
                           device="cpu")
        js, ts = je.stats(), te.stats()
        je.stop()
        te.stop()
        assert set(js) <= set(ts)
        for key in ("kv_dtype", "kv_pool_bytes", "blocks_total", "blocks_free", "slots", "max_len",
                    "block_size", "spec_decode", "spec_k"):
            assert ts[key] == js[key], key
        assert ts["kv_pool_bytes"] == sum(t.numel() * t.element_size() for t in te._pool.values())


def jax_warmup_total(engine):
    """The JAX engine's warmup total, from a run of its warmup."""
    engine.start()
    try:
        assert engine.wait_ready(timeout=300)
        return engine.stats()["warmup"]["total"]
    finally:
        engine.stop()


def test_warmup_opens_the_ready_gate(models):
    jcfg, tcfg, jp, tp = models["mha"]
    kw = dict(slots=2, max_len=48, prefill_chunk=16, spec_decode=True, spec_k=4, warmup=True)
    eng = ServingEngine(tp, tcfg, device="cpu", **kw)
    assert eng.stats()["state"] == "warming"
    eng.start()
    try:
        assert eng.wait_ready(timeout=60)
        s = eng.stats()
        # the decode step, the chunk buckets 8 and 16, the verify widths 2, 3
        # and 5, the COW copy: the JAX engine's family
        assert s["state"] == "ready" and s["warmup"]["done"] == s["warmup"]["total"]
        assert s["warmup"]["total"] == jax_warmup_total(JaxEngine(jp, jcfg, **kw)) == 7
        assert s["blocks_free"] == s["blocks_total"]  # warmup wrote only the trash block
        assert eng.generate([3, 4, 5], 4, timeout=60) == _static((tp, tcfg, None), [3, 4, 5], 4)
    finally:
        eng.stop()


def test_drain_refuses_new_work_and_stop_releases_every_waiter(models):
    eng = _long_engine(models)
    active = eng.submit([1, 2, 3], 400)
    queued = [eng.submit([4, 5, 6], 400) for _ in range(2)]
    assert active.stream.get(timeout=60) is not None
    eng.drain()
    assert eng.stats()["state"] == "draining"
    with pytest.raises(EngineDrainingError):
        eng.submit([1], 2)
    eng.stop()
    for req in [active] + queued:
        assert req.done.is_set() and req.error == "engine stopped"
        items = []
        while not req.stream.empty():
            items.append(req.stream.get_nowait())
        assert items.count(None) == 1
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1], 2)


def test_submit_validates_like_the_jax_engine(models):
    _, tcfg, _, tp = models["mha"]
    eng = ServingEngine(tp, tcfg, slots=1, max_len=48, block_size=4, num_blocks=4, device="cpu")
    for args, match in ((([], 2), "non-empty"), (([64], 2), "vocabulary"), (([1], 0), "positive"),
                        (([1] * 47, 2), "max_len"), (([1] * 20, 10), "KV blocks")):
        with pytest.raises(ValueError, match=match):
            eng.submit(*args)
    with pytest.raises(ValueError, match="kv_quantize"):
        ServingEngine(tp, tcfg, kv_quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        ServingEngine(tp, tcfg, max_len=64, device="cpu")
    a = SlotAllocator(2)
    assert [a.alloc(), a.alloc(), a.alloc()] == [0, 1, None]


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"param_shardings": {}}, {"qweights_shardings": {}},
], ids=lambda o: next(iter(o)))
def test_unported_options_raise(models, option):
    _, tcfg, _, tp = models["mha"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(tp, tcfg, device="cpu", **option)


def test_engine_defaults_to_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-absent path; a card is present")
    _, tcfg, _, tp = models["mha"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tp, tcfg)
