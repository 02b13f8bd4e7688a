"""The port's host KV tier against the JAX package's.

``HostKVTier`` and the prefix cache's tier hooks (``serving/paging.py``) go
through the same operation sequences as the JAX objects and must give the
same handles, counters, drops and ``match`` results.  Then the engine with
``kv_offload`` at the reference tests' size (vocab 64, d_model 32, 2 layers,
4 heads x 8, max_seq 48), the same weights on both sides: a pool too small
for its working set parks, spills and restores, and every request's greedy
tokens equal an engine's whose pool never fills and the JAX engine's under
the same schedule, for float32, bf16 and int8 pools, with as many sheds as
the JAX engine (0 where it has 0) and no step built after ready.  Payloads
are the pool's rows bit for bit, in its storage dtypes.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.serving import BlockAllocator as JAlloc
from polyaxon_tpu.serving import HostKVTier as JTier
from polyaxon_tpu.serving import PrefixCache as JCache
from polyaxon_tpu.serving import ServingEngine as JaxEngine
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.serving import BlockAllocator, HostKVTier, PrefixCache, ServingEngine

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=48)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jd, td) in DTYPES.items():
        jcfg = jtr.TransformerConfig(dtype=jd, **SMALL)
        tcfg = ttr.TransformerConfig(dtype=td, **SMALL)
        # Seed 2, as the reference's offload tests: greedy runs reach short
        # cycles, so speculation lands accepts.
        jp = jtr.init_params(jax.random.PRNGKey(2), jcfg)
        out[name] = (jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return out


# -- the tier and the cache's hooks, as bookkeeping ---------------------------


def _payload(mod, tag):
    arr = np.full((2, 4), tag, np.float32)
    return {"k": arr} if mod == "jax" else {"k": torch.from_numpy(arr)}


def _run_tier(mod, capacity, ops):
    """Apply ``ops`` to a fresh tier; returns everything observable."""
    tier = (JTier if mod == "jax" else HostKVTier)(capacity_blocks=capacity)
    dropped = []
    tier.on_drop = dropped.append
    seen = []
    handles = []
    for op, arg in ops:
        if op == "put":
            h = tier.put(_payload(mod, arg), pinned=False)
            handles.append(h)
            seen.append(h)
        elif op == "pin":
            h = tier.put(_payload(mod, arg), pinned=True)
            handles.append(h)
            seen.append(h)
        elif op == "get":
            seen.append(float(tier.get(handles[arg])["k"][0, 0]))
        elif op == "pop":
            seen.append(float(tier.pop(handles[arg])["k"][0, 0]))
        elif op == "discard":
            tier.discard(handles[arg])
        seen.append((len(tier), tier.n_pinned, tier.n_unpinned, tier.nbytes,
                     sorted(h for h in handles if h is not None and h in tier)))
    return seen, dropped, (tier.spilled_total, tier.restored_total, tier.dropped_total)


TIER_SCRIPTS = {
    "roundtrip": (0, [("put", 7), ("get", 0), ("pop", 0)]),
    "lru_drop": (2, [("put", 1), ("put", 2), ("get", 0), ("put", 3), ("put", 4)]),
    "pins_exempt": (1, [("pin", 1), ("pin", 2), ("put", 3), ("put", 4), ("pop", 0),
                        ("put", 5)]),
    "discard": (0, [("pin", 1), ("put", 2), ("discard", 0), ("discard", 0), ("pop", 1)]),
    "churn": (3, [("put", i) for i in range(8)] + [("get", 6), ("put", 9), ("pin", 10),
                                                  ("put", 11), ("discard", 9)]),
}


@pytest.mark.parametrize("name", sorted(TIER_SCRIPTS))
def test_host_tier_equals_the_jax_tier(name):
    capacity, ops = TIER_SCRIPTS[name]
    assert _run_tier("torch", capacity, ops) == _run_tier("jax", capacity, ops)


def test_host_tier_rejects_a_negative_capacity_like_the_jax_tier():
    for cls in (JTier, HostKVTier):
        with pytest.raises(ValueError, match=">= 0"):
            cls(capacity_blocks=-1)


def test_host_tier_counts_tensor_bytes_of_every_leaf():
    tier = HostKVTier()
    h = tier.put({"k_q": torch.zeros(2, 4, 3, 8, dtype=torch.int8),
                  "k_scale": torch.zeros(2, 4, 3), "v": torch.zeros(5, dtype=torch.bfloat16)},
                 pinned=True)
    assert tier.nbytes == 2 * 4 * 3 * 8 + 2 * 4 * 3 * 4 + 5 * 2
    tier.discard(h)
    assert tier.nbytes == 0


class _World:
    """An allocator, a prefix cache and a tier with store-backed spill and
    restore callbacks, in one package or the other."""

    def __init__(self, mod, num_blocks, capacity, retry_alloc):
        jax_side = mod == "jax"
        self.alloc = (JAlloc if jax_side else BlockAllocator)(num_blocks)
        self.pc = (JCache if jax_side else PrefixCache)(self.alloc, 4)
        self.tier = (JTier if jax_side else HostKVTier)(capacity_blocks=capacity)
        self.mod = mod
        self.restored = []

        def spill(block):
            return self.tier.put(_payload(mod, block))

        def restore(handle, block):
            self.restored.append((float(self.tier.pop(handle)["k"][0, 0]), block))

        def alloc_retry():
            block = self.alloc.alloc()
            if block is None and self.pc.evict(1):
                block = self.alloc.alloc()
            return block

        self.pc.attach_tier(self.tier, spill=spill, restore=restore,
                            alloc=alloc_retry if retry_alloc else self.alloc.alloc)

    def state(self):
        pc = self.pc
        return (len(pc), pc.n_demoted, pc.hits, pc.lookups, pc.evictions, pc.demotions,
                pc.demote_restores, pc.mutations, self.alloc.n_free, self.alloc.n_used,
                len(self.tier), self.tier.dropped_total, list(self.restored),
                [(c, b, h) for c, b, h in pc.hottest_chains(16)])


PROMPTS = [list(range(4)), list(range(10, 14)), list(range(10, 18)), list(range(20, 32))]


def _run_cache(mod, num_blocks, capacity, retry_alloc, ops):
    w = _World(mod, num_blocks, capacity, retry_alloc)
    out = []
    held = []
    for op, arg in ops:
        if op == "offer":  # a finished request publishes its prompt blocks
            prompt = PROMPTS[arg]
            blocks = [w.alloc.alloc() for _ in range(len(prompt) // 4)]
            w.pc.offer(prompt, blocks)
            for b in blocks:
                w.alloc.decref(b)
        elif op == "match":
            got = w.pc.match(PROMPTS[arg])
            out.append(got)
            for b in got:
                w.alloc.decref(b)
        elif op == "evict":
            out.append(w.pc.evict(arg))
        elif op == "hard_evict":
            out.append(w.pc.evict(arg, demote=False))
        elif op == "fill":  # pin the free list empty
            held += [w.alloc.alloc() for _ in range(w.alloc.n_free)]
        elif op == "free":
            for b in held:
                w.alloc.decref(b)
            held = []
        elif op == "install":
            block = w.alloc.alloc()
            out.append(w.pc.install(PROMPTS[arg], block))
        elif op == "drop_all":
            out.append(w.pc.drop_all())
        out.append(w.state())
    return out


CACHE_SCRIPTS = {
    # name: (num_blocks, tier capacity, engine-style retrying alloc, ops)
    "demote_then_restore": (12, 0, True, [("offer", 3), ("evict", 3), ("match", 3),
                                           ("match", 3)]),
    "capacity_drop_is_a_miss": (12, 1, True, [("offer", 2), ("evict", 2), ("match", 2)]),
    "restore_under_pressure": (6, 0, True, [("offer", 0), ("offer", 1), ("evict", 2),
                                            ("fill", None), ("match", 0), ("free", None),
                                            ("match", 1)]),
    # the reference's reentrancy regressions
    "evict_survives_drop_mid_walk": (8, 1, False, [("offer", 0), ("offer", 1), ("evict", 1),
                                                   ("fill", None), ("match", 0),
                                                   ("free", None), ("evict", 2),
                                                   ("match", 0), ("match", 1)]),
    "restore_survives_drop_of_its_handle": (8, 1, True, [("offer", 0), ("offer", 1),
                                                         ("evict", 1), ("fill", None),
                                                         ("match", 0), ("free", None),
                                                         ("match", 1)]),
    "hard_evict_and_drop_all": (12, 0, True, [("offer", 3), ("offer", 0), ("evict", 1),
                                              ("hard_evict", 1), ("drop_all", None)]),
    "install_first_writer_wins": (12, 0, True, [("install", 0), ("install", 0),
                                                ("install", 2), ("match", 2), ("evict", 4),
                                                ("match", 0)]),
}


@pytest.mark.parametrize("name", sorted(CACHE_SCRIPTS))
def test_prefix_cache_tier_hooks_equal_the_jax_cache(name):
    num_blocks, capacity, retry, ops = CACHE_SCRIPTS[name]
    tout = _run_cache("torch", num_blocks, capacity, retry, ops)
    jout = _run_cache("jax", num_blocks, capacity, retry, ops)
    assert tout == jout


# -- the engine with the tier armed -------------------------------------------


def _prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 64, length)] for _ in range(n)]


def _outcomes(engine, traffic, together=True):
    """(per-request tokens or "shed", stats) of an engine over (prompt,
    max_new) requests, submitted before start when ``together``."""
    try:
        if together:
            reqs = [engine.submit(p, n) for p, n in traffic]
            engine.start()
        else:
            engine.start()
            reqs = []
            for p, n in traffic:
                reqs.append(engine.submit(p, n))
                reqs[-1].done.wait(120)
        out = []
        for r in reqs:
            try:
                out.append(r.wait(timeout=120))
            except RuntimeError:
                assert r.error_kind == "shed", r.error
                out.append("shed")
        return out, engine.stats()
    finally:
        engine.stop()


def _three(models, dtype, traffic, together=True, **kw):
    """The JAX engine and the port's with the tier armed, then the port's
    with a pool that never fills (the tokens' reference)."""
    jcfg, tcfg, jp, tp = models[dtype]
    base = dict(max_len=48, **{k: v for k, v in kw.items() if k not in ("num_blocks",)})
    jres = _outcomes(JaxEngine(jp, jcfg, warmup=False, kv_offload=True, **kw), traffic, together)
    tres = _outcomes(ServingEngine(tp, tcfg, device="cpu", warmup=True, kv_offload=True, **kw),
                     traffic, together)
    ample = _outcomes(ServingEngine(tp, tcfg, device="cpu", warmup=False, **base), traffic,
                      together)
    return jres, tres, ample


OVERSUBSCRIBED = {
    # name: (pool dtype, kv_quantize)
    "float32": ("float32", None),
    "bfloat16": ("bfloat16", None),
    "int8": ("float32", "int8"),
}


@pytest.mark.parametrize("name", sorted(OVERSUBSCRIBED))
def test_oversubscribed_pool_serves_without_sheds_and_equal_tokens(models, name):
    """Four requests of 4 blocks each against 8 usable blocks: with the tier
    armed parking spills instead of shedding."""
    dtype, kvq = OVERSUBSCRIBED[name]
    traffic = [(p, 8) for p in _prompts(40, 4, 8)]
    (jout, js), (tout, ts), (aout, _) = _three(
        models, dtype, traffic, slots=4, block_size=4, num_blocks=9, prefix_cache=False,
        kv_quantize=kvq)
    assert tout == jout == aout
    assert ts["requests_shed"] == js["requests_shed"] == 0
    for key in ("block_parks", "host_spilled_blocks_total", "host_restored_blocks_total"):
        assert ts[key] == js[key] > 0, key
    assert ts["steady_state_compiles"] == 0
    assert ts["blocks_free"] == ts["blocks_total"] and ts["host_tier_blocks"] == 0
    assert ts["host_tier_bytes"] == 0 and ts["kv_offload"] is True


def test_park_spills_and_resumes_token_identical(models):
    """The reference's park scenario with the tier armed: the parked
    sequence's private blocks spill, free, and stream back on resume."""
    pa, pb = _prompts(24, 1, 24)[0], _prompts(25, 1, 4)[0]
    traffic = [(pa, 8), (pb, 4)]
    (jout, js), (tout, ts), (aout, _) = _three(
        models, "float32", traffic, slots=2, block_size=4, num_blocks=9, prefix_cache=False)
    assert tout == jout == aout
    for key in ("block_parks", "host_spilled_blocks_total", "host_restored_blocks_total",
                "requests_shed"):
        assert ts[key] == js[key], key
    assert ts["host_spilled_blocks_total"] >= 1 and ts["steady_state_compiles"] == 0


def test_a_lane_parking_mid_speculation_resumes_token_identical(models):
    pa = [5, 9, 3, 7, 5, 9, 3, 7] * 3
    pb = [11, 2, 11, 2]
    traffic = [(pa, 8), (pb, 12)]
    (jout, js), (tout, ts), (aout, _) = _three(
        models, "float32", traffic, slots=2, block_size=4, num_blocks=9, prefix_cache=False,
        spec_decode=True, spec_k=4, spec_min_ngram=2)
    assert tout == jout == aout
    for key in ("block_parks", "host_spilled_blocks_total", "spec_steps", "spec_accepted_total",
                "requests_shed"):
        assert ts[key] == js[key], key
    assert ts["spec_steps"] >= 1 and ts["block_parks"] >= 1


def test_shared_prefix_traffic_demotes_and_restores_like_the_jax_engine(models):
    """Prefix reuse with a pool that must demote cold prefixes to admit
    new ones, and hits that restore them."""
    rng = np.random.default_rng(33)
    pre = [int(x) for x in rng.integers(0, 64, 12)]
    other = [int(x) for x in rng.integers(0, 64, 16)]
    traffic = [(pre + [1, 2], 6), (other, 6), (pre + [3], 6), (other[:8] + [4, 5], 6),
               (pre, 5)]
    (jout, js), (tout, ts), (aout, _) = _three(
        models, "float32", traffic, together=False, slots=1, block_size=4, num_blocks=9,
        prefix_cache=True)
    assert tout == jout == aout
    for key in ("prefix_cache_hits", "prefix_cache_misses", "prefix_cache_demotions",
                "prefix_cache_restores", "prefix_cache_evictions", "cow_copies",
                "host_spilled_blocks_total", "host_restored_blocks_total", "requests_shed"):
        assert ts[key] == js[key], key
    assert ts["prefix_cache_demotions"] > 0 and ts["prefix_cache_restores"] > 0


def _demote_engine(models, dtype, kvq, **kw):
    _, tcfg, _, tp = models[dtype]
    return ServingEngine(tp, tcfg, slots=2, max_len=48, block_size=4, num_blocks=12,
                         prefix_cache=True, kv_offload=True, kv_quantize=kvq, device="cpu",
                         warmup=False, **kw).start()


@pytest.mark.parametrize("name", sorted(OVERSUBSCRIBED))
def test_demoted_payloads_are_the_pool_rows_in_their_storage_dtypes(models, name):
    dtype, kvq = OVERSUBSCRIBED[name]
    eng = _demote_engine(models, dtype, kvq)
    try:
        p = _prompts(33, 1, 12)[0]
        ref = eng.submit(p, 6).wait(timeout=120)
        pc = eng.prefix_cache
        blocks = [b for _, (b, _) in sorted(pc._entries.items(), key=lambda kv: kv[1][0])]
        rows = {b: {n: leaf[:, b].clone() for n, leaf in eng._pool.items()} for b in blocks}
        assert pc.evict(need=3) == 3 and pc.demotions == 3 and pc.n_demoted == 3
        assert eng.block_allocator.n_used == 0 and len(eng._host_tier) == 3
        payloads = [eng._host_tier.get(h) for h in pc._demoted.values()]
        for data, b in zip(payloads, blocks):
            for n, t in data.items():
                assert t.dtype == eng._pool[n].dtype
                assert torch.equal(t, rows[b][n]), n
        kinds = {n: str(t.dtype) for n, t in payloads[0].items()}
        if kvq:
            assert kinds == {"k_q": "torch.int8", "k_scale": "torch.float32",
                             "v_q": "torch.int8", "v_scale": "torch.float32"}
        else:
            assert set(kinds.values()) == {f"torch.{dtype}"}
        assert eng.stats()["host_tier_bytes"] == 3 * sum(t.nbytes for t in payloads[0].values())
        assert eng.submit(p, 6).wait(timeout=120) == ref
        assert pc.demote_restores == 3 and pc.n_demoted == 0
    finally:
        eng.stop()


def test_a_dropped_demoted_payload_degrades_to_a_miss(models):
    eng = _demote_engine(models, "float32", None, kv_offload_blocks=1)
    try:
        p = _prompts(34, 1, 8)[0]
        ref = eng.submit(p, 4).wait(timeout=120)
        pc = eng.prefix_cache
        pc.evict(need=2)
        assert pc.demotions == 2 and len(pc) == 1 and pc.n_demoted == 1
        assert eng._host_tier.dropped_total == 1
        assert eng.submit(p, 4).wait(timeout=120) == ref
    finally:
        eng.stop()


def test_warmup_total_with_the_tier_armed_equals_the_jax_engine(models):
    jcfg, tcfg, jp, tp = models["float32"]
    kw = dict(slots=2, max_len=48, prefill_chunk=16, kv_offload=True, warmup=True)
    jeng = JaxEngine(jp, jcfg, **kw).start()
    try:
        assert jeng.wait_ready(timeout=300)
        jtotal = jeng.stats()["warmup"]["total"]
    finally:
        jeng.stop()
    eng = ServingEngine(tp, tcfg, device="cpu", **kw).start()
    try:
        assert eng.wait_ready(timeout=120)
        s = eng.stats()
        # the decode step, chunk buckets 8 and 16, the COW copy, the spill
        # and restore round trip
        assert s["warmup"]["total"] == s["warmup"]["done"] == jtotal == 5
        assert s["blocks_free"] == s["blocks_total"] and s["host_tier_blocks"] == 0
        assert s["host_restored_blocks_total"] == s["host_spilled_blocks_total"] == 0
    finally:
        eng.stop()


def test_knob_defaults_arm_the_tier_like_the_jax_engine(models, monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_KV_OFFLOAD", "1")
    monkeypatch.setenv("POLYAXON_TPU_KV_OFFLOAD_BLOCKS", "5")
    jcfg, tcfg, jp, tp = models["float32"]
    jeng = JaxEngine(jp, jcfg, slots=1, max_len=48, warmup=False)
    eng = ServingEngine(tp, tcfg, slots=1, max_len=48, device="cpu")
    try:
        assert eng.kv_offload is jeng.kv_offload is True
        assert eng._host_tier.capacity_blocks == jeng._host_tier.capacity_blocks == 5
        assert eng.prefix_cache._tier is eng._host_tier
    finally:
        eng.stop()
        jeng.stop()


@pytest.mark.parametrize("option", [
    {"kv_offload": True}, {"kv_offload_blocks": 8}, {"kv_persist_dir": "kv"},
    {"kv_persist_blocks": 4}, {"kv_persist_sig": "sig"},
], ids=lambda o: next(iter(o)))
def test_kv_options_are_taken_as_the_jax_engine_takes_them(models, option, tmp_path):
    jcfg, tcfg, jp, tp = models["float32"]
    if "kv_persist_dir" in option:
        option = {"kv_persist_dir": str(tmp_path / "kv")}
    jeng = JaxEngine(jp, jcfg, slots=1, max_len=48, warmup=False, **option)
    eng = ServingEngine(tp, tcfg, slots=1, max_len=48, device="cpu", **option)
    try:
        for attr in ("kv_offload", "kv_offload_blocks", "kv_persist_dir", "kv_persist_blocks"):
            assert getattr(eng, attr) == getattr(jeng, attr), attr
        assert bool(eng.kv_persist_sig) == bool(jeng.kv_persist_sig)
        assert (eng._host_tier is None) == (jeng._host_tier is None)
    finally:
        eng.stop()
        jeng.stop()


def test_a_failed_restore_fails_its_request_and_the_engine_serves_on(models, monkeypatch):
    """No fallback hides a copy that failed: the parked request whose
    restore raised gets the error, its neighbour and later requests finish."""
    _, tcfg, _, tp = models["float32"]
    pa, pb = _prompts(24, 1, 24)[0], _prompts(25, 1, 4)[0]
    eng = ServingEngine(tp, tcfg, slots=2, max_len=48, block_size=4, num_blocks=9,
                        prefix_cache=False, kv_offload=True, device="cpu", warmup=False)

    def broken(blocks, payloads):
        raise RuntimeError("copy engine fault")

    monkeypatch.setattr(eng, "_copy_in", broken)
    ra, rb = eng.submit(pa, 8), eng.submit(pb, 4)
    eng.start()
    try:
        failed = []
        for r in (ra, rb):
            try:
                r.wait(timeout=120)
            except RuntimeError as e:
                failed.append(str(e))
        assert len(failed) == 1 and "KV restore failed" in failed[0]
        s = eng.stats()
        assert s["host_spilled_blocks_total"] >= 1 and s["host_tier_blocks"] == 0
        assert eng.submit([1, 2, 3], 3).wait(timeout=60)
        assert eng.stats()["blocks_free"] == s["blocks_total"]
    finally:
        eng.stop()


def test_a_failed_spill_fails_its_request(models, monkeypatch):
    _, tcfg, _, tp = models["float32"]
    pa, pb = _prompts(24, 1, 24)[0], _prompts(25, 1, 4)[0]
    eng = ServingEngine(tp, tcfg, slots=2, max_len=48, block_size=4, num_blocks=9,
                        prefix_cache=False, kv_offload=True, device="cpu", warmup=False)

    def broken(blocks):
        raise RuntimeError("pinned allocation failed")

    monkeypatch.setattr(eng, "_export_blocks", broken)
    ra, rb = eng.submit(pa, 8), eng.submit(pb, 4)
    eng.start()
    try:
        errors = []
        for r in (ra, rb):
            try:
                r.wait(timeout=120)
            except RuntimeError as e:
                errors.append(str(e))
        assert errors and all("KV spill failed" in e for e in errors)
        assert eng.stats()["block_parks"] >= 1
    finally:
        eng.stop()
