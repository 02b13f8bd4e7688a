"""The port's persistent prefix store against the JAX package's.

``polyaxon_tpu_torch/serving/kvstore.py`` writes the reference's on-disk
format: the same ``meta.json`` and the same ``.npy`` members in
``blocks.npz``, byte for byte (bf16 leaves as numpy writes the reference's
bfloat16 arrays).  A store either package writes loads in the other with the
same chains and bit-equal payloads, for bf16 and int8 pools, from real
engines.  Then warm boot at the reference tests' size: a warm engine gives a
cold one's greedy tokens, a torn version is ignored, a mismatched signature
boots cold, a preload whose copies fail boots cold with no entry, the
preload keeps to half the pool, and demoted entries persist from their host
payloads.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import shutil
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.serving import ServingEngine as JaxEngine
from polyaxon_tpu.serving import kvstore as jstore
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.serving import ServingEngine
from polyaxon_tpu_torch.serving import kvstore as tstore

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=48)
META = {"sig": "m1", "kv_dtype": "float32", "block_size": 4}
POOLS = {  # name: (model dtype, kv_quantize)
    "float32": ("float32", None),
    "bfloat16": ("bfloat16", None),
    "int8": ("float32", "int8"),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jd, td) in {"float32": (jnp.float32, torch.float32),
                           "bfloat16": (jnp.bfloat16, torch.bfloat16)}.items():
        jcfg = jtr.TransformerConfig(dtype=jd, **SMALL)
        tcfg = ttr.TransformerConfig(dtype=td, **SMALL)
        jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _as_torch(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _bits(t):
    """A payload leaf's bits as numpy, from either package."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return t.view(np.int16) if t.dtype == ml_dtypes.bfloat16 else np.asarray(t)


def _synthetic(layout, n=3):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        chain = tuple(range(4 * (i + 1)))
        f = rng.normal(size=(2, 4, 2, 8)).astype(np.float32)
        if layout == "int8":
            q = rng.integers(-127, 128, (2, 4, 2, 8)).astype(np.int8)
            data = {"k_q": q, "k_scale": f[..., 0].copy(), "v_q": -q, "v_scale": f[..., 1].copy()}
        elif layout == "bfloat16":
            data = {"k": f.astype(ml_dtypes.bfloat16), "v": (-f).astype(ml_dtypes.bfloat16)}
        else:
            data = {"k": f, "v": -f}
        out.append((chain, data))
    return out


@pytest.mark.parametrize("layout", sorted(POOLS))
def test_stores_are_the_jax_stores_byte_for_byte(layout, tmp_path):
    entries = _synthetic(layout)
    meta = dict(META, kv_dtype=layout)
    jstore.save_prefix_store(tmp_path / "jax", entries, meta=meta)
    tstore.save_prefix_store(tmp_path / "port",
                             [(c, {n: _as_torch(a) for n, a in d.items()}) for c, d in entries],
                             meta=meta)
    assert (tmp_path / "jax/1/meta.json").read_text() == (tmp_path / "port/1/meta.json").read_text()
    with zipfile.ZipFile(tmp_path / "jax/1/blocks.npz") as zj, \
            zipfile.ZipFile(tmp_path / "port/1/blocks.npz") as zt:
        assert zt.namelist() == zj.namelist()
        for name in zj.namelist():
            assert zt.read(name) == zj.read(name), name
    assert tstore.complete_versions(tmp_path / "jax") == jstore.complete_versions(tmp_path / "port")


@pytest.mark.parametrize("layout", sorted(POOLS))
def test_each_package_loads_the_others_store(layout, tmp_path):
    entries = _synthetic(layout)
    meta = dict(META, kv_dtype=layout)
    jstore.save_prefix_store(tmp_path / "jax", entries, meta=meta)
    tstore.save_prefix_store(tmp_path / "port",
                             [(c, {n: _as_torch(a) for n, a in d.items()}) for c, d in entries],
                             meta=meta)
    by_port = tstore.load_prefix_store(tmp_path / "jax", expect=meta)
    by_jax = jstore.load_prefix_store(tmp_path / "port", expect=meta)
    assert [c for c, _ in by_port] == [c for c, _ in by_jax] == [c for c, _ in entries]
    for (_, want), (_, t), (_, j) in zip(entries, by_port, by_jax):
        assert sorted(t) == sorted(j) == sorted(want)
        for name in want:
            assert str(t[name].dtype) == f"torch.{want[name].dtype}"
            assert str(j[name].dtype) == str(want[name].dtype)
            np.testing.assert_array_equal(_bits(t[name]), _bits(want[name]))
            np.testing.assert_array_equal(_bits(j[name]), _bits(want[name]))


def _serve(engine, prompts, max_new):
    """Tokens of ``prompts`` served one after another, and the stats after
    ``stop()`` (the final snapshot included)."""
    engine.start()
    try:
        assert engine.wait_ready(timeout=120)
        out = [engine.submit(p, max_new).wait(timeout=120) for p in prompts]
    finally:
        engine.stop()
    return out, engine.stats()


def _engine(models, pool, side, store, **kw):
    dtype, kvq = POOLS[pool]
    jcfg, tcfg, jp, tp = models[dtype]
    kw = dict(slots=2, max_len=48, block_size=4, prefix_cache=True, kv_quantize=kvq,
              kv_persist_dir=str(store) if store else None, kv_persist_sig="w1", **kw)
    if side == "jax":
        return JaxEngine(jp, jcfg, warmup=True, **kw)
    return ServingEngine(tp, tcfg, device="cpu", warmup=True, **kw)


def _prefix_prompts(seed):
    rng = np.random.default_rng(seed)
    pre = [int(x) for x in rng.integers(0, 64, 8)]
    return [pre + [int(x) for x in rng.integers(0, 64, 5)], pre + [1, 2, 3, 4, 5]]


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_engine_stores_load_across_packages_bit_equal(models, pool, tmp_path):
    """Each engine persists its prefix blocks on stop; both packages' loaders
    read each store with the same chains and bits (the two engines' KV
    differ by their float rounding, so the stores are compared each with
    itself)."""
    prompts = _prefix_prompts(11)
    jout, _ = _serve(_engine(models, pool, "jax", tmp_path / "jax"), prompts, 6)
    tout, ts = _serve(_engine(models, pool, "torch", tmp_path / "port"), prompts, 6)
    assert tout == jout
    assert ts["kv_persisted_blocks"] == 4  # two shared blocks, a third each
    meta = json.loads((tmp_path / "port/1/meta.json").read_text())["meta"]
    assert meta == json.loads((tmp_path / "jax/1/meta.json").read_text())["meta"]
    jj = jstore.load_prefix_store(tmp_path / "jax", expect=meta)
    jt = jstore.load_prefix_store(tmp_path / "port", expect=meta)
    tj = tstore.load_prefix_store(tmp_path / "jax", expect=meta)
    tt = tstore.load_prefix_store(tmp_path / "port", expect=meta)
    assert [c for c, _ in jj] == [c for c, _ in jt] == [c for c, _ in tj] == [c for c, _ in tt]
    for by_jax, by_port in ((jj, tj), (jt, tt)):
        for (_, ref), (_, data) in zip(by_jax, by_port):
            assert sorted(data) == sorted(ref)
            for name in ref:
                np.testing.assert_array_equal(_bits(data[name]), _bits(ref[name]))
    if pool == "bfloat16":
        assert str(tt[0][1]["k"].dtype) == "torch.bfloat16"
    else:
        assert {n: str(t.dtype) for n, t in tt[0][1].items()} == {
            "k_q": "torch.int8", "k_scale": "torch.float32", "v_q": "torch.int8",
            "v_scale": "torch.float32"}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_a_warm_engine_gives_the_cold_engines_tokens(models, pool, tmp_path):
    prompts = _prefix_prompts(12)
    store = tmp_path / "kv"
    first, _ = _serve(_engine(models, pool, "torch", store), prompts[:1], 6)
    shutil.copytree(store, tmp_path / "kv_jax")  # each warm engine persists again on stop
    cold, cs = _serve(_engine(models, pool, "torch", None), prompts, 6)
    warm, ws = _serve(_engine(models, pool, "torch", store), prompts, 6)
    jwarm, js = _serve(_engine(models, pool, "jax", tmp_path / "kv_jax"), prompts, 6)
    assert warm == cold == jwarm and warm[0] == first[0]
    assert ws["kv_preloaded_blocks"] == js["kv_preloaded_blocks"] == 3
    assert cs["kv_preloaded_blocks"] == 0
    assert ws["prefix_cache_hits"] == js["prefix_cache_hits"] > cs["prefix_cache_hits"]


def test_a_port_engine_boots_warm_from_a_jax_engines_store(models, tmp_path):
    prompts = _prefix_prompts(13)
    store = tmp_path / "kv"
    jout, _ = _serve(_engine(models, "float32", "jax", store), prompts[:1], 6)
    tout, ts = _serve(_engine(models, "float32", "torch", store), prompts, 6)
    assert tout[0] == jout[0]
    assert ts["kv_preloaded_blocks"] == 3 and ts["prefix_cache_hits"] >= 4


def test_a_torn_version_is_ignored_and_the_next_writer_claims_past_it(tmp_path):
    entries = [(c, {n: _as_torch(a) for n, a in d.items()}) for c, d in _synthetic("float32", 1)]
    tstore.save_prefix_store(tmp_path, entries, meta=META)
    torn = tmp_path / "2"
    torn.mkdir()
    (torn / "meta.json").write_text("{ torn")
    for mod in (tstore, jstore):
        assert mod.latest_complete_version(tmp_path) == 1
        assert len(mod.load_prefix_store(tmp_path, expect=META)) == 1
    assert tstore.save_prefix_store(tmp_path, entries, meta=META) == 3
    # a marker whose directory is gone is no version either
    (tmp_path / ".complete" / "7").write_text("")
    assert tstore.latest_complete_version(tmp_path) == jstore.latest_complete_version(tmp_path) == 3


@pytest.mark.parametrize("bad", [{"sig": "other-weights"}, {"block_size": 8},
                                 {"kv_dtype": "int8"}], ids=lambda b: next(iter(b)))
def test_a_mismatched_meta_walks_away(bad, tmp_path):
    entries = [(c, {n: _as_torch(a) for n, a in d.items()}) for c, d in _synthetic("float32", 1)]
    tstore.save_prefix_store(tmp_path, entries, meta=META)
    assert tstore.load_prefix_store(tmp_path, expect=META) is not None
    assert tstore.load_prefix_store(tmp_path, expect={**META, **bad}) is None
    assert jstore.load_prefix_store(tmp_path, expect={**META, **bad}) is None


def test_gc_keeps_the_newest_two_and_a_corrupt_payload_reads_as_missing(tmp_path):
    entries = [(c, {n: _as_torch(a) for n, a in d.items()}) for c, d in _synthetic("float32", 1)]
    for _ in range(4):
        tstore.save_prefix_store(tmp_path, entries, meta=META)
    assert tstore.complete_versions(tmp_path) == [3, 4]
    assert not (tmp_path / "1").exists() and not (tmp_path / ".complete" / "1").exists()
    (tmp_path / "4" / "blocks.npz").write_bytes(b"not a zipfile")
    assert tstore.load_prefix_store(tmp_path, expect=META) is None
    assert tstore.save_prefix_store(tmp_path, [], meta=META) is None


def test_a_signature_mismatch_boots_cold(models, tmp_path):
    prompts = _prefix_prompts(14)
    store = tmp_path / "kv"
    ref, _ = _serve(_engine(models, "float32", "torch", store), prompts[:1], 6)
    _, tcfg, _, tp = models["float32"]
    eng = ServingEngine(tp, tcfg, slots=2, max_len=48, block_size=4, prefix_cache=True,
                        kv_persist_dir=str(store), kv_persist_sig="w2", device="cpu",
                        warmup=True)
    out, s = _serve(eng, prompts[:1], 6)
    assert out == ref
    assert s["kv_preloaded_blocks"] == 0 and s["prefix_cache_hits"] == 0


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_a_failed_preload_copy_leaves_no_entry_and_boots_cold(models, pool, tmp_path,
                                                              monkeypatch):
    """The preload's copies fail (as a copy to the card could): the warmup
    boots cold with no prefix entry that a prompt could match over blocks
    that never received their KV, every block back in the pool, and a cold
    engine's tokens."""
    prompts = _prefix_prompts(16)
    store = tmp_path / "kv"
    _serve(_engine(models, pool, "torch", store), prompts[:1], 6)
    cold, cs = _serve(_engine(models, pool, "torch", None), prompts, 6)
    eng = _engine(models, pool, "torch", store)
    copies = []
    copy_in = eng._copy_in

    def failing_first_copy(blocks, payloads):  # the preload's; the warmup's round trip works
        copies.append(list(blocks))
        if len(copies) == 1:
            raise RuntimeError("copy to the card failed")
        copy_in(blocks, payloads)

    monkeypatch.setattr(eng, "_copy_in", failing_first_copy)
    eng.start()
    try:
        assert eng.wait_ready(timeout=120)
        assert len(copies[0]) == 3  # the preload tried its three blocks
        ready = eng.stats()
        assert len(eng.prefix_cache) == 0 and ready["kv_preloaded_blocks"] == 0
        assert ready["blocks_free"] == ready["blocks_total"]
        out = [eng.submit(p, 6).wait(timeout=120) for p in prompts]
    finally:
        eng.stop()
    ws = eng.stats()
    assert out == cold
    assert ws["prefix_cache_hits"] == cs["prefix_cache_hits"]
    assert ws["prefix_cache_misses"] == cs["prefix_cache_misses"]


def test_the_preload_keeps_to_half_the_pool_like_the_jax_engine(models, tmp_path):
    """A store of 12 blocks against a pool of 13: the preload stops at
    (13 - 1) // 2 = 6 blocks, root-first chains."""
    rng = np.random.default_rng(15)
    prompts = [[int(x) for x in rng.integers(0, 64, 16)] for _ in range(3)]
    store = tmp_path / "kv"
    _serve(_engine(models, "float32", "torch", store, kv_persist_blocks=64), prompts, 2)
    assert len(tstore.load_prefix_store(store)) == 12
    shutil.copytree(store, tmp_path / "kv_jax")
    stats = {}
    for side, where in (("torch", store), ("jax", tmp_path / "kv_jax")):
        eng = _engine(models, "float32", side, where, num_blocks=13)
        out, stats[side] = _serve(eng, prompts[:1], 2)
    assert stats["torch"]["kv_preloaded_blocks"] == stats["jax"]["kv_preloaded_blocks"] == 6
    assert stats["torch"]["prefix_cache_hits"] == stats["jax"]["prefix_cache_hits"]


def test_demoted_entries_persist_from_their_host_payloads(models, tmp_path):
    _, tcfg, _, tp = models["float32"]
    rng = np.random.default_rng(13)
    p = [int(x) for x in rng.integers(0, 64, 8)]
    store = tmp_path / "kv"
    a = ServingEngine(tp, tcfg, slots=2, max_len=48, block_size=4, prefix_cache=True,
                      kv_offload=True, kv_persist_dir=str(store), kv_persist_sig="w1",
                      device="cpu", warmup=False).start()
    try:
        ref = a.submit(p, 4).wait(timeout=120)
    finally:
        a.stop()  # the scheduler is down: this thread owns the pool and the cache
    rows = {b: {n: leaf[:, b].clone() for n, leaf in a._pool.items()}
            for b, _ in a.prefix_cache._entries.values()}
    assert a.prefix_cache.evict(need=2) == 2 and a.prefix_cache.n_demoted == 2
    exported = []
    a._export_blocks = lambda blocks: exported.append(blocks)  # no device traffic
    assert a.persist_prefixes() == 2 and exported == []
    loaded = tstore.load_prefix_store(store)
    for (_, data), b in zip(loaded, sorted(rows)):
        for n, t in data.items():
            assert torch.equal(t, rows[b][n])
    out, s = _serve(ServingEngine(tp, tcfg, slots=2, max_len=48, block_size=4, prefix_cache=True,
                                  kv_persist_dir=str(store), kv_persist_sig="w1", device="cpu",
                                  warmup=True), [p], 4)
    assert out == [ref] and s["kv_preloaded_blocks"] == 2 and s["prefix_cache_hits"] >= 2


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_store_meta_equals_the_jax_engines(models, pool, tmp_path):
    jeng = _engine(models, pool, "jax", tmp_path)
    teng = _engine(models, pool, "torch", tmp_path)
    try:
        assert teng._kv_store_meta() == jeng._kv_store_meta()
    finally:
        teng.stop()
        jeng.stop()


def test_an_unsigned_store_is_signed_from_the_weights(models, tmp_path):
    _, tcfg, jp, tp = models["float32"]
    jcfg = models["float32"][0]

    def sig(params, seed=0, **kw):
        eng = ServingEngine(params, tcfg, slots=1, max_len=48, kv_persist_dir=str(tmp_path),
                            seed=seed, device="cpu", **kw)
        eng.stop()
        return eng.kv_persist_sig

    base = sig(tp)
    assert base.startswith("auto:") and len(base) == len("auto:") + 16
    assert sig(tp) == base
    assert sig(tp, seed=1) != base
    other = {k: v for k, v in tp.items()}
    other["embed"] = tp["embed"] + 1.0
    assert sig(other) != base
    jeng = JaxEngine(jp, jcfg, slots=1, max_len=48, kv_persist_dir=str(tmp_path), warmup=False)
    assert jeng.kv_persist_sig.startswith("auto:")
    jeng.stop()


def test_persisting_keys_on_mutations_and_the_interval(models, tmp_path, monkeypatch):
    _, tcfg, _, tp = models["float32"]
    store = tmp_path / "kv"
    eng = ServingEngine(tp, tcfg, slots=1, max_len=48, block_size=4, kv_persist_dir=str(store),
                        kv_persist_sig="w1", device="cpu", warmup=False)
    try:
        eng._maybe_persist()  # an empty cache writes nothing
        assert tstore.latest_complete_version(store) is None
        eng.start()
        eng.submit(list(range(8)), 2).wait(timeout=60)
        eng.stop()  # the final snapshot
        assert tstore.latest_complete_version(store) == 1
        eng._maybe_persist(force=True)  # nothing changed since
        assert tstore.latest_complete_version(store) == 1
        eng.prefix_cache.evict(need=1)
        eng._maybe_persist()  # changed, but inside the interval
        assert tstore.latest_complete_version(store) == 1
        eng._last_persist_t -= eng._kv_persist_interval_s + 1
        eng._maybe_persist()
        assert tstore.latest_complete_version(store) == 2
        assert eng.stats()["kv_persisted_blocks"] == 1
    finally:
        eng.stop()


def test_warmup_total_with_a_store_armed_equals_the_jax_engine(models, tmp_path):
    totals = {}
    for side in ("jax", "torch"):
        eng = _engine(models, "float32", side, tmp_path / side, prefill_chunk=8)
        eng.start()
        try:
            assert eng.wait_ready(timeout=300)
            totals[side] = eng.stats()["warmup"]
        finally:
            eng.stop()
    assert totals["torch"]["total"] == totals["jax"]["total"] == 4
    assert totals["torch"]["done"] == totals["torch"]["total"]
