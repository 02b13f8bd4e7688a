"""Parity of the port's paged KV cache with the JAX package's.

The reference tests' small float32 model (vocab 64, d_model 32, 2 layers,
4 heads x 8, d_ff 64, max_seq 48) and a GQA variant (2 kv-heads), JAX
weights carried over through numpy.  Tolerances: pool operations
(``_kv_quant``, ``_pool_append``, ``_pool_gather``, ``copy_block``,
``export_block``, ``import_block``) bit-exact; paged step logits atol 1e-4
(float32, another summation order); host bookkeeping (allocator, prefix
cache, table rollback) identical.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import decode as jdec
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.serving import paging as jpg
from polyaxon_tpu_torch.models import decode as tdec
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.serving import paging as tpg

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=48)
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}
LAYOUTS = {"f32": None, "int8": "int8"}


def configs(variant):
    kw = dict(SMALL, **VARIANTS[variant])
    return (jtr.TransformerConfig(dtype=jnp.float32, **kw),
            ttr.TransformerConfig(dtype=torch.float32, **kw))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    jcfg, tcfg = configs(request.param)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_kv_quant_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(6, 2, 8)).astype(np.float32) * 3
    rows[1] = 0.0  # zero rows: scale 0, dequantize to exact zeros
    # A row whose scale is exactly 1: values half-way between two steps must
    # round half to even, as jnp.round does.
    rows[2, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -125.5]
    jq, js = jdec._kv_quant(jnp.asarray(rows))
    tq, ts = tdec._kv_quant(torch.from_numpy(rows))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[2, 0].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    np.testing.assert_array_equal(
        tdec._kv_dequant(tq, ts, torch.float32).numpy(),
        np.asarray(jdec._kv_dequant(jq, js, jnp.float32)))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pool_append_and_gather_are_bit_equal_to_jax(layout):
    jcfg, tcfg = configs("gqa")
    kv = LAYOUTS[layout]
    rng = np.random.default_rng(1)
    jpool = {k: v[0] for k, v in jdec.init_block_pool(jcfg, 6, 4, kv_dtype=kv).items()}
    tpool = {k: v[0] for k, v in tdec.init_block_pool(tcfg, 6, 4, kv_dtype=kv, device="cpu").items()}
    rows = rng.normal(size=(3, 5, 2, 8)).astype(np.float32)  # [S, T, Hkv, d]
    blk = rng.integers(0, 6, (3, 5))
    off = rng.integers(0, 4, (3, 5))
    for name in ("k", "v"):
        jpool = jdec._pool_append(jpool, name, jnp.asarray(rows), jnp.asarray(blk), jnp.asarray(off))
        tdec._pool_append(tpool, name, torch.from_numpy(rows), torch.from_numpy(blk),
                          torch.from_numpy(off))
    for name in jpool:
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    table = rng.integers(0, 6, (3, 4))
    for name in ("k", "v"):
        jg = jdec._pool_gather(jpool, name, jnp.asarray(table), jnp.float32)
        tg = tdec._pool_gather(tpool, name, torch.from_numpy(table), torch.float32)
        assert tuple(tg.shape) == (3, 4, 4, 2, 8)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_copy_export_import_round_trip_bit_exact(layout):
    jcfg, tcfg = configs("mha")
    rng = np.random.default_rng(2)
    start = {}
    for name, leaf in jdec.init_block_pool(jcfg, 5, 4, kv_dtype=LAYOUTS[layout]).items():
        if leaf.dtype == jnp.int8:
            start[name] = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        else:
            start[name] = rng.normal(size=leaf.shape).astype(np.float32)
    jpool = {k: jnp.asarray(v) for k, v in start.items()}
    tpool = _t(start)

    jpool = jdec.copy_block(jpool, jnp.int32(3), jnp.int32(1))
    assert tdec.copy_block(tpool, 3, 1) is tpool
    for name, leaf in tpool.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jpool[name]))
        np.testing.assert_array_equal(leaf[:, 1].numpy(), start[name][:, 3])
        np.testing.assert_array_equal(leaf[:, 2].numpy(), start[name][:, 2])

    payload = tdec.export_block(tpool, 2)
    jpayload = jdec.export_block(jpool, jnp.int32(2))
    for name in payload:
        assert payload[name].dtype == tpool[name].dtype
        np.testing.assert_array_equal(payload[name].numpy(), np.asarray(jpayload[name]))
    tpool[next(iter(tpool))][:, 2] = 0  # the payload is a copy, not a view
    tdec.import_block(tpool, payload, 4)
    jpool = jdec.import_block(jpool, jpayload, jnp.int32(4))
    for name, leaf in tpool.items():
        np.testing.assert_array_equal(leaf[:, 4].numpy(), start[name][:, 2])
        np.testing.assert_array_equal(leaf[:, 4].numpy(), np.asarray(jpool[name])[:, 4])


def test_pool_geometry_and_block_bytes_match_jax():
    jcfg, tcfg = configs("gqa")
    for kv in (None, "int8"):
        tpool = tdec.init_block_pool(tcfg, 13, 4, kv_dtype=kv, device="cpu")
        jpool = jdec.init_block_pool(jcfg, 13, 4, kv_dtype=kv)
        assert tdec.is_quantized_pool(tpool) == jdec.is_quantized_pool(jpool) == (kv == "int8")
        assert tdec.pool_geometry(tpool) == tuple(jdec.pool_geometry(jpool))
        assert {k: tuple(v.shape) for k, v in tpool.items()} == \
            {k: tuple(v.shape) for k, v in jpool.items()}
        nbytes = sum(t.numel() * t.element_size() for t in tpool.values())
        assert tdec.kv_block_bytes(tcfg, 4, kv) * 13 == nbytes == jdec.kv_block_bytes(jcfg, 4, kv)*13
    with pytest.raises(ValueError, match="kv_dtype"):
        tdec.init_block_pool(tcfg, 4, 4, kv_dtype="fp8", device="cpu")


@pytest.mark.parametrize("quantize", [False, True], ids=["f32w", "int8w"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_paged_steps_match_jax(model, layout, quantize):
    """Two prefill chunks of one prompt, decode steps for two lanes (one
    inactive for a step), and a verify step with drafts of mixed length: the
    logits of each call within 1e-4 of JAX's, on identically fed pools."""
    jcfg, tcfg, jp, tp = model
    kv = LAYOUTS[layout]
    jq = tq = None
    if quantize:
        jq, tq = jdec.quantize_weights(jp), tdec.quantize_weights(tp)
    bs, NB, W = 4, 16, 8
    jpool = jdec.init_block_pool(jcfg, NB, bs, kv_dtype=kv)
    tpool = tdec.init_block_pool(tcfg, NB, bs, kv_dtype=kv, device="cpu")
    rng = np.random.default_rng(3)
    tables = np.zeros((2, W), np.int32)
    tables[0, :6] = [3, 7, 1, 9, 4, 12]
    tables[1, :5] = [3, 7, 2, 5, 10]  # lane 1 shares lane 0's first two blocks
    prompt = rng.integers(0, 64, 14).astype(np.int32)

    def close(tl, jl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)

    for start, length, c_pad in ((0, 9, 16), (9, 5, 8)):
        chunk = np.zeros(c_pad, np.int32)
        chunk[:length] = prompt[start:start + length]
        jl, jpool = jdec.paged_prefill_chunk(jp, jpool, jnp.asarray(tables[0]), jnp.asarray(chunk),
                                             jnp.int32(start), jnp.int32(length), jcfg)
        tl, tpool = tdec.paged_prefill_chunk(tp, tpool, torch.from_numpy(tables[0]).long(),
                                             torch.from_numpy(chunk).long(), start, length, tcfg)
        assert tuple(tl.shape) == (64,)
        close(tl, jl)

    pos = np.array([14, 8], np.int32)
    tok = rng.integers(0, 64, 2).astype(np.int32)
    for active in ([True, False], [True, True]):
        act = np.array(active)
        jl, jpool = jdec.paged_decode_step(jp, jpool, jnp.asarray(tables), jnp.asarray(tok),
                                           jnp.asarray(pos), jnp.asarray(act), jcfg, qweights=jq)
        tl, tpool = tdec.paged_decode_step(tp, tpool, torch.from_numpy(tables).long(),
                                           torch.from_numpy(tok).long(), torch.from_numpy(pos).long(),
                                           torch.from_numpy(act), tcfg, qweights=tq)
        assert tuple(tl.shape) == (2, 64)
        close(tl, jl)
        pos = pos + act
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)

    drafts = np.zeros((2, 4), np.int32)
    drafts[:, 0] = tok
    drafts[0, 1:] = rng.integers(0, 64, 3)
    drafts[1, 1:2] = rng.integers(0, 64, 1)
    n_tok = np.array([4, 2], np.int32)
    act = np.array([True, True])
    jl, jpool = jdec.paged_verify_step(jp, jpool, jnp.asarray(tables), jnp.asarray(drafts),
                                       jnp.asarray(pos), jnp.asarray(n_tok), jnp.asarray(act), jcfg,
                                       qweights=jq)
    tl, tpool = tdec.paged_verify_step(tp, tpool, torch.from_numpy(tables).long(),
                                       torch.from_numpy(drafts).long(), torch.from_numpy(pos).long(),
                                       torch.from_numpy(n_tok).long(), torch.from_numpy(act), tcfg,
                                       qweights=tq)
    assert tuple(tl.shape) == (2, 4, 64)
    close(tl, jl)
    # Every write that was not a real row went to trash block 0; the live
    # blocks hold the same rows on both sides.
    live = sorted(set(tables.ravel()) - {0})
    for name, leaf in tpool.items():
        ref = np.asarray(jpool[name])[:, live]
        if leaf.dtype == torch.int8:  # the same rows quantize to the same ints
            np.testing.assert_array_equal(leaf[:, live].numpy(), ref)
        else:
            np.testing.assert_allclose(leaf[:, live].numpy(), ref, atol=1e-5, rtol=0)


def _script(pg):
    """One fixed sequence of allocator, prefix-cache and rollback operations;
    returns everything observable along the way."""
    out = []
    alloc = pg.BlockAllocator(10)
    pc = pg.PrefixCache(alloc, 4)
    a = [alloc.alloc() for _ in range(3)]
    p1 = list(range(12))
    pc.offer(p1, a)
    out += [a, [alloc.refcount(b) for b in a], len(pc), pc.mutations]
    for b in a:
        alloc.decref(b)
    out += [pc.match(p1), pc.match(p1[:8] + [60, 61, 62, 63]), pc.match([9] + p1[1:]),
            pc.hits, pc.lookups, pc.misses, round(pc.hit_rate, 9)]
    b = [alloc.alloc() for _ in range(4)]
    pc.offer(p1[:4] + [50, 51, 52, 53], [a[0], b[0]])  # first writer keeps block 0's entry
    out += [b, len(pc), alloc.n_free, alloc.n_used]
    table = np.array([a[0], b[1], b[2], b[3], -1, -1], np.int32)
    out += [pg.truncate_table(table, alloc, 5, 4), table.tolist(), alloc.n_free]
    out += [pc.evict(2), pc.evictions, alloc.n_free, len(pc)]
    for blk in a + a[:2]:
        alloc.decref(blk)  # drop the matches' references
    out += [pc.evict(10), len(pc), alloc.n_free, [alloc.alloc() for _ in range(3)]]
    out += [pc.drop_all(), alloc.decref(b[0]), pc.drop_all(), alloc.refcount(b[0]), alloc.n_used]
    for bad in (lambda: alloc.decref(b[0]), lambda: alloc.incref(0), lambda: pg.BlockAllocator(1)):
        with pytest.raises(ValueError):
            bad()
    return out


def test_bookkeeping_script_matches_reference():
    assert _script(tpg) == _script(jpg)
