"""Mesh serving: ``ServingEngine(mesh=)`` on thread ranks against the JAX package.

The reference serves a mesh inside one process (GSPMD carries the weights'
sharding through the paged steps; ``tests/test_serving/test_engine.py:226-253``
holds a ``tp`` engine's tokens to ``generate``'s).  The port runs one rank a
process: the mesh's rank 0 schedules and broadcasts each device call, the
other ranks follow (``serving/engine.py``).  Here every rank is a thread
(``tests/torch_gang_ranks.py``), in float32, on the reference decode test's
model (vocab 128, d_model 32, 2 layers, 8 heads of 8, d_ff 64, max_seq 48):

- the ``tp``, ``tp_dp``, ``pp`` and ``fsdp`` engines' greedy tokens equal
  JAX's ``generate`` per request, at the reference engine test's shapes;
  under ``pp`` a rank's pool holds its stage's layers;
- the engine composes as on one card (prefix COW, speculative decoding, the
  int8 pool, a park's spill and restore, the persistent store) under
  ``tp``, ``pp`` and ``fsdp``: its tokens and counters equal a one-rank
  engine's, each rank keeps its own part of a spilled block, the leader's
  store holds whole blocks (every rank's kv heads of every stage's layers,
  gathered), and a mesh engine boots warm from it;
- a failure of the leader's call ends the followers, and a silent leader
  ends them after ``mesh_timeout_s``;
- ``lm_server`` on two thread ranks under ``tp``, ``pp`` and ``fsdp``
  answers a ``/generate`` with one rank's tokens;
- the spawner launches a rank process a card of a card plan (read without a
  card) and keeps a ``cpu*`` plan at one process a host.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import decode as jdec
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu_torch.models import decode as tdec
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel.axes import tree_shard
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.serving import kvstore
from polyaxon_tpu_torch.serving.engine import MeshAbortedError, ServingEngine
from tests.torch_gang_ranks import run_mesh_ranks

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=8, head_dim=8, d_ff=64, max_seq=48)


@functools.lru_cache(maxsize=None)
def model(seed: int = 0, n_kv_heads=None):
    kw = dict(CFG, n_kv_heads=n_kv_heads)
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **kw)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def jax_reference(prompt: tuple, max_new: int, seed: int = 0, n_kv_heads=None) -> list:
    jcfg, _, jp, _ = model(seed, n_kv_heads)
    out = jdec.generate(jp, jnp.asarray([list(prompt)]), jcfg, max_new_tokens=max_new)
    return np.asarray(out)[0].tolist()


def serve_on_mesh(axes, strategy, traffic, *, seed=0, n_kv_heads=None, quantize=False,
                  together=True, leader=None, on_engine=None, timeout=120,
                  group_timeout=None, **kw):
    """Every rank builds the engine on its shards; the leader serves
    ``traffic`` ((prompt, max_new) pairs, all submitted before start when
    ``together``, else one after another) and stops; the followers follow.
    Returns the leader's ``(tokens, stats)`` and each rank's engine."""
    _, tcfg, _, tp = model(seed, n_kv_heads)
    tq = tdec.quantize_weights(tp) if quantize else None
    engines = {}

    def rank_main(mesh, rank):
        tpl = template_for(strategy, axes)
        specs = tdec.decode_param_shardings(tcfg, mesh, tpl, params=tp)
        qspecs = tdec.quantized_weight_shardings(tcfg, mesh, tpl, tq) if quantize else None
        eng = ServingEngine(
            tree_shard(tp, specs, mesh), tcfg, mesh=mesh, param_shardings=specs,
            qweights=tdec.shard_qweights(tq, qspecs, mesh) if quantize else None,
            qweights_shardings=qspecs, device="cpu", **kw)
        engines[rank] = eng
        if on_engine is not None:
            on_engine(eng)
        if not eng.is_leader:
            eng.follow()
            return None
        if leader is not None:
            return leader(eng)
        return _serve(eng, traffic, together)

    outs = run_mesh_ranks(axes, rank_main, timeout=timeout, group_timeout=group_timeout)
    return outs[0], engines


def _serve(engine, traffic, together=True):
    """Tokens of ``traffic`` and the engine, stopped.  ``together``: every
    request submitted before start; False: one after another; a list of
    counts: phases of that many requests submitted together, each waited
    for before the next."""
    phases = ([len(traffic)] if together is True else [1] * len(traffic) if together is False
              else together)
    try:
        engine.start()
        reqs, rest = [], list(traffic)
        for n in phases:
            batch = [engine.submit(p, m) for p, m in rest[:n]]
            rest = rest[n:]
            for r in batch:
                r.done.wait(120)
            reqs += batch
        return [r.wait(timeout=120) for r in reqs], engine
    finally:
        engine.stop()


def one_rank(traffic, *, seed=0, n_kv_heads=None, quantize=False, together=True, **kw):
    _, tcfg, _, tp = model(seed, n_kv_heads)
    tq = tdec.quantize_weights(tp) if quantize else None
    eng = ServingEngine(tp, tcfg, qweights=tq, device="cpu", **kw)
    out, _ = _serve(eng, traffic, together)
    return out, eng


ENGINE_SHAPES = [(5, 8), (9, 4), (3, 12)]  # (prompt length, new tokens), test_engine.py:241


@pytest.mark.parametrize("strategy,axes,kv", [
    ("tp", {"tensor": 2}, None),
    ("tp_dp", {"data": 2, "tensor": 2}, None),
    ("tp", {"tensor": 4}, 2),
    ("pp", {"pipeline": 2}, None),
    ("fsdp", {"data": 2}, None),
], ids=["tp-2", "tp_dp-2x2", "tp-4-gqa2", "pp-2", "fsdp-2"])
def test_mesh_engine_tokens_equal_jax_generate(strategy, axes, kv):
    rng = np.random.default_rng(9)
    traffic = [([int(x) for x in rng.integers(0, 64, t)], n) for t, n in ENGINE_SHAPES]
    (outs, leader), engines = serve_on_mesh(axes, strategy, traffic, n_kv_heads=kv, slots=2,
                                            max_len=48, warmup=True)
    for (prompt, n), out in zip(traffic, outs):
        assert out == jax_reference(tuple(prompt), n, 0, kv)
    for eng in engines.values():
        stats = eng.stats()
        assert stats["steady_state_compiles"] == 0
        assert stats["mesh"]["ranks"] == len(engines)
    s = leader.stats()
    assert s["mesh"]["role"] == "leader" and s["mesh"]["descriptors"] > 0
    kv_heads, tensor, stages = kv or CFG["n_heads"], axes.get("tensor", 1), axes.get("pipeline", 1)
    ranks_kv = engines[1]._pool["k"].shape[3]
    assert ranks_kv == (kv_heads // tensor if kv_heads % tensor == 0 else kv_heads)
    assert engines[1]._pool["k"].shape[0] == CFG["n_layers"] // stages
    assert s["kv_pool_bytes"] == s["kv_pool_rank_bytes"] * kv_heads // ranks_kv * stages
    assert "mesh_descriptor_s" in leader.latency_summaries()


def _composed_traffic():
    """A prompt whose blocks the cache publishes, the whole prefix again (a
    full hit: COW), then three together on a pool too small for them (parks,
    spills, restores; the repeating prompt drafts)."""
    rng = np.random.default_rng(33)
    pre = [int(x) for x in rng.integers(0, 64, 8)]
    loop = [5, 9, 3, 7] * 4
    return [(pre + [1, 2, 3], 6), (pre, 5), (loop, 10),
            ([int(x) for x in rng.integers(0, 64, 20)], 8), (pre + [4], 6)]


PHASES = [1, 1, 3]


COMPOSED = dict(slots=2, max_len=48, block_size=4, num_blocks=13, prefix_cache=True,
                spec_decode=True, spec_k=3, spec_min_ngram=2, kv_offload=True, warmup=True,
                kv_persist_sig="w1")


#: The templates the mesh engine composes under: (strategy, axes, the
#: dimension a rank's part of a block is half of: kv heads 2, layers 0).
COMPOSE_CASES = {"tp": ("tp", {"tensor": 2}, 2), "pp": ("pp", {"pipeline": 2}, 0),
                 "fsdp": ("fsdp", {"data": 2}, None)}


@pytest.mark.parametrize("kvq", [None, "int8"])
@pytest.mark.parametrize("case", list(COMPOSE_CASES))
def test_mesh_engine_composes_like_one_rank(case, kvq, tmp_path):
    """Prefix COW, speculation, a park's spill and restore and the store,
    under ``tp {tensor: 2}``, ``pp {pipeline: 2}`` and ``fsdp {data: 2}``:
    the leader's tokens and counters are one rank's (itself JAX's,
    ``test_torch_kv_offload.py``); each rank held its own part of each
    spilled block (half its kv heads under ``tp``, its stage's layers under
    ``pp``, all of it under ``fsdp``); the store's blocks are whole (each
    rank's part, gathered: the rank's pool rows bit for bit), signed and
    shaped as one rank's store, and a mesh engine boots warm from it."""
    strategy, axes, halved = COMPOSE_CASES[case]
    traffic = _composed_traffic()
    kw = dict(COMPOSED, kv_quantize=kvq)
    spilled = []

    def watch(eng):  # the follower's exports: its own kv heads of each block
        if not eng.is_leader:
            export = eng._export_op

            def exporting(blocks):
                out = export(blocks)
                spilled.extend(out)
                return out

            eng._ops["export"] = exporting

    (outs, lead), engines = serve_on_mesh(axes, strategy, traffic, together=PHASES,
                                          on_engine=watch,
                                          kv_persist_dir=str(tmp_path / "mesh"), **kw)
    ref, one = one_rank(traffic, together=PHASES, kv_persist_dir=str(tmp_path / "one"), **kw)
    assert outs == ref
    s, r = lead.stats(), one.stats()
    for key in ("prefix_cache_hits", "cow_copies", "block_parks", "host_spilled_blocks_total",
                "host_restored_blocks_total", "spec_steps", "spec_accepted_total",
                "kv_persisted_blocks", "requests_shed", "steady_state_compiles"):
        assert s[key] == r[key], key
    assert s["cow_copies"] > 0 and s["block_parks"] > 0 and s["spec_accepted_total"] > 0
    assert s["host_spilled_blocks_total"] > 0 and s["kv_persisted_blocks"] > 0
    whole = {name: leaf[:, 0].shape for name, leaf in one._pool.items()}
    assert spilled and all(
        t.shape == tuple(n // 2 if dim == halved else n for dim, n in enumerate(whole[name]))
        for d in spilled for name, t in d.items())
    # The follower holds its shard of exactly the blocks the leader's tier holds.
    assert set(engines[1]._held) == set(lead._host_tier._data) and not engines[1]._staged

    meta = json.loads((tmp_path / "one/1/meta.json").read_text())["meta"]
    assert json.loads((tmp_path / "mesh/1/meta.json").read_text())["meta"] == meta
    mine = kvstore.load_prefix_store(tmp_path / "mesh", expect=meta)
    ones = kvstore.load_prefix_store(tmp_path / "one", expect=meta)
    assert [c for c, _ in mine] == [c for c, _ in ones]
    for (_, got), (_, want) in zip(mine, ones):
        assert {n: (t.dtype, t.shape) for n, t in got.items()} == {
            n: (t.dtype, t.shape) for n, t in want.items()}
        for name in want:
            tol = 1e-5 if want[name].is_floating_point() else 1
            assert (got[name].float() - want[name].float()).abs().max() <= tol * max(
                1.0, float(want[name].float().abs().max()))

    # Booting warm from the mesh's store: the preload scatters each rank's
    # heads, and the tokens stay one rank's.
    (warm, wl), _ = serve_on_mesh(axes, strategy, traffic, together=PHASES,
                                  kv_persist_dir=str(tmp_path / "mesh"), **kw)
    assert warm == ref and wl.stats()["kv_preloaded_blocks"] > 0


@pytest.mark.parametrize("strategy,axes", [
    ("tp", {"data": 2, "tensor": 2}), ("pp_tp", {"pipeline": 2, "tensor": 2})],
    ids=["tp-2x2", "pp_tp-2x2"])
def test_the_store_holds_every_ranks_heads_bit_for_bit(strategy, axes, tmp_path):
    """A block the leader persists is the ranks' pool rows of that block,
    concatenated over the kv heads in the tensor axis's order and, under a
    pipeline, over the stages' layers in stage order: every layer of every
    stage, bit for bit."""
    traffic = _composed_traffic()[:2]
    kw = dict(slots=2, max_len=48, block_size=4, prefix_cache=True, warmup=False,
              kv_persist_sig="w1", kv_persist_dir=str(tmp_path))
    (_, lead), engines = serve_on_mesh(axes, strategy, traffic, together=False, **kw)
    blocks = {chain: block for chain, block, _ in lead.prefix_cache.hottest_chains(64)}
    meta = lead._kv_store_meta()
    stored = kvstore.load_prefix_store(tmp_path, expect=meta)
    assert stored and meta["kv_heads"] == CFG["n_heads"]
    # Rank r lies at (outer, tensor) = divmod(r, 2): the data replica or the stage.
    stage_of = {r: divmod(r, 2)[0] if "pipeline" in axes else 0 for r in range(4)}
    for chain, data in stored:
        b = blocks[chain]
        for name, t in data.items():
            assert t.shape[0] == CFG["n_layers"]
            rows = {r: engines[r]._pool[name][:, b] for r in range(4)}
            stages = [torch.cat([rows[r] for r in range(4) if stage_of[r] == s][:2], dim=2)
                      for s in sorted(set(stage_of.values()))]
            assert torch.equal(t, torch.cat(stages, dim=0))
            if "pipeline" not in axes:
                assert torch.equal(rows[2], rows[0])  # data replica


def test_a_failed_leader_call_ends_the_followers():
    """The leader's chunk call fails after its descriptor went out, before
    its first collective: the follower's call meets its group's timeout (5 s
    here), then the leader's ``abort``, and ends naming the leader's failure;
    every later call of the leader raises at once."""
    traffic = [([1, 2, 3], 4)]

    def leader(eng):
        real = eng._ops["entry"]

        def failing(kind, key, host):
            if kind == "chunk":
                raise RuntimeError("injected failure")
            return real(kind, key, host)

        eng._ops["entry"] = failing
        eng.start()
        try:
            req = eng.submit(*traffic[0])
            with pytest.raises(RuntimeError, match="injected failure"):
                req.wait(timeout=60)
            with pytest.raises(MeshAbortedError, match="closed"):
                eng._device("ping")
        finally:
            eng.stop()
        return eng

    t0 = time.monotonic()
    with pytest.raises(MeshAbortedError, match="leader aborted.*injected failure"):
        serve_on_mesh({"tensor": 2}, "tp", traffic, leader=leader, slots=1, max_len=48,
                      warmup=False, timeout=60, group_timeout=5)
    assert time.monotonic() - t0 < 30


def test_a_silent_leader_ends_the_followers_after_the_timeout():
    def leader(eng):
        return eng  # never starts: no descriptor ever goes out

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="no descriptor"):
        serve_on_mesh({"tensor": 2}, "tp", [], leader=leader, slots=1, max_len=48,
                      warmup=False, mesh_timeout_s=2.0, timeout=60)
    assert time.monotonic() - t0 < 30


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("strategy,axes", [
    ("tp", {"tensor": 2}), ("pp", {"pipeline": 2}), ("fsdp", {"data": 2})],
    ids=["tp", "pp", "fsdp"])
def test_lm_server_on_two_ranks_answers_with_one_ranks_tokens(strategy, axes):
    from polyaxon_tpu_torch.builtins.services import lm_server
    from polyaxon_tpu_torch.tracking.context import Context

    small = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64)
    port = _free_port()
    prompt = [3, 1, 4, 1, 5]
    params = dict(small, seq=48, slots=2, block_size=8, host="127.0.0.1", device="cpu",
                  service_port=port, max_new_tokens=6)
    answer = {}

    def rank_main(mesh, rank):
        ctx = Context(params=dict(params), process_id=rank, num_processes=2, num_hosts=1,
                      mesh=mesh, strategy=strategy, seed=4, records=[])
        if rank == 0:
            def client():
                try:
                    for _ in range(600):
                        try:
                            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                        timeout=5) as r:
                                if json.loads(r.read())["state"] == "ready":
                                    break
                        except OSError:
                            time.sleep(0.1)
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/generate",
                        data=json.dumps({"prompts": [prompt]}).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=60) as r:
                        answer.update(json.loads(r.read()))
                finally:
                    ctx.stop.set()

            threading.Thread(target=client, daemon=True).start()
        lm_server(ctx)
        return ctx.records

    records = run_mesh_ranks(axes, rank_main, timeout=120)
    # One rank's lm_server: the same seeded weights (bf16, as lm_server's
    # config), one card's engine; its tokens are generate's
    # (test_torch_lm_http.py).
    tcfg = ttr.TransformerConfig(max_seq=48, **small)
    ref_params = ttr.init_params(tcfg, torch.Generator().manual_seed(4))
    want = tdec.generate(ref_params, torch.tensor([prompt]), tcfg, max_new_tokens=6,
                         device="cpu")[0].tolist()
    assert answer["tokens"] == [want]
    lines = [r["line"] for r in records[0]]
    assert any("sharded over" in line for line in lines), lines
    assert any("following the leader" in r["line"] for r in records[1])


def test_the_spawner_launches_a_rank_process_a_card(tmp_path):
    """A 1-host, 2-card plan: two processes, ``LOCAL_RANK`` 0 and 1 of 2, one
    world of 2, a device each, the handle's plan counting both (the JAX
    watcher reads ``range(plan.num_hosts)``); a ``cpu*`` plan keeps one
    process a host with all its devices."""
    from polyaxon_tpu_torch.compiler.service import compile_gang_plan
    from polyaxon_tpu_torch.runtime.env import GangInfo
    from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun, rank_plan
    from polyaxon_tpu_torch.stores.layout import StoreLayout

    spec = {"kind": "service", "run": {"entrypoint": "m:f"},
            "environment": {"topology": {"accelerator": "h100", "num_devices": 2,
                                         "num_hosts": 1, "strategy": "tp",
                                         "mesh": {"tensor": 2}}}}
    spawner = LocalGangSpawner(StoreLayout(tmp_path))
    run = LocalRun(spec)
    plan = compile_gang_plan(spec)
    assert (plan.num_hosts, plan.devices_per_host) == (1, 2)
    ranks = rank_plan(plan)
    assert (ranks.num_hosts, ranks.devices_per_host) == (2, 1)
    paths = spawner.layout.run_paths(run.uuid)
    coordinator = spawner._coordinator(run, ranks)
    assert coordinator is not None
    envs = [spawner._process_env(run, plan, paths, i, coordinator) for i in range(2)]
    infos = [GangInfo.from_env({k: v for k, v in env.items() if v is not None})
             for env in envs]
    assert [(e["LOCAL_RANK"], e["LOCAL_WORLD_SIZE"], e["GROUP_RANK"], e["GROUP_WORLD_SIZE"])
            for e in envs] == [("0", "2", "0", "1"), ("1", "2", "0", "1")]
    assert [(i.process_id, i.num_processes, i.devices_per_host) for i in infos] == [
        (0, 2, 1), (1, 2, 1)]
    assert infos[0].mesh_axes == {"tensor": 2} and infos[0].accelerator == "h100"

    cpu = dict(spec, environment={"topology": {"accelerator": "cpu", "num_devices": 8,
                                               "num_hosts": 1}})
    cplan = compile_gang_plan(cpu)
    assert rank_plan(cplan) is cplan
    env = spawner._process_env(LocalRun(cpu), cplan, paths, 0, None)
    info = GangInfo.from_env({k: v for k, v in env.items() if v is not None})
    assert (info.num_processes, info.devices_per_host) == (1, 8)
    assert (env["LOCAL_WORLD_SIZE"], env["GROUP_WORLD_SIZE"]) == ("1", "1")
