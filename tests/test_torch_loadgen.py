"""The port's load generator against the JAX package's.

The prompt builders must give the JAX builders' prompt lists for the same
seeds and ``_pct`` the JAX percentile.  ``poisson_load`` drives the port's
engine on the CPU and the JAX engine with the same prompts, rate and seed:
every request completes, with the same greedy tokens, request by request.
``http_poisson_load`` against ``lm_server``'s handler over each engine gives
the same typed outcomes.  The model is the reference tests' small float32
one (vocab 64, d_model 32, 2 layers, 4 heads x 8, d_ff 64, max_seq 48).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.builtins.services import _make_lm_handler as jax_handler
from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu.serving import ServingEngine as JaxEngine
from polyaxon_tpu.serving import loadgen as jlg
from polyaxon_tpu_torch.builtins.services import _make_lm_handler as port_handler
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.serving import ServingEngine
from polyaxon_tpu_torch.serving import loadgen as tlg

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64, max_seq=48)
JCFG = jtr.TransformerConfig(dtype=jnp.float32, **SMALL)
TCFG = ttr.TransformerConfig(dtype=torch.float32, **SMALL)
ENGINE = dict(slots=3, max_len=48, block_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def params():
    jp = jtr.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_prompt_builders_equal_the_jax_builders(seed):
    for kw in (dict(prefix_len=12, suffix_len=5), dict(prefix_len=0, suffix_len=9, groups=2)):
        assert (tlg.shared_prefix_prompts(10, 64, seed=seed, **kw)
                == jlg.shared_prefix_prompts(10, 64, seed=seed, **kw))
    for kw in ({}, dict(n_templates=2, header_len=5, motif_len=3, rows=6, field_len=1)):
        assert tlg.templated_prompts(9, 64, seed=seed, **kw) == jlg.templated_prompts(
            9, 64, seed=seed, **kw)
    for fn in (tlg.shared_prefix_prompts, jlg.shared_prefix_prompts):
        with pytest.raises(ValueError, match="groups"):
            fn(0, 64, prefix_len=1, suffix_len=1, seed=seed)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 24, 100])
def test_pct_equals_the_jax_pct(n):
    vals = sorted(np.random.default_rng(n).exponential(1.0, n).tolist())
    for q in (0, 1, 50, 95, 99, 100):
        assert tlg._pct(vals, q) == jlg._pct(vals, q)


class _Recorder:
    """An engine whose submitted requests are kept in submission order."""

    def __init__(self, engine):
        self.engine, self.requests = engine, []

    def submit(self, *args):
        req = self.engine.submit(*args)
        self.requests.append(req)
        return req


def _loaded(engine, prompts):
    rec = _Recorder(engine.start())
    try:
        res = tlg.poisson_load(rec, prompts, 5, rate_rps=200.0, seed=17, timeout_s=120)
        return res, [r.tokens for r in rec.requests]
    finally:
        engine.stop()


def test_poisson_load_completes_with_the_jax_engine_tokens(params):
    jp, tp = params
    rng = np.random.default_rng(5)
    # bench.py's loaded mix at this size: every third prompt long.
    prompts = [rng.integers(0, 64, 30 if i % 3 == 0 else 6).tolist() for i in range(9)]
    res, port_tokens = _loaded(ServingEngine(tp, TCFG, device="cpu", **ENGINE), prompts)
    _, jax_tokens = _loaded(JaxEngine(jp, JCFG, warmup=False, **ENGINE), prompts)
    assert res["completed"] == res["n_requests"] == len(prompts)
    assert res["errors"] == res["sheds"] == 0 and res["total_tokens"] == 5 * len(prompts)
    assert len(res["ttft_s"]) == len(prompts) and None not in res["ttft_s"]
    assert res["ttft_p50_s"] <= res["ttft_p99_s"] and res["tokens_per_s"] > 0
    assert port_tokens == jax_tokens


def _serve_http(handler_factory, engine, cfg):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler_factory(
        engine, cfg, {"checkpoint_step": None, "default_max_new": 4}))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _http_outcomes(handler_factory, engine, cfg, prompts):
    httpd, base = _serve_http(handler_factory, engine.start(), cfg)
    try:
        return tlg.http_poisson_load(base, prompts, 4, rate_rps=100.0, seed=3, timeout_s=120)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def test_http_poisson_load_gives_the_jax_server_outcomes(params):
    jp, tp = params
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 64, t).tolist() for t in (5, 17, 9, 3, 26)]
    prompts += [[1, 99], [1] * 45]  # out of vocabulary; past max_len: both 400
    port = _http_outcomes(port_handler, ServingEngine(tp, TCFG, device="cpu", **ENGINE),
                          TCFG, prompts)
    ref = _http_outcomes(jax_handler, JaxEngine(jp, JCFG, warmup=False, **ENGINE), JCFG,
                         prompts)
    assert port["outcomes"] == ref["outcomes"] == ["completed"] * 5 + ["error:bad_request"] * 2
    for key in ("completed", "sheds", "errors", "failures", "hangs", "total_tokens"):
        assert port[key] == ref[key], key
    # Both servers trace every request (the knob's default): a trace id for
    # each completed request, none for the refused ones, and the same
    # waterfall keys among the slowest.
    assert [t is None for t in port["trace_ids"]] == [t is None for t in ref["trace_ids"]]
    assert [t is None for t in port["trace_ids"]] == [False] * 5 + [True] * 2
    assert len(port["slow_requests"]) == len(ref["slow_requests"]) > 0
    for mine, theirs in zip(port["slow_requests"], ref["slow_requests"]):
        assert set(mine) == set(theirs) and set(mine["waterfall"]) == set(theirs["waterfall"])


def test_fleet_and_chaos_are_not_ported():
    """Once the check that these raised (they waited for the fleet); the
    fault schedule and the chaos load are ported now, so it holds that they
    run: a kill and a stall fire against a fleet stand-in, and
    ``chaos_poisson_load`` accounts for every arrival.  Their parity with the
    JAX package's is in ``test_torch_loadgen_chaos.py``."""

    class Fleet:
        def __init__(self):
            self.calls = []

        def chaos_target(self):
            return "r0"

        def kill_replica(self, name):
            self.calls.append(("kill", name))

        def stall_replica(self, name):
            self.calls.append(("stall", name))

    fleet = Fleet()
    res = tlg.http_poisson_load("http://127.0.0.1:1", [[1]] * 3, 1, rate_rps=20.0,
                                kill_at_s={"r0": 0.0}, stall_at_s={"r1": 0.0}, fleet=fleet)
    assert sorted(fleet.calls) == [("kill", "r0"), ("stall", "r1")]
    assert res["failures"] == 3 and res["hangs"] == 0  # nothing listens on port 1
    res = tlg.chaos_poisson_load("http://127.0.0.1:1", [[1]], 1, phases=[(0.3, 10.0)],
                                 events=[tlg.ChaosEvent(0.1, "kill")], fleet=fleet, seed=3)
    assert fleet.calls[-1] == ("kill", "r0")
    assert res["failures"] == res["n_requests"] > 0 and res["hangs"] == 0


def test_chaos_schedule_equals_the_jax_schedule():
    phases = [(2.0, 5.0), (1.0, 0.0), (3.0, 9.0)]
    for seed in (0, 4):
        t_events = [tlg.ChaosEvent(0.5, "burst", n=3), tlg.ChaosEvent(1.5, "kill")]
        j_events = [jlg.ChaosEvent(0.5, "burst", n=3), jlg.ChaosEvent(1.5, "kill")]
        assert tlg.chaos_schedule(phases, seed=seed, events=t_events) == jlg.chaos_schedule(
            phases, seed=seed, events=j_events)
    with pytest.raises(ValueError, match="resume"):
        tlg.ChaosEvent(1.0, "resume")
