"""The port's search managers against the JAX package's.

- grid, random and hyperband: the same suggestions (values and types) and
  the same bracket math, on the reference's
  ``tests/test_hpsearch/test_search_managers.py`` configurations;
- BO: the port fits its own Gaussian process (numpy and scipy) where the
  reference fits scikit-learn's ``GaussianProcessRegressor``.  On the
  reference's ``TestBO`` cases, and on RBF and Matern kernels with ``nu``
  0.5, 1.5, 2.5 and 0.7 (the ``kv`` path), the posterior mean and standard
  deviation at 64 points are within 1e-8 relative of scikit-learn's at
  ``n_restarts_optimizer=0``; the fitted ``log(length_scale)`` within 1e-4
  at ``n_restarts_optimizer=2``; and the next suggestion within 1e-6 of
  each bound's span.  scikit-learn is imported on the reference's side only.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest

from polyaxon_tpu.hpsearch import search_managers as jsm
from polyaxon_tpu.schemas.hptuning import HPTuningConfig as JHPTuningConfig
from polyaxon_tpu_torch.hpsearch import search_managers as sm
from polyaxon_tpu_torch.schemas.hptuning import HPTuningConfig

HYPERBAND = {"max_iterations": 81, "eta": 3,
             "resource": {"name": "epochs", "optimization": "maximize"},
             "metric": {"name": "loss", "optimization": "minimize"}, "seed": 1}
CONFIGS = {
    "grid": {"matrix": {"lr": {"values": [0.1, 0.2]}, "units": {"range": [10, 30, 10]}},
             "grid_search": {}},
    "grid-capped": {"matrix": {"lr": {"values": [1, 2, 3, 4, 5]}},
                    "grid_search": {"n_experiments": 3}},
    "grid-spaces": {"matrix": {"a": {"linspace": "0:1:3"}, "b": {"logspace": "0:2:3"},
                               "c": {"geomspace": "1:8:4"}, "d": {"values": ["x", "y"]}},
                    "grid_search": {}},
    "random": {"matrix": {"lr": {"uniform": [0, 1]}, "act": {"values": ["relu", "gelu"]}},
               "random_search": {"n_experiments": 10, "seed": 7}},
    "random-every-op": {"matrix": {"a": {"quniform": [0, 1, 0.25]}, "b": {"loguniform": [1e-4, 1]},
                                   "c": {"qloguniform": [1, 100, 5]}, "d": {"normal": [0, 1]},
                                   "e": {"qnormal": [0, 1, 0.5]}, "f": {"lognormal": [0, 1]},
                                   "g": {"qlognormal": [0, 1, 0.5]},
                                   "h": {"pvalues": [["a", 0.9], ["b", 0.1]]},
                                   "i": {"range": [0, 10, 3]}},
                        "random_search": {"n_experiments": 6}, "seed": 11},
    "hyperband": {"matrix": {"lr": {"uniform": [0, 1]}}, "hyperband": HYPERBAND},
    "hyperband-eta2": {"matrix": {"lr": {"uniform": [0, 1]}, "u": {"values": [1, 2]}},
                       "hyperband": dict(HYPERBAND, max_iterations=4, eta=2)},
}


def both(name):
    return (sm.get_search_manager(HPTuningConfig.from_dict(CONFIGS[name])),
            jsm.get_search_manager(JHPTuningConfig.model_validate(CONFIGS[name])))


def _typed(suggestions):
    return [{k: (type(v).__name__, v) for k, v in s.items()} for s in suggestions]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_suggestions_equal_the_reference(name):
    port, ref = both(name)
    assert type(port).__name__ == type(ref).__name__
    for iteration in range(3):
        data = {"iteration": iteration}
        assert _typed(port.get_suggestions(data)) == _typed(ref.get_suggestions(data))


@pytest.mark.parametrize("name", ["hyperband", "hyperband-eta2"])
def test_hyperband_brackets_equal_the_reference(name):
    port, ref = both(name)
    assert (port.s_max, port.B) == (ref.s_max, ref.B)
    for it in range(port.s_max + 1):
        bracket = port.get_bracket(it)
        assert bracket == ref.get_bracket(it)
        assert port.get_n_configs(bracket) == ref.get_n_configs(bracket)
        assert port.get_resources_for_iteration(it) == ref.get_resources_for_iteration(it)
        for bi in range(port.s_max + 2):
            assert port.get_n_config_to_keep_for_iteration(it, bi) == \
                ref.get_n_config_to_keep_for_iteration(it, bi)
            assert port.should_reduce_configs(it, bi) == ref.should_reduce_configs(it, bi)
            assert port.should_reschedule(it, bi) == ref.should_reschedule(it, bi)
    rng = np.random.default_rng(5)
    configs = [{"lr": float(v)} for v in rng.uniform(size=9)]
    metrics = [float(v) for v in rng.normal(size=9)]
    metrics[3] = None
    for it, bi in ((0, 0), (1, 0), (0, 1)):
        assert _typed(port.reduce_configs(it, bi, configs, metrics)) == \
            _typed(ref.reduce_configs(it, bi, configs, metrics))
    if name == "hyperband":  # the reference test's concrete figures
        assert [port.get_n_configs(port.get_bracket(i)) for i in range(5)] == [81, 34, 15, 8, 5]
        assert [port.get_resources_for_iteration(i) for i in range(5)] == [1, 3, 9, 27, 81]


def test_grid_refuses_a_continuous_param_and_the_space_round_trips():
    with pytest.raises(sm.SearchError):
        sm.GridSearchManager(HPTuningConfig.from_dict(
            {"matrix": {"lr": {"uniform": [0, 1]}}, "grid_search": {}})).get_suggestions()
    matrix = {"lr": {"uniform": [0.001, 0.1]}, "units": {"values": [32, 64, 128]},
              "act": {"values": ["relu", "tanh"]}}
    port = sm.SearchSpace(HPTuningConfig.from_dict({"matrix": matrix}).matrix)
    ref = jsm.SearchSpace(JHPTuningConfig.model_validate({"matrix": matrix}).matrix)
    assert port.bounds == ref.bounds and port.dim == ref.dim
    s = {"lr": 0.01, "units": 64, "act": "tanh"}
    assert port.to_vector(s).tolist() == ref.to_vector(s).tolist()
    vecs = port.sample_vectors(5, np.random.default_rng(2))
    assert vecs.tolist() == ref.sample_vectors(5, np.random.default_rng(2)).tolist()
    assert [port.to_suggestion(v) for v in vecs] == [ref.to_suggestion(v) for v in vecs]


# -- BO -----------------------------------------------------------------------

def _bo(metric_opt="maximize", acquisition="ucb", gp=None, matrix=None, seed=0):
    return {"matrix": matrix or {"lr": {"uniform": [0, 1]}},
            "bo": {"n_initial_trials": 5, "n_iterations": 3, "seed": seed,
                   "metric": {"name": "score", "optimization": metric_opt},
                   "utility_function": {"acquisition_function": acquisition, "n_warmup": 400,
                                        "n_iter": 5, "gaussian_process": gp or {}}}}


def _grid5(c):
    return -((c["lr"] - 0.7) ** 2)


#: (hptuning, configs, metrics): the reference's TestBO cases, then kernels.
BO_CASES = {
    "concrete-ei": (_bo(acquisition="ei"), [{"lr": v} for v in (0.0, 0.25, 0.5, 0.75, 1.0)],
                    "peak"),
    "minimize-ucb": (_bo("minimize"), [{"lr": v} for v in (0.1, 0.5, 0.9)], "bowl"),
    "poi": (_bo(acquisition="poi"), [{"lr": v} for v in (0.0, 0.3, 0.6, 0.9)], "peak"),
    "rbf": (_bo(gp={"kernel": "rbf", "length_scale": 0.3}),
            [{"lr": v} for v in (0.05, 0.4, 0.45, 0.8)], "peak"),
    "matern-0.5": (_bo(gp={"nu": 0.5}), [{"lr": v} for v in (0.1, 0.2, 0.9)], "peak"),
    "matern-2.5": (_bo(gp={"nu": 2.5, "length_scale": 2.0}),
                   [{"lr": v} for v in (0.1, 0.2, 0.9)], "peak"),
    "matern-0.7": (_bo(gp={"nu": 0.7}), [{"lr": v} for v in (0.1, 0.5, 0.9)], "peak"),
    "mixed-space": (_bo(matrix={"lr": {"uniform": [0.001, 0.1]},
                                "units": {"values": [32, 64, 128]},
                                "act": {"values": ["relu", "tanh"]}}),
                    [{"lr": 0.01, "units": 32, "act": "relu"},
                     {"lr": 0.05, "units": 128, "act": "tanh"},
                     {"lr": 0.09, "units": 64, "act": "relu"}], "mixed"),
    "constant-metric": (_bo(), [{"lr": v} for v in (0.2, 0.6)], "flat"),
}


def _metrics(kind, configs):
    if kind == "peak":
        return [_grid5(c) for c in configs]
    if kind == "bowl":
        return [(c["lr"] - 0.3) ** 2 for c in configs]
    if kind == "mixed":
        return [c["lr"] * 10 + (c["act"] == "tanh") - c["units"] / 100 for c in configs]
    return [1.0 for _ in configs]


def _observed(manager, configs, metrics):
    """The (x, y) that ``get_suggestions`` fits, as the reference makes it."""
    x = np.stack([manager.space.to_vector(c) for c in configs])
    y = np.array(metrics, dtype=float)
    if manager.config.metric.optimization == "minimize":
        y = -y
    return x, y


def _pair(name, restarts):
    doc, configs, kind = BO_CASES[name]
    doc = {**doc, "bo": {**doc["bo"], "utility_function": {
        **doc["bo"]["utility_function"],
        "gaussian_process": {**doc["bo"]["utility_function"]["gaussian_process"],
                             "n_restarts_optimizer": restarts}}}}
    port = sm.BOSearchManager(HPTuningConfig.from_dict(doc))
    ref = jsm.BOSearchManager(JHPTuningConfig.model_validate(doc))
    return port, ref, configs, _metrics(kind, configs)


@pytest.mark.parametrize("name", list(BO_CASES))
def test_the_gp_posterior_equals_sklearns(name):
    pytest.importorskip("sklearn")
    port, ref, configs, metrics = _pair(name, 0)
    x, y = _observed(port, configs, metrics)
    gp, jgp = port.utility._gp().fit(x, y), ref.utility._gp().fit(x, y)
    query = port.space.sample_vectors(64, np.random.default_rng(9))
    mean, std = gp.predict(query, return_std=True)
    jmean, jstd = jgp.predict(query, return_std=True)
    np.testing.assert_allclose(mean, jmean, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(std, jstd, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gp.predict(query), jgp.predict(query), rtol=1e-8, atol=1e-12)
    acq = port.utility.acquisition(gp, query, float(np.max(y)))
    np.testing.assert_allclose(acq, ref.utility.acquisition(jgp, query, float(np.max(y))),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("name", ["concrete-ei", "minimize-ucb", "rbf", "matern-0.5",
                                  "matern-0.7", "mixed-space"])
def test_a_fitted_length_scale_equals_sklearns(name):
    pytest.importorskip("sklearn")
    port, ref, configs, metrics = _pair(name, 2)
    x, y = _observed(port, configs, metrics)
    gp, jgp = port.utility._gp().fit(x, y), ref.utility._gp().fit(x, y)
    assert abs(gp.log_length_scale - float(jgp.kernel_.theta[0])) < 1e-4
    query = port.space.sample_vectors(16, np.random.default_rng(3))
    np.testing.assert_allclose(gp.predict(query), jgp.predict(query), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", list(BO_CASES))
def test_the_next_bo_suggestion_equals_the_reference(name):
    pytest.importorskip("sklearn")
    port, ref, configs, metrics = _pair(name, 0)
    data = {"configs": configs, "metrics": metrics}
    (got,), (want,) = port.get_suggestions(data), ref.get_suggestions(data)
    assert got.keys() == want.keys()
    for k in port.space.names:
        m = port.hptuning.matrix[k]
        if m.is_continuous:
            assert abs(got[k] - want[k]) <= 1e-6 * (m.max - m.min), (k, got[k], want[k])
        else:
            assert got[k] == want[k]
    assert port.get_suggestions({}) == ref.get_suggestions({})  # the seed round
    unobserved = {"configs": configs, "metrics": [None] * len(configs)}
    assert port.get_suggestions(unobserved) == ref.get_suggestions(unobserved)
    if name == "concrete-ei":
        assert 0.5 < got["lr"] < 0.9
