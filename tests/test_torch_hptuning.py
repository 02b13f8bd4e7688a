"""The port's matrix, hptuning, group and pipeline schemas against the JAX
package's.

- ``MatrixConfig``: every case of the reference's
  ``tests/test_schemas/test_matrix.py``, run on both packages, and each op's
  ``sample`` bit for bit equal under the same numpy ``Generator`` seed (the
  reference's calls in the reference's order), with its introspection
  (``min``, ``max``, ``length``, the kinds) and ``to_numpy``;
- ``HPTuningConfig``: documents that pydantic's lax mode accepts or refuses
  (bounds, coercions, choices, unknown keys, the section-wide rules), the
  same outcome on both sides and the same ``to_dict``;
- group and pipeline specifications through ``PolyaxonFile`` (the
  reference's ``tests/test_schemas/test_specifications.py`` group and
  pipeline cases), and a group's trials materialised from the same
  suggestions equal the reference's.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json

import numpy as np
import pytest

from polyaxon_tpu.exceptions import PolyaxonTPUError as JError
from polyaxon_tpu.schemas import PolyaxonFile as JPolyaxonFile
from polyaxon_tpu.schemas.hptuning import HPTuningConfig as JHPTuningConfig
from polyaxon_tpu.schemas.matrix import MatrixConfig as JMatrixConfig
from polyaxon_tpu_torch.compiler.service import compile_spec
from polyaxon_tpu_torch.exceptions import PolyaxonTPUError, SchemaError
from polyaxon_tpu_torch.schemas import (
    GroupSpecification,
    HPTuningConfig,
    Kinds,
    MatrixConfig,
    PipelineSpecification,
    PolyaxonFile,
)

# -- the matrix ---------------------------------------------------------------

#: Every op in each of its argument forms (the reference test's cases).
MATRICES = {
    "values": {"values": [1, 2, 3]},
    "values-categorical": {"values": ["adam", "sgd"]},
    "values-mixed": {"values": [1, "a", 2.5]},
    "range-list": {"range": [0, 10, 2]},
    "range-str": {"range": "0:10:2"},
    "range-dict": {"range": {"start": 0, "stop": 10, "step": 2}},
    "range-negative": {"range": [10, 0, -3]},
    "linspace": {"linspace": "0:1:5"},
    "logspace": {"logspace": "0:2:3"},
    "geomspace": {"geomspace": "1:64:4"},
    "pvalues": {"pvalues": [["a", 0.9], ["b", 0.1]]},
    "uniform": {"uniform": [0.1, 0.9]},
    "uniform-dict": {"uniform": {"low": 0.1, "high": 0.9}},
    "quniform": {"quniform": [0, 1, 0.25]},
    "loguniform": {"loguniform": [1e-5, 1e-1]},
    "qloguniform": {"qloguniform": "1:100:5"},
    "normal": {"normal": [0, 1]},
    "normal-dict": {"normal": {"loc": 0, "scale": 1}},
    "qnormal": {"qnormal": [0, 1, 0.5]},
    "lognormal": {"lognormal": [0, 1]},
    "qlognormal": {"qlognormal": [0, 1, 0.5]},
}
REFUSED_MATRICES = {
    "unknown-op": {"bogus": [1, 2]},
    "two-ops": {"values": [1], "uniform": [0, 1]},
    "no-op": {},
    "not-a-mapping": [1, 2],
    "empty-values": {"values": []},
    "values-not-a-list": {"values": 3},
    "zero-step-range": {"range": [0, 10, 0]},
    "range-two-elements": {"range": [0, 10]},
    "range-non-numeric": {"range": "a:b:c"},
    "range-missing-key": {"range": {"start": 0, "stop": 10}},
    "range-scalar": {"range": 5},
    "linspace-zero-num": {"linspace": [0, 1, 0]},
    "pvalues-sum": {"pvalues": [["a", 0.5], ["b", 0.1]]},
    "pvalues-not-pairs": {"pvalues": [["a", 0.5, 1], ["b", 0.5, 1]]},
    "uniform-three": {"uniform": [0, 1, 2]},
    "quniform-two": {"quniform": [0, 1]},
    "normal-string": {"normal": "x:y"},
}


def outcome(fn):
    """("ok", value) or ("refused", None): both packages' errors count."""
    try:
        return "ok", fn()
    except (JError, PolyaxonTPUError, ValueError, TypeError, KeyError):
        return "refused", None


def _introspect(m):
    out = {k: getattr(m, k) for k in ("op", "params", "is_distribution", "is_categorical",
                                      "is_discrete", "is_continuous", "is_uniform", "min",
                                      "max", "length")}
    out["params"] = json.loads(json.dumps(out["params"]))  # tuples as lists
    out["to_dict"] = json.loads(json.dumps(m.to_dict()))
    out["grid"] = outcome(lambda: m.to_numpy().tolist())
    return out


@pytest.mark.parametrize("name", list(MATRICES))
def test_a_matrix_op_is_read_and_sampled_as_the_reference_does(name):
    doc = MATRICES[name]
    port, ref = MatrixConfig.from_dict(doc), JMatrixConfig.from_dict(doc)
    assert _introspect(port) == _introspect(ref)
    draws = [[m.sample(np.random.default_rng(seed)) for seed in range(8)] for m in (port, ref)]
    rng_p, rng_r = np.random.default_rng(123), np.random.default_rng(123)
    draws += [[port.sample(rng_p) for _ in range(50)], [ref.sample(rng_r) for _ in range(50)]]
    assert draws[0] == draws[1] and draws[2] == draws[3]  # bit for bit
    assert [type(v) for v in draws[2]] == [type(v) for v in draws[3]]
    assert MatrixConfig.from_dict(port.to_dict()) == port


@pytest.mark.parametrize("name", list(REFUSED_MATRICES))
def test_a_matrix_document_the_reference_refuses_is_refused(name):
    doc = REFUSED_MATRICES[name]
    assert outcome(lambda: JMatrixConfig.from_dict(doc))[0] == "refused"
    with pytest.raises((SchemaError, ValueError, TypeError)):
        MatrixConfig.from_dict(doc)


def test_the_reference_matrix_cases_hold_on_the_port():
    """``tests/test_schemas/test_matrix.py``'s assertions, on the port."""
    m = MatrixConfig.from_dict({"values": [1, 2, 3]})
    assert m.length == 3 and list(m.to_numpy()) == [1, 2, 3] and not m.is_distribution
    assert m.min == 1 and m.max == 3
    assert MatrixConfig.from_dict({"values": ["adam", "sgd"]}).min is None
    np.testing.assert_allclose(MatrixConfig.from_dict({"logspace": "0:2:3"}).to_numpy(),
                               [1, 10, 100])
    rng = np.random.default_rng(0)
    q = MatrixConfig.from_dict({"quniform": [0, 1, 0.25]})
    assert all(q.sample(rng) in (0.0, 0.25, 0.5, 0.75, 1.0) for _ in range(50))
    logu = MatrixConfig.from_dict({"loguniform": [1e-5, 1e-1]})
    samples = np.array([logu.sample(rng) for _ in range(500)])
    assert samples.min() >= 1e-5 and samples.max() <= 1e-1
    assert np.median(samples) < samples.mean()
    with pytest.raises(SchemaError):
        MatrixConfig.from_dict({"uniform": [0, 1]}).to_numpy()


# -- the hptuning section -----------------------------------------------------

METRIC = {"name": "loss", "optimization": "minimize"}
HPTUNING = {
    "grid": {"matrix": {"lr": {"values": [0.1, 0.2]}}, "grid_search": {}},
    "grid-capped": {"matrix": {"lr": {"values": [1, 2, 3]}}, "grid_search": {"n_experiments": 2}},
    "grid-default": {"matrix": {"lr": {"values": [1]}}},
    "grid-n-float": {"matrix": {"lr": {"values": [1]}}, "grid_search": {"n_experiments": 2.0}},
    "grid-n-str": {"matrix": {"lr": {"values": [1]}}, "grid_search": {"n_experiments": "3"}},
    "random": {"matrix": {"lr": {"uniform": [0, 1]}},
               "random_search": {"n_experiments": 4, "seed": 5}, "concurrency": 2},
    "concurrency-str": {"matrix": {"lr": {"values": [1]}}, "concurrency": "4"},
    "concurrency-bool": {"matrix": {"lr": {"values": [1]}}, "concurrency": True},
    "seed-null": {"matrix": {"lr": {"values": [1]}}, "seed": None, "grid_search": None},
    "hyperband": {"matrix": {"lr": {"uniform": [0, 1]}},
                  "hyperband": {"max_iterations": 81, "eta": 3,
                                "resource": {"name": "epochs"}, "metric": METRIC, "seed": 1}},
    "hyperband-resume": {"matrix": {"lr": {"uniform": [0, 1]}},
                         "hyperband": {"max_iterations": 4, "eta": "2.5", "resume": "yes",
                                       "resource": {"name": "epochs"}, "metric": METRIC}},
    "bo": {"matrix": {"lr": {"uniform": [0, 1]}, "units": {"values": [32, 64]}},
           "bo": {"n_initial_trials": 3, "n_iterations": 2, "metric": METRIC,
                  "utility_function": {"acquisition_function": "ei", "kappa": 1,
                                       "gaussian_process": {"kernel": "rbf",
                                                            "length_scale": "0.5",
                                                            "n_restarts_optimizer": 2}}}},
    "bo-defaults": {"matrix": {"lr": {"loguniform": [1e-4, 1e-1]}},
                    "bo": {"n_initial_trials": 1, "n_iterations": 1,
                           "metric": {"name": "acc", "optimization": "MAXIMIZE"}}},
    "early-stopping": {"matrix": {"lr": {"values": [1, 2]}}, "grid_search": {},
                       "early_stopping": [{"metric": METRIC, "value": "0.5"},
                                          {"metric": {"name": "acc"}, "value": 0.9,
                                           "policy": "all"}]},
}
REFUSED_HPTUNING = {
    "no-matrix": {"grid_search": {}},
    "empty-matrix": {"matrix": {}},
    "matrix-not-a-mapping": {"matrix": [1]},
    "bad-matrix-entry": {"matrix": {"lr": {"bogus": 1}}},
    "two-algorithms": {"matrix": {"a": {"values": [1]}}, "grid_search": {},
                       "random_search": {"n_experiments": 2}},
    "extra-key": {"matrix": {"a": {"values": [1]}}, "bogus": 1},
    "concurrency-zero": {"matrix": {"a": {"values": [1]}}, "concurrency": 0},
    "concurrency-fraction": {"matrix": {"a": {"values": [1]}}, "concurrency": 1.5},
    "concurrency-null": {"matrix": {"a": {"values": [1]}}, "concurrency": None},
    "grid-n-zero": {"matrix": {"a": {"values": [1]}}, "grid_search": {"n_experiments": 0}},
    "grid-extra": {"matrix": {"a": {"values": [1]}}, "grid_search": {"n": 1}},
    "random-no-n": {"matrix": {"a": {"values": [1]}}, "random_search": {}},
    "random-seed-str": {"matrix": {"a": {"values": [1]}},
                        "random_search": {"n_experiments": 1, "seed": "x"}},
    "hyperband-eta-one": {"matrix": {"a": {"values": [1]}},
                          "hyperband": {"max_iterations": 4, "eta": 1,
                                        "resource": {"name": "e"}, "metric": METRIC}},
    "hyperband-resource-in-matrix": {"matrix": {"epochs": {"values": [1]}},
                                     "hyperband": {"max_iterations": 4, "eta": 2,
                                                   "resource": {"name": "epochs"},
                                                   "metric": METRIC}},
    "hyperband-no-metric": {"matrix": {"a": {"values": [1]}},
                            "hyperband": {"max_iterations": 4, "eta": 2,
                                          "resource": {"name": "e"}}},
    "hyperband-resume-word": {"matrix": {"a": {"values": [1]}},
                              "hyperband": {"max_iterations": 4, "eta": 2, "resume": "maybe",
                                            "resource": {"name": "e"}, "metric": METRIC}},
    "metric-bad-optimization": {"matrix": {"a": {"values": [1]}},
                                "early_stopping": [{"metric": {"name": "x",
                                                               "optimization": "up"},
                                                    "value": 1}]},
    "metric-name-int": {"matrix": {"a": {"values": [1]}},
                        "early_stopping": [{"metric": {"name": 3}, "value": 1}]},
    "early-stopping-no-value": {"matrix": {"a": {"values": [1]}},
                                "early_stopping": [{"metric": METRIC}]},
    "bo-unbounded": {"matrix": {"a": {"normal": [0, 1]}},
                     "bo": {"n_initial_trials": 1, "n_iterations": 1, "metric": METRIC}},
    "bo-zero-trials": {"matrix": {"a": {"uniform": [0, 1]}},
                       "bo": {"n_initial_trials": 0, "n_iterations": 1, "metric": METRIC}},
    "bo-bad-kernel": {"matrix": {"a": {"uniform": [0, 1]}},
                      "bo": {"n_initial_trials": 1, "n_iterations": 1, "metric": METRIC,
                             "utility_function": {"gaussian_process": {"kernel": "linear"}}}},
    "bo-bad-acquisition": {"matrix": {"a": {"uniform": [0, 1]}},
                           "bo": {"n_initial_trials": 1, "n_iterations": 1, "metric": METRIC,
                                  "utility_function": {"acquisition_function": "pi"}}},
    "bo-gp-null": {"matrix": {"a": {"uniform": [0, 1]}},
                   "bo": {"n_initial_trials": 1, "n_iterations": 1, "metric": METRIC,
                          "utility_function": {"gaussian_process": None}}},
}


@pytest.mark.parametrize("name", list(HPTUNING))
def test_an_hptuning_section_is_read_as_the_reference_reads_it(name):
    doc = HPTUNING[name]
    port, ref = HPTuningConfig.from_dict(doc), JHPTuningConfig.model_validate(doc)
    assert port.to_dict() == json.loads(json.dumps(ref.to_dict()))
    assert port.search_algorithm == ref.search_algorithm
    assert port.concurrency == ref.concurrency and port.seed == ref.seed
    for es_p, es_r in zip(port.early_stopping, ref.early_stopping):
        assert [es_p.passed(v) for v in (None, 0.1, 0.5, 0.95)] == \
            [es_r.passed(v) for v in (None, 0.1, 0.5, 0.95)]


@pytest.mark.parametrize("name", list(REFUSED_HPTUNING))
def test_an_hptuning_section_the_reference_refuses_is_refused(name):
    doc = REFUSED_HPTUNING[name]
    assert outcome(lambda: JHPTuningConfig.model_validate(doc))[0] == "refused"
    assert outcome(lambda: HPTuningConfig.from_dict(doc))[0] == "refused"


# -- group and pipeline specifications ----------------------------------------

GROUP_YAML = """
version: 1
kind: group
declarations: {batch_size: 128}
hptuning:
  concurrency: 4
  matrix:
    lr: {loguniform: [0.0001, 0.1]}
    depth: {values: [2, 4]}
  random_search: {n_experiments: 8, seed: 33}
run:
  cmd: "python train.py --lr={{ lr }} --depth={{ depth }} --bs={{ batch_size }}"
"""
TOPOLOGY = {"topology": {"accelerator": "h100", "num_devices": 1, "num_hosts": 1}}
SPECS = {
    "group-yaml": GROUP_YAML,
    "group-grid": {"kind": "group", "run": {"cmd": "x"},
                   "hptuning": {"matrix": {"a": {"values": [1, 2, 3]},
                                           "b": {"linspace": "0:1:4"}}}},
    "group-from-hptuning": {"hptuning": {"matrix": {"lr": {"values": [1]}}}, "run": {"cmd": "e"}},
    "group-legacy-matrix": {"matrix": {"lr": {"values": [1]}}, "run": {"cmd": "echo"}},
    "group-experiment-kind": {"kind": "experiment", "run": {"entrypoint": "m.n:f"},
                              "environment": TOPOLOGY,
                              "hptuning": {"matrix": {"lr": {"values": [3e-4, 1e-3]}},
                                           "grid_search": {}, "concurrency": 2}},
    "pipeline": {"kind": "pipeline", "concurrency": 1,
                 "ops": [{"name": "a"}, {"name": "b", "dependencies": ["a"]}]},
    "pipeline-ops": {"kind": "pipeline", "declarations": {"lr": 1},
                     "environment": TOPOLOGY,
                     "ops": [{"name": "train", "run": {"entrypoint": "m.n:train"}},
                             {"name": "gen", "dependencies": ["train"],
                              "run": {"entrypoint": "m.n:gen"}}]},
    "pipeline-empty": {"kind": "pipeline"},
}
REFUSED_SPECS = {
    "group-two-algorithms": {"kind": "group", "run": {"cmd": "x"},
                             "hptuning": {"matrix": {"a": {"values": [1]}}, "grid_search": {},
                                          "random_search": {"n_experiments": 2}}},
    "group-no-run": {"kind": "group", "hptuning": {"matrix": {"a": {"values": [1]}}}},
    "group-no-hptuning": {"kind": "group", "run": {"cmd": "x"}},
    "group-extra": {"kind": "group", "run": {"cmd": "x"}, "ops": [],
                    "hptuning": {"matrix": {"a": {"values": [1]}}}},
    "group-empty-matrix": {"kind": "group", "run": {"cmd": "x"}, "hptuning": {"matrix": {}}},
    "pipeline-unknown-dependency": {"kind": "pipeline",
                                    "ops": [{"name": "a", "dependencies": ["missing"]}]},
    "pipeline-duplicate": {"kind": "pipeline", "ops": [{"name": "a"}, {"name": "a"}]},
    "pipeline-unnamed": {"kind": "pipeline", "ops": [{"dependencies": []}]},
    "pipeline-op-not-a-mapping": {"kind": "pipeline", "ops": ["a"]},
    "pipeline-concurrency": {"kind": "pipeline", "ops": [], "concurrency": "x"},
    "pipeline-extra": {"kind": "pipeline", "ops": [], "hptuning": {}},
}


@pytest.mark.parametrize("name", list(SPECS))
def test_a_group_or_pipeline_spec_validates_as_the_reference_does(name):
    doc = SPECS[name]
    port, ref = PolyaxonFile.load(doc), JPolyaxonFile.load(doc)
    assert port.kind == ref.kind in (Kinds.GROUP, Kinds.PIPELINE)
    assert isinstance(port.specification, (GroupSpecification, PipelineSpecification))
    assert port.to_dict() == json.loads(json.dumps(ref.to_dict()))
    if not isinstance(doc, str):
        assert compile_spec(doc).to_dict() == port.to_dict()
    if port.kind == Kinds.GROUP:
        assert port.specification.matrix_space == ref.specification.matrix_space
        # The stored row round-trips (the registry keeps ``to_dict``).
        assert PolyaxonFile(port.to_dict()).to_dict() == port.to_dict()


@pytest.mark.parametrize("name", list(REFUSED_SPECS))
def test_a_group_or_pipeline_spec_the_reference_refuses_is_refused(name):
    doc = REFUSED_SPECS[name]
    assert outcome(lambda: JPolyaxonFile.load(doc))[0] == "refused"
    with pytest.raises(SchemaError):
        PolyaxonFile.load(doc)


@pytest.mark.parametrize("name", ["group-yaml", "group-grid", "group-experiment-kind"])
def test_a_group_materialises_the_reference_trials(name):
    from polyaxon_tpu.hpsearch import get_search_manager as jget
    from polyaxon_tpu_torch.hpsearch import get_search_manager

    port, ref = PolyaxonFile.load(SPECS[name]).specification, \
        JPolyaxonFile.load(SPECS[name]).specification
    suggestions = get_search_manager(port.hptuning).get_suggestions({"iteration": 0})
    assert suggestions == jget(ref.hptuning).get_suggestions({"iteration": 0})
    for s in suggestions:
        trial, jtrial = port.get_experiment_spec(s), ref.get_experiment_spec(s)
        assert trial.kind == Kinds.EXPERIMENT
        assert trial.to_dict() == json.loads(json.dumps(jtrial.to_dict()))
        assert trial.resolved_run().to_dict() == jtrial.resolved_run().model_dump(
            exclude_none=True)
    exp = PolyaxonFile.load(GROUP_YAML).specification.get_experiment_spec({"lr": 0.01, "depth": 4})
    assert exp.declarations == {"batch_size": 128, "lr": 0.01, "depth": 4}
    assert exp.resolved_run().cmd == "python train.py --lr=0.01 --depth=4 --bs=128"
