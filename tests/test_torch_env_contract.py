"""The port's gang contract against the JAX package's, as data: the rendezvous
env (``runtime/env.py``), the run layout (``stores/layout.py``), code
snapshots, the spec sections a worker reads (``schemas/``) and the gang plan
(``compiler/service.py``).

The same documents go to both packages: those of
``tests/test_schemas/test_specifications.py`` and
``tests/test_spawner/test_env_contract.py`` (yaml parsed here; the port
takes dicts), and edge cases of every field the port checks.  A document
must be accepted by both, with equal ``to_dict()`` and equal ``GangPlan``
fields, or refused by both with a ``SchemaError`` (``CompilerError`` for a
kind mismatch) whose message holds the same text.  The control-plane kinds
(groups, pipelines) are refused by the port's worker side by design.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import copy
import dataclasses
import json
import os
from types import SimpleNamespace

import pytest
import yaml

from polyaxon_tpu import exceptions as jexc
from polyaxon_tpu.compiler import compile_gang_plan as jax_compile_gang_plan
from polyaxon_tpu.compiler import compile_spec as jax_compile_spec
from polyaxon_tpu.runtime import env as jenv
from polyaxon_tpu.spawner.local import LocalGangSpawner as JaxGangSpawner
from polyaxon_tpu.stores import layout as jlayout
from polyaxon_tpu.stores.snapshots import create_snapshot
from polyaxon_tpu.schemas.run import BuildConfig as JaxBuildConfig
from polyaxon_tpu_torch import exceptions as texc
from polyaxon_tpu_torch.compiler import compile_gang_plan, compile_spec
from polyaxon_tpu_torch.runtime import env as tenv
from polyaxon_tpu_torch.spawner.local import LocalGangSpawner, LocalRun
from polyaxon_tpu_torch.stores import layout as tlayout
from polyaxon_tpu_torch.stores.snapshots import materialize_snapshot
from tests.test_schemas.test_specifications import EXPERIMENT_YAML, GROUP_YAML

RUN = {"entrypoint": "polyaxon_tpu_torch.builtins.trainers:noop"}


def exp(**sections):
    return {"kind": "experiment", "run": dict(RUN), **sections}


def topo(**fields):
    return exp(environment={"topology": fields})


#: Documents both packages accept.
ACCEPTED = {
    "experiment-yaml": yaml.safe_load(EXPERIMENT_YAML),
    "v5e16-wildcard": {"kind": "experiment", "run": {"cmd": "true"},
                       "environment": {"topology": {"accelerator": "v5e-16",
                                                    "mesh": {"data": -1, "tensor": 4}}}},
    "declared-cmd": {"kind": "experiment", "declarations": {"lr": 0.2},
                     "run": {"cmd": "train --lr={{ lr }}"}},
    "no-kind": {"run": {"cmd": "echo"}},
    "unknown-accelerator-counts": {"kind": "experiment", "run": {"cmd": "x"},
                                   "environment": {"topology": {"accelerator": "v99-512",
                                                                "num_devices": 512,
                                                                "num_hosts": 64}}},
    "h100": topo(accelerator="h100", num_devices=1, num_hosts=1),
    "cpu-two-hosts": topo(accelerator="cpu", num_devices=2, num_hosts=2, mesh={"data": 2}),
    "mesh-axes-form": topo(accelerator="cpu", num_devices=4, num_hosts=1,
                           mesh={"axes": {"data": 2, "sequence": 2}}, strategy="sp_ring"),
    "multi-slice": topo(accelerator="cpu", num_devices=2, num_hosts=1, num_slices=2),
    "coerced-numbers": {**topo(accelerator="cpu", num_devices="2", num_hosts=1.0),
                        "version": "1"},
    "everything": {
        "version": 1, "kind": "experiment", "name": "n", "description": "d", "tags": ["a"],
        "declarations": {"steps": 3, "port": 9},
        "environment": {"topology": {"accelerator": "cpu-1", "strategy_options": {"k": 1}},
                        "resources": {"cpu": 2, "memory_mb": "512", "tpu": None},
                        "restart_policy": {"max_restarts": 2, "backoff_seconds": 0},
                        "seed": 7, "env_vars": {"OMP_NUM_THREADS": "1"}},
        "build": {"context": "src", "include": ["*.py"], "ref": "abc"},
        "run": {"entrypoint": "a.b:c", "kwargs": {"steps": "{{ steps }}"}},
    },
    "job": {"kind": "job", "run": {"cmd": "true"}},
    "build-kind": {"kind": "build", "run": {"cmd": "true"}},
    "service-no-run": {"kind": "service", "port": 0, "declarations": {"port": 8123}},
    "service-lm-server": {"kind": "service", "run": {
        "entrypoint": "polyaxon_tpu_torch.builtins.services:lm_server"}},
    "tensorboard-with-run": {"kind": "tensorboard", "port": 6006, "run": {"cmd": "tb"}},
}

#: Documents both packages refuse, with text both messages hold.
REFUSED = {
    "mesh-not-devices": ({"kind": "experiment", "run": {"cmd": "true"},
                          "environment": {"topology": {"accelerator": "v5e-8",
                                                       "mesh": {"data": 3}}}},
                         "Mesh product 3 != device count 8"),
    "run-empty": ({"kind": "experiment", "run": {}},
                  "run must set exactly one of cmd / entrypoint"),
    "run-both": ({"kind": "experiment", "run": {"cmd": "x", "entrypoint": "a:b"}},
                 "run must set exactly one of cmd / entrypoint"),
    "bad-entrypoint": (exp(run={"entrypoint": "no-colon"}), "entrypoint must look like"),
    "unknown-accelerator": ({"kind": "experiment", "run": {"cmd": "x"},
                             "environment": {"topology": {"accelerator": "v99-512"}}},
                            "Unknown accelerator 'v99-512'"),
    "h100-no-counts": (topo(accelerator="h100"), "Unknown accelerator 'h100'"),
    "extra-key": ({"run": {"cmd": "x"}, "bogus_section": 1}, "Extra inputs are not permitted"),
    "extra-topology-key": (topo(accelerator="cpu", bogus=1), "Extra inputs are not permitted"),
    "bad-strategy": (topo(strategy="zero3"), "strategy must be one of"),
    "two-wildcards": (topo(mesh={"data": -1, "tensor": -1}), "At most one -1 axis allowed"),
    "zero-axis": (topo(mesh={"data": 0}), "Axis 'data' must be >= 1 or -1"),
    "empty-mesh": (topo(mesh={}), "mesh must declare at least one axis"),
    "indivisible-hosts": (topo(accelerator="x", num_devices=3, num_hosts=2),
                          "num_devices (3) must be divisible by num_hosts (2)"),
    "zero-hosts": (topo(accelerator="x", num_devices=2, num_hosts=0),
                   "greater than or equal to 1"),
    "dcn-not-data-like": (topo(num_slices=2, dcn_axis="tensor"),
                          "dcn_axis 'tensor' must be a data-like axis"),
    "dcn-collides": (topo(num_slices=2, dcn_axis="data"),
                     "dcn_axis 'data' collides with a per-slice"),
    "fractional-int": (topo(accelerator="x", num_devices=2.5, num_hosts=1),
                       "fractional part"),
    "str-for-int": (topo(accelerator="x", num_devices="two", num_hosts=1),
                    "unable to parse string as an integer"),
    "int-for-str": (topo(accelerator=8), "Input should be a valid string"),
    "env-var-not-str": (exp(environment={"env_vars": {"A": 1}}),
                        "Input should be a valid string"),
    "negative-restarts": (exp(environment={"restart_policy": {"max_restarts": -1}}),
                          "greater than or equal to 0"),
    "version-2": ({"version": 2, **exp()}, "Unsupported spec version 2"),
    "port-not-int": ({"kind": "notebook", "run": dict(RUN), "port": "x"},
                   "unable to parse string as an integer"),
    "experiment-no-run": ({"kind": "experiment"}, "Field required"),
}


def outcome(compile_fn, errors, doc):
    try:
        return "accepted", compile_fn(copy.deepcopy(doc))
    except errors as e:
        return "refused", str(e)


JAX_ERRORS = (jexc.SchemaError, jexc.CompilerError)
PORT_ERRORS = (texc.SchemaError, texc.CompilerError)


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_both_packages_accept_the_same_documents(name):
    doc = ACCEPTED[name]
    jkind, jspec = outcome(jax_compile_spec, JAX_ERRORS, doc)
    tkind, tspec = outcome(compile_spec, PORT_ERRORS, doc)
    assert (jkind, tkind) == ("accepted", "accepted"), (jspec, tspec)
    assert type(tspec).__name__ == type(jspec).__name__
    assert tspec.to_dict() == jspec.to_dict()
    assert tspec.gang_def == jspec.gang_def and tspec.mesh_axes == jspec.mesh_axes
    assert dataclasses.asdict(compile_gang_plan(tspec)) == dataclasses.asdict(
        jax_compile_gang_plan(jspec))
    if getattr(jspec, "run", None) is not None:
        assert tspec.resolved_run().to_dict() == jspec.resolved_run().model_dump(
            exclude_none=True)


@pytest.mark.parametrize("name", list(REFUSED))
def test_both_packages_refuse_the_same_documents(name):
    doc, text = REFUSED[name]
    jkind, jmsg = outcome(jax_compile_spec, JAX_ERRORS, doc)
    tkind, tmsg = outcome(compile_spec, PORT_ERRORS, doc)
    assert (jkind, tkind) == ("refused", "refused"), (jmsg, tmsg)
    assert text in jmsg and text in tmsg, (jmsg, tmsg)


def test_kind_mismatch_and_the_control_plane_kinds():
    with pytest.raises(jexc.CompilerError):
        jax_compile_spec(yaml.safe_load(EXPERIMENT_YAML), kind="group")
    with pytest.raises(texc.CompilerError, match="does not match requested 'group'"):
        compile_spec(yaml.safe_load(EXPERIMENT_YAML), kind="group")
    for doc in (yaml.safe_load(GROUP_YAML), {"matrix": {"lr": {"values": [1]}}, "run": {"cmd": "e"}},
                {"kind": "pipeline", "ops": [{"name": "a"}]}):
        # Search and pipelines are ported: both packages read the kinds the
        # control plane expands into trial and op runs alike.
        want = jax_compile_spec(doc)
        assert want.kind in ("group", "pipeline")
        got = compile_spec(doc)
        assert got.kind == want.kind
        assert got.to_dict() == want.to_dict()
        with pytest.raises(texc.CompilerError, match="does not match requested 'experiment'"):
            compile_spec(doc, kind="experiment")


def test_a_service_spec_resolves_to_the_ports_builtin():
    spec = compile_spec({"kind": "service", "declarations": {"service_port": 8}})
    assert spec.resolved_run().entrypoint == "polyaxon_tpu_torch.builtins.services:lm_server"
    assert jax_compile_spec({"kind": "service"}).resolved_run().entrypoint == (
        "polyaxon_tpu.builtins.services:lm_server")
    for kind, name in (("notebook", "jupyter"), ("tensorboard", "tensorboard")):
        assert compile_spec({"kind": kind}).resolved_run().entrypoint == (
            f"polyaxon_tpu_torch.builtins.services:{name}")
        assert jax_compile_spec({"kind": kind}).resolved_run().entrypoint == (
            f"polyaxon_tpu.builtins.services:{name}")
    templated = compile_spec({"kind": "service", "declarations": {"service_port": 8},
                              "run": {"cmd": "serve --port {{ service_port }}"}})
    assert templated.resolved_run().cmd == "serve --port 8"


GANG_ENVS = {
    "tp_dp-4-hosts": dict(run_id=3, run_uuid="u", run_dir="/d", spec_path="/d/spec.json",
                          process_id=1, num_processes=4, coordinator="127.0.0.1:555",
                          devices_per_host=8, accelerator="v5e-32",
                          mesh_axes={"data": 4, "tensor": 8}, strategy="tp_dp",
                          strategy_options={"microbatches": 4}, seed=42),
    "single-host": dict(run_id=1, run_uuid="u", run_dir="/d", spec_path="/d/s.json",
                        process_id=0, num_processes=1, coordinator=None, devices_per_host=8,
                        accelerator="cpu", mesh_axes={"data": 8}, strategy="ddp",
                        strategy_options={}),
    "dcn-and-dirs": dict(run_id=9, run_uuid="v", run_dir="/r", spec_path="/r/spec.json",
                         process_id=1, num_processes=2, coordinator="h:1", devices_per_host=1,
                         accelerator="h100", mesh_axes={"replica": 2, "data": 1},
                         dcn_axes={"replica": 2}, strategy="ddp", strategy_options={},
                         heartbeat_interval=0.5, seed=0, data_dir="/b/data",
                         compile_cache_dir="/b/compile_cache"),
}


@pytest.mark.parametrize("name", list(GANG_ENVS))
def test_gang_env_crosses_between_the_packages(name):
    kwargs = GANG_ENVS[name]
    jax_env, port_env = jenv.gang_env(**kwargs), tenv.gang_env(**kwargs)
    assert port_env == jax_env
    want = dataclasses.asdict(jenv.GangInfo.from_env(jax_env))
    assert dataclasses.asdict(tenv.GangInfo.from_env(jax_env)) == want
    assert dataclasses.asdict(jenv.GangInfo.from_env(port_env)) == want
    assert {k: getattr(tenv.EnvVars, k) for k in vars(jenv.EnvVars) if k.isupper()} == {
        k: getattr(jenv.EnvVars, k) for k in vars(jenv.EnvVars) if k.isupper()}


def _as_env(env):
    return {k: v for k, v in env.items() if v is not None}


@pytest.mark.parametrize("doc", ["cpu-two-hosts", "multi-slice", "h100", "everything"])
def test_the_spawners_envs_decode_alike(tmp_path, doc):
    """The env either spawner writes for a gang process decodes to the same
    GangInfo in both packages."""
    spec_data = ACCEPTED[doc]
    jspec = jax_compile_spec(copy.deepcopy(spec_data))
    run = SimpleNamespace(id=4, uuid="abc", spec=jspec)
    jplan = jax_compile_gang_plan(jspec)
    jsp = JaxGangSpawner(jlayout.StoreLayout(tmp_path / "jax"), heartbeat_interval=0.5)
    tsp = LocalGangSpawner(tlayout.StoreLayout(tmp_path / "jax"), heartbeat_interval=0.5)
    for pid in range(jplan.num_hosts):
        coordinator = "127.0.0.1:1234" if jplan.num_hosts > 1 else None
        jpaths = jsp.layout.run_paths(run.uuid)
        jax_env = _as_env(jsp._process_env(run, jplan, jpaths, pid, coordinator))
        port_env = _as_env(tsp._process_env(LocalRun(spec_data, id=4, uuid="abc"),
                                            compile_gang_plan(spec_data),
                                            tsp.layout.run_paths("abc"), pid, coordinator))
        want = dataclasses.asdict(jenv.GangInfo.from_env(jax_env))
        assert dataclasses.asdict(tenv.GangInfo.from_env(port_env)) == want
        assert dataclasses.asdict(jenv.GangInfo.from_env(port_env)) == want
        assert dataclasses.asdict(tenv.GangInfo.from_env(jax_env)) == want
        assert port_env["LOCAL_RANK"] == str(pid)
        assert port_env["LOCAL_WORLD_SIZE"] == str(jplan.num_hosts)
        assert port_env["PYTHONPATH"].split(os.pathsep)[0] == jax_env["PYTHONPATH"].split(
            os.pathsep)[0]
        assert port_env.get("OMP_NUM_THREADS") == jax_env.get("OMP_NUM_THREADS")


def test_the_run_layout_has_the_references_names(tmp_path):
    jl, tl = jlayout.StoreLayout(tmp_path), tlayout.StoreLayout(tmp_path)
    for name in ("runs_dir", "snapshots_dir", "data_dir", "compile_cache_dir", "kv_cache_dir"):
        assert getattr(tl, name) == getattr(jl, name), name
    jp, tp = jl.run_paths("u1"), tl.run_paths("u1")
    for name in ("root", "spec_path", "outputs", "logs", "reports", "checkpoints", "commands",
                 "profiles", "code"):
        assert getattr(tp, name) == getattr(jp, name), name
    for i in (0, 3):
        assert tp.report_file(i) == jp.report_file(i)
        assert tp.log_file(i) == jp.log_file(i)
        assert tp.command_dir(i) == jp.command_dir(i)
    tp.ensure()
    assert sorted(p.name for p in tp.root.iterdir()) == [
        "checkpoints", "commands", "logs", "outputs", "reports"]
    (tp.outputs / "o.txt").write_text("x")
    tl.copy_outputs("u1", "u2")
    assert (jl.run_paths("u2").outputs / "o.txt").read_text() == "x"


def test_a_jax_snapshot_materializes_in_the_port(tmp_path):
    src = tmp_path / "src"
    (src / "pkg").mkdir(parents=True)
    (src / "pkg" / "mod.py").write_text("X = 1\n")
    jl = jlayout.StoreLayout(tmp_path / "base")
    ref = create_snapshot(JaxBuildConfig(), src, jl.snapshots_dir)
    dest = materialize_snapshot(ref, jl.snapshots_dir, tmp_path / "run" / "code")
    assert (dest / "pkg" / "mod.py").read_text() == "X = 1\n" and dest.is_symlink()
    copied = materialize_snapshot(ref, jl.snapshots_dir, dest, symlink=False)
    assert not copied.is_symlink() and (copied / "pkg" / "mod.py").exists()
    with pytest.raises(texc.StoreError, match="not found"):
        materialize_snapshot("nope", jl.snapshots_dir, tmp_path / "x")


def test_the_port_spawner_writes_the_spec_and_mailboxes(tmp_path):
    """Without launching: the run dir, the spec file and one command mailbox
    per process exist before any worker starts (transport stubbed)."""
    launched = []

    class Transport:
        def launch(self, host, argv, env, **kw):
            launched.append((host, argv, env, kw))
            return SimpleNamespace(pid=1000 + len(launched), poll=lambda: 0)

    spec = ACCEPTED["cpu-two-hosts"]
    sp = LocalGangSpawner(tlayout.StoreLayout(tmp_path), heartbeat_interval=0.5)
    sp.transport = Transport()
    run = LocalRun(spec, id=2, uuid="r2")
    handle = sp.start(run, compile_gang_plan(spec))
    assert json.loads(handle.paths.spec_path.read_text()) == spec
    assert [h for h, *_ in launched] == ["127.0.0.1", "127.0.0.1"]
    assert all(a[1][1:] == ["-m", "polyaxon_tpu_torch.runtime.worker"] for a in launched)
    assert all(handle.paths.command_dir(i).is_dir() for i in range(2))
    coordinators = {a[2][tenv.EnvVars.COORDINATOR] for a in launched}
    assert len(coordinators) == 1 and coordinators.pop().startswith("127.0.0.1:")
    assert launched[0][3]["rc_path"] == handle.paths.log_file(0).with_suffix(".rc")
    assert handle.poll() == {0: 0, 1: 0} and handle.all_exited
