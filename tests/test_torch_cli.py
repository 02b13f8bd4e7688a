"""The port's CLI (``polyaxon_tpu_torch/cli/main.py``) against the reference's.

Each test of ``tests/test_cli/test_main.py`` runs on both planes
(``tests/torch_api_parity.py``): exit codes, the reference's assertions and
every captured output must agree.  Then the port's own surfaces: the remote
mode against the port's ``serve`` prints what the local mode prints for the
same run, and the stated departures (``pools``, ``--version``, the ``init``
starters).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from tests import torch_api_parity as parity
from polyaxon_tpu_torch.cli.main import _STARTERS, main
from polyaxon_tpu_torch.schemas import PolyaxonFile

REF = "tests/test_cli/test_main.py"
ROOT = Path(__file__).resolve().parents[1]
SPEC = {
    "kind": "experiment",
    "run": {"entrypoint": "polyaxon_tpu_torch.builtins.trainers:noop"},
    "environment": {"topology": {"accelerator": "cpu-1", "num_devices": 1, "num_hosts": 1}},
}


@pytest.mark.parametrize("flow", parity.cases(REF))
def test_flow_matches_the_reference(flow, tmp_path):
    parity.run_both(REF, flow, tmp_path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(capsys, *argv) -> tuple:
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_remote_mode_prints_what_the_local_mode_prints(tmp_path, capsys):
    """``run --watch``, ``ps``, ``get``, ``logs`` and ``statuses`` through the
    port's ``serve`` (a subprocess on a free port) print what they print in
    local mode for the same spec, after the same masking as the parity
    flows (``get`` prints the API's detail, which adds rollups to the run's
    fields); the server releases its control-plane lease when it stops."""
    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps(SPEC))
    port = _free_port()
    served = tmp_path / "served"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    server = subprocess.Popen(
        [sys.executable, "-m", "polyaxon_tpu_torch.cli.main", "--base-dir", str(served),
         "serve", "--port", str(port)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, start_new_session=True)
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/v1/status", timeout=2):
                    break
            except OSError:
                assert server.poll() is None and time.time() < deadline, "serve did not come up"
                time.sleep(0.2)
        printed = {}
        for mode, target in (("local", ["--base-dir", str(tmp_path / "local")]),
                             ("remote", ["--host", f"127.0.0.1:{port}"])):
            seen = parity.Recorder()
            for argv in (["run", "-f", str(spec_file), "--watch", "--name", "cli-remote"],
                         ["ps"], ["get", "1"], ["logs", "1"], ["statuses", "1"]):
                rc, out, err = _cli(capsys, *target, *argv)
                seen.add("capsys", f"rc={rc}\n{out}" if not argv[0] == "get" else out, err)
                assert rc == 0, (mode, argv, err)
            base = served if mode == "remote" else tmp_path / "local"
            printed[mode] = parity.comparable(seen, base, "port")
        assert len(printed["remote"]) == len(printed["local"])
        for remote, local in zip(printed["remote"], printed["local"]):
            if isinstance(local[1], dict):
                # ``get``: the API's run detail adds its rollups (anomalies,
                # goodput, alerts, ...) to the run's fields, as the
                # reference's does; the fields themselves agree.
                assert set(local[1]) < set(remote[1])
                remote = [remote[0], {k: remote[1][k] for k in local[1]}, remote[2]]
            assert remote == local, parity._first_difference(remote, local)
        assert any("noop trainer" in str(e) for e in printed["remote"])
    finally:
        os.killpg(server.pid, signal.SIGTERM)
        assert server.wait(30) == 0
    from polyaxon_tpu_torch.db.registry import RunRegistry

    registry = RunRegistry(served / "registry.db")
    try:
        assert registry.get_option("platform.lease") is None
    finally:
        registry.close()


def test_pools_is_refused_with_its_reason(tmp_path, capsys):
    with pytest.raises(SystemExit, match="the port provisions no TPU-VM slices"):
        main(["--base-dir", str(tmp_path), "pools", "list"])


def test_version_names_the_port(capsys):
    import polyaxon_tpu_torch

    with pytest.raises(SystemExit) as stop:
        main(["--version"])
    assert stop.value.code == 0
    assert capsys.readouterr().out.strip() == f"polyaxon-tpu-torch {polyaxon_tpu_torch.__version__}"


@pytest.mark.parametrize("kind", sorted(_STARTERS))
def test_the_starters_name_the_ports_builtins_on_the_card(kind):
    """The ``init`` starters differ from the reference's only in the entry
    points' package and the accelerator: the card, where the reference
    names a ``v5e-8`` slice (the tensorboard starter keeps ``cpu-1``)."""
    from polyaxon_tpu.cli.main import _STARTERS as REFERENCE

    spec = PolyaxonFile.load(_STARTERS[kind]).specification
    topologies = [spec.environment.topology] if kind != "pipeline" else [
        PolyaxonFile.load({"kind": "experiment", "run": op["run"],
                           "environment": op["environment"]}).specification.environment.topology
        for op in spec.ops]
    want = "cpu-1" if kind == "tensorboard" else "h100"
    assert {t.accelerator for t in topologies} == {want}
    assert all((t.num_devices, t.num_hosts) == (1, 1) for t in topologies)
    ours = _STARTERS[kind].replace("polyaxon_tpu_torch.", "polyaxon_tpu.")
    ours = ours.replace("accelerator: h100\n    num_devices: 1\n    num_hosts: 1\n",
                        "accelerator: v5e-8\n")
    ours = ours.replace("{accelerator: h100, num_devices: 1, num_hosts: 1}", "{accelerator: v5e-8}")
    assert ours == REFERENCE[kind]
