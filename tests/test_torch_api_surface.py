"""The port's API where it departs from the reference's, by design.

``/api/v1/version`` reports torch and its CUDA where the reference reports
jax, and loads torch only in its handler.  ``/api/v1/status?devices=1``
adds the card probe (``checks/health.py:check_devices``); without the
parameter the report is the reference's (the parity flows hold it).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import asyncio

import pytest
import torch

from polyaxon_tpu.api.app import create_app as jax_create_app
from polyaxon_tpu.orchestrator import Orchestrator as JOrchestrator
from polyaxon_tpu_torch.api.app import create_app
from polyaxon_tpu_torch.orchestrator import Orchestrator


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    orchs = {"port": (Orchestrator(tmp_path_factory.mktemp("port")), create_app),
             "jax": (JOrchestrator(tmp_path_factory.mktemp("jax")), jax_create_app)}
    yield orchs
    for orch, _ in orchs.values():
        orch.stop()


def _get(plane, path):
    from aiohttp.test_utils import TestClient, TestServer

    orch, make_app = plane

    async def body():
        client = TestClient(TestServer(make_app(orch)))
        await client.start_server()
        try:
            resp = await client.get(path)
            return resp.status, await resp.json()
        finally:
            await client.close()

    return asyncio.run(body())


def test_version_reports_torch_and_its_cuda_where_the_reference_reports_jax(planes):
    status, port = _get(planes["port"], "/api/v1/version")
    jax_status, jax = _get(planes["jax"], "/api/v1/version")
    assert status == jax_status == 200
    assert {k: port[k] for k in ("platform", "min_cli")} == {k: jax[k] for k in ("platform",
                                                                                   "min_cli")}
    assert set(jax) - set(port) == {"jax"}
    assert port["torch"] == torch.__version__ and port["cuda"] == torch.version.cuda


def test_status_adds_the_card_probe_only_when_asked(planes):
    status, report = _get(planes["port"], "/api/v1/status?devices=1")
    plain_status, plain = _get(planes["port"], "/api/v1/status")
    assert "devices" not in plain["checks"] and plain_status == 200
    assert set(report["checks"]) == set(plain["checks"]) | {"devices"}
    if torch.cuda.is_available():
        assert report["checks"]["devices"]["ok"] and status == 200
    else:  # this host has no card: the probe says so and the report is unhealthy
        assert report["checks"]["devices"] == {
            "ok": False, "detail": "no accelerator backend: no CUDA device is visible"}
        assert status == 503 and not report["healthy"]
    assert _get(planes["jax"], "/api/v1/status?devices=1")[1]["checks"].keys() == plain[
        "checks"].keys()
