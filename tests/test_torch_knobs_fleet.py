"""The port's router, fleet and autoscaler knobs against the reference's.

Every ``POLYAXON_TPU_ROUTER_*``, ``_FLEET_*`` and ``_AUTOSCALER_*`` knob of
``polyaxon_tpu/conf/knobs.py`` (and the remediation budget a zero
autoscaler budget inherits) must be in the port's catalog under the same
name, with the same type and default, and read the same value from the
environment through the port's ``knob_*`` readers.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

from polyaxon_tpu.conf import knobs as jknobs
from polyaxon_tpu_torch.conf import knobs as tknobs

FLEET_KNOBS = sorted(
    name for name in jknobs.KNOBS
    if name.startswith(("POLYAXON_TPU_ROUTER_", "POLYAXON_TPU_FLEET_", "POLYAXON_TPU_AUTOSCALER_"))
) + ["POLYAXON_TPU_REMEDIATION_BUDGET"]
_READERS = {"bool": "knob_bool", "int": "knob_int", "float": "knob_float", "str": "knob_str"}
_SAMPLES = {"bool": ("off", "yes"), "int": ("7", "3.0"), "float": ("0.125", "nope"), "str": ("x", "")}


def test_the_catalog_has_every_fleet_knob_of_the_reference():
    assert len(FLEET_KNOBS) == 26
    assert set(FLEET_KNOBS) <= set(tknobs.KNOBS)


@pytest.mark.parametrize("name", FLEET_KNOBS)
def test_name_type_and_default_equal_the_reference(name):
    ref = jknobs.KNOBS[name]
    default = tknobs.KNOBS[name]
    assert type(default).__name__ == ref.kind
    assert default == ref.default
    assert getattr(tknobs, _READERS[ref.kind])(name) == jknobs.knob_default(name)


@pytest.mark.parametrize("name", FLEET_KNOBS)
def test_the_environment_is_read_like_the_reference(name, monkeypatch):
    kind = jknobs.KNOBS[name].kind
    for raw in _SAMPLES[kind]:
        monkeypatch.setenv(name, raw)
        assert getattr(tknobs, _READERS[kind])(name) == getattr(jknobs, _READERS[kind])(name), raw
