"""The port's API against the reference's, flow by flow: each test of
``tests/test_api/test_ownership.py`` runs on both planes
(``tests/torch_api_parity.py``) and what its client saw must be equal."""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

from tests import torch_api_parity as parity

REF = "tests/test_api/test_ownership.py"


@pytest.mark.parametrize("flow", parity.cases(REF))
def test_flow_matches_the_reference(flow, tmp_path):
    parity.run_both(REF, flow, tmp_path)
