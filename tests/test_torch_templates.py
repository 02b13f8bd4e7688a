"""Parity of the port's strategy templates (``polyaxon_tpu_torch.parallel.
templates``) with the JAX package's, and the port's mesh.

For every strategy name over a few meshes, both ``template_for`` give the
same fields, or raise the same error; the port's ``batch_spec`` is the
plain tuple of the axes the JAX ``PartitionSpec`` names.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

from polyaxon_tpu.exceptions import RuntimeLayerError as JaxRuntimeLayerError
from polyaxon_tpu.parallel import templates as jtemplates
from polyaxon_tpu_torch.parallel import templates as ttemplates
from polyaxon_tpu_torch.runtime.mesh import build_mesh

STRATEGIES = ("ddp", "fsdp", "tp", "tp_dp", "pp", "pp_tp", "sp_ring", "ulysses", "ep", "custom",
              "no_such_strategy")
MESHES = {
    "data1": {"data": 1},
    "data4": {"data": 4},
    "seq1": {"sequence": 1},
    "data2_seq2": {"data": 2, "sequence": 2},
    "fsdp2_tensor2": {"fsdp": 2, "tensor": 2},
    "replica2_data2_tensor1": {"replica": 2, "data": 2, "tensor": 1},
    "data2_pipe2_tensor2": {"data": 2, "pipeline": 2, "tensor": 2},
    "pipe4": {"pipeline": 4},
    "expert2": {"expert": 2, "data": 2},
}
OPTIONS = {
    "none": None,
    "microbatches": {"num_microbatches": 8},
    "custom": {"rules": {"embed": "fsdp", "batch": "data"}, "batch_axes": ["data"],
               "ring_axis": "sequence", "pipeline_axis": None, "num_microbatches": 2},
}
FIELDS = ("name", "rules", "batch_axes", "ring_axis", "ulysses_axis", "pipeline_axis",
          "num_microbatches", "pipeline_composed", "options")


def _resolve(template_for, error, strategy, mesh, options):
    try:
        return template_for(strategy, dict(mesh), options), None
    except error as e:
        return None, str(e)


@pytest.mark.parametrize("options", list(OPTIONS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_template_for_matches_jax(strategy, mesh, options):
    axes, opts = MESHES[mesh], OPTIONS[options]
    jt, jerr = _resolve(jtemplates.template_for, JaxRuntimeLayerError, strategy, axes, opts)
    tt, terr = _resolve(ttemplates.template_for, ttemplates.RuntimeLayerError, strategy, axes,
                        opts)
    assert terr == jerr
    if jt is None:
        return
    for field in FIELDS:
        assert getattr(tt, field) == getattr(jt, field), field
    spec = jt.batch_spec()
    want = () if len(spec) == 0 else (spec[0] if isinstance(spec[0], tuple) else (spec[0],))
    assert tt.batch_spec() == want


@pytest.mark.parametrize("axes, groups, err", [
    ({"data": 0}, {}, "size 0"),
    ({"sequence": 2}, {}, "needs a torch.distributed group"),
    ({"sequence": 1}, {"sequence": "g"}, "takes no group"),
    ({"data": 1}, {"tensor": "g"}, "not in mesh axes"),
])
def test_build_mesh_refuses_what_it_cannot_hold(axes, groups, err):
    with pytest.raises(ttemplates.RuntimeLayerError, match=err):
        build_mesh(axes, groups=groups)


def test_one_card_mesh_needs_no_process_group():
    mesh = build_mesh({"data": 1, "sequence": 1})
    assert mesh.shape == {"data": 1, "sequence": 1} and mesh.size == 1
    assert mesh.rank("sequence") == 0 and mesh.group("sequence") is None
    ring = mesh.ring("sequence")
    assert (ring.rank, ring.size) == (0, 1) and mesh.ring("sequence") is ring
    with pytest.raises(ttemplates.RuntimeLayerError, match="no axis"):
        mesh.ring("tensor")
