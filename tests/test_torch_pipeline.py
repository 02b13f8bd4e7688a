"""The port's pipeline schedule and stage hop against the JAX package's, on
the CPU.

``pipeline_scan`` (``polyaxon_tpu_torch/parallel/pipeline.py``) runs on
thread ranks over gloo (``tests/torch_gang_ranks.py``), one stage a rank,
against the reference's ``pipeline_scan`` (``polyaxon_tpu/parallel/
pipeline.py:232-300``) on the conftest's virtual CPU devices, on a small
float32 block with an aux (``tanh(x·w + b)`` plus a term of the positions,
whose aux is the mean square of its output): the outputs, the aux, and the
grads of ``x`` and of every stage's layers of ``sum(out · do) + 0.7 · aux``,
for S = 2 and 4 stages and M = 1, 2 and 4 microbatches, and for a data
axis beside the pipeline (each data rank's loss takes its rows and its
share of the aux; the ranks' grads summed).  Rows of the batch have
positions of their own, so the positions a stage reads (the fed
microbatch's, as the reference's) are held too.  Tolerance: 1e-5 (float32,
summation order).  The reference's ``RuntimeLayerError`` s for layers that
do not divide into stages and batches that do not divide into microbatches
are the port's, word for word.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.exceptions import RuntimeLayerError as JaxRuntimeLayerError
from polyaxon_tpu.parallel import pipeline as jpipe
from polyaxon_tpu.runtime.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.parallel import pipeline as tpipe
from polyaxon_tpu_torch.parallel.collectives import send_to_next
from polyaxon_tpu_torch.parallel.templates import RuntimeLayerError, template_for
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from tests.torch_gang_ranks import run_mesh_ranks

D, T, LAYERS_PER_STAGE, AUX_WEIGHT = 8, 4, 2, 0.7
#: (stages, microbatches, data ranks)
SCHEDULES = [(2, 1, 1), (2, 2, 1), (2, 4, 1), (4, 1, 1), (4, 2, 1), (4, 4, 1), (2, 2, 2)]


def _inputs(S, M, n_data):
    rng = np.random.default_rng(S * 100 + M * 10 + n_data)
    L, B = S * LAYERS_PER_STAGE, 2 * M * n_data
    layers = {"w": rng.normal(size=(L, D, D)) * D ** -0.5, "b": rng.normal(size=(L, D)) * 0.1}
    x = rng.normal(size=(B, T, D))
    do = rng.normal(size=(B, T, D))
    positions = np.arange(B * T).reshape(B, T) % 7
    return ({k: v.astype(np.float32) for k, v in layers.items()}, x.astype(np.float32),
            do.astype(np.float32), positions.astype(np.int32))


def _jax_block(x, pos, layer):
    out = jnp.tanh(x @ layer["w"] + layer["b"]) + 0.01 * pos[..., None].astype(x.dtype)
    return out, jnp.mean(jnp.square(out))


def _torch_block(x, pos, layer):
    out = torch.tanh(x @ layer["w"] + layer["b"]) + 0.01 * pos[..., None].to(x.dtype)
    return out, out.square().mean()


@functools.lru_cache(maxsize=None)
def jax_pipeline(S, M, n_data):
    layers, x, do, positions = _inputs(S, M, n_data)
    axes = {"data": n_data, "pipeline": S} if n_data > 1 else {"pipeline": S}
    mesh = jax_build_mesh(axes, devices=jax.devices()[:S * n_data])
    batch_axes = ("data",) if n_data > 1 else None

    def loss(x, layers):
        out, aux = jpipe.pipeline_scan(_jax_block, x, jnp.asarray(positions), layers, mesh,
                                       axis="pipeline", num_microbatches=M,
                                       batch_axes=batch_axes, aux_fn=lambda a: a)
        return jnp.sum(out * do) + AUX_WEIGHT * aux, (out, aux)

    with mesh:
        (_, (out, aux)), (gx, glayers) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                                     has_aux=True))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in layers.items()})
    return (np.asarray(out), float(aux), np.asarray(gx),
            {k: np.asarray(v) for k, v in glayers.items()})


@pytest.mark.parametrize("S, M, n_data", SCHEDULES,
                         ids=[f"S{S}-M{M}" + (f"-data{d}" if d > 1 else "")
                              for S, M, d in SCHEDULES])
def test_pipeline_scan_matches_the_reference(S, M, n_data):
    layers, x, do, positions = _inputs(S, M, n_data)
    want_out, want_aux, want_gx, want_gl = jax_pipeline(S, M, n_data)
    axes = {"data": n_data, "pipeline": S} if n_data > 1 else {"pipeline": S}
    rows = x.shape[0] // n_data

    def rank_main(mesh, rank):
        s, d = mesh.rank("pipeline"), mesh.rank("data")
        mine = slice(d * rows, (d + 1) * rows)
        stage = {k: torch.from_numpy(v[s * LAYERS_PER_STAGE:(s + 1) * LAYERS_PER_STAGE].copy())
                 .requires_grad_(True) for k, v in layers.items()}
        xt = torch.from_numpy(x[mine].copy()).requires_grad_(True)
        out, aux = tpipe.pipeline_scan(_torch_block, xt, torch.from_numpy(positions[mine]),
                                       stage, mesh, axis="pipeline", num_microbatches=M,
                                       batch_axes=("data",), aux_fn=lambda a: a)
        loss = (out * torch.from_numpy(do[mine])).sum() + AUX_WEIGHT * aux / n_data
        loss.backward()
        return (s, d, out.detach().numpy(), float(aux.detach()), xt.grad.numpy(),
                {k: v.grad.numpy() for k, v in stage.items()})

    summed = {}
    for s, d, out, aux, gx, gl in run_mesh_ranks(axes, rank_main):
        mine = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(out, want_out[mine], atol=1e-5, rtol=0)
        np.testing.assert_allclose(aux, want_aux, atol=1e-6, rtol=0)
        np.testing.assert_allclose(gx, want_gx[mine], atol=1e-5, rtol=0)
        for k, g in gl.items():
            summed[s, k] = summed.get((s, k), 0) + g
    for (s, k), g in summed.items():  # a stage's layers' grads, summed over data ranks
        want = want_gl[k][s * LAYERS_PER_STAGE:(s + 1) * LAYERS_PER_STAGE]
        np.testing.assert_allclose(g, want, atol=1e-5, rtol=0)


def test_send_to_next_hops_a_stage_forward_and_its_grad_back():
    """Rank r receives rank r − 1's tensor (rank 0 zeros); the backward hands
    rank r the grad of what rank r + 1 received (the last rank zeros); a
    group of one is the identity."""

    def rank_main(mesh, rank):
        x = torch.full((2, 3), float(rank + 1), requires_grad=True)
        y = send_to_next(x, mesh.group("pipeline"))
        (y * (10.0 * (rank + 1))).sum().backward()
        return y.detach(), x.grad

    for rank, (y, gx) in enumerate(run_mesh_ranks({"pipeline": 3}, rank_main)):
        assert torch.equal(y, torch.full((2, 3), float(rank)))
        assert torch.equal(gx, torch.full((2, 3), 10.0 * (rank + 2) if rank < 2 else 0.0))
    x = torch.ones(3, requires_grad=True)
    assert send_to_next(x, None) is x


def _message(fn, error):
    with pytest.raises(error) as info:
        fn()
    return str(info.value)


def test_layers_and_microbatches_that_do_not_divide_raise_the_reference_errors():
    jmesh = jax_build_mesh({"pipeline": 2}, devices=jax.devices()[:2])
    block = lambda x, pos, layer: (x @ layer["w"], None)  # noqa: E731
    three = {"w": jnp.zeros((3, D, D))}
    want = _message(lambda: jpipe.pipeline_scan(block, jnp.zeros((2, T, D)),
                                                jnp.zeros((2, T), jnp.int32), three, jmesh),
                    JaxRuntimeLayerError)
    cfg = ttr.TransformerConfig(vocab_size=64, d_model=16, n_layers=3, n_heads=2, head_dim=8,
                                d_ff=32, dtype=torch.float32, attention_impl="dense")
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    two = SimpleNamespace(size=lambda: 2, rank=lambda: 0, name=lambda: "gloo")  # a group's stand-in
    got = _message(lambda: ttr.forward(params, torch.zeros((2, T), dtype=torch.long), cfg,
                                       template_for("pp", {"pipeline": 2}),
                                       build_mesh({"pipeline": 2}, groups={"pipeline": two}),
                                       device="cpu"), RuntimeLayerError)
    assert got == want == "3 layers not divisible into 2 pipeline stages"

    two_layers = {"w": jnp.zeros((2, D, D))}
    for composed in (False, True):
        fn = jpipe.pipeline_scan_composed if composed else jpipe.pipeline_scan
        want = _message(lambda: fn(block, jnp.zeros((3, T, D)), jnp.zeros((3, T), jnp.int32),
                                   two_layers, jmesh, num_microbatches=2), JaxRuntimeLayerError)
        tfn = tpipe.pipeline_scan_composed if composed else tpipe.pipeline_scan
        got = _message(lambda: tfn(block, torch.zeros(3, T, D), torch.zeros(3, T),
                                   {"w": torch.zeros(1, D, D)}, build_mesh({"pipeline": 1}),
                                   num_microbatches=2), RuntimeLayerError)
        assert got == want
        assert want.startswith("Global batch 3" if composed else "Local batch 3")
