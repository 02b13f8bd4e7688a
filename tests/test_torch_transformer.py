"""Parity of the port's transformer forward with the JAX package's.

Weights come from ``polyaxon_tpu.models.init_params`` and cross to torch
through numpy (``params_from_jax``); tokens come from numpy.  The config is
the bench's CPU-smoke shape in float32 on both sides, plus a GQA variant.
Tolerance: atol 1e-4 on logits and KV stacks (float32; the two frameworks
sum in different orders over d_model=64 and 2 layers).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import transformer as jtr
from polyaxon_tpu_torch.models import transformer as ttr
from polyaxon_tpu_torch.models.weights import params_from_jax
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.runtime.mesh import build_mesh
from tests.torch_parity import assert_tree_close, carried, grads_of

SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128, max_seq=64)
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}


def configs(variant, impl):
    kw = dict(SMALL, **VARIANTS[variant], attention_impl=impl)
    return (
        jtr.TransformerConfig(dtype=jnp.float32, **kw),
        ttr.TransformerConfig(dtype=torch.float32, **kw),
    )


def jax_params(jcfg, seed=0):
    params = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def tokens(seed, B=2, T=16, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("impl", ["flash", "dense"])
@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_forward_logits_and_kv_match_jax(variant, impl):
    jcfg, tcfg = configs(variant, impl)
    jp, tp = jax_params(jcfg)
    toks = tokens(1)
    jl, (jk, jv) = jtr.forward(jp, jnp.asarray(toks), jcfg, return_kv=True)
    tl, (tk, tv) = ttr.forward(tp, torch.from_numpy(toks).long(), tcfg, return_kv=True, device="cpu")
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 16, 256)
    assert tuple(tk.shape) == (2, 2, 16, tcfg.kv_heads, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


def test_auto_on_cpu_is_dense_and_matches_jax_auto():
    jcfg, tcfg = configs("mha", "auto")
    jp, tp = jax_params(jcfg, seed=3)
    toks = tokens(4, T=12)
    jl = jtr.forward(jp, jnp.asarray(toks), jcfg)
    tl = ttr.forward(tp, torch.from_numpy(toks).long(), tcfg, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_explicit_positions_match_jax():
    jcfg, tcfg = configs("gqa", "dense")
    jp, tp = jax_params(jcfg, seed=2)
    toks = tokens(5, T=8)
    pos = np.broadcast_to(np.arange(8, 16), (2, 8)).astype(np.int32)
    jl = jtr.forward(jp, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos))
    tl = ttr.forward(tp, torch.from_numpy(toks).long(), tcfg,
                     positions=torch.from_numpy(pos.copy()).long(), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


@pytest.mark.parametrize("helper", ["rmsnorm", "rope"])
def test_helpers_match_jax(helper):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    if helper == "rmsnorm":
        w = rng.standard_normal((16,)).astype(np.float32)
        j = jtr._rmsnorm(jnp.asarray(x), jnp.asarray(w))
        t = ttr._rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    else:
        pos = rng.integers(0, 1000, (2, 6))
        j = jtr._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
        t = ttr._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def _rope_with_a_tensor_base(x, positions, theta):
    """The rotary embedding as the port computed it before theta became a
    Python scalar: the base as a float32 tensor on x's device."""
    d = x.shape[-1]
    exponent = -torch.arange(0, d // 2, dtype=torch.float32, device=x.device) / (d // 2)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 64, 128])
def test_rope_with_a_scalar_base_is_bitwise_the_tensor_base(d, dtype):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((2, 7, 3, d)).astype(np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 16384, (2, 7)))
    for theta in (10000.0, 500000.0, 10000, 1e6):
        assert torch.equal(ttr._rope(x, pos, theta), _rope_with_a_tensor_base(x, pos, theta))


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_config_counts_and_init_layout_match_jax(variant):
    jcfg, tcfg = configs(variant, "auto")
    assert tcfg.n_params == jcfg.n_params
    jp = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0), jcfg))
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    # bench width: the 671M model's count
    big = ttr.TransformerConfig(vocab_size=32768, d_model=2048, n_layers=8, n_heads=32,
                                head_dim=64, d_ff=8192, max_seq=1024)
    assert big.n_params == jtr.TransformerConfig(
        vocab_size=32768, d_model=2048, n_layers=8, n_heads=32, head_dim=64,
        d_ff=8192, max_seq=1024).n_params


def test_bf16_leaves_cross_through_int16():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    tree = {"a": np.asarray(x), "b": (np.asarray(x), np.arange(3, dtype=np.int8))}
    t = params_from_jax(tree, "cpu")
    assert t["a"].dtype == torch.bfloat16 and t["b"][1].dtype == torch.int8
    np.testing.assert_array_equal(t["a"].float().numpy(), np.asarray(x, np.float32))
    assert params_from_jax(tree, "cpu", torch.float32)["b"][0].dtype == torch.float32


class _TwoRankGroup:
    """Stands in for a two-rank process group: what ``build_mesh`` reads."""

    def size(self):
        return 2

    def rank(self):
        return 0


def _mesh(**axes):
    return build_mesh(axes, groups={a: _TwoRankGroup() for a, n in axes.items() if n > 1})


@pytest.mark.parametrize(
    "kwargs, match",
    [
        # Every strategy runs now; what still refuses: a custom rule the port
        # does not split, a pipeline without its layers rule, MoE under a
        # custom pipeline with a tensor axis (MoE under pp_tp runs:
        # tests/test_torch_pipeline_step.py).
        (dict(template=template_for("custom", {"tensor": 2}, {"rules": {"head_dim": "tensor"}}),
              mesh=_mesh(tensor=2)), "multi-process and parallelism"),
        (dict(mesh=_mesh(data=2)), "multi-process and parallelism"),
        # ddp's batch axes and sp_ring's ring may span ranks; a tensor axis,
        # which neither template spreads over, may not.
        (dict(template=template_for("ddp", {"data": 2, "tensor": 2}), mesh=_mesh(data=2, tensor=2)),
         "multi-process and parallelism"),
        (dict(template=template_for("sp_ring", {"sequence": 2, "tensor": 2}),
              mesh=_mesh(sequence=2, tensor=2)), "multi-process and parallelism"),
        (dict(template=template_for("custom", {"pipeline": 2}, {"pipeline_axis": "pipeline"}),
              mesh=_mesh(pipeline=2)), "multi-process and parallelism"),
        (dict(template=template_for("custom", {"pipeline": 2, "tensor": 2}, {
            "pipeline_axis": "pipeline",
            "rules": {"layers": "pipeline", "heads": "tensor", "mlp": "tensor",
                      "vocab": "tensor"}}),
              mesh=_mesh(pipeline=2, tensor=2), cfg={"n_experts": 4}),
         "multi-process and parallelism"),
    ],
)
def test_unported_paths_raise(kwargs, match):
    kwargs = dict(kwargs)
    _, tcfg = configs("mha", "dense")
    tcfg = tcfg.scaled(**kwargs.pop("cfg", {}))
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match=match):
        ttr.forward(tp, torch.zeros((1, 4), dtype=torch.long), tcfg, device="cpu", **kwargs)


@pytest.mark.parametrize(
    "override, match",
    [({"n_experts": 4}, "MoE"), ({"n_experts": 4, "remat": True}, "MoE")],
    ids=["override0-MoE", "override1-remat"],
)
def test_unported_config_raises(override, match):
    """The two MoE configs this test once held to a refusal are ported: the
    model with 4 experts gives JAX's logits and routing (atol 1e-4, indices
    equal), and its loss with the balance term (atol 1e-5) and grads (atol
    1e-5), with ``remat`` off and on."""
    jcfg, tcfg = configs("mha", "dense")
    jcfg, tcfg = jcfg.scaled(**override), tcfg.scaled(**override)
    assert match == "MoE" and tcfg.n_experts == 4
    jp, tp = jax_params(jcfg)
    toks = tokens(4, T=17)
    jl, (jgates, jidx) = jtr.forward(jp, jnp.asarray(toks[:, :-1]), jcfg)
    tl, (tgates, tidx) = ttr.forward(tp, torch.from_numpy(toks[:, :-1]).long(), tcfg, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates), atol=1e-6)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tp = carried(jp)
    tloss = ttr.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                        device="cpu")
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=1e-5)
    assert_tree_close(grads_of(tloss, tp), jgrads, atol=1e-5)


def test_forward_raises_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-absent path; a card is present")
    _, tcfg = configs("mha", "dense")
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.forward(tp, torch.zeros((1, 4), dtype=torch.long), tcfg)
