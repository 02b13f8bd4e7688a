"""The port's CUDA kernels against their plain versions, and its serving
engine against the static ``generate``, on a card.

Marked ``cuda``: they skip without one.  With bf16 inputs the forward, the
dq pass and the dk/dv pass run their tensor-core kernels, with float32
inputs the FMA kernels, so each edge case appears in both types.  This
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: o atol 2e-2 (p is rounded to bf16 against the kernel's running
max, not the final one), lse atol 1e-3; float32 inputs 1e-5.  Backward
kernels: dq/dk/dv atol 2e-3 with bf16 inputs (the kernels and the plain
version round ds and p to bf16 at the same places; the kernels sum again,
in the plain order, each value of 2^-7 or more that a float32 difference in
summation order could round the other way, so only smaller ones may flip),
1e-4 with float32 inputs (summation order over up to 1000 terms).
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch.models import decode
from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
from polyaxon_tpu_torch.parallel import flash
from polyaxon_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# Head dims past {64, 128}: each other tile width, one padded to 16 (12),
# and the widths of Phi-2 (80), Phi-3-mini (96) and Gemma (256).
WIDE_DIMS = (8, 12, 32, 80, 96, 160, 256)
# Past 256 the wide kernels run: one column block past 256 (264), one padded
# from 300 to 304, and 512 and 1024.
HUGE_DIMS = (264, 300, 512, 1024)
# The bf16 forward and dk/dv kernels own 512 columns a block: past 512 their
# column blocks come back (520: a block of 8 columns; 768).
PAST_TILE_DIMS = (520, 768)
TYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize(
    "BH, Tq, Tk, d, dtype, causal",
    [
        (128, 512, 512, 64, torch.bfloat16, True),  # 671M prefill: B=4 x H=32, T=512
        (8, 1000, 1000, 64, torch.bfloat16, True),  # ragged tail
        (8, 300, 200, 64, torch.bfloat16, False),
        (16, 512, 512, 128, torch.bfloat16, True),
        (4, 100, 100, 64, torch.float32, True),
        (4, 70, 0, 128, torch.float32, False),  # empty key block
        # bf16 runs the tensor-core kernel: its edges
        (4, 70, 0, 64, torch.bfloat16, True),  # empty key block: lse = -inf, o = 0
        (4, 70, 0, 128, torch.bfloat16, False),
        *((8, T, T, 64, torch.bfloat16, True) for T in (1, 63, 65, 127, 129)),  # tile edges
        (8, 200, 300, 128, torch.bfloat16, True),  # causal, Tq < Tk
        (8, 300, 200, 128, torch.bfloat16, True),  # causal, Tq > Tk
        # every tile width (32, 64, 96, 128, 256), a head_dim padded to 16,
        # ragged ends, one row past a tile edge, Tq != Tk, both types
        *((8, 129, 129, d, dt, True) for d in WIDE_DIMS for dt in TYPES),
        *((8, 300, 200, d, dt, False) for d in WIDE_DIMS for dt in TYPES),
        (16, 1000, 1000, 256, torch.bfloat16, True),
        (4, 70, 0, 256, torch.bfloat16, True),  # empty key block
        # the wide kernels: causal and full, ragged ends, both types
        *((8, 129, 129, d, dt, True) for d in HUGE_DIMS for dt in TYPES),
        *((8, 300, 200, d, dt, False) for d in HUGE_DIMS for dt in TYPES),
        (16, 1000, 1000, 512, torch.bfloat16, True),
        (4, 70, 0, 512, torch.bfloat16, True),  # empty key block
        # past 512 columns a block; T one row past a 32-row key tile and a
        # 64-row query tile; a single query row
        *((8, 129, 129, d, dt, True) for d in PAST_TILE_DIMS for dt in TYPES),
        *((8, 300, 200, d, dt, False) for d in PAST_TILE_DIMS for dt in TYPES),
        *((8, T, T, 512, torch.bfloat16, True) for T in (33, 65)),
        (8, 1, 1, 512, torch.bfloat16, True),
        (8, 1, 200, 512, torch.bfloat16, False),
    ],
)
def test_flash_fwd_kernel_matches_plain(cuda, BH, Tq, Tk, d, dtype, causal):
    g = torch.Generator(device=cuda).manual_seed(Tq)
    q, k, v = (torch.randn(BH, t, d, generator=g, device=cuda).to(dtype) for t in (Tq, Tk, Tk))
    before = flash.flash_block_fwd.launches
    o, lse = flash.flash_block_fwd(q, k, v, causal=causal, sm_scale=d**-0.5)
    torch.cuda.synchronize()
    assert flash.flash_block_fwd.launches == before + 1
    ro, rlse = flash.flash_block_fwd_reference(q, k, v, causal=causal, sm_scale=d**-0.5)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(o, ro, atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    if Tk == 0:
        assert torch.all(o == 0) and torch.all(torch.isneginf(lse))


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts one element past 16 bytes."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_refuse_unaligned_pointers(cuda, dtype):
    """cp.async copies 16 bytes at a time: the wrappers raise before launching."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(2, 64, 64, generator=g, device=cuda).to(dtype) for _ in range(4))
    lse = torch.zeros(2, 64, device=cuda)
    before = (flash.flash_block_fwd.launches, flash.flash_block_dq.launches,
              flash.flash_block_dkv.launches)
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_block_fwd(q, _unaligned(k), v, causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_block_dq(_unaligned(q), k, v, do, lse, lse, causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="aligned"):
        flash.flash_block_dkv(q, k, v, _unaligned(do), lse, lse, causal=True, sm_scale=0.125)
    assert (flash.flash_block_fwd.launches, flash.flash_block_dq.launches,
            flash.flash_block_dkv.launches) == before


def test_flash_fwd_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash.flash_block_fwd(q, q, q, causal=True, sm_scale=1.0)
    # Under autograd, grads now flow through the kernels (forward, dq, dk/dv).
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 80, 3, 64, generator=g, device=cuda).requires_grad_(True)
               for _ in range(3))
    before = (flash.flash_block_fwd.launches, flash.flash_block_dq.launches,
              flash.flash_block_dkv.launches)
    out = flash.flash_attention(q, k, v, 0.125)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (flash.flash_block_fwd.launches, flash.flash_block_dq.launches,
            flash.flash_block_dkv.launches) == tuple(n + 1 for n in before)
    qc, kc, vc = (x.detach().cpu().requires_grad_(True) for x in (q, k, v))
    # The reference on one CPU thread: under a cap of two its float32 sums
    # split by thread and take one of two orders, whose grads differ by up to
    # 8.4e-4 here; one thread sums in one order in every process.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = torch.autograd.grad(flash.flash_attention(qc, kc, vc, 0.125, device="cpu")
                                  .square().sum(), (qc, kc, vc))
    finally:
        torch.set_num_threads(threads)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def _bwd_inputs(device, BH, Tq, Tk, d, dtype, causal, seed):
    """Inputs of one backward call: q, k, v, do, and the forward's lse and
    delta = rowsum(do ⊙ o) from the plain forward."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn(BH, Tq, d, generator=g, device=device).to(dtype) for _ in range(2))
    k, v = (torch.randn(BH, Tk, d, generator=g, device=device).to(dtype) for _ in range(2))
    o, lse = flash.flash_block_fwd_reference(q, k, v, causal=causal, sm_scale=d**-0.5)
    delta = (do.float() * o.to(dtype).float()).sum(-1)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize(
    "BH, Tq, Tk, d, dtype, causal",
    [
        (640, 1024, 1024, 64, torch.bfloat16, True),  # 671M training: B=20 x H=32, T=1024
        (8, 1000, 1000, 64, torch.bfloat16, True),  # ragged tail
        (8, 300, 200, 128, torch.float32, False),  # non-causal, Tq != Tk, d = 128, f32
        (8, 200, 300, 128, torch.bfloat16, True),  # causal, Tq < Tk
        (4, 70, 0, 64, torch.float32, False),  # empty key block
        # bf16 runs the tensor-core dq and dk/dv kernels: their edges
        *((8, T, T, 64, torch.bfloat16, True) for T in (1, 63, 65, 127, 129)),  # tile edges
        (8, 300, 200, 128, torch.bfloat16, True),  # causal, Tq > Tk
        (8, 129, 129, 128, torch.bfloat16, False),  # d = 128 tile edge, non-causal
        (4, 70, 0, 64, torch.bfloat16, False),  # empty key block
        # Large enough that, without the kernels' rounding screen, some ds
        # would certainly round to another bf16 value than in the plain version.
        (64, 1024, 1024, 128, torch.bfloat16, True),
        (64, 1024, 1024, 64, torch.bfloat16, False),
        # every tile width, a head_dim padded to 16, ragged ends, one row
        # past a tile edge, Tq != Tk, both types; the screen at d 96 and 256
        *((8, 129, 129, d, dt, True) for d in WIDE_DIMS for dt in TYPES),
        *((8, 300, 200, d, dt, False) for d in WIDE_DIMS for dt in TYPES),
        (64, 1024, 1024, 96, torch.bfloat16, True),
        (32, 1024, 1024, 256, torch.bfloat16, True),
        (4, 70, 0, 256, torch.bfloat16, False),  # empty key block
        # the wide kernels: causal and full, ragged ends, both types; the
        # screen at d 512 over many pairs
        *((8, 129, 129, d, dt, True) for d in HUGE_DIMS for dt in TYPES),
        *((8, 300, 200, d, dt, False) for d in HUGE_DIMS for dt in TYPES),
        (16, 1024, 1024, 512, torch.bfloat16, True),
        (4, 70, 0, 512, torch.bfloat16, False),  # empty key block
        # past 512 columns a block; T one row past a 32-row tile and a 64-row
        # tile; a single query row
        *((8, 129, 129, d, dt, True) for d in PAST_TILE_DIMS for dt in TYPES),
        *((8, 300, 200, d, dt, False) for d in PAST_TILE_DIMS for dt in TYPES),
        *((8, T, T, 512, torch.bfloat16, True) for T in (33, 65)),
        (8, 1, 1, 512, torch.bfloat16, True),
        (8, 1, 200, 512, torch.bfloat16, False),
    ],
)
def test_flash_bwd_kernels_match_plain(cuda, BH, Tq, Tk, d, dtype, causal):
    q, k, v, do, lse, delta = _bwd_inputs(cuda, BH, Tq, Tk, d, dtype, causal, Tq + Tk)
    before = (flash.flash_block_dq.launches, flash.flash_block_dkv.launches)
    grads = flash.flash_block_bwd(q, k, v, do, lse, delta, causal=causal, sm_scale=d**-0.5)
    torch.cuda.synchronize()
    assert (flash.flash_block_dq.launches, flash.flash_block_dkv.launches) == (
        before[0] + 1, before[1] + (1 if Tk else 0))
    ref = flash.flash_block_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                          sm_scale=d**-0.5)
    atol = 2e-3 if dtype == torch.bfloat16 else 1e-4
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        torch.testing.assert_close(got, want, atol=atol, rtol=0, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_zero_rows_with_lse_minus_inf(cuda, dtype):
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 4, 130, 90, 64, dtype, False, 1)
    lse[1, 5] = lse[2, 64:] = float("-inf")
    grads = flash.flash_block_bwd(q, k, v, do, lse, delta, causal=False, sm_scale=0.125)
    ref = flash.flash_block_bwd_reference(q, k, v, do, lse, delta, causal=False, sm_scale=0.125)
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    assert torch.all(grads[0][1, 5] == 0) and torch.all(grads[0][2, 64:] == 0)
    atol = 2e-3 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize(
    "BH, Tq, Tk, d, causal",
    [
        (8, 1, 1, 64, True),
        (8, 65, 65, 64, True),
        (8, 129, 129, 128, True),
        (8, 200, 300, 128, True),
        (8, 300, 200, 64, True),
        (8, 300, 200, 128, False),
        (4, 70, 0, 64, False),
        # the C entry points take multiples of 8 (the wrappers pad the rest)
        *((8, 129, 129, d, True) for d in (8, 32, 80, 96, 160, 256, 264, 512, 520, 768, 1024)),
        (8, 300, 200, 256, False),
        (8, 300, 200, 512, False),
        (8, 33, 33, 512, True),
        (8, 1, 200, 768, False),
    ],
)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_write_every_output_element(cuda, BH, Tq, Tk, d, causal, dtype):
    """Outputs filled with NaN before the launch hold no NaN after it: every
    element of o, lse, dq, dk and dv is written (lse may be -inf)."""
    q, k, v, do, lse, delta = _bwd_inputs(cuda, BH, Tq, Tk, d, dtype, causal, Tq + 3)
    scale = d**-0.5
    o, l = torch.full((BH, Tq, d), math.nan, device=cuda), torch.full((BH, Tq), math.nan, device=cuda)
    flash._launch_fwd(q, k, v, o, l, causal, scale)
    dq = torch.full(q.shape, math.nan, device=cuda)
    dk, dv = (torch.full(k.shape, math.nan, device=cuda) for _ in range(2))
    fn_dq, fn_dkv = flash._bwd_kernel_fns()
    flash._launch_bwd(fn_dq, "dq", q, k, v, do, lse, delta, (dq,), causal, scale)
    if Tk:
        flash._launch_bwd(fn_dkv, "dk/dv", q, k, v, do, lse, delta, (dk, dv), causal, scale)
    torch.cuda.synchronize()
    for name, x in (("o", o), ("lse", l), ("dq", dq), ("dk", dk), ("dv", dv)):
        assert not bool(torch.isnan(x).any()), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_are_deterministic(cuda, dtype, d=64):
    """No atomics: two runs on the same inputs give bitwise the same o, lse,
    dq, dk and dv."""
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 16, 300, 300, d, dtype, True, 7)
    runs = []
    for _ in range(2):
        o, l = flash.flash_block_fwd(q, k, v, causal=True, sm_scale=0.125)
        runs.append((o, l, *flash.flash_block_bwd(q, k, v, do, lse, delta, causal=True,
                                                  sm_scale=0.125)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [96, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_are_deterministic_at_wide_head_dims(cuda, dtype, d):
    """The same at tile widths 96 and 256 (where the dk/dv pass splits its
    output columns over two blocks) and at 512 (the wide kernels: the
    forward and dk/dv own all 512 columns in one block and exchange partial
    scores through shared memory, dq splits them over four blocks)."""
    test_flash_kernels_are_deterministic(cuda, dtype, d)


def test_paged_engine_matches_static_generate(cuda):
    """The serving engine on a small float32 model on the card (the
    reference tests' widths): greedy tokens equal the static ``generate``'s
    with dense attention, request for request, with prefix reuse,
    copy-on-write, chunked prefill and speculative decoding on; no flash
    kernel runs and no block leaks.  The prompt that holds every token id
    makes the 1-gram drafter propose at its first step, whatever the
    model picks."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
                            max_seq=96, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    pre = rng.integers(0, 64, 16).tolist()
    traffic = [(rng.integers(0, 64, t).tolist(), n) for t, n in ((3, 8), (17, 9), (25, 6))]
    traffic += [(list(range(64)), 12), (pre + [1, 2, 3], 6), (pre + [1, 4], 7), (pre, 5)]
    before = flash.flash_block_fwd.launches
    engine = ServingEngine(params, cfg, slots=2, block_size=8, prefill_chunk=8, spec_decode=True,
                           spec_k=4, spec_min_ngram=1, device=cuda).start()
    try:
        outs = [engine.submit(p, n).wait(timeout=120) for p, n in traffic]
        stats = engine.stats()
    finally:
        engine.stop()
    dense = cfg.scaled(attention_impl="dense")  # "auto" would take the kernel for the prefill
    assert outs == [decode.generate(params, torch.tensor([p], device=cuda), dense,
                                    max_new_tokens=n, device=cuda)[0].tolist() for p, n in traffic]
    assert stats["cow_copies"] >= 1 and stats["prefix_cache_hits"] >= 4
    assert stats["spec_steps"] > 0 and stats["spec_proposed_total"] > 0
    assert stats["blocks_total"] - stats["blocks_free"] == stats["prefix_cache_blocks"]
    assert flash.flash_block_fwd.launches == before


@pytest.mark.parametrize("B", [1, 2])
def test_flash_attention_op_matches_plain_on_the_cpu(cuda, B):
    """The attention op through the three kernels (float32 FMA kernels) at a
    batch of one and of two: out and the q/k/v grads against the same op on
    the CPU, where it runs the plain versions (atol 1e-5 and 1e-4: summation
    order).  A batch of one once handed the kernels a strided view."""
    g = torch.Generator().manual_seed(B)
    q, k, v, do = (torch.randn(B, 200, 4, 64, generator=g) for _ in range(4))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        out = flash.flash_attention(*leaves, 64**-0.5, device=dev)
        grads[str(dev)] = (out, *torch.autograd.grad(out, leaves, do.to(dev)))
    for i, (got, want) in enumerate(zip(grads["cuda"], grads["cpu"])):
        torch.testing.assert_close(got.cpu(), want, atol=1e-5 if i == 0 else 1e-4, rtol=0)


def test_auto_attention_at_head_dim_8_gives_the_jax_logits(cuda):
    """``attention_impl="auto"`` at head_dim 8, the reference tests' width:
    the kernels take every head_dim from 1 to 256, so ``forward`` and the
    prefill of greedy ``generate`` run the forward kernel (float32, the FMA
    kernel at tile width 32), once a layer each, and give the JAX package's
    logits (atol 1e-4, float32) and tokens, stored beside
    ``tests/torch_head_dim8.py``.  ``"flash"`` runs the same kernel, and
    ``"dense"`` none, to the same logits."""
    from polyaxon_tpu_torch.models.transformer import forward
    from polyaxon_tpu_torch.models.weights import params_from_jax
    from tests import torch_head_dim8 as hd8

    stored = np.load(hd8.JAX_OUTPUTS)
    cfg = TransformerConfig(dtype=torch.float32, **hd8.CFG)
    assert cfg.attention_impl == "auto"
    params = params_from_jax(hd8.numpy_params(), cuda)
    prompt = torch.from_numpy(hd8.prompt()).to(cuda)
    before = flash.flash_block_fwd.launches
    with torch.inference_mode():
        logits = forward(params, prompt, cfg, device=cuda)
    torch.cuda.synchronize()
    assert flash.flash_block_fwd.launches == before + cfg.n_layers
    tokens = decode.generate(params, prompt, cfg, max_new_tokens=hd8.NEW_TOKENS, device=cuda)
    assert flash.flash_block_fwd.launches == before + 2 * cfg.n_layers
    np.testing.assert_allclose(logits.cpu().numpy(), stored["logits"], atol=1e-4)
    np.testing.assert_array_equal(tokens.cpu().numpy(), stored["tokens"])
    for impl, launched in (("flash", cfg.n_layers), ("dense", 0)):
        before = flash.flash_block_fwd.launches
        with torch.inference_mode():
            out = forward(params, prompt, cfg.scaled(attention_impl=impl), device=cuda)
        assert flash.flash_block_fwd.launches == before + launched, impl
        np.testing.assert_allclose(out.cpu().numpy(), stored["logits"], atol=1e-4, err_msg=impl)


@pytest.mark.parametrize("Hkv, d", [(2, 64), (4, 128)])
def test_ring_hops_on_threads_match_the_plain_hops(cuda, monkeypatch, Hkv, d):
    """The flash ring's hop functions for 4 ranks as threads of one process
    on the card (bf16, B 1, T 4 x 128, H 4): the kernels' o/lse against the
    same hops with the plain forward swapped in, and their dq/dk/dv against
    the plain backward after the same forward, at the kernels' limits."""
    from polyaxon_tpu_torch.parallel.ring import LocalRing

    B, n, Tl, H = 1, 4, 128, 4
    g = torch.Generator(device=cuda).manual_seed(Hkv + d)
    q, do = (torch.randn(B, n * Tl, H, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, n * Tl, Hkv, d, generator=g, device=cuda).bfloat16() for _ in range(2))

    def hops(ring, out_lse=None):
        sl = slice(ring.rank * Tl, (ring.rank + 1) * Tl)
        o, lse = out_lse[ring.rank] if out_lse else flash.ring_flash_fwd(
            q[:, sl], k[:, sl], v[:, sl], d**-0.5, ring)
        grads = flash.ring_flash_bwd(q[:, sl], k[:, sl], v[:, sl], o.bfloat16(), lse, do[:, sl],
                                     d**-0.5, ring)
        return o, lse, *grads

    before = flash.flash_block_fwd.launches, flash.flash_block_dkv.launches
    kernel = LocalRing.run(n, hops)
    torch.cuda.synchronize()
    # 10 visible blocks over 4 ranks (diagonal and earlier blocks)
    assert flash.flash_block_fwd.launches - before[0] == 10
    assert flash.flash_block_dkv.launches - before[1] == 10
    monkeypatch.setattr(flash, "flash_block_fwd", flash.flash_block_fwd_reference)
    plain_fwd = LocalRing.run(n, hops)
    monkeypatch.setattr(flash, "flash_block_bwd", flash.flash_block_bwd_reference)
    plain_bwd = LocalRing.run(n, lambda ring: hops(ring, [r[:2] for r in kernel]))
    for r in range(n):
        assert (kernel[r][0] - plain_fwd[r][0]).abs().max().item() <= 2e-2
        assert (kernel[r][1] - plain_fwd[r][1]).abs().max().item() <= 1e-3
        for got, want in zip(kernel[r][2:], plain_bwd[r][2:]):
            assert got.shape == want.shape and (got - want).abs().max().item() <= 2e-3


def _small_train(cuda, mu_dtype=torch.bfloat16):
    """A small bf16-compute model at head_dim 64 (so the kernels run), its
    train step, state and batch on the card."""
    from polyaxon_tpu_torch.models.transformer import loss_fn
    from polyaxon_tpu_torch.runtime.optim import AdamW
    from polyaxon_tpu_torch.runtime.train import build_train_step

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2, head_dim=64,
                            d_ff=256, max_seq=128)
    ts = build_train_step(loss_fn=lambda p, b: loss_fn(p, b, cfg, device=cuda),
                          init_fn=lambda g: init_params(cfg, g),
                          optimizer=AdamW(1e-3, mu_dtype=mu_dtype))
    params, opt = ts.init(torch.Generator(device=cuda).manual_seed(0))
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 129)), device=cuda)
    return cfg, ts, params, opt, {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def _host_copy(tree):
    from polyaxon_tpu_torch.runtime.checkpoint import _flatten

    return {k: v.detach().cpu().clone() for k, v in _flatten(tree).items()}


def test_checkpoint_round_trip_on_the_card_is_bitwise(cuda, tmp_path):
    """Params (float32) and AdamW state (bf16 mu) saved from the card and
    restored into card templates: the same bits, on the card, in their dtypes."""
    from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager

    _, ts, params, opt, batch = _small_train(cuda)
    for _ in range(2):
        params, opt, _ = ts.step(params, opt, batch)
    want = (_host_copy(params), _host_copy(opt))
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.save(1, params, opt)
    fresh_params, fresh_opt = ts.init(torch.Generator(device=cuda).manual_seed(9))
    restored = mgr.restore(fresh_params, fresh_opt)
    mgr.close()
    assert restored["step"] == 1 and restored["opt_state"].count == 2
    assert all(m.dtype == torch.bfloat16 and m.is_cuda for m in restored["opt_state"].mu)
    for tree, ref in zip((restored["params"], restored["opt_state"]), want):
        got = _host_copy(tree)
        assert got.keys() == ref.keys()
        for path in ref:
            assert got[path].dtype == ref[path].dtype and torch.equal(got[path], ref[path]), path


def test_a_save_on_the_card_is_the_step_it_was_given(cuda, tmp_path, monkeypatch):
    """The staging hazard on the card: the write is held back until the next
    (in-place) step has run; the checkpoint still holds the saved step."""
    import threading

    from polyaxon_tpu_torch.runtime.checkpoint import CheckpointManager

    release = threading.Event()
    write = CheckpointManager._write
    monkeypatch.setattr(CheckpointManager, "_write",
                        lambda self, *a: (release.wait(60), write(self, *a))[1])
    _, ts, params, opt, batch = _small_train(cuda)
    params, opt, _ = ts.step(params, opt, batch)
    want = (_host_copy(params), _host_copy(opt))
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.save(0, params, opt)
    params, opt, _ = ts.step(params, opt, batch)
    torch.cuda.synchronize()
    release.set()
    restored = mgr.restore(*ts.init(torch.Generator(device=cuda).manual_seed(9)))
    mgr.close()
    assert restored["opt_state"].count == 1
    for tree, ref in zip((restored["params"], restored["opt_state"]), want):
        got = _host_copy(tree)
        for path in ref:
            assert torch.equal(got[path], ref[path]), path


def kernel_launches_in_trace(path):
    """Kernel events of a Chrome trace by the port's kernel names."""
    import json

    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names)
            for k in ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                      "flash_bwd_dkv_bf16_kernel")}


def test_step_profiler_trace_names_the_three_kernels(cuda, tmp_path):
    """A StepProfiler window over one train step: its trace holds each of
    the three bf16 kernels once per layer."""
    from polyaxon_tpu_torch.tracking.profiling import StepProfiler

    cfg, ts, params, opt, batch = _small_train(cuda)
    prof = StepProfiler(tmp_path, start_step=1, num_steps=1)
    for step in range(3):
        prof.on_step(step)
        params, opt, _ = ts.step(params, opt, batch)
    torch.cuda.synchronize()
    prof.close()
    (trace,) = (tmp_path / "profile").glob("*.pt.trace.json")
    assert kernel_launches_in_trace(trace) == dict.fromkeys(
        ("flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel"),
        cfg.n_layers)


def _family_engines(cuda, kv, **kw):
    """A graphed engine and an eager one (the private ``_eager`` switch) over
    the same bf16 weights, with the same random KV in both pools."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
                            max_seq=64, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
    kw = dict(slots=3, max_len=64, block_size=8, spec_decode=True, spec_k=4, kv_quantize=kv,
              warmup=False, device=cuda, **kw)
    graphed = ServingEngine(params, cfg, **kw)
    eager = ServingEngine(params, cfg, _eager=True, **kw)
    g = torch.Generator(device=cuda).manual_seed(2)
    for name, leaf in graphed._pool.items():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, device=cuda))
        elif name.endswith("_scale"):
            leaf.copy_(torch.rand(leaf.shape, generator=g, device=cuda) / 64)
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda))
        eager._pool[name].copy_(leaf)
    return graphed, eager


@pytest.mark.parametrize("kv", [None, "int8"])
def test_each_captured_entry_matches_its_eager_step(cuda, kv):
    """Every member of the family (the decode step, each chunk bucket, each
    verify width) replayed from its CUDA graph gives the eager step's logits
    (same argmax, within 1e-3 of the largest logit) and leaves the same pool,
    the trash block 0 aside (several rows land there in an order the card
    does not fix)."""
    graphed, eager = _family_engines(cuda, kv, prefill_chunk=32)
    rng = np.random.default_rng(3)
    W = graphed._table_width
    tables = 1 + rng.permutation(3 * W).reshape(3, W)
    pos = np.array([37, 5, 60])
    active = np.array([True, True, False])
    tok = rng.integers(0, 64, 3)
    calls = [("decode", lambda e: e._get_step()(tables=tables, tokens=tok, pos=pos,
                                                active=active))]
    for c_pad in graphed._warmup_buckets():
        n = max(1, c_pad - 3)
        chunk = rng.integers(0, 64, n)
        calls.append((f"chunk {c_pad}", lambda e, chunk=chunk: e._chunk(tables[1], chunk, 2)))
    for width in graphed._spec_widths():
        tok_in = rng.integers(0, 64, (3, width))
        n_tok = np.array([width, 1, width])
        calls.append((f"verify {width}", lambda e, t=tok_in, n=n_tok: e._get_verify(t.shape[1])(
            tables=tables, tokens=t, pos=np.array([20, 3, 9]), n_tok=n, active=active)))
    for label, call in calls:
        a = call(graphed).clone()
        b = call(eager)
        torch.cuda.synchronize()
        assert torch.equal(a.argmax(-1), b.argmax(-1)), label
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item(), label
        for name, leaf in graphed._pool.items():
            assert torch.equal(leaf[:, 1:], eager._pool[name][:, 1:]), (label, name)
    assert graphed._step_fn.graph is not None and eager._step_fn.graph is None
    assert graphed._compiled_count() == eager._compiled_count() == len(calls)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_generate_matches_the_eager_loop(cuda, temperature):
    """``generate`` on the card (one captured step, replayed) against a loop
    of eager one-token steps at int positions that picks the same way from
    a generator seeded the same: the same tokens, greedy and sampled."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
                            max_seq=64, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(4))
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, 64, (3, 9)), device=cuda)
    out = decode.generate(params, prompt, cfg, max_new_tokens=20, temperature=temperature,
                          generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    cache = decode.init_cache(cfg, 3, 29, cuda)
    logits, cache = decode.prefill(params, prompt, cache, cfg, device=cuda)
    want = []
    for i in range(20):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            want.append(torch.multinomial(probs, 1, generator=gen)[:, 0])
        else:
            want.append(logits.argmax(-1))
        if i < 19:
            logits, cache = decode.decode_step(params, cache, want[-1], 9 + i, cfg)
    assert torch.equal(out, torch.stack(want, dim=1))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_no_capture_after_ready_under_mixed_traffic(cuda, kv):
    """With the warmup on, the whole family is captured before the gate:
    mixed prompt lengths (every chunk bucket), speculative runs of every
    width and sampled requests build nothing more, ``steady_state_compiles``
    stays 0, and the greedy requests give the eager engine's tokens."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
                            max_seq=96, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(7)
    traffic = [(rng.integers(0, 64, t).tolist(), n, temp) for t, n, temp in
               ((3, 8, 0.0), (17, 9, 0.0), (40, 6, 0.7), (70, 5, 0.0), (9, 12, 0.0))]
    traffic.append((list(range(64)), 12, 0.0))  # the 1-gram drafter proposes at once
    outs = []
    for eager in (False, True):
        engine = ServingEngine(params, cfg, slots=3, block_size=8, prefill_chunk=32,
                               spec_decode=True, spec_k=4, spec_min_ngram=1, kv_quantize=kv,
                               warmup=True, device=cuda, _eager=eager).start()
        try:
            assert engine.wait_ready(timeout=300)
            built = engine._compiled_count()
            reqs = [engine.submit(p, n, temp) for p, n, temp in traffic]
            outs.append([r.wait(timeout=120) for r in reqs])
            stats = engine.stats()
        finally:
            engine.stop()
        assert built == 1 + len(engine._warmup_buckets()) + len(engine._spec_widths())
        assert engine._compiled_count() == built and stats["steady_state_compiles"] == 0
        assert stats["spec_steps"] > 0 and stats["warmup"]["done"] == stats["warmup"]["total"]
        assert (engine._step_fn.graph is None) == eager
    greedy = [i for i, (_, _, temp) in enumerate(traffic) if temp == 0]
    assert [outs[0][i] for i in greedy] == [outs[1][i] for i in greedy]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_spill_and_restore_copies_move_the_pool_rows_bit_for_bit(cuda, kv):
    """The host tier's copies on the card: an export of scattered blocks
    gives pinned payloads equal to the pool's rows in its storage dtypes,
    and an import writes them into other blocks in place (the pool's leaves
    keep their addresses, which the captured steps hold)."""
    graphed, _ = _family_engines(cuda, kv, kv_offload=True)
    pool = graphed._pool
    addresses = {name: leaf.data_ptr() for name, leaf in pool.items()}
    blocks = [5, 2, 9]
    payloads = graphed._export_blocks(blocks)
    for b, data in zip(blocks, payloads):
        for name, t in data.items():
            assert t.is_pinned() and t.device.type == "cpu" and t.dtype == pool[name].dtype
            assert torch.equal(t, pool[name][:, b].cpu()), name
    graphed._import_blocks([11, 3, 7], payloads)
    torch.cuda.synchronize()
    for src, dst in zip(blocks, [11, 3, 7]):
        for name, leaf in pool.items():
            assert torch.equal(leaf[:, dst], leaf[:, src]), name
    # payloads outside pinned memory (a store's) go through one pinned stack
    graphed._import_blocks([12, 13], [{n: t.clone() for n, t in d.items()} for d in payloads[:2]])
    torch.cuda.synchronize()
    for src, dst in zip(blocks, [12, 13]):
        for name, leaf in pool.items():
            assert torch.equal(leaf[:, dst], leaf[:, src]), name
    assert {name: leaf.data_ptr() for name, leaf in pool.items()} == addresses
    figures = graphed._copy_figures()
    assert figures["spill"]["blocks"] == 3 and figures["restore"]["blocks"] == 5
    assert figures["spill"]["bytes"] * 5 == figures["restore"]["bytes"] * 3 > 0
    assert figures["spill"]["copy_s"] > 0 and figures["restore"]["copy_s"] > 0


@pytest.mark.parametrize("kv", [None, "int8"])
def test_an_oversubscribed_graphed_engine_spills_and_gives_the_ample_tokens(cuda, kv):
    """Four requests of 4 blocks each against 8 usable blocks, the tier
    armed, the step family captured: no shed, blocks spilled and restored,
    nothing built after ready, and the tokens of an engine whose pool never
    fills, request by request."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
                            max_seq=48, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(2))
    rng = np.random.default_rng(40)
    prompts = [rng.integers(0, 64, 8).tolist() for _ in range(4)]
    outs, stats = [], []
    for kw in (dict(num_blocks=9, kv_offload=True), {}):
        engine = ServingEngine(params, cfg, slots=4, max_len=48, block_size=4,
                               prefix_cache=False, kv_quantize=kv, warmup=True, device=cuda,
                               **kw).start()
        try:
            assert engine.wait_ready(timeout=300)
            reqs = [engine.submit(p, 8) for p in prompts]
            outs.append([r.wait(timeout=120) for r in reqs])
            stats.append(engine.stats())
        finally:
            engine.stop()
    assert outs[0] == outs[1]
    s = stats[0]
    assert s["requests_shed"] == 0 and s["steady_state_compiles"] == 0
    assert s["host_spilled_blocks_total"] > 0 and s["host_restored_blocks_total"] > 0
    assert s["blocks_free"] == s["blocks_total"] and s["host_tier_blocks"] == 0


@pytest.mark.parametrize("kv", [None, "int8"])
def test_demoted_prefixes_restore_under_the_captured_family(cuda, kv):
    """Prefix reuse with a pool that must demote cold prefixes to admit new
    ones, and later hits that restore them inside admission (one export per
    demotion, one in-place import per restore, between replays of the
    captured steps): the tokens of an engine whose pool never fills,
    request by request, and nothing built after ready."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
                            max_seq=48, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(3))
    rng = np.random.default_rng(33)
    pre = [int(x) for x in rng.integers(0, 64, 12)]
    other = [int(x) for x in rng.integers(0, 64, 16)]
    traffic = [(pre + [1, 2], 6), (other, 6), (pre + [3], 6), (other[:8] + [4, 5], 6),
               (pre, 5), (other + [6], 4), (pre + [1, 2], 6)]
    outs, stats = [], []
    for kw in (dict(num_blocks=9, kv_offload=True), {}):
        engine = ServingEngine(params, cfg, slots=1, max_len=48, block_size=4, prefix_cache=True,
                               kv_quantize=kv, warmup=True, device=cuda, **kw).start()
        try:
            assert engine.wait_ready(timeout=300)
            assert engine._step_fn.graph is not None
            outs.append([engine.submit(p, n).wait(timeout=120) for p, n in traffic])
            stats.append(engine.stats())
        finally:
            engine.stop()
    assert outs[0] == outs[1]
    s = stats[0]
    assert s["prefix_cache_demotions"] > 0 and s["prefix_cache_restores"] > 0
    assert s["host_spilled_blocks_total"] > 0 and s["host_restored_blocks_total"] > 0
    assert s["requests_shed"] == 0 and s["steady_state_compiles"] == 0
    assert stats[1]["prefix_cache_demotions"] == 0


_CAPTURE_UNDER_COLLECTION = r'''
import gc, json, sys, weakref
import torch
from polyaxon_tpu_torch.models import decode


# One CUDA object in a reference cycle, as a stopped engine holds them (its
# step entries and prefix-cache callbacks close over it): a replayed graph
# (a step entry's), a pinned buffer that a non-blocking copy on a side
# stream filled (a spill's staging buffer), or timing events (the copies'
# clock).
def garbage(kind):
    if kind == "graph":
        x = torch.zeros(4, device="cuda")
        obj = torch.cuda.CUDAGraph()
        with torch.cuda.graph(obj, capture_error_mode="thread_local"):
            y = x + 1
        obj.replay()
        box = [obj, x, y]
    elif kind == "pinned":
        stream = torch.cuda.Stream()
        rows = torch.ones(1 << 20, device="cuda")
        obj = torch.empty(1 << 20, pin_memory=True)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            obj.copy_(rows, non_blocking=True)
        box = [obj, rows]
    else:
        obj, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        obj.record()
        end.record()
        box = [obj, end]
    torch.cuda.synchronize()
    box.append(box)
    return [box], weakref.ref(obj)


def capture(kind, guarded):
    holder, ref = garbage(kind)
    x = torch.arange(8.0, device="cuda")
    during, freed = [], []

    def seen(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during.append(info["generation"])

    def fn():
        holder.clear()  # the cycle becomes garbage inside the capture
        junk = [[] for _ in range(20000)]  # allocations: the collector's trigger
        del junk
        if not guarded:
            gc.collect()  # a full collection, as the trigger may start one
        freed.append(ref() is None)
        return x * 2

    gc.callbacks.append(seen)
    gc.set_threshold(1, 1, 1)
    try:
        if guarded:
            graph, out = decode.capture_step(fn, warmup=0)
        else:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn()
        graph.replay()
        torch.cuda.synchronize()
        result = "ok" if torch.equal(out, x * 2) else "wrong output"
    except Exception as e:
        result = type(e).__name__ + ": " + str(e).splitlines()[0]
    finally:
        gc.set_threshold(700, 10, 10)
        gc.callbacks.remove(seen)
    return {"result": result, "collections_in_capture": len(during),
            "freed_in_capture": freed == [True]}


print(json.dumps(capture(sys.argv[1], sys.argv[2] == "guarded")))
'''


def _capture_under_collection(kind, guarded):
    proc = subprocess.run(
        [sys.executable, "-c", _CAPTURE_UNDER_COLLECTION, kind,
         "guarded" if guarded else "plain"],
        capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("guarded", [False, True])
def test_a_collection_inside_a_capture_invalidates_it_and_capture_step_holds_it_off(cuda,
                                                                                   guarded):
    """A garbage collection inside a capture that frees a CUDA graph (a
    stopped engine's step entries are such garbage) invalidates the
    capture.  The garbage is made while capturing, with the collector on
    and its threshold at 1, then 20000 allocations: inside a plain
    ``torch.cuda.graph`` capture the collector runs, and a full collection
    there (forced, as its trigger can start one) frees the graph and fails
    the capture; ``decode.capture_step`` holds the collector off through
    the same allocations, captures and replays right.  Each case runs in a
    process of its own (a failed capture leaves its process's graph pool
    recording)."""
    seen = _capture_under_collection("graph", guarded)
    if guarded:
        assert seen == {"result": "ok", "collections_in_capture": 0, "freed_in_capture": False}
    else:
        assert seen["collections_in_capture"] > 0 and seen["freed_in_capture"], seen
        assert seen["result"] != "ok" and "capture" in seen["result"].lower(), seen


@pytest.mark.parametrize("kind", ["pinned", "events"])
def test_a_collection_inside_a_capture_may_free_the_host_tiers_buffers_and_events(cuda, kind):
    """The host tier's own garbage, a pinned staging buffer that a copy on
    the copy stream filled and the copies' timing events, freed by a full
    collection inside a plain capture: the capture holds and replays
    right.  Of a stopped engine's objects only its graphs invalidate a
    capture."""
    seen = _capture_under_collection(kind, False)
    assert seen["collections_in_capture"] > 0 and seen["freed_in_capture"], seen
    assert seen["result"] == "ok", seen


def test_two_replicas_on_the_card_give_equal_greedy_tokens(cuda, tmp_path):
    """A fleet of two replica processes on one card (small width, warmup on,
    so each captures its step family): the same seed makes the same weights
    in both, so the same greedy prompt gives the same tokens through the
    router, from each replica directly, and from an in-process engine."""
    import urllib.request

    from polyaxon_tpu_torch.serving import FleetRouter, LocalServingFleet

    model = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=4, head_dim=64, d_ff=512)
    seq, slots, new = 128, 4, 24
    prompts = [[int(t) for t in np.random.default_rng(i).integers(0, 256, 5 + 9 * i)]
               for i in range(4)]
    router = FleetRouter(probe_interval_s=0.2, probe_timeout_s=2.0, request_timeout_s=120.0)
    fleet = LocalServingFleet(tmp_path, model, replicas=2, seq=seq, slots=slots, seed=3,
                              router=router, env={"POLYAXON_TPU_SERVING_WARMUP": "1"},
                              device="cuda")
    fleet.start()
    try:
        assert fleet.wait_ready(timeout_s=300), [
            (tmp_path / f"{n}.log").read_text()[-2000:] for n in fleet._procs]
        routed = [router.generate([p], max_new_tokens=new)["tokens"][0] for p in prompts]
        for name in router.replica_names():
            base = router.replica(name).base_url
            req = urllib.request.Request(
                base + "/generate", data=json.dumps({"prompts": prompts,
                                                     "max_new_tokens": new}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert json.load(r)["tokens"] == routed, name
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                assert json.load(r)["engine"]["steady_state_compiles"] == 0, name
    finally:
        fleet.stop()
    cfg = TransformerConfig(max_seq=seq, **model)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(3))
    engine = ServingEngine(params, cfg, slots=slots, max_len=seq, seed=3, warmup=True,
                           device=cuda).start()
    try:
        assert [engine.submit(p, new).wait(timeout=120) for p in prompts] == routed
    finally:
        engine.stop()


def test_a_graph_capture_is_one_compile_event_of_the_ledger(cuda):
    from polyaxon_tpu_torch.tracking.ledger import compile_telemetry

    x = torch.ones(64, device=cuda)
    seconds, events = compile_telemetry()
    graph, out = decode.capture_step(lambda: x * 2)
    s1, e1 = compile_telemetry()
    graph.replay()
    torch.cuda.synchronize()
    assert e1 == events + 1 and s1 > seconds and torch.equal(out, x * 2)


def test_device_prefetch_on_the_card_is_the_host_stream_byte_for_byte(cuda):
    """Pinned staging and a copy stream: each device batch equals its host
    source, with more batches than pinned slots (every slot refilled), while
    the consumer's stream is kept busy so copies overlap its work."""
    from polyaxon_tpu_torch.runtime.data import synthetic_token_batches
    from polyaxon_tpu_torch.runtime.pipeline import TrainPipeline

    def host():
        return synthetic_token_batches(vocab_size=32768, global_batch=8, seq=1024, seed=4)

    want = [b for _, b in zip(range(12), host())]
    busy = torch.randn(2048, 2048, device=cuda)
    for prefetch in (0, 2):
        with TrainPipeline(host(), cuda, prefetch=prefetch, tasks=False, device_depth=2) as pipe:
            for w in want:
                got = next(pipe)
                busy = busy @ busy / 2048  # work on the consumer's stream
                for k in ("tokens", "targets"):
                    assert got[k].device.type == "cuda" and got[k].dtype == torch.int32
                    assert np.array_equal(got[k].cpu().numpy(), w[k]), (prefetch, k)


def test_sample_devices_reads_the_card_s_memory(cuda):
    from polyaxon_tpu_torch.monitor.resources import sample_devices

    x = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    got = sample_devices()
    i = cuda.index or torch.cuda.current_device()
    assert got[f"sys/hbm{i}_mb"] >= 64 * 1.048 and got[f"sys/hbm{i}_peak_mb"] >= got[f"sys/hbm{i}_mb"]
    assert 0 < got[f"sys/hbm{i}_frac"] < 1 and got["sys/hbm_peak_mb"] >= got[f"sys/hbm{i}_peak_mb"]
    del x
