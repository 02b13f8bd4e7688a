#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``polyaxon_tpu_torch``) on one CUDA card.

Run from the repository root, on a machine with one NVIDIA Hopper card and
the CUDA toolkit: ``python3 chip_smoke.py``.  It builds the port's kernels
from ``polyaxon_tpu_torch/csrc``, holds each against its plain PyTorch
version, and drives the port's serving path (``lm_generate``: prefill
through the flash kernel, then KV-cache decode) at the full width of the
671M bench model.  Phases:

1. the card, its power limit, and the toolchain;
2. the kernel build (one ``nvcc`` per source, all started together);
3. each kernel against its plain version on the card, at the prefill
   shape of the main path and at edge shapes, with its time beside the
   plain version's, the PyTorch library call's and its bound;
4. a small float32 model: greedy ``generate`` through the kernel gives the
   same tokens as with dense attention;
5. the main path: ``lm_generate`` at the 671M width (batch 4, prompt 512,
   64 new tokens, greedy, bf16 compute, random weights from a seed), with
   the kernels' launch counts set to 0 before it and read after;
6. the prefill logits through the kernel against the same forward with
   dense attention;
7. where the time goes: device time by kernel over one prefill and over
   decode steps (torch.profiler), and the device's idle share.

Any failed check raises, and the script exits non-zero.  On success its
last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity

# The 671M bench model (bench.py: on-chip config), full width, full depth.
BENCH_MODEL = dict(vocab_size=32768, d_model=2048, n_layers=8, n_heads=32,
                   head_dim=64, d_ff=8192)
BATCH, PROMPT, NEW_TOKENS, SEED = 4, 512, 64, 0

# Kernel vs plain version: p is rounded to bf16 before P.V in both, but the
# kernel's online softmax rounds p against a running max that the one-pass
# plain version never sees, so o differs by bf16 rounding of p.
O_ATOL, LSE_ATOL = 2e-2, 1e-3


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(BH, Tq, Tk, d, dtype, causal):
    """Least time (ms) the card could take for one flash_block_fwd call, and
    what sets it: each input byte read once and each output written once at
    the HBM rate, against the two products over the visible (q, k) pairs at
    the tensor-core peak for the input type."""
    in_bytes = torch.tensor([], dtype=dtype).element_size()
    moved = BH * (Tq + 2 * Tk) * d * in_bytes + BH * Tq * d * 4 + BH * Tq * 4
    pairs = sum(min(r + 1, Tk) for r in range(Tq)) if causal else Tq * Tk
    ops = 4 * d * pairs * BH
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from polyaxon_tpu_torch import kernels_available

    avail = kernels_available()
    nvcc = subprocess.run([avail["nvcc"], "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} nvcc {nvcc}")
    return smi


def phase_build():
    from polyaxon_tpu_torch import _build

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():  # ptxas -v: one line per instantiation
        lines = report.splitlines()
        usage = [line.split(":", 1)[-1].strip() for line in lines if "registers" in line]
        spills = [line.strip() for line in lines if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
        log(f"  {name}: {usage}; spills: {spills or 'none'}")


def phase_kernels():
    """flash_fwd against its plain version; returns its record (less launches)."""
    from polyaxon_tpu_torch.parallel import flash

    cases = [  # (BH, Tq, Tk, d, dtype, causal): the main path's shape first
        (BATCH * BENCH_MODEL["n_heads"], PROMPT, PROMPT, 64, torch.bfloat16, True),
        (8, 1000, 1000, 64, torch.bfloat16, True),  # ragged tail
        (8, 300, 200, 64, torch.bfloat16, False),  # non-causal, Tq != Tk
        (16, 512, 512, 128, torch.bfloat16, True),  # d = 128
        (4, 100, 100, 64, torch.float32, True),  # float32 inputs
    ]
    record = None
    for BH, Tq, Tk, d, dtype, causal in cases:
        g = torch.Generator(device="cuda").manual_seed(BH + Tq + d)
        q = torch.randn(BH, Tq, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(BH, Tk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(BH, Tk, d, generator=g, device="cuda").to(dtype)
        scale = d**-0.5
        o, lse = flash.flash_block_fwd(q, k, v, causal=causal, sm_scale=scale)
        torch.cuda.synchronize()
        ro, rlse = flash.flash_block_fwd_reference(q, k, v, causal=causal, sm_scale=scale)
        o_err = (o - ro).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        ok = o_err <= O_ATOL and lse_err <= LSE_ATOL and bool(torch.isfinite(o).all())
        log(f"flash_fwd BH={BH} Tq={Tq} Tk={Tk} d={d} {dtype} causal={causal}: "
            f"o max abs err {o_err:.3e} (<= {O_ATOL}), lse {lse_err:.3e} (<= {LSE_ATOL})")
        if not ok:
            raise AssertionError("flash_fwd disagrees with its plain version")
        if record is None:
            ms = time_ms(lambda: flash.flash_block_fwd(q, k, v, causal=causal, sm_scale=scale))
            plain_ms = time_ms(lambda: flash.flash_block_fwd_reference(
                q, k, v, causal=causal, sm_scale=scale), reps=20)
            B, H = BATCH, BENCH_MODEL["n_heads"]
            q4, k4, v4 = (x.view(B, H, -1, d) for x in (q, k, v))
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=scale))
            bound_ms, bound_by = attention_bound(BH, Tq, Tk, d, dtype, causal)
            log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms (sdpa) "
                f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
            record = {
                "name": "flash_fwd", "route": "cuda",
                "source": "polyaxon_tpu_torch/csrc/flash_fwd.cu",
                "replaces": "polyaxon_tpu/parallel/flash.py:58",
                "max_abs_err": o_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            }
    return record


def phase_small_model():
    """Greedy tokens through the kernel equal those through dense attention
    on a small float32 model (head_dim 64, a ragged 48-token prompt)."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, forward, init_params

    cfg = TransformerConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=4, head_dim=64,
                            d_ff=512, max_seq=128, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    prompt = torch.randint(0, 256, (2, 48), generator=torch.Generator().manual_seed(2)).cuda()
    outs, logits = {}, {}
    for impl in ("auto", "dense"):
        c = cfg.scaled(attention_impl=impl)
        outs[impl] = decode.generate(params, prompt, c, max_new_tokens=16, device="cuda")
        with torch.inference_mode():
            logits[impl] = forward(params, prompt, c, device="cuda")
    diff = (logits["auto"] - logits["dense"]).abs().max().item()
    log(f"small f32 model: logits max abs diff kernel vs dense {diff:.3e} (<= 1e-3); "
        f"greedy tokens equal: {torch.equal(outs['auto'], outs['dense'])}")
    if diff > 1e-3 or not torch.equal(outs["auto"], outs["dense"]):
        raise AssertionError("small-model generate through the kernel disagrees with dense")


def phase_main_path():
    """lm_generate at the 671M width; returns (launches, cfg)."""
    from polyaxon_tpu_torch.builtins.trainers import lm_generate
    from polyaxon_tpu_torch.parallel import flash
    from polyaxon_tpu_torch.tracking.context import Context

    records = []
    ctx = Context(
        params=dict(BENCH_MODEL, seq=1024, batch=BATCH, prompt_len=PROMPT,
                    max_new_tokens=NEW_TOKENS, temperature=0.0, device="cuda"),
        seed=SEED, records=records,
    )
    torch.cuda.reset_peak_memory_stats()
    flash.flash_block_fwd.launches = 0
    out = lm_generate(ctx)
    torch.cuda.synchronize()
    launches = flash.flash_block_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    metrics = next(r["values"] for r in records if r["kind"] == "metric")
    for r in records:
        if r["kind"] == "log":
            log(r["line"])
    log(f"lm_generate 671M: prefill_s {metrics['prefill_s']} decode_tokens_per_s "
        f"{metrics['decode_tokens_per_s']} generated {metrics['generated']} "
        f"peak_memory_allocated {peak} B; flash_fwd launches {launches}")
    # lm_generate runs four prefills (two generate calls, two timed prefills).
    if launches != 4 * BENCH_MODEL["n_layers"]:
        raise AssertionError(f"expected {4 * BENCH_MODEL['n_layers']} flash launches, got {launches}")
    if tuple(out.shape) != (BATCH, NEW_TOKENS) or int(out.min()) < 0 or \
            int(out.max()) >= BENCH_MODEL["vocab_size"]:
        raise AssertionError(f"bad generated tokens: shape {tuple(out.shape)}")
    return launches


def phase_prefill_parity():
    """Last-position prefill logits through the kernel vs dense attention, on
    the same weights lm_generate drew (same seed, same device generator)."""
    from polyaxon_tpu_torch.models import decode
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
    from polyaxon_tpu_torch.parallel import flash

    cfg = TransformerConfig(max_seq=1024, **BENCH_MODEL)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)), device="cuda")
    logits = {}
    for impl in ("auto", "dense"):
        cache = decode.init_cache(cfg, BATCH, PROMPT + NEW_TOKENS, "cuda")
        flash.flash_block_fwd.launches = 0
        logits[impl], _ = decode.prefill(params, prompt, cache, cfg.scaled(attention_impl=impl),
                                         device="cuda")
        torch.cuda.synchronize()
        expected = cfg.n_layers if impl == "auto" else 0
        if flash.flash_block_fwd.launches != expected:
            raise AssertionError(f"{impl} prefill launched flash_fwd "
                                 f"{flash.flash_block_fwd.launches} times, expected {expected}")
    a, b = logits["auto"], logits["dense"]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    diff = (a - b).abs().max().item()
    same = torch.equal(a.argmax(-1), b.argmax(-1))
    log(f"prefill logits kernel vs dense: min cosine {cos:.6f} (>= 0.999), max abs diff "
        f"{diff:.4f}, greedy first tokens equal: {same}; finite: {bool(torch.isfinite(a).all())}")
    if cos < 0.999 or not same or not bool(torch.isfinite(a).all()):
        raise AssertionError("prefill through the kernel disagrees with dense attention")
    return params, cfg, prompt


def phase_profile(params, cfg, prompt, steps: int = 8):
    """Where the time goes: device time by kernel over one prefill and over
    ``steps`` decode steps at the main path's shapes (torch.profiler), beside
    the same window's wall time taken without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from polyaxon_tpu_torch.models import decode

    cache = decode.init_cache(cfg, BATCH, PROMPT + NEW_TOKENS, "cuda")
    logits, _ = decode.prefill(params, prompt, cache, cfg, device="cuda")
    token = logits.argmax(-1)

    def run_prefill():
        decode.prefill(params, prompt, cache, cfg, device="cuda")

    def run_decode():
        for i in range(steps):
            decode.decode_step(params, cache, token, PROMPT + i, cfg)

    for label, fn, calls in (("prefill", run_prefill, 1), (f"decode x{steps}", run_decode, steps)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name, launches = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
                launches += 1
        busy_ms = sum(by_name.values())
        if busy_ms == 0:
            log(f"profile {label}: the trace holds no device time (not measured)")
            continue
        log(f"profile {label}: wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} "
            f"idle_share {max(0.0, 1 - busy_ms / wall_ms):.3f} device_ops_per_call {launches / calls:.0f}")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {ms:9.3f} ms {ms / busy_ms:6.1%}  {name[:120]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    record = phase_kernels()
    phase_small_model()
    record["launches"] = phase_main_path()
    phase_profile(*phase_prefill_parity())
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
