#!/usr/bin/env python3
"""What the bf16 dk/dv kernel's rounding screen costs, and how wide it must be.

Run from the repository root on a machine with one H100 and the CUDA
toolkit: ``python3 tools/dkv_tie_variants.py [variant ...]``.  Each variant
is a copy of ``polyaxon_tpu_torch`` under the git-ignored ``_checkout/v/``
with ``csrc/flash_bwd.cu`` edited as listed below; a fresh process builds
it and times ``flash_block_dkv`` at the 671M training shape (BH 640, T 1024,
d 64, bf16, causal; CUDA-event median of 20 calls after 5), and reports its
largest distance from the plain version.  The ``count_`` variants also
count, over one call, the warp tiles, the pairs screened in and the rounds
of re-summing (atomics: their times are not comparable).

Variants:
  none           no screen, no re-summing (the kernel before the screen)
  screen         the screen runs, nothing is summed again
  committed      the source as it is
  count          the source, with counters
  floor9         kTieFloor 2^-9 (screen smaller values too)
  count_floor9   the same, with counters
  err21          kSumErr 2^-21 (a window four times narrower)
  count_err21    the same, with counters
"""

import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC_PATH = "polyaxon_tpu_torch/csrc/flash_bwd.cu"

CALL = "    if (__any_sync(0xffffffffu, near))\n      resum_near_ties"
COUNT = ("    { const int nn = __reduce_add_sync(0xffffffffu, __popc(near));\n"
         "      if (lane == 0) { atomicAdd(&g_tie[0], 1ull);"
         " atomicAdd(&g_tie[1], (unsigned long long)nn);\n"
         "        atomicAdd(&g_tie[2], (unsigned long long)((nn + 31) / 32)); } }\n")
COUNTERS = ("namespace {\n", "__device__ unsigned long long g_tie[3];\nnamespace {\n")
READ_COUNTERS = (
    '\nextern "C" int tie_counts(unsigned long long* h) {\n'
    "  return cudaMemcpyFromSymbol(h, g_tie, sizeof(g_tie));\n}\n"
    'extern "C" int tie_reset() {\n  unsigned long long z[3] = {0, 0, 0};\n'
    "  return cudaMemcpyToSymbol(g_tie, z, sizeof(z));\n}\n")
FLOOR9 = ("constexpr float kTieFloor = 0x1p-7f;", "constexpr float kTieFloor = 0x1p-9f;")
ERR21 = ("constexpr float kSumErr = 0x1p-19f;", "constexpr float kSumErr = 0x1p-21f;")
WITH_COUNTS = [(CALL, COUNT + CALL), COUNTERS]

VARIANTS = {
    "none": [(CALL, "    if (false && __any_sync(0xffffffffu, near))\n      resum_near_ties")],
    # the branch never runs (sm_scale > 0) but the compiler cannot know it
    "screen": [(CALL, "    if (__any_sync(0xffffffffu, near) && sm_scale < 0.f)\n"
                      "      resum_near_ties")],
    "committed": [],
    "count": WITH_COUNTS,
    "floor9": [FLOOR9],
    "count_floor9": [FLOOR9] + WITH_COUNTS,
    "err21": [ERR21],
    "count_err21": [ERR21] + WITH_COUNTS,
}


def measure(name: str) -> str:
    """In a variant's copy: build, run once (reading the counters), time."""
    import ctypes

    import torch

    sys.path.insert(0, os.getcwd())
    from polyaxon_tpu_torch import _build
    from polyaxon_tpu_torch.parallel import flash

    report = _build.build(["flash_bwd"])["flash_bwd"]
    spills = [line.strip() for line in report.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    BH, T, d = 640, 1024, 64
    g = torch.Generator(device="cuda").manual_seed(BH + 2 * T + d)
    q, do = (torch.randn(BH, T, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(BH, T, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    kw = dict(causal=True, sm_scale=d**-0.5)
    o, lse = flash.flash_block_fwd(q, k, v, **kw)
    delta = (do.float() * o.bfloat16().float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    counts = ""
    if name.startswith("count"):
        lib = _build.load("flash_bwd")
        lib.tie_reset()
        flash.flash_block_dkv(*args, **kw)
        torch.cuda.synchronize()
        h = (ctypes.c_ulonglong * 3)()
        lib.tie_counts(h)
        counts = (f" warp_tiles {h[0]} pairs {h[1]} rounds {h[2]} pairs_per_warp_tile "
                  f"{h[1] / h[0]} warp_tiles_with_a_round {h[2] / h[0]} pair_share "
                  f"{h[1] / (h[0] * 16 * 64)}")
    dk, dv = flash.flash_block_dkv(*args, **kw)
    ref = flash.flash_block_bwd_reference(*args, **kw)
    errs = ((dk - ref[1]).abs().max().item(), (dv - ref[2]).abs().max().item())
    del ref
    times = []
    for _ in range(25):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        flash.flash_block_dkv(*args, **kw)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return (f"ms {statistics.median(times[5:])} dk_err {errs[0]:.3e} dv_err {errs[1]:.3e} "
            f"spills {spills or 'none'}{counts}")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(measure(sys.argv[2]), flush=True)
        return 0
    src = open(os.path.join(ROOT, SRC_PATH)).read()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    failed = 0
    for name in sys.argv[1:] or list(VARIANTS):
        edits = VARIANTS[name]
        d = os.path.join(ROOT, "_checkout", "v", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "polyaxon_tpu_torch"),
                        os.path.join(d, "polyaxon_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        if name.startswith("count"):
            text += READ_COUNTERS
        with open(os.path.join(d, SRC_PATH), "w") as f:
            f.write(text)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", name],
                             cwd=d, capture_output=True, text=True, timeout=600)
        failed += run.returncode != 0
        print(name, run.stdout.strip(), run.stderr.strip()[-2000:] if run.returncode else "",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
