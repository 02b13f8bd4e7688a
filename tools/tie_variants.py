#!/usr/bin/env python3
"""What the bf16 backward kernels' rounding screen costs, how wide it must be,
and what two of the dq kernel's design choices are worth.

Run from the repository root on a machine with one H100 and the CUDA
toolkit: ``python3 tools/tie_variants.py [--shape BH,T] [variant ...]`` (all
variants by default).  A variant is ``<pass>:<edit>``, the pass ``dq`` or ``dkv``.  Each
is a copy of ``polyaxon_tpu_torch`` under the git-ignored ``_checkout/v/``
with that pass's kernel in ``csrc/flash_bwd.cu`` edited as listed below; a
fresh process builds it and times the pass (``flash_block_dq`` or
``flash_block_dkv``) at the 671M training shape (BH 640, T 1024, d 64,
bf16, causal; CUDA-event median of 20 calls after 5), or at ``--shape``
(``64,8192``: the long-context shape), and reports its largest distance
from the plain version (over the first 8 heads where a plain version of
all of them would not fit on the card: T above 2048).  The ``count`` edits also count,
over one call, the warp tiles, the pairs screened in and the rounds of
re-summing (atomics: their times are not comparable).

Edits:
  none           no screen, no re-summing (the kernel before the screen)
  screen         the screen runs, nothing is summed again
  committed      the source as it is
  count          the source, with counters
  floor9         kTieFloor 2^-9 (screen smaller values too; both passes)
  count_floor9   the same, with counters
  err21          kSumErr 2^-21 (a window four times narrower; both passes)
  count_err21    the same, with counters
  unrolled       dq only: the chunk loop unrolled (two copies of the
                 re-summing code in the kernel)
  do_regs        dq only: the do fragments kept in registers for the whole
                 key loop, as the q fragments are
"""

import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC_PATH = "polyaxon_tpu_torch/csrc/flash_bwd.cu"

# Each pass's call of the re-summing, and the (query, key) pairs of a warp
# tile at d = 64: 16 keys x 64 queries (dk/dv), 32 queries x 32 keys (dq).
PASSES = {
    "dkv": ("if (__any_sync(0xffffffffu, near))\n      resum_near_ties<D, BQ / 2>", 16 * 64),
    "dq": ("if (__any_sync(0xffffffffu, near))\n        resum_near_ties<D, MT * KC / 2>", 32 * 32),
}
COUNT = ("{ const int nn = __reduce_add_sync(0xffffffffu, __popc(near));\n"
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
UNROLLED = [("#pragma unroll 1\n    for (int kc = 0; kc < BK; kc += KC) {",
             "#pragma unroll\n    for (int kc = 0; kc < BK; kc += KC) {")]
DO_REGS = [
    ("  uint32_t qf[MT][D / 16][4];  // the warp's q rows as A fragments",
     "  uint32_t qf[MT][D / 16][4], dof[MT][D / 16][4];"),
    ("""        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[mt][kk], a_frag(qs, kS, wrow + 16 * mt, kk * 16, lane));
""", """        for (int kk = 0; kk < D / 16; ++kk) {
          ldmatrix_x4(qf[mt][kk], a_frag(qs, kS, wrow + 16 * mt, kk * 16, lane));
          ldmatrix_x4(dof[mt][kk], a_frag(dos, kS, wrow + 16 * mt, kk * 16, lane));
        }
"""),
    ("""        uint32_t dof[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(dof[mt], a_frag(dos, kS, wrow + 16 * mt, kk * 16, lane));
""", ""),
    ("mma(dp[mt][2 * j], dof[mt], b[0], b[1]);", "mma(dp[mt][2 * j], dof[mt][kk], b[0], b[1]);"),
    ("mma(dp[mt][2 * j + 1], dof[mt], b[2], b[3]);",
     "mma(dp[mt][2 * j + 1], dof[mt][kk], b[2], b[3]);"),
]


def edits(variant: str):
    """The (old, new) replacements of one variant of the source."""
    pass_, edit = variant.split(":")
    call = PASSES[pass_][0]
    with_counts = [(call, COUNT + call), COUNTERS]
    return {
        "none": [(call, call.replace("(__any_sync", "(false && __any_sync"))],
        # the branch never runs (sm_scale > 0) but the compiler cannot know it
        "screen": [(call, call.replace("near))", "near) && sm_scale < 0.f)"))],
        "committed": [],
        "count": with_counts,
        "floor9": [FLOOR9],
        "count_floor9": [FLOOR9] + with_counts,
        "err21": [ERR21],
        "count_err21": [ERR21] + with_counts,
        "unrolled": UNROLLED,
        "do_regs": DO_REGS,
    }[edit]


EDITS = ("none", "screen", "committed", "count", "floor9", "count_floor9", "err21", "count_err21")
VARIANTS = [f"{p}:{e}" for p in PASSES for e in EDITS] + ["dq:unrolled", "dq:do_regs"]


def measure(variant: str, BH: int = 640, T: int = 1024) -> str:
    """In a variant's copy: build, run once (reading the counters), time."""
    import ctypes

    import torch

    sys.path.insert(0, os.getcwd())
    from polyaxon_tpu_torch import _build
    from polyaxon_tpu_torch.parallel import flash

    pass_, edit = variant.split(":")
    report = _build.build(["flash_bwd"])["flash_bwd"]
    spills = [line.strip() for line in report.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    d = 64
    g = torch.Generator(device="cuda").manual_seed(BH + 2 * T + d)
    q, do = (torch.randn(BH, T, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(BH, T, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    kw = dict(causal=True, sm_scale=d**-0.5)
    o, lse = flash.flash_block_fwd(q, k, v, **kw)
    delta = (do.float() * o.bfloat16().float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    fn = flash.flash_block_dq if pass_ == "dq" else flash.flash_block_dkv
    counts = ""
    if edit.startswith("count"):
        lib = _build.load("flash_bwd")
        lib.tie_reset()
        fn(*args, **kw)
        torch.cuda.synchronize()
        h = (ctypes.c_ulonglong * 3)()
        lib.tie_counts(h)
        counts = (f" warp_tiles {h[0]} pairs {h[1]} rounds {h[2]} pairs_per_warp_tile "
                  f"{h[1] / h[0]} warp_tiles_with_a_round {h[2] / h[0]} pair_share "
                  f"{h[1] / (h[0] * PASSES[pass_][1])}")
    out = fn(*args, **kw)
    out = (out,) if pass_ == "dq" else out
    heads = BH if T <= 2048 else 8
    ref = flash.flash_block_bwd_reference(*(x[:heads] for x in args), **kw)
    ref = ref[:1] if pass_ == "dq" else ref[1:]
    errs = " ".join(f"{name}_err {(a[:heads] - b).abs().max().item():.3e}"
                    for name, a, b in zip(("dq",) if pass_ == "dq" else ("dk", "dv"), out, ref))
    del ref
    times = []
    for _ in range(25):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kw)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return f"ms {statistics.median(times[5:])} {errs} spills {spills or 'none'}{counts}"


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--measure":
        print(measure(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])), flush=True)
        return 0
    args = sys.argv[1:]
    BH, T = 640, 1024
    if args[:1] == ["--shape"]:
        BH, T = (int(x) for x in args[1].split(","))
        args = args[2:]
    src = open(os.path.join(ROOT, SRC_PATH)).read()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, f"shape BH {BH} T {T}", flush=True)
    failed = 0
    for variant in args or VARIANTS:
        d = os.path.join(ROOT, "_checkout", "v", variant.replace(":", "_"))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "polyaxon_tpu_torch"),
                        os.path.join(d, "polyaxon_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        text = src
        for old, new in edits(variant):
            if text.count(old) != 1:
                raise SystemExit(f"{variant}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        if variant.split(":")[1].startswith("count"):
            text += READ_COUNTERS
        with open(os.path.join(d, SRC_PATH), "w") as f:
            f.write(text)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", variant,
                              str(BH), str(T)],
                             cwd=d, capture_output=True, text=True, timeout=600)
        failed += run.returncode != 0
        print(variant, run.stdout.strip(), run.stderr.strip()[-2000:] if run.returncode else "",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
