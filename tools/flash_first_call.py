#!/usr/bin/env python3
"""What a process's first flash launches cost on the card (cold start).

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit: ``python3 tools/flash_first_call.py [checkout ...]`` (this
checkout by default; another checkout is a directory holding the same
layout, e.g. a commit unpacked with ``git archive`` under the git-ignored
``_checkout/``).  Each checkout's kernels are built first
(``chip_smoke.phase_build`` there); then a fresh process per checkout and
turn (the checkouts in order, then in reverse: A, B, B, A) times, each step
ended by ``torch.cuda.synchronize()``: the CUDA context, importing
``parallel/flash.py``, loading each kernel library, the first forward and
backward launches (bf16, head_dim 64), a second forward launch, and the
first and second call of the ``flash_attention`` op with autograd.  Prints
the card's name and power limit, then one line per process.
"""

import os
import subprocess
import sys

PROBE = r'''
import time, torch
t = [time.perf_counter()]
def mark():
    torch.cuda.synchronize()
    t.append(time.perf_counter())
torch.zeros(1, device="cuda"); mark()
from polyaxon_tpu_torch.parallel import flash
mark()
flash._kernel_fn(); mark()
q = torch.randn(4, 256, 64, device="cuda", dtype=torch.bfloat16)
o, lse = flash.flash_block_fwd(q, q, q, causal=True, sm_scale=0.125); mark()
flash._bwd_kernel_fns(); mark()
delta = torch.zeros(4, 256, device="cuda")
flash.flash_block_bwd(q, q, q, q, lse, delta, causal=True, sm_scale=0.125); mark()
flash.flash_block_fwd(q, q, q, causal=True, sm_scale=0.125); mark()
x = torch.randn(2, 256, 4, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
flash.flash_attention(x, x, x, 0.125).float().sum().backward(); mark()
flash.flash_attention(x, x, x, 0.125).float().sum().backward(); mark()
names = ["cuda_init", "import_flash", "load_flash_fwd_lib", "first_fwd_launch",
         "load_flash_bwd_lib", "first_bwd_launches", "second_fwd_launch", "first_op_fwd_bwd",
         "second_op_fwd_bwd"]
print({n: round(b - a, 4) for n, a, b in zip(names, t, t[1:])}, flush=True)
'''


def main() -> int:
    checkouts = [os.path.abspath(c) for c in sys.argv[1:]] or [os.getcwd()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for cwd in checkouts:
        r = subprocess.run([sys.executable, "-c", "import chip_smoke as c; c.phase_build()"],
                           cwd=cwd, capture_output=True, text=True, timeout=900)
        if r.returncode:
            print(f"build failed in {cwd}:\n{r.stderr[-3000:]}", flush=True)
            return 1
        print(f"{cwd}: {r.stdout.splitlines()[0]}", flush=True)
    failed = 0
    for i, cwd in enumerate(checkouts + checkouts[::-1]):
        r = subprocess.run([sys.executable, "-c", PROBE], cwd=cwd, capture_output=True,
                           text=True, timeout=600)
        failed += r.returncode != 0
        print(i, cwd, r.stdout.strip(), r.stderr[-1500:] if r.returncode else "", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
