"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers:
such a build takes seconds, not minutes).  Builds happen at first use, from
the sources in the package, into ``_build/`` beside them; the library name
carries a hash of the sources, so an edited kernel is rebuilt and a stale
one is never loaded.  A build failure raises: nothing falls back to the
plain PyTorch versions.  Builds and loads are the utilization ledger's
compile events (``tracking/ledger.py:record_compile``): a build's wall
seconds, one event and one cache miss a source built, one cache hit a
library found built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

from polyaxon_tpu_torch._device import find_nvcc
from polyaxon_tpu_torch.tracking.ledger import record_compile

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _nvcc_command(name: str, out: Path) -> List[str]:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = ()) -> Dict[str, str]:
    """Compile the named kernels (all of them by default), one ``nvcc`` per
    source, all started together.  Returns each compiler's report
    (``-Xptxas -v``: registers, shared memory, spills); a library already
    built from the same sources is kept and reports ``"cached"``."""
    names = list(names) or sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    reports = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            reports[name] = "cached"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            _nvcc_command(name, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    record_compile(time.perf_counter() - t0 if running else 0.0, events=len(running),
                   hits=len(names) - len(running), misses=len(running))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if path.exists():
                record_compile(hits=1)
            else:
                build([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
