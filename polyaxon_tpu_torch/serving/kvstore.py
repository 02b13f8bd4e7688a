"""Persistent prefix-KV store: warm replica boot for the serving engine.

The port's own copy of ``polyaxon_tpu/serving/kvstore.py``, in the same
on-disk format, so that either package loads the other's stores.  Hot
:class:`~polyaxon_tpu_torch.serving.paging.PrefixCache` blocks (payload plus
the full token chain that identifies each entry) are saved under a store
directory, so a replacement or scale-up replica can fill its prefix cache
during warmup and serve its first requests prefix-warm.

Durability is the checkpoint protocol: versioned snapshot directories plus
a ``.complete/<version>`` marker written last, each rename atomic.  A crash
mid-write leaves the previous complete version or an ignorable torn
directory; readers trust only marked versions.  Concurrent writers race
benignly: the directory rename claims a version, and a loser retries one
higher.

The format, as the reference's:

- ``<version>/meta.json``: ``{"meta": {...}, "entries": [{"tokens",
  "leaves", "dtypes"}, ...]}``; entries store token chains, not chain keys
  (the cache's keys use Python's per-process string ``hash()``);
- ``<version>/blocks.npz``: array ``e<i>.<leaf>`` per entry and pool leaf,
  the pool's storage leaves verbatim (an int8 pool stores int8 rows and
  float32 scales).  Leaf dtypes are recorded by name beside them: numpy has
  no bfloat16, so a bf16 leaf is stored as the reference's writer stores it
  (2-byte void items, ``'<V2'``) and crosses numpy only through its 16-bit
  integer view; the loader view-casts each leaf by its recorded name.

Payloads here are CPU tensors (``{leaf: tensor}``), as the engine's host
tier holds them.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

#: Marker directory: ``<root>/.complete/<version>`` exists iff snapshot
#: ``<root>/<version>/`` finished writing.
_COMPLETE_DIR = ".complete"

#: Complete snapshots kept after a successful save (older versions GC).
_KEEP_VERSIONS = 2

#: One persisted prefix block: (full chain tokens, {pool leaf: tensor}).
Entry = Tuple[Tuple[int, ...], Dict[str, torch.Tensor]]

#: The ``.npy`` type of a bf16 leaf, as numpy writes the reference's
#: bfloat16 arrays (2-byte items, the ``descr`` of the array header).
_BF16_DESCR = "<V2"


def _dtype_name(t: torch.Tensor) -> str:
    """A leaf dtype's recorded name, as numpy names it (``bfloat16``,
    ``int8``, ``float32``)."""
    return str(t.dtype).replace("torch.", "")


def _write_npy(fp, t: torch.Tensor) -> None:
    """One leaf as a ``.npy`` member: numpy's own writer, except for bf16,
    whose header numpy cannot produce without an extension dtype; its bytes
    are the tensor's 16-bit integer view."""
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        np.lib.format.write_array(fp, t.numpy(), allow_pickle=False)
        return
    header = {"descr": _BF16_DESCR, "fortran_order": False, "shape": tuple(t.shape)}
    np.lib.format.write_array_header_1_0(fp, header)
    fp.write(t.view(torch.int16).numpy().tobytes())


def _savez(path: Path, arrays: Dict[str, torch.Tensor]) -> None:
    """``np.savez`` over tensors: one ``<name>.npy`` member per array, in
    order, stored uncompressed."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as z:
        for name, t in arrays.items():
            with z.open(name + ".npy", "w", force_zip64=True) as fp:
                _write_npy(fp, t)


def _tensor(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A loaded leaf as a tensor of its recorded dtype: bf16 through the
    16-bit integer view of its bytes, never through a float conversion."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if dtype_name and str(arr.dtype) != dtype_name:
        arr = arr.view(np.dtype(dtype_name))
    return torch.from_numpy(np.ascontiguousarray(arr))


def complete_versions(root: Union[str, Path]) -> List[int]:
    """All snapshot versions whose finalize marker exists, ascending."""
    root = Path(root)
    marker_dir = root / _COMPLETE_DIR
    if not marker_dir.is_dir():
        return []
    return sorted(
        int(p.name)
        for p in marker_dir.iterdir()
        if p.name.isdigit() and (root / p.name).is_dir()
    )


def latest_complete_version(root: Union[str, Path]) -> Optional[int]:
    versions = complete_versions(root)
    return versions[-1] if versions else None


def save_prefix_store(
    root: Union[str, Path],
    entries: Sequence[Entry],
    meta: Dict[str, Any],
) -> Optional[int]:
    """Write one snapshot (payloads, chains and ``meta``); returns its
    version, or ``None`` when nothing was written (no entries, or the
    version race lost too many times).  ``meta`` is the compatibility
    fingerprint the loader matches exactly: geometry, kv dtype and the
    caller's model signature."""
    if not entries:
        return None
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / _COMPLETE_DIR).mkdir(exist_ok=True)
    for attempt in range(3):
        version = (latest_complete_version(root) or 0) + 1 + attempt
        final = root / str(version)
        if final.exists():
            continue  # a concurrent writer claimed it (possibly torn)
        tmp = root / f"{version}.tmp-{os.getpid()}"
        try:
            tmp.mkdir()
            arrays: Dict[str, torch.Tensor] = {}
            records = []
            for i, (chain, data) in enumerate(entries):
                records.append(
                    {
                        "tokens": [int(t) for t in chain],
                        "leaves": sorted(data),
                        "dtypes": {name: _dtype_name(t) for name, t in data.items()},
                    }
                )
                for name, t in data.items():
                    arrays[f"e{i}.{name}"] = t
            _savez(tmp / "blocks.npz", arrays)
            (tmp / "meta.json").write_text(
                json.dumps({"meta": dict(meta), "entries": records})
            )
            os.replace(tmp, final)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            continue
        # Data is in place: now, and only now, the finalize marker.
        marker = root / _COMPLETE_DIR / str(version)
        marker_tmp = root / _COMPLETE_DIR / f"{version}.tmp-{os.getpid()}"
        marker_tmp.write_text("")
        os.replace(marker_tmp, marker)
        _gc_versions(root)
        return version
    return None


def load_prefix_store(
    root: Union[str, Path],
    expect: Optional[Dict[str, Any]] = None,
) -> Optional[List[Entry]]:
    """Entries of the newest complete snapshot, ancestors first, or
    ``None`` when there is no usable store (missing, torn, unreadable, or
    any ``expect`` key differs from the stored meta: a geometry or
    model-signature mismatch makes the payloads garbage)."""
    root = Path(root)
    version = latest_complete_version(root)
    if version is None:
        return None
    snap = root / str(version)
    try:
        doc = json.loads((snap / "meta.json").read_text())
        stored = doc["meta"]
        if expect:
            for key, want in expect.items():
                if stored.get(key) != want:
                    return None
        out: List[Entry] = []
        with np.load(snap / "blocks.npz") as z:
            for i, rec in enumerate(doc["entries"]):
                dtypes = rec.get("dtypes") or {}
                data = {
                    name: _tensor(z[f"e{i}.{name}"], dtypes.get(name))
                    for name in rec["leaves"]
                }
                out.append((tuple(int(t) for t in rec["tokens"]), data))
        return out
    except Exception:
        return None


def _gc_versions(root: Path) -> None:
    """Keep the newest ``_KEEP_VERSIONS`` complete snapshots; older versions
    lose their marker first (so a reader never trusts a half-deleted dir),
    then their data.  Stray tmp dirs are left alone: they may belong to a
    live concurrent writer."""
    for version in complete_versions(root)[:-_KEEP_VERSIONS]:
        marker = root / _COMPLETE_DIR / str(version)
        try:
            marker.unlink()
        except OSError:
            continue
        shutil.rmtree(root / str(version), ignore_errors=True)
