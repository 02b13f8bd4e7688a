"""Store-resident datasets: registration and host-sharded reading.

The port's copy of ``polyaxon_tpu/runtime/datasets.py``, numpy only and
byte for byte the reference's format, so either package reads what the
other registered.  Datasets live under the store layout's ``data/`` dir as
numpy shard files, and the read path is sharded by contract: each process
reads only the rows it contributes to the global batch
(:func:`~polyaxon_tpu_torch.runtime.data.global_batch_from_host_data` then
puts them on its card).

On-disk format (one dir per dataset):

    data/<name>/meta.json               {"num_examples", "shards", "arrays",
                                         "format", "shard_sizes"}
    data/<name>/shard-00000.images.npy  [n,H,W,C]
    data/<name>/shard-00000.labels.npy  [n]
    ...

Per-array raw ``.npy`` shards, so the read path can ``np.load(...,
mmap_mode="r")`` and materialize only the rows each batch gathers.  Older
``shard-*.npz`` datasets still read through an in-RAM path.  Nothing is
downloaded: :func:`load_cifar10_python` reads a local
``cifar-10-batches-py`` directory, and tests use :func:`make_image_fixture`.

Any array names work; arrays must share a leading dim per shard.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from polyaxon_tpu_torch.exceptions import PolyaxonTPUError


def register_dataset(
    data_dir: Union[str, Path],
    name: str,
    shards: Sequence[Dict[str, np.ndarray]],
) -> Dict[str, Any]:
    """Write ``shards`` (list of array dicts) as a named dataset.

    Returns the meta dict. Overwrites an existing registration of the same
    name (datasets are immutable-by-convention; re-register to replace).
    """
    if not shards:
        raise PolyaxonTPUError(f"Dataset {name!r} needs at least one shard")
    root = Path(data_dir) / name
    root.mkdir(parents=True, exist_ok=True)
    arrays = sorted(shards[0].keys())
    shard_sizes: List[int] = []
    for i, shard in enumerate(shards):
        if sorted(shard.keys()) != arrays:
            raise PolyaxonTPUError(
                f"Shard {i} arrays {sorted(shard)} != shard 0 arrays {arrays}"
            )
        sizes = {len(v) for v in shard.values()}
        if len(sizes) != 1:
            raise PolyaxonTPUError(f"Shard {i} arrays disagree on length: {sizes}")
        # Raw .npy per array: mmap-able on read (npz is a zip — it isn't).
        for a, v in shard.items():
            np.save(root / f"shard-{i:05d}.{a}.npy", np.asarray(v))
        shard_sizes.append(sizes.pop())
    meta = {
        "num_examples": sum(shard_sizes),
        "shards": len(shards),
        "arrays": arrays,
        "format": "npy",
        "shard_sizes": shard_sizes,
    }
    # meta.json is the commit record: it's written LAST (shards already on
    # disk) and renamed into place atomically, so an interrupted
    # registration leaves either no meta (unregistered, shard files are
    # garbage) or a complete one — never a truncated json that readers
    # half-accept.
    tmp = root / "meta.json.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, root / "meta.json")
    return meta


def dataset_meta(data_dir: Union[str, Path], name: str) -> Dict[str, Any]:
    meta_path = Path(data_dir) / name / "meta.json"
    if not meta_path.exists():
        raise PolyaxonTPUError(
            f"Dataset {name!r} not registered under {data_dir} "
            f"(expected {meta_path})"
        )
    try:
        return json.loads(meta_path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise PolyaxonTPUError(
            f"Dataset {name!r} has an unreadable meta.json ({exc}) — "
            f"re-register it"
        ) from exc


def list_datasets(data_dir: Union[str, Path]) -> List[Dict[str, Any]]:
    root = Path(data_dir)
    out = []
    if root.is_dir():
        for d in sorted(root.iterdir()):
            if (d / "meta.json").exists():
                try:
                    out.append({"name": d.name, **dataset_meta(root, d.name)})
                except PolyaxonTPUError:
                    # A corrupt registration must not take down the whole
                    # listing — skip it (dataset_meta still reports it
                    # loudly to anyone addressing it by name).
                    continue
    return out


class DatasetReader:
    """Host-sharded batch iterator over a registered dataset.

    Process ``process_id`` of ``num_processes`` materializes only its own
    rows of every global batch: the global epoch permutation is derived
    deterministically from ``seed`` + epoch (identical on every host, no
    coordination), then each host takes its contiguous slice of each batch.
    Partial trailing batches are dropped (static shapes: the step only ever
    sees ``[B/hosts, ...]``).
    """

    def __init__(
        self,
        data_dir: Union[str, Path],
        name: str,
        *,
        global_batch: int,
        seed: int = 0,
        num_processes: int = 1,
        process_id: int = 0,
        dtype_overrides: Optional[Dict[str, Any]] = None,
    ) -> None:
        if global_batch % num_processes:
            raise PolyaxonTPUError(
                f"Global batch {global_batch} not divisible by {num_processes} hosts"
            )
        self.meta = dataset_meta(data_dir, name)
        self.root = Path(data_dir) / name
        self.global_batch = global_batch
        self.seed = seed
        self.num_processes = num_processes
        self.process_id = process_id
        self.dtype_overrides = dtype_overrides or {}
        self.num_examples = self.meta["num_examples"]
        if self.meta.get("format") == "npy":
            # Streaming path: every shard is an mmap; a batch gather
            # touches only its rows' pages, so RSS stays O(batch) no
            # matter how large the dataset is.
            self.arrays = None
            self._shards: Dict[str, List[np.ndarray]] = {
                a: [
                    np.load(
                        self.root / f"shard-{i:05d}.{a}.npy", mmap_mode="r"
                    )
                    for i in range(self.meta["shards"])
                ]
                for a in self.meta["arrays"]
            }
            sizes = self.meta.get("shard_sizes") or [
                len(s) for s in next(iter(self._shards.values()))
            ]
            self._starts = np.concatenate([[0], np.cumsum(sizes)])
        else:
            # Legacy npz datasets: zip members can't mmap;
            # load once, serve many epochs.
            arrays: Dict[str, List[np.ndarray]] = {
                a: [] for a in self.meta["arrays"]
            }
            for i in range(self.meta["shards"]):
                with np.load(self.root / f"shard-{i:05d}.npz") as z:
                    for a in self.meta["arrays"]:
                        arrays[a].append(z[a])
            self.arrays = {a: np.concatenate(v) for a, v in arrays.items()}

    @property
    def batches_per_epoch(self) -> int:
        return self.num_examples // self.global_batch

    def _epoch_tasks(
        self, epoch: int, start_batch: int = 0
    ) -> Iterator[Callable[[], Dict[str, np.ndarray]]]:
        """Zero-arg gather thunks for each batch of ``epoch``.

        The cheap index arithmetic (permutation slice) runs here, on the
        iterating thread; the expensive row gather runs when the thunk is
        CALLED — which is what lets a prefetcher execute gathers on worker
        threads while preserving this iterator's order.  Gathers are
        read-only over the mmaps, so concurrent thunk calls are safe."""
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(self.num_examples)
        per_host = self.global_batch // self.num_processes
        lo = self.process_id * per_host
        for b in range(start_batch, self.batches_per_epoch):
            batch_idx = perm[b * self.global_batch : (b + 1) * self.global_batch]
            local_idx = batch_idx[lo : lo + per_host]

            def task(idx: np.ndarray = local_idx) -> Dict[str, np.ndarray]:
                return {
                    a: self._cast(a, self._gather(a, idx))
                    for a in self.meta["arrays"]
                }

            yield task

    def epoch(
        self, epoch: int, start_batch: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """This host's slice of each global batch, from ``start_batch`` on.

        Skipped batches cost only the (already computed) permutation — no
        row gathers, so a deep resume is O(1) per skipped batch."""
        for task in self._epoch_tasks(epoch, start_batch):
            yield task()

    def _gather(self, name: str, idx: np.ndarray) -> np.ndarray:
        """Rows ``idx`` (global order = shard order) of array ``name``.

        Streaming format: indices are grouped per shard and fancy-indexed
        out of the mmap — only the gathered rows materialize."""
        if self.arrays is not None:
            return self.arrays[name][idx]
        shard_of = np.searchsorted(self._starts, idx, side="right") - 1
        shards = self._shards[name]
        first = shards[0]
        out = np.empty((len(idx), *first.shape[1:]), dtype=first.dtype)
        for s in np.unique(shard_of):
            mask = shard_of == s
            out[mask] = shards[s][idx[mask] - self._starts[s]]
        return out

    def batch_tasks(
        self, start_step: int = 0
    ) -> Iterator[Callable[[], Dict[str, np.ndarray]]]:
        """Endless resumable stream of gather thunks (see
        :meth:`_epoch_tasks`) — the source a :class:`~polyaxon_tpu_torch.runtime
        .pipeline.HostPrefetcher` consumes.  Same epoch/step arithmetic as
        :meth:`batches`, so prefetched and synchronous streams are
        byte-identical, including a mid-epoch resume."""
        bpe = self.batches_per_epoch
        if bpe == 0:
            raise PolyaxonTPUError(
                f"Dataset has {self.num_examples} examples < global batch "
                f"{self.global_batch}"
            )
        epoch, skip = divmod(start_step, bpe)
        while True:
            yield from self._epoch_tasks(epoch, start_batch=skip)
            skip = 0
            epoch += 1

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Endless stream, resumable: ``start_step`` fast-forwards the
        epoch/batch position without materializing skipped batches — a
        resumed run sees exactly the data it would have seen."""
        for task in self.batch_tasks(start_step):
            yield task()

    def _cast(self, name: str, arr: np.ndarray) -> np.ndarray:
        want = self.dtype_overrides.get(name)
        return arr.astype(want) if want is not None else arr


# -- CIFAR-10 -----------------------------------------------------------------


def load_cifar10_python(batches_dir: Union[str, Path]) -> Dict[str, Dict[str, np.ndarray]]:
    """Parse the standard ``cifar-10-batches-py`` pickles into train/test
    arrays (NHWC uint8 images + int labels).  The archive itself must be
    fetched out-of-band (zero-egress platforms mount it)."""
    import pickle

    root = Path(batches_dir)

    def _load(fname: str):
        with open(root / fname, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        images = (
            np.asarray(d[b"data"], dtype=np.uint8)
            .reshape(-1, 3, 32, 32)
            .transpose(0, 2, 3, 1)  # NCHW → NHWC (the reference's layout)
        )
        labels = np.asarray(d[b"labels"], dtype=np.int32)
        return images, labels

    train = [_load(f"data_batch_{i}") for i in range(1, 6)]
    test_images, test_labels = _load("test_batch")
    return {
        "train": {
            "images": np.concatenate([t[0] for t in train]),
            "labels": np.concatenate([t[1] for t in train]),
        },
        "test": {"images": test_images, "labels": test_labels},
    }


def register_cifar10(
    data_dir: Union[str, Path],
    batches_dir: Union[str, Path],
    *,
    shard_size: int = 10000,
) -> Dict[str, Any]:
    """Register CIFAR-10 train/test splits from the standard archive dir."""
    splits = load_cifar10_python(batches_dir)
    out = {}
    for split, arrays in splits.items():
        n = len(arrays["labels"])
        shards = [
            {a: v[i : i + shard_size] for a, v in arrays.items()}
            for i in range(0, n, shard_size)
        ]
        out[split] = register_dataset(data_dir, f"cifar10-{split}", shards)
    return out


def synthetic_class_images(
    rng: np.random.Generator,
    num_examples: int,
    image_size: int,
    n_classes: int,
) -> tuple:
    """Class-conditional noisy-template images, uint8 NHWC.

    THE synthetic image recipe — shared by the fixture dataset and
    ``cnn_train``'s no-dataset benchmark branch so the two can never
    diverge. Per-example noise keeps the learnability check honest (without
    it a batch holds only ``n_classes`` distinct images)."""
    templates = rng.normal(size=(n_classes, image_size, image_size, 3))
    labels = rng.integers(0, n_classes, num_examples)
    noisy = templates[labels] + 0.3 * rng.normal(
        size=(num_examples, image_size, image_size, 3)
    )
    images = np.clip(noisy * 32 + 128, 0, 255).astype(np.uint8)
    return images, labels.astype(np.int32)


def make_image_fixture(
    data_dir: Union[str, Path],
    name: str,
    *,
    num_examples: int = 512,
    image_size: int = 32,
    n_classes: int = 10,
    shards: int = 2,
    seed: int = 0,
) -> Dict[str, Any]:
    """A CIFAR-shaped learnable fixture dataset (class-conditional noisy
    templates) — CI-sized stand-in for the real archive, same read path."""
    rng = np.random.default_rng(seed)
    images, labels = synthetic_class_images(
        rng, num_examples, image_size, n_classes
    )
    per = num_examples // shards
    shard_list = [
        {
            "images": images[i * per : (i + 1) * per],
            "labels": labels[i * per : (i + 1) * per].astype(np.int32),
        }
        for i in range(shards)
    ]
    return register_dataset(data_dir, name, shard_list)
