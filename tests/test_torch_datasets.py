"""The port's dataset path against the JAX package's.

Counterparts of ``tests/test_runtime/test_datasets.py``,
``test_pipeline.py`` and ``test_data.py`` on the port's
``runtime/datasets.py``, ``runtime/pipeline.py`` and ``runtime/data.py``;
byte equality with the JAX package for the same seed (``make_image_fixture``
files, ``DatasetReader`` batches either way round, ``synthetic_token_batches``);
and ``TrainPipeline`` streams byte-identical with ``prefetch=0`` and
``prefetch=2``, host-side and placed on the CPU device.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pickle
import threading
import time

import jax
import numpy as np
import pytest
import torch

import polyaxon_tpu.runtime.data as jdata
import polyaxon_tpu.runtime.datasets as jds
from polyaxon_tpu_torch.exceptions import PolyaxonTPUError
from polyaxon_tpu_torch.runtime.data import (
    global_batch_from_host_data,
    host_shard_bounds,
    synthetic_token_batches,
)
from polyaxon_tpu_torch.runtime.datasets import (
    DatasetReader,
    dataset_meta,
    list_datasets,
    load_cifar10_python,
    make_image_fixture,
    register_cifar10,
    register_dataset,
    synthetic_class_images,
)
from polyaxon_tpu_torch.runtime.pipeline import (
    HostPrefetcher,
    TrainPipeline,
    device_prefetch,
    to_device,
)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# -- registration ------------------------------------------------------------------

def test_register_and_meta(tmp_path):
    shards = [{"x": np.arange(10, dtype=np.float32), "y": np.arange(10) % 3},
              {"x": np.arange(6, dtype=np.float32), "y": np.arange(6) % 3}]
    meta = register_dataset(tmp_path, "toy", shards)
    assert meta == {"num_examples": 16, "shards": 2, "arrays": ["x", "y"], "format": "npy",
                    "shard_sizes": [10, 6]}
    assert dataset_meta(tmp_path, "toy")["num_examples"] == 16
    assert [d["name"] for d in list_datasets(tmp_path)] == ["toy"]
    assert not (tmp_path / "toy" / "meta.json.tmp").exists()
    assert jds.dataset_meta(tmp_path, "toy") == meta  # the reference reads it


@pytest.mark.parametrize("shards", [
    [{"x": np.zeros(4)}, {"y": np.zeros(4)}],
    [{"x": np.zeros(4), "y": np.zeros(5)}],
    [],
])
def test_bad_registrations_are_refused(tmp_path, shards):
    with pytest.raises(PolyaxonTPUError):
        register_dataset(tmp_path, "bad", shards)


def test_unregistered_and_torn_registrations(tmp_path):
    with pytest.raises(PolyaxonTPUError):
        dataset_meta(tmp_path, "nope")
    register_dataset(tmp_path, "good", [{"x": np.arange(4)}])
    bad = tmp_path / "bad"
    bad.mkdir()
    np.save(bad / "shard-00000.x.npy", np.arange(4))
    (bad / "meta.json").write_text('{"num_examples": 4, "sha')
    assert [d["name"] for d in list_datasets(tmp_path)] == ["good"]
    with pytest.raises(PolyaxonTPUError, match="unreadable"):
        dataset_meta(tmp_path, "bad")
    register_dataset(tmp_path, "bad", [{"x": np.arange(4)}])
    assert sorted(d["name"] for d in list_datasets(tmp_path)) == ["bad", "good"]


# -- host-sharded reads --------------------------------------------------------------

def _register(tmp_path, n=64):
    register_dataset(tmp_path, "d", [{"x": np.arange(n, dtype=np.int64)}])


def test_hosts_partition_each_global_batch(tmp_path):
    _register(tmp_path)
    batches = [next(iter(DatasetReader(tmp_path, "d", global_batch=16, num_processes=4,
                                       process_id=pid).epoch(0)))["x"] for pid in range(4)]
    assert all(len(b) == 4 for b in batches)
    merged = np.concatenate(batches)
    assert len(set(merged.tolist())) == 16
    _same(merged, next(iter(DatasetReader(tmp_path, "d", global_batch=16).epoch(0)))["x"])


def test_epochs_shuffle_deterministically_and_resume_exactly(tmp_path):
    _register(tmp_path)
    r = DatasetReader(tmp_path, "d", global_batch=32, seed=7)
    e0 = np.concatenate([b["x"] for b in r.epoch(0)])
    assert not np.array_equal(e0, np.concatenate([b["x"] for b in r.epoch(1)]))
    _same(e0, np.concatenate([b["x"] for b in DatasetReader(tmp_path, "d", global_batch=32,
                                                           seed=7).epoch(0)]))
    r = DatasetReader(tmp_path, "d", global_batch=16, seed=3)
    stream = r.batches(0)
    full = [next(stream)["x"] for _ in range(7)]
    resumed = r.batches(5)
    _same(next(resumed)["x"], full[5])
    _same(next(resumed)["x"], full[6])


def test_bad_batches_are_refused(tmp_path):
    _register(tmp_path, n=8)
    with pytest.raises(PolyaxonTPUError):
        DatasetReader(tmp_path, "d", global_batch=10, num_processes=4)
    with pytest.raises(PolyaxonTPUError):
        next(DatasetReader(tmp_path, "d", global_batch=16).batches(0))


def test_reader_memory_maps_npy_shards_and_gathers_across_shards(tmp_path):
    register_dataset(tmp_path, "ident", [
        {"x": np.arange(0, 7), "q": np.arange(0, 7) * 10},
        {"x": np.arange(7, 19), "q": np.arange(7, 19) * 10},
        {"x": np.arange(19, 24), "q": np.arange(19, 24) * 10}])
    r = DatasetReader(tmp_path, "ident", global_batch=24, seed=1)
    assert r.arrays is None and all(isinstance(s, np.memmap) for s in r._shards["x"])
    (batch,) = list(r.epoch(0))
    _same(batch["x"], np.random.default_rng((1, 0)).permutation(24))
    _same(batch["q"], batch["x"] * 10)


def test_legacy_npz_datasets_read_as_npy_ones(tmp_path):
    import json

    rng = np.random.default_rng(3)
    shards = [{"img": rng.integers(0, 255, (n, 4, 4), dtype=np.uint8),
               "lab": rng.integers(0, 9, n).astype(np.int32)} for n in (21, 13, 30)]
    register_dataset(tmp_path, "new", shards)
    old = tmp_path / "old"
    old.mkdir()
    for i, shard in enumerate(shards):
        np.savez(old / f"shard-{i:05d}.npz", **shard)
    (old / "meta.json").write_text(json.dumps(
        {"num_examples": 64, "shards": 3, "arrays": ["img", "lab"]}))
    kw = dict(global_batch=16, seed=7, num_processes=2, process_id=1)
    a, b = DatasetReader(tmp_path, "new", **kw), DatasetReader(tmp_path, "old", **kw)
    assert b.arrays is not None
    for _, (x, y) in zip(range(9), zip(a.batches(), b.batches())):
        _same(x["img"], y["img"])
        _same(x["lab"], y["lab"])


# -- the reference, byte for byte ---------------------------------------------------------

@pytest.mark.parametrize("seed, n, size, classes, shards", [(0, 64, 8, 10, 2), (5, 48, 4, 3, 3)])
def test_image_fixture_is_the_reference_s_byte_for_byte(tmp_path, seed, n, size, classes, shards):
    kw = dict(num_examples=n, image_size=size, n_classes=classes, shards=shards, seed=seed)
    meta = make_image_fixture(tmp_path / "port", "fix", **kw)
    assert meta == jds.make_image_fixture(tmp_path / "jax", "fix", **kw)
    files = sorted(p.name for p in (tmp_path / "port" / "fix").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax" / "fix").iterdir())
    for name in files:
        assert (tmp_path / "port" / "fix" / name).read_bytes() == \
            (tmp_path / "jax" / "fix" / name).read_bytes(), name
    images, labels = synthetic_class_images(np.random.default_rng(seed), 8, size, classes)
    ref = jds.synthetic_class_images(np.random.default_rng(seed), 8, size, classes)
    _same(images, ref[0])
    _same(labels, ref[1])


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("procs, pid, start", [(1, 0, 0), (2, 1, 0), (4, 3, 9)])
def test_reader_batches_are_the_reference_s(tmp_path, writer, procs, pid, start):
    maker = make_image_fixture if writer == "port" else jds.make_image_fixture
    maker(tmp_path, "fix", num_examples=96, image_size=4, shards=3, seed=2)
    kw = dict(global_batch=16, seed=11, num_processes=procs, process_id=pid)
    port = DatasetReader(tmp_path, "fix", **kw).batches(start)
    ref = jds.DatasetReader(tmp_path, "fix", **kw).batches(start)
    for _ in range(8):
        a, b = next(port), next(ref)
        assert sorted(a) == sorted(b) == ["images", "labels"]
        for k in a:
            _same(a[k], b[k])


def _fake_cifar(tmp_path, per_batch=20):
    root = tmp_path / "cifar-10-batches-py"
    root.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 256, (per_batch, 3072), dtype=np.uint8),
             b"labels": rng.integers(0, 10, per_batch).tolist()}
        with open(root / name, "wb") as fh:
            pickle.dump(d, fh)
    return root


def test_cifar10_loads_and_registers_as_the_reference(tmp_path):
    root = _fake_cifar(tmp_path)
    splits = load_cifar10_python(root)
    ref = jds.load_cifar10_python(root)
    assert splits["train"]["images"].shape == (100, 32, 32, 3)
    for split in ("train", "test"):
        for k in ("images", "labels"):
            _same(splits[split][k], ref[split][k])
    out = register_cifar10(tmp_path / "data", root, shard_size=40)
    assert out["train"]["num_examples"] == 100 and out["train"]["shards"] == 3
    b = next(DatasetReader(tmp_path / "data", "cifar10-train", global_batch=20).batches(0))
    assert b["images"].shape == (20, 32, 32, 3) and b["images"].dtype == np.uint8


# -- runtime/data.py ------------------------------------------------------------------------

def test_host_shard_bounds():
    assert host_shard_bounds(16, 4, 0) == (0, 4) == jdata.host_shard_bounds(16, 4, 0)
    assert host_shard_bounds(16, 4, 3) == (12, 16)
    with pytest.raises(ValueError):
        host_shard_bounds(10, 4, 0)


@pytest.mark.parametrize("seed, procs, pid", [(3, 1, 0), (7, 2, 1), (0, 4, 2)])
def test_synthetic_token_batches_are_the_reference_s(seed, procs, pid):
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    kw = dict(vocab_size=64, global_batch=8, seq=6, seed=seed, num_processes=procs,
              process_id=pid)
    port = synthetic_token_batches(**kw)
    ref = jdata.synthetic_token_batches(sharding=sharding, **dict(kw, num_processes=1,
                                                                  process_id=0))
    lo, hi = host_shard_bounds(8, procs, pid)
    for _ in range(3):
        a, b = next(port), next(ref)
        for k in ("tokens", "targets"):
            _same(a[k], np.asarray(b[k])[lo:hi])
        _same(a["tokens"][:, 1:], a["targets"][:, :-1])


def test_local_batches_are_placed_and_more_ranks_wait_for_the_worker():
    batch = next(synthetic_token_batches(vocab_size=64, global_batch=4, seq=5, device="cpu"))
    assert batch["tokens"].dtype == torch.int32 and batch["tokens"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="item 7"):
        global_batch_from_host_data({"x": np.zeros(2)}, "cpu", num_processes=2)


# -- the pipeline -----------------------------------------------------------------------------

def _pipe_dataset(tmp_path, n=96):
    rng = np.random.default_rng(0)
    register_dataset(tmp_path, "d", [{"x": np.arange(n, dtype=np.int64),
                                      "img": rng.integers(0, 255, (n, 4, 4), dtype=np.uint8)}])


@pytest.mark.parametrize("start, prefetch, workers", [(0, 3, 1), (0, 3, 4), (8, 2, 3)])
def test_a_prefetched_stream_is_the_synchronous_one(tmp_path, start, prefetch, workers):
    _pipe_dataset(tmp_path)
    want = [b for _, b in zip(range(14), DatasetReader(tmp_path, "d", global_batch=16,
                                                       seed=5).batches(start))]
    reader = DatasetReader(tmp_path, "d", global_batch=16, seed=5)
    with TrainPipeline(reader.batch_tasks(start), prefetch=prefetch, workers=workers) as pipe:
        got = [b for _, b in zip(range(14), pipe)]
    for w, g in zip(want, got):
        for a in ("x", "img"):
            _same(w[a], g[a])


@pytest.mark.parametrize("place", ["cpu", None])
def test_prefetch_zero_and_two_give_byte_identical_streams(place):
    def stream(prefetch):
        src = synthetic_token_batches(vocab_size=64, global_batch=4, seq=8, seed=1)
        with TrainPipeline(src, place, prefetch=prefetch, tasks=False) as pipe:
            if prefetch == 0:
                assert pipe._prefetcher is None  # no threads at all
            return [next(pipe) for _ in range(6)]

    for a, b in zip(stream(0), stream(2)):
        for k in ("tokens", "targets"):
            if place is not None:
                assert a[k].device.type == b[k].device.type == "cpu"
            _same(a[k], b[k])


def test_placement_runs_on_the_consumer_thread(tmp_path):
    _pipe_dataset(tmp_path)
    r = DatasetReader(tmp_path, "d", global_batch=16)
    seen = []

    def place(b):
        seen.append(threading.get_ident())
        return b

    with TrainPipeline(r.batch_tasks(0), place, prefetch=2, workers=2) as pipe:
        next(pipe)
        next(pipe)
    assert set(seen) == {threading.get_ident()}


def test_data_wait_is_measured_and_popped_per_interval():
    def slow():
        for i in range(4):
            yield (lambda v=i: (time.sleep(0.03), {"x": np.full(2, v)})[1])

    with TrainPipeline(slow(), "cpu", prefetch=1, workers=1) as pipe:
        waits = []
        for _ in range(4):
            next(pipe)
            waits.append(pipe.pop_data_wait_s())
    assert sum(waits) == pytest.approx(pipe.data_wait_s)
    assert pipe.pop_data_wait_s() == 0.0 and pipe.data_wait_s > 0.02


def test_backpressure_bounds_the_window():
    pulled = []

    def source():
        i = 0
        while True:
            pulled.append(i)
            yield (lambda v=i: v)
            i += 1

    pf = HostPrefetcher(source(), depth=3, workers=2)
    try:
        deadline = time.time() + 5
        while len(pulled) < 4 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert len(pulled) <= 4, pulled
        assert [next(pf) for _ in range(6)] == list(range(6))
        time.sleep(0.2)
        assert len(pulled) <= 10, pulled
    finally:
        pf.close()


def test_order_preserved_under_racing_workers():
    def source():
        for i in range(40):
            yield (lambda v=i: (time.sleep(0.01 if v % 7 else 0.05), v)[1])

    with HostPrefetcher(source(), depth=4, workers=8) as pf:
        assert list(pf) == list(range(40))


def test_close_unblocks_and_errors_surface_in_order():
    pf = HostPrefetcher(iter(lambda: (lambda: 0), None), depth=2, workers=2)
    next(pf)
    pf.close()
    assert not pf._dispatcher.is_alive()
    pf.close()  # idempotent

    def failing_task():
        for i in range(10):
            yield (lambda: (_ for _ in ()).throw(ValueError("task 3"))) if i == 3 \
                else (lambda v=i: v)

    with HostPrefetcher(failing_task(), depth=2, workers=2) as pf:
        assert [next(pf) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="task 3"):
            next(pf)

    def failing_source():
        yield (lambda: 0)
        raise OSError("disk gone")

    with HostPrefetcher(failing_source(), depth=2) as pf:
        assert next(pf) == 0
        with pytest.raises(OSError, match="disk gone"):
            next(pf)
    with HostPrefetcher((lambda v=i: v) for i in range(5)) as pf:
        assert list(pf) == [0, 1, 2, 3, 4] and list(pf) == []


def test_a_trainer_exception_tears_the_threads_down(tmp_path):
    _pipe_dataset(tmp_path)
    r = DatasetReader(tmp_path, "d", global_batch=16)
    with pytest.raises(RuntimeError, match="boom"):
        with TrainPipeline(r.batch_tasks(0), prefetch=2, workers=2) as pipe:
            pf = pipe._prefetcher
            next(pipe)
            raise RuntimeError("boom")
    assert not pf._dispatcher.is_alive()


@pytest.mark.parametrize("place", ["callable", "cpu"])
def test_device_prefetch_places_ahead_and_yields_in_order(place):
    placed, out = [], []
    put = (lambda x: placed.append(x) or x) if place == "callable" else "cpu"
    items = [{"x": np.full(3, i)} for i in range(6)] if place == "cpu" else list(range(6))
    for x in device_prefetch(iter(items), put):
        out.append(x)
        if place == "callable":
            # Batch i+1's placement was dispatched before batch i came out.
            assert len(placed) >= min(len(out) + 1, 6)
    if place == "callable":
        assert out == placed == list(range(6))
    else:
        assert [int(b["x"][0]) for b in out] == list(range(6))
        assert all(isinstance(b["x"], torch.Tensor) for b in out)


def test_to_device_keeps_dtypes_and_bytes():
    batch = {"images": np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
             "labels": np.array([1, 2], np.int32), "pair": (np.ones(2, np.float32),)}
    placed = to_device("cpu")(batch)
    _same(placed["images"].numpy(), batch["images"])
    _same(placed["labels"].numpy(), batch["labels"])
    _same(placed["pair"][0].numpy(), batch["pair"][0])
