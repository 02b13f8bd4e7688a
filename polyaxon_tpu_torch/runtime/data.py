"""Host-sharded data loading helpers.

The port's copy of ``polyaxon_tpu/runtime/data.py``.  Each process reads
only its rows of the global batch (:func:`host_shard_bounds`); the reference
assembles the hosts' rows into one global ``jax.Array``.  The port runs one
rank a card, so :func:`global_batch_from_host_data` puts a rank's rows on
its device as its local batch.  Batches sharded over more than one rank
wait for the port's worker and mesh (ROADMAP Queue 1 item 7), and the
function says so when asked for them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from polyaxon_tpu_torch._device import DeviceLike


def host_shard_bounds(
    global_batch: int, num_processes: int, process_id: int
) -> tuple:
    """[start, stop) rows of the global batch this host should load."""
    if global_batch % num_processes:
        raise ValueError(
            f"Global batch {global_batch} not divisible by {num_processes} hosts"
        )
    per = global_batch // num_processes
    return process_id * per, (process_id + 1) * per


def global_batch_from_host_data(
    local_batch: Dict[str, Any], device: DeviceLike = "cuda", num_processes: int = 1
) -> Dict[str, torch.Tensor]:
    """This rank's numpy rows as tensors on ``device`` (a synchronous copy;
    ``runtime.pipeline.device_prefetch`` is the overlapped one).  Raises for
    ``num_processes`` > 1: one global batch over several ranks needs the
    port's worker and mesh (ROADMAP Queue 1 item 7)."""
    if num_processes != 1:
        raise NotImplementedError(
            f"a batch over {num_processes} ranks is not ported yet (ROADMAP Queue 1 "
            "item 7, the port worker); the port places one rank's local batch"
        )
    dev = torch.device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in local_batch.items()}


def synthetic_token_batches(
    *,
    vocab_size: int,
    global_batch: int,
    seq: int,
    device: Optional[DeviceLike] = None,
    seed: int = 0,
    num_processes: int = 1,
    process_id: int = 0,
) -> Iterator[Dict[str, Any]]:
    """Endless deterministic LM batches (int32 ``tokens`` and next-token
    ``targets``), host-sharded: every host draws the full stream from the
    shared seed and keeps its own rows, the same rows as the reference's for
    the same seed.  With ``device`` None the batches stay numpy on the host
    (the source a ``TrainPipeline`` places); otherwise they are placed by
    :func:`global_batch_from_host_data`."""
    rng = np.random.default_rng(seed)
    lo, hi = host_shard_bounds(global_batch, num_processes, process_id)
    while True:
        tokens = rng.integers(0, vocab_size, (global_batch, seq + 1))
        local = tokens[lo:hi]
        batch = {
            "tokens": local[:, :-1].astype(np.int32),
            "targets": local[:, 1:].astype(np.int32),
        }
        if device is None:
            yield batch
        else:
            yield global_batch_from_host_data(batch, device, num_processes)
