"""Standalone ``lm_server`` replica: the fleet's subprocess entry point.

``python -m polyaxon_tpu_torch.serving.replica <spec.json>`` boots one
engine and the production HTTP handler (``_make_lm_handler``) with no
platform ``Context``: the process-level unit that
:class:`~polyaxon_tpu_torch.serving.fleet.LocalServingFleet` provisions
through ``spawner.transport.LocalExecTransport``, so fault injection
(SIGKILL, SIGSTOP) hits a real OS process, not a thread.  Counterpart of
``polyaxon_tpu/serving/replica.py``.

The spec is the reference's plain JSON, plus ``device``::

    {
      "name": "r0", "host": "127.0.0.1", "port": 8301, "seed": 0,
      "model": {"vocab_size": 64, "d_model": 32, ...},  # TransformerConfig ints
      "seq": 48, "slots": 4, "block_size": 16,
      "kv_blocks": null, "prefill_chunk": 0,
      "spec_decode": null, "spec_k": null, "spec_min_ngram": null,
      "kv_offload": null, "kv_offload_blocks": null,
      "kv_persist_dir": null, "kv_persist_sig": "",
      "max_new_tokens": 64, "request_timeout_s": 600.0,
      "retry_after_s": 1.0,
      "device": "cuda"
    }

``device`` defaults to ``"cuda"`` and raises without a card, as every entry
point of the port does.  The weights are random, made on the replica's
device by a ``torch.Generator`` seeded from ``seed``: every replica of a
fleet on the same card makes the same weights, which is what makes a greedy
failover replay token-identical.  Checkpointed fleets go through the
control plane (``lm_server`` with a ``target``), which this entry does not
duplicate.
"""

from __future__ import annotations

import json
import sys


def serve(spec: dict) -> None:
    # Heavy imports stay inside serve(): a usage error costs no torch import.
    import os
    from http.server import ThreadingHTTPServer

    import torch

    from polyaxon_tpu_torch._device import resolve_device
    from polyaxon_tpu_torch.builtins.services import _make_lm_handler
    from polyaxon_tpu_torch.models.transformer import TransformerConfig, init_params
    from polyaxon_tpu_torch.serving import ServingEngine
    from polyaxon_tpu_torch.tracking.trace import get_tracer

    device = resolve_device(spec.get("device", "cuda"))
    # Label this process's spans with the replica name: span ids become
    # unique across the fleet and the router's merged trace gives each
    # replica its own named track.
    name = str(spec.get("name") or f"replica-{spec.get('port', 0)}")
    get_tracer().configure(process=name, process_id=os.getpid())

    model = {k: int(v) for k, v in (spec.get("model") or {}).items()}
    seq = int(spec.get("seq", 128))
    cfg = TransformerConfig(max_seq=seq, **model)
    seed = int(spec.get("seed", 0))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))

    kv_blocks = spec.get("kv_blocks")
    prefill_chunk = int(spec.get("prefill_chunk", 0) or 0)
    spec_decode = spec.get("spec_decode")
    spec_k = spec.get("spec_k")
    spec_min_ngram = spec.get("spec_min_ngram")
    kv_offload = spec.get("kv_offload")
    kv_offload_blocks = spec.get("kv_offload_blocks")
    kv_persist_dir = spec.get("kv_persist_dir")
    engine = ServingEngine(
        params,
        cfg,
        slots=int(spec.get("slots", 4)),
        max_len=seq,
        block_size=int(spec.get("block_size", 16)),
        num_blocks=int(kv_blocks) if kv_blocks is not None else None,
        prefill_chunk=prefill_chunk if prefill_chunk > 0 else None,
        seed=seed,
        spec_decode=bool(spec_decode) if spec_decode is not None else None,
        spec_k=int(spec_k) if spec_k is not None else None,
        spec_min_ngram=int(spec_min_ngram) if spec_min_ngram is not None else None,
        kv_offload=bool(kv_offload) if kv_offload is not None else None,
        kv_offload_blocks=int(kv_offload_blocks) if kv_offload_blocks is not None else None,
        kv_persist_dir=str(kv_persist_dir) if kv_persist_dir else None,
        kv_persist_sig=str(spec.get("kv_persist_sig", "")),
        device=device,
    ).start()

    meta = {
        "checkpoint_step": None,
        "target": None,
        "default_max_new": int(spec.get("max_new_tokens", 64)),
        "request_timeout_s": float(spec.get("request_timeout_s", 600.0)),
        "retry_after_s": float(spec.get("retry_after_s", 1.0)),
    }
    host = str(spec.get("host", "127.0.0.1"))
    port = int(spec["port"])
    try:
        server = ThreadingHTTPServer((host, port), _make_lm_handler(engine, cfg, meta))
        print(f"replica: serving on {host}:{port} ({device})", flush=True)
        server.serve_forever()
    finally:
        engine.stop()


def main(argv) -> int:
    if len(argv) != 1:
        print("usage: python -m polyaxon_tpu_torch.serving.replica <spec.json>")
        return 2
    with open(argv[0]) as f:
        spec = json.load(f)
    serve(spec)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
