"""The port's LM server: ``lm_server`` and its HTTP handler.

Counterpart of ``lm_server`` and ``_make_lm_handler`` in
``polyaxon_tpu/builtins/services.py``: an HTTP front end over the paged
continuous-batching engine (``serving/engine.py``), serving until stopped.
A module of its own so that the other services (``builtins/services.py``,
which names ``lm_server`` and loads this module at its first call) never
load torch or the engine.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from polyaxon_tpu_torch._device import resolve_device
from polyaxon_tpu_torch.builtins.services import _service_port
from polyaxon_tpu_torch.builtins.trainers import _int_params, restore_target
from polyaxon_tpu_torch.models import decode
from polyaxon_tpu_torch.models.transformer import (
    SERVING_STRATEGIES,
    TransformerConfig,
    init_params,
)
from polyaxon_tpu_torch.parallel import flash
from polyaxon_tpu_torch.parallel.axes import tree_shard
from polyaxon_tpu_torch.parallel.templates import template_for
from polyaxon_tpu_torch.serving import EngineDrainingError, ServingEngine
from polyaxon_tpu_torch.stats import get_stats
from polyaxon_tpu_torch.stats.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    render_prometheus,
    render_standard_gauges,
)
from polyaxon_tpu_torch.tracking.capture import get_capture_agent
from polyaxon_tpu_torch.tracking.context import Context
from polyaxon_tpu_torch.tracking.trace import TraceContext, extract, get_tracer, new_trace_id

_FALSY = ("", "0", "false", "no")


def _make_lm_handler(engine, cfg, meta: dict, log=lambda line: None):
    """HTTP handler class over a :class:`ServingEngine` (separate from
    ``lm_server`` so tests drive the production handler against a bare
    engine).  Routes and payloads are the reference's; errors are typed
    ``{"error": {"kind", "message"}}``: ``bad_request`` 400, ``not_found``
    404, ``shed`` 429, ``draining`` and ``timeout`` 503.  A ``/generate``
    joins the caller's trace (its ``traceparent`` header) or, with the
    engine's ``trace_requests`` on, starts one; its answer carries the
    ``trace`` block (``trace_id`` and one waterfall per prompt), and
    ``GET /v1/trace/<id>`` returns this process's spans of a trace."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route into run logs, not stderr
            log("lm_server: " + fmt % args)

        def _json(self, code, payload, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, kind, message, headers=None):
            # Routers and load generators dispatch on error.kind, not on
            # message text.
            return self._json(code, {"error": {"kind": kind, "message": message}}, headers)

        def do_GET(self):
            if self.path == "/v1/stats":
                payload = engine.stats()
                latency = engine.latency_summaries()
                if latency:
                    payload["latency"] = latency
                payload["flash_launches"] = flash.launch_counts()
                return self._json(200, payload)
            if self.path.startswith("/v1/trace/"):
                # This process's spans of one trace, from the tracer's ring;
                # an empty list is an answer (expired or never sampled).
                trace_id = self.path[len("/v1/trace/"):]
                spans = [s for s in get_tracer().spans() if s.get("trace_id") == trace_id]
                return self._json(200, {"trace_id": trace_id, "spans": spans})
            if self.path == "/metrics":
                labels = {"component": "lm_server"}
                text = render_prometheus(engine.stats_registry.snapshot(), labels=labels)
                text += render_standard_gauges(labels=labels)
                body = text.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                return self.wfile.write(body)
            if self.path not in ("/healthz", "/"):
                return self._error(404, "not_found", "not found")
            stats = engine.stats()
            self._json(200, {
                "ok": True,
                "model": {
                    "n_params": cfg.n_params,
                    "vocab_size": cfg.vocab_size,
                    "max_seq": cfg.max_seq,
                    "n_kv_heads": cfg.kv_heads,
                },
                # "warming" until the start()-time warmup has run every
                # shape once; load balancers gate traffic on "ready".
                "state": stats["state"],
                "engine": {
                    "slots": stats["slots"],
                    "slots_active": stats["slots_active"],
                    "queue_depth": stats["queue_depth"],
                    "warmup": stats["warmup"],
                    # Step-family entries built after ready (each a capture
                    # that stalled a batch); 0 when the warmup covered all.
                    "steady_state_compiles": stats["steady_state_compiles"],
                },
                **meta,
            })

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            if self.path == "/v1/cancel":
                try:
                    rid = int(self._body()["request_id"])
                except (KeyError, ValueError, TypeError) as e:
                    return self._error(400, "bad_request", str(e))
                return self._json(200, {"cancelled": engine.cancel(rid)})
            if self.path != "/generate":
                return self._error(404, "not_found", "not found")
            try:
                req = self._body()
                prompts = req["prompts"]
                max_new = int(req.get("max_new_tokens", meta.get("default_max_new", 64)))
                temperature = float(req.get("temperature", 0.0))
                if not prompts or not isinstance(prompts[0], list):
                    raise ValueError("prompts must be a list of id lists")
            except (KeyError, ValueError, TypeError) as e:
                return self._error(400, "bad_request", str(e))
            # Join the caller's trace or mint one; a malformed traceparent
            # extracts to None and gives a fresh trace, never an error.
            tctx = extract(self.headers)
            if tctx is None and engine.trace_requests:
                tctx = TraceContext(new_trace_id())
            if tctx is not None and not tctx.sampled:
                tctx = None
            if tctx is None:
                return self._generate(prompts, max_new, temperature, None)
            with get_tracer().span("serving.generate", sample=1.0, trace_id=tctx.trace_id,
                                   parent_id=tctx.span_id or None, prompts=len(prompts)) as sp:
                return self._generate(prompts, max_new, temperature, tctx.child(sp.span_id))

        def _generate(self, prompts, max_new, temperature, tctx):
            retry_after = {"Retry-After": str(int(meta.get("retry_after_s", 1)))}
            try:
                # Each prompt is its own engine request (mixed lengths are
                # fine); submit() validates each one.
                t0 = time.time()
                reqs = [engine.submit(p, max_new, temperature, trace=tctx) for p in prompts]
            except EngineDrainingError as e:
                return self._error(503, "draining", str(e), retry_after)
            except (KeyError, ValueError, TypeError) as e:
                return self._error(400, "bad_request", str(e))
            try:
                timeout_s = float(meta.get("request_timeout_s", 600))
                tokens = [r.wait(timeout=timeout_s) for r in reqs]
            except (RuntimeError, TimeoutError) as e:
                # The client gets an error and walks away: release every
                # still-running sibling instead of decoding for nobody.
                for r in reqs:
                    if not r.done.is_set():
                        engine.cancel(r.id)
                kinds = {r.error_kind for r in reqs if r.error_kind}
                if "shed" in kinds:
                    # The pool cannot fit this working set right now: back off.
                    return self._error(429, "shed", str(e), retry_after)
                if isinstance(e, TimeoutError):
                    return self._error(503, "timeout", str(e))
                return self._error(503, next(iter(kinds)) if kinds else "engine_error", str(e))
            dt = time.time() - t0
            total = sum(len(t) for t in tokens)
            payload = {
                "tokens": tokens,
                "decode_tokens_per_s": round(total / max(dt, 1e-9), 1),
                "ttft_s": [
                    round(r.first_token_at - t0, 6) if r.first_token_at is not None else None
                    for r in reqs
                ],
            }
            if tctx is not None:
                # Each request's waterfall rides the answer.
                payload["trace"] = {
                    "trace_id": tctx.trace_id,
                    "waterfalls": [r.trace_summary for r in reqs if r.trace_summary is not None],
                }
            self._json(200, payload)

    return Handler


def lm_server(ctx: Context) -> None:
    """LM inference endpoint: a continuous-batching server over a paged KV
    cache, serving until ``ctx.stop`` is set (or its process is killed).

    Routes: ``POST /generate`` ``{"prompts": [[ids…]…], "max_new_tokens": N,
    "temperature": t}`` → ``{"tokens", "decode_tokens_per_s", "ttft_s"}``
    (each prompt its own engine request; a request that times out
    server-side is cancelled before the 503 goes out); ``POST /v1/cancel``
    ``{"request_id": N}``; ``GET /healthz`` (model, occupancy, ``state``
    ``warming``/``ready``/``draining``, warming while the engine builds its
    step family, and the ``steady_state_compiles`` count); ``GET /v1/stats``
    (engine stats, latency percentiles and ``flash_launches``, this process's
    launches of each flash kernel); ``GET /v1/trace/<id>`` (this
    process's spans of a trace); ``GET /metrics`` (Prometheus text).  A
    ``/generate`` with a ``traceparent`` header joins that trace (without
    one, a trace is started while ``POLYAXON_TPU_TRACE_REQUESTS`` is on), and
    its answer carries ``trace``: ``{"trace_id", "waterfalls"}``.

    Params as the reference's: the model shape of ``lm_train``, ``seq`` (per
    request prompt + generation, default 512), ``slots``, ``block_size``,
    ``kv_blocks``, ``kv_quantize``, ``prefill_chunk`` (0 = whole prompts),
    ``prefix_cache`` (default on), ``request_timeout_s``,
    ``max_new_tokens``, ``eos_id``, ``host``, ``service_port`` (or
    ``port``), ``quantize`` (``int8`` weights), ``spec_decode``,
    ``spec_k``, ``spec_min_ngram``, ``target`` (the uuid of a run whose
    newest complete checkpoint gives the weights; omitted = random weights
    from ``ctx.seed``, made on the device), ``kv_offload`` /
    ``kv_offload_blocks`` (the pinned host KV tier: parked sequences spill
    their blocks, cold prefixes demote), ``kv_persist`` / ``kv_persist_dir``
    (the persistent prefix store; ``kv_persist: true`` puts it in
    ``kv_cache/`` beside the runs root, which every replica shares); plus
    ``device`` (default ``cuda``; raises without a card).  The store is
    signed ``ckpt:<target>:<step>`` or ``random:<seed>`` (``:wq-int8`` with
    int8 weights).  A ``drain`` command on the capture agent's bus stops
    admissions (new ``/generate`` calls get a typed 503) while in-flight
    requests finish.

    A gang of several rank processes on one host's cards (a card plan: one
    process a card) serves one engine sharded over the gang's mesh
    (``serving/engine.py``): the weights, a restored checkpoint (restored
    whole on each rank's card, then cut to the rank's shard, so a checkpoint
    written under a training mesh reshards) and the int8 tree are cut by
    ``decode.decode_param_shardings`` / ``quantized_weight_shardings`` under
    the gang's strategy (``ddp``, ``tp`` or ``tp_dp``); the mesh's rank 0
    serves HTTP, ``/healthz`` and ``drain``, the other ranks follow its calls
    and succeed when it stops.  A gang over more than one host serves, as the
    reference does, an independent unsharded replica from each host's first
    rank; the host's other ranks wait for stop.
    """
    if ctx.num_processes > 1:
        per_host = ctx.num_processes // ctx.num_hosts
        if ctx.num_hosts > 1:
            ctx.log_text("lm_server: multi-host gang — serving an independent replica per host "
                         "(sharded decode needs a single-host mesh)")
            if ctx.process_id % per_host:
                ctx.stop.wait()  # the replica is this host's first rank's
                return
        elif ctx.mesh is not None and ctx.mesh.size > 1:
            return _serve(ctx, ctx.mesh)
    return _serve(ctx, None)


def _serve(ctx: Context, mesh) -> None:
    """``lm_server`` on this rank: one card's server (``mesh`` None), or this
    rank's part of one sharded over ``mesh``."""
    device = resolve_device(ctx.get_param("device", "cuda"))
    seq = int(ctx.get_param("seq", 512))
    cfg = TransformerConfig(max_seq=seq, **_int_params(ctx, (
        "vocab_size", "d_model", "n_layers", "n_heads",
        "head_dim", "d_ff", "n_kv_heads", "n_experts",
    )))
    seed = ctx.seed or 0
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    step = None
    target = ctx.get_param("target")
    if target is not None:
        step = restore_target(ctx, target, params)
        ctx.log_text(f"lm_server: restored run {target} step {step}")
    qweights = None
    if str(ctx.get_param("quantize", "") or "") == "int8":
        qweights = decode.quantize_weights(params)
        ctx.log_text("lm_server: int8 weight-only decode enabled")
    sharding = {}
    if mesh is not None:
        template = template_for(ctx.strategy, dict(mesh.shape), ctx.strategy_options)
        if template.name not in SERVING_STRATEGIES:
            raise NotImplementedError(
                f"lm_server across ranks takes one of {', '.join(SERVING_STRATEGIES)}, not "
                f"{template.name!r} (ROADMAP item 7: multi-process and parallelism)")
        specs = decode.decode_param_shardings(cfg, mesh, template, params=params)
        qspecs = (decode.quantized_weight_shardings(cfg, mesh, template, qweights)
                  if qweights is not None else None)
        params = tree_shard(params, specs, mesh)
        if qweights is not None:
            qweights = decode.shard_qweights(qweights, qspecs, mesh)
        sharding = dict(mesh=mesh, param_shardings=specs, qweights_shardings=qspecs)
        ctx.log_text(f"lm_server: sharded over {mesh.shape} under {template.name}, rank "
                     f"{ctx.process_id} of {mesh.size}"
                     + (" (leads)" if ctx.process_id == 0 else ""))

    port = _service_port(ctx)
    host = str(ctx.get_param("host", "0.0.0.0"))
    # Label this process's spans, so a fleet's merged trace puts each
    # replica on its own track.
    get_tracer().configure(
        process=f"lm_server-{ctx.run_uuid[:8]}" if ctx.run_uuid else f"lm_server-{port}"
    )
    eos_id = ctx.get_param("eos_id")
    kv_blocks = ctx.get_param("kv_blocks")
    prefill_chunk = int(ctx.get_param("prefill_chunk", 0) or 0)
    kv_quantize = str(ctx.get_param("kv_quantize", "") or "") or None
    if kv_quantize:
        ctx.log_text(f"lm_server: kv_quantize={kv_quantize} KV pool enabled")
    spec_decode = ctx.get_param("spec_decode")
    spec_decode = None if spec_decode is None else str(spec_decode).lower() not in _FALSY
    spec_k = ctx.get_param("spec_k")
    spec_min_ngram = ctx.get_param("spec_min_ngram")
    if spec_decode:
        ctx.log_text(f"lm_server: speculative decoding enabled "
                     f"(spec_k={spec_k}, spec_min_ngram={spec_min_ngram})")
    kv_offload = ctx.get_param("kv_offload")
    kv_offload = None if kv_offload is None else str(kv_offload).lower() not in _FALSY
    kv_offload_blocks = ctx.get_param("kv_offload_blocks")
    kv_persist_dir = ctx.get_param("kv_persist_dir")
    if kv_persist_dir is None and str(ctx.get_param("kv_persist", "") or "").lower() in (
            "1", "true", "yes"):
        # The store layout's kv_cache/ dir beside runs/: every replica of a
        # fleet lands on the same store, which is what makes warm boot work.
        runs_root = ctx.runs_root or ctx.outputs_path.parent.parent
        kv_persist_dir = runs_root.parent / "kv_cache"
    # Prefix blocks are reusable only under the weights (and the weight
    # quantization) that made them.
    kv_persist_sig = (f"ckpt:{target}:{step}" if target is not None else f"random:{seed}") + (
        ":wq-int8" if qweights is not None else "")
    if kv_offload:
        ctx.log_text("lm_server: host KV offload tier enabled")
    if kv_persist_dir:
        ctx.log_text(f"lm_server: prefix KV persistence at {kv_persist_dir}")
    engine = ServingEngine(
        params,
        cfg,
        slots=int(ctx.get_param("slots", 4)),
        max_len=seq,
        block_size=int(ctx.get_param("block_size", 16)),
        num_blocks=int(kv_blocks) if kv_blocks is not None else None,
        prefill_chunk=prefill_chunk if prefill_chunk > 0 else None,
        prefix_cache=str(ctx.get_param("prefix_cache", "1")).lower() not in _FALSY,
        qweights=qweights,
        kv_quantize=kv_quantize,
        eos_id=int(eos_id) if eos_id is not None else None,
        seed=seed,
        spec_decode=spec_decode,
        spec_k=int(spec_k) if spec_k is not None else None,
        spec_min_ngram=int(spec_min_ngram) if spec_min_ngram is not None else None,
        kv_offload=kv_offload,
        kv_offload_blocks=int(kv_offload_blocks) if kv_offload_blocks is not None else None,
        kv_persist_dir=str(kv_persist_dir) if kv_persist_dir else None,
        kv_persist_sig=kv_persist_sig,
        # The process-wide registry: /metrics exports whatever else this
        # process records too.
        stats=get_stats(),
        device=device,
        **sharding,
    )
    if not engine.is_leader:
        ctx.log_text(f"lm_server: rank {ctx.process_id} following the leader's calls")
        engine.follow()
        return
    engine.start()

    # Control-plane drain: the fleet layer (or an operator) sends a `drain`
    # bus command before replacing this replica.  The handler only flips the
    # engine's admission flag: new /generate calls get a typed 503
    # "draining" while in-flight requests run to completion.
    capture = get_capture_agent()

    def _on_drain(cmd):
        engine.drain()
        ctx.log_text("lm_server: drain command — no new admissions")
        capture.command_event(str(cmd.get("uuid") or ""), "complete", message="engine draining")

    capture.register_handler("drain", _on_drain)

    meta = {
        "checkpoint_step": step,
        "target": target,
        "default_max_new": int(ctx.get_param("max_new_tokens", 64)),
        "request_timeout_s": float(ctx.get_param("request_timeout_s", 600)),
    }
    try:
        server = ThreadingHTTPServer((host, port), _make_lm_handler(engine, cfg, meta,
                                                                    log=ctx.log_text))
    except OSError:
        engine.stop()
        raise
    ctx.log_text(f"lm_server: {cfg.n_params/1e6:.0f}M params, {engine.slots} slots "
                 f"on {host}:{port} ({device}, "
                 + (f"checkpoint step {step})" if step is not None else "random init)"))
    http = threading.Thread(target=server.serve_forever, name="lm-server-http", daemon=True)
    http.start()
    try:
        ctx.stop.wait()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        http.join(timeout=30)
