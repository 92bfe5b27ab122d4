"""stdlib HTTP front end for the generation service (``dcr_tpu/serve/server.py``).

Endpoints (JSON in and out):

- ``POST /generate``: body ``{"prompt": str, "seed"?: int, "steps"?: int,
  "guidance"?: float, "sampler"?: str, "rand_noise_lam"?: float,
  "resolution"?: int, "fast_ratio"?: float, "fast_order"?: int}``. 200 with
  ``{"id", "image_png_b64", "width", "height", "cache_hit", "copy_risk",
  "latency_ms"}``; 400 on malformed input or invalid bucket parameters; 503
  with ``{"error": "overloaded"|"draining"|"bucket_limit"}`` on a typed
  admission rejection; 504 past the configured wait bound.
- ``POST /check``: body ``{"image_png_b64": <base64 PNG or JPEG>}`` scored
  against the train-embedding index (200 with ``{max_sim, top_key,
  flagged, topk, threshold, index_size}``; 503 with the risk status while
  no index is loaded).
- ``GET /healthz``: ``{"status": "warming"|"ok"|"draining", "buckets_warm",
  "buckets_total", "risk": "absent"|"loading"|"ok"|"failed"}``.
- ``GET /metrics``: the :meth:`GenerationService.status` document;
  ``?format=prometheus`` renders the telemetry registry (the same document
  folded into gauges, the copy-risk counters, the latency summary and the
  ``dcr_device_mem_*`` gauges) in Prometheus text format.
- ``POST /debug/profile``: body ``{"steps"?: int, "logdir"?: str}`` arms
  ``torch.profiler`` over the next K device steps (200 with the armed
  status; 409 when already armed or without a destination); ``GET
  /debug/profile`` reports the status, with ``artifact`` (the Chrome
  trace) once written.
- ``POST /generate_batch``: the fleet supervisor's dispatch call, body
  ``{"requests": [item, ...]}`` where an item is a /generate body with the
  full bucket and a ``trace`` context (``supervisor.wire_item``). 200 with
  ``{"results": [...]}``, positional; a per-item failure is an
  ``{"error": "<TypeName>: <detail>"}`` item, a malformed envelope a 400.
- ``GET /slo``: the fleet supervisor's SLO document (``obs/slo.py``); 404
  on a service without an SLO engine, as a single worker is.

The handler works against either service: a :class:`GenerationService` or
a :class:`~dcr_tpu_torch.serve.supervisor.FleetSupervisor`, whose futures
resolve to the worker's rendered document (passed through, bar the id),
whose ``/metrics?format=prometheus`` is every worker's text merged under
``worker`` labels (``prometheus_merged``), and which routes ``/check`` and
``/debug/profile`` to a worker. Each response is written inside a
``serve/respond`` span under the request's root. PNGs are written by the
port's own encoder (``sampling/png``). ``block_on_close`` and non-daemon
handler threads give the drain guarantee: ``server_close()`` returns only
after every in-flight response has been written.
"""

from __future__ import annotations

import base64
import json
import logging
import socket
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.config import ServeConfig
from dcr_tpu_torch.sampling import fastsample
from dcr_tpu_torch.sampling.png import encode_png
from dcr_tpu_torch.serve.queue import (AdmissionError, BucketLimitError, DrainingError,
                                       GenBucket, InvalidRequestError, MemoryBudgetError,
                                       NoWorkersError, QueueFullError, SloShedError)
from dcr_tpu_torch.serve.worker import MAX_STEPS, GenerationService

log = logging.getLogger("dcr_tpu_torch")

_ALLOWED_OVERRIDES = ("seed", "steps", "guidance", "sampler", "rand_noise_lam",
                      "resolution", "fast_ratio", "fast_order")

# typed admission rejection -> (HTTP status, wire error tag). SloShedError
# and NoWorkersError also carry a Retry-After hint
_ADMISSION_RESPONSES = (
    (InvalidRequestError, 400, "bad_request"),
    (QueueFullError, 503, "overloaded"),
    (BucketLimitError, 503, "bucket_limit"),
    (MemoryBudgetError, 503, "memory_budget"),
    (DrainingError, 503, "draining"),
    (SloShedError, 503, "shed"),
    (NoWorkersError, 503, "no_workers"),
)


def admission_response(e: AdmissionError) -> tuple[int, dict, dict]:
    """(status, payload, extra headers) for a typed admission rejection."""
    for cls, code, tag in _ADMISSION_RESPONSES:
        if isinstance(e, cls):
            payload = ({"error": f"bad request: {e}"} if code == 400
                       else {"error": tag, "detail": str(e)})
            headers = {}
            retry_after = getattr(e, "retry_after_s", None)
            if retry_after is not None:
                headers["Retry-After"] = str(max(1, round(retry_after)))
            return code, payload, headers
    return 503, {"error": "overloaded", "detail": str(e)}, {}


def png_bytes(image: np.ndarray) -> bytes:
    """float32 [H, W, 3] in [0, 1] -> PNG (on handler threads, keeping the
    worker thread on device work)."""
    return encode_png((np.asarray(image) * 255.0).round().astype(np.uint8))


def request_bucket(service: GenerationService, body: dict) -> GenBucket:
    """Default bucket plus per-request overrides. Unknown keys are a
    400-class error."""
    unknown = set(body) - {"prompt"} - set(_ALLOWED_OVERRIDES)
    if unknown:
        raise ValueError(f"unknown request fields {sorted(unknown)!r}")
    d = service.default_bucket()
    steps = int(body.get("steps", d.steps))
    if not 1 <= steps <= MAX_STEPS:
        # bounds-checked before the canonical plan below, which is O(steps)
        # on the host
        raise ValueError(f"steps must be in [1, {MAX_STEPS}], got {steps}")
    # every fast parameterization whose plan is dense maps onto one bucket
    # identity (invalid values pass through and fail validate_bucket)
    fast_ratio, fast_order = fastsample.canonical_plan_params(
        steps, float(body.get("fast_ratio", d.fast_ratio)),
        int(body.get("fast_order", d.fast_order)))
    return GenBucket(
        resolution=int(body.get("resolution", d.resolution)),
        steps=steps,
        guidance=float(body.get("guidance", d.guidance)),
        sampler=str(body.get("sampler", d.sampler)),
        rand_noise_lam=float(body.get("rand_noise_lam", d.rand_noise_lam)),
        fast_ratio=fast_ratio,
        fast_order=fast_order,
    )


class ServeHandler(BaseHTTPRequestHandler):
    service: GenerationService      # set by make_server on the subclass
    cfg: ServeConfig
    protocol_version = "HTTP/1.1"
    # socket timeout between requests on a keep-alive connection: without
    # it an idle pooled connection parks its handler thread forever and the
    # drain's server_close(), which joins handler threads, never returns
    timeout = 15

    def log_message(self, fmt, *args):  # access logs through logging
        log.debug("serve http: " + fmt, *args)

    def _reply(self, code: int, payload: dict, headers: Optional[dict] = None) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _reply_text(self, code: int, text: str,
                    content_type: str = "text/plain; version=0.0.4") -> None:
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", "0"))
        body = json.loads(self.rfile.read(length) or b"{}")
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        return body

    def do_GET(self) -> None:
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._reply(200, self.service.health_doc())
        elif url.path == "/metrics":
            fmt = parse_qs(url.query).get("format", ["json"])[0]
            if fmt == "prometheus":
                merged = getattr(self.service, "prometheus_merged", None)
                if callable(merged):
                    # a fleet supervisor: its own registry and every
                    # worker's cached scrape under worker labels; never
                    # blocks on a worker
                    self._reply_text(200, merged())
                    return
                # fold the live status document into registry gauges, then
                # render the whole registry
                status_doc = dict(self.service.status())
                status_doc.pop("compiled_buckets", None)  # not numeric
                tracing.update_gauges(status_doc, prefix="serve/")
                self._reply_text(200, tracing.registry().prometheus_text())
            else:
                self._reply(200, self.service.status())
        elif url.path == "/slo":
            slo_fn = getattr(self.service, "slo_doc", None)
            if not callable(slo_fn):
                self._reply(404, {"error": "slo engine not supported"})
                return
            try:
                self._reply(200, slo_fn())
            except Exception as e:
                self._reply(500, {"error": f"slo status failed: {e!r}"})
        elif url.path == "/debug/profile":
            try:
                self._reply(200, self.service.profile_status())
            except Exception as e:
                self._reply(500, {"error": f"profile status failed: {e!r}"})
        else:
            self._reply(404, {"error": f"no such endpoint {self.path!r}"})

    def _parse_one(self, body: dict) -> tuple[str, int, GenBucket]:
        prompt = body["prompt"]
        if not isinstance(prompt, str) or not prompt.strip():
            raise ValueError("'prompt' must be a non-empty string")
        bucket = request_bucket(self.service, body)
        return prompt, int(body.get("seed", 0)), bucket

    def _render(self, req, image) -> dict:
        """The /generate response document. A fleet supervisor's future
        resolves to the worker's rendered document, passed through bar the
        id, so a response is the same whichever worker or incarnation ran
        the batch; a single service's resolves to the image array."""
        if isinstance(image, dict):
            return {**image, "id": req.id, "latency_ms": None}
        return {
            "id": req.id,
            "image_png_b64": base64.b64encode(png_bytes(image)).decode(),
            "width": int(image.shape[1]),
            "height": int(image.shape[0]),
            "cache_hit": bool(req.cache_hit),
            # {max_sim, top_key, flagged, topk} when a train-embedding index
            # is loaded; null = unscored
            "copy_risk": req.risk,
            "latency_ms": None,  # client-side wall time is the honest number
        }

    def do_POST(self) -> None:
        if self.path == "/generate":
            self._post_generate()
        elif self.path == "/generate_batch":
            self._post_generate_batch()
        elif self.path == "/check":
            self._post_check()
        elif self.path == "/debug/profile":
            self._post_profile()
        else:
            self._reply(404, {"error": f"no such endpoint {self.path!r}"})

    def _post_profile(self) -> None:
        """Arm ``torch.profiler`` around the worker's next K device steps;
        on a fleet supervisor, routed to the named (or the first alive)
        worker."""
        try:
            body = self._read_json()
        except (TypeError, ValueError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
            return
        try:
            self._reply(200, self.service.profile(body))
        except AdmissionError as e:      # a fleet with no alive worker
            self._reply(*admission_response(e))
        except (ValueError, RuntimeError) as e:
            # already armed, no destination, steps < 1
            self._reply(409, {"error": str(e)})
        except Exception as e:
            self._reply(500, {"error": f"profile arm failed: {e!r}"})

    def _post_check(self) -> None:
        """Copy-risk query: score one submitted image against the index."""
        from dcr_tpu_torch.obs.copyrisk import RiskUnavailableError

        try:
            body = self._read_json()
        except (TypeError, ValueError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
            return
        try:
            self._reply(200, self.service.check(body))
        except RiskUnavailableError as e:
            self._reply(503, {"error": "risk_unavailable", "risk": e.status,
                              "detail": str(e)})
        except AdmissionError as e:
            self._reply(*admission_response(e))
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
        except Exception as e:
            log.exception("serve: /check failed")
            self._reply(500, {"error": f"check failed: {e!r}"})

    def _post_generate(self) -> None:
        try:
            prompt, seed, bucket = self._parse_one(self._read_json())
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
            return
        try:
            req = self.service.submit(prompt, seed=seed, bucket=bucket)
        except AdmissionError as e:
            self._reply(*admission_response(e))
            return
        try:
            result = req.future.result(timeout=self.cfg.request_timeout_s)
        except FutureTimeout:
            self._reply(504, {"error": "request timed out in queue/batch"})
            return
        except Exception as e:
            self._reply(500, {"error": f"generation failed: {e!r}"})
            return
        # the response leg of the request's tree: PNG encode and socket write
        # on this handler thread, off the device worker's path
        with tracing.span("serve/respond", request_id=req.id,
                          parent=req.span.id if req.span is not None else None,
                          trace=req.trace_id):
            self._reply(200, self._render(req, result))

    def _post_generate_batch(self) -> None:
        """The fleet dispatch channel's call: a bucket-coherent batch
        submitted together and answered together, positionally. A per-item
        failure is an ``{"error": ...}`` item (the supervisor fails exactly
        that request, or requeues it when the error names this worker's
        state); a malformed envelope is a 400 (the supervisor requeues the
        whole batch elsewhere)."""
        try:
            body = self._read_json()
            items = body["requests"]
            if not isinstance(items, list) or not items:
                raise ValueError("'requests' must be a non-empty list")
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
            return
        reqs: list = []
        for item in items:
            try:
                # the dispatcher's trace context rides beside the generation
                # fields; it is not a bucket override
                item = dict(item) if isinstance(item, dict) else item
                tctx = item.pop("trace", None) if isinstance(item, dict) else None
                if not isinstance(item, dict):
                    raise ValueError("body must be a JSON object")
                prompt, seed, bucket = self._parse_one(item)
                reqs.append(self.service.submit(
                    prompt, seed=seed, bucket=bucket,
                    trace_ctx=tctx if isinstance(tctx, dict) else None))
            except (KeyError, TypeError, ValueError, AdmissionError) as e:
                reqs.append({"error": f"{type(e).__name__}: {e}"})
        results: list[dict] = []
        for req in reqs:
            if isinstance(req, dict):        # refused at submit
                results.append(req)
                continue
            try:
                image = req.future.result(timeout=self.cfg.request_timeout_s)
            except Exception as e:  # a timeout or a failed batch: per item
                results.append({"error": f"{type(e).__name__}: {e}"})
                continue
            with tracing.span("serve/respond", request_id=req.id,
                              parent=req.span.id if req.span is not None else None,
                              trace=req.trace_id):
                results.append(self._render(req, image))
        self._reply(200, {"results": results})


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 resets the connections of a burst
    # of clients that arrive while the accept loop waits for the GIL (the
    # sampler thread holds it between launches); the kernel caps this
    request_queue_size = socket.SOMAXCONN


def make_server(cfg: ServeConfig, service) -> ThreadingHTTPServer:
    """ThreadingHTTPServer wired to the service (a :class:`GenerationService`
    or a fleet supervisor). Handler threads are non-daemon and joined by
    ``server_close()`` (block_on_close), so the drain sequence can
    guarantee every accepted request gets its response. The listen backlog
    holds a burst of concurrent clients, the supervisor's front end's
    too."""
    handler = type("BoundServeHandler", (ServeHandler,), {"service": service, "cfg": cfg})
    httpd = _Server((cfg.host, cfg.port), handler)
    httpd.daemon_threads = False
    httpd.block_on_close = True
    return httpd
