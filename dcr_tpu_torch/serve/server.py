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
  folded into gauges, the copy-risk counters and the latency summary) in
  Prometheus text format.

``POST /generate_batch`` and ``GET /slo`` belong to the serving fleet, and
``/debug/profile`` to profiling (ROADMAP Queue A items 8 and 7): they
answer 404 as the JAX handler does for a service without them. PNGs are
written by the port's own encoder (``sampling/png``). ``block_on_close`` and
non-daemon handler threads give the drain guarantee: ``server_close()``
returns only after every in-flight response has been written.
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
                # fold the live status document into registry gauges, then
                # render the whole registry
                status_doc = dict(self.service.status())
                status_doc.pop("compiled_buckets", None)  # not numeric
                tracing.update_gauges(status_doc, prefix="serve/")
                self._reply_text(200, tracing.registry().prometheus_text())
            else:
                self._reply(200, self.service.status())
        elif url.path == "/slo":
            self._reply(404, {"error": "slo engine not supported"})
        elif url.path == "/debug/profile":
            self._reply(404, {"error": "profiling not supported"})
        else:
            self._reply(404, {"error": f"no such endpoint {self.path!r}"})

    def _parse_one(self, body: dict) -> tuple[str, int, GenBucket]:
        prompt = body["prompt"]
        if not isinstance(prompt, str) or not prompt.strip():
            raise ValueError("'prompt' must be a non-empty string")
        bucket = request_bucket(self.service, body)
        return prompt, int(body.get("seed", 0)), bucket

    def _render(self, req, image: np.ndarray) -> dict:
        """The /generate response document."""
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
        elif self.path == "/check":
            self._post_check()
        elif self.path == "/debug/profile":
            self._reply(404, {"error": "profiling not supported"})
        else:
            # /generate_batch too: the fleet's dispatch channel
            self._reply(404, {"error": f"no such endpoint {self.path!r}"})

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
        self._reply(200, self._render(req, result))


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 resets the connections of a burst
    # of clients that arrive while the accept loop waits for the GIL (the
    # sampler thread holds it between launches); the kernel caps this
    request_queue_size = socket.SOMAXCONN


def make_server(cfg: ServeConfig, service: GenerationService) -> ThreadingHTTPServer:
    """ThreadingHTTPServer wired to the service. Handler threads are
    non-daemon and joined by ``server_close()`` (block_on_close), so the
    drain sequence can guarantee every accepted request gets its response.
    The listen backlog holds a burst of concurrent clients."""
    handler = type("BoundServeHandler", (ServeHandler,), {"service": service, "cfg": cfg})
    httpd = _Server((cfg.host, cfg.port), handler)
    httpd.daemon_threads = False
    httpd.block_on_close = True
    return httpd
