"""Thin stdlib HTTP/JSON listener over `ScorerService` — counterpart of
`shifu_tpu/serve/http.py` (single-service routes; the fleet routes come
later).

    POST /score   {"dense": [[...]], "index"?, "raw_dense"?,
                   "raw_codes"?}            → scores + per-stage ms
    GET  /healthz                           → liveness
    GET  /stats                             → service counters
    GET  /metrics                           → Prometheus text exposition

`ThreadingHTTPServer` gives one handler thread per connection; every
handler funnels into the service's admission queue, so concurrency is
bounded by the batcher. A full queue answers 429 with `Retry-After`.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from shifu_tpu_torch.config import environment as env
from shifu_tpu_torch.serve.service import ScorerService

log = logging.getLogger("shifu_tpu_torch")

_MAX_BODY = 64 << 20  # 64 MiB: generous for top-bucket float rows


def _np_blocks(payload: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for key, dtype in (("dense", np.float32), ("index", np.int32),
                       ("raw_dense", np.float32), ("raw_codes", np.int32)):
        if payload.get(key) is not None:
            out[key] = np.asarray(payload[key], dtype)
    return out


def prometheus_text(service: ScorerService) -> str:
    """The service's batcher counters and latency percentiles in the
    Prometheus text exposition format."""
    st = service.stats()
    b = st.get("batcher", {})
    lat = st.get("latency", {})
    lines = []

    def _metric(name: str, mtype: str, help_: str, value) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {float(value):.6g}")

    _metric("shifu_serve_requests_total", "counter",
            "requests admitted by the micro-batcher",
            b.get("requests", 0))
    _metric("shifu_serve_batches_total", "counter",
            "batches formed and scored", b.get("batches", 0))
    _metric("shifu_serve_rows_total", "counter",
            "rows scored across all batches", b.get("rows", 0))
    _metric("shifu_serve_queue_depth", "gauge",
            "requests waiting in the admission queue",
            b.get("queued_now", 0))
    _metric("shifu_serve_batch_occupancy", "gauge",
            "mean batch fill fraction vs the top shape bucket",
            b.get("occupancy_mean", 0.0))
    _metric("shifu_serve_rows_per_batch", "gauge",
            "mean rows per formed batch", b.get("rows_per_batch", 0.0))
    _metric("shifu_serve_rejected_total", "counter",
            "requests rejected on a full admission queue",
            st.get("rejected", 0))
    lines.append("# HELP shifu_serve_latency_ms request latency "
                 "percentiles over the recent window")
    lines.append("# TYPE shifu_serve_latency_ms summary")
    for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                   ("0.99", "p99_ms")):
        if key in lat:
            lines.append(f'shifu_serve_latency_ms{{quantile="{q}"}} '
                         f"{float(lat[key]):.6g}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # stdout belongs to metrics
        pass

    def _reply(self, code: int, body: Dict[str, Any],
               headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        service = self.server.service
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, service.stats())
        elif self.path == "/metrics":
            data = prometheus_text(service).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/score":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= _MAX_BODY:
                raise ValueError(f"bad Content-Length {length}")
            payload = json.loads(self.rfile.read(length))
            scores, timing = self.server.service.submit_timed(
                **_np_blocks(payload))
        except queue.Full as e:
            self._reply(429, {"error": str(e) or "admission queue full"},
                        headers={"Retry-After": "1"})
            return
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except TimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — the listener keeps serving
            log.exception("scoring request failed")
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, {
            "scores": {k: np.asarray(v).tolist() for k, v in scores.items()},
            "timing_ms": {k: v * 1e3 for k, v in timing.items()},
        })


class HttpFrontEnd:
    """Owns the listener thread; `address` is the bound (host, port) —
    pass port 0 for an ephemeral port."""

    def __init__(self, service: ScorerService, host: str = "0.0.0.0",
                 port: Optional[int] = None):
        if port is None:
            port = env.knob_int("SHIFU_TPU_SERVE_PORT")
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.service = service
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    def start(self) -> "HttpFrontEnd":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, name="serve-http",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join()
            self._thread = None
        self._server.server_close()
