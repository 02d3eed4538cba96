"""Thin stdlib HTTP/JSON listener over `ScorerService` or a
`FleetService` — counterpart of `shifu_tpu/serve/http.py`.

    POST /score   {"dense": [[...]], "index"?, "raw_dense"?,
                   "raw_codes"?}            → scores + per-stage ms
    POST /score/<model>                     → fleet-routed scoring
    GET  /healthz                           → liveness + SLO state
    GET  /stats                             → service (or fleet) counters
    GET  /metrics                           → Prometheus text exposition

`ThreadingHTTPServer` gives one handler thread per connection; every
handler funnels into a service's admission queue, so concurrency is
bounded by the batcher. In fleet mode (`HttpFrontEnd(fleet=...)`)
`/score/<model>` routes to the named registry model; a shed and a full
queue both answer 429 with a `Retry-After` header. `/healthz` always
answers `ok` (the process is alive) and adds the workspace's SLO status
when the service knows its workspace.
"""

from __future__ import annotations

import json
import logging
import math
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
    """Render the service's existing accruals (batcher counters +
    latency percentiles) in the Prometheus text exposition format —
    counters as `shifu_serve_*_total`, gauges/summaries otherwise."""
    st = service.stats()
    b = st.get("batcher", {})
    lat = st.get("latency", {})
    lines = []

    def _metric(name: str, mtype: str, help_: str, value,
                labels: str = "") -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {float(value):.6g}")

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
    lines.append("# HELP shifu_serve_latency_ms request latency "
                 "percentiles over the recent window")
    lines.append("# TYPE shifu_serve_latency_ms summary")
    for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                   ("0.99", "p99_ms")):
        if key in lat:
            lines.append(f'shifu_serve_latency_ms{{quantile="{q}"}} '
                         f"{float(lat[key]):.6g}")
    rej = st.get("rejected_by_class", {})
    lines.append("# HELP shifu_serve_rejected_total requests rejected "
                 "(queue full or shed) per priority class")
    lines.append("# TYPE shifu_serve_rejected_total counter")
    for cls in sorted(rej):
        lines.append(f'shifu_serve_rejected_total{{priority="{cls}"}} '
                     f"{float(rej[cls]):.6g}")
    return "\n".join(lines) + "\n"


def prometheus_fleet_text(fleet) -> str:
    """Fleet exposition: fleet-level gauges plus every *resident*
    model's service metrics labeled `model=`/`priority=` (an evicted
    model has no live counters — its absence from the per-model series
    is itself the residency signal)."""
    st = fleet.stats()
    fl = st["fleet"]
    lines = []

    def _metric(name: str, mtype: str, help_: str, value,
                labels: str = "") -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {float(value):.6g}")

    _metric("shifu_fleet_models_resident", "gauge",
            "models currently holding device residency",
            fl["models_resident"])
    _metric("shifu_fleet_evictions_total", "counter",
            "LRU evictions forced by the HBM budget", fl["evictions"])
    _metric("shifu_fleet_rewarm_seconds_total", "counter",
            "time spent re-warming evicted models", fl["rewarm_s"])
    _metric("shifu_fleet_shed_rate", "gauge",
            "fraction of offered low-priority requests shed",
            fl["shed_rate"])
    _metric("shifu_fleet_shedding", "gauge",
            "1 while the low-priority shed switch is engaged",
            1 if st.get("shedding") else 0)
    lines.append("# HELP shifu_fleet_p99_ms rolling p99 latency per "
                 "priority class")
    lines.append("# TYPE shifu_fleet_p99_ms gauge")
    for cls, v in sorted((fl.get("p99_ms_by_class") or {}).items()):
        if v is not None:
            lines.append(f'shifu_fleet_p99_ms{{priority="{cls}"}} '
                         f"{float(v):.6g}")
    rej = st.get("rejected_by_class", {})
    lines.append("# HELP shifu_serve_rejected_total requests rejected "
                 "(queue full or shed) per priority class")
    lines.append("# TYPE shifu_serve_rejected_total counter")
    for cls in sorted(rej):
        lines.append(f'shifu_serve_rejected_total{{priority="{cls}"}} '
                     f"{float(rej[cls]):.6g}")
    arms = st.get("canary") or {}
    if arms:
        lines.append("# HELP shifu_canary_requests_total live "
                     "requests observed per promotion arm")
        lines.append("# TYPE shifu_canary_requests_total counter")
        lines.append("# HELP shifu_canary_p99_ms rolling p99 latency "
                     "per promotion arm")
        lines.append("# TYPE shifu_canary_p99_ms gauge")
        lines.append("# HELP shifu_canary_arm_psi score-distribution "
                     "PSI between the primary and challenger arms")
        lines.append("# TYPE shifu_canary_arm_psi gauge")
        lines.append("# HELP shifu_canary_shadow_dropped_total shadow "
                     "mirrors dropped on the bounded queue")
        lines.append("# TYPE shifu_canary_shadow_dropped_total counter")
        lines.append("# HELP shifu_canary_fallbacks_total canary "
                     "requests absorbed back onto the primary")
        lines.append("# TYPE shifu_canary_fallbacks_total counter")
        for name, a in sorted(arms.items()):
            for arm_name, n in sorted((a.get("requests") or {}).items()):
                lines.append(
                    f'shifu_canary_requests_total{{model="{name}",'
                    f'arm="{arm_name}"}} {float(n):.6g}')
            for arm_name, v in sorted((a.get("p99_ms") or {}).items()):
                if v is not None:
                    lines.append(
                        f'shifu_canary_p99_ms{{model="{name}",'
                        f'arm="{arm_name}"}} {float(v):.6g}')
            if a.get("arm_psi") is not None:
                lines.append(f'shifu_canary_arm_psi{{model="{name}"}} '
                             f'{float(a["arm_psi"]):.6g}')
            lines.append(
                f'shifu_canary_shadow_dropped_total{{model="{name}"}} '
                f'{float(a.get("shadow_dropped", 0)):.6g}')
            lines.append(
                f'shifu_canary_fallbacks_total{{model="{name}"}} '
                f'{float(a.get("canary_fallbacks", 0)):.6g}')
    for name, ms in sorted(st.get("models", {}).items()):
        if not ms.get("resident"):
            continue
        labels = f'{{model="{name}",priority="{ms.get("priority")}"}}'
        b = ms.get("batcher", {})
        for metric, key in (("shifu_serve_requests_total", "requests"),
                            ("shifu_serve_batches_total", "batches"),
                            ("shifu_serve_rows_total", "rows")):
            lines.append(f"{metric}{labels} "
                         f"{float(b.get(key, 0)):.6g}")
        for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                       ("0.99", "p99_ms")):
            lat = ms.get("latency", {})
            if key in lat:
                lines.append(
                    f'shifu_serve_latency_ms{{model="{name}",'
                    f'priority="{ms.get("priority")}",quantile="{q}"}} '
                    f"{float(lat[key]):.6g}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    service: ScorerService  # set on the server class by serve_http

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

    def _reply_text(self, code: int, text: str) -> None:
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        fleet = getattr(self.server, "fleet", None)
        if self.path == "/healthz":
            # liveness (ok) + the workspace's SLO state when the
            # service knows its workspace — breach does NOT flip `ok`
            # (the process is alive; the SLO block is for routers and
            # dashboards that want to act on degradation)
            body: Dict[str, Any] = {"ok": True}
            owner = fleet if fleet is not None else self.server.service
            slo = owner.health_state()
            if slo is not None:
                body["status"] = slo["status"]
                body["slo"] = slo["slos"]
            if fleet is not None:
                body["models"] = fleet.models()
            self._reply(200, body)
        elif self.path == "/stats":
            if fleet is not None:
                self._reply(200, fleet.stats())
            else:
                self._reply(200, self.server.service.stats())
        elif self.path == "/metrics":
            if fleet is not None:
                self._reply_text(200, prometheus_fleet_text(fleet))
            else:
                self._reply_text(200,
                                 prometheus_text(self.server.service))
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        fleet = getattr(self.server, "fleet", None)
        model = None
        if fleet is not None and self.path.startswith("/score/"):
            model = self.path[len("/score/"):]
            if model not in fleet.models():
                self._reply(404, {"error": f"no model {model!r}",
                                  "models": fleet.models()})
                return
        elif fleet is None and self.path == "/score":
            pass  # single-model mode: the one implicit route
        else:
            # fleet mode has no default model — routing is explicit
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= _MAX_BODY:
                raise ValueError(f"bad Content-Length {length}")
            payload = json.loads(self.rfile.read(length))
            blocks = _np_blocks(payload)
            if model is not None:
                scores, timing = fleet.submit_timed(model, **blocks)
            else:
                scores, timing = \
                    self.server.service.submit_timed(**blocks)
        except queue.Full as e:
            # covers both a full admission queue and a fleet
            # ShedReject (a queue.Full subclass carrying the hint)
            retry_s = max(1, math.ceil(
                float(getattr(e, "retry_after_s", 1.0))))
            self._reply(429, {"error": str(e) or "admission queue full"},
                        headers={"Retry-After": str(retry_s)})
            return
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except TimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        except OSError as e:  # injected serve.route faults land here
            self._reply(503, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — the listener keeps serving
            log.exception("scoring request failed")
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        # fleet routing stamps the serving arm into the timing dict
        # ("primary" or "canary"); surface it as a header so a live
        # client can see WHICH arm scored without parsing bodies
        arm = timing.pop("arm", None)
        self._reply(200, {
            "scores": {k: np.asarray(v).tolist() for k, v in scores.items()},
            "timing_ms": {k: v * 1e3 for k, v in timing.items()},
        }, headers={"X-Shifu-Arm": arm} if arm else None)


class HttpFrontEnd:
    """Owns the listener thread; `address` is the bound (host, port) —
    pass port 0 for an ephemeral port."""

    def __init__(self, service: Optional[ScorerService] = None,
                 host: str = "0.0.0.0", port: Optional[int] = None,
                 fleet=None):
        if service is None and fleet is None:
            raise ValueError("HttpFrontEnd needs a service or a fleet")
        if port is None:
            port = env.knob_int("SHIFU_TPU_SERVE_PORT")
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.service = service
        self._server.fleet = fleet
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
