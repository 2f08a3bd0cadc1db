"""Per-rank HTTP metrics endpoint: ``/metrics``, ``/snapshot.json``,
``/healthz``.

The port's copy of ``tpu_ddp/monitor/exporter.py``: the same endpoints,
bodies and OpenMetrics series names (``tpu_ddp_<name>``), so a scraper of
one package's runs scrapes the other's. The exporter turns each training
process into a scrape target (``--monitor-port``):

- ``/metrics``: the telemetry registry (counters, gauges, per-phase
  histograms) rendered as OpenMetrics text, every series labeled with the
  run header (run id, strategy, mesh, rank).
- ``/snapshot.json``: the same registry snapshot as JSON plus the run
  metadata and heartbeat state.
- ``/healthz``: liveness backed by the hang watchdog
  (``telemetry/watchdog.py``): 200 while beats are fresh, 503 once the
  stall deadline passes.

One write route: ``POST /profile?steps=N`` arms a capture window on the
live run (``profiler/capture.py``). Because it mutates run behavior on an
unauthenticated endpoint, it is **loopback-only** unless
``--monitor-allow-remote-trigger``.

Stdlib-only (``http.server`` on a daemon thread) and torch-free: the
endpoint must keep answering precisely when the training thread is the
thing that hung. Serving never blocks training: handlers read the
thread-safe registry snapshot. With a run dir the exporter drops
``exporter-p<rank>.json`` (port + pid + url) beside the trace files, so
tooling finds each rank's endpoint (two ranks on one card each bind their
own port and write their own file).
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)

#: bump on breaking changes to the /snapshot.json shape
EXPORT_SCHEMA_VERSION = 1

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    """``train/steps`` -> ``tpu_ddp_train_steps`` (OpenMetrics charset)."""
    clean = _NAME_RE.sub("_", name).strip("_")
    return f"tpu_ddp_{clean}"


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    if isinstance(v, float) and v != v:  # NaN
        return "NaN"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def run_meta_labels(run_meta: Optional[dict],
                    process_index: int = 0) -> Dict[str, str]:
    """The label set every exported series carries, from the run-metadata
    header: run id, strategy, mesh (``data=8`` style), host index."""
    meta = run_meta or {}
    labels = {"host": str(meta.get("process_index", process_index))}
    if meta.get("run_id"):
        labels["run_id"] = str(meta["run_id"])
    if meta.get("strategy"):
        labels["strategy"] = str(meta["strategy"])
    mesh = meta.get("mesh")
    if isinstance(mesh, dict) and mesh:
        labels["mesh"] = ",".join(f"{a}={s}" for a, s in mesh.items())
    return labels


def render_openmetrics(snapshot: dict,
                       labels: Optional[Dict[str, str]] = None) -> str:
    """Registry snapshot (``Registry.snapshot()`` shape) -> OpenMetrics
    text exposition. Counters get the mandated ``_total`` sample suffix,
    histograms render as summaries (quantile series + ``_count`` /
    ``_sum``), and the body ends with the spec's ``# EOF`` terminator."""
    label_str = ""
    if labels:
        label_str = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
        )

    def series(name: str, value: float, extra: str = "") -> str:
        inner = ",".join(x for x in (label_str, extra) if x)
        return f"{name}{{{inner}}} {_fmt(value)}" if inner \
            else f"{name} {_fmt(value)}"

    lines = []
    for raw, value in sorted((snapshot.get("counters") or {}).items()):
        name = _metric_name(raw)
        lines.append(f"# TYPE {name} counter")
        lines.append(series(f"{name}_total", value))
    for raw, value in sorted((snapshot.get("gauges") or {}).items()):
        name = _metric_name(raw)
        lines.append(f"# TYPE {name} gauge")
        lines.append(series(name, value))
    for raw, summ in sorted((snapshot.get("histograms") or {}).items()):
        if not summ.get("count"):
            continue
        name = _metric_name(raw)
        lines.append(f"# TYPE {name} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95")):
            if summ.get(key) is not None:
                lines.append(
                    series(name, summ[key], extra=f'quantile="{q}"'))
        lines.append(series(f"{name}_count", summ["count"]))
        lines.append(series(f"{name}_sum", summ.get("sum", 0.0)))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MonitorExporter:
    """Serve one process's metrics over HTTP until ``close()``.

    ``port=0`` binds an ephemeral port (read it back from ``.port``);
    the trainer maps its own ``monitor_port == 0`` to "disabled" before
    ever constructing one of these. ``watchdog_provider`` is a callable
    returning the live HangWatchdog (or None): the binding is late, so the
    endpoint follows the trainer's watchdog as it starts and stops.

    ``profile_trigger`` is the capture-arming callable (the Trainer
    passes ``CaptureManager.request``); None means the run has no
    capture manager and ``POST /profile`` answers 503.
    ``allow_remote_trigger`` lifts the loopback-only restriction on
    that route (``--monitor-allow-remote-trigger``).
    """

    def __init__(
        self,
        *,
        registry=None,
        run_meta: Optional[dict] = None,
        port: int = 0,
        host: str = "0.0.0.0",
        process_index: int = 0,
        watchdog_provider: Optional[Callable[[], object]] = None,
        run_dir: Optional[str] = None,
        profile_trigger: Optional[Callable[..., bool]] = None,
        allow_remote_trigger: bool = False,
    ):
        if registry is None:
            from tpu_ddp_torch.telemetry.registry import default_registry

            registry = default_registry()
        self.registry = registry
        self.run_meta = run_meta or {}
        self.process_index = process_index
        self.run_dir = run_dir
        self.profile_trigger = profile_trigger
        self.allow_remote_trigger = allow_remote_trigger
        self._watchdog_provider = watchdog_provider or (lambda: None)
        self._labels = run_meta_labels(self.run_meta, process_index)
        self._server = ThreadingHTTPServer((host, port), self._handler())
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{socket.gethostname()}:{self.port}"

    # -- endpoint payloads ------------------------------------------------

    def healthz(self) -> dict:
        """The /healthz body + implied status code: ``ok`` (fresh beats),
        ``stale`` (watchdog deadline passed -> 503), or ``no-watchdog``
        (no deadline configured — alive by virtue of answering)."""
        wd = self._watchdog_provider()
        if wd is None:
            return {"status": "no-watchdog"}
        age = wd.seconds_since_beat()
        return {
            "status": "stale" if wd.is_stale() else "ok",
            "heartbeat_age_s": round(age, 3),
            "deadline_s": wd.deadline_seconds,
            "last_step": wd.last_step,
        }

    def snapshot(self) -> dict:
        return {
            "schema_version": EXPORT_SCHEMA_VERSION,
            "wall_time": time.time(),
            "process_index": self.process_index,
            "run_meta": self.run_meta,
            "health": self.healthz(),
            "metrics": self.registry.snapshot(),
        }

    def metrics_text(self) -> str:
        return render_openmetrics(self.registry.snapshot(), self._labels)

    def arm_profile(self, query: str, client_ip: str):
        """The ``POST /profile`` verdict: ``(status_code, body_dict)``.
        Factored off the handler so the origin gate and parameter
        parsing are unit-testable without a socket."""
        from tpu_ddp_torch.profiler.capture import _is_loopback

        if not self.allow_remote_trigger and not _is_loopback(client_ip):
            return 403, {
                "error": "remote profile trigger refused: the endpoint "
                         "is unauthenticated — POST from loopback, or "
                         "start the run with "
                         "--monitor-allow-remote-trigger",
            }
        if self.profile_trigger is None:
            return 503, {
                "error": "no capture manager on this run (profiling "
                         "needs --telemetry-dir for the bundle dir)",
            }
        import urllib.parse

        params = urllib.parse.parse_qs(query)

        def one(key):
            vals = params.get(key)
            return vals[0] if vals else None

        steps = one("steps")
        if steps is not None:
            try:
                steps = int(steps)
                if steps < 1:
                    raise ValueError
            except ValueError:
                return 400, {"error": f"bad steps value {one('steps')!r}"}
        alert_host = one("host")
        try:
            alert_host = int(alert_host) if alert_host is not None else None
        except ValueError:
            return 400, {"error": f"bad host value {one('host')!r}"}
        armed = self.profile_trigger(
            steps=steps,
            source=one("source") or "http",
            rule=one("rule"),
            host=alert_host,
        )
        if not armed:
            return 429, {
                "armed": False,
                "error": "capture refused: a window is already armed/"
                         "active, or this run hit its capture limit",
            }
        return 200, {"armed": True, "steps": steps}

    # -- http plumbing ----------------------------------------------------

    def _handler(self):
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # stdout stays training's
                log.debug("monitor exporter: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        self._send(
                            200, exporter.metrics_text().encode(),
                            "application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8",
                        )
                    elif path == "/snapshot.json":
                        self._send(
                            200, json.dumps(exporter.snapshot()).encode(),
                            "application/json",
                        )
                    elif path == "/healthz":
                        body = exporter.healthz()
                        code = 503 if body["status"] == "stale" else 200
                        self._send(code, json.dumps(body).encode(),
                                   "application/json")
                    else:
                        self._send(404, b'{"error": "not found"}\n',
                                   "application/json")
                except Exception as e:
                    # a broken scrape must never propagate into training,
                    # but the scraper deserves a status, not an empty reply
                    log.exception("monitor exporter request failed")
                    try:
                        self._send(
                            500,
                            json.dumps({"error": str(e)}).encode(),
                            "application/json",
                        )
                    except Exception:
                        pass  # headers already sent / socket gone

            def do_POST(self):  # noqa: N802 (http.server API)
                try:
                    # drain any request body so the socket stays clean
                    length = int(self.headers.get("Content-Length") or 0)
                    if length:
                        self.rfile.read(length)
                    path, _, query = self.path.partition("?")
                    if path != "/profile":
                        self._send(404, b'{"error": "not found"}\n',
                                   "application/json")
                        return
                    code, body = exporter.arm_profile(
                        query, self.client_address[0])
                    self._send(code, json.dumps(body).encode(),
                               "application/json")
                except Exception as e:
                    log.exception("monitor exporter POST failed")
                    try:
                        self._send(
                            500,
                            json.dumps({"error": str(e)}).encode(),
                            "application/json",
                        )
                    except Exception:
                        pass  # headers already sent / socket gone

        return Handler

    def start(self) -> "MonitorExporter":
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="tpu-ddp-monitor-exporter",
            daemon=True,
        )
        self._thread.start()
        self._write_endpoint_file()
        return self

    def _write_endpoint_file(self) -> None:
        """``exporter-p<i>.json`` beside the trace files: scrape-target
        discovery for the demo/fleet tooling (atomic, best-effort)."""
        if not self.run_dir:
            return
        path = os.path.join(
            self.run_dir, f"exporter-p{self.process_index}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self.run_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump({
                    "schema_version": EXPORT_SCHEMA_VERSION,
                    "port": self.port,
                    "pid": os.getpid(),
                    "process_index": self.process_index,
                    "url": self.url,
                }, f)
            os.replace(tmp, path)
        except OSError:  # discovery is a convenience, not a dependency
            pass

    def close(self) -> None:
        if self._thread is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self._thread = None
