"""HTTP control plane: template registry + extraction service.

The port's copy of the reference's ``net/control.py``, on ``http.server``
and the port's HTML tree (``core/soup.py``):

- ``POST /add_template {"name", "template"}`` — persist a declarative
  template, create its output folder, register it as an extractor plugin;
- ``POST /extract_and_get_article {"url", "template"}`` — fetch + extract
  synchronously, persisting the raw ``html_source`` to
  ``<template>/<slug>.html`` and returning the extracted fields; pass
  ``"async": true`` to get a ``request_id`` immediately and poll
  ``GET /get_result/<request_id>`` (HTTP 202 while pending);
- ``POST /process_url {"url", "template"}`` — the bare worker endpoint
  returning fields plus ``html_source``;
- ``GET /templates``, ``/metrics`` and ``/status``.

The in-memory results cache keeps async results; extraction runs on a
small thread pool.  A template whose selector lies outside the tree's CSS
subset is refused when it is added or loaded (``TemplateStore`` parses
every selector up front and raises ``NotImplementedError``, answered 500),
and ``extract`` parses the template again before it runs, so such a
selector never reads as an empty field.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from advanced_scrapper_tpu_torch.core.soup import Soup
from advanced_scrapper_tpu_torch.extractors.template import (
    TemplateStore,
    check_template,
    extract_with_template,
)


class ControlPlane:
    def __init__(
        self,
        transport_factory,
        *,
        templates_path: str = "templates.json",
        workers: int = 5,  # ref 03_worker_multi.py:31 NUM_BROWSERS
        out_root: str = ".",
    ):
        self.store = TemplateStore(templates_path)
        self.store.register_all()
        self.transport_factory = transport_factory
        self.out_root = out_root
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._results: dict[str, dict | None] = {}  # request_id → result
        self._lock = threading.Lock()
        self._local = threading.local()
        self._transports: list = []  # every created transport, for shutdown

    # -- extraction --------------------------------------------------------

    def _transport(self):
        # one transport per POOL thread (bounded by `workers`); transports
        # are tracked so shutdown() can close them — browser transports are
        # real OS processes
        t = getattr(self._local, "transport", None)
        if t is None:
            t = self.transport_factory()
            self._local.transport = t
            with self._lock:
                self._transports.append(t)
        return t

    @staticmethod
    def _check_name(name: str) -> str:
        if not name or "/" in name or "\\" in name or ".." in name or name.startswith("."):
            raise ValueError(f"invalid template name {name!r}")
        return name

    def add_template(self, name: str, template: dict) -> None:
        self.store.add(self._check_name(name), template)
        os.makedirs(os.path.join(self.out_root, name), exist_ok=True)

    def _extract_on_pool_thread(self, url: str, template_name: str) -> dict:
        template = self.store.get(self._check_name(template_name))
        check_template(template)  # a selector the tree cannot run raises, never reads ""
        html = self._transport().fetch(url)
        data = extract_with_template(Soup(html), template)
        data["html_source"] = html
        return data

    def extract(self, url: str, template_name: str) -> dict:
        # Sync requests arrive on per-connection HTTP threads; run the fetch
        # on the bounded pool so transports are reused, not leaked per
        # connection.
        return self._pool.submit(
            self._extract_on_pool_thread, url, template_name
        ).result()

    def _persist_html(self, url: str, template_name: str, data: dict) -> dict:
        html = data.pop("html_source", "")
        slug = os.path.basename(url.split("?")[0].rstrip("/")) or "index"
        out_dir = os.path.join(self.out_root, template_name)
        # Templates loaded from a pre-existing templates.json (register_all on
        # restart) never went through add_template, so their folder may not
        # exist yet.
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{slug}.html")
        with open(path, "w", encoding="utf-8") as f:
            f.write(html)
        return data

    def extract_and_persist(self, url: str, template_name: str) -> dict:
        return self._persist_html(url, template_name, self.extract(url, template_name))

    def submit(self, url: str, template_name: str) -> str:
        request_id = uuid.uuid4().hex
        with self._lock:
            self._results[request_id] = None

        def work():
            try:
                data = self._extract_on_pool_thread(url, template_name)
                result = self._persist_html(url, template_name, data)
            except Exception as e:
                result = {"error": str(e)}
            with self._lock:
                self._results[request_id] = result

        self._pool.submit(work)
        return request_id

    def get_result(self, request_id: str) -> tuple[int, dict]:
        with self._lock:
            if request_id not in self._results:
                return 404, {"error": "unknown request_id"}
            result = self._results[request_id]
        if result is None:
            return 202, {"status": "pending"}
        return 200, result

    def status(self) -> dict:
        """Plane-local view for ``GET /status``: registered templates and
        the async result cache's fill."""
        with self._lock:
            pending = sum(1 for v in self._results.values() if v is None)
            done = len(self._results) - pending
        return {
            "templates": self.store.names(),
            "results_pending": pending,
            "results_done": done,
        }

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
        with self._lock:
            transports, self._transports = self._transports, []
        for t in transports:
            try:
                t.close()
            except Exception:
                pass


def make_handler(plane: ControlPlane):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            try:
                data = self._json_body()
                if self.path == "/add_template":
                    plane.add_template(data["name"], data["template"])
                    self._reply(200, {"message": "Template added successfully"})
                elif self.path == "/extract_and_get_article":
                    if data.get("async"):
                        rid = plane.submit(data["url"], data["template"])
                        self._reply(200, {"request_id": rid})
                    else:
                        self._reply(
                            200, plane.extract_and_persist(data["url"], data["template"])
                        )
                elif self.path == "/process_url":
                    self._reply(200, plane.extract(data["url"], data["template"]))
                else:
                    self._reply(404, {"error": f"no such endpoint {self.path}"})
            except KeyError as e:
                self._reply(400, {"error": f"missing field {e}"})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"message": f"Worker failed to process the request: {e}"})

        def do_GET(self):
            if self.path.startswith("/get_result/"):
                rid = self.path.rsplit("/", 1)[-1]
                code, obj = plane.get_result(rid)
                self._reply(code, obj)
            elif self.path == "/templates":
                self._reply(200, {"templates": plane.store.names()})
            elif self.path == "/metrics":
                # process-wide telemetry — the control plane doubles as the
                # pipeline's metrics endpoint (shared exporter: the response
                # logic lives once, in obs.telemetry)
                from advanced_scrapper_tpu_torch.obs import telemetry

                telemetry.serve_metrics(self)
            elif self.path == "/status":
                from advanced_scrapper_tpu_torch.obs import telemetry

                telemetry.serve_status(
                    self, extra_status=lambda: {"control": plane.status()}
                )
            else:
                self._reply(404, {"error": f"no such endpoint {self.path}"})

    return Handler


class ControlServer:
    """Threaded HTTP server wrapper around :class:`ControlPlane`."""

    def __init__(self, plane: ControlPlane, host: str = "127.0.0.1", port: int = 0):
        from advanced_scrapper_tpu_torch.obs import telemetry

        telemetry.register_process_metrics()  # /metrics is never empty
        self.plane = plane
        self._httpd = ThreadingHTTPServer((host, port), make_handler(plane))
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "ControlServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.plane.shutdown()
