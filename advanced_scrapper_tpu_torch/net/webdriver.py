"""First-party W3C WebDriver wire client — stdlib only, no selenium.

The port's copy of the reference's ``net/webdriver.py``.  The original
scraper's fetch substrate is the selenium package driving the external
geckodriver binary over the WebDriver HTTP protocol
(``constant_rate_scrapper.py:136-139``).  selenium itself is a thin
JSON-over-HTTP client; this module implements the handful of wire
endpoints the fetch path actually uses (W3C WebDriver spec,
https://www.w3.org/TR/webdriver/), so the framework can drive
geckodriver/chromedriver directly even where the selenium package does not
exist — and so the transport stack is testable offline against a local
server speaking the real protocol instead of ``sys.modules`` object
stubs.

Endpoints used:

- ``GET  /status``                              — service readiness poll
- ``POST /session``                             — New Session (capabilities)
- ``POST /session/{id}/url``                    — Navigate To
- ``POST /session/{id}/execute/sync``           — Execute Script
- ``GET  /session/{id}/source``                 — Get Page Source
- ``POST /session/{id}/timeouts``               — Set Timeouts (pageLoad)
- ``DELETE /session/{id}``                      — Delete Session

:class:`WireSession` exposes the same driver surface the transports use
(``get`` / ``execute_script`` / ``page_source`` / ``set_page_load_timeout``
/ ``quit``), so ``net/transport.py::_WebDriverTransport`` runs unchanged on
either a selenium driver or this client.  :class:`DriverService` owns the
driver subprocess (spawn on a free port, ``/status`` readiness wait,
terminate), like selenium's ``Service``.
"""

from __future__ import annotations

import json
import socket
import subprocess
import time
import urllib.error
import urllib.request


class WebDriverError(Exception):
    """A wire-level failure; ``str(e)`` carries the driver's error code and
    message verbatim (e.g. ``unknown error: net::ERR_CONNECTION_REFUSED``)
    so the engine's circuit-breaker fingerprints
    (``pipeline/scraper.py:59-62``) keep matching exactly what real
    geckodriver/chromedriver emit."""

    def __init__(self, error: str, message: str):
        self.error = error
        self.message = message
        super().__init__(f"{error}: {message}" if message else error)


def _http_json(
    method: str, url: str, payload: dict | None, timeout: float
) -> dict:
    """One wire call.  WebDriver errors (HTTP 4xx/5xx with a JSON error
    body) raise :class:`WebDriverError`; transport-level failures raise
    ``URLError`` untouched (the caller decides what a dead driver means)."""
    data = None if payload is None else json.dumps(payload).encode("utf-8")
    req = urllib.request.Request(
        url,
        data=data,
        method=method,
        headers={"Content-Type": "application/json; charset=utf-8"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode("utf-8", "replace")
            try:
                return json.loads(raw)
            except ValueError as e:
                # a proxy/captive portal or half-dead driver can 200 with
                # an HTML body; surface it as a wire error, not a raw
                # JSONDecodeError, so transports wrap it like any failure
                raise WebDriverError(
                    "invalid response", f"non-JSON body from {url}: {raw[:200]}"
                ) from e
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode("utf-8"))
            value = body.get("value", {})
            raise WebDriverError(
                str(value.get("error", f"http {e.code}")),
                str(value.get("message", "")),
            ) from e
        except (ValueError, KeyError, AttributeError):
            raise WebDriverError(f"http {e.code}", str(e)) from e


class WireSession:
    """One WebDriver session over the wire protocol.

    Drop-in for the selenium driver surface used by the transports.
    ``remote_url`` points at a running driver (a local geckodriver, a fake
    protocol server in tests, or a remote grid endpoint)."""

    def __init__(
        self,
        remote_url: str,
        capabilities: dict | None = None,
        timeout: float = 60.0,
    ):
        self._base = remote_url.rstrip("/")
        self._timeout = timeout
        body = _http_json(
            "POST",
            f"{self._base}/session",
            {"capabilities": {"alwaysMatch": capabilities or {}}},
            timeout,
        )
        value = body.get("value", {})
        self.session_id = value.get("sessionId") or body.get("sessionId")
        if not self.session_id:
            raise WebDriverError("session not created", json.dumps(body))
        self.capabilities = value.get("capabilities", {})

    def _url(self, suffix: str) -> str:
        return f"{self._base}/session/{self.session_id}/{suffix}"

    def get(self, url: str) -> None:
        _http_json("POST", self._url("url"), {"url": url}, self._timeout)

    def execute_script(self, script: str, *args):
        body = _http_json(
            "POST",
            self._url("execute/sync"),
            {"script": script, "args": list(args)},
            self._timeout,
        )
        return body.get("value")

    @property
    def page_source(self) -> str:
        return _http_json("GET", self._url("source"), None, self._timeout)[
            "value"
        ]

    def set_page_load_timeout(self, seconds: float) -> None:
        _http_json(
            "POST",
            self._url("timeouts"),
            {"pageLoad": int(seconds * 1000)},
            self._timeout,
        )
        # navigation can legitimately take the full pageLoad budget: give
        # the HTTP layer the same budget plus slack so the socket doesn't
        # give up before the driver does
        self._timeout = max(self._timeout, seconds + 10.0)

    def quit(self) -> None:
        _http_json(
            "DELETE",
            f"{self._base}/session/{self.session_id}",
            None,
            self._timeout,
        )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class DriverService:
    """Own a driver binary subprocess (geckodriver / chromedriver).

    Spawns ``[binary, --port=N]`` on a free port and polls ``GET /status``
    until the driver reports ready — the same contract selenium's
    ``Service`` wraps.  The ``=`` form matters: geckodriver (clap) accepts
    both ``--port N`` and ``--port=N``, but chromedriver's Chromium switch
    parser only honours ``--port=N`` — with the space form it ignores the
    value and binds its default port while the client polls a free one."""

    def __init__(
        self,
        binary: str,
        *,
        args: tuple[str, ...] = (),
        startup_timeout: float = 20.0,
    ):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self._proc = subprocess.Popen(
            [binary, f"--port={self.port}", *args],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        deadline = time.monotonic() + startup_timeout
        last_err: Exception | None = None
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise WebDriverError(
                    "driver exited",
                    f"{binary} exited with {self._proc.returncode} at startup",
                )
            try:
                status = _http_json("GET", f"{self.url}/status", None, 2.0)
                if status.get("value", {}).get("ready", True):
                    return
            except Exception as e:  # not listening yet
                last_err = e
            time.sleep(0.1)
        self.stop()
        raise WebDriverError(
            "driver start timeout",
            f"{binary} not ready after {startup_timeout}s ({last_err})",
        )

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=5)


FIREFOX_PREFS = {
    # the reference's browser hardening (constant_rate_scrapper.py:33-41):
    # images off, JS off, no flash
    "permissions.default.image": 2,
    "javascript.enabled": False,
    "dom.ipc.plugins.enabled.libflashplayer.so": False,
}


#: chromedriver analogues of the Firefox hardening: images and JS off
CHROME_PREFS = {
    "profile.managed_default_content_settings.images": 2,
    "profile.managed_default_content_settings.javascript": 2,
}


class _WireDriver:
    """Shared driver shell: owns an optional :class:`DriverService` and a
    :class:`WireSession`, exposing the selenium driver surface the
    transports consume.  Subclasses provide the vendor capability dict."""

    def __init__(
        self,
        executable_path: str,
        capabilities: dict,
        remote_url: str | None,
    ):
        self._service = None
        if remote_url is None:
            self._service = DriverService(executable_path)
            remote_url = self._service.url
        try:
            self._session = WireSession(remote_url, capabilities)
        except BaseException:
            if self._service is not None:
                self._service.stop()
            raise

    # -- driver surface consumed by _WebDriverTransport --
    def get(self, url: str) -> None:
        self._session.get(url)

    def execute_script(self, script: str, *args):
        return self._session.execute_script(script, *args)

    @property
    def page_source(self) -> str:
        return self._session.page_source

    def set_page_load_timeout(self, seconds: float) -> None:
        self._session.set_page_load_timeout(seconds)

    def quit(self) -> None:
        try:
            self._session.quit()
        except Exception as e:
            # a crashed/unreachable driver cannot honour Delete Session —
            # the teardown path must still terminate the process instead
            # of exploding inside every engine worker's finally block.
            # Logged, not silent: against a REMOTE driver there is no
            # service to reap, so a swallowed failure here is a leaked
            # session slot (geckodriver serves one session per process)
            import sys

            print(f"webdriver: Delete Session failed: {e}", file=sys.stderr)
        finally:
            if self._service is not None:
                self._service.stop()


class WireFirefoxDriver(_WireDriver):
    """geckodriver + headless Firefox over the wire client — the selenium
    Firefox driver surface without selenium.  Pass ``remote_url`` to attach
    to an already-running driver/grid endpoint instead of spawning one."""

    def __init__(
        self,
        executable_path: str = "geckodriver",
        *,
        headless: bool = True,
        prefs: dict | None = None,
        remote_url: str | None = None,
    ):
        opts: dict = {"prefs": dict(FIREFOX_PREFS, **(prefs or {}))}
        if headless:
            opts["args"] = ["-headless"]
        super().__init__(
            executable_path, {"moz:firefoxOptions": opts}, remote_url
        )


class WireChromeDriver(_WireDriver):
    """chromedriver + headless Chrome over the same wire protocol (the
    plain-Chrome counterpart of the reference's experimental substrate —
    anti-bot patching is :class:`StealthChromeTransport`'s job, not this
    one's)."""

    def __init__(
        self,
        executable_path: str = "chromedriver",
        *,
        headless: bool = True,
        prefs: dict | None = None,
        remote_url: str | None = None,
    ):
        opts: dict = {"prefs": dict(CHROME_PREFS, **(prefs or {}))}
        if headless:
            opts["args"] = ["--headless=new"]
        super().__init__(
            executable_path, {"goog:chromeOptions": opts}, remote_url
        )
