"""The port's fetch transports (``net/transport.py``) and WebDriver wire
client (``net/webdriver.py``) against the JAX package's.

Mock and chaos transports give the same fetch outcomes and injection
counters under the same seed.  The wire transports run against a local
server speaking the W3C WebDriver JSON protocol (the fake of
``tests/test_webdriver_wire.py``, copied here), in process and as a fake
geckodriver/chromedriver binary: both packages exchange the same requests
and see the same pages and errors.  The selenium and undetected-chromedriver
transports run over fake modules in ``sys.modules`` (the fakes of
``tests/test_transport_selenium.py``)."""

from __future__ import annotations

import http.server
import os
import stat
import sys
import threading
import types

import pytest

from advanced_scrapper_tpu.net import transport as ref_transport
from advanced_scrapper_tpu.net import webdriver as ref_webdriver
from advanced_scrapper_tpu_torch.net import transport, webdriver

PACKAGES = {"ref": (ref_transport, ref_webdriver), "port": (transport, webdriver)}


def outcome(fn, *args, **kw):
    """``("ok", value)`` or ``(exception class name, message)``."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the outcome is the comparison
        return (type(e).__name__, str(e))


# -- mock and chaos ------------------------------------------------------------

PAGES = {
    "https://x/a.html": "<html>a</html>",
    "https://x/b.html": 42,
    "https://x/c.html": "RAISE",
    "https://x/d.html": "CALL",
}
URLS = [*PAGES, "https://x/missing.html"]


def mock_pages(tr):
    pages = dict(PAGES)
    pages["https://x/c.html"] = tr.FetchError("connection reset")
    pages["https://x/d.html"] = lambda url: f"<p>{url}</p>"
    return pages


def test_mock_transport_matches_the_reference():
    got = {}
    for name, (tr, _wd) in PACKAGES.items():
        t = tr.MockTransport(mock_pages(tr))
        callable_t = tr.MockTransport(lambda url: url.upper())
        got[name] = ([outcome(t.fetch, u) for u in URLS], t.fetched,
                     outcome(callable_t.fetch, "https://x/q"), outcome(t.close))
    assert got["port"] == got["ref"]
    assert got["port"][0][2] == ("FetchError", "connection reset")
    assert got["port"][0][4] == ("FetchError", "no fixture for https://x/missing.html")


CHAOS = [dict(seed=0, error_rate=0.3), dict(seed=1, neterror_rate=0.4),
         dict(seed=2, rate_limit_page_rate=0.5),
         dict(seed=3, error_rate=0.1, neterror_rate=0.1, rate_limit_page_rate=0.1,
              latency_spike=(0.2, 0.0)),
         dict(seed=4, rate_limit_page_rate=0.3, rate_limit_page="<p>slow down</p>")]


@pytest.mark.parametrize("knobs", CHAOS, ids=lambda k: "-".join(f"{a}" for a in k)[:40])
def test_chaos_transport_matches_the_reference(knobs):
    urls = [f"https://x/{i}.html" for i in range(120)]
    got = {}
    for name, (tr, _wd) in PACKAGES.items():
        inner = tr.MockTransport({u: f"<html>{u}</html>" for u in urls})
        t = tr.ChaosTransport(inner, **knobs)
        got[name] = ([outcome(t.fetch, u) for u in urls], dict(t.injected), inner.fetched)
        t.close()
    assert got["port"] == got["ref"]
    assert sum(got["port"][1].values()) > 0


def test_make_transport_names_match_the_reference():
    got = {}
    for name, (tr, _wd) in PACKAGES.items():
        m = tr.make_transport("mock", pages={"https://s/x": "<html></html>"})
        got[name] = (type(m).__name__, outcome(m.fetch, "https://s/x"),
                     type(tr.make_transport("mock")).__name__,
                     outcome(tr.make_transport, "carrier-pigeon"),
                     type(tr.make_transport("requests")).__name__, tr.USER_AGENT)
    assert got["port"] == got["ref"]
    assert got["port"][0] == "MockTransport" and got["port"][4] == "RequestsTransport"


def test_availability_probes_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    probes = ("selenium_available", "geckodriver_available", "stealth_chrome_available")
    for present in (False, True):
        if present:
            gd = tmp_path / "geckodriver"
            gd.write_text("#!/bin/sh\n")
            gd.chmod(gd.stat().st_mode | stat.S_IXUSR)
        got = {name: [getattr(tr, p)() for p in probes]
               + [tr._resolve_binary("geckodriver")] for name, (tr, _wd) in PACKAGES.items()}
        assert got["port"] == got["ref"]
        assert got["port"][1] is present


# -- the WebDriver wire ---------------------------------------------------------

PROTOCOL_HANDLER_SRC = r'''
import json
import http.server


class WebDriverHandler(http.server.BaseHTTPRequestHandler):
    """Minimal but protocol-faithful W3C WebDriver endpoint."""

    sessions = {}
    requests_seen = []
    ready_polls_until_complete = 0
    heights = [100]
    neterror_urls = ()
    status_polls = 0
    single_session = False  # geckodriver: one session per process

    def log_message(self, *a):
        pass

    def _json(self, code, value):
        body = json.dumps({"value": value}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read(self):
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n)) if n else {}

    def do_GET(self):
        cls = type(self)
        cls.requests_seen.append(("GET", self.path, None))
        if self.path == "/status":
            import os as _os

            cls.status_polls += 1
            unready = int(_os.environ.get("FAKE_DRIVER_STATUS_UNREADY", "0") or 0)
            if cls.status_polls <= unready:
                return self._json(200, {"ready": False, "message": "starting"})
            return self._json(200, {"ready": True, "message": "fake ready"})
        parts = self.path.strip("/").split("/")
        if len(parts) == 3 and parts[0] == "session" and parts[2] == "source":
            sess = cls.sessions.get(parts[1])
            if sess is None:
                return self._json(404, {"error": "invalid session id", "message": parts[1]})
            return self._json(200, sess["source"])
        return self._json(404, {"error": "unknown command", "message": self.path})

    def do_POST(self):
        cls = type(self)
        payload = self._read()
        cls.requests_seen.append(("POST", self.path, payload))
        parts = self.path.strip("/").split("/")
        if self.path == "/session":
            if cls.single_session and cls.sessions:
                return self._json(500, {"error": "session not created",
                                        "message": "Session is already started"})
            sid = f"sess-{len(cls.sessions)}"
            cls.sessions[sid] = {"caps": payload, "url": None, "ready_polls": 0, "h_ix": 0,
                                 "source": ""}
            return self._json(200, {"sessionId": sid, "capabilities": payload.get(
                "capabilities", {}).get("alwaysMatch", {})})
        sess = cls.sessions.get(parts[1]) if len(parts) >= 2 else None
        if sess is None:
            return self._json(404, {"error": "invalid session id", "message": self.path})
        cmd = "/".join(parts[2:])
        if cmd == "url":
            import os as _os

            if _os.environ.get("FAKE_DRIVER_DIE_ON_NAVIGATE"):
                _os._exit(9)  # the driver binary crashes mid-navigate
            url = payload["url"]
            if any(marker in url for marker in cls.neterror_urls):
                return self._json(500, {"error": "unknown error",
                                        "message": f"net::ERR_CONNECTION_REFUSED at {url}"})
            sess["url"] = url
            sess["ready_polls"] = 0
            sess["h_ix"] = 0
            sess["source"] = f"<html>page0 of {url}</html>"
            return self._json(200, None)
        if cmd == "execute/sync":
            script = payload["script"]
            if "readyState" in script:
                sess["ready_polls"] += 1
                done = sess["ready_polls"] > cls.ready_polls_until_complete
                return self._json(200, "complete" if done else "loading")
            if "return document.body.scrollHeight" in script:
                ix = min(sess["h_ix"], len(cls.heights) - 1)
                return self._json(200, cls.heights[ix])
            if "scrollTo" in script:
                sess["h_ix"] = min(sess["h_ix"] + 1, len(cls.heights) - 1)
                sess["source"] = f"<html>page{sess['h_ix']}</html>"
                return self._json(200, None)
            return self._json(400, {"error": "javascript error", "message": script})
        if cmd == "timeouts":
            sess["timeouts"] = payload
            return self._json(200, None)
        return self._json(404, {"error": "unknown command", "message": self.path})

    def do_DELETE(self):
        cls = type(self)
        cls.requests_seen.append(("DELETE", self.path, None))
        parts = self.path.strip("/").split("/")
        if len(parts) >= 2 and cls.sessions.pop(parts[1], None) is not None:
            return self._json(200, None)
        return self._json(404, {"error": "invalid session id", "message": ""})
'''

_ns: dict = {}
exec(PROTOCOL_HANDLER_SRC, _ns)
WebDriverHandler = _ns["WebDriverHandler"]


class WireServer:
    """An in-process protocol server with fresh session state."""

    def __init__(self, **state):
        class Handler(WebDriverHandler):
            sessions = {}
            requests_seen = []
            ready_polls_until_complete = 0
            heights = [100]
            neterror_urls = ()
            status_polls = 0
            single_session = False

        for k, v in state.items():
            setattr(Handler, k, v)
        self.handler = Handler
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.srv.serve_forever, args=(0.05,),
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=5)


def on_wire(scenario, **state):
    """Run ``scenario(transport module, webdriver module, url)`` for each
    package against a fresh server; returns ``{package: (result, requests
    seen)}``."""
    got = {}
    for name, (tr, wd) in PACKAGES.items():
        server = WireServer(**state)
        try:
            got[name] = (scenario(tr, wd, server.url), list(server.handler.requests_seen))
        finally:
            server.stop()
    return got


def test_fetch_over_the_wire_protocol_matches_the_reference():
    def scenario(tr, wd, url):
        t = tr.WireFirefoxTransport(page_load_timeout=30.0, ready_state_timeout=5.0,
                                    remote_url=url)
        html = t.fetch("https://news.example/a.html")
        t.close()
        return html

    got = on_wire(scenario, ready_polls_until_complete=1)
    assert got["port"] == got["ref"]
    html, seen = got["port"]
    assert html == "<html>page0 of https://news.example/a.html</html>"
    caps = seen[0][2]["capabilities"]["alwaysMatch"]
    assert caps["moz:firefoxOptions"]["prefs"]["javascript.enabled"] is False
    assert ("DELETE", "/session/sess-0", None) in seen


def test_scrolled_neterror_and_timeout_match_the_reference():
    def scenario(tr, wd, url):
        t = tr.WireFirefoxTransport(remote_url=url, ready_state_timeout=0.0)
        scrolled = t.fetch_scrolled("https://news.example/feed", settle_s=0.0)
        net = outcome(t.fetch, "https://blocked.example/x")
        t.close()
        return scrolled, net

    got = on_wire(scenario, heights=[100, 250, 250], neterror_urls=("blocked",))
    assert got["port"] == got["ref"]
    scrolled, net = got["port"][0]
    assert scrolled == "<html>page2</html>"
    assert net[0] == "FetchError" and "net::ERR_CONNECTION_REFUSED" in net[1]
    from advanced_scrapper_tpu_torch.pipeline.scraper import _RATE_LIMIT_FINGERPRINTS

    assert any(fp in net[1] for fp in _RATE_LIMIT_FINGERPRINTS)

    def slow(tr, wd, url):
        t = tr.WireFirefoxTransport(remote_url=url, ready_state_timeout=0.0)
        res = outcome(t.fetch, "https://news.example/slow.html")
        t.close()
        return res

    got = on_wire(slow, ready_polls_until_complete=10**9)
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("FetchError", "timeout waiting for readyState complete on "
                                            "https://news.example/slow.html")


def test_chrome_wire_and_explicit_names_match_the_reference():
    def scenario(tr, wd, url):
        t = tr.WireChromeTransport(remote_url=url)
        html = t.fetch("https://news.example/chrome.html")
        t.close()
        kinds = []
        for name in ("firefox-wire", "chrome-wire"):
            m = tr.make_transport(name, remote_url=url)
            kinds.append(type(m).__name__)
            m.close()
        return html, kinds

    got = on_wire(scenario)
    assert got["port"] == got["ref"]
    (html, kinds), seen = got["port"]
    assert "page0" in html and kinds == ["WireFirefoxTransport", "WireChromeTransport"]
    opts = seen[0][2]["capabilities"]["alwaysMatch"]["goog:chromeOptions"]
    assert "--headless=new" in opts["args"]


def test_session_conflict_matches_the_reference():
    def scenario(tr, wd, url):
        t1 = tr.WireFirefoxTransport(remote_url=url)
        second = outcome(tr.WireFirefoxTransport, remote_url=url)
        alive = t1.fetch("https://news.example/still-alive.html")
        t1.close()
        t2 = tr.WireFirefoxTransport(remote_url=url)
        again = t2.fetch("https://news.example/recovered.html")
        t2.close()
        return second, alive, again

    got = on_wire(scenario, single_session=True)
    assert got["port"] == got["ref"]
    second = got["port"][0][0]
    assert second[0] == "WebDriverError" and "session not created" in second[1]


def test_hostile_server_responses_match_the_reference():
    class Hostile(http.server.BaseHTTPRequestHandler):
        mode = "html_error"

        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body, code = {"html_error": (b"<html>502 Bad Gateway</html>", 502),
                          "empty_ok": (b"{}", 200)}.get(type(self).mode,
                                                        (b"not json at all", 200))
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Hostile)
    threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        got = {}
        for name, (_tr, wd) in PACKAGES.items():
            got[name] = []
            for mode in ("html_error", "empty_ok", "garbage_ok"):
                Hostile.mode = mode
                got[name].append(outcome(wd.WireSession, url))
    finally:
        srv.shutdown()
        srv.server_close()
    assert got["port"] == got["ref"]
    assert [o[0] for o in got["port"]] == ["WebDriverError"] * 3
    assert "http 502" in got["port"][0][1] and "invalid response" in got["port"][2][1]


FAKE_BINARY_TEMPLATE = """#!{python}
import sys
import http.server

{handler_src}

if __name__ == "__main__":
    port = None
    args = sys.argv[1:]
    for i, a in enumerate(args):
        if a.startswith("--port="):
            port = int(a.split("=", 1)[1])
        elif a == "--port" and {space_form}:
            port = int(args[i + 1])
    if port is None:
        sys.exit(1)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), WebDriverHandler)
    srv.serve_forever()
"""


def fake_driver(tmp_path, name: str, space_form: bool) -> str:
    """A driver binary speaking the protocol; chromedriver's takes only the
    ``--port=N`` form (as the real one), geckodriver's both."""
    path = tmp_path / name
    path.write_text(FAKE_BINARY_TEMPLATE.format(
        python=sys.executable, handler_src=PROTOCOL_HANDLER_SRC, space_form=space_form))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_driver_service_lifecycles_match_the_reference(tmp_path):
    """Spawn → ``/status`` readiness → session → fetch → quit → the process
    exits, for the geckodriver and the chromedriver flavours; a binary that
    dies at once fails fast with the same error."""
    gecko = fake_driver(tmp_path, "geckodriver", True)
    chrome = fake_driver(tmp_path, "chromedriver", False)
    bad = tmp_path / "dead-driver"
    bad.write_text(f"#!{sys.executable}\nraise SystemExit(3)\n")
    bad.chmod(bad.stat().st_mode | stat.S_IXUSR)
    got = {}
    for name, (tr, wd) in PACKAGES.items():
        rows = []
        for cls, binary in ((tr.WireFirefoxTransport, gecko), (tr.WireChromeTransport, chrome)):
            t = cls(executable_path=binary)
            service = t._driver._service
            alive = service._proc.poll() is None
            html = t.fetch(f"https://news.example/{name}-spawned.html")
            t.close()
            rows.append((alive, html.replace(name, "*"), service._proc.poll() is not None))
        err = outcome(wd.DriverService, str(bad), startup_timeout=10.0)
        rows.append((err[0], "exited" in err[1]))
        got[name] = rows
    assert got["port"] == got["ref"]
    assert got["port"][0] == (True, "<html>page0 of https://news.example/*-spawned.html</html>",
                              True)
    assert got["port"][2] == ("WebDriverError", True)


def test_auto_picks_the_wire_client_with_a_geckodriver_on_path(tmp_path, monkeypatch):
    gecko = fake_driver(tmp_path, "geckodriver", True)
    monkeypatch.setenv("PATH", os.path.dirname(gecko) + os.pathsep + os.environ["PATH"])
    assert not transport.selenium_available()
    t = transport.make_transport("auto")
    try:
        assert isinstance(t, transport.WireFirefoxTransport)
        assert "page0" in t.fetch("https://news.example/auto.html")
    finally:
        t.close()


def test_driver_crash_mid_navigate_is_a_fetch_error(tmp_path, monkeypatch):
    gecko = fake_driver(tmp_path, "geckodriver", True)
    monkeypatch.setenv("FAKE_DRIVER_DIE_ON_NAVIGATE", "1")
    t = transport.WireFirefoxTransport(executable_path=gecko)
    service = t._driver._service
    with pytest.raises(transport.FetchError):
        t.fetch("https://news.example/crash.html")
    t.close()
    assert service._proc.poll() is not None, "driver process reaped"


# -- selenium and undetected-chromedriver over fake modules --------------------


class FakeDriver:
    def __init__(self, options, heights=None):
        self.options = options
        self.visited: list[str] = []
        self.scripts: list[str] = []
        self.page_source = ""
        self.page_load_timeout = None
        self.quit_called = False
        self.ready_after = 0
        self._ready_polls = 0
        self.heights = heights or [100]
        self._h_ix = 0
        self.raise_on_get: Exception | None = None

    def set_page_load_timeout(self, t):
        self.page_load_timeout = t

    def get(self, url):
        if self.raise_on_get is not None:
            raise self.raise_on_get
        self.visited.append(url)
        self._ready_polls = 0
        self._h_ix = 0
        self.page_source = f"<html>page0 of {url}</html>"

    def execute_script(self, script):
        self.scripts.append(script)
        if "readyState" in script:
            self._ready_polls += 1
            return "complete" if self._ready_polls > self.ready_after else "loading"
        if "return document.body.scrollHeight" in script:
            return self.heights[min(self._h_ix, len(self.heights) - 1)]
        if "scrollTo" in script:
            self._h_ix = min(self._h_ix + 1, len(self.heights) - 1)
            self.page_source = f"<html>page{self._h_ix}</html>"
            return None
        raise AssertionError(f"unexpected script: {script}")

    def quit(self):
        self.quit_called = True


@pytest.fixture()
def fake_browsers(monkeypatch):
    """A minimal selenium package and undetected_chromedriver module in
    ``sys.modules``; the drivers they make land in the returned dict."""
    created: dict = {}

    class Options:
        def __init__(self):
            self.prefs: dict = {}
            self.args: list[str] = []

        def set_preference(self, k, v):
            self.prefs[k] = v

        def add_argument(self, a):
            self.args.append(a)

    class Service:
        def __init__(self, executable_path):
            self.executable_path = executable_path

    def Firefox(service, options):
        created["driver"] = FakeDriver(options)
        created["service"] = service
        return created["driver"]

    def Chrome(options):
        created["driver"] = FakeDriver(options)
        return created["driver"]

    selenium = types.ModuleType("selenium")
    webdriver_m = types.ModuleType("selenium.webdriver")
    webdriver_m.Firefox = Firefox
    options_m = types.ModuleType("selenium.webdriver.firefox.options")
    options_m.Options = Options
    service_m = types.ModuleType("selenium.webdriver.firefox.service")
    service_m.Service = Service
    selenium.webdriver = webdriver_m
    uc = types.ModuleType("undetected_chromedriver")
    uc.ChromeOptions = Options
    uc.Chrome = Chrome
    for name, mod in {"selenium": selenium, "selenium.webdriver": webdriver_m,
                      "selenium.webdriver.firefox": types.ModuleType("selenium.webdriver.firefox"),
                      "selenium.webdriver.firefox.options": options_m,
                      "selenium.webdriver.firefox.service": service_m,
                      "undetected_chromedriver": uc}.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return created


def browser_script(tr, created) -> list:
    """The selenium transport's and the stealth transport's fetch contract:
    preferences, a readyState wait, errors wrapped, scroll until stable,
    ``max_scrolls``, quit, selection by name and the availability probe."""
    rows = []
    t = tr.SeleniumTransport(page_load_timeout=30.0, executable_path="gd-path")
    d = created["driver"]
    rows.append((d.options.prefs, d.options.args, created["service"].executable_path,
                 d.page_load_timeout))
    d.ready_after = 1
    rows.append((t.fetch("https://x/a.html"), d.visited, d._ready_polls))
    d.ready_after = 0
    d.heights = [100, 250, 400, 400]
    slept: list[float] = []
    rows.append((t.fetch_scrolled("https://x/topic", settle_s=2.0, sleep=slept.append), slept,
                 len([s for s in d.scripts if "scrollTo" in s])))
    d.heights = list(range(100, 10000, 100))
    t.fetch_scrolled("https://x/topic", max_scrolls=4, sleep=lambda s: None)
    rows.append(len([s for s in d.scripts if "scrollTo" in s]))
    d.raise_on_get = RuntimeError("about:neterror (unknown host)")
    rows.append(outcome(t.fetch, "https://x/down.html"))
    t.close()
    rows.append(d.quit_called)
    s = tr.make_transport("stealth-chrome", page_load_timeout=12.0)
    d = created["driver"]
    rows.append((type(s).__name__, d.options.args, d.page_load_timeout))
    rows.append(s.fetch("https://x/b.html"))
    d.raise_on_get = RuntimeError("ERR_CONNECTION_RESET")
    rows.append(outcome(s.fetch, "https://x/blocked.html"))
    s.close()
    rows.append((d.quit_called, tr.stealth_chrome_available()))
    return rows


def test_selenium_and_stealth_transports_match_the_reference(fake_browsers):
    got = {name: browser_script(tr, fake_browsers) for name, (tr, _wd) in PACKAGES.items()}
    assert got["port"] == got["ref"]
    rows = got["port"]
    assert rows[0][0]["permissions.default.image"] == 2 and "-headless" in rows[0][1]
    assert rows[1][2] == 2 and rows[2][1] == [2.0, 2.0, 2.0] and rows[3] == 7
    assert rows[4] == ("FetchError", "about:neterror (unknown host)")
    assert rows[6][0] == "StealthChromeTransport" and "--headless=new" in rows[6][1]
    assert rows[8][0] == "FetchError" and rows[9] == (True, True)
