"""The port's HTTP control plane (``net/control.py``) against the JAX
package's: each package runs its own server over the same mock pages, and
the same requests get the same status codes and JSON (template
registration, sync, async and bare extraction, the error paths), write
the same files, and close their transports on shutdown.  A selector
outside the port's CSS subset is refused, never read as ``""``."""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from advanced_scrapper_tpu.net import control as ref_control
from advanced_scrapper_tpu.net.transport import MockTransport as RefMockTransport
from advanced_scrapper_tpu_torch.net import control
from advanced_scrapper_tpu_torch.net.transport import MockTransport

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ARTICLE_HTML = open(os.path.join(FIXTURES, "yfin_article.html")).read()
PKGS = {"jax": (ref_control, RefMockTransport), "port": (control, MockTransport)}
WAIT = 10.0
TEMPLATE = {
    "title": "div.cover-title",
    "date": {"selector": "time", "attribute": "datetime", "index": [0]},
    "author": "div.byline-attr-author",
    "article": "div.body",
    "links": {"selector": "a", "attribute": "href"},
    "paras": {"selector": "div.body", "inner": {"selector": "p"}},
}


def request(url: str, obj=None) -> tuple[int, dict]:
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def pages(seed: int) -> dict[str, str]:
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(6):
        body = "".join(chr(c) for c in rng.randint(97, 123, size=int(rng.randint(20, 200))))
        out[f"https://x/news/{i}.html?src=rss"] = ARTICLE_HTML.replace(
            "record revenue for the third quarter.", body)
    return out


@pytest.fixture()
def servers(tmp_path):
    made = {}
    for pkg, (mod, mock) in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        site = pages(3)
        plane = mod.ControlPlane(lambda site=site, mock=mock: mock(site),
                                 templates_path=str(root / "templates.json"), out_root=str(root))
        made[pkg] = (mod.ControlServer(plane).start(), root)
    yield made
    for srv, _root in made.values():
        srv.stop()


def conversation(srv) -> list:
    base = f"http://127.0.0.1:{srv.port}"
    out = [request(base + "/add_template", {"name": "ysite", "template": TEMPLATE}),
           request(base + "/add_template", {"name": "../evil", "template": TEMPLATE}),
           request(base + "/templates")]
    for url in pages(3):
        out.append(request(base + "/extract_and_get_article", {"url": url, "template": "ysite"}))
        out.append(request(base + "/process_url", {"url": url, "template": "ysite"}))
    out += [request(base + "/extract_and_get_article", {"url": "https://x/none"}),
            request(base + "/extract_and_get_article", {"url": "https://x/none", "template": "ysite"}),
            request(base + "/extract_and_get_article", {"url": "https://x/a", "template": "nope"}),
            request(base + "/nope", {}), request(base + "/nope"),
            request(base + "/get_result/nope")]
    rids = [request(base + "/extract_and_get_article",
                    {"url": url, "template": "ysite", "async": True})[1]["request_id"]
            for url in pages(3)]
    for rid in rids:
        deadline = time.monotonic() + WAIT
        while (got := request(f"{base}/get_result/{rid}"))[0] == 202 and time.monotonic() < deadline:
            time.sleep(0.01)
        out.append(got)
    return out


def test_conversation_equals_reference(servers):
    got = conversation(servers["port"][0])
    assert got == conversation(servers["jax"][0])
    assert got[0] == (200, {"message": "Template added successfully"}) and got[1][0] == 400
    assert got[3][1]["title"] == "Apple Reports Record Q3 iPhone Revenue"

    def tree(root):
        return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                for d, _s, fs in os.walk(root) for f in fs}

    assert tree(servers["port"][1]) == tree(servers["jax"][1])
    status = request(f"http://127.0.0.1:{servers['port'][0].port}/status")[1]
    assert status["control"] == {"templates": ["ysite"], "results_pending": 0, "results_done": 6}


def test_metrics_endpoint_serves_prometheus_text(servers):
    with urllib.request.urlopen(f"http://127.0.0.1:{servers['port'][0].port}/metrics",
                                timeout=WAIT) as r:
        assert r.status == 200 and b"# TYPE" in r.read()


def test_selector_outside_the_subset_is_refused(tmp_path):
    plane = control.ControlPlane(lambda: MockTransport(lambda u: ARTICLE_HTML),
                                 templates_path=str(tmp_path / "t.json"), out_root=str(tmp_path))
    srv = control.ControlServer(plane).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, resp = request(base + "/add_template",
                             {"name": "pseudo", "template": {"title": "div:first-child"}})
        assert code == 500 and "first-child" in resp["message"]
        assert request(base + "/templates")[1] == {"templates": []}
        # a template that reached the store another way is parsed again
        plane.store._templates["sneaky"] = {"title": "p:nth-of-type(2)"}
        code, resp = request(base + "/process_url", {"url": "https://x/a", "template": "sneaky"})
        assert code == 500 and "nth-of-type" in resp["message"]
    finally:
        srv.stop()


def test_shutdown_closes_transports(tmp_path):
    closed = []

    class T(MockTransport):
        def __init__(self):
            super().__init__(lambda u: ARTICLE_HTML)

        def close(self):
            closed.append(1)

    plane = control.ControlPlane(T, templates_path=str(tmp_path / "t.json"), out_root=str(tmp_path))
    plane.add_template("x", TEMPLATE)
    assert plane.extract("https://a/b.html", "x")["title"].startswith("Apple")
    plane.shutdown()
    assert closed == [1]
