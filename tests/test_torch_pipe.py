"""The port's subprocess worker pool (``net/pipe_pool.py``,
``net/pipe_worker.py``) against the JAX package's: the worker's result and
error lines equal the reference worker's for the same pages (plugin and
template extractors), the pool runs them end to end, reclaims a dead
worker's slot, and its workers never import torch."""

from __future__ import annotations

import io
import json
import os
import time

import numpy as np

from advanced_scrapper_tpu.net import pipe_worker as ref_worker
from advanced_scrapper_tpu_torch.net import pipe_worker
from advanced_scrapper_tpu_torch.net.pipe_pool import PipePool

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ARTICLE_HTML = open(os.path.join(FIXTURES, "yfin_article.html")).read()
WAIT = 30.0


def site(seed: int, n: int) -> dict[str, str]:
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(n):
        body = "".join(chr(c) for c in rng.randint(97, 123, size=int(rng.randint(10, 300))))
        html = ARTICLE_HTML.replace("record revenue for the third quarter.", body)
        if i % 5 == 3:
            html = html.replace("Apple Reports", "Apple &amp; Co Report")
        out[f"https://x/{i}.html"] = html
    return out


def torch_mapped(pid: int) -> bool:
    """Whether process ``pid`` has loaded torch's C++ library."""
    import torch

    lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    with open(f"/proc/{pid}/maps") as f:
        return lib in f.read()


def worker_lines(mod, config: dict, urls: list[str]) -> tuple[str, str]:
    out, err = io.StringIO(), io.StringIO()
    mod.run_worker(config, stdin=io.StringIO("\n".join(urls) + "\n\n"), stdout=out, stderr=err)
    return out.getvalue(), err.getvalue()


def test_worker_lines_equal_reference():
    pages = site(2, 20)
    urls = list(pages) + ["https://x/missing.html"]
    for config in ({"transport": "mock", "pages": pages, "website": "yfin"},
                   {"transport": "mock", "pages": pages,
                    "template": {"title": "div.cover-title",
                                 "date": {"selector": "time", "attribute": "datetime"}}}):
        got = worker_lines(pipe_worker, config, urls)
        assert got == worker_lines(ref_worker, config, urls)
        assert len(got[0].splitlines()) == 20 and "no fixture" in got[1]


def test_pool_end_to_end_and_workers_without_torch():
    pages = site(4, 40)
    urls = list(pages) + ["https://x/missing.html"]
    pool = PipePool(num_workers=3, config={"transport": "mock", "pages": pages,
                                           "website": "yfin"}).start()
    try:
        for u in urls:
            assert pool.dispatch(u, timeout=WAIT)
        out = pool.drain(len(urls), timeout=WAIT)
        # every worker, alive after its work, has no torch library mapped
        # (this process, which imported torch, has)
        assert torch_mapped(os.getpid())
        assert [torch_mapped(p.pid) for p in pool._procs] == [False] * 3
    finally:
        pool.stop()
    want = worker_lines(ref_worker, {"transport": "mock", "pages": pages, "website": "yfin"}, urls)
    oks = sorted(json.dumps(o) for o in out if "title" in o)
    assert oks == sorted(want[0].splitlines())
    assert [o["url"] for o in out if "error" in o] == ["https://x/missing.html"]


def test_pool_reclaims_slot_on_worker_crash():
    pool = PipePool(num_workers=1, config={"transport": "mock", "pages": {},
                                           "website": "yfin"}).start()
    try:
        proc = pool._procs[0]
        assert pool.dispatch("https://x/a.html", timeout=WAIT)
        proc.kill()
        proc.wait(timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline and pool._busy[0]:
            time.sleep(0.01)
        assert not pool._busy[0]
        assert pool._free.acquire(timeout=WAIT)
        pool._free.release()
    finally:
        pool.stop()
    assert pool._procs[0].args[1:3] == ["-m", "advanced_scrapper_tpu_torch.net.pipe_worker"]
