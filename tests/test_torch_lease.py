"""The port's lease plane (``net/lease.py``) against the JAX package's.

The NDJSON frames are the reference's byte for byte, and a client of
either package works a server of the other: the round trip with central
parsing, a disconnect and a malformed frame that requeue, the completion
handshake, the admission shed, the TTL reaper, an oversize frame, the
connect backoff and the status endpoints.  ``process_results`` over the
same results writes byte-equal success and failed CSVs in both packages,
and streams its successes into a CPU ``TpuBatchBackend`` whose
annotations equal the JAX backend's.  Every wait is a bounded poll;
nothing rests on a sleep."""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from advanced_scrapper_tpu.config import DedupConfig as RefDedupConfig
from advanced_scrapper_tpu.config import FeedConfig as RefFeedConfig
from advanced_scrapper_tpu.extractors import load_extractor as ref_load_extractor
from advanced_scrapper_tpu.net import lease as ref_lease
from advanced_scrapper_tpu.net.transport import MockTransport as RefMockTransport
from advanced_scrapper_tpu.runtime import admission as ref_admission
from advanced_scrapper_tpu_torch.config import DedupConfig, FeedConfig
from advanced_scrapper_tpu_torch.extractors import load_extractor
from advanced_scrapper_tpu_torch.net import lease
from advanced_scrapper_tpu_torch.net.transport import MockTransport
from advanced_scrapper_tpu_torch.runtime import admission

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ARTICLE_HTML = open(os.path.join(FIXTURES, "yfin_article.html")).read()
#: package → (lease module, FeedConfig, MockTransport, admission module)
PKGS = {"jax": (ref_lease, RefFeedConfig, RefMockTransport, ref_admission),
        "port": (lease, FeedConfig, MockTransport, admission)}
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]
WAIT = 10.0  # the longest any poll, socket wait or run here may take


def cfg_of(pkg: str, **kw):
    base = dict(host="127.0.0.1", port=0, batch_size=4, min_queue_length=2,
                client_threads=2, client_rate=200.0)
    base.update(kw)
    return PKGS[pkg][1](**base)


def poll(cond, timeout: float = WAIT) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def frame_bytes(send, obj) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, threading.Lock(), obj)
        a.shutdown(socket.SHUT_WR)
        b.settimeout(WAIT)
        out = []
        while chunk := b.recv(1 << 16):
            out.append(chunk)
        return b"".join(out)
    finally:
        a.close()
        b.close()


FRAMES = [{"type": "request_tasks", "num_urls": 20},
          {"type": "task_batch", "urls": ["https://x/é.html", 'a"b'], "shed": False},
          {"type": "task_batch", "urls": [], "shed": True, "retry_after": 0.25},
          {"type": "result", "url": "u", "html_content": "<p>☃\n\t</p>",
           "_trace": {"t": "abc", "s": "def"}},
          {"type": "heartbeat"}, {"type": "tasks_completed"}, {"type": "acknowledge_completion"}]


def test_frames_equal_reference_and_read_across():
    for obj in FRAMES:
        got = frame_bytes(lease._send_json, obj)
        assert got == frame_bytes(ref_lease._send_json, obj)
        for reader in (lease._LineReader, ref_lease._LineReader):
            a, b = socket.socketpair()
            try:
                b.settimeout(WAIT)
                a.sendall(b"\n  \n" + got[:5])  # blank lines skipped, a split frame joined
                a.sendall(got[5:])
                assert reader(b).readline() == obj
            finally:
                a.close()
                b.close()


def test_line_reader_cap_raises_frame_too_long():
    a, b = socket.socketpair()
    try:
        b.settimeout(WAIT)
        a.sendall(b"x" * 256)
        with pytest.raises(lease.FrameTooLong):
            lease._LineReader(b, max_line=64).readline()
    finally:
        a.close()
        b.close()
    assert issubclass(lease.FrameTooLong, ValueError)


def run_client(cpkg: str, cfg, port: int, transport_factory, **kw) -> int:
    client = PKGS[cpkg][0].LeaseClient(cfg, transport_factory, port=port, **kw)
    return client.run(max_seconds=WAIT)


def replay(pkg: str, results: list[dict], tmp, on_success=None) -> tuple:
    """``process_results`` of ``pkg`` over ``results`` in this order."""
    mod = PKGS[pkg][0]
    server = mod.LeaseServer(cfg_of(pkg), [])
    server.results = [dict(r) for r in results]
    loader = load_extractor if pkg == "port" else ref_load_extractor
    ok_csv, bad_csv = str(tmp / f"{pkg}-ok.csv"), str(tmp / f"{pkg}-bad.csv")
    counts = server.process_results(loader("yfin"), ok_csv, bad_csv, on_success=on_success)
    return counts, open(ok_csv, "rb").read(), open(bad_csv, "rb").read()


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_round_trip_and_central_parse(cpkg, spkg, tmp_path):
    urls = [f"https://x/{i}.html" for i in range(10)] + ["https://x/0.html"]  # a repeat
    pages = {u: ARTICLE_HTML for u in urls[:10]}
    pages[urls[3]] = ARTICLE_HTML.replace("<title>", "<title>Other ")
    del pages[urls[5]]  # no fixture: the client ships an ERROR: payload
    pages[urls[7]] = "<html><body>no title here</body></html>"
    server = PKGS[spkg][0].LeaseServer(cfg_of(spkg), urls).start()
    try:
        sent = run_client(cpkg, cfg_of(cpkg), server.port,
                          lambda: PKGS[cpkg][2](dict(pages)))
        assert sent == 10 and server.wait_done(WAIT)
    finally:
        server.stop()
    got = sorted(r["url"] for r in server.results)
    assert got == sorted(set(urls))  # dedup on ingest: one answer a url
    counts, ok_bytes, bad_bytes = replay("port", server.results, tmp_path)
    assert (counts, ok_bytes, bad_bytes) == replay("jax", server.results, tmp_path)
    assert counts == (8, 2) and b"no fixture" in bad_bytes and b"Title is empty" in bad_bytes


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_disconnect_and_malformed_frame_requeue(cpkg, spkg):
    mod = PKGS[spkg][0]
    urls = [f"https://x/{i}.html" for i in range(8)]
    server = mod.LeaseServer(cfg_of(spkg), urls).start()
    try:
        for tail in (None, b"this is not json\n"):
            sock = socket.create_connection(("127.0.0.1", server.port), timeout=WAIT)
            sock.sendall(b'{"type": "request_tasks", "num_urls": 3}\n')
            batch = PKGS[cpkg][0]._LineReader(sock).readline()
            assert batch["type"] == "task_batch" and len(batch["urls"]) == 3
            if tail is None:
                sock.sendall((json.dumps({"type": "result", "url": batch["urls"][0],
                                          "html_content": "<html></html>"}) + "\n").encode())
                assert poll(lambda: len(server.results) == 1)
                sock.close()
            else:
                sock.sendall(tail)
                assert poll(lambda: sock.recv(1) == b"")  # the server cut it
                sock.close()
            assert poll(lambda: not server._assigned_snapshot())  # leases requeued
        sent = run_client(cpkg, cfg_of(cpkg), server.port,
                          lambda: PKGS[cpkg][2](lambda u: ARTICLE_HTML))
        assert sent == 7 and server.wait_done(WAIT)
    finally:
        server.stop()
    assert sorted(r["url"] for r in server.results) == sorted(urls)


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_shed_grants_and_completion_handshake(cpkg, spkg):
    mod, _cfg, mock, adm = PKGS[spkg]
    urls = [f"https://x/{i}.html" for i in range(4)]
    ctrl = adm.AdmissionController()
    ctrl.trigger(0.3)  # paused: every grant shed for the first 300 ms
    server = mod.LeaseServer(cfg_of(spkg, batch_size=4, min_queue_length=1), urls,
                             admission=ctrl).start()
    try:
        sock = socket.create_connection(("127.0.0.1", server.port), timeout=WAIT)
        sock.sendall(b'{"type": "request_tasks", "num_urls": 4}\n')
        shed = PKGS[cpkg][0]._LineReader(sock).readline()
        assert shed["urls"] == [] and shed["shed"] is True and shed["retry_after"] > 0
        sock.sendall(b'{"type": "tasks_completed"}\n')
        assert PKGS[cpkg][0]._LineReader(sock).readline() == {"type": "acknowledge_completion"}
        sock.close()
        sent = run_client(cpkg, cfg_of(cpkg, batch_size=4, min_queue_length=1), server.port,
                          lambda: PKGS[cpkg][2](lambda u: ARTICLE_HTML))
        assert sent == 4 and server.wait_done(WAIT)  # a shed is not a drained queue
        assert server._m_shed.value > 0 and ctrl.rejected > 0
    finally:
        server.stop()


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_ttl_reaper_and_oversize_frame_requeue(cpkg, spkg):
    mod = PKGS[spkg][0]
    urls = [f"https://x/{i}.html" for i in range(6)]
    server = mod.LeaseServer(cfg_of(spkg, lease_ttl=0.3, max_frame_bytes=4096), urls).start()
    try:
        wedged = socket.create_connection(("127.0.0.1", server.port), timeout=WAIT)
        wedged.sendall(b'{"type": "request_tasks", "num_urls": 2}\n')
        batch = PKGS[cpkg][0]._LineReader(wedged).readline()
        evil = socket.create_connection(("127.0.0.1", server.port), timeout=WAIT)
        evil.sendall(b'{"type": "request_tasks", "num_urls": 2}\n')
        assert len(PKGS[cpkg][0]._LineReader(evil).readline()["urls"]) == 2
        try:
            evil.sendall(b"A" * 8192)  # no newline past the cap
        except OSError:
            pass
        # the wedged client goes silent: the reaper reclaims its leases and
        # cuts it within the TTL; the oversize frame cut the other
        assert wedged.recv(1) == b"" and poll(lambda: not server._assigned_snapshot())
        sent = run_client(cpkg, cfg_of(cpkg, lease_ttl=0.3), server.port,
                          lambda: PKGS[cpkg][2](lambda u: "<html><body>doc</body></html>"))
        assert sent == 6 and server.wait_done(WAIT)
        try:  # the zombie's late result is a stray, never a second answer
            wedged.sendall((json.dumps({"type": "result", "url": batch["urls"][0],
                                        "html_content": "late"}) + "\n").encode())
        except OSError:
            pass
        wedged.close()
        evil.close()
    finally:
        server.stop()
    got = [r["url"] for r in server.results]
    assert sorted(got) == sorted(urls) and len(got) == len(set(got))


def test_connect_backoff_equals_reference():
    for pkg in ("port", "jax"):
        cfg = cfg_of(pkg, connect_retries=3, connect_backoff=0.01)
        server = PKGS[pkg][0].LeaseServer(cfg, ["https://x/a.html"]).start()
        dials, slept = [], []

        def flaky(addr):
            dials.append(addr)
            if len(dials) <= 2:
                raise ConnectionRefusedError("injected: server not up yet")
            return socket.create_connection(addr, timeout=WAIT)

        def sleep(s):
            slept.append(s)
            time.sleep(min(s, 0.01))

        try:
            client = PKGS[pkg][0].LeaseClient(
                cfg, lambda: PKGS[pkg][2](lambda u: "<html></html>"), port=server.port,
                sleep=sleep, connect=flaky)
            assert client.run(max_seconds=WAIT) == 1 and len(dials) == 3
        finally:
            server.stop()
        if pkg == "port":
            port_sleeps = slept[:2]
        else:
            # the jitter is seeded by the address: the same server address
            # draws the same delays in both packages
            from advanced_scrapper_tpu.net.rpc import backoff_delays as ref_delays
            from advanced_scrapper_tpu_torch.net.rpc import backoff_delays

            seed = f"lease-connect|127.0.0.1:{server.port}"
            assert slept[:2] == ref_delays(2, base=0.01, cap=2.0, seed=seed)
            assert backoff_delays(2, base=0.01, cap=2.0, seed=seed) == ref_delays(
                2, base=0.01, cap=2.0, seed=seed)
            assert len(port_sleeps) == 2
    client = lease.LeaseClient(cfg_of("port", connect_retries=2, connect_backoff=0.001),
                               lambda: None, host="127.0.0.1", port=1, sleep=lambda s: None)
    with pytest.raises(ConnectionError, match="unreachable after 3 attempts"):
        client.run(max_seconds=1)


def test_status_endpoints_and_fleet_status():
    server = lease.LeaseServer(cfg_of("port", lease_ttl=0.0), ["https://x/a.html", "https://x/b.html"],
                               status_port=0).start()
    try:
        sock = socket.create_connection(("127.0.0.1", server.port), timeout=WAIT)
        sock.sendall(b'{"type": "request_tasks", "num_urls": 1}\n')
        lease._LineReader(sock).readline()
        assert poll(lambda: server.fleet_status()["clients"] == {"0": 1})
        base = f"http://127.0.0.1:{server.status_server.port}"
        status = json.loads(urllib.request.urlopen(base + "/status", timeout=WAIT).read())
        assert status["lease"]["pending"] == 2 and status["lease"]["clients"] == {"0": 1}
        metrics = urllib.request.urlopen(base + "/metrics", timeout=WAIT).read().decode()
        for series in ("astpu_lease_urls_leased_total", "astpu_lease_pending",
                       "astpu_lease_assigned", "astpu_lease_shed_grants_total"):
            assert series in metrics, series
        sock.close()
    finally:
        server.stop()
    assert server.status_server is None


def yfin_pages(seed: int, n: int) -> dict[str, str]:
    """``n`` article pages, a planted near-duplicate pair among them."""
    rng = np.random.RandomState(seed)
    bodies = ["".join(chr(c) for c in rng.randint(97, 123, size=400)) for _ in range(n)]
    bodies[n - 1] = bodies[0][:380] + "zzzzzzzzzzzzzzzzzzzz"
    return {f"https://x/{i}.html": ARTICLE_HTML.replace("record revenue for the third quarter.",
                                                        b) for i, b in enumerate(bodies)}


def test_process_results_feeds_equal_backends(tmp_path):
    """Central parsing streams every success into the dedup backend: the
    port's CPU ``TpuBatchBackend`` annotates what the JAX one does."""
    from advanced_scrapper_tpu.extractors.tpu_batch import TpuBatchBackend as RefBackend
    from advanced_scrapper_tpu_torch.extractors.tpu_batch import TpuBatchBackend

    pages = yfin_pages(11, 12)
    server = lease.LeaseServer(cfg_of("port", batch_size=3, min_queue_length=1), list(pages)).start()
    try:
        threads = [threading.Thread(target=run_client, args=(
            "port", cfg_of("port", batch_size=3, min_queue_length=1, client_threads=1),
            server.port, lambda: MockTransport(pages))) for _ in range(2)]
        for t in threads:
            t.start()
        assert server.wait_done(WAIT)
    finally:
        server.stop()
        for t in threads:
            t.join(timeout=WAIT)
    got, want = [], []
    backend = TpuBatchBackend(DedupConfig(batch_size=4, block_len=512), sink=got.append,
                              device="cpu")
    ref_backend = RefBackend(RefDedupConfig(batch_size=4, block_len=512), sink=want.append)
    out = replay("port", server.results, tmp_path, on_success=backend.submit)
    backend.flush()
    assert out == replay("jax", server.results, tmp_path, on_success=ref_backend.submit)
    ref_backend.flush()
    assert got == want and len(got) == 12
    links = {r["url"]: r["dup_of"] or r["near_dup_of"] for r in got}
    assert sorted(u for u, v in links.items() if v) in (["https://x/0.html"], ["https://x/11.html"])
