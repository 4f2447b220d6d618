"""The port's socket fault injection (``net/chaos.py``) against the JAX
package's, and both lease and RPC planes under it across the packages.

``ChaosSocket`` decisions are pure functions of (seed, frame digest,
occurrence) on send and of the per-socket call index on recv, so the same
seed and frames give the reference's ledger.  A client of either package,
dialling through either package's ``chaos_connector``, works a server of
the other: a result frame cut mid-wire requeues its leases and every url
ends resulted exactly once; trickled and fragmented frames reassemble; an
RPC request cut mid-frame retries under its id and runs its handler once.
The RPC case uses fixed request ids, so its frames, and with them its cuts,
are the same on every run."""

from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np
import pytest

from advanced_scrapper_tpu.config import FeedConfig as RefFeedConfig
from advanced_scrapper_tpu.net import chaos as ref_chaos
from advanced_scrapper_tpu.net import lease as ref_lease
from advanced_scrapper_tpu.net import rpc as ref_rpc
from advanced_scrapper_tpu.net.transport import MockTransport as RefMockTransport
from advanced_scrapper_tpu_torch.config import FeedConfig
from advanced_scrapper_tpu_torch.net import chaos, lease, rpc
from advanced_scrapper_tpu_torch.net.transport import MockTransport

#: package → (chaos, lease, rpc, FeedConfig, MockTransport)
PKGS = {"jax": (ref_chaos, ref_lease, ref_rpc, RefFeedConfig, RefMockTransport),
        "port": (chaos, lease, rpc, FeedConfig, MockTransport)}
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]
PAGE = "<html><body>doc</body></html>"
WAIT = 10.0


def cfg_of(pkg: str, **kw):
    base = dict(host="127.0.0.1", port=0, batch_size=4, min_queue_length=2,
                client_threads=2, client_rate=200.0)
    base.update(kw)
    return PKGS[pkg][3](**base)


def poll(cond, timeout: float = WAIT) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def ledger_run(mod, seed: int):
    a, b = socket.socketpair()
    got = bytearray()

    def drain():
        a.settimeout(WAIT)
        try:
            while chunk := a.recv(65536):
                got.extend(chunk)
        except OSError:
            pass

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    sock = mod.ChaosSocket(b, seed=seed, cut_rate=0.1, trickle_rate=0.3, trickle_delay=0.0,
                           fragment_rate=0.5, fragment_bytes=3)
    outcomes = []
    a.sendall(b"0123456789" * 4)
    outcomes.append(sock.recv(64))
    for i in range(24):
        frame = json.dumps({"type": "result", "url": f"https://x/{i % 4}"}).encode() + b"\n"
        try:
            sock.sendall(frame)
            outcomes.append("ok")
        except ConnectionResetError:
            outcomes.append("cut")
            break
    try:
        b.shutdown(socket.SHUT_WR)  # the reader sees every byte sent, then EOF
    except OSError:
        pass  # a cut already tore it down
    t.join(timeout=WAIT)
    for s in (a, b):
        s.close()
    return outcomes, list(sock.ledger), dict(sock.injected), bytes(got)


@pytest.mark.parametrize("seed", [3, 4, 11])
def test_ledger_equals_reference(seed):
    got = ledger_run(chaos, seed)
    assert got == ledger_run(ref_chaos, seed)
    assert sum(got[2].values()) > 0


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_half_frame_death_requeues_and_strays_are_rejected(cpkg, spkg):
    urls = [f"https://x/{i}.html" for i in range(8)] + ["https://x/0.html"]
    server = PKGS[spkg][1].LeaseServer(cfg_of(spkg), urls).start()
    try:
        sock = socket.create_connection(("127.0.0.1", server.port), timeout=WAIT)
        sock.sendall(b'{"type": "request_tasks", "num_urls": 5}\n')
        batch = PKGS[cpkg][1]._LineReader(sock).readline()
        done_url, torn_url = batch["urls"][0], batch["urls"][1]
        whole = (json.dumps({"type": "result", "url": done_url, "html_content": PAGE}) + "\n")
        sock.sendall(whole.encode() * 2)  # a replayed frame: a stray
        sock.sendall((json.dumps({"type": "result", "url": "https://x/forged.html",
                                  "html_content": PAGE}) + "\n").encode())
        torn = (json.dumps({"type": "result", "url": torn_url, "html_content": PAGE}) + "\n")
        sock.sendall(torn.encode()[: len(torn) // 2])
        assert poll(lambda: len(server.results) == 1)
        sock.close()  # half-frame death
        assert poll(lambda: not server._assigned_snapshot())
        healthy = PKGS[cpkg][1].LeaseClient(cfg_of(cpkg), lambda: PKGS[cpkg][4](lambda u: PAGE),
                                            port=server.port)
        assert healthy.run(max_seconds=WAIT) == 7 and server.wait_done(WAIT)
    finally:
        server.stop()
    got = [r["url"] for r in server.results]
    assert sorted(got) == sorted(set(urls)) and len(got) == len(set(got))


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_chaos_client_then_clean_client_converge(cpkg, spkg):
    urls = [f"https://x/{i}.html" for i in range(12)]
    server = PKGS[spkg][1].LeaseServer(cfg_of(spkg, client_threads=1), urls).start()
    try:
        connect, sockets = PKGS[cpkg][0].chaos_connector(seed=7, cut_rate=0.35)
        PKGS[cpkg][1].LeaseClient(cfg_of(cpkg, client_threads=1),
                                  lambda: PKGS[cpkg][4](lambda u: PAGE), port=server.port,
                                  connect=connect).run(max_seconds=WAIT)
        assert sockets[0].injected["cut"] >= 1  # the seeded cut of the first frames
        assert poll(lambda: not server._assigned_snapshot())
        PKGS[cpkg][1].LeaseClient(cfg_of(cpkg), lambda: PKGS[cpkg][4](lambda u: PAGE),
                                  port=server.port).run(max_seconds=WAIT)
        assert server.wait_done(WAIT)
    finally:
        server.stop()
    got = [r["url"] for r in server.results]
    assert sorted(got) == sorted(urls) and len(got) == len(set(got))


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_trickled_and_fragmented_frames_still_parse(cpkg, spkg):
    """Every send trickles and every read fragments.  A seeded rate below 1
    on the reads left the fragment to chance: how many reads the client
    makes depends on how TCP coalesces the server's frames, and for seed 11
    the first four reads all draw above 0.5, so a loaded run that needed
    only four reads fragmented none."""
    urls = [f"https://x/{i}.html" for i in range(6)]
    server = PKGS[spkg][1].LeaseServer(cfg_of(spkg, client_threads=1), urls).start()
    try:
        connect, sockets = PKGS[cpkg][0].chaos_connector(
            seed=11, trickle_rate=1.0, trickle_chunk=3, trickle_delay=0.0005,
            fragment_rate=1.0, fragment_bytes=7)
        client = PKGS[cpkg][1].LeaseClient(cfg_of(cpkg, client_threads=1),
                                           lambda: PKGS[cpkg][4](lambda u: PAGE),
                                           port=server.port, connect=connect)
        assert client.run(max_seconds=WAIT) == 6 and server.wait_done(WAIT)
        reads = [entry for entry in sockets[0].ledger if entry[0] == "recv"]
        assert reads and reads == [("recv", n, "fragment") for n in range(len(reads))]
        assert sockets[0].injected["trickle"] > 0
        assert sockets[0].injected["fragment"] == len(reads)
    finally:
        server.stop()
    got = [r["url"] for r in server.results]
    assert sorted(got) == sorted(urls) and len(got) == len(set(got))


def rpc_echo_server(pkg: str):
    executions = {"n": 0}

    def count(header, arrays):
        executions["n"] += 1
        return {"n": executions["n"], "x": header.get("x")}, list(arrays)

    srv = PKGS[pkg][2].RpcServer({"count": count}, frame_deadline=WAIT).start()
    return srv, executions


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_rpc_mid_frame_cut_retries_once_only(cpkg, spkg):
    """Fixed request ids make the frames, and so the seeded cuts, the same
    on every run: with a fresh seed a dial, the ledger below is certain."""
    srv, executions = rpc_echo_server(spkg)
    sockets = []

    def connect(addr):
        s = PKGS[cpkg][0].ChaosSocket(socket.create_connection(addr, timeout=WAIT),
                                      seed=len(sockets) + 1, cut_rate=0.35)
        sockets.append(s)
        return s

    cli = PKGS[cpkg][2].RpcClient(("127.0.0.1", srv.port), timeout=WAIT, retries=7,
                                  backoff_base=0.005, connect=connect)
    try:
        results = []
        for i in range(12):
            h, arrs = cli.call("count", {"x": i}, [np.full(64, i, np.uint64)],
                               request_id=f"chaos-{i}")
            assert h["x"] == i and (arrs[0] == i).all()
            results.append(h["n"])
        cli.close()
    finally:
        srv.stop()
    assert results == list(range(1, 13)) and executions["n"] == 12
    cuts = [(k, entry) for k, s in enumerate(sockets) for entry in s.ledger]
    assert cuts == [(0, ("send", ("06aa4d0c8a0e", 0), "cut")),
                    (1, ("send", ("6bac60ebde41", 0), "cut")),
                    (2, ("send", ("8c593d11f243", 0), "cut")),
                    (3, ("send", ("c2ba849b4d80", 0), "cut"))] and len(sockets) == 5
