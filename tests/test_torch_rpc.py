"""The port's RPC plane (``net/rpc.py``) against the JAX package's.

The frames are the reference's byte for byte (captured over a
``socketpair`` for the same header and arrays), ``backoff_delays`` draws
the same jitter, and a client of either package talks to a server of the
other: a call and a remote error, the replay of a duplicate request id, a
retry after a cut mid-frame, an in-flight duplicate, a deadline that ends
in ``RpcUnavailable``, an overload answered with a retry-after hint and
honoured, and a ping under full admission.  Every wait is bounded by a
short timeout of the test's own."""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest

from advanced_scrapper_tpu.net import rpc as ref_rpc
from advanced_scrapper_tpu.runtime import admission as ref_admission
from advanced_scrapper_tpu_torch.net import rpc
from advanced_scrapper_tpu_torch.runtime import admission

PKGS = {"jax": (ref_rpc, ref_admission), "port": (rpc, admission)}
#: (client package, server package): each direction across the packages,
#: and the port with itself
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]
WAIT = 2.0  # the longest any socket wait, deadline or join here may take
#: the longest a parked handler holds its slot, and a poll waits for a
#: slot to change hands: the test always releases the gate first, so this
#: bound costs nothing unless the machine stalls (other test workers)
PARK = 10.0


def capture(send_frame, header: dict, arrays) -> bytes:
    a, b = socket.socketpair()
    try:
        send_frame(a, header, arrays)
        a.shutdown(socket.SHUT_WR)
        b.settimeout(WAIT)
        out = []
        while chunk := b.recv(1 << 16):
            out.append(chunk)
        return b"".join(out)
    finally:
        a.close()
        b.close()


def frames(seed: int):
    rng = np.random.default_rng(seed)
    yield {"method": "probe", "id": "c0.1-1", "space": "bands"}, [
        rng.integers(0, 1 << 63, 37, dtype=np.uint64)]
    yield {"method": "insert", "n": 3, "names": ["a", "é"], "lo": 1 << 63}, [
        rng.integers(0, 1 << 63, (4, 5), dtype=np.uint64),
        rng.integers(-5, 5, 7).astype(np.int64)]
    yield {"ok": True, "x": 1.5, "nested": {"k": [1, 2]}}, [
        np.zeros(0, np.uint64), rng.integers(0, 255, 11).astype(np.uint8),
        rng.random((2, 3)).astype(np.float32), np.asarray([7], np.int32),
        np.asfortranarray(rng.integers(0, 9, (3, 4)).astype(np.int16))]
    yield {}, []


@pytest.mark.parametrize("seed", [0, 1])
def test_send_frame_bytes_equal_reference(seed):
    for header, arrays in frames(seed):
        got = capture(rpc.send_frame, header, arrays)
        assert got == capture(ref_rpc.send_frame, header, arrays)
        # and each package reads the other's frame back
        for recv in (rpc.recv_frame, ref_rpc.recv_frame):
            a, b = socket.socketpair()
            try:
                a.sendall(got)
                b.settimeout(WAIT)
                h, arrs = recv(b)
            finally:
                a.close()
                b.close()
            assert h == header
            assert len(arrs) == len(arrays)
            for x, y in zip(arrs, arrays):
                assert x.dtype == y.dtype and x.shape == y.shape and (x == y).all()


def test_oversized_frame_is_refused_not_buffered():
    a, b = socket.socketpair()
    try:
        ref_rpc.send_frame(a, {"m": "big"}, [np.zeros(4096, np.uint64)])
        b.settimeout(WAIT)
        with pytest.raises(rpc.FrameTooLarge):
            rpc.recv_frame(b, max_frame=1024)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("attempts,base,cap,seed", [
    (6, 0.05, 1.0, "s"), (6, 0.05, 1.0, "t"), (0, 0.1, 1.0, 3), (12, 0.001, 0.5, "0|c1.2-3"),
    (4, 2.0, 1.0, "capped"),
])
def test_backoff_delays_equal_reference(attempts, base, cap, seed):
    got = rpc.backoff_delays(attempts, base=base, cap=cap, seed=seed)
    assert got == ref_rpc.backoff_delays(attempts, base=base, cap=cap, seed=seed)
    assert len(got) == attempts and all(0 < d <= max(cap, base) for d in got)


def echo_server(pkg: str, **kw):
    mod = PKGS[pkg][0]
    calls = {"n": 0}

    def echo(header, arrays):
        calls["n"] += 1
        return {"echo": header.get("x"), "calls": calls["n"]}, list(arrays)

    def boom(header, arrays):
        raise ValueError("deliberate")

    srv = mod.RpcServer({"echo": echo, "boom": boom}, frame_deadline=WAIT, **kw).start()
    srv.test_calls = calls
    return srv


def client(pkg: str, port: int, **kw):
    kw.setdefault("timeout", WAIT)
    return PKGS[pkg][0].RpcClient(("127.0.0.1", port), **kw)


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_call_remote_error_and_replay(cpkg, spkg):
    srv = echo_server(spkg)
    cli = client(cpkg, srv.port)
    try:
        h, arrs = cli.call("echo", {"x": 42}, [np.arange(3, dtype=np.uint64)])
        assert h == {"echo": 42, "calls": 1, "ok": True, "id": h["id"]}
        assert arrs[0].dtype == np.uint64 and (arrs[0] == np.arange(3)).all()
        with pytest.raises(PKGS[cpkg][0].RpcRemoteError) as ei:
            cli.call("boom")
        assert ei.value.etype == "ValueError" and "deliberate" in str(ei.value)
        with pytest.raises(PKGS[cpkg][0].RpcRemoteError):
            cli.call("no_such_method")
        assert srv.test_calls["n"] == 1, "remote errors must not retry"
        h1, _ = cli.call("echo", {"x": 1}, request_id="fixed-id")
        h2, _ = cli.call("echo", {"x": 1}, request_id="fixed-id")
        assert h1 == h2 and h1["calls"] == 2
        assert srv.test_calls["n"] == 2 and srv.replays == 1 and srv.calls == 2
    finally:
        cli.close()
        srv.stop()


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_retry_after_connection_cut_is_single_execution(cpkg, spkg):
    """The first send is cut half-way: the client reconnects and retries
    under the same id, and the server executes once."""
    srv = echo_server(spkg)
    cut = {"done": False}

    class CutFirstSend:
        def __init__(self, inner):
            self._inner = inner

        def sendall(self, data):
            if not cut["done"]:
                cut["done"] = True
                self._inner.sendall(data[: max(1, len(data) // 2)])
                self._inner.close()
                raise ConnectionResetError("injected mid-frame cut")
            return self._inner.sendall(data)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    cli = client(cpkg, srv.port, retries=3, backoff_base=0.001,
                 connect=lambda addr: CutFirstSend(socket.create_connection(addr, timeout=WAIT)))
    try:
        h, _ = cli.call("echo", {"x": 9})
        assert h["echo"] == 9 and cut["done"]
        assert srv.test_calls["n"] == 1, "cut+retry must not double-execute"
    finally:
        cli.close()
        srv.stop()


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_duplicate_during_inflight_execution_runs_once(cpkg, spkg):
    gate = threading.Event()
    calls = {"n": 0}

    def slow(header, arrays):
        calls["n"] += 1
        gate.wait(WAIT)
        return {"n": calls["n"]}

    srv = PKGS[spkg][0].RpcServer({"slow": slow}, frame_deadline=WAIT).start()
    results = []

    def call():
        cli = client(cpkg, srv.port)
        try:
            results.append(cli.call("slow", request_id="dup-1")[0]["n"])
        finally:
            cli.close()

    threads = [threading.Thread(target=call) for _ in range(2)]
    try:
        threads[0].start()
        deadline = time.monotonic() + WAIT
        while calls["n"] == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        threads[1].start()
        time.sleep(0.2)
        gate.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert results == [1, 1] and calls["n"] == 1
    finally:
        gate.set()
        srv.stop()


@pytest.mark.parametrize("cpkg", list(PKGS))
def test_deadline_miss_then_unavailable(cpkg):
    """A peer that accepts and never answers: the call keeps to its
    budget and surfaces ``RpcUnavailable``."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    lsock.settimeout(0.2)
    stop = threading.Event()
    conns = []

    def black_hole():
        while not stop.is_set():
            try:
                conns.append(lsock.accept()[0])
            except (socket.timeout, OSError):
                continue

    t = threading.Thread(target=black_hole, daemon=True)
    t.start()
    cli = client(cpkg, lsock.getsockname()[1], timeout=0.3, retries=1, backoff_base=0.001)
    try:
        t0 = time.monotonic()
        with pytest.raises(PKGS[cpkg][0].RpcUnavailable):
            cli.call("echo", {"x": 1})
        assert time.monotonic() - t0 < WAIT
    finally:
        cli.close()
        stop.set()
        t.join(timeout=WAIT)
        lsock.close()
        for c in conns:
            c.close()


def test_refused_connect_backs_off_then_unavailable():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    port = lsock.getsockname()[1]
    lsock.close()
    slept = {}
    for pkg in PKGS:
        slept[pkg] = []
        cli = client(pkg, port, timeout=0.5, retries=2, backoff_base=0.01, seed=5,
                     sleep=slept[pkg].append)
        with pytest.raises(PKGS[pkg][0].RpcUnavailable):
            cli.call("echo", request_id="same")
    assert len(slept["port"]) == 2 and slept["port"] == slept["jax"]


def admitted_server(pkg: str, **ctrl_kw):
    """An echo server behind an admission controller of its own package
    with one in-flight slot; ``gate`` holds the handler."""
    mod, adm = PKGS[pkg]
    gate = threading.Event()
    gate.set()
    calls = {"n": 0}

    def echo(header, arrays):
        calls["n"] += 1
        gate.wait(PARK)
        return {"echo": header.get("x"), "calls": calls["n"]}

    ctrl = adm.AdmissionController(max_inflight=1, **ctrl_kw)
    srv = mod.RpcServer({"echo": echo}, admission=ctrl, frame_deadline=WAIT).start()
    return srv, ctrl, gate, calls


def hold_the_slot(cpkg, srv, ctrl, gate):
    """Park one call inside the handler; returns its thread and client."""
    gate.clear()
    blocker = client(cpkg, srv.port, retries=0, timeout=PARK)
    t = threading.Thread(target=lambda: blocker.call("echo", {"x": 0}), daemon=True)
    t.start()
    deadline = time.monotonic() + PARK
    while ctrl.inflight() == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert ctrl.inflight() == 1
    return t, blocker


def wait_released(ctrl):
    deadline = time.monotonic() + PARK
    while ctrl.inflight() > 0 and time.monotonic() < deadline:
        time.sleep(0.005)


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_overload_carries_retry_after_and_is_honoured(cpkg, spkg):
    srv, ctrl, gate, calls = admitted_server(spkg)
    t, blocker = hold_the_slot(cpkg, srv, ctrl, gate)
    c = client(cpkg, srv.port, retries=0)
    try:
        rid = c.next_request_id()
        with pytest.raises(PKGS[cpkg][0].RpcOverloaded) as ei:
            c.call("echo", {"x": 2}, request_id=rid)
        assert ei.value.retry_after > 0 and srv.overload_rejects == 1
        # the refusal is not cached under the id: the same id retried later
        # gets a fresh admission and executes
        gate.set()
        t.join(timeout=WAIT)
        wait_released(ctrl)
        assert c.call("echo", {"x": 2}, request_id=rid)[0]["echo"] == 2
        # a client with retries sleeps at least the hint and retries the same id
        t, blocker2 = hold_the_slot(cpkg, srv, ctrl, gate)
        sleeps = []

        def sleep_and_free(s):
            sleeps.append(s)
            gate.set()
            t.join(timeout=WAIT)
            wait_released(ctrl)

        c2 = client(cpkg, srv.port, retries=2, sleep=sleep_and_free)
        assert c2.call("echo", {"x": 9})[0]["echo"] == 9
        assert sleeps and sleeps[0] > 0 and calls["n"] == 4
        c2.close()
        blocker2.close()
    finally:
        gate.set()
        t.join(timeout=WAIT)
        blocker.close()
        c.close()
        srv.stop()


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_ping_bypasses_full_admission(cpkg, spkg):
    srv, ctrl, gate, _calls = admitted_server(spkg, rate=0.001, burst=1)
    t, blocker = hold_the_slot(cpkg, srv, ctrl, gate)
    probe = client(cpkg, srv.port, retries=0)
    try:
        assert all(probe.ping() is True for _ in range(5))
        with pytest.raises(PKGS[cpkg][0].RpcOverloaded):
            probe.call("echo", {"x": 1})
    finally:
        gate.set()
        t.join(timeout=WAIT)
        blocker.close()
        probe.close()
        srv.stop()
    assert probe.ping(timeout=0.5) is False, "a stopped server fails the probe"


def test_rpc_series_equal_reference():
    """The server's and client's series carry the reference's names and
    labels, and an oversized frame counts a drop by reason."""
    from advanced_scrapper_tpu.obs import telemetry as ref_telemetry
    from advanced_scrapper_tpu_torch.obs import telemetry

    names = {}
    for pkg, tel in (("jax", ref_telemetry), ("port", telemetry)):
        tel.REGISTRY.reset()
        tel.set_enabled(True)
        try:
            srv = echo_server(pkg, name="series")
            cli = client(pkg, srv.port)
            cli.call("echo", {"x": 1}, request_id="r")
            cli.call("echo", {"x": 1}, request_id="r")
            with pytest.raises(PKGS[pkg][0].RpcRemoteError):
                cli.call("boom")
            cli.close()
            srv.stop()
            a, b = socket.socketpair()
            PKGS[pkg][0].send_frame(a, {}, [np.zeros(64, np.uint64)])
            b.settimeout(WAIT)
            with pytest.raises(PKGS[pkg][0].FrameTooLarge):
                PKGS[pkg][0].recv_frame(b, max_frame=16)
            a.close()
            b.close()
            names[pkg] = sorted(
                line for line in tel.REGISTRY.prometheus_text().splitlines()
                if line.startswith("astpu_rpc_") and "_seconds" not in line)
        finally:
            tel.set_enabled(None)
            tel.REGISTRY.reset()
    assert names["port"] == names["jax"]
    assert 'astpu_rpc_frames_dropped_total{reason="oversize"} 1' in names["port"]
