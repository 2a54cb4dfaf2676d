"""The port's HTTP choke point (``serve/netio.py``) on the CPU, against the
JAX package's ``serve/netio.py``.

The netio and breaker cases of ``tests/test_netfaults.py``: the ``net_*``
grammar reaching netio, the retried reset, the non-idempotent request that
is never retried, the bounded hang, the torn body, the stream trailer's
match, mismatch and tear, the HTTP error status that is an answer, the
breaker's lifecycle and the hedged read. Each case runs both modules, each
with its own package's fault plan, against the same loopback server, and
asserts one outcome for both. Last, the port's ``stream`` reads a job's
FASTA from the port's ``serve/http.py`` through its byte-count trailer,
also when the job's commit renames its part file under the stream.
"""

import errno
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from daccord_tpu.runtime.faults import FaultPlan as JaxFaultPlan
from daccord_tpu.serve import netio as jax_netio
from daccord_tpu_torch.runtime.faults import FaultPlan
from daccord_tpu_torch.serve import netio

PKGS = {"jax": (jax_netio, JaxFaultPlan), "port": (netio, FaultPlan)}


@pytest.fixture(autouse=True)
def _clean_faults():
    """Every test leaves both process-wide fault hooks as it found them."""
    yield
    netio.install_faults(None)
    jax_netio.install_faults(None)


def _both(case):
    """``case(netio_module, FaultPlan)`` for the JAX module and the port's,
    each with its own fault plan; asserts one outcome and returns it."""
    out = {}
    for name, (mod, plan) in PKGS.items():
        mod.install_faults(None)
        out[name] = case(mod, plan)
        mod.install_faults(None)
    assert out["port"] == out["jax"], out
    return out["port"]


def test_net_fault_grammar_parse_and_counters():
    """The ``net_*`` specs parse alike; the domain-scoped counter, the torn
    offset and the continuous slow behave alike."""
    text = ("net_refused:1@healthz,net_reset:2,net_hang:1@stream"
            ",net_torn:500@result,net_slow:150@stream")

    def case(mod, Plan):
        p = Plan.parse(text)
        kinds = sorted((s.kind, s.at, s.domain) for s in p.specs)
        bad = []
        for t in ("net_reset:1@attic", "serve_crash:1@submit", "net_bogus:1"):
            try:
                Plan.parse(t)
            except ValueError:
                bad.append(t)
        q = Plan.parse("net_reset:2@submit")
        seq = [q.net_check(d) for d in ("healthz", "healthz", "submit", "submit", "submit")]
        r = Plan.parse("net_torn:500@stream,net_slow:25@stream")
        torn = (r.net_slow_ms("stream"), r.net_slow_ms("submit"),
                r.net_check("submit"), r.net_check("stream").at, r.net_check("stream"),
                r.has_net_faults(), Plan.parse("net_slow:10").net_slow_ms("healthz"))
        return (kinds, p.has_net_faults(), bad,
                [None if s is None else s.kind for s in seq], q.has_net_faults(), torn)

    kinds, has, bad, seq, left, torn = _both(case)
    assert has and len(bad) == 3 and ("net_torn", 500, "result") in kinds
    assert seq == [None, None, None, "net_reset", None] and not left
    assert torn == (25.0, 0.0, None, 500, None, True, 10.0)


def test_env_fault_plan_reaches_netio(monkeypatch):
    """``DACCORD_FAULT`` resolves lazily inside netio: a refused connection
    with its real errno, before any socket is opened."""
    monkeypatch.setenv("DACCORD_FAULT", "net_refused:1@healthz")

    def case(mod, Plan):
        try:
            mod.request("http://127.0.0.1:1/healthz", "healthz", timeout=0.2)
        except mod.InjectedNetFault as e:
            return e.errno, e.fault_kind
        return None

    assert _both(case) == (errno.ECONNREFUSED, "net_refused")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # noqa: A002
        pass

    def _serve(self):
        srv = self.server
        srv.hits += 1
        beh = srv.script.pop(0) if srv.script else {}
        if beh.get("delay"):
            time.sleep(beh["delay"])
        body = beh.get("body", b'{"ok": true}')
        self.send_response(beh.get("status", 200))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        declared = beh.get("declared", len(body))
        if declared is not None:
            self.send_header(netio.BODY_BYTES_HEADER, str(declared))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        self._serve()

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0) or 0)
        if n:
            self.rfile.read(n)
        self._serve()


@pytest.fixture
def httpd():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    srv.daemon_threads = True
    srv.hits = 0
    srv.script = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    srv.url = f"http://127.0.0.1:{srv.server_address[1]}"
    yield srv
    srv.shutdown()
    srv.server_close()


def _fresh(srv, script=()):
    srv.hits = 0
    srv.script = [dict(s) for s in script]


def test_request_absorbs_transient_reset(httpd):
    """An injected reset fires before the request leaves (the peer never saw
    it), logs ``net.fault``, and the bounded retry absorbs it."""
    def case(mod, Plan):
        _fresh(httpd)
        mod.install_faults(Plan.parse("net_reset:1@submit"))
        events = []
        status, body, _ = mod.request(
            httpd.url + "/v1/jobs", "submit", method="POST", body=b"{}",
            retries=2, log_event=lambda e, **kw: events.append((e, kw)), peer="pX")
        return status, json.loads(body)["ok"], httpd.hits, events

    assert _both(case) == (200, True, 1, [("net.fault", {
        "kind": "net_reset", "domain": "submit", "peer": "pX"})])


def test_request_non_idempotent_never_retried(httpd):
    """A submit without an idempotency key surfaces its reset."""
    def case(mod, Plan):
        _fresh(httpd)
        mod.install_faults(Plan.parse("net_reset:1@submit"))
        try:
            mod.request(httpd.url + "/v1/jobs", "submit", method="POST",
                        body=b"{}", retries=3, idempotent=False)
        except mod.InjectedNetFault as e:
            return e.errno, httpd.hits
        return None

    assert _both(case) == (errno.ECONNRESET, 0)


def test_injected_hang_bounded_by_deadline(httpd):
    """``net_hang`` surfaces as the deadline's timeout after a bounded
    spend."""
    def case(mod, Plan):
        _fresh(httpd)
        mod.install_faults(Plan.parse("net_hang:1@healthz"))
        t0 = time.monotonic()
        try:
            mod.request(httpd.url + "/healthz", "healthz", timeout=0.25)
        except TimeoutError:
            return "timeout", time.monotonic() - t0 < 2.0, httpd.hits
        return None

    assert _both(case) == ("timeout", True, 0)


def test_torn_body_detected_and_retried_when_idempotent(httpd):
    """A body shorter than its declared byte count is a ``TornBody``:
    retried when idempotent, surfaced when not; an injected tear heals on
    the retry."""
    def case(mod, Plan):
        _fresh(httpd, [{"declared": 999}, {}])
        status, body, _ = mod.request(httpd.url + "/x", "result", retries=1)
        first = (status, httpd.hits)
        _fresh(httpd, [{"declared": 999}])
        try:
            mod.request(httpd.url + "/x", "submit", retries=1, idempotent=False)
            second = None
        except mod.TornBody as e:
            second = (e.expected, e.got)
        _fresh(httpd)
        mod.install_faults(Plan.parse("net_torn:4@result"))
        status, body, _ = mod.request(httpd.url + "/x", "result", retries=1)
        return first, second, (status, body, httpd.hits)

    first, second, healed = _both(case)
    assert first == (200, 2) and second == (999, 12)
    assert healed == (200, b'{"ok": true}', 2)


def test_http_error_status_is_an_answer_not_a_failure(httpd):
    def case(mod, Plan):
        _fresh(httpd, [{"status": 503, "body": b'{"retryable": true}'}])
        status, body, _ = mod.request(httpd.url + "/x", "result", retries=2)
        return status, json.loads(body), httpd.hits

    assert _both(case) == (503, {"retryable": True}, 1)


class _StreamHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # noqa: A002
        pass

    def do_GET(self):  # noqa: N802
        srv = self.server
        self.send_response(200)
        self.send_header("Content-Type", "text/x-fasta")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Trailer", netio.STREAM_BYTES_TRAILER)
        self.end_headers()
        sent = 0
        for c in srv.chunks:
            self.wfile.write(b"%x\r\n" % len(c) + c + b"\r\n")
            sent += len(c)
        declared = srv.declared if srv.declared is not None else sent
        self.wfile.write(b"0\r\n" + netio.STREAM_BYTES_TRAILER.encode()
                         + b": %d\r\n\r\n" % declared)


@pytest.fixture
def stream_srv():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _StreamHandler)
    srv.daemon_threads = True
    srv.chunks = [b"aaaa", b"bbbb"]
    srv.declared = None
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    srv.url = f"http://127.0.0.1:{srv.server_address[1]}"
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("tear", ["match", "mismatch", "torn"])
def test_stream_trailer(stream_srv, tear):
    """The trailer's match, its mismatch (``TornBody`` at exhaustion) and an
    injected mid-copy tear (the bytes stop at the offset, no terminator)."""
    stream_srv.declared = 999 if tear == "mismatch" else None

    def case(mod, Plan):
        if tear == "torn":
            mod.install_faults(Plan.parse("net_torn:6@stream"))
        status, _h, gen = mod.stream(stream_srv.url + "/s", "stream")
        got = b""
        try:
            for c in gen:
                got += c
        except mod.TornBody as e:
            return status, got, ("torn", e.expected, e.got)
        return status, got, None

    status, got, err = _both(case)
    assert status == 200
    assert (got, err) == {"match": (b"aaaabbbb", None),
                          "mismatch": (b"aaaabbbb", ("torn", 999, 8)),
                          "torn": (b"aaaabb", ("torn", -1, 6))}[tear]


def test_circuit_breaker_lifecycle():
    def case(mod, Plan):
        t = [0.0]
        br = mod.CircuitBreaker(fails=2, open_s=5.0, clock=lambda: t[0])
        seq = [br.state(), br.allow(), br.fail(), br.fail(), br.state(), br.allow()]
        t[0] = 5.1
        seq += [br.state(), br.allow(), br.allow(), br.fail(), br.state(), br.allow()]
        t[0] = 10.3
        seq += [br.state(), br.allow(), br.ok(), br.state(), br.allow(), br.ok()]
        return seq

    assert _both(case) == ["closed", True, None, "open", "open", False,
                           "half-open", True, False, None, "open", False,
                           "half-open", True, "closed", "closed", True, None]


def test_netclient_breaker_opens_then_recloses(httpd):
    def case(mod, Plan):
        _fresh(httpd)
        events = []
        nc = mod.NetClient(log_event=lambda e, **kw: events.append((e, kw)),
                           retries=0, breaker_fails=1, breaker_open_s=0.2)
        mod.install_faults(Plan.parse("net_refused:1@submit"))
        out = []
        try:
            nc.request("px", httpd.url + "/v1/jobs", "submit", method="POST",
                       body=b"{}", idempotent=False)
        except mod.InjectedNetFault:
            out.append("refused")
        out.append(nc.breaker_state("px"))
        hits0 = httpd.hits
        try:
            nc.request("px", httpd.url + "/v1/jobs", "submit", method="POST", body=b"{}")
        except mod.BreakerOpen:
            out.append(("breaker_open", httpd.hits - hits0))
        time.sleep(0.25)
        status, _, _ = nc.request("px", httpd.url + "/x", "result")
        out += [status, nc.breaker_state("px"),
                [kw["state"] for e, kw in events if e == "router.breaker"],
                nc.counters["breaker_opens"]]
        return out

    assert _both(case) == ["refused", "open", ("breaker_open", 0), 200, "closed",
                           ["open", "closed"], 1]


def test_hedged_read_races_grey_slow_peer(httpd):
    """Past the p99-derived budget a second identical request races the
    wedged primary and wins (``net.hedge``)."""
    def case(mod, Plan):
        _fresh(httpd, [{"delay": 0.6}, {}])
        events = []
        nc = mod.NetClient(log_event=lambda e, **kw: events.append((e, kw)),
                           hedge_floor_s=0.05, hedge_min_samples=4)
        for _ in range(4):
            nc._note_latency("px", "result", 0.01)
        t0 = time.monotonic()
        status, _body, _ = nc.request("px", httpd.url + "/x", "result")
        fast = time.monotonic() - t0 < 0.5
        time.sleep(0.7)        # the wedged primary finishes before the next case
        return (status, fast, nc.counters["hedges"], nc.counters["hedge_wins"],
                [kw["domain"] for e, kw in events if e == "net.hedge"])

    assert _both(case) == (200, True, 1, 1, ["result"])


def test_port_stream_reads_the_port_services_trailer(tmp_path):
    """The port's ``stream`` against the port's ``serve/http.py``: a native
    job's FASTA streamed through the byte-count trailer equals its
    ``result``, and a forced mismatch of the trailer is a ``TornBody``."""
    from daccord_tpu_torch.serve import ConsensusService, ServeConfig
    from daccord_tpu_torch.serve.http import start_server
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    out = make_dataset(str(tmp_path / "d"), SimConfig(
        genome_len=800, coverage=8, read_len_mean=400, min_overlap=150, seed=5),
        name="st")
    svc = ConsensusService(ServeConfig(workdir=str(tmp_path / "w"), backend="native",
                                       backend_explicit=True, batch=64, workers=1))
    httpd, port, _ = start_server(svc, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{port}"
    try:
        st, body, _ = netio.request(url + "/v1/jobs", "submit", method="POST",
                                    body=json.dumps({"db": out["db"],
                                                     "las": out["las"]}).encode())
        assert st == 201
        jid = json.loads(body)["job"]
        st, want, head = netio.request(url + f"/v1/jobs/{jid}/result?wait=1", "result")
        assert st == 200 and want.startswith(b">") and \
            int(head[netio.BODY_BYTES_HEADER]) == len(want)
        status, rhead, gen = netio.stream(url + f"/v1/jobs/{jid}/stream")
        assert status == 200 and rhead.get("Trailer") == netio.STREAM_BYTES_TRAILER
        assert b"".join(gen) == want
        netio.install_faults(FaultPlan.parse("net_torn:10@stream"))
        _s, _h, gen = netio.stream(url + f"/v1/jobs/{jid}/stream")
        with pytest.raises(netio.TornBody):
            b"".join(gen)
    finally:
        svc.shutdown(drain=True)
        httpd.shutdown()


def test_stream_survives_the_commit_rename(tmp_path, monkeypatch):
    """The commit renames ``out.fasta.part`` to ``out.fasta`` and then marks
    the job done. A stream whose look at the part loses it to that rename
    (between the look and the open) must still deliver every byte behind a
    matching trailer: it looks at the committed file again. The JAX
    package's stream reads the part it saw exist, so there the same race
    tears the stream (an open of a vanished file) or, with the job done by
    then, ends it short behind a trailer that matches what was sent."""
    import types

    from daccord_tpu_torch.serve import http as serve_http
    from daccord_tpu_torch.serve.jobs import DONE, RUNNING

    d = tmp_path / "job"
    d.mkdir()
    part, final = d / "out.fasta.part", d / "out.fasta"
    body = b"".join(b">read%d\n%s\n" % (i, b"ACGT" * 40) for i in range(400))
    part.write_bytes(body)
    job = types.SimpleNamespace(fasta=str(final), fasta_part=str(part), state=RUNNING)
    real_open = open
    looks = []

    def racing_open(path, mode="r", *a, **kw):
        looks.append(os.path.basename(path))
        if path == str(part) and job.state == RUNNING and len(looks) > 1:
            os.replace(part, final)          # the commit, between look and open
            job.state = DONE
        return real_open(path, mode, *a, **kw)

    monkeypatch.setattr(serve_http, "open", racing_open, raising=False)

    class Svc:
        _jobs_lock = threading.Lock()
        jobs = {"j00001": job}
        aborted = []

        def status(self, job_id):
            return {"job": job_id, "state": job.state}

        def abort(self, job_id, reason=""):
            self.aborted.append(job_id)

    httpd, port, _ = serve_http.start_server(Svc(), "127.0.0.1", 0)
    try:
        status, _h, gen = netio.stream(f"http://127.0.0.1:{port}/v1/jobs/j00001/stream")
        got = b"".join(gen)              # a torn or short stream raises or differs
        assert status == 200 and got == body
        assert "out.fasta.part" in looks and looks.count("out.fasta") >= 2
        assert Svc.aborted == []
    finally:
        httpd.shutdown()
        httpd.server_close()
