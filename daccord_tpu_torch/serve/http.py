"""HTTP/JSON front-end for the consensus service (stdlib only).

The port's copy of the JAX package's ``serve/http.py``:
``ThreadingHTTPServer`` + JSON bodies, no new dependencies. The API surface:

    POST   /v1/jobs             submit a job (JSON: db/las paths or
                                base64 ``files`` upload + config knobs);
                                201 {job, state} | 400 bad spec/ingest |
                                429 quota | 503 pressure/draining |
                                507 disk_pressure (the volume is — or is
                                about to be — full; retryable).
                                ``idempotency_key``: a seen key
                                answers 200 with the EXISTING job — the
                                retry path for clients whose 201 was lost
                                to a server crash (keys ride the journal,
                                so dedupe survives restarts)
    GET    /v1/jobs             all jobs' status
    GET    /v1/jobs/<id>        one job's status (404 unknown)
    GET    /v1/jobs/<id>/result the committed FASTA; ``?wait=1`` blocks to
                                a terminal state first (409 if not done)
    GET    /v1/jobs/<id>/stream chunked live FASTA as fragments commit; a
                                client disconnect mid-stream ABORTS the job
                                (the poison-free abort path the batcher
                                guarantees — cohabiting jobs unaffected)
    DELETE /v1/jobs/<id>        abort
    GET    /v1/healthz          liveness + uptime + queue depth + per-group
                                busy flags + RSS (lock-free: never queues
                                behind a group solve)
    GET    /v1/metrics          registry rollup (latency quantiles),
                                admission + warm-state + batcher stats;
                                ``?format=prom`` = Prometheus text
                                exposition of the same registry; on the
                                card also ``device`` (allocated bytes,
                                graphs, kernel launch counts)
    POST   /v1/shutdown         graceful drain + stop

Streaming reads the job's ``out.fasta.part`` as it grows — the runner
flushes after every emitted read, so the stream tracks pipeline progress at
read granularity with no extra buffering layer.

The integrity header and trailer names come from ``serve/netio.py``, whose
client (``request``, ``stream``) checks them: the router proxies through it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .admission import AdmissionReject
from .jobs import ABORTED, DONE, FAILED
from .netio import BODY_BYTES_HEADER, STREAM_BYTES_TRAILER


def _json_bytes(obj) -> bytes:
    return (json.dumps(obj) + "\n").encode()


class ServeHandler(BaseHTTPRequestHandler):
    # the service is attached to the server object by serve()
    protocol_version = "HTTP/1.1"

    @property
    def svc(self):
        return self.server.service  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # stdlib default spams stderr
        pass

    # -- helpers ---------------------------------------------------------

    def _send(self, code: int, obj=None, body: bytes | None = None,
              ctype: str = "application/json") -> None:
        payload = body if body is not None else _json_bytes(obj)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        # end-to-end integrity: unlike Content-Length, this
        # survives proxies that re-frame the body — netio verifies it and
        # turns a torn response into a retryable error, not a short commit
        self.send_header(BODY_BYTES_HEADER, str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _body_json(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b"{}"
        obj = json.loads(raw.decode() or "{}")
        if not isinstance(obj, dict):
            raise ValueError("body must be a JSON object")
        return obj

    def _job_route(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        # ['v1', 'jobs', '<id>', maybe 'result'|'stream']
        if len(parts) >= 3 and parts[0] == "v1" and parts[1] == "jobs":
            return parts[2], (parts[3] if len(parts) > 3 else None)
        return None, None

    def _query(self) -> dict:
        if "?" not in self.path:
            return {}
        out = {}
        for kv in self.path.split("?", 1)[1].split("&"):
            k, _, v = kv.partition("=")
            out[k] = v
        return out

    # -- routes ----------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802 (stdlib casing)
        path = self.path.split("?")[0]
        if path == "/v1/jobs":
            try:
                body = self._body_json()
            except (ValueError, json.JSONDecodeError) as e:
                return self._send(400, {"error": f"bad body: {e}"})
            try:
                st = self.svc.submit(body)
            except AdmissionReject as e:
                # 507 Insufficient Storage for the disk-pressure governor:
                # machine-readable, retryable — clients back
                # off until the volume recovers
                if e.reason == "disk_pressure":
                    code = 507
                elif e.reason in ("pressure", "draining"):
                    code = 503
                else:
                    code = 429
                return self._send(code, {"error": str(e), "reason": e.reason,
                                         "retryable": e.retryable})
            except (ValueError, TypeError) as e:
                # TypeError covers wrong-typed spec fields (e.g. "k" sent
                # as a JSON string): a malformed request must get a 400,
                # never a dropped connection
                return self._send(400, {"error": str(e)})
            # an idempotency_key replay answers with the EXISTING job
            # (200, not 201 — nothing was created); see service.submit
            return self._send(200 if st.get("idempotent") else 201, st)
        if path == "/v1/shutdown":
            # drain in a side thread: the response must make it out before
            # the listener stops accepting
            threading.Thread(target=self._shutdown_later,
                             daemon=True).start()
            return self._send(200, {"state": "draining"})
        self._send(404, {"error": "unknown route"})

    def _shutdown_later(self) -> None:
        self.svc.shutdown(drain=True)
        self.server.shutdown()  # type: ignore[attr-defined]

    def do_GET(self) -> None:  # noqa: N802
        path = self.path.split("?")[0]
        if path == "/v1/healthz":
            # lock-free-ish liveness: must never queue behind a group's
            # solve lock
            if self.headers.get("X-Daccord-Router"):
                # a front-door router is polling us: arm the
                # evict-vs-route grace so the idle sweep defers evicting
                # groups the router's stickiness still points at
                self.svc.warm.note_router_heartbeat()
            return self._send(200, self.svc.health())
        if path == "/v1/metrics":
            if self._query().get("format") == "prom":
                # Prometheus text exposition: the scrapeable
                # health plane — registry + health/admission gauges through
                # obs.render_prom, no group solve lock taken
                return self._send(200, body=self.svc.stats_prom().encode(),
                                  ctype="text/plain; version=0.0.4")
            return self._send(200, self.svc.stats())
        if path == "/v1/jobs":
            with self.svc._jobs_lock:
                out = [j.status() for j in self.svc.jobs.values()]
            return self._send(200, out)
        job_id, sub = self._job_route()
        if job_id is None:
            return self._send(404, {"error": "unknown route"})
        st = self.svc.status(job_id)
        if st is None:
            return self._send(404, {"error": f"unknown job {job_id!r}"})
        if sub is None:
            return self._send(200, st)
        if sub == "result":
            q = self._query()
            if q.get("wait"):
                try:
                    timeout_s = float(q.get("timeout", 300))
                except ValueError:
                    return self._send(400,
                                      {"error": "timeout must be a number"})
                st = self.svc.wait(job_id, timeout_s=timeout_s)
            if st["state"] != DONE:
                code = 409 if st["state"] not in (FAILED, ABORTED) else 410
                return self._send(code, st)
            with self.svc._jobs_lock:
                job = self.svc.jobs[job_id]
            with open(job.fasta, "rb") as fh:
                data = fh.read()
            return self._send(200, body=data, ctype="text/x-fasta")
        if sub == "stream":
            return self._stream(job_id)
        self._send(404, {"error": f"unknown subresource {sub!r}"})

    def _stream(self, job_id: str) -> None:
        """Chunked live FASTA; client disconnect aborts the job (the
        mid-job-disconnect contract: the batcher drops its pooled rows,
        cohabiting batches finish untouched)."""
        with self.svc._jobs_lock:
            job = self.svc.jobs[job_id]
        self.send_response(200)
        self.send_header("Content-Type", "text/x-fasta")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Trailer", STREAM_BYTES_TRAILER)
        self.end_headers()

        def chunk(data: bytes) -> None:
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

        def read_at(pos: int) -> bytes:
            # the committed file, else the part, else the committed file
            # again: the commit renames the part (atomically) and only then
            # marks the job done, so a look that missed both files across
            # the rename finds the bytes on its third try. (A look at the
            # part alone could lose the part to the rename between its
            # exists() and its open(): a torn stream, or with the job
            # already done a short one behind a matching trailer.)
            for src in (job.fasta, job.fasta_part, job.fasta):
                try:
                    with open(src, "rb") as fh:
                        fh.seek(pos)
                        return fh.read(1 << 20)
                except FileNotFoundError:
                    continue
            return b""

        pos = 0
        try:
            while True:
                done = job.state in (DONE, FAILED, ABORTED)
                data = read_at(pos)
                if data:
                    chunk(data)
                    pos += len(data)
                    continue
                if done:
                    break
                time.sleep(0.05)
            # terminal chunk + byte-count trailer: a consumer (the router's
            # verified proxy, netio.stream) that got fewer bytes knows the
            # stream tore — a short FASTA must never look complete
            self.wfile.write(b"0\r\n" + STREAM_BYTES_TRAILER.encode()
                             + b": %d\r\n\r\n" % pos)
        except (BrokenPipeError, ConnectionResetError):
            self.svc.abort(job_id, reason="disconnect")
            self.close_connection = True

    def do_DELETE(self) -> None:  # noqa: N802
        job_id, sub = self._job_route()
        if job_id is None or sub is not None:
            return self._send(404, {"error": "unknown route"})
        ok = self.svc.abort(job_id, reason="delete")
        st = self.svc.status(job_id)
        if st is None:
            return self._send(404, {"error": f"unknown job {job_id!r}"})
        return self._send(200 if ok else 409, st)


def start_server(service, host: str = "127.0.0.1", port: int = 0):
    """Bind + start the HTTP front-end on a daemon thread; returns
    ``(httpd, bound_port, thread)``. ``port=0`` binds an ephemeral port —
    pair with a ready-file so scripts can discover it."""
    httpd = ThreadingHTTPServer((host, port), ServeHandler)
    httpd.daemon_threads = True
    httpd.service = service  # type: ignore[attr-defined]
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="daccord-serve-http")
    t.start()
    return httpd, httpd.server_address[1], t
