"""The serving plane: ``serve``, the always-on consensus service.

The port's copy of the JAX package's ``serve/`` core. An HTTP/JSON front
end takes concurrent correction jobs; a cross-job batcher merges their
window streams into shared full-width device batches (legal because every
window solves on its own); admission control with per-tenant quotas and
RSS and free-disk watermarks sheds load; a warm-state manager keeps each
solve group (its ladder on the card, its CUDA graphs, its dispatcher
thread, its supervisor and audit workers) resident across jobs.

    http.py       stdlib HTTP/JSON front end (path or upload jobs, streamed
                  results, metrics, graceful shutdown)
    service.py    ConsensusService: job registry, worker pool, ticker (stale
                  pool flush, pressure shed, idle eviction), journal replay,
                  per-job leases and peer takeover, the announce lease
    admission.py  per-tenant quotas, RSS and free-disk watermarks
    jobs.py       job spec and config (the CLI's defaults), the per-job
                  pipeline runner with its durable streaming commit
    batcher.py    SolveGroup (one shared supervised solve path per solve
                  fingerprint) and the cross-job row pools
    state.py      WarmState: the solve-group cache with idle eviction
    journal.py    the write-ahead job journal (fsync'd lifecycle records,
                  torn-tail-tolerant replay, idempotency-key memory,
                  compaction)
    netio.py      the HTTP choke point every router, autoscaler and client
                  call rides (deadlines, transient-only retries, the
                  per-peer circuit breaker, hedged reads, the body and
                  stream byte counts)
    router.py     the stateless front door: peers from the announce leases,
                  rendezvous stickiness, spill, proxying with idempotency
                  keys
    autoscale.py  the SLO-burn autoscaler inside the router: spawns, drains
                  and reaps serve peers
    aotcache.py   the fleet-shared cache of the nvcc-built kernel libraries
                  (``--aot-cache``)

Byte contract: every job's FASTA is byte-identical to a solo ``daccord``
run over the same inputs and config, under the fault and capacity matrix
(device loss, a device OOM bisecting a mixed batch, aborts) and the crash
matrix (a kill at every lifecycle point, journal replay, peer takeover),
and through the router (a peer killed mid-proxy: the client's retry with
the same idempotency key lands exactly once on the survivor).
"""

from .admission import AdmissionConfig, AdmissionController, AdmissionReject
from .aotcache import AotCache
from .autoscale import AutoscaleConfig, Autoscaler
from .batcher import JobAborted, JobSolver, SolveGroup
from .jobs import Job, JobSpec, build_job_config, solve_fingerprint
from .journal import JobJournal, JournalEntry
from .router import Router, RouterConfig
from .service import ConsensusService, ServeConfig
from .state import WarmState

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionReject", "AotCache",
    "AutoscaleConfig", "Autoscaler", "ConsensusService", "Job", "JobAborted",
    "JobJournal", "JobSolver", "JobSpec", "JournalEntry", "Router",
    "RouterConfig", "ServeConfig", "SolveGroup", "WarmState",
    "build_job_config", "solve_fingerprint",
]
