"""Admission control: per-tenant quotas, RSS and free-disk watermarks.

The port's copy of the JAX package's ``serve/admission.py``.

Admission is the OUTER pressure valve, deliberately ahead of the two the
pipeline already has: the serve watermarks should sit below the governor's
feeder watermarks (``DACCORD_GOV_RSS_*``), so a loaded server stops taking
NEW work before any running job's feeder has to pause, and the OS OOM killer
never gets a vote. Per-tenant quotas (queued jobs, queued input bytes) keep
one tenant from monopolizing the queue; the shed path (the service halving
group batch widths under sustained pressure — the capacity governor's batch
ladder as overload policy) degrades throughput, never correctness.

Every decision is counted and logged (``serve.admit`` / ``serve.reject``)
so a capacity report can reconstruct exactly what was shed and why.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..runtime.governor import host_rss_mb


class AdmissionReject(Exception):
    """Admission refused: ``reason`` is machine-readable (quota_jobs,
    quota_bytes, queue_full, pressure, disk_pressure, draining);
    ``retryable`` hints the HTTP layer between 429/503/507 (back off and
    retry) and 400-class refusals."""

    def __init__(self, reason: str, detail: str = "", retryable: bool = True):
        super().__init__(detail or reason)
        self.reason = reason
        self.retryable = retryable


@dataclass
class AdmissionConfig:
    max_queued_jobs: int = 32        # service-wide queue depth
    tenant_max_queued: int = 8       # queued+running jobs per tenant
    tenant_max_bytes: int = 1 << 30  # queued input bytes per tenant
    rss_soft_mb: float = 0.0         # pause admission at this host RSS
    rss_hard_mb: float = 0.0         # reject + shed at this host RSS
                                     # (0 = watermark off)
    # free-bytes watermarks, mirroring the RSS pair: admission
    # pauses when the watched volume's free space sinks to soft, and the
    # service's disk-pressure governor engages at hard. 0 = off.
    disk_soft_mb: float = 0.0
    disk_hard_mb: float = 0.0
    watch_dir: str = ""              # the volume the watermarks read
                                     # (the serve workdir; "" = off)


@dataclass
class _Tenant:
    queued: int = 0
    bytes: int = 0
    admitted: int = 0
    rejected: int = 0
    extra: dict = field(default_factory=dict)


class AdmissionController:
    def __init__(self, cfg: AdmissionConfig | None = None, log=None,
                 faults=None):
        from ..utils.obs import NullLogger

        self.cfg = cfg or AdmissionConfig()
        self.log = log if log is not None else NullLogger()
        self.faults = faults
        self._lock = threading.Lock()
        self._tenants: dict[str, _Tenant] = {}
        self._queued = 0
        self._draining = False
        self.counters = {"admitted": 0, "rejected": 0, "shed": 0}
        # disk-pressure latch: the service sets this to a detail
        # string when the journal's own appends start failing (the watermark
        # may not have seen it coming — ENOSPC can arrive first) and clears
        # it once the volume recovers; any non-None value refuses admission
        # with the 507-style ``disk_pressure`` reason
        self.disk_pressure: str | None = None

    def drain(self) -> None:
        """Stop admitting (graceful shutdown); running jobs finish."""
        self._draining = True

    def disk_level(self) -> tuple[str | None, float]:
        """(level, free_mb) of the watched volume against the free-bytes
        watermarks, mirroring :meth:`pressure_level`; (None, -1.0) when the
        watermarks are off or the volume is unreadable."""
        from ..utils.obs import disk_free_mb

        cfg = self.cfg
        if not cfg.watch_dir or not (cfg.disk_soft_mb or cfg.disk_hard_mb):
            return None, -1.0
        free = disk_free_mb(cfg.watch_dir)
        if free < 0:
            return None, free
        if cfg.disk_hard_mb and free <= cfg.disk_hard_mb:
            return "hard", free
        if cfg.disk_soft_mb and free <= cfg.disk_soft_mb:
            return "soft", free
        return None, free

    def pressure_level(self) -> tuple[str | None, float]:
        """(level, rss_mb) against the ADMISSION watermarks. The injected
        ``host_rss`` fault reports hard pressure deterministically (same
        counter domain the pipeline's feeder watermark consumes — in a serve
        process the admission check runs first, so the injection lands
        here)."""
        if self.faults is not None and self.faults.host_rss_check():
            return "hard", host_rss_mb()
        cfg = self.cfg
        if not (cfg.rss_soft_mb or cfg.rss_hard_mb):
            return None, 0.0
        rss = host_rss_mb()
        if cfg.rss_hard_mb and rss >= cfg.rss_hard_mb:
            return "hard", rss
        if cfg.rss_soft_mb and rss >= cfg.rss_soft_mb:
            return "soft", rss
        return None, rss

    def admit(self, tenant: str, nbytes: int, job: str = "") -> None:
        """Charge ``tenant`` for one queued job of ``nbytes`` input, or
        raise :class:`AdmissionReject`. Pair with :meth:`release`."""
        with self._lock:
            t = self._tenants.setdefault(tenant, _Tenant())
            reason = None
            if self._draining:
                reason = "draining"
            elif self.disk_pressure is not None \
                    or self.disk_level()[0] is not None:
                # the volume is (or is about to be) full: both the journal-
                # failure latch and the free-bytes watermarks refuse new
                # work with the machine-readable 507-style reason — running
                # jobs keep their already-charged quota and finish
                reason = "disk_pressure"
            else:
                level, rss = self.pressure_level()
                if level is not None:
                    # admission pauses BEFORE the feeder watermarks engage:
                    # both levels refuse new work; hard additionally drives
                    # the service's shed ladder (service ticker)
                    reason = "pressure"
                    self.counters["shed"] += 1
                elif self._queued >= self.cfg.max_queued_jobs:
                    reason = "queue_full"
                elif t.queued >= self.cfg.tenant_max_queued:
                    reason = "quota_jobs"
                elif t.bytes + nbytes > self.cfg.tenant_max_bytes:
                    reason = "quota_bytes"
            if reason is not None:
                t.rejected += 1
                self.counters["rejected"] += 1
                self.log.log("serve.reject", tenant=tenant, reason=reason,
                             job=job, bytes=int(nbytes))
                detail = f"tenant {tenant!r}: {reason}"
                if reason == "disk_pressure" and self.disk_pressure:
                    detail += f" ({self.disk_pressure})"
                raise AdmissionReject(
                    reason, detail,
                    retryable=reason in ("pressure", "disk_pressure",
                                         "queue_full", "quota_jobs",
                                         "quota_bytes"))
            t.queued += 1
            t.bytes += int(nbytes)
            t.admitted += 1
            self._queued += 1
            self.counters["admitted"] += 1
            self.log.log("serve.admit", tenant=tenant, job=job,
                         bytes=int(nbytes), queued=self._queued)

    def release(self, tenant: str, nbytes: int) -> None:
        with self._lock:
            t = self._tenants.get(tenant)
            if t is None:
                return
            t.queued = max(0, t.queued - 1)
            t.bytes = max(0, t.bytes - int(nbytes))
            self._queued = max(0, self._queued - 1)

    def stats(self) -> dict:
        with self._lock:
            return {**self.counters, "queued": self._queued,
                    "draining": self._draining,
                    "disk_pressure": bool(self.disk_pressure),
                    "tenants": {k: {"queued": t.queued, "bytes": t.bytes,
                                    "admitted": t.admitted,
                                    "rejected": t.rejected}
                                for k, t in sorted(self._tenants.items())}}
