"""Capacity governor: bounded, byte-identical degradation under memory
exhaustion.

The port's copy of ``daccord_tpu/runtime/governor.py``. On the card the
capacity class is ``torch.cuda.OutOfMemoryError`` (the caching allocator's
"CUDA out of memory"); the port's ladder compacts its escalation tiers to
their real count, so it has no esc-cap program to clamp and the governor
runs without the clamp rung (the bisect floor then hands over to the
failover engine).

At north-star scale (B=2048 x D=32 batches, M=256 quadratic rescue DP,
fleets on shared hosts) capacity faults are the *expected* failure, not the
exotic one — yet before this module a deterministic HBM OOM was classified
like a transient dispatch error: the supervisor burned its whole backoff
ladder re-dispatching the identical doomed shape, then failed over to the
CPU engine *permanently*, losing the chip for the rest of the shard. The
governor turns that into a walk down a degradation ladder whose every rung
is byte-identical by per-window independence (the same argument as the
two-stream split ladder — re-batching a window cannot change its bytes):

    capacity-classified op (XLA RESOURCE_EXHAUSTED / allocator OOM)
      └▶ BISECT    the retained WindowBatch re-dispatches as width-W chunks,
                   W walking B → B/2 → … → min_width (shape-keyed, so the
                   shrunken shapes reuse/record compile fingerprints)
           └▶ CLAMP    the esc-cap-clamped ladder program (rescue lanes at
                       ``esc_clamp`` slots instead of full width — the M=256
                       quadratic DP dominates HBM) + host-routed completion
                       of any overflowed rows (split-ladder semantics)
                └▶ NATIVE FAILOVER    demoted to last resort (the supervisor
                                      engages it only when the ladder is
                                      exhausted)

The working rung is **ratcheted** per shape fingerprint — recorded next to
the compile-fingerprint registry — so later batches of that shape dispatch
at the known-good width directly: zero full-width re-dispatches of a shape
already classified as capacity-faulted. An opt-in probation re-probe
(``probation=N``) restores full width after N clean reduced dispatches
(mirrors the supervisor's failback).

The module also hosts the two host-side capacity guards the pipeline wires
in: the RSS watermark (:func:`check_host_pressure` — backpressure that
force-flushes rescue pools + partial buckets before the OS OOM-killer gets
a vote) and the monster-pile guard (:func:`CapacityGovernor` is not
involved; the pipeline budgets pile overlap counts BEFORE the quadratic
windowing/realignment spend and routes busted piles through the PR-2
quarantine machinery).

Deterministic on CPU via ``DACCORD_FAULT=device_oom:N|host_rss:N|
monster_pile:N`` (``runtime/faults.py``); every decision emits a
``governor.*`` event (schema: ``tools/eventcheck.py``).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass

import numpy as np

from .faults import FaultDeviceOOM


class CapacityError(RuntimeError):
    """A device op failed for lack of memory. Deterministic for a given
    shape — re-dispatching the identical batch would fail identically — so
    the supervisor must NOT spend its transient retry ladder on it; the
    governor's degradation ladder is the remedy."""

    def __init__(self, msg: str, width: int = 0):
        super().__init__(msg)
        self.width = width


#: substrings that classify an exception as a capacity fault. XLA surfaces
#: HBM exhaustion as ``RESOURCE_EXHAUSTED: Out of memory while trying to
#: allocate ...``; host allocators raise MemoryError or "failed to
#: allocate" strings. Deliberately conservative — a misclassified transient
#: would skip the retry ladder, which only costs a shrink; a misclassified
#: capacity fault would burn the ladder on a doomed shape.
_CAPACITY_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                     "OUT_OF_MEMORY", "Out of memory", "out of memory",
                     "Failed to allocate", "failed to allocate",
                     "Attempting to allocate")


def is_capacity_error(exc: BaseException) -> bool:
    """True when ``exc`` is a memory-exhaustion fault (injected or real):
    ``torch.cuda.OutOfMemoryError`` and host ``MemoryError`` included."""
    if isinstance(exc, (CapacityError, FaultDeviceOOM, MemoryError)):
        return True
    oom = getattr(getattr(sys.modules.get("torch"), "cuda", None), "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    return any(m in f"{exc}" for m in _CAPACITY_MARKERS)


from ..utils.obs import env_float as _env_num


@dataclass
class GovernorConfig:
    min_width: int = 8        # bisect floor: below this the clamp rung (or
                              # native failover) takes over — a width-1
                              # batch that still OOMs is not a batching
                              # problem
    esc_clamp: int = 256      # rescue-lane slots of the clamped ladder
                              # program (the B/8-at-B=2048 experiment row);
                              # also the effective width the clamp reports
                              # to the fault plan — the M=256 quadratic DP
                              # over the rescue lanes dominates the
                              # program's HBM, not the B tier-0 rows
    probation: int = 0        # 0 = ratchets are sticky for the run; N>0 =
                              # after N clean reduced solves of a shape,
                              # re-probe full width once (restore on
                              # success — mirrors supervisor failback)
    rss_soft_mb: float = 0.0  # host RSS watermarks (0 = off): soft force-
    rss_hard_mb: float = 0.0  # flushes pools/partial buckets, hard also
                              # drains every in-flight batch
    persist: bool = True      # record ratchets in the compile-cache
                              # registry dir so later runs on this host
                              # dispatch at the known-good width directly

    @classmethod
    def from_env(cls, **overrides) -> "GovernorConfig":
        cfg = cls(
            min_width=int(_env_num("DACCORD_GOV_MIN_WIDTH", 8)),
            esc_clamp=int(_env_num("DACCORD_GOV_ESC_CLAMP", 256)),
            probation=int(_env_num("DACCORD_GOV_PROBATION", 0)),
            rss_soft_mb=_env_num("DACCORD_GOV_RSS_SOFT_MB", 0.0),
            rss_hard_mb=_env_num("DACCORD_GOV_RSS_HARD_MB", 0.0),
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


# ---------------------------------------------------------------------------
# ratchet persistence (beside the compile-fingerprint registry: both answer
# "what do we already know about this shape on this host?")
# ---------------------------------------------------------------------------

def _ratchet_path() -> str | None:
    from ..utils.obs import compcache_dir

    d = compcache_dir()
    return os.path.join(d, "daccord_capacity.json") if d else None


def load_ratchets() -> dict:
    """Raw registry entries. A NEGATIVE width marks a shape whose working
    rung is the clamped program (the bisect floor still OOMed): the next
    run must re-engage the clamp directly, not re-dispatch the unclamped
    program at a width known to OOM."""
    p = _ratchet_path()
    if p is None or not os.path.exists(p):
        return {}
    try:
        with open(p) as fh:
            d = json.load(fh)
        return {str(k): int(v) for k, v in d.items()} if isinstance(d, dict) else {}
    except (OSError, json.JSONDecodeError, ValueError, TypeError):
        return {}


def _with_ratchets(mutate) -> None:
    """Cross-process-safe read-modify-write of the ratchet registry: fleet
    workers on one host share the compcache dir, and an unlocked load/store
    pair would drop each other's entries (the lost shape re-dispatches full
    width next run and must re-OOM to reclassify). flock on a sidecar
    lockfile; best-effort throughout — same doctrine as record_fingerprint,
    a read-only cache dir must never sink a run."""
    p = _ratchet_path()
    if p is None:
        return
    try:
        import fcntl

        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p + ".lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            r = load_ratchets()
            if mutate(r) is False:
                return
            tmp = f"{p}.tmp.{os.getpid()}"
            with open(tmp, "wt") as fh:
                json.dump(r, fh)
            os.replace(tmp, p)
    except OSError:
        pass


def record_ratchet(key: str, width: int) -> None:
    def _set(r: dict):
        if r.get(key) == width:
            return False
        r[key] = int(width)

    _with_ratchets(_set)


def clear_ratchet(key: str) -> None:
    def _del(r: dict):
        if key not in r:
            return False
        del r[key]

    _with_ratchets(_del)


# ---------------------------------------------------------------------------
# result merging: the one reason the bisect is byte-identical — every
# window solves independently, so concatenating chunk results in row order
# reconstructs the full-width result exactly
# ---------------------------------------------------------------------------

def merge_results(parts: list) -> dict:
    """Merge ``(live_rows, result_dict)`` chunks back into one full-width
    result. Array fields concatenate (each chunk trimmed to its live rows —
    governor pad rows are discarded); numeric scalars (``esc_overflow``)
    sum; anything else takes the first chunk's value."""
    if len(parts) == 1:
        n, out = parts[0]
        first = next((np.asarray(v) for v in out.values()
                      if isinstance(v, np.ndarray) and np.asarray(v).ndim >= 1),
                     None)
        if first is None or len(first) == n:
            return out
    merged: dict = {}
    for k, v0 in parts[0][1].items():
        try:
            a0 = np.asarray(v0)
        except Exception:
            merged[k] = v0
            continue
        if a0.ndim >= 1 and a0.shape[0] >= parts[0][0]:
            arrs = [np.asarray(o[k])[:n] for n, o in parts]
            if any(a.shape[1:] != arrs[0].shape[1:] for a in arrs):
                # engines may size trailing dims per batch (the native
                # ladder sizes cons to the batch's longest consensus): pad
                # to the widest — padded cells sit past cons_len/lens and
                # are never read
                tgt = tuple(max(a.shape[d] for a in arrs)
                            for d in range(1, arrs[0].ndim))
                arrs = [np.pad(a, [(0, 0)] + [(0, t - s) for t, s
                                              in zip(tgt, a.shape[1:])])
                        for a in arrs]
            merged[k] = np.concatenate(arrs, axis=0)
        elif a0.ndim == 0 and a0.dtype.kind in "iuf":
            merged[k] = int(sum(int(np.asarray(o[k])) for _, o in parts)) \
                if a0.dtype.kind in "iu" else \
                float(sum(float(np.asarray(o[k])) for _, o in parts))
        else:
            merged[k] = v0
    return merged




class CapacityGovernor:
    """Walks the degradation ladder for one supervisor.

    ``solve_width_fn(batch)`` runs one guarded dispatch+fetch of ``batch``
    at its own width (the supervisor provides it, so shrunk shapes get real
    compile classification, retries, and fault injection) and raises
    :class:`CapacityError` when that width does not fit. ``clamp_solve_fn``
    (optional) solves a batch on the esc-cap-clamped program — the rung
    between the bisect floor and native failover.
    """

    def __init__(self, solve_width_fn, *, log=None,
                 cfg: GovernorConfig | None = None, clamp_solve_fn=None,
                 tracer=None, quantum_fn=None):
        from ..utils.obs import NullLogger, Tracer

        self._solve = solve_width_fn
        self._clamp = clamp_solve_fn
        # mesh-aware bisect (parallel/mesh.py): ``quantum_fn() -> N`` makes
        # every rung width a multiple of the mesh width and scales the floor
        # per device (min_width rows PER DEVICE, not per batch) — the OOM is
        # a per-device-slice property, and a non-multiple width would just
        # pad back up to one inside the solver. Callable because the
        # partial-mesh rung changes N mid-run.
        self._quantum_fn = quantum_fn
        self.cfg = cfg or GovernorConfig.from_env()
        self.log = log if log is not None else NullLogger()
        # governor-rung trace spans: each ladder-rung chunk solve
        # is bracketed so daccord-trace can attribute the degraded wall
        self.tracer = tracer if tracer is not None else Tracer(None)
        self.ratchet: dict[str, int] = {}
        self._loaded = False
        self._touched: set[str] = set()       # keys ratcheted/applied THIS run
        self._clamped: set[str] = set()       # keys whose working rung is the clamp
        self._since_probe: dict[str, int] = {}
        self.counters = {"classify": 0, "shrink": 0, "clamp": 0,
                         "ratchet": 0, "restore": 0, "chunks": 0}

    # -- ratchet state ----------------------------------------------------

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self._loaded = True
            if self.cfg.persist:
                for k, w in load_ratchets().items():
                    if k in self.ratchet:
                        continue
                    # negative width = the clamp is this shape's working
                    # rung (load_ratchets docstring). Without a clamp
                    # program wired in, fall back to treating it as a
                    # plain width ratchet at the bisect floor.
                    if w < 0 and self._clamp is not None:
                        self._clamped.add(k)
                    self.ratchet[k] = abs(w)

    def planned_width(self, key: str, width: int) -> int | None:
        """The ratcheted dispatch width for ``key``, or None when the full
        ``width`` is (as far as we know) safe. A clamp-rung shape plans even
        at full width — its working program is the clamped one."""
        self._ensure_loaded()
        r = self.ratchet.get(key)
        if r is None:
            return None
        if key in self._clamped:
            return min(r, width)
        return r if r < width else None

    def active_state(self) -> dict:
        """Ratchet entries applied or recorded during THIS run — what shard
        manifests carry as the degradation state."""
        return {k: self.ratchet[k] for k in sorted(self._touched)
                if k in self.ratchet}

    def _note_ratchet(self, key: str, width: int, clamped: bool = False) -> None:
        was = (self.ratchet.get(key), key in self._clamped)
        if clamped:
            self._clamped.add(key)
        self._touched.add(key)
        if was == (width, clamped):
            return
        self.ratchet[key] = width
        self.counters["ratchet"] += 1
        self.log.log("governor.ratchet", key=key, width=int(width),
                     clamped=clamped)
        if self.cfg.persist:
            record_ratchet(key, -width if clamped else width)

    def _note_restore(self, key: str, width: int, ok: bool) -> None:
        self.counters["restore"] += 1
        self.log.log("governor.restore", key=key, width=int(width), ok=ok)
        if ok:
            self.ratchet.pop(key, None)
            self._clamped.discard(key)
            self._since_probe.pop(key, None)
            self._touched.add(key)
            if self.cfg.persist:
                clear_ratchet(key)

    # -- the ladder -------------------------------------------------------

    def solve(self, batch, key: str, reason: str | None = None) -> dict:
        """Solve ``batch`` down the degradation ladder; returns the merged
        full-width result. ``reason`` is the classified capacity error when
        the full-width op just failed (first rung is then B/2); None means
        a ratchet-planned reduced dispatch. Raises :class:`CapacityError`
        when the whole ladder is exhausted (caller demotes to native
        failover) and lets :class:`DeviceLostError` propagate (the chip
        died mid-walk — a different failure class)."""
        self._ensure_loaded()
        # Capacity bisect operates on the HOST batch: a staged mesh batch
        # (parallel/mesh.py StagedBatch) unwraps to its retained host-side
        # windows — the staged device buffers are width-committed and get
        # discarded here, then re-staged per rung by the dispatch path.
        batch = getattr(batch, "replay_batch", batch)
        B = int(batch.size)
        q = max(1, int(self._quantum_fn())) if self._quantum_fn else 1

        def _q_up(w: int) -> int:
            # round a proposed width up to a mesh multiple (never above B)
            return min(-(-w // q) * q, B)

        floor = max(1, min(self.cfg.min_width * q, B))
        clamped = key in self._clamped
        if reason is not None:
            self.counters["classify"] += 1
            self.log.log("governor.classify", key=key, width=B,
                         reason=str(reason)[:200])
            width = self.ratchet.get(key, B)
            proposed = _q_up(max(B // 2, floor))
            if proposed < B:
                width = min(width, proposed)
                if width < B:
                    self.counters["shrink"] += 1
                    # per_device = the capacity rung each mesh member now
                    # runs at (the OOM is a per-device-slice
                    # property, so the telemetry names the slice, not just
                    # the batch)
                    self.log.log("governor.shrink", key=key, width_from=B,
                                 width_to=int(width),
                                 **({"per_device": int(width) // q}
                                    if q > 1 else {}))
            elif clamped:
                # the clamp is already this shape's working rung: stay on it
                width = min(width, B)
            elif self._clamp is not None:
                # no bisect rung exists below the floor: straight to clamp
                clamped = True
                self.counters["clamp"] += 1
                self.log.log("governor.clamp", key=key, width=B,
                             esc_cap=int(self.cfg.esc_clamp))
                width = min(width, B)
            else:
                raise CapacityError(
                    f"degradation ladder exhausted for {key}: no bisect "
                    f"rung below floor {floor} and no clamp program",
                    width=B)
        else:
            width = min(self.ratchet.get(key, B), B)
            if (width < B and self.cfg.probation > 0
                    and self._since_probe.get(key, 0) >= self.cfg.probation):
                # opt-in probation re-probe: one full-width attempt; failure
                # re-ratchets (and resets the probation clock), success
                # restores full-width dispatching for this shape
                self._since_probe[key] = 0
                try:
                    out = self._solve(batch)
                except CapacityError:
                    self._note_restore(key, B, ok=False)
                else:
                    self._note_restore(key, B, ok=True)
                    return out
        from ..kernels.tensorize import pad_batch, slice_batch

        parts: list = []
        pos = 0
        while pos < B:
            take = min(width, B - pos)
            sub = slice_batch(batch, pos, pos + take)
            if sub.size < width:
                sub = pad_batch(sub, width)
            rung_sp = self.tracer.open("governor.rung", key=key,
                                       width=int(width), clamped=clamped)
            try:
                out = self._clamp(sub) if clamped else self._solve(sub)
            except CapacityError as e:
                self.tracer.close(rung_sp, status="capacity")
                if not clamped and width > floor:
                    new = _q_up(max(width // 2, floor))
                    self.counters["shrink"] += 1
                    self.log.log("governor.shrink", key=key,
                                 width_from=int(width), width_to=int(new),
                                 **({"per_device": int(new) // q}
                                    if q > 1 else {}))
                    width = new
                    continue
                if not clamped and self._clamp is not None:
                    clamped = True
                    self.counters["clamp"] += 1
                    self.log.log("governor.clamp", key=key, width=int(width),
                                 esc_cap=int(self.cfg.esc_clamp))
                    continue
                raise CapacityError(
                    f"degradation ladder exhausted for {key} at width "
                    f"{width}: {e}", width=width) from e
            except BaseException:
                # device loss (or anything else) mid-rung: close the span
                # here — the run continues after failover, so leaving it to
                # the end-of-run unwind would book the rest of the shard's
                # wall against this rung
                self.tracer.close(rung_sp, status="error")
                raise
            self.tracer.close(rung_sp)
            self.counters["chunks"] += 1
            parts.append((take, out))
            pos += take
        if width < B or clamped:
            self._note_ratchet(key, width, clamped=clamped)
            self._since_probe[key] = self._since_probe.get(key, 0) + 1
        return merge_results(parts)


# ---------------------------------------------------------------------------
# host watermarks (RSS backpressure) — pipeline-side capacity guard
# ---------------------------------------------------------------------------

def host_rss_mb() -> float:
    """Current resident set size in MB (Linux /proc; 0.0 when unreadable —
    the watermark then simply never engages, it must not sink a run)."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0))
    except (OSError, ValueError, IndexError):
        return 0.0


def check_host_pressure(faults, cfg: GovernorConfig) -> tuple[str | None, float, bool]:
    """One watermark check: ``(level, rss_mb, injected)`` with level in
    (None, 'soft', 'hard'). The injected ``host_rss`` fault (deterministic,
    counted per check) reports hard pressure regardless of real RSS."""
    if faults is not None and faults.host_rss_check():
        return "hard", host_rss_mb(), True
    if not (cfg.rss_soft_mb or cfg.rss_hard_mb):
        return None, 0.0, False
    rss = host_rss_mb()
    if cfg.rss_hard_mb and rss >= cfg.rss_hard_mb:
        return "hard", rss, False
    if cfg.rss_soft_mb and rss >= cfg.rss_soft_mb:
        return "soft", rss, False
    return None, rss, False
