"""Device mesh and sharded window solving.

The port of ``daccord_tpu/parallel/mesh.py``. Windows are independent, so a
batch shards on its window axis over the mesh's members: each member solves
its contiguous row slice with the whole ladder (``kernels/tiers.py``: tier 0,
the rescue tiers, their paged forms) and the slices' packed results join in
member order. Nothing crosses between members but the escalation-overflow
count, summed as the JAX program's ``psum`` sums it.

A member is a ``torch.device``. On cuda the members are the cards
:func:`visible_devices` lists, one each; tests and a one-card host replace
that function to put two members on one card. ``--device cpu --mesh N``
gives N members on the CPU, the counterpart of the JAX package's forced host
devices: no count check, :attr:`ShardedLadderSolver.host_local`, and the
supervisor runs inline. Each member has its own ladder dispatcher (a thread,
and on cuda a stream of its own and pinned result buffers per call), its own
CUDA graphs (``kernels/graphs.py`` keys them by member) and, on cuda, a copy
stream. The wire formats are the single-card path's:

- a dense ``WindowBatch`` is padded to a mesh multiple and sliced by rows;
- a paged batch shards its page table, ``lens`` and ``nsegs``, and every
  member gets the whole page pool (table entries are pool-page ids, so no
  rebasing); each member gathers its own dense tile with the kernel;
- a ``stream='tier0'`` batch (the two-stream ladder's Stream A) runs tier 0
  alone on every member; the rest run the whole ladder.

*Escalation width.* The JAX mesh fixes each member's escalation at
``esc_cap`` slots, auto-resolved once to the member's slice width, so its
compiled program reads no count. On the card a member instead runs the
single-card ladder, which reads the failure count and escalates at the
narrowest of ``graphs.widths`` that holds it: the same bytes (escalation
never overflows at the slice width), without a full-slice rescue DP every
call. An explicit ``esc_cap`` keeps the JAX semantics: the escalation runs
at that width, and failures past it are counted in ``esc_overflow``.

*Partial-mesh degradation* (``runtime/supervisor.py``): :meth:`shrink`
halves the members N -> N/2 -> ... -> 1, keeping the half without an
attributed culprit; :meth:`restore` takes them all back on failback.

*Staged dispatch*: :meth:`stage` pads and slices the batch on the host and,
on cuda, copies each member's slice on that member's copy stream (an event
ends each copy); :meth:`launch` hands the slices to the members, whose
dispatcher streams wait on those events. A :class:`StagedBatch` keeps its
host batch: a launch after the members changed (shrink or restore) stages
it again, and every replay of the supervisor works on the host batch.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..kernels.tensorize import pad_batch, slice_batch

#: what a device-count refusal tells the user to do instead
OFF_CARD_RECIPE = ("--device cpu --mesh N runs N members on the CPU; on the "
                   "card --mesh N needs N visible cards")


def visible_devices() -> list[torch.device]:
    """The cards this process sees, in order: the members of a cuda mesh.
    The one place a mesh lists its cards (tests and a one-card host replace
    it to run two members on ``cuda:0``)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _card_names(devices) -> str:
    names = []
    for d in devices:
        try:
            names.append(f"{d} {torch.cuda.get_device_name(d)}")
        except Exception:
            names.append(str(d))
    return ", ".join(names) or "none"


def check_mesh_devices(n_devices: int, platform: str = "cuda") -> None:
    """Raise ``SystemExit`` when a cuda mesh of ``n_devices`` members has
    fewer visible cards; the message names the cards there are. The one
    device-count gate of the CLI, the pipeline and the serve groups. A CPU
    mesh has no count to check."""
    if platform == "cpu" or n_devices <= 1:
        return
    vis = visible_devices()
    if len(vis) < n_devices:
        raise SystemExit(f"mesh {n_devices}: only {len(vis)} cuda device"
                         f"{'' if len(vis) == 1 else 's'} visible "
                         f"({_card_names(vis)}); {OFF_CARD_RECIPE}")


def make_mesh(n_devices: int | None = None, devices=None,
              platform: str = "cuda") -> tuple:
    """The members of a mesh of ``n_devices``, in slice order: the first of
    ``devices``, by default :func:`visible_devices` on cuda, or N members on
    the CPU. One device may appear more than once (two members on one
    card)."""
    if devices is None:
        devices = ([torch.device("cpu")] * max(int(n_devices or 1), 1)
                   if platform == "cpu" else visible_devices())
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError(f"a {platform} mesh needs at least one member")
    return tuple(devices)


class StagedBatch:
    """A batch staged onto the members ahead of its launch: each active
    member's row slice (on cuda already copied to its card, with the event
    that ends the copy) and the host batch they came from, which every
    replay uses. ``size`` and ``stream`` are the host batch's."""

    __slots__ = ("replay_batch", "parts", "members", "gen", "nd", "target", "B0",
                 "pack_s", "stage_s")

    def __init__(self, replay_batch, parts, members, gen, target, pack_s, stage_s):
        self.replay_batch = replay_batch
        self.parts = parts
        self.members = members
        self.gen = gen
        self.nd = len(members)
        self.target = target
        self.B0 = replay_batch.size
        self.pack_s = pack_s
        self.stage_s = stage_s

    @property
    def size(self) -> int:
        return self.B0

    @property
    def stream(self) -> str:
        return getattr(self.replay_batch, "stream", "full")


class _MeshHandle:
    """One sharded call in flight: each member's ladder handle, in slice
    order, and the batch's own rows. ``solve_s``/``cpu_s`` sum the
    members' calls; ``busy_s`` is the longest any one card was busy with
    them (members of one card add up), set at fetch."""

    __slots__ = ("parts", "B0", "solve_s", "cpu_s", "busy_s")

    def __init__(self, parts, B0: int):
        self.parts = parts
        self.B0 = B0
        self.solve_s = 0.0
        self.cpu_s = 0.0
        self.busy_s = 0.0


class ShardedLadderSolver:
    """Async mesh solver: ``dispatch`` returns a handle at once, ``fetch``
    waits for every member's call and joins their rows. Calling the object
    is the blocking form.

    Supervisor contract (``runtime/supervisor.py``): ``nd``, ``shrink``,
    ``restore``, ``member_ids``, ``probe_devices`` and ``host_local`` drive
    the partial-mesh rung and the ``:m<N>`` shape-key suffix;
    ``routes_streams`` and ``supports_paged`` let the pipeline's split and
    paged machinery run against it."""

    routes_streams = True
    supports_paged = True

    def __init__(self, ladder, mesh: tuple, esc_cap: int | None = None,
                 batch: int | None = None, tracer=None):
        self.ladder = ladder
        self._devices0 = list(mesh)
        self._active = list(range(len(self._devices0)))
        self._gen = 0                # bumped whenever the members change
        self.nd = len(self._active)
        self.tracer = tracer
        # per-member flight recorder, keyed by the member's index in the
        # construction-time list: dispatch wall and rows per dispatch, the
        # card's peak memory at snapshot cadence, and the state the
        # partial-mesh rung leaves it in (ok, lost, dropped)
        self.device_stats: dict[int, dict] = {
            i: {"platform": d.type, "state": "ok", "dispatches": 0,
                "dispatch_wall_s": 0.0, "rows": 0, "hbm_peak_bytes": None}
            for i, d in enumerate(self._devices0)}
        self.esc_cap = esc_cap       # explicit per-member cap (None = auto)
        self._cap_base = batch       # the width the auto cap derives from
        self._auto_cap: int | None = None
        self._ladders: dict[int, object] = {}
        self._dispatchers: dict[int, object] = {}
        self._copy_streams: dict[int, object] = {}
        self._member_busy = [0.0] * len(self._devices0)
        # each member's kernel launches on the card, by wrapper
        self.member_launches: list[dict] = [{} for _ in self._devices0]
        # stage() runs on the pipeline's staging thread, launch and fetch on
        # its own: the walls and the occupancy state below share one lock
        self._stat_lock = threading.Lock()
        self.pack_s = 0.0
        self.stage_s = 0.0
        self.launch_s = 0.0
        self.restaged = 0            # staged slices dropped and staged again
        self._outstanding = 0
        self._created_pc = time.perf_counter()
        self._stage_total_s = 0.0
        self._stage_overlap_s = 0.0

    # ---- members ---------------------------------------------------------

    @property
    def host_local(self) -> bool:
        """True when every member is the CPU: the supervisor then runs
        inline (a CPU ladder cannot hang the way a card can)."""
        return all(d.type == "cpu" for d in self._devices0)

    def member_ids(self) -> list[int]:
        """Original index of every active member, in slice order: position
        j owns rows ``[j*per, (j+1)*per)`` of a staged batch. The shadow
        audit's row map (``sdc:N@K`` finds member K's rows, a divergent
        probe row names its member)."""
        return list(self._active)

    def _rebuild(self, active: list[int]) -> None:
        self._active = list(active)
        self.nd = len(self._active)
        self._gen += 1
        if self.esc_cap is None and self._cap_base is not None:
            # the slice widened: the auto cap follows it
            self._auto_cap = max(-(-int(self._cap_base) // self.nd), 1)

    def shrink(self, culprit: int = -1) -> bool:
        """Halve the active members, keeping the half without ``culprit``
        (an original index: an injected fault names it, or the probe found
        it), else the first half. The dropped members' ``device_stats``
        rows turn ``lost`` (the culprit) or ``dropped``. False at one
        member: the supervisor then fails over whole."""
        if self.nd <= 1:
            return False
        half = self.nd // 2
        first, second = self._active[:half], self._active[half:]
        keep = second if culprit in first and culprit not in second else first
        for i in self._active:
            if i not in keep:
                self.device_stats[i]["state"] = "lost" if i == culprit else "dropped"
        self._rebuild(keep)
        return True

    def restore(self) -> None:
        """Take every member back (failback), every state ``ok`` again."""
        for row in self.device_stats.values():
            row["state"] = "ok"
        self._rebuild(range(len(self._devices0)))

    def _esc_cap_for(self, target: int) -> int:
        """The per-member escalation width of a batch of ``target`` rows:
        the explicit cap, else the slice width of the configured batch
        (resolved once), never below this batch's slice."""
        if self.esc_cap is not None:
            return self.esc_cap
        if self._auto_cap is None:
            self._cap_base = self._cap_base or target
            self._auto_cap = max(-(-int(self._cap_base) // self.nd), 1)
        return max(self._auto_cap, -(-target // self.nd))

    def _member_ladder(self, m: int):
        """Member ``m``'s ladder: the solver's own on its device, else a
        copy of its tables on the member's device."""
        lad = self._ladders.get(m)
        if lad is None:
            from ..kernels.tiers import TierLadder

            dev = self._devices0[m]
            base = self.ladder
            lad = base if base.device == dev else TierLadder(
                params=list(base.params),
                tables={k: t.to(dev) for k, t in base.tables.items()},
                wide_p0=base.wide_p0, route=base.route, graphs=base.graphs)
            self._ladders[m] = lad
        return lad

    def ladders(self) -> list:
        """The member ladders built so far (a serve group releases their
        graphs at eviction)."""
        return list(self._ladders.values())

    def _dispatcher(self, m: int):
        """Member ``m``'s dispatcher thread. The CPU members share one: the
        CPU ladder's ops use the CPU's threads already, and eight members
        contending for them ran the forced-host mesh several times slower."""
        dev = self._devices0[m]
        key = m if dev.type == "cuda" else "cpu"
        d = self._dispatchers.get(key)
        if d is None:
            from ..kernels.tiers import LadderDispatcher

            d = self._dispatchers[key] = LadderDispatcher(dev, self.tracer)
        return d

    def _copy_stream(self, m: int):
        s = self._copy_streams.get(m)
        if s is None:
            s = self._copy_streams[m] = torch.cuda.Stream(self._devices0[m])
        return s

    # ---- dispatch ----------------------------------------------------------

    def dispatch(self, batch):
        """Stage and launch (or launch a :class:`StagedBatch` the pipeline
        staged ahead). Each active member's row books the wall and its
        rows."""
        t0 = time.perf_counter()
        try:
            staged = batch if isinstance(batch, StagedBatch) else self.stage(batch)
            return self.launch(staged)
        finally:
            dt = time.perf_counter() - t0
            rows = -(-int(batch.size) // max(self.nd, 1))
            for i in self._active:
                row = self.device_stats[i]
                row["dispatches"] += 1
                row["dispatch_wall_s"] += dt
                row["rows"] += rows

    def _put(self, m: int, sub):
        """Member ``m``'s slice as the ladder reads it: on cuda its upload
        arrays copied to the card on the member's copy stream, with the
        event that ends the copy; on the CPU the host slice itself."""
        dev = self._devices0[m]
        if dev.type != "cuda":
            return sub, None, None
        from ..kernels.graphs import CACHE
        from ..kernels.tiers import upload_arrays

        # never beside a capture (another member's first call of a shape),
        # which the capture's thread-local mode does not fence off
        with CACHE.capturing:
            stream = self._copy_stream(m)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                # pageable sources: CUDA stages each copy before it
                # returns, so the host slice may go at once
                ins = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev,
                                                                       non_blocking=True)
                            for a in upload_arrays(sub))
                ev = torch.cuda.Event()
                ev.record(stream)
        return sub, ins, ev

    def stage(self, batch, prof=None) -> StagedBatch:
        """The host half of a dispatch: pad ``batch`` to a multiple of the
        active members (``pack``), slice it, and on cuda copy each slice to
        its member (``stage``). Safe on a staging thread while calls are in
        flight: the members are read once, so a concurrent shrink makes the
        launch stage again. ``prof`` (a ``StageProfile``) books both walls."""
        if isinstance(batch, StagedBatch):
            return batch
        t0 = time.perf_counter()
        overlapped = self._outstanding > 0
        members, gen = list(self._active), self._gen
        nd = len(members)
        B0 = batch.size
        target = -(-B0 // nd) * nd
        padded = pad_batch(batch, target) if target != B0 else batch
        t1 = time.perf_counter()
        per = target // nd
        parts = [self._put(m, slice_batch(padded, j * per, (j + 1) * per))
                 for j, m in enumerate(members)]
        t2 = time.perf_counter()
        dt_pack, dt_stage = t1 - t0, t2 - t1
        if prof is not None:
            prof.add("pack", dt_pack)
            prof.add("stage", dt_stage)
        with self._stat_lock:
            self.pack_s += dt_pack
            self.stage_s += dt_stage
            self._stage_total_s += dt_stage
            if overlapped or self._outstanding > 0:
                self._stage_overlap_s += dt_stage
        return StagedBatch(batch, parts, members, gen, target, dt_pack, dt_stage)

    def _submit(self, m: int, sub, inputs, ready, tier0: bool):
        """One member's call on its dispatcher thread."""
        return self._dispatcher(m).submit(
            sub, self._member_ladder(m), tier0_only=tier0, inputs=inputs, ready=ready,
            member=m, esc_cap=None if tier0 else self.esc_cap)

    def launch(self, staged: StagedBatch) -> _MeshHandle:
        """The device half: every member's call, queued on its dispatcher
        (the handle resolves at fetch). A batch staged before the members
        changed is staged again from its host batch."""
        if staged.gen != self._gen:
            self.restaged += 1
            staged = self.stage(staged.replay_batch)
        t0 = time.perf_counter()
        tier0 = staged.stream == "tier0"
        for m in staged.members:
            # every member's thread and stream exist before the first call
            # starts (a stream made while another thread captures is card
            # work beside the capture)
            self._dispatcher(m)
        parts = [(m, self._submit(m, sub, ins, ev, tier0))
                 for m, (sub, ins, ev) in zip(staged.members, staged.parts)]
        now = time.perf_counter()
        with self._stat_lock:
            self.launch_s += now - t0
            self._outstanding += 1
        return _MeshHandle(parts, staged.B0)

    def dispatch_walls(self) -> dict:
        """The host walls of the dispatches so far: ``pack_s``, ``stage_s``,
        ``launch_s``, their sum ``dispatch_s``, and ``restaged``."""
        with self._stat_lock:
            return {"pack_s": self.pack_s, "stage_s": self.stage_s,
                    "launch_s": self.launch_s,
                    "dispatch_s": self.pack_s + self.stage_s + self.launch_s,
                    "restaged": self.restaged}

    # ---- fetch -----------------------------------------------------------

    def fetch(self, handle: _MeshHandle) -> dict:
        """Wait for every member's call and join their rows in slice order
        (the escalation overflow summed), cut to the batch's own rows. A
        member's error is raised once all of them have ended."""
        from ..kernels.tiers import fetch as fetch_one

        outs, err = [], None
        by_card: dict = {}
        try:
            for m, h in handle.parts:
                try:
                    outs.append(fetch_one(h))
                except BaseException as e:  # noqa: BLE001 - raised below
                    err = err or e
                    continue
                handle.solve_s += h.solve_s
                handle.cpu_s += h.cpu_s
                dev = str(self._devices0[m])
                by_card[dev] = by_card.get(dev, 0.0) + h.busy_s
                with self._stat_lock:
                    self._member_busy[m] += h.busy_s
                    for k, n in (h.launches or {}).items():
                        ml = self.member_launches[m]
                        ml[k] = ml.get(k, 0) + n
        finally:
            with self._stat_lock:
                self._outstanding = max(0, self._outstanding - 1)
        if err is not None:
            raise err
        handle.busy_s = max(by_card.values(), default=0.0)
        out = {k: np.concatenate([o[k] for o in outs])[:handle.B0]
               for k in outs[0] if k != "esc_overflow"}
        out["esc_overflow"] = sum(int(o["esc_overflow"]) for o in outs)
        return out

    def fetch_many(self, handles) -> list[dict]:
        return [self.fetch(h) for h in handles]

    @staticmethod
    def landed(handle: _MeshHandle) -> bool:
        """Whether every member's call of ``handle`` has landed
        (``tiers.landed``): its :meth:`fetch` would not wait."""
        from ..kernels.tiers import landed

        return all(landed(h) for _, h in handle.parts)

    def __call__(self, batch) -> dict:
        return self.fetch(self.dispatch(batch))

    # ---- health ----------------------------------------------------------

    def health_map(self) -> dict:
        """The mesh's health for metrics snapshots: the active and the
        construction width, and per member (by original index) its state,
        dispatch wall, rows, card peak memory, ``busy_frac`` (the member's
        calls' own spans on its engine over the solver's life),
        ``idle_frac``, its kernel ``launches`` on the card by wrapper, and
        ``overlap_frac`` (the staging wall that ran while
        a call was in flight, over all staging wall; one batch feeds every
        member, so it is the same for each)."""
        from ..utils.obs import device_peak_bytes

        for i, d in enumerate(self._devices0):
            if d.type == "cuda":
                self.device_stats[i]["hbm_peak_bytes"] = device_peak_bytes(d)
        el = max(time.perf_counter() - self._created_pc, 1e-9)
        with self._stat_lock:
            ovr = (round(self._stage_overlap_s / self._stage_total_s, 4)
                   if self._stage_total_s > 0 else None)
            busy = list(self._member_busy)
            launches = [dict(ml) for ml in self.member_launches]
        out = {}
        for i, row in self.device_stats.items():
            b = min(busy[i] / el, 1.0)
            out[i] = dict(row, busy_frac=round(b, 4), idle_frac=round(1.0 - b, 4),
                          overlap_frac=ovr, launches=launches[i])
        return {"nd": int(self.nd), "nd0": len(self._devices0), "devices": out}

    def probe_devices(self, timeout_s: float = 15.0) -> list[int]:
        """Original indexes of active members that fail a tiny op on their
        device, all probed at once against one shared deadline (a wedged
        card costs ``timeout_s`` once, not once a member). Members of one
        card share its fate: a real loss takes them all."""
        probes = []
        for i in self._active:
            ok: list = []

            def work(dev=self._devices0[i], ok=ok):
                try:
                    t = torch.zeros(8, dtype=torch.int32, device=dev)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    ok.append(int(t.sum()) == 0)
                except Exception:
                    pass

            t = threading.Thread(target=work, daemon=True, name="mesh-probe")
            t.start()
            probes.append((t, ok, i))
        deadline = time.monotonic() + timeout_s
        dead = []
        for t, ok, i in probes:
            t.join(max(0.0, deadline - time.monotonic()))
            if not ok:
                dead.append(i)
        return dead

    def describe(self) -> str:
        """Short engine tag for supervisor events."""
        kinds = {self._devices0[i].type for i in self._active}
        return f"mesh{self.nd}-{'/'.join(sorted(kinds))}-ladder"

    def close(self) -> None:
        """Stop the members' dispatcher threads."""
        for d in self._dispatchers.values():
            d.close()


def make_sharded_solver(ladder, mesh: tuple, esc_cap: int | None = None,
                        batch: int | None = None, tracer=None) -> ShardedLadderSolver:
    """The whole ladder sharded over ``mesh``, as an async solver
    (``dispatch``/``fetch``/``fetch_many``). ``esc_cap`` is an explicit
    per-member escalation width (None: the count-read ladder, see the
    module docstring); ``batch`` the configured dispatch width the auto cap
    derives from. ``PipelineConfig.mesh`` builds one in the pipeline."""
    return ShardedLadderSolver(ladder, mesh, esc_cap, batch=batch, tracer=tracer)


def build_sharded_solver(n_devices: int, profile, consensus_cfg,
                         esc_cap: int | None = None, max_kmers: int = 64,
                         rescue_max_kmers: int = 256, overflow_rescue: bool = False,
                         batch: int | None = None, device: str = "cuda",
                         route: str = "fused") -> ShardedLadderSolver:
    """A device-count-checked mesh solver from an error profile (the
    pipeline builds its own from the run's ladder instead). Raises
    ``SystemExit`` when a cuda mesh has fewer cards than ``n_devices``."""
    from ..kernels.tiers import TierLadder
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    check_mesh_devices(n_devices, dev.type)
    mesh = make_mesh(n_devices, platform=dev.type)
    ladder = TierLadder.from_config(profile, consensus_cfg, max_kmers=max_kmers,
                                    rescue_max_kmers=rescue_max_kmers,
                                    overflow_rescue=overflow_rescue,
                                    device=mesh[0], route=route)
    return make_sharded_solver(ladder, mesh, esc_cap, batch=batch)
