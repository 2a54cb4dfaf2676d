"""The solve group's drain rule (``serve/batcher.py SolveGroup``), on a CPU
ladder group whose solve path the test holds: which batches' shadow-audit
rows are back (``audit_pending``) and which results have landed
(``landed``), and a record of every ``fetch_many``.

A job's fetch lands the deque oldest first through the newest batch that
holds its handle's rows and leaves the later ones in flight; the ticker
lands only the oldest batches that are ready and never fetches one whose
audit rows are not back; each handle gets the rows, in the parts and the
order, that draining the whole deque gives; ``drain_all`` still empties it;
``drain_batches`` and ``drain_kept`` count what drains took and left.
"""

import time

import numpy as np
import pytest
import torch

WIDTH = 64


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """The profile, the job config (the CPU ladder at width 64) and the
    tensorized sampled windows of a small simulated set."""
    from daccord_tpu_torch.formats.dazzdb import read_db
    from daccord_tpu_torch.formats.las import LasFile
    from daccord_tpu_torch.kernels.tensorize import BatchShape, tensorize_windows
    from daccord_tpu_torch.runtime.pipeline import _sample_windows, estimate_profile_for_shard
    from daccord_tpu_torch.serve.jobs import JobSpec, build_job_config
    from daccord_tpu_torch.sim import SimConfig, make_dataset

    d = str(tmp_path_factory.mktemp("drain"))
    out = make_dataset(d, SimConfig(genome_len=1500, coverage=10, read_len_mean=500,
                                    min_overlap=200, seed=5), name="dr")
    db, las = read_db(out["db"]), LasFile(out["las"])
    spec = JobSpec.from_json({"db": out["db"], "las": out["las"]}, d)
    cfg = build_job_config(spec, "cpu", True, WIDTH, "fused", d, "drain")
    profile = estimate_profile_for_shard(db, las, cfg)
    _, ws = _sample_windows(db, las, cfg, None, None)
    assert len(ws) >= 80, "sample too small"
    shape = BatchShape(depth=cfg.depth, seg_len=cfg.seg_len, wlen=cfg.consensus.w)
    return profile, cfg, tensorize_windows([(0, w) for w in ws], shape)


class HeldPath:
    """The group's solve path, with the test holding the answers of
    ``audit_pending`` (the dispatch ordinals in ``pending``) and of
    ``landed`` (those in ``unlanded`` have not landed). ``fetched`` lists
    each ``fetch_many``'s ordinals, with the drain's cause."""

    def __init__(self, path):
        self._path = path
        self.handles: list = []
        self.pending: set[int] = set()
        self.unlanded: set[int] = set()
        self.fetched: list[tuple[str, list[int]]] = []
        self.cause = "?"

    def __getattr__(self, name):
        return getattr(self._path, name)

    def ordinal(self, h) -> int:
        return next(i for i, x in enumerate(self.handles) if x is h)

    def dispatch(self, batch):
        h = self._path.dispatch(batch)
        self.handles.append(h)
        return h

    def audit_pending(self, h) -> bool:
        return self.ordinal(h) in self.pending or self._path.audit_pending(h)

    def landed(self, h) -> bool:
        return self.ordinal(h) not in self.unlanded and self._path.landed(h)

    def fetch_many(self, hs):
        self.fetched.append((self.cause, [self.ordinal(h) for h in hs]))
        return self._path.fetch_many(hs)

    def wait_landed(self, timeout_s: float = 120.0) -> None:
        end = time.monotonic() + timeout_s
        while not all(self._path.landed(h) for h in self.handles):
            assert time.monotonic() < end, "the CPU ladder did not land its calls"
            time.sleep(0.01)


def _group(windows, max_inflight=8, **mode):
    """A CPU ladder group (``mode``: other ``GroupConfig`` fields) whose
    path the test holds."""
    from daccord_tpu_torch.serve.batcher import GroupConfig, SolveGroup

    profile, cfg, _ = windows
    gcfg = GroupConfig(**{**dict(backend="cpu", batch=WIDTH, max_inflight=max_inflight,
                                 audit_rate=1 / 64), **mode})
    group = SolveGroup("k", profile, cfg, gcfg)
    path = group.path = HeldPath(group.path)
    return group, path


def _block(windows, lo, n):
    from daccord_tpu_torch.kernels.tensorize import slice_batch

    full = windows[2]
    lo %= full.size - n
    return slice_batch(full, lo, lo + n)


def _tick(group, path, max_age_s=3600.0):
    path.cause = "ticker"
    group.flush_stale(max_age_s)


def _fetch(group, path, h):
    path.cause = "fetch"
    return group.fetch(h)


def test_a_jobs_fetch_leaves_the_later_batches_in_flight(windows):
    group, path = _group(windows)
    try:
        # batch 0: a's 40 rows and b's first 24; batch 1: b's last 16 and
        # c's 48; batch 2: d's 64
        ha = group.dispatch("a", _block(windows, 0, 40))
        hb = group.dispatch("b", _block(windows, 5, 40))
        hc = group.dispatch("c", _block(windows, 11, 48))
        hd = group.dispatch("d", _block(windows, 17, 64))
        assert len(group._inflight) == 3 and not any(p.rows for p in group._pools.values())
        assert len(_fetch(group, path, ha)["solved"]) == 40
        assert path.fetched == [("fetch", [0])]
        assert len(group._inflight) == 2 and not hb.event.is_set()
        assert [n for n, _ in hb.parts] == [24]
        assert (group.counters["drain_batches"], group.counters["drain_kept"]) == (1, 2)
        # b's rows lie in batches 0 and 1: its fetch stops after batch 1
        assert len(_fetch(group, path, hb)["solved"]) == 40
        assert path.fetched[1:] == [("fetch", [1])]
        assert [n for n, _ in hb.parts] == [24, 16] and hc.event.is_set()
        assert not hd.event.is_set() and len(group._inflight) == 1
        assert (group.counters["drain_batches"], group.counters["drain_kept"]) == (2, 3)
        # c was landed by b's drain: no drain at all
        _fetch(group, path, hc)
        assert len(path.fetched) == 2
        _fetch(group, path, hd)
        assert path.fetched[2:] == [("fetch", [2])] and not group._inflight
        assert (group.counters["drain_batches"], group.counters["drain_kept"]) == (3, 3)
    finally:
        group.close()


def test_the_ticker_lands_only_the_ready_batches_and_never_waits(windows):
    group, path = _group(windows, max_inflight=5)
    try:
        hs = [group.dispatch(f"j{i}", _block(windows, 7 * i, WIDTH)) for i in range(4)]
        path.wait_landed()
        # batch 2's audit rows are not back: the ticker lands 0 and 1 alone
        path.pending = {2}
        _tick(group, path)
        assert path.fetched == [("ticker", [0, 1])]
        assert [h.event.is_set() for h in hs] == [True, True, False, False]
        assert (group.counters["drain_batches"], group.counters["drain_kept"]) == (2, 2)
        # nothing ready at the head: nothing fetched, both kept again
        _tick(group, path)
        assert len(path.fetched) == 1 and len(group._inflight) == 2
        assert (group.counters["drain_batches"], group.counters["drain_kept"]) == (2, 4)
        # a result not landed stops the ticker as a pending audit does
        path.pending, path.unlanded = set(), {2}
        _tick(group, path)
        assert len(path.fetched) == 1
        path.unlanded = set()
        _tick(group, path)
        assert path.fetched[1:] == [("ticker", [2, 3])] and not group._inflight
        assert all(h.event.is_set() for h in hs)
        assert (group.counters["drain_batches"], group.counters["drain_kept"]) == (4, 6)
        # a job's fetch waits for what its rows need, pending or not
        h4 = group.dispatch("j4", _block(windows, 3, WIDTH))
        path.pending = {4}
        _fetch(group, path, h4)
        assert path.fetched[2:] == [("fetch", [4])]
        assert not any(path.ordinal(h) in path.pending
                       for cause, got in path.fetched if cause == "ticker"
                       for h in (path.handles[i] for i in got))
    finally:
        group.close()


def test_the_tickers_lag_flushes_keep_below_max_inflight(windows):
    import dataclasses

    group, path = _group(windows, max_inflight=2)
    try:
        # one batch in flight; 30 rows pooled in one bucket, 20 in another
        # (Stream B's rows pool apart)
        hs = [group.dispatch("j0", _block(windows, 0, WIDTH)),
              group.dispatch("j1", _block(windows, 2, 30)),
              group.dispatch("j2", dataclasses.replace(_block(windows, 4, 20),
                                                       stream="rescue"))]
        assert len(group._inflight) == 1
        path.wait_landed()
        path.pending = {0}
        _tick(group, path, 0.0)
        # one lag flush fills the deque to max_inflight; the other waits
        assert path.fetched == [] and len(group._inflight) == 2
        assert group.counters["lag_flushes"] == 1
        assert sum(p.rows for p in group._pools.values()) == 20
        _tick(group, path, 0.0)
        assert group.counters["lag_flushes"] == 1 and len(group._inflight) == 2
        path.pending = set()
        path.wait_landed()
        _tick(group, path, 0.0)
        # both landed, then the other pool flushed into the room they left
        assert path.fetched == [("ticker", [0, 1])] and len(group._inflight) == 1
        assert group.counters["lag_flushes"] == 2
        assert not any(p.rows for p in group._pools.values())
        for h in hs:
            _fetch(group, path, h)
        assert not group._inflight and all(h.filled == h.n for h in hs)
    finally:
        group.close()


MODES = {"cpu": {}, "native": dict(backend="native"), "mesh2": dict(mesh=2)}


@pytest.mark.parametrize("order,mode", [
    ("oldest_first", "cpu"), ("newest_first", "cpu"), ("with_ticks", "cpu"),
    ("with_ticks", "native"), ("with_ticks", "mesh2")])
def test_every_handle_gets_the_rows_a_whole_drain_gives(windows, order, mode):
    """The same blocks dispatched twice: fetched under the drain rule, and
    landed by ``drain_all`` (the whole deque at once). Each handle gets the
    same parts, in the same order, holding the same bytes, in every mode of
    group."""
    rng = np.random.default_rng(3)
    blocks = [(f"j{i % 3}", int(rng.integers(0, 200)), int(rng.integers(5, 50)))
              for i in range(12)]
    group, path = _group(windows, max_inflight=4, **MODES[mode])
    try:
        ruled = [group.dispatch(job, _block(windows, lo, n)) for job, lo, n in blocks]
        fetch_order = list(range(len(ruled)))
        if order == "newest_first":
            fetch_order.reverse()
        if order == "with_ticks":
            # every other batch's audit rows held back from the ticker
            path.pending = set(range(1, len(path.handles) + 1, 2))
        for k, i in enumerate(fetch_order):
            if order == "with_ticks" and k % 3 == 0:
                path.wait_landed()
                _tick(group, path)
            _fetch(group, path, ruled[i])
        assert not group._inflight
        # the newest handle's fetch flushes its pooled rows and lands all
        assert (group.counters["drain_kept"] > 0) == (order != "newest_first")
        whole = [group.dispatch(job, _block(windows, lo, n)) for job, lo, n in blocks]
        group.drain_all()
    finally:
        group.close()
    for a, b in zip(ruled, whole):
        assert [n for n, _ in a.parts] == [n for n, _ in b.parts]
        ra, rb = a.result(), b.result()
        assert set(ra) == set(rb)
        for k in ra:
            assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k


def test_drain_all_still_empties_the_deque(windows):
    group, path = _group(windows)
    try:
        hs = [group.dispatch(f"j{i}", _block(windows, 13 * i, 48)) for i in range(5)]
        _fetch(group, path, hs[0])
        assert group._inflight and not all(h.event.is_set() for h in hs)
        path.pending = set(range(len(path.handles)))
        path.cause = "final"
        group.drain_all()
        assert not group._inflight and not any(p.rows for p in group._pools.values())
        assert all(h.event.is_set() and h.filled == 48 for h in hs)
        assert group.counters["drain_batches"] == len(path.handles)
    finally:
        group.close()


def test_a_degraded_handle_is_not_landed_and_a_governor_result_is(windows):
    from daccord_tpu_torch.runtime.supervisor import _SupHandle

    group, path = _group(windows)
    try:
        b = _block(windows, 0, 8)
        assert not path._path.landed(_SupHandle(None, b, "k", degraded=True))
        assert path._path.landed(_SupHandle(None, b, "k", result={"solved": np.ones(8, bool)}))
        h = group.dispatch("a", _block(windows, 0, WIDTH))
        path.wait_landed()
        assert path._path.landed(path.handles[0])
        _fetch(group, path, h)
    finally:
        group.close()
