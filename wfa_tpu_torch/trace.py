"""Spans and counters of the port's host side, one record per call.

Every ``AlignmentPipeline.align_all`` leaves one :class:`CallRecord` in
:data:`history` (the last :data:`HISTORY` calls): for each kind of span
its wall time and its count (and, for pack and build, its threads' CPU
time), and the call's counters.  A span is a stretch of one thread's
work at a layer boundary:

========  ==========================================================
call      ``align_all``, on the caller's thread
gate      the caller blocked at the count cap or the byte gate
queue     from the hand-off to the submit pool to the worker's start
          (no CPU time: it spans two threads)
submit    a submit worker's batch (pack, upload, shards, launches)
pack      ``_pack_all`` and ``_seq_lens``; the two-phase re-placement
upload    a host-to-card copy of a batch's rows
shard     one shard of a mesh batch, its upload and launch
launch    the enqueue of a batch's device work and of its fetch
drain     a drain worker's batch (waits, fetch, results)
wait      the host blocked on the card (an event, a ``.cpu()``)
build     the token split and the result objects
========  ==========================================================

Spans nest as call > batch > submit | drain > the rest: a batch is the
id that its submit, its drain and every span inside them share, and
every span of a call carries the call's id.  Counters: pairs and batches
a call, bytes uploaded and fetched, refetches (batches whose guessed
token extent missed, so that the drain queued a second copy and waited
again), kernel launches (``_build.tally_launches``) and the shards'
launch lag (a mesh step's last shard span's end less its first's), and
the bases the native direct pack packed, all and those its vector body
packed (``native.pack_direct``), the pairs a tier above 0 ran (each pair
once a call: the tier ladder's retries), and the aux rows: the score cap
times the pairs of each batch launched (``aux_rows``) and the rows the
served pairs used, final_s + 1 each (``aux_rows_used``).  A thread takes
part only while a call has bound it (:func:`call`, :func:`batch`);
elsewhere a span costs one attribute read.  No Python object is kept per
span.

Inside :func:`timeline` each span also goes to a bounded buffer, which
:meth:`Timeline.chrome_events` exports as chrome-trace events on the
clock of a ``torch.profiler`` trace, for :meth:`Timeline.merge` to add
to it: pid the process, tid the thread's id as the trace has it (the
native id for a thread whose operators the profiler records; for a
worker, whose CUDA runtime calls alone it records under an id of
CUPTI's, the id of the calls that fall inside the worker's spans), the
native id also in the event's args.  The profiler records no
``record_function`` of the worker threads, so the program's spans are
moved onto its clock by the calls: each ``align_all`` enters
``record_function("wfa.align_all")`` on the caller's thread while a
timeline is on, and the trace's mark and the call span's start give the
offset (the trace's ``baseTimeNanoseconds`` and the wall clock, where
no mark is found).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from . import _build

KINDS = ("call", "gate", "queue", "submit", "pack", "upload", "shard",
         "launch", "drain", "wait", "build")
(CALL, GATE, QUEUE, SUBMIT, PACK, UPLOAD, SHARD, LAUNCH, DRAIN, WAIT,
 BUILD) = range(len(KINDS))
# the kinds whose spans also read their thread's CPU clock: the host work
# whose stall share a metric reads.  The clock is a system call (2.3-2.9 us
# on an H100 host), so the other kinds do not read it.
CPU_KINDS = frozenset((PACK, BUILD))
COUNTERS = ("pairs", "batches", "bytes_up", "bytes_down", "refetches",
            "launches", "shard_lag_ns", "shard_steps", "packed_bases",
            "packed_vec_bases", "retried_pairs", "aux_rows", "aux_rows_used")
(PAIRS, BATCHES, BYTES_UP, BYTES_DOWN, REFETCHES, LAUNCHES, SHARD_LAG,
 SHARD_STEPS, PACKED_BASES, PACKED_VEC_BASES, RETRIED_PAIRS, AUX_ROWS,
 AUX_ROWS_USED) = range(len(COUNTERS))
HISTORY = 4096
TIMELINE = 1 << 20  # spans a timeline keeps
MARK = "wfa.align_all"

_perf = time.perf_counter_ns
_cpu = time.thread_time_ns


_ids = itertools.count(1)


class _Thread(threading.local):
    """A thread's binding: its call's record, batch and shard, the start
    times of its open spans (None: unbound), its native id."""

    rec: Optional["CallRecord"] = None
    batch = -1
    shard = -1
    stack: Optional[list] = None
    tid = 0
    first_shard_end = 0


_local = _Thread()
_timeline: Optional["Timeline"] = None
# the last calls' records, oldest first, each frozen into a tuple of ints
# and tuples (CallRecord.freeze), which the collector stops tracking
history: collections.deque = collections.deque(maxlen=HISTORY)


class CallRecord:
    """One ``align_all`` call: per kind of span the summed wall ns
    (``wall``) and count (``n``), and for :data:`CPU_KINDS` the threads'
    CPU ns (``cpu``); the counters (``counters``, by :data:`COUNTERS`) and
    the pipeline's ``peak``."""

    __slots__ = ("id", "wall", "cpu", "n", "counters", "peak", "_lock")

    def __init__(self, pairs: int) -> None:
        self.id = next(_ids)
        self.wall = [0] * len(KINDS)
        self.cpu = [0] * len(KINDS)
        self.n = [0] * len(KINDS)
        self.counters = [0] * len(COUNTERS)
        self.counters[PAIRS] = pairs
        self.peak: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, kind: int, wall: int, cpu: int) -> None:
        """One span of ``kind``; ``cpu`` -1 where it did not read the CPU
        clock."""
        with self._lock:
            self.wall[kind] += wall
            self.n[kind] += 1
            if cpu >= 0:
                self.cpu[kind] += cpu

    def count(self, counter: int, n: int) -> int:
        """Add ``n`` to ``counter``; returns its new value."""
        with self._lock:
            self.counters[counter] += n
            return self.counters[counter]

    def freeze(self) -> tuple:
        """The record as :data:`history` keeps it."""
        return (self.id, tuple(self.wall), tuple(self.cpu), tuple(self.n),
                tuple(self.counters),
                tuple(sorted(self.peak.items())))


def _as_dict(frozen: tuple) -> dict:
    rid, wall, cpu, n, counters, peak = frozen
    return {"call": rid,
            "spans": {k: {"wall_ns": wall[i], "count": n[i],
                          **({"cpu_ns": cpu[i]} if i in CPU_KINDS else {})}
                      for i, k in enumerate(KINDS) if n[i]},
            **dict(zip(COUNTERS, counters)), "peak": dict(peak)}


def _bind(rec: Optional[CallRecord], batch: int) -> tuple:
    """Bind the calling thread to ``rec`` and ``batch``; returns what it
    was bound to, for :func:`_restore`."""
    loc = _local
    prev = (loc.rec, loc.batch, loc.stack)
    loc.rec, loc.batch = rec, batch
    loc.stack = None if rec is None else []
    loc.shard = -1
    if not loc.tid:
        loc.tid = threading.get_native_id()
    return prev


def _restore(prev: tuple) -> None:
    _local.rec, _local.batch, _local.stack = prev


def _record(kind: int, t0: int, t1: int, cpu: int) -> None:
    loc = _local
    loc.rec.add(kind, t1 - t0, cpu)
    tl = _timeline
    if tl is not None:
        tl.events.append((kind, loc.rec.id, loc.batch, loc.shard, loc.tid,
                          t0, t1, cpu))


class _Span:
    """``with span(KIND):`` (one object a kind, shared by every thread:
    the start times go to the thread's own stack)."""

    __slots__ = ("kind", "cpu")

    def __init__(self, kind: int) -> None:
        self.kind = kind
        self.cpu = kind in CPU_KINDS

    def __enter__(self):
        stack = _local.stack
        if stack is not None:
            stack.append(_perf())
            stack.append(_cpu() if self.cpu else -1)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _local.stack
        if stack is not None:
            c0 = stack.pop()
            cpu = _cpu() - c0 if c0 >= 0 else -1
            _record(self.kind, stack.pop(), _perf(), cpu)
        return False


_SPANS = tuple(_Span(k) for k in range(len(KINDS)))


def span(kind: int) -> _Span:
    """The span of ``kind`` around a ``with`` block of this thread."""
    return _SPANS[kind]


def count(counter: int, n: int = 1) -> None:
    """Add ``n`` to the bound call's ``counter`` (nothing when unbound)."""
    rec = _local.rec
    if rec is not None:
        rec.count(counter, n)


@contextlib.contextmanager
def call(pairs: int, peak: Dict[str, int]) -> Iterator[CallRecord]:
    """One ``align_all``: a new record, the caller's thread bound to it
    and inside its ``call`` span; ``peak`` (the pipeline's, filled in
    during the call) is copied into the record, which joins
    :data:`history`, at the end."""
    rec = CallRecord(pairs)
    prev = _bind(rec, -1)
    mark = contextlib.nullcontext()
    if _timeline is not None:
        from torch.autograd.profiler import record_function

        mark = record_function(MARK)
    try:
        with mark, span(CALL):
            yield rec
    finally:
        rec.peak = peak
        _restore(prev)
        history.append(rec.freeze())


def next_batch() -> Optional[tuple]:
    """A new batch of the calling thread's call, to hand to the workers
    (:func:`batch`): (record, batch id, now), None when unbound."""
    rec = _local.rec
    if rec is None:
        return None
    return rec, rec.count(BATCHES, 1) - 1, _perf()


@contextlib.contextmanager
def batch(tag: Optional[tuple], queued: bool = False):
    """Bind the calling thread to a batch of :func:`next_batch` (nothing
    for None) and tally its kernel launches; ``queued`` records the
    ``queue`` span from the hand-off to now."""
    if tag is None:
        yield
        return
    rec, b, handed = tag
    prev = _bind(rec, b)
    tally: dict = {}
    try:
        if queued:
            _record(QUEUE, handed, _perf(), -1)
        with _build.tally_launches(tally):
            yield
    finally:
        if tally:
            rec.count(LAUNCHES, sum(tally.values()))
        _restore(prev)


@contextlib.contextmanager
def shard(i: int, n: int):
    """The ``shard`` span of local shard ``i`` of ``n`` in a mesh step;
    the last adds the step's launch lag (its end less the first's)."""
    loc = _local
    if loc.stack is None:
        yield
        return
    loc.shard = i
    try:
        with span(SHARD):
            yield
    finally:
        end = _perf()
        loc.shard = -1
        if i == 0:
            loc.first_shard_end = end
        if i == n - 1:
            lag = end - (loc.first_shard_end or end)
            loc.rec.count(SHARD_LAG, lag)
            loc.rec.count(SHARD_STEPS, 1)


def records(n: Optional[int] = None) -> List[dict]:
    """The last ``n`` calls' records (all kept, for None), oldest first,
    as plain dicts."""
    recs = list(history)
    return [_as_dict(r) for r in (recs if n is None else recs[-n:])]


class Timeline:
    """The spans of the calls made inside :func:`timeline`, oldest first
    (the last :data:`TIMELINE`): (kind, call, batch, shard, native tid,
    start ns, end ns, CPU ns), on ``perf_counter_ns``'s clock."""

    def __init__(self) -> None:
        self.events: collections.deque = collections.deque(maxlen=TIMELINE)
        self.pid = os.getpid()
        # the wall clock against perf_counter_ns, for a trace without marks
        self.wall_less_perf = time.time_ns() - _perf()

    def offset_ns(self, trace: dict) -> int:
        """What to add to a span's ns to put it on the clock of the
        chrome trace ``trace`` (ns from its ``baseTimeNanoseconds``): the
        median over the calls of the ``wfa.align_all`` mark less the call
        span's start, each mark paired with the call that starts nearest
        to it by the wall clock; the wall clock alone where the trace has
        no mark."""
        base = int(trace.get("baseTimeNanoseconds", 0))
        rough = self.wall_less_perf - base
        marks = sorted(1000 * float(ev["ts"]) for ev in
                       trace.get("traceEvents", ())
                       if ev.get("name") == MARK and ev.get("ph") == "X")
        starts = sorted(ev[5] for ev in self.events if ev[0] == CALL)
        if not marks or not starts:
            return rough
        diffs = []
        for m in marks:
            near = min(starts, key=lambda s: abs(s + rough - m))
            diffs.append(m - near)
        diffs.sort()
        return int(diffs[len(diffs) // 2])

    def chrome_events(self, trace: dict) -> List[dict]:
        """The spans as chrome-trace complete events ("X", times in us),
        on ``trace``'s clock (:meth:`offset_ns`), each thread under the
        tid ``trace`` gives it (:meth:`tids`)."""
        off = self.offset_ns(trace)
        tids = self.tids(trace, off)
        return [{"ph": "X", "cat": "wfa", "name": KINDS[k], "pid": self.pid,
                 "tid": tids.get(tid, tid),
                 "ts": (t0 + off) / 1e3, "dur": (t1 - t0) / 1e3,
                 "args": {"call": c, "batch": b, "shard": s,
                          "native_tid": tid,
                          "cpu_us": cpu / 1e3 if cpu >= 0 else None}}
                for k, c, b, s, tid, t0, t1, cpu in list(self.events)]

    def tids(self, trace: dict, off: int) -> Dict[int, int]:
        """Each thread's tid in the chrome trace ``trace`` by its native
        id: the native id itself where the profiler recorded the thread's
        operators (the caller's); else the tid of the CUDA runtime calls
        that fall inside the thread's upload, launch and wait spans (at
        ``off``) most often.  CUPTI names a thread whose operators the
        profiler does not record (a worker) by an id of its own, which is
        not its native id."""
        events = trace.get("traceEvents", ())
        ops = {ev.get("tid") for ev in events
               if ev.get("cat") in ("cpu_op", "user_annotation")}
        spans: Dict[int, List[tuple]] = collections.defaultdict(list)
        for k, _, _, _, tid, t0, t1, _ in list(self.events):
            if k in (UPLOAD, LAUNCH, WAIT):  # never nested in each other
                spans[tid].append(((t0 + off) / 1e3, (t1 + off) / 1e3))
        starts = {}
        for tid, iv in spans.items():
            iv.sort()
            starts[tid] = [a for a, _ in iv]
        votes: collections.Counter = collections.Counter()
        for ev in events:
            if ev.get("cat") != "cuda_runtime" or ev.get("tid") in ops:
                continue
            ts = float(ev.get("ts", 0))
            for tid, iv in spans.items():
                i = bisect.bisect_right(starts[tid], ts) - 1
                if i >= 0 and ts <= iv[i][1]:
                    votes[tid, ev["tid"]] += 1
        out = {}
        for (tid, got), _ in votes.most_common():
            if tid not in ops and tid not in out and got not in out.values():
                out[tid] = got
        return out

    def merge(self, path: str) -> int:
        """Add the spans to the chrome trace at ``path`` (a
        ``torch.profiler`` export), in place; returns how many."""
        with open(path) as fh:
            trace = json.load(fh)
        events = self.chrome_events(trace)
        trace.setdefault("traceEvents", []).extend(events)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(trace, fh)
        os.replace(tmp, path)
        return len(events)


@contextlib.contextmanager
def timeline() -> Iterator[Timeline]:
    """Within the block, every span also goes to the returned
    :class:`Timeline`, and every ``align_all`` marks itself for the
    profiler."""
    global _timeline
    tl, prev = Timeline(), _timeline
    _timeline = tl
    try:
        yield tl
    finally:
        _timeline = prev
