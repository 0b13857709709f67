"""Alignment pipeline: length buckets and the tiered window retry, the
PyTorch port of :mod:`wfa_tpu.pipeline` for global and semi-global
alignment.

Pairs are grouped into length classes and run through the batched
engine with economical window caps; pairs whose band or score overflows
retry with larger caps (tiers 0-3), and the rest fall to the exact host
oracle.  Results come back in input order and equal the oracle's
whichever tier served them.  Global, wf-adaptive buckets of reads longer
than 4096 bases run K1-long (engine "long", value-rebased int16 aux) at
the tier-0 window on every tier, as ``wfa_tpu.pipeline`` routes them to
its long-read kernel.  Global wf-adaptive buckets whose longest read
lies in (4095 - k_win, 4096] at a k_win of 512 or less run K1-kw (engine
``"auto:kw<k_win>"``: int16 aux rows row- and value-rebased), where
``wfa_tpu.pipeline`` routes them (pipeline.py:216-223).  Semi-global
wf-adaptive buckets whose full span
passes 512 diagonals take the two-phase route (engine ``"semi2:<S0>"``,
:mod:`wfa_tpu_torch.semi2`) on tiers 0-2 and K1-semi at the full span on
tier 3, as ``wfa_tpu.pipeline`` routes them (pipeline.py:112-123).
A device fault (a RuntimeError from submitting or finishing a batch)
re-queues the chunk for the next tier, and after two faults in one call
the rest finishes on the oracle, as ``wfa_tpu.pipeline`` does.  A kernel
that does not build or a launch the kernel refuses
(``_build.KernelError``) is a fault of the code and propagates.

The host side is ``wfa_tpu.pipeline``'s (pipeline.py:350-671): every
batch of a tier is handed to a pool of submit workers (pack, upload,
launches; three) and a pool of drain workers (fetch, results; four)
before any is collected, under a cap on the batches in flight (eight)
and a gate on their modelled device bytes (:meth:`AlignmentPipeline
._mem_acquire`); ``WFA_SUBMIT_WORKERS``, ``WFA_DRAIN_WORKERS`` and
``WFA_MAX_INFLIGHT`` override the three.  A batch reserves its full
modelled bytes while its submit runs (a two-phase one until phase 2 has
launched) and its output bytes from then until its drain; the gate holds
the reservations to twice ``mem_budget`` and always admits one batch.
Every submit launches on the device's default stream, so the kernels of
all batches run in the order they were launched and the caching
allocator's reuse of a batch's freed working set stays ordered behind
them.  Two-phase batches modelled above ``max(2 GiB, mem_budget / 2)``
submit and drain one at a time on the calling thread.  The first chunk
of a tier with more chunks is a probe: when at least 90% of it
overflows, the tier's remaining chunks go straight to the next tier.
Faults surface through the workers' futures and are counted on the
calling thread.

``PipelineConfig.n_devices`` (or ``devices``) shards every batch over a
data-parallel mesh (:mod:`wfa_tpu_torch.parallel`), as ``wfa_tpu.pipeline``
does (pipeline.py:76-84): the tier ladder, the gates and the fault
handling stay as they are, and one submit worker launches the batches,
so that every process launches and gathers in the same order.  The byte
gate models one device's bytes per batch and is not scaled by the mesh
(nor is JAX's).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

from . import trace
from .cigar import AlignmentResult
from .constants import (MAX_SEQ_LEN, AdaptiveReductionOption, EmptySeqError,
                        Options, Penalties, SeqTooLongError)
from .device_backtrace import iter_capacity
from .engine import (BatchAligner, EngineConfig, _pad_len, engine_kw,
                     semi_cell16, windows)
from .io import bucket_pairs
from .kernel_engine import workspace
from .oracle import Aligner as OracleAligner

# reads longer than this keep the tier-0 window on every tier and, when
# global and wf-adaptive, run K1-long (wfa_tpu/pipeline.py:133-141, 207-215)
LONG_READ = 4096


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    penalties: Penalties = Penalties()
    options: Options = Options()
    adaptive: Optional[AdaptiveReductionOption] = None
    batch_size: int = 512
    # base score cap (tier 0) and diagonal window
    s_cap_base: int = 256
    k_win_base: int = 128
    # the card unless the caller asks for the CPU (plain PyTorch versions)
    device: str = "cuda"
    # device memory one batch may allocate (the byte gate holds the
    # batches in flight to two of it); bounds the batch size where
    # s_cap * k_win grows
    mem_budget: int = 16 << 30
    # False: every pair by the exact host oracle, no device
    use_device: bool = True
    # data parallelism over the cards (after parallel
    # .initialize_distributed, of every process): 0 = all, 1 = one, n = the
    # first n; on the CPU, n virtual shards (0: one)
    n_devices: int = 0
    # the mesh's devices given outright (a device may repeat: shards that
    # share a card); overrides n_devices
    devices: Tuple[str, ...] = ()


def aux_cell_bytes(rebased: bool) -> int:
    """Bytes of one [3, S, K] aux cell triple: int32 cells on K1, the
    int16 cells of K1-long and K1-kw (``rebased``)."""
    return 6 if rebased else 12


def batch_bytes_per_pair(cfg: EngineConfig, longest: int,
                         engine: str = "auto") -> int:
    """Device bytes one pair of a batch allocates on the main path: the
    aux [3, S, K] cells (K1-kw, ``cfg.aux_kw`` set: KW columns; plus
    K1-long's row bases or K1-kw's sbase words, int32 a row) and the score
    loop's workspace (with the staged rows of both), counted as device
    scratch even where it goes to shared memory, the token
    buffers and compaction temporaries of K2 (~40 B per emission slot),
    and the sequence rows."""
    rebased = engine == "long" or cfg.aux_kw is not None
    ns = 2 * iter_capacity(cfg.s_cap, cfg.penalties) + 5
    return (aux_cell_bytes(rebased) * cfg.s_cap * (cfg.aux_kw or cfg.k_win)
            + (4 * cfg.s_cap if rebased else 0)
            + 4 * workspace(cfg, 2 if rebased else 0)[0]
            + 40 * ns
            + 4 * (2 * longest + cfg.k_win))


# the two-phase semi-global ladder, tiers 0-2 (wfa_tpu/pipeline.py:112-121):
# the score phase 2 resumes at (each tier's prefix must outlast the band
# collapse of a rising error rate) and phase 2's window
SEMI2_S0 = (64, 112, 200)
SEMI2_K_WIN = (256, 512, 512)


def semi2_bytes_per_pair(cfg: EngineConfig, Kf: int, S0: int, Ltb: int,
                         longest: int) -> int:
    """Device bytes one pair of a two-phase batch holds until K2 has run
    (``cfg`` is phase 2's: k_win the narrow window, s_cap the total cap):
    phase 1's full-span aux ``aux_old`` (3 x S0 x Kf cells) and K3's
    workspace at Kf, the exports at k_win, phase 2's aux (3 x (s_cap - S0)
    x k_win cells) and K4's workspace (each counted as device scratch),
    K2's token buffers and compaction temporaries (~40 B per emission
    slot), and the sequence rows (the
    re-placed target beside the first).  Cells are int16 when the phase-1
    buffer of Ltb columns allows (``engine.semi_cell16``), for both
    phases."""
    K2, S = cfg.k_win, cfg.s_cap
    cell = 2 if semi_cell16(Ltb) else 4
    wm, we = windows(cfg.penalties)
    rows = wm + 2 * we
    ns = 2 * iter_capacity(S, cfg.penalties) + 5
    ws_k3 = workspace(dataclasses.replace(cfg, k_win=Kf), "prefix")[0]
    ws_k4 = workspace(cfg, "resume")[0]
    return (3 * S0 * Kf * cell + 4 * ws_k3
            + 4 * (rows + 3) * K2 + 4 * (3 * rows + 9)
            + 3 * (S - S0) * K2 * cell + 4 * ws_k4 + 40 * ns
            + 4 * (3 * longest + K2))


class AlignmentPipeline:
    """Aligns arbitrary lists of pairs at batch throughput."""

    def __init__(self, cfg: PipelineConfig) -> None:
        self.cfg = cfg
        self._oracle = OracleAligner(cfg.penalties, cfg.options, cfg.adaptive)
        self._engines: Dict[Tuple[int, int, str], BatchAligner] = {}
        # adaptive score-cap memory: bucket class -> max final score
        # (``DeviceResult.final_s``) seen in the most recent align_all that
        # completed pairs there
        self._score_memory: Dict[Tuple[int, int], int] = {}
        # pairs served per tier in the last align_all ("oracle": the final
        # exact fallback)
        self.served: Dict[object, int] = {}
        self._device_errors = 0  # device faults in the current align_all
        # the indices of the current align_all's pairs that a tier above 0
        # ran (trace.RETRIED_PAIRS counts each once)
        self._retried: set = set()
        # the worker pools and the count cap, made at first use
        self._spool: Optional[ThreadPoolExecutor] = None
        self._dpool: Optional[ThreadPoolExecutor] = None
        self._isem: Optional[threading.BoundedSemaphore] = None
        # the byte gate: modelled device bytes reserved by batches in
        # flight, and the batches in flight
        self._mem_cv = threading.Condition()
        self._mem_used = 0
        self._batches = 0
        # the last align_all's most batches in flight at once, most bytes
        # reserved at once, and the gate they were held to
        self.peak: Dict[str, int] = {}
        # the data-parallel mesh (wfa_tpu/pipeline.py:76-84): batches shard
        # over it; None for a single device.  n_devices 0 on a machine
        # without a card builds none here, and the engine raises then.
        self._mesh = None
        if cfg.use_device and (cfg.devices or cfg.n_devices > 1 or (
                cfg.n_devices == 0 and (torch.device(cfg.device).type
                                        == "cpu" or
                                        torch.cuda.is_available()))):
            from .parallel import make_dp_mesh

            mesh = make_dp_mesh(cfg.n_devices or None,
                                devices=cfg.devices or None,
                                device=cfg.device)
            self._mesh = mesh if mesh.size > 1 else None

    def _tier_caps(self, lq: int, lt: int, tier: int, skey=None):
        """(k_win, s_cap, b_cap, engine, serial, batch_bytes) for a bucket
        class and tier (0-3): ``batch_bytes`` models the device bytes of
        one batch of ``min(batch_size, b_cap)`` pairs, and ``serial`` says
        whether that passes ``max(2 GiB, mem_budget / 2)``
        (wfa_tpu/pipeline.py:305-315).  ``skey`` names the bucket for the
        adaptive score-cap memory."""
        cfg = self.cfg
        full_span = _round_up(lq + lt - 1 + 2, 128)
        longest = max(lq, lt)
        s0 = None
        if not cfg.options.global_alignment:
            # the semi-global seeds span every diagonal; with wf-adaptive
            # the band collapses to tens once the best path pulls ahead,
            # so tiers 0-2 run the two-phase route (full span to S0, then
            # a narrow window) and tier 3 the full span throughout, the
            # exact last tier.  Spans of 512 or fewer stay on K1-semi.
            if cfg.adaptive is not None and full_span > 512 and tier <= 2:
                s0, k_win = SEMI2_S0[tier], SEMI2_K_WIN[tier]
            else:
                k_win = full_span
        elif cfg.adaptive is not None:
            # wf-adaptive trims the band to ~2 * max_dist_diff around the
            # optimal path, whose diagonal drifts like a random walk
            band = 2 * (cfg.adaptive.max_dist_diff + 2)
            drift = int(0.75 * longest ** 0.5)
            k_win = min(full_span,
                        _round_up(max(cfg.k_win_base, band + drift), 128))
            # long reads keep the tier-0 window: their retries raise only
            # the score cap (the path's diagonal drifts like a random walk)
            if longest <= LONG_READ:
                if tier == 1:
                    k_win = min(full_span, 4 * k_win)
                elif tier >= 2:
                    k_win = full_span
        else:
            k_win = full_span
        global_ad = cfg.options.global_alignment and cfg.adaptive is not None
        if s0 is not None:
            engine = f"semi2:{s0}"
        elif global_ad and longest > LONG_READ and k_win <= 512:
            engine = "long"
        elif global_ad and k_win <= 512 and longest + k_win > 4095:
            # the reads just past int16 offsets: K1-kw at KW = k_win (value
            # rebase alone), where wfa_tpu.pipeline takes "auto:kw" (its
            # HBM gate, pp_kw(k_win) * 128 <= hbm_budget, models 128-lane
            # TPU blocks and is left out; the memory model below sizes
            # the batch)
            engine = f"auto:kw{k_win}"
        else:
            engine = "auto"
        p = cfg.penalties
        worst = (p.mismatch * longest + p.gap_open
                 + p.gap_ext * (abs(lq - lt) + 1) + 2)
        # score ladder: ~0.29 * l at 5% error, ~0.53 * l at 10%
        s1 = max(cfg.s_cap_base, _round_up(int(longest * 0.55), 128))
        smax = self._score_memory.get(skey) if skey is not None else None
        if smax is not None:
            # fitted cap: observed maximum + 20% headroom, quantized
            s1 = max(cfg.s_cap_base, _round_up(int(smax * 1.2) + 16, 128))
        s_cap = (s1, 3 * s1, _round_up(worst + 2, 8))[min(tier, 2)]
        s_cap = min(s_cap, _round_up(worst + 2, 8))
        # one pair's aux must fit the budget
        kw = engine_kw(engine, k_win)
        cell = aux_cell_bytes(engine == "long" or kw is not None)
        s_cap = max(8, min(s_cap,
                           (cfg.mem_budget // (cell * (kw or k_win))) // 8 * 8))
        ecfg = EngineConfig(penalties=p,
                            global_alignment=cfg.options.global_alignment,
                            adaptive=cfg.adaptive, k_win=k_win, s_cap=s_cap,
                            aux_kw=kw)
        if s0 is not None:
            # the total cap must leave phase 2 a score to run
            s_cap = max(s_cap, s0 + 8)
            ecfg = dataclasses.replace(ecfg, s_cap=s_cap)
            per_pair = semi2_bytes_per_pair(
                ecfg, full_span, s0, _pad_len(lq - 1 + lt), longest)
        else:
            per_pair = batch_bytes_per_pair(ecfg, longest, engine)
        b_cap = max(1, min(8192, cfg.mem_budget // per_pair))
        batch_bytes = per_pair * min(cfg.batch_size, b_cap)
        return k_win, s_cap, b_cap, engine, self._serial(batch_bytes), \
            batch_bytes

    def _serial(self, nbytes: int) -> bool:
        """Whether a batch of ``nbytes`` modelled bytes is too large to
        overlap another."""
        return nbytes > max(2 << 30, self.cfg.mem_budget // 2)

    def _engine(self, k_win: int, s_cap: int, engine: str) -> BatchAligner:
        key = (k_win, s_cap, engine)
        eng = self._engines.get(key)
        if eng is None:
            eng = BatchAligner(self.cfg.penalties, self.cfg.options,
                               self.cfg.adaptive, k_win=k_win, s_cap=s_cap,
                               device=self.cfg.device, engine=engine,
                               mesh=self._mesh)
            self._engines[key] = eng
        return eng

    def align_all(self, pairs: Sequence[Tuple[bytes, bytes]]
                  ) -> List[AlignmentResult]:
        """Align pairs, returning results in input order.  The call leaves
        its record in ``trace.history``."""
        pairs = list(pairs)
        self.peak = {"batches": 0, "bytes": 0, "gate": self._gate()}
        with trace.call(len(pairs), self.peak):
            return self._align_all(pairs)

    def _align_all(self, pairs) -> List[AlignmentResult]:
        results: List[Optional[AlignmentResult]] = [None] * len(pairs)
        # per-pair input guards: invalid pairs become error-carrying
        # results, the rest proceed (wfa.go:204-209)
        valid = []
        for i, (q, t) in enumerate(pairs):
            if len(q) == 0 or len(t) == 0:
                results[i] = AlignmentResult.failed(
                    EmptySeqError("wfa: invalid empty sequence"))
            elif len(q) > MAX_SEQ_LEN or len(t) > MAX_SEQ_LEN:
                results[i] = AlignmentResult.failed(SeqTooLongError(
                    f"wfa: sequences longer than {MAX_SEQ_LEN} are not "
                    "supported"))
            else:
                valid.append((i, (q, t)))

        served: Dict[object, int] = {0: 0, 1: 0, 2: 0, 3: 0, "oracle": 0}
        self.served = served
        pending = bucket_pairs(valid) if self.cfg.use_device else {
            None: valid}
        # device faults are counted per call (wfa_tpu/pipeline.py:376-379):
        # a faulted chunk retries on the next tier, at the same caps if the
        # ladder has nothing wider, and after two faults the rest finishes
        # on the oracle
        self._device_errors = 0
        self._retried = set()
        score_seen: Dict[Tuple[int, int], int] = {}
        if self.cfg.use_device:
            prev_caps = {}  # bucket -> previous tier's caps
            for tier in (0, 1, 2, 3):
                if self._device_errors >= 2:
                    break
                inflight = []
                counted = set()  # futures whose fault is already counted
                try:
                    self._run_tier(tier, pending, prev_caps, inflight,
                                   counted)
                    pending = self._collect(tier, inflight, counted, pending,
                                            results, served, score_seen)
                except BaseException:
                    # no batch of the call outlives it, whatever failed
                    wait([f for _, _, f in inflight
                          if isinstance(f, Future)])
                    raise
        for items in pending.values():  # final exact fallback
            for idx, (q, t) in items:
                results[idx] = self._oracle.align(q, t)
                served["oracle"] += 1
        # replace, not max-merge: easier workloads shrink the caps again
        self._score_memory.update(score_seen)
        return results  # type: ignore[return-value]

    def align_iter(self, pairs: Iterable[Tuple[bytes, bytes]],
                   chunk: int = 4096) -> Iterator[AlignmentResult]:
        """Streaming form of :meth:`align_all`: buffers ``chunk`` pairs,
        aligns them, yields their results in order
        (wfa_tpu/pipeline.py:682-693)."""
        buf: List[Tuple[bytes, bytes]] = []
        for pair in pairs:
            buf.append(pair)
            if len(buf) >= chunk:
                yield from self.align_all(buf)
                buf.clear()
        if buf:
            yield from self.align_all(buf)

    def _run_tier(self, tier: int, pending, prev_caps, inflight,
                  counted) -> None:
        """Hand every chunk of ``pending``'s buckets to the workers at this
        tier's caps, appending (bucket, chunk, out) to ``inflight``: out
        is a drain's Future, a finished result list, or a list of None for
        a chunk that did not run (a fault, a skipped tier, no wider caps).
        A probe whose fault is counted here joins ``counted``."""
        submit_futs = []  # outstanding async submits (the serial fence)
        for key, items in pending.items():
            if not items:
                continue
            lq_max = max(len(p[0]) for _, p in items)
            lt_max = max(len(p[1]) for _, p in items)
            caps = self._tier_caps(lq_max, lt_max, tier, skey=key)
            if prev_caps.get(key) == caps and self._device_errors == 0:
                # nothing wider on the ladder: go to the fallback (a
                # fault, by contrast, retries at the same caps)
                inflight.append((key, items, [None] * len(items)))
                continue
            prev_caps[key] = caps
            k_win, s_cap, b_cap, engine, _, batch_bytes = caps
            eng = self._engine(k_win, s_cap, engine)
            bs = min(self.cfg.batch_size, b_cap)
            n_chunks = (len(items) + bs - 1) // bs
            # the probe (does this tier's ladder fit the workload at
            # all?) drains asynchronously; past probe_hard chunks an
            # unresolved probe blocks.  Across processes it resolves at
            # probe_hard only, so that every process submits (and gathers)
            # the same chunks
            probe = tier < 3 and n_chunks > 1
            probe_hard = min(8, n_chunks - 1)
            lockstep = self._mesh is not None and self._mesh.world > 1
            probe_fut = None
            skip_rest = False
            for ci in range(n_chunks):
                chunk = items[ci * bs:(ci + 1) * bs]
                if skip_rest or self._device_errors >= 2:
                    inflight.append((key, chunk, [None] * len(chunk)))
                    continue
                cb = batch_bytes * len(chunk) // bs  # this chunk's model
                chunk_pairs = [p for _, p in chunk]
                if tier:
                    self._note_retried(chunk)
                try:
                    if engine.startswith("semi2") and self._serial(cb):
                        # a multi-GB two-phase batch runs alone: fence
                        # the async submits, then submit and drain here
                        for f in submit_futs:
                            try:
                                f.result()
                            except RuntimeError:
                                pass  # counted by its drain's future
                        submit_futs.clear()
                        with trace.batch(trace.next_batch()):
                            with trace.span(trace.SUBMIT):
                                h = eng.submit_batch(chunk_pairs)
                            with trace.span(trace.DRAIN):
                                out = eng.finish_batch(h, fallback=False)
                        inflight.append((key, chunk, out))
                        if probe and ci == 0:
                            skip_rest = _doomed(out)
                        continue
                    with trace.span(trace.GATE):
                        self._slot_acquire()
                    with trace.span(trace.GATE):
                        self._mem_acquire(cb)
                    owned = False
                    try:
                        tag = trace.next_batch()
                        sub = self._pool("submit").submit(
                            self._submit_one, eng, chunk_pairs, cb, tag)
                        submit_futs.append(sub)
                        fut = self._pool("drain").submit(
                            self._drain_from, eng, sub, cb, tag)
                        owned = True
                    finally:
                        if not owned:
                            self._mem_release(cb)
                            self._slot_release()
                    inflight.append((key, chunk, fut))
                    if probe and ci == 0:
                        probe_fut = fut
                except RuntimeError as exc:  # a device fault
                    self._device_fault(exc)
                    inflight.append((key, chunk, [None] * len(chunk)))
                    continue
                if probe_fut is not None and (
                        (probe_fut.done() and not lockstep)
                        or ci >= probe_hard):
                    try:
                        out = probe_fut.result()
                    except RuntimeError as exc:
                        self._device_fault(exc)
                        counted.add(probe_fut)
                        probe_fut = None
                        continue
                    probe_fut = None
                    skip_rest = _doomed(out)

    def _note_retried(self, chunk) -> None:
        """Count the pairs of a chunk that a tier above 0 runs, each pair
        once a call."""
        new = {idx for idx, _ in chunk} - self._retried
        self._retried |= new
        trace.count(trace.RETRIED_PAIRS, len(new))

    def _collect(self, tier: int, inflight, counted, pending, results,
                 served, score_seen) -> dict:
        """Wait for a tier's chunks, place their results, count device
        faults and note each bucket's largest final score; returns the
        pairs left for the next tier, by bucket."""
        nxt = {key: [] for key in pending}
        for key, chunk, item in inflight:
            out = item
            if isinstance(item, Future):
                try:
                    out = item.result()
                except RuntimeError as exc:
                    if item not in counted:
                        self._device_fault(exc)
                    out = [None] * len(chunk)
            mx = score_seen.get(key, -1)
            for (idx, pair), res in zip(chunk, out):
                if res is None:
                    nxt[key].append((idx, pair))
                else:
                    results[idx] = res
                    served[tier] += 1
                    # the score K1 ran to: above a semi-global pair's
                    # score when its global end costs more
                    mx = max(mx, res.final_s)
            if mx >= 0:
                score_seen[key] = mx
        return nxt

    # -- the workers (wfa_tpu/pipeline.py:586-655) ---------------------------

    def _pool(self, kind: str) -> ThreadPoolExecutor:
        """The submit pool (pack, upload, launches: three workers, so that
        one's pack or two-phase mid-point overlaps the others' launches;
        one under a mesh, so that every process launches and gathers in
        the same order, wfa_tpu/pipeline.py:604-620) or the drain pool
        (fetch, results: four), made at first use."""
        if kind == "submit":
            if self._spool is None:
                self._spool = ThreadPoolExecutor(
                    1 if self._mesh is not None
                    else int(os.environ.get("WFA_SUBMIT_WORKERS", "3")),
                    thread_name_prefix="wfa-submit")
            return self._spool
        if self._dpool is None:
            self._dpool = ThreadPoolExecutor(
                int(os.environ.get("WFA_DRAIN_WORKERS", "4")),
                thread_name_prefix="wfa-drain")
        return self._dpool

    def close(self) -> None:
        """Stop the worker threads (a later call starts new ones)."""
        for pool in (self._spool, self._dpool):
            if pool is not None:
                pool.shutdown()
        self._spool = self._dpool = None

    def _submit_one(self, eng: BatchAligner, chunk_pairs, cb: int, tag):
        """Submit worker: launch a batch (``tag``: its ``trace.next_batch``),
        then give back its reservation but for its outputs' bytes, which
        its drain releases; returns (handle, bytes still held)."""
        with trace.batch(tag, queued=True), trace.span(trace.SUBMIT):
            handle = eng.submit_batch(chunk_pairs)
        held = min(cb, handle.nbytes)
        self._mem_release(cb - held)
        return handle, held

    def _drain_from(self, eng: BatchAligner, sub_fut: Future, cb: int,
                    tag):
        """Drain worker: wait for the batch's submit, then fetch it and
        build its results (a fault of the submit surfaces here too).
        Releases the batch's bytes and its slot whatever happens."""
        held = cb
        try:
            handle, held = sub_fut.result()
            with trace.batch(tag), trace.span(trace.DRAIN):
                return eng.finish_batch(handle, fallback=False)
        finally:
            self._mem_release(held)
            self._slot_release()

    # -- the count cap and the byte gate (wfa_tpu/pipeline.py:626-671) -------

    def _slot_acquire(self) -> None:
        """Wait for a slot under the cap on batches in flight."""
        if self._isem is None:
            self._isem = threading.BoundedSemaphore(
                int(os.environ.get("WFA_MAX_INFLIGHT", "8")))
        self._isem.acquire()
        with self._mem_cv:
            self._batches += 1
            self.peak["batches"] = max(self.peak["batches"], self._batches)

    def _slot_release(self) -> None:
        with self._mem_cv:
            self._batches -= 1
        self._isem.release()

    def _gate(self) -> int:
        """The most modelled bytes the batches in flight may reserve."""
        return 2 * self.cfg.mem_budget

    def _mem_acquire(self, nbytes: int) -> None:
        """Block until ``nbytes`` more of modelled device memory fits the
        gate (one batch is always admitted)."""
        with self._mem_cv:
            while (self._mem_used > 0
                   and self._mem_used + nbytes > self._gate()):
                self._mem_cv.wait()
            self._mem_used += nbytes
            self.peak["bytes"] = max(self.peak["bytes"], self._mem_used)

    def _mem_release(self, nbytes: int) -> None:
        with self._mem_cv:
            self._mem_used -= nbytes
            self._mem_cv.notify_all()

    def _device_fault(self, exc: Exception) -> None:
        """Count a device fault and say on stderr what follows
        (wfa_tpu/pipeline.py:673-680); the calling thread's only."""
        self._device_errors += 1
        then = ("falling back to host oracle" if self._device_errors >= 2
                else "retrying")
        print(f"wfa-tpu-torch: device error ({exc}); {then}",
              file=sys.stderr)


def _doomed(out) -> bool:
    """Whether at least 90% of a probe chunk's pairs overflowed."""
    return sum(r is None for r in out) * 10 >= len(out) * 9
