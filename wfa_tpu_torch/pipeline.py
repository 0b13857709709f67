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
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

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
    # device memory one batch may allocate (the pipeline keeps up to two
    # batches in flight); bounds the batch size where s_cap * k_win grows
    mem_budget: int = 16 << 30


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

    def _tier_caps(self, lq: int, lt: int, tier: int, skey=None):
        """(k_win, s_cap, b_cap, engine) for a bucket class and tier
        (0-3).  ``skey`` names the bucket for the adaptive score-cap
        memory."""
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
        return k_win, s_cap, b_cap, engine

    def _engine(self, k_win: int, s_cap: int, engine: str) -> BatchAligner:
        key = (k_win, s_cap, engine)
        eng = self._engines.get(key)
        if eng is None:
            eng = BatchAligner(self.cfg.penalties, self.cfg.options,
                               self.cfg.adaptive, k_win=k_win, s_cap=s_cap,
                               device=self.cfg.device, engine=engine)
            self._engines[key] = eng
        return eng

    def align_all(self, pairs: Sequence[Tuple[bytes, bytes]]
                  ) -> List[AlignmentResult]:
        """Align pairs, returning results in input order."""
        pairs = list(pairs)
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
        pending = bucket_pairs(valid)
        prev_caps = {}  # bucket -> previous tier's caps
        score_seen = {}  # bucket -> max final score observed this call
        # device faults are counted per call (wfa_tpu/pipeline.py:376-379):
        # a faulted chunk retries on the next tier, at the same caps if the
        # ladder has nothing wider, and after two faults the rest finishes
        # on the oracle
        self._device_errors = 0
        for tier in (0, 1, 2, 3):
            if self._device_errors >= 2:
                break
            nxt = {key: [] for key in pending}
            for key, items in pending.items():
                if not items:
                    continue
                lq_max = max(len(p[0]) for _, p in items)
                lt_max = max(len(p[1]) for _, p in items)
                caps = self._tier_caps(lq_max, lt_max, tier, skey=key)
                if prev_caps.get(key) == caps and self._device_errors == 0:
                    # nothing wider on the ladder: go to the fallback (a
                    # fault, by contrast, retries at the same caps)
                    nxt[key] = items
                    continue
                prev_caps[key] = caps
                k_win, s_cap, b_cap, engine = caps
                eng = self._engine(k_win, s_cap, engine)
                bs = min(self.cfg.batch_size, b_cap)
                chunks = [items[i:i + bs] for i in range(0, len(items), bs)]
                mx = score_seen.get(key, -1)
                # one batch ahead: the next batch's host pack and launch
                # overlap the device work of the one being fetched
                handle = self._submit(eng, chunks[0])
                for ci, chunk in enumerate(chunks):
                    nxt_handle = (self._submit(eng, chunks[ci + 1])
                                  if ci + 1 < len(chunks) else None)
                    out = None
                    if handle is not None:
                        try:
                            out = eng.finish_batch(handle, fallback=False)
                        except RuntimeError as exc:
                            self._device_fault(exc)
                    handle = nxt_handle
                    if out is None:  # faulted, or not run after two faults
                        nxt[key].extend(chunk)
                        continue
                    for (idx, pair), res in zip(chunk, out):
                        if res is None:
                            nxt[key].append((idx, pair))
                        else:
                            results[idx] = res
                            served[tier] += 1
                            # the score K1 ran to: above a semi-global
                            # pair's score when its global end costs more
                            mx = max(mx, res.final_s)
                if mx >= 0:
                    score_seen[key] = mx
            pending = nxt
        for items in pending.values():  # final exact fallback
            for idx, (q, t) in items:
                results[idx] = self._oracle.align(q, t)
                served["oracle"] += 1
        # replace, not max-merge: easier workloads shrink the caps again
        self._score_memory.update(score_seen)
        self.served = served
        return results  # type: ignore[return-value]

    def _submit(self, eng: BatchAligner, chunk):
        """``eng.submit_batch`` of a chunk's pairs, or None when the device
        faulted (a RuntimeError: an out-of-memory error, an illegal address)
        or has faulted twice in this call.  Host errors (TypeError,
        ValueError) and kernel errors (``KernelError``: no build, a refused
        launch) propagate: sending them to the oracle would hide a bug."""
        if self._device_errors >= 2:
            return None
        try:
            return eng.submit_batch([p for _, p in chunk])
        except RuntimeError as exc:
            self._device_fault(exc)
            return None

    def _device_fault(self, exc: Exception) -> None:
        """Count a device fault and say on stderr what follows
        (wfa_tpu/pipeline.py:673-680)."""
        self._device_errors += 1
        then = ("falling back to host oracle" if self._device_errors >= 2
                else "retrying")
        print(f"wfa-tpu-torch: device error ({exc}); {then}",
              file=sys.stderr)
