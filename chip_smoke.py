"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase, on one card
    python3 chip_smoke.py --dp     # the build, the data-parallel phases
                                   # over every card, and the CLI

Builds the CUDA kernels from ``wfa_tpu_torch/csrc`` (nvcc, sm_90a), holds
each kernel against its plain PyTorch version on the card, then drives
the main paths through ``AlignmentPipeline.align_all`` (bench.py's
protocol: one warm call, one timed call), each with the launch counts set
to 0 just before its timed call and read just after, and checks evenly
spaced results of each against the port's exact oracle:

* global: 32768 pairs of l=1000, e=0.05, gap-affine 4/6/2, wf-adaptive
  10/50/1, kernels checked on 2048-pair batches; then ``align_iter``
  over the same pairs in chunks of 4096, held to the timed call token
  stream for token stream; then bench.py's l=1000 rows at e=0.10 and
  0.20 (4096 pairs each, one call on a fresh pipeline: the tier ladder
  and its probe), their pairs served per tier printed, 128 results of
  each checked against the oracle, and K1 and K2 checked on the first
  batch each call gave each (k_win, s_cap) it ran (tiers 0 and 1);
* semi-global l=200: 1024 pairs, e=0.05, 4/6/2, 10/50/1, on K1's
  semi-global mode at the full span (512 diagonals), K1-semi and K2
  checked on those pairs; K1-semi is also checked on 256 pairs of l=1000
  at the full span (2048), the shape of the A/B below;
* two-phase semi-global (the route of every semi-global wf-adaptive
  bucket whose full span passes 512 diagonals): 8192 pairs of l=1000 and
  64 pairs of l=10000 (bench.py's two rows, bench.py:183-189), e=0.05,
  4/6/2, 10/50/1.  K3 (phase 1), K4 (phase 2) and K2 over both aux
  tensors are checked on the very batches each path gives them (its first
  batch at each (Kf, S0, k_win, s_cap) it runs), and K3 keeps a record at
  each path's shape (Kf 2048 and 20,096); K3 also at Penalties(4,
  6, 1), the penalties only the TPU's whole-K prefix kernel takes: a
  two-phase run of 256 pairs of l=1000 against the oracle, and K3, K4 and
  K2 checked on the batch that run gave them; K4 keeps a record at each
  of the three (l=1000, l=10000, 4/6/1);
  then semi-global coordinates (``phase_semi_coords``): 4000 pairs of
  30-200 bases at penalties drawn by the fuzz, through the oracle, and
  those whose oracle CIGAR misses a length, with the card fuzz's two such
  pairs, through K1-semi at the full span and the two-phase route, on the
  card and on a mesh of 2 shards of it, held to the oracle on all 11
  fields; then one A/B of the two-phase route against K1-semi at the full
  span on 1024 pairs of l=1000, in turns;
* global reads just past int16 offsets: 4096 pairs of l=4000, e=0.05,
  4/6/2, 10/50/1 (two 2048-pair batches, so that the fitted cap runs
  too), whose longest read lies in (4095 - k_win, 4096]: the route of TPU
  kernel row 3, K1-kw (int16 aux rows row- and value-rebased, one sbase
  word a row) and K2 over those rows, both checked on the path's own
  first batch at each cap it builds; the int32 K1 must not run there;
* long global reads: 64 pairs of l=50000, e=0.05, 4/6/2, 10/50/1
  (bench.py's matrix row), through K1-long and K2 over its rebased aux,
  both checked on those same 64 pairs, the path's one batch (the plain
  K1-long takes ~100 s a call, ~6 ms for each of ~14,600 scores, so it
  runs once, at the higher cap: every pair finishes under both, and its
  rows below the lower cap are the plain output there); all 64 results
  checked against the oracle;
* data parallelism: ``AlignmentPipeline`` over a mesh of every card, or
  of 2 shards of the one card (``PipelineConfig.devices``), global
  l=1000 at the main path's width (32768 pairs), two-phase semi-global
  l=1000 (2048 pairs, and 256 at 4/6/1), semi-global l=200 (1024),
  global l=4000 (4096, K1-kw), l=5000 and l=50000 (64 each, K1-long),
  each held token stream for token stream to a single-device run of the
  same pairs (both with full token streams) and timed against it in
  turns, and each kernel held to its plain version on a shard of the
  mesh's first batch at each engine key (K1-long at l=5000); then
  processes over gloo (this script with ``--dp-worker``), one a card or
  2 on the one card, on 4096 pairs of global l=1000, each returning
  every result equal to a single-process run; both print each shard's
  launches, and every shard must launch every kernel of its path;
* the CLI: ``python -m wfa_tpu_torch.cli -i tests/data/seqs.txt`` on the
  card, byte for byte equal to the same with ``--no-device``;
* then the per-phase cycle split of a score step of K1, K1-long, K1-kw,
  K3 (Kf 2048 and 20,096) and K4 (after each) on their paths' first
  batches (the timed instantiations of ``wfa_tpu_torch.profiling
  --phases``), one line each.

The semi-global l=1000 path checks 256 results, the l=10000 and the long
paths all 64, the others 512; the oracle runs in a pool of one process
per CPU core.  Each main path also prints the most batches its timed
call had in flight at once (the pipeline's submit and drain workers) and
the most modelled device bytes they reserved against the byte gate.

K1, K1-kw and K1-long are checked at each (k_win, s_cap) the paths run:
tier 0's first cap and the cap the score memory fits after the warm call.
A path that builds an engine of caps that GLOBAL_CHECKS, SEMI_CHECKS,
SEMI2_CHECKS, KW_CHECKS or LONG_CHECKS lacks fails the run (after every
phase has run, so one run shows all of them).  Every comparison is integer and
exact: the tolerance is 0.

Exits nonzero on any failure.  The last two lines are one JSON object
per kernel (with ``bound_ms``, the least time the card could take for the
bytes the call must move or the operations it must do) and
``{"ok": true, "device": {...}}``.  Imports no JAX and nothing of the JAX
package ``wfa_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

N_MAIN = 32768
BATCH = 2048  # the main path's batch: K1 and K2 are checked at its shapes
N_CHECK = 512
N_CHECK_SEMI = 256  # the semi-global oracle takes ~0.33 s a pair at l=1000
N_SEMI = 8192  # bench.py's semi-global rows: l=1000, l=200, l=10000
N_SEMI_SHORT = 1024
N_SEMI_LONG = 64  # bench.py:185 and 189
N_LONG = 64  # bench.py's l=50000 row
N_LONG_CHECK = N_LONG  # the oracle takes ~2.2 s a pair at l=50000
# global reads whose longest lies in (4095 - k_win, 4096]: where the JAX
# pipeline takes TPU kernel row 3 (auto:kw, wfa_tpu/pipeline.py:216-223)
# and the port K1-kw
KW_LENGTH = 4000
N_KW = 2 * BATCH  # two batches: the warm call's second fits the score cap
N_BWA = 256  # K3 at Penalties(4, 6, 1)
ITER_CHUNK = 4096  # align_iter's chunk on the global l=1000 pairs
# bench.py's global l=1000 rows at higher error rates: tiers 1-2, the probe
ERROR_RATES = (0.10, 0.20)
N_ERR = 4096
# the data-parallel phases: a mesh over the cards (2 shards of the card
# where there is one); global l=1000 at the main path's width, semi-global
# l=1000 (two-phase), and processes over gloo (one a card, 2 on one card)
N_DP_SEMI = 2048
N_DP_PROC = 4096
# K1-kw and K1-long under the mesh: the K1-kw path's reads and pairs, and
# long reads past LONG_READ (4096) that take K1-long at a tenth of the
# l=50000 path's score steps (its plain version's time is per step)
DP_LONG_LENGTH = 5000
N_DP_LONG = N_LONG
N_ERR_CHECK = 128
# phase_semi_coords: semi-global pairs drawn by the fuzz's generator
N_COORD_GROUPS, COORD_GROUP, COORD_SEED = 100, 40, 0
# K1/K2 checks, (pairs, l, k_win, s_cap): the first of each mode is the
# one the kernels' record reports
GLOBAL_CHECKS = ((BATCH, 1000, 128, 640), (BATCH, 1000, 128, 512))
SEMI_CHECKS = ((256, 1000, 2048, 640), (N_SEMI_SHORT, 200, 512, 256))
# the two-phase paths' (l, Kf, S0, k_win, s_cap), Kf the batch's full
# span: tier 0 of the ladder (S0 64, k_win 256, s_cap 0.55 x the longest
# read rounded up to 128) and the cap the score memory fits after the warm
# call, then tier 1 (S0 112, k_win 512, 3 x tier 0's s_cap) for the pairs
# still wide at S0 = 64 (179 of 8192 at l=1000, 3 of 64 at l=10000)
SEMI2_CHECKS = ((1000, 2048, 64, 256, 640), (1000, 2048, 64, 256, 512),
                (1000, 2048, 112, 512, 1920), (1000, 2048, 112, 512, 1536),
                (10000, 20096, 64, 256, 5632), (10000, 20096, 64, 256, 3712),
                (10000, 20096, 112, 512, 16896),
                (10000, 20096, 112, 512, 11136))
# tier 0 at l=50000 (0.55 x the bucket's longest read, 50,057 bases,
# rounded up to 128), then the cap the score memory fits to this data's
# largest final score (14,748, the oracle's: 1.2 x 14,748 + 16, rounded
# up to 128); all 64 pairs of the path's one batch
LONG_CHECKS = ((N_LONG, 50000, 384, 27648), (N_LONG, 50000, 384, 17792))
# the l=4000 path's caps, KW = k_win 256 (band 104 + drift 47, rounded up
# to 128): tier 0 (0.55 x 4000 rounded up to 128), then the cap the score
# memory fits after the warm call; K1-kw and K2 are checked on the path's
# own first batch at each
KW_CHECKS = ((BATCH, KW_LENGTH, 256, 2304), (BATCH, KW_LENGTH, 256, 1664))

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# device memory bandwidth, and the non-tensor 32-bit rate the score
# loop's integer operations run at
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# where the kernels run (the functions below never fall back to the CPU)
DEVICE = "cuda"
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")
# cap mismatches found by the main paths: reported after every phase ran
DEFERRED = []
# seconds of each step of main, and when the last one ended
LAPS, LAP = {}, [0.0]


def lap(name: str) -> None:
    """Records and prints the seconds since the last step of ``main``
    ended (``LAP``) under ``name``."""
    now = time.perf_counter()
    LAPS[name] = round(now - LAP[0], 1)
    LAP[0] = now
    print(f"step {name}: {LAPS[name]} s", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), its milliseconds on the card): one call between CUDA events;
    for plain versions whose one checked call is also their time."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_err(refs, gots) -> int:
    """Largest absolute difference over pairs of integer tensors (a
    shape or type mismatch fails the run).  Unequal tensors are widened
    a chunk at a time: K1-kw's aux at the path's shape is 7 GiB of int16
    cells."""
    import torch

    err = 0
    for a, b in zip(refs, gots):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        if torch.equal(a, b):
            continue
        fa, fb = a.reshape(-1), b.reshape(-1)
        for i in range(0, fa.numel(), 1 << 26):
            d = fa[i:i + (1 << 26)].long() - fb[i:i + (1 << 26)].long()
            err = max(err, int(d.abs().max()))
    return err


_ORACLE = None  # (pairs, aligner) that the forked oracle workers read


def _oracle_row(i: int):
    pairs, aligner = _ORACLE
    o = aligner.align(*pairs[i])
    return o.cigar(False), tuple(getattr(o, f) for f in FIELDS)


def oracle_check(tag: str, pairs, results, idx, aligner) -> None:
    """Results ``idx`` against the port's oracle, every field, the oracle
    in a pool of forked processes (one a CPU core; they run no CUDA)."""
    import multiprocessing

    global _ORACLE
    _ORACLE = (pairs, aligner)
    t0 = time.perf_counter()
    workers = max(1, min(len(idx), os.cpu_count() or 1))
    with multiprocessing.get_context("fork").Pool(workers) as pool:
        refs = pool.map(_oracle_row, idx, chunksize=1)
    _ORACLE = None
    for i, (cigar, vals) in zip(idx, refs):
        r = results[i]
        if r.cigar(False) != cigar or tuple(
                getattr(r, f) for f in FIELDS) != vals:
            fail(f"{tag}: pair {i} differs from the oracle")
    print(f"{tag}: {len(idx)} results equal the oracle "
          f"({time.perf_counter() - t0:.1f} s, {workers} processes)")


def counters() -> dict:
    """Every kernel wrapper's launch counts, by mode."""
    from wfa_tpu_torch.device_backtrace import device_backtrace
    from wfa_tpu_torch.kernel_engine import (run_batch, run_batch_kw,
                                             run_batch_long, run_prefix,
                                             run_resume)

    return {"score_loop": run_batch.launches,
            "score_loop_kw": run_batch_kw.launches,
            "score_loop_long": run_batch_long.launches,
            "score_loop_prefix": run_prefix.launches,
            "score_loop_resume": run_resume.launches,
            "backtrace": device_backtrace.launches}


def reset_counters() -> None:
    for counts in counters().values():
        counts.update(dict.fromkeys(counts, 0))


def read_counters() -> dict:
    return {name: dict(c) for name, c in counters().items()}


class record_batches:
    """Within the block, the first batch each engine is given, by engine
    key: ("semi2", Kf, S0, k_win, s_cap) or (engine, k_win, s_cap).  With
    ``mesh``, only the batches of aligners that shard over a mesh, each
    padded to a multiple of the mesh size as the mesh pads it (its shards
    are its equal slices); else only those of single-device aligners."""

    def __init__(self, mesh: bool = False):
        self.mesh = mesh

    def __enter__(self):
        import numpy as np
        from wfa_tpu_torch.engine import BatchAligner
        from wfa_tpu_torch.semi2 import prefix_span

        self.seen, self._orig = {}, BatchAligner.submit_batch
        seen, orig, want_mesh = self.seen, self._orig, self.mesh

        def submit(eng, pairs, prepacked=None):
            pairs = list(pairs)
            if (eng.mesh is not None) == want_mesh:
                batch = pairs
                if eng.mesh is not None:
                    batch = pairs + [(b"A", b"A")] * (
                        (-len(pairs)) % eng.mesh.size)
                c = eng.cfg
                if eng.engine == "semi2":
                    lens = np.array([(len(q), len(t)) for q, t in batch])
                    key = ("semi2", prefix_span(lens[:, 0], lens[:, 1]),
                           eng.s_switch, c.k_win, c.s_cap)
                else:
                    key = (eng.engine, c.k_win, c.s_cap)
                seen.setdefault(key, batch)  # from the submit workers
            return orig(eng, pairs, prepacked)

        BatchAligner.submit_batch = submit
        return self.seen

    def __exit__(self, *exc):
        from wfa_tpu_torch.engine import BatchAligner

        BatchAligner.submit_batch = self._orig
        return False


def bound(nbytes: int, ops: int) -> dict:
    """The least time for a call: its bytes over the memory rate or its
    operations over the ALU rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}  # no PyTorch call runs a WFA score loop


def phase_build() -> None:
    from wfa_tpu_torch import _build
    from wfa_tpu_torch.profiling import ptxas_table

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s (nvcc {_build.build_seconds}) "
          f"flags {' '.join(_build.NVCC_FLAGS)}")
    for line in ptxas_table(_build.build_log):
        print(f"  ptxas: {line}")


def phase_steps(card: str) -> None:
    """The score loop's per-phase cycle split of K1, K1-long, K1-kw, K3
    and K4 on their paths' first batches (``profiling.phase_split``: the
    timed instantiations, which no path runs), one JSON line each."""
    from wfa_tpu_torch.profiling import (PHASE_BATCHES, RESUME_BATCHES,
                                         SEMI2_BATCHES, phase_split)

    for name in (*PHASE_BATCHES, *SEMI2_BATCHES, *RESUME_BATCHES):
        print(f"phases {name} on {card}: {json.dumps(phase_split(name))}",
              flush=True)


def check_kernels(checks, global_alignment: bool, reps: int,
                  long: bool = False):
    """K1 (K1-long) and K2 against their plain versions at each shape of
    ``checks``; returns the two records (times and bounds of the first
    shape, max_abs_err over all)."""
    import torch
    from wfa_tpu_torch.profiling import kernel_batch

    recs = None
    plain = {}  # K1-long's plain output, kept for the next, lower cap
    for n, length, k_win, s_cap in checks:
        torch.cuda.empty_cache()
        cfg, ins = kernel_batch(n, length, k_win, s_cap,
                                global_alignment=global_alignment)
        rec1, k1_out = (phase_k1_long(cfg, ins, reps, plain) if long
                        else phase_k1(cfg, ins, reps))
        rec2 = phase_k2(cfg, ins, k1_out, long=long)
        del k1_out, ins
        if recs is None:
            recs = (rec1, rec2)
        for rec, new in zip(recs, (rec1, rec2)):
            rec["max_abs_err"] = max(rec["max_abs_err"], new["max_abs_err"])
    del plain
    torch.cuda.empty_cache()
    return recs


def k1_bound(cfg, ins, final_s, ok, cell_bytes: int, base_bytes: int = 0):
    """Bytes and operations a score-loop call must spend: read the rows
    and lengths once, write the aux rows 0..final_s of the pairs it
    finished (3 planes of K cells, KW in the KW mode, of ``cell_bytes``,
    plus a base or sbase word per row in the long-read and KW modes) and
    the out rows; one operation per aux cell."""
    qb, tbuf = ins[:2]
    B = qb.shape[0]
    rows = int((final_s.long() + 1)[ok].sum())
    cells = 3 * rows * (cfg.aux_kw or cfg.k_win)
    nbytes = (qb.numel() + tbuf.numel() + 12 * B + 28 * B
              + cells * cell_bytes + rows * base_bytes)
    return bound(nbytes, cells)


def phase_k1(cfg, ins, reps: int = 10):
    """K1 against run_batch_plain on the card; returns (record, outputs)."""
    import torch
    from wfa_tpu_torch.engine import run_batch_plain
    from wfa_tpu_torch.kernel_engine import run_batch

    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    args = (qb, tbuf, qlen, tlen, toff)
    kw = dict(cfg=cfg, Lq=Lq, Ltb=Ltb)
    name = "score_loop" if cfg.global_alignment else "score_loop_semi"
    ref = run_batch_plain(*args, **kw)
    got = run_batch(*args, **kw)
    torch.cuda.synchronize()
    names = ("final_s", "done", "overflow", "term_cell", "end_s", "end_k",
             "end_cell")
    for field, a, b in zip(names, ref[:4] + ref[5], got[:4] + got[5]):
        if not torch.equal(a, b):
            fail(f"{name} {field} differs on {int((a != b).sum())} pairs")
    ok = ref[1] & ~ref[2]
    # the aux rows 0..final_s of done pairs, 64 rows at a time (at the
    # e=0.20 path's tier-1 caps each aux is 17 GB)
    last, okm = ref[0][None, None, :, None], ok[None, None, :, None]
    err = bad = 0
    for s0 in range(0, cfg.s_cap, 64):
        rows = torch.arange(s0, min(s0 + 64, cfg.s_cap),
                            device=qb.device)[None, :, None, None]
        diff = torch.where((rows <= last) & okm,
                           (ref[4][:, s0:s0 + 64] - got[4][:, s0:s0 + 64])
                           .abs(), 0)
        err, bad = max(err, int(diff.max())), bad + int((diff != 0).sum())
    if err:
        fail(f"{name} aux differs in {bad} cells")
    del ref, diff
    plain_ms = cuda_ms(lambda: run_batch_plain(*args, **kw), 1)
    ms = cuda_ms(lambda: run_batch(*args, **kw), reps)
    n = qb.shape[0]
    rec = {"name": name, "route": "cuda",
           "source": "wfa_tpu_torch/csrc/score_loop.cu",
           "replaces": ("wfa_tpu/pallas_engine.py:95" if cfg.global_alignment
                        else "wfa_tpu/pallas_engine.py:726"),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **k1_bound(cfg, ins, got[0], ok, 4)}
    print(f"K1 {name} == run_batch_plain: {n} pairs, k_win {cfg.k_win}, "
          f"s_cap {cfg.s_cap}, {int(ok.sum())} done, max_abs_err {err} "
          f"(tolerance 0); kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec, got


def phase_k1_long(cfg, ins, reps: int = 3, plain=None):
    """K1-long against run_batch_long_plain on the card: every out row of
    every pair, the int16 aux rows and their bases 0..final_s of done
    pairs.  The plain version's one checked call is also its time.
    ``plain`` (a dict) keeps the plain output for the next call on the
    same inputs: at a lower cap that every pair finished under, its rows
    below that cap are the plain output there, and it is not run again."""
    import torch
    from wfa_tpu_torch.engine import run_batch_long_plain
    from wfa_tpu_torch.kernel_engine import run_batch_long

    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    args = (qb, tbuf, qlen, tlen, toff)
    kw = dict(cfg=cfg, Lq=Lq, Ltb=Ltb)
    name = "score_loop_long"
    kept = (plain or {}).get("out")
    if kept is not None and bool(kept[1].all()) and (
            int(kept[0].max()) < cfg.s_cap <= kept[5].shape[1]):
        ref = (*kept[:4], kept[4][:, :cfg.s_cap], kept[5][:, :cfg.s_cap])
        plain_ms, plain_peak = plain["ms"], plain["peak"]
        how = f"reused from s_cap {kept[5].shape[1]}"
    else:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = run_batch_long_plain(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        how = f"{plain_ms:.1f} ms"
        if plain is not None:
            plain.update(out=ref, ms=plain_ms, peak=plain_peak)
    got = run_batch_long(*args, **kw)
    torch.cuda.synchronize()
    for field, a, b in zip(("final_s", "done", "overflow", "term_cell"),
                           ref[:4], got[:4]):
        if not torch.equal(a, b):
            fail(f"{name} {field} differs on {int((a != b).sum())} pairs")
    ok = ref[1] & ~ref[2]
    if not bool(ok.all()):
        fail(f"{name}: {int((~ok).sum())} pairs not done at s_cap "
             f"{cfg.s_cap}")
    rows = torch.arange(cfg.s_cap, device=qb.device)
    mask = rows[None, :] <= ref[0][:, None]  # [B, S]
    err = int(torch.where(mask, (ref[5] - got[5]).abs(), 0).max())
    for c in range(3):  # one plane at a time keeps the temporaries small
        d = (ref[4][c].int() - got[4][c].int()).abs()  # [S, B, K]
        err = max(err, int(torch.where(mask.t()[:, :, None], d, 0).max()))
    if err:
        fail(f"{name} aux or aux_base differs (max_abs_err {err})")
    del ref
    ms = cuda_ms(lambda: run_batch_long(*args, **kw), reps)
    rec = {"name": name, "route": "cuda",
           "source": "wfa_tpu_torch/csrc/score_loop.cu",
           "replaces": "wfa_tpu/pallas_longread.py:168",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **k1_bound(cfg, ins, got[0], ok, 2, 4)}
    print(f"K1 {name} == run_batch_long_plain: {qb.shape[0]} pairs, k_win "
          f"{cfg.k_win}, s_cap {cfg.s_cap}, final_s max "
          f"{int(got[0].max())}, max_abs_err {err} (tolerance 0); kernel "
          f"{ms:.3f} ms, plain {how} (peak device memory "
          f"{plain_peak:.2f} GiB), bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return rec, got


def phase_k1_kw(cfg, ins, reps: int = 3):
    """K1-kw against run_batch_kw_plain on the card: every out row of every
    pair, the int16 aux rows and sbase words 0..final_s of served pairs
    (the rest zeroed on both sides, ``engine.canonical_kw``).  The plain
    version's one checked call is also its time.  Then int32 K1 and K1-kw
    on the same batch in turns (K1, K1-kw, K1-kw, K1), and K2 over each
    one's aux in turns, printed beside the record."""
    import torch
    from wfa_tpu_torch.device_backtrace import device_backtrace
    from wfa_tpu_torch.engine import (_token_plan, canonical_kw,
                                      run_batch_kw_plain)
    from wfa_tpu_torch.kernel_engine import run_batch, run_batch_kw

    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    args = (qb, tbuf, qlen, tlen, toff)
    kw = dict(cfg=cfg, Lq=Lq, Ltb=Ltb)
    name = "score_loop_kw"
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    ref, plain_ms = timed_once(lambda: run_batch_kw_plain(*args, **kw))
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    ref = canonical_kw(ref)
    got = run_batch_kw(*args, **kw)
    torch.cuda.synchronize()
    gotc = canonical_kw(got)
    err = max_err(ref, gotc)
    if err:
        names = ("final_s", "done", "overflow", "term_cell", "aux", "sbase")
        bad = [n for n, a, b in zip(names, ref, gotc) if not torch.equal(a, b)]
        fail(f"{name} differs from run_batch_kw_plain in {bad} "
             f"(max_abs_err {err})")
    ok = ref[1] & ~ref[2]
    cb = int((gotc[5] & 31).max())  # the largest row base of a served row
    del ref, gotc
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: run_batch_kw(*args, **kw), reps)
    turns = [cuda_ms(lambda: run_batch(*args, **kw), reps),
             cuda_ms(lambda: run_batch_kw(*args, **kw), reps),
             cuda_ms(lambda: run_batch_kw(*args, **kw), reps),
             cuda_ms(lambda: run_batch(*args, **kw), reps)]
    # K2 over int32 K1's aux and over K1-kw's (one more dependent load a
    # step, the sbase word that places the cell): the same tokens, and
    # their times in turns on this batch
    k1 = run_batch(*args, **kw)
    ak, ok2 = tlen - qlen, ok & k1[1] & ~k1[2]
    shift, _ = _token_plan(cfg.s_cap, cfg.penalties, Lq, Ltb)
    bkw = dict(penalties=cfg.penalties, S=cfg.s_cap, token_shift=shift,
               split_ext_codes=True)

    def k2(kw_aux: bool):
        if kw_aux:
            return device_backtrace(got[4], got[3], -toff, got[0], ak, qlen,
                                    tlen, ok2, K=cfg.aux_kw,
                                    aux_sbase=got[5], **bkw)
        return device_backtrace(k1[4], k1[3], -toff, k1[0], ak, qlen, tlen,
                                ok2, K=cfg.k_win, **bkw)

    if not all(torch.equal(a, b) for a, b in zip(k2(False), k2(True))):
        fail("K2 tokens over K1-kw's aux differ from those over int32 K1's")
    k2_turns = [cuda_ms(lambda: k2(False), reps), cuda_ms(lambda: k2(True), reps),
                cuda_ms(lambda: k2(True), reps), cuda_ms(lambda: k2(False), reps)]
    del k1
    torch.cuda.empty_cache()
    rec = {"name": name, "route": "cuda",
           "source": "wfa_tpu_torch/csrc/score_loop.cu",
           "replaces": "wfa_tpu/pallas_engine.py:775",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **k1_bound(cfg, ins, got[0], ok, 2, 4)}
    print(f"K1 {name} == run_batch_kw_plain: {qb.shape[0]} pairs, k_win "
          f"{cfg.k_win}, KW {cfg.aux_kw}, s_cap {cfg.s_cap}, {int(ok.sum())} "
          f"served, final_s max {int(got[0].max())}, largest row base cb "
          f"{cb}, max_abs_err {err} (tolerance 0); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms (peak device memory {plain_peak:.2f} GiB, "
          f"{held:.2f} GiB held before it), bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}); in turns "
          f"int32 K1 {turns[0]:.3f}, K1-kw {turns[1]:.3f}, K1-kw "
          f"{turns[2]:.3f}, int32 K1 {turns[3]:.3f} ms; K2 over them in "
          f"turns {k2_turns[0]:.3f} (int32), {k2_turns[1]:.3f} (KW), "
          f"{k2_turns[2]:.3f} (KW), {k2_turns[3]:.3f} (int32) ms")
    return rec, got


def check_kw_batches(seen, reps: int):
    """K1-kw and K2 over its sbase words on each batch the l=4000 path gave
    them (its first at each (k_win, s_cap)); returns the two records,
    with the times of the first batch."""
    import torch
    from wfa_tpu_torch import AdaptiveReductionOption, Penalties
    from wfa_tpu_torch.engine import EngineConfig, _pack_all, inputs_from_packed

    recs = None
    for (engine, k_win, s_cap), pairs in seen.items():
        if engine != "kw":
            fail(f"the l={KW_LENGTH} path ran engine {engine!r}")
        cfg = EngineConfig(penalties=Penalties(4, 6, 2),
                           adaptive=AdaptiveReductionOption(10, 50, 1),
                           k_win=k_win, s_cap=s_cap, aux_kw=k_win)
        ins = inputs_from_packed(_pack_all(pairs, k_win), DEVICE)
        rec1, out = phase_k1_kw(cfg, ins, reps)
        new = (rec1, phase_k2(cfg, ins, out, reps=reps, rows_kw=True))
        del out, ins
        torch.cuda.empty_cache()
        if recs is None:
            recs = new
        else:
            merge(recs, new)
    return recs


def phase_k2(cfg, ins, k1_out, reps: int = 10, long: bool = False,
             rows_kw: bool = False):
    """K2 against device_backtrace_plain on K1's aux (K1-long's rebased
    aux with its bases, or K1-kw's with its sbase words: ``rows_kw``),
    from K1's end."""
    import torch
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain,
                                                iter_capacity)
    from wfa_tpu_torch.engine import _token_plan

    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    aux_base = sbase = None
    if long or rows_kw:
        final_s, done, overflow, term_cell, aux, base = k1_out
        end_s, end_k, end_cell = final_s, tlen - qlen, term_cell
        if long:
            aux_base = base
        else:
            sbase = base
    else:
        _, done, overflow, _, aux, (end_s, end_k, end_cell) = k1_out
    shift, _ = _token_plan(cfg.s_cap, cfg.penalties, Lq, Ltb)
    ga = cfg.global_alignment
    name = ("backtrace_long" if long else "backtrace_kw" if rows_kw
            else "backtrace" if ga else "backtrace_semi")
    args = (aux, end_cell, -toff, end_s, end_k, qlen, tlen, done & ~overflow)
    kw = dict(penalties=cfg.penalties, S=cfg.s_cap,
              K=cfg.aux_kw if rows_kw else cfg.k_win, token_shift=shift,
              split_ext_codes=ga, global_alignment=ga, aux_base=aux_base,
              aux_sbase=sbase, return_iters=True)
    ref = device_backtrace_plain(*args, **kw)
    got = device_backtrace(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for field, a, b in zip(("tok0", "buf", "tail", "iters"), ref, got):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{name} {field}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        d = int((a.int() - b.int()).abs().max())
        if d:
            fail(f"{name} {field} differs in {int((a != b).sum())} slots")
        err = max(err, d)
    plain_ms = cuda_ms(lambda: device_backtrace_plain(*args, **kw), 1)
    ms = cuda_ms(lambda: device_backtrace(*args, **kw), reps)
    # bytes: the scalar inputs, one aux cell (and base or sbase word) per
    # chase step, every token slot and the iteration counts
    B = qb.shape[0]
    steps = int(got[3].long().sum())
    cell = (2 + 4) if long or rows_kw else 4
    tok = got[0].element_size()
    slots = 1 + 2 * iter_capacity(cfg.s_cap, cfg.penalties) + 4
    nbytes = 25 * B + steps * cell + slots * B * tok + 4 * B
    rec = {"name": name, "route": "cuda",
           "source": "wfa_tpu_torch/csrc/backtrace.cu",
           "replaces": "wfa_tpu/device_backtrace.py:276",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes, steps)}
    print(f"K2 {name} == device_backtrace_plain: {B} pairs, k_win "
          f"{cfg.k_win}, s_cap {cfg.s_cap}, {steps} chase steps, "
          f"max_abs_err {err} (tolerance 0); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return rec


def phase_main(n: int, length: int, global_alignment: bool, batch: int,
               n_check: int, card: str, checks, need, semi2_checks=(),
               iter_chunk: int = 0):
    """One main path: a warm call, then the timed call with the launch
    counts set to 0 just before it.  Fails if a kernel of ``need``
    ((counter, mode) pairs) was launched no time; defers a failure for
    caps that ``checks`` ((pairs, l, k_win, s_cap) of K1 and K1-long) or
    ``semi2_checks`` ((l, Kf, S0, k_win, s_cap)) lack.  Prints the most
    batches the timed call had in flight at once and the most modelled
    bytes they reserved against the gate.  With ``iter_chunk``, then
    runs ``align_iter`` over the pairs in chunks of that many
    (``phase_iter``).  Returns the timed call's launch counts and the
    first batch each engine was given in either call
    (``record_batches``)."""
    import torch
    from wfa_tpu_torch import (AdaptiveReductionOption, OracleAligner,
                               Options, Penalties)
    from wfa_tpu_torch.datagen import generate_pairs
    from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

    tag = f"main {'global' if global_alignment else 'semi'} l={length}"
    pen, opts = Penalties(4, 6, 2), Options(global_alignment)
    ad = AdaptiveReductionOption(10, 50, 1)
    pipe = AlignmentPipeline(PipelineConfig(pen, opts, ad, batch_size=batch,
                                            device=DEVICE))
    t0 = time.perf_counter()
    pairs = generate_pairs(n, length, 0.05, seed=42)
    print(f"{tag}: {n} pairs generated in {time.perf_counter() - t0:.1f} s")
    with record_batches() as seen:
        t0 = time.perf_counter()
        pipe.align_all(pairs)  # warm
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        faults = [(pipe._device_errors, pipe.served["oracle"])]
        reset_counters()
        t0 = time.perf_counter()
        results = pipe.align_all(pairs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counters()
        faults.append((pipe._device_errors, pipe.served["oracle"]))
    caps, runs = set(), set()
    for (k_win, s_cap, _), eng in pipe._engines.items():
        if eng.engine == "semi2":
            runs |= {(length, kf, eng.s_switch, k_win, s_cap)
                     for kf in eng.spans}
        else:
            caps.add((k_win, s_cap))
    engines = sorted({k[2] for k in pipe._engines})
    print(f"{tag}: align_all {n} pairs in {secs:.3f} s = {n / secs:.1f} "
          f"aln/s (warm call {warm:.3f} s) on {card}")
    print(f"{tag}: launches {launches}; pairs served per tier "
          f"{pipe.served}; engines {engines}, (k_win, s_cap) {sorted(caps)}, "
          f"two-phase (l, Kf, S0, k_win, s_cap) {sorted(runs)}")
    print(f"{tag}: at most {pipe.peak['batches']} batches in flight, "
          f"{pipe.peak['bytes'] / 2**30:.3f} GiB reserved of the gate's "
          f"{pipe.peak['gate'] / 2**30:.1f} GiB")
    # the pipeline's device-fault retry must not have run: no fault, and
    # no pair left to the host oracle, in the warm call or the timed one
    if any(errors or oracle for errors, oracle in faults):
        fail(f"{tag}: (device faults, pairs served by the oracle) of the "
             f"warm and the timed call {faults}")
    for counter, mode in need:
        if launches[counter][mode] <= 0:
            fail(f"{tag} launched {counter} ({mode}) no time")
    unchecked = caps - {c[2:] for c in checks}
    if unchecked:
        DEFERRED.append(f"{tag} ran K1 at unchecked (k_win, s_cap) "
                        f"{sorted(unchecked)}")
    unchecked = runs - set(semi2_checks)
    if unchecked:
        DEFERRED.append(f"{tag} ran the two-phase route at unchecked (l, "
                        f"Kf, S0, k_win, s_cap) {sorted(unchecked)}")
    if len(results) != n or any(r is None or r.error for r in results):
        fail(f"{tag} returned missing or failed results")
    if iter_chunk:
        phase_iter(pipe, pairs, results, iter_chunk, tag)
    pipe.close()  # no worker threads across the oracle pool's fork
    idx = list(range(0, n, max(1, n // n_check)))[:n_check]
    oracle_check(tag, pairs, results, idx, OracleAligner(pen, opts, ad))
    return launches, seen


def token_stream(res):
    """The token array a device result was made from (before its lazy
    decode)."""
    toks = res._raw_tokens
    return toks[0] if isinstance(toks, tuple) else toks


def phase_iter(pipe, pairs, results, chunk: int, tag: str) -> None:
    """``align_iter`` over ``pairs`` in chunks of ``chunk`` against the
    timed ``align_all``'s ``results``: every pair from the device, with
    the same score, final score and token stream."""
    import numpy as np

    t0 = time.perf_counter()
    streamed = list(pipe.align_iter(iter(pairs), chunk=chunk))
    secs = time.perf_counter() - t0
    if pipe._device_errors or len(streamed) != len(results):
        fail(f"{tag} align_iter: {len(streamed)} results, "
             f"{pipe._device_errors} device faults")
    for i, (a, b) in enumerate(zip(results, streamed)):
        if (getattr(b, "final_s", None) is None
                or (a.score, a.final_s) != (b.score, b.final_s)
                or not np.array_equal(token_stream(a), token_stream(b))):
            fail(f"{tag} align_iter differs from align_all at pair {i}")
    print(f"{tag}: align_iter in chunks of {chunk} equals align_all, token "
          f"stream for token stream, on all {len(pairs)} pairs "
          f"({secs:.3f} s)")


def phase_errors(card: str, recs) -> None:
    """bench.py's global l=1000 rows at e=0.10 and 0.20 (bench.py:143-144),
    which retry up the tier ladder and probe it: each on a fresh pipeline
    (batch 2048), one call, the pairs served per tier printed and a
    sample held to the oracle; then K1 and K2 against their plain versions
    on the first batch the call gave each (k_win, s_cap), their
    max_abs_err folded into ``recs`` (the global K1 and K2 records).  A
    device fault fails the phase; pairs the ladder sends to the oracle do
    not."""
    import torch
    from wfa_tpu_torch import (AdaptiveReductionOption, OracleAligner,
                               Options, Penalties)
    from wfa_tpu_torch.datagen import generate_pairs
    from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

    pen, ad = Penalties(4, 6, 2), AdaptiveReductionOption(10, 50, 1)
    for err in ERROR_RATES:
        tag = f"global l=1000 e={err:.2f}"
        pairs = generate_pairs(N_ERR, 1000, err, seed=42)
        pipe = AlignmentPipeline(PipelineConfig(pen, Options(True), ad,
                                                batch_size=BATCH,
                                                device=DEVICE))
        with record_batches() as seen:
            t0 = time.perf_counter()
            results = pipe.align_all(pairs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        pipe.close()
        print(f"{tag}: align_all {N_ERR} pairs in {secs:.3f} s = "
              f"{N_ERR / secs:.1f} aln/s (first call) on {card}; pairs "
              f"served per tier {pipe.served}; engines "
              f"{sorted(pipe._engines)}; at most {pipe.peak['batches']} "
              f"batches in flight, {pipe.peak['bytes'] / 2**30:.3f} GiB "
              f"reserved of {pipe.peak['gate'] / 2**30:.1f} GiB")
        if pipe._device_errors:
            fail(f"{tag}: {pipe._device_errors} device faults")
        if len(results) != N_ERR or any(r is None or r.error
                                        for r in results):
            fail(f"{tag} returned missing or failed results")
        idx = list(range(0, N_ERR, N_ERR // N_ERR_CHECK))[:N_ERR_CHECK]
        oracle_check(tag, pairs, results, idx,
                     OracleAligner(pen, Options(True), ad))
        for (engine, k_win, s_cap), batch in seen.items():
            if engine != "auto":
                fail(f"{tag} ran engine {engine!r}")
            check_batch(batch, pen, True, k_win, s_cap, 3, recs)


def phase_semi2(pairs, pen, S0: int, k_win: int, s_cap: int, reps: int,
                tag: str, shards: int = 1, shard: int = 0):
    """K3, K4 and K2 over both aux tensors against their plain versions on
    one batch of the two-phase route: K3 on the packed pairs, K4 on K3's
    exports and the re-placed targets, K2 on K4's aux and K3's aux_old.
    The exports and aux rows the kernels leave unspecified are zeroed in
    both (``semi2.canonical_exports`` / ``canonical_resume``).  Each plain
    version's one checked call is also its time.  Returns the three
    records.  With ``shards``, on shard ``shard`` of the batch as a mesh
    runs it: packed whole, K3 on each shard, the targets re-placed over
    the whole batch (``Ltb2`` batch-wide), K4 and K2 on the shard."""
    import dataclasses

    import numpy as np
    import torch
    from wfa_tpu_torch import AdaptiveReductionOption
    from wfa_tpu_torch import semi2 as ts
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain,
                                                iter_capacity)
    from wfa_tpu_torch.engine import (EngineConfig, _pack_all, _token_plan,
                                      inputs_from_packed,
                                      run_batch_resume_plain, windows)
    from wfa_tpu_torch.kernel_engine import run_prefix, run_resume

    cfg = EngineConfig(penalties=pen, global_alignment=False,
                       adaptive=AdaptiveReductionOption(10, 50, 1),
                       k_win=k_win, s_cap=s_cap)
    packed = _pack_all(pairs, k_win, global_alignment=False)
    whole = inputs_from_packed(packed, DEVICE)
    lb = len(pairs) // shards
    parts = [slice(i * lb, (i + 1) * lb) for i in range(shards)]
    qb, tbuf, qlen, tlen, toff = (a[parts[shard]] for a in whole[:5])
    Lq, Ltb = whole[5:]
    B = qb.shape[0]
    Kf = ts.prefix_span(packed[2], packed[3])
    wm, we = windows(pen)
    export_bytes = 4 * B * ((wm + 2 * we + 3) * k_win
                            + 3 * (wm + 2 * we) + len(ts.META1_COLS))
    src = "wfa_tpu_torch/csrc/score_loop.cu"

    # ---- K3
    args = (qb, tbuf, qlen, tlen, toff)
    pkw = dict(cfg=dataclasses.replace(cfg, k_win=Kf), Lq=Lq, Ltb=Ltb,
               S0=S0, K2=k_win)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: ts.prefix_export_plain(*args, **pkw))
    ex = run_prefix(*args, **pkw)
    torch.cuda.synchronize()
    ref, got = ts.canonical_exports(ref), ts.canonical_exports(ex)
    err = max_err([ref[k] for k in ref], [got[k] for k in ref])
    del ref, got
    if err:
        fail(f"{tag} K3 exports differ (max_abs_err {err})")
    ms = cuda_ms(lambda: run_prefix(*args, **pkw), reps)
    m1 = ex["meta1"]
    done1 = m1[:, ts.M1_DONE] > 0
    rows = int(torch.where(done1, (m1[:, ts.M1_FS] + 1).clamp(max=S0),
                           S0).sum())
    cells = 3 * rows * Kf
    nbytes = (qb.numel() + tbuf.numel() + 12 * B + export_bytes
              + cells * ex["aux_old"].element_size())
    rec3 = {"name": "score_loop_prefix", "route": "cuda", "source": src,
            "replaces": "wfa_tpu/pallas_prefix.py:92", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(nbytes, cells)}
    live = int((~done1 & (m1[:, ts.M1_OVF] == 0)).sum())
    print(f"K3 {tag}: {B} pairs, Kf {Kf}, S0 {S0}, K2 {k_win}, "
          f"{int(done1.sum())} done and {live} live at S0, max_abs_err "
          f"{err} (tolerance 0); kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {rec3['bound_ms']:.4f} ms ({rec3['bound_by']})")

    # ---- K4 on K3's exports; the other shards' K3 gives their k02
    k02 = np.concatenate([
        (m1 if i == shard else run_prefix(
            *(a[r] for a in whole[:5]), **pkw)["meta1"])[:, ts.M1_K02]
        .cpu().numpy() for i, r in enumerate(parts)])
    t2raw, _, toff2, Ltb2 = ts.replace_targets([t for _, t in pairs], k02)
    tb2 = torch.from_numpy(t2raw[parts[shard]]).to(DEVICE)
    toff2 = torch.from_numpy(toff2[parts[shard]]).to(DEVICE)
    keys = ("win_m", "win_i", "win_d", "ainit", "b_m", "b_ie", "meta1")
    r_args = (qb, tb2, qlen, tlen, toff2, *(ex[k] for k in keys))
    rkw = dict(cfg=cfg, Lq=Lq, Ltb2=Ltb2, Ltb_full=Ltb, S0=S0)
    ref, plain_ms = timed_once(lambda: run_batch_resume_plain(*r_args, **rkw))
    res = run_resume(*r_args, **rkw)
    torch.cuda.synchronize()
    ref, got = ts.canonical_resume(ref, S0), ts.canonical_resume(res, S0)
    err = max_err(ref[:5] + ref[5], got[:5] + got[5])
    del ref, got
    if err:
        fail(f"{tag} K4 differs (max_abs_err {err})")
    ms = cuda_ms(lambda: run_resume(*r_args, **rkw), reps)
    final_s, done, overflow = res[:3]
    ok = done & ~overflow
    ran = ok & (final_s >= S0)
    rows = int((final_s - S0 + 1)[ran].sum())
    cells = 3 * rows * k_win
    nbytes = (qb.numel() + tb2.numel() + 12 * B + export_bytes + 28 * B
              + cells * res[4].element_size())
    rec4 = {"name": "score_loop_resume", "route": "cuda", "source": src,
            "replaces": "wfa_tpu/pallas_engine.py:1394", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(nbytes, cells)}
    print(f"K4 {tag}: {B} pairs, K {k_win}, s_cap {s_cap}, Ltb2 {Ltb2}, "
          f"{int(ran.sum())} finished in phase 2, {int(ok.sum())} done in "
          f"all, max_abs_err {err} (tolerance 0); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, bound {rec4['bound_ms']:.4f} ms "
          f"({rec4['bound_by']})")

    # ---- K2 over both aux tensors, from K4's ends
    shift, _ = _token_plan(s_cap, pen, Lq, Ltb)
    end_s, end_k, end_cell = res[5]
    bt_args = (res[4], end_cell, -toff2, end_s, end_k, qlen, tlen, ok)
    kw = dict(penalties=pen, S=s_cap, K=k_win, token_shift=shift,
              global_alignment=False, aux_old=ex["aux_old"],
              k0_old=-(qlen - 1), s_split=S0, return_iters=True)
    ref, plain_ms = timed_once(lambda: device_backtrace_plain(*bt_args, **kw))
    got = device_backtrace(*bt_args, **kw)
    torch.cuda.synchronize()
    err = max_err(ref, got)
    if err:
        fail(f"{tag} K2 over both aux tensors differs (max_abs_err {err})")
    ms = cuda_ms(lambda: device_backtrace(*bt_args, **kw), reps)
    steps = int(got[3].long().sum())
    slots = 1 + 2 * iter_capacity(s_cap, pen) + 4
    nbytes = (25 * B + steps * 4 + slots * B * got[0].element_size()
              + 4 * B)
    rec2 = {"name": "backtrace_semi2", "route": "cuda",
            "source": "wfa_tpu_torch/csrc/backtrace.cu",
            "replaces": "wfa_tpu/device_backtrace.py:276",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(nbytes, steps)}
    print(f"K2 {tag} (both aux tensors): {B} pairs, {steps} chase steps, "
          f"max_abs_err {err} (tolerance 0); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, bound {rec2['bound_ms']:.4f} ms "
          f"({rec2['bound_by']})")
    del ex, res, got, ref
    torch.cuda.empty_cache()
    return rec3, rec4, rec2


def merge(recs, new) -> None:
    """Fold later checks into the first: max_abs_err over all."""
    for rec, n in zip(recs, new):
        rec["max_abs_err"] = max(rec["max_abs_err"], n["max_abs_err"])


def check_own_batches(seen, length: int, reps: int, recs, k1_recs,
                      pen=None, tag: str = "", shards: int = 1,
                      shard: int = 0):
    """The two-phase route's kernels on each batch a path gave them (its
    first at each engine key), and K1-semi and K2 on the batches of its
    full-span last tier, at ``pen`` (default 4/6/2); the first batch's
    times stay in ``recs`` (K3, K4, K2) unless it is already filled.
    ``shards``/``shard``: the batches went to a mesh, and the kernels are
    checked on that shard of each (``shard_ins``)."""
    from wfa_tpu_torch import Penalties

    pen = pen or Penalties(4, 6, 2)
    for key, pairs in seen.items():
        if key[0] == "semi2":
            _, Kf, S0, k_win, s_cap = key
            new = phase_semi2(pairs, pen, S0, k_win, s_cap, reps,
                              f"{tag}l={length} Kf {Kf} S0 {S0} "
                              f"({len(pairs)} pairs, s_cap {s_cap})",
                              shards, shard)
            if not recs:
                recs.extend(new)
            else:
                merge(recs, new)
            continue
        _, k_win, s_cap = key
        check_batch(pairs, pen, False, k_win, s_cap, reps, k1_recs,
                    shards=shards, shard=shard)


def shard_ins(pairs, k_win: int, global_alignment: bool, shards: int = 1,
              shard: int = 0):
    """K1's inputs (qb, tbuf, qlen, tlen, toff, Lq, Ltb) on the card for
    shard ``shard`` of ``shards`` equal shards of ``pairs``, packed whole
    as a mesh packs a batch (``Lq`` and ``Ltb`` batch-wide); the whole
    batch for one shard."""
    from wfa_tpu_torch.engine import _pack_all, inputs_from_packed

    ins = inputs_from_packed(
        _pack_all(pairs, k_win, global_alignment=global_alignment), DEVICE)
    lb = len(pairs) // shards
    rows = slice(shard * lb, (shard + 1) * lb)
    return tuple(a[rows] for a in ins[:5]) + tuple(ins[5:])


def check_batch(pairs, pen, global_alignment: bool, k_win: int, s_cap: int,
                reps: int, recs, engine: str = "auto", shards: int = 1,
                shard: int = 0) -> None:
    """K1 (K1-semi; K1-kw for ``engine`` "kw", K1-long for "long") and K2
    against their plain versions on a batch a path gave them, at its caps
    (on shard ``shard`` of ``shards`` where a mesh ran it); their
    max_abs_err folded into ``recs``."""
    import torch
    from wfa_tpu_torch import AdaptiveReductionOption
    from wfa_tpu_torch.engine import EngineConfig

    torch.cuda.empty_cache()
    cfg = EngineConfig(penalties=pen, global_alignment=global_alignment,
                       adaptive=AdaptiveReductionOption(10, 50, 1),
                       k_win=k_win, s_cap=s_cap,
                       aux_kw=k_win if engine == "kw" else None)
    ins = shard_ins(pairs, k_win, global_alignment, shards, shard)
    k1 = {"auto": phase_k1, "kw": phase_k1_kw, "long": phase_k1_long}[engine]
    rec1, out = k1(cfg, ins, reps)
    merge(recs, (rec1, phase_k2(cfg, ins, out, reps=reps,
                                long=engine == "long",
                                rows_kw=engine == "kw")))
    del out, ins
    torch.cuda.empty_cache()


def phase_bwa(reps: int, recs, card: str):
    """The two-phase route at Penalties(4, 6, 1) (x, e or o+e below 2:
    the TPU's whole-K EXPORT kernel, pallas_engine.py:1259) on 256 pairs
    of l=1000 against the oracle, its launch counts read around the timed
    call; then K3, K4 and K2 against their plain versions on the batch
    that run gave them, so that K3's and K4's records (their checks,
    times, bounds and launches) hold the one launch plan the run took.
    Returns the two records."""
    import torch
    from wfa_tpu_torch import (AdaptiveReductionOption, OracleAligner,
                               Options, Penalties)
    from wfa_tpu_torch.datagen import generate_pairs
    from wfa_tpu_torch.engine import BatchAligner

    pen, ad = Penalties(4, 6, 1), AdaptiveReductionOption(10, 50, 1)
    pairs = generate_pairs(N_BWA, 1000, 0.05, seed=42)
    eng = BatchAligner(pen, Options(False), ad, k_win=256, s_cap=640,
                       engine="semi2:64", device=DEVICE)
    with record_batches() as seen:
        eng.align_batch(pairs, fallback=False)  # warm
        reset_counters()
        res = eng.align_batch(pairs, fallback=False)
        torch.cuda.synchronize()
        launches = read_counters()
    k3_launches = launches["score_loop_prefix"]["prefix"]
    k4_launches = launches["score_loop_resume"]["resume"]
    served = [i for i, r in enumerate(res) if r is not None]
    print(f"4/6/1 l=1000 two-phase: {len(served)} of {len(pairs)} pairs "
          f"served at tier-0 caps on {card}; launches {launches}; batches "
          f"{[(key, len(p)) for key, p in seen.items()]}")
    if len(served) < len(pairs) // 2 or k3_launches <= 0 or k4_launches <= 0:
        fail("4/6/1 two-phase run served too few pairs or launched no K3 "
             "or no K4")
    oracle_check("4/6/1 l=1000 two-phase", pairs, res, served,
                 OracleAligner(pen, Options(False), ad))
    new = []
    check_own_batches(seen, 1000, reps, new, [], pen, "4/6/1 ")
    rec3, rec4, rec2 = new
    merge(recs[1:], (rec4, rec2))
    rec3.update(name="score_loop_prefix_4_6_1",
                replaces="wfa_tpu/pallas_engine.py:1259",
                launches=k3_launches)
    rec4.update(name="score_loop_resume_4_6_1", launches=k4_launches)
    return rec3, rec4


def _oracle_semi(item):
    """The oracle's result of one semi-global pair at its own penalties:
    whether its CIGAR uses up both lengths, and its fields."""
    from wfa_tpu_torch import AdaptiveReductionOption, Options, Penalties
    from wfa_tpu_torch.fuzz import uses_lengths
    from wfa_tpu_torch.oracle import Aligner

    pen, ad, q, t = item
    o = Aligner(Penalties(*pen), Options(False),
                AdaptiveReductionOption(*ad) if ad else None).align(q, t)
    return uses_lengths(o, q, t), coord_fields(o)


def coord_fields(res) -> tuple:
    """The 11 fields a semi-global result is held to: score, the CIGAR and
    its trimmed form, the four coordinates and the four stats."""
    return (res.cigar(False), res.cigar(True)) + tuple(
        getattr(res, f) for f in FIELDS)


def phase_semi_coords(card: str) -> None:
    """Semi-global coordinates on the pairs where the oracle's CIGAR
    misses a length (``fuzz.uses_lengths``), which a walk of the ops from
    (0, 0) places one diagonal off the oracle: N_COORD_GROUPS groups of
    COORD_GROUP pairs of 30-200 bases at penalties of their own
    (``fuzz.draw_semi_groups``, seed COORD_SEED) through the oracle in a
    pool of forked processes, then the drift pairs and the card fuzz's two
    (``fuzz.DRIFT_PAIRS``), a batch at each penalties, through K1-semi at
    the full span (engine "auto") and the two-phase route ("semi2:<S0>",
    S0 16 or the penalties' least, phase 2's window 256 and, for a pair
    it loses there, the full span), each on the card and on a mesh of 2
    shards of it: every pair served and equal to the oracle on all 11
    fields, and K1-semi, K3, K4 and K2 launched."""
    import dataclasses
    import multiprocessing
    import random

    import torch
    from wfa_tpu_torch import AdaptiveReductionOption, Options, Penalties
    from wfa_tpu_torch.engine import BatchAligner, windows
    from wfa_tpu_torch.fuzz import DRIFT_PAIRS, case_pair, draw_semi_groups
    from wfa_tpu_torch.parallel import make_dp_mesh

    t0 = time.perf_counter()
    items = [(dataclasses.astuple(pen), ad and dataclasses.astuple(ad), q, t)
             for pen, ad, pairs in draw_semi_groups(
                 random.Random(COORD_SEED), N_COORD_GROUPS, COORD_GROUP)
             for q, t in pairs]
    with multiprocessing.get_context("fork").Pool(os.cpu_count() or 1) as p:
        refs = p.map(_oracle_semi, items, chunksize=16)
    batches = {}  # (penalties, adaptive) -> [(pair, oracle fields)]
    for (pen, ad, q, t), (used, want) in zip(items, refs):
        if not used:
            batches.setdefault((pen, ad), []).append(((q, t), want))
    n_drift = sum(len(b) for b in batches.values())
    for seed, case, index in DRIFT_PAIRS:
        drawn, (q, t) = case_pair(seed, case, index)
        key = (drawn["penalties"], drawn["adaptive"])
        used, want = _oracle_semi(key + (q, t))
        if used:
            fail(f"fuzz seed {seed} case {case} pair {index}: the oracle's "
                 "CIGAR uses up both lengths")
        batches.setdefault(key, []).append(((q, t), want))
    secs_oracle = time.perf_counter() - t0
    mesh = make_dp_mesh(devices=(f"{DEVICE}:0",) * 2)
    retried = [[], []]  # by the two-phase route on one card, on the mesh
    reset_counters()
    for (pen, ad), got in batches.items():
        pen = Penalties(*pen)
        ad = AdaptiveReductionOption(*ad) if ad else None
        longest = max(max(len(q), len(t)) for (q, t), _ in got)
        spread = max(abs(len(q) - len(t)) for (q, t), _ in got)
        s_cap = -(-(pen.mismatch * longest + pen.gap_open
                    + pen.gap_ext * (spread + 1) + 8) // 8) * 8
        span = -(-(2 * longest + 2) // 128) * 128
        S0 = max(windows(pen)[0], 16)
        # the two-phase route retries a pair its narrow window lost with
        # phase 2's window at the full span, as the ladder widens it
        for engine, k_wins in (("auto", (span,)),
                               (f"semi2:{S0}", (min(256, span), span))):
            for m in (None, mesh):
                todo = list(range(len(got)))
                for k_win in k_wins:
                    if not todo:
                        break
                    if k_win != k_wins[0]:
                        retried[m is not None] += [
                            (str(pen), len(got[i][0][0]), len(got[i][0][1]))
                            for i in todo]
                    eng = BatchAligner(pen, Options(False), ad, k_win=k_win,
                                       s_cap=max(s_cap, S0 + 8),
                                       device=DEVICE, engine=engine, mesh=m)
                    res = eng.align_batch([got[i][0] for i in todo],
                                          fallback=False)
                    for i, r in zip(todo, res):
                        (q, t), want = got[i]
                        if r is not None and coord_fields(r) != want:
                            fail(f"semi coords {engine} k_win {k_win} "
                                 f"{'mesh' if m else 'one'} at {pen}, {ad}: "
                                 f"pair ({len(q)}, {len(t)}): "
                                 f"{coord_fields(r)[2:]} against the "
                                 f"oracle's {want[2:]}")
                    todo = [i for i, r in zip(todo, res) if r is None]
                for i in todo:
                    fail(f"semi coords {engine} {'mesh' if m else 'one'} at "
                         f"{pen}, {ad}: pair ({len(got[i][0][0])}, "
                         f"{len(got[i][0][1])}) not served")
    torch.cuda.synchronize()
    launches = read_counters()
    for counter, mode in (("score_loop", "semi"), ("score_loop_prefix",
                                                   "prefix"),
                          ("score_loop_resume", "resume"),
                          ("backtrace", "semi"), ("backtrace", "semi2")):
        if launches[counter].get(mode, 0) <= 0:
            fail(f"semi coords launched {counter} ({mode}) no time")
    print(f"semi coords: {len(items)} pairs drawn, {n_drift} whose oracle "
          f"CIGAR misses a length, and the {len(DRIFT_PAIRS)} fuzz pairs, "
          f"at {len(batches)} penalties, equal the oracle on all 11 fields "
          f"through K1-semi and the two-phase route, on the card and on a "
          f"mesh of 2 shards of it, every pair served (the two-phase route "
          f"retried at the full span, one card {retried[0]}, mesh "
          f"{retried[1]}), on {card}; oracle {secs_oracle:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if any(v.values())} }")


def phase_ab(card: str) -> None:
    """The two-phase route (engine "semi2:64", k_win 256) against K1-semi
    at the full span (engine "auto", k_win 2048) on the same 1024 pairs of
    l=1000, s_cap 640 both (``profiling.route_ab``): align_batch wall
    times and each route's kernel times, two turns each after a warm call,
    the pairs each serves, their results equal where both serve."""
    import wfa_tpu_torch
    from wfa_tpu_torch.profiling import route_ab

    print(f"A/B l=1000 semi routes on {card}: "
          f"{json.dumps(route_ab({'this': wfa_tpu_torch}))}")


def full_tokens(res):
    """The non-empty tokens of a result's full token stream (a flat
    stream, or a 2-D layout's row with its trailing zeros)."""
    toks = token_stream(res)
    return toks[toks != 0]


def stream_digest(results) -> str:
    """A hash of every result's score, final score and full token
    stream."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for r in results:
        h.update(np.array([r.score, r.final_s], np.int64).tobytes())
        h.update(full_tokens(r).astype(np.int32).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def full_streams():
    """Within the block, global batches ship full token streams
    (``WFA_EDIT_TOKENS=0``), as a mesh's always do, so that the two can
    be held token for token."""
    before = os.environ.get("WFA_EDIT_TOKENS")
    os.environ["WFA_EDIT_TOKENS"] = "0"
    try:
        yield
    finally:
        if before is None:
            del os.environ["WFA_EDIT_TOKENS"]
        else:
            os.environ["WFA_EDIT_TOKENS"] = before


def dp_pipeline(global_alignment: bool, devices=(), pen=None):
    """A pipeline of the data-parallel phases at ``pen`` (default 4/6/2):
    one card, or a mesh over ``devices``."""
    from wfa_tpu_torch import AdaptiveReductionOption, Options, Penalties
    from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

    return AlignmentPipeline(PipelineConfig(
        pen or Penalties(4, 6, 2), Options(global_alignment),
        AdaptiveReductionOption(10, 50, 1), batch_size=BATCH, device=DEVICE,
        n_devices=1, devices=devices))


def no_faults(tag: str, pipe) -> None:
    if pipe._device_errors or pipe.served["oracle"]:
        fail(f"{tag}: {pipe._device_errors} device faults, "
             f"{pipe.served['oracle']} pairs served by the oracle")


def dp_devices() -> tuple:
    """The mesh of the data-parallel phases: every card, or 2 shards of
    the one card."""
    import torch

    n = torch.cuda.device_count()
    return tuple(f"cuda:{i}" for i in range(n)) if n > 1 else ("cuda:0",) * 2


def dummy_records() -> dict:
    """Kernel records for ``phase_dp`` where the run keeps none (``--dp``):
    the checks fold their errors into these, and a mismatch still fails."""
    return {k: tuple({"max_abs_err": 0} for _ in range(n)) if n else []
            for k, n in (("auto", 2), ("semi", 2), ("semi2", 0),
                         ("semi2 4/6/1", 0), ("kw", 2), ("long", 2))}


def check_shard_batches(seen, ga: bool, length: int, recs, shards: int,
                        shard: int = 0, pen=None, semi2: str = "semi2"
                        ) -> None:
    """Each kernel of a mesh's run against its plain version on shard
    ``shard`` of the first batch at each engine key (``record_batches``
    with ``mesh=True``), at the shard's own size and the whole batch's
    shapes, at ``pen`` (default 4/6/2); max_abs_err folded into ``recs``
    (by engine: "auto" global K1 and K2, "kw", "long"; "semi" K1-semi and
    K2, ``semi2`` K3, K4 and K2)."""
    from wfa_tpu_torch import Penalties

    pen = pen or Penalties(4, 6, 2)
    if not ga:
        check_own_batches(seen, length, 3, recs[semi2], recs["semi"], pen,
                          tag=f"dp shard {shard} of {shards} ",
                          shards=shards, shard=shard)
        return
    for (engine, k_win, s_cap), batch in seen.items():
        print(f"dp shard {shard} of {shards}, global l={length} {engine} "
              f"(k_win {k_win}, s_cap {s_cap}), {len(batch) // shards} "
              "pairs:")
        check_batch(batch, pen, True, k_win, s_cap, 3, recs[engine],
                    engine=engine, shards=shards, shard=shard)


def phase_dp(card: str, recs) -> None:
    """The data-parallel mesh in one process: AlignmentPipeline over
    ``dp_devices()``, global l=1000 at the main path's width (N_MAIN
    pairs, K1), semi-global l=1000 (N_DP_SEMI pairs, the two-phase route),
    semi-global l=200 (N_SEMI_SHORT pairs, K1-semi), semi-global l=1000 at
    4/6/1 (N_BWA pairs, the two-phase route's K3 at any penalties),
    global l=4000 (N_KW pairs, K1-kw), l=DP_LONG_LENGTH (N_DP_LONG
    pairs, K1-long) and l=50000 (N_LONG pairs, K1-long), each held token
    stream for token stream to a single-device pipeline on the same pairs,
    both with full streams.
    Times the two in turns (one, mesh, mesh, one; after a warm call of
    each) and prints each shard's launches in the last mesh call, which
    must have launched every kernel of the path on every shard.  Then
    holds each kernel to its plain version on the first shard of the
    first batch the mesh ran at each engine key (``check_shard_batches``,
    into ``recs``), but at l=50000, whose K1-long shards are checked at
    l=DP_LONG_LENGTH."""
    import torch
    from wfa_tpu_torch import Penalties
    from wfa_tpu_torch.datagen import generate_pairs
    from wfa_tpu_torch.parallel import shard_launches

    two_phase = (("score_loop_prefix", "prefix"),
                 ("score_loop_resume", "resume"), ("backtrace", "semi2"))
    for ga, length, n, pen, need in (
            (True, 1000, N_MAIN, None, (("score_loop", "global"),
                                        ("backtrace", "global"))),
            (False, 1000, N_DP_SEMI, None, two_phase),
            (False, 200, N_SEMI_SHORT, None, (("score_loop", "semi"),
                                              ("backtrace", "semi"))),
            (False, 1000, N_BWA, Penalties(4, 6, 1), two_phase),
            (True, KW_LENGTH, N_KW, None, (("score_loop_kw", "kw"),
                                           ("backtrace", "kw"))),
            (True, DP_LONG_LENGTH, N_DP_LONG, None,
             (("score_loop_long", "long"), ("backtrace", "long"))),
            (True, 50000, N_LONG, None,
             (("score_loop_long", "long"), ("backtrace", "long")))):
        devices = dp_devices()
        tag = (f"dp {len(devices)} shards of {len(set(devices))} cards "
               f"{'global' if ga else 'semi'} l={length}"
               + (f" at {pen.mismatch}/{pen.gap_open}/{pen.gap_ext}"
                  if pen else ""))
        pairs = generate_pairs(n, length, 0.05, seed=42)
        with full_streams(), record_batches(mesh=True) as seen:
            pipes = {"one": dp_pipeline(ga, pen=pen),
                     "mesh": dp_pipeline(ga, devices, pen)}
            mesh = pipes["mesh"]._mesh
            if pipes["one"]._mesh is not None or mesh is None or (
                    mesh.size != len(devices)):
                fail(f"{tag}: meshes {pipes['one']._mesh} and {mesh}")
            for name, pipe in pipes.items():
                pipe.align_all(pairs)  # warm
                no_faults(f"{tag} {name} warm", pipe)
            secs, results = {"one": [], "mesh": []}, {}
            for name in ("one", "mesh", "mesh", "one"):
                for tally in mesh.launches:
                    tally.clear()
                t0 = time.perf_counter()
                results[name] = pipes[name].align_all(pairs)
                torch.cuda.synchronize()
                secs[name].append(time.perf_counter() - t0)
                no_faults(f"{tag} {name}", pipes[name])
                if name == "mesh":
                    per_shard = shard_launches(mesh)
        for pipe in pipes.values():
            pipe.close()
        print(f"{tag}: launches per shard {per_shard}; engines "
              f"{sorted(pipes['mesh']._engines)}; pairs served per tier "
              f"{pipes['mesh'].served}")
        for i, shard in enumerate(per_shard):
            for counter, mode in need:
                if shard.get(counter, {}).get(mode, 0) <= 0:
                    fail(f"{tag}: shard {i} launched {counter} ({mode}) no "
                         "time")
        for i, (a, b) in enumerate(zip(results["one"], results["mesh"])):
            if (a.score, a.final_s) != (b.score, b.final_s) or not (
                    torch.equal(torch.from_numpy(full_tokens(a)),
                                torch.from_numpy(full_tokens(b)))):
                fail(f"{tag}: pair {i} differs from the single-device run")
        rates = {k: [round(n / t, 1) for t in v] for k, v in secs.items()}
        print(f"{tag}: all {n} results equal the single-device run token "
              f"stream for token stream; aln/s in turns (one, mesh, mesh, "
              f"one) {rates['one'][0]}, {rates['mesh'][0]}, "
              f"{rates['mesh'][1]}, {rates['one'][1]} on {card}")
        del pipes, results
        if length == 50000:
            continue  # the plain K1-long takes ~100 s a cap: DP_LONG_LENGTH
        check_shard_batches(seen, ga, length, recs, mesh.size, pen=pen,
                            semi2="semi2 4/6/1" if pen else "semi2")


def phase_dp_procs(card: str, recs) -> None:
    """Processes over gloo, one a card (2 on the one card where there is
    one), each a mesh of one shard on its card (``dp_worker``), on
    N_DP_PROC pairs of global l=1000: each must return every result, equal
    to a single-process run's
    (score, final score and full token stream), with no fault and no
    pair served by the oracle, each shard launching K1 and K2.  Each
    process holds K1 and K2 to their plain versions on its own shard of
    the first batch at each (k_win, s_cap); their max_abs_err folds into
    ``recs`` (the global K1 and K2 records)."""
    import socket

    import torch
    from wfa_tpu_torch.datagen import generate_pairs

    pairs = generate_pairs(N_DP_PROC, 1000, 0.05, seed=42)
    with full_streams():
        pipe = dp_pipeline(True)
        pipe.align_all(pairs)
        t0 = time.perf_counter()
        results = pipe.align_all(pairs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        no_faults("dp single process", pipe)
        want = stream_digest(results)
        pipe.close()
    print(f"dp single process global l=1000: {N_DP_PROC} pairs in "
          f"{secs:.3f} s = {N_DP_PROC / secs:.1f} aln/s (full streams)")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        init = f"tcp://localhost:{sock.getsockname()[1]}"
    t0 = time.perf_counter()
    world = len(dp_devices())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
         str(world), init], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(world)]
    got = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                fail(f"dp worker exited {p.returncode}:\n{out[-2000:]}\n"
                     f"{err[-3000:]}")
            got += [json.loads(line.split(" ", 1)[1])
                    for line in out.splitlines()
                    if line.startswith("DP_WORKER ")]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    torch.cuda.synchronize()
    for rec in got:
        print(f"dp {world} processes global l=1000 (rank {rec['rank']}, "
              f"{rec['device']}): "
              f"{N_DP_PROC} pairs in {rec['secs']:.3f} s = "
              f"{N_DP_PROC / rec['secs']:.1f} aln/s; launches per shard of "
              f"this process {rec['launches']}; pairs served per tier "
              f"{rec['served']}")
        merge(recs, [{"max_abs_err": e} for e in rec["max_abs_err"]])
        print(f"dp rank {rec['rank']}: K1 and K2 on its shard of the "
              f"batches at (k_win, s_cap) {rec['checked']} equal their "
              f"plain versions, max_abs_err {rec['max_abs_err']} "
              "(tolerance 0)")
        if rec["digest"] != want:
            fail(f"dp rank {rec['rank']}: results differ from the "
                 "single-process run")
        if rec["faults"] or rec["served"]["oracle"]:
            fail(f"dp rank {rec['rank']}: {rec['faults']} device faults, "
                 f"{rec['served']['oracle']} pairs served by the oracle")
        for counter, mode in (("score_loop", "global"),
                              ("backtrace", "global")):
            if rec["launches"][0].get(counter, {}).get(mode, 0) <= 0:
                fail(f"dp rank {rec['rank']} launched {counter} no time")
    if sorted(r["rank"] for r in got) != list(range(world)):
        fail(f"dp workers reported {len(got)} results")
    print(f"dp {world} processes: every rank's results equal the "
          f"single-process run on {card} ({time.perf_counter() - t0:.1f} s "
          "with the processes' start)")


def dp_worker(rank: int, world: int, init: str) -> None:
    """One of ``phase_dp_procs``' processes: a pipeline whose mesh is this
    process's one shard on its card and the other processes'; a warm
    call, then a timed one; then K1 and K2 against their plain versions
    on this process's shard of the first batch at each (k_win, s_cap);
    prints one ``DP_WORKER {json}`` line."""
    import torch
    from wfa_tpu_torch.datagen import generate_pairs
    from wfa_tpu_torch.parallel import initialize_distributed, shard_launches

    initialize_distributed(init_method=init, world_size=world, rank=rank)
    device = dp_devices()[rank]
    torch.cuda.set_device(device)
    pipe = dp_pipeline(True, (device,))
    if pipe._mesh is None or pipe._mesh.size != world:
        fail(f"rank {rank}: mesh {pipe._mesh}")
    pairs = generate_pairs(N_DP_PROC, 1000, 0.05, seed=42)
    with record_batches(mesh=True) as seen:
        pipe.align_all(pairs)
        faults = pipe._device_errors + pipe.served["oracle"]
        pipe._mesh.launches[0].clear()
        t0 = time.perf_counter()
        results = pipe.align_all(pairs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    pipe.close()
    recs = dummy_records()
    check_shard_batches(seen, True, 1000, recs, world, rank)
    print("DP_WORKER " + json.dumps({
        "rank": rank, "device": device, "secs": secs,
        "digest": stream_digest(results),
        "launches": shard_launches(pipe._mesh), "served": pipe.served,
        "checked": sorted(k[1:] for k in seen),
        "max_abs_err": [r["max_abs_err"] for r in recs["auto"]],
        "faults": faults + pipe._device_errors}), flush=True)
    # gloo's threads joined before the interpreter's teardown
    torch.distributed.destroy_process_group()


def phase_cli(card: str) -> None:
    """``python -m wfa_tpu_torch.cli -i tests/data/seqs.txt`` on the card
    against the same with ``--no-device`` (the oracle): the same standard
    output, byte for byte."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "wfa_tpu_torch.cli", "-i",
           os.path.join("tests", "data", "seqs.txt")]
    runs = [subprocess.run(cmd + extra, capture_output=True, timeout=600,
                           cwd=root) for extra in ([], ["--no-device"])]
    for r in runs:
        if r.returncode != 0:
            fail(f"CLI exited {r.returncode}: {r.stderr[-2000:]!r}")
    if not runs[0].stdout or runs[0].stdout != runs[1].stdout:
        fail("CLI on the card differs from --no-device")
    print(f"CLI on {card}: {len(runs[0].stdout)} bytes of standard output "
          f"equal --no-device's, byte for byte "
          f"({runs[0].stderr.decode().strip()})")


def blocked_modules() -> set:
    """Loaded modules of JAX and of the JAX package wfa_tpu."""
    return {m for m in sys.modules
            if m.split(".")[0].startswith("jax")
            or m.split(".")[0] == "wfa_tpu"}


def main(dp_only: bool = False) -> None:
    """Every phase; with ``dp_only`` (``--dp``: the data-parallel phases
    over every card of the machine, and the CLI) the build and those
    alone, and no kernel records."""
    preloaded = blocked_modules()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:  # fail before any output when the checkout is missing
        import wfa_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not importable here: {exc}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = LAP[0] = time.perf_counter()

    phase_build()
    lap("build")
    if dp_only:
        recs = dummy_records()
        phase_dp(card, recs)
        lap("dp")
        phase_dp_procs(card, recs["auto"])
        lap("dp processes")
        phase_cli(card)
        lap("cli")
        print(f"seconds by step: {json.dumps(LAPS)}")
        print(f"data-parallel phases passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return
    # global: kernels at the main path's batch, then the main path
    rec1, rec2 = check_kernels(GLOBAL_CHECKS, True, reps=10)
    lap("K1, K2 global checks")
    launches, _ = phase_main(N_MAIN, 1000, True, BATCH, N_CHECK, card,
                             GLOBAL_CHECKS, need=(("score_loop", "global"),
                                                  ("backtrace", "global")),
                             iter_chunk=ITER_CHUNK)
    rec1["launches"] = launches["score_loop"]["global"]
    rec2["launches"] = launches["backtrace"]["global"]
    lap("main global l=1000")
    phase_errors(card, (rec1, rec2))
    lap("errors")
    # semi-global at spans up to 512: K1-semi and K2 (also at the A/B's
    # full-span shape), then the l=200 path
    rec3, rec4 = check_kernels(SEMI_CHECKS, False, reps=3)
    lap("K1-semi, K2 checks")
    launches, _ = phase_main(N_SEMI_SHORT, 200, False, BATCH, N_CHECK, card,
                             SEMI_CHECKS, need=(("score_loop", "semi"),
                                                ("backtrace", "semi")))
    rec3["launches"] = launches["score_loop"]["semi"]
    rec4["launches"] = launches["backtrace"]["semi"]
    lap("main semi l=200")
    # the two-phase route: each path, then its kernels on its own batches
    need2 = (("score_loop_prefix", "prefix"), ("score_loop_resume", "resume"),
             ("backtrace", "semi2"))
    semi2_recs = []
    launches, seen = phase_main(N_SEMI, 1000, False, BATCH, N_CHECK_SEMI,
                                card, SEMI_CHECKS, need2, SEMI2_CHECKS)
    check_own_batches(seen, 1000, 3, semi2_recs, (rec3, rec4))
    for rec, (counter, mode) in zip(semi2_recs, need2):
        rec["launches"] = launches[counter][mode]
    lap("main semi l=1000, checks")
    launches, seen = phase_main(N_SEMI_LONG, 10000, False, BATCH,
                                N_SEMI_LONG, card, SEMI_CHECKS, need2,
                                SEMI2_CHECKS)
    # K3 at Kf 20,096 and K4 after it keep records of their own: their
    # time, bound and launches at the l=10000 path's shape
    long_recs = []
    check_own_batches(seen, 10000, 3, long_recs, (rec3, rec4))
    merge(semi2_recs, long_recs)
    k3_long, k4_long = long_recs[:2]
    k3_long.update(name="score_loop_prefix_l10000",
                   launches=launches["score_loop_prefix"]["prefix"])
    k4_long.update(name="score_loop_resume_l10000",
                   launches=launches["score_loop_resume"]["resume"])
    lap("main semi l=10000, checks")
    rec_bwa, k4_bwa = phase_bwa(3, semi2_recs, card)
    lap("4/6/1")
    phase_semi_coords(card)
    lap("semi coords")
    phase_ab(card)
    lap("A/B")
    # reads just past int16 offsets: the path, then K1-kw and K2 over its
    # sbase words on the batches it ran; the int32 K1 must not run there
    # (every pair at tier 0: a retry would also run unchecked caps)
    launches, seen = phase_main(N_KW, KW_LENGTH, True, BATCH, N_CHECK, card,
                                KW_CHECKS, need=(("score_loop_kw", "kw"),
                                                 ("backtrace", "kw")))
    if launches["score_loop"]["global"]:
        fail(f"main global l={KW_LENGTH} launched the int32 K1 "
             f"{launches['score_loop']['global']} times")
    rec7, rec8 = check_kw_batches(seen, 3)
    rec7["launches"] = launches["score_loop_kw"]["kw"]
    rec8["launches"] = launches["backtrace"]["kw"]
    lap("main global l=4000, checks")
    # long global reads: K1-long and K2 over its rebased aux, then the path
    rec5, rec6 = check_kernels(LONG_CHECKS, True, reps=3, long=True)
    lap("K1-long, K2 checks")
    launches, _ = phase_main(N_LONG, 50000, True, BATCH, N_LONG_CHECK, card,
                             LONG_CHECKS, need=(("score_loop_long", "long"),
                                                ("backtrace", "long")))
    rec5["launches"] = launches["score_loop_long"]["long"]
    rec6["launches"] = launches["backtrace"]["long"]
    lap("main global l=50000")
    # data parallelism (a mesh of shards of the one card, then two
    # processes), each kernel held to its plain version on a shard's
    # batch, and the CLI
    phase_dp(card, {"auto": (rec1, rec2), "semi": (rec3, rec4),
                    "semi2": semi2_recs,
                    "semi2 4/6/1": [rec_bwa, k4_bwa, semi2_recs[2]],
                    "kw": (rec7, rec8), "long": (rec5, rec6)})
    lap("dp")
    phase_dp_procs(card, (rec1, rec2))
    lap("dp processes")
    phase_cli(card)
    lap("cli")
    phase_steps(card)
    lap("step phases")
    imported = sorted(blocked_modules() - preloaded)
    if imported:
        fail(f"the run imported JAX or wfa_tpu modules: {imported[:5]}")
    if DEFERRED:
        fail("; ".join(DEFERRED))
    print(f"seconds by step: {json.dumps(LAPS)}")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k3, k4, k2d = semi2_recs
    recs = [rec1, rec3, rec7, rec5, k3, k3_long, rec_bwa, k4, k4_long,
            k4_bwa, rec2, rec4, rec8, rec6, k2d]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:] == ["--dp"]:
        main(dp_only=True)
    else:
        main()
