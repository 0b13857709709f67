"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``wfa_tpu_torch/csrc`` (nvcc, sm_90a), holds
each kernel against its plain PyTorch version on the card, then drives
the main paths through ``AlignmentPipeline.align_all`` (bench.py's
protocol: one warm call, one timed call), each with the launch counts set
to 0 just before its timed call and read just after, and checks evenly
spaced results of each against the port's exact oracle:

* global: 32768 pairs of l=1000, e=0.05, gap-affine 4/6/2, wf-adaptive
  10/50/1, kernels checked on 2048-pair batches;
* semi-global: 8192 pairs of l=1000 and 1024 pairs of l=200, e=0.05,
  4/6/2, 10/50/1, kernels checked in their semi-global mode on 256 pairs
  of l=1000 (the plain version needs ~20 GB at more) and on the 1024
  pairs of l=200;
* long global reads: 64 pairs of l=50000, e=0.05, 4/6/2, 10/50/1
  (bench.py's matrix row), through K1-long and K2 over its rebased aux,
  both checked on those same 64 pairs, the path's one batch (the plain
  K1-long takes ~90 s a call, ~6 ms for each of ~14,600 scores); all 64
  results checked against the oracle.

The semi-global l=1000 path checks 256 results (its oracle takes ~0.33 s
a pair), the long path 64, the others 512.

The kernels are checked at each (k_win, s_cap) the paths run: tier 0's
first cap and the cap the score memory fits after the warm call.  A path
that builds an engine of other caps fails the run.  Every comparison is
integer and exact: the tolerance is 0.

Exits nonzero on any failure.  The last two lines are one JSON object
per kernel (with ``bound_ms``, the least time the card could take for the
bytes the call must move or the operations it must do) and
``{"ok": true, "device": {...}}``.  Imports no JAX and nothing of the JAX
package ``wfa_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N_MAIN = 32768
BATCH = 2048  # the main path's batch: K1 and K2 are checked at its shapes
N_CHECK = 512
N_CHECK_SEMI = 256  # the semi-global oracle takes ~0.33 s a pair at l=1000
N_SEMI = 8192  # bench.py's semi-global rows: l=1000 and l=200
N_SEMI_SHORT = 1024
N_LONG = 64  # bench.py's l=50000 row
N_LONG_CHECK = N_LONG  # the oracle takes ~1.4 s a pair at l=50000
# K1/K2 checks, (pairs, l, k_win, s_cap): the first of each mode is the
# one the kernels' record reports
GLOBAL_CHECKS = ((BATCH, 1000, 128, 640), (BATCH, 1000, 128, 512))
SEMI_CHECKS = ((256, 1000, 2048, 640), (256, 1000, 2048, 512),
               (N_SEMI_SHORT, 200, 512, 256))
# tier 0 at l=50000 (0.55 x the bucket's longest read, 50,057 bases,
# rounded up to 128), then the cap the score memory fits to this data's
# largest final score (14,748, the oracle's: 1.2 x 14,748 + 16, rounded
# up to 128); all 64 pairs of the path's one batch
LONG_CHECKS = ((N_LONG, 50000, 384, 27648), (N_LONG, 50000, 384, 17792))

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# device memory bandwidth, and the non-tensor 32-bit rate the score
# loop's integer operations run at
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


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

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s (nvcc {_build.build_seconds}) "
          f"flags {' '.join(_build.NVCC_FLAGS)}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def kernel_batch(n: int, length: int, k_win: int, s_cap: int,
                 global_alignment: bool):
    """A K1/K2 test batch on the card: the first ``n`` pairs of a main
    path's data at one of its (k_win, s_cap)."""
    from wfa_tpu_torch import AdaptiveReductionOption, Penalties
    from wfa_tpu_torch.datagen import generate_pairs
    from wfa_tpu_torch.engine import EngineConfig, _pack_all, inputs_from_packed

    cfg = EngineConfig(penalties=Penalties(4, 6, 2),
                       global_alignment=global_alignment,
                       adaptive=AdaptiveReductionOption(10, 50, 1),
                       k_win=k_win, s_cap=s_cap)
    pairs = generate_pairs(n, length, 0.05, seed=42)
    packed = _pack_all(pairs, cfg.k_win, global_alignment=global_alignment)
    return cfg, inputs_from_packed(packed, "cuda")


def check_kernels(checks, global_alignment: bool, reps: int,
                  long: bool = False):
    """K1 (K1-long) and K2 against their plain versions at each shape of
    ``checks``; returns the two records (times and bounds of the first
    shape, max_abs_err over all)."""
    import torch

    recs = None
    for n, length, k_win, s_cap in checks:
        torch.cuda.empty_cache()
        cfg, ins = kernel_batch(n, length, k_win, s_cap, global_alignment)
        rec1, k1_out = (phase_k1_long if long else phase_k1)(cfg, ins, reps)
        rec2 = phase_k2(cfg, ins, k1_out, long=long)
        del k1_out, ins
        if recs is None:
            recs = (rec1, rec2)
        for rec, new in zip(recs, (rec1, rec2)):
            rec["max_abs_err"] = max(rec["max_abs_err"], new["max_abs_err"])
    torch.cuda.empty_cache()
    return recs


def k1_bound(cfg, ins, final_s, ok, cell_bytes: int, base_bytes: int = 0):
    """Bytes and operations a score-loop call must spend: read the rows
    and lengths once, write the aux rows 0..final_s of the pairs it
    finished (3 planes of K cells of ``cell_bytes``, plus a base per row
    in the long-read mode) and the out rows; one operation per aux
    cell."""
    qb, tbuf = ins[:2]
    B = qb.shape[0]
    rows = int((final_s.long() + 1)[ok].sum())
    cells = 3 * rows * cfg.k_win
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
    rows = torch.arange(cfg.s_cap, device=qb.device)[None, :, None, None]
    mask = (rows <= ref[0][None, None, :, None]) & ok[None, None, :, None]
    diff = torch.where(mask, (ref[4] - got[4]).abs(), 0)
    err = int(diff.max())
    if err:
        fail(f"{name} aux differs in {int((diff != 0).sum())} cells")
    del ref, diff, mask
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


def phase_k1_long(cfg, ins, reps: int = 3):
    """K1-long against run_batch_long_plain on the card: every out row of
    every pair, the int16 aux rows and their bases 0..final_s of done
    pairs.  The plain version's one checked call is also its time."""
    import torch
    from wfa_tpu_torch.engine import run_batch_long_plain
    from wfa_tpu_torch.kernel_engine import run_batch_long

    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    args = (qb, tbuf, qlen, tlen, toff)
    kw = dict(cfg=cfg, Lq=Lq, Ltb=Ltb)
    name = "score_loop_long"
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
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms (peak device memory "
          f"{plain_peak:.2f} GiB), bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return rec, got


def phase_k2(cfg, ins, k1_out, reps: int = 10, long: bool = False):
    """K2 against device_backtrace_plain on K1's aux (K1-long's rebased
    aux with its bases), from K1's end."""
    import torch
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain,
                                                iter_capacity)
    from wfa_tpu_torch.engine import _token_plan

    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    if long:
        final_s, done, overflow, term_cell, aux, aux_base = k1_out
        end_s, end_k, end_cell = final_s, tlen - qlen, term_cell
    else:
        _, done, overflow, _, aux, (end_s, end_k, end_cell) = k1_out
        aux_base = None
    shift, _ = _token_plan(cfg.s_cap, cfg.penalties, Lq, Ltb)
    ga = cfg.global_alignment
    name = ("backtrace_long" if long
            else "backtrace" if ga else "backtrace_semi")
    args = (aux, end_cell, -toff, end_s, end_k, qlen, tlen, done & ~overflow)
    kw = dict(penalties=cfg.penalties, S=cfg.s_cap, K=cfg.k_win,
              token_shift=shift, split_ext_codes=ga, global_alignment=ga,
              aux_base=aux_base, return_iters=True)
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
    # bytes: the scalar inputs, one aux cell (and base) per chase step,
    # every token slot and the iteration counts
    B = qb.shape[0]
    steps = int(got[3].long().sum())
    cell = (2 + 4) if long else 4
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
               n_check: int, card: str, checks, long: bool = False):
    """One main path; returns the launch counts of its timed call.  Fails
    if it ran the kernels at a (k_win, s_cap) that ``checks`` lacks."""
    import torch
    from wfa_tpu_torch import (AdaptiveReductionOption, OracleAligner,
                               Options, Penalties)
    from wfa_tpu_torch.datagen import generate_pairs
    from wfa_tpu_torch.device_backtrace import device_backtrace
    from wfa_tpu_torch.kernel_engine import run_batch, run_batch_long
    from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

    mode = "long" if long else "global" if global_alignment else "semi"
    tag = f"main {'global' if global_alignment else 'semi'} l={length}"
    pen, opts = Penalties(4, 6, 2), Options(global_alignment)
    ad = AdaptiveReductionOption(10, 50, 1)
    pipe = AlignmentPipeline(PipelineConfig(pen, opts, ad, batch_size=batch,
                                            device="cuda"))
    t0 = time.perf_counter()
    pairs = generate_pairs(n, length, 0.05, seed=42)
    print(f"{tag}: {n} pairs generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe.align_all(pairs)  # warm
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    counters = (run_batch.launches, run_batch_long.launches,
                device_backtrace.launches)
    for counts in counters:
        counts.update(dict.fromkeys(counts, 0))
    t0 = time.perf_counter()
    results = pipe.align_all(pairs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1 = run_batch_long.launches if long else run_batch.launches
    launches = {"score_loop": k1[mode],
                "backtrace": device_backtrace.launches[mode]}
    caps = sorted({k[:2] for k in pipe._engines})
    engines = sorted({k[2] for k in pipe._engines})
    print(f"{tag}: align_all {n} pairs in {secs:.3f} s = {n / secs:.1f} "
          f"aln/s (warm call {warm:.3f} s) on {card}")
    print(f"{tag}: launches {mode} {launches} (mean batch "
          f"{n / max(1, launches['score_loop']):.1f} pairs), all "
          f"{{'score_loop': {run_batch.launches}, 'score_loop_long': "
          f"{run_batch_long.launches}, 'backtrace': "
          f"{device_backtrace.launches}}}; pairs served per tier "
          f"{pipe.served}; (k_win, s_cap) engines {caps} {engines}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{tag} launched {name} ({mode}) no time")
    unchecked = set(caps) - {c[2:] for c in checks}
    if unchecked:
        fail(f"{tag} ran the kernels at unchecked (k_win, s_cap) "
             f"{sorted(unchecked)}")
    if len(results) != n or any(r is None or r.error for r in results):
        fail(f"{tag} returned missing or failed results")
    oracle = OracleAligner(pen, opts, ad)
    fields = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
              "matches", "gaps", "gap_regions")
    t0 = time.perf_counter()
    for i in range(0, n, max(1, n // n_check))[:n_check]:
        r, o = results[i], oracle.align(*pairs[i])
        if r.cigar(False) != o.cigar(False) or any(
                getattr(r, f) != getattr(o, f) for f in fields):
            fail(f"{tag}: pair {i} differs from the oracle")
    print(f"{tag}: {min(n_check, n)} sampled results equal the oracle "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches


def blocked_modules() -> set:
    """Loaded modules of JAX and of the JAX package wfa_tpu."""
    return {m for m in sys.modules
            if m.split(".")[0].startswith("jax")
            or m.split(".")[0] == "wfa_tpu"}


def main() -> None:
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
    t_start = time.perf_counter()

    phase_build()
    # global: kernels at the main path's batch, then the main path
    rec1, rec2 = check_kernels(GLOBAL_CHECKS, True, reps=10)
    launches = phase_main(N_MAIN, 1000, True, BATCH, N_CHECK, card,
                          GLOBAL_CHECKS)
    rec1["launches"] = launches["score_loop"]
    rec2["launches"] = launches["backtrace"]
    # semi-global: the kernels' semi-global mode, then both main paths
    rec3, rec4 = check_kernels(SEMI_CHECKS, False, reps=3)
    launches = phase_main(N_SEMI, 1000, False, BATCH, N_CHECK_SEMI, card,
                          SEMI_CHECKS)
    rec3["launches"] = launches["score_loop"]
    rec4["launches"] = launches["backtrace"]
    phase_main(N_SEMI_SHORT, 200, False, BATCH, N_CHECK, card, SEMI_CHECKS)
    # long global reads: K1-long and K2 over its rebased aux, then the path
    rec5, rec6 = check_kernels(LONG_CHECKS, True, reps=3, long=True)
    launches = phase_main(N_LONG, 50000, True, BATCH, N_LONG_CHECK, card,
                          LONG_CHECKS, long=True)
    rec5["launches"] = launches["score_loop"]
    rec6["launches"] = launches["backtrace"]
    imported = sorted(blocked_modules() - preloaded)
    if imported:
        fail(f"the run imported JAX or wfa_tpu modules: {imported[:5]}")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    recs = [rec1, rec3, rec5, rec2, rec4, rec6]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
