"""Profile timed ``align_all`` calls of the port on the card, or the
score loop's phases.

    python -m wfa_tpu_torch.profiling [--length 50000] [--pairs 64]
                                      [--calls 3] [--semi]
    python -m wfa_tpu_torch.profiling --phases [--plans] [--ab DIR]

Generates ``generate_pairs(pairs, length, 0.05, seed=42)`` (bench.py's
data), runs one warm call of ``AlignmentPipeline.align_all`` (global, or
semi-global with ``--semi``; gap-affine 4/6/2, wf-adaptive 10/50/1,
device "cuda"), then times ``--calls`` calls
(host clock, each ending in a synchronise) and traces the last one with
``torch.profiler``: the card's name and power limit, wall time, aln/s, the
device's busy share (the union of its kernel and copy intervals over the
wall time) and the device time per kernel name.

``--phases`` prints ptxas's register, spill and shared-memory report of
every kernel (when this process built the library), then runs the timed
instantiations of the score loop (:func:`run_phases`,
:func:`run_prefix_phases`) on the batches of ``PHASE_BATCHES``: K1 on
2048 global pairs of l=1000 (k_win 128, s_cap 640), K1-long on 64 pairs
of l=50000 (k_win 384, s_cap 27,648) and K1-kw on 2048 pairs of l=4000
(KW = k_win 256, s_cap 2304), and of ``SEMI2_BATCHES``: K3 on 2048
semi-global pairs of l=1000 (Kf 2048) and on 64 of l=10000 (Kf 20,096),
S0 64, K2 256; ``generate_pairs(n, l, 0.05, seed=42)``, 4/6/2, 10/50/1,
each path's own first batch.  For each it prints the cycles thread 0 of
a pair's block spent in each phase of a score step (``PHASES``), summed
over the batch, per step and as a share, with the card's name and power
limit.  ``--plans`` first times K3 at every launch plan it takes
(:func:`prefix_plans`).  Each ``--ab DIR`` builds a second library from
the ``*.cu`` sources in DIR (a copy of another revision's ``csrc``,
placed in the git-ignored build directory) and times, with each build in
turns on the same batch (DIR's, this tree's, this tree's, DIR's; CUDA
events, 3 launches a turn after a warm one): K1, K1-long, K1-kw, K1-semi
(1024 semi-global pairs of l=200, k_win 512, s_cap 256), K3 and K4
(``AB_SEMI2``: 2048 semi-global pairs of l=1000 at 4/6/2, 256 at 4/6/1,
64 of l=10000), after checking that the two builds give the same
outputs; then the semi-global l=1000 routes (:func:`route_ab`):
``align_batch`` of the two-phase route and of K1-semi at the full span
on 1024 pairs, host clock, and each route's kernels.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import time

# the phase profile's score-loop batches, (pairs, l, k_win, s_cap, KW or
# None, mode): the first batch of the global l=1000, long l=50000 and
# l=4000 paths
PHASE_BATCHES = {"K1": (2048, 1000, 128, 640, None, 0),
                 "K1-long": (64, 50000, 384, 27648, None, 2),
                 "K1-kw": (2048, 4000, 256, 2304, 256, 3)}
AB_BATCHES = {**PHASE_BATCHES,
              "K1-semi": (1024, 200, 512, 256, None, 1)}
# K3's batches, the two-phase semi-global paths' first (S0 64, K2 = k_win
# 256; Kf 2048 at l=1000, 20,096 at l=10000): (penalties, pairs, l, s_cap)
SEMI2_BATCHES = {"K3": ((4, 6, 2), 2048, 1000, 640),
                 "K3-10k": ((4, 6, 2), 64, 10000, 5632)}
# K3 and K4 of both builds in turns, by name suffix: those batches, and
# 4/6/1 on the 256 pairs of the smoke's K3 record at those penalties
AB_SEMI2 = {"": SEMI2_BATCHES["K3"], " 4/6/1": ((4, 6, 1), 256, 1000, 640),
            " l=10000": SEMI2_BATCHES["K3-10k"]}
# K3's launch plans in turns: those batches, 128 pairs of l=1000 (a pair
# or fewer an SM at Kf 2048, as the l=1000 path's tier-1 retries), and
# batches whose workspace lies in the scratch, from under a pair an SM to
# eight, at l=2100 (Kf 4224) and l=10000 (Kf 20,096), where the plan's
# block shape moves with the pairs an SM
PLAN_BATCHES = {**AB_SEMI2, " 128 pairs": ((4, 6, 2), 128, 1000, 640),
                **{f" l={length} {n} pairs": ((4, 6, 2), n, length, s_cap)
                   for length, s_cap, sizes in (
                       (2100, 1280, (133, 264, 528, 529, 1056)),
                       (10000, 5632, (100, 132, 133, 200, 264, 528, 529,
                                      792, 1056)))
                   for n in sizes}}
# the routes' A/B batch: K1-semi's aux at the full span is 16 GiB
AB_ROUTE_PAIRS = 1024


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_batch(n: int, length: int, k_win: int, s_cap: int, kw=None,
                 device: str = "cuda", global_alignment: bool = True):
    """(cfg, inputs) of a batch: ``generate_pairs(n, length, 0.05,
    seed=42)`` packed at k_win, 4/6/2, 10/50/1."""
    from . import AdaptiveReductionOption, Penalties
    from .datagen import generate_pairs
    from .engine import EngineConfig, _pack_all, inputs_from_packed

    cfg = EngineConfig(penalties=Penalties(4, 6, 2),
                       global_alignment=global_alignment,
                       adaptive=AdaptiveReductionOption(10, 50, 1),
                       k_win=k_win, s_cap=s_cap, aux_kw=kw)
    pairs = generate_pairs(n, length, 0.05, seed=42)
    return cfg, inputs_from_packed(
        _pack_all(pairs, k_win, global_alignment=global_alignment), device)


# the phases of the timed instantiation's cycles columns: extend (with
# dmin and the Ak cell), the termination test, the reduce (classify, the
# mark scan, the zero pass with the flush's value range), the flush (its
# plan and its writes), next() (the new cells), the new bands (the barrier
# and the ballot scans), the semi-global end finder, the zero tail of the
# aux rows next() writes whole (outside its columns), the set-up before the
# first step (zeroing, seeding), and the prefix's exports (the other
# modes: the out rows)
PHASES = ("extend", "termination", "reduce", "flush", "next", "bands",
          "end finder", "zero tail", "setup", "exports")


def run_phases(qb, tbuf, qlen, tlen, toff, *, cfg, Lq: int, Ltb: int,
               mode: int = 0):
    """One launch of the timed score loop ``wfa_score_loop_phases`` in
    ``mode`` (0 K1, 2 K1-long, 3 K1-kw at ``cfg.aux_kw``) on CUDA tensors:
    returns (out int32[7, B], cycles int64[B, len(PHASES) + 1]), the
    cycles thread 0 of each pair's block spent in each of ``PHASES``, then
    the steps it ran.  No path runs it, so no launch count counts it."""
    import torch

    from ._build import launch, stream_ptr
    from .kernel_engine import loop_args

    B, S = qb.shape[0], cfg.s_cap
    dev = qb.device
    cycles = torch.zeros((B, len(PHASES) + 1), dtype=torch.int64, device=dev)
    aux = torch.empty((3, S, B, cfg.aux_kw or cfg.k_win), device=dev,
                      dtype=torch.int32 if mode == 0 else torch.int16)
    base = (None if mode == 0 else torch.empty(
        (B, S) if mode == 2 else (S, B), dtype=torch.int32, device=dev))
    args, out = loop_args(qb, tbuf, qlen, tlen, toff, cfg, Lq, Ltb, mode,
                          aux, base, kw=cfg.aux_kw or 0)
    launch("wfa_score_loop_phases", *args, cycles, stream_ptr(dev))
    return out, cycles


def run_prefix_phases(qb, tbuf, qlen, tlen, toff, *, cfg, Lq: int, Ltb: int,
                      S0: int, K2: int, plan=None):
    """One launch of K3's timed instantiation (``wfa_prefix`` with cycles)
    at ``plan`` (default ``kernel_engine.prefix_plan``): returns (the
    exports, cycles as :func:`run_phases`').  Counts no launch."""
    import torch

    from . import kernel_engine

    cycles = torch.zeros((qb.shape[0], len(PHASES) + 1), dtype=torch.int64,
                         device=qb.device)
    ex = kernel_engine._prefix_launch(
        qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb, S0=S0, K2=K2,
        plan=plan, cycles=cycles)
    return ex, cycles


def phase_split(name: str) -> dict:
    """The timed score loop on ``PHASE_BATCHES[name]`` or, for K3,
    ``SEMI2_BATCHES[name]``: cycles per phase (summed over the batch's
    blocks), per step, and shares; the steps; the launch's milliseconds
    (CUDA events, stamps included)."""
    import torch

    from .engine import semi_cell16
    from .kernel_engine import _sms, prefix_plan

    if name in SEMI2_BATCHES:
        from . import Penalties
        from .semi2 import M1_DONE

        pen, n, length, s_cap = SEMI2_BATCHES[name]
        _, args, pkw, cfg = _semi2_batch(Penalties(*pen), n, length,
                                         s_cap=s_cap)

        def run():
            ex, cyc = run_prefix_phases(*args, **pkw)
            return ex["meta1"][:, M1_DONE], cyc

        k_win = pkw["K2"]
        rec = {"row": name, "pairs": n, "length": length, "Kf":
               pkw["cfg"].k_win, "S0": pkw["S0"], "k_win": k_win,
               "cell16": semi_cell16(pkw["Ltb"]),
               "plan": prefix_plan(pkw["cfg"], n, semi_cell16(pkw["Ltb"]),
                                   _sms(args[0].device))._asdict()}
    else:
        n, length, k_win, s_cap, kw, mode = PHASE_BATCHES[name]
        cfg, ins = kernel_batch(n, length, k_win, s_cap, kw)
        args = ins[:5]
        pkw = dict(cfg=cfg, Lq=ins[5], Ltb=ins[6], mode=mode)

        def run():
            out, cyc = run_phases(*args, **pkw)
            return out[1], cyc

        rec = {"row": name, "pairs": n, "length": length, "k_win": k_win,
               "s_cap": s_cap, "kw": kw}
    run()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    done, cyc = run()
    end.record()
    torch.cuda.synchronize()
    tot = cyc.sum(0).tolist()
    steps = tot[-1]
    total = sum(tot[:-1])
    rec.update({"ms": start.elapsed_time(end), "steps": steps,
                "done": int((done > 0).sum()),
                "cycles_per_step": total / max(steps, 1),
                "phases": {ph: {"cycles": c, "per_step": c / max(steps, 1),
                                "share": c / max(total, 1)}
                           for ph, c in zip(PHASES, tot)}})
    del args, done, cyc
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def _built_from(lib):
    """Inside the block the kernel wrappers launch ``lib``, a build of
    another copy of the sources, in place of the package's library.  A
    build whose score loop predates the shared-memory workspace (it has no
    ``wfa_workspace`` entry) reads every workspace from the device
    scratch: it gets one of this tree's size, no smaller than its own."""
    from . import _build, kernel_engine

    saved = _build._lib, kernel_engine.workspace, kernel_engine.prefix_plan
    _build._lib = lib
    if not hasattr(lib, "wfa_workspace"):
        ws = saved[1]
        kernel_engine.workspace = lambda cfg, mode: (ws(cfg, mode)[0], False)
    if not hasattr(lib, "wfa_prefix_shared"):
        # its wfa_prefix predates the block shape and the cycles: one
        # block of 128 threads, the workspace in shared memory only within
        # 48 KB (its rule), those three arguments dropped
        def plan(cfg, *_, **__):
            ints = kernel_engine.workspace(cfg, "prefix")[0]  # int32 cells
            slots = kernel_engine.slot_ints(cfg)
            return kernel_engine.PrefixPlan(
                128, 0, not hasattr(lib, "wfa_workspace")
                or 4 * (slots + ints) > kernel_engine.SHARED_BYTES, ints)

        kernel_engine.prefix_plan = plan
        if not hasattr(lib, "_wfa_prefix_c"):
            lib._wfa_prefix_c = lib.wfa_prefix
            lib._wfa_prefix_c.argtypes = _build._SIGNATURES["wfa_prefix"][
                :18] + [ctypes.c_void_p] * 10
            lib.wfa_prefix = lambda *a: lib._wfa_prefix_c(*a[:18],
                                                          *a[20:-2], a[-1])
    try:
        yield
    finally:
        (_build._lib, kernel_engine.workspace,
         kernel_engine.prefix_plan) = saved


def _turns(fn, libs: dict, reps: int, host: bool = False) -> dict:
    """ms per call of ``fn`` launching each of ``libs`` ("parent" and
    "this": parent, this, this, parent; or "this" alone, twice), ``reps``
    calls a turn: device time between CUDA events, or with ``host`` the
    host's clock up to a synchronise."""
    import torch

    order = (("parent", "this", "this", "parent") if "parent" in libs
             else ("this", "this"))
    out = {who: [] for who in libs}
    for who in order:
        with _built_from(libs[who]):
            fn()  # warm: the caching allocator, the first launch
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms = ((time.perf_counter() - t0) * 1e3 if host
                  else start.elapsed_time(end))
        out[who].append(ms / reps)
    return out


def ab_turns(parent_dir: str, reps: int = 3) -> dict:
    """K1, K1-long, K1-kw and K1-semi (``AB_BATCHES``), K3 and K4 on the
    batches of ``AB_SEMI2``, and the semi-global routes (:func:`route_ab`)
    of the build of ``parent_dir``'s sources and of this tree's, on the
    same batch in turns (parent, this, this, parent; ms per call); fails
    unless both give the same out rows, aux rows (to each done pair's
    final_s) and row bases, or exports and phase-2 outputs."""
    import torch

    from . import Penalties, _build
    from .kernel_engine import _launch

    libs = {"this": _build.library()}
    libs["parent"] = _build.build(parent_dir)
    res = {}
    for name, (n, length, k_win, s_cap, kw, mode) in AB_BATCHES.items():
        cfg, ins = kernel_batch(n, length, k_win, s_cap, kw,
                                global_alignment=mode != 1)
        qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
        B, dev = qb.shape[0], qb.device
        cell = torch.int32 if mode <= 1 else torch.int16
        width = kw or k_win

        def run():
            aux = torch.empty((3, s_cap, B, width), dtype=cell, device=dev)
            base = (None if mode <= 1 else torch.empty(
                (B, s_cap) if mode == 2 else (s_cap, B), dtype=torch.int32,
                device=dev))
            out = _launch(qb, tbuf, qlen, tlen, toff, cfg, Lq, Ltb, mode,
                          aux, base, kw=kw or 0)
            return out, aux, base

        got = []
        for who in ("parent", "this"):
            with _built_from(libs[who]):
                got.append(run())
        torch.cuda.synchronize()
        (o1, a1, b1), (o2, a2, b2) = got
        if not torch.equal(o1, o2):
            raise SystemExit(f"A/B {name}: out rows differ")
        ok = (o1[1] > 0) & (o1[2] == 0)
        rows = torch.arange(s_cap, device=dev)
        live = (rows[:, None] <= o1[0][None, :]) & ok[None, :]  # [S, B]
        for c in range(3):
            if not torch.equal(torch.where(live[:, :, None], a1[c], 0),
                               torch.where(live[:, :, None], a2[c], 0)):
                raise SystemExit(f"A/B {name}: aux plane {c} differs")
        if b1 is not None:
            lv = live if mode == 3 else live.t()
            if not torch.equal(torch.where(lv, b1, 0), torch.where(lv, b2, 0)):
                raise SystemExit(f"A/B {name}: bases differ")
        del got, o1, o2, a1, a2, b1, b2
        res[name] = {"pairs": n, "length": length, "k_win": k_win,
                     "s_cap": s_cap, "kw": kw, "done": int(ok.sum()),
                     "turns_ms": _turns(run, libs, reps)}
        del ins
        torch.cuda.empty_cache()
    for tag, (pen, n, length, s_cap) in AB_SEMI2.items():
        for name, rec in ab_semi2(libs, Penalties(*pen), n, length, s_cap,
                                  reps).items():
            res[name + tag] = rec
    res["routes"] = route_ab(libs)
    return res


def _semi2_batch(pen, n: int, length: int = 1000, S0: int = 64,
                 k_win: int = 256, s_cap: int = 640):
    """The two-phase route's first batch of the semi-global l=1000 path at
    penalties ``pen`` (``generate_pairs(n, length, 0.05, seed=42)``,
    10/50/1): (pairs, K3's arguments, K3's keywords, phase 2's config,
    Ltb)."""
    import dataclasses

    from . import AdaptiveReductionOption
    from . import semi2 as ts
    from .datagen import generate_pairs
    from .engine import EngineConfig, _pack_all, inputs_from_packed

    pairs = generate_pairs(n, length, 0.05, seed=42)
    packed = _pack_all(pairs, k_win, global_alignment=False)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = inputs_from_packed(packed, "cuda")
    cfg = EngineConfig(penalties=pen, global_alignment=False,
                       adaptive=AdaptiveReductionOption(10, 50, 1),
                       k_win=k_win, s_cap=s_cap)
    Kf = ts.prefix_span(packed[2], packed[3])
    pkw = dict(cfg=dataclasses.replace(cfg, k_win=Kf), Lq=Lq, Ltb=Ltb,
               S0=S0, K2=k_win)
    return pairs, (qb, tbuf, qlen, tlen, toff), pkw, cfg


def _resume_args(pairs, args, ex):
    """K4's arguments after K3's exports ``ex``: the re-placed targets."""
    import torch

    from . import semi2 as ts

    k02 = ex["meta1"][:, ts.M1_K02].cpu().numpy()
    t2raw, _, toff2, Ltb2 = ts.replace_targets([t for _, t in pairs], k02)
    qb, _, qlen, tlen, _ = args
    return (qb, torch.from_numpy(t2raw).cuda(), qlen, tlen,
            torch.from_numpy(toff2).cuda(),
            *(ex[k] for k in ("win_m", "win_i", "win_d", "ainit", "b_m",
                              "b_ie", "meta1"))), Ltb2


def ab_semi2(libs: dict, pen, n: int, length: int, s_cap: int,
             reps: int) -> dict:
    """K3 and K4 of both builds on the two-phase route's first batch of
    ``n`` semi-global pairs of ``length`` at ``pen`` (Kf the full span,
    S0 64, k_win 256), in turns, after checking that both give the same
    exports and phase-2 outputs (their don't-cares zeroed); K4 of both
    runs on this tree's exports."""
    import torch

    from . import semi2 as ts
    from .kernel_engine import run_prefix, run_resume

    pairs, args, pkw, cfg = _semi2_batch(pen, n, length, s_cap=s_cap)
    got = []
    for who in ("parent", "this"):
        with _built_from(libs[who]):
            got.append(run_prefix(*args, **pkw))
    ex = got[1]
    a, b = (ts.canonical_exports(e) for e in got)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    if bad:
        raise SystemExit(f"A/B K3 {pen}: exports {bad} differ")
    k3 = _turns(lambda: run_prefix(*args, **pkw), libs, reps)
    r_args, Ltb2 = _resume_args(pairs, args, ex)
    S0 = pkw["S0"]
    rkw = dict(cfg=cfg, Lq=pkw["Lq"], Ltb2=Ltb2, Ltb_full=pkw["Ltb"], S0=S0)
    got = []
    for who in ("parent", "this"):
        with _built_from(libs[who]):
            got.append(ts.canonical_resume(run_resume(*r_args, **rkw), S0))
    a, b = got
    if not all(torch.equal(x, y) for x, y in zip(a[:5] + a[5], b[:5] + b[5])):
        raise SystemExit(f"A/B K4 {pen}: phase-2 outputs differ")
    k4 = _turns(lambda: run_resume(*r_args, **rkw), libs, reps)
    del ex, a, b, got
    torch.cuda.empty_cache()
    common = {"pairs": n, "length": length, "penalties": list(
        (pen.mismatch, pen.gap_open, pen.gap_ext)), "Kf": pkw["cfg"].k_win,
        "S0": S0, "k_win": cfg.k_win, "s_cap": cfg.s_cap}
    return {"K3": {**common, "turns_ms": k3}, "K4": {**common, "turns_ms": k4}}


def route_ab(libs: dict, reps: int = 3) -> dict:
    """The semi-global l=1000 routes on the same ``AB_ROUTE_PAIRS`` pairs,
    s_cap 640: the two-phase route (engine "semi2:64", k_win 256) and
    K1-semi at the full span (engine "auto", k_win 2048), each under each
    build of ``libs`` in turns.  Per route and build: ``align_batch``'s
    wall time (host clock, ``reps`` calls a turn) and its kernels' device
    time (CUDA events: K3 + K4 + K2, or K1-semi + K2); the pairs each
    route serves.  Fails unless the routes agree where both serve."""
    import torch

    from . import AdaptiveReductionOption, Options, Penalties
    from .datagen import generate_pairs
    from .device_backtrace import device_backtrace
    from .engine import BatchAligner, EngineConfig, _token_plan
    from .kernel_engine import run_batch, run_prefix, run_resume

    pen, ad = Penalties(4, 6, 2), AdaptiveReductionOption(10, 50, 1)
    n = AB_ROUTE_PAIRS
    pairs = generate_pairs(n, 1000, 0.05, seed=42)
    routes = {"two-phase": BatchAligner(pen, Options(False), ad, k_win=256,
                                        s_cap=640, engine="semi2:64",
                                        device="cuda"),
              "full span": BatchAligner(pen, Options(False), ad, k_win=2048,
                                        s_cap=640, engine="auto",
                                        device="cuda")}
    out = {name: eng.align_batch(pairs, fallback=False)
           for name, eng in routes.items()}
    for i, (x, y) in enumerate(zip(out["two-phase"], out["full span"])):
        if x is not None and y is not None and (
                x.score, x.cigar(False)) != (y.score, y.cigar(False)):
            raise SystemExit(f"A/B routes: pair {i} differs")
    res = {name: {"serves": sum(r is not None for r in o)}
           for name, o in out.items()}
    del out
    for name, eng in routes.items():
        res[name]["align_batch_ms"] = _turns(
            lambda: eng.align_batch(pairs, fallback=False), libs, reps,
            host=True)

    # each route's kernels on this batch
    _, args, pkw, cfg = _semi2_batch(pen, n)
    Lq, Ltb, S0 = pkw["Lq"], pkw["Ltb"], pkw["S0"]
    shift, _ = _token_plan(640, pen, Lq, Ltb)
    qlen, tlen, toff = args[2:]
    ex = run_prefix(*args, **pkw)
    r_args, Ltb2 = _resume_args(pairs, args, ex)
    rkw = dict(cfg=cfg, Lq=Lq, Ltb2=Ltb2, Ltb_full=Ltb, S0=S0)
    r = run_resume(*r_args, **rkw)
    bt = (r[4], r[5][2], -r_args[4], r[5][0], r[5][1], qlen, tlen,
          r[1] & ~r[2])
    bkw = dict(penalties=pen, S=640, K=256, token_shift=shift,
               global_alignment=False, aux_old=ex["aux_old"],
               k0_old=-(qlen - 1), s_split=S0)

    def two_phase():
        run_prefix(*args, **pkw)
        run_resume(*r_args, **rkw)
        device_backtrace(*bt, **bkw)

    res["two-phase"]["kernels_ms"] = _turns(two_phase, libs, reps)
    del ex, r, bt, r_args
    full = dict(cfg=EngineConfig(penalties=pen, global_alignment=False,
                                 adaptive=ad, k_win=2048, s_cap=640),
                Lq=Lq, Ltb=Ltb)
    k1 = run_batch(*args, **full)
    bt = (k1[4], k1[5][2], -toff, k1[5][0], k1[5][1], qlen, tlen,
          k1[1] & ~k1[2])
    bkw = dict(penalties=pen, S=640, K=2048, token_shift=shift,
               global_alignment=False)

    def full_span():
        run_batch(*args, **full)
        device_backtrace(*bt, **bkw)

    res["full span"]["kernels_ms"] = _turns(full_span, libs, reps)
    del k1, bt
    torch.cuda.empty_cache()
    return {"pairs": n, "length": 1000, "s_cap": 640, **res}


_MODES = {(1, 0, 0, "i", 0): "K1", (0, 0, 0, "i", 0): "K1-semi",
          (1, 1, 0, "s", 0): "K1-long", (1, 1, 0, "s", 1): "K1-kw",
          (0, 0, 1, "i", 0): "K3 int32", (0, 0, 1, "s", 0): "K3 int16",
          (0, 0, 2, "i", 0): "K4 int32", (0, 0, 2, "s", 0): "K4 int16"}


def ptxas_table(log: str) -> list:
    """ptxas's report (``-Xptxas -v``) of every kernel in an nvcc log: one
    line per entry function with its registers, stack, spills and static
    shared memory; score-loop instantiations by their template arguments
    (GLOBAL, REBASE, PHASE, Cell, KWIN, TIMED, NT, CL) and row name."""
    import re

    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"score_loop_kernelILb(\d)ELb(\d)ELi(\d)E(\w)"
                          r"Lb(\d)ELb(\d)E(?:Li(\d+)E)?(?:Li(\d+)E)?",
                          name)
            if t:
                g, r, ph, cell, kwin, timed, nt, cl = t.groups()
                key = (int(g), int(r), int(ph), cell, int(kwin))
                name = (f"score_loop_kernel<{g}, {r}, {ph}, "
                        f"{'int32' if cell == 'i' else 'int16'}, {kwin}, "
                        f"{timed}, {nt or 128}, {cl or 1}> "
                        f"({_MODES.get(key, '?')}"
                        f"{', timed' if timed == '1' else ''})")
            elif "backtrace_kernel" in name:
                name = ("backtrace_kernel<int32>" if "IiE" in name
                        else "backtrace_kernel<int16>")
            rows.append([name, "", ""])
        elif name and "stack frame" in line:
            rows[-1][1] = line.strip()
        elif name and "Used" in line and "registers" in line:
            rows[-1][2] = line.split("Used", 1)[1].strip()
    return [f"{n}: {u}; {st}" for n, st, u in rows]


def prefix_plans(parent_dir=None, reps: int = 3) -> dict:
    """K3 at every launch plan it takes
    (``kernel_engine.every_prefix_plan``), and with ``parent_dir`` the
    build of its sources at its own plan, on each batch of
    ``PLAN_BATCHES``, in turns (the variants in order, then in reverse;
    CUDA events, ``reps`` launches a turn after a warm one), after
    checking that every
    variant gives the exports of this tree's default plan (their
    don't-cares zeroed).  Returns ms per launch by batch and variant."""
    import torch

    from . import Penalties, _build
    from . import semi2 as ts
    from .engine import semi_cell16
    from .kernel_engine import (_prefix_launch, _sms, every_prefix_plan,
                                prefix_plan)

    this = _build.library()
    parent = _build.build(parent_dir) if parent_dir else None
    res = {}
    for tag, (pen, n, length, s_cap) in PLAN_BATCHES.items():
        _, args, pkw, _ = _semi2_batch(Penalties(*pen), n, length,
                                       s_cap=s_cap)
        cfg = pkw["cfg"]
        cell16 = semi_cell16(pkw["Ltb"])
        at = (cfg, n, cell16, _sms(args[0].device))
        variants = [(this, plan) for plan in every_prefix_plan(*at)]
        if parent is not None:
            variants.insert(0, (parent, None))

        def run(lib, plan):
            with _built_from(lib):
                return _prefix_launch(*args, **pkw, plan=plan)

        want = ts.canonical_exports(run(this, None))
        for lib, plan in variants:
            got = ts.canonical_exports(run(lib, plan))
            bad = [k for k in want if not torch.equal(want[k], got[k])]
            del got
            if bad:
                raise SystemExit(f"K3{tag} at {plan}: exports {bad} differ")
        del want
        name = lambda plan: ("parent" if plan is None
                             else str((*plan[:3], plan.cluster)))
        turns = {name(plan): [] for _, plan in variants}
        for lib, plan in variants + variants[::-1]:
            run(lib, plan)  # warm
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                run(lib, plan)
            end.record()
            torch.cuda.synchronize()
            turns[name(plan)].append(start.elapsed_time(end) / reps)
        res["K3" + tag] = {"pairs": n, "length": length, "Kf": cfg.k_win,
                           "penalties": list(pen),
                           "default": name(prefix_plan(*at)),
                           "turns_ms": turns}
        del args
        torch.cuda.empty_cache()
    return res


def phases_main(args) -> None:
    from . import _build

    card = card_name()
    print(card, flush=True)
    _build.library()
    print(f"build: nvcc {_build.build_seconds} s")
    for line in ptxas_table(_build.build_log):
        print(f"  ptxas: {line}")
    if args.plans:
        rec = prefix_plans(args.ab[0] if args.ab else None)
        print(f"K3 plans on {card}: " + json.dumps(rec), flush=True)
    for name in (*PHASE_BATCHES, *SEMI2_BATCHES):
        rec = phase_split(name)
        print(f"phases {name} on {card}: " + json.dumps(rec), flush=True)
    for d in args.ab:
        rec = ab_turns(d)
        for line in ptxas_table(_build.build_log):
            print(f"  ptxas ({d}): {line}")
        print(f"A/B {d} on {card}: " + json.dumps(rec), flush=True)


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import AdaptiveReductionOption, Options, Penalties
    from .datagen import generate_pairs
    from .pipeline import AlignmentPipeline, PipelineConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--length", type=int, default=50000)
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--semi", action="store_true",
                    help="semi-global alignment (the CLI's -g)")
    ap.add_argument("--phases", action="store_true",
                    help="the score loop's per-phase cycle split")
    ap.add_argument("--plans", action="store_true",
                    help="with --phases: time K3 at each launch plan "
                         "(and the first --ab DIR's K3) in turns")
    ap.add_argument("--ab", metavar="DIR", action="append", default=[],
                    help="with --phases: time the build of DIR's sources "
                         "against this tree's, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.phases:
        phases_main(args)
        return
    card = card_name()
    pipe = AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(not args.semi),
        AdaptiveReductionOption(10, 50, 1), batch_size=2048, device="cuda"))
    pairs = generate_pairs(args.pairs, args.length, 0.05, seed=42)
    pipe.align_all(pairs)  # warm: builds the kernels, fits the score cap
    torch.cuda.synchronize()
    tag = f"{'semi' if args.semi else 'global'} l={args.length}"

    def timed(traced: bool) -> float:
        t0 = time.perf_counter()
        pipe.align_all(pairs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"{tag}: {args.pairs} pairs in {wall * 1e3:.2f} ms = "
              f"{args.pairs / wall:.1f} aln/s{' (traced)' if traced else ''}"
              f" on {card}; engines {sorted(pipe._engines)}; served "
              f"{pipe.served}")
        return wall

    for _ in range(args.calls - 1):
        timed(False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed(True)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("no device events traced: time with CUDA events instead")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    per_name = {}
    for e in dev:
        t, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"{tag}: device busy {busy / 1e3:.3f} ms of {wall * 1e3:.2f} ms "
          f"wall ({100 * busy / 1e3 / (wall * 1e3):.1f}%, idle "
          f"{100 - 100 * busy / 1e3 / (wall * 1e3):.1f}%)")
    for name, (t, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / 1e3:10.3f} ms  {n:6d} x  {name[:90]}")


if __name__ == "__main__":
    main()
