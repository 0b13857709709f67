"""Profile timed ``align_all`` calls of the port on the card, or the
score loop's phases.

    python -m wfa_tpu_torch.profiling [--length 50000] [--pairs 64]
                                      [--calls 3] [--semi]
                                      [--ab DIR | --host]
    python -m wfa_tpu_torch.profiling --phases [--plans [k3|warp]]
                                      [--ab DIR]

Generates ``generate_pairs(pairs, length, 0.05, seed=42)`` (bench.py's
data), runs one warm call of ``AlignmentPipeline.align_all`` (global, or
semi-global with ``--semi``; gap-affine 4/6/2, wf-adaptive 10/50/1,
device "cuda"), then times ``--calls`` calls
(host clock, each ending in a synchronise) and traces two more with
``torch.profiler``, one for host and device activity and one for device
activity only: the card's name and power limit, wall time, aln/s, the
device's busy share (the union of its kernel and copy intervals over the
traced call's wall, and over the untraced calls' median wall) and the
device time per kernel name.  With ``--ab DIR`` it times, untraced, the
same calls under the package copy in DIR and under this tree in turns
instead (:func:`path_turns`); ``--host`` prints the timed calls' records
of the program's own spans and counters (:mod:`wfa_tpu_torch.trace`:
wall ns of each kind of span, CPU ns of pack and build, pairs, batches,
bytes, refetches, launches) instead.

``--phases`` prints ptxas's register, spill and shared-memory report of
every kernel (when this process built the library), then runs the timed
instantiations of the score loop (:func:`run_phases`,
:func:`run_prefix_phases`, :func:`run_resume_phases`) on the batches of
``PHASE_BATCHES``: K1 on 2048 global pairs of l=1000 (k_win 128, s_cap
640), K1-long on 64 pairs of l=50000 (k_win 384, s_cap 27,648) and K1-kw
on 2048 pairs of l=4000 (KW = k_win 256, s_cap 2304), each at the stride
its path runs (``engine.score_stride``: 2/3/1 over (s_cap - 2) // 2 + 2
rows), of
``SEMI2_BATCHES``: K3 on 2048 semi-global pairs of l=1000 (Kf 2048) and
on 64 of l=10000 (Kf 20,096), S0 64, K2 256, and of ``RESUME_BATCHES``:
K4 on those two batches' exports; ``generate_pairs(n, l, 0.05,
seed=42)``, 4/6/2, 10/50/1, each path's own first batch.  For each it
prints the cycles the thread 0 of each pair spent in each phase of a
score step (``PHASES``), summed over the batch, per step and as a share,
and the mean width in columns of the band extend strides, with the
card's name and power limit.  ``--plans`` first times K3 at every launch plan it takes
(:func:`prefix_plans`), then K1-kw and K4 at every launch plan
(:func:`warp_plans`; ``--plans k3`` or ``--plans warp`` one of them).
Each ``--ab DIR`` imports
the copy of another revision's whole package in DIR (``git archive <rev>
wfa_tpu_torch | tar -x -C DIR``, DIR under the git-ignored
``wfa_tpu_torch/build/``) under another package name
(:func:`load_package`; the port's imports are all relative), which
builds its own library into its own build directory, and times, through
each package's own wrappers in turns on the same batch (DIR's, this
tree's, this tree's, DIR's; CUDA events, 3 launches a turn after a warm
one): K1, K1-long, K1-kw, K1-semi (1024 semi-global pairs of l=200,
k_win 512, s_cap 256), K3 and K4 (``AB_SEMI2``: 2048 semi-global pairs
of l=1000 at 4/6/2, 256 at 4/6/1, 64 of l=10000), after checking that
the two give the same outputs; then the semi-global l=1000 routes
(:func:`route_ab`): ``align_batch`` of the two-phase route and of
K1-semi at the full span on 1024 pairs, host clock, and each route's
kernels.  With ``--plans`` the first DIR's K3, K1-kw and K4 join the
plan turns.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

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
# K4's: phase 2 of those batches, on K3's exports, and of the smoke's 256
# pairs at 4/6/1
RESUME_BATCHES = {"K4": SEMI2_BATCHES["K3"],
                  "K4-10k": SEMI2_BATCHES["K3-10k"],
                  "K4-4/6/1": ((4, 6, 1), 256, 1000, 640)}
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
# the warp shape's plans in turns: K1-kw on the l=4000 path's batch and at
# the tier-1 window (KW = k_win 512) on 256 of its pairs, as a retry gets
# them, (pairs, l, k_win, s_cap, KW); K4 on AB_SEMI2's batches
# and a sweep of pairs an SM at both windows, where the plan moves the
# workspace between shared memory and the scratch
WARP_KW_BATCHES = {"K1-kw": PHASE_BATCHES["K1-kw"][:5],
                   "K1-kw k_win 512": (256, 4000, 512, 2304, 512),
                   **{f"K1-kw k_win {k} {n} pairs": (n, 4000, k, 2304, k)
                      for k, sizes in ((256, (264, 528, 1056)),
                                       (512, (528, 1056)))
                      for n in sizes}}
# K4's: AB_SEMI2's batches and a sweep of pairs an SM at l=1000, at 4/6/2
# and 4/6/1
WARP_RESUME_BATCHES = {**AB_SEMI2, **{
    f" {pen} {n} pairs": (pen, n, 1000, 640)
    for pen, sizes in (((4, 6, 2), (264, 528, 792, 1056, 1320)),
                       ((4, 6, 1), (528, 1056, 2048)))
    for n in sizes}}
# the routes' A/B batch: K1-semi's aux at the full span is 16 GiB
AB_ROUTE_PAIRS = 1024


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _this():
    """This package (the module's own parent package)."""
    return sys.modules[__package__]


def _sub(pkg, name: str):
    """The submodule ``name`` of package ``pkg`` (this one, or a copy
    :func:`load_package` imported)."""
    return importlib.import_module(f"{pkg.__name__}.{name}")


def load_package(root):
    """Import the copy of the port's package in ``root`` (a directory
    holding ``wfa_tpu_torch/``, e.g. unpacked from ``git archive <rev>
    wfa_tpu_torch``) under another package name, ``wfa_ab_<n>``.  The
    port's imports are all relative, so its modules, its kernel library
    (built from its own ``csrc`` into its own ``build`` directory at first
    use) and its launch counters are its own."""
    pkg_dir = Path(root).resolve() / "wfa_tpu_torch"
    n = sum(m.startswith("wfa_ab_") and "." not in m for m in sys.modules)
    name = f"wfa_ab_{n}"
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _cfg(pkg, pen, global_alignment: bool, k_win: int, s_cap: int,
         kw=None):
    """An EngineConfig of package ``pkg`` at penalties ``pen`` (a tuple),
    wf-adaptive 10/50/1."""
    return _sub(pkg, "engine").EngineConfig(
        penalties=pkg.Penalties(*pen), global_alignment=global_alignment,
        adaptive=pkg.AdaptiveReductionOption(10, 50, 1), k_win=k_win,
        s_cap=s_cap, aux_kw=kw)


def kernel_batch(n: int, length: int, k_win: int, s_cap: int, kw=None,
                 device: str = "cuda", global_alignment: bool = True):
    """(cfg, inputs) of a batch: ``generate_pairs(n, length, 0.05,
    seed=42)`` packed at k_win, 4/6/2, 10/50/1."""
    from .datagen import generate_pairs
    from .engine import _pack_all, inputs_from_packed

    cfg = _cfg(_this(), (4, 6, 2), global_alignment, k_win, s_cap, kw)
    pairs = generate_pairs(n, length, 0.05, seed=42)
    return cfg, inputs_from_packed(
        _pack_all(pairs, k_win, global_alignment=global_alignment), device)


# the phases of the timed instantiation's cycles columns: extend (with
# dmin and the Ak cell), the termination test, the reduce (classify, the
# mark scan, the zero pass with the flush's value range), the flush (its
# plan and its writes), next() (the new cells), the new bands (the barrier
# and the ballot scans), the semi-global end finder, the zero tail of the
# aux rows next() writes whole (outside its columns), the set-up before the
# first step (zeroing, seeding, the phase-1 handoff), and the prefix's
# exports (the other modes: the out rows); then two counters, the columns
# extend strode and the steps, both summed over the steps
PHASES = ("extend", "termination", "reduce", "flush", "next", "bands",
          "end finder", "zero tail", "setup", "exports")
COUNTERS = ("width", "steps")


def _cycles(B: int, dev):
    import torch

    return torch.zeros((B, len(PHASES) + len(COUNTERS)), dtype=torch.int64,
                       device=dev)


def run_phases(qb, tbuf, qlen, tlen, toff, *, cfg, Lq: int, Ltb: int,
               mode: int = 0, plan=None):
    """One launch of the timed score loop ``wfa_score_loop_phases`` in
    ``mode`` (0 K1, 2 K1-long, 3 K1-kw at ``cfg.aux_kw`` and ``plan``) on
    CUDA tensors: returns (out int32[7, B], cycles int64[B, len(PHASES) +
    2]), the cycles the thread 0 of each pair spent in each of ``PHASES``,
    then ``COUNTERS``.  No path runs it, so no launch count counts it."""
    import torch

    from ._build import launch, stream_ptr
    from .kernel_engine import loop_args

    B, S = qb.shape[0], cfg.s_cap
    dev = qb.device
    cycles = _cycles(B, dev)
    aux = torch.empty((3, S, B, cfg.aux_kw or cfg.k_win), device=dev,
                      dtype=torch.int32 if mode == 0 else torch.int16)
    base = (None if mode == 0 else torch.empty(
        (B, S) if mode == 2 else (S, B), dtype=torch.int32, device=dev))
    args, out = loop_args(qb, tbuf, qlen, tlen, toff, cfg, Lq, Ltb, mode,
                          aux, base, kw=cfg.aux_kw or 0, plan=plan)
    launch("wfa_score_loop_phases", *args, cycles, stream_ptr(dev))
    return out, cycles


def run_prefix_phases(qb, tbuf, qlen, tlen, toff, *, cfg, Lq: int, Ltb: int,
                      S0: int, K2: int, plan=None):
    """One launch of K3's timed instantiation (``wfa_prefix`` with cycles)
    at ``plan`` (default ``kernel_engine.prefix_plan``): returns (the
    exports, cycles as :func:`run_phases`').  Counts no launch."""
    from . import kernel_engine

    cycles = _cycles(qb.shape[0], qb.device)
    ex = kernel_engine._prefix_launch(
        qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb, S0=S0, K2=K2,
        plan=plan, cycles=cycles)
    return ex, cycles


def run_resume_phases(*r_args, plan=None, **rkw):
    """One launch of K4's timed instantiation (``wfa_resume`` with cycles)
    on ``run_resume``'s arguments at ``plan`` (default
    ``kernel_engine.warp_plan``): returns (its outputs, cycles as
    :func:`run_phases`').  Counts no launch."""
    from . import kernel_engine

    cycles = _cycles(r_args[0].shape[0], r_args[0].device)
    res = kernel_engine._resume_launch(*r_args, **rkw, plan=plan,
                                       cycles=cycles)
    return res, cycles


def phase_split(name: str) -> dict:
    """The timed score loop on ``PHASE_BATCHES[name]`` (at the stride its
    path runs), for K3
    ``SEMI2_BATCHES[name]``, for K4 ``RESUME_BATCHES[name]`` (on K3's
    exports), each at its launch plan: cycles per phase (summed over the batch's pairs), per step,
    and shares; the steps, and the mean columns extend strode a step; the
    launch's milliseconds (CUDA events, stamps included)."""
    import torch

    from .engine import loop_config, score_stride, semi_cell16
    from .kernel_engine import (_prefix_launch, _sms, kw_mode, prefix_plan,
                                resume_mode, warp_plan)

    sms = _sms(torch.device("cuda"))
    if name in SEMI2_BATCHES or name in RESUME_BATCHES:
        from .semi2 import M1_DONE

        pen, n, length, s_cap = {**SEMI2_BATCHES, **RESUME_BATCHES}[name]
        batch, args, Kf = _semi2_data(n, length)
        pkw, cfg = _semi2_cfgs(_this(), pen, Kf, args, s_cap)
        cell16 = semi_cell16(pkw["Ltb"])
        rec = {"row": name, "pairs": n, "length": length, "Kf": Kf,
               "S0": pkw["S0"], "k_win": cfg.k_win, "s_cap": s_cap,
               "cell16": cell16}
        if name in SEMI2_BATCHES:
            def run():
                ex, cyc = run_prefix_phases(*args[:5], **pkw)
                return ex["meta1"][:, M1_DONE], cyc

            rec["plan"] = prefix_plan(pkw["cfg"], n, cell16, sms)._asdict()
        else:
            r_args, rkw = _resume_args(batch, args,
                                       _prefix_launch(*args[:5], **pkw), pkw,
                                       cfg)
            plan = warp_plan(cfg, resume_mode(pkw["Ltb"]), n, sms)

            def run():
                res, cyc = run_resume_phases(*r_args, **rkw, plan=plan)
                return res[1], cyc

            rec["plan"] = plan._asdict()
    else:
        n, length, k_win, s_cap, kw, mode = PHASE_BATCHES[name]
        cfg, ins = kernel_batch(n, length, k_win, s_cap, kw)
        g = score_stride(cfg)
        cfg = loop_config(cfg, g)
        args = ins[:5]
        pkw = dict(cfg=cfg, Lq=ins[5], Ltb=ins[6], mode=mode)

        def run():
            out, cyc = run_phases(*args, **pkw)
            return out[1], cyc

        rec = {"row": name, "pairs": n, "length": length, "k_win": k_win,
               "s_cap": s_cap, "kw": kw, "stride": g,
               "loop_s_cap": cfg.s_cap}
        if mode == 3:
            rec["plan"] = warp_plan(cfg, kw_mode(ins[6]), n, sms)._asdict()
    run()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    done, cyc = run()
    end.record()
    torch.cuda.synchronize()
    tot = cyc.sum(0).tolist()
    width, steps = tot[len(PHASES):]
    total = sum(tot[:len(PHASES)])
    rec.update({"ms": start.elapsed_time(end), "steps": steps,
                "done": int((done > 0).sum()),
                "cycles_per_step": total / max(steps, 1),
                "band_width": width / max(steps, 1),
                "phases": {ph: {"cycles": c, "per_step": c / max(steps, 1),
                                "share": c / max(total, 1)}
                           for ph, c in zip(PHASES, tot)}})
    del args, done, cyc
    torch.cuda.empty_cache()
    return rec


def _turns(fns: dict, reps: int, host: bool = False) -> dict:
    """ms per call of each of ``fns`` ("parent" and "this": parent, this,
    this, parent; or "this" alone, twice), ``reps`` calls a turn after a
    warm one: device time between CUDA events, or with ``host`` the
    host's clock up to a synchronise."""
    import torch

    order = (("parent", "this", "this", "parent") if "parent" in fns
             else ("this", "this"))
    out = {who: [] for who in fns}
    for who in order:
        fn = fns[who]
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


def _k1_diff(mode: int, a, b):
    """The first part in which two score-loop results of ``mode`` (0 K1, 1
    K1-semi, 2 K1-long, 3 K1-kw; their wrappers' tuples) differ, their
    don't-cares aside (aux rows and bases above final_s and of pairs not
    served), or None."""
    import torch

    from .engine import canonical_kw

    if mode == 3:
        a, b = canonical_kw(a), canonical_kw(b)
        return next((f"output {i}" for i, (x, y) in enumerate(zip(a, b))
                     if not torch.equal(x, y)), None)
    for i in range(4):
        if not torch.equal(a[i], b[i]):
            return f"output {i}"
    if mode <= 1 and not all(torch.equal(x, y) for x, y in zip(a[5], b[5])):
        return "the ends"
    final_s, ok = a[0], a[1] & ~a[2]
    rows = torch.arange(a[4].shape[1], device=final_s.device)
    live = (rows[:, None] <= final_s[None, :]) & ok[None, :]  # [S, B]
    for c in range(3):
        if not torch.equal(torch.where(live[:, :, None], a[4][c], 0),
                           torch.where(live[:, :, None], b[4][c], 0)):
            return f"aux plane {c}"
    if mode == 2 and not torch.equal(torch.where(live.t(), a[5], 0),
                                     torch.where(live.t(), b[5], 0)):
        return "bases"
    return None


# each score-loop mode's wrapper in kernel_engine
_K1_WRAPPERS = {0: "run_batch", 1: "run_batch", 2: "run_batch_long",
                3: "run_batch_kw"}


def ab_turns(pkgs: dict, reps: int = 3) -> dict:
    """K1, K1-long, K1-kw and K1-semi (``AB_BATCHES``), K3 and K4 on the
    batches of ``AB_SEMI2``, and the semi-global routes (:func:`route_ab`)
    of the packages ``pkgs`` ("parent": :func:`load_package`'s copy,
    "this"), each through its own wrappers, on the same batch in turns
    (parent, this, this, parent; ms per call); fails unless both give the
    same out rows, aux rows (to each done pair's final_s) and row bases,
    or exports and phase-2 outputs."""
    import torch

    res = {}
    for name, (n, length, k_win, s_cap, kw, mode) in AB_BATCHES.items():
        ga = mode != 1
        _, ins = kernel_batch(n, length, k_win, s_cap, kw,
                              global_alignment=ga)
        args, kwargs = ins[:5], dict(Lq=ins[5], Ltb=ins[6])
        fns = {who: (lambda fn, cfg: lambda: fn(*args, cfg=cfg, **kwargs))(
            getattr(_sub(pkg, "kernel_engine"), _K1_WRAPPERS[mode]),
            _cfg(pkg, (4, 6, 2), ga, k_win, s_cap, kw))
            for who, pkg in pkgs.items()}
        got = [fns[who]() for who in ("parent", "this")]
        torch.cuda.synchronize()
        bad = _k1_diff(mode, *got)
        if bad:
            raise SystemExit(f"A/B {name}: {bad} differs")
        ok = got[0][1] & ~got[0][2]
        del got
        res[name] = {"pairs": n, "length": length, "k_win": k_win,
                     "s_cap": s_cap, "kw": kw, "done": int(ok.sum()),
                     "turns_ms": _turns(fns, reps)}
        del ins, args, fns
        torch.cuda.empty_cache()
    for tag, (pen, n, length, s_cap) in AB_SEMI2.items():
        for name, rec in ab_semi2(pkgs, pen, n, length, s_cap,
                                  reps).items():
            res[name + tag] = rec
    res["routes"] = route_ab(pkgs)
    return res


def _semi2_data(n: int, length: int):
    """The two-phase route's first batch of ``n`` semi-global pairs of
    ``length`` (``generate_pairs(n, length, 0.05, seed=42)``): (pairs,
    K3's input tensors on the card with Lq and Ltb, the full span Kf)."""
    from . import semi2 as ts
    from .datagen import generate_pairs
    from .engine import _pack_all, inputs_from_packed

    pairs = generate_pairs(n, length, 0.05, seed=42)
    packed = _pack_all(pairs, 128, global_alignment=False)
    return (pairs, inputs_from_packed(packed, "cuda"),
            ts.prefix_span(packed[2], packed[3]))


def _semi2_cfgs(pkg, pen, Kf: int, ins, s_cap: int, S0: int = 64,
                k_win: int = 256):
    """K3's keywords (its config at the full span Kf, Lq, Ltb, S0, K2)
    and phase 2's config, of package ``pkg``, for the inputs ``ins`` of
    :func:`_semi2_data` at penalties ``pen`` (a tuple)."""
    import dataclasses

    cfg = _cfg(pkg, pen, False, k_win, s_cap)
    return dict(cfg=dataclasses.replace(cfg, k_win=Kf), Lq=ins[5],
                Ltb=ins[6], S0=S0, K2=k_win), cfg


def _resume_args(pairs, ins, ex, pkw, cfg):
    """K4's arguments and keywords after K3's exports ``ex``: the
    re-placed targets, phase 2's config ``cfg``."""
    import torch

    from . import semi2 as ts

    k02 = ex["meta1"][:, ts.M1_K02].cpu().numpy()
    t2raw, _, toff2, Ltb2 = ts.replace_targets([t for _, t in pairs], k02)
    qb, _, qlen, tlen, _ = ins[:5]
    r_args = (qb, torch.from_numpy(t2raw).cuda(), qlen, tlen,
              torch.from_numpy(toff2).cuda(),
              *(ex[k] for k in ("win_m", "win_i", "win_d", "ainit", "b_m",
                                "b_ie", "meta1")))
    return r_args, dict(cfg=cfg, Lq=pkw["Lq"], Ltb2=Ltb2,
                        Ltb_full=pkw["Ltb"], S0=pkw["S0"])


def ab_semi2(pkgs: dict, pen, n: int, length: int, s_cap: int,
             reps: int) -> dict:
    """K3 and K4 of both packages on the two-phase route's first batch of
    ``n`` semi-global pairs of ``length`` at ``pen`` (Kf the full span,
    S0 64, k_win 256), in turns, after checking that both give the same
    exports and phase-2 outputs (their don't-cares zeroed); K4 of both
    runs on this tree's exports."""
    import torch

    from . import semi2 as ts

    pairs, ins, Kf = _semi2_data(n, length)
    cfgs = {who: _semi2_cfgs(pkg, pen, Kf, ins, s_cap)
            for who, pkg in pkgs.items()}
    k3 = {who: (lambda fn, pkw: lambda: fn(*ins[:5], **pkw))(
        _sub(pkg, "kernel_engine").run_prefix, cfgs[who][0])
        for who, pkg in pkgs.items()}
    got = [k3[who]() for who in ("parent", "this")]
    ex = got[1]
    a, b = (ts.canonical_exports(e) for e in got)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    if bad:
        raise SystemExit(f"A/B K3 {pen}: exports {bad} differ")
    del got, a, b
    k3_ms = _turns(k3, reps)
    pkw, cfg = cfgs["this"]
    r_args, _ = _resume_args(pairs, ins, ex, pkw, cfg)
    k4 = {who: (lambda fn, rkw: lambda: fn(*r_args, **rkw))(
        _sub(pkg, "kernel_engine").run_resume,
        _resume_args(pairs, ins, ex, *cfgs[who])[1])
        for who, pkg in pkgs.items()}
    S0 = pkw["S0"]
    a, b = (ts.canonical_resume(k4[who](), S0) for who in ("parent", "this"))
    if not all(torch.equal(x, y) for x, y in zip(a[:5] + a[5], b[:5] + b[5])):
        raise SystemExit(f"A/B K4 {pen}: phase-2 outputs differ")
    del a, b
    k4_ms = _turns(k4, reps)
    del ex, r_args, k3, k4
    torch.cuda.empty_cache()
    common = {"pairs": n, "length": length, "penalties": list(pen),
              "Kf": Kf, "S0": S0, "k_win": cfg.k_win, "s_cap": cfg.s_cap}
    return {"K3": {**common, "turns_ms": k3_ms},
            "K4": {**common, "turns_ms": k4_ms}}


def route_ab(pkgs: dict, reps: int = 3) -> dict:
    """The semi-global l=1000 routes on the same ``AB_ROUTE_PAIRS`` pairs,
    s_cap 640: the two-phase route (engine "semi2:64", k_win 256) and
    K1-semi at the full span (engine "auto", k_win 2048), each under each
    package of ``pkgs`` ("this", and "parent" where given) in turns.  Per
    route and package: ``align_batch``'s wall time (host clock, ``reps``
    calls a turn) and its kernels' device time (CUDA events: K3 + K4 + K2,
    or K1-semi + K2); the pairs each route serves.  Fails unless the
    routes agree where both serve."""
    import torch

    from .datagen import generate_pairs
    from .engine import _token_plan

    n = AB_ROUTE_PAIRS
    pairs = generate_pairs(n, 1000, 0.05, seed=42)
    shapes = {"two-phase": dict(k_win=256, engine="semi2:64"),
              "full span": dict(k_win=2048, engine="auto")}
    routes = {name: {who: _sub(pkg, "engine").BatchAligner(
        pkg.Penalties(4, 6, 2), pkg.Options(False),
        pkg.AdaptiveReductionOption(10, 50, 1), s_cap=640, device="cuda",
        **shape) for who, pkg in pkgs.items()}
        for name, shape in shapes.items()}
    out = {name: engs["this"].align_batch(pairs, fallback=False)
           for name, engs in routes.items()}
    for i, (x, y) in enumerate(zip(out["two-phase"], out["full span"])):
        if x is not None and y is not None and (
                x.score, x.cigar(False)) != (y.score, y.cigar(False)):
            raise SystemExit(f"A/B routes: pair {i} differs")
    res = {name: {"serves": sum(r is not None for r in o)}
           for name, o in out.items()}
    del out
    for name, engs in routes.items():
        res[name]["align_batch_ms"] = _turns(
            {who: (lambda e: lambda: e.align_batch(pairs, fallback=False))(
                eng) for who, eng in engs.items()}, reps, host=True)
    del routes

    # each route's kernels on this batch, through each package's wrappers
    _, ins, Kf = _semi2_data(n, 1000)
    Lq, Ltb = ins[5], ins[6]
    qlen, tlen, toff = ins[2:5]
    shift, _ = _token_plan(640, _this().Penalties(4, 6, 2), Lq, Ltb)

    def two_phase(pkg):
        ke, db = _sub(pkg, "kernel_engine"), _sub(pkg, "device_backtrace")
        pkw, cfg = _semi2_cfgs(pkg, (4, 6, 2), Kf, ins, 640)
        ex = ke.run_prefix(*ins[:5], **pkw)
        r_args, rkw = _resume_args(pairs, ins, ex, pkw, cfg)
        r = ke.run_resume(*r_args, **rkw)
        bt = (r[4], r[5][2], -r_args[4], r[5][0], r[5][1], qlen, tlen,
              r[1] & ~r[2])
        bkw = dict(penalties=cfg.penalties, S=640, K=256, token_shift=shift,
                   global_alignment=False, aux_old=ex["aux_old"],
                   k0_old=-(qlen - 1), s_split=pkw["S0"])

        def run():
            ke.run_prefix(*ins[:5], **pkw)
            ke.run_resume(*r_args, **rkw)
            db.device_backtrace(*bt, **bkw)
        return run

    def full_span(pkg):
        ke, db = _sub(pkg, "kernel_engine"), _sub(pkg, "device_backtrace")
        cfg = _cfg(pkg, (4, 6, 2), False, 2048, 640)
        k1 = ke.run_batch(*ins[:5], cfg=cfg, Lq=Lq, Ltb=Ltb)
        bt = (k1[4], k1[5][2], -toff, k1[5][0], k1[5][1], qlen, tlen,
              k1[1] & ~k1[2])
        bkw = dict(penalties=cfg.penalties, S=640, K=2048,
                   token_shift=shift, global_alignment=False)

        def run():
            ke.run_batch(*ins[:5], cfg=cfg, Lq=Lq, Ltb=Ltb)
            db.device_backtrace(*bt, **bkw)
        return run

    for name, make in (("two-phase", two_phase), ("full span", full_span)):
        res[name]["kernels_ms"] = _turns(
            {who: make(pkg) for who, pkg in pkgs.items()}, reps)
        torch.cuda.empty_cache()
    return {"pairs": n, "length": 1000, "s_cap": 640, **res}


_MODES = {(1, 0, 0, "i"): "K1", (0, 0, 0, "i"): "K1-semi",
          (1, 1, 0, "s"): "K1-long", (0, 0, 1, "i"): "K3 int32",
          (0, 0, 1, "s"): "K3 int16", (0, 0, 2, "i"): "K4 int32",
          (0, 0, 2, "s"): "K4 int16"}


def ptxas_table(log: str) -> list:
    """ptxas's report (``-Xptxas -v``) of every kernel in an nvcc log: one
    line per entry function with its registers, stack, spills and static
    shared memory; score-loop instantiations by their template arguments
    (GLOBAL, REBASE, PHASE, Cell, TIMED, NT, CL, and before TIMED an
    older build's KWIN, which marked its K1-kw; the warp shape's KW, Cell,
    TIMED, W16) and row name."""
    import re

    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"score_loop_kernelILb(\d)ELb(\d)ELi(\d)E(\w)"
                          r"((?:Lb\dE)+)(?:Li(\d+)E)?(?:Li(\d+)E)?", name)
            w = re.search(r"warp_loop_kernelILb(\d)E(\w)Lb(\d)ELb(\d)E",
                          name)
            if w:
                kw, cell, timed, w16 = w.groups()
                name = (f"warp_loop_kernel<{kw}, "
                        f"{'int32' if cell == 'i' else 'int16'}, {timed}, "
                        f"{w16}> ({'K1-kw' if kw == '1' else 'K4'}"
                        f"{', 16-bit cells' if w16 == '1' else ''}"
                        f"{', timed' if timed == '1' else ''})")
            elif t:
                g, r, ph, cell, flags, nt, cl = t.groups()
                flags = re.findall(r"\d", flags)
                timed = flags[-1]
                row = ("K1-kw" if flags[0] == "1" and len(flags) == 2
                       else _MODES.get((int(g), int(r), int(ph), cell), "?"))
                name = (f"score_loop_kernel<{g}, {r}, {ph}, "
                        f"{'int32' if cell == 'i' else 'int16'}, "
                        f"{', '.join(flags)}, {nt or 128}, {cl or 1}> "
                        f"({row}{', timed' if timed == '1' else ''})")
            elif "backtrace_kernel" in name:
                name = ("backtrace_kernel<int32>" if "IiE" in name
                        else "backtrace_kernel<int16>")
            rows.append([name, "", ""])
        elif name and "stack frame" in line:
            rows[-1][1] = line.strip()
        elif name and "Used" in line and "registers" in line:
            rows[-1][2] = line.split("Used", 1)[1].strip()
    return [f"{n}: {u}; {st}" for n, st, u in rows]


def _plan_turns(variants: list, reps: int) -> dict:
    """ms per launch of each (name, fn) of ``variants``, in turns (the
    variants in order, then in reverse; CUDA events, ``reps`` launches a
    turn after a warm one)."""
    import torch

    turns = {name: [] for name, _ in variants}
    for name, fn in variants + variants[::-1]:
        fn()  # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        turns[name].append(start.elapsed_time(end) / reps)
    return turns


def prefix_plans(parent=None, reps: int = 3) -> dict:
    """K3 at every launch plan it takes
    (``kernel_engine.every_prefix_plan``), and with ``parent`` (a package
    of :func:`load_package`) the parent's K3 at its own plan, on each
    batch of ``PLAN_BATCHES``, in turns (:func:`_plan_turns`), after
    checking that every variant gives the exports of this tree's default
    plan (their don't-cares zeroed).  Returns ms per launch by batch and
    variant."""
    import torch

    from . import semi2 as ts
    from .engine import semi_cell16
    from .kernel_engine import (_prefix_launch, _sms, every_prefix_plan,
                                prefix_plan)

    res = {}
    for tag, (pen, n, length, s_cap) in PLAN_BATCHES.items():
        _, ins, Kf = _semi2_data(n, length)
        pkw, _ = _semi2_cfgs(_this(), pen, Kf, ins, s_cap)
        at = (pkw["cfg"], n, semi_cell16(pkw["Ltb"]), _sms(ins[0].device))
        name = lambda plan: str((*plan[:3], plan.cluster))  # noqa: E731
        variants = [(name(plan), (lambda plan: lambda: _prefix_launch(
            *ins[:5], **pkw, plan=plan))(plan))
            for plan in every_prefix_plan(*at)]
        if parent is not None:
            ppkw, _ = _semi2_cfgs(parent, pen, Kf, ins, s_cap)
            variants.insert(0, ("parent", lambda: _sub(
                parent, "kernel_engine").run_prefix(*ins[:5], **ppkw)))
        want = ts.canonical_exports(_prefix_launch(*ins[:5], **pkw))
        for vname, fn in variants:
            got = ts.canonical_exports(fn())
            bad = [k for k in want if not torch.equal(want[k], got[k])]
            del got
            if bad:
                raise SystemExit(f"K3{tag} at {vname}: exports {bad} differ")
        del want
        res["K3" + tag] = {"pairs": n, "length": length, "Kf": Kf,
                           "penalties": list(pen),
                           "default": name(prefix_plan(*at)),
                           "turns_ms": _plan_turns(variants, reps)}
        del ins, variants
        torch.cuda.empty_cache()
    return res


def warp_plans(parent=None, reps: int = 3) -> dict:
    """K1-kw (``WARP_KW_BATCHES``) and K4 (on K3's exports of each batch
    of ``WARP_RESUME_BATCHES``) at every launch plan
    (``kernel_engine.every_warp_plan``: pairs a block, the workspace in
    shared memory or the scratch), and
    with ``parent`` the parent's at its own launch, in turns
    (:func:`_plan_turns`), after checking that every variant gives the
    outputs of this tree's default plan (their don't-cares zeroed).
    Returns ms per launch by batch and variant."""
    import torch

    from . import semi2 as ts
    from .kernel_engine import (_kw_launch, _prefix_launch, _resume_launch,
                                _sms, every_warp_plan, kw_mode, resume_mode,
                                warp_plan)

    sms = _sms(torch.device("cuda"))
    name = lambda plan: str(tuple(plan[:3]))  # noqa: E731
    res = {}
    for tag, (n, length, k_win, s_cap, kw) in WARP_KW_BATCHES.items():
        cfg, ins = kernel_batch(n, length, k_win, s_cap, kw)
        kwargs = dict(Lq=ins[5], Ltb=ins[6])
        mode = kw_mode(ins[6])
        variants = [(name(plan), (lambda plan: lambda: _kw_launch(
            *ins[:5], cfg=cfg, **kwargs, plan=plan))(plan))
            for plan in every_warp_plan(cfg, mode, n, sms)]
        if parent is not None:
            pcfg = _cfg(parent, (4, 6, 2), True, k_win, s_cap, kw)
            variants.insert(0, ("parent", lambda: _sub(
                parent, "kernel_engine").run_batch_kw(*ins[:5], cfg=pcfg,
                                                      **kwargs)))
        want = _kw_launch(*ins[:5], cfg=cfg, **kwargs)
        for vname, fn in variants:
            bad = _k1_diff(3, want, fn())
            if bad:
                raise SystemExit(f"{tag} at {vname}: {bad} differs")
        del want
        res[tag] = {"pairs": n, "length": length, "k_win": k_win, "kw": kw,
                    "mode": mode,
                    "default": name(warp_plan(cfg, mode, n, sms)),
                    "turns_ms": _plan_turns(variants, reps)}
        del ins, variants
        torch.cuda.empty_cache()
    for tag, (pen, n, length, s_cap) in WARP_RESUME_BATCHES.items():
        pairs, ins, Kf = _semi2_data(n, length)
        pkw, cfg = _semi2_cfgs(_this(), pen, Kf, ins, s_cap)
        ex = _prefix_launch(*ins[:5], **pkw)
        r_args, rkw = _resume_args(pairs, ins, ex, pkw, cfg)
        mode = resume_mode(pkw["Ltb"])
        variants = [(name(plan), (lambda plan: lambda: _resume_launch(
            *r_args, **rkw, plan=plan))(plan))
            for plan in every_warp_plan(cfg, mode, n, sms)]
        if parent is not None:
            _, prkw = _resume_args(pairs, ins, ex,
                                   *_semi2_cfgs(parent, pen, Kf, ins, s_cap))
            variants.insert(0, ("parent", lambda: _sub(
                parent, "kernel_engine").run_resume(*r_args, **prkw)))
        S0 = pkw["S0"]
        want = ts.canonical_resume(_resume_launch(*r_args, **rkw), S0)
        for vname, fn in variants:
            got = ts.canonical_resume(fn(), S0)
            if not all(torch.equal(x, y) for x, y in
                       zip(want[:5] + want[5], got[:5] + got[5])):
                raise SystemExit(f"K4{tag} at {vname}: outputs differ")
        del want, got
        res["K4" + tag] = {"pairs": n, "length": length, "Kf": Kf,
                           "penalties": list(pen), "k_win": cfg.k_win,
                           "default": name(warp_plan(cfg, mode, n, sms)),
                           "turns_ms": _plan_turns(variants, reps)}
        del ins, ex, r_args, variants
        torch.cuda.empty_cache()
    return res


def phases_main(args) -> None:
    from concurrent.futures import ThreadPoolExecutor

    card = card_name()
    print(card, flush=True)
    pkgs = [_this(), *(load_package(d) for d in args.ab)]
    builds = [_sub(pkg, "_build") for pkg in pkgs]
    # every package's nvcc processes at once
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: b.library(), builds))
    for d, b in zip(["this tree", *args.ab], builds):
        print(f"build ({d}): nvcc {b.build_seconds} s")
        for line in ptxas_table(b.build_log):
            print(f"  ptxas ({d}): {line}")
    parent = pkgs[1] if len(pkgs) > 1 else None
    if args.plans in ("all", "k3"):
        rec = prefix_plans(parent)
        print(f"K3 plans on {card}: " + json.dumps(rec), flush=True)
    if args.plans in ("all", "warp"):
        rec = warp_plans(parent)
        print(f"warp plans on {card}: " + json.dumps(rec), flush=True)
    for name in (*PHASE_BATCHES, *SEMI2_BATCHES, *RESUME_BATCHES):
        rec = phase_split(name)
        print(f"phases {name} on {card}: " + json.dumps(rec), flush=True)
    for d, pkg in zip(args.ab, pkgs[1:]):
        rec = ab_turns({"this": pkgs[0], "parent": pkg})
        print(f"A/B {d} on {card}: " + json.dumps(rec), flush=True)


def path_turns(pkgs: dict, length: int, n: int, semi: bool,
               calls: int) -> dict:
    """The path's ``align_all`` under each package of ``pkgs`` ("parent",
    "this"), in turns (parent, this, this, parent): a warm call (which
    builds the package's kernels and fits its score cap), then ``calls``
    timed calls a turn, host clock up to a synchronise, on
    ``generate_pairs(n, length, 0.05, seed=42)`` (4/6/2, 10/50/1, batch
    2048); returns ms per call by package, what each served and, for a
    package whose pipeline keeps it, its last call's peak batches in
    flight and bytes reserved (``AlignmentPipeline.peak``)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from .datagen import generate_pairs

    with ThreadPoolExecutor(len(pkgs)) as pool:  # every nvcc at once
        list(pool.map(lambda p: _sub(p, "_build").library(), pkgs.values()))
    pairs = generate_pairs(n, length, 0.05, seed=42)
    pipes = {}
    for who, pkg in pkgs.items():
        pl = _sub(pkg, "pipeline")
        pipes[who] = pl.AlignmentPipeline(pl.PipelineConfig(
            pkg.Penalties(4, 6, 2), pkg.Options(not semi),
            pkg.AdaptiveReductionOption(10, 50, 1), batch_size=2048,
            device="cuda"))
        pipes[who].align_all(pairs)
    out = {who: [] for who in pkgs}
    for who in ("parent", "this", "this", "parent"):
        for _ in range(calls):
            t0 = time.perf_counter()
            pipes[who].align_all(pairs)
            torch.cuda.synchronize()
            out[who].append((time.perf_counter() - t0) * 1e3)
    return {"pairs": n, "length": length, "semi": semi, "ms": out,
            "served": {who: dict(p.served) for who, p in pipes.items()},
            "peak": {who: dict(getattr(p, "peak", {}))
                     for who, p in pipes.items()}}


def _device_busy(prof):
    """(device busy us, {name: (us, count)}) of a trace, or None when it
    holds no device event."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
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
    return busy, per_name


def main() -> None:
    import torch
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
    ap.add_argument("--plans", nargs="?", const="all",
                    choices=("all", "k3", "warp"),
                    help="with --phases: time K3 (k3), K1-kw and K4 (warp) "
                         "or all three at each launch plan (and the first "
                         "--ab DIR's) in turns")
    ap.add_argument("--host", action="store_true",
                    help="the timed calls' span and counter records "
                         "(wfa_tpu_torch.trace) instead of the trace")
    ap.add_argument("--ab", metavar="DIR", action="append", default=[],
                    help="time the package copy in DIR (DIR/wfa_tpu_torch) "
                         "against this tree's, in turns: with --phases its "
                         "kernels, else the path's align_all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.phases:
        phases_main(args)
        return
    card = card_name()
    if args.ab:
        rec = path_turns({"this": _this(), "parent": load_package(args.ab[0])},
                         args.length, args.pairs, args.semi, args.calls)
        print(f"A/B {args.ab[0]} on {card}: " + json.dumps(rec), flush=True)
        return
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
              f"{pipe.served}; peak {pipe.peak}")
        return wall

    if args.host:
        from . import trace

        for _ in range(args.calls):
            timed(False)
        for rec in trace.records(args.calls):
            print(f"{tag} call record on {card}: " + json.dumps(rec),
                  flush=True)
        return
    walls = [timed(False) for _ in range(args.calls - 1)]
    mid = sorted(walls)[len(walls) // 2] if walls else None
    # two traced calls: host and device activity, the busy share of the
    # traced call's own wall (as the profiles before the workers took
    # it); device activity only, whose trace stretches a call of the
    # workers less, also as a share of the untraced calls' median wall
    for what, acts in (("host and device",
                        [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                       ("device only", [ProfilerActivity.CUDA])):
        with profile(activities=acts) as prof:
            wall = timed(True)
        traced = _device_busy(prof)
        if traced is None:
            print("no device events traced: time with CUDA events instead")
            return
        busy, per_name = traced
        print(f"{tag} (traced {what}): device busy {busy / 1e3:.3f} ms of "
              f"{wall * 1e3:.2f} ms wall ({100 * busy / 1e3 / (wall * 1e3):.1f}"
              f"%, idle {100 - 100 * busy / 1e3 / (wall * 1e3):.1f}%)")
        if mid:
            print(f"{tag} (traced {what}): the same busy time is "
                  f"{100 * busy / 1e6 / mid:.1f}% of the untraced calls' "
                  f"median wall, {mid * 1e3:.2f} ms")
        for name, (t, n) in sorted(per_name.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
            print(f"  {t / 1e3:10.3f} ms  {n:6d} x  {name[:90]}")


if __name__ == "__main__":
    main()
