"""Randomized check of the port's card kernels against their plain
versions and of its results against the oracle.

    python -m wfa_tpu_torch.fuzz [--seed 0] [--cases 40] [--start 0]
                                 [--device cuda]

Not a pytest file: it needs the card (``--device cpu`` runs the plain
versions on both sides, which checks only the harness and the oracle
comparison).  Each case draws, from ``random.Random(seed)``:

* penalties: random ones, or one of ``DEGENERATE`` (mismatch or gap
  extension 1, gap open 0: the steps where next() reads the row the
  reduce just zeroed);
* global or semi-global, wf-adaptive on (max_dist_diff 20 or 50) or off;
* an engine: global ``"auto"``, ``"long"`` or ``"auto:kw<KW>"`` at KW
  below k_win; semi-global ``"auto"`` at the full span or
  ``"semi2:<S0>"``;
* k_win on either side of the score loop's shared-memory limit
  (``kernel_engine.workspace``: the largest window whose workspace fits
  the block's shared memory, and the next one up, or 128); for
  ``"semi2"``, in one case of two, K3's full span on either side of a
  threshold of its workspace (:func:`prefix_sides`: where it stops
  fitting shared memory, where its cells widen to int32), through a first
  pair whose target is cut or grown to it;
* a batch of 4-16 pairs of 60-450 bases at 2-20% error, with an
  identical pair, a prefix pair and, in one case of three, raw bytes
  outside ACGT; in one case of four the batch repeats to a size on
  either side of a pairs-a-block threshold of the warp shape's launch
  plan (:data:`BATCH_SIDES`, one or two SMs' worth of pairs).

Then it holds, at tolerance 0:

1. the card's outputs against the plain versions': ``align_full2``'s byte
   (or raw) streams, every key; for ``"semi2"`` the phase-1 exports
   (``semi2.canonical_exports``), K3's at every launch plan it takes, and
   the results of ``BatchAligner``; K1-kw's outputs (``"auto:kw"``) and
   K4's (``"semi2"``, on the card's exports) at every launch plan of the
   warp shape (``kernel_engine.every_warp_plan``);
2. every result the card serves against the oracle, decoded at once
   (score, CIGAR, coordinates, counts), and the served sets of card and
   plain alike;
3. for global cases, the results with ``WFA_EDIT_TOKENS=0`` (full token
   streams) against those with the edit-only default.

Then ``--mesh-cases`` rounds of the data-parallel mesh (the counterpart
of tests/fuzz.py:230-260), drawn from a generator of their own: penalties
(4/6/2, or random ones), global or semi-global, wf-adaptive on or off,
2, 4 or 8 shards of the one device (``PipelineConfig.devices``), batches
of 16 or 64 and 4-40 pairs of up to 90 bases (often not a multiple of the
mesh size) through ``AlignmentPipeline.align_all``: every result equal to
the same pipeline's on one device, field by field, and to the oracle's
score and CIGAR.

A mismatch prints one JSON line (seed, case, config, the pair and the
first tensor or field that diverges) and the run exits 1.  A case whose
batch the pipeline's memory model puts past ``MAX_MODEL_BYTES`` (its
plain versions on the CPU would not fit the host) holds step 1 on slices
of its distinct pairs, each under it, and its whole batch's results to
the plain results of those slices; the last line counts such cases.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import time

import numpy as np
import torch

from .constants import AdaptiveReductionOption, Options, Penalties
from .engine import (BatchAligner, EngineConfig, _pack_all, align_full2,
                     loop_config, score_stride, windows)
from .kernel_engine import H100_SMS, prefix_plan, workspace

# batch sizes on either side of the warp shape's pairs-a-block thresholds
# (kernel_engine.warp_plan: as many pairs a block as each SM gets)
BATCH_SIDES = (H100_SMS, H100_SMS + 1, 2 * H100_SMS, 2 * H100_SMS + 1)
from .oracle import Aligner as OracleAligner

FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")
# x = 1, e = 1 or o = 0: the zero-penalty steps (score_loop.cu next())
DEGENERATE = (Penalties(1, 1, 1), Penalties(2, 0, 2), Penalties(1, 2, 2),
              Penalties(5, 1, 1), Penalties(1, 4, 1), Penalties(4, 6, 1),
              Penalties(2, 1, 1), Penalties(2, 3, 1))


def limit_sides(cfg: EngineConfig, mode) -> tuple:
    """(K, K'): the largest multiple of 128 whose workspace goes to shared
    memory and the next one, whose workspace goes to the scratch (128
    twice when even 128 does not fit)."""
    k = 128
    while workspace(dataclasses.replace(cfg, k_win=k + 128), mode)[1]:
        k += 128
    if not workspace(dataclasses.replace(cfg, k_win=k), mode)[1]:
        return 128, 128
    return k, k + 128


def prefix_sides(cfg: EngineConfig) -> tuple:
    """Full spans on either side of each threshold of K3's workspace by
    span at ``cfg``'s penalties: where its launch plan moves it from
    shared memory to the scratch (int16 cells), and where its cells widen
    to int32 (a target buffer past 4093 columns: spans 3584 and 4096)."""
    k = 128
    while not prefix_plan(dataclasses.replace(cfg, k_win=k + 128), 16, True,
                          H100_SMS).scratch:
        k += 128
    return tuple(sorted({k, k + 128, 3584, 4096}))


def _force_span(rng: random.Random, pairs: list, span: int) -> list:
    """``pairs`` with the first pair's target cut or grown (random bases)
    so that its two lengths sum to span - 1, which makes ``span`` the
    batch's full span (``semi2.prefix_span``) when no other pair is
    longer."""
    q, t = pairs[0]
    need = span - 1 - len(q)
    t = (t + bytes(rng.choice(b"ACGT")
                   for _ in range(max(0, need - len(t)))))[:need]
    return [(q, t)] + pairs[1:]


def _mutate(rng: random.Random, s: bytes, err: float) -> bytes:
    out = bytearray()
    for ch in s:
        r = rng.random()
        if r < err / 3:
            out.append(rng.choice(b"ACGT"))  # substitution
        elif r < 2 * err / 3:
            continue  # deletion
        elif r < err:
            out += bytes([ch, rng.choice(b"ACGT")])  # insertion
        else:
            out.append(ch)
    return bytes(out) or b"A"


def draw_pairs(rng: random.Random, n: int, length: int, err: float,
               raw: bool) -> list:
    pairs = []
    for _ in range(n):
        q = bytes(rng.choice(b"ACGT") for _ in range(
            rng.randint(max(1, length // 2), length)))
        pairs.append((q, _mutate(rng, q, err)))
    q = pairs[0][0]
    pairs[1] = (q, q)  # identical: one extension to the rows' end
    pairs[2] = (q[: len(q) // 2], q)  # a prefix: a long gap at the end
    if raw:
        pairs[3] = (b"NNACGTX" + pairs[3][0], b"NACGTXAC" + pairs[3][1])
    return pairs


def draw_penalties(rng: random.Random) -> tuple:
    """(penalties, whether global, wf-adaptive reduction or None) of one
    case."""
    pen = (rng.choice(DEGENERATE) if rng.random() < 0.4 else
           Penalties(rng.randint(1, 8), rng.randint(0, 8), rng.randint(1, 4)))
    ga = rng.random() < 0.6
    ad = (AdaptiveReductionOption(10, rng.choice((20, 50)), 1)
          if rng.random() < 0.7 else None)
    return pen, ga, ad


def draw_case(rng: random.Random) -> dict:
    pen, ga, ad = draw_penalties(rng)
    length = rng.randint(60, 450)
    pairs = draw_pairs(rng, rng.randint(4, 16), length,
                       rng.choice((0.02, 0.05, 0.1, 0.2)),
                       rng.random() < 0.33)
    # a batch size on a side of a warp-shape threshold, drawn from a
    # generator of its own so that every seed's other cases stay as they
    # were
    sub = random.Random(sum(len(q) + 5 * len(t) for q, t in pairs))
    if sub.random() < 0.25:
        n = sub.choice(BATCH_SIDES)
        pairs = (pairs * -(-n // len(pairs)))[:n]
    longest = max(max(len(q), len(t)) for q, t in pairs)
    spread = max(abs(len(q) - len(t)) for q, t in pairs)
    worst = pen.mismatch * longest + pen.gap_open + pen.gap_ext * (spread + 1)
    s_cap = -(-int(worst * rng.choice((0.3, 0.6, 1.0)) + 8) // 8) * 8
    base = EngineConfig(penalties=pen, global_alignment=ga, adaptive=ad,
                        s_cap=s_cap)
    span = -(-(2 * longest + 2) // 128) * 128
    if ga:
        engine = rng.choice(("auto", "long", "kw"))
        # (the K1-kw of these short reads runs 16-bit cells)
        mode = {"auto": 0, "long": 2, "kw": "kw16"}[engine]
        # the sides of the workspace the loop gets at its stride
        k_win = rng.choice((128,) + limit_sides(
            loop_config(base, score_stride(base)), mode))
        # the windows must hold the terminal diagonal
        while k_win < 2 * spread + 8:
            k_win += 128
        if engine == "kw":
            k_win = max(k_win, 256)
            kw = rng.choice([w for w in (128, 256, 384) if w < k_win
                             and (k_win - w) // 32 <= 31] or [k_win - 128])
            engine = f"auto:kw{kw}"
    elif rng.random() < 0.5:
        engine, k_win = "auto", span  # the full span
    else:
        wm, _ = windows(pen)
        engine = f"semi2:{max(wm, rng.choice((16, 40, 64)))}"
        # K3's full span on a side of one of its plan's thresholds, drawn
        # from a generator of its own so that every seed's other cases
        # stay as they were
        sub = random.Random(sum(len(q) + 3 * len(t) for q, t in pairs))
        if sub.random() < 0.5:
            span = sub.choice(prefix_sides(base))
            pairs = _force_span(sub, pairs, span)
        k_win = min(rng.choice((256,) + limit_sides(base, "resume")), span)
        s_cap = max(s_cap, int(engine.split(":")[1]) + 8)
    return {"penalties": dataclasses.astuple(pen), "global": ga,
            "adaptive": dataclasses.astuple(ad) if ad else None,
            "engine": engine, "k_win": k_win, "s_cap": s_cap,
            "length": length, "pairs": pairs}


# (seed, case, pair index) of the two semi-global pairs on which a walk of
# the ops from (0, 0) missed the oracle's coordinates (DeviceResult)
DRIFT_PAIRS = ((1, 20, 2), (7, 7, 8))


def case_pair(seed: int, case: int, index: int) -> tuple:
    """(case, pair): case ``case`` of seed ``seed`` as :func:`main` draws
    it, and the case's pair ``index``."""
    rng = random.Random(seed)
    for _ in range(case):
        draw_case(rng)
    drawn = draw_case(rng)
    return drawn, drawn["pairs"][index]


def uses_lengths(res, q: bytes, t: bytes) -> bool:
    """Whether the CIGAR of ``res`` uses up both lengths of (q, t).  The
    oracle's semi-global CIGAR misses one on rare pairs (its leading ops
    stop a base off at row or column 1), where only a walk of the ops
    back from the end gives its coordinates."""
    nq = sum(n for op, n in res.ops if op in "MXDH")
    nt = sum(n for op, n in res.ops if op in "MXI")
    return (nq, nt) == (len(q), len(t))


def draw_semi_groups(rng: random.Random, groups: int, size: int) -> list:
    """``groups`` groups of ``size`` semi-global pairs of 30-200 bases at
    2-20% error (:func:`draw_pairs`, no raw bytes), each at penalties and
    a wf-adaptive reduction of its own (:func:`draw_penalties`):
    [(penalties, adaptive or None, pairs)]."""
    out = []
    for _ in range(groups):
        pen, _, ad = draw_penalties(rng)
        out.append((pen, ad, draw_pairs(
            rng, size, rng.randint(60, 200),
            rng.choice((0.02, 0.05, 0.1, 0.2)), False)))
    return out


# a case whose batch the pipeline's memory model puts past this holds its
# tensors and its plain results on slices of its distinct pairs: its plain
# versions on the CPU hold several times the modelled bytes (the plain
# K1-kw on 1024 pairs of l=4000 peaks at 15.8 GiB for a ~3.7 GiB model),
# past a host of 96 GiB
MAX_MODEL_BYTES = 16 << 30


def model_bytes(case: dict) -> int:
    """The device bytes the pipeline's memory model gives a case's batch
    (``pipeline.batch_bytes_per_pair``, ``semi2_bytes_per_pair``)."""
    from .pipeline import batch_bytes_per_pair, semi2_bytes_per_pair
    from .semi2 import prefix_span

    cfg = _aligner(case, "cpu").cfg
    pairs = case["pairs"]
    longest = max(max(len(q), len(t)) for q, t in pairs)
    if case["engine"].startswith("semi2:"):
        qlen = np.array([len(q) for q, _ in pairs])
        tlen = np.array([len(t) for _, t in pairs])
        per_pair = semi2_bytes_per_pair(
            cfg, prefix_span(qlen, tlen), int(case["engine"][6:]),
            int((qlen - 1 + tlen).max()), longest)
    else:
        per_pair = batch_bytes_per_pair(cfg, longest, case["engine"])
    return per_pair * len(pairs)


def row_slices(case: dict) -> list:
    """The case's batch where its model fits ``MAX_MODEL_BYTES``, else its
    distinct pairs in slices whose models each fit it."""
    if model_bytes(case) <= MAX_MODEL_BYTES:
        return [case["pairs"]]
    out = []
    for pair in dict.fromkeys(case["pairs"]):
        if out and model_bytes(dict(case, pairs=out[-1] + [pair])) \
                <= MAX_MODEL_BYTES:
            out[-1].append(pair)
        else:
            out.append([pair])
    return out


def _aligner(case: dict, device: str) -> BatchAligner:
    ad = case["adaptive"]
    return BatchAligner(Penalties(*case["penalties"]),
                        Options(case["global"]),
                        AdaptiveReductionOption(*ad) if ad else None,
                        k_win=case["k_win"], s_cap=case["s_cap"],
                        device=device, engine=case["engine"])


def _result_diff(a, b):
    """The first field (or the CIGAR) where results a and b differ."""
    if a.cigar(False) != b.cigar(False):
        return "cigar"
    for f in FIELDS:
        if getattr(a, f) != getattr(b, f):
            return f
    return None


def _prefix_plans_diff(pairs, cfg: EngineConfig, pkw: dict, ref: dict,
                       device: str) -> list:
    """K3 at every launch plan it takes (each block shape, the workspace
    in the scratch and, where it fits, in shared memory) against the plain
    exports ``ref``: the first plan and tensor that differ, if any."""
    from . import semi2 as ts
    from .engine import inputs_from_packed, semi_cell16
    from .kernel_engine import _prefix_launch, _sms, every_prefix_plan

    packed = _pack_all(pairs, cfg.k_win, global_alignment=False)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = inputs_from_packed(packed, device)
    kcfg, cell16 = pkw["cfg"], semi_cell16(Ltb)
    kw = dict(cfg=kcfg, Lq=Lq, Ltb=Ltb, S0=pkw["S0"], K2=pkw["K2"])
    for plan in every_prefix_plan(kcfg, len(pairs), cell16,
                                  _sms(qb.device)):
        got = ts.canonical_exports(_prefix_launch(
            qb, tbuf, qlen, tlen, toff, **kw, plan=plan))
        for k in ref:
            if not torch.equal(ref[k], got[k].cpu()):
                return [(f"exports[{k}] at plan {tuple(plan)}", None)]
    return []


def _warp_plans_diff(card: BatchAligner, pairs, device: str,
                     ex=None) -> list:
    """K1-kw (``card``'s engine ``"auto:kw"``) or K4 (``"semi2"``, on the
    card's phase-1 exports ``ex``) at every launch plan of the warp shape
    against its plain version on the same inputs: the first plan and
    output that differ, if any."""
    from . import semi2 as ts
    from .engine import (canonical_kw, inputs_from_packed, run_batch_kw_plain,
                         run_batch_resume_plain)
    from .kernel_engine import (_kw_launch, _resume_launch, _sms,
                                every_warp_plan, kw_mode, resume_mode)

    cfg = card.cfg
    packed = _pack_all(pairs, cfg.k_win,
                       global_alignment=cfg.global_alignment)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = inputs_from_packed(packed, device)
    sms = _sms(qb.device)
    if ex is None:
        kw = dict(cfg=cfg, Lq=Lq, Ltb=Ltb)
        ref = canonical_kw(run_batch_kw_plain(qb, tbuf, qlen, tlen, toff,
                                              **kw))
        for plan in every_warp_plan(cfg, kw_mode(Ltb), len(pairs), sms):
            got = canonical_kw(_kw_launch(qb, tbuf, qlen, tlen, toff, **kw,
                                          plan=plan))
            for i, (a, b) in enumerate(zip(ref, got)):
                if not torch.equal(a, b):
                    return [(f"K1-kw output {i} at plan {tuple(plan)}",
                             None)]
        return []
    S0 = card.s_switch
    t2raw, _, toff2, Ltb2 = ts.replace_targets(
        [t for _, t in pairs], ex["meta1"][:, ts.M1_K02].cpu().numpy())
    r_args = (qb, torch.from_numpy(t2raw).to(qb.device), qlen, tlen,
              torch.from_numpy(toff2).to(qb.device),
              *(ex[k] for k in ("win_m", "win_i", "win_d", "ainit", "b_m",
                                "b_ie", "meta1")))
    rkw = dict(cfg=cfg, Lq=Lq, Ltb2=Ltb2, Ltb_full=Ltb, S0=S0)
    ref = ts.canonical_resume(run_batch_resume_plain(*r_args, **rkw), S0)
    for plan in every_warp_plan(cfg, resume_mode(Ltb), len(pairs), sms):
        got = ts.canonical_resume(_resume_launch(*r_args, **rkw, plan=plan),
                                  S0)
        for i, (a, b) in enumerate(zip(ref[:5] + ref[5], got[:5] + got[5])):
            if not torch.equal(a, b):
                return [(f"K4 output {i} at plan {tuple(plan)}", None)]
    return []


def _tensors_diff(pairs, card: BatchAligner, device: str) -> list:
    """Step 1 on one batch: the card's tensors against the plain
    versions', as (what, None)."""
    bad = []
    cfg = card.cfg
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = _pack_all(
        pairs, cfg.k_win, global_alignment=cfg.global_alignment)
    ok2 = tp is not None
    seq = torch.from_numpy(np.concatenate([qp, tp] if ok2 else [qb, tbuf],
                                          axis=1))
    lens = torch.from_numpy(np.stack([qlen, tlen, toff], 1).astype(np.int32))
    if card.engine == "semi2":
        from . import semi2 as ts

        Kf = ts.prefix_span(qlen, tlen)
        pkw = dict(cfg=dataclasses.replace(cfg, k_win=Kf), Lq=Lq, Ltb=Ltb,
                   S0=card.s_switch, K2=cfg.k_win, packed=ok2)
        ref = ts.canonical_exports(ts.prefix_export(seq, lens, **pkw))
        got = ts.canonical_exports(ts.prefix_export(
            seq.to(device), lens.to(device), **pkw))
        bad += [(f"exports[{k}]", None) for k in ref
                if not torch.equal(ref[k], got[k].cpu())][:1]
        if device != "cpu":
            bad += _prefix_plans_diff(pairs, cfg, pkw, ref, device)
            bad += _warp_plans_diff(card, pairs, device, got)
    else:
        kw = dict(cfg=cfg, B=len(pairs), Lq=Lq, Ltb=Ltb, packed=ok2,
                  engine=card.engine)
        ref = align_full2(seq, lens, **kw)
        got = align_full2(seq.to(device), lens.to(device), **kw)
        if sorted(ref) != sorted(got):
            bad.append((f"align_full2 keys {sorted(got)}", None))
        else:
            bad += [(f"align_full2[{k}]", None) for k in ref
                    if not torch.equal(ref[k], got[k].cpu())][:1]
        if device != "cpu" and cfg.aux_kw is not None:
            bad += _warp_plans_diff(card, pairs, device)
    return bad


def check_case(case: dict, device: str) -> tuple:
    """(every mismatch of one case as (what, pair index or None), the
    pairs the card served).  Past ``MAX_MODEL_BYTES`` (:func:`row_slices`)
    the tensors are held on slices of the distinct pairs, and the card's
    results on the whole batch to the plain results of those slices."""
    bad = []
    pairs = case["pairs"]
    card, plain = _aligner(case, device), _aligner(case, "cpu")
    cfg = card.cfg
    slices = row_slices(case)
    # 1. the card's tensors against the plain versions'
    for part in slices:
        bad += _tensors_diff(part, card, device)
    # 2. served sets alike, served results equal the oracle
    res = card.align_batch(pairs, fallback=False)
    by_pair = {}  # a pair's result does not depend on its batch
    for part in slices:
        by_pair.update(zip(part, plain.align_batch(part, fallback=False)))
    res_plain = [by_pair[p] for p in pairs]
    oracle = OracleAligner(cfg.penalties, Options(cfg.global_alignment),
                           cfg.adaptive)
    truth = {}  # the oracle's result by pair (a repeated batch repeats)
    for i, (a, b) in enumerate(zip(res, res_plain)):
        if (a is None) != (b is None):
            bad.append(("served", i))
        elif a is not None:
            what = _result_diff(a, b)
            if what:
                bad.append((f"card vs plain: result.{what}", i))
            else:
                if pairs[i] not in truth:
                    truth[pairs[i]] = oracle.align(*pairs[i])
                what = _result_diff(a, truth[pairs[i]])
                if what:
                    bad.append((f"vs the oracle: result.{what}", i))
    # 3. full token streams give the same results as edit-only ones
    if cfg.global_alignment:
        before = os.environ.get("WFA_EDIT_TOKENS")
        os.environ["WFA_EDIT_TOKENS"] = "0"
        try:
            full = card.align_batch(pairs, fallback=False)
        finally:
            if before is None:
                del os.environ["WFA_EDIT_TOKENS"]
            else:
                os.environ["WFA_EDIT_TOKENS"] = before
        for i, (a, b) in enumerate(zip(res, full)):
            if (a is None) != (b is None):
                bad.append(("WFA_EDIT_TOKENS=0 served", i))
            elif a is not None and _result_diff(a, b):
                bad.append((f"WFA_EDIT_TOKENS=0 {_result_diff(a, b)}", i))
    served = sum(r is not None for r in res)
    return bad, served


def draw_mesh_case(rng: random.Random) -> dict:
    """One round of the mesh stage (tests/fuzz.py:230-260)."""
    pen = (Penalties(4, 6, 2) if rng.random() < 0.4 else
           Penalties(rng.randint(1, 8), rng.randint(0, 12),
                     rng.randint(1, 6)))
    ad = (None if rng.random() < 0.3 else
          AdaptiveReductionOption(rng.randint(1, 20), rng.randint(5, 80), 1))
    ga = rng.random() < 0.7
    shards = rng.choice((2, 4, 8))
    batch = rng.choice((16, 64))
    pairs = draw_pairs(rng, rng.randint(4, 40), 90, rng.choice((0.05, 0.15)),
                       rng.random() < 0.2)
    return {"penalties": dataclasses.astuple(pen), "global": ga,
            "adaptive": dataclasses.astuple(ad) if ad else None,
            "shards": shards, "batch_size": batch, "pairs": pairs}


def check_mesh_case(case: dict, device: str) -> list:
    """Every mismatch of one mesh round as (what, pair index)."""
    from .pipeline import AlignmentPipeline, PipelineConfig

    ad = case["adaptive"]
    args = (Penalties(*case["penalties"]), Options(case["global"]),
            AdaptiveReductionOption(*ad) if ad else None)
    base = dict(batch_size=case["batch_size"], device=device)
    mesh = AlignmentPipeline(PipelineConfig(
        *args, devices=(device,) * case["shards"], **base))
    one = AlignmentPipeline(PipelineConfig(*args, n_devices=1, **base))
    pairs = case["pairs"]
    got, want = mesh.align_all(pairs), one.align_all(pairs)
    mesh.close()
    one.close()
    bad = [("mesh device faults", None)] if mesh._device_errors else []
    oracle = OracleAligner(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        what = _result_diff(a, b)
        if what:
            bad.append((f"mesh vs one device: result.{what}", i))
            continue
        ref = oracle.align(*pairs[i])
        if (a.score, a.cigar(False)) != (ref.score, ref.cigar(False)):
            bad.append(("mesh vs the oracle: score or cigar", i))
    return bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", type=int, default=40)
    ap.add_argument("--start", type=int, default=0,
                    help="first case to run (the ones before it are drawn, "
                    "not run): resumes a seed")
    ap.add_argument("--mesh-cases", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card (or --device cpu)")
    rng = random.Random(args.seed)
    t0 = time.perf_counter()
    n_bad = n_pairs = n_served = 0
    sliced = []
    for c in range(args.cases):
        case = draw_case(rng)
        if c < args.start:
            continue
        desc = {k: v for k, v in case.items() if k != "pairs"}
        if model_bytes(case) > MAX_MODEL_BYTES:
            sliced.append(c)
        bad, served = check_case(case, args.device)
        n_pairs += len(case["pairs"])
        n_served += served
        print(f"case {c}: {json.dumps(desc)} {len(case['pairs'])} pairs, "
              f"{served} served, {len(bad)} mismatches"
              + (", held on slices of its distinct pairs" * (c in sliced)),
              flush=True)
        for what, i in bad:
            n_bad += 1
            print(json.dumps({"seed": args.seed, "case": c, **desc,
                              "diverges": what, "pair_index": i,
                              "pair": (None if i is None else [
                                  x.decode("latin-1")
                                  for x in case["pairs"][i]])}))
    # the mesh stage, from a generator of its own so that every seed's
    # kernel cases stay as they were
    rng = random.Random(f"mesh {args.seed}")
    n_mesh = 0
    for c in range(args.mesh_cases):
        case = draw_mesh_case(rng)
        bad = check_mesh_case(case, args.device)
        n_mesh += len(case["pairs"])
        desc = {k: v for k, v in case.items() if k != "pairs"}
        print(f"mesh case {c}: {json.dumps(desc)} {len(case['pairs'])} "
              f"pairs, {len(bad)} mismatches", flush=True)
        for what, i in bad:
            n_bad += 1
            print(json.dumps({"seed": args.seed, "mesh_case": c, **desc,
                              "diverges": what, "pair_index": i,
                              "pair": (None if i is None else [
                                  x.decode("latin-1")
                                  for x in case["pairs"][i]])}))
    print(f"fuzz seed {args.seed}: cases {args.start}-{args.cases - 1} "
          f"({len(sliced)} held on slices for their size: {sliced}), "
          f"{n_pairs} pairs, "
          f"{n_served} served by the {args.device} kernels; "
          f"{args.mesh_cases} mesh cases, {n_mesh} pairs; {n_bad} "
          f"mismatches in {time.perf_counter() - t0:.1f} s")
    sys.exit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
