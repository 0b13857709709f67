"""Spans, counters and the device trace of a ``--trace 1`` run.

The harness wraps the program's own entry points from outside, and only
in a traced run: ``BatchAligner.submit_batch`` ("submit") and its
``finish_small`` / ``finish_tokens`` ("finish"), timed in thread time of
the worker that runs them (the outermost call of a thread: a mesh's
shards run inside their batch's); and, inside the profiled slice, each
launch of the port's kernels (``kernel_engine.run_batch``,
``run_batch_long``, ``run_batch_kw``, ``run_prefix``, ``run_resume``,
``device_backtrace.device_backtrace``), whose bytes and operations
:mod:`portbench.roofline` counts.  Launch counts come from the wrappers'
own ``launches`` counters.  The slice runs under ``torch.profiler``; its
chrome trace gives the device's kernels and copies, and the host spans
(timed by ``perf_counter``) are moved onto its clock by the offset of the
calls, which the trace also marks.
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import roofline

SPANS = (("submit_batch", "submit"), ("finish_small", "finish"),
         ("finish_tokens", "finish"))
KERNEL_FNS = (("kernel_engine", "run_batch", "score"),
              ("kernel_engine", "run_batch_long", "score"),
              ("kernel_engine", "run_batch_kw", "score"),
              ("kernel_engine", "run_prefix", "prefix"),
              ("kernel_engine", "run_resume", "resume"),
              ("device_backtrace", "device_backtrace", "backtrace"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Instrument:
    """The wrappers of a traced run, installed on the program's modules
    and classes until :meth:`uninstall`."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.thread_s: Dict[str, float] = defaultdict(float)
        self.local = threading.local()
        self.profiling = False
        # host spans of the profiled slice: (name, start, end), perf_counter
        self.spans: List[Tuple[str, float, float]] = []
        self.launches: List[tuple] = []  # what roofline needs, per launch
        self.missing: List[str] = []  # wrapped names the program lacks
        self._undo: List[Tuple[object, str, object]] = []
        self._counters: List[dict] = []

    def install(self) -> None:
        import importlib

        from wfa_tpu_torch.engine import BatchAligner

        for attr, span in SPANS:
            if hasattr(BatchAligner, attr):
                self._set(BatchAligner, attr, self._span(
                    getattr(BatchAligner, attr), span))
            else:
                self.missing.append(f"BatchAligner.{attr}")
        for mod_name, attr, kind in KERNEL_FNS:
            mod = importlib.import_module(f"wfa_tpu_torch.{mod_name}")
            fn = getattr(mod, attr, None)
            if fn is None or not hasattr(fn, "launches"):
                self.missing.append(f"{mod_name}.{attr}")
                continue
            self._counters.append(fn.launches)
            wrapper = self._kernel(fn, kind)
            wrapper.launches = fn.launches  # the original counts through it
            self._set(mod, attr, wrapper)

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def launch_count(self) -> int:
        return sum(sum(c.values()) for c in self._counters)

    def _set(self, owner, attr, new) -> None:
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def _span(self, orig, span: str):
        inst = self

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            if getattr(inst.local, "busy", False):
                return orig(*args, **kwargs)
            inst.local.busy = True
            t0, w0 = time.thread_time(), time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                dt = time.thread_time() - t0
                inst.local.busy = False
                with inst.lock:
                    inst.thread_s[span] += dt
                if inst.profiling:
                    inst.spans.append((span, w0, time.perf_counter()))

        return wrapper

    def _kernel(self, orig, kind: str):
        inst = self

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            if not inst.profiling:
                return orig(*args, **kwargs)
            if kind == "backtrace":
                want = kwargs.get("return_iters", False)
                out = orig(*args, **dict(kwargs, return_iters=True))
                inst.launches.append(_backtrace_record(args, kwargs, out))
                return out if want else out[:3]
            out = orig(*args, **kwargs)
            inst.launches.append(_RECORDS[kind](args, kwargs, out))
            return out

        return wrapper

    def roofline(self) -> Optional[Tuple[float, int]]:
        """(least seconds, launches) over the profiled slice's launches,
        read once the slice has ended (a record holds its launch's small
        device outputs, so that the slice never waits for them); None
        where a wrapped name was missing."""
        if self.missing or not self.launches:
            return None
        least = 0.0
        for kind, nums, outs in self.launches:
            host = [t.cpu() for t in outs]
            if kind == "backtrace":
                got = roofline.backtrace(*nums, int(host[0].long().sum()))
            elif kind == "prefix":
                final_s, done = host
                got = roofline.prefix(*nums, final_s.tolist(),
                                      (done > 0).tolist())
            else:
                final_s, done, overflow = host
                got = getattr(roofline, kind)(*nums, final_s.tolist(),
                                              (done & ~overflow).tolist())
            least += roofline.least_seconds(*got)
        return least, len(self.launches)


def _score_record(args, kwargs, out):
    qb, tbuf, qlen, tlen, toff = args[:5]
    final_s, done, overflow, _, aux, extra = out
    base = 0 if isinstance(extra, tuple) else 4  # K1-long's, K1-kw's word
    return ("score_loop", (_nbytes(qb, tbuf, qlen, tlen, toff), qb.shape[0],
                           aux.shape[3], aux.element_size(), base),
            (final_s, done, overflow))


def _prefix_record(args, kwargs, ex):
    from wfa_tpu_torch.semi2 import M1_DONE, M1_FS

    exports = [ex[k] for k in ("win_m", "win_i", "win_d", "ainit", "b_m",
                               "b_ie", "meta1")]
    m1, aux = ex["meta1"], ex["aux_old"]
    return ("prefix", (_nbytes(*args[:5]), _nbytes(*exports), aux.shape[3],
                       aux.element_size(), kwargs["S0"]),
            (m1[:, M1_FS], m1[:, M1_DONE]))


def _resume_record(args, kwargs, out):
    final_s, done, overflow, _, aux2, _ = out
    return ("resume", (_nbytes(*args[:12]), args[0].shape[0], aux2.shape[3],
                       aux2.element_size(), kwargs["S0"]),
            (final_s, done, overflow))


def _backtrace_record(args, kwargs, out):
    aux = args[0]
    tok0, buf, tail, iters = out
    step = aux.element_size() + (
        4 if kwargs.get("aux_base") is not None
        or kwargs.get("aux_sbase") is not None else 0)
    return ("backtrace", (tok0.shape[0], _nbytes(tok0, buf, tail), step),
            (iters,))


_RECORDS = {"score": _score_record, "prefix": _prefix_record,
            "resume": _resume_record}


def profile(fn, cuda: bool, spans: List[Tuple[str, float, float]]) -> dict:
    """Run ``fn`` under ``torch.profiler`` and read its chrome trace: the
    device's kernel, copy and set intervals by device (seconds on the
    trace's clock) and by name.  ``spans`` are the host spans ``fn``
    recorded by ``perf_counter`` (its calls' as "call", each annotated for
    the profiler too): the worker threads' spans are not in the trace,
    and all of them are moved onto its clock by the calls' offset."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    dev: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    ops: Dict[str, float] = defaultdict(float)
    kernel_s = 0.0
    marks = []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = float(ev["ts"]) * 1e-6, float(ev["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            device = (ev.get("args") or {}).get("device", ev.get("pid"))
            dev[int(device)].append((s, s + d))
            ops[name] += d
            if cat == "kernel" and roofline.is_kernel(name):
                kernel_s += d
        elif cat == "user_annotation" and name == "call":
            marks.append(s)
    calls = sorted(sp[1] for sp in spans if sp[0] == "call")
    marks.sort()
    shift = (sorted(m - c for m, c in zip(marks, calls))[len(calls) // 2]
             if marks and len(marks) == len(calls) else 0.0)
    host = [(n, a + shift, b + shift) for n, a, b in spans]
    ends = [sp for sp in host if sp[0] == "call"]
    lo = min((a for _, a, _ in ends), default=0.0)
    hi = max((b for _, _, b in ends), default=0.0)
    return {"device": dict(dev), "ops": dict(ops), "kernel_s": kernel_s,
            "spans": host, "window": (lo, hi), "aligned": bool(marks)}


def _union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(tr: dict, devices: int) -> Tuple[float, float]:
    """(device-busy seconds averaged over the ``devices`` cards used, the
    traced window's seconds)."""
    lo, hi = tr["window"]
    per = [sum(e - s for s, e in _union(tr["device"].get(d, []), lo, hi))
           for d in sorted(tr["device"])[:devices]]
    per += [0.0] * (devices - len(per))
    return sum(per) / max(devices, 1), hi - lo


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    gaps (no card busy) split by what the host was doing: inside a
    "submit" or "finish" span (both: "submit_finish"), inside a call but
    neither ("pipeline"), or between calls."""
    lo, hi = tr["window"]
    busy_all = _union([iv for ivs in tr["device"].values() for iv in ivs],
                      lo, hi)
    gaps, t = [], lo
    for s, e in busy_all:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    spans = sorted(tr["spans"], key=lambda sp: sp[1])
    idle: Dict[str, float] = defaultdict(float)
    for gs, ge in gaps:
        inside = [sp for sp in spans if sp[1] < ge and sp[2] > gs]
        pts = sorted({gs, ge, *(min(max(x, gs), ge) for _, a, b in inside
                                for x in (a, b))})
        for a, b in zip(pts, pts[1:]):
            mid = (a + b) / 2
            names = {n for n, s, e in inside if s <= mid < e}
            label = "_".join(sorted(names - {"call"})) or (
                "pipeline" if "call" in names else "between_calls")
            idle[label] += b - a
    rank = sorted(tr["ops"].items(), key=lambda kv: -kv[1])[:top]
    gap_rank = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in rank],
            "idle_gaps": [[n, s] for n, s in gap_rank]}
