"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``wfa_tpu_torch/csrc`` (nvcc, sm_90a), holds
each kernel against its plain PyTorch version on the card, then drives
the main path — ``AlignmentPipeline.align_all`` on 32768 pairs of
l=1000, e=0.05, global, gap-affine 4/6/2, wf-adaptive 10/50/1 (bench.py's
protocol: one warm call, one timed call) — and checks 512 evenly spaced
results against the exact oracle.  Every comparison is integer and exact:
the tolerance is 0.

Exits nonzero on any failure.  The last two lines are one JSON object
per kernel run and ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N_MAIN = 32768
BATCH = 2048  # the main path's batch: K1 and K2 are checked at its shapes
N_CHECK = 512


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


def kernel_batch(n: int, device):
    """The K1/K2 test batch: main-path shapes of tier 0 at l=1000."""
    from wfa_tpu import AdaptiveReductionOption, Penalties
    from wfa_tpu.datagen import generate_pairs
    from wfa_tpu_torch.engine import EngineConfig, _pack_all, inputs_from_packed

    cfg = EngineConfig(penalties=Penalties(4, 6, 2), global_alignment=True,
                       adaptive=AdaptiveReductionOption(10, 50, 1),
                       k_win=128, s_cap=640)
    pairs = generate_pairs(n, 1000, 0.05, seed=42)
    return cfg, inputs_from_packed(_pack_all(pairs, cfg.k_win), device)


def phase_k1(cfg, ins, reps: int = 10):
    """K1 against run_batch_plain on the card; returns (record, outputs)."""
    import torch
    from wfa_tpu_torch.engine import run_batch_plain
    from wfa_tpu_torch.kernel_engine import run_batch

    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    args = (qb, tbuf, qlen, tlen, toff)
    kw = dict(cfg=cfg, Lq=Lq, Ltb=Ltb)
    ref = run_batch_plain(*args, **kw)
    got = run_batch(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("final_s", "done", "overflow", "term_cell"),
                          ref[:4], got[:4]):
        if not torch.equal(a, b):
            fail(f"K1 {name} differs on {int((a != b).sum())} pairs")
    ok = ref[1] & ~ref[2]
    rows = torch.arange(cfg.s_cap, device=qb.device)[None, :, None, None]
    mask = (rows <= ref[0][None, None, :, None]) & ok[None, None, :, None]
    diff = torch.where(mask, (ref[4] - got[4]).abs(), 0)
    err = int(diff.max())
    if err:
        fail(f"K1 aux differs in {int((diff != 0).sum())} cells")
    plain_ms = cuda_ms(lambda: run_batch_plain(*args, **kw), 1)
    ms = cuda_ms(lambda: run_batch(*args, **kw), reps)
    n = qb.shape[0]
    print(f"K1 score_loop == run_batch_plain: {n} pairs, {int(ok.sum())} "
          f"done, max_abs_err {err} (tolerance 0); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms")
    rec = {"name": "score_loop", "route": "cuda",
           "source": "wfa_tpu_torch/csrc/score_loop.cu",
           "replaces": "wfa_tpu/pallas_engine.py:95",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return rec, got


def phase_k2(cfg, ins, k1_out, reps: int = 10):
    """K2 against device_backtrace_plain on K1's aux."""
    import torch
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain)
    from wfa_tpu_torch.engine import _token_plan

    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    final_s, done, overflow, term_cell, aux = k1_out
    shift, _ = _token_plan(cfg.s_cap, cfg.penalties, Lq, Ltb)
    args = (aux, term_cell, -toff, final_s, tlen - qlen, qlen, tlen,
            done & ~overflow)
    kw = dict(penalties=cfg.penalties, S=cfg.s_cap, K=cfg.k_win,
              token_shift=shift, split_ext_codes=True)
    ref = device_backtrace_plain(*args, **kw)
    got = device_backtrace(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(("tok0", "buf", "tail"), ref, got):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"K2 {name}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        d = int((a.int() - b.int()).abs().max())
        if d:
            fail(f"K2 {name} differs in {int((a != b).sum())} slots")
        err = max(err, d)
    plain_ms = cuda_ms(lambda: device_backtrace_plain(*args, **kw), 1)
    ms = cuda_ms(lambda: device_backtrace(*args, **kw), reps)
    print(f"K2 backtrace == device_backtrace_plain: max_abs_err {err} "
          f"(tolerance 0); kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    return {"name": "backtrace", "route": "cuda",
            "source": "wfa_tpu_torch/csrc/backtrace.cu",
            "replaces": "wfa_tpu/device_backtrace.py:276",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_main(n: int, n_check: int, card: str):
    """The main path; returns the launch counts of the timed call."""
    import torch
    from wfa_tpu import AdaptiveReductionOption, OracleAligner, Options, Penalties
    from wfa_tpu.datagen import generate_pairs
    from wfa_tpu_torch.device_backtrace import device_backtrace
    from wfa_tpu_torch.kernel_engine import run_batch
    from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

    pen, opts = Penalties(4, 6, 2), Options(True)
    ad = AdaptiveReductionOption(10, 50, 1)
    pipe = AlignmentPipeline(PipelineConfig(pen, opts, ad, batch_size=BATCH,
                                            device="cuda"))
    t0 = time.perf_counter()
    pairs = generate_pairs(n, 1000, 0.05, seed=42)
    print(f"main: {n} pairs generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe.align_all(pairs)  # warm
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    run_batch.launches = 0
    device_backtrace.launches = 0
    t0 = time.perf_counter()
    results = pipe.align_all(pairs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"score_loop": run_batch.launches,
                "backtrace": device_backtrace.launches}
    print(f"main: align_all {n} pairs in {secs:.3f} s = {n / secs:.1f} aln/s "
          f"(warm call {warm:.3f} s) on {card}")
    print(f"main: launches {launches}; pairs served per tier {pipe.served}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path launched {name} no time")
    if len(results) != n or any(r is None or r.error for r in results):
        fail("main path returned missing or failed results")
    oracle = OracleAligner(pen, opts, ad)
    fields = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
              "matches", "gaps", "gap_regions")
    t0 = time.perf_counter()
    for i in range(0, n, max(1, n // n_check))[:n_check]:
        r, o = results[i], oracle.align(*pairs[i])
        if r.cigar(False) != o.cigar(False) or any(
                getattr(r, f) != getattr(o, f) for f in fields):
            fail(f"pair {i} differs from the oracle")
    print(f"main: {min(n_check, n)} sampled results equal the oracle "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches


def jax_modules() -> set:
    """Loaded modules of JAX and of the JAX-bound layers of wfa_tpu."""
    shared = {"constants", "oracle", "cigar", "backtrace", "io", "datagen",
              "native"}
    return {m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
            or (m.startswith("wfa_tpu.") and m.split(".")[1] not in shared)}


def main() -> None:
    preloaded = jax_modules()
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

    phase_build()
    cfg, ins = kernel_batch(BATCH, "cuda")
    rec1, k1_out = phase_k1(cfg, ins)
    rec2 = phase_k2(cfg, ins, k1_out)
    del k1_out, ins
    launches = phase_main(N_MAIN, N_CHECK, card)
    rec1["launches"] = launches["score_loop"]
    rec2["launches"] = launches["backtrace"]
    imported = sorted(jax_modules() - preloaded)
    if imported:
        fail(f"the run imported JAX-bound modules: {imported[:5]}")
    print(json.dumps({"kernels": [rec1, rec2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
