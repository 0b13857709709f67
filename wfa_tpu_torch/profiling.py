"""Profile timed ``align_all`` calls of the port on the card.

    python -m wfa_tpu_torch.profiling [--length 50000] [--pairs 64]
                                      [--calls 3] [--semi]

Generates ``generate_pairs(pairs, length, 0.05, seed=42)`` (bench.py's
data), runs one warm call of ``AlignmentPipeline.align_all`` (global, or
semi-global with ``--semi``; gap-affine 4/6/2, wf-adaptive 10/50/1,
device "cuda"), then times ``--calls`` calls
(host clock, each ending in a synchronise) and traces the last one with
``torch.profiler``: the card's name and power limit, wall time, aln/s, the
device's busy share (the union of its kernel and copy intervals over the
wall time) and the device time per kernel name.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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
