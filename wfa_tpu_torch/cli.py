"""wfa-tpu — command-line aligner with flag/output parity to the reference,
the port of :mod:`wfa_tpu.cli` (the same flags, and the same standard
output, byte for byte).

    python -m wfa_tpu_torch.cli [options] -i input.txt

Reference CLI: wfa-go/wfa-go.go.  Flags (wfa-go.go:70-78):

    -i <file>   input pair file (WFA-paper format)
    -g          do not use global alignment (semi-global)
    -a          do not use adaptive reduction
    -N          do not output alignment (for benchmark)
    -t          only show the aligned region
    -p / -m     cpu / mem profile
    -h          help

Extras: --batch-size, --no-device (host oracle only), --devices (data
parallelism over the cards), --distributed (over the processes
``torchrun`` starts), --resume, --profile-dir (a ``torch.profiler`` chrome
trace with the program's own spans, ``wfa_tpu_torch.trace``, merged in)
and the port's one flag of its own, --device {cuda,cpu}: the card unless
the caller asks for the CPU (the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Iterable, Tuple

from .cigar import AlignmentResult
from .constants import AdaptiveReductionOption, Options, Penalties
from .io import read_pairs
from .pipeline import AlignmentPipeline, PipelineConfig

USAGE = """\
WFA alignment on an NVIDIA GPU (PyTorch / CUDA)

Input file format:
  Alternating lines; the first character of each line is stripped:
  >ATTGGAAAATAGGATTGG...
  <GATTGGAAAATAGGATGG...

Usage:
  1. Align two sequences from the positional arguments.

        wfa-tpu [options] <query seq> <target seq>

  2. Align sequence pairs from the input file (described above).

        wfa-tpu [options] -i input.txt
"""


def _format_result(
    out, q: bytes, t: bytes, result: AlignmentResult, trim: bool
) -> None:
    """Byte-parity with the reference's output block (wfa-go.go:125-136)."""
    Q, A, T = result.alignment_text(q, t, trim)
    out.write(f"query   {Q.decode('latin-1')}\n")
    out.write(f"        {A.decode('latin-1')}\n")
    out.write(f"target  {T.decode('latin-1')}\n")
    out.write(f"cigar   {result.cigar(trim)}\n")
    out.write("\n")
    out.write(f"align-score : {result.score}\n")
    out.write(
        f"match-region: q[{result.q_begin}, {result.q_end}]/{len(q)}"
        f" vs t[{result.t_begin}, {result.t_end}]/{len(t)}\n"
    )
    pct = (
        result.matches / result.align_len * 100 if result.align_len else float("nan")
    )
    pct_s = "NaN" if pct != pct else f"{pct:.2f}"
    out.write(
        f"align-length: {result.align_len}, matches: {result.matches}"
        f" ({pct_s}%), gaps: {result.gaps}, gap regions: {result.gap_regions}\n"
    )
    out.write("\n")


def _trace_handler(profile_dir: str, timeline):
    """``on_trace_ready``: the profiler's chrome trace written into
    ``profile_dir`` (named as ``tensorboard_trace_handler`` names it) with
    the spans of ``timeline`` merged in, on its clock."""
    import socket

    def handler(prof) -> None:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"{socket.gethostname()}_"
                            f"{os.getpid()}.{time.time_ns() // 10**6}"
                            ".pt.trace.json")
        prof.export_chrome_trace(path)
        n = timeline.merge(path)
        print(f"profile written to {path} with {n} program spans",
              file=sys.stderr)

    return handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="wfa-tpu", usage=USAGE, add_help=False
    )
    ap.add_argument("-h", action="store_true", dest="help")
    ap.add_argument("-i", dest="infile", default="")
    ap.add_argument("-g", action="store_true", dest="no_global")
    ap.add_argument("-a", action="store_true", dest="no_adaptive")
    ap.add_argument("-N", action="store_true", dest="no_output")
    ap.add_argument("-t", action="store_true", dest="trim")
    ap.add_argument("-p", action="store_true", dest="pprof_cpu")
    ap.add_argument("-m", action="store_true", dest="pprof_mem")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--no-device", action="store_true")
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="the card, or the CPU (the kernels' plain versions)")
    ap.add_argument(
        "--devices", type=int, default=0,
        help="data-parallel card count (0 = all; on the CPU, virtual "
             "shards)")
    ap.add_argument(
        "--distributed", action="store_true",
        help="multi-process: torch.distributed over gloo before building "
             "the mesh (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as "
             "torchrun sets them)")
    ap.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler chrome trace here, the program's "
             "spans merged in")
    ap.add_argument(
        "--resume", default="",
        help="progress-state file: skip pairs recorded as completed and "
             "append new progress (checkpoint/resume at block granularity)")
    ap.add_argument("seqs", nargs="*")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = sys.stdout

    if args.help:
        print(USAGE)
        return 0

    adaptive = None if args.no_adaptive else AdaptiveReductionOption(10, 50, 1)
    if args.distributed:
        from .parallel import initialize_distributed

        n_proc = initialize_distributed()
        print(f"distributed: {n_proc} processes", file=sys.stderr)
    cfg = PipelineConfig(
        penalties=Penalties(4, 6, 2),
        options=Options(global_alignment=not args.no_global),
        adaptive=adaptive,
        batch_size=args.batch_size,
        use_device=not args.no_device,
        device=args.device,
        n_devices=args.devices,
    )
    pipe = AlignmentPipeline(cfg)

    profiler = None
    spans = contextlib.ExitStack()
    if args.profile_dir:
        import torch

        from . import trace

        profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA]
               if cfg.use_device and args.device == "cuda" else []),
            on_trace_ready=_trace_handler(
                args.profile_dir, spans.enter_context(trace.timeline())))
        profiler.start()
    elif args.pprof_cpu:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
    elif args.pprof_mem:
        import tracemalloc

        tracemalloc.start()
        profiler = "mem"

    try:
        if not args.infile:
            if len(args.seqs) != 2:
                print(
                    "if flag -i not given, please give me two sequences. "
                    'type "wfa-tpu -h" for help.',
                    file=sys.stderr,
                )
                return 1
            pairs: Iterable[Tuple[bytes, bytes]] = [
                (args.seqs[0].encode(), args.seqs[1].encode())
            ]
            pair_src = pairs
        else:
            if not os.path.exists(args.infile):
                print(f"failed to read file: {args.infile}", file=sys.stderr)
                return 1
            pair_src = read_pairs(args.infile)

        import itertools

        skip = 0
        if args.resume:
            if os.path.exists(args.resume):
                with open(args.resume) as fh:
                    skip = int(fh.read().strip() or 0)
                print(f"resuming after {skip} completed pairs",
                      file=sys.stderr)

        it = iter(pair_src)
        n_done = 0
        t_start = time.perf_counter()
        if skip:
            for _ in itertools.islice(it, skip):
                n_done += 1
        while True:
            block = list(itertools.islice(it, 4096))
            if not block:
                break
            for pair_i, ((q, t), result) in enumerate(
                    zip(block, pipe.align_all(block))):
                if result.error is not None:
                    # the reference CLI exits on any error (wfa-go.go:185-
                    # 190); a batch pipeline reports the pair and continues
                    # (SURVEY §5: a bad pair must not poison the run)
                    print(f"pair {n_done + pair_i + 1}: {result.error}",
                          file=sys.stderr)
                elif not args.no_output:
                    try:
                        _format_result(out, q, t, result, args.trim)
                    except ValueError as exc:
                        # -t on a pair with no aligned (M) region: the
                        # reference PANICS here (trimOps slices
                        # ops[-1:0], wfa_cigar.go:217-233) — report the
                        # pair and continue instead
                        print(f"pair {n_done + pair_i + 1}: {exc}",
                              file=sys.stderr)
            n_done += len(block)
            if args.resume:
                tmp = args.resume + ".tmp"
                with open(tmp, "w") as fh:
                    fh.write(str(n_done))
                os.replace(tmp, args.resume)
        elapsed = time.perf_counter() - t_start
        aligned = n_done - skip
        if aligned and args.infile:
            print(
                f"aligned {aligned} pairs in {elapsed:.2f}s "
                f"({aligned / elapsed:.1f} aln/s)",
                file=sys.stderr,
            )
    finally:
        if args.profile_dir:
            profiler.stop()
            spans.close()
        elif profiler == "mem":
            import tracemalloc

            snap = tracemalloc.take_snapshot()
            with open("mem.pprof.txt", "w") as fh:
                for stat in snap.statistics("lineno")[:50]:
                    fh.write(f"{stat}\n")
            print("heap profile written to mem.pprof.txt", file=sys.stderr)
        elif profiler is not None:
            profiler.disable()
            profiler.dump_stats("cpu.pprof.pstats")
            print("cpu profile written to cpu.pprof.pstats", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
