"""The yardstick of ``kernels_roofline_pct``: the least time an H100 needs
for each launch of the port's own kernels, from the bytes and operations
the launch's inputs need.

As PERF.md's kernel table ("Bound") counts them: each input byte is read
once and each output byte written once; where the work depends on the
data, only what these inputs need is counted (the aux rows up to the
score a pair stopped at, the cells a backtrace chased); one operation a
score-loop cell or a backtrace step.  Every launch of that table is bound
by bytes.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the dense float32 rate
# outside the tensor cores, the rate the integer ALU work is held to
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# the device functions of the port's CUDA sources (csrc/*.cu) whose
# launches the metric covers: K1, K1-long, K3 (score_loop_kernel), K1-kw,
# K4 (warp_loop_kernel) and K2 (backtrace_kernel)
KERNELS = ("score_loop_kernel", "warp_loop_kernel", "backtrace_kernel")
# bytes of a pair's out row (seven int32 words) and of a backtrace's
# scalar inputs (six int32 words and a bool)
OUT_ROW = 28
BT_SCALARS = 25


def score_loop(in_bytes: int, B: int, K: int, cell: int, base: int,
               final_s: Iterable[int], served: Iterable[bool]
               ) -> Tuple[int, int]:
    """K1, K1-long, K1-kw: the sequence rows and lengths read (``in_bytes``),
    the out rows and the aux rows 0..final_s of each pair served written
    (3 planes of K cells of ``cell`` bytes, plus a ``base`` word a row
    for the rebased aux)."""
    rows = sum(f + 1 for f, ok in zip(final_s, served) if ok)
    cells = 3 * rows * K
    return in_bytes + OUT_ROW * B + cells * cell + rows * base, cells


def prefix(in_bytes: int, export_bytes: int, Kf: int, cell: int, S0: int,
           final_s: Iterable[int], done: Iterable[bool]) -> Tuple[int, int]:
    """K3: the rows read, the exports written, and the full-span aux rows
    up to the score a pair finished at, or all S0 rows."""
    rows = sum(min(f + 1, S0) if d else S0 for f, d in zip(final_s, done))
    cells = 3 * rows * Kf
    return in_bytes + export_bytes + cells * cell, cells


def resume(in_bytes: int, B: int, K: int, cell: int, S0: int,
           final_s: Iterable[int], served: Iterable[bool]) -> Tuple[int, int]:
    """K4: the rows and exports read (``in_bytes``), the out rows and the
    narrow aux rows S0..final_s of each pair served past S0 written."""
    rows = sum(f - S0 + 1 for f, ok in zip(final_s, served)
               if ok and f >= S0)
    cells = 3 * rows * K
    return in_bytes + OUT_ROW * B + cells * cell, cells


def backtrace(B: int, token_bytes: int, step: int, steps: int
              ) -> Tuple[int, int]:
    """K2: the scalar inputs and one aux cell (``step`` bytes, with its
    base or sbase word) a chase step read; every token slot and the
    iteration counts written."""
    return BT_SCALARS * B + steps * step + token_bytes + 4 * B, steps


def least_seconds(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)


def is_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)
