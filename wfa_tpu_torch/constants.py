"""Constants of the port (the same values as :mod:`wfa_tpu.constants`,
kept here so the port imports nothing of the JAX package).

The 3-bit backtrace-tag encoding is kept bit-identical to the reference
implementation (reference: wfa_backtrace_types.go:24-39) so that packed
offset words round-trip exactly and CIGAR backtraces replay identically:

    cell = offset << 3 | tag        (0 == absent, wfa_wavefront.go:44)

Tags (wfa_backtrace_types.go:27-35)::

    1 insert-open   2 insert-ext
    3 delete-open   4 delete-ext
    5 mismatch      6 match (only used for first-row/column seeds)
"""

from __future__ import annotations

import dataclasses

TYPE_BITS = 3
TYPE_MASK = (1 << TYPE_BITS) - 1

T_INS_OPEN = 1
T_INS_EXT = 2
T_DEL_OPEN = 3
T_DEL_EXT = 4
T_MISMATCH = 5
T_MATCH = 6

# tag -> CIGAR op byte (index 0 and 7 are padding; wfa_backtrace_types.go:37).
# NOTE the package's own convention (inverted vs SAM): 'I' consumes the
# *target*, 'D'/'H' consume the *query* (wfa_cigar.go:286-330).
OPS = (".", "I", "I", "D", "D", "X", "M", "H")

# tag -> arrow rune for component plots (wfa_backtrace_types.go:39).
ARROWS = ("⊕", "⟼", "\U0001f826", "↧", "\U0001f827", "⬂", "⬊")

TYPE_STR = ("N/A", "I.O", "I.E", "D.O", "D.E", "Mis", "Mat")

# Longest supported sequence (3 tag bits leave 29 offset bits; wfa.go:190).
MAX_SEQ_LEN = (1 << (32 - TYPE_BITS)) - 1


@dataclasses.dataclass(frozen=True)
class Penalties:
    """Gap-affine penalties; match costs 0 (wfa.go:32-36)."""

    mismatch: int = 4
    gap_open: int = 6
    gap_ext: int = 2


@dataclasses.dataclass(frozen=True)
class Options:
    """Alignment options (wfa.go:64-66)."""

    global_alignment: bool = True


@dataclasses.dataclass(frozen=True)
class AdaptiveReductionOption:
    """wf-adaptive heuristic parameters (wfa.go:46-60).

    ``cutoff_step`` is carried for API parity but unused, like the
    reference (wfa.go:49).
    """

    min_wf_len: int = 10
    max_dist_diff: int = 50
    cutoff_step: int = 1


DEFAULT_PENALTIES = Penalties()
DEFAULT_OPTIONS = Options()
DEFAULT_ADAPTIVE = AdaptiveReductionOption()


class EmptySeqError(ValueError):
    """Query or target sequence is empty (wfa.go:187)."""


class SeqTooLongError(ValueError):
    """Sequence longer than MAX_SEQ_LEN (wfa.go:193)."""


def type2str(tag: int) -> str:
    if 0 <= tag < len(TYPE_STR):
        return TYPE_STR[tag]
    return "N/A"
