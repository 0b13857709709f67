"""Debug visualization: render a WFA component as a score/arrow table.

Port of the reference's ``(*Aligner).Plot`` (wfa_component_plot.go:41-209):
the dense lenQ x lenT matrix is reconstructed from a component's
wavefronts (lowest score wins per cell, :97-99), match runs are
back-filled by re-deriving pre-extension offsets with the same
GetAfterDiff recomputation as the backtrace (:110-178), and cells print
as ``<arrow><score>`` in a tab-separated table (:182-208).

Operates on the host oracle aligner's state (the reference's Plot is a
debugging aid over its in-memory components).  The port's own copy of
:mod:`wfa_tpu.plot`, over the port's oracle.
"""

from __future__ import annotations

import io
from typing import Optional

from .constants import (
    ARROWS,
    T_DEL_EXT,
    T_INS_EXT,
    T_MATCH,
    TYPE_BITS,
    TYPE_MASK,
)
from .oracle import Aligner, Component


def plot(
    aligner: Aligner,
    q: bytes,
    t: bytes,
    component: Optional[Component] = None,
    not_change_to_match: bool = False,
    max_score: int = -1,
) -> str:
    """Render ``component`` (default: M) as the reference's plot table.

    Call after ``aligner.align(q, t)`` — the aligner's components hold the
    final wavefront state of that pair.  ``not_change_to_match`` keeps
    extension cells tagged with their origin op instead of match;
    ``max_score`` (if >= 0) stops at that score (wfa_component_plot.go:41,
    75-77).
    """
    M, I, D, p = aligner.M, aligner.I, aligner.D, aligner.p
    if component is None:
        component = M
    len_q, len_t = len(q), len(t)
    is_m = component.is_m

    # dense matrix of score<<3|tag, -1 = unset; lowest score wins because
    # scores are visited in ascending order (wfa_component_plot.go:71-99)
    m = [[-1] * len_t for _ in range(len_q)]

    oe = p.gap_open + p.gap_ext
    e = p.gap_ext
    x = p.mismatch

    for s in sorted(component.wavefronts):
        if 0 <= max_score < s:
            break
        wf = component.wavefronts[s]
        for k in range(wf.lo, wf.hi + 1):
            offset, tag, ok = wf.get(k)
            if not ok:
                continue
            h = offset - 1  # 0-based
            v = h - k
            if v < 0 or h < 0 or v >= len_q or h >= len_t:
                continue
            if m[v][h] >= 0:  # recorded with a lower score
                continue
            m[v][h] = (s << TYPE_BITS) | tag

            if not is_m or q[v] != t[h]:
                continue

            # re-derive the pre-extension offset (wfa_component_plot.go:107-131)
            if tag == T_INS_EXT:
                v1 = M.get_after_diff(s, oe, k - 1)[0]
                v2 = I.get_after_diff(s, e, k - 1)[0]
                offset0 = max(v1, v2) + 1
            elif tag == T_DEL_EXT:
                v1 = M.get_after_diff(s, oe, k + 1)[0]
                v2 = D.get_after_diff(s, e, k + 1)[0]
                offset0 = max(v1, v2)
            else:
                v1 = M.get_after_diff(s, oe, k - 1)[0]
                v2 = I.get_after_diff(s, e, k - 1)[0]
                isk = max(v1, v2) + 1
                v1 = M.get_after_diff(s, oe, k + 1)[0]
                v2 = D.get_after_diff(s, e, k + 1)[0]
                dsk = max(v1, v2)
                v1 = M.get_after_diff(s, x, k)[0]
                offset0 = max(isk, dsk, v1 + 1)
            h00 = offset0 - 1

            if h == h00:  # was not extended at all
                continue

            # back-fill the match run (wfa_component_plot.go:141-178)
            v0, h0 = v, h
            if not not_change_to_match:
                m[v0][h0] = (s << TYPE_BITS) | T_MATCH
            n = 0
            vp, hp = v, h
            while True:
                h -= 1
                v -= 1
                if v < 0 or h < 0:
                    break
                n += 1
                if m[v][h] >= 0:
                    continue
                if not not_change_to_match:
                    m[v][h] = (s << TYPE_BITS) | T_MATCH
                else:
                    m[v][h] = (s << TYPE_BITS) | tag
                vp, hp = v, h
                if q[v] != t[h] or h == h00:
                    break
            if n == 0:  # just itself
                vp, hp = v0, h0
            if not not_change_to_match:
                m[vp][hp] = (s << TYPE_BITS) | tag  # restore the origin op

    # render (wfa_component_plot.go:183-208)
    out = io.StringIO()
    out.write("   \t ")
    for h in range(len_t):
        out.write(f"\t{h + 1:3d}")
    out.write("\n")
    out.write("   \t ")
    for b in t:
        out.write(f"\t{chr(b):>3}")
    out.write("\n")
    for v in range(len_q):
        out.write(f"{v + 1:3d}\t{chr(q[v])}")
        for cell in m[v]:
            if cell < 0:
                out.write("\t  .")
            else:
                out.write(
                    f"\t{ARROWS[cell & TYPE_MASK]}{cell >> TYPE_BITS:2d}")
        out.write("\n")
    return out.getvalue()
