"""The port's plot (its copy of :mod:`wfa_tpu.plot`, over its own oracle)
against the reference README's recorded table: the counterparts of
``tests/test_plot.py``'s cases."""

import io

from wfa_tpu_torch import (AdaptiveReductionOption, Options, OracleAligner,
                           Penalties)

from test_plot import GOLDEN_GLOBAL_CELLS


def test_plot_matches_reference_readme_table():
    a = OracleAligner(Penalties(4, 6, 2), Options(True),
                      AdaptiveReductionOption(10, 50, 1))
    q, t = b"ACCATACTCG", b"AGGATGCTCG"
    assert a.align(q, t).score == 12
    lines = a.plot(q, t).splitlines()
    assert len(lines) == 2 + len(q)
    for row, want in zip(lines[2:], GOLDEN_GLOBAL_CELLS):
        cells = [c.strip() for c in row.split("\t")[2:]]
        assert cells == want.split("|"), (cells, want)


def test_plot_not_change_to_match_keeps_origin_tags():
    a = OracleAligner(Penalties(4, 6, 2), Options(True), None)
    q, t = b"ACCATACTCG", b"AGGATGCTCG"
    a.align(q, t)
    assert "⬊ 0" in a.plot(q, t, not_change_to_match=True)


def test_component_print_and_wavefront_str():
    a = OracleAligner(Penalties(4, 6, 2), Options(True), None)
    a.align(b"ACGT", b"AGGT")
    buf = io.StringIO()
    a.M.print(buf, "M")
    text = buf.getvalue()
    assert text.startswith("M0: k[") and "k(0):" in text
    assert str(a.M.wavefronts[0]).startswith("k range: [")
