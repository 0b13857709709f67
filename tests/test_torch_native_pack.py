"""The port's native direct pack (``wfa_tpu_torch/csrc/pack.c``) against
the JAX package's (``wfa_tpu.native.pack_direct``), byte for byte: the
body this host runs (the vector one where the CPU has it) and the
portable scalar one, at lengths on both sides of the vector step, at
every offset modulo 4, negative offsets and rows cut at ``L``; the same
verdict (None) for every byte outside ACGT planted in a row's head, its
vector body, its 4-base body and its tail; the query and target halves
packed into one matrix, which ``_seq_lens`` hands on as it is; the
counters of the bases packed and the benchmark's reader of them."""

import numpy as np
import pytest

from wfa_tpu import native as jn
from wfa_tpu_torch import engine as te
from wfa_tpu_torch import native, trace

LENGTHS = [1, 3, 4, 31, 32, 33, 63, 64, 65, 1000, 50000]
BAD = sorted(set(range(256)) - set(b"ACGT"))


@pytest.fixture
def lib():
    if native.load() is None or jn.lib is None:
        pytest.skip("needs a C compiler for the native packers")
    return native.lib


def _acgt(rng, n):
    return bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)])


def _packs(lib, seqs, offs, L):
    """The JAX package's, this host's and the scalar direct pack."""
    lens = np.array([len(s) for s in seqs], np.int32)
    scalar = native._pack(lib.wfa_pack_direct_scalar, seqs, lens, offs, L)
    return (jn.pack_direct(seqs, lens, offs, L),
            native.pack_direct(seqs, lens, offs, L),
            None if scalar is None else scalar[0])


@pytest.mark.parametrize("placed", [False, True], ids=["at0", "placed"])
@pytest.mark.parametrize("length", LENGTHS)
def test_direct_pack_matches_jax_byte_for_byte(lib, length, placed):
    rng = np.random.default_rng(length)
    L = -(-length // 4) * 4 + 8
    if placed:
        # off % 4 in 0-3 (also past the first output byte), negative
        # offsets (the row's first bases skipped), rows cut at L, and one
        # that starts past it
        offs = np.array([0, 1, 2, 3, 5, 6, 7, 8, -1, -2, -3, -5,
                         L - length + 1, L - length + 6, L - 2, L + 3],
                        np.int32)
    else:
        offs = None
    seqs = [_acgt(rng, length) for _ in range(16)]
    want, got, scalar = _packs(lib, seqs, offs, L)
    assert want is not None and want.shape == (16, L // 4)
    assert np.array_equal(got, want)
    assert np.array_equal(scalar, want)


# (offset, length, position of the planted byte): off 1 leaves a head of
# 3 bases (0-2), a 64-base vector body (3-66), 8 bases for the 4-base
# loop (67-74) and a tail of 2 (75-76)
PLACES = {"head": 1, "vector_body": 43, "body4": 70, "tail": 76}


@pytest.mark.parametrize("place", list(PLACES))
def test_every_bad_byte_gives_the_same_verdict(lib, place):
    rng = np.random.default_rng(7)
    offs = np.array([1, 1, 1], np.int32)
    L = 96
    seqs = [_acgt(rng, 77) for _ in range(3)]
    want, got, scalar = _packs(lib, seqs, offs, L)
    assert want is not None
    assert np.array_equal(got, want) and np.array_equal(scalar, want)
    for byte in BAD:
        row = bytearray(seqs[1])
        row[PLACES[place]] = byte
        want, got, scalar = _packs(lib, [seqs[0], bytes(row), seqs[2]],
                                   offs, L)
        assert want is None, byte
        assert got is None and scalar is None, byte
        # a bad byte the row's placement cuts off is never read
        cut = _packs(lib, [seqs[0], bytes(row), seqs[2]],
                     np.array([1, L - PLACES[place], 1], np.int32), L)
        assert all(p is not None for p in cut), byte
        assert np.array_equal(cut[1], cut[0])


def test_the_halves_are_one_matrix_as_seq_lens_hands_it_on(lib):
    from wfa_tpu import AdaptiveReductionOption, Options, Penalties
    from wfa_tpu.engine import BatchAligner

    rng = np.random.default_rng(3)
    pairs = [(_acgt(rng, int(rng.integers(90, 400))),
              _acgt(rng, int(rng.integers(90, 400)))) for _ in range(24)]
    jb = BatchAligner(Penalties(4, 6, 2), Options(True),
                      AdaptiveReductionOption(10, 50, 1), k_win=128,
                      s_cap=640, engine="jax")
    _, _, _, _, _, _, _, jqp, jtp = jb._pack_all(pairs)
    direct = te._pack_all(pairs, 128, need_raw=False)
    qp, tp = direct[7], direct[8]
    assert np.array_equal(qp, jqp) and np.array_equal(tp, jtp)
    seq, lens, packed, Lq, Ltb = te._seq_lens(direct)
    assert packed and seq.shape == (24, (Lq + Ltb) // 4)
    assert np.array_equal(seq, np.concatenate([jqp, jtp], axis=1))
    # no copy: the halves are views of the matrix handed on
    assert seq.flags.c_contiguous
    assert np.shares_memory(seq, qp) and np.shares_memory(seq, tp)
    # halves not of one matrix are joined by a copy, as before
    seq2 = te._seq_lens(direct[:7] + (qp.copy(), tp.copy()))[0]
    assert np.array_equal(seq2, seq) and not np.shares_memory(seq2, qp)
    # the raw route is as it was
    raw = te._seq_lens(te._pack_all(pairs, 128))[0]
    assert np.array_equal(raw, seq)


def test_pack_direct_refuses_an_out_it_cannot_fill(lib):
    seqs = [b"ACGT" * 8] * 2
    lens = np.array([32, 32], np.int32)
    wide = np.full((2, 20), 7, np.uint8)
    assert native.pack_direct(seqs, lens, None, 32,
                              out=wide[:, 4:12]).base is wide
    assert np.array_equal(wide[:, 4:12], native.pack_direct(seqs, lens,
                                                            None, 32))
    assert (wide[:, :4] == 7).all() and (wide[:, 12:] == 7).all()
    for bad in (np.zeros((2, 9), np.uint8), np.zeros((2, 8), np.int32),
                np.zeros((8, 2), np.uint8).T):
        with pytest.raises(ValueError):
            native.pack_direct(seqs, lens, None, 32, out=bad)


def test_the_counters_count_the_bases_packed(lib):
    seqs = [b"ACGT" * 30, b"GATTACA" * 9, b"T"]
    lens = np.array([len(s) for s in seqs], np.int32)
    offs = np.array([0, -3, 200], np.int32)  # 63 - 3 bases; one cut off
    with trace.call(3, {}) as rec:
        native.pack_direct(seqs, lens, offs, 128)
        native.pack_direct([b"ACGN"], np.array([4], np.int32), None,
                           128)  # the raw route: not counted
    bases = rec.counters[trace.PACKED_BASES]
    assert bases == 120 + 60
    assert rec.counters[trace.PACKED_VEC_BASES] == (
        bases if lib.wfa_pack_vector() else 0)


def test_the_reader_of_pack_vector_pct(lib, monkeypatch):
    from portbench import manifest

    read = manifest.reader("pack_vector_pct")
    ctx = {"calls_s": [0.1, 0.1], "pairs": 6}
    recs = [{"pairs": 3, "packed_bases": 100, "packed_vec_bases": 100},
            {"pairs": 3, "packed_bases": 300, "packed_vec_bases": 0}]
    monkeypatch.setattr(trace, "records", lambda n: recs)
    assert read(ctx) == 25.0
    # a program without the counters, or that packed nothing directly
    monkeypatch.setattr(trace, "records", lambda n: [
        {"pairs": 3}, {"pairs": 3}])
    assert read(ctx) is None
    monkeypatch.setattr(trace, "records", lambda n: [
        dict(r, packed_bases=0, packed_vec_bases=0) for r in recs])
    assert read(ctx) is None
