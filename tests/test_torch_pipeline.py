"""The port's entry point vs the exact oracle, on the CPU.

``wfa_tpu_torch.pipeline.AlignmentPipeline(device="cpu").align_all``
must equal ``wfa_tpu.oracle`` on score, CIGAR, q/t begin/end, align_len,
matches, gaps and gap_regions, whichever tier served the pair, in global
and semi-global mode."""

import inspect
import random

import pytest
import torch

from wfa_tpu import AdaptiveReductionOption, Options, OracleAligner, Penalties
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.io import read_pairs
from wfa_tpu_torch import EmptySeqError  # the port raises its own
from wfa_tpu_torch.engine import BatchAligner, DeviceResult
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

from test_pallas_engine import random_pairs

torch.set_num_threads(2)

ADAPTIVE = AdaptiveReductionOption(10, 50, 1)
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")
GOLDEN = [  # (query, target, score, cigar) with 4/6/2 and 10/50/1
    (b"AGCTAGTGTCAATGGCTACTTTTCAGGTCCT",
     b"AACTAAGTGTCGGTGGCTACTATATATCAGGTCCT", 36, "1M1X3M1I5M2X8M3I1M1X9M"),
]
SEMI_GOLDEN = [  # semi-global, 4/6/2 and 10/50/1 (README, BASELINE.md)
    (b"ACGATCTCG", b"CAGGCTCCTCGG", 16, "1I1M1X1M1X2M1I3M1I"),
    (b"Bioinformatics helps Biology",
     b"We learn bioinformatics to help biologists", 32,
     "9I1X14M3I4M1D1M1X5M1X3I"),
]


def _assert_oracle(pairs, results, penalties, adaptive, ga=True):
    oracle = OracleAligner(penalties, Options(ga), adaptive)
    assert len(results) == len(pairs)
    for (q, t), res in zip(pairs, results):
        ref = oracle.align(q, t)
        assert res.cigar(False) == ref.cigar(False), (q, t)
        for f in FIELDS:
            assert getattr(res, f) == getattr(ref, f), (f, q, t)


@pytest.mark.parametrize("penalties,adaptive,ga", [
    (Penalties(4, 6, 2), ADAPTIVE, True),
    (Penalties(4, 6, 2), None, True),
    (Penalties(2, 3, 1), ADAPTIVE, True),
    (Penalties(4, 6, 2), ADAPTIVE, False),
    (Penalties(4, 6, 2), None, False),
    (Penalties(2, 3, 1), ADAPTIVE, False),
], ids=["adaptive", "plain", "degenerate", "semi_adaptive", "semi_plain",
        "semi_degenerate"])
def test_pipeline_matches_oracle(penalties, adaptive, ga):
    pairs = random_pairs(random.Random(17), 24, 80)
    pairs += list(read_pairs("tests/data/seqs.txt"))[:3]
    pairs += [(q, t) for q, t, _, _ in GOLDEN + SEMI_GOLDEN]
    pipe = AlignmentPipeline(PipelineConfig(penalties, Options(ga),
                                            adaptive, batch_size=16,
                                            device="cpu"))
    _assert_oracle(pairs, pipe.align_all(pairs), penalties, adaptive, ga)
    # a second call runs at the score caps the first one learned
    _assert_oracle(pairs, pipe.align_all(pairs), penalties, adaptive, ga)


def test_pipeline_golden_values():
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2), Options(True),
                                            ADAPTIVE, device="cpu"))
    seqs = list(read_pairs("tests/data/seqs.txt"))[0]
    res = pipe.align_all([(q, t) for q, t, _, _ in GOLDEN] + [seqs])
    for r, (_, _, score, cigar) in zip(res, GOLDEN):
        assert (r.score, r.cigar(False)) == (score, cigar)
    assert (res[-1].score, res[-1].cigar(False)) == (
        36, "1X1I14M1D39M1D31M1D12M")
    assert (res[-1].q_begin, res[-1].q_end, res[-1].t_begin,
            res[-1].t_end) == (2, 100, 3, 98)


def test_pipeline_semi_golden_values():
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2),
                                            Options(False), ADAPTIVE,
                                            device="cpu"))
    res = pipe.align_all([(q, t) for q, t, _, _ in SEMI_GOLDEN])
    for r, (_, _, score, cigar) in zip(res, SEMI_GOLDEN):
        assert isinstance(r, DeviceResult)
        assert (r.score, r.cigar(False)) == (score, cigar)
    assert pipe.served[0] == len(SEMI_GOLDEN)


def test_pipeline_full_token_stream(monkeypatch):
    """Under WFA_EDIT_TOKENS=0 a global batch ships full token streams
    (match runs included), as the JAX package does, and decodes to the
    same results."""
    monkeypatch.setenv("WFA_EDIT_TOKENS", "0")
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(8, 120, 0.05, seed=6)
    pairs += [(q, t) for q, t, _, _ in GOLDEN]
    eng = BatchAligner(p, Options(True), ADAPTIVE, k_win=128, s_cap=256,
                       device="cpu")
    res = eng.align_batch(pairs)
    assert all(not isinstance(r._raw_tokens, tuple) for r in res)
    _assert_oracle(pairs, res, p, ADAPTIVE)


def test_token_format_fixed_at_submit(monkeypatch):
    """The pipeline submits one batch ahead; the stream format chosen at
    submit holds when the batch is finished, whatever the environment
    says by then."""
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(4, 120, 0.05, seed=8)
    eng = BatchAligner(p, Options(True), ADAPTIVE, k_win=128, s_cap=256,
                       device="cpu")
    monkeypatch.setenv("WFA_EDIT_TOKENS", "0")
    full = eng.submit_batch(pairs)
    monkeypatch.delenv("WFA_EDIT_TOKENS")
    edit = eng.submit_batch(pairs)
    monkeypatch.setenv("WFA_EDIT_TOKENS", "0")
    for handle, is_edit in ((full, False), (edit, True)):
        res = eng.finish_batch(handle)
        assert all(isinstance(r._raw_tokens, tuple) == is_edit for r in res)
        _assert_oracle(pairs, res, p, ADAPTIVE)


def test_semi_score_memory_holds_the_global_end():
    """A short read inside a longer target has a small semi-global score,
    but K1 runs it to its global end, which costs more.  The score memory
    learns that cost, so the second call serves every pair at tier 0 too:
    a cap fitted to the semi-global scores (24 at most here, a cap of
    128) would send the first pair (global end 210) to tier 1."""
    p = Penalties(4, 6, 2)
    pairs = []
    for seed, off in ((21, 60), (22, 100), (23, 140)):
        read, target = generate_pairs(1, 300, 0.02, seed=seed)[0]
        pairs.append((read[off:off + 150], target))
    pipe = AlignmentPipeline(PipelineConfig(p, Options(False), ADAPTIVE,
                                            s_cap_base=64, device="cpu"))
    first = pipe.align_all(pairs)
    _assert_oracle(pairs, first, p, ADAPTIVE, ga=False)
    assert pipe.served[0] == len(pairs), pipe.served
    assert max(r.final_s for r in first) > 128 > 1.2 * max(
        r.score for r in first) + 16
    _assert_oracle(pairs, pipe.align_all(pairs), p, ADAPTIVE, ga=False)
    assert pipe.served[0] == len(pairs), pipe.served


def test_pipeline_tier_retry_and_oracle_tier():
    """A band that leaves the tier-0 window retries at tier 1; a memory
    budget that caps every tier's score below the pairs' scores sends
    them to the final oracle tier."""
    p = Penalties(4, 6, 2)
    q = generate_pairs(1, 300, 0.0, seed=3)[0][0]
    pairs = [(q, q[:150]), (q[:140], q)] + generate_pairs(6, 120, 0.05, seed=4)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=4, device="cpu"))
    _assert_oracle(pairs, pipe.align_all(pairs), p, ADAPTIVE)
    assert pipe.served[1] >= 2 and pipe.served["oracle"] == 0

    noisy = generate_pairs(5, 200, 0.3, seed=5)
    small = AlignmentPipeline(PipelineConfig(
        p, Options(True), ADAPTIVE, batch_size=4, mem_budget=12 * 128 * 64,
        device="cpu"))
    _assert_oracle(noisy, small.align_all(noisy), p, ADAPTIVE)
    assert small.served["oracle"] == len(noisy)


def test_guards_and_unported_modes():
    p = Penalties(4, 6, 2)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            device="cpu"))
    res = pipe.align_all([(b"", b"ACGT"), (b"ACGT", b"ACGA")])
    assert isinstance(res[0].error, EmptySeqError)
    assert res[1].error is None and res[1].score == 4
    with pytest.raises(EmptySeqError):
        BatchAligner(p, Options(True), ADAPTIVE, device="cpu").align_batch(
            [(b"A", b"")])
    with pytest.raises(ValueError):
        BatchAligner(p, Options(True), AdaptiveReductionOption(0, 50, 1),
                     device="cpu")
    # semi-global is ported: the pipeline and the aligner take it
    semi = AlignmentPipeline(PipelineConfig(p, Options(False), ADAPTIVE,
                                            device="cpu"))
    res = semi.align_all([(b"", b"ACGT"), (b"ACGT", b"TTACGTTT")])
    assert isinstance(res[0].error, EmptySeqError)
    assert res[1].error is None and res[1].cigar(False) == "2I4M2I"
    assert BatchAligner(p, Options(False), ADAPTIVE, device="cpu").align_batch(
        [(b"ACGT", b"ACGA")])[0].score == res[1].score + 4
    # reads over 4096 bases align: global ones on the long-read engine,
    # semi-global ones on the two-phase route
    long = [(b"A" * 4097, b"A" * 4097), (b"AC" * 2100, b"AG" + b"AC" * 2099)]
    _assert_oracle(long, pipe.align_all(long), p, ADAPTIVE)
    assert {e for _, _, e in pipe._engines} == {"auto", "long"}
    _assert_oracle(long[:1], semi.align_all(long[:1]), p, ADAPTIVE, ga=False)
    assert semi.served[0] == 1
    assert {e for _, _, e in semi._engines} == {"auto", "semi2:64"}


def test_default_device_is_the_card():
    """Both entry points run on the card unless the caller asks for the
    CPU; with no card the default raises instead of running on the CPU."""
    assert PipelineConfig().device == "cuda"
    assert inspect.signature(BatchAligner).parameters["device"].default == (
        "cuda")
    if torch.cuda.is_available():
        assert BatchAligner().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchAligner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AlignmentPipeline(PipelineConfig()).align_all([(b"ACGT", b"ACGA")])


def _faulty_submit(monkeypatch, errors):
    """Make ``BatchAligner.submit_batch`` raise the exceptions of
    ``errors`` on its first calls, then submit as before; returns the list
    of calls it saw."""
    orig = BatchAligner.submit_batch
    calls = []

    def submit(eng, pairs):
        calls.append(len(pairs))
        if len(calls) <= len(errors):
            raise errors[len(calls) - 1]
        return orig(eng, pairs)

    monkeypatch.setattr(BatchAligner, "submit_batch", submit)
    return calls


@pytest.mark.parametrize("faults,served_by", [
    (1, "device"), (2, "oracle")], ids=["one_fault", "two_faults"])
def test_device_fault_retries_then_falls_to_the_oracle(monkeypatch, capsys,
                                                       faults, served_by):
    """A RuntimeError from submit_batch (a device fault: an out-of-memory
    error, an illegal address) re-queues its chunk; one fault is served by
    the device retry on the next tier, two send the rest of the call to
    the oracle, as wfa_tpu.pipeline.align_all does.  The fault budget is
    per call."""
    pairs = random_pairs(random.Random(5), 12, 60)
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2), Options(True),
                                            ADAPTIVE, batch_size=8,
                                            device="cpu"))
    calls = _faulty_submit(monkeypatch, [RuntimeError("CUDA error: an "
                                                      "illegal memory access")]
                           * faults)
    res = pipe.align_all(pairs)
    _assert_oracle(pairs, res, Penalties(4, 6, 2), ADAPTIVE)
    err = capsys.readouterr().err
    assert err.count("device error") == faults
    if served_by == "device":
        # chunk 0 faulted at tier 0 and was served at tier 1; chunk 1 at 0
        assert "retrying" in err
        assert pipe.served[0] == 4 and pipe.served[1] == 8
        assert pipe.served["oracle"] == 0
    else:
        assert "falling back to host oracle" in err
        assert pipe.served["oracle"] == len(pairs)
        assert len(calls) == 2
    # a new call starts with a clean budget
    res = pipe.align_all(pairs)
    assert pipe.served["oracle"] == 0
    _assert_oracle(pairs, res, Penalties(4, 6, 2), ADAPTIVE)


def test_host_errors_are_not_device_faults(monkeypatch):
    """A ValueError (or TypeError) is a bug on the host: it propagates."""
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2), Options(True),
                                            ADAPTIVE, device="cpu"))
    _faulty_submit(monkeypatch, [ValueError("bad shape")])
    with pytest.raises(ValueError, match="bad shape"):
        pipe.align_all(random_pairs(random.Random(6), 4, 40))


def test_finish_fault_retries_the_chunk(monkeypatch):
    """A RuntimeError from finish_batch re-queues that chunk too."""
    orig = BatchAligner.finish_batch
    seen = []

    def finish(eng, handle, fallback=True):
        seen.append(1)
        if len(seen) == 1:
            raise RuntimeError("CUDA error: an illegal memory access")
        return orig(eng, handle, fallback=fallback)

    monkeypatch.setattr(BatchAligner, "finish_batch", finish)
    pairs = random_pairs(random.Random(7), 6, 50)
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2), Options(True),
                                            ADAPTIVE, device="cpu"))
    _assert_oracle(pairs, pipe.align_all(pairs), Penalties(4, 6, 2),
                   ADAPTIVE)
    assert pipe.served[1] == len(pairs) and pipe.served["oracle"] == 0


class _RefusingLibrary:
    """A kernel library whose every entry returns one CUDA error code."""

    def __init__(self, code):
        self.code = code

    def __getattr__(self, name):
        return lambda *args: self.code


@pytest.mark.parametrize("cause", ["build", "refused_launch"])
def test_kernel_errors_are_not_device_faults(monkeypatch, tmp_path, capsys,
                                             cause):
    """A kernel that does not build (here a source nvcc cannot compile, or
    no nvcc at all) or a launch the kernel refuses raises KernelError out
    of align_all: no retry, nothing served by the oracle."""
    from wfa_tpu_torch import _build

    if cause == "build":
        (tmp_path / "broken.cu").write_text("not CUDA\n")
        monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_lib", None)
    else:
        monkeypatch.setattr(_build, "_lib", _RefusingLibrary(1))
    orig = BatchAligner.submit_batch

    def submit(eng, pairs):
        _build.launch("wfa_score_loop")  # as the card's first launch does
        return orig(eng, pairs)

    monkeypatch.setattr(BatchAligner, "submit_batch", submit)
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2), Options(True),
                                            ADAPTIVE, device="cpu"))
    with pytest.raises(_build.KernelError):
        pipe.align_all(random_pairs(random.Random(8), 4, 40))
    assert pipe._device_errors == 0
    assert "device error" not in capsys.readouterr().err


@pytest.mark.parametrize("code,fault", [
    (1, False), (9, False), (209, False), (701, False),
    (2, True), (700, True), (719, True)])
def test_launch_error_kinds(monkeypatch, code, fault):
    """A C entry's CUDA error: a device fault at run time (out of memory,
    an earlier kernel's illegal address or failure) raises RuntimeError,
    which the pipeline retries; a refused launch (an invalid value or
    configuration, no image for the card, too many resources) raises
    KernelError, which is not a RuntimeError."""
    from wfa_tpu_torch import _build

    monkeypatch.setattr(_build, "_lib", _RefusingLibrary(code))
    with pytest.raises(Exception) as info:
        _build.launch("wfa_score_loop", 1, None)
    assert isinstance(info.value, RuntimeError) is fault
    assert isinstance(info.value, _build.KernelError) is not fault
    monkeypatch.setattr(_build, "_lib", _RefusingLibrary(0))
    _build.launch("wfa_score_loop", 1, None)
