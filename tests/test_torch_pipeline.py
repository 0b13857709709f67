"""The port's entry point vs the exact oracle, on the CPU.

``wfa_tpu_torch.pipeline.AlignmentPipeline(device="cpu").align_all``
must equal ``wfa_tpu.oracle`` on score, CIGAR, q/t begin/end, align_len,
matches, gaps and gap_regions, whichever tier served the pair, in global
and semi-global mode."""

import contextlib
import inspect
import random
import sys
import threading

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


def _faulty_submit(monkeypatch, faults):
    """Make ``BatchAligner.submit_batch`` raise each exception of
    ``faults`` ((pair, exception) items) once, on the first submit of a
    batch that holds that pair, and submit as before otherwise (the
    pipeline's submit workers call it in no fixed order); returns the
    list of calls it saw."""
    orig = BatchAligner.submit_batch
    calls = []
    pending = list(faults)
    lock = threading.Lock()

    def submit(eng, pairs):
        with lock:
            calls.append(len(pairs))
            hit = next((f for f in pending if f[0] in pairs), None)
            if hit is not None:
                pending.remove(hit)
        if hit is not None:
            raise hit[1]
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
    # chunk 0 holds pairs 0-7 and chunk 1 pairs 8-11
    calls = _faulty_submit(monkeypatch, [
        (pairs[i], RuntimeError("CUDA error: an illegal memory access"))
        for i in (0, 8)[:faults]])
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
    pairs = random_pairs(random.Random(6), 4, 40)
    _faulty_submit(monkeypatch, [(pairs[0], ValueError("bad shape"))])
    with pytest.raises(ValueError, match="bad shape"):
        pipe.align_all(pairs)


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


def _counting_submit(monkeypatch, gate=None):
    """Count ``BatchAligner.submit_batch`` calls (the batch sizes, from any
    thread); with ``gate`` (a threading.Event) each call first waits for
    it."""
    orig = BatchAligner.submit_batch
    calls = []

    def submit(eng, pairs):
        calls.append(len(pairs))
        if gate is not None:
            assert gate.wait(30)
        return orig(eng, pairs)

    monkeypatch.setattr(BatchAligner, "submit_batch", submit)
    return calls


def test_pipeline_probe_skips_doomed_tier(monkeypatch):
    """The counterpart of tests/test_semi2.py's probe test: 96 pairs of
    l=150 at e=0.45 in batches of 16 take at most 10 submits, and the
    results equal the oracle."""
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(96, 150, 0.45, seed=3)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=16, device="cpu"))
    calls = _counting_submit(monkeypatch)
    _assert_oracle(pairs, pipe.align_all(pairs), p, ADAPTIVE)
    assert len(calls) <= 10, calls


def test_probe_skips_the_rest_of_a_doomed_tier(monkeypatch):
    """When at least 90% of a tier's first chunk overflows, its chunks not
    yet handed to the workers go straight to the next tier.  One batch in
    flight at a time (WFA_MAX_INFLIGHT=1) makes the third chunk wait for
    the probe: of six chunks whose every pair overflows tier 0 (s_cap 128)
    at most three run there."""
    monkeypatch.setenv("WFA_MAX_INFLIGHT", "1")
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(24, 150, 0.45, seed=3)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=4, s_cap_base=64,
                                            device="cpu"))
    assert pipe._tier_caps(170, 170, 0)[1] == 128
    tier0 = []
    orig = BatchAligner.submit_batch

    def submit(eng, batch):
        if eng.cfg.s_cap == 128:
            tier0.append(len(batch))
        return orig(eng, batch)

    monkeypatch.setattr(BatchAligner, "submit_batch", submit)
    _assert_oracle(pairs, pipe.align_all(pairs), p, ADAPTIVE)
    assert pipe.served[0] == 0
    assert 2 <= len(tier0) <= 3, tier0
    assert pipe.peak["batches"] == 1


def test_count_cap(monkeypatch):
    """No more than WFA_MAX_INFLIGHT batches are in flight at once: with
    the submits held, the pipeline admits exactly that many and waits."""
    monkeypatch.setenv("WFA_MAX_INFLIGHT", "2")
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(24, 100, 0.05, seed=12)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=4, device="cpu"))
    go = threading.Event()
    calls = _counting_submit(monkeypatch, go)
    out = {}
    runner = threading.Thread(
        target=lambda: out.setdefault("res", pipe.align_all(pairs)))
    runner.start()
    try:
        for _ in range(300):
            if pipe._batches == 2:
                break
            threading.Event().wait(0.01)
        threading.Event().wait(0.3)
        assert pipe._batches == 2 and len(calls) == 2
    finally:
        go.set()
        runner.join(60)
    assert not runner.is_alive()
    _assert_oracle(pairs, out["res"], p, ADAPTIVE)
    assert len(calls) == 6 and pipe.peak["batches"] == 2
    assert pipe._batches == 0 and pipe._mem_used == 0


def test_byte_gate():
    """The gate holds the bytes reserved at once to twice mem_budget: a
    reservation that would pass it waits for a release; one larger than
    the whole gate is still admitted, alone."""
    pipe = AlignmentPipeline(PipelineConfig(mem_budget=100, device="cpu"))
    pipe.peak = {"batches": 0, "bytes": 0}
    admitted = threading.Event()

    def second(nbytes):
        admitted.clear()
        t = threading.Thread(target=lambda: (pipe._mem_acquire(nbytes),
                                             admitted.set()))
        t.start()
        return t

    pipe._mem_acquire(150)
    t = second(100)  # 250 > 200: waits
    assert not admitted.wait(0.3)
    pipe._mem_release(150)
    assert admitted.wait(10)
    t.join(10)
    assert pipe._mem_used == 100
    pipe._mem_release(100)
    pipe._mem_acquire(500)  # past the gate, but the only reservation
    t = second(1)
    assert not admitted.wait(0.3)
    pipe._mem_release(500)
    assert admitted.wait(10)
    t.join(10)
    pipe._mem_release(1)
    assert pipe._mem_used == 0 and pipe.peak["bytes"] == 500


def test_byte_gate_in_align_all():
    """A call whose gate admits two of its batches' models at once: the
    reservations never pass the gate, and the results equal the oracle."""
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(24, 100, 0.05, seed=13)
    probe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                             batch_size=4, device="cpu"))
    per_batch = probe._tier_caps(128, 128, 0)[5]
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=4,
                                            mem_budget=per_batch + 1,
                                            device="cpu"))
    assert pipe._tier_caps(128, 128, 0)[5] == per_batch
    _assert_oracle(pairs, pipe.align_all(pairs), p, ADAPTIVE)
    assert pipe.served[0] == len(pairs)
    assert per_batch <= pipe.peak["bytes"] <= pipe.peak["gate"]
    assert pipe._mem_used == 0


def test_errors_release_every_reservation(monkeypatch):
    """A host error in one batch's submit leaves align_all only after
    every batch of the call has drained: no byte reservation or slot is
    left held, and the pipeline aligns the next call."""
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(16, 80, 0.05, seed=14)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=4, device="cpu"))
    _faulty_submit(monkeypatch, [(pairs[5], ValueError("bad shape"))])
    with pytest.raises(ValueError, match="bad shape"):
        pipe.align_all(pairs)
    assert pipe._mem_used == 0 and pipe._batches == 0
    _assert_oracle(pairs, pipe.align_all(pairs), p, ADAPTIVE)
    pipe.close()


def test_align_iter_matches_align_all():
    """align_iter yields align_all's results in input order, across the
    boundaries of its chunks."""
    p = Penalties(4, 6, 2)
    pairs = random_pairs(random.Random(31), 11, 70)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=4, device="cpu"))
    whole = pipe.align_all(pairs)
    streamed = list(pipe.align_iter(iter(pairs), chunk=5))
    assert len(streamed) == len(pairs)
    for a, b in zip(whole, streamed):
        assert a.cigar(False) == b.cigar(False)
        assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)
    _assert_oracle(pairs, streamed, p, ADAPTIVE)


def test_use_device_false_is_the_oracle():
    """use_device=False serves every pair by the oracle and touches no
    device: the card default holds even where there is none."""
    p = Penalties(4, 6, 2)
    pairs = random_pairs(random.Random(32), 6, 60) + [(b"", b"ACGT")]
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            use_device=False))
    assert PipelineConfig().use_device
    res = pipe.align_all(pairs)
    assert isinstance(res[-1].error, EmptySeqError)
    _assert_oracle(pairs[:-1], res[:-1], p, ADAPTIVE)
    assert pipe.served["oracle"] == len(pairs) - 1
    assert not pipe._engines


@pytest.mark.parametrize("layout", ["mtb", "raw"])
def test_fetch_guess_too_small_or_too_large(layout):
    """The speculative fetch's guessed extents change what is copied, not
    the results: a guess far too small (the rest fetched by finish_small)
    and one far too large give the cold start's results.  The raw layout
    (token streams past 2**16 slots) guesses rows of its loop buffer."""
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(4, 60, 0.05, seed=15)
    if layout == "raw":  # the smallest score cap past 2**16 slots
        eng = BatchAligner(p, Options(True), ADAPTIVE, k_win=32,
                           s_cap=65528, device="cpu")
        key = "buf"
    else:
        eng = BatchAligner(p, Options(True), ADAPTIVE, k_win=128,
                           s_cap=256, device="cpu")
        key = "mtb"
    cold = eng.submit_batch(pairs)
    assert (key in cold.host) == (layout == "mtb")  # cold: meta bytes only
    ref = eng.finish_batch(cold)
    _assert_oracle(pairs, ref, p, ADAPTIVE)
    learned = eng._tok_guess[key]
    assert learned
    for guess, rest in ((1, True), (1 << 20, False)):
        eng._tok_guess = {"mtb": guess, "lg": guess, "buf": guess}
        h = eng.finish_small(eng.submit_batch(pairs))
        assert (f"{key}_rest" in h.host) == rest
        assert eng._tok_guess[key] == learned  # re-learned from the meta
        res = eng.finish_tokens(h)
        assert h.out is None  # the device outputs are released
        for a, b in zip(ref, res):
            assert a.cigar(False) == b.cigar(False) and a.score == b.score
    eng.wait_exec(cold)  # nothing to wait for on the CPU


def test_fetch_event_goes_to_the_aligners_card(monkeypatch):
    """On a card other than the thread's current one (a worker thread
    starts on device 0), a batch's event is recorded on the current
    stream of the aligner's own card, the stream its launches went to,
    and the copy stream waits on it; a submit runs with that card as the
    current device.  Torch's CUDA calls are stood in for, so this runs on
    the CPU."""
    class Event:
        def record(self, stream=None):  # None: the current device's
            self.stream = stream

    class CopyStream:
        def __init__(self):
            self.waited = []

        def wait_event(self, ev):
            self.waited.append(ev)

    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        yield

    card = torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream", device))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", device)
    eng = BatchAligner(Penalties(4, 6, 2), Options(True), ADAPTIVE,
                       device="cpu")
    eng.device, eng._copy = card, CopyStream()
    monkeypatch.setattr(eng, "_host", lambda a: a)
    monkeypatch.setattr(eng, "_copied", lambda: None)
    h = eng._queue_fetch([(b"ACGT", b"ACGT")] * 2,
                         {"meta": torch.zeros(2, 8, dtype=torch.int32)}, False)
    assert h.ran.stream == ("stream", card)
    assert eng._copy.waited == [h.ran]
    monkeypatch.setattr(eng, "_submit", lambda pairs, prepacked, shards: (
        lambda: [(eng, list(entered))]))
    assert eng.submit_batch([(b"ACGT", b"ACGT")]) == [card]


def test_builds_once_under_concurrent_first_calls(monkeypatch):
    """Eight threads calling _build.library() or native.load() at once
    build once and all get the one library: no thread sees a missing
    library (native.load's None would send its pack down the numpy
    path)."""
    from wfa_tpu_torch import _build, native

    sentinel = object()
    builds = []

    def slow_build(src_dir):
        builds.append(src_dir)
        threading.Event().wait(0.2)
        return sentinel

    real = native._build

    def slow_native():
        builds.append("native")
        threading.Event().wait(0.2)
        return real()

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(native, "_build", slow_native)
    monkeypatch.setattr(native, "lib", None)
    monkeypatch.setattr(native, "_tried", False)
    for fn, want in ((_build.library, lambda: sentinel),
                     (native.load, lambda: native.lib)):
        builds.clear()
        start = threading.Barrier(8)
        got = []

        def call():
            start.wait(10)
            got.append(fn())

        threads = [threading.Thread(target=call) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1 and len(got) == 8
        assert all(g is want() for g in got)
    assert native.lib is not None  # the packer builds here


def test_launch_counts_under_threads():
    """The launch counters take concurrent adds without losing one."""
    from wfa_tpu_torch._build import count

    counts = {"global": 0}

    def add():
        for _ in range(2000):
            count(counts, "global")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert counts["global"] == 32000


@pytest.mark.parametrize("ga", [True, False], ids=["global", "semi2"])
def test_threaded_pipeline_matches_jax_pipeline(ga):
    """The threaded align_all gives wfa_tpu.pipeline.AlignmentPipeline's
    results value for value on the same pairs, over several batches:
    global on engine "auto", semi-global (spans past 512) on "semi2:64"."""
    from wfa_tpu.pipeline import AlignmentPipeline as JaxPipeline
    from wfa_tpu.pipeline import PipelineConfig as JaxConfig

    p = Penalties(4, 6, 2)
    pairs = (generate_pairs(16, 100, 0.05, seed=9) if ga
             else generate_pairs(8, 270, 0.05, seed=9))
    args = (p, Options(ga), ADAPTIVE)
    ref = JaxPipeline(JaxConfig(*args, batch_size=4, n_devices=1)).align_all(
        pairs)
    pipe = AlignmentPipeline(PipelineConfig(*args, batch_size=4,
                                            device="cpu"))
    got = pipe.align_all(pairs)
    assert {e for _, _, e in pipe._engines} == {"auto" if ga else "semi2:64"}
    assert pipe.served[0] == len(pairs) and pipe.peak["batches"] >= 1
    for r, g in zip(ref, got):
        assert r.cigar(False) == g.cigar(False)
        assert all(getattr(r, f) == getattr(g, f) for f in FIELDS)


@pytest.mark.parametrize("ga", [True, False], ids=["global", "semi2"])
def test_pack_batch_and_prepacked_submit(ga):
    """pack_batch gives wfa_tpu.engine.BatchAligner.pack_batch's arrays,
    and a submit of a batch packed beforehand (``prepacked``) gives the
    results of one that packs itself."""
    import numpy as np
    from wfa_tpu.engine import BatchAligner as JaxAligner

    from wfa_tpu_torch.engine import _pack_all

    p = Penalties(4, 6, 2)
    pairs = generate_pairs(6, 270, 0.05, seed=16)
    engine = "auto" if ga else "semi2:64"
    eng = BatchAligner(p, Options(ga), ADAPTIVE, k_win=256, s_cap=640,
                       engine=engine, device="cpu")
    ref = JaxAligner(p, Options(ga), ADAPTIVE, k_win=256, s_cap=640,
                     engine=engine)
    for a, b in zip(eng.pack_batch(pairs), ref.pack_batch(pairs)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    prepacked = _pack_all(pairs, 256, need_raw=not ga, global_alignment=ga)
    own = eng.align_batch(pairs, fallback=False)
    pre = eng.finish_batch(eng.submit_batch(pairs, prepacked),
                           fallback=False)
    assert sum(r is not None for r in own) >= 5
    for a, b in zip(own, pre):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.score, a.cigar(False)) == (b.score, b.cigar(False))
