"""The port's data parallelism against :mod:`wfa_tpu.parallel`, on the CPU.

The JAX side runs ``engine="jax"`` (the XLA lockstep path, bit-exact to
the Pallas path by ``tests/test_pallas_engine.py``) under the 8 virtual
XLA devices of ``tests/conftest.py``; the port runs the same number of
virtual shards of the CPU (a mesh whose device repeats), where its kernel
wrappers run their plain PyTorch versions.  Every comparison is integer:
the tolerance is exact equality.  The counterparts of
``tests/test_parallel.py``'s cases, the KW mode under a mesh
(``tests/test_rebase_aux.py::test_rebase_aux_under_shard_map``), and two
processes over gloo."""

import contextlib
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from wfa_tpu import AdaptiveReductionOption, Options, OracleAligner, Penalties
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.engine import BatchAligner as JaxAligner
from wfa_tpu.engine import EngineConfig as JaxConfig
from wfa_tpu_torch import parallel
from wfa_tpu_torch.engine import BatchAligner, config_from_jax
from wfa_tpu_torch.kernel_engine import run_batch
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEN = Penalties(4, 6, 2)
ADA = AdaptiveReductionOption(10, 50, 1)
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")


def cpu_mesh(n):
    return parallel.make_dp_mesh(n, device="cpu")


def _same(a, b):
    """Results equal field by field (None alike)."""
    assert (a is None) == (b is None)
    if a is not None:
        assert a.cigar(False) == b.cigar(False)
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f


def _padded(pairs, n):
    return pairs + [(b"A", b"A")] * ((-len(pairs)) % n)


@pytest.mark.parametrize("shift", [12, 28], ids=["int16", "int32"])
def test_compact_tokens_matches_jax(shift):
    """The 2-D compaction (a prefix sum and a scatter) against JAX's
    stable sort, token for token, at both token widths."""
    from wfa_tpu.device_backtrace import compact_tokens as jct

    from wfa_tpu_torch.device_backtrace import compact_tokens

    rng = np.random.default_rng(shift)
    B, it = 9, 23
    dt = np.int16 if shift == 12 else np.int32
    hi = (5 << shift) - 1

    def sparse(shape):
        a = rng.integers(1, hi, shape)
        return np.where(rng.random(shape) < 0.4, a, 0).astype(dt)

    tok0, buf, tail = sparse((B,)), sparse((it, B, 2)), sparse((B, 4))
    buf[:, 3] = 0  # a pair whose loop emitted nothing
    jt, jn = jct(tok0, buf, tail, shift)
    tt, tn = compact_tokens(*map(torch.from_numpy, (tok0, buf, tail)), shift)
    assert tt.dtype == (torch.int16 if shift == 12 else torch.int32)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(jn), tn.numpy())


def _dp_full_case(n_pairs, shards, layout):
    """(pairs padded to the mesh, JAX's packed batch, port cfg) for the
    compact ("mt") or raw layout."""
    if layout == "mt":
        pen, ada, k_win, s_cap = PEN, ADA, 128, 128
        pairs = generate_pairs(n_pairs, 48, 0.15, seed=3)
    else:  # past 2**16 token slots: the raw layout (k_win 32 keeps it small)
        pen, ada, k_win, s_cap = Penalties(8, 6, 1), None, 32, 65536
        pairs = generate_pairs(n_pairs, 20, 0.1, seed=4)
    pairs = _padded(pairs, shards)
    jb = JaxAligner(pen, Options(True), ada, k_win=k_win, s_cap=s_cap,
                    engine="jax")
    return pairs, jb, config_from_jax(jb.cfg)


@pytest.mark.parametrize("layout,shards,n", [
    ("mt", 2, 13), ("mt", 4, 13), ("mt", 8, 13), ("raw", 2, 5),
    ("raw", 4, 5)], ids=["mt-2", "mt-4", "mt-8", "raw-2", "raw-4"])
def test_dp_align_full_matches_jax(layout, shards, n):
    """dp_align_full's 2-D outputs against dp_align_full_fn's, tensor for
    tensor and dtype for dtype, on a ragged batch padded to the mesh."""
    from wfa_tpu.parallel import dp_align_full as jdp
    from wfa_tpu.parallel import make_dp_mesh as jmesh

    pairs, jb, cfg = _dp_full_case(n, shards, layout)
    packed = jb.pack_batch(pairs)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = packed
    want = jax.device_get(jdp(*map(jax.numpy.asarray, packed[:5]),
                              cfg=jb.cfg, mesh=jmesh(shards), Lq=Lq,
                              Ltb=Ltb, engine="jax"))
    got = parallel.dp_align_full(qb, tbuf, qlen, tlen, toff, cfg=cfg,
                                 mesh=cpu_mesh(shards), Lq=Lq, Ltb=Ltb)
    assert sorted(got) == sorted(want) == (
        ["mt"] if layout == "mt" else ["buf", "meta", "tail", "tok0"])
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype, k
        assert np.array_equal(got[k].numpy(), w), k
    # the same outputs from the engine's own 2-D layout on one device
    from wfa_tpu_torch.engine import align_full2

    seq = torch.from_numpy(np.concatenate([qb, tbuf], axis=1))
    lens = torch.from_numpy(np.stack([qlen, tlen, toff], 1).astype(np.int32))
    one = align_full2(seq, lens, cfg=cfg, B=len(pairs), Lq=Lq, Ltb=Ltb,
                      flat=False)
    if layout == "mt":
        assert torch.equal(one["mt"], got["mt"])
    results = BatchAligner(PEN if layout == "mt" else Penalties(8, 6, 1),
                           Options(True), cfg.adaptive, k_win=cfg.k_win,
                           s_cap=cfg.s_cap, device="cpu",
                           mesh=cpu_mesh(shards)).align_batch(pairs)
    oracle = OracleAligner(cfg.penalties, Options(True), cfg.adaptive)
    for (q, t), r in zip(pairs, results):
        _same(r, oracle.align(q, t))


def test_dp_scores_and_state_match_single_device():
    """dp_align_scores (8 shards) against K1 on one device and against
    JAX's dp_align_scores; dp_align_state's done count is the sum."""
    from wfa_tpu.parallel import dp_align_scores as jscores
    from wfa_tpu.parallel import make_dp_mesh as jmesh

    jcfg = JaxConfig(penalties=PEN, global_alignment=True, adaptive=ADA,
                     k_win=128, s_cap=128)
    cfg = config_from_jax(jcfg)
    pairs = generate_pairs(16, 48, 0.15, seed=3)
    jb = JaxAligner(PEN, Options(True), ADA, k_win=128, s_cap=128)
    packed = jb.pack_batch(pairs)
    Lq, Ltb = packed[5:7]
    mesh = cpu_mesh(8)
    final_s, done = parallel.dp_align_scores(*packed[:5], cfg=cfg, mesh=mesh,
                                             Lq=Lq, Ltb=Ltb)
    single = run_batch(*(torch.from_numpy(np.asarray(a)) for a in packed[:5]),
                       cfg=cfg, Lq=Lq, Ltb=Ltb)
    assert torch.equal(final_s, single[0]) and torch.equal(done, single[1])
    assert bool(done.all())
    js, jd = jscores(*map(jax.numpy.asarray, packed[:5]), cfg=jcfg,
                     mesh=jmesh(8), Lq=Lq, Ltb=Ltb)
    assert np.array_equal(np.asarray(js), final_s.numpy())
    assert np.array_equal(np.asarray(jd), done.numpy())
    st, n_done = parallel.dp_align_state(*packed[:5], cfg=cfg, mesh=mesh,
                                         Lq=Lq, Ltb=Ltb)
    assert n_done == 16 and torch.equal(st["final_s"], final_s)
    assert st["aux"].shape == single[4].shape


def test_pipeline_mesh_matches_single_device():
    """AlignmentPipeline with n_devices=8 (8 virtual shards of the CPU)
    against n_devices=1, field by field, on 35 pairs (ragged everywhere),
    through one submit worker."""
    base = dict(penalties=PEN, options=Options(True), adaptive=ADA,
                batch_size=16, device="cpu")
    pairs = generate_pairs(35, 60, 0.1, seed=11)
    multi = AlignmentPipeline(PipelineConfig(**base, n_devices=8))
    single = AlignmentPipeline(PipelineConfig(**base, n_devices=1))
    assert multi._mesh is not None and multi._mesh.size == 8
    assert single._mesh is None
    for a, b in zip(multi.align_all(pairs), single.align_all(pairs)):
        _same(a, b)
    assert multi.served[0] == 35
    assert multi._pool("submit")._max_workers == 1
    assert single._pool("submit")._max_workers == 3
    # n_devices 0 on the CPU is one device: no mesh
    assert AlignmentPipeline(PipelineConfig(**base))._mesh is None
    multi.close()
    single.close()


def test_mesh_padding_raw_token_path():
    """3 pairs over 4 shards through the raw (past 2**16 slots) layout:
    the padded rows are fetched and dropped (tests/test_parallel.py
    test_mesh_padding_raw_token_path)."""
    eng = BatchAligner(Penalties(8, 6, 1), Options(True), None, k_win=64,
                       s_cap=65536, device="cpu", mesh=cpu_mesh(4))
    oracle = OracleAligner(Penalties(8, 6, 1), Options(True), None)
    pairs = [(b"ACGTACGTAC", b"ACGAACGTAC"), (b"ACGT", b"AGGT"),
             (b"ACCTG", b"ACCTG")]
    h = eng.submit_batch(pairs)
    assert [len(p.pairs) for _, p in h.parts] == [1, 1, 1, 1]
    assert all("buf" in p.out for _, p in h.parts)
    res = eng.finish_batch(h)
    assert len(res) == 3
    for (q, t), r in zip(pairs, res):
        _same(r, oracle.align(q, t))


def test_kw_mode_under_a_mesh():
    """K1-kw (engine "pallas:kw128") under 4 shards: the sbase words
    survive the shards' joins; the same results, None alike, as on one
    device, and served ones equal the oracle
    (test_rebase_aux_under_shard_map)."""
    args = (PEN, Options(True), ADA)
    kw = dict(k_win=256, s_cap=384, engine="pallas:kw128", device="cpu")
    pairs = generate_pairs(8, 200, 0.08, seed=13)
    got = BatchAligner(*args, **kw, mesh=cpu_mesh(4)).align_batch(
        pairs, fallback=False)
    want = BatchAligner(*args, **kw).align_batch(pairs, fallback=False)
    oracle = OracleAligner(*args)
    assert sum(r is not None for r in got) >= 6
    for (q, t), a, b in zip(pairs, got, want):
        _same(a, b)
        if a is not None:
            _same(a, oracle.align(q, t))


def test_semi2_pipeline_under_mesh():
    """The two-phase semi-global route over 4 shards: a semi2 tier serves
    the pairs (the mid-point on the whole batch), bit-exact to the
    oracle; 9 pairs pad to 12."""
    cfg = PipelineConfig(penalties=PEN, options=Options(False), adaptive=ADA,
                         batch_size=9, n_devices=4, device="cpu")
    pipe = AlignmentPipeline(cfg)
    assert pipe._mesh is not None and pipe._mesh.size == 4
    pairs = generate_pairs(9, 300, 0.05, seed=23)
    results = pipe.align_all(pairs)
    assert any(e.startswith("semi2") for _, _, e in pipe._engines)
    assert pipe.served[0] == 9
    oracle = OracleAligner(PEN, Options(False), ADA)
    for (q, t), r in zip(pairs, results):
        _same(r, oracle.align(q, t))
    pipe.close()


def test_longest_pair_in_one_shard():
    """One pair past 4096 bases in the last of 4 shards sets the whole
    batch's token plan (28-bit tokens): every shard emits int32 rows, and
    the joined outputs equal JAX's (a shard that packed its own pairs
    would emit int16 and not join)."""
    from wfa_tpu.parallel import dp_align_full as jdp
    from wfa_tpu.parallel import make_dp_mesh as jmesh

    long = generate_pairs(1, 4200, 0.0, seed=8)[0]
    pairs = generate_pairs(7, 60, 0.1, seed=8) + [long]
    eng = BatchAligner(PEN, Options(True), ADA, k_win=128, s_cap=256,
                       device="cpu", mesh=cpu_mesh(4))
    h = eng.submit_batch(pairs)
    assert [p.out["mt"].dtype for _, p in h.parts] == [torch.int32] * 4
    oracle = OracleAligner(PEN, Options(True), ADA)
    for (q, t), r in zip(pairs, eng.finish_batch(h)):
        _same(r, oracle.align(q, t))
    jb = JaxAligner(PEN, Options(True), ADA, k_win=128, s_cap=256,
                    engine="jax")
    packed = jb.pack_batch(pairs)
    Lq, Ltb = packed[5:7]
    want = jax.device_get(jdp(*map(jax.numpy.asarray, packed[:5]),
                              cfg=jb.cfg, mesh=jmesh(4), Lq=Lq, Ltb=Ltb,
                              engine="jax"))
    got = parallel.dp_align_full(*packed[:5], cfg=eng.cfg,
                                 mesh=cpu_mesh(4), Lq=Lq, Ltb=Ltb)
    assert np.array_equal(got["mt"].numpy(), want["mt"])


def test_each_shard_runs_on_its_own_device(monkeypatch):
    """With two cards, each shard's inputs go to its own card with that
    card current, its event is recorded on that card's stream, and that
    card's copy stream waits on it (one card's two shards would share one
    stream and hide a mistake here).  Torch's CUDA calls are stood in for
    and the shards' tensors stay on the CPU, so this runs here."""
    current = [None]
    uploads = []

    @contextlib.contextmanager
    def device(d):
        before, current[0] = current[0], torch.device(d)
        try:
            yield
        finally:
            current[0] = before

    class Event:
        def record(self, stream=None):
            self.stream = stream

    class CopyStream:
        def __init__(self, device=None):
            self.device, self.waited = device, []

        def wait_event(self, ev):
            self.waited.append(ev)

    rows = parallel._rows

    def upload(a, r, dev):
        uploads.append((dev, current[0]))
        return rows(a, r, torch.device("cpu"))

    for name, fn in (("is_available", lambda: True),
                     ("Stream", CopyStream), ("Event", Event),
                     ("current_stream", lambda device=None: ("stream",
                                                             device)),
                     ("stream", lambda s: contextlib.nullcontext()),
                     ("device", device)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(parallel, "_rows", upload)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    eng = BatchAligner(PEN, Options(True), ADA, mesh=parallel.DpMesh(cards))
    for sub in eng._shard_aligners.values():
        monkeypatch.setattr(sub, "_host", lambda a: a)
        monkeypatch.setattr(sub, "_copied", lambda: None)
    pairs = generate_pairs(5, 60, 0.05, seed=3)
    h = eng.submit_batch(pairs)
    assert uploads == [(c, c) for c in cards for _ in range(2)]
    for (sub, part), card in zip(h.parts, cards):
        assert sub.device == card and part.ran.stream == ("stream", card)
        assert sub._copy.device == card and sub._copy.waited == [part.ran]
    oracle = OracleAligner(PEN, Options(True), ADA)
    for (q, t), r in zip(pairs, eng.finish_batch(h)):
        _same(r, oracle.align(q, t))


def test_mesh_that_cannot_be_built_raises(monkeypatch):
    """More cards than there are, or none: an error, never a quiet run on
    fewer devices or on the CPU; a batch that does not divide raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="cards"):
        parallel.make_dp_mesh(2)
    with pytest.raises(RuntimeError, match="no card"):
        parallel.make_dp_mesh(devices=["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="cards"):
        AlignmentPipeline(PipelineConfig(n_devices=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_dp_mesh(2)
    with pytest.raises(ValueError, match="divisible"):
        cpu_mesh(4).shards(6)


def test_indexed_card_is_one_card(monkeypatch):
    """A card named by its index stays the card the caller chose: on a
    host with two cards, ``device="cuda:1"`` with the default
    ``n_devices`` builds no mesh (three submit workers, flat outputs), and
    asking it for more shards raises instead of replacing the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.make_dp_mesh(device="cuda:1").devices == [
        torch.device("cuda", 1)]
    assert AlignmentPipeline(PipelineConfig(device="cuda:1"))._mesh is None
    with pytest.raises(ValueError, match="name the cards"):
        parallel.make_dp_mesh(2, device="cuda:1")
    with pytest.raises(ValueError, match="name the cards"):
        AlignmentPipeline(PipelineConfig(device="cuda:1", n_devices=2))
    # the unindexed card still means every card
    assert parallel.make_dp_mesh(device="cuda").size == 2
    two = AlignmentPipeline(PipelineConfig(devices=("cuda:1", "cuda:0")))
    assert two._mesh.devices == [torch.device("cuda", 1),
                                 torch.device("cuda", 0)]


def test_shard_launch_tally():
    """Each shard's launches go to its own tally, named as the smoke
    names the counts; another thread's count does not."""
    import threading

    from wfa_tpu_torch._build import count

    mesh = cpu_mesh(2)
    with mesh.on(1):
        count(run_batch.launches, "global")
        t = threading.Thread(target=count,
                             args=(run_batch.launches, "semi"))
        t.start()
        t.join(10)
    assert not t.is_alive()
    assert parallel.shard_launches(mesh) == [
        {}, {"score_loop": {"global": 1}}]


_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from wfa_tpu_torch import (AdaptiveReductionOption, Options, Penalties)
from wfa_tpu_torch.datagen import generate_pairs
from wfa_tpu_torch.parallel import initialize_distributed
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

n = initialize_distributed(init_method=sys.argv[1], world_size=2,
                           rank=int(sys.argv[2]))
assert n == 2 and initialize_distributed() == 2
for ga, n_pairs, length, batch in ((True, 12, 50, 8), (False, 6, 280, 6)):
    pipe = AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(ga), AdaptiveReductionOption(10, 50, 1),
        batch_size=batch, device="cpu"))
    assert pipe._mesh.size == 2 and pipe._mesh.world == 2
    res = pipe.align_all(generate_pairs(n_pairs, length, 0.06, seed=33))
    assert pipe._device_errors == 0 and pipe.served["oracle"] == 0
    if not ga:
        assert any(e.startswith("semi2") for _, _, e in pipe._engines)
    pipe.close()
    print("DIGEST:" + repr([(r.score, r.cigar(False), r.q_begin, r.q_end,
                             r.t_begin, r.t_end, r.align_len, r.matches,
                             r.gaps, r.gap_regions) for r in res]))
# gloo's threads joined before the interpreter's teardown
torch.distributed.destroy_process_group()
"""


def test_two_processes_over_gloo():
    """Two processes, one CPU shard each, over gloo: each holds the whole
    input, runs its shard and gathers the other's, so both return every
    result, global and two-phase semi-global (the meta1 exchange), equal
    to the oracle (test_multihost_two_process_cpu)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, f"tcp://localhost:{port}", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append([eval(line[len("DIGEST:"):])
                         for line in out.splitlines()
                         if line.startswith("DIGEST:")])
    finally:
        for p in procs:
            p.kill()
    assert outs[0] == outs[1] and len(outs[0]) == 2
    for ga, n_pairs, length, got in ((True, 12, 50, outs[0][0]),
                                     (False, 6, 280, outs[0][1])):
        oracle = OracleAligner(PEN, Options(ga), ADA)
        want = [(r.score, r.cigar(False), *(getattr(r, f)
                                            for f in FIELDS[1:]))
                for r in (oracle.align(q, t) for q, t in generate_pairs(
                    n_pairs, length, 0.06, seed=33))]
        assert got == want


def test_initialize_distributed_timeout(monkeypatch):
    """The process group's timeout is 300 s unless the caller gives one,
    and the caller's is passed on."""
    import datetime

    import torch.distributed as dist

    seen = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: seen.append(kw))
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    args = dict(init_method="tcp://localhost:1", world_size=2, rank=0)
    assert parallel.initialize_distributed(**args) == 2
    mine = datetime.timedelta(seconds=7)
    parallel.initialize_distributed(**args, timeout=mine)
    assert [kw["timeout"] for kw in seen] == [
        datetime.timedelta(seconds=300), mine]
    assert all(kw["backend"] == "gloo" for kw in seen)


DEAD_TIMEOUT = 3  # seconds, the group's timeout in test_dead_peer_raises

_DEAD_PEER = r"""
import datetime
import os
import sys
import time
import torch
torch.set_num_threads(1)
from wfa_tpu_torch import AdaptiveReductionOption, Options, Penalties
from wfa_tpu_torch.datagen import generate_pairs
from wfa_tpu_torch.parallel import ShardError, initialize_distributed
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

init, rank, how, timeout = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    int(sys.argv[4])
initialize_distributed(init_method=init, world_size=2, rank=rank,
                       timeout=datetime.timedelta(seconds=timeout))
pipe = AlignmentPipeline(PipelineConfig(
    Penalties(4, 6, 2), Options(True), AdaptiveReductionOption(10, 50, 1),
    batch_size=8, device="cpu"))
print("READY", flush=True)
if rank == 1:  # the peer: gone, or stuck past the timeout
    if how == "hangs":
        time.sleep(timeout + 60)
    os._exit(0)
t0 = time.perf_counter()
try:
    pipe.align_all(generate_pairs(12, 50, 0.06, seed=33))
    print("NO RAISE", flush=True)
except ShardError as exc:
    print(f"RAISED {time.perf_counter() - t0:.3f} {exc}", flush=True)
pipe.close()
os._exit(0)
"""


@pytest.mark.parametrize("how", ["exits", "hangs"])
def test_dead_peer_raises(how):
    """Two processes over gloo with a 3 s timeout; one exits, or sleeps
    past the timeout, before its first exchange.  The other's align_all
    raises ShardError within the timeout plus a margin, and hangs in no
    later gather."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DEAD_PEER, f"tcp://localhost:{port}", str(r),
         how, str(DEAD_TIMEOUT)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    try:
        # the test's own wall limit: a hang fails here, it does not hold
        # the suite's clock
        out, err = procs[0].communicate(timeout=120)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert procs[0].returncode == 0, err[-3000:]
    raised = [line.split() for line in out.splitlines()
              if line.startswith("RAISED ")]
    assert "READY" in out and len(raised) == 1, (out, err[-3000:])
    assert float(raised[0][1]) < DEAD_TIMEOUT + 10, raised
    assert "the gather failed" in out
