"""The port stands alone: no module of ``wfa_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or any module of the JAX package
``wfa_tpu``, and the port's own copies of the host layers (oracle,
datagen, io, native packer) equal the JAX package's."""

import ast
import os
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the port's sources; its git-ignored build directory (kernel libraries,
# copies of other revisions' sources) is not the port
FILES = sorted(p for p in (ROOT / "wfa_tpu_torch").rglob("*.py")
               if p.relative_to(ROOT / "wfa_tpu_torch").parts[0] != "build"
               ) + [ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "wfa_tpu")  # import roots the port may not load


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    for name in _imports(path):
        assert name.split(".")[0] not in BLOCKED, (path, name)


# The main paths on the CPU in a fresh interpreter where importing JAX or
# wfa_tpu fails; it also catches imports the scan above cannot see.
_NO_JAX_RUN = """
import sys

class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Blocked())
import torch
torch.set_num_threads(2)
from wfa_tpu_torch import (AdaptiveReductionOption, OracleAligner, Options,
                           Penalties)
from wfa_tpu_torch.datagen import generate_pairs
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

args = (Penalties(4, 6, 2), Options(True), AdaptiveReductionOption(10, 50, 1))
pairs = generate_pairs(6, 150, 0.05, seed=9)
q = generate_pairs(1, 300, 0.0, seed=3)[0][0]
pairs.append((q, q[:150]))  # its band leaves the tier-0 window
long_pair = generate_pairs(1, 4300, 0.002, seed=5)  # the long-read engine
kw_pair = generate_pairs(1, 3950, 0.003, seed=31)  # K1-kw ("auto:kw256")
pipe = AlignmentPipeline(PipelineConfig(*args, batch_size=4, device="cpu"))
oracle = OracleAligner(*args)
run = pairs + long_pair + kw_pair
for (q, t), r in zip(run, pipe.align_all(run)):
    o = oracle.align(q, t)
    assert (r.score, r.cigar(False), r.q_end, r.matches) == (
        o.score, o.cigar(False), o.q_end, o.matches), (q, t)
assert pipe.served[1] >= 1, pipe.served
engines = [e for _, _, e in pipe._engines]
assert "long" in engines and "auto:kw256" in engines, engines
# semi-global: full token streams, decoded without JAX; l=320 takes the
# two-phase route
semi = (args[0], Options(False), args[2])
pipe = AlignmentPipeline(PipelineConfig(*semi, batch_size=4, device="cpu"))
oracle = OracleAligner(*semi)
pairs += generate_pairs(2, 320, 0.05, seed=11)
for (q, t), r in zip(pairs, pipe.align_all(pairs)):
    o = oracle.align(q, t)
    assert (r.score, r.cigar(False), r.q_end, r.t_begin, r.matches) == (
        o.score, o.cigar(False), o.q_end, o.t_begin, o.matches), (q, t)
assert pipe.served["oracle"] == 0, pipe.served
assert any(e.startswith("semi2:") for _, _, e in pipe._engines), pipe._engines
# the data-parallel mesh (two virtual shards of the CPU), the CLI and plot
pipe = AlignmentPipeline(PipelineConfig(*args, batch_size=4, device="cpu",
                                        n_devices=2))
assert pipe._mesh is not None
oracle = OracleAligner(*args)
for (q, t), r in zip(pairs, pipe.align_all(pairs)):
    assert (r.score, r.cigar(False)) == (oracle.align(q, t).score,
                                         oracle.align(q, t).cigar(False))
from wfa_tpu_torch import cli
assert cli.main(["-i", "tests/data/seqs.txt", "--device", "cpu",
                 "--devices", "2"]) == 0
oracle.align(b"ACCATACTCG", b"AGGATGCTCG")
assert "12" in oracle.plot(b"ACCATACTCG", b"AGGATGCTCG")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r})
assert not loaded, loaded
print("no-jax run ok")
"""


def test_main_path_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN.format(blocked=set(BLOCKED))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "no-jax run ok" in r.stdout


ORACLE_FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end",
                 "align_len", "matches", "gaps", "gap_regions")


def _oracle_pairs():
    """The goldens plus a seeded fuzz set of mixed lengths, error rates,
    length differences and non-ACGT bytes."""
    from wfa_tpu.io import read_pairs

    pairs = [(b"AGCTAGTGTCAATGGCTACTTTTCAGGTCCT",
              b"AACTAAGTGTCGGTGGCTACTATATATCAGGTCCT"),
             (b"ACGATCTCG", b"CAGGCTCCTCGG"),
             (b"Bioinformatics helps Biology",
              b"We learn bioinformatics to help biologists")]
    pairs += list(read_pairs(str(ROOT / "tests" / "data" / "seqs.txt")))[:3]
    rng = random.Random(23)
    for _ in range(24):
        n = rng.randint(1, 120)
        q = bytes(rng.choice(b"ACGT") for _ in range(n))
        t = bytearray(q)
        for _ in range(rng.randint(0, max(1, n // 6))):
            pos = rng.randrange(len(t) + 1)
            kind = rng.randrange(3)
            if kind == 0 and pos < len(t):
                t[pos] = rng.choice(b"ACGTN")
            elif kind == 1 and pos < len(t):
                del t[pos]
            else:
                t[pos:pos] = bytes([rng.choice(b"ACGT")])
        pairs.append((q, bytes(t) or b"A"))
    return pairs


HOST_CASES = ["oracle-global-adaptive", "oracle-global-plain",
              "oracle-semi-adaptive", "oracle-semi-plain", "generate_pairs",
              "bucket_pairs", "native_pack", "plot"]


@pytest.mark.parametrize("case", HOST_CASES)
def test_host_layers_match_wfa_tpu(case):
    """The port's copies of the host layers give what wfa_tpu's give:
    oracle results (every field and the CIGAR), datagen pairs, buckets,
    the native 2-bit pack, and the plot tables (``plot.plot`` and the
    oracle's ``plot`` method), byte for byte."""
    import wfa_tpu
    import wfa_tpu_torch

    if case.startswith("oracle"):
        _, mode, red = case.split("-")
        res = []
        for pkg in (wfa_tpu, wfa_tpu_torch):
            ad = pkg.AdaptiveReductionOption(10, 50, 1) if red == "adaptive" \
                else None
            aligner = pkg.OracleAligner(pkg.Penalties(4, 6, 2),
                                        pkg.Options(mode == "global"), ad)
            res.append([aligner.align(q, t) for q, t in _oracle_pairs()])
        for a, b in zip(*res):
            assert a.cigar(False) == b.cigar(False)
            assert a.cigar(True) == b.cigar(True)
            for f in ORACLE_FIELDS:
                assert getattr(a, f) == getattr(b, f), f
    elif case == "generate_pairs":
        from wfa_tpu import datagen as jd
        from wfa_tpu_torch import datagen as td

        for args in ((16, 300, 0.05, 42), (4, 2000, 0.2, 7), (3, 5, 1.0, 1)):
            assert jd.generate_pairs(*args) == td.generate_pairs(*args)
    elif case == "plot":
        from wfa_tpu import plot as jp
        from wfa_tpu_torch import plot as tp

        for ga in (True, False):
            for ad in (None, (10, 50, 1)):
                tables = []
                for pkg, mod in ((wfa_tpu, jp), (wfa_tpu_torch, tp)):
                    aligner = pkg.OracleAligner(
                        pkg.Penalties(4, 6, 2), pkg.Options(ga),
                        ad and pkg.AdaptiveReductionOption(*ad))
                    got = []
                    for q, t in _oracle_pairs()[:8]:
                        aligner.align(q, t)
                        got += [aligner.plot(q, t), mod.plot(
                            aligner, q, t, aligner.I, True, 20)]
                    tables.append(got)
                assert tables[0] == tables[1]
    elif case == "bucket_pairs":
        from wfa_tpu import io as jio
        from wfa_tpu_torch import io as tio

        indexed = list(enumerate(_oracle_pairs()))
        indexed += [(99, (b"A" * 5000, b"C" * 70))]
        assert jio.bucket_pairs(indexed) == tio.bucket_pairs(indexed)
    else:
        from wfa_tpu import native as jn
        from wfa_tpu_torch import native as tn

        assert (tn.load() is None) == (jn.lib is None)
        if jn.lib is None:
            return
        seqs = [q for q, _ in _oracle_pairs()[:12]] + [b"ACGTTGCA" * 40]
        lens = np.array([len(s) for s in seqs], np.int32)
        offs = np.arange(len(seqs), dtype=np.int32) * 3
        L = 512
        for off in (None, offs):
            raw_j, pk_j = jn.build_and_pack(seqs, lens, off, L)
            raw_t, pk_t = tn.build_and_pack(seqs, lens, off, L)
            assert np.array_equal(raw_j, raw_t)
            assert (pk_j is None) == (pk_t is None)
            if pk_j is not None:
                assert np.array_equal(pk_j, pk_t)
            dj = jn.pack_direct(seqs, lens, off, L)
            dt = tn.pack_direct(seqs, lens, off, L)
            assert (dj is None) == (dt is None)
            if dj is not None:
                assert np.array_equal(dj, dt)
        acgt = [s for s in seqs if set(s) <= set(b"ACGT")]
        lens = np.array([len(s) for s in acgt], np.int32)
        assert np.array_equal(jn.pack_direct(acgt, lens, None, L),
                              tn.pack_direct(acgt, lens, None, L))
