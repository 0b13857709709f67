"""The port runs where JAX is not installed: no module of
``wfa_tpu_torch`` (nor ``chip_smoke.py``) may import JAX or a JAX-bound
module of ``wfa_tpu``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "wfa_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
JAX_BOUND = ("engine", "pipeline", "device_backtrace", "pallas_engine",
             "pallas_longread", "pallas_prefix", "semi2", "parallel", "cli",
             "dp", "plot")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
            if node.module == "wfa_tpu":
                for alias in node.names:
                    yield f"wfa_tpu.{alias.name}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib"), (path, name)
        if top == "wfa_tpu" and "." in name:
            assert name.split(".")[1] not in JAX_BOUND, (path, name)


# The main path on the CPU in a fresh interpreter where importing JAX
# fails; it also catches imports the scan above cannot see (lazy imports
# inside the shared wfa_tpu layers).
_NO_JAX_RUN = """
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("JAX is blocked: " + name)

sys.meta_path.insert(0, NoJax())
import torch
torch.set_num_threads(2)
from wfa_tpu import AdaptiveReductionOption, OracleAligner, Options, Penalties
from wfa_tpu.datagen import generate_pairs
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

args = (Penalties(4, 6, 2), Options(True), AdaptiveReductionOption(10, 50, 1))
pairs = generate_pairs(6, 150, 0.05, seed=9)
q = generate_pairs(1, 300, 0.0, seed=3)[0][0]
pairs.append((q, q[:150]))  # its band leaves the tier-0 window
pipe = AlignmentPipeline(PipelineConfig(*args, batch_size=4))
oracle = OracleAligner(*args)
for (q, t), r in zip(pairs, pipe.align_all(pairs)):
    o = oracle.align(q, t)
    assert (r.score, r.cigar(False), r.q_end, r.matches) == (
        o.score, o.cigar(False), o.q_end, o.matches), (q, t)
assert pipe.served[1] >= 1, pipe.served
# semi-global: full token streams, decoded without JAX
semi = (args[0], Options(False), args[2])
pipe = AlignmentPipeline(PipelineConfig(*semi, batch_size=4))
oracle = OracleAligner(*semi)
for (q, t), r in zip(pairs, pipe.align_all(pairs)):
    o = oracle.align(q, t)
    assert (r.score, r.cigar(False), r.q_end, r.t_begin, r.matches) == (
        o.score, o.cigar(False), o.q_end, o.t_begin, o.matches), (q, t)
assert pipe.served["oracle"] == 0, pipe.served
bound = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
               or m.startswith("wfa_tpu.") and m.split(".")[1] in {bound!r})
assert not bound, bound
print("no-jax run ok")
"""


def test_main_path_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN.format(bound=set(JAX_BOUND))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "no-jax run ok" in r.stdout
