"""wfa_tpu_torch — the PyTorch / CUDA port of the batched WFA engine.

The JAX package :mod:`wfa_tpu` is the reference; this package reproduces
its global and semi-global paths bit for bit on an NVIDIA H100, and
imports nothing of it:

* :mod:`wfa_tpu_torch.engine`        — packing, seed rows, stop tables, the
  lockstep plain score loop and its value-rebased long-read form, output
  packing and :class:`BatchAligner`;
* :mod:`wfa_tpu_torch.kernel_engine` — kernel K1, the per-pair CUDA score
  loop (``csrc/score_loop.cu``), and its long-read form K1-long;
* :mod:`wfa_tpu_torch.device_backtrace` — kernel K2, the per-pair CUDA
  backtrace (``csrc/backtrace.cu``), and the token compaction;
* :mod:`wfa_tpu_torch.pipeline`      — bucketing and the tier ladder;
* :mod:`wfa_tpu_torch.parallel`      — data parallelism over cards and
  processes;
* :mod:`wfa_tpu_torch.cli`           — the ``wfa-tpu`` command-line tool
  (``python -m wfa_tpu_torch.cli``).

The host layers (constants, oracle, backtrace, cigar decode, io, datagen,
plot, the native packer, the Gotoh score check :mod:`wfa_tpu_torch.dp`)
are the port's own copies of the JAX package's,
and the package exports what :mod:`wfa_tpu` exports.  Importing this
package imports neither JAX nor :mod:`wfa_tpu`.
"""

from .cigar import AlignmentResult
from .constants import (
    DEFAULT_ADAPTIVE,
    DEFAULT_OPTIONS,
    DEFAULT_PENALTIES,
    MAX_SEQ_LEN,
    AdaptiveReductionOption,
    EmptySeqError,
    Options,
    Penalties,
    SeqTooLongError,
)
from .oracle import Aligner as OracleAligner
from .oracle import align as oracle_align

__version__ = "0.3.0"


def __getattr__(name):
    # the device stack loads torch on first touch
    if name in ("BatchAligner", "EngineConfig"):
        from . import engine

        return getattr(engine, name)
    if name in ("AlignmentPipeline", "PipelineConfig"):
        from . import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)


# -- recycling API parity (wfa_tpu/__init__.py:52-80) -----------------------
# The reference exposes sync.Pool-based object recycling as part of its API
# contract (README.md:82-84, 207-214; wfa.go:102, wfa_cigar.go:92); nothing
# here is pooled, so these are no-ops that let reference callers port code
# unchanged.

def recycle_aligner(aligner) -> None:
    """No-op (RecycleAligner, wfa.go:102): nothing to pool here."""


def recycle_alignment_result(result) -> None:
    """No-op (RecycleAlignmentResult, wfa_cigar.go:92)."""


def recycle_alignment_text(q, a, t) -> None:
    """No-op (RecycleAlignmentText, wfa_cigar.go:347)."""


def recycle_component(component) -> None:
    """No-op (RecycleComponent, wfa_component.go:74)."""


def recycle_wave_front(wavefront) -> None:
    """No-op (RecycleWaveFront, wfa_wavefront.go:70)."""


__all__ = [
    "AlignmentPipeline",
    "AlignmentResult",
    "AdaptiveReductionOption",
    "BatchAligner",
    "EngineConfig",
    "PipelineConfig",
    "DEFAULT_ADAPTIVE",
    "DEFAULT_OPTIONS",
    "DEFAULT_PENALTIES",
    "EmptySeqError",
    "MAX_SEQ_LEN",
    "Options",
    "OracleAligner",
    "Penalties",
    "SeqTooLongError",
    "oracle_align",
    "recycle_aligner",
    "recycle_alignment_result",
    "recycle_alignment_text",
    "recycle_component",
    "recycle_wave_front",
]
