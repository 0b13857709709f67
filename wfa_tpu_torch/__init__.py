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
* :mod:`wfa_tpu_torch.pipeline`      — bucketing and the tier ladder.

The host layers (constants, oracle, backtrace, cigar decode, io, datagen,
the native packer) are the port's own copies of the JAX package's and are
re-exported here.  Importing this package imports neither JAX nor
:mod:`wfa_tpu`.
"""

from .cigar import AlignmentResult
from .constants import (
    MAX_SEQ_LEN,
    AdaptiveReductionOption,
    EmptySeqError,
    Options,
    Penalties,
    SeqTooLongError,
)
from .oracle import Aligner as OracleAligner


def __getattr__(name):
    # the device stack loads torch on first touch
    if name in ("BatchAligner", "EngineConfig"):
        from . import engine

        return getattr(engine, name)
    if name in ("AlignmentPipeline", "PipelineConfig"):
        from . import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)


__all__ = [
    "AlignmentPipeline",
    "AlignmentResult",
    "AdaptiveReductionOption",
    "BatchAligner",
    "EngineConfig",
    "EmptySeqError",
    "MAX_SEQ_LEN",
    "Options",
    "OracleAligner",
    "Penalties",
    "PipelineConfig",
    "SeqTooLongError",
]
