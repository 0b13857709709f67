"""wfa_tpu_torch — the PyTorch / CUDA port of the batched WFA engine.

The JAX package :mod:`wfa_tpu` is the reference; this package reproduces
its global-alignment main path bit for bit on an NVIDIA H100:

* :mod:`wfa_tpu_torch.engine`        — packing, seed rows, stop tables, the
  lockstep plain score loop, output packing and :class:`BatchAligner`;
* :mod:`wfa_tpu_torch.kernel_engine` — kernel K1, the per-pair CUDA score
  loop (``csrc/score_loop.cu``);
* :mod:`wfa_tpu_torch.device_backtrace` — kernel K2, the per-pair CUDA
  backtrace (``csrc/backtrace.cu``), and the token compaction;
* :mod:`wfa_tpu_torch.pipeline`      — bucketing and the tier ladder.

The JAX-free host layers (constants, oracle, cigar decode, io, datagen,
native packer) are shared with :mod:`wfa_tpu` and re-exported here.
Importing this package never imports JAX.
"""

from wfa_tpu.cigar import AlignmentResult
from wfa_tpu.constants import (
    MAX_SEQ_LEN,
    AdaptiveReductionOption,
    EmptySeqError,
    Options,
    Penalties,
    SeqTooLongError,
)
from wfa_tpu.oracle import Aligner as OracleAligner


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
