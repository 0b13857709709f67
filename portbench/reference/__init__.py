"""The plain reference that decides a run's ``correct``: a frozen, scalar
gap-affine wavefront aligner in Python and NumPy (:mod:`.wfa`).

It imports nothing of the measured program, of the JAX package or of
JAX, and recomputes every answer from the input pair alone.
"""

from .wfa import Aligner, answer

__all__ = ["Aligner", "answer"]
