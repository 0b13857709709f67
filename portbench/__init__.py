"""The benchmark of the PyTorch / CUDA port, ``wfa_tpu_torch``.

``python3 -m portbench.run`` runs one cell of ``BENCHMARK.json``; the
configurations, traffic mixes and per-layer metrics it finds by name
under ``configs/``, ``traffic/`` and ``metrics/``; ``reference/`` is the
plain aligner that decides ``correct``; ``control.py`` runs the control
that must come out not correct.  Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the port.
"""
