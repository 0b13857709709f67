"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source (one process each, started
together) and links them into one shared library with a plain C
interface for Hopper (``sm_90a``), in ``wfa_tpu_torch/build/``
(git-ignored), and ``ctypes`` loads it.  The
library name carries a hash of the sources, so an edited kernel
rebuilds.  Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.
A kernel that does not build, or a launch the kernel or the CUDA runtime
refuses, raises :class:`KernelError`, which is not a RuntimeError, so the
pipeline's device-fault retry never hands it to the oracle; a fault of
the device at run time (an allocation, an earlier kernel's bad address)
raises RuntimeError, as PyTorch's own CUDA errors do.
Nothing here runs at import time: the CPU tests import every module.
The pipeline's submit workers call :func:`library` and :func:`count`
from several threads at once, so both hold a lock.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: every pointer and the stream are c_void_p, every
# scalar a c_int (ctypes would otherwise cut a pointer to 32 bits)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
    # min_wf_len, max_dist_diff, mode, kw, pairs, win, out, aux, aux_base,
    # stream
    "wfa_score_loop": [_P] * 5 + [_I] * 14 + [_P] * 5,
    # wfa_score_loop's, then cycles before the stream
    "wfa_score_loop_phases": [_P] * 5 + [_I] * 14 + [_P] * 6,
    # qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S0, Kf, K2, x, oe, e,
    # reduce_on, min_wf_len, max_dist_diff, cell16, threads, cluster, win,
    # aux_old, win_m, win_i, win_d, ainit, b_m, b_ie, meta1, cycles, stream
    "wfa_prefix": [_P] * 5 + [_I] * 15 + [_P] * 11,
    # K, x, oe, e, cell16, threads, cluster, scratch: K3's dynamic shared
    # memory
    "wfa_prefix_shared": [_I] * 8,
    # qb, tbuf2, qlen, tlen, toff2, B, Lq, Ltb2, S, S0, K, x, oe, e,
    # reduce_on, min_wf_len, max_dist_diff, cell16, pairs, win, out, aux2,
    # win_m, win_i, win_d, ainit, b_m, b_ie, meta1, cycles, stream
    "wfa_resume": [_P] * 5 + [_I] * 14 + [_P] * 12,
    # K, x, oe, e, mode (wfa_score_loop's 0-3 and 8, 4 K3, 5 K4, 6 K3
    # int16, 7 K4 int16), *shared
    "wfa_workspace": [_I] * 5 + [ctypes.POINTER(_I)],
    # K, x, oe, e, mode (3, 8 K1-kw, 5, 7 K4), pairs, scratch: the dynamic
    # shared memory of a K1-kw or K4 launch
    "wfa_warp_shared": [_I] * 7,
    # aux, aux_c16, aux_base, sbase, aux_old, old_c16, s_split, Kf,
    # k0_old, start_cell, k0, start_s, start_k, qlen, tlen, active0, B, S,
    # K, x, oe, e, it_cap, token_shift, split, semi, tok0, buf, tail, iters,
    # stream
    "wfa_backtrace": ([_P, _I, _P, _P, _P, _I, _I, _I] + [_P] * 8
                      + [_I] * 10 + [_P] * 5),
}

# cudaError_t codes of device faults at run time: cudaErrorMemoryAllocation,
# then the sticky faults an earlier kernel leaves (illegal address, launch
# timeout, assert, stack, instruction, misaligned or bad address space,
# bad PC, launch failure).  Any other code is a refused launch.
DEVICE_FAULTS = frozenset((2, 700, 702, 710, 714, 715, 716, 717, 718, 719))


class KernelError(Exception):
    """A kernel that did not build, or a launch that was refused (a bad
    size or configuration, no image for the card): a fault of the code,
    never retried."""


_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_tally = threading.local()  # a thread's open tallies (tally_launches)
build_seconds = None  # wall time of the nvcc run (None: loaded cached)
build_log = ""  # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError("nvcc not found: the CUDA kernels build only "
                          "where the CUDA toolkit is installed")
    return path


def library() -> ctypes.CDLL:
    """The kernel library, built on the first call (once, whichever
    thread calls first; the others wait for that build)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = build(SRC_DIR)
        return _lib


def count(launches: dict, mode: str) -> None:
    """Add one to a wrapper's launch count ``launches[mode]`` (and to
    each tally the calling thread has open, :func:`tally_launches`)."""
    with _count_lock:
        launches[mode] += 1
        key = (id(launches), mode)
        for tally in getattr(_tally, "open", ()):
            tally[key] = tally.get(key, 0) + 1


@contextlib.contextmanager
def tally_launches(into: dict):
    """Within the block, every launch the calling thread counts is also
    added to ``into``, keyed by (id of the wrapper's count dict, mode): a
    data-parallel shard's own launches, a batch's (``trace.batch``).
    Tallies nest: a launch goes to every one that is open."""
    before = getattr(_tally, "open", ())
    _tally.open = before + (into,)
    try:
        yield into
    finally:
        _tally.open = before


def build(src_dir: Path) -> ctypes.CDLL:
    """Build (or load the cached build of) the ``*.cu`` sources of
    ``src_dir`` into one library in ``BUILD_DIR`` and bind the C entries
    it has.  :func:`library` builds the package's own; the phase profile
    builds a second library from another copy of the sources to time the
    two in turns.  Raises KernelError when nvcc is missing or fails."""
    global build_seconds, build_log
    src_dir = Path(src_dir)
    sources = sorted(src_dir.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sorted(src_dir.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    so = BUILD_DIR / f"libwfa_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all at once, then one link
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
            build_log = "".join(p.communicate()[0] for p in procs)
            failed = [p.returncode for p in procs if p.returncode != 0]
            if failed:
                raise KernelError(f"nvcc failed ({failed}):\n{build_log}")
            r = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log += r.stdout + r.stderr
            if r.returncode != 0:
                raise KernelError(f"nvcc link failed ({r.returncode}):\n"
                                  f"{build_log}")
            os.replace(tmp, so)
        finally:
            for path in (*objs, tmp):
                path.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_inputs(fn: str, device: torch.device, **tensors) -> None:
    """Raise unless every (tensor, dtype, shape) lies on ``device`` with
    that dtype and shape and is contiguous."""
    if device.type != "cuda":
        raise ValueError(f"{fn}: expected CUDA tensors, got {device}")
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{fn}: {name} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def launch(name: str, *args) -> None:
    """Call the C entry ``name`` of :func:`library`; tensors pass as device
    pointers, None as a null pointer.  Raises RuntimeError if the launch
    reported a device fault (``DEVICE_FAULTS``), KernelError for any other
    CUDA error: a launch the kernel or the CUDA runtime refused."""
    argv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    err = getattr(library(), name)(*argv)
    if err in DEVICE_FAULTS:
        raise RuntimeError(f"{name}: CUDA error {err} (a device fault)")
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err}: the launch was refused")
