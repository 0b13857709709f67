"""ctypes loader for the native host packer (``csrc/pack.c``).

:func:`load` compiles it on first use with the system C compiler into
``wfa_tpu_torch/build/`` (git-ignored; the library name carries a hash of
the source, so an edited source rebuilds).  Every consumer falls back to
the pure-numpy path when the toolchain or the build is unavailable
(:func:`load` returns None then), so the native layer is a pure
accelerator of a host path, never a requirement.  :func:`load` builds
under a lock: a thread that calls it while another builds waits for that
build instead of seeing None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from . import trace

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "pack.c")
_BUILD = os.path.join(_DIR, "build")

lib = None
_tried = False
_lock = threading.Lock()


def _build() -> str | None:
    """Path of the built library, building it if needed; None on failure."""
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        so = os.path.join(_BUILD, f"libwfa_pack_{digest}.so")
        if os.path.exists(so):
            return so
        os.makedirs(_BUILD, exist_ok=True)
        # per-process temp name: concurrent first-run builds must not
        # interleave writes into one .tmp and os.replace a corrupt .so
        tmp = f"{so}.{os.getpid()}.tmp"
        for cc in ("cc", "gcc", "clang"):
            try:
                r = subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                    capture_output=True, timeout=120)
            except FileNotFoundError:
                continue
            if r.returncode == 0:
                os.replace(tmp, so)
                return so
        return None
    except OSError:
        return None


def load():
    """The native library (built on the first call), or None."""
    global lib, _tried
    with _lock:
        if not _tried:
            lib = _load()
            _tried = True
        return lib


def _load():
    """Build and bind the library; None when it cannot be built."""
    so = _build()
    if so is None:
        return None
    try:
        l = ctypes.CDLL(so)
    except OSError:
        return None
    l.wfa_build_rows.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    l.wfa_build_rows.restype = None
    l.wfa_pack2.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_void_p]
    l.wfa_pack2.restype = ctypes.c_int32
    l.wfa_build_and_pack.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    l.wfa_build_and_pack.restype = ctypes.c_int32
    for fn in (l.wfa_pack_direct, l.wfa_pack_direct_scalar):
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int64
    l.wfa_pack_vector.argtypes = []
    l.wfa_pack_vector.restype = ctypes.c_int32
    return l


def build_and_pack(seqs, lens: np.ndarray, offs, L: int):
    """Build the zero-padded [B, L] row matrix for ``seqs`` (each placed
    at its row offset) and 2-bit-pack it.  Returns (raw, packed_or_None);
    ``packed`` is None when any sequence byte is not ACGT.  Requires the
    native library (callers check :func:`load`)."""
    B = len(seqs)
    raw = np.empty((B, L), np.uint8)
    packed = np.empty((B, L // 4), np.uint8)
    arr = (ctypes.c_char_p * B)(*seqs)
    lens = np.ascontiguousarray(lens, np.int32)
    offs_p = None
    if offs is not None:
        offs = np.ascontiguousarray(offs, np.int32)
        offs_p = offs.ctypes.data_as(ctypes.c_void_p)
    ok = lib.wfa_build_and_pack(
        arr, lens.ctypes.data_as(ctypes.c_void_p), offs_p,
        B, L, raw.ctypes.data_as(ctypes.c_void_p),
        packed.ctypes.data_as(ctypes.c_void_p))
    return raw, (packed if ok else None)


def pack_direct(seqs, lens: np.ndarray, offs, L: int, out=None):
    """2-bit-pack straight from the source strings — no raw matrix
    (the pipeline hot path never reads the raw rows of a pure-ACGT
    batch, and skipping them saves ~4x the host memory traffic), with
    the vector body where the CPU has one.  ``out``: the uint8[B, L // 4]
    array to pack into (a column range of a wider matrix does; a new one
    when None).  Returns it, or None (non-ACGT: caller falls back to
    :func:`build_and_pack`).  Counts the bases packed in the bound call's
    record (``packed_bases``, and ``packed_vec_bases`` when the vector
    body packed them)."""
    got = _pack(lib.wfa_pack_direct, seqs, lens, offs, L, out)
    if got is None:
        return None
    out, bases = got
    trace.count(trace.PACKED_BASES, bases)
    if lib.wfa_pack_vector():
        trace.count(trace.PACKED_VEC_BASES, bases)
    return out


def _pack(fn, seqs, lens: np.ndarray, offs, L: int, out=None):
    """(out, bases packed) of the direct pack ``fn`` (``wfa_pack_direct``
    or ``wfa_pack_direct_scalar``), or None for a non-ACGT batch."""
    B = len(seqs)
    if out is None:
        out = np.empty((B, L // 4), np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (B, L // 4)
          or out.strides[1] != 1):
        raise ValueError("pack_direct: out must be uint8[B, L // 4] with "
                         "contiguous rows")
    arr = (ctypes.c_char_p * B)(*seqs)
    lens = np.ascontiguousarray(lens, np.int32)
    offs_p = None
    if offs is not None:
        offs = np.ascontiguousarray(offs, np.int32)
        offs_p = offs.ctypes.data_as(ctypes.c_void_p)
    bases = fn(arr, lens.ctypes.data_as(ctypes.c_void_p), offs_p, B, L,
               out.strides[0], out.ctypes.data_as(ctypes.c_void_p))
    return None if bases < 0 else (out, bases)
