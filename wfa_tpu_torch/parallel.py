"""Data-parallel execution over cards and processes, the PyTorch port of
:mod:`wfa_tpu.parallel`.

Pairwise alignment is embarrassingly parallel, so the one strategy is data
parallelism: a batch is packed once, as a whole (so that ``Lq``, ``Ltb``
and the token plan they set are batch-wide, as ``shard_map`` sees them),
split into equal shards along the batch axis, and each shard runs the whole
device path on its own device, with that device current and the launches
on its current stream.  The outputs are the 2-D layout of
``engine.align_full2(..., flat=False)``, which concatenates along the
batch axis as JAX's ``P("dp")`` specs do: ``mt`` (or the raw ``meta``,
``tok0``, ``tail``, ``final_s``) along axis 0, the raw ``buf`` along
axis 1.

A :class:`DpMesh` holds this process's shard devices.  A device may
repeat: shards that share a card (or the CPU) stand in for the virtual
devices XLA gives the JAX tests, and take the same code path as distinct
cards.  Shards on one card run on one stream, which hides a mistake in the
ordering across cards; the tests check that each shard's tensors go to its
own mesh device.

Across processes (:func:`initialize_distributed`, ``torch.distributed``
over gloo): every process holds the whole input, packs it whole, runs the
shards of its rank on its own devices, and all-gathers what crosses
processes, which is host data as in JAX (``_host_fetch``,
wfa_tpu/engine.py:79-99): the fetched outputs, and ``meta1`` at the
two-phase route's mid-point.  So each process returns every result, and
any number of processes may share one card.  The gathers run in the order
of the batches, the same in every process (:meth:`DpMesh.exchange`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build


# the process group's timeout unless the caller gives one
# (initialize_distributed)
DIST_TIMEOUT = datetime.timedelta(seconds=300)


class ShardError(Exception):
    """A failure, other than a device fault, of another process's shards:
    every process raises after the exchange, so that none waits in a later
    gather.  Also the failure of a gather itself (a peer process gone, or
    the process group's timeout), which no retry can mend."""


class DpMesh:
    """A 1-D data-parallel mesh: this process's shard devices (``devices``,
    in shard order; a device may repeat), this process's ``rank`` and the
    process count ``world``.  Process r holds global shards r * n ..
    (r + 1) * n - 1 of n local devices; :attr:`size` is the global shard
    count, the counterpart of ``mesh.devices.size``.

    ``launches[i]`` tallies the kernel launches of local shard i, by
    (wrapper, mode) as :func:`shard_launches` names them."""

    def __init__(self, devices: Sequence, rank: int = 0, world: int = 1):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.rank, self.world = rank, world
        self.launches = [{} for _ in self.devices]
        self.broken = None  # why a gather failed: the group is gone

    @property
    def size(self) -> int:
        return self.world * len(self.devices)

    def __repr__(self) -> str:
        return (f"DpMesh({[str(d) for d in self.devices]}, rank={self.rank},"
                f" world={self.world})")

    def shards(self, B: int) -> List[Tuple[int, torch.device, slice]]:
        """(local index, device, rows of the batch) of this process's
        shards of a batch of ``B`` rows."""
        lb = _local_b(B, self)
        n = len(self.devices)
        return [(i, d, slice((self.rank * n + i) * lb,
                             (self.rank * n + i + 1) * lb))
                for i, d in enumerate(self.devices)]

    @contextlib.contextmanager
    def on(self, i: int):
        """Local shard i's device as the thread's current one (nothing on
        the CPU), its launches tallied into ``launches[i]``."""
        dev = self.devices[i]
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx, _build.tally_launches(self.launches[i]):
            yield dev

    def exchange(self, fn: Callable):
        """``fn()`` here, then its result from every process, in rank order
        (an all-gather of host objects over the process group; one process:
        ``[fn()]``).  When ``fn`` fails in any process, every process
        raises after the gather, so that none waits in a later one: the
        failure itself where it happened, elsewhere a RuntimeError for a
        device fault (which the pipeline retries everywhere alike) and a
        :class:`ShardError` for any other.

        A gather that fails raises :class:`ShardError`, which the pipeline
        does not retry, here and in every later exchange of this mesh: a
        peer process gone (at once, its connections closed) or one that
        does not reach the gather within the process group's timeout
        (:func:`initialize_distributed`, 300 s by default)."""
        if self.world == 1:
            return [fn()]
        import torch.distributed as dist

        if self.broken is not None:
            raise ShardError(self.broken)
        err = None
        try:
            mine = (None, fn())
        except Exception as exc:  # re-raised below, after the gather
            err = exc
            mine = ((isinstance(exc, RuntimeError), repr(exc)), None)
        got = [None] * self.world
        try:
            dist.all_gather_object(got, mine)
        except RuntimeError as exc:  # gloo: a peer gone, or the timeout
            self.broken = (f"process {self.rank} of {self.world}: the "
                           f"gather failed: {exc}")
            raise ShardError(self.broken) from exc
        if err is not None:
            raise err
        for r, (fault, _) in enumerate(got):
            if fault is not None:
                kind = RuntimeError if fault[0] else ShardError
                raise kind(f"process {r} of {self.world}: {fault[1]}")
        return [res for _, res in got]


def _local_b(B: int, mesh: DpMesh) -> int:
    if B % mesh.size:
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size}")
    return B // mesh.size


def initialize_distributed(**kwargs) -> int:
    """Multi-process entry: ``torch.distributed.init_process_group`` over
    gloo (what crosses processes is host data), idempotent; returns the
    process count.  Without arguments it reads the environment ``torchrun``
    sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), the
    counterpart of ``JAX_COORDINATOR_ADDRESS``, and a single process (no
    ``WORLD_SIZE``, or 1) is a no-op.  Keyword arguments go to
    ``init_process_group`` (``init_method="tcp://localhost:<port>"``,
    ``world_size``, ``rank``, ``timeout``).  A group that cannot be formed
    raises.

    ``timeout`` (a ``datetime.timedelta``) bounds the group's forming and
    each gather: 300 s unless the caller gives one, the figure of
    ``jax.distributed.initialize``'s own initialization timeout (the JAX
    package's counterpart), in place of the process group's 30 minutes.
    A process whose peer has died then raises in its next
    :meth:`DpMesh.exchange`: a :class:`ShardError`, at once where the
    peer's connections closed, else once the timeout has passed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if not kwargs and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 1
    kwargs.setdefault("timeout", DIST_TIMEOUT)
    kwargs.setdefault("backend", "gloo")
    if "store" not in kwargs:
        kwargs.setdefault("init_method", "env://")
    dist.init_process_group(**kwargs)
    return dist.get_world_size()


def make_dp_mesh(n_devices: Optional[int] = None, devices=None,
                 device="cuda") -> DpMesh:
    """The data-parallel mesh over the first ``n_devices`` cards (None or
    0: all), or over ``devices``, this process's shard devices given
    outright (a device may repeat).  ``device="cpu"`` makes ``n_devices``
    virtual shards of the CPU (one when 0).  A card named by its index
    (``device="cuda:1"``) is a mesh of that card alone; asking it for more
    shards raises.

    Across processes ``n_devices`` counts the shards of all of them and
    must divide by the process count; each process takes its share of the
    cards from ``LOCAL_RANK`` on (``LOCAL_WORLD_SIZE`` processes a host,
    as ``torchrun`` sets them).  A mesh that cannot be built raises: more
    cards than there are, no card, or processes with unequal shard
    counts."""
    import torch.distributed as dist

    from .engine import resolve_device

    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_available() and dist.is_initialized()
                   else (0, 1))
    if devices is None:
        dev = resolve_device(device)
        if n_devices and n_devices % world:
            raise ValueError(f"{n_devices} shards over {world} processes")
        if dev.type == "cpu":
            devices = ["cpu"] * (n_devices // world if n_devices else 1)
        elif dev.index is not None:
            if (n_devices or world) != world:
                raise ValueError(
                    f"a mesh of {n_devices} cards and device={str(dev)!r}: "
                    "name the cards in devices")
            devices = [dev]
        else:
            have = torch.cuda.device_count()
            local_world = (int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
                           if world > 1 else 1)
            local_rank = (int(os.environ.get("LOCAL_RANK", "0"))
                          if world > 1 else 0)
            n = n_devices // world if n_devices else have // local_world
            first = local_rank * n
            if n < 1 or first + n > have:
                raise RuntimeError(
                    f"a mesh of {n_devices or 'all'} cards: process "
                    f"{local_rank} of {local_world} on this host needs "
                    f"cards {first}..{first + n - 1}, and {have} are here")
            devices = [torch.device("cuda", first + i) for i in range(n)]
    for d in map(torch.device, devices):
        resolve_device(d)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"no card {d} ({torch.cuda.device_count()} "
                               "here)")
    mesh = DpMesh(devices, rank, world)
    counts = mesh.exchange(lambda: len(mesh.devices))
    if len(set(counts)) > 1:
        raise RuntimeError(f"processes hold unequal shard counts {counts}")
    return mesh


def shard_launches(mesh: DpMesh) -> List[dict]:
    """Each local shard's kernel launches so far, as {wrapper: {mode: n}}
    with the wrappers named as ``chip_smoke.py`` names their counts."""
    from .device_backtrace import device_backtrace
    from .kernel_engine import (run_batch, run_batch_kw, run_batch_long,
                                run_prefix, run_resume)

    names = {id(run_batch.launches): "score_loop",
             id(run_batch_kw.launches): "score_loop_kw",
             id(run_batch_long.launches): "score_loop_long",
             id(run_prefix.launches): "score_loop_prefix",
             id(run_resume.launches): "score_loop_resume",
             id(device_backtrace.launches): "backtrace"}
    out = []
    for tally in mesh.launches:
        per = {}
        for (key, mode), n in sorted(tally.items(), key=str):
            per.setdefault(names.get(key, str(key)), {})[mode] = n
        out.append(per)
    return out


def _rows(a, rows: slice, dev: torch.device) -> torch.Tensor:
    """Rows of a host array (or CPU tensor) of the whole batch on
    ``dev``."""
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    return torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)


def dp_align_full_fn(cfg, mesh: DpMesh, B: int, Lq: int, Ltb: int,
                     engine: str = "auto", packed: bool = False):
    """The data-parallel full-alignment step, the counterpart of JAX's
    ``shard_map`` step (which JAX caches; here there is nothing costly to
    build).  It takes the whole batch's ``seq`` and ``lens`` on the host
    (as ``engine.align_full2`` takes them) and returns this process's
    shards' outputs, ``align_full2(..., flat=False)`` on each shard's
    device, in shard order."""
    from .engine import align_full2

    def fn(seq, lens):
        outs = []
        for i, dev, rows in mesh.shards(B):
            with mesh.on(i):
                outs.append(align_full2(
                    _rows(seq, rows, dev), _rows(lens, rows, dev), cfg=cfg,
                    B=rows.stop - rows.start, Lq=Lq, Ltb=Ltb, packed=packed,
                    engine=engine, flat=False))
        return outs

    return fn


def _gathered(mesh: DpMesh, outs: Sequence[dict]) -> dict:
    """This process's shards' outputs, fetched and joined with every
    other process's: the whole batch's outputs on the CPU, each along the
    batch axis (axis 1 for the raw ``buf``, as JAX's ``P(None, "dp",
    None)``)."""
    parts = mesh.exchange(lambda: [{k: v.cpu() for k, v in o.items()}
                                   for o in outs])
    outs = [o for part in parts for o in part]
    return {k: torch.cat([o[k] for o in outs], dim=1 if k == "buf" else 0)
            for k in outs[0]}


def dp_align_full(qb, tbuf, qlen, tlen, toff, *, cfg, mesh: DpMesh, Lq: int,
                  Ltb: int, engine: str = "auto", packed: bool = False
                  ) -> dict:
    """Full data-parallel alignment (score loop, backtrace, compaction) of
    a packed batch (``packed``: ``qb``/``tbuf`` 2-bit packed): the whole
    batch's 2-D outputs on the CPU, from every process's shards."""
    seq = np.concatenate([np.asarray(qb), np.asarray(tbuf)], axis=1)
    lens = np.stack([np.asarray(a, np.int32) for a in (qlen, tlen, toff)],
                    axis=1)
    fn = dp_align_full_fn(cfg, mesh, seq.shape[0], Lq, Ltb, engine, packed)
    return _gathered(mesh, fn(seq, lens))


def dp_semi2_prefix_fn(cfg, mesh: DpMesh, B: int, Lq: int, Ltb: int, S0: int,
                       K2: int, packed: bool):
    """The two-phase route's phase 1, data-parallel: K3 on each shard at
    the whole batch's shapes (``cfg.k_win`` the batch's full span); takes
    the whole batch's ``seq`` and ``lens`` and returns each local shard's
    export dict (``semi2.prefix_export``) on its device.  The mid-point
    (the ``meta1`` fetch and the targets' re-placement) runs on the whole
    batch, in the caller.  JAX's ``use_kernel`` / ``old_lanes`` (pairs on
    the lanes of a Mosaic tile) are not carried over."""
    from .semi2 import prefix_export

    def fn(seq, lens):
        outs = []
        for i, dev, rows in mesh.shards(B):
            with mesh.on(i):
                outs.append(prefix_export(
                    _rows(seq, rows, dev), _rows(lens, rows, dev), cfg=cfg,
                    Lq=Lq, Ltb=Ltb, S0=S0, K2=K2, packed=packed))
        return outs

    return fn


def dp_semi2_phase2_fn(cfg, mesh: DpMesh, B: int, Lq: int, Ltb_full: int,
                       Ltb2: int, S0: int, packed: bool):
    """The two-phase route's phase 2, data-parallel: K4 and K2 over both
    aux tensors on each shard, from the whole batch's re-placed ``seq2`` /
    ``lens2`` (``Ltb2`` batch-wide) and each local shard's exports;
    returns each shard's ``semi2.phase2(..., flat=False)`` outputs, the
    layout of :func:`dp_align_full_fn`."""
    from .semi2 import phase2

    names = ("win_m", "win_i", "win_d", "ainit", "b_m", "b_ie", "meta1",
             "aux_old")

    def fn(seq2, lens2, exports: Sequence[dict]):
        outs = []
        for (i, dev, rows), ex in zip(mesh.shards(B), exports):
            with mesh.on(i):
                outs.append(phase2(
                    _rows(seq2, rows, dev), _rows(lens2, rows, dev),
                    *(ex[k] for k in names), cfg=cfg, Lq=Lq,
                    Ltb_full=Ltb_full, Ltb2=Ltb2, S0=S0, packed=packed,
                    flat=False))
        return outs

    return fn


def _scores_by_shard(qb, tbuf, qlen, tlen, toff, cfg, mesh: DpMesh, Lq: int,
                     Ltb: int) -> list:
    """K1 (``kernel_engine.run_batch``) on each local shard of a packed
    batch of raw rows: each shard's result tuple, on the CPU."""
    from .kernel_engine import run_batch

    host = [np.asarray(a) for a in (qb, tbuf)] + [
        np.asarray(a, np.int32) for a in (qlen, tlen, toff)]
    outs = []
    for i, dev, rows in mesh.shards(host[0].shape[0]):
        with mesh.on(i):
            final_s, done, overflow, term_cell, aux, end = run_batch(
                *(_rows(a, rows, dev) for a in host), cfg=cfg, Lq=Lq,
                Ltb=Ltb)
        outs.append({"final_s": final_s, "done": done, "overflow": overflow,
                     "term_cell": term_cell, "aux": aux, "end_s": end[0],
                     "end_k": end[1], "end_cell": end[2]})
    return outs


def dp_align_scores(qb, tbuf, qlen, tlen, toff, *, cfg, mesh: DpMesh,
                    Lq: int, Ltb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores-only data-parallel alignment: (final_s, done) [B] of the
    whole batch on the CPU, K1 on every shard of every process."""
    outs = _scores_by_shard(qb, tbuf, qlen, tlen, toff, cfg, mesh, Lq, Ltb)
    st = _gathered(mesh, [{"final_s": o["final_s"], "done": o["done"]}
                          for o in outs])
    return st["final_s"], st["done"]


def dp_align_state(qb, tbuf, qlen, tlen, toff, *, cfg, mesh: DpMesh,
                   Lq: int, Ltb: int) -> Tuple[dict, int]:
    """K1 on every shard: the whole batch's per-pair state on the CPU and
    the count of pairs done, summed over the shards and all-reduced across
    processes (JAX's ``psum``).

    The state is what K1 exposes: ``final_s``, ``done``, ``overflow``,
    ``term_cell``, the backtrace start (``end_s``, ``end_k``,
    ``end_cell``) and ``aux`` [3, S, B, K] (joined along its batch axis,
    2); rows above a pair's final_s are unspecified.  JAX's lockstep
    histories (``hist_*``, the bands ``lo_*`` / ``hi_*``, ``ex_*``) exist
    only in the plain version, ``engine.run_batch_plain``, and are not
    part of it."""
    outs = _scores_by_shard(qb, tbuf, qlen, tlen, toff, cfg, mesh, Lq, Ltb)
    n_done = torch.tensor(sum(int(o["done"].sum()) for o in outs))
    parts = mesh.exchange(lambda: [{k: v.cpu() for k, v in o.items()}
                                   for o in outs])
    flat = [o for part in parts for o in part]
    st = {k: torch.cat([o[k] for o in flat], dim=2 if k == "aux" else 0)
          for k in flat[0]}
    if mesh.world > 1:
        import torch.distributed as dist

        dist.all_reduce(n_done)
    return st, int(n_done)
