"""PyTorch port vs the JAX package: the device backtrace and the token
compaction, fed the same lockstep aux tensor.  Integer outputs, exact
equality."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wfa_tpu import AdaptiveReductionOption, Options, Penalties
from wfa_tpu import device_backtrace as jdb
from wfa_tpu.engine import BatchAligner as JaxBatchAligner
from wfa_tpu.engine import _run_batch
from wfa_tpu_torch import device_backtrace as tdb
from wfa_tpu_torch import engine as te

from test_pallas_engine import random_pairs

torch.set_num_threads(2)


def _aux_batch(seed, penalties, ga=True):
    """The JAX lockstep aux of a random batch and the backtrace's inputs;
    a semi-global batch starts from the JAX end finder's pick."""
    pairs = random_pairs(random.Random(seed), 12, 80)
    jb = JaxBatchAligner(penalties, Options(ga),
                         AdaptiveReductionOption(10, 50, 1),
                         k_win=128 if ga else 256, s_cap=128, engine="jax")
    packed = jb.pack_batch(pairs)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = packed
    st = _run_batch(*(jnp.asarray(a) for a in packed[:5]), cfg=jb.cfg,
                    B=len(pairs), Lq=Lq, Ltb=Ltb)
    aux = np.stack([np.asarray(st.aux_m), np.asarray(st.aux_i),
                    np.asarray(st.aux_d)])
    final_s = np.asarray(st.final_s)
    k0 = -toff.astype(np.int32)
    qlen, tlen = qlen.astype(np.int32), tlen.astype(np.int32)
    start_s, start_k = final_s, (tlen - qlen).astype(np.int32)
    if not ga:
        start_s, start_k, _ = (np.asarray(a) for a in jdb.end_finder(
            st.hist_m, jnp.asarray(k0), st.final_s, jnp.asarray(qlen),
            jnp.asarray(tlen), jb.cfg.s_cap, jb.cfg.k_win))
    b = np.arange(len(pairs))
    start_cell = np.asarray(st.hist_m)[start_s, b, start_k - k0]
    active0 = np.asarray(st.done) & ~np.asarray(st.overflow)
    args = (aux, start_cell, k0, start_s, start_k, qlen, tlen, active0)
    return jb.cfg, tuple(np.array(a, dtype=a.dtype) for a in args)


@pytest.mark.parametrize("penalties", [Penalties(4, 6, 2), Penalties(2, 3, 1)],
                         ids=["4-6-2", "2-3-1"])
@pytest.mark.parametrize("split", [True, False], ids=["split", "plain_codes"])
def test_device_backtrace_plain_matches_jax(penalties, split):
    cfg, args = _aux_batch(5, penalties)
    for token_shift in (12, 28):
        kw = dict(penalties=penalties, S=cfg.s_cap, K=cfg.k_win,
                  token_shift=token_shift, split_ext_codes=split)
        jout = jdb.device_backtrace(*(jnp.asarray(a) for a in args),
                                    global_alignment=True, **kw)
        tout = tdb.device_backtrace(*(torch.from_numpy(a) for a in args),
                                    **kw)
        for a, b in zip(jout[:3], tout):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
        # the compaction of those streams, with and without match runs
        for drop_m in (True, False):
            jc = jdb.compact_tokens_flat_u8(*jout[:3], token_shift, drop_m)
            tc = tdb.compact_tokens_flat_u8(*tout, token_shift, drop_m)
            for a, b in zip(jc, tc):
                a = np.asarray(a)
                assert a.dtype == b.numpy().dtype
                assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("penalties", [Penalties(4, 6, 2), Penalties(2, 3, 1)],
                         ids=["4-6-2", "2-3-1"])
def test_device_backtrace_plain_semi_matches_jax(penalties):
    """The semi-global chase (full token codes, stop on the first row or
    column) and its compaction with the match runs kept."""
    cfg, args = _aux_batch(7, penalties, ga=False)
    assert args[-1].all()
    for token_shift in (12, 28):
        kw = dict(penalties=penalties, S=cfg.s_cap, K=cfg.k_win,
                  token_shift=token_shift)
        jout = jdb.device_backtrace(*(jnp.asarray(a) for a in args),
                                    global_alignment=False, **kw)
        tout = tdb.device_backtrace(*(torch.from_numpy(a) for a in args),
                                    global_alignment=False, **kw)
        for a, b in zip(jout[:3], tout):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
        jc = jdb.compact_tokens_flat_u8(*jout[:3], token_shift, False)
        tc = tdb.compact_tokens_flat_u8(*tout, token_shift, False)
        for a, b in zip(jc, tc):
            assert np.array_equal(np.asarray(a), b.numpy())


def test_end_finder_plain_matches_jax():
    """end_finder_plain equals wfa_tpu.device_backtrace.end_finder on a
    semi-global JAX history, every pair (fallbacks included)."""
    pairs = random_pairs(random.Random(9), 12, 80)
    jb = JaxBatchAligner(Penalties(4, 6, 2), Options(False),
                         AdaptiveReductionOption(10, 50, 1), k_win=256,
                         s_cap=40, engine="jax")
    packed = jb.pack_batch(pairs)
    st = _run_batch(*(jnp.asarray(a) for a in packed[:5]), cfg=jb.cfg,
                    B=len(pairs), Lq=packed[5], Ltb=packed[6])
    k0 = -packed[4].astype(np.int32)
    qlen, tlen = (packed[i].astype(np.int32) for i in (2, 3))
    S, K = jb.cfg.s_cap, jb.cfg.k_win
    jout = jdb.end_finder(st.hist_m, jnp.asarray(k0), st.final_s,
                          jnp.asarray(qlen), jnp.asarray(tlen), S, K)
    tout = tdb.end_finder_plain(
        torch.from_numpy(np.array(st.hist_m)), torch.from_numpy(k0),
        torch.from_numpy(np.array(st.final_s)), torch.from_numpy(qlen),
        torch.from_numpy(tlen), S, K)
    for a, b in zip(jout, tout):
        assert np.array_equal(np.asarray(a), b.numpy())
    found = tout[2].numpy()
    assert found.any() and (~found).any()  # both branches


def test_iter_capacity_matches_jax():
    for p in (Penalties(4, 6, 2), Penalties(2, 3, 1), Penalties(1, 2, 2)):
        for s_cap in (8, 128, 640):
            assert (tdb.iter_capacity(s_cap, p)
                    == jdb.iter_capacity(s_cap, p))


def test_token_plan_matches_jax():
    from wfa_tpu.engine import _token_plan

    for s_cap, lq, ltb in ((128, 128, 256), (640, 1024, 1152),
                           (4400, 1024, 3200), (40000, 4096, 8192)):
        p = Penalties(4, 6, 2)
        assert (te._token_plan(s_cap, p, lq, ltb)
                == _token_plan(s_cap, p, lq, ltb))
