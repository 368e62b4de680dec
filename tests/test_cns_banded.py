"""Banded tag emission vs the op-tape oracle: exact counts equality.

The banded route (ops/consensus_banded.py) replaces the column-walk
traceback + presence scatter of ops/consensus_device.accumulate_tags with
gather/scatter-free row walks and sliding-band planes; the two must produce
EXACTLY equal tag tables on identical alignments (and the row-walk itself
must reproduce the column walk's op tapes bit for bit).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from mecat_jax import constants as C
from mecat_jax.ops.align import (banded_dp_segment, extend_pair_batch_rows,
                                 extend_pair_batch_with_ops, max_tape_cols,
                                 pick_end_local, rows_to_tape, traceback_ops,
                                 traceback_rows, Q_SENTINEL, T_SENTINEL)
from mecat_jax.ops.consensus_banded import banded_accumulate_tags
from mecat_jax.ops.consensus_device import accumulate_tags
from mecat_jax.utils.sim import mutate, random_genome


def _pile(S, W, G, B, L_t, L_s, T, err, seed, ins_heavy=False):
    rng = np.random.default_rng(seed)
    tmpl = random_genome(L_t - int(rng.integers(1, 40)), seed=seed + 1)
    q = np.zeros((B, L_s), np.uint8)
    t = np.zeros((B, L_t), np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    qs = np.zeros(B, np.int32)
    ts = np.zeros(B, np.int32)
    t_slot = rng.integers(0, T, size=B).astype(np.int32)
    for b in range(B):
        a = int(rng.integers(0, max(len(tmpl) - 50, 1)))
        bb = int(rng.integers(a + 30, len(tmpl) + 1))
        pins = err * (3.0 if ins_heavy else 1.0)
        sup = mutate(tmpl[a:bb], rng, err, pins, err)[:L_s]
        t[b, :len(tmpl)] = tmpl
        q[b, :len(sup)] = sup
        qlen[b], tlen[b] = len(sup), len(tmpl)
        mid = int(rng.integers(0, max(len(sup) - 1, 1)))
        qs[b] = mid
        ts[b] = min(max(a + mid, 0), len(tmpl) - 1)
    return (jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen),
            jnp.asarray(tlen), jnp.asarray(qs), jnp.asarray(ts),
            jnp.asarray(t_slot))


@pytest.mark.parametrize("kw", [
    dict(S=64, W=32, G=4, B=32, L_t=256, L_s=320, T=8, err=0.12, seed=11),
    dict(S=64, W=32, G=6, B=48, L_t=320, L_s=512, T=6, err=0.15, seed=12,
         ins_heavy=True),
    dict(S=32, W=32, G=8, B=32, L_t=300, L_s=400, T=6, err=0.2, seed=40,
         ins_heavy=True),
])
def test_banded_equals_tape_counts(kw):
    S, W, G, T, L_t = kw["S"], kw["W"], kw["G"], kw["T"], kw["L_t"]
    q, t, qlen, tlen, qs, ts, t_slot = _pile(**kw)
    pa, rt, lt = extend_pair_batch_with_ops(
        q, t, qlen, tlen, qs, ts, S=S, W=W, max_segs=G, max_segs_left=G)
    pa2, rr, lr = extend_pair_batch_rows(
        q, t, qlen, tlen, qs, ts, S=S, W=W, max_segs=G, max_segs_left=G)
    assert np.array_equal(np.asarray(pa.identity), np.asarray(pa2.identity))
    pair_ok = jnp.asarray(
        np.asarray((pa.identity >= 60.0) & ((pa.tend - pa.tbeg) >= 20)))
    D1 = C.MAX_INS_DELTA + 1
    z = lambda: (jnp.zeros((T, L_t, D1, 5), jnp.int32),
                 jnp.zeros((T, L_t + 1), jnp.int32))
    c0, v0 = z()
    ca, va = accumulate_tags(c0, v0, rt, lt, qs, ts, q, qlen, tlen, t_slot,
                             pair_ok, pa.tbeg, pa.tend, L_t=L_t)
    c1, v1 = z()
    cb, vb = banded_accumulate_tags(c1, v1, rr, lr, qs, ts, q, tlen, t_slot,
                                    pair_ok, pa2.tbeg, pa2.tend,
                                    L_t=L_t, S=S, W=W)
    assert np.array_equal(np.asarray(ca), np.asarray(cb))
    assert np.array_equal(np.asarray(va), np.asarray(vb))


def test_row_walk_equals_column_walk():
    S, W, B = 128, 32, 48
    rng = np.random.default_rng(3)
    q = np.full((B, S), Q_SENTINEL, np.uint8)
    t = np.full((B, S + W // 2), T_SENTINEL, np.uint8)
    tmax = np.zeros(B, np.int32)
    seg_q = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(0, S + 1))
        m = int(rng.integers(0, S + W // 2 + 1))
        base = random_genome(max(n + W, m, 8), seed=100 + b)
        qb = mutate(base[:n], rng, 0.1, 0.1, 0.1)[:n] if n else \
            np.zeros(0, np.uint8)
        q[b, :len(qb)] = qb
        t[b, :m] = base[:m]
        seg_q[b], tmax[b] = len(qb), m
    rows, moves = banded_dp_segment(jnp.asarray(q), jnp.asarray(t),
                                    jnp.asarray(tmax), W)
    r_end, w_end, _, d, _ = pick_end_local(rows, jnp.asarray(seg_q),
                                           jnp.asarray(tmax), W)
    TC = max_tape_cols(S, W, 0.65)
    ops0, qi0, tj0, n0 = traceback_ops(moves, r_end, w_end, W, max_cols=TC)
    mv, h, wo, w0 = traceback_rows(moves, r_end, w_end, W)
    ops1, qi1, tj1, n1 = rows_to_tape(mv, h, w0, W, TC)
    valid = np.asarray(d) < (1 << 20)   # endpoint-gated lanes may diverge
    for a, b in ((ops0, ops1), (qi0, qi1), (tj0, tj1)):
        assert np.array_equal(np.asarray(a)[valid], np.asarray(b)[valid])
    assert np.array_equal(np.asarray(n0)[valid], np.asarray(n1)[valid])


def test_banded_equals_tape_clipped_windows():
    """Window-clipped supports (qlen > L_s, w0 > 0): the config class the
    full-scale run exercises but small tests missed (support reads longer
    than the seed-centred window)."""
    import jax

    from mecat_jax.pipeline.cns import make_cns_chunk

    P, L_t, L_s = 16, 1024, 2048
    S, W, G = 256, 64, 6
    rng = np.random.default_rng(9)
    tmpl = random_genome(L_t - 40, seed=43)
    sup_list = []
    for p in range(P):
        a = int(rng.integers(0, len(tmpl) // 2))
        b = int(rng.integers(a + 500, len(tmpl) + 1))
        core = mutate(tmpl[a:b], rng, 0.04, 0.05, 0.04)
        lf = random_genome(int(rng.integers(1500, 2500)), seed=1000 + p)
        rf = random_genome(int(rng.integers(1500, 2500)), seed=2000 + p)
        sup_list.append((np.concatenate([lf, core, rf]),
                         len(lf) + (b - a) // 2, a + (b - a) // 2))
    qlen = np.array([len(s[0]) for s in sup_list], np.int32)
    assert qlen.max() > L_s  # windows really clip
    reads = [tmpl] + [s[0] for s in sup_list]
    lens_v = np.array([len(r) for r in reads], np.int64)
    starts_v = np.concatenate([[0], np.cumsum(lens_v)[:-1]])
    n_bases = int(lens_v.sum())
    fwd = np.concatenate(reads)
    vol_cat = jnp.asarray(np.concatenate(
        [fwd, (3 - fwd[::-1]), np.zeros(L_s + 1024, np.uint8)]))
    s_ids = jnp.asarray(np.arange(1, P + 1, dtype=np.int32))
    t_ids = jnp.zeros(P, jnp.int32)
    t_slot = jnp.asarray((np.arange(P) % 4).astype(np.int32))
    tlen = jnp.asarray(np.full(P, len(tmpl), np.int32))
    qs = jnp.asarray(np.array([s[1] for s in sup_list], np.int32))
    ts = jnp.asarray(np.array([min(s[2], len(tmpl) - 1) for s in sup_list],
                              np.int32))
    D1 = C.MAX_INS_DELTA + 1
    T = 4
    outs = {}
    for mode in ("tape", "banded"):
        chunk = jax.jit(make_cns_chunk(
            L_s=L_s, L_t=L_t, S=S, W=W, max_segs=G, max_segs_left=G,
            min_identity=60.0, min_align_size=200, min_mapping_ratio=0.05,
            tags=mode))
        for sd in (0, 1):
            c, v, h = chunk(
                jnp.zeros((T, L_t, D1, 5), jnp.int32),
                jnp.zeros((T, L_t + 1), jnp.int32), jnp.zeros(T, bool),
                vol_cat, jnp.asarray(starts_v.astype(np.int32)),
                jnp.asarray(lens_v.astype(np.int32)), np.int32(n_bases),
                s_ids, t_ids, jnp.asarray(qlen), tlen, qs, ts, t_slot,
                jnp.full(P, sd, jnp.int32), jnp.ones(P, bool))
            outs[(mode, sd)] = (np.asarray(c), np.asarray(v), np.asarray(h))
    assert outs[("tape", 0)][0].sum() > 10_000  # real tag mass landed
    for sd in (0, 1):
        for a, b in zip(outs[("tape", sd)], outs[("banded", sd)]):
            assert np.array_equal(a, b)
