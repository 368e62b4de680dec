"""Banded aligner tests: exact agreement with NumPy edit-distance DP."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from mecat_jax.ops.align import (IND_K, INF, VINF, banded_dp_segment,
                                 extend_pair_batch, traceback_counts,
                                 Q_SENTINEL, T_SENTINEL)
from mecat_jax.io.packed_db import revcomp
from mecat_jax.utils.sim import mutate, random_genome

W, S = 32, 64



# Test-local reference model: simplest endpoint rule (best band cell on the
# row where the query runs out).  The product path uses pick_end_local's
# stop-on-degradation scoring; this minimal rule pins the DP/traceback
# bookkeeping invariants independent of that policy.
def pick_end(rows: jnp.ndarray, seg_qlen: jnp.ndarray, tmax: jnp.ndarray,
             W: int):
    """Best band cell on the row where the segment's query chars run out.

    Tie-break: minimal (distance, indels), then target advance closest to
    the query advance (stay near the main diagonal).  TODO(ref): reference
    tie-breaking unknown (mount empty); "modulo tie-breaking" per
    BASELINE.json.
    """
    B = rows.shape[0]
    half = W // 2
    w_idx = jnp.arange(W, dtype=jnp.int32)
    last = jnp.take_along_axis(
        rows, seg_qlen[:, None, None].astype(jnp.int32), axis=1)[:, 0, :]
    j = seg_qlen[:, None] - half + w_idx[None, :]
    valid = (j >= 0) & (j <= tmax[:, None])
    val = jnp.where(valid, last, VINF)
    # lexicographic (val, |w-half|): scale by 2W without overflow by
    # comparing float64-free: use (val - min) trick is overkill; val < 2^23
    # in practice so val*(2W) stays in int32 for W <= 128.
    key = val * (2 * W) + jnp.abs(w_idx[None, :] - half)
    key = jnp.where(val >= VINF, jnp.int32(2 ** 31 - 1), key)
    w_best = jnp.argmin(key, axis=1).astype(jnp.int32)
    v_best = jnp.take_along_axis(val, w_best[:, None], axis=1)[:, 0]
    d_best = jnp.where(v_best >= VINF, INF, v_best // IND_K)
    j_best = seg_qlen - half + w_best
    return w_best, j_best, d_best

def levenshtein_row(q, t):
    """Full DP table, returns D[len(q)][j] row (NumPy reference)."""
    n, m = len(q), len(t)
    D = np.zeros((n + 1, m + 1), dtype=np.int32)
    D[0, :] = np.arange(m + 1)
    D[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                          D[i - 1, j - 1] + (q[i - 1] != t[j - 1]))
    return D


def make_pair(rng, n, err):
    q = rng.integers(0, 4, size=n, dtype=np.uint8)
    t = mutate(q, rng, err / 3, err / 3, err / 3)
    return q, t


def pad_batch(seqs, L, sentinel):
    out = np.full((len(seqs), L), sentinel, dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s[:L]
    return out


def test_banded_matches_full_dp():
    rng = np.random.default_rng(31)
    qs, ts = [], []
    for _ in range(6):
        q, t = make_pair(rng, S - 10, 0.08)
        qs.append(q)
        ts.append(t)
    qlen = np.array([len(q) for q in qs], np.int32)
    tlen = np.array([min(len(t), S + W // 2) for t in ts], np.int32)
    qb = pad_batch(qs, S, Q_SENTINEL)
    tb = pad_batch(ts, S + W // 2, T_SENTINEL)
    rows, moves = banded_dp_segment(jnp.asarray(qb), jnp.asarray(tb),
                                    jnp.asarray(tlen), W)
    rows = np.asarray(rows) // IND_K  # packed val -> edit distance
    half = W // 2
    for b in range(len(qs)):
        D = levenshtein_row(qs[b], ts[b][:tlen[b]])
        n = qlen[b]
        for j in range(max(0, n - half), min(tlen[b], n + half - 1) + 1):
            w = j - n + half
            if 0 <= w < W:
                # banded >= full DP; equal when the band covers the opt path
                assert rows[b, n, w] >= D[n, j]
        # on low-error pairs the optimal path stays in the band
        j_true = tlen[b]
        w = j_true - n + half
        if 0 <= w < W:
            assert rows[b, n, w] == D[n, j_true]


def test_traceback_consistency():
    rng = np.random.default_rng(33)
    qs, ts = [], []
    for _ in range(8):
        q, t = make_pair(rng, S - 8, 0.1)
        qs.append(q)
        ts.append(t)
    qlen = jnp.asarray([len(q) for q in qs], jnp.int32)
    tlen = jnp.asarray([min(len(t), S + W // 2) for t in ts], jnp.int32)
    qb = jnp.asarray(pad_batch(qs, S, Q_SENTINEL))
    tb = jnp.asarray(pad_batch(ts, S + W // 2, T_SENTINEL))
    rows, moves = banded_dp_segment(qb, tb, tlen, W)
    w_end, j_end, d = pick_end(rows, qlen, tlen, W)
    m, alen, lead = traceback_counts(moves, qlen, w_end, W)
    m, alen, d = np.asarray(m), np.asarray(alen), np.asarray(d)
    j_end = np.asarray(j_end)
    for b in range(len(qs)):
        # unit-cost optimal path: non-match columns == edit distance
        assert alen[b] - m[b] == d[b]
        assert m[b] <= min(len(qs[b]), int(j_end[b]))
        # column count bookkeeping: alen = matches+mismatches+ins+del,
        # q consumed = diag cols + ins, t consumed = diag cols + del
        assert alen[b] >= max(len(qs[b]), int(j_end[b]))
        assert alen[b] <= len(qs[b]) + int(j_end[b])


def test_extension_recovers_overlap():
    rng = np.random.default_rng(35)
    genome = random_genome(6000, seed=36)
    # two reads overlapping on genome[1500:3500]
    a = mutate(genome[500:3500], rng, 0.03, 0.03, 0.03)
    b = mutate(genome[1500:4500], rng, 0.03, 0.03, 0.03)
    L = 3584
    q = pad_batch([a], L, Q_SENTINEL)
    t = pad_batch([b], L, T_SENTINEL)
    # seed: genome pos 2000 ≈ a[1500] ≈ b[500] (indel drift ~ +-3%)
    res = extend_pair_batch(
        jnp.asarray(q), jnp.asarray(t),
        jnp.asarray([len(a)], jnp.int32), jnp.asarray([len(b)], jnp.int32),
        jnp.asarray([1500], jnp.int32), jnp.asarray([500], jnp.int32),
        S=128, W=64, max_segs=40)
    qbeg, qend = int(res.qbeg[0]), int(res.qend[0])
    tbeg, tend = int(res.tbeg[0]), int(res.tend[0])
    ident = float(res.identity[0])
    # overlap is a[~1000:end] vs b[0:~2000]
    assert tbeg <= 25, (qbeg, qend, tbeg, tend)
    assert qend >= len(a) - 25
    assert abs((qend - qbeg) - (tend - tbeg)) < 200
    assert (qend - qbeg) > 1800
    assert ident > 80.0, ident
    # identity consistent with ~6% per-read error on both reads
    assert ident < 99.0


def test_extension_stops_at_junk():
    rng = np.random.default_rng(38)
    core = random_genome(800, seed=39)
    a = np.concatenate([core, random_genome(800, seed=40)])
    b = np.concatenate([core.copy(), random_genome(800, seed=41)])
    L = 1664
    res = extend_pair_batch(
        jnp.asarray(pad_batch([a], L, Q_SENTINEL)),
        jnp.asarray(pad_batch([b], L, T_SENTINEL)),
        jnp.asarray([len(a)], jnp.int32), jnp.asarray([len(b)], jnp.int32),
        jnp.asarray([100], jnp.int32), jnp.asarray([100], jnp.int32),
        S=128, W=64, max_segs=16)
    # identical prefix aligns perfectly; random tails must stop extension
    qend = int(res.qend[0])
    assert 750 <= qend <= 1100, qend
    assert float(res.identity[0]) > 85.0


def test_ops_tapes_invariant_to_segment_budgets():
    """Tags/tapes must not depend on the per-direction max_segs budgets.

    mecat2cns sizes max_segs / max_segs_left per chunk from host-side span
    bounds (pipeline/cns.correct_batch_device); any budget at least as large
    as the segments actually applied must give identical alignments and
    identical op tapes (compared as right-aligned column lists).
    """
    from mecat_jax.ops.align import extend_pair_batch_with_ops
    from mecat_jax.ops.consensus import tapes_to_columns

    rng = np.random.default_rng(123)
    B, Lq, Lt = 4, 700, 700
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lt), np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    qseed = np.zeros(B, np.int32)
    tseed = np.zeros(B, np.int32)
    for b in range(B):
        base = rng.integers(0, 4, size=Lt, dtype=np.uint8)
        mut = mutate(base, rng, 0.04, 0.03, 0.03)[: Lq]
        t[b, : len(base)] = base
        q[b, : len(mut)] = mut
        qlen[b], tlen[b] = len(mut), len(base)
        # one seed near the middle, one hard against an edge
        qseed[b] = 10 if b % 2 else len(mut) // 2
        tseed[b] = 10 if b % 2 else len(base) // 2

    def run(ms, msl):
        pa, r, l = extend_pair_batch_with_ops(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen),
            jnp.asarray(tlen), jnp.asarray(qseed), jnp.asarray(tseed),
            S=S, W=W, max_segs=ms, max_segs_left=msl)
        cols = tapes_to_columns(r, l, qseed, tseed)
        return pa, cols

    pa_big, cols_big = run(24, 24)
    pa_tight, cols_tight = run(16, 8)
    for f_big, f_tight in zip(pa_big, pa_tight):
        assert np.array_equal(np.asarray(f_big), np.asarray(f_tight))
    for (o1, q1, t1), (o2, q2, t2) in zip(cols_big, cols_tight):
        assert np.array_equal(o1, o2)
        assert np.array_equal(q1, q2)
        assert np.array_equal(t1, t2)


def test_max_tape_cols_never_truncates_gated_segments():
    """max_tape_cols(S, W, p) must cover every identity-gated segment: the
    number of alignment columns of any applied segment is bounded by
    (2S + W/2)/(1 + p) (see the derivation in ops/align.max_tape_cols)."""
    from mecat_jax.ops.align import max_tape_cols
    from mecat_jax import constants as Cn

    for (s, w) in [(64, 32), (128, 64), (512, 128)]:
        tc = max_tape_cols(s, w, Cn.MIN_SEGMENT_IDENTITY)
        assert tc >= (2 * s + w // 2) / (1 + Cn.MIN_SEGMENT_IDENTITY)
        assert tc <= 2 * s + w
        assert tc % 64 == 0 or tc == 2 * s + w
