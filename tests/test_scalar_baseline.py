"""Scalar C++ baseline as an algorithm-level differential oracle.

The scalar single-thread engine (native/src/scalar_baseline.cpp) replicates
the framework's own scan/extend semantics in reference-style scalar code
(VERDICT r4 next #1).  These tests pin that replication exactly: candidate
sets must match ops/ddf.scan_candidates element-wise, and extensions must
match ops/align.extend_pair_batch bit-for-bit on every integer field —
which makes the scalar engine a credible stand-in oracle while the
reference mount stays empty, and makes its measured rate an
apples-to-apples baseline denominator.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mecat_jax import constants as C
from mecat_jax.utils.sim import random_genome, simulate_reads


@pytest.fixture(scope="module")
def workload():
    g = random_genome(40000, seed=17)
    db, _ = simulate_reads(g, 48, mean_len=1800, min_len=1000, seed=18,
                           error_rate=0.1)
    from mecat_jax.native.scalar import ScalarEngine

    eng = ScalarEngine(db.codes, db.starts, db.lengths, k=13)
    return g, db, eng


SCAN = dict(stride=10, max_occ=16, diag_bin=256, n_cand=12)


def test_scalar_index_matches_kmer_index(workload):
    """CSR offsets + (rid, loc) occurrence arrays equal index/kmer_index."""
    _, db, eng = workload
    from mecat_jax.index.kmer_index import build_index

    idx = build_index(db.codes, db.starts, db.lengths, k=13)
    # the engine keeps its arrays internal; probe equality via the scan on
    # a read against the JAX probe on the same read (covered below) plus
    # the occurrence-count surface here
    assert eng.n_valid == len(idx.positions)
    assert eng.cutoff() == idx.max_occ_cutoff


def test_scalar_scan_matches_jax(workload):
    """Candidates (target, score, qseed, tseed) equal scan_candidates."""
    import jax.numpy as jnp

    from mecat_jax.index.kmer_index import build_index
    from mecat_jax.ops.ddf import scan_candidates

    _, db, eng = workload
    idx = build_index(db.codes, db.starts, db.lengths, k=13)
    cutoff = eng.cutoff()
    L = 4096
    ids = list(range(db.n_reads))
    bases, lens = db.padded_batch(ids, pad_to=L)
    cand = scan_candidates(
        jnp.asarray(bases), jnp.asarray(lens), jnp.asarray(idx.offsets),
        jnp.asarray(idx.pos_rid), jnp.asarray(idx.pos_loc),
        jnp.int32(cutoff),
        jnp.asarray(np.arange(db.n_reads, dtype=np.int32)),
        k=13, stride=SCAN["stride"], max_occ=SCAN["max_occ"],
        num_candidates=SCAN["n_cand"], diag_bin=SCAN["diag_bin"])
    tgt = np.asarray(cand.target)
    score = np.asarray(cand.score)
    qseed = np.asarray(cand.qseed)
    tseed = np.asarray(cand.tseed)
    valid = np.asarray(cand.valid)
    for r in ids:
        s_tgt, s_score, s_qseed, s_tseed = eng.scan_read(
            db.read(r), r, cutoff=cutoff, **SCAN)
        n_valid = int(valid[r].sum())
        # JAX emits exactly n_cand rows; invalid tail rows carry score <
        # MIN_BLOCK_SCORE.  The scalar emits one row per real run.  On the
        # valid prefix everything must agree element-wise.
        assert n_valid <= len(s_tgt)
        np.testing.assert_array_equal(s_tgt[:n_valid], tgt[r, :n_valid])
        np.testing.assert_array_equal(s_score[:n_valid], score[r, :n_valid])
        np.testing.assert_array_equal(s_qseed[:n_valid], qseed[r, :n_valid])
        np.testing.assert_array_equal(s_tseed[:n_valid], tseed[r, :n_valid])
        # scores beyond the JAX-valid prefix must all be below the cut
        assert all(s < C.MIN_BLOCK_SCORE for s in s_score[n_valid:])


def test_scalar_extend_matches_jax(workload):
    """Extension integer fields bit-equal extend_pair_batch on real pairs."""
    import jax.numpy as jnp

    from mecat_jax.index.kmer_index import build_index
    from mecat_jax.ops.align import extend_pair_batch

    _, db, eng = workload
    idx = build_index(db.codes, db.starts, db.lengths, k=13)
    cutoff = eng.cutoff()
    S, W, max_segs = 128, 64, 40
    pairs = []
    for r in range(db.n_reads):
        s_tgt, s_score, s_qseed, s_tseed = eng.scan_read(
            db.read(r), r, cutoff=cutoff, **SCAN)
        for j in range(len(s_tgt)):
            if s_score[j] >= C.MIN_BLOCK_SCORE:
                pairs.append((r, int(s_tgt[j]), int(s_qseed[j]),
                              int(s_tseed[j])))
    pairs = pairs[:96]
    assert len(pairs) >= 32
    L = 4096
    B = len(pairs)
    q_b = np.zeros((B, L), np.uint8)
    t_b = np.zeros((B, L), np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    qs = np.zeros(B, np.int32)
    ts = np.zeros(B, np.int32)
    for i, (r, t, q0, t0) in enumerate(pairs):
        qr, tr = db.read(r), db.read(t)
        q_b[i, :len(qr)] = qr
        t_b[i, :len(tr)] = tr
        qlen[i], tlen[i] = len(qr), len(tr)
        qs[i], ts[i] = q0, t0
    res = extend_pair_batch(
        jnp.asarray(q_b), jnp.asarray(t_b), jnp.asarray(qlen),
        jnp.asarray(tlen), jnp.asarray(qs), jnp.asarray(ts),
        S=S, W=W, max_segs=max_segs)
    for i, (r, t, q0, t0) in enumerate(pairs):
        d = eng.extend_pair(db.read(r), db.read(t), q0, t0, S=S, W=W,
                            max_segs=max_segs, penalty=C.ALIGN_TRIM_PENALTY,
                            min_seg_identity=C.MIN_SEGMENT_IDENTITY)
        got = (d["qbeg"], d["qend"], d["tbeg"], d["tend"], d["dist"],
               d["matches"], d["alen"])
        want = tuple(int(np.asarray(getattr(res, f))[i]) for f in
                     ("qbeg", "qend", "tbeg", "tend", "dist", "matches",
                      "align_len"))
        assert got == want, (i, pairs[i], got, want)
        assert abs(d["identity"] - float(np.asarray(res.identity)[i])) < 1e-3


def test_scalar_overlap_range_consistent(workload):
    """The timed driver's counts agree with the primitive-by-primitive path."""
    _, db, eng = workload
    cutoff = eng.cutoff()
    r = eng.overlap_range(
        0, db.n_reads, task=0, stride=SCAN["stride"],
        max_occ=SCAN["max_occ"], cutoff=cutoff, diag_bin=SCAN["diag_bin"],
        n_cand=SCAN["n_cand"], min_block_score=C.MIN_BLOCK_SCORE,
        S=128, W=64, penalty=C.ALIGN_TRIM_PENALTY,
        min_seg_identity=C.MIN_SEGMENT_IDENTITY, min_identity=65.0,
        min_align_size=300)
    # candidate total == sum over reads of merged-strand top-n
    from mecat_jax.io.packed_db import revcomp

    total = 0
    for q in range(db.n_reads):
        fwd = db.read(q)
        merged = []
        for bases in (fwd, revcomp(fwd)):
            _, score, _, _ = eng.scan_read(bases, q, cutoff=cutoff, **SCAN)
            merged += [s for s in score if s >= C.MIN_BLOCK_SCORE]
        total += min(len(merged), SCAN["n_cand"])
    assert r["candidates"] == total
    r1 = eng.overlap_range(
        0, db.n_reads, task=1, stride=SCAN["stride"],
        max_occ=SCAN["max_occ"], cutoff=cutoff, diag_bin=SCAN["diag_bin"],
        n_cand=SCAN["n_cand"], min_block_score=C.MIN_BLOCK_SCORE,
        S=128, W=64, penalty=C.ALIGN_TRIM_PENALTY,
        min_seg_identity=C.MIN_SEGMENT_IDENTITY, min_identity=65.0,
        min_align_size=300)
    assert r1["candidates"] == total
    assert r1["extended"] == total
    assert 0 < r1["overlaps"] <= r1["extended"]
