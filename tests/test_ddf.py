"""DDF candidate filter tests: brute-force score agreement + sensitivity."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from mecat_jax import constants as C
from mecat_jax.index.kmer_index import build_index
from mecat_jax.io.packed_db import revcomp
from mecat_jax.ops.ddf import _DIAG_SHIFT, scan_candidates
from mecat_jax.utils.sim import random_genome, simulate_reads, true_overlap

K, STRIDE, BIN = 8, 4, 128


def brute_candidates(db, idx, q_codes, qlen, self_id, max_occ=32):
    """Reference NumPy implementation of steps 1-5 of scan_candidates."""
    from mecat_jax.index.kmer_index import kmer_codes_np
    codes = kmer_codes_np(q_codes, K)
    scores = {}
    for qp in range(0, len(q_codes), STRIDE):
        if qp + K > qlen:
            continue
        code = int(codes[qp])
        a, b = int(idx.offsets[code]), int(idx.offsets[code + 1])
        if b - a > idx.max_occ_cutoff:
            continue
        for gpos in idx.positions[a:a + max_occ] if b - a > max_occ else idx.positions[a:b]:
            rid = int(np.searchsorted(db.starts, gpos, side="right")) - 1
            if rid == self_id:
                continue
            toff = int(gpos) - int(db.starts[rid])
            dbin = (qp - toff + _DIAG_SHIFT) // BIN
            scores[(rid, dbin)] = scores.get((rid, dbin), 0) + 1
    return scores


@pytest.fixture(scope="module")
def overlap_db():
    genome = random_genome(20000, seed=21)
    db, truths = simulate_reads(genome, 30, mean_len=3000, min_len=1500,
                                seed=22, error_rate=0.1)
    return db, truths


def run_scan(db, idx, read_ids, L=4096):
    bases, lens = db.padded_batch(read_ids, pad_to=L)
    dev = idx.as_device_arrays()
    return scan_candidates(
        jnp.asarray(bases), jnp.asarray(lens), dev["offsets"],
        dev["pos_rid"], dev["pos_loc"],
        jnp.int32(idx.max_occ_cutoff),
        jnp.asarray(read_ids, dtype=jnp.int32),
        k=K, stride=STRIDE, max_occ=32, num_candidates=20, diag_bin=BIN)


def test_scores_match_brute(overlap_db):
    db, _ = overlap_db
    idx = build_index(db.codes, db.starts, db.lengths, k=K)
    rids = [0, 1, 2, 3]
    cand = run_scan(db, idx, rids)
    for row, rid in enumerate(rids):
        read = db.read(rid)[:4096]
        brute = brute_candidates(db, idx, read, min(int(db.lengths[rid]), 4096),
                                 rid)
        got = {}
        for j in range(cand.target.shape[1]):
            if bool(cand.valid[row, j]):
                t = int(cand.target[row, j])
                s = int(cand.score[row, j])
                dbin = (int(cand.qseed[row, j]) - int(cand.tseed[row, j])
                        + _DIAG_SHIFT) // BIN
                got[(t, dbin)] = s
        want_top = sorted(brute.values(), reverse=True)[:len(got)]
        got_top = sorted(got.values(), reverse=True)
        # top-k scores agree with brute force
        assert got_top == want_top
        # every reported (target, bin) has the brute-force score
        for key, s in got.items():
            assert brute.get(key) == s, (key, s, brute.get(key))


def test_seed_inside_run(overlap_db):
    db, _ = overlap_db
    idx = build_index(db.codes, db.starts, db.lengths, k=K)
    cand = run_scan(db, idx, [0, 5, 7])
    v = np.asarray(cand.valid)
    qs, ts = np.asarray(cand.qseed), np.asarray(cand.tseed)
    lens_t = db.lengths[np.asarray(cand.target)[v]]
    assert (qs[v] >= 0).all() and (ts[v] >= 0).all()
    assert (ts[v] < lens_t).all()


def test_sensitivity_true_overlaps(overlap_db):
    """Reads with >=1500bp true genomic overlap should find each other."""
    db, truths = overlap_db
    idx = build_index(db.codes, db.starts, db.lengths, k=K)
    found, expected = 0, 0
    for q in range(10):
        partners = {t for t in range(db.n_reads)
                    if t != q and true_overlap(truths[q], truths[t]) > 1500}
        if not partners:
            continue
        hits = set()
        for strand in (0, 1):
            bases = db.read(q) if strand == 0 else revcomp(db.read(q))
            padded = np.zeros((1, 4096), dtype=np.uint8)
            padded[0, :len(bases)] = bases[:4096]
            dev = idx.as_device_arrays()
            cand = scan_candidates(
                jnp.asarray(padded),
                jnp.asarray([min(len(bases), 4096)], dtype=jnp.int32),
                dev["offsets"], dev["pos_rid"], dev["pos_loc"],
                jnp.int32(idx.max_occ_cutoff),
                jnp.asarray([q], dtype=jnp.int32),
                k=K, stride=STRIDE, max_occ=32, num_candidates=30,
                diag_bin=BIN)
            hits |= {int(t) for t, v in zip(np.asarray(cand.target)[0],
                                            np.asarray(cand.valid)[0]) if v}
        expected += len(partners)
        found += len(partners & hits)
    assert expected > 0
    assert found / expected >= 0.9, f"sensitivity {found}/{expected}"
