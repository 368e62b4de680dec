"""Multi-chip sharded overlap step vs single-device, on an 8-device CPU mesh."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from mecat_jax.index.kmer_index import build_index
from mecat_jax.ops.ddf import scan_candidates
from mecat_jax.parallel.sharded import (make_mesh, place_sharded_inputs,
                                        shard_index_by_hash,
                                        sharded_overlap_step)
from mecat_jax.pipeline.device_step import overlap_step
from mecat_jax.utils.sim import random_genome, simulate_reads

K = 7
CFG = dict(k=K, stride=4, max_occ=16, num_candidates=8, diag_bin=128,
           L_target=2048, S=128, W=64, max_segs=8, min_align_size=300,
           min_identity=65.0)


@pytest.fixture(scope="module")
def setup():
    genome = random_genome(12000, seed=61)
    db, _ = simulate_reads(genome, 16, mean_len=1500, min_len=800, seed=62,
                           error_rate=0.08)
    idx = build_index(db.codes, db.starts, db.lengths, k=K)
    bases, lens = db.padded_batch(range(16), pad_to=2048)
    self_id = np.arange(16, dtype=np.int32)
    return db, idx, bases, lens, self_id


def valid_set(out):
    """Set of overlap tuples from an OverlapStepOut (order-independent)."""
    v = np.asarray(out.valid)
    r, c = np.nonzero(v)
    return {(int(r[i]),
             int(np.asarray(out.target)[r[i], c[i]]),
             int(np.asarray(out.score)[r[i], c[i]]),
             int(np.asarray(out.qbeg)[r[i], c[i]]),
             int(np.asarray(out.qend)[r[i], c[i]]),
             int(np.asarray(out.tbeg)[r[i], c[i]]),
             int(np.asarray(out.tend)[r[i], c[i]]))
            for i in range(len(r))}


def test_shard_index_partitions(setup):
    db, idx, *_ = setup
    for n_hash in (2, 4):
        off_sh, rid_sh, loc_sh, lo = shard_index_by_hash(idx, n_hash)
        spp = (len(idx.offsets) - 1) // n_hash
        total = 0
        for h in range(n_hash):
            cnt = int(off_sh[h, -1])
            total += cnt
            # shard h's slice reproduces the global CSR for its code range
            a = int(idx.offsets[h * spp])
            assert np.array_equal(rid_sh[h, :cnt], idx.pos_rid[a:a + cnt])
            assert np.array_equal(loc_sh[h, :cnt], idx.pos_loc[a:a + cnt])
            assert np.array_equal(off_sh[h] + a,
                                  idx.offsets[h * spp:(h + 1) * spp + 1])
        assert total == len(idx.positions)


def test_sharded_matches_single_device(setup):
    db, idx, bases, lens, self_id = setup
    # single-device fused step
    single = overlap_step(
        jnp.asarray(bases), jnp.asarray(lens), jnp.asarray(self_id),
        jnp.asarray(db.codes), jnp.asarray(idx.offsets),
        jnp.asarray(idx.pos_rid), jnp.asarray(idx.pos_loc),
        jnp.asarray(idx.read_starts), jnp.asarray(idx.read_lengths),
        jnp.int32(idx.max_occ_cutoff), **CFG)

    mesh = make_mesh(n_data=4, n_hash=2)
    off_sh, rid_sh, loc_sh, lo = shard_index_by_hash(idx, 2)
    step = sharded_overlap_step(mesh, **CFG)
    args = place_sharded_inputs(
        mesh, bases, lens, self_id, db.codes, off_sh, rid_sh, loc_sh, lo,
        idx.read_starts, idx.read_lengths, np.int32(idx.max_occ_cutoff))
    sharded = step(*args)

    assert np.asarray(sharded.valid).shape == np.asarray(single.valid).shape
    s_single = valid_set(single)
    s_sharded = valid_set(sharded)
    # EXACT equality: the 4-key canonical hit sort (ops/ddf.score_hits) makes
    # candidate selection invariant to the hit layout, so the sharded step
    # must reproduce the single-device overlaps bit-for-bit.
    assert s_single == s_sharded
    assert len(s_single) > 0


def test_sharded_hash4(setup):
    db, idx, bases, lens, self_id = setup
    mesh = make_mesh(n_data=2, n_hash=4)
    off_sh, rid_sh, loc_sh, lo = shard_index_by_hash(idx, 4)
    step = sharded_overlap_step(mesh, **CFG)
    args = place_sharded_inputs(
        mesh, bases, lens, self_id, db.codes, off_sh, rid_sh, loc_sh, lo,
        idx.read_starts, idx.read_lengths, np.int32(idx.max_occ_cutoff))
    out = step(*args)
    assert int(np.asarray(out.valid).sum()) > 0
