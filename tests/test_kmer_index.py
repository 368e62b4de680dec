"""L2 k-mer index tests: brute-force dict comparison + probe semantics."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax

from mecat_jax.index.kmer_index import (build_index, global_to_read,
                                        kmer_codes_jnp, kmer_codes_np,
                                        probe_index)
from mecat_jax.utils.sim import random_genome, simulate_reads


def brute_force_table(db, k):
    table = {}
    for rid in range(db.n_reads):
        r = db.read(rid)
        s = int(db.starts[rid])
        for p in range(len(r) - k + 1):
            code = 0
            for b in r[p:p + k]:
                code = code * 4 + int(b)
            table.setdefault(code, []).append(s + p)
    return table


@pytest.fixture(scope="module")
def small_db():
    db, _ = simulate_reads(random_genome(4000, seed=11), 12, mean_len=400,
                           min_len=100, seed=12)
    return db


@pytest.fixture(scope="module")
def brute6(small_db):
    return brute_force_table(small_db, 6)


def test_kmer_codes_np_matches_brute(small_db):
    k = 6
    r = small_db.read(0)
    codes = kmer_codes_np(r, k)
    for p in range(len(r) - k + 1):
        code = 0
        for b in r[p:p + k]:
            code = code * 4 + int(b)
        assert codes[p] == code


def test_kmer_codes_jnp_matches_np(small_db):
    k = 7
    r = small_db.read(1)
    want = kmer_codes_np(r, k)
    got = np.asarray(kmer_codes_jnp(jnp.asarray(r), k))
    n_valid = len(r) - k + 1
    assert np.array_equal(got[:n_valid], want[:n_valid])


def test_build_index_matches_brute(small_db, brute6):
    k = 6
    idx = build_index(small_db.codes, small_db.starts, small_db.lengths, k=k)
    brute = brute6
    assert idx.offsets[-1] == sum(len(v) for v in brute.values())
    for code, plist in list(brute.items())[:500]:
        a, b = int(idx.offsets[code]), int(idx.offsets[code + 1])
        assert sorted(idx.positions[a:b].tolist()) == sorted(plist)
    # slots absent from brute force are empty
    empty = set(range(4 ** k)) - set(brute)
    for code in list(empty)[:100]:
        assert idx.offsets[code] == idx.offsets[code + 1]


def test_probe_index(small_db, brute6):
    k = 6
    idx = build_index(small_db.codes, small_db.starts, small_db.lengths, k=k)
    brute = brute6
    dev = idx.as_device_arrays()
    q_codes = jnp.asarray([[c for c in list(brute)[:8]]], dtype=jnp.int32)
    q_valid = jnp.ones_like(q_codes, dtype=bool)
    rid, loc, valid = probe_index(dev["offsets"], dev["pos_rid"],
                                  dev["pos_loc"], q_codes, q_valid,
                                  jnp.int32(idx.max_occ_cutoff), max_occ=16)
    starts = small_db.starts
    pos = np.asarray(starts[np.asarray(rid)]) + np.asarray(loc)
    valid = np.asarray(valid)
    for qi, code in enumerate(list(brute)[:8]):
        want = set(brute[code][:16]) if len(brute[code]) <= 16 else None
        got = set(pos[0, qi][valid[0, qi]].tolist())
        if want is not None and len(brute[code]) <= idx.max_occ_cutoff:
            assert got == set(brute[code]) or got == want


def test_probe_invalid_and_cutoff(small_db):
    k = 6
    idx = build_index(small_db.codes, small_db.starts, small_db.lengths, k=k)
    dev = idx.as_device_arrays()
    q_codes = jnp.zeros((1, 4), dtype=jnp.int32)
    q_valid = jnp.zeros((1, 4), dtype=bool)
    _, _, valid = probe_index(dev["offsets"], dev["pos_rid"], dev["pos_loc"],
                              q_codes, q_valid,
                              jnp.int32(idx.max_occ_cutoff))
    assert not np.asarray(valid).any()
    # cutoff of 0 drops every slot
    _, _, valid = probe_index(dev["offsets"], dev["pos_rid"], dev["pos_loc"],
                              q_codes, jnp.ones((1, 4), dtype=bool),
                              jnp.int32(0))
    assert not np.asarray(valid).any()


def test_global_to_read(small_db):
    starts = jnp.asarray(small_db.starts.astype(np.int32))
    lengths = jnp.asarray(small_db.lengths)
    gpos = jnp.asarray([0, int(small_db.starts[3]) + 5,
                        int(small_db.starts[-1])], dtype=jnp.int32)
    rid, off = global_to_read(starts, lengths, gpos)
    assert rid.tolist() == [0, 3, small_db.n_reads - 1]
    assert off.tolist() == [0, 5, 0]


def test_device_build_matches_numpy(small_db):
    """The device counting-sort build == the NumPy reference build."""
    for k in (6, 9):
        a = build_index(small_db.codes, small_db.starts, small_db.lengths,
                        k=k, device=False)
        b = build_index(small_db.codes, small_db.starts, small_db.lengths,
                        k=k, device=True)
        assert np.array_equal(a.offsets, b.offsets)
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.pos_rid, b.pos_rid)
        assert np.array_equal(a.pos_loc, b.pos_loc)
        assert a.max_occ_cutoff == b.max_occ_cutoff


def test_build_index_codes_dev_identical():
    """build_index(codes_dev=...) (the run_pw single-upload path) must
    produce arrays identical to the self-uploading device build."""
    import jax.numpy as jnp
    from mecat_jax.index.kmer_index import build_index
    from mecat_jax.utils.sim import random_genome, simulate_reads

    db, _ = simulate_reads(random_genome(5000, seed=41), 16, mean_len=600,
                           min_len=200, seed=42)
    a = build_index(db.codes, db.starts, db.lengths, k=8, device=True)
    b = build_index(db.codes, db.starts, db.lengths, k=8, device=True,
                    codes_dev=jnp.asarray(db.codes))
    import numpy as np
    for f in ("offsets", "positions", "pos_rid", "pos_loc"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert a.max_occ_cutoff == b.max_occ_cutoff
