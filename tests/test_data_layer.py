"""Tests for the L1 data layer: FASTA IO, 2-bit packing, PackedDB, volumes."""
import numpy as np
import pytest

from mecat_jax.io.fasta import (FastaRecord, decode_bases, encode_bases,
                                iter_fasta, write_fasta)
from mecat_jax.io.packed_db import (PackedDB, pack_2bit, revcomp, unpack_2bit)
from mecat_jax.utils.sim import random_genome, simulate_reads


def test_encode_decode_roundtrip():
    seq = b"ACGTacgtTTTT"
    codes = encode_bases(seq)
    assert decode_bases(codes) == b"ACGTACGTTTTT"
    # non-ACGT maps to a valid code
    assert encode_bases(b"N").item() in range(4)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    for n in [0, 1, 3, 4, 5, 127, 1024]:
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        assert np.array_equal(unpack_2bit(pack_2bit(codes), n), codes)


def test_pack_layout():
    # base i lives in bits 2*(i%4) of byte i//4
    codes = np.array([1, 2, 3, 0, 3], dtype=np.uint8)
    packed = pack_2bit(codes)
    assert packed[0] == (1 | (2 << 2) | (3 << 4) | (0 << 6))
    assert packed[1] == 3


def test_revcomp():
    codes = encode_bases(b"ACGT")
    assert decode_bases(revcomp(codes)) == b"ACGT"
    codes = encode_bases(b"AACG")
    assert decode_bases(revcomp(codes)) == b"CGTT"


def test_fasta_roundtrip(tmp_path):
    g = random_genome(500, seed=1)
    recs = [("r1", g[:100]), ("r2", g[100:350]), ("r3", g[350:])]
    path = str(tmp_path / "x.fasta")
    write_fasta(path, recs, width=60)
    back = list(iter_fasta(path))
    assert [r.name for r in back] == ["r1", "r2", "r3"]
    for (name, codes), rec in zip(recs, back):
        assert np.array_equal(rec.codes, codes)


def test_fastq(tmp_path):
    path = str(tmp_path / "x.fastq")
    with open(path, "w") as fh:
        fh.write("@q1 extra\nACGT\n+\n!!!!\n@q2\nGGCC\n+\nIIII\n")
    back = list(iter_fasta(path))
    assert [r.name for r in back] == ["q1", "q2"]
    assert decode_bases(back[0].codes) == b"ACGT"
    assert decode_bases(back[1].codes) == b"GGCC"


def test_packed_db_basic():
    db, truths = simulate_reads(random_genome(20000, seed=2), 20, mean_len=2000,
                                min_len=500, seed=3)
    assert db.n_reads == 20
    assert db.total_bases == int(db.lengths.sum())
    for i in range(db.n_reads):
        assert len(db.read(i)) == db.lengths[i]
    sub = db.subset([3, 1])
    assert np.array_equal(sub.read(0), db.read(3))
    assert np.array_equal(sub.read(1), db.read(1))
    assert sub.names == [db.name(3), db.name(1)]


def test_packed_db_save_load(tmp_path):
    db, _ = simulate_reads(random_genome(5000, seed=4), 5, mean_len=800,
                           min_len=300, seed=5)
    prefix = str(tmp_path / "vol0")
    db.save(prefix)
    back = PackedDB.load(prefix)
    assert np.array_equal(back.codes, db.codes)
    assert np.array_equal(back.starts, db.starts)
    assert np.array_equal(back.lengths, db.lengths)
    assert back.names == db.names


def test_split_volumes():
    db, _ = simulate_reads(random_genome(30000, seed=6), 30, mean_len=1500,
                           min_len=500, seed=7)
    vols = db.split_volumes(max_bases=5000)
    assert vols[0][0] == 0 and vols[-1][1] == db.n_reads
    for (a, b), (c, d) in zip(vols, vols[1:]):
        assert b == c and a < b
    for a, b in vols:
        bases = int(db.lengths[a:b].sum())
        assert b - a == 1 or bases <= 5000


def test_padded_batch():
    db, _ = simulate_reads(random_genome(10000, seed=8), 8, mean_len=1200,
                           min_len=400, seed=9)
    bases, lens = db.padded_batch(range(8), multiple=128)
    assert bases.shape[0] == 8 and bases.shape[1] % 128 == 0
    for i in range(8):
        assert np.array_equal(bases[i, :lens[i]], db.read(i)[:lens[i]])
        assert (bases[i, lens[i]:] == 0).all()
