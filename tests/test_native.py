"""Differential tests: native C++ data layer vs the pure-Python fallbacks.

The native library (mecat_jax/native) replaces the reference's C++ data layer
(SURVEY.md §2.1 component 1).  Every entry point must produce byte-identical
results to the Python implementation it shadows.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from mecat_jax import native
from mecat_jax.io.fasta import encode_bases, format_fasta
from mecat_jax.io.m4 import CandidateRecord, M4Record, format_block
from mecat_jax.io.packed_db import PackedDB

lib = native.get()
pytestmark = pytest.mark.skipif(lib is None, reason="native lib unavailable")


def _write(tmp_path, name, data: bytes):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def test_parse_fasta_matches_python(tmp_path):
    data = (b">read_one extra stuff\nACGTacgtNN\nGGTT\n"
            b">read_two\n" + b"ACGT" * 300 + b"\n"
            b">empty\n"
            b">last\nTTTT\n")
    path = _write(tmp_path, "t.fa", data)
    os.environ["MECAT_NO_NATIVE"] = "1"
    try:
        py = PackedDB.from_fasta(path)
    finally:
        del os.environ["MECAT_NO_NATIVE"]
    nat = PackedDB.from_fasta(path)
    assert nat.names == py.names
    assert np.array_equal(nat.codes, py.codes)
    assert np.array_equal(nat.starts, py.starts)
    assert np.array_equal(nat.lengths, py.lengths)
    assert nat.names == ["read_one", "read_two", "empty", "last"]


def test_parse_fastq_matches_python(tmp_path):
    data = (b"@q1 desc\nACGTN\n+\nIIIII\n"
            b"@q2\nGGCC\n+ q2\n!!!!\n")
    path = _write(tmp_path, "t.fq", data)
    os.environ["MECAT_NO_NATIVE"] = "1"
    try:
        py = PackedDB.from_fasta(path)
    finally:
        del os.environ["MECAT_NO_NATIVE"]
    nat = PackedDB.from_fasta(path)
    assert nat.names == py.names == ["q1", "q2"]
    assert np.array_equal(nat.codes, py.codes)
    assert np.array_equal(nat.lengths, py.lengths)


def test_pack_unpack_roundtrip_vs_python():
    rng = np.random.default_rng(3)
    for n in (0, 1, 3, 4, 5, 1023, 4096):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        packed_nat = lib.pack_2bit(codes)
        # python model
        padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
        padded[:n] = codes
        q = padded.reshape(-1, 4)
        packed_py = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
                     | (q[:, 3] << 6)).astype(np.uint8)
        assert np.array_equal(packed_nat, packed_py)
        assert np.array_equal(lib.unpack_2bit(packed_nat, n), codes)


def test_padded_batch_matches_python():
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 200, 20).astype(np.int32)
    starts = np.zeros(20, dtype=np.int64)
    np.cumsum(lens[:-1].astype(np.int64), out=starts[1:])
    codes = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    db = PackedDB(codes, starts, lens, [str(i) for i in range(20)])
    ids = [5, 0, 19, 7, 7]
    nat_b, nat_l = db.padded_batch(ids, pad_to=128)
    os.environ["MECAT_NO_NATIVE"] = "1"
    try:
        py_b, py_l = db.padded_batch(ids, pad_to=128)
    finally:
        del os.environ["MECAT_NO_NATIVE"]
    assert np.array_equal(nat_b, py_b)
    assert np.array_equal(nat_l, py_l)


def test_m4_and_candidate_block_format_identical():
    rng = np.random.default_rng(5)
    m4s = [M4Record(qid=int(rng.integers(1, 1 << 30)), sid=i + 1,
                    identity=float(np.round(rng.uniform(60, 100), 6)),
                    score=int(rng.integers(0, 9999)), qstrand=0,
                    qstart=int(rng.integers(0, 100)), qend=1000, qsize=2000,
                    sstrand=int(rng.integers(0, 2)), sstart=3, send=999,
                    ssize=1500) for i in range(500)]
    cands = [CandidateRecord(qid=i + 1, sid=2 * i + 1,
                             score=int(rng.integers(0, 999)),
                             qdir=i % 2, qext=int(rng.integers(0, 5000)),
                             qsize=5000, sdir=0, sext=7, ssize=888)
             for i in range(500)]
    nat_m4 = format_block(m4s)
    nat_c = format_block(cands)
    py_m4 = "".join(r.format() + "\n" for r in m4s)
    py_c = "".join(r.format() + "\n" for r in cands)
    assert nat_m4 == py_m4
    assert nat_c == py_c


def test_format_fasta_matches_python():
    rng = np.random.default_rng(6)
    recs = [(f"r{i}", rng.integers(0, 4, int(rng.integers(1, 300)))
             .astype(np.uint8)) for i in range(10)]
    chunks = [c for _, c in recs]
    lens = np.array([len(c) for c in chunks], dtype=np.int32)
    starts = np.zeros(len(chunks), dtype=np.int64)
    np.cumsum(lens[:-1].astype(np.int64), out=starts[1:])
    blob = lib.format_fasta(np.concatenate(chunks), starts, lens,
                            [n for n, _ in recs], width=80)
    expect = b"".join(format_fasta(n, c) for n, c in recs)
    assert blob == expect


def test_parse_table():
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("1 2 3.25 4 5 6 7 8 9\n")
        f.write("  10\t20 30 40 50 60 70 80 90  \n")
        path = f.name
    t = lib.parse_table(path, 9)
    os.unlink(path)
    assert t.shape == (2, 9)
    assert t[0].tolist() == [1, 2, 3.25, 4, 5, 6, 7, 8, 9]
    assert t[1].tolist() == [10, 20, 30, 40, 50, 60, 70, 80, 90]
