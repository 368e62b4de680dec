"""Distributed (template-sharded) mecat2cns vs single-device: exact equality.

BASELINE config-5 shape for the CORRECTION half: tag tables sharded over the
'data' mesh axis, per-host corrected-FASTA shards, rank-0 merge.  Integer tag
adds commute, so every corrected record must be bit-for-bit identical to the
single-device run_cns output (order may differ: shards interleave slices).
"""
import os

import pytest

from mecat_jax.io.fasta import write_fasta
from mecat_jax.parallel.cns_dist import run_cns_dist
from mecat_jax.pipeline.cns import CnsOptions, run_cns
from mecat_jax.pipeline.pw import PwOptions, run_pw
from mecat_jax.utils.sim import random_genome, simulate_reads

CNS_OPTS = dict(min_align_size=300, min_length=500, min_mapping_ratio=0.3,
                align_segment=128, align_band=64, extend_batch=32,
                min_identity=65.0)


def _records(path):
    return {name: bytes(seq) for name, seq in _iter_decoded(path)}


def _iter_decoded(path):
    from mecat_jax.io.packed_db import PackedDB
    db = PackedDB.from_fasta(path)
    for i in range(db.n_reads):
        yield db.name(i), db.read(i).tobytes()


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("cnsdist")
    genome = random_genome(9000, seed=61)
    db, _ = simulate_reads(genome, 28, mean_len=1800, min_len=1000,
                           seed=62, error_rate=0.1)
    reads = str(d / "reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    cand = str(d / "cand.txt")
    run_pw(reads, cand, str(d / "wrk"),
           PwOptions(task=0, kmer_size=9, scan_stride=4, num_candidates=12,
                     scan_batch=8, min_block_score=2), db=db)
    return d, reads, cand, db


def test_dist_cns_matches_single(sim):
    d, reads, cand, db = sim
    single = str(d / "single.fasta")
    run_cns(cand, reads, single, CnsOptions(**CNS_OPTS), db=db)
    dist = str(d / "dist.fasta")
    stats = run_cns_dist(cand, reads, dist, str(d / "wrk_d"),
                         CnsOptions(**CNS_OPTS), n_data=8, db=db)
    s, m = _records(single), _records(dist)
    assert stats.corrected_reads == len(m) > 0
    assert s == m  # record-exact: same names, same corrected bases


def test_dist_cns_table_cap_slices(sim, monkeypatch):
    """HBM-cap sub-slicing must not change the sharded output."""
    d, reads, cand, db = sim
    single = str(d / "single.fasta")  # from the test above (module fixture)
    if not os.path.exists(single):
        run_cns(cand, reads, single, CnsOptions(**CNS_OPTS), db=db)
    monkeypatch.setenv("MECAT_CNS_TABLE_BYTES", str(1 << 22))
    dist = str(d / "dist_capped.fasta")
    run_cns_dist(cand, reads, dist, str(d / "wrk_dc"),
                 CnsOptions(**CNS_OPTS), n_data=4, db=db)
    assert _records(single) == _records(dist)


def test_dist_cns_two_processes(sim):
    """REAL multi-controller cns: 2 processes x 4 virtual CPU devices over a
    localhost coordinator; per-process shard FASTAs; rank-0 merge.  Must be
    record-exact vs single-device run_cns."""
    import socket
    import subprocess
    import sys

    d, reads, cand, db = sim
    single = str(d / "single.fasta")
    if not os.path.exists(single):
        run_cns(cand, reads, single, CnsOptions(**CNS_OPTS), db=db)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("PYTHONPATH", None)
    workers = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(os.path.dirname(__file__), "dist_worker.py"),
             str(port), "2", str(pid), str(d), "cns"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for pid in (1, 0)]
    outs = [w.communicate(timeout=600) for w in workers]
    for w, (so, se) in zip(workers, outs):
        assert w.returncode == 0, se.decode()[-2000:]

    assert _records(str(d / "dist_mp.fasta")) == _records(single)
    # both processes wrote non-trivial shards (templates really spread)
    for p in (0, 1):
        sp = os.path.join(str(d), "wrk_mp_cns", f"cns_shard_p{p}.fasta")
        assert os.path.exists(sp)
        assert os.path.getsize(sp) > 0


def test_dist_cns_rounds_matches_single(sim):
    """Iterative correction over the mesh: rounds=2 sharded output must be
    record-exact vs single-device rounds=2 (drafts derived from REPLICATED
    emit arrays; seeds remapped identically on every process)."""
    d, reads, cand, db = sim
    single = str(d / "single_r2.fasta")
    run_cns(cand, reads, single, CnsOptions(rounds=2, **CNS_OPTS), db=db)
    dist = str(d / "dist_r2.fasta")
    stats = run_cns_dist(cand, reads, dist, str(d / "wrk_dr2"),
                         CnsOptions(rounds=2, **CNS_OPTS), n_data=8, db=db)
    s, m = _records(single), _records(dist)
    assert stats.corrected_reads == len(m) > 0
    assert s == m
    # and rounds must bind vs the rounds=1 outputs of the base test
    base = str(d / "single.fasta")
    if os.path.exists(base):
        assert _records(base) != s
