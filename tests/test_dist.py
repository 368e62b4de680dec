"""Distributed pw driver vs the single-device pipeline (virtual 8-dev mesh).

BASELINE config-5 shape: mesh-sharded overlap detection with per-host shard
files and a deterministic merge.  The distributed driver shares the batch
plan, probe/extend kernels, survivor filter, and dedup tie-break with the
single-chip fused path, so agreement is EXACT full-record equality (modulo
file ordering), not a Jaccard gate.
"""
import os

import numpy as np
import pytest

from mecat_jax.io.fasta import write_fasta
from mecat_jax.io.m4 import read_m4
from mecat_jax.parallel.dist import run_pw_dist
from mecat_jax.pipeline.pw import PwOptions, run_pw
from mecat_jax.utils.sim import random_genome, simulate_reads


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    genome = random_genome(15000, seed=31)
    db, _ = simulate_reads(genome, 32, mean_len=2200, min_len=1200,
                           seed=32, error_rate=0.08)
    reads = str(d / "reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    return d, reads, db


OPTS = dict(task=1, kmer_size=9, scan_stride=4, min_align_size=500,
            num_candidates=8, scan_batch=4, extend_batch=64,
            align_segment=128, align_band=64, min_block_score=2)


def _records(path):
    """Full M4 records as a sorted tuple list (order-independent compare)."""
    return sorted(
        (r.qid, r.sid, r.identity, r.score, r.qstrand, r.qstart, r.qend,
         r.qsize, r.sstrand, r.sstart, r.send, r.ssize)
        for r in read_m4(path))


def _pairs(path):
    return {(r.qid, r.sid, r.sstrand) for r in read_m4(path)}


def test_dist_pw_matches_single_exactly(sim, monkeypatch):
    d, reads, db = sim
    # the single-chip reference is the FUSED two-phase path (the GPU
    # production path) — forced on the CPU backend for the test
    monkeypatch.setenv("MECAT_FORCE_FUSED", "1")
    single_out = str(d / "single.m4")
    run_pw(reads, single_out, str(d / "wrk_s"), PwOptions(**OPTS), db=db)
    monkeypatch.delenv("MECAT_FORCE_FUSED")
    dist_out = str(d / "dist.m4")
    stats = run_pw_dist(reads, dist_out, str(d / "wrk_d"),
                        PwOptions(**OPTS), n_data=4, n_hash=2, db=db)
    assert os.path.exists(dist_out)
    s, m = _records(single_out), _records(dist_out)
    assert stats.overlaps == len(m) > 0
    assert s == m


def test_dist_pw_shard_files(sim):
    d, reads, db = sim
    wrk = str(d / "wrk_d")  # reuse the run above
    assert os.path.exists(os.path.join(wrk, "pw_shard_p0.m4"))


def test_dist_pw_two_processes(sim):
    """REAL multi-controller run: 2 processes x 4 virtual CPU devices over a
    localhost coordinator; per-process addressable-shard emit; rank-0 merge.
    Output records must match the in-process 8-device run exactly."""
    import socket
    import subprocess
    import sys

    d, reads, db = sim
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
             str(port), "2", str(pid), str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for pid in (2 - 1, 0)[::-1]]
    outs = [w.communicate(timeout=600) for w in workers]
    for w, (so, se) in zip(workers, outs):
        assert w.returncode == 0, se.decode()[-2000:]

    mp = _records(str(d / "dist_mp.m4"))
    single_out = str(d / "single8.m4")
    run_pw_dist(reads, single_out, str(d / "wrk_d8"),
                PwOptions(**OPTS), n_data=4, n_hash=2, db=db)
    s8 = _records(single_out)
    assert len(mp) > 0
    assert mp == s8
