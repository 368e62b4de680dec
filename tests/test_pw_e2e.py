"""End-to-end mecat2pw tests on simulated reads with ground truth."""
import numpy as np
import pytest

from mecat_jax.io.m4 import (CandidateRecord, M4Record, read_candidates,
                             read_m4)
from mecat_jax.io.fasta import write_fasta
from mecat_jax.pipeline.pw import PwOptions, run_pw
from mecat_jax.utils.sim import random_genome, simulate_reads, true_overlap

OPTS = dict(num_candidates=20, min_align_size=500, kmer_size=8,
            scan_stride=4, scan_batch=16, extend_batch=64,
            align_segment=128, align_band=64, diag_bin=128)


@pytest.fixture(scope="module")
def sim_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pw")
    genome = random_genome(15000, seed=51)
    db, truths = simulate_reads(genome, 24, mean_len=2500, min_len=1200,
                                seed=52, error_rate=0.08)
    reads = str(tmp / "reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    return tmp, reads, db, truths


def test_pw_m4(sim_setup):
    tmp, reads, db, truths = sim_setup
    out = str(tmp / "out.m4")
    stats = run_pw(reads, out, str(tmp / "wrk"), PwOptions(task=1, **OPTS))
    recs = list(read_m4(out))
    assert stats.overlaps == len(recs) > 0

    # --- format / coordinate sanity -------------------------------------
    for r in recs:
        assert 1 <= r.qid <= db.n_reads and 1 <= r.sid <= db.n_reads
        assert r.qid != r.sid
        assert r.qstrand == 0 and r.sstrand in (0, 1)
        assert 0 <= r.qstart < r.qend <= r.qsize
        assert 0 <= r.sstart < r.send <= r.ssize
        assert r.qsize == int(db.lengths[r.qid - 1])
        assert r.ssize == int(db.lengths[r.sid - 1])
        assert 0 < r.identity <= 100.0

    # --- precision: every reported overlap is a true genomic overlap ----
    bad = 0
    for r in recs:
        if true_overlap(truths[r.qid - 1], truths[r.sid - 1]) < 300:
            bad += 1
    assert bad / len(recs) <= 0.05, f"{bad}/{len(recs)} false overlaps"

    # --- strand consistency ----------------------------------------------
    for r in recs[:50]:
        same = truths[r.qid - 1].strand == truths[r.sid - 1].strand
        assert (r.sstrand == 0) == same

    # --- sensitivity -------------------------------------------------------
    true_pairs = {(min(a, b), max(a, b))
                  for a in range(db.n_reads) for b in range(db.n_reads)
                  if a < b and true_overlap(truths[a], truths[b]) >= 1500}
    found = {(min(r.qid, r.sid) - 1, max(r.qid, r.sid) - 1) for r in recs}
    sens = len(true_pairs & found) / max(1, len(true_pairs))
    assert len(true_pairs) >= 10
    assert sens >= 0.85, f"sensitivity {sens:.2f} ({len(true_pairs)} pairs)"


def test_pw_candidates(sim_setup):
    tmp, reads, db, truths = sim_setup
    out = str(tmp / "out.cand")
    stats = run_pw(reads, out, str(tmp / "wrk2"), PwOptions(task=0, **OPTS))
    recs = list(read_candidates(out))
    assert stats.candidates == len(recs) > 0
    for r in recs:
        assert 1 <= r.qid <= db.n_reads and 1 <= r.sid <= db.n_reads
        assert r.qid != r.sid
        assert r.qdir in (0, 1) and r.sdir == 0
        assert 0 <= r.qext < r.qsize
        assert 0 <= r.sext < r.ssize
        assert r.qsize == int(db.lengths[r.qid - 1])
        assert r.ssize == int(db.lengths[r.sid - 1])
        assert r.score >= 2


def test_pw_multivolume(sim_setup):
    """Volume splitting must not lose cross-volume overlaps."""
    tmp, reads, db, truths = sim_setup
    out1 = str(tmp / "one.m4")
    outN = str(tmp / "multi.m4")
    run_pw(reads, out1, str(tmp / "w3"), PwOptions(task=1, **OPTS))
    run_pw(reads, outN, str(tmp / "w4"),
           PwOptions(task=1, volume_bases=20000, **OPTS))
    pairs1 = {(r.qid, r.sid, r.sstrand) for r in read_m4(out1)}
    pairsN = {(min(r.qid, r.sid), max(r.qid, r.sid), r.sstrand)
              for r in read_m4(outN)}
    pairs1u = {(min(a, b), max(a, b), s) for a, b, s in pairs1}
    # multi-volume finds at least 90% of single-volume unordered pairs
    inter = len(pairs1u & pairsN)
    assert inter / max(1, len(pairs1u)) >= 0.9


def test_cli(sim_setup):
    tmp, reads, db, truths = sim_setup
    from mecat_jax.cli.mecat2pw import main
    out = str(tmp / "cli.m4")
    rc = main(["-j", "1", "-d", reads, "-o", out, "-w", str(tmp / "w5"),
               "-t", "2", "-n", "20", "-a", "500", "--kmer-size", "8",
               "--scan-stride", "4", "--scan-batch", "16",
               "--extend-batch", "64", "--align-segment", "128",
               "--align-band", "64"])
    assert rc == 0
    assert len(list(read_m4(out))) > 0


def test_pw_resume_skips_completed_shards(sim_setup):
    """Rerunning with existing volume-pair shards reprocesses nothing and
    reproduces the merged output byte-for-byte (SURVEY.md §5 resume)."""
    tmp, reads, db, truths = sim_setup
    out = str(tmp / "resume.m4")
    wrk = str(tmp / "w_resume")
    s1 = run_pw(reads, out, wrk, PwOptions(task=1, **OPTS))
    first = open(out, "rb").read()
    assert s1.candidates > 0
    s2 = run_pw(reads, out, wrk, PwOptions(task=1, **OPTS))
    assert s2.candidates == 0 and s2.extended == 0  # all shards skipped
    assert open(out, "rb").read() == first


def test_fused_batch_path_matches_staged(sim_setup):
    """The fused device batch path (GPU default) vs the staged host path:
    fused recovers ~everything staged finds (superset semantics, like the
    dist driver: top-n per strand vs per read)."""
    import mecat_jax.pipeline.pw as pwmod
    from mecat_jax.index.kmer_index import build_index
    import jax.numpy as jnp

    tmp, reads, db, truths = sim_setup
    opts = PwOptions(task=1, **OPTS)
    idx = build_index(db.codes, db.starts, db.lengths, k=opts.kmer_size)
    dev = idx.as_device_arrays()
    dev["vol_codes"] = jnp.asarray(db.codes)
    from mecat_jax.pipeline.common import bucket_length
    L = bucket_length(int(db.lengths.max()))
    qids = list(range(min(db.n_reads, opts.scan_batch)))
    staged, _ = pwmod.process_query_batch(
        db, 0, dev, idx.max_occ_cutoff, qids, opts, db,
        pwmod.PwStats(), L, L)
    fused = pwmod.process_query_batch_fused(
        db, 0, dev, idx.max_occ_cutoff, qids, opts, db,
        pwmod.PwStats(), L, L)
    s = {(r.qid, r.sid, r.sstrand) for r in staged}
    f = {(r.qid, r.sid, r.sstrand) for r in fused}
    assert len(f) > 0
    assert len(s & f) / max(1, len(s)) >= 0.95, (len(s), len(f), len(s & f))


def test_print_ext_seed_columns(sim_setup):
    """-g 1 appends two seed-point columns; -g 0 output is its prefix."""
    tmp, reads, db, truths = sim_setup
    out0 = str(tmp / "g0.m4")
    out1 = str(tmp / "g1.m4")
    run_pw(reads, out0, str(tmp / "wg0"), PwOptions(task=1, **OPTS))
    run_pw(reads, out1, str(tmp / "wg1"),
           PwOptions(task=1, print_ext=1, **OPTS))
    lines0 = open(out0).read().splitlines()
    lines1 = open(out1).read().splitlines()
    assert len(lines0) == len(lines1) > 0
    for a, b in zip(lines0, lines1):
        fb = b.split("\t")
        assert len(fb) == 14 and a.split("\t") == fb[:12]
        r = read_m4(out1)
    recs = list(read_m4(out1))
    assert all(r.qext is not None and 0 <= r.qext <= r.qsize for r in recs)
    assert all(0 <= r.sext <= r.ssize for r in recs)


def test_device_gather_byte_identical(sim_setup, monkeypatch):
    """Device-resident oriented query gather (common.device_query_volume)
    must reproduce the host oriented_batch path BYTE-identically, for both
    the staged -j 0 candidate output and the fused -j 1 M4 output (the
    gather only changes where the identical arrays are materialised)."""
    tmp, reads, db, truths = sim_setup

    def both(task, force_fused):
        outs = []
        for dev_gather in ("0", "1"):
            monkeypatch.setenv("MECAT_PW_DEV_GATHER", dev_gather)
            if force_fused:
                monkeypatch.setenv("MECAT_FORCE_FUSED", "1")
            else:
                monkeypatch.delenv("MECAT_FORCE_FUSED", raising=False)
            out = str(tmp / f"dg{task}_{dev_gather}.txt")
            run_pw(reads, out, str(tmp / f"wdg{task}_{dev_gather}"),
                   PwOptions(task=task, **OPTS))
            outs.append(open(out, "rb").read())
        return outs

    a, b = both(0, force_fused=False)          # staged candidates
    assert a == b and len(a) > 0
    a, b = both(1, force_fused=True)           # fused M4
    assert a == b and len(a) > 0


def test_device_gather_multivolume_byte_identical(sim_setup, monkeypatch):
    """Device gather across VOLUME PAIRS (vj != vi builds its own oriented
    query volume; vj == vi reuses the index volume's) must stay
    byte-identical to the host path."""
    tmp, reads, db, truths = sim_setup
    outs = []
    for dev_gather in ("0", "1"):
        monkeypatch.setenv("MECAT_PW_DEV_GATHER", dev_gather)
        monkeypatch.setenv("MECAT_FORCE_FUSED", "1")
        out = str(tmp / f"mv{dev_gather}.m4")
        run_pw(reads, out, str(tmp / f"wmv{dev_gather}"),
               PwOptions(task=1, volume_bases=20000, **OPTS))
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and len(outs[0]) > 0


def test_grouped_pulls_many_batches_byte_identical(sim_setup, monkeypatch):
    """Staged -j 0 grouped result pulls (pw.flush_scan_group) across MORE
    batches than the group size: a full group of 8 plus a partial tail
    group must still be byte-identical to the host per-batch path."""
    tmp, reads, db, truths = sim_setup
    outs = []
    small = dict(OPTS, scan_batch=2)       # 24 reads -> 12 pending batches
    for dev_gather in ("0", "1"):
        monkeypatch.setenv("MECAT_PW_DEV_GATHER", dev_gather)
        out = str(tmp / f"grp{dev_gather}.txt")
        run_pw(reads, out, str(tmp / f"wgrp{dev_gather}"),
               PwOptions(task=0, **small))
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and len(outs[0]) > 0
