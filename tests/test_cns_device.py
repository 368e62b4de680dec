"""Device tag-voting consensus vs the host CnsTable path: exact agreement.

correct_batch_device moves the tag tally + vote on device (the op-tape
device→host pull is the cns bottleneck on this system); it must reproduce
the host path's corrected reads exactly — same alignments, same vote rules.
"""
import numpy as np
import pytest

from mecat_jax.pipeline.cns import (CnsOptions, CnsStats, correct_batch,
                                    correct_batch_device, load_supports)
from mecat_jax.pipeline.pw import PwOptions, run_pw
from mecat_jax.io.fasta import write_fasta
from mecat_jax.utils.sim import random_genome, simulate_reads


@pytest.fixture(scope="module")
def pile(tmp_path_factory):
    d = tmp_path_factory.mktemp("cnsdev")
    genome = random_genome(9000, seed=51)
    db, _ = simulate_reads(genome, 28, mean_len=1800, min_len=1000,
                           seed=52, error_rate=0.1)
    reads = str(d / "r.fa")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    cand = str(d / "c.txt")
    run_pw(reads, cand, str(d / "w"),
           PwOptions(task=0, kmer_size=9, scan_stride=4, num_candidates=12,
                     scan_batch=8, min_block_score=2), db=db)
    by_t = load_supports(cand, db, 0)
    return db, by_t


def test_device_matches_host(pile):
    db, by_t = pile
    templates = sorted(by_t)
    opts = CnsOptions(min_align_size=300, min_length=500, extend_batch=32,
                      align_segment=128, align_band=64)
    host = correct_batch(db, templates, by_t, opts, CnsStats())
    dev = list(correct_batch_device(db, templates, by_t, opts, CnsStats()))
    assert len(host) > 0
    host_d = {n: s for n, s in host}
    dev_d = {n: s for n, s in dev}
    assert set(host_d) == set(dev_d)
    for n in host_d:
        assert np.array_equal(host_d[n], dev_d[n]), n


def test_device_stats_match(pile):
    db, by_t = pile
    templates = sorted(by_t)[:8]
    opts = CnsOptions(min_align_size=300, min_length=500, extend_batch=16,
                      align_segment=128, align_band=64)
    sh, sd = CnsStats(), CnsStats()
    correct_batch(db, templates, by_t, opts, sh)
    list(correct_batch_device(db, templates, by_t, opts, sd))
    assert sh.supports_aligned == sd.supports_aligned
    assert sh.corrected_reads == sd.corrected_reads
    assert sh.corrected_bases == sd.corrected_bases


def test_device_table_cap_subbatching(pile, monkeypatch):
    """A tiny table-bytes cap forces sub-batching; results are unchanged."""
    db, by_t = pile
    templates = sorted(by_t)
    opts = CnsOptions(min_align_size=300, min_length=500, extend_batch=32,
                      align_segment=128, align_band=64)
    full = list(correct_batch_device(db, templates, by_t, opts, CnsStats()))
    monkeypatch.setenv("MECAT_CNS_TABLE_BYTES", str(1 << 22))  # ~4 MB
    sub = list(correct_batch_device(db, templates, by_t, opts, CnsStats()))
    assert {n: s.tobytes() for n, s in full} == \
        {n: s.tobytes() for n, s in sub}


def test_device_support_windows_mixed_lengths(tmp_path):
    """Long supports vs short templates: the windowed device path must
    match the host path exactly (windows always cover the alignment)."""
    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.io.packed_db import PackedDB

    genome = random_genome(30000, seed=61)
    # short reads tile the middle; two very long reads span most of it
    reads = []
    for i in range(12):
        a = 8000 + i * 1000
        reads.append(np.asarray(genome[a:a + 1800]))
    reads.append(np.asarray(genome[2000:28000]))    # 26 kb
    reads.append(np.asarray(genome[0:25000]))       # 25 kb
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    starts = np.zeros(len(reads), dtype=np.int64)
    np.cumsum(lens[:-1].astype(np.int64), out=starts[1:])
    db = PackedDB(np.concatenate(reads), starts, lens,
                  [f"m{i}" for i in range(len(reads))])
    d = tmp_path
    reads_fa = str(d / "m.fa")
    write_fasta(reads_fa, [(db.name(i), db.read(i))
                           for i in range(db.n_reads)])
    cand = str(d / "m_cand.txt")
    run_pw(reads_fa, cand, str(d / "mw"),
           PwOptions(task=0, kmer_size=10, scan_stride=4, num_candidates=16,
                     scan_batch=8, min_block_score=2), db=db)
    by_t = load_supports(cand, db, 0)
    templates = sorted(by_t)
    opts = CnsOptions(min_align_size=400, min_length=500, extend_batch=16,
                      align_segment=128, align_band=64,
                      min_mapping_ratio=0.05)
    host = correct_batch(db, templates, by_t, opts, CnsStats())
    dev = list(correct_batch_device(db, templates, by_t, opts, CnsStats()))
    host_d = {n: s.tobytes() for n, s in host}
    dev_d = {n: s.tobytes() for n, s in dev}
    assert len(host_d) > 0
    assert host_d == dev_d


@pytest.mark.parametrize("T,L,k", [(3, 257, 1), (2, 64, 5), (1, 7, 16)])
def test_pack_emit_cov_roundtrip(T, L, k):
    """Transfer-layer nibble/bit packing is an exact inverse pair across
    odd/even L, bit-boundary L, and every slot-count regime."""
    import jax.numpy as jnp

    from mecat_jax.ops.consensus_device import pack_emit_cov, unpack_emit_cov

    rng = np.random.default_rng(L * 31 + k)
    emit = rng.integers(-1, 5, size=(T, L, 16), dtype=np.int8)
    cov = rng.integers(0, 2, size=(T, L)).astype(bool)
    packed, cbits = pack_emit_cov(jnp.asarray(emit), jnp.asarray(cov), k)
    e2, c2 = unpack_emit_cov(packed, cbits, L)
    assert np.array_equal(e2, emit[:, :, :k])
    assert np.array_equal(c2, cov)


def test_device_matches_host_window_rule(pile):
    """Exact host/device agreement with the window-pooled insertion rule
    ON (win_radius > 0, nanopore-preset-shaped thresholds)."""
    db, by_t = pile
    templates = sorted(by_t)
    opts = CnsOptions(min_align_size=300, min_length=500, extend_batch=32,
                      align_segment=128, align_band=64,
                      win_radius=4, win_mass_frac=0.4, win_peak_frac=0.2)
    host = correct_batch(db, templates, by_t, opts, CnsStats())
    dev = list(correct_batch_device(db, templates, by_t, opts, CnsStats()))
    host_d = {n: s for n, s in host}
    dev_d = {n: s for n, s in dev}
    assert set(host_d) == set(dev_d)
    for n in host_d:
        assert np.array_equal(host_d[n], dev_d[n]), n
    # the rule must actually bind on this pile vs radius 0 (different
    # output somewhere), otherwise this test is vacuous
    opts0 = CnsOptions(min_align_size=300, min_length=500, extend_batch=32,
                       align_segment=128, align_band=64)
    base = {n: s.tobytes() for n, s in
            correct_batch(db, templates, by_t, opts0, CnsStats())}
    assert {n: s.tobytes() for n, s in host} != base


def test_device_matches_host_rounds(pile):
    """rounds=2 iterative correction: device path equals host exactly
    (drafts, seed remap, and final vote all flow through shared code)."""
    from mecat_jax.pipeline.cns import correct_batch_rounds

    db, by_t = pile
    templates = sorted(by_t)
    opts = CnsOptions(min_align_size=300, min_length=500, extend_batch=32,
                      align_segment=128, align_band=64, rounds=2)
    host = list(correct_batch_rounds(db, templates, by_t, opts, CnsStats(),
                                     correct=correct_batch))
    dev = list(correct_batch_rounds(db, templates, by_t, opts, CnsStats(),
                                    correct=correct_batch_device))
    assert len(host) > 0
    assert {n: s.tobytes() for n, s in host} == \
        {n: s.tobytes() for n, s in dev}
    # stats: supports aligned twice, templates counted once
    sh = CnsStats()
    list(correct_batch_rounds(db, templates, by_t, opts, sh,
                              correct=correct_batch))
    s1 = CnsStats()
    correct_batch(db, templates, by_t,
                  CnsOptions(min_align_size=300, min_length=500,
                             extend_batch=32, align_segment=128,
                             align_band=64), s1)
    assert sh.templates == s1.templates
    assert sh.supports_aligned > s1.supports_aligned
