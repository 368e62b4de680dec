"""Assembly subsystem tests: ovStore, BOG unitigger, contig consensus, driver.

Strategy (SURVEY.md §4): no reference binaries exist, so correctness is
property-based — synthetic layouts with known truth for the unitigger, a
simulated genome reassembled end-to-end with identity checked against the
source genome.
"""
import os

import numpy as np
import pytest

from mecat_jax.assembly.ctgcns import CtgCnsOptions, stitch_backbone
from mecat_jax.assembly.ovstore import OverlapStore
from mecat_jax.assembly.unitig import (arrays_to_layouts, build_unitigs,
                                       layouts_to_arrays)
from mecat_jax.io.fasta import decode_bases, write_fasta
from mecat_jax.io.m4 import M4Record, write_records
from mecat_jax.io.packed_db import PackedDB, revcomp
from mecat_jax.utils.sim import random_genome


def _m4(q, s, qspan, sspan, qlen, slen, strand=0, ident=99.0, score=100):
    return M4Record(qid=q + 1, sid=s + 1, identity=ident, score=score,
                    qstrand=0, qstart=qspan[0], qend=qspan[1], qsize=qlen,
                    sstrand=strand, sstart=sspan[0], send=sspan[1],
                    ssize=slen)


def _tiled_reads(genome, n, read_len, step, flip_every=0):
    """Reads tiling the genome with fixed overlap; optional orient flips."""
    reads, orients = [], []
    for i in range(n):
        a = i * step
        r = genome[a:a + read_len]
        o = 1 if (flip_every and i % flip_every == 1) else 0
        reads.append(revcomp(r) if o else r)
        orients.append(o)
    return reads, orients


def _db_from(reads):
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    starts = np.zeros(len(reads), dtype=np.int64)
    np.cumsum(lens[:-1].astype(np.int64), out=starts[1:])
    return PackedDB(np.concatenate(reads), starts, lens,
                    [f"r{i}" for i in range(len(reads))])


def test_ovstore_symmetrised_roundtrip(tmp_path):
    recs = [_m4(0, 1, (500, 1000), (0, 500), 1000, 800),
            _m4(2, 0, (0, 300), (700, 1000), 900, 1000, strand=1)]
    m4p = str(tmp_path / "o.m4")
    write_records(m4p, recs)
    store = OverlapStore.from_m4(m4p, 3)
    assert len(store) == 4  # symmetrised
    # CSR slices per read
    s0 = store.for_read(0)
    assert np.all(store.a[s0] == 0) and set(store.b[s0].tolist()) == {1, 2}
    # save/load roundtrip
    store.save(str(tmp_path / "st"))
    st2 = OverlapStore.load(str(tmp_path / "st"))
    for c in ("a", "b", "flip", "abeg", "aend", "alen", "bbeg", "bend",
              "blen", "score"):
        assert np.array_equal(getattr(store, c), getattr(st2, c))
    assert np.allclose(store.identity, st2.identity)


def _perfect_overlaps(reads, orients, read_len, step):
    """Exact M4 records for a tiled layout (adjacent pairs only)."""
    ov = read_len - step
    out = []
    for i in range(len(reads) - 1):
        o = orients[i] ^ orients[i + 1]
        # q = read i fwd coords of its right part; on read i+1 left part
        qs = (step, read_len) if not orients[i] else (0, ov)
        ss = (0, ov) if not orients[i + 1] else (step, read_len)
        out.append(_m4(i, i + 1, qs, ss, read_len, read_len, strand=o))
    return out


@pytest.mark.parametrize("flip_every", [0, 2])
def test_unitigger_single_path(tmp_path, flip_every):
    genome = random_genome(6000, seed=10)
    read_len, step, n = 1200, 800, 7
    reads, orients = _tiled_reads(genome, n, read_len, step, flip_every)
    recs = _perfect_overlaps(reads, orients, read_len, step)
    m4p = str(tmp_path / "o.m4")
    write_records(m4p, recs)
    store = OverlapStore.from_m4(m4p, n)
    bog = build_unitigs(store, end_slack=50)
    assert len(bog.unitigs) == 1
    tig = bog.unitigs[0]
    assert len(tig.rows) == n
    got = sorted((r.read, r.offset) for r in tig.rows)
    assert [r for r, _ in got] == list(range(n))
    offs = [o for _, o in got]
    assert offs == [i * step for i in range(n)]
    # orientation chain consistent: orient[i] ^ orient[i+1] matches sim flips
    by_read = {r.read: r.orient for r in tig.rows}
    for i in range(n - 1):
        assert (by_read[i] ^ by_read[i + 1]) == (orients[i] ^ orients[i + 1])
    # round-trip layouts
    tigs2 = arrays_to_layouts(layouts_to_arrays(bog.unitigs))
    assert [(r.read, r.orient, r.offset) for r in tigs2[0].rows] == \
        [(r.read, r.orient, r.offset) for r in tig.rows]


def test_unitigger_contained_reads(tmp_path):
    # read 2 sits wholly inside read 0
    recs = [_m4(0, 1, (800, 1200), (0, 400), 1200, 1200),
            _m4(2, 0, (0, 300), (100, 400), 300, 1200)]
    m4p = str(tmp_path / "c.m4")
    write_records(m4p, recs)
    store = OverlapStore.from_m4(m4p, 3)
    bog = build_unitigs(store, end_slack=50)
    assert bog.contained[2] and not bog.contained[0] and not bog.contained[1]
    assert len(bog.unitigs) == 1
    tig = bog.unitigs[0]
    cont = [r for r in tig.rows if r.contained]
    assert len(cont) == 1 and cont[0].read == 2
    host0 = next(r for r in tig.rows if r.read == 0)
    assert cont[0].offset == host0.offset + 100


def test_stitch_backbone_reconstructs_genome():
    genome = random_genome(5000, seed=11)
    read_len, step, n = 1000, 750, 6
    reads, orients = _tiled_reads(genome, n, read_len, step, flip_every=2)
    db = _db_from(reads)
    recs = _perfect_overlaps(reads, orients, read_len, step)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        m4p = os.path.join(d, "o.m4")
        write_records(m4p, recs)
        store = OverlapStore.from_m4(m4p, n)
    bog = build_unitigs(store, end_slack=50)
    assert len(bog.unitigs) == 1
    backbone = stitch_backbone(db, bog.unitigs[0])
    want = genome[:step * (n - 1) + read_len]
    got = (backbone if np.array_equal(backbone[:50], want[:50])
           else revcomp(backbone))
    assert len(got) == len(want)
    assert np.array_equal(got, want)


def test_assembly_driver_end_to_end(tmp_path):
    """Sim genome → error-free tiled reads → contigs ≈ genome; resumable."""
    from mecat_jax.assembly.driver import AsmOptions, run_assembly
    from mecat_jax.pipeline.pw import PwOptions

    genome = random_genome(12000, seed=12)
    read_len, step = 2000, 1200
    n = (len(genome) - read_len) // step + 1
    reads, orients = _tiled_reads(genome, n, read_len, step, flip_every=3)
    db = _db_from(reads)
    reads_fa = str(tmp_path / "reads.fasta")
    write_fasta(reads_fa, [(db.name(i), db.read(i))
                           for i in range(db.n_reads)])
    wrk = str(tmp_path / "asm")
    pw = PwOptions(task=1, kmer_size=9, scan_stride=4, min_align_size=400,
                   num_candidates=16, scan_batch=16, extend_batch=32)
    opts = AsmOptions(do_trim=False, min_read_length=500,
                      min_overlap_length=400, min_contig_length=1500,
                      pw=pw, cns=CtgCnsOptions(extend_batch=16))
    report = run_assembly(reads_fa, "test", wrk, opts)
    assert report.n_contigs >= 1
    contigs = PackedDB.from_fasta(os.path.join(wrk, "test.contigs.fasta"))
    longest = contigs.read(int(np.argmax(contigs.lengths)))
    # the longest contig must cover most of the genome at high identity;
    # with error-free reads the sequence should match a genome slice exactly
    assert len(longest) >= 0.8 * len(genome)
    gs = decode_bases(genome).decode()
    cs = decode_bases(longest).decode()
    cs_rc = decode_bases(revcomp(longest)).decode()
    assert cs in gs or cs_rc in gs or _identity_vs(gs, cs) > 0.98

    # resumability: stage markers exist; rerun skips everything quickly
    for stage in ("gatekeeper", "meryl", "overlap", "ovstore", "erate",
                  "unitig", "consensus", "output"):
        assert os.path.exists(os.path.join(wrk, stage + ".done")), stage
    report2 = run_assembly(reads_fa, "test", wrk, opts)
    assert report2.n_contigs == report.n_contigs
    assert report2.stages == []  # nothing re-ran


def _identity_vs(genome: str, contig: str) -> float:
    """Cheap identity estimate via difflib (tests only)."""
    import difflib
    sm = difflib.SequenceMatcher(None, genome, contig, autojunk=False)
    return sm.ratio() * max(len(genome), len(contig)) / max(1, len(contig))


def test_erate_estimator_recovers_read_errors(tmp_path):
    """Jacobi least-squares recovers heterogeneous per-read error rates from
    pairwise divergences d_ab = e_a + e_b (+ binomial sampling noise)."""
    from mecat_jax.assembly.erate import estimate_read_erates

    rng = np.random.default_rng(41)
    n = 60
    e_true = rng.uniform(0.005, 0.06, n)
    recs = []
    for _ in range(n * 8):          # ~16 overlaps/read after symmetrisation
        a, b = rng.choice(n, size=2, replace=False)
        span = int(rng.integers(3000, 9000))
        d = e_true[a] + e_true[b]
        # binomial sampling noise of observing d over `span` columns
        d_obs = rng.binomial(span, min(d, 0.5)) / span
        recs.append(_m4(int(a), int(b), (0, span), (0, span), 10000, 10000,
                        ident=100.0 * (1.0 - d_obs)))
    m4p = str(tmp_path / "e.m4")
    write_records(m4p, recs)
    store = OverlapStore.from_m4(m4p, n)
    res = estimate_read_erates(store)
    assert res.e.shape == (n,)
    err = np.abs(res.e - e_true)
    assert float(err.max()) < 0.01
    assert float(err.mean()) < 0.003
    # residuals of true overlaps are noise-centred near zero
    assert float(np.abs(res.residual).mean()) < 0.005
    assert np.allclose(res.adj_identity,
                       100.0 * (1.0 - np.maximum(res.residual, 0)))


def test_erate_adjustment_levels_the_field(tmp_path):
    """Adjusted filtering rescues a noisy read's true overlap and drops a
    repeat-induced overlap between clean reads — the opposite of what any
    single RAW-identity cutoff can do (the true overlap's raw identity is
    LOWER than the false one's)."""
    from mecat_jax.assembly.erate import estimate_read_erates

    rng = np.random.default_rng(42)
    n = 40
    e_true = np.full(n, 0.01)
    e_true[0] = 0.10                 # one very noisy read
    recs = []
    for _ in range(n * 8):
        a, b = rng.choice(n, size=2, replace=False)
        d = e_true[a] + e_true[b]
        recs.append(_m4(int(a), int(b), (0, 5000), (0, 5000), 8000, 8000,
                        ident=100.0 * (1.0 - d)))
    # read 0's true overlap: d = 0.11 → raw identity 89.0
    recs.append(_m4(0, 1, (0, 5000), (0, 5000), 8000, 8000, ident=89.0))
    true_row = len(recs) - 1
    # repeat-induced false overlap between clean reads: d = 0.08 → raw 92.0
    recs.append(_m4(2, 3, (0, 5000), (0, 5000), 8000, 8000, ident=92.0))
    false_row = len(recs) - 1
    m4p = str(tmp_path / "f.m4")
    write_records(m4p, recs)
    store = OverlapStore.from_m4(m4p, n)
    res = estimate_read_erates(store)
    # locate the two rows in the symmetrised store
    t = np.nonzero((store.a == 0) & (store.b == 1))[0]
    f = np.nonzero((store.a == 2) & (store.b == 3))[0]
    assert len(t) >= 1 and len(f) >= 1
    t_resid = float(res.residual[t].min())
    f_resid = float(res.residual[f].min())
    assert t_resid < 0.02            # true overlap: residual ≈ 0 (rescued)
    assert f_resid > 0.04            # false overlap: residual ≈ 0.06 (dropped)
    # no raw cutoff separates them (89.0 true < 92.0 false), adjusted does
    assert store.identity[t[0]] < store.identity[f[0]]
    keep = res.residual <= 0.04
    assert keep[t[0]] and not keep[f[0]]
    del true_row, false_row


def test_meryl_spectrum_and_cutoff():
    from mecat_jax.index.meryl import (kmer_counts, kmer_histogram,
                                       pick_freq_cutoff)
    genome = random_genome(3000, seed=13)
    # db with 3 copies of the same sequence: every k-mer count divisible by 3
    db = _db_from([genome, genome, genome])
    counts = kmer_counts(db, k=12)
    assert counts.sum() == 3 * (3000 - 12 + 1)
    assert np.all(counts % 3 == 0)
    hist = kmer_histogram(db, k=12)
    assert hist.sum() == len(counts)
    assert hist[3] > 0 and hist[1] == 0 and hist[2] == 0
    cut = pick_freq_cutoff(hist)
    assert cut >= 16


def test_polish_device_matches_host():
    """Device tag-table polish == host CnsTable.call_polished, exactly."""
    from mecat_jax.assembly.ctgcns import (_polish_contig_device,
                                           _polish_contig_host,
                                           stitch_backbone)
    from mecat_jax.assembly.ovstore import OverlapStore
    from mecat_jax.assembly.unitig import build_unitigs
    from mecat_jax.io.m4 import write_records
    import tempfile

    genome = random_genome(6000, seed=77)
    read_len, step, n = 1200, 800, 7
    # noisy reads so polish has real work
    rng = np.random.default_rng(78)
    reads = []
    for i in range(n):
        r = np.array(genome[i * step:i * step + read_len])
        err = rng.random(len(r)) < 0.05
        r[err] = (r[err] + rng.integers(1, 4, err.sum())) % 4
        reads.append(r)
    db = _db_from(reads)
    recs = _perfect_overlaps(reads, [0] * n, read_len, step)
    with tempfile.TemporaryDirectory() as d:
        m4p = os.path.join(d, "o.m4")
        write_records(m4p, recs)
        store = OverlapStore.from_m4(m4p, n)
    tig = build_unitigs(store, end_slack=60).unitigs[0]
    backbone = stitch_backbone(db, tig)
    opts = CtgCnsOptions(extend_batch=8, align_segment=128, align_band=64)
    dev = _polish_contig_device(db, tig, backbone, opts)
    host = _polish_contig_host(db, tig, backbone, opts)
    assert np.array_equal(dev, host)
    assert len(dev) > 0


def test_polish_tiled_matches_host(monkeypatch):
    """Multi-tile device polish == host whole-table path: tiles overlap by a
    margin covering any read's alignment span, reads go to every tile whose
    core they can touch, and per-core emission must reproduce the
    whole-contig vote exactly."""
    import tempfile

    from mecat_jax.assembly import ctgcns
    from mecat_jax.assembly.ctgcns import (_polish_contig_device,
                                           _polish_contig_host,
                                           stitch_backbone)
    from mecat_jax.assembly.ovstore import OverlapStore
    from mecat_jax.assembly.unitig import build_unitigs
    from mecat_jax.io.m4 import write_records

    genome = random_genome(24000, seed=81)
    read_len, step, n = 1200, 800, 29
    rng = np.random.default_rng(82)
    reads = []
    for i in range(n):
        r = np.array(genome[i * step:i * step + read_len])
        err = rng.random(len(r)) < 0.05
        r[err] = (r[err] + rng.integers(1, 4, err.sum())) % 4
        reads.append(r)
    db = _db_from(reads)
    recs = _perfect_overlaps(reads, [0] * n, read_len, step)
    with tempfile.TemporaryDirectory() as d:
        m4p = os.path.join(d, "o.m4")
        write_records(m4p, recs)
        store = OverlapStore.from_m4(m4p, n)
    tig = build_unitigs(store, end_slack=60).unitigs[0]
    backbone = stitch_backbone(db, tig)
    assert len(backbone) > 15000
    opts = CtgCnsOptions(extend_batch=8, align_segment=128, align_band=64)
    # margin for 1200bp reads at S=128: bucket(1800+512)=3072; force tiles
    # of 8192 so the backbone splits into several cores of 2048
    monkeypatch.setattr(ctgcns, "_TILE_L_MAX", 8192)
    dev = _polish_contig_device(db, tig, backbone, opts)
    host = _polish_contig_host(db, tig, backbone, opts)
    assert np.array_equal(dev, host)


def test_raw_noisy_reads_to_contigs(tmp_path):
    """FULL stack on noisy reads: simulate → mecat2pw → mecat2cns
    (rounds=2) → assembly driver → contig vs truth genome.

    This is the README pipeline end-to-end at miniature scale — the other
    e2e tests cover stages in isolation or with error-free reads."""
    from mecat_jax.assembly.driver import AsmOptions, run_assembly
    from mecat_jax.assembly.ctgcns import CtgCnsOptions
    from mecat_jax.pipeline.cns import CnsOptions, run_cns
    from mecat_jax.pipeline.pw import PwOptions, run_pw
    from mecat_jax.utils.sim import simulate_reads

    genome = random_genome(20000, seed=81)
    db, _ = simulate_reads(genome, 60, mean_len=2500, min_len=1500,
                           seed=82, error_rate=0.08)
    reads_fa = str(tmp_path / "reads.fasta")
    write_fasta(reads_fa, [(db.name(i), db.read(i))
                           for i in range(db.n_reads)])
    cand = str(tmp_path / "cand.txt")
    pw_opts = dict(kmer_size=9, scan_stride=4, num_candidates=16,
                   scan_batch=16, extend_batch=32, min_align_size=400)
    run_pw(reads_fa, cand, str(tmp_path / "wrk_pw"),
           PwOptions(task=0, **pw_opts), db=db)
    corrected = str(tmp_path / "corrected.fasta")
    stats = run_cns(cand, reads_fa, corrected,
                    CnsOptions(input_type=0, rounds=2, min_align_size=400,
                               min_coverage=4, min_length=1000,
                               min_mapping_ratio=0.3, align_segment=128,
                               align_band=64, extend_batch=32,
                               min_identity=65.0), db=db)
    assert stats.corrected_reads >= 0.6 * db.n_reads

    wrk = str(tmp_path / "asm")
    report = run_assembly(
        corrected, "noisy", wrk,
        AsmOptions(do_trim=False, min_read_length=800,
                   min_overlap_length=400, min_contig_length=2000,
                   pw=PwOptions(task=1, **pw_opts),
                   cns=CtgCnsOptions(extend_batch=16)))
    assert report.n_contigs >= 1
    contigs = PackedDB.from_fasta(os.path.join(wrk, "noisy.contigs.fasta"))
    longest = contigs.read(int(np.argmax(contigs.lengths)))
    assert len(longest) >= 0.6 * len(genome)
    # exact banded infix alignment of the contig against the truth genome
    # (utils/accuracy) — _identity_vs overestimates for partial coverage
    from mecat_jax.utils.accuracy import edit_stats, identity_pct
    ident = max(
        identity_pct(edit_stats(longest, genome, band=1024, mode=1),
                     len(longest)),
        identity_pct(edit_stats(revcomp(longest), genome, band=1024,
                                mode=1), len(longest)))
    # corrected reads are ~99.9% (rounds=2); the polished contig must not
    # be worse than its inputs by more than noise
    assert ident > 99.5, ident
