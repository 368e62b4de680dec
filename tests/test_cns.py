"""mecat2cns tests: tag voting units + end-to-end identity improvement."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from mecat_jax.io.fasta import write_fasta
from mecat_jax.ops.consensus import GAP, CnsTable, columns_to_tags
from mecat_jax.ops.align import MOVE_HORIZ, MOVE_MATCH, MOVE_MISMATCH, MOVE_VERT
from mecat_jax.pipeline.cns import CnsOptions, run_cns
from mecat_jax.pipeline.pw import PwOptions, run_pw
from mecat_jax.utils.sim import random_genome, simulate_reads

PW_OPTS = dict(num_candidates=20, min_align_size=500, kmer_size=8,
               scan_stride=4, scan_batch=16, extend_batch=64,
               align_segment=128, align_band=64, diag_bin=128)
CNS_OPTS = dict(min_align_size=500, min_coverage=4, min_length=500,
                min_mapping_ratio=0.3, align_segment=128, align_band=64,
                extend_batch=64, min_identity=65.0)


# ---------------------------------------------------------------------------
# unit: columns_to_tags
# ---------------------------------------------------------------------------
def test_columns_to_tags_basic():
    # template TTT vs support: match T, mismatch A, deletion, then 2 inserts
    ops = np.array([MOVE_MATCH, MOVE_MISMATCH, MOVE_HORIZ, MOVE_VERT,
                    MOVE_VERT], np.int32)
    qpos = np.array([0, 1, -1, 2, 3], np.int32)
    tpos = np.array([0, 1, 2, 3, 3], np.int32)
    support = np.array([3, 0, 1, 2], np.uint8)  # T A C G
    pos, delta, base = columns_to_tags(ops, qpos, tpos, support, tlen=10)
    got = set(zip(pos.tolist(), delta.tolist(), base.tolist()))
    assert (0, 0, 3) in got          # match T at 0
    assert (1, 0, 0) in got          # mismatch votes A at 1
    assert (2, 0, GAP) in got        # deletion at 2
    # insertions anchored at the last template column (the deletion at 2)
    assert (2, 1, 1) in got and (2, 2, 2) in got


def test_columns_to_tags_leading_insertion_dropped():
    ops = np.array([MOVE_VERT, MOVE_MATCH], np.int32)
    qpos = np.array([0, 1], np.int32)
    tpos = np.array([0, 0], np.int32)
    support = np.array([1, 2], np.uint8)
    pos, delta, base = columns_to_tags(ops, qpos, tpos, support, tlen=5)
    assert list(zip(pos.tolist(), delta.tolist(), base.tolist())) == [(0, 0, 2)]


# ---------------------------------------------------------------------------
# unit: CnsTable voting
# ---------------------------------------------------------------------------
def test_cns_table_majority_and_split():
    template = np.array([0, 1, 2, 3, 0, 1], np.uint8)  # ACGTAC
    table = CnsTable(template)
    # 5 supports vote C at position 1->A (correcting), full span
    for _ in range(5):
        pos = np.arange(6, dtype=np.int32)
        delta = np.zeros(6, np.int32)
        base = np.array([0, 0, 2, 3, 0, 1], np.int32)  # A at pos1 (was C)
        table.add_tags(pos, delta, base, (0, 6))
    table.add_template_votes()
    segs = table.call(min_coverage=4, min_length=3)
    assert len(segs) == 1
    assert segs[0].tolist() == [0, 0, 2, 3, 0, 1]


def test_cns_table_deletion_and_insertion():
    template = np.array([0, 1, 2, 3], np.uint8)
    table = CnsTable(template)
    for _ in range(6):
        # vote: pos0 A, pos1 GAP (delete), pos1 insert G after, pos2 G, pos3 T
        pos = np.array([0, 1, 1, 2, 3], np.int32)
        delta = np.array([0, 0, 1, 0, 0], np.int32)
        base = np.array([0, GAP, 2, 2, 3], np.int32)
        table.add_tags(pos, delta, base, (0, 4))
    table.add_template_votes()
    segs = table.call(min_coverage=4, min_length=2)
    assert len(segs) == 1
    # A, (C deleted), G inserted, G, T
    assert segs[0].tolist() == [0, 2, 2, 3]


def test_cns_table_low_coverage_split():
    template = np.zeros(20, np.uint8)
    table = CnsTable(template)
    for _ in range(5):
        pos = np.concatenate([np.arange(8), np.arange(12, 20)]).astype(np.int32)
        delta = np.zeros(16, np.int32)
        base = np.zeros(16, np.int32)
        table.add_tags(pos, delta, base, (0, 8))
        table.coverage[12:20] += 1  # second span
    table.add_template_votes()
    segs = table.call(min_coverage=4, min_length=5)
    assert len(segs) == 2
    assert all(len(s) == 8 for s in segs)


# ---------------------------------------------------------------------------
# end-to-end: corrected reads beat raw reads in identity to the true genome
# ---------------------------------------------------------------------------
def identity_to_genome(seq, genome):
    """Best local identity of seq against genome via the package aligner."""
    from mecat_jax.ops.align import extend_pair_batch, Q_SENTINEL, T_SENTINEL
    L = max(1024, (len(seq) + 1023) // 1024 * 1024)
    Lg = (len(genome) + 1023) // 1024 * 1024
    q = np.full((1, L), Q_SENTINEL, np.uint8)
    q[0, :len(seq)] = seq
    t = np.full((1, Lg), T_SENTINEL, np.uint8)
    t[0, :len(genome)] = genome
    # brute-force seed: exact 16-mer match
    k = 16
    for qoff in range(0, len(seq) - k, 97):
        probe = seq[qoff:qoff + k].tobytes()
        idx = genome.tobytes().find(probe)
        if idx >= 0:
            res = extend_pair_batch(
                jnp.asarray(q), jnp.asarray(t),
                jnp.asarray([len(seq)], jnp.int32),
                jnp.asarray([len(genome)], jnp.int32),
                jnp.asarray([qoff], jnp.int32), jnp.asarray([idx], jnp.int32),
                S=128, W=64, max_segs=40)
            if int(res.qend[0] - res.qbeg[0]) > 0.8 * len(seq):
                return float(res.identity[0])
    return 0.0


@pytest.fixture(scope="module")
def cns_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cns")
    genome = random_genome(8000, seed=71)
    # 30x coverage so most positions have >=4 supports
    db, truths = simulate_reads(genome, 60, mean_len=2500, min_len=1500,
                                seed=72, error_rate=0.08)
    reads = str(tmp / "reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    return tmp, reads, db, truths, genome


@pytest.mark.parametrize("input_type", [0, 1])
def test_cns_e2e(cns_setup, input_type):
    tmp, reads, db, truths, genome = cns_setup
    suffix = f"i{input_type}"
    ovl = str(tmp / f"ovl.{suffix}")
    run_pw(reads, ovl, str(tmp / f"wrk{suffix}"),
           PwOptions(task=0 if input_type == 0 else 1, **PW_OPTS))
    corrected = str(tmp / f"corrected.{suffix}.fasta")
    stats = run_cns(ovl, reads, corrected,
                    CnsOptions(input_type=input_type, **CNS_OPTS))
    assert stats.corrected_reads > 0

    from mecat_jax.io.packed_db import PackedDB
    cdb = PackedDB.from_fasta(corrected)
    # a decent fraction of reads should survive correction
    assert cdb.n_reads >= db.n_reads * 0.5

    raw_idents, cor_idents = [], []
    for i in range(min(8, cdb.n_reads)):
        cor_idents.append(identity_to_genome(cdb.read(i), genome))
    for i in range(min(8, db.n_reads)):
        raw_idents.append(identity_to_genome(db.read(i), genome))
    raw_m = np.mean([x for x in raw_idents if x > 0])
    cor_m = np.mean([x for x in cor_idents if x > 0])
    # property test (SURVEY.md §4): consensus must improve identity a lot
    assert cor_m > raw_m + 4, (raw_m, cor_m)
    assert cor_m > 96.0, cor_m


def test_cns_accuracy_gate(cns_setup):
    """Regression-gated truth accuracy (VERDICT r1 item 4): corrected reads
    scored against their KNOWN truth loci with an exact banded alignment
    (utils/accuracy).  Floors pinned ~0.4 under the measured 99.90 median /
    99.74 p5 (2026-08-17) so any vote-rule regression trips them."""
    from mecat_jax.utils.accuracy import corrected_accuracy

    tmp, reads, db, truths, genome = cns_setup
    corrected = str(tmp / "corrected.i0.fasta")  # from test_cns_e2e[0]
    import os

    if not os.path.exists(corrected):
        run_pw(reads, str(tmp / "ovl.i0"), str(tmp / "wrki0"),
               PwOptions(task=0, **PW_OPTS))
        run_cns(str(tmp / "ovl.i0"), reads, corrected,
                CnsOptions(input_type=0, **CNS_OPTS))
    rep = corrected_accuracy(corrected, genome, truths)
    s = rep.summary()
    assert s["n"] + s["split_reads"] + s["missing_reads"] == db.n_reads
    assert s["missing_reads"] <= 2, s
    assert s["median_identity"] >= 99.5, s
    assert s["p5_identity"] >= 99.0, s


def test_max_est_coverage_switch(cns_setup):
    """The estimated-coverage support cut (a deliberate divergence from the
    reference's count cap — CnsOptions.max_est_coverage TODO(ref)) must have
    an off switch for future equality debugging, and its output delta is
    pinned: capping recruits strictly fewer supports while the corrected
    accuracy stays at the uncapped level (the cut drops only redundant
    coverage; pile sweeps 2026-08-17 measured a flat identity curve >25x)."""
    from mecat_jax.utils.accuracy import corrected_accuracy

    tmp, reads, db, truths, genome = cns_setup
    ovl = str(tmp / "ovl.i0")
    import os

    if not os.path.exists(ovl):
        run_pw(reads, ovl, str(tmp / "wrki0"), PwOptions(task=0, **PW_OPTS))
    outs = {}
    for cap in (0, 12):
        out = str(tmp / f"corrected.cap{cap}.fasta")
        stats = run_cns(ovl, reads, out, CnsOptions(
            input_type=0, max_est_coverage=cap, **CNS_OPTS))
        rep = corrected_accuracy(out, genome, truths)
        outs[cap] = (stats, rep.summary())
    s_off, s_cap = outs[0][0], outs[12][0]
    assert s_cap.supports_aligned < s_off.supports_aligned, (
        s_cap.supports_aligned, s_off.supports_aligned)
    assert s_cap.corrected_reads >= 0.9 * s_off.corrected_reads
    # pinned delta: a 12x cut at ~30x input costs <0.5 median identity here
    # (the production default 25 measured flat; tools/pile_harness sweep)
    assert outs[12][1]["median_identity"] >= outs[0][1]["median_identity"] - 0.5
    # CLI pass-through: 0 disables (for_tech must not swallow a 0 override)
    assert CnsOptions.for_tech(0, max_est_coverage=0).max_est_coverage == 0


def test_cns_streamed_partition_identical(cns_setup, monkeypatch):
    """Spill-to-disk input partitioning (reference overlaps_partition role)
    must produce byte-identical corrected FASTA, with small partitions
    forcing many partition files."""
    tmp, reads, db, truths, genome = cns_setup
    ovl = str(tmp / "ovl.i0")  # produced by test_cns_e2e[0]
    import os

    if not os.path.exists(ovl):
        run_pw(reads, ovl, str(tmp / "wrki0"), PwOptions(task=0, **PW_OPTS))
    base = str(tmp / "corr_mem.fasta")
    opts = CnsOptions(input_type=0, partition_size=7, **CNS_OPTS)
    monkeypatch.setenv("MECAT_CNS_STREAM", "0")
    run_cns(ovl, reads, base, opts, db=db)
    streamed = str(tmp / "corr_stream.fasta")
    monkeypatch.setenv("MECAT_CNS_STREAM", "1")
    st = run_cns(ovl, reads, streamed, opts, db=db)
    assert st.corrected_reads > 0
    assert open(base, "rb").read() == open(streamed, "rb").read()
    assert not os.path.exists(streamed + ".parts")  # cleaned up


def test_partition_supports_native_matches_fallback(cns_setup, monkeypatch):
    tmp, reads, db, truths, genome = cns_setup
    ovl = str(tmp / "ovl.i0")
    import os

    if not os.path.exists(ovl):
        run_pw(reads, ovl, str(tmp / "wrki0"), PwOptions(task=0, **PW_OPTS))
    from mecat_jax.pipeline.cns import (load_supports,
                                        load_supports_partition,
                                        partition_supports)

    d_nat = str(tmp / "parts_native")
    parts_nat = partition_supports(ovl, db, 0, d_nat, part_size=11)
    monkeypatch.setenv("MECAT_NO_NATIVE", "1")
    d_py = str(tmp / "parts_py")
    parts_py = partition_supports(ovl, db, 0, d_py, part_size=11)
    monkeypatch.delenv("MECAT_NO_NATIVE")
    assert [(a, b) for a, b, _ in parts_nat] == [(a, b)
                                                 for a, b, _ in parts_py]
    for (_, _, pn), (_, _, pp) in zip(parts_nat, parts_py):
        assert open(pn, "rb").read() == open(pp, "rb").read()

    # partition loads reproduce the whole-file support lists exactly
    whole = load_supports(ovl, db, 0)
    seen = 0
    for t_lo, t_hi, path in parts_nat:
        part = load_supports_partition(path, 0, t_lo, t_hi)
        for t in part:
            assert t_lo <= t < t_hi
            np.testing.assert_array_equal(part.get(t), whole.get(t))
            seen += 1
    assert seen == len(whole)


# ---------------------------------------------------------------------------
# iterative correction (rounds > 1)
# ---------------------------------------------------------------------------
def test_cns_rounds_improves_and_partition_invariant(cns_setup):
    """rounds=2 realigns raw supports against the round-1 draft: accuracy
    must not regress vs rounds=1, output must be independent of the
    template partition size (drafts are built per template from
    partition-local data only), and the rounds path must bind (differ
    from rounds=1)."""
    tmp, reads, db, truths, genome = cns_setup
    ovl = str(tmp / "ovl.i0")   # built by test_cns_e2e[0]
    import os
    if not os.path.exists(ovl):
        run_pw(reads, ovl, str(tmp / "wrkr"), PwOptions(task=0, **PW_OPTS))

    out1 = str(tmp / "r1.fasta")
    out2 = str(tmp / "r2.fasta")
    out2b = str(tmp / "r2b.fasta")
    run_cns(ovl, reads, out1, CnsOptions(input_type=0, **CNS_OPTS))
    run_cns(ovl, reads, out2,
            CnsOptions(input_type=0, rounds=2, **CNS_OPTS))
    run_cns(ovl, reads, out2b,
            CnsOptions(input_type=0, rounds=2, partition_size=5,
                       **{k: v for k, v in CNS_OPTS.items()
                          if k != "partition_size"}))
    b1 = open(out1, "rb").read()
    b2 = open(out2, "rb").read()
    assert b2 != b1                       # the second round binds
    assert open(out2b, "rb").read() == b2  # partition invariance

    from mecat_jax.io.packed_db import PackedDB
    c1, c2 = PackedDB.from_fasta(out1), PackedDB.from_fasta(out2)
    m1 = np.mean([x for x in
                  (identity_to_genome(c1.read(i), genome)
                   for i in range(min(8, c1.n_reads))) if x > 0])
    m2 = np.mean([x for x in
                  (identity_to_genome(c2.read(i), genome)
                   for i in range(min(8, c2.n_reads))) if x > 0])
    assert m2 >= m1 - 0.05, (m1, m2)
