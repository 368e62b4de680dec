"""Technology presets (-x) + meryl-cutoff consumption tests.

Covers the reference's per-tech ConsensusOptions defaults (SURVEY.md §2.1
row 4, Appendix B; constants.CNS_TECH_PRESETS) and the meryl→overlap-seeding
threshold wiring (SURVEY.md §2.2 row 9).
"""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from mecat_jax import constants as C
from mecat_jax.io.fasta import write_fasta
from mecat_jax.pipeline.cns import CnsOptions, run_cns
from mecat_jax.pipeline.pw import PwOptions, run_pw
from mecat_jax.utils.sim import (PROFILE_NANOPORE, random_genome,
                                 simulate_reads)


def test_for_tech_resolves_presets():
    for tech in (C.TECH_PACBIO, C.TECH_NANOPORE):
        o = CnsOptions.for_tech(tech)
        p = C.CNS_TECH_PRESETS[tech]
        assert o.tech == tech
        assert o.min_mapping_ratio == p["min_mapping_ratio"]
        assert o.min_align_size == p["min_align_size"]
        assert o.min_coverage == p["min_coverage"]
        assert o.min_length == p["min_length"]
        assert o.min_identity == p["min_identity"]
    # the two techs must actually differ (the round-1 bug: -x ignored)
    a, b = CnsOptions.for_tech(0), CnsOptions.for_tech(1)
    assert a.min_align_size != b.min_align_size
    assert a.min_length != b.min_length


def test_for_tech_overrides_and_none():
    o = CnsOptions.for_tech(C.TECH_NANOPORE, min_coverage=9,
                            min_length=None, extend_batch=32)
    assert o.min_coverage == 9                      # explicit wins
    assert o.min_length == C.CNS_TECH_PRESETS[1]["min_length"]  # None→preset
    assert o.extend_batch == 32


def test_cli_defaults_follow_tech():
    """mecat2cns CLI: unset -r/-a/-c/-l follow -x; explicit flags win."""
    from mecat_jax.cli.mecat2cns import build_parser

    args = build_parser().parse_args(["-x", "1", "in.txt", "r.fa", "o.fa"])
    o = CnsOptions.for_tech(
        args.tech, min_mapping_ratio=args.min_mapping_ratio,
        min_align_size=args.min_align_size, min_coverage=args.min_coverage,
        min_length=args.min_length)
    assert o.min_align_size == C.CNS_TECH_PRESETS[1]["min_align_size"]

    args = build_parser().parse_args(["-x", "1", "-a", "123",
                                      "in.txt", "r.fa", "o.fa"])
    o = CnsOptions.for_tech(args.tech, min_align_size=args.min_align_size)
    assert o.min_align_size == 123


def test_nanopore_e2e_config4_shape(tmp_path):
    """Config-4-shaped ONT run: nanopore error profile + nanopore presets
    (scaled-down shapes) must still correct reads."""
    genome = random_genome(8000, seed=81)
    db, _ = simulate_reads(genome, 80, mean_len=2500, min_len=1500, seed=82,
                           error_rate=0.14, profile=PROFILE_NANOPORE)
    reads = str(tmp_path / "reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    cand = str(tmp_path / "cand.txt")
    run_pw(reads, cand, str(tmp_path / "wrk"),
           PwOptions(task=0, num_candidates=20, min_align_size=400,
                     kmer_size=8, scan_stride=4, scan_batch=16,
                     extend_batch=64, align_segment=128, align_band=64,
                     diag_bin=128))
    corrected = str(tmp_path / "corrected.fasta")
    opts = CnsOptions.for_tech(
        C.TECH_NANOPORE, input_type=0, min_length=1000,
        align_segment=128, align_band=64, extend_batch=64)
    assert opts.min_align_size == C.CNS_TECH_PRESETS[1]["min_align_size"]
    assert opts.min_identity == C.CNS_TECH_PRESETS[1]["min_identity"]
    stats = run_cns(cand, reads, corrected, opts)
    assert stats.corrected_reads > 0
    assert stats.corrected_bases > 0


def test_meryl_cutoff_changes_probe_masking():
    """An absolute index cutoff (meryl role) must mask frequent k-mers at
    probe time (SURVEY.md §2.2 row 9 'Done' gate)."""
    from mecat_jax.index.kmer_index import build_index, probe_index

    db, _ = simulate_reads(random_genome(4000, seed=31), 12, mean_len=400,
                           min_len=100, seed=32)
    k = 6
    idx_lo = build_index(db.codes, db.starts, db.lengths, k=k,
                         freq_cutoff_abs=1)
    idx_hi = build_index(db.codes, db.starts, db.lengths, k=k,
                         freq_cutoff_abs=10**6)
    assert idx_lo.max_occ_cutoff == 1
    assert idx_hi.max_occ_cutoff == 10**6
    # probe every k-mer code of read 0 against both cutoffs
    from mecat_jax.index.kmer_index import kmer_codes_np
    r = db.read(0)
    codes = kmer_codes_np(r, k)[: len(r) - k + 1][None, :]
    valid_in = np.ones_like(codes, dtype=bool)
    dev = idx_lo.as_device_arrays()
    _, _, v_lo = probe_index(dev["offsets"], dev["pos_rid"], dev["pos_loc"],
                             jnp.asarray(codes), jnp.asarray(valid_in),
                             jnp.int32(idx_lo.max_occ_cutoff))
    _, _, v_hi = probe_index(dev["offsets"], dev["pos_rid"], dev["pos_loc"],
                             jnp.asarray(codes), jnp.asarray(valid_in),
                             jnp.int32(idx_hi.max_occ_cutoff))
    n_lo, n_hi = int(np.sum(np.asarray(v_lo))), int(np.sum(np.asarray(v_hi)))
    # at 15x simulated coverage most k-mers occur >1 time: the low cutoff
    # must strictly reduce surviving probe hits
    assert n_lo < n_hi
    assert n_hi > 0


def test_assembly_driver_consumes_meryl(tmp_path):
    """run_assembly must feed the meryl cutoff into the overlap stages."""
    from mecat_jax.assembly.driver import AsmOptions, run_assembly

    genome = random_genome(6000, seed=91)
    db, _ = simulate_reads(genome, 50, mean_len=2000, min_len=1200, seed=92,
                           error_rate=0.01)
    reads = str(tmp_path / "reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    pw = PwOptions(task=1, num_candidates=20, min_align_size=400,
                   kmer_size=8, scan_stride=4, scan_batch=16,
                   extend_batch=64, align_segment=128, align_band=64,
                   diag_bin=128)
    opts = AsmOptions(min_read_length=800, min_overlap_length=400,
                      do_trim=False, pw=pw)
    run_assembly(reads, "t", str(tmp_path / "wrk"), opts)
    meryl = np.load(str(tmp_path / "wrk" / "t.meryl.npz"))
    # spectrum computed at the overlapper's k, and the cutoff was wired in
    assert int(meryl["k"]) == pw.kmer_size
    assert pw.index_cutoff == int(meryl["cutoff"])


def test_vote_params_per_tech():
    """-x drives the pooled vote rules, and host/device agree under a
    non-default VoteParams."""
    from mecat_jax.ops.consensus import (VoteParams, _run_pooled_deletions,
                                         default_vote_params)
    from mecat_jax.ops.consensus_device import _run_pooled_deletions_dev

    nano = CnsOptions.for_tech(C.TECH_NANOPORE).vote_params()
    pac = CnsOptions.for_tech(C.TECH_PACBIO).vote_params()
    assert nano != pac
    assert CnsOptions().vote_params() is None       # env/builtin defaults
    assert isinstance(default_vote_params(), VoteParams)

    # a homopolymer run with split GAP votes: aggressive bias deletes one
    # more position than the weak bias; device mirrors host bit-for-bit
    rng = np.random.default_rng(17)
    L = 64
    template = np.zeros(L, np.uint8)
    template[20:28] = 1                               # CCCCCCCC run
    counts = np.zeros((L, 1, 5), np.int32)
    counts[np.arange(L), 0, template] = 9             # matches everywhere
    from mecat_jax.ops.consensus import GAP
    counts[20:28, 0, GAP] = 4                         # split deletion votes
    counts[20:28, 0, 1] -= 4
    coverage = np.full(L, 9, np.int32)
    weak = VoteParams(10, 60, 5, 8)
    strong = VoteParams(90, 60, 5, 8)
    d_weak = _run_pooled_deletions(template, counts[:, :1], coverage, 1,
                                   vote=weak)
    d_strong = _run_pooled_deletions(template, counts[:, :1], coverage, 1,
                                     vote=strong)
    assert d_strong.sum() > d_weak.sum()
    for v in (weak, strong):
        host = _run_pooled_deletions(template, counts[:, :1], coverage, 1,
                                     vote=v)
        # device takes [T, L, D1, 5] counts without the self-vote added
        dev = np.asarray(_run_pooled_deletions_dev(
            jnp.asarray(template[None].astype(np.int32)),
            jnp.asarray(counts[None]),
            jnp.asarray(coverage[None] + 1),  # host m adds self_vote
            jnp.asarray(np.array([L], np.int32)), self_vote=0, vote=v))[0]
        np.testing.assert_array_equal(host, dev.astype(bool))
