"""Self-golden regression tests: pinned CPU-backend outputs.

Catch silent behavior drift (candidate selection, extension, vote rules,
formatting).  Regenerate deliberately with tests/golden/make_golden.py when
an intentional change lands.  Reference-C++ golden equality stays gated on
the reference mount (SURVEY.md §4, Appendix C).
"""
import os
import tempfile

HERE = os.path.join(os.path.dirname(__file__), "golden")


def test_pw_m4_matches_golden():
    from mecat_jax.pipeline.pw import PwOptions, run_pw
    reads = os.path.join(HERE, "reads.fasta")
    opts = PwOptions(task=1, kmer_size=9, scan_stride=4, min_align_size=400,
                     num_candidates=12, scan_batch=8, extend_batch=32,
                     align_segment=128, align_band=64, min_block_score=2)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.m4")
        run_pw(reads, out, os.path.join(d, "w"), opts)
        got = open(out, "rb").read()
    want = open(os.path.join(HERE, "overlaps.m4"), "rb").read()
    assert got == want


def test_cns_matches_golden():
    from mecat_jax.pipeline.cns import CnsOptions, run_cns
    reads = os.path.join(HERE, "reads.fasta")
    cand = os.path.join(HERE, "candidates.txt")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "corrected.fasta")
        run_cns(cand, reads, out,
                CnsOptions(min_align_size=300, min_length=500,
                           extend_batch=32, align_segment=128,
                           align_band=64))
        got = open(out, "rb").read()
    want = open(os.path.join(HERE, "corrected.fasta"), "rb").read()
    assert got == want
