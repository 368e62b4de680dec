"""Regenerate the self-golden fixtures (run on the CPU backend).

These snapshots pin CURRENT behavior so later refactors that silently change
output semantics/formatting are caught (tests/test_golden.py).  They are NOT
reference-C++ golden files — those remain gated on the reference mount
(SURVEY.md Appendix C); regenerate deliberately when an intentional
behavior change lands, and say so in the commit message.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
HERE = os.path.dirname(os.path.abspath(__file__))

# goldens are made on the CPU backend, as the tests compare them there
os.environ["JAX_PLATFORMS"] = "cpu"


def main():
    import tempfile

    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.pipeline.cns import CnsOptions, run_cns
    from mecat_jax.pipeline.pw import PwOptions, run_pw
    from mecat_jax.utils.sim import random_genome, simulate_reads

    genome = random_genome(12000, seed=991)
    db, _ = simulate_reads(genome, 24, mean_len=2000, min_len=1200,
                           seed=992, error_rate=0.08)
    with tempfile.TemporaryDirectory() as d:
        reads = os.path.join(d, "reads.fasta")
        write_fasta(reads, [(db.name(i), db.read(i))
                            for i in range(db.n_reads)])
        with open(reads, "rb") as fh:
            open(os.path.join(HERE, "reads.fasta"), "wb").write(fh.read())
        opts = PwOptions(task=1, kmer_size=9, scan_stride=4,
                         min_align_size=400, num_candidates=12,
                         scan_batch=8, extend_batch=32, align_segment=128,
                         align_band=64, min_block_score=2)
        run_pw(reads, os.path.join(HERE, "overlaps.m4"),
               os.path.join(d, "w1"), opts, db=db)
        opts0 = PwOptions(task=0, kmer_size=9, scan_stride=4,
                          num_candidates=12, scan_batch=8,
                          min_block_score=2)
        cand = os.path.join(d, "cand.txt")
        run_pw(reads, cand, os.path.join(d, "w2"), opts0, db=db)
        with open(cand, "rb") as fh:
            open(os.path.join(HERE, "candidates.txt"), "wb").write(fh.read())
        run_cns(cand, reads, os.path.join(HERE, "corrected.fasta"),
                CnsOptions(min_align_size=300, min_length=500,
                           extend_batch=32, align_segment=128,
                           align_band=64), db=db)
    print("golden fixtures written to", HERE)


if __name__ == "__main__":
    main()
