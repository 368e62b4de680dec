"""mecat2ref CLI — flag-compatible with the reference tool (SURVEY.md App. A).

Usage (reference shape):
    mecat2ref -d reads.fastq -r genome.fasta -w wrk -t 16 -o out.sam -x 0|1

``-x``: output format, 0 = M4-format lines, 1 = SAM (TODO(ref): the
reference's output-format flag spelling is unverified — mount empty).
"""
from __future__ import annotations

import argparse
import sys

from .. import constants as C
from ..pipeline.ref import RefOptions, run_ref
from ..utils.log import get_logger

log = get_logger("cli.ref")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mecat2ref", description="reference mapping")
    p.add_argument("-d", dest="reads", required=True, help="reads FASTA/FASTQ")
    p.add_argument("-r", dest="reference", required=True, help="genome FASTA")
    p.add_argument("-w", dest="wrk_dir", required=True)
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("-t", dest="threads", type=int, default=1,
                   help="accepted for compatibility (device-batched instead)")
    p.add_argument("-x", dest="out_fmt", type=int, default=1, choices=(0, 1),
                   help="output format: 0 M4 lines, 1 SAM")
    p.add_argument("-n", dest="num_candidates", type=int, default=12)
    p.add_argument("-b", dest="num_extend", type=int, default=4,
                   help="candidate loci extended per strand")
    p.add_argument("-m", dest="best_n", type=int, default=1,
                   help="alignments reported per read (1 primary + m-1 "
                        "secondaries)")
    p.add_argument("-a", dest="min_align_size", type=int,
                   default=C.DEFAULT_MIN_ALIGN_SIZE)
    p.add_argument("--min-identity", type=float, default=C.MIN_OVERLAP_IDENTITY)
    p.add_argument("--kmer-size", type=int, default=C.KMER_SIZE)
    p.add_argument("--scan-stride", type=int, default=C.KMER_SCAN_STRIDE)
    p.add_argument("--scan-batch", type=int, default=C.DEFAULT_SCAN_BATCH)
    p.add_argument("--extend-batch", type=int, default=C.DEFAULT_EXTEND_BATCH)
    p.add_argument("--align-segment", type=int, default=C.ALIGN_SEGMENT)
    p.add_argument("--align-band", type=int, default=C.ALIGN_BAND)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    opts = RefOptions(
        output_format="sam" if args.out_fmt == 1 else "m4",
        num_candidates=args.num_candidates, num_extend=args.num_extend,
        best_n=args.best_n,
        min_align_size=args.min_align_size, min_identity=args.min_identity,
        kmer_size=args.kmer_size, scan_stride=args.scan_stride,
        scan_batch=args.scan_batch, extend_batch=args.extend_batch,
        align_segment=args.align_segment, align_band=args.align_band)
    stats = run_ref(args.reads, args.reference, args.output, args.wrk_dir,
                    opts)
    log.info("done: %d/%d reads mapped in %.1fs", stats.mapped, stats.reads,
             stats.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
