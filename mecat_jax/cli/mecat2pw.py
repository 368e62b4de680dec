"""mecat2pw CLI — flag-compatible with the reference tool (SURVEY.md App. A).

Usage (reference shape):
    mecat2pw -j 0 -d reads.fasta -o candidates.txt -w wrk -t 16 [-n 100]
             [-a 2000] [-k 32] [-g 0]

``-t`` (threads) is accepted for compatibility; parallelism here is device
batching, not pthreads.  TODO(ref): exact flag defaults unverified (mount
empty) — see constants.py.
"""
from __future__ import annotations

import argparse
import sys

from .. import constants as C
from ..pipeline.pw import PwOptions, run_pw
from ..utils.log import get_logger

log = get_logger("cli.pw")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mecat2pw", description="pairwise overlap detection")
    p.add_argument("-j", dest="task", type=int, default=0, choices=(0, 1),
                   help="task: 0 = detect candidates only, 1 = full M4 overlaps")
    p.add_argument("-d", dest="reads", required=True, help="input reads FASTA/FASTQ")
    p.add_argument("-o", dest="output", required=True, help="output file")
    p.add_argument("-w", dest="wrk_dir", required=True, help="working directory")
    p.add_argument("-t", dest="threads", type=int, default=1,
                   help="accepted for compatibility (device-batched instead)")
    p.add_argument("-n", dest="num_candidates", type=int,
                   default=C.DEFAULT_NUM_CANDIDATES,
                   help="number of candidates per read")
    p.add_argument("-a", dest="min_align_size", type=int,
                   default=C.DEFAULT_MIN_ALIGN_SIZE,
                   help="minimum alignment size to report")
    p.add_argument("-k", dest="max_occ", type=int, default=C.MAX_OCC_PER_KMER,
                   help="max k-mer occurrences gathered per probe")
    p.add_argument("-g", dest="print_ext", type=int, default=0, choices=(0, 1),
                   help="1 = append gapped-extension seed point columns")
    p.add_argument("--kmer-size", type=int, default=C.KMER_SIZE)
    p.add_argument("--scan-stride", type=int, default=C.KMER_SCAN_STRIDE)
    p.add_argument("--min-identity", type=float, default=C.MIN_OVERLAP_IDENTITY)
    p.add_argument("--volume-bases", type=int, default=0,
                   help="bases per volume (0: sized from device memory)")
    p.add_argument("--scan-batch", type=int, default=C.DEFAULT_SCAN_BATCH)
    p.add_argument("--extend-batch", type=int, default=C.DEFAULT_EXTEND_BATCH)
    p.add_argument("--align-segment", type=int, default=C.ALIGN_SEGMENT)
    p.add_argument("--align-band", type=int, default=C.ALIGN_BAND)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    opts = PwOptions(
        task=args.task, num_candidates=args.num_candidates,
        min_align_size=args.min_align_size, min_identity=args.min_identity,
        kmer_size=args.kmer_size, scan_stride=args.scan_stride,
        max_occ=args.max_occ, volume_bases=args.volume_bases,
        scan_batch=args.scan_batch, extend_batch=args.extend_batch,
        align_segment=args.align_segment, align_band=args.align_band,
        print_ext=args.print_ext)
    stats = run_pw(args.reads, args.output, args.wrk_dir, opts)
    log.info("done: %d reads, %d candidates, %d overlaps in %.1fs",
             stats.reads, stats.candidates, stats.overlaps, stats.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
