"""Algorithm constants for the MECAT-capability framework.

Provenance: the reference mount (/root/reference, xiaochuanle/MECAT) was EMPTY
at build time (see SURVEY.md "PROVENANCE NOTICE"), so every constant below that
governs output equality with the reference C++ binaries is a reconstruction
from the MECAT paper (Xiao et al., Nat Methods 2017) and memory of the public
repo.  Each such constant carries a ``TODO(ref)`` marker: once the reference
tree appears, re-read the true value from its ``defs.h`` / option parsers /
``dw.cpp`` (SURVEY.md Appendix B) and update here.

Everything is centralised in this module on purpose: no other module may
hard-code an algorithm constant.
"""

# ---------------------------------------------------------------------------
# Base encoding (SURVEY.md §2.5: PackedDB packs A=0, C=1, G=2, T=3, 2 bits)
# ---------------------------------------------------------------------------
BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
N_BASES = 4
#: code used for non-ACGT input characters before packing.
#: TODO(ref): verify how the reference maps ambiguity codes (memory: maps to 0/random).
INVALID_BASE_CODE = 0

# ---------------------------------------------------------------------------
# K-mer index (SURVEY.md §2 component 1: build_lookup_table)
# ---------------------------------------------------------------------------
#: k-mer length. TODO(ref): MECAT default believed 13 (paper).
KMER_SIZE = 13
#: query-side k-mer scan stride, bases. TODO(ref): believed ~10 ("block score" scan).
KMER_SCAN_STRIDE = 10
#: k-mer frequency cutoff expressed as a multiple of the mean occurrence count;
#: k-mers more frequent than this are dropped from the index.
#: TODO(ref): reference uses an absolute cutoff derived from `-k` (default 1000?).
KMER_FREQ_CUTOFF_MULTIPLE = 128.0
#: hard cap on occurrences gathered per probed k-mer on device (fixed-shape gather).
MAX_OCC_PER_KMER = 32

# ---------------------------------------------------------------------------
# DDF (distance-difference-factor) candidate filter (SURVEY.md §0 idea 1)
# ---------------------------------------------------------------------------
#: width (bases) of a diagonal bin: hits whose (qpos - tpos) diagonals fall in
#: the same bin are treated as mutually consistent and accumulate one block
#: score. TODO(ref): reference block size believed 1000-2000bp with a relative
#: DDF threshold; we bin diagonals instead (a device-friendly segment-sum).
DDF_DIAG_BIN = 256
#: number of candidates kept per read. TODO(ref): mecat2pw -n default 100.
DEFAULT_NUM_CANDIDATES = 100
#: minimum block score for a (target, diagonal-bin) to become a candidate.
#: TODO(ref): reference minimum k-mer block score (believed >= 2..4).
MIN_BLOCK_SCORE = 2

# ---------------------------------------------------------------------------
# Banded DW / diff aligner (SURVEY.md §3.5)
# ---------------------------------------------------------------------------
#: segment length for the segmented wavefront extension.
#: TODO(ref): dw.cpp segment believed ~500bp.
ALIGN_SEGMENT = 512
#: half band width of the banded edit-distance DP (diagonal drift allowance
#: per segment; the band is re-centred after every segment).
ALIGN_BAND = 128
#: stop extending when a segment's identity falls below this.
#: TODO(ref): error tolerance believed ~0.3 (i.e. min identity ~0.7 per segment).
MIN_SEGMENT_IDENTITY = 0.65
#: minimum overall alignment identity (%) to report an overlap.
#: TODO(ref): mecat2pw filters on identity/size; exact default unknown.
MIN_OVERLAP_IDENTITY = 70.0
#: mecat2pw -a: minimum alignment size to report. TODO(ref): believed 2000 (pacbio).
DEFAULT_MIN_ALIGN_SIZE = 2000
#: per-error penalty in the local endpoint score (r + j - 2*penalty*dist):
#: errors score negative so extension endpoints trim garbage tails.
#: TODO(ref): reference stop-on-degradation constants unknown.
ALIGN_TRIM_PENALTY = 2

# ---------------------------------------------------------------------------
# Consensus (mecat2cns; SURVEY.md §3.2)
# ---------------------------------------------------------------------------
#: -c minimum coverage to call a consensus base. TODO(ref): believed 4 (pacbio) / 6?
DEFAULT_MIN_COVERAGE = 4
#: -l minimum corrected-read (segment) length. TODO(ref): believed 2000 (pacbio)/1000?
DEFAULT_MIN_CORRECTED_LENGTH = 500
#: -r minimum mapping ratio of a supporting overlap. TODO(ref): believed 0.6/0.9.
DEFAULT_MIN_MAPPING_RATIO = 0.6
#: -a minimum overlap size used by cns. TODO(ref): believed 2000 pacbio / 500 nanopore.
DEFAULT_CNS_MIN_OVERLAP = 500
#: cap on supporting reads per template pile (highest-scoring kept).
#: TODO(ref): MECAT caps effective coverage per template (believed ~coverage cap).
MAX_SUPPORTS_PER_TEMPLATE = 64
#: maximum number of inserted bases between two template positions that
#: consensus voting distinguishes (falcon-sense style (pos, delta) tags).
MAX_INS_DELTA = 15

# ---------------------------------------------------------------------------
# Volumes / batching (SURVEY.md §2 split_database, overlaps_partition)
# ---------------------------------------------------------------------------
#: maximum bases per volume when splitting a read database, for 16 GiB of
#: device memory (pipeline.pw.default_volume_bases scales it to the
#: device).  TODO(ref): reference volume size believed ~2GB packed / 4G
#: bases.  The device index-build counting sort peaks at ~40 bytes per
#: volume base; volume pairing is byte-exact (tests/test_pw_e2e.py), so
#: splitting is free correctness-wise.
DEFAULT_VOLUME_BASES = 1 << 27  # 128 Mbases at 16 GiB
#: mecat2cns -p: templates per consensus partition/batch.
DEFAULT_PARTITION_BATCH = 100_000

# ---------------------------------------------------------------------------
# Technology presets (mecat2cns -x)
# ---------------------------------------------------------------------------
TECH_PACBIO = 0
TECH_NANOPORE = 1

#: per-technology mecat2cns defaults, applied to any flag the user leaves
#: unset (reference ConsensusOptions drives these from -x; SURVEY.md §2.1
#: row 4, Appendix B).  TODO(ref): values reconstructed from memory of the
#: reference usage text — believed r 0.9/0.4, a 2000/400, c 6/6, l 5000/2000
#: for pacbio/nanopore; re-read from options.cpp when the mount appears.
#: min_identity is ours (the reference gates per-segment error instead):
#: nanopore pair alignments run ~10 points lower identity than pacbio.
CNS_TECH_PRESETS = {
    TECH_PACBIO: dict(min_mapping_ratio=0.9, min_align_size=2000,
                      min_coverage=6, min_length=5000, min_identity=70.0,
                      del_bias=0.65, ins_bias=0.6, pool_min_cov_ins=8,
                      # window-pooled insertion rule (short-tandem-repeat
                      # vote scattering; tools/diag_dels.py): strict
                      # thresholds — the ins-heavy profile has more noise
                      # insertion mass (sweep 2026-08-18: cov25
                      # 99.647 -> 99.702 median, seeds 1/7/11)
                      win_radius=4, win_mass_frac=0.6, win_peak_frac=0.35),
    TECH_NANOPORE: dict(min_mapping_ratio=0.4, min_align_size=400,
                        min_coverage=6, min_length=2000, min_identity=60.0,
                        # deletion-heavy profile: weaker pooled deletions,
                        # stronger pooled insertions (pile-harness sweep
                        # 2026-08-17: cov8 98.16 -> 98.4 median)
                        del_bias=0.5, ins_bias=0.7, pool_min_cov_ins=5,
                        # looser window rule: restoring template-deleted
                        # bases dominates (sweep 2026-08-18: cov24
                        # 98.92 -> 99.36, cov16 98.68 -> 99.09, cov8
                        # 98.07 -> 98.56 median, validated seeds 7/11)
                        win_radius=4, win_mass_frac=0.4, win_peak_frac=0.2),
}

# ---------------------------------------------------------------------------
# Device batching (ours, not reference-governed)
# ---------------------------------------------------------------------------
#: read-length bucket boundaries for padding (bases).
LENGTH_BUCKETS = (2048, 4096, 8192, 16384, 32768, 65536, 131072)
#: default query reads per device batch in the candidate scan.
DEFAULT_SCAN_BATCH = 256
#: default (query,target) pairs per device batch in the extension kernel.
DEFAULT_EXTEND_BATCH = 512

M4_IDENTITY_DECIMALS = 2  # identity printed as %.2f  TODO(ref): verify format string
