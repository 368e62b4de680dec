"""mecat2ref tests: mapping accuracy vs simulation truth, SAM validity."""
import re

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from mecat_jax.io.fasta import decode_bases, write_fasta
from mecat_jax.io.m4 import read_m4
from mecat_jax.io.sam import cigar_from_ops
from mecat_jax.ops.align import MOVE_HORIZ, MOVE_MATCH, MOVE_MISMATCH, MOVE_VERT
from mecat_jax.pipeline.ref import RefOptions, run_ref
from mecat_jax.utils.sim import random_genome, simulate_reads

OPTS = dict(num_candidates=8, num_extend=3, min_align_size=400,
            kmer_size=10, scan_stride=5, scan_batch=16, extend_batch=32,
            align_segment=128, align_band=64)


def test_cigar_from_ops():
    ops = np.array([MOVE_MATCH, MOVE_MATCH, MOVE_MISMATCH, MOVE_VERT,
                    MOVE_MATCH, MOVE_HORIZ, MOVE_HORIZ, MOVE_MATCH], np.int32)
    assert cigar_from_ops(ops, 2, 8, 10) == "2S3M1I1M2D1M2S"
    assert cigar_from_ops(np.zeros(0, np.int32), 0, 0, 5) == "5S"


@pytest.fixture(scope="module")
def ref_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    g1 = random_genome(30000, seed=81)
    g2 = random_genome(20000, seed=82)
    ref = str(tmp / "genome.fasta")
    write_fasta(ref, [("chr1", g1), ("chr2", g2)])
    db, truths = simulate_reads(g1, 12, mean_len=2000, min_len=1000, seed=83,
                                error_rate=0.08)
    db2, truths2 = simulate_reads(g2, 8, mean_len=2000, min_len=1000, seed=84,
                                  error_rate=0.08)
    names, seqs, truth_all = [], [], []
    for i in range(db.n_reads):
        names.append(("chr1", truths[i]))
        seqs.append((f"c1_{i}", db.read(i)))
    for i in range(db2.n_reads):
        names.append(("chr2", truths2[i]))
        seqs.append((f"c2_{i}", db2.read(i)))
    # one junk read that must stay unmapped
    seqs.append(("junk", random_genome(1500, seed=99)))
    names.append((None, None))
    reads = str(tmp / "reads.fasta")
    write_fasta(reads, seqs)
    return tmp, reads, ref, names, seqs, (g1, g2)


def parse_sam(path):
    header, lines = [], []
    for ln in open(path):
        (header if ln.startswith("@") else lines).append(ln.rstrip("\n"))
    return header, [ln.split("\t") for ln in lines]


def cigar_consumes(cigar):
    q = r = 0
    for n, op in re.findall(r"(\d+)([MIDSH])", cigar):
        n = int(n)
        if op in "MIS":
            q += n
        if op in "MD":
            r += n
    return q, r


def test_ref_sam(ref_setup):
    tmp, reads, ref, names, seqs, genomes = ref_setup
    out = str(tmp / "out.sam")
    stats = run_ref(reads, ref, out, str(tmp / "wrk"),
                    RefOptions(output_format="sam", **OPTS))
    header, lines = parse_sam(out)
    assert any("SN:chr1" in h and "LN:30000" in h for h in header)
    assert any("SN:chr2" in h and "LN:20000" in h for h in header)
    by_name = {f[0]: f for f in lines}
    assert len(lines) == len(seqs)  # one line per read

    n_correct = 0
    for (contig, truth), (name, seq) in zip(names, seqs):
        f = by_name[name]
        flag = int(f[1])
        if contig is None:
            assert flag == 4, f
            continue
        assert flag in (0, 16), f
        assert f[2] == contig
        # position within truth span (allow 100bp fuzz for clipping)
        pos = int(f[3]) - 1
        assert truth.start - 150 <= pos <= truth.end, (name, pos, truth)
        assert (flag == 16) == (truth.strand == 1)
        # CIGAR consumes the whole read and a plausible ref span
        qc, rc = cigar_consumes(f[5])
        assert qc == len(seq), (name, qc, len(seq))
        assert abs(rc - (truth.end - truth.start)) < 0.4 * len(seq)
        # SEQ orientation: flag 16 → reverse-complemented read
        n_correct += 1
    assert n_correct == len(seqs) - 1
    assert stats.mapped == n_correct


def test_ref_m4(ref_setup):
    tmp, reads, ref, names, seqs, genomes = ref_setup
    out = str(tmp / "out.m4ref")
    stats = run_ref(reads, ref, out, str(tmp / "wrk2"),
                    RefOptions(output_format="m4", **OPTS))
    recs = list(read_m4(out))
    assert stats.mapped == len(recs) == len(seqs) - 1
    for r in recs:
        contig, truth = names[r.qid - 1]
        assert r.sid == (1 if contig == "chr1" else 2)
        assert truth.start - 150 <= r.sstart <= truth.end
        assert r.identity > 70


def test_ref_cli(ref_setup):
    tmp, reads, ref, names, seqs, genomes = ref_setup
    from mecat_jax.cli.mecat2ref import main
    out = str(tmp / "cli.sam")
    rc = main(["-d", reads, "-r", ref, "-w", str(tmp / "w3"), "-o", out,
               "-x", "1", "-a", "400", "--kmer-size", "10",
               "--scan-stride", "5", "--scan-batch", "16",
               "--extend-batch", "32", "--align-segment", "128",
               "--align-band", "64"])
    assert rc == 0
    header, lines = parse_sam(out)
    assert len(lines) == len(seqs)


def test_ref_topk_secondary_and_mapq(tmp_path):
    """A duplicated genome segment forces two near-equal loci: with -m 2 the
    read reports a secondary (FLAG 256) at the other copy and its MAPQ
    collapses toward 0; unique reads keep high MAPQ."""
    seg = random_genome(8000, seed=91)
    uniq = random_genome(20000, seed=92)
    genome = np.concatenate([seg, uniq, seg])  # seg copies at 0 and 28000
    ref = str(tmp_path / "genome.fasta")
    write_fasta(ref, [("chr1", genome)])
    # read fully inside the repeat copy 1; read fully inside unique part
    reads = str(tmp_path / "reads.fasta")
    write_fasta(reads, [("rep", genome[1000:4000]),
                        ("unq", genome[12000:15000])])
    out = str(tmp_path / "out.sam")
    stats = run_ref(reads, ref, out, str(tmp_path / "wrk"),
                    RefOptions(output_format="sam", best_n=2, **OPTS))
    assert stats.mapped == 2
    header, lines = parse_sam(out)
    by_name = {}
    for f in lines:
        by_name.setdefault(f[0], []).append(f)
    rep = by_name["rep"]
    assert len(rep) == 2
    prim = [f for f in rep if not int(f[1]) & 256]
    seco = [f for f in rep if int(f[1]) & 256]
    assert len(prim) == 1 and len(seco) == 1
    # the two loci are the two copies of the repeat
    positions = sorted(int(f[3]) - 1 for f in rep)
    assert abs(positions[0] - 1000) < 200
    assert abs(positions[1] - 29000) < 200
    assert int(prim[0][4]) <= 15          # ambiguous -> low MAPQ
    assert int(seco[0][4]) == 0
    unq = by_name["unq"]
    assert len(unq) == 1
    assert int(unq[0][4]) >= 40           # unique -> high MAPQ


def _synthetic_scan(big_off, k=10, stride=5, L=2000, seed=7):
    """Scan one read against a fabricated CSR index whose occurrences sit at
    genome offset ``big_off`` (no giant array needed — the CSR is sparse)."""
    from mecat_jax.index.kmer_index import kmer_codes_np
    from mecat_jax.ops.ddf import scan_candidates
    from mecat_jax.pipeline.ref import GENOME_DIAG_SHIFT

    rng = np.random.default_rng(seed)
    read = rng.integers(0, 4, L).astype(np.uint8)
    codes = kmer_codes_np(read, k)
    qpos = np.arange(0, L, stride)
    qpos = qpos[qpos + k <= L]
    vcodes = codes[qpos]
    # consistent diagonal: loc = big_off + qpos (one run of len(qpos) hits);
    # plus decoys at scattered diagonals on a second target (score 1 runs)
    all_codes = np.concatenate([vcodes, vcodes])
    all_rid = np.concatenate([np.zeros_like(qpos), np.ones_like(qpos)])
    all_loc = np.concatenate([big_off + qpos, big_off + 7919 * qpos % (1 << 29)])
    order = np.argsort(all_codes, kind="stable")
    n_slots = 1 << (2 * k)
    offsets = np.zeros(n_slots + 1, dtype=np.int64)
    np.cumsum(np.bincount(all_codes, minlength=n_slots), out=offsets[1:])
    cand = scan_candidates(
        jnp.asarray(read[None, :]), jnp.asarray([L], np.int32),
        jnp.asarray(offsets.astype(np.int32)),
        jnp.asarray(all_rid[order].astype(np.int32)),
        jnp.asarray(all_loc[order].astype(np.int32)),
        jnp.int32(1 << 30), jnp.asarray([-1], np.int32),
        k=k, stride=stride, max_occ=4, num_candidates=4,
        diag_shift=GENOME_DIAG_SHIFT)
    return qpos, {f: np.asarray(getattr(cand, f))[0] for f in cand._fields}


def test_diag_binning_beyond_128mb():
    """DDF diagonal binning must be exact for contig offsets beyond the
    2^27 GENOME_DIAG_SHIFT (negative diagonals; human-chr1-scale contigs).
    The scan result must be translation-invariant in the genome offset."""
    # offsets congruent mod DDF_DIAG_BIN so bin boundaries translate exactly
    near = _synthetic_scan(big_off=1_024)                    # diag positive
    far = _synthetic_scan(big_off=(1 << 27) + 123_392)       # diag negative
    vfar = _synthetic_scan(big_off=(1 << 28) + 50_000_128)   # ~390 Mb contig
    for (qpos, a) in (near, far, vfar):
        assert a["valid"][0]
        assert a["target"][0] == 0
        assert a["score"][0] == len(qpos)            # the full consistent run
        assert a["score"][1] < len(qpos) // 4        # decoys never coalesce
    for key in ("score", "qseed", "valid", "target"):
        np.testing.assert_array_equal(near[1][key], far[1][key])
        np.testing.assert_array_equal(near[1][key], vfar[1][key])
    # seed target positions translate exactly with the offset
    assert far[1]["tseed"][0] - near[1]["tseed"][0] == (1 << 27) + 122_368
    assert vfar[1]["tseed"][0] - near[1]["tseed"][0] == (1 << 28) + 49_999_104


def test_ref_sam_m4_coordinates_agree(ref_setup):
    """Differential SAM <-> M4 check: the primary alignment's contig, strand,
    and genome span must agree between the two output formats."""
    tmp, reads, ref, names, seqs, genomes = ref_setup
    sam_out = str(tmp / "out.sam")       # written by test_ref_sam
    m4_out = str(tmp / "out.m4ref")      # written by test_ref_m4
    import os
    if not os.path.exists(sam_out):
        run_ref(reads, ref, sam_out, str(tmp / "wrk"),
                RefOptions(output_format="sam", **OPTS))
    if not os.path.exists(m4_out):
        run_ref(reads, ref, m4_out, str(tmp / "wrk2"),
                RefOptions(output_format="m4", **OPTS))
    header, lines = parse_sam(sam_out)
    sam_primary = {f[0]: f for f in lines
                   if not int(f[1]) & 4 and not int(f[1]) & 256}
    name_of = {i + 1: nm for i, (nm, _) in enumerate(seqs)}
    contig_id = {"chr1": 1, "chr2": 2}
    n = 0
    for r in read_m4(m4_out):
        f = sam_primary[name_of[r.qid]]
        assert contig_id[f[2]] == r.sid
        assert (int(f[1]) & 16 == 16) == (r.sstrand == 1)
        pos = int(f[3]) - 1
        assert pos == r.sstart, (f[0], pos, r.sstart)
        qc, rc = cigar_consumes(f[5])
        assert abs((pos + rc) - r.send) <= 0
        n += 1
    assert n == len(sam_primary)


def test_ref_device_gather_byte_identical(tmp_path, monkeypatch):
    """The device-resident query gather (common.device_query_volume) must
    leave mecat2ref output byte-identical to the host oriented_batch path."""
    from mecat_jax.pipeline.ref import RefOptions, run_ref
    from mecat_jax.io.fasta import write_fasta
    from mecat_jax.utils.sim import random_genome, simulate_reads
    import numpy as np

    genome = random_genome(20000, seed=71)
    db, _ = simulate_reads(genome, 12, mean_len=2500, min_len=1200, seed=72,
                           error_rate=0.1)
    reads = str(tmp_path / "reads.fasta")
    ref = str(tmp_path / "ref.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    write_fasta(ref, [("g", genome)])
    outs = []
    for dev_gather in ("0", "1"):
        monkeypatch.setenv("MECAT_PW_DEV_GATHER", dev_gather)
        out = str(tmp_path / f"out{dev_gather}.sam")
        run_ref(reads, ref, out, str(tmp_path / f"w{dev_gather}"),
                RefOptions(output_format="sam", **OPTS))
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and len(outs[0]) > 200
