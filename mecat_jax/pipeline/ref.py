"""mecat2ref equivalent: read-to-reference mapping.

Counterpart of the reference tool (SURVEY.md §2.1 component 3, call stack
§3.3; reference ``src/mecat2ref/mecat2ref.cpp`` — unverified, mount empty).
The genome (all contigs) is packed and k-mer-indexed once; reads stream
through the same DDF scan as mecat2pw but with a genome-scale diagonal
shift, and the top candidate loci are extended with the banded aligner
collecting op tapes so SAM CIGARs are exact.  Extension works on a genome
window around each seed (|window| ~ 2|read|) rather than whole contigs, so
batch shapes stay read-sized no matter how large the genome is.

Output: SAM (soft clips; FLAG 0/16 primary, 4 unmapped, +256 secondary) or
M4-format lines (``qid`` = read, ``sid`` = contig), selected by mecat2ref's
output-format flag; up to ``best_n`` distinct loci per read.  MAPQ =
round(60 * (m1 - m2) / m1) from the best and second-best loci's match
counts (0 = ambiguous, 60 = uncontested).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..index.kmer_index import build_index
from ..io.m4 import M4Record
from ..io.packed_db import PackedDB, revcomp, upload_codes
from ..io.sam import cigar_from_ops, sam_header, sam_line, sam_unmapped
from ..ops.align import extend_pair_batch_with_ops
from ..ops.consensus_device import ops_stream
from ..ops.ddf import scan_candidates
from ..utils.log import get_logger
from .common import (bucket_length, device_query_volume,
                     gather_oriented_rows_dev, max_segs_for, oriented_batch,
                     pad_to_batch)
from .pw import _use_dev_gather as _pw_use_dev_gather

log = get_logger("ref")

#: diagonal shift for genome-scale target offsets.  Keeps diagonals of
#: contigs < 128 Mb non-negative; correctness does NOT depend on that —
#: ``ops/ddf.py`` bins diagonals with true floor division, so negative
#: diagonals (contig offsets beyond the shift) stay distinct and ordered.
#: The real ceiling is the int32 position representation: contigs and the
#: packed genome must stay < 2^31 bases (guarded in :func:`run_ref`);
#: human chr1 (248 Mb) is well inside it.  tests/test_ref.py
#: (test_diag_binning_beyond_128mb) pins the >2^27 behaviour.
GENOME_DIAG_SHIFT = 1 << 27

#: int32 position ceiling for the packed genome (see GENOME_DIAG_SHIFT note).
MAX_GENOME_BASES = (1 << 31) - 1


@dataclass
class RefOptions:
    """CLI-mirroring options (reference mecat2ref flags, SURVEY.md App. A)."""

    output_format: str = "sam"         # "sam" | "m4"
    num_candidates: int = 12           # candidate loci per strand
    num_extend: int = 4                # loci extended per strand
    #: alignments reported per read (reference "max candidate count" output
    #: role, SURVEY.md §2.1 row 3; TODO(ref): exact flag/default unverified).
    #: The best alignment is primary; the rest are SAM secondaries (FLAG
    #: 256) / extra M4 lines, distinct loci only.
    best_n: int = 1
    min_align_size: int = C.DEFAULT_MIN_ALIGN_SIZE
    min_identity: float = C.MIN_OVERLAP_IDENTITY
    kmer_size: int = C.KMER_SIZE
    scan_stride: int = C.KMER_SCAN_STRIDE
    max_occ: int = C.MAX_OCC_PER_KMER
    diag_bin: int = C.DDF_DIAG_BIN
    scan_batch: int = C.DEFAULT_SCAN_BATCH
    extend_batch: int = C.DEFAULT_EXTEND_BATCH
    align_segment: int = C.ALIGN_SEGMENT
    align_band: int = C.ALIGN_BAND


@dataclass
class RefStats:
    reads: int = 0
    mapped: int = 0
    seconds: float = 0.0
    # phase walls: the pw-style breakdown that localises where a batch's
    # time goes
    prep_s: float = 0.0      # host gather/pair assembly
    scan_s: float = 0.0      # DDF scan dispatch + candidate pull
    count_s: float = 0.0     # phase A counts-only extension (dispatch+pull)
    ops_s: float = 0.0       # phase B winner extension + op streams
    emit_s: float = 0.0      # host record formatting


def _window(tseed: int, qlen: int, contig_len: int, L_win: int):
    """Genome window [start, start+L_win) centred on the seed."""
    start = max(0, min(int(tseed) - L_win // 2, contig_len - L_win))
    start = max(0, start)
    return start, min(L_win, contig_len - start)


from functools import partial as _partial

import jax as _jax


def _ref_gather_qt(fwd, rev, ref_codes, rowi, strand, g0, wlen, L_win):
    q = jnp.where(strand[:, None] == 0, fwd[rowi], rev[rowi])
    ref_pad = jnp.concatenate(
        [ref_codes, jnp.zeros(L_win, dtype=ref_codes.dtype)])
    win = _jax.vmap(
        lambda o: _jax.lax.dynamic_slice(ref_pad, (o,), (L_win,)))(g0)
    col = jnp.arange(L_win, dtype=jnp.int32)[None, :]
    t = jnp.where(col < wlen[:, None], win, 0)
    return q, t


def _stack_pa(pa):
    """One [7, P] float32 stack of the PairAlignment fields the host needs.

    Every per-field ``np.asarray`` is one host round-trip; a
    genome-mapping batch made ~25 of them.  Positions and match counts are
    < 2^24 so the float32 cast is exact."""
    return jnp.stack([
        pa.identity,
        pa.matches.astype(jnp.float32), pa.qbeg.astype(jnp.float32),
        pa.qend.astype(jnp.float32), pa.tbeg.astype(jnp.float32),
        pa.tend.astype(jnp.float32), pa.n_segs.astype(jnp.float32)])


@_partial(_jax.jit, static_argnames=("L_win", "S", "W", "max_segs"))
def _ref_count_chunk(fwd, rev, ref_codes, rowi, strand, g0, wlen, qlen,
                     qs, ts, *, L_win, S, W, max_segs):
    """Phase-A device chunk: score every candidate locus, NO op tapes.

    The counts-only extension early-exits its segment loop and writes no
    move stream; collecting + pulling op streams for every candidate was
    ~10x the device time and ~2 MB/chunk of transfer, for tapes of which
    only the best-per-read survives.  Output is the
    stacked [7, P] result (ONE compact pull per chunk).
    """
    from ..ops.align import extend_pair_batch

    q, t = _ref_gather_qt(fwd, rev, ref_codes, rowi, strand, g0, wlen, L_win)
    return _stack_pa(extend_pair_batch(q, t, qlen, wlen, qs, ts, S=S, W=W,
                                       max_segs=max_segs))


@_partial(_jax.jit, static_argnames=("n_extend",))
def _stack_cands(c0, c1, *, n_extend: int):
    """Both strands' candidate fields as ONE [2, 5, B, ncol] int32 array."""
    def five(c):
        return jnp.stack([c.target, c.score, c.qseed, c.tseed,
                          c.valid.astype(jnp.int32)])[:, :, :n_extend]

    return jnp.stack([five(c0), five(c1)])


@_partial(_jax.jit, static_argnames=("L_win", "L_q", "S", "W", "max_segs"))
def _ref_extend_chunk(fwd, rev, ref_codes, rowi, strand, g0, wlen, qlen,
                      qs, ts, *, L_win, L_q, S, W, max_segs):
    """Phase-B device chunk (winners only): extend with ops, compact CIGAR
    stream.  Scalar fields + per-row op counts come back stacked (one
    pull); the host then pulls only a [rows, max_ops]-bucketed crop of the
    ops matrix instead of the full [P, CW] (~21 MB of which ~3 MB was
    real — the dominant term of the r4 16.7 reads/s plateau)."""
    q, t = _ref_gather_qt(fwd, rev, ref_codes, rowi, strand, g0, wlen, L_win)
    pa, right_t, left_t = extend_pair_batch_with_ops(
        q, t, qlen, wlen, qs, ts, S=S, W=W, max_segs=max_segs)
    CW = -(-(L_q + L_win + 2) // 128) * 128
    ops8 = ops_stream(right_t, left_t, qs, ts, CW=CW)
    n_ops = jnp.sum((ops8 >= 0).astype(jnp.int32), axis=1)
    stk = jnp.concatenate([_stack_pa(pa),
                           n_ops.astype(jnp.float32)[None, :]])
    return stk, ops8


@_partial(_jax.jit, static_argnames=("R", "K"))
def _crop_ops(ops8, *, R: int, K: int):
    """Bucketed [R, K] crop of the ops matrix (rows/cols padded on
    device; one small pull instead of the whole [P, CW] buffer)."""
    return _jax.lax.dynamic_slice(ops8, (0, 0), (R, K))


def map_batch(db: PackedDB, read_ids: List[int], ref_db: PackedDB, idx, dev,
              opts: RefOptions, out_lines: List[str], stats: RefStats,
              qvol=None):
    B = opts.scan_batch
    t_ph = time.time()
    L_q = bucket_length(max(int(db.lengths[r]) for r in read_ids))
    if qvol is not None:
        # reads resident on device: gather fwd/rev rows there (B int32 ids
        # uploaded instead of 2*B*L_q raw bytes per batch — the same
        # fix as pipeline.pw; see common.device_query_volume)
        ids_p, = pad_to_batch([np.asarray(read_ids, np.int32)], B)
        fwd_p, rev_p, _ = gather_oriented_rows_dev(
            qvol, ids_p, len(read_ids), L_q)
        lens = db.lengths[list(read_ids)]
        lens_p, = pad_to_batch([lens], B)
    else:
        fwd, rev, lens = oriented_batch(db, read_ids, L_q)
        fwd_p, rev_p, lens_p = pad_to_batch([fwd, rev, lens], B)
    no_self = np.full(B, -1, dtype=np.int32)
    stats.prep_s += time.time() - t_ph

    t_ph = time.time()
    cands = {}
    for strand, bases in ((0, fwd_p), (1, rev_p)):
        cands[strand] = scan_candidates(
            jnp.asarray(bases), jnp.asarray(lens_p), dev["offsets"],
            dev["pos_rid"], dev["pos_loc"],
            jnp.int32(idx.max_occ_cutoff), jnp.asarray(no_self),
            k=opts.kmer_size, stride=opts.scan_stride, max_occ=opts.max_occ,
            num_candidates=opts.num_candidates, diag_bin=opts.diag_bin,
            diag_shift=GENOME_DIAG_SHIFT)
    # ONE stacked candidate pull for both strands (was 8 per-field pulls)
    ncol = min(opts.num_extend, opts.num_candidates)
    cand_np = np.asarray(_stack_cands(cands[0], cands[1], n_extend=ncol))
    stats.scan_s += time.time() - t_ph

    # build extension pair list: top loci per strand per read (vectorised —
    # the per-read x per-locus Python loop was a per-record host cost at
    # genome-mapping scale)
    t_ph = time.time()
    L_win = min(2 * L_q + 1024, bucket_length(int(ref_db.lengths.max())))
    chunks = []  # [n, 8]: row, strand, contig, win0, qseed, tseed_loc, score, wlen
    for strand in (0, 1):
        tgt_a, score_a, qseed_a, tseed_a, valid_a = cand_np[strand]
        valid = valid_a[:len(read_ids)].astype(bool)
        r, j = np.nonzero(valid)
        if len(r) == 0:
            continue
        tgt = tgt_a[:len(read_ids)][r, j].astype(np.int64)
        tseed = tseed_a[:len(read_ids)][r, j].astype(np.int64)
        clen = ref_db.lengths[tgt].astype(np.int64)
        win0 = np.clip(np.minimum(tseed - L_win // 2, clen - L_win), 0, None)
        wlen = np.minimum(L_win, clen - win0)
        chunks.append(np.stack([
            r, np.full_like(tgt, strand), tgt, win0,
            qseed_a[:len(read_ids)][r, j].astype(np.int64),
            tseed - win0,
            score_a[:len(read_ids)][r, j].astype(np.int64),
            wlen], axis=1))
    pairs = (np.concatenate(chunks, axis=0) if chunks
             else np.zeros((0, 8), np.int64))
    stats.prep_s += time.time() - t_ph

    # Phase A: score every candidate locus with the counts-only extension
    # (no op tapes), keep best + runner-up matches per read.  Phase B
    # re-extends ONLY the winners with op collection — and only when the
    # output actually needs CIGARs (SAM); M4 needs none.  Query rows and
    # genome windows are gathered ON DEVICE (row indices / window offsets
    # are the only per-chunk upload).
    best = {}   # row -> (matches, pair index)
    second = {} # row -> matches of runner-up
    P = opts.extend_batch
    S, W = opts.align_segment, opts.align_band
    msegs = max_segs_for(L_q, S)
    bases_dev = {0: jnp.asarray(fwd_p), 1: jnp.asarray(rev_p)}
    chunk_arr = pairs
    g_start = (ref_db.starts[chunk_arr[:, 2]] + chunk_arr[:, 3]).astype(
        np.int32)

    def chunk_args(ca, g0):
        rowi = ca[:, 0].astype(np.int32)
        wlen = ca[:, 7].astype(np.int32)
        qlen_b = lens[rowi].astype(np.int32)
        qs_b = np.clip(ca[:, 4], 0, np.maximum(qlen_b - 1, 0)).astype(
            np.int32)
        ts_b = np.clip(ca[:, 5], 0, np.maximum(wlen - 1, 0)).astype(np.int32)
        padded = pad_to_batch(
            [rowi, ca[:, 1].astype(np.int32), g0.astype(np.int32), wlen,
             qlen_b, qs_b, ts_b], P)
        return [jnp.asarray(a) for a in padded]

    # dispatch EVERY phase-A chunk before the first pull: JAX dispatch is
    # async, so the (round-trip-bound) pulls overlap later chunks' device
    # compute instead of serialising with it
    t_ph = time.time()
    pend_a = []
    for ofs in range(0, len(pairs), P):
        ca = chunk_arr[ofs:ofs + P]
        args = chunk_args(ca, g_start[ofs:ofs + P])
        pend_a.append((ofs, len(ca), _ref_count_chunk(
            bases_dev[0], bases_dev[1], dev["ref_codes"], *args,
            L_win=L_win, S=S, W=W, max_segs=msegs)))

    surv = []  # per-chunk columnar survivors: [row, m, pi, strand, contig, band]
    for ofs, n, stk in pend_a:
        ca = chunk_arr[ofs:ofs + n]
        s = np.asarray(stk)          # ONE [7, P] pull per chunk
        ident, matches = s[0, :n], s[1, :n].astype(np.int64)
        qbeg, qend = s[2, :n], s[3, :n]
        tbeg_a, tend = s[4, :n].astype(np.int64), s[5, :n]
        span = np.minimum(qend - qbeg, tend - tbeg_a).astype(np.int64)
        keep = np.nonzero((span >= opts.min_align_size)
                          & (ident >= opts.min_identity))[0]
        if len(keep) == 0:
            continue
        # distinct-locus key: different seeds converging on the same
        # alignment land within a band width of the same genome start
        band = (ca[keep, 3] + tbeg_a[keep]) // max(W, 1)
        surv.append(np.stack([
            ca[keep, 0], matches[keep], ofs + keep,
            ca[keep, 1], ca[keep, 2], band], axis=1))
    stats.count_s += time.time() - t_ph

    # top best_n DISTINCT loci per read; runner-up matches drive MAPQ.
    # Columnar (no per-candidate Python loop — this host is 1-core):
    #   1. lexsort by (row, locus key, -m, pi); first entry per (row, key)
    #      group is that locus's best alignment,
    #   2. re-sort survivors by (row, -m, pi); within-row rank < best_n is
    #      reported, rank 1's matches is the MAPQ runner-up.
    if surv:
        sv = np.concatenate(surv, axis=0)
        row_c, m_c, pi_c = sv[:, 0], sv[:, 1], sv[:, 2]
        o1 = np.lexsort((pi_c, -m_c, sv[:, 5], sv[:, 4], sv[:, 3], row_c))
        key_cols = sv[o1][:, [0, 3, 4, 5]]
        first = np.ones(len(o1), dtype=bool)
        first[1:] = (key_cols[1:] != key_cols[:-1]).any(axis=1)
        d = o1[first]
        o2 = d[np.lexsort((pi_c[d], -m_c[d], row_c[d]))]
        row_d = row_c[o2]
        is_start = np.ones(len(o2), dtype=bool)
        is_start[1:] = row_d[1:] != row_d[:-1]
        idx = np.arange(len(o2))
        rank = idx - np.maximum.accumulate(np.where(is_start, idx, 0))
        for j in np.nonzero(rank < opts.best_n)[0]:
            best.setdefault(int(row_d[j]), []).append(
                (int(m_c[o2[j]]), int(pi_c[o2[j]])))
        for j in np.nonzero(rank == 1)[0]:
            second[int(row_d[j])] = int(m_c[o2[j]])

    # Phase B: selected alignments only (primary + up to best_n-1
    # secondary).  Dispatch all chunks, then pull the stacked results.
    t_ph = time.time()
    payloads = {}  # row -> [payload tuple] in rank order
    sel_rows, sel_pis = [], []
    for r in sorted(best):
        for _, pi in best[r]:
            sel_rows.append(r)
            sel_pis.append(pi)
    win_idx = np.asarray(sel_pis, dtype=np.int64)
    need_ops = opts.output_format == "sam"
    pend_b = []
    for ofs in range(0, len(win_idx), P):
        sel = win_idx[ofs:ofs + P]
        ca = chunk_arr[sel]
        args = chunk_args(ca, g_start[sel])
        if need_ops:
            stk, ops_dev = _ref_extend_chunk(
                bases_dev[0], bases_dev[1], dev["ref_codes"], *args,
                L_win=L_win, L_q=L_q, S=S, W=W, max_segs=msegs)
        else:
            stk = _ref_count_chunk(
                bases_dev[0], bases_dev[1], dev["ref_codes"], *args,
                L_win=L_win, S=S, W=W, max_segs=msegs)
            ops_dev = None
        pend_b.append((sel, stk, ops_dev))
    for sel, stk, ops_dev in pend_b:
        s = np.asarray(stk)
        if ops_dev is not None:
            n_ops = s[7].astype(np.int64)
            R = min(ops_dev.shape[0],
                    max(128, -(-len(sel) // 128) * 128))
            K = min(ops_dev.shape[1],
                    max(256, int(-(-(n_ops[:len(sel)].max(initial=0))
                                  // 256) * 256)))
            ops_np = np.asarray(_crop_ops(ops_dev, R=R, K=K))
        else:
            ops_np = None
        ident = s[0]
        qbeg, qend = s[2], s[3]
        tbeg, tend = s[4], s[5]
        for i, pi in enumerate(sel):
            row, strand, contig, win0, qs, ts, score, wlen = chunk_arr[pi]
            if ops_np is not None:
                row_ops = ops_np[i, :n_ops[i]]
            else:
                row_ops = np.zeros(0, np.int8)
            payloads.setdefault(int(row), []).append((
                int(strand), int(contig), int(win0), int(qbeg[i]),
                int(qend[i]), int(tbeg[i]), int(tend[i]), float(ident[i]),
                int(score), row_ops))
    stats.ops_s += time.time() - t_ph

    # emit records: primary first, then secondaries (FLAG 256 / extra lines)
    t_ph = time.time()
    for row, rid in enumerate(read_ids):
        stats.reads += 1
        qsize = int(db.lengths[rid])
        name = db.name(rid)
        if row not in payloads:
            if opts.output_format == "sam":
                out_lines.append(sam_unmapped(name, db.read(rid)))
            continue
        stats.mapped += 1
        m1 = best[row][0][0]
        # MAPQ from best-vs-second matches (documented formula): 0 when the
        # runner-up ties the winner (ambiguous), scaling linearly to 60 for
        # an uncontested locus — mapq = round(60 * (m1 - m2) / m1).
        m2 = second.get(row, 0)
        mapq = int(round(60.0 * (m1 - m2) / m1)) if m1 > 0 else 0
        mapq = max(0, min(60, mapq))
        for rank, payload in enumerate(payloads[row]):
            strand, contig, win0, qb, qe, tb, te, ident, score, ops = payload
            gstart = win0 + tb
            gend = win0 + te
            if opts.output_format == "sam":
                cigar = cigar_from_ops(np.asarray(ops), qb, qe, qsize)
                seq = db.read(rid) if strand == 0 else revcomp(db.read(rid))
                flag = (0 if strand == 0 else 16) | (256 if rank else 0)
                mm = best[row][rank][0]
                out_lines.append(sam_line(
                    name, flag, ref_db.name(contig), gstart,
                    mapq if rank == 0 else 0, cigar, seq,
                    tags=f"NM:i:{int((qe - qb) - mm)}\tAS:i:{mm}"))
            else:
                if strand == 0:
                    qs0, qe0 = qb, qe
                else:
                    qs0, qe0 = qsize - qe, qsize - qb
                out_lines.append(M4Record(
                    qid=rid + 1, sid=contig + 1, identity=ident, score=score,
                    qstrand=0, qstart=qs0, qend=qe0, qsize=qsize,
                    sstrand=strand, sstart=gstart, send=gend,
                    ssize=int(ref_db.lengths[contig])).format())
    stats.emit_s += time.time() - t_ph


def run_ref(reads_path: str, ref_path: str, out_path: str, wrk_dir: str,
            opts: Optional[RefOptions] = None,
            db: Optional[PackedDB] = None,
            ref_db: Optional[PackedDB] = None) -> RefStats:
    opts = opts or RefOptions()
    os.makedirs(wrk_dir, exist_ok=True)
    t0 = time.time()
    db = db or PackedDB.from_fasta(reads_path)
    ref_db = ref_db or PackedDB.from_fasta(ref_path)
    if int(ref_db.total_bases) > MAX_GENOME_BASES:
        raise ValueError(
            f"reference genome has {ref_db.total_bases} bases; the int32 "
            f"position representation caps a packed genome at "
            f"{MAX_GENOME_BASES} (~2.1 Gb). Split the FASTA into "
            f"< 2^31-base groups of contigs and map against each.")
    stats = RefStats()
    # genome codes are uploaded ONCE; the index build derives its padded
    # view on device (same dedupe as run_pw)
    ref_codes_dev = upload_codes(ref_db.codes)
    idx = build_index(ref_db.codes, ref_db.starts, ref_db.lengths,
                      k=opts.kmer_size, codes_dev=ref_codes_dev)
    dev = idx.as_device_arrays()
    dev["ref_codes"] = ref_codes_dev
    qvol = None
    if _pw_use_dev_gather() and int(db.total_bases) <= (1 << 30):
        qvol = device_query_volume(db)
    log.info("ref: %d reads vs %d contigs (%d bases)", db.n_reads,
             ref_db.n_reads, ref_db.total_bases)
    with open(out_path, "w") as fh:
        if opts.output_format == "sam":
            fh.write(sam_header(
                [(ref_db.name(i), int(ref_db.lengths[i]))
                 for i in range(ref_db.n_reads)]))
        for bs in range(0, db.n_reads, opts.scan_batch):
            ids = list(range(bs, min(db.n_reads, bs + opts.scan_batch)))
            lines: List[str] = []
            map_batch(db, ids, ref_db, idx, dev, opts, lines, stats,
                      qvol=qvol)
            for ln in lines:
                fh.write(ln + "\n")
            log.info("ref: %d/%d reads, %d mapped", stats.reads, db.n_reads,
                     stats.mapped)
    stats.seconds = time.time() - t0
    log.info("ref phases: prep %.1fs scan %.1fs count %.1fs ops %.1fs "
             "emit %.1fs (total %.1fs)", stats.prep_s, stats.scan_s,
             stats.count_s, stats.ops_s, stats.emit_s, stats.seconds)
    return stats
