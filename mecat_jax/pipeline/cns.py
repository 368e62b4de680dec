"""mecat2cns equivalent: pile-consensus error correction.

Counterpart of the reference tool (SURVEY.md §2.1 component 4, call stack
§3.2; reference ``src/mecat2cns/*`` — unverified, mount empty).  Structure:

1. parse candidates (``-i 0``, from mecat2pw -j 0) or M4 overlaps (``-i 1``),
   symmetrised so every read collects supports from both record sides
   (the reference's partition_candidates/partition_m4 role);
2. partition templates into batches (``-p``);
3. per batch: cap supports per template by score, align every
   (support → template) pair with the batched banded aligner collecting op
   tapes (device), convert tapes to (pos, delta, base) tags, vote per
   template (CnsTable), split at low coverage, emit corrected FASTA.

Corrected read headers are ``{name}_{k}`` for the k-th segment of a split
template (TODO(ref): reference header scheme unverified).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..io.fasta import format_fasta
from ..io.m4 import read_candidates, read_m4
from ..io.packed_db import PackedDB, revcomp
from ..ops.align import extend_pair_batch_with_ops
from ..ops.consensus import CnsTable, columns_to_tags, tapes_to_columns
from ..utils.device import memory_scaled, on_accelerator
from ..utils.log import get_logger
from .common import bucket_length, max_segs_for, pad_to_batch

log = get_logger("cns")


@dataclass
class CnsOptions:
    """CLI-mirroring options (reference mecat2cns flags, SURVEY.md App. A)."""

    input_type: int = 0                      # -i: 0 candidates, 1 M4
    tech: int = C.TECH_PACBIO                # -x
    partition_size: int = C.DEFAULT_PARTITION_BATCH       # -p
    min_mapping_ratio: float = C.DEFAULT_MIN_MAPPING_RATIO  # -r
    min_align_size: int = C.DEFAULT_CNS_MIN_OVERLAP       # -a
    min_coverage: int = C.DEFAULT_MIN_COVERAGE            # -c
    min_length: int = C.DEFAULT_MIN_CORRECTED_LENGTH      # -l
    max_supports: int = C.MAX_SUPPORTS_PER_TEMPLATE
    #: stop recruiting supports once their summed dovetail extents reach
    #: this many template lengths (score-sorted prefix; 0 = off).  The
    #: identity-vs-coverage curve is flat above ~25-30x (tools/pile_harness
    #: sweep 2026-08-17: 25x=99.64, 30x=99.67, 40x=99.73 median), so extra
    #: supports cost alignment time for negligible accuracy; at E. coli
    #: scale target 25 cuts supports-to-align to 54% (567k -> 306k).
    #: TODO(ref): the reference caps by count, not estimated coverage.
    max_est_coverage: int = 25
    #: estimated-coverage cap for NON-FINAL rounds (rounds > 1).  The draft
    #: only has to be mostly-clean — realignment + the final full-coverage
    #: vote wash out small draft-quality differences (pile sweep 2026-08-19)
    #: — so drafting from fewer supports cuts round-1 alignment cost ~40%
    #: at E. coli scale.  None = use max_est_coverage.
    draft_est_coverage: Optional[int] = None
    #: correction rounds (--rounds).  Rounds > 1 re-align the SAME raw
    #: supports against the previous round's full-length draft (seeds are
    #: coordinate-mapped through the draft's emit map): alignment-level
    #: degeneracies in short tandem repeats — where every support votes the
    #: template's error because equal-edit-cost paths shift identically —
    #: vanish once the template error itself is gone.  Measured on piles
    #: (2026-08-18): nanopore cov24 99.42 -> 99.87, pacbio cov25
    #: 99.62 -> 99.89 median; cost is ~2x alignment time per extra round.
    rounds: int = 1
    align_segment: int = C.ALIGN_SEGMENT
    align_band: int = C.ALIGN_BAND
    extend_batch: int = 128
    min_identity: float = C.MIN_OVERLAP_IDENTITY
    #: pooled vote-rule tuning (None -> env/builtin defaults); the -x tech
    #: presets carry per-technology values — nanopore's deletion-heavy
    #: profile wants a weaker pooled-deletion bias and a stronger pooled-
    #: insertion rule (ops/consensus.VoteParams docstring, measured sweeps).
    del_bias: Optional[float] = None
    ins_bias: Optional[float] = None
    pool_min_cov: Optional[int] = None
    pool_min_cov_ins: Optional[int] = None
    win_radius: Optional[int] = None
    win_mass_frac: Optional[float] = None
    win_peak_frac: Optional[float] = None

    def vote_params(self):
        """Resolved VoteParams (hashable; device jit-static) or None for
        the env/builtin defaults."""
        if (self.del_bias is None and self.ins_bias is None
                and self.pool_min_cov is None
                and self.pool_min_cov_ins is None
                and self.win_radius is None):
            return None
        from ..ops.consensus import default_vote_params

        d = default_vote_params()
        return d._replace(
            **{k: v for k, v in (
                ("del_bias100", None if self.del_bias is None
                 else int(round(self.del_bias * 100))),
                ("ins_bias100", None if self.ins_bias is None
                 else int(round(self.ins_bias * 100))),
                ("pool_min_cov", self.pool_min_cov),
                ("pool_min_cov_ins", self.pool_min_cov_ins),
                ("win_radius", self.win_radius),
                ("win_mass_frac100", None if self.win_mass_frac is None
                 else int(round(self.win_mass_frac * 100))),
                ("win_peak_frac100", None if self.win_peak_frac is None
                 else int(round(self.win_peak_frac * 100))),
            ) if v is not None})

    @classmethod
    def for_tech(cls, tech: int, **overrides) -> "CnsOptions":
        """Preset-resolved options: any field not in ``overrides`` (or passed
        as None) takes the per-technology default (reference ConsensusOptions
        -x behaviour, constants.CNS_TECH_PRESETS)."""
        base = dict(C.CNS_TECH_PRESETS[tech], tech=tech)
        base.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**base)


@dataclass
class CnsStats:
    templates: int = 0
    supports_aligned: int = 0
    corrected_reads: int = 0
    corrected_bases: int = 0
    seconds: float = 0.0


# a support entry: (support_read, orientation, support_seed, template_seed,
#                   score)
Support = Tuple[int, int, int, int, int]


class SupportTable:
    """Columnar per-template support lists (duck-types the former dict).

    Rows are [support_read, orientation, support_seed, template_seed, score]
    sorted by (template, score desc, input order) — ``get(t)`` returns the
    already-score-sorted rows, so the per-template ``sorted(...)[:cap]`` in
    the correct paths is a stable no-op on them.  Built vectorised from
    numeric column arrays: the per-line dict build was ~6 s for E. coli's
    867k support records and would be minutes at human scale.
    """

    def __init__(self, t_ids: np.ndarray, cols: np.ndarray,
                 tiebreak: Optional[np.ndarray] = None):
        if tiebreak is None:
            tiebreak = np.arange(len(t_ids))
        order = np.lexsort((tiebreak, -cols[:, 4], t_ids))
        self._t = t_ids[order]
        self._cols = cols[order]
        self._uniq, starts = np.unique(self._t, return_index=True)
        self._offsets = np.append(starts, len(self._t))
        self._idx = {int(v): i for i, v in enumerate(self._uniq)}

    def __iter__(self):
        return (int(v) for v in self._uniq)

    def __len__(self):
        return len(self._uniq)

    def __contains__(self, t):
        return int(t) in self._idx

    def get(self, t, default=()):
        i = self._idx.get(int(t))
        if i is None:
            return default
        return self._cols[self._offsets[i]:self._offsets[i + 1]]


def _support_columns(path: str, input_type: int):
    """Raw numeric columns of a candidate/M4 file (native parse, fallback
    Python).  Returns float64 [n, 9] or [n, 12] (extra -g columns ignored)."""
    from ..native import get as _native

    lib = _native()
    ncols = 9 if input_type == 0 else 12
    if lib is not None:
        try:
            return lib.parse_table(path, ncols)
        except ValueError:
            pass
    if input_type == 0:
        rows = [(r.qid, r.sid, r.score, r.qdir, r.qext, r.qsize, r.sdir,
                 r.sext, r.ssize) for r in read_candidates(path)]
    else:
        rows = [(r.qid, r.sid, r.identity, r.score, r.qstrand, r.qstart,
                 r.qend, r.qsize, r.sstrand, r.sstart, r.send, r.ssize)
                for r in read_m4(path)]
    return np.asarray(rows, dtype=np.float64).reshape(-1, ncols)


def _sides_from_columns(a: np.ndarray, input_type: int):
    """Both support sides of parsed records: (t1, c1, t2, c2).

    Seeds are (support position in oriented support, template position on
    the forward template).  Shared by the whole-file and partition loaders
    so they produce identical support rows.
    """
    if input_type == 0:
        qid, sid, score = a[:, 0] - 1, a[:, 1] - 1, a[:, 2]
        qdir, qext, qsize = a[:, 3], a[:, 4], a[:, 5]
        sext, ssize = a[:, 7], a[:, 8]
        # side 1: template s (fwd); qdir-oriented q aligns at (qext, sext)
        t1 = sid
        c1 = np.stack([qid, qdir, qext, sext, score], axis=1)
        # side 2: template q (fwd).  If qdir=1 the relative orientation is
        # reversed: support is rc(s); flip both seeds.
        t2 = qid
        spos2 = np.where(qdir == 0, sext, ssize - 1 - sext)
        tpos2 = np.where(qdir == 0, qext, qsize - 1 - qext)
        c2 = np.stack([sid, qdir, spos2, tpos2, score], axis=1)
    else:
        qid, sid, score = a[:, 0] - 1, a[:, 1] - 1, a[:, 3]
        qmid = (a[:, 5] + a[:, 6]) // 2
        smid = (a[:, 9] + a[:, 10]) // 2
        qsize, sstrand, ssize = a[:, 7], a[:, 8], a[:, 11]
        t1 = sid
        c1 = np.stack([qid, sstrand,
                       np.where(sstrand == 0, qmid, qsize - 1 - qmid),
                       smid, score], axis=1)
        # q fwd aligns rc(s) ⇔ rc(q) aligns s fwd
        t2 = qid
        c2 = np.stack([sid, sstrand,
                       np.where(sstrand == 0, smid, ssize - 1 - smid),
                       qmid, score], axis=1)
    return t1, c1, t2, c2


def load_supports(path: str, db: PackedDB, input_type: int) -> SupportTable:
    """Parse candidate/M4 records into per-template support lists (both
    sides)."""
    a = _support_columns(path, input_type).astype(np.int64)
    t1, c1, t2, c2 = _sides_from_columns(a, input_type)
    # score ties keep the former per-record insertion order (side 1 of
    # record i, then side 2 of record i, then record i+1): interleave
    n = len(t1)
    tb = np.concatenate([2 * np.arange(n), 2 * np.arange(n) + 1])
    return SupportTable(np.concatenate([t1, t2]), np.concatenate([c1, c2]),
                        tiebreak=tb)


def partition_supports(input_path: str, db: PackedDB, input_type: int,
                       part_dir: str, part_size: int):
    """Spill the support table to per-template-range partition files.

    The reference's overlaps_partition/partition_candidates role (SURVEY.md
    §3.2): each partition file holds the raw rows whose template sides fall
    in its id range, so consensus peak memory is bounded by one partition,
    never the whole input.  Streaming native writer when available (peak
    memory = IO buffers); NumPy fallback produces byte-identical files.
    Returns [(t_lo, t_hi, path)] for every NON-EMPTY partition.
    """
    from ..native import get as _native

    ncols = 9 if input_type == 0 else 12
    n_parts = max(1, -(-db.n_reads // part_size))
    os.makedirs(part_dir, exist_ok=True)
    lib = _native()
    if lib is not None:
        lib.partition_table(input_path, ncols, part_size, n_parts, part_dir)
    else:
        a = _support_columns(input_path, input_type)
        rows = np.concatenate([a, np.arange(len(a), dtype=np.float64)
                               [:, None]], axis=1)
        pid_q = ((a[:, 0].astype(np.int64) - 1) // part_size).clip(
            0, n_parts - 1)
        pid_s = ((a[:, 1].astype(np.int64) - 1) // part_size).clip(
            0, n_parts - 1)
        for p in range(n_parts):
            sel = rows[(pid_s == p) | (pid_q == p)]
            if len(sel):
                sel.tofile(os.path.join(part_dir, f"part_{p}.bin"))
    out = []
    for p in range(n_parts):
        path = os.path.join(part_dir, f"part_{p}.bin")
        if os.path.exists(path):
            out.append((p * part_size, min((p + 1) * part_size, db.n_reads),
                        path))
    return out


def load_supports_partition(part_path: str, input_type: int, t_lo: int,
                            t_hi: int) -> SupportTable:
    """One partition file -> SupportTable restricted to [t_lo, t_hi).

    The trailing row-index column restores the GLOBAL insertion order for
    score tie-breaks, so a partitioned run's support lists (and hence its
    corrected output) are byte-identical to the whole-file loader's.
    """
    ncols = 9 if input_type == 0 else 12
    raw = np.fromfile(part_path, dtype=np.float64).reshape(-1, ncols + 1)
    rowidx = raw[:, -1].astype(np.int64)
    a = raw[:, :ncols].astype(np.int64)
    t1, c1, t2, c2 = _sides_from_columns(a, input_type)
    m1 = (t1 >= t_lo) & (t1 < t_hi)
    m2 = (t2 >= t_lo) & (t2 < t_hi)
    return SupportTable(
        np.concatenate([t1[m1], t2[m2]]),
        np.concatenate([c1[m1], c2[m2]]),
        tiebreak=np.concatenate([2 * rowidx[m1], 2 * rowidx[m2] + 1]))


def _oriented(db: PackedDB, rid: int, direction: int) -> np.ndarray:
    r = db.read(rid)
    return revcomp(r) if direction else r


def _capped_supports(by_template, t, cap: int):
    """Top-`cap` supports of template t, score-sorted (works on both the
    columnar SupportTable and plain dict-of-tuple-lists)."""
    sups = by_template.get(t, ())
    if not isinstance(sups, np.ndarray):
        sups = sorted(sups, key=lambda x: -x[4])
    return sups[:cap]


def select_supports(db: PackedDB, by_template, t, opts: CnsOptions):
    """Deterministic support selection for one template (host AND device
    paths — host/device output parity depends on both using this).

    Score-sorted cap (``max_supports``), then an estimated-coverage cut:
    stop at the first support whose cumulative dovetail extent reaches
    ``max_est_coverage`` template lengths.  The extent formula matches the
    mapping-ratio gate, so the estimate upper-bounds what each support can
    contribute."""
    sups = _capped_supports(by_template, t, opts.max_supports)
    target = opts.max_est_coverage
    if not target or len(sups) == 0:
        return sups
    a = np.asarray(sups, dtype=np.int64).reshape(-1, 5)
    tlen = int(db.lengths[t])
    qlen = db.lengths[a[:, 0]].astype(np.int64)
    spos = np.clip(a[:, 2], 0, np.maximum(qlen - 1, 0))
    tpos = np.clip(a[:, 3], 0, tlen - 1)
    extent = (np.minimum(spos, tpos)
              + np.minimum(qlen - spos, tlen - tpos))
    cum = np.cumsum(extent)
    # index of the first support that reaches the target (inclusive)
    n_keep = int(np.searchsorted(cum, target * tlen, side="left")) + 1
    return sups[:max(n_keep, 1)]


def _orient_rows(rows, lens, flip):
    """Device row-wise orient: reverse-complement rows where flip==1.

    rows uint8 [B, L] forward bases left-padded at 0; lens int32 [B];
    flip int32 [B].  Flipped rows come out as revcomp(rows[:len]) followed
    by zero padding — identical to the host ``revcomp(read)`` layout.
    """
    import jax.numpy as jnp

    B, L = rows.shape
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = jnp.where(flip[:, None] == 1,
                    jnp.clip(lens[:, None] - 1 - col, 0, L - 1), col)
    g = jnp.take_along_axis(rows, src, axis=1)
    g = jnp.where(flip[:, None] == 1, 3 - g.astype(jnp.int32),
                  g.astype(jnp.int32))
    return jnp.where(col < lens[:, None], g, 0).astype(jnp.uint8)


def correct_batch(db: PackedDB, templates: List[int],
                  by_template: Dict[int, List[Support]], opts: CnsOptions,
                  stats: CnsStats,
                  _draft: bool = False) -> List[Tuple[str, np.ndarray]]:
    """Align supports and vote consensus for one partition of templates.

    With ``_draft=True`` (iterative correction, opts.rounds > 1) returns
    [(template_id, (draft_bases, pos_map))] via CnsTable.call_draft
    instead of named corrected segments, and does not touch the
    templates/corrected_* stats."""
    # build the pair list, grouped by template
    pairs = []  # (template, support, dir, spos, tpos)
    for t in templates:
        for s, sdir, spos, tpos, score in select_supports(
                db, by_template, t, opts):
            pairs.append((int(t), int(s), int(sdir), int(spos), int(tpos)))
    if not pairs:
        return []

    L_t = bucket_length(max(int(db.lengths[t]) for t in templates))
    L_s = bucket_length(max(int(db.lengths[p[1]]) for p in pairs))
    S, W = opts.align_segment, opts.align_band
    msegs = max_segs_for(max(L_t, L_s), S)
    P = opts.extend_batch

    vote = opts.vote_params()
    tables: Dict[int, CnsTable] = {}
    for ofs in range(0, len(pairs), P):
        chunk = pairs[ofs:ofs + P]
        n = len(chunk)
        q_b = np.zeros((n, L_s), dtype=np.uint8)
        t_b = np.zeros((n, L_t), dtype=np.uint8)
        qlen = np.zeros(n, np.int32)
        tlen = np.zeros(n, np.int32)
        qs = np.zeros(n, np.int32)
        ts = np.zeros(n, np.int32)
        sup_bases = []
        for i, (t, s, sdir, spos, tpos) in enumerate(chunk):
            sb = _oriented(db, s, sdir)[:L_s]
            tb = db.read(t)[:L_t]
            q_b[i, :len(sb)] = sb
            t_b[i, :len(tb)] = tb
            qlen[i], tlen[i] = len(sb), len(tb)
            qs[i] = min(max(spos, 0), len(sb) - 1)
            ts[i] = min(max(tpos, 0), len(tb) - 1)
            sup_bases.append(sb)
        q_p, t_p, qlen_p, tlen_p, qs_p, ts_p = pad_to_batch(
            [q_b, t_b, qlen, tlen, qs, ts], P)
        pa, right_t, left_t = extend_pair_batch_with_ops(
            jnp.asarray(q_p), jnp.asarray(t_p), jnp.asarray(qlen_p),
            jnp.asarray(tlen_p), jnp.asarray(qs_p), jnp.asarray(ts_p),
            S=S, W=W, max_segs=msegs)
        stats.supports_aligned += n

        cols = tapes_to_columns(right_t, left_t, qs_p, ts_p, n_pairs=n)
        ident = np.asarray(pa.identity)[:n]
        tbeg = np.asarray(pa.tbeg)[:n]
        tend = np.asarray(pa.tend)[:n]
        qbeg = np.asarray(pa.qbeg)[:n]
        qend = np.asarray(pa.qend)[:n]
        for i, (t, s, sdir, spos, tpos) in enumerate(chunk):
            span = int(tend[i] - tbeg[i])
            # mapping ratio vs the maximal DOVETAIL EXTENT the seed allows
            # (min over each side of what support and template can consume),
            # NOT the full support length: a long support overlapping a
            # short template can never align most of itself, and the full-
            # length denominator silently discarded ~75% of real supports
            # on short E. coli templates (measured 2026-08-17; effective
            # pile coverage 38x -> 8x, the dominant accuracy loss).
            # TODO(ref): exact reference ratio denominator unverified.
            extent = (min(int(qs[i]), int(ts[i]))
                      + min(int(qlen[i]) - int(qs[i]),
                            int(tlen[i]) - int(ts[i])))
            ratio = (qend[i] - qbeg[i]) / max(1, extent)
            if (ident[i] < opts.min_identity or span < opts.min_align_size
                    or ratio < opts.min_mapping_ratio):
                continue
            if t not in tables:
                tables[t] = CnsTable(db.read(t))
            pos, delta, base = columns_to_tags(
                *cols[i], support=sup_bases[i], tlen=int(db.lengths[t]))
            tables[t].add_tags(pos, delta, base,
                               (int(tbeg[i]), int(tend[i])))

    out: List[Tuple[str, np.ndarray]] = []
    for t in templates:
        table = tables.get(t)
        if _draft:
            if table is not None:
                table.add_template_votes()
                out.append((t, table.call_draft(
                    min_coverage=opts.min_coverage, vote=vote)))
            continue
        stats.templates += 1
        if table is None:
            continue
        table.add_template_votes()
        segs = table.call(min_coverage=opts.min_coverage,
                          min_length=opts.min_length, vote=vote)
        for k, seg in enumerate(segs):
            out.append((f"{db.name(t)}_{k}", seg))
            stats.corrected_reads += 1
            stats.corrected_bases += len(seg)
    return out


def plan_table_slices(db: PackedDB, templates: List[int],
                      cap: Optional[int] = None) -> List[List[int]]:
    """Split a template batch into device-table-sized sub-batches.

    The device tag tables cost L_t * D1 * 5 * 4 bytes per template slot.
    Templates are sorted by LENGTH and sliced greedily so every sub-batch
    pads to its own L_t bucket AND stays under the table-bytes cap — one
    very long template must not dictate every sub-batch's shape, and the
    CLI's partition size (-p) never dictates HBM footprint.
    """
    if cap is None:
        # 512 MiB at 16 GiB of device memory, scaled to the device
        env = os.environ.get("MECAT_CNS_TABLE_BYTES")
        cap = int(env) if env else memory_scaled(1 << 29)
    D1 = C.MAX_INS_DELTA + 1
    L_t_all = bucket_length(max(int(db.lengths[t]) for t in templates),
                            pow2=True)
    if len(templates) * L_t_all * D1 * 5 * 4 <= cap:
        return [list(templates)]
    by_len = sorted(templates, key=lambda t: int(db.lengths[t]))
    out = []
    a = 0
    while a < len(by_len):
        b = a + 1
        while b < len(by_len):
            L_t_b = bucket_length(int(db.lengths[by_len[b]]), pow2=True)
            if (b + 1 - a) * L_t_b * D1 * 5 * 4 > cap:
                break
            b += 1
        # floor the slice to a multiple of TEMPLATE_SLOT_BUCKET: the device
        # table shape [T, L_t, ...] keys every chunk/vote compile, and a
        # free-running T made nearly EVERY full-scale slice a fresh
        # compile.
        # Leftovers pad up with inert slots at dispatch instead.
        if b - a > TEMPLATE_SLOT_BUCKET:
            b = a + ((b - a) // TEMPLATE_SLOT_BUCKET) * TEMPLATE_SLOT_BUCKET
        out.append(by_len[a:b])
        a = b
    return out


#: device-table row granularity (see plan_table_slices)
TEMPLATE_SLOT_BUCKET = 32


def plan_pairs(db: PackedDB, templates: List[int], by_template,
               opts: CnsOptions, L_t: int, msegs: int):
    """Vectorised (template, support) pair metadata for one table slice.

    Returns None when no template has supports; otherwise a dict of arrays
    sorted by per-pair segment budget (see the budget derivation below) with
    keys: pairs [N,5] (t, s, dir, spos, tpos), qlen, tlen, qs, ts (int32),
    segs_r, segs_l (int64 per-direction budgets), slot (int32 row in the
    slice's tag table).
    """
    S, W = opts.align_segment, opts.align_band
    sup_list, t_rep = [], []
    for t in templates:
        s = select_supports(db, by_template, t, opts)
        if len(s):
            sup_list.append(np.asarray(s, dtype=np.int64).reshape(-1, 5))
            t_rep.append(np.full(len(s), t, dtype=np.int64))
    if not sup_list:
        return None
    sups_a = np.concatenate(sup_list)
    pairs_a = np.column_stack([np.concatenate(t_rep), sups_a[:, :4]])
    slot_of = {t: i for i, t in enumerate(templates)}

    # vectorised pair metadata (the per-pair Python loop was host-bound)
    all_qlen = db.lengths[pairs_a[:, 1]].astype(np.int32)  # FULL lengths
    all_tlen = np.minimum(db.lengths[pairs_a[:, 0]], L_t).astype(np.int32)
    all_qs = np.clip(pairs_a[:, 3], 0, all_qlen - 1).astype(np.int32)
    all_ts = np.clip(pairs_a[:, 4], 0, all_tlen - 1).astype(np.int32)

    # Per-direction segment budgets, exact from host-side metadata: every
    # applied non-final segment advances >= eff = S - S//4 query bases
    # (seg_step's continue rule), so the QUERY side bounds segments by
    # (qlen - qs)/eff (+2: one final partial segment plus one crawl-tail
    # margin); the TEMPLATE side consumed right of the seed is <= tlen - ts
    # (left: ts + 1) and band drift bounds q_adv - t_adv by W//2 per
    # segment, giving segs <= (span/eff + 1) * eff/(eff - W//2).  The MIN of
    # the two sides is the budget — the query side usually binds (supports
    # are shorter than the padded template bucket) and cut issued segment
    # lanes 1.57x at E. coli scale.  Chunks are
    # grouped by budget so one long one-sided pair cannot widen every
    # chunk's DP scan, traceback lane count and tag-fold width
    # (budget-sized, the dominant cns costs).
    eff = S - S // 4
    factor = eff / (eff - W // 2)
    segs_r = np.ceil(factor * ((all_tlen - all_ts) / eff + 1)).astype(np.int64)
    segs_l = np.ceil(factor * ((all_ts + 1) / eff + 1)).astype(np.int64)
    segs_r = np.minimum(segs_r,
                        (np.ceil((all_qlen - all_qs) / eff) + 2).astype(np.int64))
    segs_l = np.minimum(segs_l,
                        (np.ceil((all_qs + 1) / eff) + 2).astype(np.int64))
    segs_r = np.minimum(segs_r, msegs)
    segs_l = np.minimum(segs_l, msegs)
    order = np.argsort(segs_r + segs_l, kind="stable")
    pairs_a = pairs_a[order]
    return dict(pairs=pairs_a,
                qlen=all_qlen[order], tlen=all_tlen[order],
                qs=all_qs[order], ts=all_ts[order],
                segs_r=segs_r[order], segs_l=segs_l[order],
                slot=np.asarray([slot_of[t] for t in pairs_a[:, 0]],
                                np.int32))


def seg_bucket(n: int, msegs: int) -> int:
    """Coarse segment-budget ladder: every (msegs_r, msegs_l) combo is a
    separate compile; powers of two bound the combo
    count while keeping the scan within 2x of the exact budget."""
    for b in (8, 16, 32, 64, 96):
        if n <= b:
            return min(b, msegs)
    return msegs


def correct_batch_device(db: PackedDB, templates: List[int],
                         by_template: Dict[int, List[Support]],
                         opts: CnsOptions, stats: CnsStats,
                         dev_vol=None, _draft: bool = False):
    """Device-resident variant of :func:`correct_batch` (a GENERATOR).

    Same alignments, but tags are tallied and voted ON DEVICE
    (ops/consensus_device.py) instead of pulling each batch's op tapes
    (~80 MB) to the host.  The volume uploads once (``dev_vol`` caches it across
    partitions); per chunk only pair ids/seeds go up and nothing comes back
    until the final int8 emit/coverage arrays.  Corrected reads are YIELDED
    per table slice so callers stream them to disk — an interrupted run
    keeps everything finished so far (the list form lost an hour-long run
    to a timeout 64 templates before the end).

    Table slices run DEPTH-1 PIPELINED: slice k+1's pair planning and chunk
    dispatches (all async under JAX) are queued before slice k's emit pull,
    so the host-side plan/emit/split work of one slice hides under the
    device alignment time of the next (same pattern as pipeline/pw.py's
    dispatch/collect split; the emit pull was a serial per-slice cost).
    """
    if dev_vol is None:
        dev_vol = device_volume(db)   # upload once, not once per slice
    slices = plan_table_slices(db, templates)
    preps = [None] * len(slices)
    if (os.environ.get("MECAT_CNS_PRECOMPILE", "1") == "1"
            and len(slices) > 2):
        # plan every slice upfront (the plans are consumed by dispatch, so
        # this is moved work, not extra work) and warm the chunk/vote
        # compile ladder from background threads, so compiles overlap
        # execution instead of serialising with it.
        preps = [_prepare_slice(db, sl, by_template, opts) for sl in slices]
        _start_ladder_warmer(preps, opts, dev_vol, draft_mode=_draft)
    collect = _collect_slice_drafts if _draft else _collect_slice_device
    pending = None
    done = 0
    for sl, prep in zip(slices, preps):
        nxt = _dispatch_slice_device(db, sl, by_template, opts, stats,
                                     dev_vol, draft_mode=_draft, prep=prep)
        if pending is not None:
            yield from collect(db, pending, opts, stats)
            done += 1
            if len(slices) > 1:
                log.info("cns: table slice %d/%d collected (%d corrected)",
                         done, len(slices), stats.corrected_reads)
        pending = nxt
    if pending is not None:
        yield from collect(db, pending, opts, stats)


def _slice_shapes(db: PackedDB, templates: List[int], opts: CnsOptions):
    """Static shape tuple (T, L_t, L_s, msegs, P, D1) of one table slice."""
    T = -(-len(templates) // TEMPLATE_SLOT_BUCKET) * TEMPLATE_SLOT_BUCKET
    L_t = bucket_length(max(int(db.lengths[t]) for t in templates),
                        pow2=True)
    L_s = bucket_length(min(int(db.lengths.max()), 3 * L_t), pow2=True)
    S = opts.align_segment
    msegs = max_segs_for(min(max(L_t, L_s), int(1.4 * L_t) + 2 * S), S)
    return T, L_t, L_s, msegs, opts.extend_batch, C.MAX_INS_DELTA + 1


def _prepare_slice(db: PackedDB, templates: List[int], by_template,
                   opts: CnsOptions):
    """Plan + derive every jit key one slice will need (see
    correct_batch_device's warmer)."""
    T, L_t, L_s, msegs, P, D1 = _slice_shapes(db, templates, opts)
    plan = plan_pairs(db, templates, by_template, opts, L_t, msegs)
    keys = []
    if plan is not None:
        for ofs in range(0, len(plan["pairs"]), P):
            sl = slice(ofs, ofs + P)
            keys.append((L_s, L_t, T,
                         seg_bucket(int(plan["segs_r"][sl].max()), msegs),
                         seg_bucket(int(plan["segs_l"][sl].max()), msegs)))
    return dict(shapes=(T, L_t, L_s, msegs, P, D1), plan=plan,
                chunk_keys=keys)


_WARMED: set = set()


def _start_ladder_warmer(preps, opts: CnsOptions, dev_vol,
                         draft_mode: bool) -> None:
    """Issue every NEW chunk/vote compile from daemon threads, in first-use
    order, COMPILE-ONLY (``.lower(...).compile()`` on ShapeDtypeStructs):
    compiles overlap the main loop's execution and populate the persistent
    compilation cache, so the main loop's first call per shape
    deserialises instead of compiling.  No device buffers — an earlier
    dummy-execution variant stacked donated tables from 3 threads on top
    of the live run and exhausted device memory."""
    import threading
    from queue import Queue

    import jax
    from ..ops.consensus_device import call_tables
    import jax.numpy as jnp

    jobs = []
    seen = set()
    S, W = opts.align_segment, opts.align_band
    filt = (float(opts.min_identity), int(opts.min_align_size),
            float(opts.min_mapping_ratio))
    vote = opts.vote_params()
    for prep in preps:
        if prep["plan"] is None:
            continue
        T, L_t, L_s, msegs, P, D1 = prep["shapes"]
        for (L_s_k, L_t_k, T_k, mr, ml) in prep["chunk_keys"]:
            key = ("chunk", L_s_k, L_t_k, T_k, mr, ml)
            if key not in seen and key not in _WARMED:
                seen.add(key)
                jobs.append(key + (P,))
        vkey = ("vote", T, L_t, D1)
        if vkey not in seen and vkey not in _WARMED:
            seen.add(vkey)
            jobs.append(vkey)
    if not jobs:
        return
    q: Queue = Queue()
    for j in jobs:
        q.put(j)

    vol_cat, starts_d, lengths_d = dev_vol[0], dev_vol[1], dev_vol[2]
    sds = lambda shape, dt: jax.ShapeDtypeStruct(shape, dt)
    i32, u8, b8 = jnp.int32, jnp.uint8, jnp.bool_
    vol_sd = sds(vol_cat.shape, vol_cat.dtype)
    st_sd = sds(starts_d.shape, starts_d.dtype)
    ln_sd = sds(lengths_d.shape, lengths_d.dtype)

    def work():
        while True:
            try:
                job = q.get_nowait()
            except Exception:
                return
            try:
                if job[0] == "chunk":
                    _, L_s_k, L_t_k, T_k, mr, ml, P_k = job
                    fn = _get_chunk_jit(
                        L_s=L_s_k, L_t=L_t_k, S=S, W=W, max_segs=mr,
                        max_segs_left=ml, min_identity=filt[0],
                        min_align_size=filt[1], min_mapping_ratio=filt[2])
                    pi = sds((P_k,), i32)
                    fn.lower(
                        sds((T_k, L_t_k, C.MAX_INS_DELTA + 1, 5), i32),
                        sds((T_k, L_t_k + 1), i32), sds((T_k,), b8),
                        vol_sd, st_sd, ln_sd, sds((), i32), pi, pi, pi,
                        pi, pi, pi, pi, pi, sds((P_k,), b8)).compile()
                else:
                    _, T_k, L_t_k, D1_k = job
                    call_tables.lower(
                        sds((T_k, L_t_k, D1_k, 5), i32),
                        sds((T_k, L_t_k + 1), i32), sds((T_k, L_t_k), u8),
                        sds((T_k,), i32), sds((T_k,), b8), sds((), i32),
                        draft_mode=draft_mode, vote=vote).compile()
                _WARMED.add(job[:6] if job[0] == "chunk" else job)
            except Exception as e:    # pragma: no cover - best effort
                log.info("cns: ladder warmer: %s failed (%s)", job[0], e)

    n_threads = int(os.environ.get("MECAT_CNS_PRECOMPILE_THREADS", "3"))
    log.info("cns: warming %d compile-ladder shapes on %d threads",
             len(jobs), n_threads)
    for _ in range(min(n_threads, len(jobs))):
        threading.Thread(target=work, daemon=True).start()


def _dispatch_slice_device(db: PackedDB, templates: List[int],
                           by_template, opts: CnsOptions, stats: CnsStats,
                           dev_vol, draft_mode: bool = False, prep=None):
    """Plan + dispatch one table slice's device work (all calls async).

    Returns (templates, emit_dev, cov_ok_dev, has_dev) — device arrays the
    collector pulls later — or None when no template in the slice has
    supports.  ``prep`` (from :func:`_prepare_slice`) supplies a
    precomputed plan + shapes (the compile-ladder warmer path).
    """
    from .. import constants as C
    from ..ops.consensus_device import call_tables
    import jax.numpy as jnp

    timers = os.environ.get("MECAT_CNS_TIMERS") == "1"
    t_start = time.time() if timers else 0.0

    # [T, L_t] keys every chunk/vote compile (see plan_table_slices /
    # _slice_shapes), so T is padded to the slot bucket: inert slots never
    # accumulate tags (no pair references them) and never emit (has stays
    # False).  L_s is a pure function of L_t (DB-wide max read length), and
    # msegs bounds per-direction consumption at ~1.4x the template.
    if prep is not None:
        T, L_t, L_s, msegs, P, D1 = prep["shapes"]
        plan = prep["plan"]
    else:
        T, L_t, L_s, msegs, P, D1 = _slice_shapes(db, templates, opts)
        plan = plan_pairs(db, templates, by_template, opts, L_t, msegs)
    S, W = opts.align_segment, opts.align_band
    if plan is None:
        return None
    t_plan = (time.time() - t_start) if timers else 0.0

    if dev_vol is None:
        dev_vol = device_volume(db)
    vol_cat, starts_d, lengths_d, n_bases = dev_vol[:4]

    counts = jnp.zeros((T, L_t, D1, 5), jnp.int32)
    cov_diff = jnp.zeros((T, L_t + 1), jnp.int32)
    has = jnp.zeros(T, dtype=bool)
    ids_pad = np.asarray(
        list(templates) + [templates[0]] * (T - len(templates)), np.int32)
    tmpl_ids = jnp.asarray(ids_pad)
    tmpl_mat = _gather_rows_dev(vol_cat, starts_d, lengths_d, tmpl_ids, L_t)
    tmpl_len = np.minimum(db.lengths[ids_pad], L_t).astype(np.int32)

    pairs_a = plan["pairs"]
    for ofs in range(0, len(pairs_a), P):
        sl = slice(ofs, ofs + P)
        n = len(pairs_a[sl])
        real = np.zeros(P, dtype=bool)
        real[:n] = True
        msegs_r = seg_bucket(int(plan["segs_r"][sl].max()), msegs)
        msegs_l = seg_bucket(int(plan["segs_l"][sl].max()), msegs)
        s_ids, t_ids, qlen, tlen, qs, ts, t_slot, sdir, real_p = pad_to_batch(
            [pairs_a[sl, 1].astype(np.int32), pairs_a[sl, 0].astype(np.int32),
             plan["qlen"][sl], plan["tlen"][sl], plan["qs"][sl],
             plan["ts"][sl], plan["slot"][sl],
             pairs_a[sl, 2].astype(np.int32), real[:n]], P)
        counts, cov_diff, has = _cns_chunk_device(
            counts, cov_diff, has, vol_cat, starts_d, lengths_d, n_bases,
            jnp.asarray(s_ids), jnp.asarray(t_ids), jnp.asarray(qlen),
            jnp.asarray(tlen), jnp.asarray(qs), jnp.asarray(ts),
            jnp.asarray(t_slot), jnp.asarray(sdir), jnp.asarray(real_p),
            L_s=L_s, L_t=L_t, S=S, W=W, max_segs=msegs_r,
            max_segs_left=msegs_l,
            min_identity=opts.min_identity,
            min_align_size=opts.min_align_size,
            min_mapping_ratio=opts.min_mapping_ratio)
        stats.supports_aligned += n

    if timers:
        # force-sync the chunk ladder so align time is separated from the
        # vote/pull below (debug-only: this defeats the depth-1 pipelining)
        t0 = time.time()
        np.asarray(has[0])
        log.info("cns-timer: slice T=%d L_t=%d pairs=%d chunks=%d "
                 "plan=%.2fs dispatch+align=%.2fs",
                 T, L_t, len(pairs_a), -(-len(pairs_a) // P), t_plan,
                 time.time() - t_start - t_plan)
        t_start = time.time()
    emit, cov_ok = call_tables(counts, cov_diff, tmpl_mat,
                               jnp.asarray(tmpl_len), has,
                               jnp.int32(opts.min_coverage),
                               draft_mode=draft_mode,
                               vote=opts.vote_params())
    # squeeze the device-side transfer now but pull NOTHING yet: the int
    # count of non-empty insertion slots is the collector's first (tiny)
    # sync point.  MUST be jitted: the eager form materialised a [T, L, 15]
    # slice + bool + int32 copy chain (~4-5x a table slice) and OOMed HBM
    # at the fragmented tail of 970-slice cov-20 runs (round 5).
    n_ins = _count_ins_slots(emit)
    if timers:
        np.asarray(n_ins)
        log.info("cns-timer: vote=%.2fs", time.time() - t_start)
    return templates, emit, cov_ok, has, n_ins


def _count_ins_slots(emit):
    """max over templates/positions of non-empty insertion slots (jitted
    so the [T, L, 15] comparison fuses into one reduction — no transient
    copies; see _dispatch_slice_device)."""
    import jax

    global _COUNT_INS_JIT
    if _COUNT_INS_JIT is None:
        _COUNT_INS_JIT = jax.jit(lambda e: jnp.max(
            jnp.sum((e[:, :, 1:] >= 0).astype(jnp.int32), axis=2)))
    return _COUNT_INS_JIT(emit)


_COUNT_INS_JIT = None


def _collect_slice_device(db: PackedDB, pending, opts: CnsOptions,
                          stats: CnsStats):
    """Pull one dispatched slice's emit arrays and yield corrected segments.

    Pulls only the delta slots that actually emitted anything: insertion
    runs longer than 1-2 are vanishingly rare, and the [T, L, 16] int8 pull
    was the dominant per-slice transfer (the prefix rule makes the
    truncation exact — dropped slots are all -1).  The surviving arrays are
    nibble/bit-packed on device (pack_emit_cov) so the transfer carries
    ~2.2x fewer bytes; unpacked exactly on the host."""
    from ..ops.consensus_device import (pack_emit_cov, split_called,
                                        unpack_emit_cov)

    templates, emit, cov_ok, has, n_ins = pending
    timers = os.environ.get("MECAT_CNS_TIMERS") == "1"
    t0 = time.time() if timers else 0.0
    max_ins = int(n_ins)
    L = emit.shape[1]
    packed, cbits = pack_emit_cov(emit, cov_ok, max_ins + 1)
    emit, cov_ok = unpack_emit_cov(packed, cbits, L)
    has_support = np.asarray(has)
    if timers:
        log.info("cns-timer: pull=%.2fs (emit %s, max_ins %d)",
                 time.time() - t0, emit.shape, max_ins)

    for i, t in enumerate(templates):
        stats.templates += 1
        if not has_support[i]:
            continue
        segs = split_called(emit[i], cov_ok[i], int(db.lengths[t]),
                            opts.min_length)
        for k, seg in enumerate(segs):
            stats.corrected_reads += 1
            stats.corrected_bases += len(seg)
            yield (f"{db.name(t)}_{k}", seg)


def _collect_slice_drafts(db: PackedDB, pending, opts: CnsOptions,
                          stats: CnsStats):
    """Draft-mode twin of _collect_slice_device: yields
    (template_id, (draft_bases, pos_map)) per supported template.

    Same packed emit pull; emit_to_draft (shared with the host
    CnsTable.call_draft) turns the emit rows into the full-length draft
    plus the old→new coordinate map for pass-2 seed remapping."""
    from ..ops.consensus import emit_to_draft
    from ..ops.consensus_device import pack_emit_cov, unpack_emit_cov

    templates, emit, cov_ok, has, n_ins = pending
    max_ins = int(n_ins)
    L = emit.shape[1]
    packed, cbits = pack_emit_cov(emit, cov_ok, max_ins + 1)
    emit, cov_ok = unpack_emit_cov(packed, cbits, L)
    has_support = np.asarray(has)
    for i, t in enumerate(templates):
        if not has_support[i]:
            continue
        tl = int(db.lengths[t])
        draft, pos_map = emit_to_draft(emit[i][:tl])
        yield t, (draft, pos_map)


class _DeviceVolume(NamedTuple):
    vol_cat: "jnp.ndarray"     # [cap] uint8 [fwd | rc | slack | reserve]
    starts: "jnp.ndarray"      # [R_cap] int32 (rows past `n_reads` inert)
    lengths: "jnp.ndarray"     # [R_cap] int32
    n_bases: int               # forward-base count (rc addressing)
    used: int = -1             # next free write offset (-1: no reserve)
    n_reads: int = -1          # rows currently meaningful (-1: no reserve)


def device_volume(db: PackedDB, reserve_bases: int = 0,
                  reserve_reads: int = 0):
    """Upload the volume once: [fwd bases | revcomp bases | zero slack].

    Returns a :class:`_DeviceVolume`.  With the reverse complement
    resident, an ORIENTED seed-centred support window is one contiguous
    dynamic_slice from either half — the former per-element orient gather
    (take_along_axis over the window) dominated the chunk's gather
    stage.  rc(read r)[x] lives at
    vol_cat[2*n_bases - starts[r] - lengths[r] + x].

    ``reserve_bases``/``reserve_reads`` pre-allocate bucketed headroom so
    :func:`append_device_volume` can add correction-round drafts IN PLACE
    (``jax.lax.dynamic_update_slice``) without changing any array shape:
    array shapes key every cns chunk/vote jit, and the former grow-by-
    concatenate append forced a full 30-100 s-per-shape remote recompile
    of the whole chunk ladder in every round > 1 (VERDICT r4 item 2).
    """
    import jax.numpy as jnp

    from ..io.packed_db import upload_codes

    vol = upload_codes(db.codes)
    n_bases = int(vol.shape[0])
    slack = int(3 * int(db.lengths.max()) + 1024) if db.n_reads else 1024
    used = 2 * n_bases + slack
    cap = bucket_length(used + max(0, reserve_bases)) if reserve_bases \
        else used
    vol_cat = jnp.concatenate([
        vol, (3 - vol[::-1].astype(jnp.int32)).astype(vol.dtype),
        jnp.zeros((cap - 2 * n_bases,), dtype=vol.dtype)])
    starts = db.starts.astype(np.int32)
    lengths = np.asarray(db.lengths)
    if reserve_reads:
        r_cap = db.n_reads + reserve_reads
        starts = np.concatenate(
            [starts, np.zeros(r_cap - db.n_reads, np.int32)])
        lengths = np.concatenate(
            [lengths, np.zeros(r_cap - db.n_reads, lengths.dtype)])
    return _DeviceVolume(vol_cat, jnp.asarray(starts), jnp.asarray(lengths),
                         n_bases, used if reserve_bases else -1,
                         db.n_reads if reserve_reads else -1)


def _gather_rows_dev(vol_cat, starts, lengths, ids, L: int):
    """[B, L] forward rows from the device volume (vmapped dynamic_slice).

    vol_cat carries the rc half + zero slack after the forward bases, so
    slices never clamp for any realistic L.
    """
    import jax
    import jax.numpy as jnp

    offs = starts[ids]
    rows = jax.vmap(
        lambda o: jax.lax.dynamic_slice(vol_cat, (o,), (L,)))(offs)
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where(col < jnp.minimum(lengths[ids], L)[:, None], rows, 0)


def make_cns_chunk(*, L_s, L_t, S, W, max_segs, max_segs_left,
                   min_identity, min_align_size, min_mapping_ratio,
                   tags: str = "banded"):
    """Build the pure device cns-chunk fn: gather → align → filter → tags.

    Supports are gathered as SEED-CENTRED WINDOWS of L_s (callers bound
    L_s ~ 3*L_t): the aligned span cannot exceed ~1.35x the template, so a
    single very long support read must not inflate the chunk shapes.
    Orientation costs nothing: the window is one contiguous dynamic_slice
    from the fwd or rc half of vol_cat (see device_volume).  qlen carries
    the FULL support length (for the mapping-ratio filter); window
    coordinates are handled internally.  max_segs / max_segs_left budget
    the right/left extension scans per chunk (see correct_batch_device).

    ``tags`` selects the tag fold: "banded" (default) derives tags from
    gather-free row-walk tracebacks and sliding-band dense planes
    (ops/consensus_banded.py — no column walk, no presence scatter);
    "tape" keeps the op-tape route
    (ops/consensus_device.accumulate_tags).  Both produce EXACTLY equal
    counts (tests/test_cns_banded.py).

    The returned function is pure (jit-able and shard_map-able: the
    template-sharded distributed cns wraps it per mesh shard —
    parallel/cns_dist.py).
    """
    import jax
    from ..ops.align import (extend_pair_batch_rows,
                             extend_pair_batch_with_ops)
    from ..ops.consensus_banded import banded_accumulate_tags
    from ..ops.consensus_device import accumulate_tags
    import jax.numpy as jnp

    def chunk(counts, cov_diff, has, vol_cat, starts, lengths, n_bases,
              s_ids, t_ids, qlen, tlen, qs, ts, t_slot, sdir, real):
        full = lengths[s_ids].astype(jnp.int32)
        qs_c = jnp.clip(qs, 0, jnp.maximum(full - 1, 0))
        w0 = jnp.clip(qs_c - L_s // 2, 0, jnp.maximum(full - L_s, 0))
        start = jnp.where(sdir == 0, starts[s_ids] + w0,
                          2 * n_bases - starts[s_ids] - full + w0)
        rows = jax.vmap(
            lambda o: jax.lax.dynamic_slice(vol_cat, (o,), (L_s,)))(
            start)
        w_len = jnp.minimum(full - w0, L_s).astype(jnp.int32)
        col = jnp.arange(L_s, dtype=jnp.int32)[None, :]
        q = jnp.where(col < w_len[:, None], rows, 0)
        qs_w = (qs_c - w0).astype(jnp.int32)
        t = _gather_rows_dev(vol_cat, starts, lengths, t_ids, L_t)
        if tags == "banded":
            pa, right_r, left_r = extend_pair_batch_rows(
                q, t, w_len, tlen, qs_w, ts, S=S, W=W, max_segs=max_segs,
                max_segs_left=max_segs_left)
        else:
            pa, right_t, left_t = extend_pair_batch_with_ops(
                q, t, w_len, tlen, qs_w, ts, S=S, W=W, max_segs=max_segs,
                max_segs_left=max_segs_left)
        # mapping ratio vs the maximal DOVETAIL EXTENT the seed allows in
        # FULL-read coordinates (identical formula to the host path — see
        # correct_batch; the full-length denominator discarded ~75% of real
        # supports on short templates)
        extent = (jnp.minimum(qs_c, ts)
                  + jnp.minimum(full - qs_c, tlen - ts))
        ratio = (pa.qend - pa.qbeg) / jnp.maximum(1, extent)
        keep = (real & (pa.identity >= min_identity)
                & ((pa.tend - pa.tbeg) >= min_align_size)
                & (ratio >= min_mapping_ratio))
        has2 = has.at[t_slot].max(keep)
        if tags == "banded":
            c2, v2 = banded_accumulate_tags(
                counts, cov_diff, right_r, left_r, qs_w, ts, q, tlen,
                t_slot, keep, pa.tbeg, pa.tend, L_t=L_t, S=S, W=W)
        else:
            c2, v2 = accumulate_tags(counts, cov_diff, right_t, left_t,
                                     qs_w, ts, q, w_len, tlen, t_slot, keep,
                                     pa.tbeg, pa.tend, L_t=L_t)
        return c2, v2, has2

    return chunk


def _cns_chunk_device(counts, cov_diff, has, vol_cat, starts, lengths,
                      n_bases, s_ids, t_ids, qlen, tlen, qs, ts, t_slot,
                      sdir, real, *, L_s, L_t, S, W, max_segs, max_segs_left,
                      min_identity, min_align_size, min_mapping_ratio):
    """Jitted single-device wrapper of :func:`make_cns_chunk` (cached per
    shape/filter key; counts/cov_diff/has donated across chunks)."""
    import jax

    fn = _get_chunk_jit(
        L_s=L_s, L_t=L_t, S=S, W=W, max_segs=max_segs,
        max_segs_left=max_segs_left, min_identity=min_identity,
        min_align_size=min_align_size, min_mapping_ratio=min_mapping_ratio)
    return fn(counts, cov_diff, has, vol_cat, starts, lengths,
              np.int32(n_bases), s_ids, t_ids,
              qlen, tlen, qs, ts, t_slot, sdir, real)


def _get_chunk_jit(*, L_s, L_t, S, W, max_segs, max_segs_left, min_identity,
                   min_align_size, min_mapping_ratio):
    """The cached jitted chunk fn for one shape/filter key (thread-safe
    enough: dict ops are atomic and a benign double-create loses a race)."""
    import jax

    tags = os.environ.get("MECAT_CNS_TAGS", "banded")
    key = (L_s, L_t, S, W, max_segs, max_segs_left, float(min_identity),
           int(min_align_size), float(min_mapping_ratio), tags)
    fn = _CNS_CHUNK_CACHE.get(key)
    if fn is None:
        chunk = make_cns_chunk(
            L_s=L_s, L_t=L_t, S=S, W=W, max_segs=max_segs,
            max_segs_left=max_segs_left, min_identity=min_identity,
            min_align_size=min_align_size,
            min_mapping_ratio=min_mapping_ratio, tags=tags)
        fn = jax.jit(chunk, donate_argnums=(0, 1, 2))
        _CNS_CHUNK_CACHE[key] = fn
    return fn


_CNS_CHUNK_CACHE: Dict = {}


def _pick_correct_batch():
    """Device tag path on an accelerator; host path on the CPU backend or
    with MECAT_HOST_CNS=1."""
    if (os.environ.get("MECAT_HOST_CNS") != "1"
            and on_accelerator()):
        return correct_batch_device
    return correct_batch


def _use_stream_partition(input_path: str) -> bool:
    """Spill-to-disk input partitioning: forced by MECAT_CNS_STREAM=1/0,
    else automatic above a file-size threshold (default 1 GiB) — the
    reference partitions unconditionally; small inputs skip the extra IO."""
    force = os.environ.get("MECAT_CNS_STREAM")
    if force in ("0", "1"):
        return force == "1"
    thresh = int(os.environ.get("MECAT_CNS_STREAM_BYTES", 1 << 30))
    return os.path.getsize(input_path) > thresh


def append_device_volume(dev_vol, tail_db: PackedDB, n_old_reads: int):
    """Extend an uploaded device volume with the appended drafts of
    ``tail_db`` (a PackedDB built by :meth:`PackedDB.append`).

    Only the tail is uploaded; the original
    [fwd | rc | slack] layout stays a prefix so support reads' forward and
    reverse-complement addressing (2*n_bases - start - length) is
    untouched.  Drafts are template-side only and always gathered forward,
    so they need no rc half — just fresh slack after them so windowed
    dynamic_slices never clamp.

    When the volume was built with reserve headroom (see
    :func:`device_volume`) and the tail fits, the append is IN PLACE
    (``dynamic_update_slice``) and every array shape is preserved — the
    next correction round then reuses the whole compiled chunk/vote
    ladder instead of recompiling it (the dominant rounds=2 wall cost).
    Falls back to the grow-by-concatenate path when headroom is missing
    or exhausted.
    """
    import jax
    import jax.numpy as jnp

    from ..io.packed_db import upload_codes

    dv = _as_device_volume(dev_vol)
    vol_cat, starts_d, lengths_d, n_bases = dv[:4]
    tail_start = int(tail_db.starts[n_old_reads])
    tail_codes = tail_db.codes[tail_start:]
    tail_lengths = tail_db.lengths[n_old_reads:]
    n_new = tail_db.n_reads - n_old_reads
    slack = int(3 * int(tail_lengths.max()) + 1024)
    # bucket the tail upload so its unpack jit stays on the shape ladder
    tail_dev = upload_codes(tail_codes, bucket_length(len(tail_codes)))

    in_place = (
        dv.used >= 0 and dv.n_reads >= 0
        and dv.used + int(tail_dev.shape[0]) + slack <= int(vol_cat.shape[0])
        and dv.n_reads + n_new <= int(starts_d.shape[0])
        # tail_db must extend THIS volume's read table, not some other db's
        and dv.n_reads == n_old_reads)
    if in_place:
        vol2 = jax.lax.dynamic_update_slice(vol_cat, tail_dev, (dv.used,))
        new_starts = jnp.asarray(
            (dv.used + (tail_db.starts[n_old_reads:] - tail_start)
             ).astype(np.int32))
        starts2 = jax.lax.dynamic_update_slice(
            starts_d, new_starts, (n_old_reads,))
        lengths2 = jax.lax.dynamic_update_slice(
            lengths_d, jnp.asarray(tail_lengths).astype(lengths_d.dtype),
            (n_old_reads,))
        return _DeviceVolume(vol2, starts2, lengths2, n_bases,
                             dv.used + int(tail_dev.shape[0]) + slack,
                             n_old_reads + n_new)

    if dv.n_reads >= 0:
        # reserve exhausted on a padded volume: drop the inert pad rows so
        # appended read ids keep indexing their own starts/lengths rows
        starts_d = starts_d[:dv.n_reads]
        lengths_d = lengths_d[:dv.n_reads]
    base = int(vol_cat.shape[0])
    vol2 = jnp.concatenate([
        vol_cat, tail_dev, jnp.zeros((slack,), dtype=vol_cat.dtype)])
    starts2 = jnp.concatenate([
        starts_d,
        jnp.asarray((base + (tail_db.starts[n_old_reads:] - tail_start)
                     ).astype(np.int32))])
    lengths2 = jnp.concatenate(
        [lengths_d, jnp.asarray(tail_lengths).astype(lengths_d.dtype)])
    return _DeviceVolume(vol2, starts2, lengths2, n_bases, -1, -1)


def device_volume_for_rounds(db: PackedDB, opts: "CnsOptions"):
    """Device volume with draft headroom for ``opts.rounds`` rounds.

    Drafts total at most ~1.15x the template bases per extra round (vote
    insertions can lengthen a draft slightly); reserving that up front
    keeps every round's array shapes — and therefore every chunk/vote jit
    key — identical (see append_device_volume)."""
    rounds = max(1, int(getattr(opts, "rounds", 1)))
    if rounds <= 1 or not db.n_reads:
        return device_volume(db)
    n_bases = int(db.lengths.sum())
    per_round = int(1.15 * n_bases) + 3 * int(db.lengths.max()) + 2048
    return device_volume(db, reserve_bases=(rounds - 1) * per_round,
                         reserve_reads=(rounds - 1) * db.n_reads)


def _as_device_volume(dev_vol) -> "_DeviceVolume":
    """Accept legacy 4-tuples (tests/tools) and the named form."""
    if isinstance(dev_vol, _DeviceVolume):
        return dev_vol
    parts = tuple(dev_vol)
    if len(parts) == 4:
        return _DeviceVolume(*parts, -1, -1)
    return _DeviceVolume(*parts)


def append_drafts(cur_db: PackedDB, cur_ids: List[int], cur_by,
                  drafts: Dict[int, Tuple[np.ndarray, np.ndarray]]):
    """Append round-k drafts as fresh template reads and remap seeds.

    Shared by the single-path rounds driver and the sharded one
    (parallel/cns_dist.py): templates without a draft keep their original
    id; drafted template t becomes a new read with t's NAME, and every
    support seed's template coordinate maps through the draft's emit map.
    Returns (new_db, new_ids, new_by, n_old_reads).
    """
    from ..io.fasta import FastaRecord

    recs, new_ids, new_by = [], [], {}
    base_id = cur_db.n_reads
    for t in cur_ids:
        d = drafts.get(t)
        if d is None or len(d[0]) == 0:
            new_ids.append(t)
            if t in cur_by:
                new_by[t] = cur_by[t]
            continue
        draft, pos_map = d
        nid = base_id + len(recs)
        recs.append(FastaRecord(cur_db.name(t), draft))
        new_ids.append(nid)
        lim = len(draft) - 1
        new_by[nid] = [
            (s, sdir, spos,
             min(int(pos_map[min(int(ts), len(pos_map) - 1)]), lim),
             score)
            for (s, sdir, spos, ts, score) in cur_by.get(t, [])]
    n_old = cur_db.n_reads
    return cur_db.append(recs), new_ids, new_by, n_old


def correct_batch_rounds(db: PackedDB, templates: List[int],
                         by_template: Dict[int, List[Support]],
                         opts: CnsOptions, stats: CnsStats,
                         correct=None, dev_vol=None):
    """Iterative correction driver (a GENERATOR; see CnsOptions.rounds).

    Each non-final round produces full-length DRAFTS (call_draft /
    draft_mode), appends them to the db as fresh template reads with the
    ORIGINAL names, and remaps every support seed's template coordinate
    through the draft's emit map.  Supports always stay the raw reads, so
    the output is independent of template partitioning exactly like the
    single-round path.  The final round runs the normal voting + splitting.
    """
    correct = correct or _pick_correct_batch()
    device = correct is correct_batch_device
    rounds = max(1, int(opts.rounds))
    cur_db, cur_ids, cur_by, cur_vol = db, list(templates), by_template, \
        dev_vol
    draft_opts = opts
    if opts.draft_est_coverage:
        from dataclasses import replace as _dc_replace

        draft_opts = _dc_replace(
            opts, max_est_coverage=int(opts.draft_est_coverage))
    for _ in range(rounds - 1):
        scratch = CnsStats()
        if device:
            if cur_vol is None:
                cur_vol = device_volume_for_rounds(cur_db, opts)
            drafts = dict(correct_batch_device(
                cur_db, cur_ids, cur_by, draft_opts, scratch,
                dev_vol=cur_vol, _draft=True))
        else:
            drafts = dict(correct_batch(cur_db, cur_ids, cur_by, draft_opts,
                                        scratch, _draft=True))
        stats.supports_aligned += scratch.supports_aligned
        if not drafts:
            break
        cur_db, cur_ids, cur_by, n_old = append_drafts(
            cur_db, cur_ids, cur_by, drafts)
        if device:
            cur_vol = append_device_volume(cur_vol, cur_db, n_old)
    kwargs = {"dev_vol": cur_vol} if device else {}
    out = correct(cur_db, cur_ids, cur_by, opts, stats, **kwargs)
    yield from (out if device else iter(out))


def run_cns(input_path: str, reads_path: str, out_path: str,
            opts: Optional[CnsOptions] = None,
            db: Optional[PackedDB] = None) -> CnsStats:
    """Full mecat2cns run.  Output is independent of both the template
    batching (-p) and the input spill mode: a streamed run's corrected
    FASTA is byte-identical to an in-memory run's (tests/test_cns.py)."""
    from ..utils.metrics import Metrics

    opts = opts or CnsOptions()
    t0 = time.time()
    if db is None:
        db = PackedDB.from_fasta(reads_path)
    stats = CnsStats()
    met = Metrics("cns")
    correct = _pick_correct_batch()
    kwargs = ({"dev_vol": device_volume_for_rounds(db, opts)}
              if correct is correct_batch_device else {})

    def emit_batches(fh, by_template):
        templates = sorted(by_template)
        for ofs in range(0, len(templates), opts.partition_size):
            batch = templates[ofs:ofs + opts.partition_size]
            for name, seg in correct_batch_rounds(
                    db, batch, by_template, opts, stats, correct=correct,
                    dev_vol=kwargs.get("dev_vol")):
                fh.write(format_fasta(name, seg))
            log.info("cns: %d/%d templates, %d corrected reads",
                     min(ofs + opts.partition_size, len(templates)),
                     len(templates), stats.corrected_reads)

    if _use_stream_partition(input_path):
        import shutil

        part_dir = out_path + ".parts"
        parts = partition_supports(input_path, db, opts.input_type,
                                   part_dir, opts.partition_size)
        log.info("cns: %d reads, %d support partitions (streamed)",
                 db.n_reads, len(parts))
        with open(out_path, "wb") as fh:
            for t_lo, t_hi, pp in parts:
                by_template = load_supports_partition(
                    pp, opts.input_type, t_lo, t_hi)
                emit_batches(fh, by_template)
        shutil.rmtree(part_dir, ignore_errors=True)
    else:
        by_template = load_supports(input_path, db, opts.input_type)
        log.info("cns: %d reads, %d templates with supports", db.n_reads,
                 len(by_template))
        with open(out_path, "wb") as fh:
            emit_batches(fh, by_template)
    stats.seconds = time.time() - t0
    # structured throughput counters (north-star supports/s/chip — the
    # driver-facing perf metric for this stage)
    met.set("templates", stats.templates)
    met.set("supports_aligned", stats.supports_aligned)
    met.set("corrected_reads", stats.corrected_reads)
    met.set("corrected_bases", stats.corrected_bases)
    met.set("seconds", round(stats.seconds, 3))
    met.set("supports_per_s",
            round(stats.supports_aligned / max(stats.seconds, 1e-9), 1))
    met.emit_summary()
    return stats
