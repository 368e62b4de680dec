"""DDF (distance-difference-factor) candidate filter — batched, sort-based.

Counterpart of the reference's pseudo-linear candidate scan (SURVEY.md §0 idea
1 and §3.1 HOT LOOP 1; reference ``src/mecat2pw/pw_impl.*`` — unverified,
mount empty).  The reference walks each read's k-mers one thread at a time,
probing a chained hash table and scatter-accumulating per-(target, block)
scores in scalar RAM.  Random scatter is an accelerator's weak spot, so this
implementation restates the same math as fixed-shape dataflow:

1. sample query k-mers at a stride (``KMER_SCAN_STRIDE``),
2. probe the CSR index — a fixed-[B, Q, O] gather,
3. map hits to (target read, diagonal = qpos − tpos) pairs,
4. **sort** hits lexicographically by (target, diagonal-bin) with
   ``lax.sort`` (two int32 keys — no 64-bit key packing needed),
5. score = run length of equal (target, bin) keys (segment-sum),
6. ``lax.top_k`` run starts → candidates, each with a seed hit taken from
   the middle of its run (the gapped-extension start point, mecat2pw ``-g``).

Hits whose diagonals agree within ``DDF_DIAG_BIN`` are exactly the
"position-consistent" hits of the reference's DDF scoring; binning quantises
the |Δq−Δt| tolerance (TODO(ref): the reference uses a relative threshold —
re-derive once the mount is populated).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..index.kmer_index import kmer_codes_jnp, probe_index

#: diagonals are shifted by this before binning so they are non-negative
#: (supports reads/genome chunks up to 2^20 bases on either side).
_DIAG_SHIFT = 1 << 20
# plain int (not a jnp scalar): keeps package import from initialising the
# XLA backend, which must not happen before jax.distributed.initialize.
_INVALID_RID = 2 ** 31 - 1


class Candidates(NamedTuple):
    """Top-n overlap candidates per query (fixed shape [B, N])."""

    target: jnp.ndarray   # int32 target read id within the index
    score: jnp.ndarray    # int32 DDF block score (k-mer hits in the bin)
    qseed: jnp.ndarray    # int32 query position of the seed hit
    tseed: jnp.ndarray    # int32 target (local) position of the seed hit
    valid: jnp.ndarray    # bool


def probe_hits(
    bases: jnp.ndarray,        # uint8 [B, L] query bases (already oriented)
    lengths: jnp.ndarray,      # int32 [B]
    offsets: jnp.ndarray,      # index CSR offsets (full or one hash shard)
    pos_rid: jnp.ndarray,      # index occurrence read ids
    pos_loc: jnp.ndarray,      # index occurrence in-read offsets
    cutoff: jnp.ndarray,       # int32 scalar high-frequency k-mer cutoff
    self_id: jnp.ndarray,      # int32 [B] target id to exclude (-1: none)
    *,
    k: int = C.KMER_SIZE,
    stride: int = C.KMER_SCAN_STRIDE,
    max_occ: int = C.MAX_OCC_PER_KMER,
    diag_bin: int = C.DDF_DIAG_BIN,
    diag_shift: int = _DIAG_SHIFT,
    code_lo: int | jnp.ndarray = 0,
    code_hi: int | jnp.ndarray = 1 << 30,
):
    """Steps 1–3: sampled k-mer probe → flat (rid, dbin, qpos, toff) hits.

    ``code_lo``/``code_hi`` restrict probing to a k-mer code range — the hook
    for hash-range index sharding (SURVEY.md §2.3): each shard holds the CSR
    slice for its range and masks everything else.  Returns [B, H] arrays
    with H = ceil(L/stride) * max_occ.
    """
    B, L = bases.shape
    Q = (L + stride - 1) // stride
    H = Q * max_occ

    all_codes = kmer_codes_jnp(bases, k)                      # [B, L]
    qpos = jnp.arange(Q, dtype=jnp.int32) * stride            # [Q]
    codes = all_codes[:, ::stride][:, :Q]                     # [B, Q]
    qvalid = qpos[None, :] + k <= lengths[:, None]            # [B, Q]
    qvalid &= (codes >= code_lo) & (codes < code_hi)

    hit_rid, hit_loc, hit_valid = probe_index(
        offsets, pos_rid, pos_loc, codes - code_lo, qvalid, cutoff,
        max_occ=max_occ)

    rid = hit_rid.reshape(B, H)
    toff = hit_loc.reshape(B, H)
    hqpos = jnp.broadcast_to(qpos[None, :, None],
                             (B, Q, max_occ)).reshape(B, H)
    hvalid = hit_valid.reshape(B, H)
    hvalid &= rid != self_id[:, None]
    dbin = ((hqpos - toff + diag_shift) // diag_bin).astype(jnp.int32)
    return rid, dbin, hqpos, toff, hvalid


def score_hits(rid, dbin, hqpos, toff, hvalid, *, num_candidates: int
               ) -> Candidates:
    """Steps 4–6: sort hits by (target, diagonal-bin), run-length score, top-n.

    Hits may come from one device's probe or be the concatenation of several
    hash shards' probes after an all-to-all exchange — the scoring is
    identical either way.
    """
    B, H = rid.shape
    num_candidates = min(num_candidates, H)

    # -- 4. lexicographic sort by (target, diagonal bin, qpos, tpos) ---------
    # qpos/toff participate as tie-break keys so the within-run order (and
    # hence the seed choice below) is invariant to hit arrangement — single
    # device and hash-sharded all-to-all layouts give identical results.
    rid_key = jnp.where(hvalid, rid, _INVALID_RID)
    rid_s, dbin_s, qpos_s, toff_s = jax.lax.sort(
        (rid_key, dbin, hqpos, toff), num_keys=4, dimension=-1)
    svalid = rid_s != _INVALID_RID

    # -- 5. run-length scores -------------------------------------------------
    # run length at each run start = (index of the next start) - (own index),
    # clipped to the valid prefix (invalid hits all sort to the tail).  A
    # reverse cummin computes next-start indices with no scatter/gather:
    # the scatter-add formulation measured slower.
    same_prev = jnp.zeros((B, H), dtype=bool).at[:, 1:].set(
        (rid_s[:, 1:] == rid_s[:, :-1]) & (dbin_s[:, 1:] == dbin_s[:, :-1]))
    is_start = svalid & ~same_prev
    h_idx = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
    start_pos = jnp.where(is_start, h_idx, H)
    next_start_geq = jnp.flip(
        jax.lax.cummin(jnp.flip(start_pos, axis=-1), axis=1), axis=-1)
    next_start = jnp.concatenate(
        [next_start_geq[:, 1:], jnp.full((B, 1), H, jnp.int32)], axis=-1)
    n_valid = jnp.sum(svalid, axis=-1, keepdims=True).astype(jnp.int32)
    score_at_start = jnp.where(
        is_start, jnp.minimum(next_start, n_valid) - h_idx, 0)

    # -- 6. top-n candidates ---------------------------------------------------
    n = num_candidates
    top_score, top_idx = jax.lax.top_k(score_at_start, n)     # [B, n]
    # seed = middle hit of the run (stable sort keeps within-run qpos order)
    seed_idx = jnp.minimum(top_idx + top_score // 2, H - 1)
    cand = Candidates(
        target=jnp.take_along_axis(rid_s, top_idx, axis=-1),
        score=top_score,
        qseed=jnp.take_along_axis(qpos_s, seed_idx, axis=-1),
        tseed=jnp.take_along_axis(toff_s, seed_idx, axis=-1),
        valid=top_score >= C.MIN_BLOCK_SCORE,
    )
    return cand


@partial(jax.jit, static_argnames=("k", "stride", "max_occ", "num_candidates",
                                   "diag_bin", "diag_shift"))
def scan_candidates(
    bases: jnp.ndarray,
    lengths: jnp.ndarray,
    offsets: jnp.ndarray,
    pos_rid: jnp.ndarray,
    pos_loc: jnp.ndarray,
    cutoff: jnp.ndarray,
    self_id: jnp.ndarray,
    *,
    k: int = C.KMER_SIZE,
    stride: int = C.KMER_SCAN_STRIDE,
    max_occ: int = C.MAX_OCC_PER_KMER,
    num_candidates: int = C.DEFAULT_NUM_CANDIDATES,
    diag_bin: int = C.DDF_DIAG_BIN,
    diag_shift: int = _DIAG_SHIFT,
) -> Candidates:
    """Single-device candidate scan: probe_hits → score_hits."""
    rid, dbin, hqpos, toff, hvalid = probe_hits(
        bases, lengths, offsets, pos_rid, pos_loc,
        cutoff, self_id, k=k, stride=stride, max_occ=max_occ,
        diag_bin=diag_bin, diag_shift=diag_shift)
    return score_hits(rid, dbin, hqpos, toff, hvalid,
                      num_candidates=num_candidates)


@partial(jax.jit, static_argnames=("n_keep",))
def merge_strand_candidates_device(c0: Candidates, c1: Candidates,
                                   min_score: jnp.ndarray,
                                   n_valid: jnp.ndarray | None = None, *,
                                   n_keep: int):
    """Device twin of pipeline.pw._merge_strand_candidates.

    The host merge pulled 10 per-field [B, N] arrays per batch to the host
    (4 int32 + 1 bool per strand) and lexsorted there.  This merges ON
    DEVICE and compacts the kept rows to
    the front of ONE [2*B*N, 6] buffer (columns row/strand/target/score/
    qseed/tseed), so the host pulls a count plus a bucketed prefix.

    Exact-order contract (differential-tested byte-identical via run_pw):
    the host path concatenates strand 0 then strand 1 in row-major (r, c)
    order and stable-lexsorts by (row asc, score desc), then keeps the
    first n_keep per row.  Building the flat arrays in the same
    concatenation order and stable-sorting by the same keys reproduces the
    host tie-breaking exactly.

    ``n_valid`` (ADVICE r4): number of real query rows in the batch —
    repeat-last padded rows keep nonzero lengths and their poly-A k-mer
    hits would otherwise inflate the pulled prefix before the host-side
    row filter drops them.  None keeps the old all-rows behaviour.
    """
    parts = []
    for strand, c in ((0, c0), (1, c1)):
        B, N = c.target.shape
        row = jnp.broadcast_to(
            jnp.arange(B, dtype=jnp.int32)[:, None], (B, N)).reshape(-1)
        ok = (c.valid & (c.score >= min_score)).reshape(-1)
        parts.append((jnp.where(ok, row, B).astype(jnp.int32),
                      jnp.full(B * N, strand, jnp.int32),
                      c.target.reshape(-1).astype(jnp.int32),
                      c.score.reshape(-1).astype(jnp.int32),
                      c.qseed.reshape(-1).astype(jnp.int32),
                      c.tseed.reshape(-1).astype(jnp.int32)))
    row, strand, target, score, qseed, tseed = (
        jnp.concatenate([p[i] for p in parts]) for i in range(6))
    # stable sort by (row asc, score desc); invalid rows carry row=B so
    # they land after every real row
    row, negs, strand, target, score, qseed, tseed = jax.lax.sort(
        (row, -score, strand, target, score, qseed, tseed),
        num_keys=2, is_stable=True)
    M = row.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    is_new = jnp.concatenate(
        [jnp.ones(1, bool), row[1:] != row[:-1]])
    seg_start = jax.lax.cummax(jnp.where(is_new, idx, 0))
    rank = idx - seg_start
    row_cap = (jnp.int32(c0.target.shape[0]) if n_valid is None
               else jnp.minimum(jnp.int32(c0.target.shape[0]),
                                n_valid.astype(jnp.int32)))
    keep = (rank < n_keep) & (row < row_cap)
    # compact kept rows to the front (stable: preserves merged order)
    sink = jnp.where(keep, jnp.int32(0), jnp.int32(1))
    _, row, strand, target, score, qseed, tseed = jax.lax.sort(
        (sink, row, strand, target, score, qseed, tseed),
        num_keys=1, is_stable=True)
    merged = jnp.stack([row, strand, target, score, qseed, tseed], axis=1)
    return merged, jnp.sum(keep.astype(jnp.int32))


@partial(jax.jit, static_argnames=("K",))
def slice_merged(merged: jnp.ndarray, *, K: int) -> jnp.ndarray:
    """First K rows of a merged-candidate buffer (bucketed static K so the
    host pulls ~the kept prefix instead of the whole [2*B*N, 6] buffer)."""
    return jax.lax.dynamic_slice(merged, (0, 0), (K, merged.shape[1]))


@partial(jax.jit, static_argnames=("B",))
def pack_merged_group(merged_stack: jnp.ndarray, counts: jnp.ndarray, *,
                      B: int):
    """Compact k batches' merged-candidate buffers into ONE buffer.

    The staged -j 0 path paid ~2 host round-trips PER BATCH (count +
    prefix pull).  This packs a GROUP of k batches' merged
    buffers on device: row ids are globalised to slot*B + row, valid rows
    are stably compacted to the front (batch order preserved, so the
    emitted text is byte-identical to the per-batch path), and the host
    pulls ONE count + ONE bucketed prefix per group.

    merged_stack: [k, M, 6] from merge_strand_candidates_device;
    counts: [k] kept-row counts.  Returns (packed [k*M, 6], total).
    """
    k, M, _ = merged_stack.shape
    ridx = jax.lax.broadcasted_iota(jnp.int32, (k, M), 1)
    slot = jax.lax.broadcasted_iota(jnp.int32, (k, M), 0)
    valid = (ridx < counts[:, None]).reshape(-1)
    row_g = (merged_stack[:, :, 0] + slot * B).reshape(-1)
    cols = [row_g] + [merged_stack[:, :, c].reshape(-1) for c in range(1, 6)]
    sink = jnp.where(valid, jnp.int32(0), jnp.int32(1))
    order = jax.lax.broadcasted_iota(jnp.int32, (k * M,), 0)
    _, _, *packed_cols = jax.lax.sort(
        (sink, order, *cols), num_keys=2, is_stable=False)
    return (jnp.stack(packed_cols, axis=1),
            jnp.sum(valid.astype(jnp.int32)))
