"""Fused device-side overlap step: scan → candidate select → gather → extend.

This is the framework's "flagship forward step": one jit-compiled program
that takes a batch of query reads plus a device-resident volume (flat codes +
k-mer table) and returns scored, extended overlaps — the device side of
SURVEY.md §3.1 with no host round-trip between the DDF filter and the
aligner.  The host pipeline (pipeline/pw.py) currently stages through the
host for flexible filtering; this fused step is the performance path and the
unit that gets sharded across a mesh (parallel/).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..ops.align import extend_pair_batch
from ..ops.ddf import scan_candidates


class OverlapStepOut(NamedTuple):
    target: jnp.ndarray    # int32 [B, N] target read ids (volume-local)
    score: jnp.ndarray     # int32 [B, N] DDF scores
    qbeg: jnp.ndarray      # int32 [B, N] (scanned-orientation coords)
    qend: jnp.ndarray
    tbeg: jnp.ndarray
    tend: jnp.ndarray
    identity: jnp.ndarray  # float32 [B, N]
    valid: jnp.ndarray     # bool [B, N] passed score/identity/size filters
    qseed: jnp.ndarray     # int32 [B, N] seed point (scanned orientation)
    tseed: jnp.ndarray     # int32 [B, N] seed point on the forward target
    n_segs: jnp.ndarray    # int32 [B, N] DP segments actually computed
                           # (both directions) — useful-cell accounting


@partial(jax.jit, static_argnames=(
    "k", "stride", "max_occ", "num_candidates", "diag_bin", "L_target",
    "S", "W", "max_segs", "min_align_size", "min_identity"))
def overlap_step(
    bases: jnp.ndarray,          # uint8 [B, L] oriented query bases
    lengths: jnp.ndarray,        # int32 [B]
    self_id: jnp.ndarray,        # int32 [B]
    vol_codes: jnp.ndarray,      # uint8 [total_bases] flat volume
    offsets: jnp.ndarray,        # k-mer CSR
    pos_rid: jnp.ndarray,        # occurrence read ids
    pos_loc: jnp.ndarray,        # occurrence in-read offsets
    read_starts: jnp.ndarray,    # int32 [n_reads]
    read_lengths: jnp.ndarray,   # int32 [n_reads]
    cutoff: jnp.ndarray,         # int32 scalar
    *,
    k: int = C.KMER_SIZE,
    stride: int = C.KMER_SCAN_STRIDE,
    max_occ: int = C.MAX_OCC_PER_KMER,
    num_candidates: int = 16,
    diag_bin: int = C.DDF_DIAG_BIN,
    L_target: int = 4096,
    S: int = C.ALIGN_SEGMENT,
    W: int = C.ALIGN_BAND,
    max_segs: int = 16,
    min_align_size: int = C.DEFAULT_MIN_ALIGN_SIZE,
    min_identity: float = C.MIN_OVERLAP_IDENTITY,
) -> OverlapStepOut:
    B, L = bases.shape
    N = num_candidates

    cand = scan_candidates(
        bases, lengths, offsets, pos_rid, pos_loc,
        cutoff, self_id, k=k, stride=stride, max_occ=max_occ,
        num_candidates=N, diag_bin=diag_bin)

    # flatten [B, N] candidates into a [N*B] RANK-MAJOR extension batch:
    # top_k already orders each read's candidates by descending DDF score,
    # and score tracks overlap length — i.e. how many segment iterations a
    # lane survives.  Rank-major layout (lane j*B+b = read b's rank-j
    # candidate) therefore clusters same-mortality lanes, so the DP
    # kernel's thread blocks (which skip each pair once it stops:
    # dp_segment_best active hint) finish together — and costs only cheap
    # tiles/transposes
    # (a score-argsort layout needed a [B*N, L] base gather that measured
    # ~9% SLOWER end-to-end than no sorting at all).
    tgt = jnp.clip(cand.target, 0,
                   read_starts.shape[0] - 1).T.reshape(-1)  # [N*B]
    q_pairs = jnp.tile(bases, (N, 1))                       # [N*B, L]
    qlen_pairs = jnp.tile(lengths, N)
    # target rows are CONTIGUOUS volume slices: a vmapped dynamic_slice
    # beats the equivalent [B*N, L] element gather
    t_start = read_starts[tgt].astype(jnp.int32)
    t_len = read_lengths[tgt].astype(jnp.int32)
    vol_pad = jnp.concatenate(
        [vol_codes, jnp.zeros(L_target, dtype=vol_codes.dtype)])
    rows = jax.vmap(
        lambda o: jax.lax.dynamic_slice(vol_pad, (o,), (L_target,)))(t_start)
    col = jnp.arange(L_target, dtype=jnp.int32)
    t_pairs = jnp.where(col[None, :] < t_len[:, None], rows, 0)

    res = extend_pair_batch(
        q_pairs, t_pairs, qlen_pairs, t_len,
        jnp.maximum(cand.qseed.T.reshape(-1), 0),
        jnp.minimum(jnp.maximum(cand.tseed.T.reshape(-1), 0),
                    jnp.maximum(t_len - 1, 0)),
        S=S, W=W, max_segs=max_segs)
    res = type(res)(*(x.reshape(N, B).T.reshape(-1) for x in res))

    qspan = (res.qend - res.qbeg).reshape(B, N)
    tspan = (res.tend - res.tbeg).reshape(B, N)
    ok = (cand.valid
          & (res.identity.reshape(B, N) >= min_identity)
          & (jnp.minimum(qspan, tspan) >= min_align_size))
    return OverlapStepOut(
        target=cand.target, score=cand.score,
        qbeg=res.qbeg.reshape(B, N), qend=res.qend.reshape(B, N),
        tbeg=res.tbeg.reshape(B, N), tend=res.tend.reshape(B, N),
        identity=res.identity.reshape(B, N), valid=ok,
        qseed=cand.qseed, tseed=cand.tseed,
        n_segs=res.n_segs.reshape(B, N))


# ---------------------------------------------------------------------------
# Two-phase overlap step: 1-segment probe of ALL candidates, full extension
# of survivors only.  With the reference's -n 100 candidates/read, most
# candidates are junk that dies within one DP segment — but in the fused
# one-shot step they still occupy batch lanes for the whole while_loop of
# the longest genuine overlap.  Probing costs ~2/max_segs of the one-shot
# work; survivors (roughly the true overlaps) are compacted to a bucketed
# batch with one tiny host sync, then extended to full length.  Candidate
# sets and final filters are identical to overlap_step.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=(
    "k", "stride", "max_occ", "num_candidates", "diag_bin", "L_target",
    "S", "W", "min_block_score"))
def probe_step(
    bases: jnp.ndarray, lengths: jnp.ndarray, self_id: jnp.ndarray,
    vol_codes: jnp.ndarray, offsets: jnp.ndarray, pos_rid: jnp.ndarray,
    pos_loc: jnp.ndarray, read_starts: jnp.ndarray,
    read_lengths: jnp.ndarray, cutoff: jnp.ndarray, *,
    k: int, stride: int, max_occ: int, num_candidates: int, diag_bin: int,
    L_target: int, S: int, W: int, min_block_score: int,
):
    """Scan + 1-segment probe extension; returns candidates + survive mask.

    survive keeps every candidate whose first segments still look like an
    alignment (or are too short to judge) — a PRUNE-ONLY filter: anything it
    drops would fail the final identity/size filters anyway.
    """
    B, L = bases.shape
    N = num_candidates
    cand = scan_candidates(
        bases, lengths, offsets, pos_rid, pos_loc, cutoff, self_id,
        k=k, stride=stride, max_occ=max_occ, num_candidates=N,
        diag_bin=diag_bin)
    tgt = jnp.clip(cand.target, 0, read_starts.shape[0] - 1).reshape(-1)
    q_pairs = jnp.repeat(bases, N, axis=0)
    qlen_pairs = jnp.repeat(lengths, N)
    t, t_len_w, ts_local, _ = _target_windows(
        vol_codes, read_starts, read_lengths, tgt,
        cand.tseed.reshape(-1), L_target)
    probe = extend_pair_batch(
        q_pairs, t, qlen_pairs, t_len_w,
        jnp.maximum(cand.qseed.reshape(-1), 0), ts_local,
        S=S, W=W, max_segs=1)
    short = probe.align_len < 96          # too little evidence: keep
    looks_ok = probe.identity >= 55.0
    survive = (cand.valid.reshape(-1) & (cand.score.reshape(-1)
                                         >= min_block_score)
               & (short | looks_ok))
    return cand, survive.reshape(B, N)


def _target_windows(vol_codes, read_starts, read_lengths, tgt, tseed,
                    L_win: int):
    """Seed-centred target windows [n, L_win] from the flat volume.

    Batches are length-homogeneous (run_pw sorts queries by length), but a
    single very long TARGET read must not inflate the batch shape: the
    alignment can never consume more target than ~1.35x the query span, so
    a window of L_win ~ 3*L_query around the seed always contains the full
    overlap.  Returns (rows, window_len, seed_local, win0)."""
    t_start = read_starts[tgt].astype(jnp.int32)
    t_len = read_lengths[tgt].astype(jnp.int32)
    tseed = jnp.clip(tseed, 0, jnp.maximum(t_len - 1, 0))
    win0 = jnp.clip(tseed - L_win // 2, 0, jnp.maximum(t_len - L_win, 0))
    vol_pad = jnp.concatenate(
        [vol_codes, jnp.zeros(L_win, dtype=vol_codes.dtype)])
    rows = jax.vmap(
        lambda o: jax.lax.dynamic_slice(vol_pad, (o,),
                                        (L_win,)))(t_start + win0)
    t_len_w = jnp.minimum(t_len - win0, L_win).astype(jnp.int32)
    col = jnp.arange(L_win, dtype=jnp.int32)
    rows = jnp.where(col[None, :] < t_len_w[:, None], rows, 0)
    return rows, t_len_w, (tseed - win0).astype(jnp.int32), win0


@partial(jax.jit, static_argnames=("K", "N", "L_target", "S", "W",
                                   "max_segs"))
def extend_selected(
    bases: jnp.ndarray, lengths: jnp.ndarray, vol_codes: jnp.ndarray,
    read_starts: jnp.ndarray, read_lengths: jnp.ndarray,
    tgt_flat: jnp.ndarray,     # int32 [B*N] candidate targets
    qseed_flat: jnp.ndarray, tseed_flat: jnp.ndarray,
    sel: jnp.ndarray,          # int32 [K] indices into the flat candidates
    sel_valid: jnp.ndarray = None,  # bool [K]; padded tail lanes -> False
    *, K: int, N: int, L_target: int, S: int, W: int, max_segs: int,
):
    """Full extension of the selected candidate pairs only.

    Returned target coordinates (tbeg/tend) are WINDOW-LOCAL; the matching
    window origin comes back as win0 ([K]) for host-side globalisation.
    ``sel`` is padded to the K bucket; with ``sel_valid`` the padded lanes
    get qlen=0, so they are dead from segment 0 and whole 128-lane pad
    blocks are skipped by the DP kernel instead of re-extending lane 0.
    """
    rowi = sel // N
    tgt = jnp.clip(tgt_flat[sel], 0, read_starts.shape[0] - 1)
    q = bases[rowi]
    qlen = lengths[rowi]
    if sel_valid is not None:
        qlen = jnp.where(sel_valid, qlen, 0)
    t, t_len_w, ts_local, win0 = _target_windows(
        vol_codes, read_starts, read_lengths, tgt, tseed_flat[sel], L_target)
    res = extend_pair_batch(
        q, t, qlen, t_len_w,
        jnp.maximum(qseed_flat[sel], 0), ts_local,
        S=S, W=W, max_segs=max_segs)
    return res, win0
