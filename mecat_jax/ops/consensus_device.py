"""Device-resident pile consensus: op tapes → tag counts → vote, on chip.

The host path (ops/consensus.py) pulls each extension batch's op tapes to
the host and tallies tags in NumPy: ~80 MB of tapes per 128-pair batch.
This module keeps the whole tag pipeline on device:

1. scatter each direction's right-aligned per-segment tapes into one
   template-forward column stream per pair (fixed [B, CW]);
2. vectorised tag derivation (insertion anchors via cummax, deltas, bases)
   — the same math as ops/consensus.columns_to_tags;
3. scatter-add tags into a persistent per-template counts buffer
   [T, L, D1, 5] plus a coverage diff buffer (donated across batches);
4. majority vote + insertion prefix rule on device
   (mirroring CnsTable.call), returning only the tiny emit/coverage arrays
   to the host for final segment splitting and FASTA output.

Differential tests (tests/test_cns_device.py) assert exact agreement with
the host CnsTable path on the same alignments.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .. import constants as C
from .align import MOVE_HORIZ, MOVE_VERT
from .consensus import GAP


def _stream_one_direction(tapes, qseed, tseed, reverse: bool):
    """One direction's tapes → (ops, qpos, tpos, slot, n_total) flat views.

    Returns per-column arrays shaped [B, G*MAXC] (stored layout order) plus
    the in-stream slot of every column (template-forward compaction), and
    the per-pair total column count.
    """
    ops, qi, tj, n, qo, to, ok = tapes
    G, B, MAXC = ops.shape
    n = n.astype(jnp.int32)                                   # [G, B]
    c_idx = jax.lax.broadcasted_iota(jnp.int32, (G, B, MAXC), 2)
    col_valid = c_idx >= (MAXC - n[:, :, None])

    if not reverse:
        # forward order: segments ascending, stored order within segment
        f = c_idx - (MAXC - n[:, :, None])
        seg_base = jnp.cumsum(n, axis=0) - n                  # [G, B]
        qpos = jnp.where(qi >= 0,
                         qseed[None, :, None] + qo[:, :, None] + qi, -1)
        tpos = tseed[None, :, None] + to[:, :, None] + tj
    else:
        # left tapes: template-forward = reversed segment order, reversed
        # within segment (ops/consensus.tapes_to_columns left branch)
        f = MAXC - 1 - c_idx
        total = jnp.sum(n, axis=0)                            # [B]
        seg_base = total[None, :] - jnp.cumsum(n, axis=0)     # [G, B]
        qpos = jnp.where(qi >= 0,
                         qseed[None, :, None] - 1
                         - (qo[:, :, None] + qi), -1)
        tpos = tseed[None, :, None] - 1 - (to[:, :, None] + tj)

    slot = jnp.where(col_valid, seg_base[:, :, None] + f, -1)
    n_total = jnp.sum(n, axis=0)                              # [B]
    flat = lambda a: jnp.swapaxes(a, 0, 1).reshape(B, G * MAXC)
    return (flat(ops.astype(jnp.int32)), flat(qpos), flat(tpos), flat(slot),
            n_total)


def _build_streams(right_t, left_t, qseed, tseed, CW: int):
    """Both directions → template-forward column streams [B, CW].

    (ops, qpos) travel packed as one scattered word — (qpos+1)*4 + ops, -1
    when empty — halving the scatter count of the compaction (the dominant
    cost of this function).
    """
    l_ops, l_qpos, l_tpos, l_slot, l_n = _stream_one_direction(
        left_t, qseed, tseed, reverse=True)
    r_ops, r_qpos, r_tpos, r_slot, _ = _stream_one_direction(
        right_t, qseed, tseed, reverse=False)
    B = l_ops.shape[0]

    oq_s = jnp.full((B, CW), -1, jnp.int32)
    tpos_s = jnp.full((B, CW), -1, jnp.int32)

    def pack(ops, qpos):
        return jnp.where(ops >= 0, (qpos + 1) * 4 + ops, -1)

    def scat(dst, src, slot):
        # invalid/overflow slots fall out of range and are dropped (the CW
        # bound guarantees real columns fit: cols <= q advance + t advance)
        slot = jnp.where(slot >= 0, slot, CW)
        return dst.at[jnp.arange(B)[:, None], slot].set(src, mode="drop")

    # left stream occupies [0, l_n); right follows at l_n
    oq_s = scat(oq_s, pack(l_ops, l_qpos), l_slot)
    tpos_s = scat(tpos_s, l_tpos, l_slot)
    r_slot_g = jnp.where(r_slot >= 0, r_slot + l_n[:, None], -1)
    oq_s = scat(oq_s, pack(r_ops, r_qpos), r_slot_g)
    tpos_s = scat(tpos_s, r_tpos, r_slot_g)

    ops_s = jnp.where(oq_s >= 0, oq_s & 3, -1)
    qpos_s = jnp.where(oq_s >= 0, (oq_s >> 2) - 1, -1)
    return ops_s, qpos_s, tpos_s


@partial(jax.jit, static_argnames=("CW",))
def ops_stream(right_t, left_t, qseed, tseed, CW: int) -> jnp.ndarray:
    """Forward-ordered alignment op codes per pair, compacted on device.

    int8 [B, CW]: ops (0..3) in template-forward order starting at slot 0,
    -1 beyond the alignment.  This is all mecat2ref needs for exact CIGARs —
    pulling it costs ~CW bytes/pair vs the ~300 bytes/column of the full op
    tapes.
    """
    o, _, _ = _build_streams(right_t, left_t, qseed, tseed, CW)
    return o.astype(jnp.int8)


def _direction_tags(ops, qi, tj, n, ok, qpos_map, tpos_map,
                    anchor0, trail0, left_aligned=False):
    """One direction's tapes → per-column (ops, pos, delta, qpos) + carries.

    Works in FORWARD template order assuming stored order == forward order
    (right direction; the left direction is handled by the caller flipping
    both the segment and column axes and mapping coordinates first — after
    the column flip real columns sit at the HEAD of the axis, signalled by
    ``left_aligned``).

    The insertion anchor (most recent non-insertion column's template
    position) and the run delta (columns since that anchor) are computed
    with per-segment cummax plus a tiny [G, B] carry scan over segments —
    no cross-segment stream compaction (the former [B, CW] scatter-based
    compaction was the dominant cost of the whole cns chunk).

    anchor0/trail0: int32 [B] carries entering this direction (anchor
    template pos or -1; trailing-insertion column count since that anchor).
    Returns (pos, delta, valid, qpos_abs, anchor_out, trail_out).
    """
    G, B, MAXC = ops.shape
    n = jnp.where(ok, n, 0).astype(jnp.int32)                  # [G, B]
    c_idx = jax.lax.broadcasted_iota(jnp.int32, (G, B, MAXC), 2)
    if left_aligned:
        valid = (c_idx < n[:, :, None]) & (ops >= 0)
        local = c_idx                                          # 0-based in seg
    else:
        valid = (c_idx >= (MAXC - n[:, :, None])) & (ops >= 0)
        local = c_idx - (MAXC - n[:, :, None])                 # 0-based in seg
    is_ins = valid & (ops == MOVE_VERT)
    non_ins = valid & ~is_ins

    qpos = qpos_map(qi)                                        # [G, B, MAXC]
    tpos = tpos_map(tj)

    # within-segment anchor: non-ins tpos is non-decreasing in forward order
    last_local = jax.lax.cummax(jnp.where(non_ins, local, -1), axis=2)
    anchor_local = jax.lax.cummax(jnp.where(non_ins, tpos, -1), axis=2)

    # per-segment summaries for the carry scan
    seg_anchor = anchor_local[:, :, -1]                        # [G, B] or -1
    seg_last = last_local[:, :, -1]                            # [G, B] or -1
    seg_trail = jnp.where(seg_last >= 0, n - 1 - seg_last, n)

    def carry_step(carry, xs):
        anc, trail = carry
        s_anchor, s_trail, s_n = xs
        has = s_anchor >= 0
        anc2 = jnp.where(has, s_anchor, anc)
        trail2 = jnp.where(has, s_trail, trail + s_n)
        return (anc2, trail2), (anc, trail)

    (anchor_out, trail_out), (anc_in, trail_in) = jax.lax.scan(
        carry_step, (anchor0, trail0), (seg_anchor, seg_trail, n))

    # resolve anchors/deltas: local anchor wins, else the segment carry
    has_local = last_local >= 0
    pos = jnp.where(is_ins,
                    jnp.where(has_local, anchor_local, anc_in[:, :, None]),
                    tpos)
    delta = jnp.where(is_ins,
                      jnp.where(has_local, local - last_local,
                                local + 1 + trail_in[:, :, None]),
                      0)
    pos = jnp.where(is_ins & (pos < 0), -1, pos)
    return pos, delta, valid, qpos, anchor_out, trail_out


@partial(jax.jit, static_argnames=("L_t", "max_delta"), donate_argnums=(0, 1))
def accumulate_tags(counts: jnp.ndarray,        # int32 [T, L_t, D1, 5]
                    cov_diff: jnp.ndarray,      # int32 [T, L_t + 1]
                    right_t, left_t,
                    qseed: jnp.ndarray,         # int32 [B]
                    tseed: jnp.ndarray,
                    support: jnp.ndarray,       # uint8 [B, L_s] oriented
                    qlen: jnp.ndarray,          # int32 [B]
                    tlen: jnp.ndarray,          # int32 [B] template length
                    t_slot: jnp.ndarray,        # int32 [B] row in counts
                    pair_ok: jnp.ndarray,       # bool [B]
                    tbeg: jnp.ndarray, tend: jnp.ndarray,
                    *, L_t: int,
                    max_delta: int = C.MAX_INS_DELTA
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fold one extension batch's alignments into the device tag tables.

    Tags are derived DIRECTLY from the per-segment tapes (insertion anchors
    via per-segment cummax + a [G, B] carry scan), then scatter-added once.
    The left direction is flipped on both axes so the same forward-order
    code serves both; its exit carries seed the right direction so
    insertion runs spanning the seed point stay exact (differential tests
    against the host CnsTable path assert equality).
    """
    G, B, MAXC = right_t[0].shape
    D1 = max_delta + 1
    T = counts.shape[0]

    def tag_arrays(direction_t, reverse):
        ops, qi, tj, n, qo, to, ok = direction_t
        if reverse:
            # forward template order = reversed segment order, reversed
            # within segment: flip both axes.  The stored tapes are
            # right-aligned, so after the column flip real columns occupy
            # the HEAD of the axis in forward order — handled by
            # left_aligned=True (no re-alignment gather).
            ops = jnp.flip(ops, axis=(0, 2))
            qi = jnp.flip(qi, axis=(0, 2))
            tj = jnp.flip(tj, axis=(0, 2))
            n = jnp.flip(n, axis=0)
            qo = jnp.flip(qo, axis=0)
            to = jnp.flip(to, axis=0)
            ok = jnp.flip(ok, axis=0)
            qpos_map = lambda qi_: jnp.where(
                qi_ >= 0, qseed[None, :, None] - 1 - (qo[:, :, None] + qi_),
                -1)
            tpos_map = lambda tj_: (tseed[None, :, None] - 1
                                    - (to[:, :, None] + tj_))
        else:
            qpos_map = lambda qi_: jnp.where(
                qi_ >= 0, qseed[None, :, None] + qo[:, :, None] + qi_, -1)
            tpos_map = lambda tj_: tseed[None, :, None] + to[:, :, None] + tj_
        return (ops.astype(jnp.int32), qi, tj, n, ok), qpos_map, tpos_map

    zero = jnp.zeros_like(qseed)
    neg1 = jnp.full_like(qseed, -1)
    (l_ops, l_qi, l_tj, l_n, l_ok), l_qmap, l_tmap = tag_arrays(left_t, True)
    l_pos, l_delta, l_valid, l_qpos, anc, trail = _direction_tags(
        l_ops, l_qi, l_tj, l_n, l_ok, l_qmap, l_tmap, neg1, zero,
        left_aligned=True)
    (r_ops, r_qi, r_tj, r_n, r_ok), r_qmap, r_tmap = tag_arrays(right_t,
                                                                False)
    r_pos, r_delta, r_valid, r_qpos, _, _ = _direction_tags(
        r_ops, r_qi, r_tj, r_n, r_ok, r_qmap, r_tmap, anc, trail)

    # Tag fold: scatter-ADD is slower per element than scatter-SET (XLA
    # serialises adds against collisions).  Within one PAIR every
    # (pos, delta) tag is unique — non-insertion columns consume distinct
    # template positions, insertion runs have distinct deltas, and runs
    # spanning the seed continue the same anchor — so the fold becomes:
    # unique-indices scatter-SET into a per-pair one-hot presence buffer
    # [B, F], then an int8 MATMUL with the pair→slot one-hot [T, B] reduces
    # over pairs on the MXU.  No scatter-add anywhere.
    F = L_t * D1 * 5
    pres = jnp.zeros((B * F,), jnp.int8)

    def presence_set(pres, ops, pos, delta, valid, qpos):
        b_iota = jax.lax.broadcasted_iota(jnp.int32, ops.shape, 1)
        base_q = support.astype(jnp.int32)[
            jnp.arange(B, dtype=jnp.int32)[None, :, None],
            jnp.clip(qpos, 0, jnp.maximum(qlen - 1, 0)[None, :, None])]
        base = jnp.where(ops == MOVE_HORIZ, GAP, base_q)
        keep = (valid & pair_ok[None, :, None]
                & (pos >= 0) & (pos < tlen[None, :, None])
                & (delta <= max_delta))
        flat_idx = b_iota * F + ((pos * D1 + delta) * 5 + base)
        flat_idx = jnp.where(keep, flat_idx, B * F)   # out of bounds: drop
        return pres.at[flat_idx.reshape(-1)].set(
            jnp.int8(1), mode="drop", unique_indices=True)

    pres = presence_set(pres, l_ops, l_pos, l_delta, l_valid, l_qpos)
    pres = presence_set(pres, r_ops, r_pos, r_delta, r_valid, r_qpos)
    onehot = ((t_slot[None, :] == jnp.arange(T, dtype=jnp.int32)[:, None])
              & pair_ok[None, :]).astype(jnp.int8)
    contrib = jax.lax.dot(onehot, pres.reshape(B, F),
                          preferred_element_type=jnp.int32)
    counts = counts + contrib.reshape(counts.shape)

    # coverage diff: +1 at clip(tbeg), -1 at min(tend, tlen), when b > a
    a = jnp.clip(tbeg, 0, L_t)
    b = jnp.clip(jnp.minimum(tend, tlen), 0, L_t)
    span_ok = pair_ok & (b > a)
    rows = jnp.where(span_ok, t_slot, counts.shape[0])
    cov_diff = cov_diff.at[rows, a].add(1, mode="drop")
    cov_diff = cov_diff.at[rows, b].add(-1, mode="drop")
    return counts, cov_diff


@partial(jax.jit, static_argnames=("keep_template", "draft_mode", "vote"))
def call_tables(counts: jnp.ndarray,        # int32 [T, L, D1, 5]
                cov_diff: jnp.ndarray,      # int32 [T, L + 1]
                template: jnp.ndarray,      # uint8 [T, L] padded bases
                tlen: jnp.ndarray,          # int32 [T]
                has_support: jnp.ndarray,   # bool [T]
                min_coverage: jnp.ndarray,
                keep_template: bool = False,
                draft_mode: bool = False,
                vote=None):                 # VoteParams (static) or None
    """Device replica of CnsTable.call's vote stage.

    Returns (emit int32 [T, L, D1] base code or -1, cov_ok bool [T, L]) —
    the host performs the final low-coverage segment splitting (tiny data).

    keep_template=True mirrors CnsTable.call_polished instead (contig
    consensus / utgcns role): template bases are kept verbatim where
    coverage is thin and there is no self-vote or splitting.

    draft_mode=True mirrors CnsTable.call_draft (iterative correction,
    rounds > 1): identical vote rules to the normal call, but thin-coverage
    positions keep the template base so the draft is full-length and seed
    coordinates can be mapped through (the host splits nothing).
    """
    T, L, D1, _ = counts.shape
    l_idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_read = l_idx < tlen[:, None]
    if not keep_template:
        # template self-votes (CnsTable.add_template_votes), only where a
        # support produced a table in the host semantics
        counts = counts.at[
            jnp.arange(T)[:, None], l_idx, 0, template.astype(jnp.int32)].add(
            (in_read & has_support[:, None]).astype(jnp.int32))

    coverage = jnp.cumsum(cov_diff[:, :L], axis=1)
    cov_ok = (coverage >= min_coverage) & in_read & has_support[:, None]
    base_win = jnp.argmax(counts[:, :, 0, :4], axis=2)        # [T, L] no GAP
    deleted = _run_pooled_deletions_dev(
        template.astype(jnp.int32), counts, coverage, tlen,
        self_vote=0 if keep_template else 1, vote=vote)
    ins_tot = jnp.sum(counts[:, :, 1:, :4], axis=3)           # [T, L, D1-1]
    ins_win = jnp.argmax(counts[:, :, 1:, :4], axis=3)
    ins_emit = jnp.cumprod(
        (ins_tot * 2 > jnp.maximum(coverage, 1)[:, :, None]).astype(
            jnp.int32), axis=2).astype(bool)

    emit = jnp.full((T, L, D1), -1, jnp.int32)
    base0 = jnp.where(cov_ok & ~deleted, base_win, -1)
    if keep_template or draft_mode:
        # thin coverage keeps the template verbatim (polish: always;
        # draft: where the call path would leave a split gap)
        base0 = jnp.where(cov_ok, base0,
                          jnp.where(in_read & has_support[:, None],
                                    template.astype(jnp.int32), -1)
                          if draft_mode else
                          jnp.where(in_read, template.astype(jnp.int32), -1))
    emit = emit.at[:, :, 0].set(base0)
    ins_slots = jnp.where(cov_ok[:, :, None] & ins_emit, ins_win, -1)
    extra = _run_pooled_insertions_dev(
        template.astype(jnp.int32), counts, coverage, ins_emit, ins_win,
        tlen, self_vote=0 if keep_template else 1, vote=vote)
    gate = cov_ok if not keep_template else (coverage >= min_coverage)
    extra = jnp.where(gate, extra, 0)
    # fill the first `extra` FREE slots at each run start with the run letter
    free = ins_slots < 0
    frank = jnp.cumsum(free.astype(jnp.int32), axis=2)
    fill = free & (frank <= extra[:, :, None])
    ins_slots = jnp.where(fill, template.astype(jnp.int32)[:, :, None],
                          ins_slots)
    if not keep_template:
        ins_slots = _window_pooled_insertions_dev(counts, coverage,
                                                  ins_slots, cov_ok, vote)
    emit = emit.at[:, :, 1:].set(ins_slots)
    return emit, cov_ok


def _window_pooled_insertions_dev(counts, coverage, ins_slots, gate,
                                  vote=None):
    """Device mirror of ops/consensus._window_pooled_insertions (exact).

    counts [T, L, D1, 5], coverage/gate [T, L], ins_slots [T, L, D1-1]
    (post run-pool fill).  Emits the peak slot's letter into the first
    free slot at strict local peaks of windowed insertion mass.
    """
    from ..ops.consensus import default_vote_params
    vote = vote or default_vote_params()
    R = int(vote.win_radius)
    if R <= 0:
        return ins_slots
    T, L, D1, _ = counts.shape
    sv = counts[:, :, 1:, :4].astype(jnp.int32)
    v_pos = jnp.sum(sv, axis=(2, 3))                          # [T, L]
    already = jnp.any(ins_slots >= 0, axis=2)
    mass, near = v_pos, already
    lmax = jnp.zeros((T, L), jnp.int32)
    rmax = jnp.zeros((T, L), jnp.int32)
    zc = jnp.zeros((T, 1), jnp.int32)
    zb = jnp.zeros((T, 1), bool)

    def sl(x, s, z):  # x shifted right by s (left-neighbour view), z pad
        return jnp.concatenate([jnp.repeat(z, s, axis=1), x[:, :-s]], axis=1)

    def sr(x, s, z):  # x shifted left by s (right-neighbour view)
        return jnp.concatenate([x[:, s:], jnp.repeat(z, s, axis=1)], axis=1)

    for s in range(1, R + 1):
        mass = mass + sl(v_pos, s, zc) + sr(v_pos, s, zc)
        near = near | sl(already, s, zb) | sr(already, s, zb)
        lmax = jnp.maximum(lmax, sl(v_pos, s, zc))
        rmax = jnp.maximum(rmax, sr(v_pos, s, zc))
    flat = sv.reshape(T, L, -1)
    best = jnp.max(flat, axis=2)
    bbase = (jnp.argmax(flat, axis=2) % 4).astype(jnp.int32)  # first-max tie
    cov = jnp.maximum(coverage.astype(jnp.int32), 1)
    fire = (gate & ~near & (v_pos > lmax) & (v_pos >= rmax)
            & (100 * mass > vote.win_mass_frac100 * cov)
            & (100 * best >= vote.win_peak_frac100 * cov)
            & (best >= 2))
    free = ins_slots < 0
    first_free = free & (jnp.cumsum(free.astype(jnp.int32), axis=2) == 1)
    return jnp.where(fire[:, :, None] & first_free, bbase[:, :, None],
                     ins_slots)


def _run_pooled_insertions_dev(template, counts, coverage, ins_emit,
                               ins_win, tlen, self_vote: int, vote=None):
    """Device mirror of ops/consensus._run_pooled_insertions (exact):
    per-position count of EXTRA run-letter insertions, nonzero only at run
    starts."""
    from ..ops.consensus import default_vote_params
    vote = vote or default_vote_params()

    T, L = template.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    row = jnp.arange(T, dtype=jnp.int32)[:, None]
    brk = jnp.concatenate(
        [jnp.ones((T, 1), bool), template[:, 1:] != template[:, :-1]],
        axis=1) | (pos == tlen[:, None])
    run_start = jax.lax.cummax(jnp.where(brk, pos, 0), axis=1)
    nxt = jnp.where(brk, pos, L)
    run_end = jnp.flip(jax.lax.cummin(
        jnp.flip(jnp.concatenate(
            [nxt[:, 1:], jnp.full((T, 1), L, jnp.int32)], axis=1),
            axis=1), axis=1), axis=1)

    ins_by_letter = jnp.sum(counts[:, :, 1:, :4], axis=2)     # [T, L, 4]
    v_own = jnp.take_along_axis(ins_by_letter, template[:, :, None],
                                axis=2)[:, :, 0]
    emitted_own = jnp.sum(
        ins_emit & (ins_win == template[:, :, None]), axis=2)

    def prefix(x):
        c = jnp.cumsum(x.astype(jnp.int32), axis=1)
        return jnp.concatenate([jnp.zeros((T, 1), jnp.int32), c], axis=1)

    cv, ce, cc = prefix(v_own), prefix(emitted_own), prefix(coverage)
    I = cv[row, run_end] - cv[row, run_start]
    E = ce[row, run_end] - ce[row, run_start]
    # left-boundary anchor (the position just before the run) voting for
    # THIS run's letter
    letter = jnp.take_along_axis(template, run_start, axis=1)
    ls = jnp.maximum(run_start - 1, 0)
    # gather ins_by_letter[row, ls, letter]: two-step take_along_axis
    g1 = jnp.take_along_axis(ins_by_letter, ls[:, :, None], axis=1)  # [T,L,4]
    v_left = jnp.take_along_axis(g1, letter[:, :, None], axis=2)[:, :, 0]
    e1 = jnp.take_along_axis(ins_emit, ls[:, :, None], axis=1)
    w1 = jnp.take_along_axis(ins_win, ls[:, :, None], axis=1)
    e_left = jnp.sum(e1 & (w1 == letter[:, :, None]), axis=2)
    has_left = run_start > 0
    I = I + jnp.where(has_left, v_left, 0)
    E = E + jnp.where(has_left, e_left, 0)

    run_len = jnp.maximum(run_end - run_start, 1)
    m = jnp.maximum((cc[row, run_end] - cc[row, run_start]) // run_len
                    + self_vote, 1)
    b100 = vote.ins_bias100
    sat = I >= m * (run_len + 1)
    I_c = jnp.minimum(I, m * (run_len + 1))
    # floor((100*I + b*m)/(100*m)) == I//m + (100*(I%m) >= (100-b)*m):
    # exact decomposition that never forms 100*I_c, which can pass 2^31 on
    # deep long-run piles while the host computes in unbounded Python ints
    k_pool = jnp.where(
        sat, run_len,
        I_c // m + (100 * (I_c % m) >= (100 - b100) * m).astype(jnp.int32))
    k_extra = jnp.where(m >= vote.pool_min_cov_ins,
                        jnp.maximum(k_pool - E, 0), 0)
    return jnp.where(pos == run_start, k_extra, 0)


def _run_pooled_deletions_dev(template, counts, coverage, tlen,
                              self_vote: int, vote=None):
    """Device mirror of ops/consensus._run_pooled_deletions (exact).

    Hybrid plurality + homopolymer-run-pooled GAP votes: see the host
    docstring.  All segmented run quantities are prefix sums gathered at
    run starts/ends — [T, L] element gathers, once per table call.
    """
    from ..ops.consensus import default_vote_params
    vote = vote or default_vote_params()

    T, L = template.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    gap_votes = counts[:, :, 0, GAP]
    deleted = gap_votes > jnp.max(counts[:, :, 0, :4], axis=2)
    brk = jnp.concatenate(
        [jnp.ones((T, 1), bool), template[:, 1:] != template[:, :-1]],
        axis=1)
    brk = brk | (pos == tlen[:, None])    # padding is its own run
    run_start = jax.lax.cummax(jnp.where(brk, pos, 0), axis=1)
    # next-break index (exclusive run end) via suffix-min of break positions
    nxt = jnp.where(brk, pos, L)
    run_end = jnp.flip(jax.lax.cummin(
        jnp.flip(jnp.concatenate(
            [nxt[:, 1:], jnp.full((T, 1), L, jnp.int32)], axis=1),
            axis=1), axis=1), axis=1)

    def prefix(x):
        # int32: bounded by coverage * L (~2^21 at the largest slices)
        c = jnp.cumsum(x.astype(jnp.int32), axis=1)
        return jnp.concatenate(
            [jnp.zeros((T, 1), jnp.int32), c], axis=1)

    cg, cc = prefix(gap_votes), prefix(coverage)
    cd, cn = prefix(deleted), prefix(~deleted)
    row = jnp.arange(T, dtype=jnp.int32)[:, None]
    G = (cg[row, run_end] - cg[row, run_start]).astype(jnp.int32)
    run_len = jnp.maximum(run_end - run_start, 1)
    # integer arithmetic, int32-safe via saturation — must agree
    # bit-for-bit with the host rule
    m = jnp.maximum((cc[row, run_end] - cc[row, run_start]).astype(jnp.int32)
                    // run_len + self_vote, 1)
    b100 = vote.del_bias100
    sat = G >= m * (run_len + 1)
    G_c = jnp.minimum(G, m * (run_len + 1))
    # exact overflow-free decomposition (see the insertion rule above):
    # floor((100*G + b*m)/(100*m)) == G//m + (100*(G%m) >= (100-b)*m)
    k_pool = jnp.where(
        sat, run_len,
        jnp.minimum(
            G_c // m + (100 * (G_c % m)
                        >= (100 - b100) * m).astype(jnp.int32),
            run_len)).astype(jnp.int32)
    k_extra = jnp.where(
        m >= vote.pool_min_cov,
        jnp.maximum(k_pool - (cd[row, run_end]
                              - cd[row, run_start]).astype(jnp.int32), 0), 0)
    nd_rank = (cn[row, pos] - cn[row, run_start]).astype(jnp.int32)
    return deleted | (~deleted & (nd_rank < k_extra))


def split_called(emit_row, cov_ok_row, tlen: int, min_length: int):
    """Host tail of CnsTable.call: split the emitted bases at low-coverage
    template positions.  emit_row [L, D1] int32, cov_ok_row [L] bool."""
    import numpy as np

    emit_row = np.asarray(emit_row)[:tlen]
    cov_ok_row = np.asarray(cov_ok_row)[:tlen]
    D1 = emit_row.shape[1]
    seg_id = np.repeat(np.cumsum(~cov_ok_row), D1)
    flat = emit_row.reshape(-1)
    mask = flat >= 0
    bases = flat[mask].astype(np.uint8)
    segs = seg_id[mask]
    if len(bases) == 0:
        return []
    cut = np.nonzero(np.diff(segs))[0] + 1
    return [s for s in np.split(bases, cut) if len(s) >= min_length]


@partial(jax.jit, static_argnums=(2,))
def pack_emit_cov(emit: jnp.ndarray, cov_ok: jnp.ndarray, k: int):
    """Transfer-layer packing of the per-slice emit pull.

    The emit array ([T, L, k] values in -1..4 after the insertion-prefix
    truncation) and the cov_ok bools are the ONLY arrays mecat2cns pulls per
    table slice, so these bytes are the device->host transfer.  Values fit a nibble (+1 -> 0..5):
    pack L-adjacent pairs into one uint8 (2x), and cov_ok into bits (8x).
    unpack_emit_cov is the exact inverse; the device-vs-host differential
    tests (tests/test_cns_device.py) run through this path byte-for-byte.
    """
    e = (emit[:, :, :k] + 1).astype(jnp.uint8)
    T, L, _ = e.shape
    if L % 2:
        e = jnp.pad(e, ((0, 0), (0, 1), (0, 0)))
    packed = (e[:, 0::2] | (e[:, 1::2] << 4)).astype(jnp.uint8)
    c = cov_ok.astype(jnp.int32)
    pad = (-L) % 8
    if pad:
        c = jnp.pad(c, ((0, 0), (0, pad)))
    cbits = (c.reshape(T, -1, 8) << jnp.arange(8, dtype=jnp.int32)).sum(
        axis=2).astype(jnp.uint8)
    return packed, cbits


def unpack_emit_cov(packed, cbits, L: int):
    """Host inverse of pack_emit_cov -> (emit int8 [T, L, k], cov bool [T, L])."""
    import numpy as np

    packed = np.asarray(packed)
    lo = (packed & 0xF).astype(np.int8) - 1
    hi = (packed >> 4).astype(np.int8) - 1
    T, Lh, k = packed.shape
    e = np.empty((T, 2 * Lh, k), np.int8)
    e[:, 0::2] = lo
    e[:, 1::2] = hi
    cov = np.unpackbits(np.asarray(cbits), axis=1,
                        bitorder="little")[:, :L].astype(bool)
    return e[:, :L], cov
