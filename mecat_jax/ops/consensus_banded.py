"""Banded consensus tag emission: row-walk -> dense sliding-band planes.

Drop-in replacement for the tape route of ops/consensus_device.py
(reference mecat2cns tag tally, SURVEY.md §3.2 — unverified, mount empty).
The tape route pays two scatter/gather walls per chunk:

  * the serial column-walk traceback: one element-gather per tape column
    per lane;
  * the presence scatter over every [G, B, MAXC] tape slot.

Both disappear by exploiting the band: the row-major walk
(ops/align.traceback_rows) visits DP ROWS, and every tag a row produces
lands within the DP band of that row — so a second S-step scan deposits
tags into a [lanes, W] accumulator that SLIDES with the band, emitting one
finished template-char column per step.  No gathers, no scatters; the only
scattered work left is one batched side-band fix-up for insertion runs that
cross segment/seed boundaries (a few hundred elements per chunk).

Planes per direction (segment-local target CHAR coordinates c, 0-based at
the segment's toff):
  val0  int8  : delta-0 channel — base code consumed at c, GAP if deleted,
                -1 if not consumed;
  ipack int32 : insertion bases anchored at c, 2 bits per delta, delta d at
                bits 2(d-1), d = 1..15 (deltas beyond MAX_INS_DELTA drop,
                matching the host keep rule);
  icnt  int32 : total insertion-run length anchored at c (UNCLAMPED —
                boundary continuations need the true count).

Anchor conventions (band geometry; differentially tested for exact counts
equality against ops/consensus_device.accumulate_tags):
  right direction: a VERT at row r, band col w sits at target count
    j = r - W/2 + w; its anchor char is j-1; runs with j == 0 anchor in the
    PREVIOUS segment (side-band, target dir-local char toff-1).
  left direction: global order reverses the local walk, so a run's anchor
    char is j (not j-1), per-run deltas reverse, and runs with j == j_end
    anchor in the NEXT local segment (side-band, target toff + j_end).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants as C
from .align import MOVE_MATCH, MOVE_MISMATCH, MOVE_VERT
from .consensus import GAP

MAXD = C.MAX_INS_DELTA  # 15: 2-bit bases for deltas 1..15 fit one int32


def run_deltas(mv: jnp.ndarray, h: jnp.ndarray, left: bool):
    """Per-row insertion-run positions from row-walk outputs.

    mv, h: int32 [..., S] ascending-row arrays (index i = row r-1).  A VERT
    run is a maximal set of consecutive VERT rows with h == 0 between them
    (forward tape order is [mv_r, HORIZ^h_r], so row r joins row r-1's run
    iff mv[r-1] == VERT and h[r-1] == 0).  Returns delta int32 [..., S]:
    for VERT rows the GLOBAL-order run position (right direction: ascending
    rows; left: descending — global order reverses the local walk), else 0.
    """
    S = mv.shape[-1]
    ax = mv.ndim - 1
    isv = mv == MOVE_VERT
    prev_v = jnp.concatenate(
        [jnp.zeros_like(isv[..., :1]), isv[..., :-1]], axis=ax)
    prev_h0 = jnp.concatenate(
        [jnp.zeros_like(h[..., :1]), h[..., :-1]], axis=ax) == 0
    start = isv & ~(prev_v & prev_h0)
    i_idx = jax.lax.broadcasted_iota(jnp.int32, mv.shape, ax)
    start_idx = jax.lax.cummax(jnp.where(start, i_idx, -1), axis=ax)
    d_fwd = jnp.where(isv, i_idx - start_idx + 1, 0)
    if not left:
        return d_fwd
    # row e ends its run iff row e+1 does not continue it (non-VERT, or
    # h[e] > 0 breaks adjacency in the forward tape)
    nxt_v = jnp.concatenate(
        [isv[..., 1:], jnp.zeros_like(isv[..., :1])], axis=ax)
    run_end = isv & ~(nxt_v & (h == 0))
    end_idx = jnp.flip(jax.lax.cummin(
        jnp.flip(jnp.where(run_end, i_idx, S), axis=ax), axis=ax), axis=ax)
    run_len = end_idx - start_idx + 1
    return jnp.where(isv, run_len - d_fwd + 1, 0)


def _deposit_scan(wo, aw, h, mv, vbase, delta, keep_ins, W: int):
    """Sliding-band deposit: per-row tags -> per-segment local planes.

    All row arrays are [N, S] lane-major (N = segment-lanes x pairs,
    ascending rows).  Scans rows DESCENDING (the direction the band slides);
    at row r the accumulator column w holds target char c = (r-1) + w - W/2:
    a diagonal's consumed char is col wo, its h trailing deletions are cols
    wo+1..wo+h, and an insertion deposits at col aw (right: wo; left: wo+1).
    Each step emits the exiting top column; chars below the final window
    come from the end state.  Returns (val0, ipack, icnt) planes
    [N, S + W//2 - 1] in ascending-char order.
    """
    N, S = wo.shape
    half = W // 2
    w_iota = jnp.arange(W, dtype=jnp.int32)[None, :]

    def step(state, xs):
        a0, ap, ac = state
        wo_r, aw_r, h_r, mv_r, vb_r, d_r, ki_r = xs
        isd = (mv_r == MOVE_MATCH) | (mv_r == MOVE_MISMATCH)
        a0 = jnp.where(isd[:, None] & (w_iota == wo_r[:, None]),
                       vb_r[:, None].astype(jnp.int8), a0)
        gap = ((w_iota > wo_r[:, None]) & (w_iota <= (wo_r + h_r)[:, None])
               & (mv_r >= 0)[:, None])
        a0 = jnp.where(gap, jnp.int8(GAP), a0)
        dep = ((ki_r & (d_r >= 1) & (d_r <= MAXD))[:, None]
               & (w_iota == aw_r[:, None]))
        ap = jnp.where(dep, ap | (vb_r[:, None] << (2 * jnp.maximum(d_r[:, None] - 1, 0))),
                       ap)
        cnt = (ki_r & (d_r >= 1))[:, None] & (w_iota == aw_r[:, None])
        ac = jnp.where(cnt, jnp.maximum(ac, d_r[:, None]), ac)
        ys = (a0[:, -1], ap[:, -1], ac[:, -1])
        z8 = jnp.full((N, 1), -1, jnp.int8)
        z32 = jnp.zeros((N, 1), jnp.int32)
        return (jnp.concatenate([z8, a0[:, :-1]], axis=1),
                jnp.concatenate([z32, ap[:, :-1]], axis=1),
                jnp.concatenate([z32, ac[:, :-1]], axis=1)), ys

    flip = lambda a: jnp.flip(a, axis=1).T        # [N, S] -> [S, N] desc rows
    init = (jnp.full((N, W), -1, jnp.int8),
            jnp.zeros((N, W), jnp.int32), jnp.zeros((N, W), jnp.int32))
    (f0, fp, fc), (y0, yp, yc) = jax.lax.scan(
        step, init, (flip(wo), flip(aw), flip(h), flip(mv), flip(vbase),
                     flip(delta), flip(keep_ins)))
    # emitted step s (row S-s) holds char S - s + half - 2, so ascending
    # char order is reversed steps; chars [0, half-1) sit in the end state
    # at cols [half+1, W) (col w <-> char w - half - 1 after the last slide)
    lo = lambda f: f[:, half + 1:]
    hi = lambda y: jnp.flip(y.T, axis=1)
    return (jnp.concatenate([lo(f0), hi(y0)], axis=1),
            jnp.concatenate([lo(fp), hi(yp)], axis=1),
            jnp.concatenate([lo(fc), hi(yc)], axis=1))


def direction_rowinfo(rows, q: jnp.ndarray, qseed: jnp.ndarray, S: int,
                      W: int, left: bool):
    """One direction's row-walk outputs -> deposit-scan row arrays.

    rows: (mv, h, wo [G, B, S], w0 [G, B], qoff, toff, ok) from
    ops/align.extend_pair_batch_rows, in the direction's local coordinates.
    q: uint8 [B, Lq] support chars in the scanned (forward) orientation.

    Returns (row arrays dict, bnd_pack, bnd_cnt [G, B] side-band runs,
    toff, j_end, lead [G, B]).  The row arrays are direction-agnostic once
    built (the left/right differences — anchor column, delta orientation,
    side-band selection — are folded into the data), so both directions
    share ONE deposit scan.
    """
    mv, h, wo, w0, qoff, toff, ok = rows
    G, B, _ = mv.shape
    half = W // 2
    i_idx = jax.lax.broadcasted_iota(jnp.int32, mv.shape, 2)
    j = (i_idx + 1) - half + wo                   # target count at the move
    j_end = jnp.max(jnp.where(mv >= 0, j + h, -1), axis=2)  # [G, B]

    # per-row consumed query char: right q[qseed+qoff+i]; left the reversed
    # prefix q[qseed-1-qoff-i] — both one contiguous slice per segment
    qp = jnp.concatenate(
        [jnp.zeros((B, S), q.dtype), q, jnp.zeros((B, S), q.dtype)], axis=1)
    offs = (qseed[None, :] - qoff if left
            else S + qseed[None, :] + qoff).astype(jnp.int32)
    qrows = jax.vmap(jax.vmap(
        lambda row, o: jax.lax.dynamic_slice(row, (o,), (S,)),
        in_axes=(0, 0)), in_axes=(None, 0))(qp, offs)
    if left:
        qrows = jnp.flip(qrows, axis=2)
    vbase = qrows.astype(jnp.int32)

    delta = run_deltas(mv, h, left=left)
    isv = mv == MOVE_VERT
    if left:
        sideband = isv & (j == j_end[:, :, None])
        aw = wo + 1                               # anchor char j -> col wo+1
    else:
        sideband = isv & (j == 0)
        aw = wo
    okx = ok[:, :, None]
    keep_ins = isv & ~sideband & okx

    sb = sideband & okx
    sb_d = jnp.where(sb, delta, 0)
    bnd_cnt = jnp.max(sb_d, axis=2)
    bits = jnp.where(sb & (sb_d <= MAXD),
                     vbase << (2 * jnp.maximum(sb_d - 1, 0)), 0)
    bnd_pack = jax.lax.reduce(bits, jnp.int32(0), jax.lax.bitwise_or, (2,))

    info = dict(wo=wo, aw=aw, h=jnp.where(okx, h, 0),
                mv=jnp.where(okx, mv, -1), vbase=vbase, delta=delta,
                keep_ins=keep_ins)
    lead = jnp.maximum(w0 - half, 0)
    return info, bnd_pack, bnd_cnt, toff, j_end, lead, ok


def _planes_from_rowinfo(infos, oks, leads, S: int, W: int):
    """ONE deposit scan over every direction's segments, then per-direction
    ok-masking and leading-deletion GAP marks.  Returns a list of
    (val0, ipack, icnt) [G, B, LP] tuples, one per input info."""
    half = W // 2
    LP = S + half - 1
    shapes = [i["wo"].shape for i in infos]
    flat = lambda k: jnp.concatenate(
        [i[k].reshape(-1, S) for i in infos], axis=0)
    v0, ip, ic = _deposit_scan(flat("wo"), flat("aw"), flat("h"), flat("mv"),
                               flat("vbase"), flat("delta"),
                               flat("keep_ins"), W)
    out = []
    ofs = 0
    for (G, B, _), ok, lead in zip(shapes, oks, leads):
        n = G * B
        sl = slice(ofs, ofs + n)
        ofs += n
        p0 = v0[sl].reshape(G, B, LP)
        pp = ip[sl].reshape(G, B, LP)
        pc = ic[sl].reshape(G, B, LP)
        okx = ok[:, :, None]
        c_iota = jnp.arange(LP, dtype=jnp.int32)[None, None, :]
        p0 = jnp.where(okx & (c_iota < lead[:, :, None]), jnp.int8(GAP), p0)
        out.append((p0, pp, pc))
    return out


def _window_write(planes, toff, ok, LG: int):
    """Forward scan of per-segment window writes into [B, LG] planes.

    Clobber-safe: every TRUE cell of segment g sits below segment g+1's
    window start (right: cells <= toff+j-1 < toff_next; left: cells < j_end
    only, the j == j_end run is side-banded), so later windows only
    overwrite empty tails.  Non-applied segments are masked empty here.
    """
    v0, ip, ic = planes
    G, B, LP = v0.shape

    def step(state, xs):
        g0, gp, gc = state
        s0, sp, sc, o = xs
        upd = jax.vmap(lambda dst, src, oo: jax.lax.dynamic_update_slice(
            dst, src, (oo,)))
        return (upd(g0, s0, o), upd(gp, sp, o), upd(gc, sc, o)), None

    okx = ok[:, :, None]
    init = (jnp.full((B, LG), -1, jnp.int8),
            jnp.zeros((B, LG), jnp.int32), jnp.zeros((B, LG), jnp.int32))
    (g0, gp, gc), _ = jax.lax.scan(
        step, init, (jnp.where(okx, v0, jnp.int8(-1)),
                     jnp.where(okx, ip, 0), jnp.where(okx, ic, 0),
                     jnp.clip(toff, 0, LG - LP)))
    return g0, gp, gc


def _segmented(vals, same, comb, dtype):
    """Within-group inclusive scan over axis 0 (groups = runs of same)."""
    def f(a, b):
        av, am = a
        bv, bm = b
        return jnp.where(bm, comb(av, bv), bv), am & bm
    out, _ = jax.lax.associative_scan(f, (vals.astype(dtype), same), axis=0)
    return out


@partial(jax.jit, static_argnames=("L_t", "S", "W"))
def banded_global_planes(right_rows, left_rows, q, qseed, tseed,
                         *, L_t: int, S: int, W: int):
    """Both directions -> GLOBAL template-coordinate planes [B, L_t].

    Assembles each direction's local planes, places them around the seed
    (left flipped: local char c <-> global tseed-1-c; right at tseed+c),
    then applies the side-band insertion continuations in global column
    order (left descending segments, then right ascending) with live delta
    offsets: base = the assembled plane's run count at the target cell,
    plus a segmented prefix over same-cell side-band chains.  One batched
    gather + one batched scatter over (G_l + G_r) x B elements.
    """
    B = q.shape[0]
    half = W // 2
    LP = S + half - 1
    LG = L_t + LP + S

    ri, rbp, rbc, rtoff, _, rlead, rok = direction_rowinfo(
        right_rows, q, qseed, S, W, left=False)
    li, lbp, lbc, ltoff, lj_end, llead, lok = direction_rowinfo(
        left_rows, q, qseed, S, W, left=True)
    planes_r, planes_l = _planes_from_rowinfo(
        [ri, li], [rok, lok], [rlead, llead], S, W)
    r0, rp, rc = _window_write(planes_r, rtoff, right_rows[6], LG)
    l0, lp, lc = _window_write(planes_l, ltoff, left_rows[6], LG)

    Lb = LG + L_t + LG  # buffer origin LG: left placement never underflows
    place = jax.vmap(lambda dst, src, o: jax.lax.dynamic_update_slice(
        dst, src, (o,)))

    def build(lv, rv, fill, dt):
        g = jnp.full((B, Lb), fill, dt)
        g = place(g, jnp.flip(lv, axis=1), tseed)  # global [tseed-LG, tseed)
        return place(g, rv, LG + tseed)            # global [tseed, tseed+LG)

    g0 = build(l0, r0, jnp.int8(-1), jnp.int8)
    gp = build(lp, rp, jnp.int32(0), jnp.int32)
    gc = build(lc, rc, jnp.int32(0), jnp.int32)

    # ---- side-band application (global column order) ----
    l_cell = LG + tseed[None, :] - 1 - (ltoff + jnp.maximum(lj_end, 0))
    r_cell = LG + tseed[None, :] + rtoff - 1
    rev = lambda a: jnp.flip(a, axis=0)
    cells = jnp.concatenate([rev(l_cell), r_cell], axis=0)
    packs = jnp.concatenate([rev(lbp), rbp], axis=0)
    cnts = jnp.concatenate([rev(lbc), rbc], axis=0)
    oks = jnp.concatenate([rev(left_rows[6]), right_rows[6]], axis=0)
    cnts = jnp.where(oks, cnts, 0)

    cells_c = jnp.clip(cells, 0, Lb - 1)
    b_iota = jax.lax.broadcasted_iota(jnp.int32, cells.shape, 1)
    base_cnt = gc[b_iota, cells_c]
    live = (cnts > 0) & (g0[b_iota, cells_c] >= 0)  # unconsumed anchor: drop
    cnts = jnp.where(live, cnts, 0)

    same = jnp.concatenate(
        [jnp.zeros((1, B), bool), cells[1:] == cells[:-1]], axis=0)
    chain_off = _segmented(cnts, same, jnp.add, jnp.int32) - cnts
    off = base_cnt + chain_off
    # int32-safe: only bits below 2*MAXD survive, and off < MAXD bounds the
    # shift at 2*(MAXD-1) = 28 < 31 (x64 is disabled on this stack — an
    # int64 route would silently truncate)
    shift = jnp.clip(2 * off, 0, 2 * MAXD)
    shifted = jnp.where(live & (off < MAXD),
                        (packs << shift) & jnp.int32((1 << (2 * MAXD)) - 1),
                        0)
    pack_acc = _segmented(shifted, same, jnp.bitwise_or, jnp.int32)
    cnt_acc = _segmented(cnts, same, jnp.add, jnp.int32)
    is_last = jnp.concatenate(
        [cells[1:] != cells[:-1], jnp.ones((1, B), bool)], axis=0)
    write = is_last & (cnt_acc > 0)
    wcell = jnp.where(write, cells_c, Lb)
    gp = gp.at[b_iota, wcell].set(gp[b_iota, cells_c] | pack_acc,
                                  mode="drop")
    gc = gc.at[b_iota, wcell].set(base_cnt + cnt_acc, mode="drop")

    o = LG
    return g0[:, o:o + L_t], gp[:, o:o + L_t], gc[:, o:o + L_t]


def banded_presence(g0, gpack, gcnt, tlen, pair_ok, L_t: int,
                    max_delta: int = C.MAX_INS_DELTA):
    """Global planes -> the per-pair tag presence buffer int8 [B, L_t, D1, 5]
    (the matmul-fold operand of accumulate_tags, built scatter-free)."""
    B = g0.shape[0]
    D1 = max_delta + 1
    l_idx = jnp.arange(L_t, dtype=jnp.int32)[None, :]
    ok = pair_ok[:, None] & (l_idx < tlen[:, None])
    pres0 = ((g0[:, :, None] == jnp.arange(5, dtype=jnp.int8)[None, None, :])
             & ok[:, :, None]).astype(jnp.int8)
    d = jnp.arange(1, D1, dtype=jnp.int32)[None, None, :]
    based = (gpack[:, :, None] >> (2 * (d - 1))) & 3
    presd = ((d <= gcnt[:, :, None])[:, :, :, None] & ok[:, :, None, None]
             & (based[:, :, :, None]
                == jnp.arange(4, dtype=jnp.int32)[None, None, None, :]))
    presd = jnp.concatenate(
        [presd, jnp.zeros((B, L_t, D1 - 1, 1), bool)], axis=3)
    return jnp.concatenate([pres0[:, :, None, :], presd.astype(jnp.int8)],
                           axis=2)


def banded_accumulate_tags(counts, cov_diff, right_rows, left_rows,
                           qseed, tseed, support, tlen, t_slot, pair_ok,
                           tbeg, tend, *, L_t: int, S: int, W: int):
    """accumulate_tags twin fed by row-walk outputs (no tapes, no scatter).

    Same (counts, cov_diff) contract and donation pattern; differential
    tests assert exact equality with the tape path.
    """
    T = counts.shape[0]
    g0, gpk, gcn = banded_global_planes(
        right_rows, left_rows, support, qseed, tseed, L_t=L_t, S=S, W=W)
    pres = banded_presence(g0, gpk, gcn, tlen, pair_ok, L_t)
    B = pres.shape[0]
    onehot = ((t_slot[None, :] == jnp.arange(T, dtype=jnp.int32)[:, None])
              & pair_ok[None, :]).astype(jnp.int8)
    contrib = jax.lax.dot(onehot, pres.reshape(B, -1),
                          preferred_element_type=jnp.int32)
    counts = counts + contrib.reshape(counts.shape)

    a = jnp.clip(tbeg, 0, L_t)
    b = jnp.clip(jnp.minimum(tend, tlen), 0, L_t)
    span_ok = pair_ok & (b > a)
    rows_i = jnp.where(span_ok, t_slot, T)
    cov_diff = cov_diff.at[rows_i, a].add(1, mode="drop")
    cov_diff = cov_diff.at[rows_i, b].add(-1, mode="drop")
    return counts, cov_diff
