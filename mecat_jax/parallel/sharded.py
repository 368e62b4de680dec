"""Multi-chip sharded overlap step: data-parallel reads × hash-sharded index.

This is the device-mesh restatement of the reference's scale-out story (SURVEY.md
§2.3/§2.4): where the reference shards work as volumes on a shared
filesystem and grid array jobs, we shard over a ``jax.sharding.Mesh`` with
two axes:

* ``data`` — query read batches, the DP analog (reference: volume streaming);
* ``hash`` — the k-mer index split by code range, the "expert-routing-shaped"
  axis (reference: one lookup table per volume).  Every device probes its
  index shard for the whole local query batch, then hits are exchanged with
  ``all_to_all`` between devices so each device ends up scoring/extending a 1/|hash|
  slice of the queries with the hits from *all* shards — exactly the
  north-star design in BASELINE.json.

The volume's packed bases are replicated (cheap: 1 byte/base) so extension
is local after the exchange; per-read overlap lists never need a second
collective because scoring happens where the hits land.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C
from ..index.kmer_index import KmerIndex
from ..ops import ddf
from ..ops.align import extend_pair_batch
from ..pipeline.device_step import OverlapStepOut


def make_mesh(n_data: int, n_hash: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_data * n_hash, (len(devices), n_data, n_hash)
    arr = np.asarray(devices[: n_data * n_hash]).reshape(n_data, n_hash)
    return Mesh(arr, axis_names=("data", "hash"))


def shard_index_by_hash(idx: KmerIndex, n_hash: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Split a CSR k-mer table into n_hash equal code ranges.

    Returns (offsets_sh [n_hash, spp+1], rid_sh [n_hash, P_max],
    loc_sh [n_hash, P_max], code_lo [n_hash]) with per-shard offsets rebased
    to the shard's occurrence slice, padded to the longest shard.
    """
    n_slots = len(idx.offsets) - 1
    assert n_slots % n_hash == 0, (n_slots, n_hash)
    spp = n_slots // n_hash
    off_sh, rid_sh, loc_sh, lo = [], [], [], []
    for h in range(n_hash):
        a, b = h * spp, (h + 1) * spp
        base = int(idx.offsets[a])
        off_sh.append(idx.offsets[a:b + 1].astype(np.int32) - base)
        rid_sh.append(idx.pos_rid[base:int(idx.offsets[b])])
        loc_sh.append(idx.pos_loc[base:int(idx.offsets[b])])
        lo.append(a)
    pmax = max(1, max(len(p) for p in rid_sh))
    rid_pad = np.zeros((n_hash, pmax), dtype=np.int32)
    loc_pad = np.zeros((n_hash, pmax), dtype=np.int32)
    for h in range(n_hash):
        rid_pad[h, :len(rid_sh[h])] = rid_sh[h]
        loc_pad[h, :len(loc_sh[h])] = loc_sh[h]
    return (np.stack(off_sh), rid_pad, loc_pad,
            np.asarray(lo, dtype=np.int32))


def sharded_overlap_step(
    mesh: Mesh,
    *,
    k: int = C.KMER_SIZE,
    stride: int = C.KMER_SCAN_STRIDE,
    max_occ: int = C.MAX_OCC_PER_KMER,
    num_candidates: int = 16,
    diag_bin: int = C.DDF_DIAG_BIN,
    L_target: int = 2048,
    S: int = C.ALIGN_SEGMENT,
    W: int = C.ALIGN_BAND,
    max_segs: int = 8,
    min_align_size: int = C.DEFAULT_MIN_ALIGN_SIZE,
    min_identity: float = C.MIN_OVERLAP_IDENTITY,
):
    """Build the pjit-able sharded overlap step for `mesh`.

    Argument shardings (enforced by shard_map):
      bases/lengths/self_id: sharded over 'data' (replicated over 'hash');
      offsets_sh/positions_sh/code_lo: leading dim sharded over 'hash'
        (replicated over 'data');
      vol_codes/read_starts/read_lengths/cutoff: replicated.

    Output: OverlapStepOut with leading dim sharded over ('data', 'hash') —
    each device owns the results of its 1/(data*hash) query slice.
    """
    n_hash = mesh.shape["hash"]

    def step(bases, lengths, self_id, vol_codes, offsets_sh, rid_sh,
             loc_sh, code_lo, read_starts, read_lengths, cutoff):
        # local views: bases [Bl, L]; offsets_sh [1, spp+1]; code_lo [1]
        Bl = bases.shape[0]
        assert Bl % n_hash == 0, (Bl, n_hash)
        Bh = Bl // n_hash
        offsets_l = offsets_sh[0]
        lo = code_lo[0]
        spp = offsets_l.shape[0] - 1

        # 1. probe the local hash shard for the full local query batch
        rid, dbin, hqpos, toff, hvalid = ddf.probe_hits(
            bases, lengths, offsets_l, rid_sh[0], loc_sh[0],
            cutoff, self_id, k=k, stride=stride,
            max_occ=max_occ, diag_bin=diag_bin,
            code_lo=lo, code_hi=lo + spp)

        # 2. all-to-all over 'hash': device h keeps query slice h, gains the
        #    hits every shard found for that slice  → [Bh, H * n_hash]
        def exchange(x):
            return jax.lax.all_to_all(x, "hash", split_axis=0, concat_axis=1,
                                      tiled=True)
        rid, dbin, hqpos, toff = (
            exchange(rid), exchange(dbin), exchange(hqpos), exchange(toff))
        hvalid = exchange(hvalid.astype(jnp.int8)) != 0

        # 3. score the combined hits for this device's query slice
        cand = ddf.score_hits(rid, dbin, hqpos, toff, hvalid,
                              num_candidates=num_candidates)

        # 4. local extension against the replicated volume
        h = jax.lax.axis_index("hash")
        q_sub = jax.lax.dynamic_slice_in_dim(bases, h * Bh, Bh, axis=0)
        qlen_sub = jax.lax.dynamic_slice_in_dim(lengths, h * Bh, Bh, axis=0)
        N = num_candidates
        tgt = jnp.clip(cand.target, 0, read_starts.shape[0] - 1).reshape(-1)
        t_start = read_starts[tgt].astype(jnp.int32)
        t_len = read_lengths[tgt].astype(jnp.int32)
        vol_pad = jnp.concatenate(
            [vol_codes, jnp.zeros(L_target, dtype=vol_codes.dtype)])
        rows = jax.vmap(
            lambda o: jax.lax.dynamic_slice(vol_pad, (o,),
                                            (L_target,)))(t_start)
        col = jnp.arange(L_target, dtype=jnp.int32)
        t_rows = jnp.where(col[None, :] < t_len[:, None], rows, 0)
        res = extend_pair_batch(
            jnp.repeat(q_sub, N, axis=0), t_rows,
            jnp.repeat(qlen_sub, N), t_len,
            jnp.maximum(cand.qseed.reshape(-1), 0),
            jnp.minimum(jnp.maximum(cand.tseed.reshape(-1), 0),
                        jnp.maximum(t_len - 1, 0)),
            S=S, W=W, max_segs=max_segs)

        qspan = (res.qend - res.qbeg).reshape(Bh, N)
        tspan = (res.tend - res.tbeg).reshape(Bh, N)
        ok = (cand.valid
              & (res.identity.reshape(Bh, N) >= min_identity)
              & (jnp.minimum(qspan, tspan) >= min_align_size))
        return OverlapStepOut(
            target=cand.target, score=cand.score,
            qbeg=res.qbeg.reshape(Bh, N), qend=res.qend.reshape(Bh, N),
            tbeg=res.tbeg.reshape(Bh, N), tend=res.tend.reshape(Bh, N),
            identity=res.identity.reshape(Bh, N), valid=ok,
            qseed=cand.qseed, tseed=cand.tseed,
            n_segs=res.n_segs.reshape(Bh, N))

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"),        # queries
                  P(),                                     # vol_codes
                  P("hash"), P("hash"), P("hash"), P("hash"),  # index shards
                  P(), P(), P()),                          # read tables
        out_specs=jax.tree.map(lambda _: P(("data", "hash")),
                               OverlapStepOut(*(0,) * 11)),
        check_vma=False)
    return jax.jit(mapped)


def sharded_probe_step(
    mesh: Mesh,
    *,
    k: int = C.KMER_SIZE,
    stride: int = C.KMER_SCAN_STRIDE,
    max_occ: int = C.MAX_OCC_PER_KMER,
    num_candidates: int = 16,
    diag_bin: int = C.DDF_DIAG_BIN,
    L_target: int = 2048,
    S: int = C.ALIGN_SEGMENT,
    W: int = C.ALIGN_BAND,
    min_block_score: int = C.MIN_BLOCK_SCORE,
):
    """Two-phase sharded overlap, phase 1: scan + exchange + 1-seg probe.

    Mesh restatement of pipeline/device_step.probe_step: each hash shard
    probes its code range for the whole local query batch, hits ride an
    all_to_all over 'hash', every device scores + probe-extends its
    1/(data*hash) query slice with seed-centred target windows.  Outputs are
    FLAT [B*N] arrays sharded over ('data', 'hash'):
    (target, score, qseed, tseed, survive).  survive applies the same
    prune-only filter as the single-chip step, so phase-2 extension of the
    survivors reproduces the fused path's overlaps exactly.
    """
    from ..pipeline.device_step import _target_windows

    n_hash = mesh.shape["hash"]
    N = num_candidates

    def step(bases, lengths, self_id, vol_codes, offsets_sh, rid_sh,
             loc_sh, code_lo, read_starts, read_lengths, cutoff):
        Bl = bases.shape[0]
        Bh = Bl // n_hash
        offsets_l = offsets_sh[0]
        lo = code_lo[0]
        spp = offsets_l.shape[0] - 1
        rid, dbin, hqpos, toff, hvalid = ddf.probe_hits(
            bases, lengths, offsets_l, rid_sh[0], loc_sh[0],
            cutoff, self_id, k=k, stride=stride, max_occ=max_occ,
            diag_bin=diag_bin, code_lo=lo, code_hi=lo + spp)

        def exchange(x):
            return jax.lax.all_to_all(x, "hash", split_axis=0, concat_axis=1,
                                      tiled=True)
        rid, dbin, hqpos, toff = (
            exchange(rid), exchange(dbin), exchange(hqpos), exchange(toff))
        hvalid = exchange(hvalid.astype(jnp.int8)) != 0
        cand = ddf.score_hits(rid, dbin, hqpos, toff, hvalid,
                              num_candidates=N)

        h = jax.lax.axis_index("hash")
        q_sub = jax.lax.dynamic_slice_in_dim(bases, h * Bh, Bh, axis=0)
        qlen_sub = jax.lax.dynamic_slice_in_dim(lengths, h * Bh, Bh, axis=0)
        tgt = jnp.clip(cand.target, 0, read_starts.shape[0] - 1).reshape(-1)
        t, t_len_w, ts_local, _ = _target_windows(
            vol_codes, read_starts, read_lengths, tgt,
            cand.tseed.reshape(-1), L_target)
        probe = extend_pair_batch(
            jnp.repeat(q_sub, N, axis=0), t, jnp.repeat(qlen_sub, N),
            t_len_w, jnp.maximum(cand.qseed.reshape(-1), 0), ts_local,
            S=S, W=W, max_segs=1)
        short = probe.align_len < 96          # too little evidence: keep
        looks_ok = probe.identity >= 55.0
        survive = (cand.valid.reshape(-1)
                   & (cand.score.reshape(-1) >= min_block_score)
                   & (short | looks_ok))
        return (cand.target.reshape(-1), cand.score.reshape(-1),
                cand.qseed.reshape(-1), cand.tseed.reshape(-1), survive)

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"),
                  P(),
                  P("hash"), P("hash"), P("hash"), P("hash"),
                  P(), P(), P()),
        out_specs=(P(("data", "hash")),) * 5,
        check_vma=False)
    return jax.jit(mapped)


def sharded_extend_step(
    mesh: Mesh,
    *,
    K: int,
    N: int,
    L_target: int = 2048,
    S: int = C.ALIGN_SEGMENT,
    W: int = C.ALIGN_BAND,
    max_segs: int = 16,
):
    """Two-phase sharded overlap, phase 2: full extension of survivors.

    Mesh restatement of pipeline/device_step.extend_selected: every device
    extends K selected candidates of its own query slice (sel = local flat
    indices into the device's [Bh*N] candidate block, padded with 0s).
    Returns flat [n_dev*K] arrays sharded over ('data', 'hash'):
    (identity, qbeg, qend, tbeg, tend, win0) with tbeg/tend WINDOW-LOCAL.
    """
    from ..pipeline.device_step import _target_windows

    n_hash = mesh.shape["hash"]

    def step(bases, lengths, vol_codes, read_starts, read_lengths,
             tgt_flat, qseed_flat, tseed_flat, sel):
        Bl = bases.shape[0]
        Bh = Bl // n_hash
        h = jax.lax.axis_index("hash")
        rowi = sel // N + h * Bh           # row within the local data slice
        tgt = jnp.clip(tgt_flat[sel], 0, read_starts.shape[0] - 1)
        q = bases[rowi]
        qlen = lengths[rowi]
        t, t_len_w, ts_local, win0 = _target_windows(
            vol_codes, read_starts, read_lengths, tgt, tseed_flat[sel],
            L_target)
        res = extend_pair_batch(
            q, t, qlen, t_len_w, jnp.maximum(qseed_flat[sel], 0), ts_local,
            S=S, W=W, max_segs=max_segs)
        return res.identity, res.qbeg, res.qend, res.tbeg, res.tend, win0

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("data"), P("data"), P(), P(), P(),
                  P(("data", "hash")), P(("data", "hash")),
                  P(("data", "hash")), P(("data", "hash"))),
        out_specs=(P(("data", "hash")),) * 6,
        check_vma=False)
    return jax.jit(mapped)


def place_sharded_inputs(mesh: Mesh, bases, lengths, self_id, vol_codes,
                         offsets_sh, rid_sh, loc_sh, code_lo, read_starts,
                         read_lengths, cutoff):
    """Device-put host arrays with the shardings sharded_overlap_step expects."""
    def put(x, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    return (put(bases, P("data")), put(lengths, P("data")),
            put(self_id, P("data")), put(vol_codes, P()),
            put(offsets_sh, P("hash")), put(rid_sh, P("hash")),
            put(loc_sh, P("hash")),
            put(code_lo, P("hash")), put(read_starts, P()),
            put(read_lengths, P()), put(cutoff, P()))
