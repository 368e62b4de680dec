"""Distributed mecat2cns: template-sharded consensus over the device mesh.

Device-mesh restatement of the reference's consensus batch partitioning at multi-host
scale (SURVEY.md §2.3 batch-partitioning row; BASELINE config 5 "overlap +
correction sharded across 4 hosts").  Where the reference shards mecat2cns
work as `-p`-sized template batches across grid jobs with a shared
filesystem, we shard the TEMPLATE axis of the device tag tables over a
1-axis ``data`` mesh:

* every device owns a contiguous slice of each table batch's templates —
  its tag-count buffer ``[T/n, L, D1, 5]`` lives on that device only;
* support→template alignment chunks are routed host-side to the owning
  device (the pair lists are grouped by template slot, so no collective is
  needed for the tag fold itself — templates are independent piles);
* the vote (call_tables) runs under the same sharding; only the tiny int8
  emit arrays come back, each PROCESS pulling only its addressable shards
  and writing its own corrected-FASTA shard (per-host output files, rank-0
  deterministic merge — the reference's per-batch output concatenation).

The per-device compute is exactly pipeline/cns.py's device chunk
(make_cns_chunk) wrapped in ``jax.shard_map``; integer tag adds commute, so
the sharded run is bit-for-bit equal to the single-device path per template
(tests/test_cns_dist.py asserts record-exact equality with run_cns).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from .. import constants as C
from ..io.fasta import format_fasta
from ..io.packed_db import PackedDB, pack_2bit
from ..pipeline.cns import (CnsOptions, CnsStats, load_supports,
                            make_cns_chunk, plan_pairs, plan_table_slices,
                            seg_bucket, _gather_rows_dev)
from ..pipeline.common import bucket_length, max_segs_for
from ..utils.log import get_logger
from .dist import init_distributed

log = get_logger("cns_dist")

_CHUNK_CACHE: Dict = {}
_CALL_CACHE: Dict = {}
_ZEROS_CACHE: Dict = {}


def make_cns_mesh(n_data: Optional[int] = None, devices=None):
    import jax
    from jax.sharding import Mesh

    devices = devices if devices is not None else jax.devices()
    n_data = n_data or len(devices)
    return Mesh(np.asarray(devices[:n_data]), axis_names=("data",))


def device_volume_mesh(db: PackedDB, mesh):
    """Replicated device volume [fwd | revcomp | slack] over the mesh.

    Same layout as pipeline/cns.device_volume, but the upload is 2-bit
    packed and the unpack+concat runs jit-ted with a replicated output
    sharding, so it works identically single- and multi-controller.
    """
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    n = len(db.codes)
    slack = int(3 * int(db.lengths.max()) + 1024) if db.n_reads else 1024
    m = -(-max(n, 1) // 4) * 4
    buf = db.codes
    if m != n:
        buf = np.zeros(m, dtype=np.uint8)
        buf[:n] = db.codes
    packed = jax.device_put(pack_2bit(buf), rep)

    @partial(jax.jit, static_argnames=("n", "slack"), out_shardings=rep)
    def build(p, n: int, slack: int):
        quads = jnp.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                          axis=1)
        vol = quads.reshape(-1)[:n]
        return jnp.concatenate(
            [vol, (3 - vol[::-1].astype(jnp.int32)).astype(vol.dtype),
             jnp.zeros((slack,), dtype=vol.dtype)])

    vol_cat = build(packed, n=n, slack=slack)
    starts = jax.device_put(db.starts.astype(np.int32), rep)
    lengths = jax.device_put(db.lengths, rep)
    return vol_cat, starts, lengths, n


def _sharded_chunk(mesh, **statics):
    """shard_map-wrapped cns chunk: counts/pairs sharded over 'data'."""
    import jax
    from jax.sharding import PartitionSpec as P

    key = (id(mesh),) + tuple(sorted(statics.items()))
    fn = _CHUNK_CACHE.get(key)
    if fn is None:
        chunk = make_cns_chunk(**statics)
        mapped = jax.shard_map(
            chunk, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"),      # tables
                      P(), P(), P(), P(),                   # volume
                      P("data"), P("data"), P("data"), P("data"),  # pairs
                      P("data"), P("data"), P("data"), P("data"),
                      P("data")),
            out_specs=(P("data"), P("data"), P("data")),
            check_vma=False)
        fn = jax.jit(mapped, donate_argnums=(0, 1, 2))
        _CHUNK_CACHE[key] = fn
    return fn


def _sharded_call(mesh, L_t: int, draft_mode: bool = False, vote=None):
    """shard_map-wrapped vote: gather template rows + call_tables locally."""
    import jax
    from jax.sharding import PartitionSpec as P
    from ..ops.consensus_device import call_tables

    key = (id(mesh), L_t, draft_mode, vote)
    fn = _CALL_CACHE.get(key)
    if fn is None:
        def call(counts, cov_diff, vol_cat, starts, lengths, tmpl_ids,
                 tlen, has, min_cov):
            tmpl = _gather_rows_dev(vol_cat, starts, lengths, tmpl_ids, L_t)
            return call_tables(counts, cov_diff, tmpl, tlen, has, min_cov,
                               draft_mode=draft_mode, vote=vote)

        mapped = jax.shard_map(
            call, mesh=mesh,
            in_specs=(P("data"), P("data"), P(), P(), P(),
                      P("data"), P("data"), P("data"), P()),
            out_specs=(P("data"), P("data")),
            check_vma=False)
        fn = jax.jit(mapped)
        _CALL_CACHE[key] = fn
    return fn


def _zeros_sharded(mesh, shape, dtype):
    """Create a 'data'-sharded zero buffer directly on the devices."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = (id(mesh), shape, np.dtype(dtype).name)
    fn = _ZEROS_CACHE.get(key)
    if fn is None:
        sh = NamedSharding(mesh, P("data"))
        fn = jax.jit(partial(jnp.zeros, shape, dtype), out_shardings=sh)
        _ZEROS_CACHE[key] = fn
    return fn()


def _iter_addressable_rows(arrs):
    """Yield (row0, [np blocks]) for this process's addressable row shards
    of 'data'-sharded arrays (deduped by row start)."""
    ref = arrs[0]
    if not hasattr(ref, "addressable_shards"):
        yield 0, [np.asarray(a) for a in arrs]
        return
    seen = set()
    for i, sh in enumerate(ref.addressable_shards):
        r0 = sh.index[0].start or 0
        if r0 in seen:
            continue
        seen.add(r0)
        yield r0, [np.asarray(a.addressable_shards[i].data) for a in arrs]


def append_device_volume_mesh(dev_vol, tail_db: PackedDB, n_old_reads: int,
                              mesh):
    """Mesh twin of pipeline/cns.append_device_volume: extend the
    REPLICATED volume with the appended drafts (2-bit-packed upload,
    jit-ted unpack+concat with a replicated output sharding, so it is
    identical single- and multi-controller)."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    vol_cat, starts_d, lengths_d, n_bases = dev_vol[:4]
    tail_start = int(tail_db.starts[n_old_reads])
    tail_codes = tail_db.codes[tail_start:]
    tail_lengths = tail_db.lengths[n_old_reads:]
    n = len(tail_codes)
    m = -(-max(n, 1) // 4) * 4
    buf = tail_codes
    if m != n:
        buf = np.zeros(m, dtype=np.uint8)
        buf[:n] = tail_codes
    packed = jax.device_put(pack_2bit(buf), rep)
    base = int(vol_cat.shape[0])
    slack = int(3 * int(tail_lengths.max()) + 1024)

    @partial(jax.jit, static_argnames=("n", "slack"), out_shardings=rep)
    def extend(vol, p, n: int, slack: int):
        quads = jnp.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                          axis=1)
        tail = quads.reshape(-1)[:n].astype(vol.dtype)
        return jnp.concatenate(
            [vol, tail, jnp.zeros((slack,), dtype=vol.dtype)])

    vol2 = extend(vol_cat, packed, n=n, slack=slack)
    starts2 = jax.device_put(
        np.concatenate([np.asarray(starts_d),
                        (base + (tail_db.starts[n_old_reads:] - tail_start)
                         ).astype(np.int32)]), rep)
    lengths2 = jax.device_put(
        np.concatenate([np.asarray(lengths_d), tail_lengths]), rep)
    return vol2, starts2, lengths2, n_bases


def correct_slice_sharded(mesh, db: PackedDB, templates: List[int],
                          by_template, opts: CnsOptions, stats: CnsStats,
                          dev_vol):
    """One table slice, template-sharded over the mesh (a GENERATOR).

    Yields (name, segment) records for THIS process's addressable template
    rows only — the caller writes them to its per-host shard file.

    opts.rounds > 1 runs the iterative-correction draft passes first
    (pipeline/cns.CnsOptions.rounds): each non-final pass votes in
    draft_mode, REPLICATES the emit arrays over the mesh (an all-gather of
    a few MB) so every process derives the identical drafts, appends them
    to its local PackedDB copy + the replicated device volume, and remaps
    seeds — then the final pass proceeds exactly as a single round.
    """
    from ..ops.consensus import emit_to_draft
    from ..pipeline.cns import append_drafts

    rounds = max(1, int(getattr(opts, "rounds", 1)))
    cur_db, cur_ids, cur_by, cur_vol = db, list(templates), by_template, \
        dev_vol
    for _ in range(rounds - 1):
        scratch = CnsStats()
        emit, cov_ok, has = _slice_tables(mesh, cur_db, cur_ids, cur_by,
                                          opts, scratch, cur_vol,
                                          draft_mode=True, replicate=True)
        stats.supports_aligned += scratch.supports_aligned
        emit_h = np.asarray(emit)
        has_h = np.asarray(has)
        drafts = {}
        for i, t in enumerate(cur_ids):
            if not bool(has_h[i]):
                continue
            tl = int(cur_db.lengths[t])
            drafts[t] = emit_to_draft(emit_h[i][:tl])
        if not drafts:
            break
        cur_db, cur_ids, cur_by, n_old = append_drafts(
            cur_db, cur_ids, cur_by, drafts)
        cur_vol = append_device_volume_mesh(cur_vol, cur_db, n_old, mesh)

    emit, cov_ok, has = _slice_tables(mesh, cur_db, cur_ids, cur_by, opts,
                                      stats, cur_vol)

    from ..ops.consensus_device import split_called

    for r0, (emit_b, cov_b, has_b) in _iter_addressable_rows(
            [emit, cov_ok, has]):
        for i in range(emit_b.shape[0]):
            row = r0 + i
            if row >= len(cur_ids):
                continue
            t = cur_ids[row]
            stats.templates += 1
            if not bool(has_b[i]):
                continue
            segs = split_called(emit_b[i], cov_b[i], int(cur_db.lengths[t]),
                                opts.min_length)
            for k, seg in enumerate(segs):
                stats.corrected_reads += 1
                stats.corrected_bases += len(seg)
                yield (f"{cur_db.name(t)}_{k}", seg)


def _slice_tables(mesh, db: PackedDB, templates: List[int],
                  by_template, opts: CnsOptions, stats: CnsStats,
                  dev_vol, draft_mode: bool = False,
                  replicate: bool = False):
    """Fold one slice's support chunks and vote, template-sharded.

    Returns (emit int8 [T_pad, L_t, k+1], cov_ok, has) — sharded over
    'data', or fully replicated when ``replicate=True`` (draft passes: the
    host-side draft derivation must be identical on every process).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_data = mesh.shape["data"]
    vol_cat, starts_d, lengths_d, n_bases = dev_vol[:4]
    T = len(templates)
    T_loc = -(-T // n_data)
    T_pad = T_loc * n_data
    L_t = bucket_length(max(int(db.lengths[t]) for t in templates),
                        pow2=True)
    L_s = bucket_length(min(int(db.lengths.max()), 3 * L_t), pow2=True)
    S, W = opts.align_segment, opts.align_band
    msegs = max_segs_for(min(max(L_t, L_s), int(1.4 * L_t) + 2 * S), S)
    P_b = opts.extend_batch
    D1 = C.MAX_INS_DELTA + 1
    sh_pairs = NamedSharding(mesh, P("data"))

    plan = plan_pairs(db, templates, by_template, opts, L_t, msegs)
    counts = _zeros_sharded(mesh, (T_pad, L_t, D1, 5), np.int32)
    cov_diff = _zeros_sharded(mesh, (T_pad, L_t + 1), np.int32)
    has = _zeros_sharded(mesh, (T_pad,), bool)

    if plan is not None:
        # route each pair to its owning device (local slot = slot % T_loc),
        # preserving the budget sort within each device's list
        owner = plan["slot"] // T_loc
        idx_by_dev = [np.nonzero(owner == d)[0] for d in range(n_data)]
        rounds = max(-(-len(ix) // P_b) for ix in idx_by_dev) \
            if any(len(ix) for ix in idx_by_dev) else 0
        pairs_a = plan["pairs"]
        for r in range(rounds):
            cols = {k: np.zeros(n_data * P_b, np.int32)
                    for k in ("s", "t", "qlen", "tlen", "qs", "ts",
                              "slot", "dir")}
            real = np.zeros(n_data * P_b, dtype=bool)
            used = []
            for d, ix in enumerate(idx_by_dev):
                part = ix[r * P_b:(r + 1) * P_b]
                if len(part) == 0:
                    continue
                used.append(part)
                dst = slice(d * P_b, d * P_b + len(part))
                cols["s"][dst] = pairs_a[part, 1]
                cols["t"][dst] = pairs_a[part, 0]
                cols["dir"][dst] = pairs_a[part, 2]
                cols["qlen"][dst] = plan["qlen"][part]
                cols["tlen"][dst] = plan["tlen"][part]
                cols["qs"][dst] = plan["qs"][part]
                cols["ts"][dst] = plan["ts"][part]
                cols["slot"][dst] = plan["slot"][part] % T_loc
                real[dst] = True
            used_all = np.concatenate(used)
            msegs_r = seg_bucket(int(plan["segs_r"][used_all].max()), msegs)
            msegs_l = seg_bucket(int(plan["segs_l"][used_all].max()), msegs)
            step = _sharded_chunk(
                mesh, L_s=L_s, L_t=L_t, S=S, W=W, max_segs=msegs_r,
                max_segs_left=msegs_l, min_identity=opts.min_identity,
                min_align_size=opts.min_align_size,
                min_mapping_ratio=opts.min_mapping_ratio,
                tags=os.environ.get("MECAT_CNS_TAGS", "banded"))

            def put(x):
                return jax.device_put(x, sh_pairs)

            counts, cov_diff, has = step(
                counts, cov_diff, has, vol_cat, starts_d, lengths_d,
                np.int32(n_bases), put(cols["s"]), put(cols["t"]),
                put(cols["qlen"]), put(cols["tlen"]), put(cols["qs"]),
                put(cols["ts"]), put(cols["slot"]), put(cols["dir"]),
                put(real))
            stats.supports_aligned += len(used_all)

    tmpl_ids = np.zeros(T_pad, np.int32)
    tmpl_ids[:T] = np.asarray(templates, dtype=np.int32)
    tmpl_len = np.zeros(T_pad, np.int32)
    tmpl_len[:T] = np.minimum(db.lengths[np.asarray(templates)], L_t)
    call = _sharded_call(mesh, L_t, draft_mode=draft_mode,
                         vote=opts.vote_params())
    emit, cov_ok = call(counts, cov_diff, vol_cat, starts_d, lengths_d,
                        jax.device_put(tmpl_ids, sh_pairs),
                        jax.device_put(tmpl_len, sh_pairs), has,
                        jnp.int32(opts.min_coverage))
    # truncate the delta axis to the deepest used insertion slot before the
    # pull (prefix rule: dropped slots are all -1) — same as single-device
    max_ins = int(jax.jit(lambda e: jnp.max(jnp.sum(
        (e[:, :, 1:] >= 0).astype(jnp.int32), axis=2)))(emit))
    emit = emit[:, :, :max_ins + 1].astype(jnp.int8)
    if replicate:
        rep = NamedSharding(mesh, P())
        gather = jax.jit(lambda *xs: xs, out_shardings=(rep, rep, rep))
        emit, cov_ok, has = gather(emit, cov_ok, has)
    return emit, cov_ok, has


def run_cns_dist(input_path: str, reads_path: str, out_path: str,
                 wrk_dir: str, opts: Optional[CnsOptions] = None,
                 n_data: Optional[int] = None,
                 db: Optional[PackedDB] = None) -> CnsStats:
    """Mesh-sharded mecat2cns run → merged corrected FASTA.

    Multi-controller contract (same as run_pw_dist): every process runs this
    same function on identical inputs; each process writes only the
    corrected reads of its addressable template shards to
    ``<wrk>/cns_shard_p{pidx}.fasta``; rank 0 concatenates after a barrier.
    Record content is bit-for-bit equal to single-device run_cns per
    template (record order differs: slices are interleaved across shards).
    """
    import jax

    opts = opts or CnsOptions()
    os.makedirs(wrk_dir, exist_ok=True)
    t0 = time.time()
    pidx, pcount = init_distributed()
    mesh = make_cns_mesh(n_data)
    if db is None:
        db = PackedDB.from_fasta(reads_path)
    stats = CnsStats()
    by_template = load_supports(input_path, db, opts.input_type)
    templates = sorted(by_template)
    dev_vol = device_volume_mesh(db, mesh)
    log.info("dist cns: %d reads, %d templates, mesh data=%d, process %d/%d",
             db.n_reads, len(templates), mesh.shape["data"], pidx, pcount)

    shard_path = os.path.join(wrk_dir, f"cns_shard_p{pidx}.fasta")
    with open(shard_path, "wb") as fh:
        for ofs in range(0, len(templates), opts.partition_size):
            batch = templates[ofs:ofs + opts.partition_size]
            for sl in plan_table_slices(db, batch):
                for name, seg in correct_slice_sharded(
                        mesh, db, sl, by_template, opts, stats, dev_vol):
                    fh.write(format_fasta(name, seg))
            log.info("dist cns: %d/%d templates, %d corrected (local)",
                     min(ofs + opts.partition_size, len(templates)),
                     len(templates), stats.corrected_reads)

    if pcount > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("cns_dist_shards")
    if pidx == 0:
        with open(out_path, "wb") as out:
            for p in range(pcount):
                sp = os.path.join(wrk_dir, f"cns_shard_p{p}.fasta")
                if not os.path.exists(sp):
                    raise FileNotFoundError(
                        f"missing cns shard {sp}: multi-host merge requires "
                        f"a shared filesystem (reference data plane)")
                with open(sp, "rb") as fh:
                    out.write(fh.read())
    stats.seconds = time.time() - t0
    return stats
