"""Distributed overlap pipeline: mesh-sharded mecat2pw with per-host shards.

The multi-host restatement of the reference's grid scale-out (SURVEY.md §2.3,
§2.4; BASELINE config 5 shape): every process runs this same driver under
``jax.distributed``; queries are data-parallel over the ``data`` mesh axis,
the k-mer index is sharded by hash range over ``hash``, hits ride an
``all_to_all`` between devices (parallel/sharded.py), and every HOST writes only the
M4 records of its addressable query slices to its own shard file.  Overlap
COMPUTE rides collectives; the final merge (rank 0) concatenates the shard
files, mirroring the reference's per-volume-output concatenation — this step
(and only this step) requires a shared filesystem, which the merge verifies
explicitly.

The compute path is the same two-phase probe→prune→extend pipeline as the
single-chip fused driver (pipeline/device_step.py), restated over the mesh
(sharded_probe_step / sharded_extend_step), with the batch plan, survivor
filter, emit columns, and dedup tie-break all SHARED with pipeline/pw.py —
so a distributed run's record set equals the single-chip fused run's exactly
(tests/test_dist.py asserts full-record equality).

Single-host this degrades gracefully: one process, all local devices, one
shard, same code path (tests run it on the virtual 8-device CPU mesh).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.packed_db import PackedDB
from ..index.kmer_index import build_index
from ..pipeline.common import (bucket_length, max_segs_for, oriented_batch,
                               pad_to_batch)
from ..pipeline.pw import (PwOptions, PwStats, _bucket_k, append_m4_columns,
                           default_volume_bases, finalize_m4_text,
                           new_m4_cols, plan_fused_batches)
from ..utils.log import get_logger
from .sharded import (make_mesh, place_sharded_inputs, shard_index_by_hash,
                      sharded_extend_step, sharded_probe_step)

log = get_logger("dist")


def init_distributed() -> Tuple[int, int]:
    """Initialise jax.distributed from env when configured.

    Returns (process_index, process_count).  With no coordinator configured
    (single-host run) this is (0, 1) and no init happens.  Each process
    opens only its own card (``local_device_ids=[process_id]``, the
    one-process-per-card layout of one host) unless JAX_LOCAL_DEVICE_IDS
    names the cards; a process that opened every card would reserve memory
    on all of them.
    """
    import jax

    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        from jax._src import distributed as _dist

        if _dist.global_state.client is None:  # not yet initialised
            pid = int(os.environ["JAX_PROCESS_ID"])
            local = (None if os.environ.get("JAX_LOCAL_DEVICE_IDS")
                     else [pid])
            jax.distributed.initialize(
                coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
                num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
                process_id=pid, local_device_ids=local)
    return jax.process_index(), jax.process_count()


_step_cache: dict = {}


def _cached(factory, mesh, **params):
    """Reuse jitted sharded steps across batches/volume pairs with equal
    static params (the factories build a fresh jit wrapper per call)."""
    key = (factory.__name__, id(mesh)) + tuple(sorted(params.items()))
    if key not in _step_cache:
        _step_cache[key] = factory(mesh, **params)
    return _step_cache[key]


def _addressable_blocks(arr) -> Dict[int, np.ndarray]:
    """{global_start_row: local block} for THIS process's shards of a flat
    array sharded over ('data', 'hash').

    Multi-controller contract: a process must only read shards resident on
    its own devices — np.asarray on the global array would require
    non-addressable data."""
    out: Dict[int, np.ndarray] = {}
    for sh in arr.addressable_shards:
        start = sh.index[0].start or 0
        if start not in out:
            out[start] = np.asarray(sh.data)
    return out


def _global_max(local: int, pcount: int) -> int:
    """Max of a host scalar across processes (all processes must call)."""
    if pcount <= 1:
        return local
    from jax.experimental import multihost_utils

    return int(np.max(multihost_utils.process_allgather(
        np.asarray(local, np.int32))))


def _place_local_sel(mesh, sel_by_dev: Dict[int, np.ndarray], K: int,
                     n_dev: int):
    """Build the global [n_dev*K] sel array from per-device local blocks.

    Each process supplies only its addressable devices' blocks
    (jax.make_array_from_single_device_arrays) — no process ever needs
    another host's survivor lists."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(("data", "hash")))
    shape = (n_dev * K,)
    pieces = []
    for dev, index in sharding.addressable_devices_indices_map(shape).items():
        start = index[0].start or 0
        d = start // K
        sel_pad = np.zeros(K, np.int32)
        sel = sel_by_dev.get(d)
        if sel is not None and len(sel):
            sel_pad[:len(sel)] = sel
        pieces.append(jax.device_put(sel_pad, dev))
    return jax.make_array_from_single_device_arrays(shape, sharding, pieces)


def run_pw_dist(reads_path: str, out_path: str, wrk_dir: str,
                opts: Optional[PwOptions] = None,
                n_data: Optional[int] = None, n_hash: int = 2,
                db: Optional[PackedDB] = None) -> PwStats:
    """Mesh-sharded all-vs-all overlap run → merged M4 file.

    Record-for-record equal to the single-chip fused ``run_pw`` (modulo file
    ordering, which interleaves differently across shard files): the batch
    plan (plan_fused_batches), probe/extend kernels, survivor filter, and
    span-max dedup tie-break are all the same code.  tests/test_dist.py
    asserts exact full-record equality on the merged output.

    Multi-controller: every process runs this same function; inputs are
    device_put with identical host data on all processes, each process pulls
    only its addressable probe/extension shards, writes its own shard file,
    and rank 0 concatenates after a barrier.  Exercised for real by
    tests/test_dist.py::test_dist_pw_two_processes (2 processes x 4 virtual
    CPU devices over a localhost coordinator).
    """
    import jax

    opts = opts or PwOptions(task=1)
    os.makedirs(wrk_dir, exist_ok=True)
    pidx, pcount = init_distributed()
    devs = jax.devices()
    if n_data is None:
        n_data = max(1, len(devs) // n_hash)
    mesh = make_mesh(n_data=n_data, n_hash=n_hash)
    n_dev = n_data * n_hash
    N = opts.num_candidates
    S, W = opts.align_segment, opts.align_band
    if db is None:
        db = PackedDB.from_fasta(reads_path)
    stats = PwStats(reads=db.n_reads)
    vols = db.split_volumes(opts.volume_bases or default_volume_bases())
    log.info("dist pw: %d reads, mesh data=%d hash=%d, %d volume(s), "
             "process %d/%d", db.n_reads, n_data, n_hash, len(vols),
             pidx, pcount)

    import time as _time
    t0 = _time.time()
    shard_path = os.path.join(wrk_dir, f"pw_shard_p{pidx}.m4")
    fh = open(shard_path + ".tmp", "w")
    for vi, (va, vb) in enumerate(vols):
        vol_db = db.subset(range(va, vb))
        idx = build_index(vol_db.codes, vol_db.starts, vol_db.lengths,
                          k=opts.kmer_size,
                          freq_cutoff_abs=opts.index_cutoff)
        off_sh, rid_sh, loc_sh, lo = shard_index_by_hash(idx, n_hash)
        vol_max = int(vol_db.lengths.max())
        for vj in range(vi, len(vols)):
            qa, qb = vols[vj]
            for qids, b_eff, L_q, L_t in plan_fused_batches(
                    db, qa, qb, vol_max, opts):
                n_rows = len(qids)
                B_pad = -(-max(b_eff, n_rows) // n_dev) * n_dev
                Bh = B_pad // n_dev
                fwd, rev, lens = oriented_batch(db, qids, L_q)
                fwd_p, rev_p, lens_p = pad_to_batch([fwd, rev, lens], B_pad)
                lens_p = lens_p.copy()
                lens_p[n_rows:] = 0
                qids_pad = np.zeros(B_pad, np.int64)
                qids_pad[:n_rows] = qids
                self_ids = np.where(
                    (qids_pad >= va) & (qids_pad < vb),
                    qids_pad - va, -1).astype(np.int32)
                self_ids[n_rows:] = -1
                msegs = max_segs_for(max(L_q, L_t), S)
                probe = _cached(
                    sharded_probe_step, mesh, k=opts.kmer_size,
                    stride=opts.scan_stride, max_occ=opts.max_occ,
                    num_candidates=N, diag_bin=opts.diag_bin, L_target=L_t,
                    S=S, W=W, min_block_score=opts.min_block_score)
                cols = new_m4_cols()
                for strand, oriented in ((0, fwd_p), (1, rev_p)):
                    args = place_sharded_inputs(
                        mesh, oriented, lens_p, self_ids, vol_db.codes,
                        off_sh, rid_sh, loc_sh, lo, idx.read_starts,
                        idx.read_lengths, np.int32(idx.max_occ_cutoff))
                    tgt_f, score_f, qseed_f, tseed_f, surv_f = probe(*args)

                    # survivor selection per addressable device block (the
                    # survive pull is the only host sync: ~Bh*N bools/device)
                    blocks: Dict[int, dict] = {}
                    tgt_b = _addressable_blocks(tgt_f)
                    score_b = _addressable_blocks(score_f)
                    qseed_b = _addressable_blocks(qseed_f)
                    tseed_b = _addressable_blocks(tseed_f)
                    local_max = 0
                    for start, surv in _addressable_blocks(surv_f).items():
                        d = start // (Bh * N)
                        sel = np.flatnonzero(surv).astype(np.int32)
                        sel = sel[(start + sel) // N < n_rows]
                        if not len(sel):
                            continue
                        blocks[d] = dict(
                            sel=sel, tgt=tgt_b[start][sel],
                            score=score_b[start][sel],
                            qseed=qseed_b[start][sel],
                            tseed=tseed_b[start][sel])
                        local_max = max(local_max, len(sel))
                    gmax = _global_max(local_max, pcount)
                    if gmax == 0:
                        continue
                    K = _bucket_k(gmax)
                    sel_arr = _place_local_sel(
                        mesh, {d: b["sel"] for d, b in blocks.items()},
                        K, n_dev)
                    ext = _cached(
                        sharded_extend_step, mesh, K=K, N=N, L_target=L_t,
                        S=S, W=W, max_segs=msegs)
                    ident_f, qbeg_f, qend_f, tbeg_f, tend_f, win0_f = ext(
                        args[0], args[1], args[3], args[8], args[9],
                        tgt_f, qseed_f, tseed_f, sel_arr)

                    ident_b = _addressable_blocks(ident_f)
                    qbeg_b = _addressable_blocks(qbeg_f)
                    qend_b = _addressable_blocks(qend_f)
                    tbeg_b = _addressable_blocks(tbeg_f)
                    tend_b = _addressable_blocks(tend_f)
                    win0_b = _addressable_blocks(win0_f)
                    for start in sorted(ident_b):
                        d = start // K
                        blk = blocks.get(d)
                        if blk is None:
                            continue
                        m = len(blk["sel"])
                        rows = d * Bh + blk["sel"] // N
                        w0 = win0_b[start][:m]
                        stats.candidates += m
                        stats.extended += m
                        append_m4_columns(
                            cols, opts, strand=strand, vol_base=va,
                            qids=qids_pad[rows], qsize=lens_p[rows],
                            tgt=blk["tgt"], tlens=vol_db.lengths,
                            ident=ident_b[start][:m],
                            score=blk["score"],
                            qbeg=qbeg_b[start][:m], qend=qend_b[start][:m],
                            tbeg=tbeg_b[start][:m] + w0,
                            tend=tend_b[start][:m] + w0,
                            qseed=blk["qseed"], tseed=blk["tseed"])
                fh.write(finalize_m4_text(cols, opts, stats))
            log.info("dist pw: volume %d vs %d done (%d overlaps so far)",
                     vi, vj, stats.overlaps)
    fh.close()
    os.replace(shard_path + ".tmp", shard_path)

    # deterministic merge on rank 0 (shared-filesystem output contract)
    if pcount > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("pw_dist_shards")
    if pidx == 0:
        with open(out_path, "wb") as out:
            for p in range(pcount):
                sp = os.path.join(wrk_dir, f"pw_shard_p{p}.m4")
                # the merge is the one shared-filesystem dependency: fail
                # loudly instead of silently truncating the merged M4 when
                # ranks don't share wrk_dir (e.g. multi-host without NFS)
                if not os.path.exists(sp):
                    raise FileNotFoundError(
                        f"rank 0 cannot see shard file {sp}: wrk_dir must "
                        "be on a filesystem shared by all processes for "
                        "the merge step (per-rank output is complete in "
                        "each rank's own shard file)")
                with open(sp, "rb") as shf:
                    out.write(shf.read())
    stats.seconds = _time.time() - t0
    return stats
