"""PackedDB: 2-bit packed read database with volume sharding.

Device-first counterpart of the reference data layer (SURVEY.md §2.1 component 1,
reference ``src/common/packed_db.*`` + ``split_database.*`` — unverified,
mount empty).  Design differences from the reference, on purpose:

* The canonical in-memory form is a single flat ``uint8`` code array
  (one base per byte, values 0..3) plus int64 ``starts`` / int32 ``lengths``
  tables — this is exactly the layout the device kernels consume, so a volume
  uploads to HBM with one transfer and zero host-side unpack loops.
* The on-disk form is 2-bit packed (4 bases/byte, A=0 C=1 G=2 T=3, base i of
  the stream in bits ``2*(i%4)`` of byte ``i//4``) with a ``.npz`` index —
  same information content as the reference's volume files.
* Volume splitting returns index ranges over a deterministic read ordering
  (input order), mirroring ``split_raw_dataset``'s contract that read ids are
  assigned by input order.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from functools import partial
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .. import constants as C
from .fasta import FastaRecord, iter_fasta

_REVCOMP = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G in 2-bit codes


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a uint8 code array."""
    return _REVCOMP[codes][::-1]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes {0..3} → 2-bit packed bytes (4 bases/byte, LSB-first)."""
    codes = np.asarray(codes, dtype=np.uint8)
    from ..native import get as _native
    lib = _native()
    if lib is not None:
        return lib.pack_2bit(codes)
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4)
    return (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
            | (quads[:, 3] << 6)).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, n_bases: int) -> np.ndarray:
    """2-bit packed bytes → uint8 codes {0..3} of length n_bases."""
    packed = np.asarray(packed, dtype=np.uint8)
    from ..native import get as _native
    lib = _native()
    if lib is not None:
        return lib.unpack_2bit(packed, n_bases)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    out[:, 0] = packed & 3
    out[:, 1] = (packed >> 2) & 3
    out[:, 2] = (packed >> 4) & 3
    out[:, 3] = (packed >> 6) & 3
    return out.reshape(-1)[:n_bases]


def upload_codes(codes: np.ndarray, n_pad: int = 0):
    """Host→device transfer of base codes, 2-bit packed over the wire.

    Packing 4 bases/byte on the host (native C++ when available) cuts the
    host→device bytes of the flat uint8 code array 4x; the device unpacks
    with three shifts.
    Returns a device uint8 [max(len, n_pad)] array equal to ``codes``
    zero-padded to n_pad.
    """
    import jax
    import jax.numpy as jnp

    n = len(codes)
    n_out = max(n, n_pad)
    m = -(-n_out // 4) * 4
    buf = codes
    if m != n:
        buf = np.zeros(m, dtype=np.uint8)
        buf[:n] = codes
    packed_dev = jnp.asarray(pack_2bit(buf))

    @partial(jax.jit, static_argnames=("n_out",))
    def unpack(p, n_out: int):
        quads = jnp.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                          axis=1)
        return quads.reshape(-1)[:n_out]

    return unpack(packed_dev, n_out=n_out)


@dataclass
class PackedDB:
    """Flat read database: all reads concatenated as uint8 codes."""

    codes: np.ndarray                 # uint8 [total_bases], values 0..3
    starts: np.ndarray                # int64 [n_reads] start offset of each read
    lengths: np.ndarray               # int32 [n_reads]
    names: List[str] = field(default_factory=list)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_records(cls, records: Iterable[FastaRecord]) -> "PackedDB":
        names: List[str] = []
        chunks: List[np.ndarray] = []
        lengths: List[int] = []
        for rec in records:
            names.append(rec.name)
            chunks.append(np.asarray(rec.codes, dtype=np.uint8))
            lengths.append(len(rec.codes))
        lengths_a = np.asarray(lengths, dtype=np.int32)
        starts = np.zeros(len(lengths), dtype=np.int64)
        if len(lengths):
            np.cumsum(lengths_a[:-1], out=starts[1:])
        codes = (np.concatenate(chunks) if chunks
                 else np.zeros(0, dtype=np.uint8))
        return cls(codes=codes, starts=starts, lengths=lengths_a, names=names)

    @classmethod
    def from_fasta(cls, path: str) -> "PackedDB":
        from ..native import get as _native
        lib = _native()
        if lib is not None and not str(path).endswith(".gz"):
            p = lib.parse_path(str(path))
            return cls(codes=p.codes, starts=p.starts, lengths=p.lengths,
                       names=p.names)
        return cls.from_records(iter_fasta(path))

    # -- accessors -----------------------------------------------------------
    @property
    def n_reads(self) -> int:
        return len(self.lengths)

    @property
    def total_bases(self) -> int:
        return int(self.codes.shape[0])

    def read(self, i: int) -> np.ndarray:
        s = int(self.starts[i])
        return self.codes[s:s + int(self.lengths[i])]

    def name(self, i: int) -> str:
        return self.names[i] if self.names else str(i)

    def append(self, records: Iterable[FastaRecord]) -> "PackedDB":
        """New PackedDB with `records` appended after the existing reads.

        Existing read ids keep their offsets (a device volume built from
        the old db stays valid as a prefix); appended read i gets id
        n_reads + i.  Used by iterative correction (cns rounds > 1) to add
        pass-k drafts as template reads without touching support ids.
        """
        recs = list(records)
        if not recs:
            return self
        tail_lengths = np.asarray([len(r.codes) for r in recs],
                                  dtype=np.int32)
        tail_starts = (self.total_bases
                       + np.concatenate([[0], np.cumsum(
                           tail_lengths[:-1], dtype=np.int64)]))
        codes = np.concatenate(
            [self.codes] + [np.asarray(r.codes, dtype=np.uint8)
                            for r in recs])
        names = ((list(self.names) if self.names
                  else [str(i) for i in range(self.n_reads)])
                 + [r.name for r in recs])
        return PackedDB(codes=codes,
                        starts=np.concatenate([self.starts, tail_starts]),
                        lengths=np.concatenate([self.lengths, tail_lengths]),
                        names=names)

    def subset(self, idx: Sequence[int]) -> "PackedDB":
        idx = np.asarray(idx, dtype=np.int64)
        chunks = [self.read(int(i)) for i in idx]
        lengths = self.lengths[idx].astype(np.int32)
        starts = np.zeros(len(idx), dtype=np.int64)
        if len(idx):
            np.cumsum(lengths[:-1].astype(np.int64), out=starts[1:])
        names = [self.name(int(i)) for i in idx]
        codes = (np.concatenate(chunks) if chunks
                 else np.zeros(0, dtype=np.uint8))
        return PackedDB(codes, starts, lengths, names)

    # -- volume splitting (split_raw_dataset counterpart) --------------------
    def split_volumes(self, max_bases: int = C.DEFAULT_VOLUME_BASES
                      ) -> List[Tuple[int, int]]:
        """Split reads (in id order) into volumes of <= max_bases.

        Returns [(read_id_begin, read_id_end), ...).  A single read longer
        than max_bases still gets its own volume.
        """
        vols: List[Tuple[int, int]] = []
        begin, acc = 0, 0
        for i, ln in enumerate(self.lengths):
            if acc and acc + int(ln) > max_bases:
                vols.append((begin, i))
                begin, acc = i, 0
            acc += int(ln)
        if begin < self.n_reads or not vols:
            vols.append((begin, self.n_reads))
        return vols

    # -- persistence (2-bit packed volume files) -----------------------------
    def save(self, prefix: str) -> None:
        np.save(prefix + ".pac.npy", pack_2bit(self.codes))
        np.savez(prefix + ".idx.npz", starts=self.starts, lengths=self.lengths,
                 total_bases=np.int64(self.total_bases))
        with open(prefix + ".names.json", "w") as fh:
            json.dump(self.names, fh)

    @classmethod
    def load(cls, prefix: str) -> "PackedDB":
        packed = np.load(prefix + ".pac.npy")
        idx = np.load(prefix + ".idx.npz")
        codes = unpack_2bit(packed, int(idx["total_bases"]))
        names: List[str] = []
        if os.path.exists(prefix + ".names.json"):
            with open(prefix + ".names.json") as fh:
                names = json.load(fh)
        return cls(codes=codes, starts=idx["starts"].astype(np.int64),
                   lengths=idx["lengths"].astype(np.int32), names=names)

    # -- device batching helpers ---------------------------------------------
    def padded_batch(self, read_ids: Sequence[int], pad_to: int | None = None,
                     multiple: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        """Gather reads into a dense [B, L] uint8 array (padded with 0).

        Returns (bases[B, L], lengths[B]).  L is max length rounded up to
        ``multiple`` (or ``pad_to`` if given).
        """
        read_ids = np.asarray(read_ids, dtype=np.int64)
        lens = self.lengths[read_ids].astype(np.int32)
        maxlen = int(lens.max()) if len(lens) else multiple
        L = pad_to if pad_to is not None else -(-maxlen // multiple) * multiple
        from ..native import get as _native
        lib = _native()
        if lib is not None:
            return lib.padded_batch(self.codes, self.starts, self.lengths,
                                    read_ids, L)
        out = np.zeros((len(read_ids), L), dtype=np.uint8)
        for row, rid in enumerate(read_ids):
            r = self.read(int(rid))[:L]
            out[row, :len(r)] = r
        return out, np.minimum(lens, L)
