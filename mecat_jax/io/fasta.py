"""Streaming FASTA/FASTQ readers and writers.

Device-first counterpart of the reference data layer's FastaReader /
BufferLineIterator (SURVEY.md §2.1 component 1; reference files
``src/common/fasta_reader.*`` — unverified, mount empty).  We parse on the
host with NumPy vectorised byte ops rather than per-character C++ loops: the
output of this layer is flat ``uint8`` code arrays ready for 2-bit packing and
device upload, so parsing is a bulk byte transform, not an object stream.
"""
from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..constants import INVALID_BASE_CODE

# char → 2-bit code lookup (A=0 C=1 G=2 T=3, case-insensitive, else INVALID)
_CODE_LUT = np.full(256, INVALID_BASE_CODE, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_LUT[ord(_c)] = _v
    _CODE_LUT[ord(_c.lower())] = _v

_DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII bases → uint8 codes in {0..3} (non-ACGT → INVALID_BASE_CODE)."""
    if isinstance(seq, (bytes, bytearray, memoryview)):
        seq = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[seq]


def decode_bases(codes: np.ndarray) -> bytes:
    """uint8 codes in {0..3} → ASCII bytes."""
    return _DECODE_LUT[codes].tobytes()


@dataclass
class FastaRecord:
    name: str
    codes: np.ndarray  # uint8 in {0..3}


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[FastaRecord]:
    """Stream records from FASTA or FASTQ (auto-detected on first byte)."""
    with _open(path) as fh:
        first = fh.peek(1)[:1] if hasattr(fh, "peek") else fh.read(1)
        if not hasattr(fh, "peek"):  # pragma: no cover - gzip has peek
            fh.seek(0)
        if first == b">":
            yield from _iter_fasta_fh(fh)
        elif first == b"@":
            yield from _iter_fastq_fh(fh)
        elif first == b"":
            return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (first byte {first!r})")


def _iter_fasta_fh(fh) -> Iterator[FastaRecord]:
    name = None
    chunks: List[bytes] = []
    for raw in fh:
        line = raw.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                yield FastaRecord(name, encode_bases(b"".join(chunks)))
            name = line[1:].split()[0].decode() if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield FastaRecord(name, encode_bases(b"".join(chunks)))


def _iter_fastq_fh(fh) -> Iterator[FastaRecord]:
    while True:
        hdr = fh.readline()
        if not hdr:
            return
        hdr = hdr.strip()
        if not hdr:
            continue
        if not hdr.startswith(b"@"):
            raise ValueError(f"bad FASTQ header line: {hdr[:40]!r}")
        seq = fh.readline().strip()
        plus = fh.readline()
        qual = fh.readline()
        if not qual:
            raise ValueError("truncated FASTQ record")
        name = hdr[1:].split()[0].decode() if len(hdr) > 1 else ""
        yield FastaRecord(name, encode_bases(seq))


def write_fasta(path: str, records: Sequence[Tuple[str, np.ndarray]],
                width: int = 80) -> None:
    """Write (name, codes) records as FASTA with fixed line width."""
    from ..native import get as _native
    lib = _native()
    if lib is not None:
        records = list(records)
        names = [name for name, _ in records]
        chunks = [np.asarray(c, dtype=np.uint8) for _, c in records]
        lengths = np.array([len(c) for c in chunks], dtype=np.int32)
        starts = np.zeros(len(chunks), dtype=np.int64)
        if len(chunks):
            np.cumsum(lengths[:-1].astype(np.int64), out=starts[1:])
        codes = (np.concatenate(chunks) if chunks
                 else np.zeros(0, dtype=np.uint8))
        with open(path, "wb") as fh:
            fh.write(lib.format_fasta(codes, starts, lengths, names, width))
        return
    with open(path, "wb") as fh:
        for name, codes in records:
            fh.write(b">" + name.encode() + b"\n")
            seq = decode_bases(np.asarray(codes, dtype=np.uint8))
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + b"\n")


def format_fasta(name: str, codes: np.ndarray, width: int = 80) -> bytes:
    out = _io.BytesIO()
    out.write(b">" + name.encode() + b"\n")
    seq = decode_bases(np.asarray(codes, dtype=np.uint8))
    for i in range(0, len(seq), width):
        out.write(seq[i:i + width] + b"\n")
    return out.getvalue()
