"""M4 overlap and extension-candidate record formats.

Contract surfaces of the framework (SURVEY.md §2.5).  The M4 line layout is
[B]-confidence from BASELINE.json / SURVEY.md:

    qid sid identity score qstrand qstart qend qsize sstrand sstart send ssize

Conventions (documented here because the reference mount is empty —
TODO(ref): re-check every one against the reference's writer when available):

* read ids are 1-based integers assigned in input order;
* the query is normalised to its forward strand (qstrand always 0);
  sstrand is 1 when the query matches the reverse-complement of the subject;
* all coordinates are 0-based half-open [start, end) on the FORWARD strand
  of the respective read;
* identity is printed with 2 decimals; score is the DDF block score.

Candidate records (mecat2pw -j 0 → mecat2cns -i 0) carry the un-extended
seed:

    qid sid score qdir qext qsize sdir sext ssize

where qext is the seed position in the qdir-oriented query and sext the seed
position on the forward subject (sdir always 0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

from ..constants import M4_IDENTITY_DECIMALS


@dataclass
class M4Record:
    qid: int          # 1-based
    sid: int          # 1-based
    identity: float   # percent
    score: int        # DDF block score
    qstrand: int      # always 0 (query normalised to forward)
    qstart: int
    qend: int
    qsize: int
    sstrand: int      # 0/1
    sstart: int
    send: int
    ssize: int
    # mecat2pw -g 1: gapped-extension start point (seed) columns.  qext is
    # in the sstrand-oriented query, sext on the forward subject
    # (candidate-record convention).  None = plain 12-column M4.
    qext: int | None = None
    sext: int | None = None

    def format(self) -> str:
        base = (f"{self.qid}\t{self.sid}\t"
                f"{self.identity:.{M4_IDENTITY_DECIMALS}f}\t{self.score}\t"
                f"{self.qstrand}\t{self.qstart}\t{self.qend}\t{self.qsize}\t"
                f"{self.sstrand}\t{self.sstart}\t{self.send}\t{self.ssize}")
        if self.qext is not None:
            base += f"\t{self.qext}\t{self.sext}"
        return base

    @classmethod
    def parse(cls, line: str) -> "M4Record":
        f = line.split()
        if len(f) < 12:
            raise ValueError(f"bad M4 line: {line!r}")
        return cls(qid=int(f[0]), sid=int(f[1]), identity=float(f[2]),
                   score=int(float(f[3])), qstrand=int(f[4]), qstart=int(f[5]),
                   qend=int(f[6]), qsize=int(f[7]), sstrand=int(f[8]),
                   sstart=int(f[9]), send=int(f[10]), ssize=int(f[11]),
                   qext=int(f[12]) if len(f) >= 14 else None,
                   sext=int(f[13]) if len(f) >= 14 else None)


@dataclass
class CandidateRecord:
    qid: int          # 1-based
    sid: int          # 1-based
    score: int
    qdir: int         # orientation of the query for this candidate
    qext: int         # seed position in the qdir-oriented query
    qsize: int
    sdir: int         # always 0
    sext: int         # seed position on the forward subject
    ssize: int

    def format(self) -> str:
        return (f"{self.qid}\t{self.sid}\t{self.score}\t"
                f"{self.qdir}\t{self.qext}\t{self.qsize}\t"
                f"{self.sdir}\t{self.sext}\t{self.ssize}")

    @classmethod
    def parse(cls, line: str) -> "CandidateRecord":
        f = line.split()
        if len(f) < 9:
            raise ValueError(f"bad candidate line: {line!r}")
        return cls(qid=int(f[0]), sid=int(f[1]), score=int(float(f[2])),
                   qdir=int(f[3]), qext=int(f[4]), qsize=int(f[5]),
                   sdir=int(f[6]), sext=int(f[7]), ssize=int(f[8]))


def format_block(records: List) -> str:
    """Batched formatting of a homogeneous list of M4Record/CandidateRecord.

    Uses the native columnar serializer (mecat_jax.native) when available —
    this is the hot write path of the pw/ref drivers — with a per-record
    Python fallback producing identical bytes.
    """
    if not records:
        return ""
    from ..native import get as _native
    import numpy as np
    lib = _native()
    if lib is None or (isinstance(records[0], M4Record)
                       and records[0].qext is not None):
        # 14-column (-g 1) records take the Python writer
        return "".join(r.format() + "\n" for r in records)
    if isinstance(records[0], M4Record):
        cols = {f: np.asarray([getattr(r, f) for r in records])
                for f in ("qid", "sid", "identity", "score", "qstrand",
                          "qstart", "qend", "qsize", "sstrand", "sstart",
                          "send", "ssize")}
        return lib.format_m4(cols).decode()
    cols = {f: np.asarray([getattr(r, f) for r in records])
            for f in ("qid", "sid", "score", "qdir", "qext", "qsize",
                      "sdir", "sext", "ssize")}
    return lib.format_candidates(cols).decode()


def format_candidate_columns(cols: dict) -> str:
    """Columnar candidate serialization (no per-record Python objects).

    The hot write path of mecat2pw -j 0 at scale: callers assemble int
    column arrays vectorised; the native writer (or a byte-identical
    Python fallback) renders them in one call.
    """
    import numpy as np

    n = len(cols["qid"])
    if n == 0:
        return ""
    from ..native import get as _native
    lib = _native()
    if lib is not None:
        return lib.format_candidates(cols).decode()
    a = np.column_stack([np.asarray(cols[f], dtype=np.int64)
                         for f in ("qid", "sid", "score", "qdir", "qext",
                                   "qsize", "sdir", "sext", "ssize")])
    return "".join("\t".join(map(str, row)) + "\n" for row in a)


def read_m4(path: str) -> Iterator[M4Record]:
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield M4Record.parse(line)


def read_candidates(path: str) -> Iterator[CandidateRecord]:
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield CandidateRecord.parse(line)


def write_records(path: str, records: List) -> None:
    with open(path, "w") as fh:
        for r in records:
            fh.write(r.format() + "\n")
