"""FASTA/FASTQ reading and FASTA writing.

The port's own copy of ``tpu_euler/io/fastx.py``, record for record. Parsing
streams line by line. A shard of a plain file is a byte range: the reader
maps the file, moves both ends of its range to the next record start and
parses the records that start inside, so n readers touch a file once between
them and their shards partition its records in order. A gzip file has no
random access and is sharded by taking every n-th record.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import mmap
import os
from collections.abc import Iterator
from pathlib import Path


def _open(path: str | Path):
    path = str(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def _name(hdr) -> str:
    """Record name: the header's first word after its marker."""
    return hdr[1:].split()[0] if len(hdr) > 1 else hdr[:0]


def is_fastq(path: str | Path) -> bool:
    """By extension, under an optional ``.gz``."""
    p = str(path)
    return (p[:-3] if p.endswith(".gz") else p).endswith((".fq", ".fastq"))


def read_fasta(path: str | Path) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) records from a FASTA file (.gz ok)."""
    name, chunks = None, []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name, chunks = _name(line), []
            else:
                chunks.append(line.upper())
        if name is not None:
            yield name, "".join(chunks)


def read_fastq_with_qual(path: str | Path) -> Iterator[tuple[str, str, str]]:
    """Yield (name, sequence, quality string) records from a FASTQ file."""
    with _open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            seq = f.readline().strip().upper()
            f.readline()  # +
            qual = f.readline().strip()
            yield _name(hdr.strip()), seq, qual


def read_fastq(path: str | Path) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) records from a FASTQ file (.gz ok)."""
    for name, seq, _ in read_fastq_with_qual(path):
        yield name, seq


def read_fastx(path: str | Path) -> Iterator[tuple[str, str]]:
    """Dispatch on extension: .fq/.fastq against anything else (.gz ok)."""
    return read_fastq(path) if is_fastq(path) else read_fasta(path)


def shard_byte_range(size: int, shard: int, num_shards: int) -> tuple[int, int]:
    """[begin, end) byte range of shard i of n (contiguous, covers [0, size))."""
    return size * shard // num_shards, size * (shard + 1) // num_shards


def _line_start(mm, size: int, off: int) -> int:
    """First line start at or after byte ``off``."""
    return off if mm[off - 1 : off] == b"\n" else mm.find(b"\n", off) + 1


def _fq_resync(mm, size: int, off: int) -> int:
    """First FASTQ record start at or after byte ``off``, as the native codec
    finds it: an '@' line with a '+' line two below and a quality line as
    long as the sequence line, so an '@' that opens a quality line cannot
    pass for a header."""
    if off <= 0:
        return 0
    if off >= size:
        return size
    pos = _line_start(mm, size, off)
    while 0 < pos < size:
        if mm[pos : pos + 1] == b"@":
            l1 = mm.find(b"\n", pos) + 1
            l2 = mm.find(b"\n", l1) + 1 if l1 else 0
            if l2 and mm[l2 : l2 + 1] == b"+":
                l3 = mm.find(b"\n", l2) + 1
                l4 = mm.find(b"\n", l3) if l3 else -1
                l4 = l4 if l4 >= 0 else size
                if l3 and (l2 - l1) == (l4 - l3) + 1:
                    return pos
        nxt = mm.find(b"\n", pos)
        pos = nxt + 1 if nxt >= 0 else size
    return size


def _fa_resync(mm, size: int, off: int) -> int:
    """First FASTA record start ('>' at a line start) at or after ``off``."""
    if off <= 0:
        return 0
    if off >= size:
        return size
    pos = _line_start(mm, size, off)
    while 0 < pos < size:
        if mm[pos : pos + 1] == b">":
            return pos
        nxt = mm.find(b"\n", pos)
        pos = nxt + 1 if nxt >= 0 else size
    return size


def _readline_span(mm, size: int, pos: int) -> tuple[bytes, int]:
    nxt = mm.find(b"\n", pos)
    if nxt < 0:
        return mm[pos:size], size
    return mm[pos:nxt], nxt + 1


def _parse_fq_span(mm, size: int, begin: int, stop: int):
    """(name, sequence, quality) of the FASTQ records that start in
    [begin, stop). Lines are stripped as ``read_fastq`` strips them: a CRLF
    file must not keep its \\r, which would encode as N."""
    pos = begin
    while pos < stop:
        if mm[pos : pos + 1] != b"@":
            return
        hdr, pos = _readline_span(mm, size, pos)
        seq, pos = _readline_span(mm, size, pos)
        _, pos = _readline_span(mm, size, pos)
        qual, pos = _readline_span(mm, size, pos)
        yield _name(hdr).decode(), seq.decode().strip().upper(), qual.decode().strip()


def _parse_fa_span(mm, size: int, begin: int, stop: int):
    """FASTA records that start in [begin, stop); the last one is followed
    past ``stop``, since a record's lines belong to its header's shard."""
    pos = begin
    name, chunks = None, []
    while pos < size:
        if mm[pos : pos + 1] == b">":
            if name is not None:
                yield name, "".join(chunks)
            if pos >= stop:
                return
            hdr, pos = _readline_span(mm, size, pos)
            name, chunks = _name(hdr).decode(), []
        else:
            line, pos = _readline_span(mm, size, pos)
            if name is not None:
                chunks.append(line.decode().strip().upper())
    if name is not None:
        yield name, "".join(chunks)


@contextlib.contextmanager
def _mapped_shard(path: str, shard: int, num_shards: int, resync):
    """The mapped file, its size and the shard's record-aligned byte range."""
    size = os.path.getsize(path)
    begin, end = shard_byte_range(size, shard, num_shards)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            yield mm, size, resync(mm, size, begin), resync(mm, size, end)
        finally:
            mm.close()


def _strided(records, shard: int, num_shards: int):
    for i, rec in enumerate(records):
        if i % num_shards == shard:
            yield rec


def read_shard_with_qual(
    path: str | Path, shard: int, num_shards: int
) -> Iterator[tuple[str, str, str]]:
    """FASTQ shard i of n with quality strings: by byte range for a plain
    file, every n-th record for gzip. Which of the two is decided by the
    file's type alone, so that every reader of one file cuts it alike."""
    p = str(path)
    if p.endswith(".gz"):
        yield from _strided(read_fastq_with_qual(p), shard, num_shards)
    elif os.path.getsize(p):
        with _mapped_shard(p, shard, num_shards, _fq_resync) as (mm, size, b, e):
            yield from _parse_fq_span(mm, size, b, e)


def read_shard(path: str | Path, shard: int, num_shards: int) -> Iterator[tuple[str, str]]:
    """Shard i of n of a file's (name, sequence) records."""
    p = str(path)
    if p.endswith(".gz"):
        yield from _strided(read_fastx(p), shard, num_shards)
    elif p.endswith((".fq", ".fastq")):
        for name, seq, _ in read_shard_with_qual(p, shard, num_shards):
            yield name, seq
    elif os.path.getsize(p):
        with _mapped_shard(p, shard, num_shards, _fa_resync) as (mm, size, b, e):
            yield from _parse_fa_span(mm, size, b, e)


def batched_sequences(
    records: Iterator[tuple[str, str]], batch_size: int
) -> Iterator[list[str]]:
    """Group record sequences into batches of ``batch_size`` (the last may
    be short)."""
    batch: list[str] = []
    for _, seq in records:
        batch.append(seq)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def write_fasta(path: str | Path, contigs: list[str], prefix: str = "contig") -> None:
    """Write contigs as FASTA, 80 columns, named ``<prefix>_<i> len=<n>``."""
    with open(path, "w") as f:
        for i, seq in enumerate(contigs):
            f.write(f">{prefix}_{i} len={len(seq)}\n")
            for j in range(0, len(seq), 80):
                f.write(seq[j : j + 80] + "\n")
