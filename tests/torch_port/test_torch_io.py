"""The port's FASTA/FASTQ parsers, encoder and native codec vs the
reference's, on the files of tests/unit/test_shard_io.py and
test_native_codec.py: the same records, shards and code matrices."""

import gzip

import numpy as np
import pytest

from tpu_euler.io import encode as ref_encode
from tpu_euler.io import fastx as ref_fastx
from tpu_euler.io import native as ref_native
from tpu_euler.reference_impl.simulate import random_genome, simulate_reads
from tpu_euler_torch.io import encode, fastx, native

@pytest.fixture
def codec():
    """Skip where no compiler builds the native codec (decided in the test,
    not while the module is imported)."""
    if not (native.native_available() and ref_native.native_available()):
        pytest.skip("no compiler for the native codec")


@pytest.fixture(scope="module")
def reads():
    return simulate_reads(random_genome(1500, seed=601), read_len=80, coverage=14, seed=602)


def _fq(path, reads, qual="I", crlf=False, trailing_newline=True):
    nl = "\r\n" if crlf else "\n"
    text = "".join(f"@r{i} pair/1{nl}{r}{nl}+{nl}{qual * len(r)}{nl}" for i, r in enumerate(reads))
    with open(path, "wb") as f:
        f.write((text if trailing_newline else text[: -len(nl)]).encode())
    return str(path)


def _fa(path, reads, width=33, trailing_newline=True):
    text = "".join(
        f">r{i} desc\n" + "".join(r[j : j + width] + "\n" for j in range(0, len(r), width))
        for i, r in enumerate(reads)
    )
    with open(path, "w") as f:
        f.write(text if trailing_newline else text[:-1])
    return str(path)


FILES = {
    "fq": lambda p, r: _fq(p / "r.fq", r),
    "fq_at_quality": lambda p, r: _fq(p / "r.fastq", r, qual="@"),
    "fq_crlf": lambda p, r: _fq(p / "r.fq", r, crlf=True),
    "fq_no_final_newline": lambda p, r: _fq(p / "r.fq", r, trailing_newline=False),
    "fa_multiline": lambda p, r: _fa(p / "r.fa", r),
    "fa_no_final_newline": lambda p, r: _fa(p / "r.fasta", r, trailing_newline=False),
}


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7])
@pytest.mark.parametrize("kind", list(FILES))
def test_shards_match_reference_and_partition_the_file(tmp_path, reads, kind, n_shards):
    path = FILES[kind](tmp_path, reads)
    whole = list(fastx.read_fastx(path))
    assert whole == list(ref_fastx.read_fastx(path))
    assert [s for _, s in whole] == reads
    parts = [list(fastx.read_shard(path, s, n_shards)) for s in range(n_shards)]
    assert parts == [list(ref_fastx.read_shard(path, s, n_shards)) for s in range(n_shards)]
    assert sum(parts, []) == whole
    if kind.startswith("fq"):
        qwhole = list(fastx.read_fastq_with_qual(path))
        assert qwhole == list(ref_fastx.read_fastq_with_qual(path))
        qparts = [list(fastx.read_shard_with_qual(path, s, n_shards)) for s in range(n_shards)]
        assert qparts == [list(ref_fastx.read_shard_with_qual(path, s, n_shards)) for s in range(n_shards)]
        assert sum(qparts, []) == qwhole
        assert [[(n, s) for n, s, _ in p] for p in qparts] == parts


def test_more_shards_than_records_and_an_empty_file(tmp_path):
    path = _fq(tmp_path / "tiny.fq", ["ACGTACGTAC", "TTGGCCAATT"])
    parts = [list(fastx.read_shard(path, s, 16)) for s in range(16)]
    assert parts == [list(ref_fastx.read_shard(path, s, 16)) for s in range(16)]
    assert sum(parts, []) == list(fastx.read_fastx(path)) and len(sum(parts, [])) == 2
    empty = tmp_path / "empty.fq"
    empty.write_text("")
    assert list(fastx.read_shard(str(empty), 0, 2)) == list(fastx.read_shard_with_qual(str(empty), 1, 2)) == []


@pytest.mark.parametrize("ext", ["fq", "fa"])
def test_gz_is_sharded_by_striding(tmp_path, reads, ext):
    path = str(tmp_path / f"r.{ext}.gz")
    with gzip.open(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" if ext == "fq" else f">r{i}\n{r}\n")
    whole = list(fastx.read_fastx(path))
    assert whole == list(ref_fastx.read_fastx(path)) and len(whole) == len(reads)
    for s in range(3):
        assert list(fastx.read_shard(path, s, 3)) == list(ref_fastx.read_shard(path, s, 3)) == whole[s::3]
    if ext == "fq":
        assert [x[:2] for x in fastx.read_shard_with_qual(path, 1, 3)] == whole[1::3]


def test_write_fasta_and_batches(tmp_path, reads):
    ours, theirs = tmp_path / "a.fa", tmp_path / "b.fa"
    contigs = [reads[0] * 3, "ACGT", ""]
    fastx.write_fasta(ours, contigs, prefix="walk")
    ref_fastx.write_fasta(theirs, contigs, prefix="walk")
    assert ours.read_text() == theirs.read_text()
    assert [s for _, s in fastx.read_fasta(ours)] == [c for c in contigs]
    recs = [(str(i), r) for i, r in enumerate(reads[:10])]
    assert list(fastx.batched_sequences(iter(recs), 4)) == list(ref_fastx.batched_sequences(iter(recs), 4))
    assert fastx.shard_byte_range(1000, 2, 3) == ref_fastx.shard_byte_range(1000, 2, 3)


def test_encoders_match_reference(reads):
    odd = ["ACGTN", "acgtacgtTT", "", "GGXCA" * 30, b"TTGCA"]
    for batch, n in ((odd, 100), (odd, 7), (reads, 80)):
        np.testing.assert_array_equal(encode.encode_reads(batch, n), ref_encode.encode_reads(batch, n))
    quals = ["".join("#I5"[(i + j) % 3] for j in range(len(r))) for i, r in enumerate(reads)]
    for min_qual in (0, 10, 30):
        np.testing.assert_array_equal(
            encode.encode_reads_with_qual(reads, quals, 70, min_qual),
            ref_encode.encode_reads_with_qual(reads, quals, 70, min_qual),
        )
    codes = encode.encode_reads(odd[:2], 12)
    assert [encode.decode_read(c) for c in codes] == [ref_encode.decode_read(c) for c in codes] == ["ACGT", "ACGTACGTTT"]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("kind", list(FILES))
def test_native_codec_matches_reference_and_python(codec, tmp_path, reads, kind, n_shards):
    path = FILES[kind](tmp_path, reads)
    whole = native.encode_file_native(path, read_len=80)
    np.testing.assert_array_equal(whole, ref_native.encode_file_native(path, read_len=80))
    np.testing.assert_array_equal(whole, encode.encode_reads(reads, 80))
    parts = [native.encode_file_shard_native(path, s, n_shards, read_len=80) for s in range(n_shards)]
    for s, part in enumerate(parts):
        np.testing.assert_array_equal(part, ref_native.encode_file_shard_native(path, s, n_shards, read_len=80))
        py = [seq for _, seq in fastx.read_shard(path, s, n_shards)]
        np.testing.assert_array_equal(part, encode.encode_reads(py, 80))
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_native_codec_quality_mask_short_filter_and_refusals(codec, tmp_path, reads):
    quals = []
    with open(tmp_path / "q.fq", "w") as f:
        for i, r in enumerate(reads):
            q = ["I"] * len(r)
            q[i % len(r)] = "#"
            quals.append("".join(q))
            f.write(f"@r{i}\n{r}\n+\n{quals[-1]}\n")
    path = str(tmp_path / "q.fq")
    got = native.encode_file_native(path, read_len=90, min_qual=10)
    np.testing.assert_array_equal(got, encode.encode_reads_with_qual(reads, quals, 90, 10))
    np.testing.assert_array_equal(got, ref_native.encode_file_native(path, read_len=90, min_qual=10))

    seqs = ["ACGTACGTAA" * 9, "TTTT", "GGGCCCAAATTT" * 5, "ACGTN" + "A" * 30]
    fa = _fa(tmp_path / "s.fa", seqs, width=25)
    keep = [s for s in seqs if len(s) >= 21]
    np.testing.assert_array_equal(native.encode_file_native(fa, min_len_keep=21), encode.encode_reads(keep, 90))
    # what the codec does not take goes to the Python parser
    assert native.encode_file_native(str(tmp_path / "r.fq.gz")) is None
    assert native.encode_file_native(str(tmp_path / "r.txt")) is None
    assert native.encode_file_shard_native(str(tmp_path / "r.fq.gz"), 0, 2) is None
    assert native.encode_file_native(str(tmp_path / "missing.fq")) is None


def test_codec_is_built_beside_the_kernels_not_into_native(codec):
    from tpu_euler_torch import _build

    info = _build.build_info["fastx_codec"]
    assert "build/tpu_euler_torch/libfastx_codec-" in info["path"].replace("\\", "/")
    assert native.SOURCE.name == "fastx_codec.cpp" and native.SOURCE.parent.name == "native"
