"""The gates of the full-size runs, shared by ``chip_smoke.py`` and the bench
entry (``tpu_euler_torch/verify/compare.py``): ``check_one_contig``,
``check_substring_gate`` and ``same_assembly``, on contigs that pass and on
contigs broken in one way each."""

import dataclasses

import pytest

from tpu_euler_torch.oracle import rc
from tpu_euler_torch.pipeline.assemble import AssemblyResult
from tpu_euler_torch.simulate import ADVERSARIAL_GENOME_BP, adversarial_coverage_floor, random_genome
from tpu_euler_torch.verify.compare import check_one_contig, check_substring_gate, same_assembly

K = 31
GENOME = random_genome(2_000, seed=11)


def circular_contig(shift: int, reverse: bool) -> bytes:
    """The genome read from ``shift`` around the circle: G + k - 1 bases."""
    g = GENOME[shift:] + GENOME[:shift]
    c = g + g[: K - 1]
    return (rc(c) if reverse else c).encode()


@pytest.mark.parametrize("shift,reverse", [(0, False), (777, False), (0, True), (1_234, True)])
def test_a_rotated_or_reverse_complemented_contig_passes(shift, reverse, capsys):
    check_one_contig("case", {circular_contig(shift, reverse)}, GENOME, K)
    assert "spells the circular genome exactly" in capsys.readouterr().out


def one_base_changed():
    c = bytearray(circular_contig(500, True))
    c[900] = ord("A") if c[900] != ord("A") else ord("C")
    return {bytes(c)}


@pytest.mark.parametrize(
    "contigs,fails",
    [
        (one_base_changed, "does not spell the genome"),
        (lambda: {circular_contig(0, False), circular_contig(5, False)}, "expected exactly one contig"),
        (lambda: {circular_contig(0, False)[:-1]}, "expected exactly one contig"),
        (lambda: {circular_contig(0, False) + b"A"}, "expected exactly one contig"),
        (lambda: set(), "expected exactly one contig"),
    ],
    ids=["one base changed", "two contigs", "a base short", "a base long", "none"],
)
def test_a_broken_contig_fails(contigs, fails):
    with pytest.raises(AssertionError, match=fails):
        check_one_contig("case", contigs(), GENOME, K)


def pieces():
    """Three substrings of the circular genome (one across its origin, one
    reverse-complemented) that cover all of it, and one short contig."""
    doubled = GENOME + GENOME
    return [doubled[0:900].encode(), rc(doubled[850:1_700]).encode(), doubled[1_650:2_100].encode(), b"ACGT"]


def test_substring_gate_passes(capsys):
    check_substring_gate("case", pieces(), GENOME, True, 0.99, 2)
    assert "is an exact substring" in capsys.readouterr().out


@pytest.mark.parametrize(
    "change,args",
    [
        (lambda cs: cs[:1] + [b"T" + cs[1][1:] if cs[1][:1] != b"T" else b"G" + cs[1][1:]] + cs[2:], (True, 0.99, 1)),
        (lambda cs: cs, (False, 0.99, 1)),  # the contig across the origin is no substring of a linear genome
        (lambda cs: cs[:1], (True, 0.99, 1)),  # too little covered
        (lambda cs: cs, (True, 0.99, 5)),  # too few contigs
        (lambda cs: cs[3:], (True, 0.0, 1)),  # no contig long enough to check
    ],
    ids=["a changed base", "linear genome", "coverage", "contig count", "nothing checked"],
)
def test_substring_gate_fails(change, args):
    with pytest.raises(AssertionError, match="the substring gate failed"):
        check_substring_gate("case", change(pieces()), GENOME, *args)


def result(**change) -> AssemblyResult:
    base = AssemblyResult(
        contigs={circular_contig(0, False)}, n_distinct_kmers=4_000, n_kmers_counted=70_000, n_reads=1_000,
        stage_seconds={"count": 1.0},
    )
    return dataclasses.replace(base, **change)


def test_same_assembly_passes_on_equal_results():
    same_assembly("case", result(stage_seconds={"count": 2.0}), result())


@pytest.mark.parametrize(
    "field,value",
    [("n_reads", 999), ("n_kmers_counted", 70_001), ("n_distinct_kmers", 3_999), ("contigs", {circular_contig(1, False)})],
)
def test_same_assembly_raises_on_one_difference(field, value):
    with pytest.raises(AssertionError, match="differ from the one-device run's"):
        same_assembly("case", result(**{field: value}), result())


def test_repeat_genome_coverage_floor():
    """scripts/fullscale_adversarial.py's structure at 12 Mbp: the tandem
    array, eleven folded copies of the 3 kbp element and 60 kbp more."""
    assert adversarial_coverage_floor() == 1.0 - (200_000 + 33_000 + 60_000) / ADVERSARIAL_GENOME_BP
    assert 0.97 < adversarial_coverage_floor() < 0.98
    assert adversarial_coverage_floor(30_000) < 0
