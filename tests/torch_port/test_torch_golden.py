"""The golden-file twin: the port's ``assemble_reads`` on the four cases of
scripts/regen_golden.py must give the checked-in digest of the sorted
canonical contig set (tests/golden/golden.json), its contig count and its
total bases. The genomes and reads are rebuilt with the port's simulator;
the script is imported read-only, as tests/integration/test_golden.py does,
for its case parameters and its digest."""

import json
import os
import sys

import pytest

from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.oracle import canonical_contig_set
from tpu_euler_torch.pipeline.assemble import assemble_reads
from tpu_euler_torch.simulate import PHIX174, random_genome, simulate_reads

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from regen_golden import CASES, contig_digest  # noqa: E402

# each case's genome, made by the port's simulator
GENOMES = {
    "phix_k21": lambda: PHIX174,
    "bac10k_k31": lambda: random_genome(10_000, seed=77),
    "errored_k21_mc4": lambda: random_genome(6_000, seed=78),
    "k41_3limb": lambda: random_genome(5_000, seed=79),
}


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(ROOT, "tests", "golden", "golden.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_reproduces_the_golden_digest(golden, name):
    case = CASES[name]
    genome = GENOMES[name]()
    assert genome == case["genome"]
    reads = simulate_reads(
        genome, read_len=100, coverage=case["cov"], seed=case["seed"], error_rate=case["err"], circular=True
    )
    cfg = AssemblyConfig(
        k=case["k"], min_count=case["min_count"], read_batch=1024, read_len=100, spectrum_capacity=1 << 16
    )
    contigs = canonical_contig_set(assemble_reads(reads, cfg, "cpu").contig_strings)
    want = golden[name]
    assert (len(contigs), sum(len(c) for c in contigs)) == (want["n_contigs"], want["total_bp"])
    assert contig_digest(sorted(contigs)) == want["digest"]
