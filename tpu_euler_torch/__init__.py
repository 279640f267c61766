"""tpu_euler_torch: the PyTorch + CUDA port of tpu_euler for an NVIDIA H100.

The JAX package ``tpu_euler`` is the reference; each module here names the
reference function it ports, and the tests in ``tests/torch_port`` hold the
two against each other on the same seeded inputs. This package imports
``torch`` and never ``jax``, and nothing of ``tpu_euler`` either: it carries
its own config, seeded simulators and CPU oracle, so it runs where the
reference package is absent.

Layout (the path of SPEC configs 2, 3 and 5, in order):
  cli.py                 the command line: assemble, tour
  config.py              AssemblyConfig (the fields the port reads)
  simulate.py            seeded genome/read simulators, configs 2, 3 and 5,
                         the 12 Mbp repeat genome
  oracle.py              pure-Python CPU oracle (with tips and bubbles),
                         contig-set comparison
  verify/compare.py      contig-set comparison under the reference's path,
                         the substring gate of the full-size runs
  io/fastx.py            FASTA/FASTQ readers (whole, byte-range shards), FASTA
                         writer
  io/encode.py           reads -> int8 codes, quality masking
  io/native.py           the native parse-and-encode codec (native/, g++)
  convert.py             limbs <-> int64 words; reference records -> port/numpy
  kmer/keys.py           k-mer keys: one int64 word (k <= 31), or ceil(k/31)
  kmer/extract.py        plain window extraction + canonicalization
  kmer/extract_kernel.py the fused extract kernel (csrc/extract_canonical.cu)
  kmer/count.py          sort + dedup into a spectrum, merges, cutoff
  graph/build.py         staged graph build over the virtual doubled edges;
                         build_graph with materialized edge keys
  graph/validate.py      graph and chain invariants, on the host
  euler/unitigs.py       successors, cycle cutting, chains
  euler/ranking.py       sparse-ruling-set list ranking
  euler/clean.py         tip clipping and bubble popping, round by round
  euler/extract.py       device emission of contig bytes; the host emission
  euler/tour.py          Eulerian tour: pairing, labels, rotation merge
  pipeline/assemble.py   counting routes (one-shot, grouped arena, per
                         batch), cutoff + cleaning, assemble_codes /
                         assemble_reads
  pipeline/checkpoint.py spectrum and graph checkpoints in the reference's
                         file format
  trace.py               each assembly's spans and counters; the stage
                         timers are sums of its spans
  profile_config2.py     configs 2 to 5 on the card, one device or
                         sharded: walls, stages, the split of the
                         assembly's own spans and counters, trace
  probes.py              the five TPU compiler probes (csrc/probes.cu)

Functions that make tensors from host data take an explicit ``device``;
the rest allocate on the device of the tensors they are given. Nothing
uses a global default device or random numbers.
"""
