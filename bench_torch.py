"""The port's bench entry, the twin of ``bench.py``: SPEC config 2 (or 3, 4,
5, the repeat genome) on one H100, or over NCCL ranks with ``--mesh N``.
Run from the repository root:

    python3 bench_torch.py [--config 2|3|4|5|repeat] [--mesh N [--shard-traversal]] [--reps 3]
                           [--seed S] [--genome-bp B] [--device cuda|cpu] [--out F]

It prints one JSON line; see ``tpu_euler_torch/bench.py``.
"""

import sys

if __name__ == "__main__":
    from tpu_euler_torch.bench import main

    sys.exit(main())
