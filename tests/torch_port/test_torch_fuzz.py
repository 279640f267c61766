"""The reference's fuzz sweep (``tests/integration/test_fuzz.py``) through
the port on the CPU: six adversarial genome profiles, eight seeded trials
and the GC-skewed genome sharded over four loopback ranks with the traversal
sharded, each equal to the port's oracle (``tpu_euler_torch/fuzz.py``,
which ``chip_smoke.py`` runs on the card too). The oracle is held to the
reference's by ``test_torch_oracle.py``; the draws of each trial are the
reference's, in its order."""

import pytest

from tpu_euler_torch import fuzz
from tpu_euler_torch.dist.mesh import LoopbackComm


@pytest.mark.parametrize("i", range(len(fuzz.PROFILES)), ids=[p[0] for p in fuzz.PROFILES])
def test_adversarial_profiles_equal_oracle(i):
    assert fuzz.run_profile(i, "cpu") > 0


@pytest.mark.parametrize("trial", range(fuzz.N_TRIALS))
def test_fuzz_pipeline_equals_oracle(trial):
    assert fuzz.run_trial(trial, "cpu") > 0


def test_adversarial_sharded_skew():
    assert fuzz.run_skew(LoopbackComm(4, "cpu")) > 0
