"""The multi-rank dry run (``tpu_euler_torch.entry``) over a loopback on the
CPU: the three phases of the reference's ``dryrun_multichip``, each equal to
the oracle, with the first slab factor's overflow retried."""

import logging

import pytest
import torch

from tpu_euler_torch import entry
from tpu_euler_torch.dist.mesh import LoopbackComm


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_over_the_loopback(n, caplog, capsys):
    with caplog.at_level(logging.WARNING, logger="tpu_euler_torch"):
        summary = entry.dryrun_multichip(n, comm=LoopbackComm(n, "cpu"))
    assert summary["ranks"] == n and summary["retries"] == 1
    assert summary["reads"] == 12_000 and summary["kmers"] == 60_000
    assert (summary["contigs"], summary["contigs_tips_bubbles"], summary["contigs_k41"]) == (1, 1, 1)
    # the retry is in the log, once, and only the dry run's own handler is gone
    assert sum("retrying with a bigger slab" in r.getMessage() for r in caplog.records) == 1
    assert not [h for h in logging.getLogger("tpu_euler_torch").handlers if type(h).__name__ == "_Catch"]
    assert f"dryrun_multichip({n}): OK" in capsys.readouterr().out


def test_dryrun_refuses_a_comm_of_another_size():
    with pytest.raises(AssertionError, match="need 4 ranks, the comm has 2"):
        entry.dryrun_multichip(4, comm=LoopbackComm(2, "cpu"))


def test_dryrun_defaults_to_the_card():
    """No comm and no device given: the first CUDA device, never the CPU
    behind the caller's back."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises((RuntimeError, AssertionError)):
        entry.dryrun_multichip(2)
