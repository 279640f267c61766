"""The five TPU compiler probes (``tpu_euler_torch.probes``) on the CPU.

The scripts ``scripts/debug_pallas{2..6}.py`` run on import and need a TPU,
so their numpy expectations are restated here with their seed and shapes,
and each plain probe is held equal to them. The plain ``extract_stages`` is
also held equal to the reference's stage functions
(``pallas_extract._pack_windows``, ``_revcomp_limbs``, ``_canonical_limbs``,
pure jnp) at k = 31 and 41. JAX is imported inside the test that uses it, so
the CUDA test can run on a machine without it:

    python -m pytest --confcutdir=tests/torch_port tests/torch_port/test_torch_probes.py -m cuda
"""

import numpy as np
import pytest
import torch

from tpu_euler_torch import convert, probes

R, LMAX, W = 512, 100, 70


def _codes():
    return np.random.default_rng(0).integers(0, 4, (R, LMAX), dtype=np.int8)


def _script2(codes):
    return np.stack([codes[:, i : i + W].astype(np.int32) for i in range(8)])


def _script4(codes):
    cw = codes.astype(np.uint32)
    terms = [((cw[:, i : i + W] & 3) << (2 * (14 - i))).astype(np.uint32) for i in range(15)]
    want_acc = np.zeros((R, W), np.uint32)
    for t in terms:
        want_acc |= t
    return np.stack([terms[4], terms[5], terms[8], want_acc, want_acc, want_acc])


def _script5(x):
    LS = RS = [2, 8, 14, 16, 18, 20, 22, 26, 30]
    MS = [14, 16, 18, 20, 22]
    return np.stack(
        [x << np.uint32(s) for s in LS] + [x >> np.uint32(s) for s in RS]
        + [x * np.uint32(1 << s) for s in MS]
    )


def _script6(codes):
    cw = codes.astype(np.uint32) & 3
    want = np.zeros((R, W), np.uint32)
    for i in range(15):
        want |= cw[:, i : i + W] << np.uint32(2 * (14 - i))
    return np.stack([cw[:, 4 : 4 + W] << np.uint32(20), cw[:, 5 : 5 + W] << np.uint32(18), want, want, want])


def _u32_input():
    rng = np.random.default_rng(0)
    return rng.integers(0, 1 << 32, (R, 128), dtype=np.uint64).astype(np.uint32)


CASES = {  # name -> (plain probe, expectation module function, input, script's expectation)
    "lane_slices": (probes.lane_slices_plain, probes.expect_lane_slices, _codes, _script2),
    "shift_terms": (probes.shift_terms_plain, probes.expect_shift_terms, _codes, _script4),
    "u32_shifts": (
        probes.u32_shifts_plain, probes.expect_u32_shifts,
        lambda: _u32_input().view(np.int32), lambda x: _script5(x.view(np.uint32)),
    ),
    "hoisted_and_roll": (probes.hoisted_and_roll_plain, probes.expect_hoisted_and_roll, _codes, _script6),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_probe_matches_script(name):
    plain, expect, make_input, script = CASES[name]
    x = make_input()
    want = script(x).view(np.int32)  # uint32 results are held as int32 bits
    got = plain(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(expect(x), want)
    assert np.unique(got).size > 1


@pytest.mark.parametrize("k", [31, 41])
def test_extract_stages_matches_pallas_stages(k):
    """Forward pack, reverse complement and canonical select, per limb, as
    the reference's kernel body computes them (debug_pallas3's stages)."""
    import jax.numpy as jnp

    from tpu_euler.kmer.keys import nlimbs
    from tpu_euler.kmer.pallas_extract import _canonical_limbs, _pack_windows, _revcomp_limbs

    codes = _codes()
    Wk = LMAX - k + 1
    L = nlimbs(k)
    fwd = _pack_windows(jnp.asarray(codes, dtype=jnp.int32), k, Wk)
    rev = _revcomp_limbs(fwd, k)
    can = _canonical_limbs(fwd, rev)
    got = probes.extract_stages_plain(torch.from_numpy(codes), k)
    assert got.shape[:2] == (3, R * Wk)
    for s, stage in enumerate((fwd, rev, can)):
        want = np.stack([np.asarray(x) for x in stage], axis=-1).reshape(R * Wk, L)
        np.testing.assert_array_equal(convert.words_to_limbs(got[s], L), want, err_msg=f"stage {s}")
    np.testing.assert_array_equal(probes.expect_extract_stages(codes, k), got.numpy())
    assert not torch.equal(got[0], got[2]) and not torch.equal(got[1], got[2])


def test_run_all_on_cpu_launches_nothing():
    before = dict(probes.launches)
    lines = probes.run_all("cpu")
    assert len(lines) == 6 and all(": OK" in ln for ln in lines)
    assert probes.launches == before


def test_probes_command_runs_on_the_cpu_only_when_asked(capsys):
    """``--device cpu`` runs the plain versions; the default device is the
    card, and without one the command fails instead of passing on the CPU."""
    assert probes.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "plain versions" in out and out.count("OK") == 6
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(SystemExit) as exc:
        probes.main([])
    assert exc.value.code not in (0, None) and "no CUDA device" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_probes_reject_bad_input():
    codes = torch.from_numpy(_codes())
    with pytest.raises(ValueError):
        probes.lane_slices(codes, W=95)  # windows run past the read
    with pytest.raises(ValueError):
        probes.shift_terms(codes, W=90)
    with pytest.raises(TypeError):
        probes.hoisted_and_roll(codes.to(torch.int32))
    with pytest.raises(ValueError):
        probes.extract_stages(codes, 63)  # (k+1)-mers would not fit two words
    with pytest.raises(TypeError):
        probes.u32_shifts(codes)
    with pytest.raises(ValueError):
        probes.lane_slices(codes[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        probes.lane_slices(codes.to("meta"))  # no kernel there


@pytest.mark.cuda
@pytest.mark.parametrize("k_stages", [31, 41])
def test_kernels_match_plain_on_card(k_stages):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for name, probe, plain, x, expect in probes.cases((k_stages,)):
        xd = torch.from_numpy(x).to(dev)
        before = dict(probes.launches)
        got = probe(xd)
        assert sum(probes.launches.values()) == sum(before.values()) + 1, name
        want = plain(xd)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        np.testing.assert_array_equal(got.cpu().numpy(), expect(x), err_msg=name)
