"""The weak-scaling twin (``tpu_euler_torch/bench_scaling.py``) on the CPU:
gloo ranks at world 1 and 2 and two ranks held on one device, at a tiny
load; the rows' fields, and no key, record or request dropped."""

import pytest

from tpu_euler_torch import bench_scaling
from tpu_euler_torch.dist.traverse_dist import _log2_ceil

FIELDS = {
    "mode", "world", "devices", "count_step_s", "count_spread_s", "count_reads_per_s_per_device",
    "count_kmers_per_s_per_device", "traverse_step_s", "traverse_spread_s", "traverse_edges_total",
    "traverse_edges_per_s_per_device", "traverse_rounds_max", "count_dropped", "slab_dropped",
}


def test_rows_over_gloo_and_the_loopback():
    rec = bench_scaling.run(
        "cpu", worlds=(1, 2), loopback=(2,), reads_per_rank=256, genome_per_rank=3000, reps=2,
        timeout_s=240, threads=1, emit=lambda _: None,
    )
    rows = {(r["mode"], r["world"]): r for r in rec["rows"]}
    assert list(rows) == [("gloo", 1), ("gloo", 2), ("loopback", 2)]
    assert rec["per_rank_load"]["count_windows"] == 256 * 70 and rec["skipped"] == []
    for (mode, world), r in rows.items():
        assert FIELDS <= set(r)
        assert r["count_dropped"] == 0 and r["slab_dropped"] == 0
        assert r["count_spread_s"][0] <= r["count_step_s"] <= r["count_spread_s"][1]
        assert r["traverse_spread_s"][0] <= r["traverse_step_s"] <= r["traverse_spread_s"][1]
        # two strands of a circular genome of 3,000 bases a rank
        assert r["traverse_edges_total"] == 2 * 3000 * world
        assert r["traverse_rounds_max"] == _log2_ceil(world * 2 * 4096) + 1
        assert r["devices"] == (1 if mode == "loopback" else world)
    assert rows["gloo", 1]["count_weak_eff"] == rows["gloo", 1]["traverse_weak_eff"] == 1.0
    assert rows["gloo", 2]["count_weak_eff"] > 0
    assert "count_weak_eff" not in rows["loopback", 2] and "timeshare" in rows["loopback", 2]["label"]


def test_a_row_that_drops_fails_the_run(monkeypatch):
    got = {"count_s": [1.0], "count_windows": 10, "traverse_s": [1.0], "traverse_edges": 4,
           "traverse_rounds_max": 3, "count_dropped": 0, "slab_dropped": 2}
    monkeypatch.setattr(bench_scaling, "scaling_rank", lambda *a: got)
    monkeypatch.setattr(bench_scaling, "make_inputs", lambda *a: (bench_scaling.np.zeros((2, 100), "int8"),) * 2)
    with pytest.raises(RuntimeError, match="dropped"):
        bench_scaling.run("cpu", worlds=(), loopback=(2,), reads_per_rank=1, genome_per_rank=10, emit=lambda _: None)


def test_more_ranks_than_gpus_are_left_out_and_say_so(monkeypatch):
    monkeypatch.setattr(bench_scaling.torch.cuda, "device_count", lambda: 1)
    said = []
    rec = bench_scaling.run("cuda", worlds=(2, 4), loopback=(), emit=said.append)
    assert rec["rows"] == [] and said == rec["skipped"] == [
        "nccl world 2 not run: 1 GPU(s) visible", "nccl world 4 not run: 1 GPU(s) visible"
    ]
