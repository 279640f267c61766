"""The port's spans and counters (``tpu_euler_torch/trace.py``): the span
tree of a small assembly, the stage timers as sums of its spans, the bounded
history, the spans' mirror in ``torch.profiler``'s host timeline, the
counters, and the benchmark's readers of the history."""

import collections
import dataclasses
import json
import threading
from pathlib import Path

import pytest
import torch

from tpu_euler_torch import trace
from tpu_euler_torch.config import AssemblyConfig
from tpu_euler_torch.pipeline.assemble import assemble_codes
from tpu_euler_torch.simulate import random_genome, simulate_read_codes

ROOT = Path(__file__).resolve().parents[2]
READERS = ("pack_s", "pack_cpu_s", "walk_s", "emit_copy_s", "emit_host_s")


def _codes():
    return simulate_read_codes(random_genome(6000, seed=41), read_len=100, coverage=25, seed=42, circular=True)


BASE = AssemblyConfig(k=31, read_batch=256, read_len=100, spectrum_capacity=1 << 15)
ROUTES = {
    "oneshot": BASE,
    "grouped": dataclasses.replace(BASE, oneshot_rows=2 * 256 * 70),  # 6 batches, 2 a group
    "per_batch": dataclasses.replace(BASE, oneshot_rows=0),
    "cleaning": dataclasses.replace(BASE, min_count=2, tip_rounds=1, bubble_rounds=1),
}


@pytest.fixture(scope="module")
def assemblies():
    codes = _codes()
    return codes, {route: assemble_codes(codes, cfg, "cpu") for route, cfg in ROUTES.items()}


def _n_batches(codes, cfg):
    return -(-codes.shape[0] // cfg.read_batch)


@pytest.mark.parametrize("route", list(ROUTES))
def test_span_tree_of_an_assembly(assemblies, route):
    """Unique ids; every parent a span of the trace; one assembly id; the
    root ``assembly`` on the main thread, the feed's pack on another
    thread; each batch packed, waited for and launched once."""
    codes, results = assemblies
    recs = results[route].trace.records()
    ids = [r["id"] for r in recs]
    assert len(ids) == len(set(ids))
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == trace.ROOT and root["id"] == results[route].trace.root
    assert all(r["parent"] in set(ids) for r in recs if r is not root)
    assert {r["assembly"] for r in recs} == {results[route].trace.assembly}
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r["name"]].append(r)
        assert root["start_ns"] <= r["start_ns"] <= r["end_ns"] <= root["end_ns"]
    assert {r["thread"] for r in by_name["feed: wait"]} == {root["thread"]} == {threading.get_native_id()}
    assert root["thread"] not in {r["thread"] for r in by_name["feed: pack"]}
    n = _n_batches(codes, ROUTES[route])
    for name in ("feed: pack", "feed: wait", "count: extract launch"):
        assert sorted(r["attrs"]["batch"] for r in by_name[name]) == list(range(n)), name
    for r in by_name["feed: pack"]:
        assert r["attrs"]["cpu_end_ns"] >= r["attrs"]["cpu_start_ns"]
    assert ("clean" in by_name) == (route == "cleaning")
    if route == "grouped":
        assert sorted(r["attrs"]["group"] for r in by_name["count: drain"]) == [0, 1, 2]
    copy = by_name["emit: copy"]
    assert len(copy) == 1 and copy[0]["attrs"]["bytes"] == results[route].trace.counters["d2h_bytes"] > 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_stage_seconds_are_sums_of_spans(assemblies, route):
    """Each stage is the sum of its spans, the keys in the reference's
    order; the emission's three spans make the ``extract`` stage (the
    sharded mode's ``emit: fragments`` is its fourth). No staged span nests
    in another on these routes, so the sums are whole. The cleaning route
    has its rounds' ``clean: graph`` and ``clean: mark`` spans, one pair a
    round, inside ``clean``, which alone makes ``tips``."""
    res = assemblies[1][route]
    recs = res.trace.records()
    by_id = {r["id"]: r for r in recs}
    ns = collections.Counter()
    for r in recs:
        if r["name"] in trace.STAGE_OF:
            ns[trace.STAGE_OF[r["name"]]] += r["end_ns"] - r["start_ns"]
            up = by_id.get(r["parent"])
            while up is not None:
                assert up["name"] not in trace.STAGE_OF, (r["name"], up["name"])
                up = by_id.get(up["parent"])
    assert res.stage_seconds == {stage: ns[stage] / 1e9 for stage in trace.STAGES if stage in ns}
    want = ["encode", "count", "count_drain"] + (["tips"] if route == "cleaning" else []) + ["graph", "extract"]
    assert list(res.stage_seconds) == want
    assert trace.STAGES["extract"] == ("emit: device", "emit: copy", "emit: host", "emit: fragments")
    assert res.stage_seconds == res.trace.stage_seconds()
    calls = res.trace.rollup()["calls"]
    rounds = [r for r in recs if r["name"] in ("clean: graph", "clean: mark")]
    if route != "cleaning":
        assert not rounds
        return
    cfg = ROUTES[route]
    assert 1 <= calls["clean: graph"] == calls["clean: mark"] <= cfg.tip_rounds + cfg.bubble_rounds
    assert {r["attrs"]["kind"] for r in rounds} <= {"tips", "bubbles"}
    assert all(by_id[r["parent"]]["name"] == "clean" and r["attrs"]["round"] >= 0 for r in rounds)
    assert sorted((r["attrs"]["kind"], r["attrs"]["round"]) for r in rounds if r["name"] == "clean: graph") == sorted(
        (r["attrs"]["kind"], r["attrs"]["round"]) for r in rounds if r["name"] == "clean: mark"
    )
    assert res.stage_seconds["tips"] == res.trace.rollup()["seconds"]["clean"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_profile_fine_split_of_a_cpu_assembly(assemblies, route):
    """``profile_config2``'s ``fine_s`` is the assembly's rollup: every span
    name with its seconds and calls, the feed's pack with its CPU seconds,
    the costliest first; a name of a few calls lists each call with its
    attributes (the drains by group, the cleaning rounds by kind and
    round)."""
    from tpu_euler_torch.profile_config2 import EACH_MOST, fine_split

    res = assemblies[1][route]
    rollup = res.trace.rollup()
    fine = fine_split(rollup, res.trace.records())
    assert list(fine) == sorted(rollup["seconds"], key=lambda name: -rollup["seconds"][name])
    assert fine[trace.ROOT]["calls"] == 1 and list(fine)[0] == trace.ROOT
    for name, row in fine.items():
        assert (row["s"], row["calls"]) == (rollup["seconds"][name], rollup["calls"][name])
        assert ("cpu_s" in row) == (name == "feed: pack")
        if "each" in row:
            assert 1 < len(row["each"]) == row["calls"] <= EACH_MOST
            assert sum(e["s"] for e in row["each"]) == pytest.approx(row["s"])
    n = _n_batches(assemblies[0], ROUTES[route])
    assert fine["feed: wait"]["calls"] == n and ("each" in fine["feed: wait"]) == (1 < n <= EACH_MOST)
    if route == "grouped":
        assert [e["group"] for e in fine["count: drain"]["each"]] == [0, 1, 2]
    if route == "cleaning":
        rounds = fine["clean: graph"].get("each", [])
        assert all(set(e) == {"s", "kind", "round"} for e in rounds)
    assert all(("each" in row) == (1 < row["calls"] <= EACH_MOST) for row in fine.values())


def test_counters_of_an_assembly(assemblies):
    """``batches`` is the number of batches, in the assembly's counters and
    in the process totals' growth; a forced emission rerun counts once."""
    from tpu_euler_torch.euler.extract import chains_to_contigs_device_spec
    from tpu_euler_torch.euler.unitigs import unitig_chains
    from tpu_euler_torch.graph.build import build_graph
    from tpu_euler_torch.kmer.count import apply_cutoff
    from tpu_euler_torch.pipeline.assemble import count_spectrum, right_size_spectrum

    codes, results = assemblies
    for route, res in results.items():
        assert res.trace.counters["batches"] == _n_batches(codes, ROUTES[route]), route
        assert res.trace.counters["h2d_bytes"] == 0  # the CPU feed copies nothing
    before = trace.totals()
    res = assemble_codes(codes, BASE, "cpu")
    grew = trace.since(before)
    assert grew["batches"] == res.trace.counters["batches"] == _n_batches(codes, BASE)
    assert grew["d2h_bytes"] == res.trace.counters["d2h_bytes"] > 0
    spec = apply_cutoff(right_size_spectrum(count_spectrum(codes, BASE, "cpu")[0]), BASE.min_count)
    chains = unitig_chains(build_graph(spec, BASE.k), BASE.k)
    before = trace.totals()
    with trace.assembly() as tr:
        assert chains_to_contigs_device_spec(spec.words, chains, BASE.k, 8, 1) == res.contigs
    assert tr.counters["emit_reruns"] == trace.since(before)["emit_reruns"] == 1


def test_emission_counters_of_an_assembly(assemblies):
    """On the CPU the emission takes the kernel's plain version: no launch;
    no contig of a random genome mirrors itself; the one copy's bytes are
    the canonical buffer's, header and both strands."""
    from tpu_euler_torch.euler import emit_kernel

    _, results = assemblies
    for res in results.values():
        c = res.trace.counters
        assert c["emit_canonical_launches"] == 0 and c["emit_mirrored_prefixes"] == 0
        assert c["d2h_bytes"] >= 8 * emit_kernel.header_words(2 * len(res.contigs)) + 2 * sum(map(len, res.contigs))


@pytest.mark.cuda
def test_emission_kernel_runs_on_the_main_path():
    """An assembly on the card emits through the canonical kernel: three
    launches, no rerun, the CPU's contigs, and one copy of the buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes = _codes()
    res = assemble_codes(codes, BASE, "cuda")
    c = res.trace.counters
    assert c["emit_canonical_launches"] == 3 and c["emit_reruns"] == 0
    assert res.contigs == assemble_codes(codes, BASE, "cpu").contigs
    assert [r["name"] for r in res.trace.records()].count("emit: copy") == 1


def test_outside_an_assembly_counters_reach_the_totals_only():
    """A span outside an assembly records nothing; a counter grows the
    process total; ``stage_times`` still gives the caller its stages."""
    before, done = trace.totals(), len(trace.history())
    with trace.span("graph: walk"):
        trace.add("walk_launches", 3)
    assert trace.since(before)["walk_launches"] == 3
    t = {}
    with trace.stage_times(t) as tr:
        with trace.span("graph: walk"):
            pass
    assert tr is not trace.OFF and list(t) == ["graph"] and t["graph"] >= 0
    assert trace.current() is trace.OFF and len(trace.history()) == done


def test_history_is_bounded_and_holds_the_newest():
    for _ in range(trace.HISTORY + 5):
        with trace.assembly() as tr:
            trace.add("batches")
    hist = trace.history()
    assert len(hist) == trace.HISTORY
    assert hist[-1]["assembly"] == tr.assembly
    assert [h["assembly"] for h in hist] == list(range(tr.assembly - trace.HISTORY + 1, tr.assembly + 1))
    assert hist[-1]["counters"]["batches"] == 1 and hist[-1]["calls"] == {trace.ROOT: 1}


def test_a_failed_assembly_leaves_no_history():
    done = trace.history()
    with pytest.raises(RuntimeError):
        with trace.assembly():
            raise RuntimeError("the assembly failed")
    assert trace.history() == done and trace.current() is trace.OFF


def test_spans_are_cpu_ops_in_the_profiler():
    """Under ``torch.profiler`` each main-thread span is a ``cpu_op`` of its
    name (never a ``user_annotation``), within 100 us of the record."""
    from torch.profiler import ProfilerActivity, profile

    codes = _codes()[:600]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = assemble_codes(codes, BASE, "cpu")
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append(e)
    main = threading.get_native_id()
    recs = [r for r in res.trace.records() if r["thread"] == main]
    assert {r["name"] for r in recs} >= {"assembly", "feed: wait", "count: sort", "graph: walk", "emit: host"}
    for r in recs:
        near = [e for e in events[r["name"]] if abs(e.start_ns() - r["start_ns"]) < 100_000]
        assert len(near) == 1, r["name"]
        assert near[0].activity_type() == "cpu_op"
        assert abs(near[0].end_ns() - r["end_ns"]) < 100_000
    assert not any(e.activity_type() == "user_annotation" for name in trace.STAGE_OF for e in events[name])


def test_profile_writes_the_spans(tmp_path, capsys):
    """``--profile DIR`` writes the assembly's spans, from every thread,
    and its counters as ``spans.json`` beside ``trace.json``."""
    from tpu_euler_torch.cli import main
    from tpu_euler_torch.io.encode import decode_read

    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@r{i}\n{decode_read(c)}\n+\n{'I' * 100}\n" for i, c in enumerate(_codes()[:400])))
    prof = tmp_path / "prof"
    assert main(["assemble", str(fq), "-k", "31", "-o", str(tmp_path / "c.fa"), "--profile", str(prof),
                 "--device", "cpu"]) == 0
    got = json.loads((prof / "spans.json").read_text())
    assert (prof / "trace.json").stat().st_size > 0
    names = {s["name"] for s in got["spans"]}
    assert {"assembly", "feed: pack", "feed: wait", "emit: copy", "emit: host"} <= names
    assert len({s["thread"] for s in got["spans"]}) == 2 and got["counters"]["batches"] >= 1
    stages = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["stages_s"]
    assert list(stages) == ["encode", "count", "count_drain", "graph", "extract"]


def _reader(name):
    from euler_bench import cells

    return cells.load_reader(ROOT / "euler_bench", name)


@pytest.mark.parametrize("name", READERS)
def test_reader_means_the_window(name, monkeypatch):
    """Each reader is the mean over the window's assemblies (the last n
    rollups of the history) of its spans, and None without a history, or
    with fewer rollups than the window's assemblies."""
    spans = {"pack_s": ("seconds", ["feed: pack"]), "pack_cpu_s": ("cpu_seconds", ["feed: pack"]),
             "walk_s": ("seconds", ["graph: walk", "graph: sync"]), "emit_copy_s": ("seconds", ["emit: copy"]),
             "emit_host_s": ("seconds", ["emit: host"])}
    field, names = spans[name]

    def rollup(i, v):
        return {"assembly": i, "seconds": {}, "cpu_seconds": {}, "calls": {}, "counters": {},
                field: {n: v * (j + 1) for j, n in enumerate(names)}}

    hist = [rollup(i, v) for i, v in enumerate([100.0, 1.0, 2.0, 6.0])]
    read = _reader(name)
    ctx = {"stages": [{}] * 3}
    monkeypatch.setattr(trace, "history", lambda: list(hist))
    want = sum(v * (j + 1) for v in (1.0, 2.0, 6.0) for j in range(len(names))) / 3
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    assert read({"stages": [{}] * 5}) is None
    monkeypatch.setattr(trace, "history", lambda: [])
    assert read(ctx) is None and read({"stages": []}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_real_window(name, assemblies):
    """After an assembly, each reader reads its own spans of the last one."""
    res = assemble_codes(_codes(), BASE, "cpu")
    roll = res.trace.rollup()
    assert trace.history()[-1] == roll
    value = _reader(name)({"stages": [res.stage_seconds]})
    field = "cpu_seconds" if name == "pack_cpu_s" else "seconds"
    names = {"pack_s": ["feed: pack"], "pack_cpu_s": ["feed: pack"], "walk_s": ["graph: walk", "graph: sync"],
             "emit_copy_s": ["emit: copy"], "emit_host_s": ["emit: host"]}[name]
    assert value == sum(roll[field][n] for n in names) and value >= 0
    if name == "walk_s":
        assert value <= res.stage_seconds["graph"]
    if name in ("emit_copy_s", "emit_host_s"):
        assert value <= res.stage_seconds["extract"]


def test_the_tracer_holds_no_tensor(assemblies):
    """Nothing a span or a rollup keeps is a tensor (no device memory held,
    no event, no stream)."""
    res = assemblies[1]["oneshot"]
    held = [x for rec in res.trace.spans for x in rec] + [v for rec in res.trace.spans for v in rec[-1].values()]
    assert not any(isinstance(x, (torch.Tensor, torch.cuda.Event, torch.cuda.Stream)) for x in held)
    assert json.dumps(res.trace.to_json()) and json.dumps(trace.history()[-1])


def test_threads_lose_no_span_or_count():
    """More threads than cores record into one trace and count at once,
    with the interpreter switching threads as often as it can: every span
    and every count arrives, each span under its own thread's parent."""
    import os
    import sys

    n_threads, n = 2 * (os.cpu_count() or 4), 300
    before = trace.totals()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.assembly() as tr:

            def work():
                for i in range(n):
                    with tr.span("feed: pack", batch=i) as outer:
                        with tr.span("feed: copy issue", batch=i):
                            assert tr._stacks[threading.get_ident()][1][-2] == outer._id
                    tr.add("batches")
                    tr.add("h2d_bytes", 3)

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(saved)
    recs = tr.records()
    assert len(recs) == 2 * n_threads * n + 1 and len({r["id"] for r in recs}) == len(recs)
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == "feed: copy issue":
            parent = by_id[r["parent"]]
            assert (parent["name"], parent["thread"], parent["attrs"]) == ("feed: pack", r["thread"], r["attrs"])
        elif r["name"] == "feed: pack":
            assert r["parent"] == tr.root
    assert tr.counters["batches"] == n_threads * n and tr.counters["h2d_bytes"] == 3 * n_threads * n
    grew = trace.since(before)
    assert (grew["batches"], grew["h2d_bytes"]) == (n_threads * n, 3 * n_threads * n)


@pytest.mark.parametrize("k, rows", [(41, 1000), (77, 777), (95, 64)])
def test_key_sort_counters_count_a_multi_word_sort(k, rows):
    """A sort of W-word keys counts one call, W stable passes and rows * W
    sorted rows, in the assembly's counters and in the process totals."""
    from tpu_euler_torch.kmer import keys

    W = keys.nwords(k)
    w = torch.randint(0, 1 << 40, (rows, W), generator=torch.Generator().manual_seed(k))
    before = trace.totals()
    with trace.assembly() as tr:
        s, perm = keys.sort(w)
    want = {"key_sorts": 1, "key_sort_passes": W, "key_sort_rows": rows * W}
    assert {name: tr.counters[name] for name in want} == want
    assert {name: trace.since(before)[name] for name in want} == want
    assert trace.history()[-1]["counters"]["key_sort_rows"] == rows * W
    assert torch.equal(s, w[perm]) and bool(keys.key_less(s[1:], s[:-1]).logical_not().all())


def test_one_word_sorts_leave_the_key_sort_counters_at_zero():
    from tpu_euler_torch.kmer import keys

    with trace.assembly() as tr:
        keys.sort(torch.arange(500, 0, -1))
    assert [tr.counters[n] for n in ("key_sorts", "key_sort_passes", "key_sort_rows")] == [0, 0, 0]


def test_a_key_sort_counter_reads_nothing_from_the_device(monkeypatch):
    """The counts come from the keys' shape: no tensor is read to the host
    (a read there would be a sync on the card)."""
    from tpu_euler_torch.kmer import keys

    w = torch.randint(0, 1 << 40, (300, 3), generator=torch.Generator().manual_seed(5))

    def no_read(*a, **kw):
        raise AssertionError("a tensor was read to the host")

    for name in ("item", "tolist", "__int__", "__bool__", "__index__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    monkeypatch.setattr(torch.cuda, "synchronize", no_read)
    with trace.assembly() as tr:
        keys.sort(w)
    monkeypatch.undo()
    assert tr.counters["key_sort_rows"] == 900


@pytest.mark.parametrize("k, read_len", [(31, 100), (41, 100), (77, 150)])
def test_assembly_counts_its_key_sorts_and_names_its_words(k, read_len):
    """An assembly's rollup holds the key-sort counters: every multi-word
    sort of the grouped count, the graph build and the transition keys;
    none at one word. The drains and the graph build carry the key's word
    count."""
    from tpu_euler_torch.kmer import keys

    codes = simulate_read_codes(random_genome(4000, seed=43), read_len=read_len, coverage=20, seed=44, circular=True)
    W = keys.nwords(k)
    cfg = AssemblyConfig(k=k, read_batch=128, read_len=read_len, spectrum_capacity=1 << 14,
                         oneshot_rows=2 * 128 * (read_len - k + 1))
    res = assemble_codes(codes, cfg, "cpu")
    c = res.trace.counters
    recs = res.trace.records()
    drains = [r for r in recs if r["name"] == "count: drain"]
    assert len(drains) >= 2 and {r["attrs"]["words"] for r in drains} == {W}
    assert [r["attrs"]["words"] for r in recs if r["name"] == "graph: build"] == [W]
    assert trace.history()[-1]["counters"] == c
    if W == 1:
        assert (c["key_sorts"], c["key_sort_passes"], c["key_sort_rows"]) == (0, 0, 0)
    else:
        # a drain, the endpoint sort and the transition keys' rank each sort once at least
        assert c["key_sorts"] >= len(drains) + 2 and c["key_sort_passes"] == W * c["key_sorts"]
        assert c["key_sort_rows"] % W == 0 and c["key_sort_rows"] >= W * len(drains) * cfg.spectrum_capacity
