"""The port's cost-based planner and advisor against the JAX package's.

Mirrors ``tests/test_advisor_plan.py``: ``profile_query`` and the peak
bounds give the JAX package's numbers; ``plan`` reports are equal field
by field for the same ``Throughputs`` and crossover table, with the one
name mapping below; ``render_plan_report`` gives the same text; a plan
report written by either package loads in the other; ``extract(plan=)``
and ``sharded_extract_to_device(plan=)`` give the graphs and uploads of
the unplanned build; ``'scatter'`` packing is byte-identical to
``'reduceat'`` and to the JAX package's; ``measure_pack_throughput``
follows an injected clock; ``recommend`` is equal with and without a
table; and the README's quickstart for the port runs on the CPU.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from repro.core import ExtractionBudget as RefBudget
from repro.core import cost as ref_cost
from repro.core import advisor as ref_advisor
from repro.core import dedup as ref_dedup
from repro.core.condensed import BipartiteEdges as RefEdges
from repro.core.serialize import load_plan_report as ref_load_report
from repro.core.serialize import save_plan_report as ref_save_report
from repro.data import synth as ref_synth
from repro.kernels import autotune as ref_autotune
from repro.kernels import pack as ref_pack

from repro_torch.core import (
    ExtractionBudget,
    PlanConfig,
    PlanReport,
    Throughputs,
    dedup,
    engine,
    extract,
    graphs_identical,
    plan,
    profile_query,
    recommend,
)
from repro_torch.core import cost
from repro_torch.core.condensed import BipartiteEdges
from repro_torch.core.serialize import load_plan_report, save_plan_report
from repro_torch.data import synth
from repro_torch.data.pipeline import sharded_extract_to_device
from repro_torch.kernels import autotune, pack
from repro_torch.launch.report import main as report_main
from repro_torch.launch.report import render_plan_report

ROOT = Path(__file__).resolve().parents[1]

Q_DBLP = """
Nodes(ID, Name) :- Author(ID, Name).
Edges(ID1, ID2) :- AuthorPub(ID1, PubID), AuthorPub(ID2, PubID).
"""
Q_TPCH = """
Nodes(ID, Name) :- Customer(ID, Name).
Edges(ID1, ID2) :- Orders(ok1, ID1), LineItem(ok1, pk),
                   Orders(ok2, ID2), LineItem(ok2, pk).
"""
Q_UNIV = """
Nodes(ID, Name) :- Instructor(ID, Name).
Nodes(ID, Name) :- Student(ID, Name).
Edges(ID1, ID2) :- TaughtCourse(ID1, courseId), TookCourse(ID2, courseId).
"""

FIXTURES = {
    "dblp": (lambda m: m.dblp_catalog(150, 300, 3.0, seed=0), Q_DBLP),
    "tpch": (lambda m: m.tpch_catalog(80, 300, 30, 3.0, seed=0), Q_TPCH),
    "univ": (lambda m: m.univ_catalog(15, 120, 25, 3.0, seed=0), Q_UNIV),
}

# The only text that differs between the two packages' reports: the
# fused-config prune reason names the backends (segment / CUDA for the
# JAX package's XLA / Pallas).
NAME_MAP = {
    "measured CrossoverTable prefers XLA in every cell: the fused Pallas "
    "epilogue stands down at dispatch":
    "measured CrossoverTable prefers the segment path in every cell: the "
    "fused CUDA epilogue stands down at dispatch",
}


def _mapped(doc):
    """A JAX-package report dict with its backend names mapped to the
    port's."""
    if isinstance(doc, dict):
        return {k: _mapped(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mapped(v) for v in doc]
    if isinstance(doc, str):
        return NAME_MAP.get(doc, doc)
    return doc


def _tables(cuda_us, segment_us, n_src=60, feats=128):
    """One measured ``'sum'`` cell in each package's table."""
    key = ("sum", autotune.src_bucket(n_src), autotune.batch_bucket(feats))
    port = autotune.CrossoverTable.from_entries(
        {key: autotune.CrossoverEntry(cuda_us=cuda_us, segment_us=segment_us)})
    ref = ref_autotune.CrossoverTable.from_entries(
        {key: ref_autotune.CrossoverEntry(pallas_us=cuda_us, xla_us=segment_us)})
    return port, ref


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_profile_and_bounds_equal_reference(name):
    make, q = FIXTURES[name]
    prof = profile_query(make(synth), q)
    rprof = ref_cost.profile_query(make(ref_synth), q)
    assert dataclasses.asdict(prof) == dataclasses.asdict(rprof)
    for n in (1, 2, 4, 7):
        assert cost.peak_resident_rows_bound(prof, n) == ref_cost.peak_resident_rows_bound(rprof, n)
        assert cost.peak_transient_bytes_bound(prof, n) == ref_cost.peak_transient_bytes_bound(rprof, n)
        assert cost.assembly_account_bounds(prof, n) == ref_cost.assembly_account_bounds(rprof, n)
        for f in (1.5, 4.0):
            assert dataclasses.asdict(prof.scaled(f)) == dataclasses.asdict(rprof.scaled(f))
    assert (cost.HOST_MEM_BW, cost.HOST_DISK_BW) == (ref_cost.HOST_MEM_BW, ref_cost.HOST_DISK_BW)
    assert dataclasses.asdict(Throughputs()) == dataclasses.asdict(ref_cost.Throughputs())


PLAN_CASES = [
    ("dblp", {}, None),
    ("tpch", {}, None),
    ("univ", {}, None),
    ("dblp", {"budget": (20_000, None)}, None),
    ("dblp", {"budget": (None, 300_000)}, None),
    ("univ", {"pack": {"reduceat": 1e5, "scatter": 9e6}}, None),
    ("univ", {}, (100.0, 10.0)),   # the kernel loses everywhere
    ("univ", {}, (1.0, 10.0)),
]


@pytest.mark.parametrize("name,opts,table", PLAN_CASES)
def test_plan_reports_equal_reference(name, opts, table):
    make, q = FIXTURES[name]
    kw, rkw = {}, {}
    if "budget" in opts:
        rows, nbytes = opts["budget"]
        kw["budget"] = ExtractionBudget(max_resident_rows=rows, max_assembly_bytes=nbytes)
        rkw["budget"] = RefBudget(max_resident_rows=rows, max_assembly_bytes=nbytes)
    if "pack" in opts:
        kw["throughputs"] = Throughputs.with_measured_pack(opts["pack"])
        rkw["throughputs"] = ref_cost.Throughputs.with_measured_pack(opts["pack"])
    if table is not None:
        kw["crossover"], rkw["crossover"] = _tables(*table)
    report = plan(make(synth), q, **kw)
    want = ref_cost.plan(make(ref_synth), q, **rkw)
    assert report.to_json_dict() == _mapped(want.to_json_dict())
    assert report.render() == _mapped_text(want.render())
    assert render_plan_report(report.to_json_dict()) == report.render()
    if table == (100.0, 10.0):
        assert all(not c.fuse_correction for c, _ in report.ranked)
        assert any("stands down" in p.reason for p in report.pruned)


def _mapped_text(text):
    for a, b in NAME_MAP.items():
        text = text.replace(a, b)
    return text


def test_no_feasible_plan_raises_as_reference():
    make, q = FIXTURES["dblp"]
    with pytest.raises(ValueError) as ep:
        plan(make(synth), q, budget=ExtractionBudget(max_resident_rows=10))
    with pytest.raises(ValueError) as er:
        ref_cost.plan(make(ref_synth), q, budget=RefBudget(max_resident_rows=10))
    assert str(ep.value) == str(er.value)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_report_files_load_in_both_packages(writer, tmp_path):
    make, q = FIXTURES["univ"]
    report = plan(make(synth), q)
    want = ref_cost.plan(make(ref_synth), q)
    path = str(tmp_path / "plan.json")
    (save_plan_report if writer == "port" else ref_save_report)(
        report if writer == "port" else want, path)
    assert load_plan_report(path) == report
    assert ref_load_report(path) == want
    assert PlanReport.from_json(report.to_json()) == report


def test_report_cli_prints_the_rendered_plan(tmp_path, capsys):
    make, q = FIXTURES["dblp"]
    report = plan(make(synth), q)
    path = str(tmp_path / "plan.json")
    save_plan_report(report, path)
    assert report_main([path]) == 0
    assert capsys.readouterr().out.strip() == report.render().strip()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_extract_with_plan_is_identical(name, tmp_path):
    """Every ranked plan executes to the unplanned graph, as the JAX
    package's plans do, spilling ones through a temporary directory."""
    make, q = FIXTURES[name]
    cat = make(synth)
    want = extract(cat, q).graph
    report = plan(cat, q)
    seen = set()
    for cfg, _ in report.ranked:
        key = (cfg.n_shards, cfg.spill, cfg.merge_arity)
        if key in seen:
            continue
        seen.add(key)
        p = dataclasses.replace(report.chosen, config=cfg)
        res = extract(cat, q, plan=p)
        assert graphs_identical(res.graph, want), cfg
        if cfg.n_shards > 1:
            assert res.n_shards == cfg.n_shards
    assert graphs_identical(report.chosen.execute(cat).graph, want)


def test_sharded_upload_with_plan_matches_unplanned():
    make, q = FIXTURES["dblp"]
    cat = make(synth)
    report = plan(cat, q, throughputs=Throughputs.with_measured_pack(
        {"reduceat": 1e5, "scatter": 9e6}))
    assert report.chosen.config.pack_method == "scatter"
    res, dev = sharded_extract_to_device(cat, q, n_shards=5, packed=True,
                                         plan=report.chosen, device="cpu")
    g = extract(cat, q).graph
    assert graphs_identical(res.graph, g)
    want = engine.to_device_packed(g, correction=dedup.build_correction_streaming(g),
                                   device="cpu")
    _same_tensors(dev, want)


def _same_tensors(a, b):
    import torch

    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name not in ("plans", "correction_plans"):
                _same_tensors(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tensors(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("shard_edges", [None, 97])
@pytest.mark.parametrize("n_src,n_dst,n_edges", [(300, 260, 4000), (130, 1, 50), (5, 7, 0)])
def test_scatter_pack_byte_identical(n_src, n_dst, n_edges, shard_edges):
    rng = np.random.default_rng(n_edges)
    key = rng.choice(n_src * n_dst, size=min(n_edges, n_src * n_dst), replace=False)
    e = BipartiteEdges(key % n_src, key // n_src, n_src, n_dst)
    got = pack.pack_bipartite(e, method="scatter", shard_edges=shard_edges)
    for want in (pack.pack_bipartite(e, shard_edges=shard_edges),
                 ref_pack.pack_bipartite(RefEdges(key % n_src, key // n_src, n_src, n_dst),
                                         method="scatter")):
        for f in ("slot_src", "slot_row", "bitmaps", "row_start", "row_count"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    if n_edges:
        dup = BipartiteEdges(np.r_[e.src, e.src[:1]], np.r_[e.dst, e.dst[:1]], n_src, n_dst)
        with pytest.raises(ValueError, match="duplicate-free"):
            pack.pack_bipartite(dup, method="scatter")
    with pytest.raises(ValueError, match="unknown pack method"):
        pack.pack_bipartite(e, method="bogus")


def test_measure_pack_throughput_under_injected_clock():
    rng = np.random.default_rng(3)
    key = rng.choice(50 * 60, size=400, replace=False)
    e = BipartiteEdges(key % 50, key // 50, 50, 60)
    re_ = RefEdges(key % 50, key // 50, 50, 60)
    script = [1e-4, 1e-4, 1e-2, 1e-4]
    it, rit = iter(script), iter(script)
    fast = pack.measure_pack_throughput(e, time_fn=lambda fn: next(it))
    rfast = ref_pack.measure_pack_throughput(re_, time_fn=lambda fn: next(rit))
    slow = pack.measure_pack_throughput(e, time_fn=lambda fn: next(it))
    rslow = ref_pack.measure_pack_throughput(re_, time_fn=lambda fn: next(rit))
    assert (fast, slow) == (rfast, rslow)
    assert fast["reduceat"] == pytest.approx(400 / 1e-4)
    calls = []
    pack.measure_pack_throughput(e, methods=("scatter",),
                                 time_fn=lambda fn: calls.append(fn()) or 1.0)
    assert len(calls) == 1 and calls[0].n_slots > 0
    measured = pack.measure_pack_throughput(e, repeats=1)
    assert set(measured) == {"reduceat", "scatter"} and min(measured.values()) > 0
    tp = Throughputs.with_measured_pack(slow)
    prof = profile_query(FIXTURES["dblp"][0](synth), Q_DBLP)
    red = cost.plan_cost(prof, PlanConfig(pack_method="reduceat"), tp)
    sca = cost.plan_cost(prof, PlanConfig(pack_method="scatter"), tp)
    assert sca.pack_s < red.pack_s


def _membership(seed, n_real, n_virt, avg):
    rng = np.random.default_rng(seed)
    return [set(rng.choice(n_real, size=min(max(2, int(rng.poisson(avg))), n_real),
                           replace=False).tolist()) for _ in range(n_virt)]


def _rec_fields(r):
    d = dataclasses.asdict(r)
    d.pop("expansion_accounting")
    return d


@pytest.mark.parametrize("table", [None, (1.0, 10.0), (100.0, 10.0)])
@pytest.mark.parametrize("workload", ["multi_pass", "repeated", "point"])
@pytest.mark.parametrize("sets", [(11, 60, 30, 3.0), (4, 8, 4, 1.0)])
def test_recommend_equal_reference(sets, workload, table):
    seed, n_real, n_virt, avg = sets
    members = _membership(seed, n_real, n_virt, avg)
    if avg == 1.0:  # disjoint pairs: no expansion, the ladder picks EXP
        members = [{0, 1}, {2, 3}, {4, 5}, {6, 7}]
    g = dedup.graph_from_membership(n_real, members)
    rg = ref_dedup.graph_from_membership(n_real, members)
    pt, rt = (None, None) if table is None else _tables(*table, n_src=n_real)
    got = recommend(g, workload=workload, crossover=pt)
    want = ref_advisor.recommend(rg, workload=workload, crossover=rt)
    assert _rec_fields(got) == _rec_fields(want)
    assert dataclasses.asdict(got.expansion_accounting) == dataclasses.asdict(
        want.expansion_accounting)
    if table is not None:
        assert cost.device_representation_costs(1.5, 0.7, pt, n_real) == \
            ref_cost.device_representation_costs(1.5, 0.7, rt, n_real)
    assert cost.device_representation_costs(1.5, 0.7, None, n_real) is None


def test_readme_port_quickstart_runs_on_cpu(tmp_path, monkeypatch):
    """The README's quickstart for the port, run as written with the CPU
    as the device (in a scratch directory: it writes a delta log)."""
    monkeypatch.chdir(tmp_path)
    text = (ROOT / "README.md").read_text()
    blocks = re.findall(r"```python\n(.*?)```", text, flags=re.S)
    code = next(b for b in blocks if "from repro_torch.core import" in b
                and "recommend" in b)
    code = code.replace('DEVICE = "cuda"', 'DEVICE = "cpu"')
    assert 'DEVICE = "cpu"' in code
    scope = {}
    exec(compile(code, "README.md", "exec"), scope)
    assert graphs_identical(scope["g_planned"], scope["g"])
    assert scope["after"][2].shape == (scope["g"].n_real,)
    assert scope["tier"].tenants["coauthor"].version == 1
