"""Path M's stage spans (``obs.trace.stage``, ``obs.trace.STAGES``) on the
CPU: off without a profiler, the master step's tree of spans under one,
and the same bits either way.

* with no profiler session, ``stage`` is the shared no-op and a query
  adds nothing to ``STAGES``; under one, a solve outside a query (the
  serve head's) adds nothing either;
* under ``torch.profiler`` one query records ``pathm.query`` ->
  ``pathm.products``, ``pathm.decode`` -> ``decode.gather``,
  ``decode.lu``, ``decode.trisolve``, with ids and parent ids that match
  the names, a device time on each (its host duration on the CPU), and each span a ``user_annotation`` of the
  profiler's Chrome trace; through ``__call__`` and ``on_block`` of a
  one-rank ``workers`` mesh too;
* a query counts one decode in ``REGISTRY``'s ``erasure_decodes`` on the
  path its pipeline's decoder bound (reduced for the seeded systematic G,
  general for a G that is not),
  and the reduced path's ``decode.gather`` carries the mask's count of
  erased systematic rows as ``erased`` and the system's rows (e rounded up
  to 128, at most n - k; 0: no solve) as ``size``, which the query also
  counts once in ``erasure_solve_rows``;
* ``z`` and ``ok`` are bit-identical with and without the profiler.
"""
import json

import pytest
import torch
from torch.profiler import profile

from repro_torch.core.coded_matvec import DecodePipeline, pack_coded_matrix
from repro_torch.core.coding import SIZE_STEP, decode_systematic, make_generator
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.launch.mesh import destroy_local_mesh, make_workers_mesh
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.runtime.executor import CodedRoundExecutor

K, D = 96, 64
TREE = {"pathm.query": None, "pathm.products": "pathm.query", "pathm.decode": "pathm.query",
        "decode.gather": "pathm.decode", "decode.lu": "pathm.decode",
        "decode.trisolve": "pathm.decode"}


@pytest.fixture(scope="module")
def deployment():
    exe = CodedRoundExecutor(ClusterSpec.make([4, 4], [4.0, 1.0], 1.0), K, "optimal",
                             deadline_safety=3.0, device="cpu")
    plan = exe.plan
    g = make_generator(plan.n, plan.k, seed=3, device="cpu")
    a = torch.randn((K, D), generator=torch.Generator().manual_seed(4))
    packed, row_of = pack_coded_matrix(g, a, plan)
    return plan, g, packed, row_of


def _gather_attrs(plan, row_of, mask) -> dict:
    """``decode.gather``'s attributes on the sized reduced path: e, the
    erased workers' systematic rows, and the system's rows (0 where fewer
    than k rows survive)."""
    lost = row_of[~mask]  # the erased workers' coded rows, -1 in pads
    e = int(((lost >= 0) & (lost < plan.k)).sum())
    size = min(-(-e // SIZE_STEP) * SIZE_STEP, plan.n - plan.k)
    return {"erased": e, "size": size if int((row_of[mask] >= 0).sum()) >= plan.k else 0}


def _inputs(plan, erased: int):
    x = torch.randn(D, generator=torch.Generator().manual_seed(5))
    mask = torch.ones(plan.num_workers, dtype=torch.bool)
    mask[:erased] = False
    return x, mask


def test_no_profiler_no_stage_span(deployment):
    plan, g, packed, row_of = deployment
    x, mask = _inputs(plan, 1)
    assert trace.stage("pathm.query", x.device, root=True) is trace._NULL_SPAN
    before = list(trace.STAGES.spans)
    DecodePipeline(g, row_of)(packed, x, mask)
    assert list(trace.STAGES.spans) == before


def test_a_solve_outside_a_query_records_nothing(deployment):
    plan, g, packed, row_of = deployment
    y = torch.randn(plan.n, generator=torch.Generator().manual_seed(6))
    fin = torch.ones(plan.n, dtype=torch.bool)
    before = list(trace.STAGES.spans)
    with profile():
        assert trace.stage("decode.lu", y.device) is trace._NULL_SPAN
        decode_systematic(g, y, fin)
    assert list(trace.STAGES.spans) == before


@pytest.mark.parametrize("path", ["call", "mesh-call", "mesh-block"])
def test_a_profiled_query_records_the_stage_tree(deployment, tmp_path, path):
    plan, g, packed, row_of = deployment
    x, mask = _inputs(plan, 1)
    mesh = make_workers_mesh(device="cpu") if path != "call" else None
    try:
        pipe = DecodePipeline(g, row_of, mesh=mesh)
        pipe(packed, x, mask)
        before = len(trace.STAGES.spans)
        with profile() as prof:
            if path == "mesh-block":
                pipe.on_block(packed, x, mask)
            else:
                pipe(packed, x, mask)
    finally:
        if mesh is not None:
            destroy_local_mesh()
    spans = list(trace.STAGES.spans)[before:]
    assert sorted(s.name for s in spans) == sorted(TREE)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(TREE)
    for s in spans:
        want = TREE[s.name]
        assert s.parent == want
        assert (s.parent_id is None) == (want is None)
        if want is not None:
            assert by_id[s.parent_id].name == want
        assert isinstance(s, trace.StageSpan) and s.device_s == s.dur_s > 0
        if s.name == "decode.gather":  # the reduced solve's e and its system's rows
            assert s.host_attrs == _gather_attrs(plan, row_of, mask)
        else:
            assert s.attrs == {}
    summ = trace.STAGES.summary()
    assert all(summ[name]["count"] >= 1 for name in TREE)
    path_json = tmp_path / "t.pt.trace.json"
    prof.export_chrome_trace(str(path_json))
    events = json.loads(path_json.read_text())["traceEvents"]
    notes = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(n for n in notes if n in TREE) == sorted(TREE)


@pytest.mark.parametrize("erased", [0, 1, 3])
@pytest.mark.parametrize("systematic", [True, False], ids=["reduced", "general"])
def test_a_query_counts_its_path_and_the_erased_rows(deployment, erased, systematic):
    plan, g, packed, row_of = deployment
    x, mask = _inputs(plan, erased)
    if not systematic:  # the same code with its top block mixed: not [I; P]
        mix = torch.randn((K, K), generator=torch.Generator().manual_seed(7))
        g = g @ torch.linalg.qr(mix)[0]
        packed, row_of = pack_coded_matrix(g, torch.randn((K, D)), plan)
    pipe = DecodePipeline(g, row_of)
    path = "reduced" if systematic else "general"
    assert pipe.decoder.path == path
    counts = lambda: {p: REGISTRY.counter("erasure_decodes", path=p).value  # noqa: E731
                      for p in ("reduced", "general")}
    sizes = lambda: {r["labels"]["size"]: r["value"] for r in REGISTRY.snapshot()  # noqa: E731
                     if r["name"] == "erasure_solve_rows"}
    before, rows = counts(), sizes()
    with profile():
        n0 = len(trace.STAGES.spans)
        pipe(packed, x, mask)
    assert counts() == {p: v + (p == path) for p, v in before.items()}
    gather, = [s for s in list(trace.STAGES.spans)[n0:] if s.name == "decode.gather"]
    want = _gather_attrs(plan, row_of, mask) if systematic else {}
    assert gather.host_attrs == want
    grew = {s: v - rows.get(s, 0) for s, v in sizes().items() if v != rows.get(s, 0)}
    assert grew == ({want["size"]: 1} if systematic else {})


def test_plain_span_ids_nest():
    tracer = trace.SpanTracer()
    with tracer.span("adapt_update"):
        with tracer.span("replan"):
            pass
        with tracer.span("replan"):
            pass
    first, second, outer = tracer.spans
    assert outer.parent_id is None and first.parent_id == second.parent_id == outer.id
    assert len({first.id, second.id, outer.id}) == 3
    assert not isinstance(outer, trace.StageSpan)
    assert tracer.summary()["replan"]["count"] == 2


@pytest.mark.parametrize("erased", [0, 1, 8], ids=["all", "one-erased", "too-few"])
def test_z_and_ok_bit_identical_under_the_profiler(deployment, erased):
    plan, g, packed, row_of = deployment
    x, mask = _inputs(plan, erased)
    pipe = DecodePipeline(g, row_of)
    z0, ok0 = pipe(packed, x, mask)
    with profile():
        z1, ok1 = pipe(packed, x, mask)
    assert torch.equal(z0, z1) and bool(ok0) == bool(ok1) == (erased < 8)
