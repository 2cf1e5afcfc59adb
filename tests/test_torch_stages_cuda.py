"""Path M's stage spans on the card (``-m cuda``; each test skips where
there is no card):

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_stages_cuda.py

* a profiled query at k 8,000 (the second of a session, past the
  profiler's first-use cost) gives every stage span a device time from
  its CUDA events, the children within their parents, and the solve's
  three stages (``decode.*``, the scatter of the workers' slots in
  ``decode.gather``) sum to within 3% of ``pathm.decode``: on the
  deployment's own mask, and with 20 of the fast workers out (e ~1,700,
  an LU that holds the card); a profiled query with nothing erased still
  records all six spans, ``decode.gather`` with ``erased`` and ``size``
  0;
* an ``ErasureDecoder`` at a serve head's size, bound to the static
  reduced solve, captured in a CUDA graph inside an open ``pathm.query`` while a
  profiler records, adds no stage of its own to ``STAGES``, and its
  replays equal the eager solve bit for bit;
* the static reduced solve, as the serve head calls it, runs under
  ``torch.cuda.set_sync_debug_mode("error")``: it never waits for the
  host; a Path M query, after a warm-up, syncs with the host exactly once
  (counted under ``"warn"``): the read of e that sizes its solve;
* at Path M's k 20,000 with n - k systematic rows erased (exactly k
  survive, the sized system at its cap c, 6,980 x 6,980), the reduced
  solve's error against A x in float64 is within 30x that of the general
  (k, k) solve on the same rows (a pipeline whose decoder was bound
  reading G as not systematic).
"""
import warnings
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.coded_matvec import DecodePipeline, pack_coded_matrix
from repro_torch.core import coding
from repro_torch.core.coding import ErasureDecoder, encode, make_generator
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.runtime.executor import CodedRoundExecutor

pytestmark = pytest.mark.cuda

K, D = 8000, 1024
STAGE_NAMES = ("pathm.query", "pathm.products", "pathm.decode", "decode.gather", "decode.lu",
               "decode.trisolve")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def deployment(card):
    exe = CodedRoundExecutor(ClusterSpec.make([40, 60, 100], [8.0, 2.0, 0.5], 1.0), K,
                             "optimal", deadline_safety=3.0, device="cuda")
    plan = exe.plan
    g = make_generator(plan.n, plan.k, seed=1, device="cuda")
    a = torch.randn((K, D), generator=torch.Generator(device="cuda").manual_seed(2),
                    device="cuda")
    packed, row_of = pack_coded_matrix(g, a, plan)
    mask = exe.finish_mask(torch.Generator(device="cuda").manual_seed(3))
    return plan, g, packed, row_of, mask


def _profiled(pipe, packed, x, mask) -> dict:
    """Device seconds by stage of the second of two profiled queries."""
    pipe(packed, x, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pipe(packed, x, mask)
        before = len(trace.STAGES.spans)
        pipe(packed, x, mask)
        torch.cuda.synchronize()
    spans = list(trace.STAGES.spans)[before:]
    assert sorted(s.name for s in spans) == sorted(STAGE_NAMES)
    return {s.name: s.device_s for s in spans}


def test_profiled_query_times_every_stage_on_the_card(deployment):
    plan, g, packed, row_of, mask = deployment
    x = torch.randn(D, device="cuda")
    pipe = DecodePipeline(g, row_of)
    for m in (mask, torch.where(torch.arange(plan.num_workers, device="cuda") < 20, False,
                                mask)):
        dev = _profiled(pipe, packed, x, m)
        assert all(v > 0 for v in dev.values()), dev
        solve = dev["decode.gather"] + dev["decode.lu"] + dev["decode.trisolve"]
        assert 0.97 * dev["pathm.decode"] <= solve <= dev["pathm.decode"] * 1.0001, dev
        assert dev["pathm.products"] + dev["pathm.decode"] <= dev["pathm.query"] * 1.0001, dev


def test_a_captured_solve_records_no_stage_and_replays(card):
    n, k = 312, 250
    g = make_generator(n, k, seed=4, device="cuda")
    y = torch.randn(n, device="cuda")
    fin = torch.ones(n, dtype=torch.bool, device="cuda")
    fin[: n - k - 7] = False
    decoder = ErasureDecoder(g)
    assert decoder.path == "reduced"
    want, want_ok = decoder(y, fin)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decoder(y, fin)  # warm up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = list(trace.STAGES.spans)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with trace.stage("pathm.query", g.device, root=True):
            with torch.cuda.graph(graph):
                z, ok = decoder(y, fin)
        torch.cuda.synchronize()
    assert [s.name for s in list(trace.STAGES.spans)[len(before):]] == ["pathm.query"]
    for _ in range(2):
        z.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(z, want) and bool(ok) == bool(want_ok)


def test_a_profiled_query_with_nothing_erased_records_every_stage(deployment):
    plan, g, packed, row_of, _ = deployment
    x = torch.randn(D, device="cuda")
    everyone = torch.ones(plan.num_workers, dtype=torch.bool, device="cuda")
    pipe = DecodePipeline(g, row_of)
    want, want_ok = pipe(packed, x, everyone)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        before = len(trace.STAGES.spans)
        z, ok = pipe(packed, x, everyone)
        torch.cuda.synchronize()
    spans = list(trace.STAGES.spans)[before:]
    assert sorted(s.name for s in spans) == sorted(STAGE_NAMES)
    gather, = [s for s in spans if s.name == "decode.gather"]
    assert gather.host_attrs == {"erased": 0, "size": 0}
    assert all(s.device_s >= 0 for s in spans)
    assert bool(ok) and bool(want_ok) and torch.equal(z, want)


def test_the_static_reduced_solve_does_not_sync_with_the_host(card):
    n, k, cols = 312, 250, 4 * 1024  # yi-9b's coded head: nb, kb, B x R
    g = make_generator(n, k, seed=4, device="cuda")
    y = torch.randn((n, cols), device="cuda")
    fin = torch.ones(n, dtype=torch.bool, device="cuda")
    fin[: n - k - 7] = False
    decoder = ErasureDecoder(g)  # the bind's one host read, outside the check
    assert decoder.path == "reduced"
    want, want_ok = decoder(y, fin)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        z, ok = decoder(y, fin)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(z, want) and bool(ok) == bool(want_ok)


def test_a_query_syncs_with_the_host_once(deployment):
    plan, g, packed, row_of, mask = deployment
    x = torch.randn(D, device="cuda")
    pipe = DecodePipeline(g, row_of)
    assert pipe.decoder.path == "reduced"
    want, want_ok = pipe(packed, x, mask)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            z, ok = pipe(packed, x, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, syncs
    assert torch.equal(z, want) and bool(ok) == bool(want_ok)


def test_the_reduced_solve_at_path_m_size_with_exactly_k_survivors(card):
    k, n, d, load = 20000, 26980, 64, 20  # 1,349 workers of 20 rows
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = make_generator(n, k, seed=6, device="cuda")
    a = torch.randn((k, d), generator=gen, device="cuda")
    x = torch.randn(d, generator=gen, device="cuda")
    packed = encode(g, a).reshape(n // load, load, d)
    row_of = torch.arange(n, dtype=torch.int32, device="cuda").reshape(n // load, load)
    fin = torch.ones(n // load, dtype=torch.bool, device="cuda")
    fin[: (n - k) // load] = False  # rows 0..6,979: n - k systematic rows
    want = (a.double() @ x.double())
    pipe = DecodePipeline(g, row_of)
    assert pipe.decoder.path == "reduced"
    at_cap = REGISTRY.counter("erasure_solve_rows", size=n - k)
    before = at_cap.value
    z, ok = pipe(packed, x, fin)
    assert at_cap.value == before + 1
    with mock.patch.object(coding, "is_systematic", lambda _: False):
        general = DecodePipeline(g, row_of)
    assert general.decoder.path == "general"
    z_full, ok_full = general(packed, x, fin)
    assert bool(ok) and bool(ok_full)
    err, err_full = (z.double() - want).norm(), (z_full.double() - want).norm()
    assert err <= 30 * err_full, (float(err), float(err_full), float(want.norm()))
