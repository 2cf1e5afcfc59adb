"""Dispatch programs captured as CUDA graphs against the same program
functions uncaptured (``Server._capture = False``), on the card.

Marked ``cuda``: they skip on a machine without CUDA. Run them on the
card with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_programs_cuda.py

Reduced qwen3-0.6b, seeded weights, the serve fleet's shape and a
deadline that erases workers: the paged and the dense serve give the
same streams, decode-ok and erased rounds captured and uncaptured, with
the same B1 and B2 launch counts (a replay adds the launches its capture
recorded); ``generate`` gives the same tokens, logits and finish masks
for two seeds; a captured server captures again only after a structural
replan, never after a bucket switch, and keeps the serve state of one
shape; a profile replays graphs captured before an earlier profiler
session (in a child process, so that a crash fails the test).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.kernels as kernels
from repro_torch.configs import ARCHS
from repro_torch.core.runtime_model import ClusterSpec
from repro_torch.models.model import Model
from repro_torch.runtime.serve_loop import ServeConfig, Server
from repro_torch.serve.workload import make_workload

pytestmark = pytest.mark.cuda

FLEET = ([6, 6], [8.0, 0.7])


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return Model(ARCHS["qwen3-0.6b"].reduced(), device="cuda", seed=0)


def _server(model, captured: bool, **cfg) -> Server:
    server = Server(model, ClusterSpec.make(*FLEET),
                    ServeConfig(block_rows=16, deadline_safety=1.2, **cfg))
    server._capture = captured
    return server


def _trace(model, seed: int, n: int = 8):
    return make_workload("poisson", num_requests=n, prompt_len=(8, 40), out_len=(3, 9),
                         vocab=model.config.vocab_size).trace(seed=seed)


@pytest.mark.parametrize("paged", [True, False])
def test_captured_serve_matches_uncaptured(model, paged):
    trace = _trace(model, 3)
    kw = dict(slots=4, decode_block=3, paged=paged, prompt_cap=40, max_out=9,
              **({"num_blocks": 4 * 4, "block_len": 16, "prefill_chunk": 16} if paged else {}))
    reports, counts = [], []
    for captured in (False, True):
        server = _server(model, captured)
        for _ in range(2):  # the second run replays every key the first built
            kernels.reset_launch_counts()
            reports.append(server.serve(trace, **kw))
            counts.append(kernels.launch_counts())
        if captured:
            assert server.programs.captures == len(server.programs.keys()) > 0
            assert server.programs.replays > 0
    eager, _, first, steady = reports
    for rep in (first, steady, reports[1]):
        assert rep.streams == eager.streams
        assert (rep.decode_ok, rep.erased_rounds) == (eager.decode_ok, eager.erased_rounds)
    assert eager.erased_rounds > 0 and eager.tokens == sum(r.out_len for r in trace)
    for c in counts[1:]:
        assert c == counts[0]
    assert counts[0]["coded_matvec"] == eager.decode_rounds
    assert counts[0]["paged_decode"] == (model.config.num_layers * eager.decode_rounds
                                         if paged else 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_captured_generate_matches_uncaptured(model, seed):
    prompts = np.random.default_rng(seed).integers(0, model.config.vocab_size, (3, 12))
    runs = []
    for captured in (False, True):
        server = _server(model, captured)
        for _ in range(3):  # built, captured and replayed, replayed
            kernels.reset_launch_counts()
            seen = []
            out = server.generate(prompts, 6, seed=seed,
                                  observe=lambda t, lg, sel, ok, mask: seen.append(
                                      (lg.clone(), bool(ok), mask.clone())))
            runs.append((out, seen, kernels.launch_counts()))
        assert server.traces == 1
        assert server.programs.captures == int(captured)
    eager_out, eager_seen, eager_counts = runs[0]
    assert eager_counts["coded_matvec"] == 6
    for out, seen, counts in runs[1:]:
        assert torch.equal(out, eager_out) and counts == eager_counts
        for (lg, ok, mask), (lg0, ok0, mask0) in zip(seen, eager_seen, strict=True):
            assert torch.equal(lg, lg0) and ok == ok0 and torch.equal(mask, mask0)


def test_captured_generate_at_a_two_block_head(model):
    """A head of kb = 2 blocks (vocab 512, R 256): the erasure solve at
    this size stays capturable (``lu_solve`` took MAGMA's batched solve
    here, which a capture refuses)."""
    prompts = np.random.default_rng(3).integers(0, model.config.vocab_size, (4, 8))
    outs = []
    for captured in (False, True):
        server = Server(model, ClusterSpec.make(*FLEET),
                        ServeConfig(block_rows=256, deadline_safety=1.2))
        server._capture = captured
        for _ in range(3):
            out = server.generate(prompts, 4, seed=1)
        assert server.programs.captures == int(captured)
        outs.append(out)
    assert server.coded_head.kb == 2 and torch.equal(outs[0], outs[1])


def test_recaptures_only_after_a_structural_replan(model):
    server = _server(model, True, bucket_quantum=2)
    exe = server.coded_head.executor
    prompts = np.random.default_rng(2).integers(0, model.config.vocab_size, (2, 8))
    trace = _trace(model, 4, n=4)

    def use():
        for _ in range(2):
            server.generate(prompts, 3)
            server.serve(trace, slots=2, decode_block=2)

    use()
    captures, keys = server.programs.captures, len(server.programs.keys())
    assert captures == keys
    exe.replan(ClusterSpec.make([6, 6], [8.0, 0.2]))
    assert not exe.last_replan_structural
    server.refresh_coded_head()
    use()
    assert server.programs.captures == captures  # a bucket switch keeps every graph
    exe.replan(ClusterSpec.make([6, 3], [8.0, 0.7]))
    assert exe.last_replan_structural
    server.refresh_coded_head()
    use()
    assert server.programs.captures == captures + len(server.programs.keys()) == 2 * keys


def test_captured_server_keeps_one_serve_state(model):
    """A captured server keeps the state its graphs read: across runs of
    one shape the same tensors, replayed; another shape replaces the
    state and the old shape's programs."""
    server = _server(model, True)
    trace = _trace(model, 5, n=4)
    kw = dict(slots=2, decode_block=2, paged=True, block_len=16)
    for _ in range(2):
        server.serve(trace, num_blocks=8, **kw)
    first = server._serve_st
    ptr = first["cache"]["k"].data_ptr()
    captures = server.programs.captures
    server.serve(trace, num_blocks=8, **kw)
    assert server._serve_st is first and first["cache"]["k"].data_ptr() == ptr
    assert server.programs.captures == captures
    server.serve(trace, num_blocks=10, **kw)
    shape = server._serve_shape
    assert shape[2] == 10 and server._serve_st is not first
    assert server._serve_st["cache"]["k"].shape[1] == first["cache"]["k"].shape[1] + 2
    assert all(key[:len(shape)] == shape for key in server.programs.keys("serve"))


PROFILED_REPLAY = textwrap.dedent("""
    import tempfile

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core.runtime_model import ClusterSpec
    from repro_torch.models.model import Model
    from repro_torch.obs import profile
    from repro_torch.runtime.serve_loop import ServeConfig, Server
    from repro_torch.serve.workload import make_workload

    model = Model(ARCHS["qwen3-0.6b"].reduced(), device="cuda", seed=0)
    trace = make_workload("poisson", num_requests=4, prompt_len=(8, 24), out_len=(3, 6),
                          vocab=model.config.vocab_size).trace(seed=1)
    kw = dict(slots=2, decode_block=2, paged=False, prompt_cap=24, max_out=6)
    make = lambda: Server(model, ClusterSpec.make([6, 6], [8.0, 0.7]),
                          ServeConfig(block_rows=16, deadline_safety=1.2))
    old = make()
    for _ in range(2):
        old.serve(trace, **kw)  # every key captured before any session
    captures = old.programs.captures
    with tempfile.TemporaryDirectory() as tmp:
        with profile.capture(tmp, "other"):  # graphs made and dropped in a session
            other = make()
            for _ in range(2):
                other.generate(torch.zeros((2, 4), dtype=torch.int32), 3)
            del other
        with profile.capture(tmp, "plain"):
            torch.randn(64, 64, device="cuda").sum()
        with profile.capture(tmp, "replay"):
            old.serve(trace, **kw)
        s = profile.summarize(tmp, ["replay"])["replay"]
    assert old.programs.captures == captures and old.programs.replays > 0
    print("device ops", s["op_total_us"], flush=True)
    assert s["op_total_us"] > 0
    print("OK")
""")


def test_profiled_replay_of_graphs_older_than_a_profiler_session(model):
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    proc = subprocess.run([sys.executable, "-c", PROFILED_REPLAY], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and proc.stdout.rstrip().endswith("OK"), (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
