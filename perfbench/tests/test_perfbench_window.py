"""What the matvec driver keeps of a window: every query's wall and counts,
and the check's sample of decoded queries drawn from the seed as they
come (a reservoir); and ``setup_s`` as the set-up phases after the card
check."""
from __future__ import annotations

import pytest
import torch

from perfbench import run
from perfbench.tests import tinybench

drv = run.load_module(run.HERE / "drivers" / "matvec.py")


class FakeQueries:
    """A mask is decodable where it is True."""

    @staticmethod
    def decodable(mask) -> bool:
        return bool(mask)


def _stream(win, decodable: list[bool]):
    """Each query i as (x i, mask, z -i, ok = mask, wall i ms)."""
    for i, ok in enumerate(decodable):
        win.add(i, ok, -i, ok, i * 1e-3)
    return win


def _picked(win) -> list[int]:
    return [x for x, _, _ in win.sample()]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinybench.make_root(tmp_path_factory.mktemp("bench"))


def test_the_reservoir_never_holds_more_than_the_checks_queries():
    win = drv.Window(FakeQueries(), 8, 2**33 + 5)
    for i in range(2000):
        win.add(i, i % 3 != 0, -i, i % 3 != 0, 1e-3)
        assert len(win.picked) == min(8, win.decoded)
    assert win.attempted == 2000 and win.walls == [1e-3] * 2000
    assert all(x % 3 != 0 for x in _picked(win))
    assert all(z == -x for x, _, z in win.sample())


def test_the_same_seed_picks_the_same_queries():
    stream = [i % 5 != 2 for i in range(500)]
    a = _picked(_stream(drv.Window(FakeQueries(), 8, 77), stream))
    b = _picked(_stream(drv.Window(FakeQueries(), 8, 77), stream))
    c = _picked(_stream(drv.Window(FakeQueries(), 8, 78), stream))
    assert a == b and a == sorted(a) and len(a) == 8
    assert a != c


def test_every_decodable_query_can_be_picked():
    stream = [i % 4 != 1 for i in range(40)]
    seen: set[int] = set()
    for seed in range(300):
        seen |= set(_picked(_stream(drv.Window(FakeQueries(), 3, seed), stream)))
    assert seen == {i for i, ok in enumerate(stream) if ok}


def test_the_tiny_cell_counts_every_query_of_the_window(root, monkeypatch):
    """ok turned False on every third call that decoded: ``attempted``,
    ``failed`` and ``wrong_ok`` count each query of the window."""
    from repro_torch.core import coded_matvec

    real = coded_matvec.DecodePipeline.__call__
    oks: list[bool] = []
    flipped: list[bool] = []

    def call(self, packed, x, mask):
        z, ok = real(self, packed, x, mask)
        flip = bool(ok) and len(oks) % 3 == 0
        oks.append(bool(ok) and not flip)
        flipped.append(flip)
        return z, (torch.zeros_like(ok) if flip else ok)

    monkeypatch.setattr(coded_matvec.DecodePipeline, "__call__", call)
    rc, line = tinybench.run_cell(root, "tiny-stragglers", seed=2**32 + 11)
    warm = tinybench.TINY_STRAGGLERS["warmup_queries"]
    assert rc == 0 and line["correct"] is False
    assert line["attempted"] == len(oks) - warm > 10
    assert line["failed"] == oks[warm:].count(False) > 0
    assert line["checks"]["wrong_ok"]["value"] == sum(flipped[warm:]) > 0


def test_setup_s_is_the_phases_after_the_card_check(root, capsys):
    rc, line = tinybench.run_cell(root, "tiny-stragglers", seed=2**31 + 3)
    err = capsys.readouterr().err
    phases = [ln.split() for ln in err.splitlines() if ln.startswith("setup ")]
    names = [p[1] for p in phases]
    assert rc == 0 and names[:2] == ["torch", "card"] and names[-1] == "warmup"
    after = sum(float(p[2]) for p in phases[2:])
    assert line["metrics"]["setup_s"]["value"] == pytest.approx(after, rel=1e-9)
