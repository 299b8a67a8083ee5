"""The reader of pc_refit_share on synthetic records of the program's
trace store (benchmark/spans.py)."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.run import load_reader


def span(i, name, parent, step):
    from cfdtpu_torch.utils.trace import Span

    return Span(i, name, parent, step, 0, 1, None)


@pytest.fixture
def records(monkeypatch):
    from cfdtpu_torch.utils import trace

    rec = {"spans": [span(0, "step", None, 5), span(1, "step", None, 6),
                     span(2, "step", None, 7)],
           "steps": {5: {"rebuilds": 1, "pc_refits": 1}, 6: {},
                     7: {"rebuilds": 1}}}
    monkeypatch.setattr(trace, "records", lambda: rec)
    return rec


def ctx(n_steps=3):
    return SimpleNamespace(trace_steps=[{}] * n_steps,
                           device=torch.device("cuda"))


def test_share_of_the_rebuilds(records):
    read = load_reader("pc_refit_share")
    # one refit over two rebuilds; the other made afresh
    assert read(ctx()) == pytest.approx(50.0)
    records["steps"][7]["pc_refits"] = 1
    assert read(ctx()) == pytest.approx(100.0)
    assert read(ctx(2)) is None  # not the traced window


def test_nothing_to_read(records, monkeypatch):
    read = load_reader("pc_refit_share")
    records["steps"] = {5: {}, 6: {}, 7: {}}
    assert read(ctx()) is None  # no rebuild traced
    records["steps"][5]["rebuilds"] = 1
    assert read(ctx()) == 0.0
    # a program without the slot refits nothing and reports nothing
    from cfdtpu_torch.la import schur

    monkeypatch.delattr(schur, "PrecondSlot")
    assert read(ctx()) is None
