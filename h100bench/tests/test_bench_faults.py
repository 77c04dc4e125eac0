"""The check that decides ``correct``, driven through a whole run at a small
size on the CPU (the look for a card skipped), with the timed path broken
underneath: each fault a solve cell can have comes out not correct.

Of the faults a check must catch, a solve cell can have two: a step that
returns its state unchanged, and an answer altered where it is produced.
It has no batch (each request is one right-hand side, and no mean is taken
over requests) and one card (no exchange between cards)."""

import pytest
import torch

from smallcells import CELLS, run_small
from tpu_multigrid_torch import cycles, precision


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, lines = run_small(cell)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert all(line.startswith(("setup:", "check ")) for line in lines)


def _unchanged_step(monkeypatch):
    """The V-cycle returns its iterate as it came."""
    monkeypatch.setattr(precision, "cycle", lambda hier, cfg, u, b, k=0: u)
    monkeypatch.setattr(cycles, "cycle_with_norm", lambda hier, cfg, u, b: (
        u, torch.linalg.vector_norm(b)))


def _altered_answer(monkeypatch):
    """The answer comes back with a relative error of 1e-3."""
    solve_ds, solve_fixed = precision.solve_refined_ds, cycles.solve_fixed

    def ds(*args, **kw):
        hi, lo, *rest = solve_ds(*args, **kw)
        return (hi * (1 + 1e-3), lo, *rest)

    def fixed(*args, **kw):
        res = solve_fixed(*args, **kw)
        res.u = res.u * (1 + 1e-3)
        return res
    monkeypatch.setattr(precision, "solve_refined_ds", ds)
    monkeypatch.setattr(cycles, "solve_fixed", fixed)


@pytest.mark.parametrize("fault", [_unchanged_step, _altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, lines = run_small(cell)
    assert not result["correct"], lines
