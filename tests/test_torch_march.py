"""The Python side of the marching kernels, on the CPU with the C queries
stubbed: K1v_3's and the 7-point K1_3's launch plans under the z march's
halo limit (``transfer3d.k1_plan``, ``vartransfer3d._plan``, the C calls
``transfer3d.smooth_restrict3`` / ``smooth_restrict_ext3`` make), and the
streaming smoother's launches under a changed ``tmt_stencil_max_steps``
(``stencil.launch_plan`` and the sequence of C calls ``stencil._launch``
makes)."""

import types

import numpy as np
import pytest
import torch

from tpu_multigrid_torch.core import ops
from tpu_multigrid_torch.kernels import stencil
from tpu_multigrid_torch.kernels import transfer3d as T3
from tpu_multigrid_torch.kernels import vartransfer3d as VT3

CHEB3 = ops.chebyshev_omegas(3, 0.4)


def _halos(plan, extra):
    """Each launch's halo: its steps, + extra for the last (K1's residual and
    blur)."""
    return [k + (extra if i == len(plan) - 1 else 0)
            for i, (_, k, _) in enumerate(plan)]


@pytest.mark.parametrize("steps", [0, 1, 2, 3, 4, 6, 9, 10, 12, 14, 20, 40])
@pytest.mark.parametrize("ws", [(1.0,), CHEB3])
def test_k1_plan_equals_split_plan_at_equal_limits(steps, ws):
    """With both windows at 11 layers (the kernels' limits today) a K1v_3
    call splits exactly as K1_3's does."""
    assert T3.k1_plan(steps, ws, 11, 11) == T3.split_plan(steps, 2, 11, ws)


@pytest.mark.parametrize("k1_halo,k2_halo", [(6, 11), (11, 11), (14, 11),
                                             (16, 8)])
@pytest.mark.parametrize("steps", [0, 2, 3, 4, 9, 10, 12, 14, 30])
def test_k1_plan_fits_each_launch_in_its_window(k1_halo, k2_halo, steps):
    """Every launch fits the window it runs on: the last (K1v_3, halo steps
    + 2) the z march's, the leading ones (K2v_3 passes) the 3D window's;
    one launch whenever steps + 2 fits the z march; the steps run in order
    with their weights rotated to each launch's first step."""
    ws = CHEB3
    plan = T3.k1_plan(steps, ws, k1_halo, k2_halo)
    halos = _halos(plan, 2)
    assert halos[-1] <= k1_halo
    assert all(h <= k2_halo for h in halos[:-1])
    if steps + 2 <= k1_halo:
        assert len(plan) == 1
    first = 0
    for f, k, launch_ws in plan:
        assert f == first
        assert launch_ws == tuple(ws[(f + s) % len(ws)]
                                  for s in range(max(1, min(k, len(ws)))))
        first += k
    assert first == steps


def test_k1_plan_rbgs_5_5_splits_only_where_the_window_needs_it():
    """RB-GS (5, 5) (10 half-steps, a halo of 12): one launch once the z
    march holds 12 layers, two (6 + 4 steps) under today's 11."""
    assert T3.k1_plan(10, (1.0,), 12, 11) == [(0, 10, (1.0,))]
    assert T3.k1_plan(10, (1.0,), 11, 11) == [(0, 6, (1.0,)),
                                               (6, 4, (1.0,))]


def _stub_lib(**limits):
    """The bound library's limits as they are today, some replaced."""
    return types.SimpleNamespace(**{"window3_max_halo": 11,
                                    "zmarch3_max_halo": 11,
                                    "stencil_max_steps": 16, **limits})


@pytest.mark.parametrize("sweeps,k1_halo,launches", [(3, 11, 1), (3, 8, 1),
                                                     (3, 5, 2), (5, 6, 2),
                                                     (5, 12, 1)])
def test_var_k1_entries_plan_with_the_zmarch_query(sweeps, k1_halo,
                                                   launches):
    """``_plan`` of a K1v_3 entry reads ``zmarch3_max_halo`` (RB-GS here:
    2 * sweeps half-steps), a K2v_3 entry ``window3_max_halo`` alone."""
    lib = _stub_lib(zmarch3_max_halo=k1_halo)
    rbgs, plan = VT3._plan("var_smooth_restrict3", lib, "rbgs", 1.0, sweeps,
                           2)
    assert rbgs == 1 and len(plan) == launches
    assert sum(k for _, k, _ in plan) == 2 * sweeps
    lib = _stub_lib(zmarch3_max_halo=2)   # a K2 plan does not read it
    _, plan2 = VT3._plan("var_prolong_smooth3", lib, "jacobi", 2.0 / 3.0,
                         sweeps, 1)
    assert plan2 == T3.split_plan(sweeps, 1, 11, (2.0 / 3.0,))


class _FakeK1:
    """Stands in for the bound library under K1_3's entries: the halo
    limits, and each C call's (entry, steps, first step)."""

    # The index of `steps` among each entry's arguments (`first` follows).
    STEPS_AT = {"tmt_smooth_restrict3": 11, "tmt_prolong_smooth3": 13,
                "tmt_smooth_restrict_ext3": 13,
                "tmt_prolong_smooth_ext3": 15}

    def __init__(self, zmarch3_max_halo, window3_max_halo):
        self.zmarch3_max_halo = zmarch3_max_halo
        self.window3_max_halo = window3_max_halo
        self.calls = []

    def __getattr__(self, entry):
        at = self.STEPS_AT[entry]

        def call(*args):
            self.calls.append((entry, args[at], args[at + 1]))
            return 0
        return call


@pytest.fixture
def fake_k1(monkeypatch):
    """transfer3d's K1_3 entries on meta tensors (they take the card's
    route), with the C library faked; ``fake_k1(zmarch, window)`` sets the
    limits."""
    from tpu_multigrid_torch.kernels import _build
    lib = _FakeK1(11, 11)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "check_inputs", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def limits(zmarch, window):
        lib.zmarch3_max_halo, lib.window3_max_halo = zmarch, window
        lib.calls.clear()
        return lib
    return limits


def _k1_calls(plan, leading, last):
    """The C calls that run ``plan``: leading smoothing passes, then K1."""
    return [(leading if i < len(plan) - 1 else last, k, first)
            for i, (first, k, _) in enumerate(plan)]


@pytest.mark.parametrize("zmarch,window", [(6, 11), (14, 11), (11, 11),
                                           (11, 6)])
@pytest.mark.parametrize("steps", [0, 3, 4, 9, 10, 12])
@pytest.mark.parametrize("stencil", [None, "19"])
def test_k1_3_entries_plan_the_7_point_form_on_the_zmarch(fake_k1, zmarch,
                                                          window, steps,
                                                          stencil):
    """``smooth_restrict3`` plans its 7-point launches with
    ``zmarch3_max_halo`` (``k1_plan``) and its static-taps launches with
    ``window3_max_halo`` alone (``split_plan``); ``smooth_restrict_ext3``
    (7-point only) as the 7-point form.  Each launch counts once."""
    from tpu_multigrid_torch.core.operators import Const19Op
    st = Const19Op.STENCIL27 if stencil else None
    ws = ops.chebyshev_omegas(steps, 0.4) if steps else (2.0 / 3.0,)
    om = ws if steps else ws[0]
    lib = fake_k1(zmarch, window)
    if st is None:
        plan = T3.k1_plan(steps, ws, zmarch, window)
    else:
        plan = T3.split_plan(steps, 2, window, ws)
    u = torch.empty((48, 48, 128), device="meta")
    before = dict(T3.LAUNCHES)
    T3.smooth_restrict3(u, u, 32, (32, 32, 128), steps, "jacobi", om, st)
    assert lib.calls == _k1_calls(plan, "tmt_prolong_smooth3",
                                  "tmt_smooth_restrict3")
    assert (T3.LAUNCHES["smooth_restrict3"]
            - before["smooth_restrict3"]) == len(plan)
    if st is not None or steps + 2 > 16:
        return
    lib.calls.clear()
    ext = torch.empty((80, 80, 128), device="meta")
    T3.smooth_restrict_ext3(ext, ext, (-16, -16), 64, (56, 56, 128), steps,
                            "jacobi", om)
    assert lib.calls == _k1_calls(plan, "tmt_prolong_smooth_ext3",
                                  "tmt_smooth_restrict_ext3")
    assert (T3.LAUNCHES["smooth_restrict_ext3"]
            - before["smooth_restrict_ext3"]) == len(plan)


@pytest.mark.parametrize("chunk", [4, 16, 24, 32])
@pytest.mark.parametrize("steps", [0, 1, 3, 16, 17, 20, 40])
def test_stencil_launch_plan_under_any_max_steps(chunk, steps):
    """At most ``chunk`` steps a launch, ceil(steps / chunk) launches (one
    for none), each beginning at the step after the last one's, with its
    weights rotated there."""
    ws = ops.chebyshev_omegas(5, 0.4)
    plan = stencil.launch_plan(steps, chunk, ws)
    assert len(plan) == max(1, -(-steps // chunk))
    first = 0
    for f, k, launch_ws in plan:
        assert f == first and 0 <= k <= chunk
        assert launch_ws[0] == ws[f % len(ws)]
        first += k
    assert first == steps


class _FakeStreamed:
    """Stands in for the bound library: records each tmt_streamed call's
    (steps, first step, rbgs, weights, u_out?, r_out?)."""

    def __init__(self, max_steps):
        self.stencil_max_steps = max_steps
        self.calls = []

    def tmt_streamed(self, u, b, u_out, r_out, S, n, steps, first, rbgs,
                     weights, count, stream):
        import ctypes
        w = np.ctypeslib.as_array(
            (ctypes.c_float * (2 * count)).from_address(weights))
        self.calls.append((steps, first, rbgs, tuple(w[:count]),
                           u_out is not None, r_out is not None))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """stencil._launch on CPU tensors, with the C library faked."""
    from tpu_multigrid_torch.kernels import _build
    lib = _FakeStreamed(16)
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "check_inputs", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("max_steps", [8, 16, 24])
def test_streamed_launches_follow_the_max_steps_query(fake_card, max_steps):
    """The wrapper splits at the library's ``stencil_max_steps``: RB-GS (10)
    (20 half-steps) and Chebyshev 20 run in ceil(20 / max) launches, each
    told its first step, the residual fused into the last one only; the
    LAUNCHES count is one per launch."""
    fake_card.stencil_max_steps = max_steps
    u = torch.zeros((256, 256))
    count = -(-20 // max_steps)
    before = dict(stencil.LAUNCHES)
    stencil._launch("rbgs_sweeps_residual", u, u, 250, 20, 1, (1.0,), True,
                    True)
    calls = fake_card.calls
    assert [c[1] for c in calls] == list(range(0, 20, max_steps))
    assert sum(c[0] for c in calls) == 20
    assert all(c[0] <= max_steps and c[2] == 1 for c in calls)
    assert [c[5] for c in calls] == [False] * (count - 1) + [True]
    assert all(c[4] for c in calls)
    assert (stencil.LAUNCHES["rbgs_sweeps_residual"]
            - before["rbgs_sweeps_residual"]) == count
    fake_card.calls.clear()
    ws = ops.chebyshev_omegas(20, 0.4)
    stencil._launch("jacobi_sweeps", u, u, 250, 20, 0, ws, True, False)
    for steps, first, _, w, _, want_r in fake_card.calls:
        want = stencil.step_weights(stencil.launch_plan(20, max_steps, ws)[
            first // max_steps][2])
        assert np.array_equal(np.array(w, np.float32), want[:len(w)])
        assert not want_r


def test_residual_alone_is_one_launch_of_no_steps(fake_card):
    """The residual entry: one launch of no steps, u' left out (its weight
    entry c1 = 1 - 1.0 is read by no step)."""
    u = torch.zeros((256, 256))
    stencil._launch("residual", u, u, 250, 0, 0, (1.0,), False, True)
    assert fake_card.calls == [(0, 0, 0, (0.0,), False, True)]
