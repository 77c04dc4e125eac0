"""The port's deep-tolerance refinement path (cycle_ds, triple-single
refinement) and FMG on the kernel path, against the JAX package on the CPU,
from the same configurations; and the kernel dispatch of the path, counted
with spies on the wrappers.

Tolerances.  Both packages evaluate the same float32 operations in the same
order, but XLA:CPU contracts multiply-adds into FMAs where torch's CPU
kernels do not, so iterates differ at f32 roundoff: one cycle's e_hi to
1e-6 of its largest entry (measured: one ulp), and the ds pair's sum to
1e-6 of that too (a one-ulp move of e_hi re-splits e_lo entirely, so e_lo
alone is not compared).  Residual histories agree to rtol 1e-4 with equal
iteration counts.  The refined iterates are checked by an independent
float64 residual, at the bounds of tests/test_precision.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_multigrid as jmg
from tpu_multigrid import precision as jprecision

import tpu_multigrid_torch as tmg
from tpu_multigrid_torch import interop, kernels, precision
from tpu_multigrid_torch.kernels import compres, localref, stencil, transfer

# One torch thread per test worker (see tests/test_torch_ops.py).
torch.set_num_threads(1)

KERNEL_PAD = dict(align=256, min_pad_level=0)


def _pair(level, coarsest, use_kernels=False, **kw):
    """(JAX problem, JAX config, port problem, port config); with
    ``use_kernels`` both are padded as the kernel path pads, while the JAX
    side stays on its jnp route (``use_pallas=False``)."""
    cj = jmg.MultigridConfig(finest_level=level, coarsest_level=coarsest,
                             dtype=jnp.float32, **kw)
    ct = tmg.MultigridConfig(finest_level=level, coarsest_level=coarsest,
                             use_kernels=use_kernels, **kw)
    pad = KERNEL_PAD if use_kernels else {}
    return (jmg.PoissonProblem(cj, **pad), cj,
            tmg.PoissonProblem(ct, device="cpu", **pad), ct)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _f64_rel_residual(b, comps, n):
    """||b - A(sum of comps)|| / ||b|| in float64 numpy, interior only."""
    b64 = _np(b).astype(np.float64)
    u = sum(_np(c).astype(np.float64) for c in comps)
    nbr = (np.roll(u, 1, 0) + np.roll(u, -1, 0)
           + np.roll(u, 1, 1) + np.roll(u, -1, 1))
    r = b64 - 4.0 * u + nbr
    mask = np.zeros(r.shape, bool)
    mask[1:n, 1:n] = True
    return np.linalg.norm(np.where(mask, r, 0.0)) / np.linalg.norm(b64)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_cycle_ds_matches_jax(use_kernels):
    pj, cj, pt, ct = _pair(6, 3, use_kernels, nu1=3, nu2=2,
                           smoother="chebyshev")
    jhi, jlo = jprecision.cycle_ds(pj.hierarchy, cj, pj.rhs(), ds_levels=3)
    thi, tlo = precision.cycle_ds(pt.hierarchy, ct, pt.rhs(), ds_levels=3)
    assert thi.dtype == tlo.dtype == torch.float32
    scale = float(np.abs(np.asarray(jhi)).max())
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), rtol=0,
                               atol=1e-6 * scale)
    assert float(tlo.abs().max()) < 1e-6 * scale
    tsum = thi.numpy().astype(np.float64) + tlo.numpy()
    jsum = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    np.testing.assert_allclose(tsum, jsum, rtol=0, atol=1e-6 * scale)


def test_cycle_ds_below_ds_levels_is_the_plain_cycle():
    _, _, pt, ct = _pair(6, 3)
    b = pt.rhs()
    e_hi, e_lo = precision.cycle_ds(pt.hierarchy, ct, b, ds_levels=0)
    assert torch.equal(e_hi, tmg.cycle(pt.hierarchy, ct, torch.zeros_like(b),
                                       b))
    assert not e_lo.any()
    # The 3D branch too (ported since): a 3D hierarchy, shape kept.
    p3 = tmg.Poisson3DProblem(ct, device="cpu")
    b3 = p3.rhs()
    e_hi, e_lo = precision.cycle_ds(p3.hierarchy, ct, b3, ds_levels=0)
    assert e_hi.shape == (65, 65, 65) and not e_lo.any()
    assert torch.equal(e_hi, tmg.cycle(p3.hierarchy, ct, torch.zeros_like(b3),
                                       b3))


# Each refinement entry against the JAX one: ds with three ds levels at
# level 6 to 1e-10; ts at level 7 to 1e-12, as tests/test_precision.py runs
# the JAX one.
REFINED = {"ds": (6, 1e-10, dict(ds_levels=3)), "ts": (7, 1e-12, {})}


@pytest.mark.parametrize("kind, use_kernels", [("ds", False), ("ts", False),
                                               ("ts", True)])
def test_solve_refined_matches_jax(kind, use_kernels):
    level, tol, kw = REFINED[kind]
    pj, cj, pt, ct = _pair(level, 3, use_kernels)
    entry = f"solve_refined_{kind}"
    jout = getattr(jprecision, entry)(pj.hierarchy, cj, pj.rhs(), tol=tol,
                                       max_iters=40, **kw)
    tout = getattr(precision, entry)(pt.hierarchy, ct, pt.rhs(), tol=tol,
                                      max_iters=40, **kw)
    *parts, hist, iters, ok = tout
    assert len(parts) == (2 if kind == "ds" else 3)
    assert ok is True and bool(jout[-1])
    assert iters == int(jout[-2])
    assert hist.dtype == torch.float32 and hist.device.type == "cpu"
    assert hist.shape == (41,)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jout[-3]), rtol=1e-4)
    assert hist[iters] <= tol * hist[0]
    assert _f64_rel_residual(pt.rhs(), parts, 2 ** level) < 5 * tol


def test_solve_refined_ts_fixed_count_and_guards():
    pj, cj, pt, ct = _pair(5, 3)
    jout = jprecision.solve_refined_ts(pj.hierarchy, cj, pj.rhs(),
                                       num_cycles=4, tol=None, ds_levels=0)
    tout = precision.solve_refined_ts(pt.hierarchy, ct, pt.rhs(),
                                      num_cycles=4, tol=None, ds_levels=0)
    assert tout[4] == 4 and tout[5] is True
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               rtol=1e-4)
    with pytest.raises(ValueError):
        precision.solve_refined_ts(pt.hierarchy, ct, pt.rhs(), tol=None)
    with pytest.raises(ValueError):
        precision.solve_refined_ds(pt.hierarchy, ct, pt.rhs(), ds_levels=2,
                                   inner_dtype=torch.bfloat16)


def test_ts_add_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    comps = [rng.standard_normal((64, 64)).astype(np.float32) * s
             for s in (1.0, 1e-7, 1e-14, 1e-3)]
    want = jprecision.ts_add(*map(jnp.asarray, comps))
    got = precision.ts_add(*map(torch.tensor, comps))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("nparts", [2, 3])
@pytest.mark.parametrize("nys", [1, 2])
def test_accumulate_on_the_cpu_takes_the_plain_chain(monkeypatch, nparts,
                                                      nys):
    """_accumulate on CPU tensors, kernels on or off, runs ds_add / ts_add
    and never reaches comp_add_ext, whose CPU version calls _accumulate:
    the sums replace the list's entries and leave the old parts alone."""
    def refuse(comps, ys):
        raise AssertionError("comp_add_ext reached from CPU tensors")
    monkeypatch.setattr(localref, "comp_add_ext", refuse)
    rng = np.random.default_rng(nparts * 10 + nys)

    def grids(scales):
        return [torch.tensor(rng.standard_normal((33, 65)).astype(np.float32)
                             * s) for s in scales]
    parts = grids((1.0, 1e-7, 1e-14)[:nparts])
    ys = grids((1e-3, 1e-9)[:nys])
    add = precision.ds_add if nparts == 2 else precision.ts_add
    want = list(parts)
    for y in ys:
        want = list(add(*want, y))
    before = [p.clone() for p in parts]
    for use_kernels in (True, False):
        got = list(parts)
        precision._accumulate(got, ys, use_kernels)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(torch.equal(p, q) for p, q in zip(parts, before))


@pytest.mark.parametrize("ds_levels", [0, 2])
def test_solve_refined_ds_leaves_the_callers_start_alone(monkeypatch,
                                                         ds_levels):
    """solve_refined_ds(u0=x, u0_lo=x_lo) leaves x and x_lo as given, also
    when the accumulation writes its sums over the parts' storage, as
    comp_add_ext does on the card (here its CPU version, patched in), and
    the answer is the plain chain's, bit for bit."""
    _, _, pt, ct = _pair(6, 3)
    b = pt.rhs()
    x, x_lo = precision.solve_refined_ds(pt.hierarchy, ct, b, num_cycles=1,
                                         tol=None)[:2]
    keep = (x.clone(), x_lo.clone())

    def solve():
        return precision.solve_refined_ds(pt.hierarchy, ct, b, num_cycles=2,
                                          tol=None, u0=x, u0_lo=x_lo,
                                          ds_levels=ds_levels)
    want = solve()
    chain = precision._accumulate

    def in_place(parts, ys, use_kernels=False):
        new = list(parts)
        chain(new, ys)
        for c, v in zip(parts, new):
            c.copy_(v)
    monkeypatch.setattr(precision, "_accumulate", in_place)
    got = solve()
    assert torch.equal(x, keep[0]) and torch.equal(x_lo, keep[1])
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert got[3:] == want[3:]


def test_resume_from_a_jax_refinement_iterate():
    """interop carries a JAX (hi, lo) iterate across; both packages resume
    it with ds corrections and take the same steps."""
    pj, cj, pt, ct = _pair(6, 3)
    jhi, jlo, jhist, _, _ = jprecision.solve_refined_ds(
        pj.hierarchy, cj, pj.rhs(), num_cycles=3, tol=None, ds_levels=3)
    r0 = float(np.asarray(jhist)[0])   # the tolerance stays relative to b
    state = interop.refinement_state_to_numpy((jhi, jlo))
    assert [a.dtype for a in state] == [np.float32] * 2
    thi, tlo = interop.refinement_state_from_numpy(state)
    assert torch.equal(thi, torch.tensor(np.asarray(jhi)))
    jr = jprecision.solve_refined_ds(pj.hierarchy, cj, pj.rhs(), tol=1e-10,
                                     u0=jhi, u0_lo=jlo, r0_norm=r0,
                                     ds_levels=3)
    tr = precision.solve_refined_ds(pt.hierarchy, ct, pt.rhs(), tol=1e-10,
                                    u0=thi, u0_lo=tlo, r0_norm=r0,
                                    ds_levels=3)
    assert tr[3] == int(jr[3]) and tr[4] is True and bool(jr[4])
    np.testing.assert_allclose(tr[2].numpy(), np.asarray(jr[2]), rtol=1e-4)
    back = interop.refinement_state_to_numpy(tr[:2])
    assert _f64_rel_residual(pt.rhs(), back, 64) < 5e-10


def test_front_door_fmg_with_kernels_matches_jax():
    """solve_poisson(use_fmg=True) on the kernel path (its plain versions on
    the CPU) against the JAX jnp route.  The port pads every level to 256
    as the kernels need, so the solutions compare on the physical nodes.
    The FMG guess is accurate enough that its residual is mostly f32
    evaluation noise, which the packages round differently (FMAs on
    XLA:CPU): the refined histories, relative to it, agree to rtol 1e-2
    (measured 5.4e-3), the solutions to 1e-6 of their largest entry
    (measured 5.1e-8), and the kernel path equals the port's plain path."""
    cfg = dict(finest_level=8, coarsest_level=4, nu1=3, nu2=2,
               smoother="chebyshev")
    rj = jmg.solve_poisson(8, config=jmg.MultigridConfig(
        dtype=jnp.float32, **cfg), use_fmg=True, tol=1e-7)
    kernels.reset_launch_counts()
    rt = tmg.solve_poisson(8, config=tmg.MultigridConfig(
        use_kernels=True, **cfg), use_fmg=True, tol=1e-7, device="cpu")
    assert set(kernels.launch_counts().values()) == {0}
    rp = tmg.solve_poisson(8, config=tmg.MultigridConfig(**cfg),
                           use_fmg=True, tol=1e-7, device="cpu")
    assert rt.u.shape == (512, 512)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations) == rp.iterations
    np.testing.assert_allclose(_np(rt.res_history), _np(rj.res_history),
                               rtol=1e-2)
    ut = tmg.extract_solution(rt.u, 256)
    uj = np.asarray(jmg.extract_solution(rj.u, 256))
    np.testing.assert_allclose(ut.numpy(), uj, rtol=0,
                               atol=1e-6 * np.abs(uj).max())
    assert torch.equal(ut, tmg.extract_solution(rp.u, 256))


# ---------------------------------------------------------------------------
# Dispatch: which wrapper each step of the path calls
# ---------------------------------------------------------------------------

SPIED = {stencil: ["jacobi_sweeps", "jacobi_sweeps_residual", "rbgs_sweeps",
                   "rbgs_sweeps_residual", "residual"],
         transfer: ["smooth_restrict", "prolong_smooth",
                    "prolong_smooth_resnorm", "restrict_fw", "prolong_add",
                    "prolong_comp"],
         compres: ["ds_residual", "ts_residual"]}


@pytest.fixture
def calls(monkeypatch):
    """Counts of calls per wrapper, through spies on the kernel modules."""
    counts = {}
    for mod, names in SPIED.items():
        for name in names:
            counts[name] = 0

            def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return counts


def ts_record_calls(iterations, num_levels, ds_levels=3):
    """Wrapper calls of ``iterations`` ts iterations with ``ds_levels`` ds
    levels, all levels kernel-sized: per ds level one fused pre-smooth, one
    post-smooth, one restriction, one prolong-comp, one prolong-add and one
    ds residual; K1/K2 on each level pair below; one ts residual."""
    per = dict.fromkeys(["jacobi_sweeps_residual", "jacobi_sweeps",
                         "restrict_fw", "prolong_comp", "prolong_add",
                         "ds_residual"], ds_levels)
    per.update(smooth_restrict=num_levels - 1 - ds_levels,
               prolong_smooth=num_levels - 1 - ds_levels, ts_residual=1)
    return {k: iterations * v for k, v in per.items()}


def test_ts_record_dispatch_counts(calls):
    """The record's path at a small depth: levels 9 -> 5 padded to 256, the
    record's Chebyshev (3, 2); per iteration the counts chip_smoke.py checks
    at 16385^2 (there with 10 levels, so K1 = K2 = 6)."""
    _, _, pt, ct = _pair(9, 5, True, nu1=3, nu2=2, smoother="chebyshev")
    out = precision.solve_refined_ts(pt.hierarchy, ct, pt.rhs(),
                                     num_cycles=2, tol=None, ds_levels=3)
    assert out[4] == 2
    want = dict.fromkeys(calls, 0)
    want.update(ts_record_calls(2, num_levels=5))
    assert calls == want
    assert ts_record_calls(1, num_levels=10)["smooth_restrict"] == 6


def test_fmg_dispatch_counts(calls):
    _, _, pt, ct = _pair(8, 5, True, nu1=3, nu2=2, smoother="chebyshev")
    tmg.fmg(pt.hierarchy, ct, pt.rhs())
    want = dict.fromkeys(calls, 0)
    # 3 restrictions down, 3 prolong-adds up; nu0 = 1 V-cycle at each of
    # the 3 finer levels, of 1, 2 and 3 level pairs.
    want.update(restrict_fw=3, prolong_add=3, smooth_restrict=6,
                prolong_smooth=6)
    assert calls == want


@pytest.mark.parametrize("smoother,entry", [("rbgs", "rbgs_sweeps"),
                                            ("chebyshev", "jacobi_sweeps")])
def test_smoothed_coarsest_level_runs_the_stencil_kernel(calls, smoother,
                                                         entry):
    _, _, pt, ct = _pair(6, 5, True, smoother=smoother,
                         coarse_solver="smooth")
    b = pt.rhs()
    u = tmg.cycle(pt.hierarchy, ct, torch.zeros_like(b), b)
    assert calls[entry] == 1 and calls["smooth_restrict"] == 1
    plain = dataclasses.replace(ct, use_kernels=False)
    assert torch.equal(u, tmg.cycle(pt.hierarchy, plain,
                                    torch.zeros_like(b), b))


def test_deep_smoothing_runs_unfused_levels_on_kernels(calls):
    """RB-GS with 10 sweeps is too deep for K1/K2 once the grid is
    row-tiled (S=512, the finest level here): that level runs the streaming
    smoother (20 half-steps, two launches on the card),
    the residual and the standalone transfers, as the JAX package does."""
    ct = tmg.MultigridConfig(finest_level=8, coarsest_level=5,
                             smoother="rbgs", nu1=10, nu2=10,
                             use_kernels=True)
    res = tmg.solve_poisson(8, config=ct, num_cycles=2, refined=False,
                            device="cpu")
    assert calls["rbgs_sweeps_residual"] == 2 and calls["rbgs_sweeps"] == 2
    assert calls["restrict_fw"] == 2 and calls["prolong_add"] == 2
    assert calls["residual"] == 2   # the norm after each cycle
    # The S=256 level pairs below have no row tiling: K1/K2 take them.
    assert calls["smooth_restrict"] == calls["prolong_smooth"] == 4
    plain = tmg.solve_poisson(8, config=dataclasses.replace(
        ct, use_kernels=False), num_cycles=2, refined=False, device="cpu")
    np.testing.assert_allclose(res.res_history.numpy(),
                               plain.res_history.numpy(), rtol=1e-5)
