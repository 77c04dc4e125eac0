"""The kernel rooflines' yardstick against chip_smoke.py's figures at
PERF.md section 6's shapes, and the share a reader takes from a trace."""

import pytest

import devtrace
import harness
import roofline

# PERF.md section 6, the "bound ms" column (chip_smoke.py's bound()):
# rows 1-2 at S = 8448 / Sc = 4352, Chebyshev 3 / 2; rows 9-10 at
# (528, 528, 640) / (272, 272, 384).
PAIR2 = ([8192, [8448, 8448]], [4096, [4352, 4352]])
PAIR3 = ([512, [528, 528, 640]], [256, [272, 272, 384]])


@pytest.mark.parametrize("work, ms", [
    (roofline.k1_work(*PAIR2, 3), 0.268),
    (roofline.k2_work(*PAIR2, 2), 0.265),
    (roofline.k2_work(*PAIR2, 2, True), 0.265),
    (roofline.k1_work(*PAIR3, 3), 0.567),
    (roofline.k2_work(*PAIR3, 2), 0.552),
    (roofline.k2_work(*PAIR3, 2, True), 0.552)])
def test_bounds_match_perf_table(work, ms):
    secs, by = roofline.bound(*work)
    assert by == "bytes"
    assert round(secs * 1e3, 3) == ms


def test_counts_match_chip_smoke_formulas():
    """The same numbers as chip_smoke.py's own expressions (its lines
    4278-4283 and 4337-4354 for 2D, 4109-4127 for 3D)."""
    chip_smoke = pytest.importorskip("chip_smoke")
    S, Sc, n = 8448, 4352, 8192
    N, Nc, reach, inner, creach, cinner = chip_smoke.cells2(S, Sc, n)
    assert roofline.k1_work(*PAIR2, 3) == (
        4 * (reach + inner + N + Nc),
        (3 * chip_smoke.JAC + chip_smoke.RES) * inner
        + chip_smoke.FW * cinner)
    assert roofline.k2_work(*PAIR2, 2) == (
        4 * (2 * inner + creach + N), (chip_smoke.PRO + 2 * chip_smoke.JAC)
        * inner)
    cells, ccells = 528 * 528 * 640, 272 * 272 * 384
    reach, inner = 513 ** 3, 511 ** 3
    creach, cinner = 257 ** 3, 255 ** 3
    assert roofline.k1_work(*PAIR3, 3) == (
        4 * (reach + inner + cells + ccells),
        (3 * chip_smoke.JAC3 + chip_smoke.RES3) * inner
        + chip_smoke.FW3 * cinner)
    assert roofline.k2_work(*PAIR3, 2, True) == (
        4 * (2 * inner + creach + cells) + 4,
        (chip_smoke.PRO3 + 2 * chip_smoke.JAC3 + chip_smoke.RES3 + 2)
        * inner)
    for a, b in ((roofline.PEAK_BYTES_PER_S, chip_smoke.PEAK_BYTES_PER_S),
                 (roofline.PEAK_F32_PER_S, chip_smoke.PEAK_F32_PER_S)):
        assert a == b


CONFIG2 = {"ndim": 2, "levels": [list(p) for p in PAIR2] + [
    [2048, [2304, 2304]]],
    "multigrid": {"smoother": "chebyshev", "nu1": 3, "nu2": 2}}


def _trace(config, device, launches, cycles):
    t = devtrace.Trace(device=device, host=[], window_s=1.0,
                       launches=launches)
    return harness.Run(setup_s=0, window_s=1.0, solve_s=[1.0],
                       solves=[{"cycles": cycles}], peak_bytes=0,
                       held_bytes=0, trace=t, config=config)


def test_k1_share_from_a_trace():
    """Two cycles over two fused pairs, 4 ms of K1 in all."""
    k1 = harness.load_module(harness.BENCH / "metrics" / "k1_roofline.2d.py")
    device = [("void (anonymous namespace)::smooth_restrict_kernel<3>(float "
               "const*)", 0.0, 1000.0)] * 4 + [
        ("void at::native::reduce_kernel<512>()", 0.0, 5000.0)]
    run = _trace(CONFIG2, device, {"smooth_restrict": 4}, 2)
    need = 2 * sum(roofline.bound(*roofline.k1_work(
        CONFIG2["levels"][i], CONFIG2["levels"][i + 1], 3))[0]
        for i in range(2))
    assert k1.read(run) == pytest.approx(100 * need / 4e-3)


def test_k2_share_counts_the_resnorm_visits():
    k2 = harness.load_module(harness.BENCH / "metrics" / "k2_roofline.2d.py")
    device = [("prolong_smooth_kernel", 0.0, 1000.0),
              ("sum_partials_kernel", 0.0, 10.0)]
    run = _trace(CONFIG2, device, {"prolong_smooth": 1,
                                   "prolong_smooth_resnorm": 1}, 1)
    lv = CONFIG2["levels"]
    need = (roofline.bound(*roofline.k2_work(lv[0], lv[1], 2, True))[0]
            + roofline.bound(*roofline.k2_work(lv[1], lv[2], 2))[0])
    assert k2.read(run) == pytest.approx(100 * need / 1.01e-3)


def test_nothing_to_read_gives_none():
    k1 = harness.load_module(harness.BENCH / "metrics" / "k1_roofline.2d.py")
    k13 = harness.load_module(harness.BENCH / "metrics" / "k1_roofline.3d.py")
    device = [("smooth_restrict_kernel", 0.0, 1000.0)]
    # launches not a multiple of the cycles; no launches; another ndim
    assert k1.read(_trace(CONFIG2, device, {"smooth_restrict": 3}, 2)) is None
    assert k1.read(_trace(CONFIG2, device, {}, 2)) is None
    assert k13.read(_trace(CONFIG2, device, {"smooth_restrict3": 2},
                           2)) is None
    run = _trace(CONFIG2, device, {"smooth_restrict": 2}, 2)
    run.trace = None
    assert k1.read(run) is None
