"""The reduction of a profiler trace: busy time, names, idle gaps and the
readers of the device's and plain ops' shares."""

import pytest

import devtrace
import harness


def test_busy_is_the_union_of_intervals():
    assert devtrace.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25


@pytest.mark.parametrize("name, base", [
    ("void (anonymous namespace)::smooth_restrict_kernel<3, false>(float "
     "const*, float*)", "smooth_restrict_kernel"),
    ("void (anonymous namespace)::prolong_smooth3_kernel<(anonymous "
     "namespace)::ConstOp3<false> >(float const*)", "prolong_smooth3_kernel"),
    ("ds_residual_kernel", "ds_residual_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float> >(int, at::native::CUDAFunctor_add<float>)",
     "vectorized_elementwise_kernel")])
def test_base_name(name, base):
    assert devtrace.base_name(name) == base


def _trace(device, host, window_s=1e-4):
    return devtrace.Trace(device=device, host=host, window_s=window_s,
                          launches={})


HOST = [("h100bench.window", 0.0, 100.0), ("h100bench.solve", 0.0, 60.0),
        ("aten::item", 30.0, 42.0), ("cudaStreamSynchronize", 31.0, 41.0),
        ("h100bench.solve", 61.0, 100.0)]
DEVICE = [("smooth_restrict_kernel", 5.0, 30.0),
          ("at::native::reduce_kernel<512>", 30.0, 36.0),
          ("smooth_restrict_kernel", 40.0, 55.0),
          ("smooth_restrict_kernel", 70.0, 90.0)]


def test_idle_gaps_are_named_by_the_host():
    """Gaps [0, 5], [55, 70] and [90, 100] fall in the harness's solve
    spans; [36, 40] inside the host's stream synchronisation."""
    gaps = devtrace.idle_gaps(DEVICE, HOST, 0.0, 100.0)
    named = {}
    for name, secs in gaps:
        named[name] = named.get(name, 0.0) + secs * 1e6
    assert named == {"h100bench.solve": pytest.approx(30.0),
                     "cudaStreamSynchronize": pytest.approx(4.0)}


def test_breakdown_orders_and_sums():
    out = devtrace.breakdown(_trace(DEVICE, HOST))
    assert out["device_ops"][0] == ["smooth_restrict_kernel",
                                    pytest.approx(60e-6)]
    assert sum(s for _, s in out["idle_gaps"]) == pytest.approx(34e-6)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def _run(trace):
    return harness.Run(setup_s=0, window_s=trace.window_s, solve_s=[1.0],
                       solves=[], peak_bytes=0, held_bytes=0, trace=trace,
                       config={})


def test_device_idle_and_plain_ops_share():
    idle = harness.load_module(harness.BENCH / "metrics" / "device_idle.py")
    plain = harness.load_module(harness.BENCH / "metrics"
                                / "plain_ops_share.py")
    run = _run(_trace(DEVICE, HOST))
    assert idle.read(run) == pytest.approx(34.0)
    assert plain.read(run) == pytest.approx(100 * 6 / 66)
    memcpy = DEVICE + [("Memcpy DtoH (Device -> Pageable)", 90.0, 95.0)]
    assert plain.read(_run(_trace(memcpy, HOST))) == pytest.approx(
        100 * 11 / 71)
    assert idle.read(_run(_trace([], HOST))) is None
    assert plain.read(_run(_trace([], HOST))) is None


def test_events_skip_the_harness_annotations():
    """A CPU profile gives host events only; the spans are among them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("h100bench.window"):
            torch.ones(4).sum()
    device, host = devtrace.events(prof)
    assert device == []
    assert any(n == "h100bench.window" for n, _, _ in host)
    assert devtrace.window_span(host)[1] > devtrace.window_span(host)[0]
