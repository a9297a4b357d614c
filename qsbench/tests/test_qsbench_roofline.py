"""The roofline reckoning on hand-worked shapes, and the reduction of a
device trace."""

import pytest

from qsbench.devtrace import DeviceTrace, roofline_share
from qsbench.roofline import (Launch, launch_bytes, launch_flops,
                              least_time)


def test_dense_k128_complex_n30_is_bound_by_bytes():
    # a planar complex64 n = 30 state: 2^31 floats; a complex 128 x 128
    # operator: 2 x 128 x 128 floats
    ln = Launch("dense_axis", 2**31, 2 * 128 * 128, 128, True, "float32")
    assert launch_bytes(ln) == (2 * 2**31 + 32768) * 4 == 17180000256
    assert launch_flops(ln) == 2**31 * 2 * 128 * 2
    t, by = least_time(ln)
    assert by == "bytes"
    assert t == pytest.approx(17180000256 / 3.35e12)        # 5.128 ms
    assert t == pytest.approx(5.1284e-3, rel=1e-4)


def test_real_operator_on_planar_state_counts_2k_per_element():
    ln = Launch("cross_bit_axis", 2**29, 256 * 256, 256, False, "float32")
    assert launch_flops(ln) == 2**29 * 512
    t, by = least_time(ln)
    assert by == "bytes" and t == pytest.approx((2**30 + 65536) * 4
                                                / 3.35e12)


def test_float64_deep_complex_is_bound_by_operations():
    ln = Launch("cross_bit_axis_f64", 2**28, 2 * 256 * 256, 256, True,
                "float64")
    t, by = least_time(ln)
    assert by == "operations"
    assert t == pytest.approx(2**28 * 1024 / 67e12)


def _chrome(events):
    return {"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in events] + [{"ph": "M", "name": "meta"}]}


TRACE = _chrome([
    ("user_annotation", "qsbench.request", 0.0, 1000.0),
    ("user_annotation", "build_group_operands", 10.0, 200.0),
    ("kernel", "void qs::mma_kernel<128, true, false>(float*)", 300.0,
     100.0),
    ("kernel", "void qs::mma_kernel<256, true, true>(float*)", 350.0, 100.0),
    ("gpu_memcpy", "Memcpy HtoD", 600.0, 50.0),
    ("kernel", "void qs::simt_kernel<4, true>(float*)", 800.0, 100.0),
    ("cpu_op", "aten::copy_", 0.0, 5.0),
])


def test_busy_union_and_idle_labels():
    t = DeviceTrace.from_chrome(TRACE)
    assert t.busy_intervals() == [(300.0, 450.0), (600.0, 650.0),
                                  (800.0, 900.0)]
    assert t.busy_s() == pytest.approx(300e-6)
    # gaps 450-600 and 650-800, both inside the request, outside the build
    assert t.idle_by_label() == [["qsbench.request", pytest.approx(300e-6)]]
    assert t.top_ops(2)[0][1] == pytest.approx(100e-6)


def test_fiber_kernels_matched_to_launches_in_order():
    t = DeviceTrace.from_chrome(TRACE)
    launches = [Launch("dense_axis", 2**20, 2 * 128 * 128, 128, True,
                       "float32"),
                Launch("cross_bit_axis", 2**20, 2 * 256 * 256, 256, True,
                       "float32"),
                Launch("dense_axis", 2**20, 16, 4, True, "float32")]
    timed = t.fiber_kernel_times(launches)
    assert [round(s * 1e6) for _, s in timed] == [100, 100, 100]
    share = roofline_share(timed, "dense_axis")
    want = 100 * (least_time(launches[0])[0] + least_time(launches[2])[0]) \
        / 200e-6
    assert share == pytest.approx(want)
    assert roofline_share(timed, "dense_axis_f64") is None
    with pytest.raises(RuntimeError):
        t.fiber_kernel_times(launches[:2])
