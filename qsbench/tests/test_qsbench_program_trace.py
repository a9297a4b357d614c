"""Device operations of a hand-written trace matched to their launches by
correlation id, and found by the program span open at their launch."""

from qsbench.program_trace import LaunchedTrace, union


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# Host: a request (0-1000) holding a compile (10-100), a batched build
# (100-300) and an execution (300-400). The build launches a GEMM at 150
# and a copy at 250 that run at 320-380 and 400-420, after the build's
# host span ended; the execution launches a fiber kernel at 350 that runs
# at 450-550. A kernel of correlation 9 has no launch in the trace.
TRACE = {"traceEvents": [
    _x("user_annotation", "simulator.run_with_noise", 0.0, 1000.0),
    _x("user_annotation", "program.compile", 10.0, 90.0),
    _x("user_annotation", "plan.operands_batched", 100.0, 200.0),
    _x("user_annotation", "plan.execute", 300.0, 100.0),
    _x("cuda_runtime", "cudaLaunchKernel", 150.0, 5.0, corr=1),
    _x("cuda_runtime", "cudaMemcpyAsync", 250.0, 5.0, corr=2),
    _x("cuda_runtime", "cudaLaunchKernelExC", 350.0, 5.0, corr=3),
    _x("kernel", "sm80_xmma_gemm_cf32cf32", 320.0, 60.0, corr=1),
    _x("gpu_memcpy", "Memcpy HtoD", 400.0, 20.0, corr=2),
    _x("kernel", "void qs::mma_kernel<128, true, false>(float*)", 450.0,
       100.0, corr=3),
    _x("kernel", "void at::native::fill", 600.0, 10.0, corr=9),
    {"ph": "f", "cat": "ac2g", "id": 1, "ts": 320.0},
]}


def test_device_operations_matched_to_their_launches():
    t = LaunchedTrace.from_chrome(TRACE)
    assert [op.launch for op in t.launched] == [150.0, 250.0, 350.0]
    assert t.unlaunched == 1
    assert len(t.device) == 4          # what DeviceTrace keeps, unchanged
    assert t.busy_intervals() == [(320.0, 380.0), (400.0, 420.0),
                                  (450.0, 550.0), (600.0, 610.0)]
    build = t.launched_in(t.ranges(("plan.operands_batched",)))
    assert [(op.start, op.end) for op in build] == [(320.0, 380.0),
                                                    (400.0, 420.0)]
    assert [op.name for op in t.launched_in(t.ranges(("plan.execute",)))] \
        == ["void qs::mma_kernel<128, true, false>(float*)"]
    assert t.launched_in(t.ranges(("program.compile",))) == []
    assert len(t.launched_in(t.ranges(("simulator.run_with_noise",)))) == 3


def test_union_of_ranges():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert union([]) == []
