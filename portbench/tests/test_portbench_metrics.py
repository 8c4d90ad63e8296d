"""The trace reading and every metric reader on small synthetic runs whose
numbers are known."""

import os

import pytest

from portbench import run, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# a window of 100 us: two calls, [10, 50) and [60, 95); kernels at
# [12, 20), [18, 30) (overlapping), a copy at [40, 45), a kernel at
# [70, 80) and one outside the window; CPU ops inside the calls, one
# nested in another
EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0, 100),
    _x(trace.CALL, "user_annotation", 10, 40),
    _x(trace.CALL, "user_annotation", 60, 35),
    _x("nw_gotoh", "kernel", 12, 8),
    _x("gather", "kernel", 18, 12),
    _x("Memcpy DtoH", "gpu_memcpy", 40, 5),
    _x("nw_gotoh", "kernel", 70, 10),
    _x("late", "kernel", 120, 10),
    _x("aten::copy_", "cpu_op", 35, 12),
    _x("aten::to", "cpu_op", 60, 8),
    _x("aten::empty", "cpu_op", 61, 2),
    {"ph": "i", "name": "marker", "ts": 5},
]


def test_trace_numbers():
    t = trace.from_events(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((18 + 5 + 10) * 1e-6)
    assert t.kernel_s == pytest.approx((18 + 10) * 1e-6)
    assert t.device_ops == pytest.approx(
        {"nw_gotoh": 18e-6, "gather": 12e-6, "Memcpy DtoH": 5e-6})
    # idle: [0,12) [30,40) [45,70) [80,100) = 67 us; outside the calls
    # [0,10) [50,60) [95,100) = 25 us; in calls: [10,12) [30,40) [45,50)
    # [60,70) [80,95) = 42 us, of which aten::copy_ covers [35,40) and
    # [45,47), aten::to [60,68)
    idle = t.idle_by_host
    assert sum(idle.values()) == pytest.approx(67e-6)
    assert idle[trace.BETWEEN_CALLS] == pytest.approx(25e-6)
    assert idle["aten::copy_"] == pytest.approx(7e-6)
    assert idle["aten::to"] == pytest.approx(8e-6)
    assert "aten::empty" not in idle
    assert idle[trace.NO_OP] == pytest.approx(27e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["nw_gotoh", pytest.approx(18e-6)]
    assert b["idle_gaps"][0][0] in (trace.NO_OP, trace.BETWEEN_CALLS)
    assert len(b["idle_gaps"]) <= 10


def test_one_window_span_is_required():
    with pytest.raises(ValueError):
        trace.from_events(EVENTS[1:])


def _run(**kw):
    base = dict(unit="pairs", work=1000, bounds={"nw_dp": 2e-6,
                "compare": 1e-6}, calls=[(0.0, 0.5), (0.5, 1.5),
                                         (1.5, 2.0)],
                window_s=2.0, setup_s=7.5,
                trace=trace.from_events(EVENTS))
    return run.Run(**{**base, **kw})


def _read(name, r):
    return run.reader(name)(r)


def test_end_to_end_readers():
    r = _run()
    assert _read("setup_s", r) == 7.5
    assert _read("nw_pairs_per_s", r) == pytest.approx(1500.0)
    assert _read("mh_pairs_per_s", r) == pytest.approx(1500.0)
    # the four-chip cell's whole-call rate, a per-layer metric there
    assert _read("pairs_per_s.nw4", r) == pytest.approx(1500.0)
    # a call whose work is counted in another unit is no pair
    assert _read("nw_pairs_per_s", _run(unit="seqs")) is None
    assert _read("pairs_per_s.nw4", _run(calls=[])) is None


def test_per_layer_readers():
    r = _run()
    # 3 calls of 2 us of bound over 28 us of kernels
    assert _read("nw_dp_roofline", r) == pytest.approx(100 * 6 / 28)
    assert _read("compare_roofline.mh", r) == pytest.approx(100 * 3 / 28)
    for name in ("idle_share.nw", "idle_share.mh"):
        assert _read(name, r) == pytest.approx(67.0)
    bare = _run(trace=None, bounds={})
    for name in ("nw_dp_roofline", "compare_roofline.mh", "idle_share.nw",
                 "idle_share.mh"):
        assert _read(name, bare) is None


def test_every_metric_has_a_reader():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_minhash_counts_charge_one_instruction_and_each_pair_once():
    from portbench import counts

    # a 4-byte block: xor, funnel-shift rotate, multiply-add; finaliser 9;
    # the minimum 1; a tail of 1-3 bytes adds its xor
    assert [counts.ops_per_hash(k) for k in (2, 4, 5, 8)] == [11, 13, 14, 16]
    n, h = 1000, 50
    pairs = n * (n - 1) // 2
    assert counts.compare_bound_s(pairs, h, 0) == pytest.approx(
        2 * pairs * h / counts.ALU_OPS_PER_S)


# rank 0 of a four-chip window of 100 us: the NW kernel at [10, 40) and
# [50, 60); the all-reduce at [40, 70), on NCCL's stream beside the second
# NW kernel; another NCCL kernel (a templated name) at [90, 110), half
# past the window; a copy at [75, 80)
NW_KERNEL = "void nw_gotoh_kernel<32, 18>(int const*, int const*)"
NCCL_EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0, 100),
    _x(trace.CALL, "user_annotation", 5, 90),
    _x(NW_KERNEL, "kernel", 10, 30),
    _x(NW_KERNEL, "kernel", 50, 10),
    _x("ncclDevKernel_AllReduce_Sum_i32_RING_LL(ncclDevKernelArgsStorage"
       "<4096ul>)", "kernel", 40, 30),
    _x("void ncclKernel<0, 1>(ncclWorkElem)", "kernel", 90, 20),
    _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 75, 5),
]


def _rank0(**kw):
    return _run(**{"bounds": {"nw_dp_per_chip": 2e-6},
                   "trace": trace.from_events(NCCL_EVENTS), **kw})


def test_kernel_time_by_name():
    t = trace.from_events(NCCL_EVENTS)
    assert t.kernel_s == pytest.approx(70e-6)
    # [40, 70) and [90, 100)
    assert t.kernel_s_named("nccl") == pytest.approx(40e-6)
    # [10, 40) and [50, 60): the overlap with NCCL counts for both
    assert t.kernel_s_named("nccl", matching=False) == pytest.approx(40e-6)
    assert t.kernel_s_named("Memcpy") == 0.0
    assert len(t.kernel_names) == len(t.kernel_iv) == 4


def test_four_chip_readers():
    r = _rank0()
    # 3 calls of 1,000 pairs over the busy [10, 70) [75, 80) [90, 100)
    assert _read("nw4_busy_pairs_per_s", r) == pytest.approx(3000 / 75e-6)
    assert _read("collective_share.nw4", r) == pytest.approx(40.0)
    # 3 calls of 2 us of one rank's bound over 40 us of NW kernels
    assert _read("nw_dp_roofline.nw4", r) == pytest.approx(100 * 6 / 40)
    # the whole call's bound is never applied to one rank's kernels
    assert _read("nw_dp_roofline", r) is None


def test_four_chip_readers_find_nothing_to_read():
    # a one-chip window: no NCCL kernel and no per-chip bound
    one = _run()
    assert _read("collective_share.nw4", one) is None
    assert _read("nw_dp_roofline.nw4", one) is None
    # an untraced run
    for name in ("collective_share.nw4", "nw_dp_roofline.nw4",
                 "nw4_busy_pairs_per_s"):
        assert _read(name, _rank0(trace=None)) is None
    # no call, or work in another unit
    assert _read("nw4_busy_pairs_per_s", _rank0(calls=[])) is None
    assert _read("nw4_busy_pairs_per_s", _rank0(unit="seqs")) is None
    # a window of NCCL kernels alone has no NW kernel time to read
    only = [e for e in NCCL_EVENTS if "nw_gotoh" not in e["name"]]
    r = _rank0(trace=trace.from_events(only))
    assert _read("nw_dp_roofline.nw4", r) is None
    assert _read("collective_share.nw4", r) == pytest.approx(40.0)


def test_busy_rate_needs_a_device_operation():
    only_host = [e for e in EVENTS if e.get("cat") in ("user_annotation",
                                                  "cpu_op")]
    r = _rank0(trace=trace.from_events(only_host))
    assert _read("nw4_busy_pairs_per_s", r) is None


def test_device_trace_end_to_end_metrics_trace_their_cells_runs():
    """A cell whose end-to-end metrics include one read from the device
    trace is traced in every run; the others' runs without --trace 1 are
    not."""
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        e2e = run.reported(bench, w["name"], False)
        assert {"setup_s"} < {m["name"] for m in e2e}
        traced = any(m["source"] == "device_trace" for m in e2e)
        assert traced == (w["name"] == "nw_blosum62.h3n2_all_4chip")
    names = {m["name"] for m in run.reported(
        bench, "nw_blosum62.h3n2_all_4chip", True)}
    assert names == {"collective_share.nw4", "nw_dp_roofline.nw4",
                     "pairs_per_s.nw4"}
