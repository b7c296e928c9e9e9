"""The yardstick, the metric readers and the trace reduction, on made-up
records and timings."""

import types

import pytest

from mzbench import harness, trace, yardstick


def test_roofline_and_rate():
    assert yardstick.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert yardstick.roofline_pct(1.0, 0.0) is None
    assert yardstick.gbps(2e9, 4.0) == pytest.approx(0.5)


def test_order_statistics():
    vals = list(range(1, 101))
    assert yardstick.nearest_rank(vals, 0.95) == 95
    assert yardstick.nearest_rank([3.0], 0.95) == 3.0
    assert yardstick.median([4, 1, 3, 2]) == 2.5
    assert yardstick.median([5, 1, 3]) == 3


def decode_rec():
    return {"kind": "decode", "window_s": 2.0, "setup_s": 12.5,
            "bytes_out": [32 << 20] * 100, "bytes_in": [10 << 20] * 100,
            "latency_s": [0.001 * (i + 1) for i in range(100)],
            "enqueue_s": [0.0002] * 99 + [0.05]}


def encode_rec():
    return {"kind": "encode", "window_s": 10.0, "setup_s": 9.0,
            "bytes_in": 1 << 30, "bytes_out": 400 << 20}


def read(name, rec, tr=None):
    return harness.load_metric(name).read(rec, tr)


def test_decode_readers():
    rec = decode_rec()
    tr = {"busy_s": 1.5, "window_s": 2.0}
    assert read("decode_gbps", rec) == pytest.approx(100 * (32 << 20) / 2e9)
    assert read("decode_p95_ms", rec) == pytest.approx(95.0)
    assert read("enqueue_ms.decode", rec) == pytest.approx(0.2)
    assert read("idle_share.decode", rec, tr) == pytest.approx(25.0)
    assert read("idle_share.decode", rec) is None
    moved = 100 * (42 << 20)
    assert read("decode_roofline", rec, tr) == \
        pytest.approx(100 * moved / 3.35e12 / 1.5)
    assert read("setup_s", rec) == 12.5
    for name in ("encode_gbps", "ratio", "idle_share.compress",
                 "encode_roofline"):
        assert read(name, rec, tr) is None


def test_encode_readers():
    rec = encode_rec()
    tr = {"busy_s": 8.0, "window_s": 10.0}
    assert read("encode_gbps", rec) == pytest.approx((1 << 30) / 1e10)
    assert read("ratio", rec) == pytest.approx(400 / 1024)
    assert read("idle_share.compress", rec, tr) == pytest.approx(20.0)
    assert read("encode_roofline", rec, tr) == \
        pytest.approx(100 * ((1 << 30) + (400 << 20)) / 3.35e12 / 8.0)
    for name in ("decode_gbps", "decode_p95_ms", "decode_roofline"):
        assert read(name, rec, tr) is None


def test_every_metric_has_a_reader():
    bench = harness.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_metrics_of_a_cell():
    bench = harness.benchmark()
    names = [m["name"] for m in harness.metrics_for(
        bench, "nyc-taxi-csv.decode-resident", False)]
    assert set(names) == {"decode_gbps", "decode_p95_ms", "setup_s"}
    names = [m["name"] for m in harness.metrics_for(
        bench, "gharchive-json.compress-emit", True)]
    assert set(names) == {"idle_share.compress", "encode_roofline"}


class FakeEvent:
    def __init__(self, name, device, start_us, end_us):
        self._n, self._d = name, device
        self._s, self._e = start_us, end_us

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._d else DeviceType.CPU

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int((self._e - self._s) * 1000)

    def is_user_annotation(self):
        return self._n.startswith("mzbench.")


def fake_prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_trace_reduction():
    ev = [FakeEvent("mzbench.window", False, 0, 1000),
          FakeEvent("mzbench.window", True, 0, 1000),  # device mirror
          FakeEvent("mzbench.decode_planned", False, 0, 100),
          FakeEvent("cudaLaunchKernel", False, 40, 60),
          FakeEvent("mzbench.wait", False, 100, 600),
          FakeEvent("k3", True, 100, 400),
          FakeEvent("k1", True, 300, 500),
          FakeEvent("k1", True, 700, 750),
          FakeEvent("late", True, 900, 1200)]
    r = trace.reduce(fake_prof(ev))
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(550e-6)  # 100-500, 700-750, 900-1000
    assert r["device_ops"][0] == ["k3", pytest.approx(300e-6)]
    assert dict(map(tuple, r["device_ops"]))["k1"] == pytest.approx(250e-6)
    gaps = dict(map(tuple, r["idle_gaps"]))
    assert gaps["mzbench.decode_planned/cudaLaunchKernel"] == \
        pytest.approx(100e-6)
    assert gaps["mzbench.wait"] == pytest.approx(200e-6)
    assert gaps["host"] == pytest.approx(150e-6)


def test_trace_without_device_work_is_an_error():
    ev = [FakeEvent("mzbench.window", False, 0, 1000)]
    with pytest.raises(RuntimeError):
        trace.reduce(fake_prof(ev))


def test_names_are_cleaned():
    assert trace.clean("void a::b<int>(x, y)") == "void_a::b_int_x_y_"
    assert len(trace.clean("x" * 100)) == 64

