"""The window's arithmetic by hand: rates over the whole window, p90 over
every frame, idle share as a union of intervals, the query byte floor, and
spans' device time read from a Chrome trace."""
import pytest

from perfbench import stats, trace
from perfbench.loops import first_frame


def test_rate_is_over_the_whole_window():
    # 10 frames in 2.5 s: 250 ms a frame, whatever the frames' own times
    assert stats.per_item_ms(2.5, 10) == pytest.approx(250.0)
    with pytest.raises(ValueError):
        stats.per_item_ms(1.0, 0)


def test_p90_takes_every_frame():
    frames = [100.0] * 18 + [300.0, 900.0]
    # nearest rank: the 18th of 20 sorted values
    assert stats.percentile(frames, 90.0) == 100.0
    assert stats.percentile(frames + [500.0, 500.0], 90.0) == 500.0
    assert stats.percentile(list(range(1, 11)), 90.0) == 9
    assert stats.percentile([7.0], 90.0) == 7.0


def test_idle_share_is_a_union():
    # two overlapping kernels on two streams count once: busy 0-4 and 6-7
    iv = [(0.0, 3.0), (1.0, 4.0), (6.0, 7.0)]
    assert stats.merge_intervals(iv) == [(0.0, 4.0), (6.0, 7.0)]
    assert stats.union_length(iv) == 5.0
    assert stats.idle_share(iv, 10.0) == pytest.approx(0.5)
    assert stats.gaps(iv, 0.0, 10.0) == [(4.0, 6.0), (7.0, 10.0)]
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (4.0, 5.0)]


def test_query_byte_floor_by_hand():
    # a scene of 2 triangles, one closest-hit query of 3 live rays and one
    # occlusion query of 2: rays 3 x (32 + 8) + 2 x (32 + 1), triangles
    # 2 x 36 a query
    assert stats.query_bytes(3, 2, 2, 2) == 3 * 40 + 2 * 33 + 2 * 2 * 36 == 330


def test_first_frame_has_one_bit():
    t = {"first_frame_log2": 10, "first_frame_span": 21}
    frames = {first_frame(s, t) for s in (0, 1, 9, 20, 2**31 + 5, 12345678901)}
    assert all(bin(f).count("1") == 1 and 1024 <= f <= 2**30 for f in frames)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_trace_spans_take_their_launches_device_time():
    events = [
        _ev("user_annotation", trace.WINDOW_SPAN, 0, 100),
        _ev("user_annotation", "perfbench.query.intersect", 10, 20),
        _ev("cpu_op", "aten::add", 12, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=3),
        _ev("kernel", "k1", 15, 4, correlation=1),
        _ev("kernel", "k2", 40, 6, correlation=2),
        _ev("gpu_memcpy", "copy", 60, 10, correlation=3),
        _ev("gpu_user_annotation", "perfbench.query.intersect", 15, 31),
    ]
    rec = trace.parse(events, "progressive")
    assert rec.spans["perfbench.query.intersect"] == [(10.0, 20.0, 10.0)]
    assert len(rec.kernels) == 2 and len(rec.device) == 3
    assert rec.busy_s == pytest.approx(20e-6)
    assert trace.top_device_ops(rec)[0] == ["copy", pytest.approx(10e-6)]
    # gaps 0-15, 19-40, 46-60, 70-100: the one at 19 opens inside the span
    idle = dict(trace.idle_by_host_op(rec))
    assert idle == {"python": pytest.approx(59e-6),
                    "perfbench.query.intersect": pytest.approx(21e-6)}


def test_idle_share_divides_by_the_untraced_time():
    # 8 traced frames busy 0.8 s in all; the window's 40 untraced frames
    # took 10 s, so the 8 take 2 s untraced and the device idles 60% of
    # them, however long the profiler made the traced window
    from perfbench import manifest

    assert trace.untraced_s(8, 10.0, 40) == pytest.approx(2.0)
    assert trace.untraced_s(8, 0.0, 0) == 0.0
    rec = trace.Record(loop="progressive", window_s=3.5,
                       device=[("k", i * 1e5, 1e5) for i in range(8)])
    idle = manifest.reader("device.idle_share.render")
    assert idle(rec) is None  # no untraced rest: nothing to read
    rec.untraced_s = 2.0
    assert idle(rec) == pytest.approx(60.0)
    rec.loop, rec.kernels = "sharded", [("ncclKernel_AllReduce", 0.0, 2e4)]
    assert manifest.reader("dist.collective_share")(rec) == pytest.approx(1.0)


@pytest.mark.parametrize("f0", [1024, 2048, 2**30])
@pytest.mark.parametrize("per", [1, 4])
def test_traced_samples_have_the_same_set_bits(f0, per):
    # however many items the window held, the traced samples' indices
    # (f0 + start * per + k) have the same number of set bits each
    from perfbench.loops import trace_start

    counts = set()
    for done in (1, 7, 200, 280, 513, 1024, 3000):
        start = trace_start(done, 8, f0, per)
        assert start >= done
        counts.add(tuple(bin(f0 + start * per + k).count("1") for k in range(8 * per)))
    assert len(counts) == 1
