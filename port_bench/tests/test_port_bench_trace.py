"""The reduction from a trace to per-layer metrics, on a hand-made trace."""

import pytest

from port_bench import cells, trace, work


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    ev = [
        _x("stream_window", "user_annotation", 0, 100),
        _x("stream_window", "user_annotation", 200, 100),
        # window 1: chain 10..30, copy 25..45 (overlaps), stock 60..70
        _x("void esr::conv3x3_chain_wgmma_kernel<__half, 2, false>(...)", "kernel", 10, 20),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 25, 20),
        _x("cudnn_conv_kernel", "kernel", 60, 10),
        # window 2: tail 190..210 (clipped to 200..210), stock 250..260
        _x("void conv3x3_pixelshuffle_wgmma_kernel<__half, 2, false>(...)", "kernel", 190, 20),
        _x("elementwise_kernel", "kernel", 250, 10),
        # outside every window
        _x("cudnn_conv_kernel", "kernel", 120, 50),
        # host calls
        _x("aten::copy_", "cpu_op", 40, 40),
        _x("cudaStreamSynchronize", "cuda_runtime", 45, 10),
        _x("aten::stack", "cpu_op", 260, 40),
    ]
    return trace.Trace(ev, "stream_window")


def test_busy_and_window():
    t = _trace()
    assert t.window_us == 200
    # window 1: 10..45 and 60..70; window 2: 200..210 and 250..260
    assert t.busy_us() == 35 + 10 + 10 + 10
    assert t.busy_us(("gpu_memcpy",)) == 20


def test_kernel_time_by_pattern():
    t = _trace()
    assert t.kernel_us(r"^(void )?(esr::)?conv3x3_chain") == 20
    assert t.kernel_us(r"^(void )?(esr::)?conv3x3_pixelshuffle") == 10
    assert t.kernel_us(None, exclude=(r"^(void )?(esr::)?conv3x3_chain",
                                      r"^(void )?(esr::)?conv3x3_pixelshuffle")) == 20


def test_idle_gaps_named_by_host():
    gaps = trace.Trace(_trace_events_for_gaps(), "w").idle_gaps(3)
    assert gaps[0] == ["cudaStreamSynchronize", 40e-6]
    assert gaps[1][1] == 10e-6


def _trace_events_for_gaps():
    return [
        _x("w", "user_annotation", 0, 100),
        _x("k", "kernel", 0, 10),
        _x("k", "kernel", 50, 40),
        _x("aten::copy_", "cpu_op", 5, 80),
        _x("cudaStreamSynchronize", "cuda_runtime", 8, 50),
    ]


def test_extent_and_protocol_idle():
    t = _trace()
    # window 1: 10..70, window 2: 200..260
    assert t.extent_us() == 60 + 60
    r = _reading(t)
    idle = cells.load_module("metrics", "device_idle.protocol").read(r)
    assert idle == pytest.approx(100 * (1 - 65 / 120))


def test_no_window_raises():
    with pytest.raises(ValueError):
        trace.Trace([_x("k", "kernel", 0, 1)], "stream_window")


def _reading(t, units=4, timed_s=None, tier="fasthi16"):
    cfg = cells.load_json(cells.path_of("configs", "rlfn", ".json"))
    return trace.Reading(trace=t, units=units, timed_s=timed_s or t.window_us / 1e6,
                         config=cfg, tier=tier, frame_hw=(256, 256), flops_per_frame=39.3e9)


def test_readers():
    t = _trace()
    r = _reading(t)
    read = {n: cells.load_module("metrics", n).read for n in (
        "copy_share.serve", "device_idle.serve", "mfu.serve", "mfu.protocol",
        "chain_roofline.serve", "tail_roofline.serve", "stock_ms_per_image.serve")}
    assert read["copy_share.serve"](r) == pytest.approx(100 * 20 / 65)
    assert read["device_idle.serve"](r) == pytest.approx(100 * (1 - 65 / 200))
    assert read["mfu.serve"](r) == pytest.approx(100 * 39.3e9 * 4 / (200e-6 * work.PEAK_FLOPS))
    bound = 4 * work.kernel_bound_s(r.config, "chain", "fasthi16", 256, 256)
    assert read["chain_roofline.serve"](r) == pytest.approx(100 * bound / 20e-6)
    tail = 4 * work.kernel_bound_s(r.config, "tail", "fasthi16", 256, 256)
    assert read["tail_roofline.serve"](r) == pytest.approx(100 * tail / 10e-6)
    assert read["stock_ms_per_image.serve"](r) == pytest.approx(1000 * 20e-6 / 4)
    # over the replays' device extent (120 us), not the driver's event time
    r2 = _reading(t, timed_s=1e-3)
    assert read["mfu.protocol"](r2) == pytest.approx(100 * 39.3e9 * 4 / (120e-6 * work.PEAK_FLOPS))


def test_reader_finds_nothing_returns_none():
    ev = [_x("stream_window", "user_annotation", 0, 100), _x("cudnn", "kernel", 10, 10)]
    r = _reading(trace.Trace(ev, "stream_window"))
    for n in ("chain_roofline.serve", "tail_roofline.serve", "copy_share.serve"):
        v = cells.load_module("metrics", n).read(r)
        assert v is None or n == "copy_share.serve" and v == 0.0
    cfg = cells.load_json(cells.path_of("configs", "imdn", ".json"))
    r.config = cfg
    assert cells.load_module("metrics", "chain_roofline.serve").read(r) is None
