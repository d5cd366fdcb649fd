"""The benchmark's arithmetic: rates, tails, spreads, bytes, busy time."""

import statistics

import pytest
import torch

from portbench import harness, stats
from portbench.record import Run, TracedChunk
from portbench.tracecap import Trace


def _run(**kw):
    base = dict(platform="gpu", device_kind="x", memory_peak_bytes=0,
                correct=True, attempted=4, failed=0, setup_s=1.0,
                window_s=2.0, pixels_per_frame=1920 * 1080, frames=32,
                latencies_ms=[10.0] * 20)
    base.update(kw)
    return Run(**base)


def _read(kind, name, run):
    return harness.load_module(harness.HERE / kind / f"{name}.py").read(run)


def test_rate_is_all_the_work_over_all_the_window():
    r = _run(frames=800, window_s=10.0)
    assert _read("end_to_end", "framed_mpx_s", r) == pytest.approx(
        1920 * 1080 * 800 / 10.0 / 1e6)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_p95_is_over_every_chunk_and_one_stall_moves_it():
    lat = [10.0] * 19 + [11.0]
    calm = _read("metrics", "chunk_p95_ms", _run(latencies_ms=lat))
    stalled = _read("metrics", "chunk_p95_ms",
                    _run(latencies_ms=lat[:-1] + [500.0]))
    assert calm == pytest.approx(10.05)
    assert stalled > calm + 20
    assert _read("metrics", "chunk_p95_ms", _run(latencies_ms=[])) is None


def test_quartile_spread_is_pythons_quantiles():
    v = [100.0, 101.0, 99.0, 103.0, 98.0, 100.5]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.quartile_spread(v) == pytest.approx((q3 - q1) / med)


def test_roofline_bytes_come_from_shapes_and_events():
    from adder_tpu_torch.ops import integrate

    for depth in (6, 8):  # every node live: the whole state
        st = integrate.init_state(100, "cpu", depth=depth)
        actual = sum(x.numel() * x.element_size() for x in st[:-1])
        assert stats.state_bytes(100, 100 * depth) == actual
    n = 1920 * 1080
    assert stats.chunk_bytes(8, n, n, 3 * n, 1000) == (
        8 * n + 5 * 4 * (n + 3 * n) + 2 * 27 * n + 8000)


def test_state_bytes_count_only_live_nodes():
    """Held to a count made node by node from a state the reference ran."""
    from portbench import reference

    W, H, T = 12, 8, 8
    n = W * H
    p = reference.Params(255, 24 * 255, 0, 0, 1)
    g = torch.Generator().manual_seed(5)
    base = torch.randint(0, 256, (n,), generator=g)
    frames = torch.stack([base] * T).to(torch.uint8)  # held: deeper arenas
    frames[:, ::2] = torch.randint(0, 256, (T, n // 2), generator=g,
                                   dtype=torch.uint8)  # changing: shallow
    st = reference.first_frame(reference.initial_state(n, p, "cpu"), frames[0])
    st = reference.run_chunk(st, frames, p, events=False).state
    lengths = st.length.tolist()
    assert len(set(lengths)) > 1  # some pixels deeper than others
    arena, fixed = 0, 0
    for i, k in enumerate(lengths):
        for node in range(k):
            for f in reference.ARENA:
                arena += getattr(st, f)[node, i].element_size()
    for f in reference.State._fields:
        x = getattr(st, f)
        if f not in reference.ARENA and x.dim() == 1:
            fixed += x.element_size() * n
    assert stats.state_bytes(n, int(st.length.sum())) == arena + fixed


def test_kernels_roofline_divides_by_the_kernels_own_time():
    n = 1920 * 1080
    need = stats.chunk_bytes(8, n, n, 2 * n, 0) / stats.HBM_BYTES_PER_S
    ops = [("void adder_resident_chunk_kernel<6>", 0.0, need * 5),
           ("Memcpy HtoD (Pageable -> Device)", 1.0, 1.5),
           ("adder_resident_chunk_kernel", 2.0, 2.0 + need * 5)]
    r = _run(trace=Trace(4.0, ops, [], {}),
             traced_chunks=[TracedChunk(8, n, n, 2 * n, 0)] * 2)
    assert _read("metrics", "kernels_roofline", r) == pytest.approx(20.0)
    assert _read("metrics", "h2d_pct", r) == pytest.approx(12.5)
    no_kernels = _run(trace=Trace(4.0, ops[1:2], [], {}),
                      traced_chunks=[TracedChunk(8, n, n, 2 * n, 0)])
    assert _read("metrics", "kernels_roofline", no_kernels) is None


def test_busy_idle_and_stage_shares():
    ops = [("k", 0.0, 1.0), ("k", 0.5, 1.5), ("m", 3.0, 4.0)]
    tr = Trace(5.0, ops, [("video.encode", 1.5, 3.0),
                          ("portbench.collect", 4.0, 5.0)],
               {"video.encode": 1.5, "video.submit_chunk": 0.25})
    r = _run(trace=tr)
    assert stats.busy([(a, b) for _, a, b in ops], 0.0, 5.0) == 2.5
    assert _read("metrics", "device_idle_pct", r) == pytest.approx(50.0)
    assert _read("metrics", "encode_pct", r) == pytest.approx(30.0)
    assert _read("metrics", "submit_pct", r) == pytest.approx(5.0)
    assert _read("metrics", "fetch_pct", r) is None
    b = harness.breakdown(tr)
    assert b["idle_gaps"] == [["video.encode", 1.5], ["portbench.collect", 1.0]]
    assert b["device_ops"][0] == ["k", 2.0]
    assert _read("metrics", "h2d_pct", r) is None
    assert _read("metrics", "device_idle_pct", _run()) is None


def test_gap_without_a_span_is_untraced():
    tr = Trace(2.0, [("k", 0.0, 1.0)], [], {})
    assert harness.breakdown(tr)["idle_gaps"] == [["untraced", 1.0]]


def test_union_merges_overlaps():
    assert stats.union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert stats.gaps([(1, 2)], 0, 3) == [(0, 1), (2, 3)]


def test_state_bytes_match_torch_dtypes():
    assert torch.zeros(1, dtype=torch.bool).element_size() == 1
