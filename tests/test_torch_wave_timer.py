"""The wave timer of the port (kernels 5–6) against the reference's.

The tick word format, the tick unit and the calibration are held against
the reference's numpy code on the same inputs; the plain versions of
``read_ticks`` / ``stamp_through`` (what CPU tensors run) are checked for
monotone stamps and bit-identical copies; ``force_backend`` drives the
``"none"`` backend; ``copy_split`` (the copy kernel's head / bulk body /
tail split) covers every byte once. The ``gpu`` cases launch the
``%globaltimer`` kernels: bitwise copies (through the bulk-copy ring and
the byte path, at sizes around one ring stage and one ring, at every
source and destination offset mod 16), stamps that advance across a
device-side spin, and stamp intervals against CUDA event times. The reference is imported inside the
CPU tests only, so the ``gpu`` cases also run where JAX is absent
(``--noconftest -m gpu``).
"""

import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels.wave_timer import calibration as tcal
from repro_torch.kernels.wave_timer import ops as wt
from repro_torch.kernels.wave_timer import ref as tref
from repro_torch.kernels.wave_timer.wave_timer import copy_split, stamp_through_cuda


# ---------------------------------------------------------------------------
# Word format, tick unit and calibration against the reference.
# ---------------------------------------------------------------------------


_TICKS = [0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 7, 1_700_000_000_123_456_789, 2 ** 62 + 3]


@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
def test_split_and_combine_match_reference(shape):
    from repro.kernels.wave_timer import ref as rref

    rng = np.random.default_rng(len(shape))
    ticks = rng.choice(np.asarray(_TICKS, np.uint64), size=shape)
    words = tref.split_ticks(ticks)
    np.testing.assert_array_equal(words, rref.split_ticks(ticks))
    assert words.dtype == np.uint32 and words.shape == tuple(shape) + (2,)
    np.testing.assert_array_equal(tref.combine_ticks(words), rref.combine_ticks(words))
    np.testing.assert_array_equal(tref.combine_ticks(words), ticks.astype(np.int64))


def test_combine_rejects_a_missing_word_axis():
    from repro.kernels.wave_timer import ref as rref

    for mod in (tref, rref):
        with pytest.raises(ValueError, match="word axis"):
            mod.combine_ticks(np.zeros((4, 3), np.uint32))


@pytest.mark.parametrize("spt", [1e-9, 2.5e-10, 3.3e-8])
def test_tick_calibration_matches_reference(spt):
    from repro.kernels.wave_timer import calibration as rcal

    mine, theirs = tcal.TickCalibration(spt, "t"), rcal.TickCalibration(spt, "t")
    ticks = np.asarray([0, 1, 999, 10 ** 9, 123_456_789_012])
    np.testing.assert_array_equal(mine.ticks_to_seconds(ticks), theirs.ticks_to_seconds(ticks))
    secs = np.asarray([0.0, 1e-9, 0.5, 1.25, 3600.0])
    np.testing.assert_array_equal(mine.seconds_to_ticks(secs), theirs.seconds_to_ticks(secs))
    assert tcal.HOST_NS == tcal.TickCalibration(1e-9, source="host-ns")
    assert tcal.HOST_NS.seconds_per_tick == rcal.HOST_NS.seconds_per_tick


@pytest.mark.parametrize("bad", [0.0, -1e-9, float("nan"), float("inf")])
def test_tick_calibration_rejects_bad_units(bad):
    from repro.kernels.wave_timer import calibration as rcal

    for mod in (tcal, rcal):
        with pytest.raises(ValueError):
            mod.TickCalibration(bad)


def _scripted_counter(step_ticks):
    """A counter that advances by ``step_ticks`` (a list) at each read pair."""
    values = itertools.accumulate(itertools.chain([10 ** 6], step_ticks))
    values = list(values)
    reads = iter(values)
    return lambda: next(reads)


def test_calibrate_matches_reference_on_a_scripted_counter(monkeypatch):
    """Both calibrations see the same counter and the same host clock."""
    from repro.kernels.wave_timer import calibration as rcal

    clock = {"t": 100.0}

    def perf_counter():
        clock["t"] += 0.001
        return clock["t"]

    steps = [3_000_000, 5, 3_100_000, 7, 2_900_000, 1, 3_000_000, 2, 3_050_000]
    results = []
    for mod in (tcal, rcal):
        clock["t"] = 100.0
        monkeypatch.setattr(mod.time, "perf_counter", perf_counter)
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        results.append(mod.calibrate(_scripted_counter(steps), repeats=5))
    assert results[0].seconds_per_tick == results[1].seconds_per_tick
    assert results[0].source == results[1].source == "device"


@pytest.mark.parametrize("package", ["port", "reference"])
def test_calibrate_raises_on_a_stopped_counter(package):
    if package == "reference":
        from repro.kernels.wave_timer import calibration as mod
    else:
        mod = tcal
    with pytest.raises(RuntimeError, match="never advanced"):
        mod.calibrate(lambda: 5, sleep_seconds=0.0, repeats=2)


def test_host_calibration_of_the_host_clock_is_near_one_ns():
    cal = tcal.calibrate(lambda: tref.combine_ticks(tref.read_ticks_ref()),
                         sleep_seconds=0.005, repeats=3)
    assert 0.8e-9 < cal.seconds_per_tick < 1.25e-9


# ---------------------------------------------------------------------------
# The plain versions (CPU tensors).
# ---------------------------------------------------------------------------


def test_cpu_stamps_are_monotone_host_nanoseconds():
    assert wt.backend(torch.zeros(1)) == "host" and wt.available("cpu")
    assert wt.tick_calibration("cpu") is tcal.HOST_NS
    x = torch.ones(3)
    stamps = [wt.read_ticks(x, device="cpu")]
    for _ in range(20):
        _, t = wt.stamp_through(x, x)
        stamps.append(t)
    stamps.append(wt.read_ticks(device="cpu"))
    assert all(s.dtype == torch.uint32 and s.shape == (2,) for s in stamps)
    values = wt.combine_ticks(np.stack([wt.ticks_numpy(s) for s in stamps]))
    assert (np.diff(values) >= 0).all() and values[-1] > values[0]


def _payload(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.bfloat16:
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max, n, endpoint=True)).to(dtype)


_DTYPES = [torch.float32, torch.int32, torch.uint8, torch.bfloat16]
_SIZES = [0, 1, 7, 4097]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bytes (PyTorch cannot re-view an empty tensor's bytes)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return a.numel() == 0 or torch.equal(a.cpu().view(torch.uint8), b.cpu().view(torch.uint8))


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("n", _SIZES)
def test_cpu_stamp_through_copies_bit_for_bit(dtype, n):
    x = _payload(dtype, n, seed=n)
    y, ticks = wt.stamp_through(x)
    assert y.dtype == dtype and y.shape == x.shape
    assert y.data_ptr() != x.data_ptr() or n == 0
    assert _same_bits(y, x)
    assert wt.combine_ticks(wt.ticks_numpy(ticks)) > 0


def test_force_backend_pins_and_restores():
    x = torch.zeros(4)
    with wt.force_backend("none"):
        assert wt.backend(x) == "none" and not wt.available(x)
        with pytest.raises(RuntimeError):
            wt.stamp_through(x)
        with pytest.raises(RuntimeError):
            wt.read_ticks(x)
        with pytest.raises(RuntimeError):
            wt.tick_calibration(x)
        with wt.force_backend(None):
            assert wt.backend(x) == "host"
        assert wt.backend(x) == "none"
    assert wt.backend(x) == "host" and wt.available(x)
    with pytest.raises(ValueError, match="unknown"):
        wt.force_backend("callback")


def test_cpu_tensors_never_count_as_launches():
    r0, s0 = wt.read_ticks_launches, wt.stamp_through_launches
    wt.stamp_through(torch.ones(5), torch.ones(1))
    wt.read_ticks(torch.ones(1))
    assert (wt.read_ticks_launches, wt.stamp_through_launches) == (r0, s0)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 1 << 40), st.integers(0, 1 << 40), st.integers(0, 1 << 20))
def test_copy_split_covers_every_byte_once(src, dst, nbytes):
    head, body = copy_split(src, dst, nbytes)
    tail = nbytes - head - body
    assert head >= 0 and body >= 0 and tail >= 0
    if (src - dst) % 16:
        assert (head, body) == (0, 0)                 # the byte path takes it all
        return
    assert body % 16 == 0
    if body:
        assert (src + head) % 16 == 0 and (dst + head) % 16 == 0
        assert head < 16 and tail < 16
    else:
        assert nbytes - head < 16
    pieces = [(0, head), (head, head + body), (head + body, nbytes)]
    cover = np.zeros(nbytes, np.int64)
    for lo, hi in pieces:
        cover[lo:hi] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("src_mod,dst_mod", [(s, d) for s in range(16) for d in (0, 3, 8)])
def test_copy_split_at_every_offset(src_mod, dst_mod):
    """Every source offset mod 16 against three destination offsets, at a
    size of one ring (6 stages of 32 KB) plus a few bytes."""
    nbytes = 6 * 32768 + 7
    head, body = copy_split(4096 + src_mod, 8192 + dst_mod, nbytes)
    if src_mod != dst_mod:
        assert (head, body) == (0, 0)
    else:
        assert head == (16 - src_mod) % 16
        assert body == (nbytes - head) // 16 * 16 and nbytes - head - body < 16


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("n", _SIZES + [1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_stamp_through_copies_bit_for_bit(dtype, n, offset):
    dev = _cuda()
    # offset=1 starts the primary one element into its buffer: against a
    # fresh (aligned) copy the two disagree mod 16, so the byte path copies.
    base = _payload(dtype, n + offset, seed=n).to(dev)
    x = base[offset:]
    s0 = wt.stamp_through_launches
    y, ticks = wt.stamp_through(x, base)
    torch.cuda.synchronize()
    assert wt.stamp_through_launches == s0 + 1
    assert y.device == dev and y.dtype == dtype and y.shape == x.shape
    assert _same_bits(y, x)
    assert ticks.device == dev and ticks.dtype == torch.uint32
    assert wt.combine_ticks(wt.ticks_numpy(ticks)) > 0


# Bytes around one 32 KB ring stage and one ring of 6 stages, and a share
# of several rings a CTA.
_RING_SIZES = [32768 - 16, 32768, 32768 + 17, 6 * 32768 - 1, 6 * 32768, 6 * 32768 + 33,
               132 * 6 * 32768 + 5]


@pytest.mark.gpu
@pytest.mark.parametrize("nbytes", _RING_SIZES)
@pytest.mark.parametrize("src_off", range(16))
def test_cuda_stamp_through_ring_at_every_offset(nbytes, src_off):
    """Source offsets 0-15 each, with the destination at the same offset
    mod 16 (the bulk-copy ring, with a head and a tail) and at offset 0
    (the byte path unless the source is aligned too)."""
    dev = _cuda()
    base = _payload(torch.uint8, nbytes + 16, seed=nbytes + src_off).to(dev)
    src = base[src_off:src_off + nbytes]
    for dst_off in sorted({src_off, 0}):
        buf = torch.full((nbytes + 16,), 0xA5, dtype=torch.uint8, device=dev)
        dst = buf[dst_off:dst_off + nbytes]
        ticks = torch.zeros(2, dtype=torch.uint32, device=dev)
        stamp_through_cuda(src, dst, [base], ticks)
        torch.cuda.synchronize()
        assert torch.equal(dst, src), (nbytes, src_off, dst_off)
        assert (buf[:dst_off] == 0xA5).all() and (buf[dst_off + nbytes:] == 0xA5).all()
        assert wt.combine_ticks(wt.ticks_numpy(ticks)) > 0


@pytest.mark.gpu
def test_cuda_stamps_advance_across_a_device_spin():
    dev = _cuda()
    r0 = wt.read_ticks_launches
    a = wt.read_ticks(device=dev)
    torch.cuda._sleep(2_000_000)                 # ~1 ms of device-side spin
    _, b = wt.stamp_through(torch.zeros(16, device=dev))
    torch.cuda._sleep(2_000_000)
    c = wt.read_ticks(torch.ones(1, device=dev))
    torch.cuda.synchronize()
    assert wt.read_ticks_launches == r0 + 2
    ticks = wt.combine_ticks(np.stack([wt.ticks_numpy(t) for t in (a, b, c)]))
    assert ticks[0] < ticks[1] < ticks[2]


@pytest.mark.gpu
def test_cuda_stamp_interval_matches_cuda_events():
    """Two stamps around >= 10 ms of device work agree with CUDA event
    elapsed time within 5% (ticks calibrated to seconds)."""
    dev = _cuda()
    cal = wt.tick_calibration(dev)
    assert 0.95e-9 < cal.seconds_per_tick < 1.05e-9       # %globaltimer: ns
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        start.record()
        t0 = wt.read_ticks(device=dev)
        torch.cuda._sleep(40_000_000)
        t1 = wt.read_ticks(device=dev)
        end.record()
        torch.cuda.synchronize()
        event_s = start.elapsed_time(end) / 1e3
        ticks = wt.combine_ticks(np.stack([wt.ticks_numpy(t0), wt.ticks_numpy(t1)]))
        stamp_s = float(ticks[1] - ticks[0]) * cal.seconds_per_tick
        if event_s >= 0.01:
            break
    assert event_s >= 0.01, "the spin was shorter than 10 ms"
    assert abs(stamp_s - event_s) <= 0.05 * event_s, (stamp_s, event_s)


@pytest.mark.gpu
def test_cuda_read_ticks_waits_for_an_anchor_of_another_stream():
    dev = _cuda()
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        before = wt.read_ticks(device=dev)
        torch.cuda._sleep(5_000_000)
        anchor = torch.ones(8, device=dev)
    stamp = wt.read_ticks(anchor, streams=[side])
    torch.cuda.synchronize()
    ticks = wt.combine_ticks(np.stack([wt.ticks_numpy(before), wt.ticks_numpy(stamp)]))
    cal = wt.tick_calibration(dev)
    assert (ticks[1] - ticks[0]) * cal.seconds_per_tick > 1e-3


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _cuda()
    with pytest.raises(ValueError, match="contiguous"):
        wt.stamp_through(torch.zeros(4, 4, device=dev).t())
    with pytest.raises(ValueError, match="anchor"):
        wt.stamp_through(torch.zeros(4, device=dev), torch.zeros(1))
    with pytest.raises(ValueError, match="at most"):
        wt.read_ticks(*[torch.zeros(1, device=dev)] * 9)
