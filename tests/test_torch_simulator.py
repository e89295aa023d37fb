"""The port's job simulator and on-device LPT against the reference's.

* ``simulate_job`` for all six PUMA benchmarks × S/M/L × hadoop/os4m
  through both packages in this one process: every ``SimResult`` field
  equal (``==`` on floats and lists). ``synth_key_distribution`` seeds
  with ``hash(spec.name)``, which Python salts per process, so the two
  packages agree within a process, not across processes.
* ``synth_key_distribution`` arrays equal; ``ClusterSpec`` and the PUMA
  table equal field by field.
* The reference's three qualitative checks (``TestSimulator``) on the port.
* ``lpt_assign_torch`` against ``lpt_assign_jax``: the cases of the
  reference's own tests, fractional speeds over integer loads, a dead slot,
  tied loads, float64 / int64 inputs (computed in float32 / int32 as JAX
  does with 64-bit types off); the assignment equal, the slot loads equal
  in value and type. On the card: equal to the CPU, with no host sync.

The simulator's durations are model seconds of the paper's cluster.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import simulator as tsim
from repro_torch.core.scheduler import lpt_assign_torch, schedule_lpt

SIZES = ("S", "M", "L")
MODES = ("hadoop", "os4m")


@pytest.mark.parametrize("bench", list(tsim.PUMA_BENCHMARKS))
def test_simulate_job_equals_reference(bench):
    from repro.core import simulator as rsim

    for size in SIZES:
        for mode in MODES:
            got = tsim.simulate_job(bench, size, mode)
            want = rsim.simulate_job(bench, size, mode)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (bench, size, mode)


@pytest.mark.parametrize("bench", list(tsim.PUMA_BENCHMARKS))
def test_synth_key_distribution_equals_reference(bench):
    from repro.core import simulator as rsim

    for seed in (0, 3):
        for gb in (5, 30):
            got = tsim.synth_key_distribution(tsim.PUMA_BENCHMARKS[bench], gb * 2**30, seed)
            want = rsim.synth_key_distribution(rsim.PUMA_BENCHMARKS[bench], gb * 2**30, seed)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_specs_equal_reference():
    from repro.core import simulator as rsim

    assert dataclasses.asdict(tsim.PAPER_CLUSTER) == dataclasses.asdict(rsim.PAPER_CLUSTER)
    assert (tsim.PAPER_CLUSTER.map_slots, tsim.PAPER_CLUSTER.reduce_slots) == \
        (rsim.PAPER_CLUSTER.map_slots, rsim.PAPER_CLUSTER.reduce_slots) == (32, 32)
    assert {k: dataclasses.asdict(v) for k, v in tsim.PUMA_BENCHMARKS.items()} == \
        {k: dataclasses.asdict(v) for k, v in rsim.PUMA_BENCHMARKS.items()}
    assert tsim.__all__ == rsim.__all__


def test_simulate_job_non_default_arguments_equal_reference():
    from repro.core import simulator as rsim

    kw = dict(num_reduce=12, num_clusters=96, pipeline_order="decreasing", seed=5)
    for mode in MODES:
        got = tsim.simulate_job("RII", "M", mode, cluster=tsim.ClusterSpec(num_nodes=4), **kw)
        want = rsim.simulate_job("RII", "M", mode, cluster=rsim.ClusterSpec(num_nodes=4), **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


class TestSimulator:
    """The reference's ``tests/test_serve_simulator.py::TestSimulator`` on the port."""

    @pytest.mark.parametrize("bench", list(tsim.PUMA_BENCHMARKS))
    def test_os4m_faster_on_all_benchmarks(self, bench):
        h = tsim.simulate_job(bench, "M", "hadoop")
        o = tsim.simulate_job(bench, "M", "os4m")
        assert o.job_duration < h.job_duration
        assert o.avg_map_duration < h.avg_map_duration

    def test_balance_ratio_improves(self):
        h = tsim.simulate_job("RII", "S", "hadoop")
        o = tsim.simulate_job("RII", "S", "os4m")
        assert o.balance_ratio < h.balance_ratio

    def test_map_waves_flat_for_os4m(self):
        o = tsim.simulate_job("II", "S", "os4m")
        h = tsim.simulate_job("II", "S", "hadoop")
        ot = np.diff([t for t, _ in o.map_progress])
        ht = np.diff([t for t, _ in h.map_progress])
        assert np.allclose(ot, ot[0])
        assert ht[-1] > ht[0]


def test_simulate_job_runs_no_device_code(monkeypatch):
    """The simulator is host code: it never makes a tensor."""
    def refuse(*args, **kwargs):
        raise AssertionError("the simulator made a tensor")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    assert tsim.simulate_job("SJ", "S", "os4m").job_duration > 0


# ---------------------------------------------------------------------------
# lpt_assign_torch
# ---------------------------------------------------------------------------


def _against_reference(loads, m, speeds=None):
    from repro.core import scheduler as rsched

    ra, rl = rsched.lpt_assign_jax(loads, m, speeds=speeds)
    pa, pl = lpt_assign_torch(loads, m, speeds=speeds, device="cpu")
    assert pa.dtype == torch.int32
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    assert pl.numpy().dtype == np.asarray(rl).dtype
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    return pa.numpy(), pl.numpy()


def test_lpt_matches_host_lpt():
    """The case of the reference's ``test_lpt_assign_jax_matches_host``."""
    loads = np.asarray([5, 3, 8, 1, 9, 2, 7, 4], float)
    assign, _ = _against_reference(loads, 3)
    got = np.bincount(assign, weights=loads, minlength=3)
    assert np.isclose(sorted(got)[-1], schedule_lpt(loads, 3).max_load)


def test_lpt_integer_loads_fractional_speeds():
    """The reference's ``test_lpt_assign_jax_integer_loads_fractional_speeds``:
    integer loads do not truncate fractional speeds (computed in float32)."""
    loads = np.asarray([5, 3, 2, 2], np.int32)
    assign, slot_loads = _against_reference(loads, 2, speeds=[1.0, 0.5])
    assert slot_loads.dtype == np.float32
    got = np.bincount(assign, weights=[5, 3, 2, 2], minlength=2)
    assert got.min() > 0
    host = schedule_lpt(np.asarray([5.0, 3.0, 2.0, 2.0]), 2, speeds=np.asarray([1.0, 0.5]))
    assert (got / np.asarray([1.0, 0.5])).max() == pytest.approx(host.makespan)


@pytest.mark.parametrize("speeds_kind", [None, "ones"])
def test_lpt_golden_cases_with_and_without_speeds(speeds_kind):
    """The ``lpt_jax`` golden assignments (the reference's
    ``test_heterogeneous.py`` replays them with nominal speeds too)."""
    import json
    import pathlib

    golden = json.loads((pathlib.Path(__file__).parent / "data"
                         / "golden_assignments.json").read_text())
    checked = 0
    for key, case in golden.items():
        if "lpt_jax" not in case["assignments"]:
            continue
        rng = np.random.default_rng(case["seed"])
        loads = rng.zipf(1.3, case["n"]).clip(1, 20_000).astype(float)
        speeds = None if speeds_kind is None else np.ones(case["m"])
        got, _ = lpt_assign_torch(loads, case["m"], speeds=speeds, device="cpu")
        np.testing.assert_array_equal(got.numpy(), case["assignments"]["lpt_jax"], err_msg=key)
        checked += 1
    assert checked == 4


@pytest.mark.parametrize("kind", ["float64", "float32", "int32", "int64", "float16"])
def test_lpt_dtypes_dead_slot_and_ties(kind):
    """Tied loads (few distinct values), a dead slot (speed 0: no load), and
    fractional speeds, in each input type."""
    rng = np.random.default_rng(7)
    for trial, m in enumerate((1, 3, 5)):
        loads = rng.integers(0, 4, 40).astype(kind)
        _against_reference(loads, m)
        speeds = rng.choice([0.0, 0.3, 0.5, 1.0, 2.0], m)
        speeds[trial % m] = 1.0                      # one slot alive at least
        if m > 1:
            speeds[(trial + 1) % m] = 0.0            # one dead
        assign, slot_loads = _against_reference(loads, m, speeds=speeds)
        for dead in np.nonzero(speeds == 0.0)[0]:
            assert not np.any(assign == dead) and slot_loads[dead] == 0


def test_lpt_devices_and_inputs():
    loads = torch.tensor([4.0, 1.0, 3.0])
    a, s = lpt_assign_torch(loads, 2)                # a tensor stays on its device
    assert a.device.type == "cpu" and a.tolist() == [0, 1, 1]
    assert lpt_assign_torch([4.0, 1.0, 3.0], 2, device="cpu")[0].tolist() == [0, 1, 1]
    assert lpt_assign_torch(np.zeros(0), 3, device="cpu")[0].shape == (0,)
    with pytest.raises(ValueError):
        lpt_assign_torch(loads, 2, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lpt_assign_torch([4.0, 1.0, 3.0], 2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,dead", [(160, 16, None), (352, 32, 5), (4096, 64, None)])
def test_lpt_on_the_card_equals_cpu_without_sync(n, m, dead):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n)
    loads = rng.zipf(1.3, n).clip(1, 20_000).astype(np.float32)
    speeds = None
    if dead is not None:
        speeds = np.ones(m, np.float32)
        speeds[0], speeds[dead] = 0.5, 0.0
    want_a, want_l = lpt_assign_torch(loads, m, speeds=speeds, device="cpu")
    loads_d = torch.as_tensor(loads, device="cuda")
    speeds_d = None if speeds is None else torch.as_tensor(speeds, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_a, got_l = lpt_assign_torch(loads_d, m, speeds=speeds_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got_a.device.type == "cuda"
    assert torch.equal(got_a.cpu(), want_a) and torch.equal(got_l.cpu(), want_l)
