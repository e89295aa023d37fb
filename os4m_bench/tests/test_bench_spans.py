"""The readers of the program's spans inside a job, on synthetic runs: each
reads the median over the jobs, the gap a per-job difference, and each
returns None where the program records no such span."""

import pytest

from os4m_bench import harness, spec

STAGE = {"phase_a_device_ms.recurring": "phase_a.map_stats",
         "decide_ms.recurring": "phase_a.decide",
         "spill_ms.recurring": "phase_b.spill",
         "copy_ms.recurring": "phase_b.copy",
         "rank_sort_ms.recurring": "phase_b.rank_sort",
         "reduce_ms.recurring": "phase_b.reduce"}
GAP = "phase_b_gap_ms.recurring"


def run_of(phase_ms_list):
    jobs = [harness.Job(i % 4, i * 0.04, i * 0.04 + 0.039, ms)
            for i, ms in enumerate(phase_ms_list)]
    return harness.Run({}, jobs, 1.0, 10.0, [100] * 4)


def job_ms(b, spill, copy, rank_sort, reduce, **extra):
    return {"phase_a": 0.5, "plan": 0.01, "phase_b": b, "phase_a.map_stats": 0.2,
            "phase_a.decide": 0.1, "phase_b.spill": spill, "phase_b.copy": copy,
            "phase_b.rank_sort": rank_sort, "phase_b.reduce": reduce, **extra}


def test_every_new_metric_is_a_cell_entry():
    names = {m.name for m in spec.load_cell("rii-recurring").per_layer}
    assert set(STAGE) | {GAP, "phase_b_ms.recurring"} <= names


@pytest.mark.parametrize("name", sorted(STAGE))
def test_stage_readers_read_the_median(name):
    key = STAGE[name]
    jobs = [job_ms(38.0, 12.0, 7.0, 5.0, 3.0) for _ in range(5)]
    for i, value in enumerate([4.0, 1.0, 3.0, 9.0, 2.0]):
        jobs[i][key] = value
    assert spec.load_reader(name)(run_of(jobs)) == 3.0


def test_the_gap_is_a_per_job_difference():
    # Per job: 38-27 = 11, 40-37 = 3, 30-20 = 10; the median of the
    # differences (10) is not the difference of the medians (38-27 = 11).
    jobs = [job_ms(38.0, 12.0, 7.0, 5.0, 3.0), job_ms(40.0, 20.0, 9.0, 5.0, 3.0),
            job_ms(30.0, 10.0, 5.0, 3.0, 2.0)]
    assert spec.load_reader(GAP)(run_of(jobs)) == pytest.approx(10.0)


def test_the_gap_skips_jobs_without_every_stage():
    partial = job_ms(38.0, 12.0, 7.0, 5.0, 3.0)
    del partial["phase_b.copy"]
    jobs = [partial, job_ms(30.0, 10.0, 5.0, 3.0, 2.0)]
    assert spec.load_reader(GAP)(run_of(jobs)) == pytest.approx(10.0)


@pytest.mark.parametrize("name", sorted(STAGE) + [GAP])
def test_none_without_the_spans(name):
    # The program before its spans: only the three phases.
    plain = [{"phase_a": 0.5, "plan": 0.01, "phase_b": 38.0}] * 3
    assert spec.load_reader(name)(run_of(plain)) is None
    assert spec.load_reader(name)(run_of([])) is None
