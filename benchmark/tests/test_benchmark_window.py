"""The window's arithmetic: a closed loop whose last job runs past
``--seconds`` and closes the window, and a rate over the whole window."""

from benchmark import harness


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_jobs_run_to_their_end_past_the_seconds():
    clock = FakeClock()

    def job(k):
        clock.t += 3.0           # every job takes 3 s
        return 1000

    jobs, window = harness.run_window(job, 10.0, clock=clock)
    # Jobs start at 0, 3, 6 and 9 s; the fourth ends at 12 s.
    assert jobs == [1000] * 4
    assert window == 12.0
    assert sum(jobs) / window == 4000 / 12.0


def test_a_job_longer_than_the_window_still_runs():
    clock = FakeClock()

    def job(k):
        clock.t += 30.0
        return k

    jobs, window = harness.run_window(job, 10.0, clock=clock)
    assert jobs == [0] and window == 30.0


def test_the_harness_reading_between_jobs_is_off_the_clock():
    clock = FakeClock()
    read = []

    def job(k):
        clock.t += 3.0
        return 1000

    def after(k, done):
        clock.t += 5.0           # the harness reads the outputs
        read.append(k)

    jobs, window = harness.run_window(job, 10.0, after, clock=clock)
    # The jobs' own time decides: 3, 6, 9, then 12 s of work.
    assert jobs == [1000] * 4 and read == [0, 1, 2, 3]
    assert window == 12.0


def test_job_seeds_differ_and_fit_torch():
    from benchmark.drivers import job_seed

    seeds = {job_seed(2 ** 31 + 12345, k) for k in range(100)}
    assert len(seeds) == 100
    assert all(0 <= s < 2 ** 62 for s in seeds)
