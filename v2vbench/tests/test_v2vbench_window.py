"""The window's accounting on a fake clock: whole requests, the stop rule,
and the end-to-end rates."""

from __future__ import annotations

import pytest

from v2vbench.run import Reservoir, closed_loop, rate


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def loop(lengths, seconds):
    clock = FakeClock()
    done = []

    def request(i):
        clock.t += lengths[i % len(lengths)]
        done.append(i)

    got, window = closed_loop(request, seconds, clock=clock)
    return got, window, done


@pytest.mark.parametrize("length,seconds,n", [(18.0, 40.0, 2), (18.0, 36.0, 2), (18.0, 35.9, 1),
                                              (7.7, 40.0, 5), (50.0, 40.0, 1)])
def test_only_whole_requests_that_fit(length, seconds, n):
    got, window, done = loop([length], seconds)
    assert len(got) == n and done == list(range(n))
    assert window == pytest.approx(n * length)


def test_a_request_is_not_started_when_the_last_one_says_it_would_not_fit():
    got, window, _ = loop([10.0, 25.0, 10.0], 40.0)
    assert got == [10.0, 25.0] and window == pytest.approx(35.0)


def test_rates():
    edit = {"metric": {"name": "edit_s", "per": "requests", "times": 1}}
    invert = {"metric": {"name": "invert_s", "per": "steps", "times": 500}}
    assert rate(edit, 36.0, 2, 98) == pytest.approx(18.0)
    assert rate(invert, 40.0, 5, 250) == pytest.approx(80.0)


def test_reservoir_is_seeded_and_uniform():
    def kept(seed, n):
        r = Reservoir(seed)
        for i in range(n):
            r.offer(i)
        return r.kept

    assert kept(3, 5) == kept(3, 5)
    counts = [0] * 4
    for s in range(4000):
        counts[kept(s, 4)] += 1
    assert all(800 < c < 1200 for c in counts)
