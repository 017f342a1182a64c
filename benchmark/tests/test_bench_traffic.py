"""The generator: the session order and the arrival schedule from the
seed, the same amount of work for every seed, and the streams cut into
access units as a demuxer hands them over."""
import itertools
import math
import os

import pytest

from conftest import ROOT
from hevcbench.streams import (access_units, first_frames, layer_id,
                               nal_type, split_nals)
from hevcbench.traffic import (arrivals, check_mix, expected_outputs,
                               expected_sequence, nearest_rank, session_aus,
                               session_order)

SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 31 + 12345, 3 * 2 ** 31]


def take(gen, n):
    return list(itertools.islice(gen, n))


@pytest.mark.parametrize("seed", SEEDS)
def test_session_order_is_the_seeds_and_covers_the_pool_each_round(seed):
    got = take(session_order(seed, 5), 20)
    assert got == take(session_order(seed, 5), 20)
    for r in range(4):
        assert sorted(got[5 * r:5 * r + 5]) == list(range(5))


def test_session_order_differs_between_seeds():
    orders = {tuple(take(session_order(s, 6), 12)) for s in SEEDS}
    assert len(orders) > 1


def test_a_pool_of_one_gives_the_same_sessions_to_every_seed():
    assert {tuple(take(session_order(s, 1), 8)) for s in SEEDS} == \
        {(0,) * 8}


@pytest.mark.parametrize("rate, seconds", [(8.0, 30), (9.5, 10), (20, 1)])
def test_arrivals_hold_the_same_work_for_every_seed(rate, seconds):
    schedules = [arrivals(s, rate, seconds) for s in SEEDS]
    n = round(rate * seconds)
    for due in schedules:
        assert len(due) == n
        assert 0 <= due[0] < 1 / rate
        gaps = [b - a for a, b in zip(due, due[1:])]
        assert all(math.isclose(g, 1 / rate) for g in gaps)
    assert arrivals(SEEDS[3], rate, seconds) == schedules[3]
    assert len({d[0] for d in schedules}) > 1          # the phase moves


def test_expected_outputs_follow_poc_order():
    # hierarchical B: decode order 0 8 4 2 1 3 6 5 7
    pocs = [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert expected_outputs(pocs, 9) == list(range(9))
    assert expected_outputs(pocs, 3) == [0, 4, 8]
    assert expected_outputs([0, 1, 2, 3, 4], 2) == [0, 1]


def test_expected_sequence_runs_copy_after_copy():
    pocs = [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert expected_sequence(pocs, 9) == list(range(9))
    assert expected_sequence(pocs, 21) == list(range(9)) * 2 + [0, 4, 8]
    assert expected_sequence(pocs, 12, order="decode") == \
        pocs + [0, 8, 4]
    assert expected_sequence([0], 1) == [0]


def test_a_repeated_session_feeds_its_copies():
    aus = [b"a", b"b", b"c"]
    assert session_aus(aus, "repeat", 3) == aus * 3
    assert session_aus(aus, "repeat") == aus
    assert session_aus(aus, "first_au", 3) == aus[:1]


def test_nearest_rank_counts_missing_pictures_as_the_largest():
    vals = list(range(1, 101))
    assert nearest_rank(vals, 0.95) == 95
    assert nearest_rank(vals, 0.5) == 50
    assert nearest_rank(vals[:94] + [math.inf] * 6, 0.95) == math.inf
    assert nearest_rank(vals[:95] + [math.inf] * 5, 0.95) == 95
    with pytest.raises(ValueError):
        nearest_rank([], 0.5)


@pytest.mark.parametrize("mix", [
    {"loop": "open", "session": "whole", "fetch": True,
     "rate_aus_per_s": 8},
    {"loop": "open", "session": "repeat", "fetch": True},
    {"loop": "closed", "session": "repeat", "fetch": False},
    {"loop": "closed", "session": "repeat", "fetch": False, "copies": 0},
    {"loop": "closed", "session": "repeat", "fetch": False,
     "copies": True},
    {"loop": "closed", "session": "every", "fetch": False},
    {"loop": "closed", "session": "whole"},
])
def test_check_mix_refuses_what_the_generator_cannot_run(mix):
    with pytest.raises(ValueError):
        check_mix(mix)


def test_access_units_of_both_configurations():
    ra = open(os.path.join(ROOT, "benchmark/streams/hevc_ra_1080p_qp32.265"),
              "rb").read()
    aus = access_units(ra)
    assert len(aus) == 33
    assert b"".join(aus).replace(b"\x00", b"") == ra.replace(b"\x00", b"")
    assert aus[0] == first_frames(ra, 1)
    assert session_aus(aus, "first_au") == aus[:1]
    assert session_aus(aus, "repeat") == aus
    assert session_aus(aus, "repeat", 10) == aus * 10
    shvc = open(os.path.join(ROOT,
                             "benchmark/streams/shvc_x2_1080p_ld32.265"),
                "rb").read()
    aus = access_units(shvc)
    assert len(aus) == 32
    for au in aus:                      # one picture of each layer
        vcl = [n for n in split_nals(au) if nal_type(n) <= 31]
        assert [layer_id(n) for n in vcl] == [0, 1]
    assert {nal_type(n) for n in split_nals(aus[0])} >= {32, 33, 34}
