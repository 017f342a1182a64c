"""The one generator of traffic: what a mix file's parameters and the
seed make of a configuration's pool of streams.

A mix (`benchmark/traffic/<name>.json`) holds:
- `loop`: "closed" (sessions back to back, each the next as soon as the
  last has returned) or "open" (access units due on a fixed schedule);
- `session`: "first_au" (a fresh decoder fed only the stream's first
  access unit) or "repeat" (one decoder fed the stream's access units
  over and over, each copy opening with its parameter sets and IDR);
- `copies` (closed loop, "repeat" only): the copies of the stream that
  one session feeds before it is flushed (an open loop's session runs
  until the arrivals end);
- `drain` (closed loop, "repeat" only; false if absent): whether the
  decoder is flushed at the end of each copy, and goes on with the next
  copy, as at the end of each clip of a playlist;
- `fetch`: whether each output picture is copied to the host as the
  decoder returns it (a player) or left on the device (a GPU consumer);
- `rate_aus_per_s` (open loop only): the access units offered a second.

The seed sets the order of sessions over the pool and the phase of the
first arrival. It never sets how much work a run holds: every seed gets
the same sessions, each as long, and the same number of arrivals.
"""
from __future__ import annotations

import math
import random

LOOPS = ("closed", "open")
SESSIONS = ("first_au", "repeat")


def check_mix(mix: dict) -> None:
    """Raise ValueError on a mix the generator cannot run."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"loop must be one of {LOOPS}: {mix.get('loop')}")
    if mix.get("session") not in SESSIONS:
        raise ValueError(f"session must be one of {SESSIONS}")
    if not isinstance(mix.get("fetch"), bool):
        raise ValueError("fetch must be true or false")
    if mix["loop"] == "open":
        rate = mix.get("rate_aus_per_s")
        if not isinstance(rate, (int, float)) or not rate > 0:
            raise ValueError("an open loop needs rate_aus_per_s > 0")
        if mix["session"] != "repeat":
            raise ValueError("an open loop feeds one repeated session")
    elif mix["session"] == "repeat":
        copies = mix.get("copies")
        if not isinstance(copies, int) or isinstance(copies, bool) or \
                copies < 1:
            raise ValueError("a closed loop's repeated session needs "
                             "copies >= 1")
        if not isinstance(mix.get("drain", False), bool):
            raise ValueError("drain must be true or false")


def session_order(seed: int, pool: int):
    """Endless stream indices of a closed loop's sessions: the pool in
    an order drawn from the seed, then again in a new order, and so on.
    Every pool member comes once in each round."""
    rng = random.Random(seed)
    while True:
        order = list(range(pool))
        rng.shuffle(order)
        yield from order


def arrivals(seed: int, rate: float, seconds: float) -> list[float]:
    """Due times (s from the window's start) of an open loop's access
    units: round(seconds * rate) of them, 1 / rate apart, the first at a
    phase drawn from the seed in [0, 1 / rate)."""
    n = max(1, int(round(seconds * rate)))
    phase = random.Random(seed).random() / rate
    return [phase + k / rate for k in range(n)]


def session_aus(aus: list[bytes], session: str,
                copies: int = 1) -> list[bytes]:
    """The access units of one session: the first, or for "repeat" all
    of them `copies` times over."""
    return aus[:1] if session == "first_au" else list(aus) * copies


def expected_outputs(decode_pocs: list[int], n_fed: int) -> list[int]:
    """For the first n_fed access units of a copy of a stream whose
    pictures have decode_pocs (decode order), the indices into the
    stream's output-order sidecar of the pictures they carry, in output
    order (output order is POC order within a copy)."""
    rank = {p: i for i, p in enumerate(sorted(decode_pocs))}
    return sorted(rank[p] for p in decode_pocs[:n_fed])


def expected_sequence(decode_pocs: list[int], n_fed: int,
                      order: str = "output") -> list[int]:
    """The sidecar indices of the pictures that the first n_fed access
    units of a session carry, in output order (or with order="decode"
    in decode order), where the session feeds copies of one stream back
    to back (each copy opens with an IDR, so a copy's pictures are all
    output before the next copy's)."""
    n = len(decode_pocs)
    rank = {p: i for i, p in enumerate(sorted(decode_pocs))}
    out = []
    for c in range(0, n_fed, n):
        fed = min(n, n_fed - c)
        out += expected_outputs(decode_pocs, fed) if order == "output" \
            else [rank[p] for p in decode_pocs[:fed]]
    return out


def nearest_rank(values: list[float], q: float) -> float:
    """The q-quantile by nearest rank: the ceil(q * n)-th smallest
    value (math.inf counts as the largest)."""
    if not values:
        raise ValueError("no values")
    k = max(1, math.ceil(q * len(values)))
    return sorted(values)[k - 1]
