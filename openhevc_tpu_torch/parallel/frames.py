"""Dependency-aware picture wave scheduling.

The reference decodes N frames concurrently by cloning decoder contexts
and gating reads on per-row progress (pthread_frame.c:325,
hevc_refs.c progress waits). The port groups *independent* pictures,
pictures whose reference sets contain no picture still in the current
group, into a wave that reconstructs together over a device mesh
(parallel/mesh.py).

Wave composition by content type:
- all-intra streams: every picture is independent -> full waves;
- random-access pyramids: the top B level (half the pictures of a GOP)
  shares dependency level -> waves of gop/2;
- low-delay P chains: each picture references the previous -> waves of
  one.

The JAX package's parallel/frames.py, copied: the port imports nothing
of it.
"""
from __future__ import annotations


class WaveScheduler:
    """Accumulates parse-complete pictures into independence waves.

    add(key, ref_keys, item) -> None | list[(key, item)]: returns the
    flushed wave when `item` cannot join it (a reference is inside, or
    the wave is full)."""

    def __init__(self, max_wave: int):
        self.max_wave = max(1, max_wave)
        self._wave = []          # [(key, item)]
        self._keys = set()

    def add(self, key, ref_keys, item):
        flushed = None
        if (len(self._wave) >= self.max_wave or
                any(r in self._keys for r in ref_keys)):
            flushed = self.flush()
        self._wave.append((key, item))
        self._keys.add(key)
        return flushed

    def flush(self):
        w, self._wave, self._keys = self._wave, [], set()
        return w

    def __len__(self):
        return len(self._wave)
