"""What the per-layer readers (`benchmark/metrics/<name>.py`) read, from
a `--trace 1` run: the profiled window itself, then, after it, one
decode of a session with the engine's stages synchronised and timed,
then the parse run alone. Each reader is `read(r) -> number or None`
over a `Readings` `r`; None leaves the metric out of the line."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .drive import decoder_class, sync
from .traffic import session_aus


@dataclass
class Readings:
    window_s: float = 0.0           # the profiled window
    busy_s: float | None = None     # device busy in it (union of ops)
    device_ops: list = field(default_factory=list)  # (start, end, name) us
    pictures: int = 0               # output pictures in the window
    intra_bytes: int | None = None  # intra work of the window's pictures
    hbm_bytes_per_s: float | None = None
    stage_ms: dict = field(default_factory=dict)    # a picture, layers added
    fetch_ms: float | None = None   # host clock of the fetch, a picture
    parse_ms: float | None = None   # the parse alone, a picture

    def device_s(self, part: str) -> float:
        """Seconds of the window's device ops whose name holds `part`."""
        return sum(e - s for s, e, n in self.device_ops if part in n) / 1e6

    def stages(self, names) -> float | None:
        """The sum of these stages' ms a picture, or None when none ran."""
        got = [self.stage_ms[n] for n in names if n in self.stage_ms]
        return sum(got) if got else None


def timed_stages(streams, mix, two_layers, device):
    """One session of each stream of the pool (one copy of a repeated
    stream) through a decoder whose engine synchronises and times every
    stage, fed access unit by access unit; with the mix's fetch, each
    output picture is fetched as it is returned, on the host clock.
    Returns (stage ms a picture with the layers added, fetch ms a picture
    or None)."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    stage_ms, pics, fetch_s = {}, 0, 0.0
    for st in streams:
        cls = decoder_class(two_layers,
                            engine=lambda d: TorchEngine(d, sync_timers=True))
        dec = cls(device=device)
        for au in session_aus(st.aus, mix["session"]) + [None]:
            out = dec.flush() if au is None else dec.decode(au)
            pics += len(out)
            if mix["fetch"]:
                t0 = time.perf_counter()
                for p in out:
                    p.planes.get()
                fetch_s += time.perf_counter() - t0
        for layer in ([dec.bl, dec.el] if two_layers else [dec]):
            for k, ms in layer._engine().stage_ms.items():
                stage_ms[k] = stage_ms.get(k, 0.0) + ms
        del dec
    sync(device)
    pics = max(pics, 1)
    return ({k: v / pics for k, v in stage_ms.items()},
            fetch_s * 1e3 / pics if mix["fetch"] else None)


def parse_alone(streams, mix, device) -> float:
    """ms a picture of the parse alone (the native core and its
    parse-ahead thread; no reconstruction), over one session of each
    stream, fed access unit by access unit. Single layer only: the
    enhancement layer's parse needs the base layer's pictures."""
    from openhevc_tpu_torch.decoder import Decoder

    class ParseOnly(Decoder):
        def _reconstruct(self, fs, refs):
            self.parsed += 1

    total, n = 0.0, 0
    for st in streams:
        dec = ParseOnly(device=device)
        dec.parsed = 0
        t0 = time.perf_counter()
        for au in session_aus(st.aus, mix["session"]):
            dec.decode(au)
        dec.flush()
        total += time.perf_counter() - t0
        n += dec.parsed
    return total * 1e3 / max(n, 1)
