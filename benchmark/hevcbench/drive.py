"""Driving the program: its decoders, the two loops of the measured
window, device memory, and the faults that the benchmark's own tests
plant under the timed path.

The window drives the port's public entry points, `Decoder` and
`ShvcDecoder`, one access unit a `decode()` call, and `flush()` at a
session's end (with a mix's `drain`, at each copy's end). Subclasses are used only where the benchmark must see
more than the entry returns: the base-layer pictures of two layers, the
engine's stages as spans or timers, and the parsed pictures.
"""
from __future__ import annotations

import contextlib
import random
import time
from dataclasses import dataclass, field

from .traffic import arrivals, session_aus, session_order


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def decoder_class(two_layers: bool, on_bump=None, engine=None,
                  on_recon=None):
    """The port's `Decoder` (or `ShvcDecoder` with two layers), or a
    subclass with these hooks:
    on_bump: called with (layer, picture) as each layer finishes a
    picture, in decode order, once its reconstruction is enqueued (how
    the base layer's pictures are seen);
    engine: a callable device -> engine, in place of `TorchEngine`;
    on_recon: called with (layer, parsed picture) before each
    reconstruction."""
    from openhevc_tpu_torch.decoder import Decoder, ShvcDecoder
    if not (on_bump or engine or on_recon):
        return ShvcDecoder if two_layers else Decoder

    class Layer(Decoder):
        if engine is not None:
            def _engine(self):
                if self._torch_engine is None:
                    self._torch_engine = engine(self.device)
                return self._torch_engine

        if on_recon is not None:
            def _reconstruct(self, fs, refs):
                on_recon(self.layer, fs)
                return super()._reconstruct(fs, refs)

        if on_bump is not None:
            def _bump(self, pic, sps):
                super()._bump(pic, sps)
                on_bump(self.layer, pic)

    if not two_layers:
        return Layer

    class Shvc(ShvcDecoder):
        layer_class = Layer

    return Shvc


class Memory:
    """Device memory: the most that one session adds above what was
    allocated when it began (`session_peak`), and the process's peak
    (`process_peak`), both in bytes; 0 off a card."""

    def __init__(self, device):
        import torch
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.session_peak = 0
        self.process_peak = 0
        self.base = 0

    def _read(self):
        import torch
        peak = torch.cuda.max_memory_allocated(self.device)
        self.process_peak = max(self.process_peak, peak)
        return peak

    def begin(self):
        if self.cuda:
            import torch
            self._read()
            self.base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def end(self):
        if self.cuda:
            self.session_peak = max(self.session_peak,
                                    self._read() - self.base)

    def peak(self):
        if self.cuda:
            self._read()
        return self.process_peak


@dataclass
class Kept:
    """An output picture fetched for the comparison: its planes on the
    host, SPS and POC."""
    planes: object
    sps: object
    poc: int


class Sampler:
    """The pictures of one layer as a window outputs them: the POC and
    SPS of every picture, in order, and a uniform sample of at most
    `size` of them drawn from the seed (reservoir sampling), each copied
    as it comes into a row of one buffer that `alloc` makes on the
    device before the window. So the window allocates nothing for the
    comparison, and no picture of the program is kept alive by it."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.buf = None
        self.pocs, self.sps = [], []
        self.held = {}                  # row -> index of its picture

    def alloc(self, pic, device) -> None:
        """Make the buffer, with rows of `pic`'s size, and copy `pic`
        into it once (so the copy is warm before the window)."""
        import torch
        flat = _device_tensor(pic.planes).reshape(-1)
        self.buf = torch.empty((self.size, flat.numel()), dtype=flat.dtype,
                               device=device)
        self.buf[0].copy_(flat)

    @property
    def n(self) -> int:
        return len(self.pocs)

    def add(self, pic) -> None:
        i = self.n
        self.pocs.append(pic.poc)
        self.sps.append(pic.sps)
        row = i if i < self.size else self.rng.randrange(i + 1)
        if row < self.size:
            flat = _device_tensor(pic.planes).reshape(-1)
            if flat.numel() > self.buf.shape[1]:
                raise ValueError("a picture larger than the sample's rows")
            self.buf[row, :flat.numel()].copy_(flat)
            self.held[row] = i

    def __call__(self, pics) -> None:
        for p in pics:
            self.add(p)

    def sampled(self) -> dict:
        """index -> (flat samples on the host, SPS) of every picture
        held, the buffer fetched once."""
        host = self.buf.cpu().numpy() if self.held else None
        return {i: (host[row], self.sps[i]) for row, i in self.held.items()}


# ---- faults: each breaks the timed path where the pictures are produced ----

def _device_tensor(planes):
    return planes._dev          # TorchPlanes: the flat output on the device


class Tamper:
    """Applied to the pictures each decode() or flush() returns, before
    anything else sees them. None is the sound run. "lsb" is the control:
    every sample of every output picture loses its lowest bit in place,
    as a decoder one bit short of the stated depth would give it (later
    pictures predict from the damaged ones, as they would there). The
    faults: "stale", each picture after the first is the one before it
    again (a step that returns its state unchanged); "half", every
    second picture is left out; "flip", one sample of the first picture
    is altered where it is produced."""

    KINDS = (None, "lsb", "stale", "half", "flip")

    def __init__(self, kind=None):
        if kind not in self.KINDS:
            raise ValueError(f"unknown fault {kind!r}")
        self.kind = kind
        self.seen = 0
        self.last = None

    def __call__(self, pics):
        if self.kind is None:
            return pics
        out = []
        for p in pics:
            i, self.seen = self.seen, self.seen + 1
            if self.kind == "lsb":
                import torch
                t = _device_tensor(p.planes)
                if t.dtype == torch.uint8:
                    t.bitwise_and_(0xFE)
                else:
                    t.view(torch.int16).bitwise_and_(-2)
            elif self.kind == "flip" and i == 0:
                _device_tensor(p.planes)[:1].bitwise_xor_(1)
            elif self.kind == "half" and i % 2:
                continue
            elif self.kind == "stale" and self.last is not None:
                p, self.last = self.last, p
                out.append(p)
                continue
            self.last = p
            out.append(p)
        return out


# ---- the measured window ----------------------------------------------------

@dataclass
class Session:
    stream: int                 # index into the configuration's pool
    fed: int = 0                # access units fed
    el: tuple = (0, 0)          # its pictures' indices in the EL sampler
    bl: tuple = (0, 0)          # ... and in the BL sampler (two layers)


@dataclass
class Window:
    t0: float
    t1: float
    pictures: int = 0                                # output in the window
    sessions: list = field(default_factory=list)     # closed loop
    fed: list = field(default_factory=list)          # (stream, AU index)
    due: list = field(default_factory=list)          # open loop, abs. s
    lag: list = field(default_factory=list)          # fed - due, s
    arrived: list = field(default_factory=list)      # (Kept, abs. s)
    ticks: list = field(default_factory=list)        # (s, pictures so far)

    @property
    def seconds(self):
        return self.t1 - self.t0

    def rates(self, parts: int) -> list[float]:
        """Pictures a second in each of `parts` equal spans of the
        window, from the counts after each access unit (a diagnosis of
        drift within a run; no metric)."""
        span = self.seconds / parts
        out, k, last = [], 0, 0
        for p in range(1, parts + 1):
            while k < len(self.ticks) and \
                    self.ticks[k][0] - self.t0 <= p * span:
                last = self.ticks[k][1]
                k += 1
            out.append(last)
        return [(b - a) / span for a, b in zip([0] + out, out)]


def closed_loop(streams, mix, seed, seconds, device, cls, mem, tamper,
                el, bl=None, span=contextlib.nullcontext):
    """Sessions back to back, each a fresh decoder over the mix's access
    units of the next stream in the seeded order, fed one at a time,
    outputs left on the device and handed to the sampler `el` (the base
    layer's to `bl`, through the decoder class's hook); with the mix's
    `drain`, flushed at the end of each copy of a repeated stream. The
    window ends
    at the first access unit after `seconds` have passed, or at the
    flush of a session whose last access unit that was; it ends with a
    synchronize, and the pictures output by then are the window's. A
    session cut by the end is flushed after it, for the comparison
    alone. span(name): a context around each call into the decoder (a
    named span in a traced run)."""
    order = session_order(seed, len(streams))
    copies, drain = mix.get("copies", 1), mix.get("drain", False)
    sync(device)
    w = Window(time.perf_counter(), 0.0)
    cut = None
    while cut is None:
        i = next(order)
        aus = session_aus(streams[i].aus, mix["session"], copies)
        n_aus = len(streams[i].aus)
        s = Session(i)
        w.sessions.append(s)
        mem.begin()
        first = (el.n, bl.n if bl else 0)
        with span("open"):
            dec = cls(device=device)
        for au in aus:
            with span("decode"):
                el(tamper(dec.decode(au)))
            w.fed.append((i, s.fed % n_aus))
            s.fed += 1
            if drain and s.fed % n_aus == 0 and s.fed < len(aus):
                with span("flush"):
                    el(tamper(dec.flush()))
            w.ticks.append((time.perf_counter(), el.n))
            if s.fed < len(aus) and time.perf_counter() - w.t0 >= seconds:
                cut = dec
                break
        else:
            with span("flush"):
                el(tamper(dec.flush()))
            del dec
            if time.perf_counter() - w.t0 >= seconds:
                cut = False
        mem.end()
        s.el, s.bl = (first[0], el.n), (first[1], bl.n if bl else 0)
    sync(device)
    w.t1 = time.perf_counter()
    w.pictures = el.n
    if cut:
        el(tamper(cut.flush()))
        s.el, s.bl = (first[0], el.n), (first[1], bl.n if bl else 0)
    cut = dec = None
    return w


def _fetch(pics, w, span):
    for p in pics:
        with span("fetch"):
            host = p.planes.get()
        w.arrived.append((Kept(host, p.sps, p.poc), time.perf_counter()))


def open_loop(stream, mix, seed, seconds, device, cls, mem, tamper,
              span=contextlib.nullcontext):
    """One session of the stream's access units repeated, each offered
    at its due time (`arrivals`), or at once when the decoder is behind;
    every output picture fetched to the host as it is returned, and its
    arrival time taken (the base layer's pictures go to the sampler of
    the decoder class's hook). After the last arrival the session is
    flushed; the window ends with a synchronize. span: as in
    `closed_loop`."""
    due = arrivals(seed, mix["rate_aus_per_s"], seconds)
    n_aus = len(stream.aus)
    mem.begin()
    dec = cls(device=device)
    sync(device)
    w = Window(time.perf_counter(), 0.0)
    for k, d in enumerate(due):
        at = w.t0 + d
        wait = at - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        w.due.append(at)
        w.lag.append(time.perf_counter() - at)
        w.fed.append((0, k % n_aus))
        with span("decode"):
            pics = tamper(dec.decode(stream.aus[k % n_aus]))
        _fetch(pics, w, span)
    with span("flush"):
        pics = tamper(dec.flush())
    _fetch(pics, w, span)
    sync(device)
    w.t1 = time.perf_counter()
    w.pictures = len(w.arrived)
    mem.end()
    del dec
    return w
