"""The comparison that decides `correct`: every picture that the
window's sessions output, against the reference decoders' sidecars
(md5 of the cropped Y, U, V planes, as they hash them). Every picture's
POC is held against the one due at its place, and its md5 where it is
in the seeded sample (closed loops: `drive.Sampler`; the open loop's
fetched pictures: every one). An exact comparison: each count below
has the limit 0."""
from __future__ import annotations

import math

from .streams import crop, hash_planes
from .traffic import expected_outputs, expected_sequence

LIMITS = {"el_wrong": 0, "el_missing": 0, "bl_wrong": 0, "bl_missing": 0}


def hashes(kept) -> list[str]:
    """md5 of each Kept picture."""
    return [hash_planes(crop(list(k.planes), k.sps), k.sps.bit_depth)
            for k in kept]


def hash_flat(flat, sps) -> str:
    """md5 of a picture from its flat output (Y, then Cb, then Cr, each
    uncropped and row by row, as the program packs it)."""
    H, W = sps.height, sps.width
    Hc, Wc = H >> sps.vshift1, W >> sps.hshift1
    n = H * W
    planes = [flat[:n].reshape(H, W),
              flat[n:n + Hc * Wc].reshape(Hc, Wc),
              flat[n + Hc * Wc:n + 2 * Hc * Wc].reshape(Hc, Wc)]
    return hash_planes(crop(planes, sps), sps.bit_depth)


def _count(got, want):
    """(wrong, missing) of got md5s against want md5s, position by
    position; a picture beyond the expected ones is wrong."""
    wrong = sum(g != w for g, w in zip(got, want)) + \
        max(0, len(got) - len(want))
    return wrong, max(0, len(want) - len(got))


def sampled_run(sampler, span, samples, want, md5s, pocs):
    """(wrong, missing) of the pictures `span` (start, end) of a sampler
    against the sidecar indices `want` due there: each picture's POC
    against the due one's (`pocs`: POC of each sidecar index), and its
    md5 against `md5s` where `samples` holds it."""
    start, end = span
    got = sampler.pocs[start:end]
    wrong = 0
    for j, (poc, idx) in enumerate(zip(got, want)):
        bad = poc != pocs[idx]
        if not bad and start + j in samples:
            flat, sps = samples[start + j]
            bad = hash_flat(flat, sps) != md5s[idx]
        wrong += bad
    return wrong + max(0, len(got) - len(want)), max(0, len(want) - len(got))


def closed(window, streams, el, bl, pocs):
    """Counts of a closed loop's window, and the pictures due: every
    session's output pictures (and base-layer pictures, where the
    stream has their sidecar) against the sidecars. `pocs[i]` = (EL,
    BL) POCs of one copy of stream i in decode order."""
    n = {"el_wrong": 0, "el_missing": 0}
    el_s = el.sampled()
    bl_s = bl.sampled() if bl is not None else {}
    attempted = 0
    for s in window.sessions:
        st = streams[s.stream]
        el_pocs, bl_pocs = pocs[s.stream]
        want = expected_sequence(el_pocs, s.fed)
        wrong, missing = sampled_run(el, s.el, el_s, want, st.el,
                                     sorted(el_pocs))
        n["el_wrong"] += wrong
        n["el_missing"] += missing
        attempted += len(want)
        if st.bl is not None and bl is not None:
            want = expected_sequence(bl_pocs, s.fed, order="decode")
            wrong, missing = sampled_run(bl, s.bl, bl_s, want, st.bl,
                                         sorted(bl_pocs))
            n["bl_wrong"] = n.get("bl_wrong", 0) + wrong
            n["bl_missing"] = n.get("bl_missing", 0) + missing
            attempted += len(want)
    return n, attempted


def open_(window, stream, pocs, bl=None):
    """Counts and latencies of an open loop's window. Arrivals fall into
    copies of the stream where the POC stops rising; each copy's
    pictures are compared with the sidecar lines of the access units fed
    in it; the base layer's (sampler `bl`) as in `closed`. `pocs` = (EL,
    BL) POCs of one copy in decode order. Returns (counts, attempted,
    latencies in s, one for every picture due: math.inf for a picture
    that never came or is wrong)."""
    decode_pocs, bl_pocs = pocs
    n_aus = len(decode_pocs)
    n_fed = len(window.due)
    copies, last = [], None
    for kept, t in window.arrived:
        if last is None or kept.poc <= last:
            copies.append([])
        copies[-1].append((kept, t))
        last = kept.poc
    ranks = sorted(decode_pocs)
    n = {"el_wrong": 0, "el_missing": 0}
    lat = []
    n_copies = -(-n_fed // n_aus)
    for c in range(n_copies):
        fed = min(n_aus, n_fed - c * n_aus)
        want = expected_outputs(decode_pocs, fed)
        got = copies[c] if c < len(copies) else []
        got_md5 = hashes(k for k, _ in got)
        for j, idx in enumerate(want):
            pos = decode_pocs.index(ranks[idx])
            ok = j < len(got) and got_md5[j] == stream.el[idx]
            lat.append(got[j][1] - window.due[c * n_aus + pos] if ok
                       else math.inf)
        wrong, missing = _count(got_md5, [stream.el[i] for i in want])
        n["el_wrong"] += wrong
        n["el_missing"] += missing
    n["el_wrong"] += sum(len(c) for c in copies[n_copies:])
    window.arrived = None
    attempted = len(lat)
    if stream.bl is not None and bl is not None:
        want = expected_sequence(bl_pocs, n_fed, order="decode")
        n["bl_wrong"], n["bl_missing"] = sampled_run(
            bl, (0, bl.n), bl.sampled(), want, stream.bl, sorted(bl_pocs))
        attempted += len(want)
    return n, attempted, lat


def passed(counts) -> bool:
    return all(v <= LIMITS[k] for k, v in counts.items())
