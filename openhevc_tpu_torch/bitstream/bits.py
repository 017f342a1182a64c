"""Bit-level I/O and RBSP (de-)escaping for Annex-B HEVC streams.

MSB-first bit order as in H.265. The reader mirrors the behavior of the
reference's get_bits.h/golomb.h substrate (no code shared); the writer is the
encoder-side counterpart used by the test-stream generator.
"""
from __future__ import annotations


class BitReader:
    """MSB-first bit reader over a bytes-like RBSP buffer."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes, start_bit: int = 0):
        self.data = data
        self.pos = start_bit          # bit position
        self.nbits = len(data) * 8

    def read1(self) -> int:
        p = self.pos
        if p >= self.nbits:
            # conformant streams never over-read; mimic safe reader (zeros)
            self.pos = p + 1
            return 0
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read1()
        return v

    def peek(self, n: int) -> int:
        p = self.pos
        v = self.read(n)
        self.pos = p
        return v

    def ue(self) -> int:
        """Exp-Golomb unsigned (ue(v))."""
        zeros = 0
        while self.read1() == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid exp-golomb code")
        return (1 << zeros) - 1 + self.read(zeros)

    def se(self) -> int:
        """Exp-Golomb signed (se(v))."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP payload before the rbsp_stop_one_bit."""
        if self.pos >= self.nbits:
            return False
        # bit index of the last set bit in the stream = rbsp_stop_one_bit
        for byte_idx in range(len(self.data) - 1, -1, -1):
            b = self.data[byte_idx]
            if b:
                lsb_from_msb = 7 - ((b & -b).bit_length() - 1)
                return self.pos < byte_idx * 8 + lsb_from_msb
        return False


class BitWriter:
    """MSB-first bit writer producing an RBSP byte buffer."""

    __slots__ = ("_bytes", "_cur", "_nbits")

    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0  # bits in _cur (0..7)

    def put1(self, bit: int):
        self._cur = (self._cur << 1) | (bit & 1)
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.put1((value >> i) & 1)

    def ue(self, v: int):
        assert v >= 0
        k = v + 1
        n = k.bit_length()
        self.put(0, n - 1)
        self.put(k, n)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align_zero(self):
        while self._nbits:
            self.put1(0)

    def align_one_then_zero(self):
        """rbsp_trailing_bits(): stop bit then zero-pad to byte boundary."""
        self.put1(1)
        self.align_zero()

    @property
    def bitpos(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unaligned bit writer"
        return bytes(self._bytes)


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (0x03) per H.265 7.4.2
    (inverse of the reference's ff_hevc_extract_rbsp, hevc.c:3724)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def unescape_rbsp(data: bytes) -> bytes:
    """Remove emulation prevention bytes (ff_hevc_extract_rbsp behavior).

    Vectorized: delete byte i iff data[i]==3 and data[i-2:i]==00 00.  This
    equals the sequential zero-counter scan: a deleted byte is 0x03, so it
    can never be part of a later 00 00 prefix, and the counter reset after
    an escape is exactly the data[i-1]==3 exclusion."""
    if b"\x00\x00\x03" not in data:
        return data
    import numpy as np
    a = np.frombuffer(data, np.uint8)
    z = a == 0
    keep = np.ones(len(a), bool)
    keep[2:] = ~((a[2:] == 3) & z[1:-1] & z[:-2])
    return a[keep].tobytes()


def substream_starts_rbsp(esc_payload: bytes, data_start_rbsp: int,
                          entry_point_offsets) -> list[int]:
    """Map slice-header entry points to rbsp-domain byte starts.

    entry_point_offset_minus1+1 values are byte distances in the CODED
    (escaped) NAL payload (the reference adjusts them for removed
    emulation bytes at hevc.c:3028-3058); the parse core addresses the
    un-escaped rbsp, so convert via the kept-byte prefix counts."""
    import numpy as np
    a = np.frombuffer(esc_payload, np.uint8)
    z = a == 0
    keep = np.ones(len(a), bool)
    keep[2:] = ~((a[2:] == 3) & z[1:-1] & z[:-2])
    kept_before = np.cumsum(keep)       # kept bytes in [0..i]
    # escaped index of the slice-data start (first i with count p+1)
    cum = int(np.searchsorted(kept_before, data_start_rbsp + 1, "left"))
    starts = [data_start_rbsp]
    for off in entry_point_offsets:
        cum += int(off)
        starts.append(int(kept_before[cum - 1]))
    return starts


def nal_header(nal_type: int, layer_id: int = 0, temporal_id: int = 0) -> bytes:
    """Two-byte HEVC NAL unit header (hls_nal_unit, hevc.c:3107)."""
    b0 = (nal_type & 0x3F) << 1 | (layer_id >> 5)
    b1 = ((layer_id & 0x1F) << 3) | ((temporal_id + 1) & 7)
    return bytes([b0, b1])


def wrap_nal(nal_type: int, rbsp: bytes, layer_id: int = 0,
             temporal_id: int = 0) -> bytes:
    """start code + header + escaped RBSP."""
    return (b"\x00\x00\x00\x01" + nal_header(nal_type, layer_id, temporal_id)
            + escape_rbsp(rbsp))
