"""CABAC binary arithmetic coding engines (H.265 clause 9.3).

Python reference implementation — the correctness mirror for the C++ native
parse core (native/hevcparse.cc). Implements the *specification* algorithm
(9-bit range/offset state machine) rather than the reference decoder's
shifted-register formulation (cabac_functions.h:97-118); the bitstreams are
identical, only the engine bookkeeping differs.

Tables are the normative H.265 Table 9-46/9-47 constants (identical in every
HEVC implementation; cf. cabac_tablegen.h in the reference).
"""
from __future__ import annotations

# Table 9-46: rangeTabLps[pStateIdx][qRangeIdx]
LPS_RANGE = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216), (123, 150, 178, 205),
    (116, 142, 169, 195), (111, 135, 160, 185), (105, 128, 152, 175), (100, 122, 144, 166),
    (95, 116, 137, 158), (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116), (66, 80, 95, 110),
    (62, 76, 90, 104), (59, 72, 86, 99), (56, 69, 81, 94), (53, 65, 77, 89),
    (51, 62, 73, 85), (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62), (35, 43, 51, 59),
    (33, 41, 48, 56), (32, 39, 46, 53), (30, 37, 43, 50), (29, 35, 41, 48),
    (27, 33, 39, 45), (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33), (19, 23, 27, 31),
    (18, 22, 26, 30), (17, 21, 25, 28), (16, 20, 23, 27), (15, 19, 22, 25),
    (14, 18, 21, 24), (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18), (10, 12, 15, 17),
    (10, 12, 14, 16), (9, 11, 13, 15), (9, 11, 12, 14), (8, 10, 12, 14),
    (8, 9, 11, 13), (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2),
)

# Table 9-47: transIdxLps / transIdxMps
TRANS_LPS = (
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
)
TRANS_MPS = tuple(min(i + 1, 62) if i < 62 else i for i in range(63)) + (63,)


def clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def init_context_state(init_value: int, qp: int) -> int:
    """Context variable init (9.3.2.2). Packs (pStateIdx<<1)|valMps."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = clip3(1, 126, ((slope * clip3(0, 51, qp)) >> 4) + offset)
    if pre <= 63:
        return (63 - pre) << 1 | 0
    return (pre - 64) << 1 | 1


class CabacDecoder:
    """Spec-form arithmetic decoder over an unescaped RBSP buffer.

    `bitpos` counts every bit the engine has consumed (9 at init, 1 per
    renormalization/bypass read). PCM data and post-terminate positions are
    byte-aligned via consumed-bit accounting (equivalent to the reference's
    skip_bytes() pointer arithmetic, cabac_functions.h:182)."""

    __slots__ = ("data", "bitpos", "nbits", "range", "offset")

    def __init__(self, data: bytes, start_bit: int):
        self.data = data
        self.nbits = len(data) * 8
        self.reinit(start_bit)

    def reinit(self, start_bit: int):
        assert start_bit % 8 == 0
        self.bitpos = start_bit
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self) -> int:
        p = self.bitpos
        self.bitpos = p + 1
        if p >= self.nbits:
            return 0
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def decode_bin(self, ctx_table, ctx_idx: int) -> int:
        """Regular (context-coded) bin. ctx_table is a mutable list of
        packed (pStateIdx<<1)|valMps states."""
        s = ctx_table[ctx_idx]
        p_state, val_mps = s >> 1, s & 1
        lps = LPS_RANGE[p_state][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            bin_val = 1 - val_mps
            self.offset -= self.range
            self.range = lps
            if p_state == 0:
                val_mps = 1 - val_mps
            ctx_table[ctx_idx] = TRANS_LPS[p_state] << 1 | val_mps
        else:
            bin_val = val_mps
            ctx_table[ctx_idx] = TRANS_MPS[p_state] << 1 | val_mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        """end_of_slice_segment_flag / pcm_flag / end_of_subset bin."""
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0

    def consumed_bytes(self) -> int:
        """Byte offset just past all consumed bits (for PCM / terminate)."""
        return (self.bitpos + 7) >> 3


class CabacEncoder:
    """Spec-form arithmetic encoder (9.3.4), writing into a BitWriter."""

    __slots__ = ("bw", "low", "range", "outstanding", "first_bit")

    def __init__(self, bit_writer):
        self.bw = bit_writer
        self.restart()

    def restart(self):
        """Engine init (9.3.4.2) — contexts are NOT touched."""
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first_bit = True

    def _put(self, b: int):
        if self.first_bit:
            self.first_bit = False
        else:
            self.bw.put1(b)
        while self.outstanding:
            self.bw.put1(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low >= 512:
                self.low -= 512
                self._put(1)
            elif self.low < 256:
                self._put(0)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def encode_bin(self, ctx_table, ctx_idx: int, bin_val: int):
        s = ctx_table[ctx_idx]
        p_state, val_mps = s >> 1, s & 1
        lps = LPS_RANGE[p_state][(self.range >> 6) & 3]
        self.range -= lps
        if bin_val != val_mps:
            self.low += self.range
            self.range = lps
            if p_state == 0:
                val_mps = 1 - val_mps
            ctx_table[ctx_idx] = TRANS_LPS[p_state] << 1 | val_mps
        else:
            ctx_table[ctx_idx] = TRANS_MPS[p_state] << 1 | val_mps
        self._renorm()

    def encode_bypass(self, bin_val: int):
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put(1)
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def encode_bypass_bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bin_val: int):
        self.range -= 2
        if bin_val:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self):
        """9.3.4.3.5 EncodeFlush: emit the final low bits + stop bit."""
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bw.put(((self.low >> 7) & 3) | 1, 2)
