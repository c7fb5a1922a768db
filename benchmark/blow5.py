"""A BLOW5 writer for the benchmark's inputs (slow5lib's binary layout,
version 0.2.0): the header, then length-prefixed records, each wrapped in
zlib or not, with the signal in svb-zd (zigzag, delta, streamvbyte), then
the `5WOLB` end marker. slow5tools writes `-c zlib -s svb-zd` by default
and `-c none -s svb-zd` for fast access.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

RECORD_PRESS = {"none": 0, "zlib": 1}
SIGNAL_PRESS = {"svb-zd": 1}
COLUMNS = [("read_id", "char*"), ("read_group", "uint32_t"), ("digitisation", "double"),
           ("offset", "double"), ("range", "double"), ("sampling_rate", "double"),
           ("len_raw_signal", "uint64_t"), ("raw_signal", "int16_t*")]


def svb_zd(sig: np.ndarray) -> bytes:
    """A u32 count, then streamvbyte of the zigzag-coded deltas: 2-bit
    byte counts four to a control byte, then each value's low bytes."""
    sig = np.asarray(sig, np.int32)
    n = sig.size
    d = np.diff(sig, prepend=np.int32(0)).astype(np.int32)
    zz = ((d << 1) ^ (d >> 31)).astype(np.uint32)
    lens = 1 + (zz > 0xFF).astype(np.int64) + (zz > 0xFFFF) + (zz > 0xFFFFFF)
    codes = np.zeros(-(-n // 4) * 4, np.uint8)
    codes[:n] = lens - 1
    ctrl = codes[0::4] | (codes[1::4] << 2) | (codes[2::4] << 4) | (codes[3::4] << 6)
    ends = np.cumsum(lens)
    offs = ends - lens
    data = np.zeros(int(ends[-1]) if n else 0, np.uint8)
    data[offs] = zz & 0xFF
    for k in (1, 2, 3):
        sel = np.flatnonzero(lens > k)
        data[offs[sel] + k] = (zz[sel] >> (8 * k)) & 0xFF
    return struct.pack("<I", n) + ctrl.astype(np.uint8).tobytes() + data.tobytes()


class Writer:
    def __init__(self, path: str, header: dict[str, str], record_press: str, signal_press: str):
        self.fp = open(path, "wb")
        self.record_press = record_press
        if signal_press not in SIGNAL_PRESS:
            raise ValueError(f"signal compression {signal_press!r}: only svb-zd is written")
        fp = self.fp
        fp.write(b"BLOW5\x01" + struct.pack("<BBB", 0, 2, 0))
        fp.write(struct.pack("<BIB", RECORD_PRESS[record_press], 1, SIGNAL_PRESS[signal_press]))
        fp.write(b"\x00" * (64 - fp.tell()))
        lines = [f"@{k}\t{v}" for k, v in sorted(header.items())]
        lines.append("#" + "\t".join(t for _, t in COLUMNS))
        lines.append("#" + "\t".join(n for n, _ in COLUMNS))
        text = ("\n".join(lines) + "\n").encode("ascii")
        fp.write(struct.pack("<I", len(text)) + text)

    @staticmethod
    def body(read_id: str, raw: np.ndarray, digitisation: float, offset: float,
             rng: float, sampling_rate: float) -> bytes:
        """A record's columns, before the record's compression."""
        rid = read_id.encode("ascii")
        sig = svb_zd(raw)
        return (struct.pack("<H", len(rid)) + rid + struct.pack("<I", 0)
                + struct.pack("<dddd", digitisation, offset, rng, sampling_rate)
                + struct.pack("<Q", len(sig)) + sig)

    def wrap(self, body: bytes) -> bytes:
        """The record as written: compressed or not, length first. Keeps
        no state, so threads may wrap records in parallel (zlib releases
        the interpreter lock)."""
        if self.record_press == "zlib":
            body = zlib.compress(body)
        return struct.pack("<Q", len(body)) + body

    def append(self, record: bytes) -> None:
        self.fp.write(record)

    def close(self) -> None:
        self.fp.write(b"5WOLB")
        self.fp.close()
