"""S/BLOW5 signal-file reader (read path only).

A from-scratch implementation of the subset of the SLOW5 format that the
mapping pipeline needs, built for batch decode into numpy arrays:

  - BLOW5 binary container: magic/version/compression header, ASCII header
    data (attributes per read group + aux-meta lines), length-prefixed
    records, `5WOLB` EOF marker.
    ref: slow5lib/src/slow5.c:792-880 (header), :3191-3280 (get_next_mem)
  - record decode: zlib/zstd/none record compression, then fixed columns
    read_id/read_group/digitisation/offset/range/sampling_rate/
    len_raw_signal/raw_signal; auxiliary fields parse on demand
    (`decode_record(with_aux=True)` + typed accessors; the mapper's hot
    path skips them).
    ref: slow5lib/src/slow5.c:2575-2607 (depress-parse), :2806-2942
    (binary column parse); slow5lib/include/slow5/slow5_defs.h:84-94
  - signal codec `svb-zd` (zigzag + delta + streamvbyte), decoded fully
    vectorized in numpy (the C library scalar-decodes per value).
    ref: slow5lib/src/slow5_press.c:1054-1140,
    slow5lib/thirdparty/streamvbyte/*
  - ASCII SLOW5 (.slow5): tab-separated records, for debugging parity.

Unlike slow5lib this is a columnar *batch* reader: `read_batch()` returns
raw record blobs (cheap, single-threaded sequential IO exactly like
sigfish `load_db`, ref src/sigfish.c:274-314) and `decode_record()` /
`decode_batch()` turn blobs into numpy signals, parallelizable across a
thread pool because each blob is independent.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional

import numpy as np

MAGIC = b"BLOW5\x01"
EOF_MARKER = b"5WOLB"
HDR_SIZE_OFFSET = 64

# record/signal compression byte encodings
# ref: slow5lib/src/slow5_press.c:76-148 (record: 0=none,1=zlib,2=zstd;
# signal: 0=none,1=svb-zd, plus the hidden dev codes 250=zlib,251=zstd,
# slow5_press.c:100-148)
REC_PRESS = {0: "none", 1: "zlib", 2: "zstd"}
SIG_PRESS = {0: "none", 1: "svb-zd", 250: "zlib", 251: "zstd"}

_SVB_SHIFTS = np.array([1, 256, 65536, 16777216], dtype=np.uint32)

# auxiliary-field primitive types: name -> (numpy dtype, size, null sentinel)
# ref: slow5lib/include/slow5/slow5.h:107-150 (enum slow5_aux_type + the
# SLOW5_*_NULL missing-value representations), slow5lib/src/slow5.c
# aux_type_meta table. Arrays append "*" to the type string; SLOW5_STRING
# is "char*"; enums are uint8_t with labels declared in the header.
_AUX_PRIM: dict[str, tuple[str, int, object]] = {
    "int8_t": ("<i1", 1, 127),
    "int16_t": ("<i2", 2, 32767),
    "int32_t": ("<i4", 4, 2147483647),
    "int64_t": ("<i8", 8, 9223372036854775807),
    "uint8_t": ("<u1", 1, 255),
    "uint16_t": ("<u2", 2, 65535),
    "uint32_t": ("<u4", 4, 4294967295),
    "uint64_t": ("<u8", 8, 18446744073709551615),
    "float": ("<f4", 4, None),  # NULL = nan, checked with isnan
    "double": ("<f8", 8, None),
    "char": ("S1", 1, 0),
}


def _aux_base(type_str: str) -> tuple[str, bool, list[str] | None]:
    """Split a header type string into (primitive, is_array, enum_labels)."""
    is_arr = type_str.endswith("*")
    base = type_str[:-1] if is_arr else type_str
    labels = None
    if base.startswith("enum"):
        # e.g. enum{unknown,partial,complete}
        lb = base.find("{")
        if lb != -1 and base.endswith("}"):
            labels = base[lb + 1 : -1].split(",")
        base = "uint8_t"
    return base, is_arr, labels


def svb_zd_decode(buf: bytes | np.ndarray) -> np.ndarray:
    """Decode an svb-zd blob (u32 count header + streamvbyte of
    zigzag-delta values) to int16 samples, fully vectorized.

    ref: slow5lib/src/slow5_press.c:1085-1140 (ptr_depress_svb{,_zd}),
    streamvbyte standard layout: ceil(n/4) control bytes then data bytes,
    2-bit codes little-endian within each control byte, values stored
    little-endian in 1-4 bytes.
    """
    raw = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    if raw.size < 4:
        raise ValueError("svb-zd blob too short")
    count = int(np.frombuffer(raw[:4].tobytes(), dtype="<u4")[0])
    if count == 0:
        return np.zeros(0, dtype=np.int16)
    nctrl = (count + 3) // 4
    ctrl = raw[4 : 4 + nctrl]
    data = raw[4 + nctrl :]

    # 2-bit codes -> byte length per value
    codes = np.empty(nctrl * 4, dtype=np.uint8)
    codes[0::4] = ctrl & 0x3
    codes[1::4] = (ctrl >> 2) & 0x3
    codes[2::4] = (ctrl >> 4) & 0x3
    codes[3::4] = (ctrl >> 6) & 0x3
    lens = (codes[:count].astype(np.int64)) + 1

    offs = np.zeros(count, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    total = int(offs[-1] + lens[-1]) if count else 0
    if data.size < total:
        raise ValueError("svb-zd blob truncated")

    padded = np.zeros(total + 3, dtype=np.uint8)
    padded[: data.size if data.size <= total + 3 else total + 3] = data[: total + 3]
    pos = offs[:, None] + np.arange(4, dtype=np.int64)[None, :]
    mask = np.arange(4, dtype=np.int64)[None, :] < lens[:, None]
    b = padded[pos].astype(np.uint32) * mask
    zz = (b * _SVB_SHIFTS[None, :]).sum(axis=1, dtype=np.uint32)

    # zigzag decode then delta (prev=0) accumulate
    # ref: streamvbyte_zigzag.c zigzag_delta_decode
    d = ((zz >> 1).astype(np.int32)) ^ -(zz & 1).astype(np.int32)
    sig = np.cumsum(d, dtype=np.int32)
    return sig.astype(np.int16)


def svb_zd_encode(sig: np.ndarray) -> bytes:
    """Inverse of :func:`svb_zd_decode` (for the writer / test fixtures)."""
    sig = np.asarray(sig, dtype=np.int32)
    count = sig.size
    d = np.diff(sig, prepend=np.int32(0)).astype(np.int32)
    zz = ((d << 1) ^ (d >> 31)).astype(np.uint32)

    b0 = (zz & 0xFF).astype(np.uint8)
    b1 = ((zz >> 8) & 0xFF).astype(np.uint8)
    b2 = ((zz >> 16) & 0xFF).astype(np.uint8)
    b3 = ((zz >> 24) & 0xFF).astype(np.uint8)
    lens = np.ones(count, dtype=np.int64)
    lens[zz > 0xFF] = 2
    lens[zz > 0xFFFF] = 3
    lens[zz > 0xFFFFFF] = 4
    codes = (lens - 1).astype(np.uint8)

    nctrl = (count + 3) // 4
    codes_pad = np.zeros(nctrl * 4, dtype=np.uint8)
    codes_pad[:count] = codes
    ctrl = (
        codes_pad[0::4]
        | (codes_pad[1::4] << 2)
        | (codes_pad[2::4] << 4)
        | (codes_pad[3::4] << 6)
    )

    offs = np.zeros(count, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    total = int(offs[-1] + lens[-1]) if count else 0
    data = np.zeros(total, dtype=np.uint8)
    data[offs] = b0
    for k, bk in ((1, b1), (2, b2), (3, b3)):
        sel = lens > k
        data[offs[sel] + k] = bk[sel]

    out = bytearray()
    out += struct.pack("<I", count)
    out += ctrl.tobytes()
    out += data.tobytes()
    return bytes(out)


@dataclass
class Slow5Record:
    """One decoded read. Columns ref slow5_defs.h:84-94."""

    read_id: str
    read_group: int
    digitisation: float
    offset: float
    range: float
    sampling_rate: float
    raw_signal: np.ndarray  # int16
    # auxiliary fields (channel_number, median_before, ...): populated by
    # decode_record(with_aux=True); None = not parsed, missing values
    # inside the dict are None. ref: slow5.c:3084-3184 (binary aux parse)
    aux: Optional[dict[str, object]] = None

    def aux_get(self, name: str):
        """Typed aux accessor (~ slow5_aux_get_*). None when missing."""
        return None if self.aux is None else self.aux.get(name)

    @property
    def len_raw_signal(self) -> int:
        return int(self.raw_signal.size)

    def to_pa(self) -> np.ndarray:
        """ADC -> picoamps. ref: src/sigfish.c:344-347, src/misc.h:123.

        Uses the fused native pass when available (identical f32 op
        order, no numpy temporaries)."""
        from .. import native

        pa = native.pa_from_i16(
            self.raw_signal, self.digitisation, self.offset, self.range
        )
        if pa is not None:
            return pa
        raw_unit = np.float32(self.range) / np.float32(self.digitisation)
        return (
            (self.raw_signal.astype(np.float32) + np.float32(self.offset)) * raw_unit
        )


def _decompress_record(blob: bytes, method: str) -> bytes:
    if method == "none":
        return blob
    if method == "zlib":
        try:
            return zlib.decompress(blob)
        except zlib.error as e:
            raise ValueError(f"corrupt zlib record: {e}") from e
    if method == "zstd":
        try:
            import zstandard  # type: ignore

            return zstandard.ZstdDecompressor().decompress(blob)
        except ImportError as e:
            raise RuntimeError(
                "zstd-compressed BLOW5 needs the zstandard module"
            ) from e
    raise ValueError(f"unknown record compression {method!r}")


def _decode_signal(blob: np.ndarray, method: str) -> np.ndarray:
    if method == "none":
        return np.frombuffer(blob.tobytes(), dtype="<i2")
    if method == "svb-zd":
        return svb_zd_decode(blob)
    if method == "zlib":
        return np.frombuffer(zlib.decompress(blob.tobytes()), dtype="<i2")
    if method == "zstd":
        import zstandard

        return np.frombuffer(
            zstandard.ZstdDecompressor().decompress(blob.tobytes()), dtype="<i2"
        )
    raise ValueError(f"unknown signal compression {method!r}")


class Slow5File:
    """Sequential-streaming BLOW5/SLOW5 reader.

    Mirrors the slow5lib read API surface that sigfish uses:
    `header_get(attr, read_group)` ~ slow5_hdr_get, `read_batch(n, max_bytes)`
    ~ the load_db loop of slow5_get_next_mem calls, `decode_record` ~
    slow5_rec_depress_parse.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._fp: BinaryIO = open(self.path, "rb")
        self.format = (
            "binary" if self.path.endswith(".blow5") else "ascii"
        )  # ref slow5.c: format from extension (slow5_path_get_fmt)
        # peek at magic to be robust to renamed files
        head = self._fp.read(6)
        self._fp.seek(0)
        if head == MAGIC:
            self.format = "binary"
        elif head[:1] == b"#":
            self.format = "ascii"

        self._rec_index = 0
        self.header_data: list[dict[str, str]] = []
        self.aux_types: list[str] = []
        self.aux_names: list[str] = []
        self.num_read_groups = 1
        self.rec_press = "none"
        self.sig_press = "none"
        self.version = (0, 0, 0)

        if self.format == "binary":
            self._parse_binary_header()
        else:
            self._parse_ascii_header()

    # ----------------------------------------------------------- header

    def _parse_binary_header(self) -> None:
        fp = self._fp
        magic = fp.read(6)
        if magic != MAGIC:
            raise ValueError(f"{self.path}: not a BLOW5 file (bad magic)")
        major, minor, patch = struct.unpack("<BBB", fp.read(3))
        self.version = (major, minor, patch)
        (rec_press,) = struct.unpack("<B", fp.read(1))
        (self.num_read_groups,) = struct.unpack("<I", fp.read(4))
        # signal press byte exists for version >= 0.2.0
        # ref: slow5.c:824 slow5_signal_press_version_cmp
        if (major, minor, patch) >= (0, 2, 0):
            (sig_press,) = struct.unpack("<B", fp.read(1))
        else:
            sig_press = 0
        # unknown press bytes are a hard error (slow5lib maps them to 255
        # and fails press-init, slow5_press.c:90-96,144-147)
        if rec_press not in REC_PRESS:
            raise ValueError(
                f"{self.path}: unknown record compression method {rec_press}"
            )
        if sig_press not in SIG_PRESS:
            raise ValueError(
                f"{self.path}: unknown signal compression method {sig_press}"
            )
        self.rec_press = REC_PRESS[rec_press]
        self.sig_press = SIG_PRESS[sig_press]

        fp.seek(HDR_SIZE_OFFSET)
        (hdr_size,) = struct.unpack("<I", fp.read(4))
        text = fp.read(hdr_size).decode("ascii", errors="replace")
        self._parse_header_text(text)
        self._data_start = fp.tell()

    def _parse_ascii_header(self) -> None:
        fp = self._fp
        lines = []
        while True:
            pos = fp.tell()
            line = fp.readline().decode("ascii")
            if not line:
                break
            if line.startswith("#slow5_version"):
                v = line.rstrip("\n").split("\t")[1]
                self.version = tuple(int(x) for x in v.split("."))  # type: ignore
                continue
            if line.startswith("#num_read_groups"):
                self.num_read_groups = int(line.rstrip("\n").split("\t")[1])
                continue
            if line.startswith("@") or line.startswith("#"):
                lines.append(line)
                if line.startswith("#read_id"):
                    self._data_start = fp.tell()
                    break
                continue
            fp.seek(pos)
            self._data_start = pos
            break
        self._parse_header_text("".join(lines))

    def _parse_header_text(self, text: str) -> None:
        self.header_data = [dict() for _ in range(self.num_read_groups)]
        for line in text.split("\n"):
            if not line:
                continue
            if line.startswith("@"):
                parts = line[1:].split("\t")
                attr = parts[0]
                vals = parts[1:]
                for g in range(self.num_read_groups):
                    v = vals[g] if g < len(vals) else ""
                    # "." means missing: stored as empty string, exactly
                    # like slow5lib (slow5.c:1746-1749)
                    self.header_data[g][attr] = "" if v == "." else v
            elif line.startswith("#"):
                # two aux-meta lines: types ("#char*...") then names
                # ("#read_id..."); the parts[0] checks below select which
                parts = line[1:].split("\t")
                if parts and parts[0] == "char*":
                    self.aux_types = parts[8:]  # after the 8 main columns
                elif parts and parts[0] == "read_id":
                    self.aux_names = parts[8:]
        self.aux_meta = list(zip(self.aux_names, self.aux_types))

    def header_get(self, attr: str, read_group: int = 0) -> Optional[str]:
        """ref: slow5_hdr_get (slow5.c:1381-1399). Returns None when the
        attribute is absent; a "." value parses to the empty string
        (slow5.c:1746-1749)."""
        if read_group >= len(self.header_data):
            return None
        return self.header_data[read_group].get(attr)

    # ---------------------------------------------------------- records

    def read_next_blob(self) -> Optional[bytes]:
        """One length-prefixed raw record (still compressed); None at EOF.

        ref: slow5_get_next_mem slow5.c:3191-3280.
        """
        if self.format == "ascii":
            line = self._fp.readline()
            if not line:
                return None
            return line.rstrip(b"\n")
        szb = self._fp.read(8)
        if len(szb) < 8:
            # the 5-byte `5WOLB` EOF marker terminates the stream
            # (slow5.c:3249-3260); a clean EOF with no marker is also
            # accepted for robustness
            if len(szb) == 0 or szb == EOF_MARKER[: len(szb)]:
                return None
            raise IOError(f"{self.path}: malformed record size prefix")
        if szb[:5] == EOF_MARKER:
            # marker followed by trailing bytes: treat as end of stream
            return None
        (size,) = struct.unpack("<Q", szb)
        blob = self._fp.read(size)
        if len(blob) != size:
            raise IOError(f"{self.path}: truncated record")
        return blob

    def seek_record(self, file_offset: int, rec_index: int) -> None:
        """Position the stream at a record boundary (multi-host range
        split: each host seeks straight to its contiguous record range
        instead of scanning the whole file). `file_offset` must point at
        a record's u64 size prefix (binary) or line start (ascii), as
        recorded by the .idx sidecar (io/blow5_idx.py)."""
        self._fp.seek(file_offset)
        self._rec_index = rec_index

    def read_batch(
        self,
        max_records: int,
        max_bytes: int,
        shard_id: int = 0,
        n_shards: int = 1,
    ) -> list[bytes]:
        """Load up to K records or B bytes. ref: load_db src/sigfish.c:274-305.

        With n_shards > 1 only records whose global index is congruent to
        shard_id modulo n_shards are kept -- the multi-host data-parallel
        stripe (each host streams the same file and maps its own stripe;
        outputs concatenate to the full mapping set).
        """
        out: list[bytes] = []
        total = 0
        while len(out) < max_records and total < max_bytes:
            blob = self.read_next_blob()
            if blob is None:
                break
            idx = self._rec_index
            self._rec_index += 1
            if n_shards > 1 and idx % n_shards != shard_id:
                continue
            out.append(blob)
            total += len(blob)
        return out

    def read_id_of(self, blob: bytes) -> str:
        """Parse only the read_id from a raw record blob -- record-level
        decompression is unavoidable (the id sits inside the compressed
        region) but the signal is never touched. Used by the index
        builder (ref slow5_idx_build reads ids the same way)."""
        if self.format == "ascii":
            return blob.split(b"\t", 1)[0].decode("ascii")
        mem = _decompress_record(blob, self.rec_press)
        (rid_len,) = struct.unpack_from("<H", mem, 0)
        return bytes(mem[2 : 2 + rid_len]).decode("ascii")

    def decode_record(self, blob: bytes, with_aux: bool = False) -> Slow5Record:
        """ref: slow5_rec_depress_parse + binary/ascii column parse.

        Uses the native (C++) decoder for every binary press combination
        (record none/zlib/zstd x signal none/svb-zd/zlib/zstd incl. the
        dev codes 250/251); falls back to the Python path for ascii and
        aux parsing.
        ``with_aux=True`` additionally parses the auxiliary columns
        declared in the header (slow5.c:3084-3184) into ``rec.aux``."""
        if self.format == "ascii":
            return self._decode_ascii(blob, with_aux=with_aux)
        if not with_aux:
            from .. import native

            res = native.blow5_decode(blob, self.rec_press, self.sig_press)
            if res is not None:
                rid, rg, digi, off_, rng, rate, sig = res
                return Slow5Record(
                    read_id=rid,
                    read_group=rg,
                    digitisation=digi,
                    offset=off_,
                    range=rng,
                    sampling_rate=rate,
                    raw_signal=sig,
                )
        mem = _decompress_record(blob, self.rec_press)
        (rid_len,) = struct.unpack_from("<H", mem, 0)
        off = 2
        read_id = mem[off : off + rid_len].decode("ascii")
        off += rid_len
        (read_group,) = struct.unpack_from("<I", mem, off)
        off += 4
        digitisation, offset_, range_, sampling_rate = struct.unpack_from(
            "<dddd", mem, off
        )
        off += 32
        (len_raw,) = struct.unpack_from("<Q", mem, off)
        off += 8
        if self.sig_press == "none":
            nbytes = len_raw * 2
        else:
            nbytes = len_raw  # byte count when signal-compressed (slow5.c:2880)
        sig_blob = np.frombuffer(mem, dtype=np.uint8, count=nbytes, offset=off)
        signal = _decode_signal(sig_blob, self.sig_press)
        aux = None
        if with_aux and self.aux_meta:
            aux = self._parse_aux_binary(mem, off + nbytes)
        return Slow5Record(
            read_id=read_id,
            read_group=read_group,
            digitisation=digitisation,
            offset=offset_,
            range=range_,
            sampling_rate=sampling_rate,
            raw_signal=signal,
            aux=aux,
        )

    def _parse_aux_binary(self, mem: bytes, off: int) -> dict[str, object]:
        """ref: slow5_rec_aux_parse binary branch (slow5.c:3084-3184):
        per aux column in header order, arrays carry a u64 length prefix
        then len*size bytes; primitives are size bytes with type-specific
        NULL sentinels (slow5.h:139-150) meaning missing -> None."""
        aux: dict[str, object] = {}
        for name, tstr in self.aux_meta:
            base, is_arr, labels = _aux_base(tstr)
            if base not in _AUX_PRIM:
                raise ValueError(f"{self.path}: unknown aux type {tstr!r}")
            dtype, size, null = _AUX_PRIM[base]
            if is_arr:
                if off + 8 > len(mem):
                    raise IOError(f"{self.path}: aux field {name} missing")
                (ln,) = struct.unpack_from("<Q", mem, off)
                off += 8
                if off + ln * size > len(mem):
                    raise IOError(f"{self.path}: aux field {name} truncated")
                if ln == 0:
                    val: object = None
                elif base == "char":
                    val = bytes(mem[off : off + ln]).decode(
                        "ascii", errors="replace"
                    )
                else:
                    val = np.frombuffer(
                        mem, dtype=dtype, count=ln, offset=off
                    ).copy()
                off += ln * size
            else:
                if off + size > len(mem):
                    raise IOError(f"{self.path}: aux field {name} missing")
                v = np.frombuffer(mem, dtype=dtype, count=1, offset=off)[0]
                off += size
                if base in ("float", "double"):
                    val = None if np.isnan(v) else float(v)
                elif base == "char":
                    # numpy "S1" strips trailing NULs, so the missing
                    # sentinel b"\x00" (SLOW5_CHAR_NULL) reads as b""
                    val = None if len(v) == 0 else v.decode("ascii")
                else:
                    iv = int(v)
                    val = None if iv == null else iv
                    if val is not None and labels:
                        val = iv  # enum: expose the raw code (slow5_aux_get_enum)
            aux[name] = val
        return aux

    def _decode_ascii(self, blob: bytes, with_aux: bool = False) -> Slow5Record:
        cols = blob.decode("ascii").split("\t")
        signal = np.array(
            [int(x) for x in cols[7].split(",")] if cols[7] else [], dtype=np.int16
        )
        aux = None
        if with_aux and self.aux_meta:
            aux = {}
            for k, (name, tstr) in enumerate(self.aux_meta):
                tok = cols[8 + k] if 8 + k < len(cols) else "."
                base, is_arr, labels = _aux_base(tstr)
                dtype, _, _ = _AUX_PRIM.get(base, ("<u1", 1, 255))
                if tok == "." or (is_arr and tok == ""):
                    # "." = missing; tolerate a bare empty array column
                    # from third-party writers too
                    aux[name] = None
                elif is_arr and base == "char":
                    aux[name] = tok
                elif is_arr:
                    aux[name] = np.array(tok.split(","), dtype=dtype)
                elif base in ("float", "double"):
                    aux[name] = float(tok)
                elif base == "char":
                    aux[name] = tok
                else:
                    aux[name] = int(tok)
        return Slow5Record(
            read_id=cols[0],
            read_group=int(cols[1]),
            digitisation=float(cols[2]),
            offset=float(cols[3]),
            range=float(cols[4]),
            sampling_rate=float(cols[5]),
            raw_signal=signal,
            aux=aux,
        )

    def decode_batch(self, blobs: list[bytes]) -> list[Slow5Record]:
        return [self.decode_record(b) for b in blobs]

    # ------------------------------------------------- random access

    def index_load(self) -> "Slow5Index":  # noqa: F821
        """Load `<path>.idx` if present, else build it and write the
        sidecar (ref slow5_idx_load, slow5.c:4100-4126). Cached."""
        import os as _os

        from .blow5_idx import Slow5Index, index_path

        idx = getattr(self, "_index", None)
        if idx is not None:
            return idx
        ip = index_path(self.path)
        if _os.path.exists(ip):
            idx = Slow5Index.load(ip)
        else:
            idx = Slow5Index.build(self)
            try:
                idx.write(ip)
            except OSError:
                pass  # read-only location: keep the in-memory index
        self._index = idx
        return idx

    def index_to(self, pathname: str) -> None:
        """Build and write the index to an explicit path
        (ref slow5_idx_to, slow5_idx.c:153-181)."""
        from .blow5_idx import Slow5Index

        Slow5Index.build(self).write(pathname)

    def get(self, read_id: str) -> Optional[Slow5Record]:
        """Random access by read_id via the index (ref slow5_get).

        Returns None when the read_id is not in the file. Preserves the
        sequential streaming position.
        """
        ent = self.index_load().get(read_id)
        if ent is None:
            return None
        offset, size = ent
        saved = self._fp.tell()
        try:
            self._fp.seek(offset)
            if self.format == "ascii":
                blob = self._fp.read(size).rstrip(b"\n")
            else:
                blob = self._fp.read(size)[8:]  # strip the u64 size prefix
        finally:
            self._fp.seek(saved)
        return self.decode_record(blob)

    def __iter__(self) -> Iterator[Slow5Record]:
        while True:
            blob = self.read_next_blob()
            if blob is None:
                return
            yield self.decode_record(blob)

    def close(self) -> None:
        self._fp.close()

    def __enter__(self) -> "Slow5File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Slow5Writer:
    """S/BLOW5 writer (binary: record zlib / signal svb-zd by default;
    ASCII .slow5 with fmt="ascii").

    Write-path counterpart of :class:`Slow5File`, completing the
    slow5lib API-parity surface (ref: slow5lib/src/slow5.c header write
    :792-880 layout, record write, 5WOLB EOF). Used by test fixtures and
    the benchmark workload generator.
    """

    def __init__(
        self,
        path: str | os.PathLike,
        header_data: list[dict[str, str]] | None = None,
        rec_press: str = "zlib",
        sig_press: str = "svb-zd",
        fmt: str | None = None,
        aux_meta: list[tuple[str, str]] | None = None,
    ):
        self.path = os.fspath(path)
        if fmt is None:
            fmt = "ascii" if self.path.endswith(".slow5") else "binary"
        self.fmt = fmt
        self._fp: BinaryIO = open(self.path, "wb")
        self.rec_press = rec_press if fmt == "binary" else "none"
        self.sig_press = sig_press if fmt == "binary" else "none"
        self.header_data = header_data or [{}]
        # aux columns: list of (name, type_str) pairs after the 8 main
        # columns, e.g. [("channel_number","char*"),("median_before","double")]
        self.aux_meta = aux_meta or []
        if fmt == "binary":
            self._write_header()
        else:
            self._write_ascii_header()

    def _write_ascii_header(self) -> None:
        w = self._fp.write
        w(b"#slow5_version\t0.2.0\n")
        w(f"#num_read_groups\t{len(self.header_data)}\n".encode())
        for a in sorted({k for g in self.header_data for k in g}):
            # empty/missing values serialize as "." (slow5.c:1069-1093)
            vals = "\t".join(g.get(a) or "." for g in self.header_data)
            w(f"@{a}\t{vals}\n".encode())
        w(("\t".join(self._type_cols()) + "\n").encode())
        w(("\t".join(self._name_cols()) + "\n").encode())

    def _type_cols(self) -> list[str]:
        return [
            "#char*", "uint32_t", "double", "double", "double", "double",
            "uint64_t", "int16_t*",
        ] + [t for _, t in self.aux_meta]

    def _name_cols(self) -> list[str]:
        return [
            "#read_id", "read_group", "digitisation", "offset", "range",
            "sampling_rate", "len_raw_signal", "raw_signal",
        ] + [n for n, _ in self.aux_meta]

    def _write_header(self) -> None:
        fp = self._fp
        rec_code = {v: k for k, v in REC_PRESS.items()}[self.rec_press]
        sig_code = {v: k for k, v in SIG_PRESS.items()}[self.sig_press]
        fp.write(MAGIC)
        fp.write(struct.pack("<BBB", 0, 2, 0))
        fp.write(struct.pack("<B", rec_code))
        fp.write(struct.pack("<I", len(self.header_data)))
        fp.write(struct.pack("<B", sig_code))
        fp.write(b"\x00" * (HDR_SIZE_OFFSET - fp.tell()))
        attrs = sorted({k for g in self.header_data for k in g})
        lines = []
        for a in attrs:
            vals = "\t".join(g.get(a) or "." for g in self.header_data)
            lines.append(f"@{a}\t{vals}")
        lines.append("\t".join(self._type_cols()))
        lines.append("\t".join(self._name_cols()))
        text = ("\n".join(lines) + "\n").encode("ascii")
        fp.write(struct.pack("<I", len(text)))
        fp.write(text)

    def _aux_ascii(self, rec: Slow5Record) -> str:
        cols = []
        for name, tstr in self.aux_meta:
            v = rec.aux.get(name) if rec.aux else None
            base, is_arr, _ = _aux_base(tstr)
            if (
                v is None
                or (is_arr and len(v) == 0)
                or (base == "char" and not is_arr and str(v) == "")
            ):
                # zero-length arrays/strings (and '' chars) are the same
                # as missing in the binary layout; write "." so the
                # column parses (an empty token would not)
                cols.append(".")
            elif is_arr and base == "char":
                cols.append(str(v))
            elif is_arr:
                cols.append(",".join(str(x) for x in np.asarray(v).tolist()))
            elif base in ("float", "double"):
                cols.append(f"{float(v):.17g}")
            else:
                cols.append(str(v))
        return ("\t" + "\t".join(cols)) if cols else ""

    def _aux_binary(self, rec: Slow5Record) -> bytes:
        out = bytearray()
        for name, tstr in self.aux_meta:
            v = rec.aux.get(name) if rec.aux else None
            base, is_arr, _ = _aux_base(tstr)
            dtype, size, null = _AUX_PRIM[base]
            if is_arr:
                if v is None:
                    out += struct.pack("<Q", 0)
                elif base == "char":
                    b = str(v).encode("ascii")
                    out += struct.pack("<Q", len(b)) + b
                else:
                    a = np.asarray(v, dtype=dtype)
                    out += struct.pack("<Q", a.size) + a.tobytes()
            elif base in ("float", "double"):
                out += np.array(
                    [float("nan") if v is None else float(v)], dtype=dtype
                ).tobytes()
            elif base == "char":
                # exactly ONE byte always: an empty string must not emit
                # zero bytes (it would shift every following aux field);
                # '' maps to the missing sentinel like None
                b = b"" if v is None else str(v).encode("ascii")[:1]
                out += b if b else b"\x00"
            else:
                out += np.array([null if v is None else int(v)], dtype=dtype).tobytes()
        return bytes(out)

    def write_record(self, rec: Slow5Record) -> None:
        if self.fmt == "ascii":
            sig = ",".join(str(int(v)) for v in rec.raw_signal)
            self._fp.write(
                (
                    f"{rec.read_id}\t{rec.read_group}\t{rec.digitisation:.17g}\t"
                    f"{rec.offset:.17g}\t{rec.range:.17g}\t{rec.sampling_rate:.17g}\t"
                    f"{rec.len_raw_signal}\t{sig}{self._aux_ascii(rec)}\n"
                ).encode("ascii")
            )
            return
        rid = rec.read_id.encode("ascii")
        body = bytearray()
        body += struct.pack("<H", len(rid))
        body += rid
        body += struct.pack("<I", rec.read_group)
        body += struct.pack(
            "<dddd", rec.digitisation, rec.offset, rec.range, rec.sampling_rate
        )
        if self.sig_press == "none":
            sig = np.asarray(rec.raw_signal, dtype="<i2").tobytes()
            body += struct.pack("<Q", rec.len_raw_signal)
        else:
            if self.sig_press == "svb-zd":
                sig = svb_zd_encode(rec.raw_signal)
            elif self.sig_press == "zlib":  # dev code 250 (slow5_press.c:110)
                sig = zlib.compress(np.asarray(rec.raw_signal, dtype="<i2").tobytes())
            elif self.sig_press == "zstd":  # dev code 251
                import zstandard

                sig = zstandard.ZstdCompressor().compress(
                    np.asarray(rec.raw_signal, dtype="<i2").tobytes()
                )
            else:
                raise ValueError(f"unknown signal compression {self.sig_press!r}")
            body += struct.pack("<Q", len(sig))  # byte count (slow5.c:2880)
        body += sig
        if self.aux_meta:
            body += self._aux_binary(rec)
        blob = bytes(body)
        if self.rec_press == "zlib":
            blob = zlib.compress(blob)
        elif self.rec_press == "zstd":
            import zstandard

            blob = zstandard.ZstdCompressor().compress(blob)
        self._fp.write(struct.pack("<Q", len(blob)))
        self._fp.write(blob)

    def close(self) -> None:
        if self.fmt == "binary":
            self._fp.write(EOF_MARKER)
        self._fp.close()

    def __enter__(self) -> "Slow5Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
