"""SLOW5/BLOW5 index: random access by read_id.

Binary-compatible with slow5lib's `.idx` sidecar format so index files
interoperate with the C ecosystem (slow5tools / slow5lib readers):

  header:  9-byte magic "SLOW5IDX\\x01", u8 major, u8 minor, u8 patch
           (the *slow5 file's* version), zero-padded to byte 64
           (ref slow5_idx.h:22-24, slow5_idx.c:356-377)
  entries: u16 LE read_id_len, read_id bytes, u64 LE offset, u64 LE size
           (ref slow5_idx.c:380-397; slow5_rid_len_t = u16, slow5.h:267)
  eof:     8 bytes "XDI5WOLS" (ref slow5_idx.h:23)

For a binary BLOW5, `offset` is the file offset of the record's u64
length prefix and `size` is `8 + record_size` (ref slow5_idx.c:238-276);
for ASCII SLOW5, `offset` is the line start and `size` the line length
including the newline (ref slow5_idx.c:201-231).

The reference mapper itself never loads an index (sigfish dtw streams
sequentially, SURVEY §2.2); this exists for API completeness --
`Slow5File.get(read_id)` mirrors slow5lib's `slow5_get` +
`slow5_idx_load` surface.
"""

from __future__ import annotations

import struct
from typing import Optional

INDEX_MAGIC = b"SLOW5IDX\x01"
INDEX_EOF = b"XDI5WOLS"
INDEX_HEADER_SIZE = 64  # ref slow5_idx.h:24 SLOW5_INDEX_HEADER_SIZE_OFFSET
INDEX_EXTENSION = ".idx"  # ref slow5_idx.h:20


def index_path(slow5_path: str) -> str:
    """`<file>.idx` next to the slow5 file (ref slow5.c:4254-4263)."""
    return slow5_path + INDEX_EXTENSION


class Slow5Index:
    """In-memory read_id -> (offset, size) map, insertion-ordered."""

    def __init__(self, version: tuple[int, int, int] = (0, 0, 0)):
        self.version = version
        self._map: dict[str, tuple[int, int]] = {}

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, read_id: str) -> bool:
        return read_id in self._map

    def get(self, read_id: str) -> Optional[tuple[int, int]]:
        """(offset, size) or None (ref slow5_idx_get)."""
        return self._map.get(read_id)

    def ids(self) -> list[str]:
        return list(self._map)

    def insert(self, read_id: str, offset: int, size: int) -> None:
        """ref slow5_idx_insert: duplicate read_ids are an error."""
        if read_id in self._map:
            raise ValueError(f"duplicate read_id in index: {read_id!r}")
        self._map[read_id] = (offset, size)

    # ----------------------------------------------------------- builders

    @classmethod
    def build(cls, sf) -> "Slow5Index":
        """Scan every record of an open Slow5File (ref slow5_idx_build).

        Leaves the file's sequential position where it was.
        """
        idx = cls(version=sf.version)
        fp = sf._fp
        saved = fp.tell()
        try:
            fp.seek(sf._data_start)
            if sf.format == "ascii":
                while True:
                    offset = fp.tell()
                    line = fp.readline()
                    if not line:
                        break
                    rid = line.split(b"\t", 1)[0].decode("ascii")
                    idx.insert(rid, offset, len(line))
            else:
                from .blow5 import EOF_MARKER

                while True:
                    offset = fp.tell()
                    szb = fp.read(8)
                    if len(szb) < 8:
                        if len(szb) == 0 or szb == EOF_MARKER[: len(szb)]:
                            break
                        raise IOError(f"{sf.path}: malformed record size prefix")
                    if szb[:5] == EOF_MARKER:
                        break
                    (size,) = struct.unpack("<Q", szb)
                    blob = fp.read(size)
                    if len(blob) != size:
                        raise IOError(f"{sf.path}: truncated record")
                    # only the read_id is needed: skip the signal decode
                    # (record decompression alone dominates, and svb is
                    # ~25% of a full decode on compressed files)
                    idx.insert(sf.read_id_of(blob), offset, 8 + size)
        finally:
            fp.seek(saved)
        return idx

    @classmethod
    def load(cls, path: str) -> "Slow5Index":
        """Parse a `.idx` file (ref slow5_idx_read)."""
        with open(path, "rb") as fp:
            magic = fp.read(len(INDEX_MAGIC))
            if magic != INDEX_MAGIC:
                raise ValueError(f"{path}: not a slow5 index (bad magic)")
            major, minor, patch = struct.unpack("<BBB", fp.read(3))
            idx = cls(version=(major, minor, patch))
            fp.seek(INDEX_HEADER_SIZE)
            while True:
                head = fp.read(2)
                if len(head) < 2:
                    raise IOError(f"{path}: truncated index (missing eof marker)")
                (rid_len,) = struct.unpack("<H", head)
                rid = fp.read(rid_len)
                if len(rid) != rid_len:
                    # the EOF marker is distinguished by a short entry
                    # read, exactly as in the reference (slow5_idx.c:435-460)
                    if head + rid == INDEX_EOF:
                        break
                    raise IOError(f"{path}: truncated index entry")
                off_sz = fp.read(16)
                if len(off_sz) != 16:
                    raise IOError(f"{path}: truncated index entry")
                offset, size = struct.unpack("<QQ", off_sz)
                idx.insert(rid.decode("ascii"), offset, size)
        return idx

    def write(self, path: str) -> None:
        """Emit the binary `.idx` layout (ref slow5_idx_write).

        Atomic: written to a same-directory temp file then rename()d
        into place, so a concurrent reader (multi-host startup, every
        host racing to create the sidecar) can never observe a partial
        index -- it sees either no file or a complete one.
        """
        import os

        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fp:
            fp.write(INDEX_MAGIC)
            fp.write(struct.pack("<BBB", *self.version))
            fp.write(b"\x00" * (INDEX_HEADER_SIZE - fp.tell()))
            for rid, (offset, size) in self._map.items():
                rb = rid.encode("ascii")
                fp.write(struct.pack("<H", len(rb)))
                fp.write(rb)
                fp.write(struct.pack("<QQ", offset, size))
            fp.write(INDEX_EOF)
        try:
            os.replace(tmp, path)
        except OSError:
            os.unlink(tmp)
            raise
