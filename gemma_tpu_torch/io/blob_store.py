"""`.sbs` BlobStore reader/writer, wire-compatible with io/blob_store.{h,cc}.

On-disk little-endian layout (blob_store.cc:95-112):

  Header:    magic u32 = 0x0A534253 ("SBS\\n"), num_blobs u32, file_bytes u64
  Directory: num_blobs x u128 keys (<= 16 ASCII chars, zero-padded),
             then num_blobs x u128 (offset u64, bytes u64)

  V1: Header + Directory + pad(256) + Payload + pad(64K)
  V2: Header{num_blobs=0, file_bytes=64K} + pad(256) + Payload + pad
      + Directory + Header        (always written; enables streaming writes)

Each blob's offset is 256-byte aligned (kBlobAlign); the file is padded to a
64 KiB multiple (kEndAlign) for mmap.  We always write V2, and read both.

A copy of gemma_tpu/io/blob_store.py without its optional C reader
(io/native_io.py): blobs are read through the mapping.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

import numpy as np

MAGIC = 0x0A534253  # "SBS\n"
BLOB_ALIGN = 256
END_ALIGN = 64 * 1024
MAX_BLOBS = 16 * 1024
_HEADER = struct.Struct("<IIQ")  # magic, num_blobs, file_bytes


def _round_up(x: int, align: int) -> int:
    return (x + align - 1) // align * align


def _key_to_bytes(key: str) -> bytes:
    raw = key.encode("ascii")
    if not 0 < len(raw) <= 16:
        raise ValueError(f"Blob key must be 1..16 chars: {key!r}")
    return raw + b"\0" * (16 - len(raw))


def _key_from_bytes(raw: bytes) -> str:
    return raw.rstrip(b"\0").decode("ascii")


class BlobReader:
    """Reads the header/directory; blobs are fetched on demand.

    Maps BlobReader (io/blob_store.h:51-112): key -> (offset, bytes) lookup
    plus whole-blob reads.  `memmap=True` maps the file so large tensor blobs
    are paged in lazily (the reference's kMap mode, gemma/weights.h:381-390).
    """

    def __init__(self, path: str, memmap: bool = True):
        self.path = str(path)
        self._file = open(self.path, "rb")
        file_bytes = os.fstat(self._file.fileno()).st_size
        self._mmap = None
        if memmap:
            import mmap as mmap_mod

            self._mmap = mmap_mod.mmap(
                self._file.fileno(), 0, access=mmap_mod.ACCESS_READ
            )

        header = self._read_at(0, _HEADER.size)
        magic, num_blobs, header_file_bytes = _HEADER.unpack(header)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a BlobStore file (magic {magic:#x})")
        if num_blobs == 0:
            # V2: directory + header at the end of the file.
            tail = self._read_at(file_bytes - _HEADER.size, _HEADER.size)
            magic, num_blobs, header_file_bytes = _HEADER.unpack(tail)
            if magic != MAGIC or num_blobs == 0 or num_blobs > MAX_BLOBS:
                raise ValueError(f"{path}: corrupt V2 BlobStore trailer")
            dir_bytes = 2 * 16 * num_blobs
            dir_off = file_bytes - _HEADER.size - dir_bytes
        else:
            if num_blobs > MAX_BLOBS:
                raise ValueError(f"{path}: too many blobs")
            dir_bytes = 2 * 16 * num_blobs
            dir_off = _HEADER.size
        if header_file_bytes != file_bytes:
            raise ValueError(
                f"{path}: truncated (header says {header_file_bytes}, "
                f"file is {file_bytes})"
            )

        directory = self._read_at(dir_off, dir_bytes)
        self.keys: list[str] = []
        self.ranges: dict[str, tuple[int, int]] = {}
        for i in range(num_blobs):
            key = _key_from_bytes(directory[i * 16 : (i + 1) * 16])
            off, nbytes = struct.unpack(
                "<QQ", directory[(num_blobs + i) * 16 : (num_blobs + i + 1) * 16]
            )
            if off == 0 or nbytes == 0 or off + nbytes > file_bytes:
                raise ValueError(f"{path}: invalid range for blob {key!r}")
            self.keys.append(key)
            self.ranges[key] = (off, nbytes)

    def _read_at(self, offset: int, nbytes: int) -> bytes:
        if self._mmap is not None:
            return self._mmap[offset : offset + nbytes]
        self._file.seek(offset)
        return self._file.read(nbytes)

    def __contains__(self, key: str) -> bool:
        return key in self.ranges

    def blob_bytes(self, key: str) -> int:
        return self.ranges[key][1]

    def read(self, key: str, dtype=np.uint8, copy: bool = True) -> np.ndarray:
        """Read one whole blob as a numpy array of `dtype`.

        With `copy=False` and memmap enabled, returns a zero-copy view into
        the mapping (pages fault in lazily, the reference's kMap mode); the
        reader must stay open while the view is alive.
        """
        off, nbytes = self.ranges[key]
        if self._mmap is not None:
            buf = np.frombuffer(self._mmap, dtype=np.uint8, count=nbytes, offset=off)
            if copy:
                buf = buf.copy()
        else:
            buf = np.frombuffer(self._read_at(off, nbytes), dtype=np.uint8)
        return buf.view(dtype)

    def read_slice(self, key: str, offset: int, nbytes: int) -> np.ndarray:
        """Read a byte range within a blob (for sharded/parallel loads)."""
        off, total = self.ranges[key]
        assert offset + nbytes <= total
        if self._mmap is not None:
            return np.frombuffer(
                self._mmap, dtype=np.uint8, count=nbytes, offset=off + offset
            )
        return np.frombuffer(self._read_at(off + offset, nbytes), dtype=np.uint8)

    def close(self) -> None:
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # Zero-copy views are still alive; the mapping is released
                # when they are garbage collected.
                pass
            self._mmap = None
        self._file.close()

    def __enter__(self) -> "BlobReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BlobWriter:
    """Streaming V2 writer: blobs appended as added, directory written last.

    Maps BlobWriter (io/blob_store.h:115-135): `add` buffers nothing -- each
    blob goes straight to disk at a 256-aligned offset, so writing a 27B
    model never holds more than one tensor in memory.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._file = open(self.path, "wb")
        self._keys: list[str] = []
        self._ranges: list[tuple[int, int]] = []
        # V2 prelude: header with num_blobs=0, padded to kBlobAlign.
        prelude = bytearray(_round_up(_HEADER.size, BLOB_ALIGN))
        _HEADER.pack_into(prelude, 0, MAGIC, 0, END_ALIGN)
        self._file.write(prelude)
        self._offset = len(prelude)

    def add(self, key: str, data) -> None:
        if len(self._keys) >= MAX_BLOBS:
            raise ValueError("too many blobs")
        _key_to_bytes(key)  # validate
        if key in dict(zip(self._keys, self._ranges)):
            raise ValueError(f"duplicate blob key {key!r}")
        raw = np.ascontiguousarray(data).tobytes() if not isinstance(
            data, (bytes, bytearray)
        ) else bytes(data)
        if len(raw) == 0:
            raise ValueError(f"zero-sized blob {key!r}")
        self._keys.append(key)
        self._ranges.append((self._offset, len(raw)))
        self._file.write(raw)
        padded = _round_up(len(raw), BLOB_ALIGN)
        if padded != len(raw):
            self._file.write(b"\0" * (padded - len(raw)))
        self._offset += padded

    def finalize(self) -> None:
        num_blobs = len(self._keys)
        dir_bytes = 2 * 16 * num_blobs
        trailer_bytes = _round_up(_HEADER.size + dir_bytes, BLOB_ALIGN)
        file_bytes = _round_up(self._offset + trailer_bytes, END_ALIGN)

        directory = bytearray()
        for key in self._keys:
            directory += _key_to_bytes(key)
        for off, nbytes in self._ranges:
            directory += struct.pack("<QQ", off, nbytes)

        header = _HEADER.pack(MAGIC, num_blobs, file_bytes)
        pad = file_bytes - self._offset - dir_bytes - _HEADER.size
        self._file.write(b"\0" * pad)
        self._file.write(bytes(directory))
        self._file.write(header)
        self._file.close()

    def __enter__(self) -> "BlobWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.finalize()
        else:
            self._file.close()


def iter_blobs(path: str) -> Iterator[tuple[str, int]]:
    """Yield (key, nbytes) for each blob without reading payloads."""
    with BlobReader(path, memmap=False) as reader:
        for key in reader.keys:
            yield key, reader.blob_bytes(key)
