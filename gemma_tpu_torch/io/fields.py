"""Version-less forward/backward-compatible struct serialization.

Wire-compatible with the reference's io/fields.{h,cc} (JPEG-XL-inspired):
everything is encoded into little-endian uint32 words,

  u32/i32  -> 1 word               bool -> 1 word (0/1)
  enum     -> 1 word (validated)   f32  -> 1 word (bit cast, finite only)
  u64      -> 2 words (lo, hi)
  str      -> [num_u32][ceil(len/4) words, zero-padded, ASCII, <= 64 words]
  vector   -> [count][items...]    (count <= 64K)
  nested   -> [payload_num_u32][payload...]

Readers skip unknown trailing fields (old code / new data) and keep defaults
for missing ones (new code / old data); the nested length prefix makes both
directions safe (io/fields.h:36-51, fields.cc:117-243).

Usage: subclass `Fields` and define `visit(self, v)` calling the visitor for
each field in the unchanging serialization order, e.g.::

    class LayerConfig(Fields):
        def visit(self, v):
            self.model_dim = v.u32(self.model_dim)
            ...
"""

from __future__ import annotations

import dataclasses

import numpy as np


class Fields:
    """Base class for serializable field structs."""

    def visit(self, v: "Visitor") -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def write(self) -> np.ndarray:
        return write_fields(self)

    def read(self, span: np.ndarray, pos: int = 0) -> "ReadResult":
        return read_fields(self, span, pos)


@dataclasses.dataclass
class ReadResult:
    """Maps IFields::ReadResult: pos==0 signals failure."""

    pos: int
    missing_fields: int = 0
    extra_u32: int = 0


class Visitor:
    """Abstract visitor; subclasses implement the scalar hooks."""

    def u32(self, value: int) -> int:
        raise NotImplementedError

    def i32(self, value: int) -> int:
        raise NotImplementedError

    def u64(self, value: int) -> int:
        lo = self.u32(value & 0xFFFFFFFF)
        hi = self.u32((value >> 32) & 0xFFFFFFFF)
        return (hi << 32) | lo

    def f32(self, value: float) -> float:
        u = int(np.float32(value).view(np.uint32))
        u = self.u32(u)
        out = float(np.uint32(u).view(np.float32))
        if not np.isfinite(out):
            raise ValueError(f"Invalid float {out}")
        return out

    def boolean(self, value: bool) -> bool:
        u = self.u32(1 if value else 0)
        if u > 1:
            raise ValueError(f"Invalid bool {u}")
        return u == 1

    def enum(self, value, enum_cls):
        u = self.u32(int(value))
        return enum_cls(u)

    def string(self, value: str) -> str:
        raise NotImplementedError

    def fields(self, value: Fields) -> None:
        raise NotImplementedError

    def vector(self, values: list, item):
        """`item` is a callable v-method name string or a Fields factory."""
        raise NotImplementedError


class _WriteVisitor(Visitor):
    def __init__(self) -> None:
        self.storage: list[int] = []

    def u32(self, value: int) -> int:
        self.storage.append(int(value) & 0xFFFFFFFF)
        return value

    def i32(self, value: int) -> int:
        self.storage.append(int(value) & 0xFFFFFFFF)
        return value

    def string(self, value: str) -> str:
        raw = value.encode("ascii")
        num_u32 = (len(raw) + 3) // 4
        if num_u32 > 64:
            raise ValueError(f"String too long: {value!r}")
        self.u32(num_u32)
        padded = raw + b"\0" * (num_u32 * 4 - len(raw))
        for i in range(num_u32):
            word = int.from_bytes(padded[i * 4 : i * 4 + 4], "little")
            if word == 0 or (word & 0x80808080):
                raise ValueError(f"Invalid string characters in {value!r}")
            self.u32(word)
        return value

    def fields(self, value: Fields) -> None:
        placeholder = len(self.storage)
        self.storage.append(0)
        value.visit(self)
        self.storage[placeholder] = len(self.storage) - placeholder - 1

    def vector(self, values: list, item) -> list:
        self.u32(len(values))
        if len(values) > 64 * 1024:
            raise ValueError("Vector too long")
        for x in values:
            if isinstance(item, str):
                getattr(self, item)(x)
            elif isinstance(item, tuple) and item[0] == "enum":
                self.enum(x, item[1])
            else:
                self.fields(x)
        return values


class _ReadVisitor(Visitor):
    def __init__(self, span: np.ndarray, pos: int) -> None:
        self.span = np.asarray(span, dtype=np.uint32)
        self.pos = pos
        self.end = [len(self.span)]
        self.missing = 0
        self.extra = 0

    def _skip(self) -> bool:
        if self.pos >= self.end[-1]:
            self.missing += 1
            return True
        return False

    def u32(self, value: int) -> int:
        if self._skip():
            return value
        out = int(self.span[self.pos])
        self.pos += 1
        return out

    def i32(self, value: int) -> int:
        u = self.u32(value & 0xFFFFFFFF if value < 0 else value)
        return u - (1 << 32) if u >= (1 << 31) else u

    def u64(self, value: int) -> int:
        if self._skip():
            return value
        return super().u64(value)

    def f32(self, value: float) -> float:
        if self._skip():
            return value
        return super().f32(value)

    def boolean(self, value: bool) -> bool:
        if self._skip():
            return value
        return super().boolean(value)

    def enum(self, value, enum_cls):
        if self._skip():
            return value
        return super().enum(value, enum_cls)

    def string(self, value: str) -> str:
        if self._skip():
            return value
        num_u32 = self.u32(0)
        if num_u32 > 64 or self.pos + num_u32 > self.end[-1]:
            raise ValueError("Invalid string")
        raw = b""
        for _ in range(num_u32):
            word = self.u32(0)
            if word == 0 or (word & 0x80808080):
                raise ValueError("Invalid string characters")
            raw += int(word).to_bytes(4, "little")
        return raw.rstrip(b"\0").decode("ascii")

    def fields(self, value: Fields) -> None:
        self.end.append(len(self.span))
        if self._skip():
            self.end.pop()
            return
        num_u32 = self.u32(0)
        if self.pos + num_u32 > len(self.span):
            raise ValueError("Invalid nested IFields length")
        self.end[-1] = self.pos + num_u32
        value.visit(self)
        assert self.pos <= self.end[-1]
        # Mirror fields.cc:205-211: count extra words (old code, new data) but
        # do NOT advance pos; callers use `result.pos + result.extra_u32`.
        self.extra += self.end[-1] - self.pos
        self.end.pop()

    def vector(self, values: list, item) -> list:
        if self._skip():
            return values
        num = self.u32(0)
        if num > 64 * 1024:
            raise ValueError("Vector too long")
        out = []
        for _ in range(num):
            if isinstance(item, str):
                out.append(getattr(self, item)(0))
            elif isinstance(item, tuple) and item[0] == "enum":
                out.append(self.enum(0, item[1]))
            else:
                x = item()
                self.fields(x)
                out.append(x)
        return out


def write_fields(obj: Fields) -> np.ndarray:
    """Serialize to uint32 words, with the outer length prefix.

    Matches `IFields::Write` (fields.cc:343-350): the top-level object is
    itself wrapped in [num_u32][payload].
    """
    v = _WriteVisitor()
    v.fields(obj)
    return np.asarray(v.storage, dtype=np.uint32)


def read_fields(obj: Fields, span: np.ndarray, pos: int = 0) -> ReadResult:
    """Deserialize into `obj` (fields keep defaults if missing)."""
    v = _ReadVisitor(span, pos)
    try:
        v.fields(obj)
    except (ValueError, IndexError) as e:
        import warnings

        warnings.warn(f"fields read failed: {e}")
        return ReadResult(pos=0)
    return ReadResult(pos=v.pos, missing_fields=v.missing, extra_u32=v.extra)
