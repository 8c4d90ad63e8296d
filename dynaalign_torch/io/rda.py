"""Minimal reader for R .rda / .rds serialization (XDR format, v2/v3).

The reference ships its nine datasets as lazy-loaded .rda blobs
(reference: data/*.rda, DESCRIPTION:17 ``LazyData: true``).  The package
depends on neither R nor pyreadr, so it implements the subset of R's
serialization grammar those files need: pairlists, symbols,
character/integer/real/logical vectors, generic vectors (lists /
data.frames), attributes, reference table entries, and the ALTREP compact
sequences modern R uses for ``row.names``.

Format reference: R Internals §1.8 "Serialization Formats" (public
documentation of the on-disk grammar).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from typing import Any, BinaryIO

import numpy as np

# SEXP type codes (R Internals, Rinternals.h — public ABI constants)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CLOSXP = 3
ENVSXP = 4
LANGSXP = 6
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
EXPRSXP = 20
RAWSXP = 24
S4SXP = 25
# serialization pseudo-types
REFSXP = 255
NILVALUE_SXP = 254
GLOBALENV_SXP = 253
UNBOUNDVALUE_SXP = 252
MISSINGARG_SXP = 251
BASENAMESPACE_SXP = 250
NAMESPACESXP = 249
PACKAGESXP = 248
PERSISTSXP = 247
BASEENV_SXP = 241
EMPTYENV_SXP = 242
ATTRLANGSXP = 240
ATTRLISTSXP = 239
ALTREP_SXP = 238

NA_INTEGER = -2147483648


class RObject:
    """A decoded R object: .value plus .attributes dict."""

    __slots__ = ("value", "attributes")

    def __init__(self, value: Any, attributes: dict | None = None):
        self.value = value
        self.attributes = attributes or {}

    def __repr__(self):
        return f"RObject({type(self.value).__name__}, attrs={list(self.attributes)})"


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.refs: list[Any] = []

    def u8(self) -> int:
        return self.f.read(1)[0]

    def i4(self) -> int:
        return struct.unpack(">i", self.f.read(4))[0]

    def read_header(self) -> None:
        magic = self.f.read(2)
        if magic == b"RD":
            rest = self.f.read(3)  # e.g. b"X3\n" / b"X2\n" (rda) header line
            if rest[:1] not in (b"X", b"A", b"B"):
                raise ValueError(f"unsupported RData header {magic + rest!r}")
            fmt = self.f.read(2)  # b"X\n" XDR marker
            if fmt != b"X\n":
                raise ValueError(f"only XDR serialization supported, got {fmt!r}")
        elif magic == b"X\n":
            pass  # bare .rds XDR stream
        else:
            raise ValueError(f"not an XDR RData stream: {magic!r}")
        version = self.i4()
        self.i4()  # writer version
        self.i4()  # min reader version
        if version >= 3:
            enc_len = self.i4()
            self.f.read(enc_len)  # native encoding name

    # -- grammar ------------------------------------------------------------
    def read_item(self) -> Any:
        flags = self.i4()
        typ = flags & 255
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if typ == NILVALUE_SXP or typ == NILSXP:
            return None
        if typ == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i4()
            return self.refs[idx - 1]
        if typ == SYMSXP:
            name = self.read_item()  # CHARSXP
            sym = ("symbol", name.value if isinstance(name, RObject) else name)
            self.refs.append(sym)
            return sym
        if typ in (PACKAGESXP, NAMESPACESXP):
            self.i4()  # version-marker int preceding the name strings
            n = self.i4()
            names = [self._read_charsxp_raw() for _ in range(n)]
            ref = ("package", names)
            self.refs.append(ref)
            return ref
        if typ in (GLOBALENV_SXP, BASEENV_SXP, EMPTYENV_SXP,
                   UNBOUNDVALUE_SXP, MISSINGARG_SXP, BASENAMESPACE_SXP):
            return ("special_env", typ)
        if typ == ENVSXP:
            self.i4()  # locked
            ref = ("environment", [])
            self.refs.append(ref)
            for _ in range(4):  # enclos, frame, hashtab, attrib
                ref[1].append(self.read_item())
            return ref
        if typ in (LISTSXP, LANGSXP, ATTRLISTSXP, ATTRLANGSXP):
            attrs = self.read_item() if has_attr else None
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            cdr = self.read_item()
            return ("pairlist", tag, car, cdr, attrs)
        if typ == CHARSXP:
            n = self.i4()
            if n == -1:
                return RObject(None)
            return RObject(self.f.read(n).decode("utf-8", errors="replace"))
        if typ == LGLSXP:
            n = self.i4()
            data = np.frombuffer(self.f.read(4 * n), dtype=">i4").astype(np.int32)
            val = np.where(data == NA_INTEGER, -1, data)
            return self._with_attrs(RObject(val), has_attr)
        if typ == INTSXP:
            n = self.i4()
            data = np.frombuffer(self.f.read(4 * n), dtype=">i4").astype(np.int32)
            return self._with_attrs(RObject(data), has_attr)
        if typ == REALSXP:
            n = self.i4()
            data = np.frombuffer(self.f.read(8 * n), dtype=">f8").astype(np.float64)
            return self._with_attrs(RObject(data), has_attr)
        if typ == CPLXSXP:
            n = self.i4()
            data = np.frombuffer(self.f.read(16 * n), dtype=">c16").astype(np.complex128)
            return self._with_attrs(RObject(data), has_attr)
        if typ == RAWSXP:
            n = self.i4()
            return self._with_attrs(RObject(self.f.read(n)), has_attr)
        if typ == STRSXP:
            n = self.i4()
            vals = []
            for _ in range(n):
                item = self.read_item()
                vals.append(item.value if isinstance(item, RObject) else item)
            return self._with_attrs(RObject(np.array(vals, dtype=object)), has_attr)
        if typ in (VECSXP, EXPRSXP):
            n = self.i4()
            vals = [self.read_item() for _ in range(n)]
            return self._with_attrs(RObject(vals), has_attr)
        if typ == ALTREP_SXP:
            info = self.read_item()  # pairlist: (class, package, type)
            state = self.read_item()
            self.read_item()  # attributes slot of the altrep
            return self._decode_altrep(info, state)
        if typ == S4SXP:
            return self._with_attrs(RObject(("S4",)), has_attr)
        raise ValueError(f"unsupported SEXP type {typ} in RData stream")

    def _read_charsxp_raw(self) -> str:
        item = self.read_item()
        return item.value if isinstance(item, RObject) else item

    def _with_attrs(self, obj: RObject, has_attr: bool) -> RObject:
        if has_attr:
            obj.attributes = pairlist_to_dict(self.read_item())
        return obj

    def _decode_altrep(self, info, state) -> RObject:
        # info is a pairlist whose CAR is the class symbol
        class_name = None
        if isinstance(info, tuple) and info[0] == "pairlist":
            car = info[2]
            if isinstance(car, tuple) and car[0] == "symbol":
                class_name = car[1]
        if class_name == "compact_intseq":
            n, start, step = state.value  # REALSXP [n, start, step]
            return RObject(
                (np.arange(int(n)) * int(step) + int(start)).astype(np.int32)
            )
        if class_name == "compact_realseq":
            n, start, step = state.value
            return RObject(np.arange(int(n)) * step + start)
        if class_name in ("wrap_integer", "wrap_real", "wrap_string",
                          "wrap_logical", "wrap_complex", "wrap_raw"):
            # state = pairlist-ish (wrapped, metadata); CAR holds the payload
            if isinstance(state, tuple) and state[0] == "pairlist":
                payload = state[2]
            elif isinstance(state, RObject) and isinstance(state.value, list):
                payload = state.value[0]
            else:
                payload = state
            return payload if isinstance(payload, RObject) else RObject(payload)
        raise ValueError(f"unsupported ALTREP class {class_name!r}")


def pairlist_to_dict(pl) -> dict:
    out = {}
    while isinstance(pl, tuple) and pl and pl[0] == "pairlist":
        _, tag, car, cdr, _ = pl
        key = tag[1] if isinstance(tag, tuple) and tag[0] == "symbol" else tag
        out[key] = car
        pl = cdr
    return out


def _open_maybe_compressed(path: str) -> BinaryIO:
    with open(path, "rb") as f:
        magic = f.read(6)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(path, "rb")
    if magic[:3] == b"BZh":
        return bz2.open(path, "rb")
    if magic[:6] == b"\xfd7zXZ\x00":
        return lzma.open(path, "rb")
    return open(path, "rb")


def load_rda(path: str) -> dict[str, RObject]:
    """Load an .rda workspace file: {object_name: RObject}."""
    with _open_maybe_compressed(path) as f:
        r = _Reader(f)
        r.read_header()
        top = r.read_item()
    out = {}
    for key, val in pairlist_to_dict(top).items():
        out[key] = val
    return out


def load_rds(path: str) -> RObject:
    """Load a single-object .rds file."""
    with _open_maybe_compressed(path) as f:
        r = _Reader(f)
        r.read_header()
        return r.read_item()


def to_columns(obj: RObject) -> dict[str, np.ndarray]:
    """Convert a decoded data.frame RObject to {column_name: array}.

    Factor columns (INTSXP with a ``levels`` attribute) are expanded to
    their string labels.
    """
    attrs = obj.attributes
    names_obj = attrs.get("names")
    names = list(names_obj.value) if isinstance(names_obj, RObject) else None
    cols = obj.value
    if names is None or not isinstance(cols, list):
        raise ValueError("not a data.frame-like object")
    out: dict[str, np.ndarray] = {}
    for name, col in zip(names, cols):
        if not isinstance(col, RObject):
            out[name] = np.asarray(col)
            continue
        val = col.value
        levels = col.attributes.get("levels")
        if levels is not None and isinstance(val, np.ndarray) and val.dtype.kind == "i":
            lv = np.asarray(levels.value, dtype=object)
            expanded = np.empty(len(val), dtype=object)
            ok = val > 0
            expanded[ok] = lv[val[ok] - 1]
            expanded[~ok] = None
            out[name] = expanded
        else:
            out[name] = np.asarray(val)
    return out
