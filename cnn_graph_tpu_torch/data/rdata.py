"""RData -> .mat conversion (the reference's nips2016/loadRData.py).

A copy of ``cnn_graph_tpu/data/rdata.py``: ``parse_rdata_bytes`` (:220),
the pure-Python reader of R's XDR serialization (version 2 and 3
streams, ``RDX2``/``RDX3`` workspaces and ``.rds`` single objects,
uncompressed or wrapped in gzip, bzip2 or xz) for the subset the flow
datasets need: numeric, integer, logical and string vectors and
matrices (``dim`` respected, Fortran order), lists (named lists become
dicts), pairlists and reference-table symbols; ``rdata_to_dict`` (:251)
and ``rdata_to_mat`` (:282), whose output is a dict of numpy arrays
written with ``scipy.io.savemat``.  The JAX package falls back to
pyreadr or rpy2 for other files; the port raises there instead.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np
import scipy.io

__all__ = ["rdata_to_dict", "rdata_to_mat", "parse_rdata_bytes"]

# SEXP type codes used by the serialization format (R internals).
_NILSXP = 0
_SYMSXP = 1
_LISTSXP = 2
_LANGSXP = 6
_CHARSXP = 9
_LGLSXP = 10
_INTSXP = 13
_REALSXP = 14
_CPLXSXP = 15
_STRSXP = 16
_VECSXP = 19
_EXPRSXP = 20
_RAWSXP = 24
_REFSXP = 255
_NILVALUE = 254
_GLOBALENV = 253
_MISSINGARG = 251
_BASENAMESPACE = 252
_EMPTYENV = 242
_BASEENV = 241
_UNBOUNDVALUE = 245
_NA_INTEGER = -2147483648

_HASATTR = 0x200
_HASTAG = 0x400


class _Nil:
    """R NULL sentinel (distinct from python None in pairlist cdr)."""


_NIL = _Nil()


class _Sym:
    def __init__(self, name):
        self.name = name


class _XDRReader:
    """Pure-python reader for one XDR serialization stream."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos
        self.refs = []  # serialization reference table (1-based)

    def _take(self, n):
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated RData stream")
        self.pos += n
        return b

    def u32(self):
        return struct.unpack(">I", self._take(4))[0]

    def i32(self):
        return struct.unpack(">i", self._take(4))[0]

    def f64(self, n):
        return np.frombuffer(self._take(8 * n), ">f8").astype(np.float64)

    def ints(self, n):
        return np.frombuffer(self._take(4 * n), ">i4").astype(np.int32)

    def length(self):
        n = self.i32()
        if n == -1:  # long vector: two 32-bit halves
            hi, lo = self.u32(), self.u32()
            return (hi << 32) | lo
        return n

    def header(self, rds: bool):
        fmt = self._take(2)
        if fmt not in (b"X\n", b"A\n", b"B\n"):
            raise ValueError(f"unsupported serialization format {fmt!r}")
        if fmt != b"X\n":
            raise ValueError("only XDR ('X') RData streams are supported")
        version = self.i32()
        self.i32()  # writer R version
        self.i32()  # minimal reader R version
        if version >= 3:
            enc_len = self.i32()
            self._take(enc_len)  # native encoding name
        return version

    # ---- items ----

    def item(self):
        flags = self.u32()
        t = flags & 255
        if t == _NILVALUE or t == _NILSXP:
            return _NIL
        if t in (_GLOBALENV, _EMPTYENV, _BASEENV, _UNBOUNDVALUE,
                 _MISSINGARG, _BASENAMESPACE):
            return _NIL
        if t == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i32()
            return self.refs[idx - 1]
        if t == _SYMSXP:
            name = self.item()  # CHARSXP
            sym = _Sym(name)
            self.refs.append(sym)
            return sym
        if t in (_LISTSXP, _LANGSXP):
            attr = self.item() if flags & _HASATTR else _NIL
            tag = self.item() if flags & _HASTAG else _NIL
            car = self.item()
            cdr = self.item()
            return ("pairlist", attr, tag, car, cdr)
        if t == _CHARSXP:
            n = self.i32()
            if n == -1:
                return None  # NA_character_
            return self._take(n).decode("utf-8", errors="replace")

        # vector types: data then (optionally) attributes
        if t in (_LGLSXP, _INTSXP):
            n = self.length()
            data = self.ints(n)
        elif t == _REALSXP:
            n = self.length()
            data = self.f64(n)
        elif t == _CPLXSXP:
            n = self.length()
            raw = self.f64(2 * n)
            data = raw[0::2] + 1j * raw[1::2]
        elif t == _STRSXP:
            n = self.length()
            data = np.asarray([self.item() for _ in range(n)], object)
        elif t in (_VECSXP, _EXPRSXP):
            n = self.length()
            data = [self.item() for _ in range(n)]
        elif t == _RAWSXP:
            n = self.length()
            data = np.frombuffer(self._take(n), np.uint8)
        else:
            raise ValueError(f"unsupported SEXP type {t} in RData stream")
        attr = self.item() if flags & _HASATTR else _NIL
        return ("vector", t, data, attr)


def _attr_dict(attr):
    """Pairlist of attributes -> {name: converted value}."""
    out = {}
    while isinstance(attr, tuple) and attr[0] == "pairlist":
        _, _a, tag, car, cdr = attr
        if isinstance(tag, _Sym):
            out[tag.name] = _convert(car)
        attr = cdr
    return out


def _convert(item):
    """Parsed item -> numpy array / dict / list / scalar."""
    if item is _NIL or item is None:
        return None
    if isinstance(item, _Sym):
        return item.name
    if isinstance(item, str):
        return item
    kind = item[0]
    if kind == "pairlist":
        out = {}
        node = item
        while isinstance(node, tuple) and node[0] == "pairlist":
            _, _a, tag, car, cdr = node
            key = tag.name if isinstance(tag, _Sym) else str(len(out))
            out[key] = _convert(car)
            node = cdr
        return out
    _, t, data, attr = item
    attrs = _attr_dict(attr)
    if t in (_VECSXP, _EXPRSXP):
        vals = [_convert(v) for v in data]
        names = attrs.get("names")
        if names is not None and len(names) == len(vals):
            return {str(n): v for n, v in zip(names, vals)}
        return vals
    arr = data
    if t == _LGLSXP:
        arr = np.where(arr == _NA_INTEGER, -1, arr).astype(np.int8)
    dim = attrs.get("dim")
    if dim is not None:
        arr = np.asarray(arr).reshape(
            tuple(int(d) for d in np.ravel(dim)), order="F"
        )
    return arr


def parse_rdata_bytes(raw: bytes) -> dict:
    """Parse .RData / .rds bytes into a dict of numpy values.

    Handles the three compressors ``save()`` can emit — gzip (the
    default), bzip2 (``compress="bzip2"``), xz (``compress="xz"``) —
    plus uncompressed streams.  Workspaces map each top-level binding
    name to its value; an .rds stream maps its single object to
    {"value": obj}."""
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    elif raw[:3] == b"BZh":
        import bz2

        raw = bz2.decompress(raw)
    elif raw[:6] == b"\xfd7zXZ\x00":
        import lzma

        raw = lzma.decompress(raw)
    if raw[:5] in (b"RDX3\n", b"RDX2\n", b"RDA3\n", b"RDA2\n"):
        r = _XDRReader(raw, pos=5)
        r.header(rds=False)
        top = r.item()  # pairlist of bindings
        out = _convert(top)
        if not isinstance(out, dict):
            raise ValueError("workspace did not parse to bindings")
        return out
    r = _XDRReader(raw)
    r.header(rds=True)
    return {"value": _convert(r.item())}


def rdata_to_dict(path: str) -> dict:
    """Load an .RData/.rds file into a dict of numpy arrays with the pure
    Python XDR reader.  A file outside the subset it reads (an ALTREP-
    compressed or environment-bearing workspace) raises: the JAX
    package falls back to pyreadr or rpy2 there, which the port does
    not import."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return parse_rdata_bytes(raw)
    except ValueError as err:
        raise RuntimeError(
            f"{path}: the pure-Python RData reader cannot read this file "
            f"({err}); convert it elsewhere (pyreadr or rpy2 and R) to a "
            ".mat holding a dict of arrays") from err


def rdata_to_mat(rdata_path: str, mat_path: str) -> dict:
    """Convert an RData file to .mat (loadRData.py:13-25 semantics)."""
    data = rdata_to_dict(rdata_path)
    scipy.io.savemat(mat_path, data)
    return data
