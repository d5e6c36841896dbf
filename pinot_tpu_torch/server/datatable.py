"""DataTable: the server-to-broker wire format, `PDT1`.

A copy of pinot_tpu/server/datatable.py (ref pinot-common
datatable/DataTableImplV4.java:82): the bytes a server returns for a
query, its per-segment results, the server's stats and its exceptions, as
a tagged value tree (not pickle: a broker never runs payload-controlled
code). The layout is the reference's byte for byte, so a JAX broker reads
a port server's reply and the port reads a JAX server's:

  'PDT1', then [exceptions], stats, u32 count, count shape-tagged results
  N null | i int64 | f float64 | s utf-8 str | b bytes | T/F bool
  D Decimal(str) | t tuple | l list | S set | M dict
  A numpy array (dtype str, ndim, shape, raw bytes; strings as a list)
  H HyperLogLog (log2m + registers) | G TDigest (compression, total,
  means, weights)

The sketches are the port's own (query/sketches.py). Theta (E) and KLL
(K) sketches come with the functions that make them. A server's span tree
may follow the payload as one more tagged value
(`deserialize_results_ex` returns it).
"""
from __future__ import annotations

import struct
from decimal import Decimal
from typing import Any, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.query.results import (
    AggregationResult, DistinctResult, ExecutionStats, GroupByResult,
    SelectionResult)
from pinot_tpu_torch.query.sketches import HyperLogLog, TDigest
from pinot_tpu_torch.utils import errorcodes

MAGIC = b"PDT1"

_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u32(self, v: int):
        self.parts.append(_U32.pack(v))

    def raw(self, b: bytes):
        self.parts.append(b)

    def tag(self, t: str):
        self.parts.append(t.encode())

    def seq(self, t: str, items):
        self.tag(t)
        self.u32(len(items))
        for x in items:
            self.value(x)

    def value(self, v: Any):
        if v is None:
            self.tag("N")
        elif isinstance(v, (bool, np.bool_)):
            self.tag("T" if v else "F")
        elif isinstance(v, (int, np.integer)):
            self.tag("i")
            self.raw(_I64.pack(int(v)))
        elif isinstance(v, (float, np.floating)):
            self.tag("f")
            self.raw(_F64.pack(float(v)))
        elif isinstance(v, str):
            b = v.encode()
            self.tag("s")
            self.u32(len(b))
            self.raw(b)
        elif isinstance(v, bytes):
            self.tag("b")
            self.u32(len(v))
            self.raw(v)
        elif isinstance(v, Decimal):
            b = str(v).encode()
            self.tag("D")
            self.u32(len(b))
            self.raw(b)
        elif isinstance(v, tuple):
            self.seq("t", v)
        elif isinstance(v, list):
            self.seq("l", v)
        elif isinstance(v, (set, frozenset)):
            self.seq("S", list(v))
        elif isinstance(v, dict):
            self.tag("M")
            self.u32(len(v))
            for k, x in v.items():
                self.value(k)
                self.value(x)
        elif isinstance(v, np.ndarray):
            self.tag("A")
            if v.dtype.kind in "UO":  # a list of strings
                self.value([str(x) for x in v.tolist()])
            else:
                dt = v.dtype.str.encode()
                self.u32(len(dt))
                self.raw(dt)
                self.u32(v.ndim)
                for d in v.shape:
                    self.u32(d)
                self.raw(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, HyperLogLog):
            self.tag("H")
            self.u32(v.log2m)
            self.raw(v.registers.astype(np.uint8).tobytes())
        elif isinstance(v, TDigest):
            v._compress(force=True)
            self.tag("G")
            self.raw(_F64.pack(v.compression))
            self.raw(_F64.pack(v.total))
            self.value(v.means)
            self.value(v.weights)
        else:
            raise TypeError(f"unserializable value type {type(v)}")

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def u32(self) -> int:
        v = _U32.unpack_from(self.buf, self.pos)[0]
        self.pos += 4
        return v

    def f64(self) -> float:
        v = _F64.unpack_from(self.buf, self.pos)[0]
        self.pos += 8
        return v

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def value(self) -> Any:
        t = chr(self.buf[self.pos])
        self.pos += 1
        if t == "N":
            return None
        if t == "T":
            return True
        if t == "F":
            return False
        if t == "i":
            v = _I64.unpack_from(self.buf, self.pos)[0]
            self.pos += 8
            return v
        if t == "f":
            return self.f64()
        if t == "s":
            return self.take(self.u32()).decode()
        if t == "b":
            return self.take(self.u32())
        if t == "D":
            return Decimal(self.take(self.u32()).decode())
        if t == "t":
            return tuple(self.value() for _ in range(self.u32()))
        if t == "l":
            return [self.value() for _ in range(self.u32())]
        if t == "S":
            return {self.value() for _ in range(self.u32())}
        if t == "M":
            return {self.value(): self.value() for _ in range(self.u32())}
        if t == "A":
            if chr(self.buf[self.pos]) == "l":  # strings, stored as a list
                return np.array(self.value(), dtype=object)
            dt = np.dtype(self.take(self.u32()).decode())
            shape = tuple(self.u32() for _ in range(self.u32()))
            n = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(self.take(n * dt.itemsize), dtype=dt)
            return arr.reshape(shape).copy()
        if t == "H":
            h = HyperLogLog(self.u32())
            h.registers = np.frombuffer(self.take(h.m),
                                        dtype=np.uint8).copy()
            return h
        if t == "G":
            td = TDigest(self.f64())
            td.total = self.f64()
            td.means = self.value()
            td.weights = self.value()
            return td
        if t in "EK":
            raise ValueError(f"the {'theta' if t == 'E' else 'KLL'} sketch "
                             "is not in this port yet")
        raise ValueError(f"bad tag {t!r} at {self.pos - 1}")


def _stats_tuple(s: ExecutionStats) -> tuple:
    return (s.num_docs_scanned, s.num_entries_scanned_in_filter,
            s.num_entries_scanned_post_filter, s.num_segments_processed,
            s.num_segments_matched, s.total_docs, s.num_segments_pruned)


def serialize_value(v: Any) -> bytes:
    """One typed value (a server's span tree, appended to its reply)."""
    w = _Writer()
    w.value(v)
    return w.bytes()


def deserialize_value(buf: bytes) -> Any:
    return _Reader(buf).value()


def serialize_results(results: List[Any], exceptions: List[dict] = (),
                      extra_stats: Optional[ExecutionStats] = None) -> bytes:
    """A server's reply: its shape-tagged per-segment results, its
    exceptions and its own stats (the pruner's counts survive a reply with
    no result)."""
    w = _Writer()
    w.raw(MAGIC)
    w.value([(int(e.get("errorCode", errorcodes.QUERY_EXECUTION)),
              str(e.get("message", ""))) for e in exceptions])
    w.value(_stats_tuple(extra_stats) if extra_stats is not None else None)
    w.u32(len(results))
    for r in results:
        if isinstance(r, AggregationResult):
            w.tag("1")
            w.value(r.intermediates)
            w.value(_stats_tuple(r.stats))
        elif isinstance(r, GroupByResult):
            w.tag("2")
            w.value(r.groups)
            w.value(_stats_tuple(r.stats))
            w.value(r.num_groups_limit_reached)
        elif isinstance(r, SelectionResult):
            w.tag("3")
            w.value(r.rows)
            w.value(r.order_values)
            w.value(r.columns)
            w.value(_stats_tuple(r.stats))
        elif isinstance(r, DistinctResult):
            w.tag("4")
            w.value(r.rows)
            w.value(_stats_tuple(r.stats))
        else:
            raise TypeError(f"unserializable result {type(r)}")
    return w.bytes()


def deserialize_results_ex(buf: bytes) -> Tuple[
        List[Any], List[dict], Optional[ExecutionStats], Optional[dict]]:
    """(results, exceptions, the server's stats, its span tree or None)."""
    if buf[:4] != MAGIC:
        raise ValueError("bad DataTable magic")
    r = _Reader(buf, 4)
    exceptions = [{"errorCode": c, "message": m} for c, m in r.value()]
    st = r.value()
    extra_stats = ExecutionStats(*st) if st is not None else None
    out: List[Any] = []
    for _ in range(r.u32()):
        tag = chr(r.buf[r.pos])
        r.pos += 1
        if tag == "1":
            inters = r.value()
            out.append(AggregationResult(inters, ExecutionStats(*r.value())))
        elif tag == "2":
            groups = r.value()
            stats = ExecutionStats(*r.value())
            out.append(GroupByResult(groups, stats,
                                     num_groups_limit_reached=r.value()))
        elif tag == "3":
            rows, order_values, columns = r.value(), r.value(), r.value()
            out.append(SelectionResult(rows, order_values=order_values,
                                       columns=columns,
                                       stats=ExecutionStats(*r.value())))
        elif tag == "4":
            rows = r.value()
            out.append(DistinctResult(rows, ExecutionStats(*r.value())))
        else:
            raise ValueError(f"bad result tag {tag!r}")
    trace = None
    if r.pos < len(r.buf):
        t = r.value()
        if isinstance(t, dict):
            trace = t
    return out, exceptions, extra_stats, trace
