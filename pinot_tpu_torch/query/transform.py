"""Transform-function evaluation over column blocks, on the host.

A trimmed copy of pinot_tpu/query/transform.py (ref pinot-core
operator/transform/function/TransformFunction.java:35): an expression tree
evaluates over whole-column numpy arrays that a column provider supplies
(query/filter.py `SegmentColumnProvider`, over all of a segment's docs or
over the docs a selection picked). Here: arithmetic, the unary math
functions, comparisons and predicates, CASE, CONCAT, SUBSTR, CAST, the
string functions and COALESCE. Not yet ported: the JSON-path functions
(`json_extract_scalar`, `json_extract_key`, `json_format`), `map_value`
and `st_distance`, whose indexes the port's segments lack, and
`clpDecode`.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Protocol

import numpy as np

from pinot_tpu_torch.query.expressions import (
    Expression, Function, Identifier, Literal)
from pinot_tpu_torch.query.predicate import like_to_regex


class ColumnProvider(Protocol):
    def column(self, name: str) -> np.ndarray: ...
    @property
    def num_docs(self) -> int: ...


_BINARY_NUMERIC: Dict[str, Callable] = {
    "plus": np.add,
    "minus": np.subtract,
    "times": np.multiply,
    "divide": lambda a, b: np.divide(np.asarray(a, dtype=np.float64), b),
    "mod": np.mod,
    "pow": np.power,
    "power": np.power,
}

_UNARY_NUMERIC: Dict[str, Callable] = {
    "abs": np.abs,
    "ceil": np.ceil,
    "floor": np.floor,
    "exp": np.exp,
    "ln": np.log,
    "log": np.log,
    "log2": np.log2,
    "log10": np.log10,
    "sqrt": np.sqrt,
    "sign": np.sign,
    "negate": np.negative,
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "degrees": np.degrees, "radians": np.radians,
}

_COMPARISONS: Dict[str, Callable] = {
    "equals": lambda a, b: _eq(a, b),
    "not_equals": lambda a, b: ~_eq(a, b),
    "greater_than": lambda a, b: np.greater(a, b),
    "greater_than_or_equal": lambda a, b: np.greater_equal(a, b),
    "less_than": lambda a, b: np.less(a, b),
    "less_than_or_equal": lambda a, b: np.less_equal(a, b),
}

#: transforms of the JAX package that later slices bring over
NOT_PORTED = ("json_extract_scalar", "json_extract_key", "json_format",
              "map_value", "st_distance", "clpdecode")


def _eq(a, b):
    a_s = np.asarray(a).dtype.kind in "UOS"
    b_s = np.asarray(b).dtype.kind in "UOS"
    if a_s != b_s:  # numeric vs string comparison via string form
        a = np.asarray(a).astype(str) if not a_s else a
        b = np.asarray(b).astype(str) if not b_s else b
    return np.equal(a, b)


def evaluate(expr: Expression, provider: ColumnProvider) -> Any:
    """expr as a numpy array over the provider's docs, or a scalar for a
    literal-only tree."""
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, Identifier):
        return provider.column(expr.name)
    name = expr.name
    if name in _BINARY_NUMERIC:
        a = evaluate(expr.args[0], provider)
        b = evaluate(expr.args[1], provider)
        with np.errstate(all="ignore"):
            return _BINARY_NUMERIC[name](a, b)
    if name in _UNARY_NUMERIC:
        with np.errstate(all="ignore"):
            return _UNARY_NUMERIC[name](
                _as_numeric(evaluate(expr.args[0], provider)))
    if name in _COMPARISONS:
        return _COMPARISONS[name](evaluate(expr.args[0], provider),
                                  evaluate(expr.args[1], provider))
    if name in _PREDICATES:
        return _PREDICATES[name](expr, provider)
    handler = _SPECIAL.get(name)
    if handler is not None:
        return handler(expr, provider)
    if name in NOT_PORTED:
        raise NotImplementedError(f"transform {name} is not in this port "
                                  "yet")
    raise ValueError(f"unsupported transform function: {name}")


def _bool(x, p: ColumnProvider) -> np.ndarray:
    arr = np.asarray(x)
    if arr.ndim == 0:
        arr = np.full(p.num_docs, bool(arr))
    return arr.astype(bool, copy=False)


def _pred_and(e: Function, p: ColumnProvider):
    out = _bool(evaluate(e.args[0], p), p)
    for a in e.args[1:]:
        out = out & _bool(evaluate(a, p), p)
    return out


def _pred_or(e: Function, p: ColumnProvider):
    out = _bool(evaluate(e.args[0], p), p)
    for a in e.args[1:]:
        out = out | _bool(evaluate(a, p), p)
    return out


def _pred_between(e: Function, p: ColumnProvider):
    v = evaluate(e.args[0], p)
    lo = evaluate(e.args[1], p)
    hi = evaluate(e.args[2], p)
    return np.greater_equal(v, lo) & np.less_equal(v, hi)


def _pred_in(e: Function, p: ColumnProvider):
    v = np.asarray(evaluate(e.args[0], p))
    vals = [a.value for a in e.args[1:]]  # type: ignore[union-attr]
    if v.dtype.kind in "UOS":
        vals = [str(x) for x in vals]
        v = v.astype(str)
    else:
        # numeric column: string literals into the value domain
        vals = [float(x) if isinstance(x, str) else x for x in vals]
    return np.isin(v, np.asarray(vals))


def _pred_like(e: Function, p: ColumnProvider):
    v = np.asarray(evaluate(e.args[0], p))
    pattern = e.args[1].value  # type: ignore[union-attr]
    rx = re.compile(like_to_regex(pattern) if e.name == "like" else pattern)
    return np.array([rx.search(str(x)) is not None for x in v], bool)


def _pred_is_null(e: Function, p: ColumnProvider):
    v = np.asarray(evaluate(e.args[0], p))
    if v.dtype.kind == "f":
        return np.isnan(v)
    if v.dtype.kind == "O":
        return np.array([x is None for x in v], bool)
    return np.zeros(len(v), bool)


_PREDICATES: Dict[str, Callable] = {
    "and": _pred_and,
    "or": _pred_or,
    "not": lambda e, p: ~_bool(evaluate(e.args[0], p), p),
    "between": _pred_between,
    "in": _pred_in,
    "not_in": lambda e, p: ~_pred_in(e, p),
    "like": _pred_like,
    "regexp_like": _pred_like,
    "is_null": _pred_is_null,
    "is_not_null": lambda e, p: ~_pred_is_null(e, p),
}


def _as_numeric(x):
    arr = np.asarray(x)
    if arr.dtype.kind in "UOS":
        return arr.astype(np.float64)
    return x


def _broadcast(x, n: int) -> np.ndarray:
    arr = np.asarray(x)
    if arr.ndim == 0:
        return np.broadcast_to(arr, (n,))
    return arr


def _case(expr: Function, p: ColumnProvider):
    n = p.num_docs
    *pairs, default = expr.args
    result = _broadcast(evaluate(default, p), n).copy() \
        if default is not None else np.full(n, np.nan)
    assigned = np.zeros(n, dtype=bool)
    for i in range(0, len(pairs), 2):
        cond = _broadcast(evaluate(pairs[i], p), n).astype(bool)
        val = _broadcast(evaluate(pairs[i + 1], p), n)
        take = cond & ~assigned
        if result.dtype != val.dtype and (result.dtype.kind in "UOS"
                                          or val.dtype.kind in "UOS"):
            result = result.astype(object)
            val = val.astype(object)
        result = np.where(take, val, result)
        assigned |= cond
    return result


def _concat(expr: Function, p: ColumnProvider):
    parts = [np.asarray(evaluate(a, p)).astype(str) for a in expr.args]
    n = max((len(x) for x in parts if x.ndim), default=1)
    parts = [_broadcast(x, n) for x in parts]
    out = parts[0]
    for part in parts[1:]:
        out = np.char.add(out, part)
    return out


def _substr(expr: Function, p: ColumnProvider):
    s = np.asarray(evaluate(expr.args[0], p)).astype(str)
    start = int(evaluate(expr.args[1], p))
    if len(expr.args) > 2:
        end = int(evaluate(expr.args[2], p))
        return np.array([x[start:end] for x in s])
    return np.array([x[start:] for x in s])


def _cast(expr: Function, p: ColumnProvider):
    arr = np.asarray(evaluate(expr.args[0], p))
    target = expr.args[1]
    tname = (target.value if isinstance(target, Literal)
             else target.name).upper()  # type: ignore[union-attr]
    if tname in ("INT", "INTEGER"):
        return arr.astype(np.float64).astype(np.int32) \
            if arr.dtype.kind in "UOS" else arr.astype(np.int32)
    if tname == "LONG":
        return arr.astype(np.float64).astype(np.int64) \
            if arr.dtype.kind in "UOS" else arr.astype(np.int64)
    if tname == "FLOAT":
        return arr.astype(np.float32)
    if tname == "DOUBLE":
        return arr.astype(np.float64)
    if tname in ("STRING", "VARCHAR"):
        return arr.astype(str)
    if tname == "BOOLEAN":
        return arr.astype(bool)
    raise ValueError(f"unsupported cast target {tname}")


def _missing_mask(arr: np.ndarray) -> np.ndarray:
    """NaN for float arrays; None / NaN elements for object arrays."""
    if arr.dtype.kind == "f":
        return np.isnan(arr)
    if arr.dtype.kind == "O":
        return np.fromiter(
            (x is None or (isinstance(x, float) and np.isnan(x))
             for x in arr), dtype=bool, count=len(arr))
    return np.zeros(len(arr), dtype=bool)


def _coalesce(expr: Function, p: ColumnProvider):
    n = p.num_docs
    result = None
    for a in expr.args:
        try:
            v = _broadcast(evaluate(a, p), n)
        except TypeError:
            continue  # a null-propagating argument is NULL
        if result is None:
            result = v.copy()
        else:
            result = np.where(missing, v, result)
        missing = _missing_mask(result)
        if not missing.any():
            break
    if result is None:  # every argument was NULL
        result = np.full(n, None, dtype=object)
    return result


def _strings(e: Function, p: ColumnProvider) -> np.ndarray:
    return np.asarray(evaluate(e.args[0], p)).astype(str)


_SPECIAL: Dict[str, Callable] = {
    "case": _case,
    "concat": _concat,
    "substr": _substr,
    "substring": _substr,
    "cast": _cast,
    "lower": lambda e, p: np.char.lower(_strings(e, p)),
    "upper": lambda e, p: np.char.upper(_strings(e, p)),
    "trim": lambda e, p: np.char.strip(_strings(e, p)),
    "length": lambda e, p: np.char.str_len(_strings(e, p)),
    "strlen": lambda e, p: np.char.str_len(_strings(e, p)),
    "reverse": lambda e, p: np.array([x[::-1] for x in _strings(e, p)]),
    "coalesce": _coalesce,
}
