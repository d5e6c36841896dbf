"""Small seeded tables for the server and host-executor tests.

Built with the port's creator, which writes no bloom filter (so neither
package's pruner probes one) and whose bytes both loaders read. Imports
neither JAX nor pinot_tpu.

- `srv`: SSB-Q1-like dimensions (d_date, d_int, d_str), a raw INT m_int,
  a raw FLOAT m_float (5% of its docs exactly 0.1f, its minimum below
  0.1), a raw DOUBLE m_double ~ N(50, 10), a low-cardinality raw INT
  r_small, a 0/1 flag, and an upsert key pk with a version ver.
- `st`: the same columns, with a star-tree on (d_int, d_str) holding
  SUM__m_int and COUNT__*.
- the FLOAT-literal probe (`build_float_probe`): three segments of 3000
  docs whose raw FLOAT rf holds 0.1f in 693 docs and more than 0.1f in
  3994, every segment's minimum below 0.1.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType, Schema,
                                    StarTreeIndexConfig, TableConfig)
from pinot_tpu_torch.segment.creator import SegmentCreator

N_SEGMENTS, DOCS = 3, 4000

FIELDS = [("d_date", DataType.INT, False), ("d_int", DataType.INT, False),
          ("d_str", DataType.STRING, False), ("m_int", DataType.INT, True),
          ("m_float", DataType.FLOAT, True), ("m_double", DataType.DOUBLE, True),
          ("r_small", DataType.INT, True), ("flag", DataType.INT, False),
          ("pk", DataType.INT, False), ("ver", DataType.LONG, False)]
RAW = ["m_int", "m_float", "m_double", "r_small"]


def columns(seg: int, docs: int = DOCS, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng([seed, seg])
    m_float = rng.uniform(-0.5, 1.0, docs).astype(np.float32)
    m_float[rng.random(docs) < 0.05] = np.float32(0.1)
    return {
        "d_date": (19940101 + rng.integers(0, 90, docs)).astype(np.int32),
        "d_int": rng.integers(0, 20, docs).astype(np.int32),
        "d_str": np.array([f"s{v}" for v in rng.integers(0, 7, docs)],
                          dtype=object),
        "m_int": rng.integers(-500, 500, docs).astype(np.int32),
        "m_float": m_float,
        "m_double": rng.normal(50.0, 10.0, docs),
        "r_small": rng.integers(0, 10, docs).astype(np.int32),
        "flag": rng.integers(0, 2, docs).astype(np.int32),
        # keys repeat within and across segments: the upsert keeps the
        # latest version of each
        "pk": rng.integers(0, docs, docs).astype(np.int32),
        "ver": (seg * docs + np.arange(docs)).astype(np.int64),
    }


def _schema(name: str) -> Schema:
    return Schema(name, [FieldSpec(f, t, FieldType.METRIC if m
                                   else FieldType.DIMENSION)
                         for f, t, m in FIELDS])


def build_table(root: str, name: str, star_tree: bool = False,
                seed: int = 0) -> List[str]:
    """The table's segment directories, `{root}/{name}_{i}`."""
    tc = TableConfig(name)
    tc.indexing.no_dictionary_columns = list(RAW)
    if star_tree:
        tc.indexing.star_tree_configs = [StarTreeIndexConfig(
            ["d_int", "d_str"], [], ["SUM__m_int", "COUNT__*"])]
    creator = SegmentCreator(tc, _schema(name))
    dirs = []
    for i in range(N_SEGMENTS):
        out = os.path.join(root, f"{name}_{i}")
        creator.build(columns(i, seed=seed), out, f"{name}_{i}")
        dirs.append(out)
    return dirs


#: the FLOAT-literal probe: per segment, docs holding 0.1f and docs above
FLOAT_EQ, FLOAT_GT = (231, 231, 231), (1331, 1331, 1332)


def build_float_probe(root: str) -> List[str]:
    schema = Schema("f", [FieldSpec("rf", DataType.FLOAT, FieldType.METRIC),
                          FieldSpec("k", DataType.INT, FieldType.DIMENSION)])
    tc = TableConfig("f")
    tc.indexing.no_dictionary_columns = ["rf"]
    dirs = []
    for i in range(3):
        rng = np.random.default_rng([7, i])
        n = 3000
        rf = np.concatenate([
            np.full(FLOAT_EQ[i], 0.1, np.float32),
            rng.uniform(0.2, 1.0, FLOAT_GT[i]).astype(np.float32),
            rng.uniform(-1.0, 0.05, n - FLOAT_EQ[i] - FLOAT_GT[i])
            .astype(np.float32)])
        rng.shuffle(rf)
        out = os.path.join(root, f"f_{i}")
        SegmentCreator(tc, schema).build(
            {"rf": rf, "k": (np.arange(n) % 5).astype(np.int32)}, out,
            f"f_{i}")
        dirs.append(out)
    return dirs


def build_all_point_one(root: str) -> str:
    """One segment whose FLOAT column holds 0.1f, 0.2f and 1.0f: its
    minimum is 0.1f, above the double 0.1."""
    schema = Schema("p", [FieldSpec("rf", DataType.FLOAT, FieldType.METRIC)])
    tc = TableConfig("p")
    tc.indexing.no_dictionary_columns = ["rf"]
    out = os.path.join(root, "p_0")
    SegmentCreator(tc, schema).build(
        {"rf": np.array([0.1, 0.2, 0.1, 1.0], dtype=np.float32)}, out, "p_0")
    return out


#: the query shapes both packages' servers answer: name -> (table, SQL).
#: The device path serves the first eight; the last three are refused by
#: the port's planner by design and answered by its host executor.
SHAPES = {
    "q1": ("srv", "SELECT SUM(m_int * d_int), COUNT(*) FROM srv WHERE "
           "d_date BETWEEN 19940101 AND 19940131 AND d_int BETWEEN 2 AND 4 "
           "AND flag < 1"),
    "groupby": ("srv", "SELECT d_str, SUM(m_int), COUNT(*), AVG(m_double) "
                "FROM srv WHERE d_int < 12 GROUP BY d_str ORDER BY d_str "
                "LIMIT 100"),
    "sketches": ("srv", "SELECT DISTINCTCOUNTHLL(d_int), "
                 "PERCENTILETDIGEST95(m_double) FROM srv WHERE m_int > 10"),
    "moments": ("srv", "SELECT VARIANCE(m_double), STDDEV_SAMP(m_double), "
                "SKEWNESS(m_double), KURTOSIS(m_double), BOOL_AND(flag), "
                "BOOL_OR(flag) FROM srv WHERE d_int > 3"),
    "selection": ("srv", "SELECT d_int, m_int, d_str FROM srv "
                  "WHERE m_int > 100 ORDER BY m_double DESC LIMIT 10"),
    "distinct": ("srv", "SELECT DISTINCT d_str, d_int FROM srv "
                 "WHERE d_int < 6 ORDER BY d_str, d_int LIMIT 100"),
    "startree": ("st", "SELECT d_str, SUM(m_int), COUNT(*) FROM st "
                 "WHERE d_int BETWEEN 3 AND 9 GROUP BY d_str ORDER BY d_str"),
    "upsert": ("ups", "SELECT COUNT(*), SUM(m_int) FROM ups "
               "WHERE d_int < 10"),
    "grouped_sketches": ("srv", "SELECT d_str, DISTINCTCOUNTHLL(d_int), "
                         "PERCENTILETDIGEST50(m_double) FROM srv "
                         "GROUP BY d_str ORDER BY d_str"),
    "two_order_keys": ("srv", "SELECT d_int, m_double FROM srv "
                       "WHERE d_int < 3 ORDER BY d_int, m_double LIMIT 20"),
    "raw_group_by": ("srv", "SELECT r_small, COUNT(*), SUM(d_int) FROM srv "
                     "GROUP BY r_small ORDER BY r_small"),
}
#: each refused shape's fixed `host_fallback{reason}` label
REFUSED = {"grouped_sketches": "groupedSketch", "two_order_keys": "orderBy",
           "raw_group_by": "rawGroupBy"}
#: the FLOAT-literal repair's queries on `srv`, held to the host oracle
FLOAT_SHAPES = {
    "float_gt": "SELECT COUNT(*), SUM(m_int) FROM srv WHERE m_float > 0.1",
    "float_eq": "SELECT COUNT(*) FROM srv WHERE m_float = 0.1",
    "float_in": "SELECT COUNT(*), SUM(m_int) FROM srv "
                "WHERE m_float IN (0.1, 0.2)",
    "float_not_in": "SELECT COUNT(*), SUM(m_int) FROM srv "
                    "WHERE m_float NOT IN (0.1, 0.2)",
}
#: the SQL the reference's host executor answers as the port answers a
#: FLOAT_SHAPES query: it reads `=` in float32 but an IN list in double
#: (so `m_float IN (0.1, 0.2)` matches no 0.1f doc there, ROADMAP §C)
FLOAT_ORACLE = {
    "float_in": "SELECT COUNT(*), SUM(m_int) FROM srv "
                "WHERE m_float = 0.1 OR m_float = 0.2",
    "float_not_in": "SELECT COUNT(*), SUM(m_int) FROM srv "
                    "WHERE NOT (m_float = 0.1 OR m_float = 0.2)",
}


def float_oracle_sql(shape: str) -> str:
    return FLOAT_ORACLE.get(shape, FLOAT_SHAPES[shape])
