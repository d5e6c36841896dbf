"""Star-tree index: pre-aggregated cube with star (*) wildcards.

Counterpart of pinot_tpu/segment/startree.py (ref pinot-segment-local
startree/ OffHeapStarTree.java:38 node array format, v2/builder
{OnHeap,OffHeap}SingleTreeBuilder + MultipleTreesBuilder, StarTreeV2Metadata,
and core/startree StarTreeFilterOperator.java:90 traversal), copied so the
port imports nothing of the JAX package. The builder writes the same bytes
as the JAX builder, so a segment written by either creator loads in either
package with the same tree.

Build: the base table is the full group-by over the split-order dims
(value-sorted dictIds, from the same np.unique as the dictionary creator);
each internal node splits on the next dim, and a star child re-aggregates
with that dim wildcarded (-1). Records are laid out in DFS order so every
node covers a contiguous [start, end) range of the pre-agg table, which the
device leg (ops/startree_device.py) turns into a selection mask.

Storage: nodes as one int32 [N, 6] array in the `startree_index` buffer;
pre-agg columns (dim codes int32, then metric columns float64) packed in
`startree_data`; shapes and pairs in metadata.star_tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.models import Schema, StarTreeIndexConfig, TableConfig
from pinot_tpu_torch.segment import index_types as it
from pinot_tpu_torch.segment.store import index_key

STAR = -1  # wildcard dim value (ref StarTreeNode.ALL)

# node record: dim_id, dim_value, start_doc, end_doc, child_start, num_children
_NODE_FIELDS = 6


class DimFilter:
    """One dim's matching dictId set in compressed form: a dense
    inclusive ``[lo, hi]`` interval (range predicates are never
    materialized into id arrays) or an explicit sorted-unique id array.
    Intersections stay in interval space whenever one side is an
    interval, so arbitrarily wide BETWEEN / comparison predicates cost
    O(1) instead of O(hi-lo) arange + intersect1d."""

    __slots__ = ("lo", "hi", "ids")

    def __init__(self, lo: Optional[int] = None, hi: Optional[int] = None,
                 ids: Optional[np.ndarray] = None):
        self.lo = lo
        self.hi = hi
        self.ids = ids

    @classmethod
    def from_range(cls, lo: int, hi: int) -> "DimFilter":
        return cls(lo=int(lo), hi=int(hi))

    @classmethod
    def from_ids(cls, ids) -> "DimFilter":
        return cls(ids=np.unique(np.asarray(ids, dtype=np.int64)))

    def is_empty(self) -> bool:
        if self.ids is not None:
            return len(self.ids) == 0
        return self.hi < self.lo

    def intersect(self, other: "DimFilter") -> "DimFilter":
        if self.ids is None and other.ids is None:
            return DimFilter(lo=max(self.lo, other.lo),
                             hi=min(self.hi, other.hi))
        if self.ids is None:
            return other.intersect(self)
        if other.ids is None:  # clip the id list to the interval
            ids = self.ids
            return DimFilter(ids=ids[(ids >= other.lo) & (ids <= other.hi)])
        return DimFilter(ids=np.intersect1d(self.ids, other.ids))

    def contains(self, v: int) -> bool:
        if self.ids is None:
            return self.lo <= v <= self.hi
        i = int(np.searchsorted(self.ids, v))
        return i < len(self.ids) and int(self.ids[i]) == v

    def mask(self, codes: np.ndarray) -> np.ndarray:
        """Boolean membership mask over a code array (leaf residual)."""
        if self.ids is None:
            return (codes >= self.lo) & (codes <= self.hi)
        return np.isin(codes, self.ids)


def parse_pair(pair: str) -> Tuple[str, str]:
    """'SUM__revenue' -> ('sum', 'revenue'); 'COUNT__*' -> ('count', '*')."""
    func, col = pair.split("__", 1)
    return func.lower(), col


@dataclass
class StarTreeMeta:
    dims: List[str]
    pairs: List[str]                      # canonical "FUNC__col" strings
    max_leaf_records: int
    num_nodes: int
    num_records: int
    skip_star_dims: List[str]

    def to_dict(self) -> dict:
        return {"dims": self.dims, "pairs": self.pairs,
                "maxLeafRecords": self.max_leaf_records,
                "numNodes": self.num_nodes, "numRecords": self.num_records,
                "skipStarDims": self.skip_star_dims}

    @classmethod
    def from_dict(cls, d: dict) -> "StarTreeMeta":
        return cls(d["dims"], d["pairs"], d["maxLeafRecords"], d["numNodes"],
                   d["numRecords"], d.get("skipStarDims", []))


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

class _TreeBuilder:
    def __init__(self, num_dims: int, max_leaf_records: int,
                 skip_star: Sequence[bool], pairs: List[Tuple[str, str]]):
        self.num_dims = num_dims
        self.max_leaf = max_leaf_records
        self.skip_star = list(skip_star)
        self.pairs = pairs
        self.nodes: List[List[int]] = []
        self.rec_dims: List[List[np.ndarray]] = []   # chunks per emit
        self.rec_metrics: List[Dict[Tuple[str, str], np.ndarray]] = []
        self.num_records = 0

    def build(self, dim_codes, metrics) -> int:
        root = self._new_node(-1, STAR)
        self._build(root, dim_codes, metrics, 0)
        return root

    def _new_node(self, dim_id: int, dim_value: int) -> int:
        self.nodes.append([dim_id, dim_value, 0, 0, -1, 0])
        return len(self.nodes) - 1

    def _emit(self, node: int, dim_codes, metrics) -> None:
        start = self.num_records
        n = len(dim_codes[0]) if dim_codes else 0
        self.rec_dims.append(dim_codes)
        self.rec_metrics.append(metrics)
        self.num_records += n
        self.nodes[node][2] = start
        self.nodes[node][3] = self.num_records

    def _build(self, node: int, dim_codes, metrics, dim_idx: int) -> None:
        n = len(dim_codes[0]) if dim_codes else 0
        if dim_idx >= self.num_dims or n <= self.max_leaf:
            self._emit(node, dim_codes, metrics)
            return
        # order rows by this dim so each child's rows are contiguous
        order = np.argsort(dim_codes[dim_idx], kind="stable")
        dim_codes = [c[order] for c in dim_codes]
        metrics = {p: v[order] for p, v in metrics.items()}

        self.nodes[node][2] = self.num_records
        children: List[Tuple[int, Any, Any]] = []
        vals, starts = np.unique(dim_codes[dim_idx], return_index=True)
        bounds = list(starts) + [n]
        for i, v in enumerate(vals):
            sl = slice(bounds[i], bounds[i + 1])
            children.append((int(v), [c[sl] for c in dim_codes],
                             {p: m[sl] for p, m in metrics.items()}))
        # star child: wildcard this dim, re-aggregate over remaining dims
        if not self.skip_star[dim_idx]:
            star_codes = [c.copy() for c in dim_codes]
            star_codes[dim_idx] = np.full(n, STAR, dtype=np.int32)
            s_codes, s_metrics = _aggregate_pairs(star_codes, metrics,
                                                  self.pairs)
            children.append((STAR, s_codes, s_metrics))

        child_ids = []
        for v, codes, mets in children:
            child = self._new_node(dim_idx, v)
            child_ids.append(child)
        # children must be contiguous in the node array (ref child_start)
        self.nodes[node][4] = child_ids[0]
        self.nodes[node][5] = len(child_ids)
        # child subtrees are built after all siblings exist, so the
        # siblings' node ids stay contiguous
        for child, (v, codes, mets) in zip(child_ids, children):
            self._build(child, codes, mets, dim_idx + 1)
        self.nodes[node][3] = self.num_records

    def records(self):
        if not self.rec_dims:
            return ([np.empty(0, np.int32)] * self.num_dims,
                    {p: np.empty(0) for p in self.pairs})
        dims = [np.concatenate([chunk[i] for chunk in self.rec_dims])
                .astype(np.int32) for i in range(self.num_dims)]
        mets = {p: np.concatenate([m[p] for m in self.rec_metrics])
                for p in self.pairs}
        return dims, mets


def _aggregate_pairs(dim_codes: List[np.ndarray],
                     pair_metrics: Dict[Tuple[str, str], np.ndarray],
                     pairs: List[Tuple[str, str]]):
    if len(dim_codes[0]) == 0:
        return [c[:0] for c in dim_codes], {p: np.empty(0) for p in pairs}
    stacked = np.stack(dim_codes, axis=1)
    uniq, inverse = np.unique(stacked, axis=0, return_inverse=True)
    n_groups = len(uniq)
    out_dims = [uniq[:, i].astype(np.int32) for i in range(len(dim_codes))]
    out: Dict[Tuple[str, str], np.ndarray] = {}
    for func, col in pairs:
        vals = pair_metrics[(func, col)]
        if func in ("count", "sum"):
            o = np.bincount(inverse, weights=vals, minlength=n_groups)
        elif func == "min":
            o = np.full(n_groups, np.inf)
            np.minimum.at(o, inverse, vals)
        else:
            o = np.full(n_groups, -np.inf)
            np.maximum.at(o, inverse, vals)
        out[(func, col)] = o.astype(np.float64)
    return out_dims, out


def build_star_trees(table_config: TableConfig, schema: Schema,
                     columns: Dict[str, Any], metadata, buffers: Dict[str, bytes]
                     ) -> None:
    """Creator hook (ref SegmentIndexCreationDriverImpl.java:396)."""
    trees = []
    for ti, cfg in enumerate(table_config.indexing.star_tree_configs):
        tree_meta = _build_one(ti, cfg, columns, metadata, buffers)
        trees.append(tree_meta.to_dict())
    if trees:
        metadata.star_tree = {"trees": trees}


def _build_one(ti: int, cfg: StarTreeIndexConfig, columns, metadata,
               buffers) -> StarTreeMeta:
    dims = cfg.dimensions_split_order
    pairs = [parse_pair(p) for p in cfg.function_column_pairs]
    if ("count", "*") not in pairs:
        pairs.append(("count", "*"))  # always materialized (ref default)
    for func, col in pairs:
        if func not in ("sum", "count", "min", "max"):
            raise ValueError(f"star-tree pair {func}__{col} not supported")

    num_docs = metadata.num_docs
    # dictIds: value-sorted, reproduced with the same np.unique the
    # dictionary creator uses
    dim_codes = []
    for d in dims:
        vals = np.asarray(columns[d])
        uniq, inverse = np.unique(vals, return_inverse=True)
        dim_codes.append(inverse.astype(np.int32))
    pair_metrics: Dict[Tuple[str, str], np.ndarray] = {}
    for func, col in pairs:
        if col == "*":
            pair_metrics[(func, col)] = np.ones(num_docs, dtype=np.float64)
        else:
            pair_metrics[(func, col)] = np.asarray(
                columns[col], dtype=np.float64)

    base_dims, base_metrics = _aggregate_pairs(dim_codes, pair_metrics, pairs)
    skip = [d in cfg.skip_star_node_creation for d in dims]
    builder = _TreeBuilder(len(dims), cfg.max_leaf_records, skip, pairs)
    builder.build(base_dims, base_metrics)
    rec_dims, rec_metrics = builder.records()

    nodes = np.asarray(builder.nodes, dtype=np.int32).reshape(-1, _NODE_FIELDS)
    buffers[index_key(f"__startree_{ti}", it.STARTREE)] = nodes.tobytes()
    blob = bytearray()
    for arr in rec_dims:
        blob += arr.astype(np.int32).tobytes()
    for func, col in pairs:
        blob += rec_metrics[(func, col)].astype(np.float64).tobytes()
    buffers[index_key(f"__startree_{ti}", it.STARTREE_DATA)] = bytes(blob)
    return StarTreeMeta(
        dims=list(dims), pairs=[f"{f.upper()}__{c}" for f, c in pairs],
        max_leaf_records=cfg.max_leaf_records, num_nodes=len(nodes),
        num_records=builder.num_records,
        skip_star_dims=list(cfg.skip_star_node_creation))


# ---------------------------------------------------------------------------
# Read + traverse
# ---------------------------------------------------------------------------

class StarTreeV2:
    def __init__(self, seg, ti: int, meta: StarTreeMeta):
        self.seg = seg
        self.meta = meta
        nodes_buf = seg.dir.get_buffer(f"__startree_{ti}", it.STARTREE)
        self.nodes = np.frombuffer(bytes(nodes_buf), dtype=np.int32) \
            .reshape(-1, _NODE_FIELDS)
        data = bytes(seg.dir.get_buffer(f"__startree_{ti}", it.STARTREE_DATA))
        n = meta.num_records
        off = 0
        self.dim_codes: Dict[str, np.ndarray] = {}
        for d in meta.dims:
            self.dim_codes[d] = np.frombuffer(data, np.int32, n, off)
            off += 4 * n
        self.metrics: Dict[Tuple[str, str], np.ndarray] = {}
        for p in meta.pairs:
            func, col = parse_pair(p)
            self.metrics[(func, col)] = np.frombuffer(data, np.float64, n, off)
            off += 8 * n
        self._pair_bounds: Dict[Tuple[str, str], Tuple[float, float, bool]] = {}

    def pair_bounds(self, pair: Tuple[str, str]) -> Tuple[float, float, bool]:
        """(min, max, integral) over one pre-agg metric column, cached —
        the device staging admission data (ops/startree_device.py picks
        an exact int-plane slot vs a float32 slot from these)."""
        cached = self._pair_bounds.get(pair)
        if cached is None:
            v = self.metrics[pair]
            if len(v) == 0:
                cached = (0.0, 0.0, True)
            else:
                cached = (float(v.min()), float(v.max()),
                          bool(np.all(v == np.floor(v))))
            self._pair_bounds[pair] = cached
        return cached

    def traverse(self, dim_id_sets: Dict[str, Optional["DimFilter"]],
                 group_dims: set) -> np.ndarray:
        """Record mask for the query (ref StarTreeFilterOperator.java:90).

        dim_id_sets: dim -> matching DimFilter (None = no predicate;
        plain dictId arrays are accepted and wrapped).
        group_dims: dims that must keep real values (no star substitution).
        Returns selected record indices into the pre-agg table.
        """
        filters = {d: f if (f is None or isinstance(f, DimFilter))
                   else DimFilter.from_ids(f)
                   for d, f in dim_id_sets.items()}
        selected: List[np.ndarray] = []

        def visit(node: int):
            dim_id, dim_value, start, end, child_start, n_children = \
                self.nodes[node]
            if n_children == 0:
                # leaf: records keep real values for dims never split on
                # this path, so re-applying every predicate is both
                # necessary (residual dims) and harmless (consumed dims
                # already satisfy it); star-substituted dims are never
                # predicated because predicated dims never take the star
                # child below
                idx = np.arange(start, end)
                keep = np.ones(len(idx), dtype=bool)
                for d, f in filters.items():
                    if f is not None:
                        keep &= f.mask(self.dim_codes[d][idx])
                selected.append(idx[keep])
                return
            child_dim = self.nodes[child_start][0]
            dname = self.meta.dims[child_dim]
            f = filters.get(dname)
            children = range(child_start, child_start + n_children)
            if f is None and dname not in group_dims:
                # no predicate, not grouped: take the star child if present
                for c in children:
                    if self.nodes[c][1] == STAR:
                        visit(c)
                        return
                for c in children:  # star skipped: take all real children
                    visit(c)
                return
            for c in children:
                v = self.nodes[c][1]
                if v == STAR:
                    continue
                if f is None or f.contains(int(v)):
                    visit(c)
        visit(0)
        if not selected:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(selected)


class StarTreeReader:
    def __init__(self, seg):
        self.seg = seg
        self.trees: List[StarTreeV2] = []
        st = seg.metadata.star_tree or {}
        for ti, tm in enumerate(st.get("trees", [])):
            self.trees.append(StarTreeV2(seg, ti, StarTreeMeta.from_dict(tm)))
