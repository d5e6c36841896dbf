"""Segment creation: columnar arrays -> immutable packed segment.

Counterpart of pinot_tpu/segment/creator.py (ref pinot-segment-local
SegmentIndexCreationDriverImpl.java:93,231), trimmed: single-value columns
without nulls, written as a sorted dictionary plus a fixed-bit forward index,
or as a raw chunked forward index for no-dictionary columns, CLP log
columns as their logtype / variable split (segment/clp.py), the vector
index of a vector column (segment/vector_index.py), plus the table's
star-trees (segment/startree.py). The on-disk layout is the JAX package's,
so its loader reads these segments; other auxiliary indexes (inverted,
range, sorted, bloom, ...) are not written.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Sequence, Union

import numpy as np

from pinot_tpu_torch.models import DataType, FieldSpec, Schema, TableConfig
from pinot_tpu_torch.segment import bitpack, clp, fwd, index_types as it
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.meta import ColumnMetadata, SegmentMetadata
from pinot_tpu_torch.segment.startree import build_star_trees
from pinot_tpu_torch.segment.store import index_key, write_segment
from pinot_tpu_torch.segment.vector_index import VectorIndex, json_rows

ColumnData = Union[np.ndarray, Sequence]


class SegmentCreator:
    def __init__(self, table_config: TableConfig, schema: Schema):
        self.table_config = table_config
        self.schema = schema

    def build(self, columns: Dict[str, ColumnData], out_dir: str,
              segment_name: str) -> str:
        """columns: name -> flat array or list of single values (no None);
        a CLP column's messages may also come as their `clp.ClpParts`, and
        a vector column's JSON-array strings as their [n, d] float32 block
        (rendered by `vector_index.json_rows` for the forward index).
        Returns out_dir."""
        num_docs = _num_docs(columns, self.schema)
        buffers: Dict[str, bytes] = {}
        col_meta: Dict[str, ColumnMetadata] = {}
        for spec in self.schema.fields:
            if spec.virtual:
                continue
            if not spec.single_value:
                raise NotImplementedError(
                    f"multi-value column {spec.name}: not in this port yet")
            data = columns.get(spec.name)
            if data is None or len(data) != num_docs:
                raise ValueError(
                    f"column {spec.name!r} needs {num_docs} values")
            col_meta[spec.name] = self._build_sv(spec, data, num_docs,
                                                 buffers)
        time_col = self.table_config.retention.time_column
        start_t = end_t = None
        if time_col and time_col in col_meta:
            start_t = col_meta[time_col].min_value
            end_t = col_meta[time_col].max_value
        metadata = SegmentMetadata(
            segment_name=segment_name,
            table_name=self.table_config.table_name_with_type,
            num_docs=num_docs, columns=col_meta, time_column=time_col,
            start_time=start_t, end_time=end_t,
            creation_time_ms=int(time.time() * 1000))
        # star-trees are built before packing (ref
        # SegmentIndexCreationDriverImpl.java:396 buildStarTreeV2IfNecessary)
        if self.table_config.indexing.star_tree_configs:
            build_star_trees(self.table_config, self.schema, columns,
                             metadata, buffers)
        write_segment(out_dir, metadata, buffers)
        return out_dir

    def _build_sv(self, spec: FieldSpec, data: ColumnData, num_docs: int,
                  buffers: Dict[str, bytes]) -> ColumnMetadata:
        name = spec.name
        meta = ColumnMetadata(name=name, data_type=spec.data_type,
                              field_type=spec.field_type, single_value=True,
                              total_entries=num_docs)
        idx_cfg = self.table_config.indexing
        if name in idx_cfg.clp_columns:
            # CLP log columns: template / variable split instead of a
            # forward index (JAX creator.py:99-112, ref
            # CLPForwardIndexCreatorV2)
            if spec.data_type.stored_type is not DataType.STRING:
                raise ValueError(f"CLP column {name!r} must be STRING-typed")
            if isinstance(data, clp.ClpParts):
                parts = data
                meta.cardinality = clp.parts_cardinality(parts)
            else:
                values = _as_array(spec, data)
                parts = clp.encode(values)
                meta.cardinality = len(set(values.tolist()))
            meta.has_dictionary = False
            buffers[index_key(name, it.CLP)] = clp.pack_compressed(
                clp.write_clp_parts(parts), idx_cfg.compression)
            meta.indexes.append(it.CLP)
            return meta
        vector = None
        if name in idx_cfg.vector_index_columns:
            # the dense [n, d] block of a vector column's JSON arrays (JAX
            # creator.py:186-195, ref HnswVectorIndexCreator), indexed
            # before the strings render, so the build's k-means and the
            # rendered text are never in memory together
            if spec.data_type.stored_type is not DataType.STRING:
                raise ValueError(f"vector column {name!r} must be "
                                 "STRING-typed (JSON arrays)")
            if isinstance(data, np.ndarray) and data.ndim == 2:
                block = np.asarray(data, dtype=np.float32)
                vector = VectorIndex.build(block).to_bytes()
                data = json_rows(block)
                del block
            else:
                vector = VectorIndex.build(np.asarray(
                    [json.loads(v) if isinstance(v, (str, bytes)) else v
                     for v in data], np.float32)).to_bytes()
        meta = self._write_column(spec, meta, _as_array(spec, data),
                                  num_docs, buffers)
        if vector is not None:
            buffers[index_key(name, it.VECTOR)] = vector
            meta.indexes.append(it.VECTOR)
        return meta

    def _write_column(self, spec: FieldSpec, meta: ColumnMetadata,
                      values: np.ndarray, num_docs: int,
                      buffers: Dict[str, bytes]) -> ColumnMetadata:
        """A dictionary plus a fixed-bit forward index, or a raw chunked
        forward index for a no-dictionary column."""
        name = spec.name
        idx_cfg = self.table_config.indexing
        if name not in idx_cfg.no_dictionary_columns:
            dictionary, dict_ids = Dictionary.build(spec.data_type, values)
            card = dictionary.cardinality
            bits = bitpack.num_bits(card)
            meta.has_dictionary = True
            meta.cardinality = card
            meta.bits_per_element = bits
            meta.min_value = dictionary.min_value
            meta.max_value = dictionary.max_value
            meta.is_sorted = bool(num_docs <= 1
                                  or np.all(dict_ids[1:] >= dict_ids[:-1]))
            buffers[index_key(name, it.DICTIONARY)] = dictionary.to_bytes()
            buffers[index_key(name, it.FORWARD)] = fwd.write_sv_dict(
                dict_ids, bits)
            meta.indexes += [it.DICTIONARY, it.FORWARD]
            return meta
        meta.has_dictionary = False
        st = spec.data_type.stored_type
        if st.is_fixed_width:
            meta.min_value = values.min().item() if num_docs else None
            meta.max_value = values.max().item() if num_docs else None
            buffers[index_key(name, it.FORWARD)] = fwd.write_raw_fixed(
                values, idx_cfg.compression)
        else:
            if num_docs:
                meta.min_value = min(values)
                meta.max_value = max(values)
            buffers[index_key(name, it.FORWARD)] = fwd.write_raw_var(
                list(values), idx_cfg.compression, st is DataType.BYTES)
        meta.indexes.append(it.FORWARD)
        return meta


def _num_docs(columns: Dict[str, ColumnData], schema: Schema) -> int:
    for name in schema.column_names:
        if name in columns and columns[name] is not None:
            return len(columns[name])
    raise ValueError("no columns provided")


def _as_array(spec: FieldSpec, data: ColumnData) -> np.ndarray:
    npdt = spec.data_type.np_dtype
    if isinstance(data, np.ndarray) and data.dtype != np.dtype(object):
        arr = np.ascontiguousarray(data, dtype=npdt)
        if arr.dtype.kind == "f" and np.isnan(arr).any():
            raise NotImplementedError(
                f"column {spec.name}: null handling is not in this port yet")
        return arr
    if any(v is None for v in data):
        raise NotImplementedError(
            f"column {spec.name}: null handling is not in this port yet")
    if npdt == np.dtype(object):
        out = np.empty(len(data), dtype=object)
        out[:] = [spec.data_type.convert(v) for v in data]
        return out
    return np.array([spec.data_type.convert(v) for v in data], dtype=npdt)

