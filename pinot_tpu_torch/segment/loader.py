"""Immutable segment loading + per-column DataSource.

Counterpart of pinot_tpu/segment/loader.py (ref pinot-segment-local
ImmutableSegmentLoader.java:57 and pinot-segment-spi DataSource.java:41),
trimmed to what the scan-aggregate, selection, star-tree and vector paths
read: metadata, the dictionary, dictIds and materialized values of
single-value columns, CLP log columns (`clp_reader`), vector indexes
(`vector_index`), and the star-trees. Index families the port does not
read (inverted, range, sorted, bloom, null vectors, JSON, text, geo, map)
stay on disk untouched.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from pinot_tpu_torch.models.field_spec import DataType
from pinot_tpu_torch.segment import clp, fwd, index_types as it
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.meta import ColumnMetadata, SegmentMetadata
from pinot_tpu_torch.segment.startree import StarTreeReader
from pinot_tpu_torch.segment.store import SegmentDirectory
from pinot_tpu_torch.segment.vector_index import VectorIndex


class DataSource:
    """Per-column access point (ref DataSource.java:41); decodes lazily and
    caches the decoded arrays."""

    def __init__(self, seg: "ImmutableSegment", meta: ColumnMetadata):
        self._seg = seg
        self.metadata = meta
        self._dictionary: Optional[Dictionary] = None
        self._dict_ids: Optional[np.ndarray] = None
        self._values: Optional[np.ndarray] = None
        self._clp: Optional[clp.CLPForwardIndexReader] = None
        self._vector: Optional[VectorIndex] = None

    @property
    def dictionary(self) -> Optional[Dictionary]:
        if self._dictionary is None and self.metadata.has_dictionary:
            buf = self._seg.dir.get_buffer(self.metadata.name, it.DICTIONARY)
            self._dictionary = Dictionary.from_bytes(
                self.metadata.data_type, buf, self.metadata.cardinality)
        return self._dictionary

    def dict_ids(self) -> np.ndarray:
        """Whole-column int32 dictIds (SV dict-encoded columns)."""
        if self._dict_ids is None:
            m = self.metadata
            if not m.has_dictionary:
                raise ValueError(f"column {m.name} is raw-encoded")
            if not m.single_value:
                raise NotImplementedError(
                    f"multi-value column {m.name}: not in this port yet")
            buf = self._seg.dir.get_buffer(m.name, it.FORWARD)
            self._dict_ids = fwd.read_sv_dict(buf, self._seg.num_docs,
                                              m.bits_per_element)
        return self._dict_ids

    @property
    def clp_reader(self) -> Optional[clp.CLPForwardIndexReader]:
        """A CLP log column's reader (ref DataSource CLP getter); None for
        other columns."""
        if self._clp is None and it.CLP in self.metadata.indexes:
            self._clp = clp.CLPForwardIndexReader(clp.unpack_compressed(
                self._seg.dir.get_buffer(self.metadata.name, it.CLP)))
        return self._clp

    @property
    def vector_index(self) -> Optional[VectorIndex]:
        """The column's vector index, read at first use (ref
        DataSource.getVectorIndex; JAX loader.py:152-158); None without."""
        if self._vector is None and it.VECTOR in self.metadata.indexes:
            self._vector = VectorIndex.from_bytes(
                self._seg.dir.get_buffer(self.metadata.name, it.VECTOR))
        return self._vector

    def values(self) -> np.ndarray:
        """Whole-column materialized values (dictionary take, raw decode,
        or a CLP column's whole decode)."""
        if self._values is None:
            m = self.metadata
            if it.CLP in m.indexes:
                self._values = self.clp_reader.decode_all()
            elif m.has_dictionary:
                self._values = self.dictionary.get_values(self.dict_ids())
            elif it.FORWARD not in m.indexes or not m.single_value:
                raise NotImplementedError(
                    f"column {m.name}: encoding not in this port yet")
            else:
                buf = self._seg.dir.get_buffer(m.name, it.FORWARD)
                st = m.data_type.stored_type
                if st.is_fixed_width:
                    self._values = fwd.read_raw_fixed(
                        buf, self._seg.num_docs, m.data_type.np_dtype)
                else:
                    self._values = fwd.read_raw_var(
                        buf, self._seg.num_docs, st is DataType.BYTES)
        return self._values


class ImmutableSegment:
    """Loaded immutable segment (ref IndexSegment/ImmutableSegmentImpl)."""

    def __init__(self, seg_dir: str):
        self.dir = SegmentDirectory(seg_dir)
        self.metadata: SegmentMetadata = self.dir.metadata
        self._sources: Dict[str, DataSource] = {}
        self._star_tree: Optional[StarTreeReader] = None

    @property
    def name(self) -> str:
        return self.metadata.segment_name

    @property
    def num_docs(self) -> int:
        return self.metadata.num_docs

    @property
    def column_names(self) -> List[str]:
        """The segment's columns in metadata order (what '*' selects)."""
        return list(self.metadata.columns.keys())

    def data_source(self, column: str) -> DataSource:
        ds = self._sources.get(column)
        if ds is None:
            cmeta = self.metadata.columns.get(column)
            if cmeta is None:
                raise KeyError(f"column {column!r} not in segment {self.name}")
            ds = DataSource(self, cmeta)
            self._sources[column] = ds
        return ds

    def has_column(self, column: str) -> bool:
        return column in self.metadata.columns

    def destroy(self) -> None:
        """Drop the decoded columns (the server's data manager calls this
        once a replaced or removed segment's last query releases it)."""
        self._sources.clear()

    @property
    def star_tree(self) -> Optional[StarTreeReader]:
        """The segment's star-trees, read at first use; None without."""
        if self._star_tree is None and self.metadata.star_tree:
            self._star_tree = StarTreeReader(self)
        return self._star_tree


def load_segment(seg_dir: str) -> ImmutableSegment:
    """Ref ImmutableSegmentLoader.load(indexDir, readMode) — mmap read mode."""
    return ImmutableSegment(seg_dir)
