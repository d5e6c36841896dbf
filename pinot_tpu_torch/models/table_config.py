"""Table configuration, trimmed to what segment creation reads.

Counterpart of pinot_tpu/models/table_config.py (ref
pinot-spi/src/main/java/org/apache/pinot/spi/config/table/TableConfig.java:38).
The port's creator writes dictionaries, forward indexes and star-trees, so
only the indexing fields that decide those (no-dictionary columns, raw-chunk
compression, star-tree configs, CLP log columns, vector index columns) and
the time column survive here. Upsert
state is not table configuration here: a
`segment/upsert.PartitionUpsertMetadataManager` (FULL mode) attaches
`valid_doc_ids` to the segments it registers, so the JAX package's upsert /
star-tree exclusion (`TableConfig.validate`) has nothing to check; the
engine keeps a segment with cleared bits off its star-tree.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class TableType(enum.Enum):
    OFFLINE = "OFFLINE"
    REALTIME = "REALTIME"


def split_physical_table_name(table: str):
    """(logical name, 'OFFLINE' | 'REALTIME' | None) of a possibly
    type-suffixed table name."""
    for suffix in ("_OFFLINE", "_REALTIME"):
        if table.endswith(suffix):
            return table[: -len(suffix)], suffix[1:]
    return table, None


def base_table_name(table: str) -> str:
    """The logical name, any _OFFLINE / _REALTIME suffix stripped."""
    return split_physical_table_name(table)[0]


@dataclass
class StarTreeIndexConfig:
    """Ref: spi/config/table/StarTreeIndexConfig.java."""

    dimensions_split_order: List[str] = field(default_factory=list)
    skip_star_node_creation: List[str] = field(default_factory=list)
    function_column_pairs: List[str] = field(default_factory=list)  # e.g. "SUM__revenue"
    max_leaf_records: int = 10_000

    def to_dict(self) -> dict:
        return {
            "dimensionsSplitOrder": self.dimensions_split_order,
            "skipStarNodeCreationForDimensions": self.skip_star_node_creation,
            "functionColumnPairs": self.function_column_pairs,
            "maxLeafRecords": self.max_leaf_records,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StarTreeIndexConfig":
        return cls(
            dimensions_split_order=d.get("dimensionsSplitOrder", []),
            skip_star_node_creation=d.get("skipStarNodeCreationForDimensions", []),
            function_column_pairs=d.get("functionColumnPairs", []),
            max_leaf_records=d.get("maxLeafRecords", 10_000),
        )


@dataclass
class IndexingConfig:
    """Ref: spi/config/table/IndexingConfig.java (trimmed)."""

    no_dictionary_columns: List[str] = field(default_factory=list)
    star_tree_configs: List[StarTreeIndexConfig] = field(default_factory=list)
    #: STRING columns stored as CLP logtypes plus variables (segment/clp.py)
    clp_columns: List[str] = field(default_factory=list)
    #: STRING columns of JSON float arrays that carry a vector index
    #: (segment/vector_index.py): the VECTOR_SIMILARITY filter's columns
    vector_index_columns: List[str] = field(default_factory=list)
    # Chunk compression for raw (no-dictionary) columns.
    compression: str = "LZ4"  # PASS_THROUGH | LZ4 | GZIP | ZSTANDARD


@dataclass
class RetentionConfig:
    """Ref: SegmentsValidationAndRetentionConfig (time column only)."""

    time_column: Optional[str] = None


@dataclass
class TableConfig:
    """Ref: spi/config/table/TableConfig.java:38 (trimmed)."""

    name: str  # raw table name, without type suffix
    table_type: TableType = TableType.OFFLINE
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    retention: RetentionConfig = field(default_factory=RetentionConfig)

    def __post_init__(self):
        if isinstance(self.table_type, str):
            self.table_type = TableType(self.table_type)

    @property
    def table_name_with_type(self) -> str:
        return f"{self.name}_{self.table_type.value}"
