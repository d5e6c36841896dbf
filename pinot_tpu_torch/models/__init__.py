"""Logical data model: field specs, schemas, table configs.

Counterpart of pinot_tpu/models (ref pinot-spi FieldSpec.java, Schema.java,
config/table/TableConfig.java), copied so the port imports nothing of the
JAX package.
"""
from pinot_tpu_torch.models.field_spec import DataType, FieldSpec, FieldType
from pinot_tpu_torch.models.schema import Schema
from pinot_tpu_torch.models.table_config import (
    IndexingConfig, RetentionConfig, StarTreeIndexConfig, TableConfig,
    TableType, base_table_name, split_physical_table_name)

__all__ = [
    "DataType", "FieldType", "FieldSpec", "Schema", "TableConfig",
    "TableType", "IndexingConfig", "RetentionConfig", "StarTreeIndexConfig",
    "base_table_name", "split_physical_table_name",
]
