"""An embedded server over real TCP (counterpart of pinot_tpu/cluster,
trimmed to one server role)."""
