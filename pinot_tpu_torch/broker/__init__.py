"""The broker role (counterpart of pinot_tpu/broker): routing, scatter and
gather over the port's servers, the reduce, and the client HTTP API."""
