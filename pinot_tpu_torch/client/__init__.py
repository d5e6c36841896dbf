"""The broker's HTTP client (counterpart of pinot_tpu/client)."""
from pinot_tpu_torch.client.connection import (Connection, Cursor,
                                               PinotClientError,
                                               PinotOverloadError,
                                               PinotTimeoutError, ResultSet,
                                               connect)

__all__ = ["Connection", "Cursor", "PinotClientError", "PinotOverloadError",
           "PinotTimeoutError", "ResultSet", "connect"]
