"""Index-type keys of the packed segment file that the port reads or writes.

Counterpart of pinot_tpu/segment/index_types.py (ref pinot-segment-spi
index/StandardIndexes.java); the other index families keep their keys in
the JAX package and the port skips them.
"""
DICTIONARY = "dictionary"
FORWARD = "forward_index"
STARTREE = "startree_index"
STARTREE_DATA = "startree_data"
CLP = "clp_forward"  # y-scope CLP log-compressed forward index
VECTOR = "vector_index"  # dense vector block + IVF cells
