"""pinot-tpu on PyTorch and CUDA: the port of pinot_tpu's device layer to
an NVIDIA H100.

The package mirrors pinot_tpu's sub-packages (models, segment, query, ops)
and imports nothing of it, nor JAX. It carries scan-aggregate, group-by,
sketch, selection (top-N), DISTINCT, star-tree, time-series, upsert, CLP
log-search and vector queries from SQL text to result rows through nine
hand-written CUDA kernels (ops/csrc), on one card or over a (segments,
docs) mesh of devices (parallel). Entry point:

    from pinot_tpu_torch.query.executor import QueryExecutor
    QueryExecutor(segments).execute(sql)        # on the card
    QueryExecutor(segments, device="cpu")       # plain PyTorch kernels
    QueryExecutor(segments, mesh=make_mesh(["cuda:0"] * 8, doc_axis=2))

and, through servers and a broker over HTTP, cluster/mini.py's
`MiniCluster` with client/connection.py's `connect`.
"""
