"""The port stands alone: importing it, running a query, answering one
through its server over TCP and through a cluster's broker over HTTP loads
neither JAX nor any pinot_tpu module,
its entry points default to the card and refuse to run without one, and
chip_smoke.py imports nothing of either and fails where there is no card
or no port beside it."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import sys, tempfile
import numpy as np
from pinot_tpu_torch.models import DataType, FieldSpec, Schema, TableConfig
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.query.executor import QueryExecutor
import pinot_tpu_torch.ops._cuda, pinot_tpu_torch.ops.program
import pinot_tpu_torch.ops.dispatch
from pinot_tpu_torch.utils import accounting, config, failpoints, metrics
d = tempfile.mkdtemp()
SegmentCreator(TableConfig("t"), Schema("t", [FieldSpec("a", DataType.INT)])
               ).build({"a": np.arange(100, dtype=np.int32) % 7}, d, "s")
ex = QueryExecutor([load_segment(d)], device="cpu")
rows = ex.execute(
    "SELECT a, COUNT(*) FROM t WHERE a > 2 GROUP BY a ORDER BY a").rows
assert [r[0] for r in rows] == [3, 4, 5, 6], rows
assert ex.execute("SELECT DISTINCTCOUNTHLL(a) FROM t").rows == [(7,)]
assert ex.execute("SELECT PERCENTILETDIGEST50(a) FROM t").rows
from pinot_tpu_torch.models import FieldType, StarTreeIndexConfig
tc = TableConfig("u")
tc.indexing.star_tree_configs = [StarTreeIndexConfig(["a"], [], ["SUM__m"])]
d2 = tempfile.mkdtemp()
SegmentCreator(tc, Schema("u", [
    FieldSpec("a", DataType.INT),
    FieldSpec("m", DataType.INT, FieldType.METRIC)])).build(
        {"a": np.arange(100, dtype=np.int32) % 7,
         "m": np.arange(100, dtype=np.int32)}, d2, "s")
ex = QueryExecutor([load_segment(d2)], device="cpu")
assert ex.execute("SELECT SUM(m) FROM u WHERE a = 3").rows == [(679.0,)]
assert ex.engine.meter("startree_served") == 1
from concurrent.futures import ThreadPoolExecutor
from pinot_tpu_torch.query.context import QueryContext
with ThreadPoolExecutor(4) as pool:
    outs = list(pool.map(lambda k: ex.execute(
        f"SELECT SUM(m) FROM u WHERE a > {k}").rows, range(4)))
assert [o[0][0] for o in outs] == [sum(m for m in range(100) if m % 7 > k)
                                   for k in range(4)], outs
fut = ex.engine.execute_async(ex.segments, QueryContext.from_sql(
    "SELECT COUNT(*) FROM u WHERE a < 3"))
assert int(fut.result(timeout=60)[0].intermediates[0]) == 44
from pinot_tpu_torch.ops import timeseries_device
from pinot_tpu_torch.segment.bitmap import Bitmap
from pinot_tpu_torch.segment.upsert import PartitionUpsertMetadataManager
from pinot_tpu_torch.timeseries.engine import query as ts_query
d3 = tempfile.mkdtemp()
SegmentCreator(TableConfig("m"), Schema("m", [
    FieldSpec("ts", DataType.LONG), FieldSpec("h", DataType.INT),
    FieldSpec("v", DataType.DOUBLE, FieldType.METRIC)])).build(
        {"ts": np.arange(100, dtype=np.int64), "h": np.arange(100) % 2,
         "v": np.ones(100)}, d3, "s")
ex = QueryExecutor([load_segment(d3)], device="cpu")
block = ts_query("fetch(m, v, ts, 0, 100, 10) | groupby(h) | sum(h)", ex)
assert sorted(s.values.tolist() for s in block.series) == [[5.0] * 10] * 2
assert ex.engine.meter("timeseries_leaf_device") == 1
seg = ex.segments[0]
PartitionUpsertMetadataManager(["h"], "ts").add_segment(seg)
assert ex.execute("SELECT COUNT(*) FROM m").rows == [(2,)]
assert ex.execute("SELECT ts FROM m LIMIT 5").rows == [(98,), (99,)]
from pinot_tpu_torch.parallel import make_mesh, distributed_query_step
import torch
mex = QueryExecutor(ex.segments * 3, device="cpu",
                    mesh=make_mesh(["cpu"] * 4, doc_axis=2))
assert mex.execute("SELECT COUNT(*) FROM m").rows == [(6,)]
assert mex.engine.meter("mesh_merge_served") == 1
z = torch.zeros((2, 256), dtype=torch.int32)
tot = distributed_query_step(make_mesh(["cpu"] * 4, doc_axis=2))(4)(
    z, z.double() + 1, z, z[:, 0], z[:, 0], z[:, 0] + 256,
    torch.arange(256)[None])
assert float(tot[1]) == 512.0
from pinot_tpu_torch.cache.warmup import FingerprintLog
from pinot_tpu_torch.cluster.mini import MiniClusterServer
from pinot_tpu_torch.query.reduce import reduce_results
from pinot_tpu_torch.server import datatable
from pinot_tpu_torch.server.query_server import ServerConnection
srv = MiniClusterServer(device="cpu")
srv.start()
try:
    srv.data_manager.table("t").add_segment_from_dir(d)
    sql = "SELECT a, COUNT(*) FROM t WHERE a > 4 GROUP BY a ORDER BY a"
    results, exc, _st, _tr = datatable.deserialize_results_ex(
        ServerConnection("127.0.0.1", srv.transport.port).request("t", sql))
    assert not exc, exc
    rows = reduce_results(QueryContext.from_sql(sql), results).rows
    assert rows == [(5, 14), (6, 14)], rows
finally:
    srv.stop()
from pinot_tpu_torch.client import connect
from pinot_tpu_torch.cluster.mini import MiniCluster
cl = MiniCluster(num_servers=2, device="cpu")
cl.start(with_http=True)
try:
    cl.add_table("t")
    cl.add_segment("t", d, 1)
    rs = connect(cl.http.address).execute(
        "SELECT a, COUNT(*) FROM t WHERE a > 4 GROUP BY a ORDER BY a")
    assert rs.rows == [[5, 14], [6, 14]], rs.rows
    assert rs.stats["numServersResponded"] == 1
finally:
    cl.stop()
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "pinot_tpu")
             or m.startswith(("jax.", "jaxlib.", "pinot_tpu.")))
print("BAD", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_port_imports_no_jax_and_no_pinot_tpu():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_port_sources_import_no_jax_and_no_pinot_tpu():
    """Static form of the check, over every module of the package and
    chip_smoke.py (lazy imports inside functions included)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(ROOT, "pinot_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "pinot_tpu"), (path, n)


def test_dispatch_modules_stand_alone():
    """The dispatch ring, the mesh modules and the utils they read import
    nothing of JAX or pinot_tpu, each in a fresh interpreter."""
    for mod in ("pinot_tpu_torch.ops.dispatch", "pinot_tpu_torch.parallel",
                "pinot_tpu_torch.parallel.mesh",
                "pinot_tpu_torch.parallel.distributed_query",
                "pinot_tpu_torch.ops.collective",
                "pinot_tpu_torch.utils.config",
                "pinot_tpu_torch.utils.failpoints",
                "pinot_tpu_torch.utils.metrics",
                "pinot_tpu_torch.utils.accounting"):
        probe = (f"import sys, {mod}\n"
                 "print('BAD', sorted(m for m in sys.modules if m in "
                 "('jax', 'jaxlib', 'pinot_tpu') or m.startswith(('jax.', "
                 "'jaxlib.', 'pinot_tpu.'))))")
        out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                             env=_env(), capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        assert "BAD []" in out.stdout, (mod, out.stdout)


def test_default_device_is_the_card():
    from pinot_tpu_torch.query.executor import QueryExecutor
    if torch.cuda.is_available():
        assert QueryExecutor([]).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QueryExecutor([])


def test_server_default_device_is_the_card():
    """The server's executor, the embedded server and the cluster default
    to the card too, and never fall back to the CPU by themselves."""
    from pinot_tpu_torch.cluster.mini import MiniClusterServer
    from pinot_tpu_torch.server.data_manager import InstanceDataManager
    from pinot_tpu_torch.server.query_server import ServerQueryExecutor
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServerQueryExecutor(InstanceDataManager())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiniClusterServer()
    from pinot_tpu_torch.cluster.mini import MiniCluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiniCluster()


def test_chip_smoke_fails_without_card_or_port(tmp_path):
    """Where torch sees no card, chip_smoke.py exits non-zero and prints no
    result; alone in a directory it cannot find the port either."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), str(lone))):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
