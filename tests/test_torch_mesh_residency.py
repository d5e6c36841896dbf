"""Per-chip residency, the `device=` gauges, the `server.mesh.collective`
failpoint, the default device set and a server on a mesh, against the JAX
package.

- `ResidencyManager(devices=4)` takes the same labelled admissions, gets
  and invalidations as JAX's `ResidencyManager` under a tight budget; the
  two agree step by step on what is admitted, evicted and declined, on
  `bytes_by_device`, `max_device_bytes` and `pressure`.
- An engine on a logical mesh (every slot "cpu") is one chip: one label,
  the whole budget, its admissions labelled, and one `device=` gauge of
  each kind.
- Armed, the failpoint keeps a merge-eligible query on the sharded launch
  and the host fold, `mesh_merge_fallback{chaos}`: the merge-off rows
  exactly, the merged rows within rel 1e-9 (a float sum added in another
  order).
- `default_devices` and `segments_mesh` with `torch.cuda` monkeypatched
  to 1 and to 4 cards (no engine is built on a fake card); with no CUDA
  device each entry point raises RuntimeError.
- A port server on a logical 4x1 "cpu" mesh and a JAX server on a 4x1
  mesh of its virtual CPU devices answer a Q1-shaped query, a selection
  and a star-tree query equally over TCP, with `host_fallback` at 0.
"""
import numpy as np
import pytest
import torch

import jax

from pinot_tpu.ops.engine import TpuOperatorExecutor
from pinot_tpu.ops.residency import ResidencyManager as JaxResidency
from pinot_tpu.segment.loader import load_segment as jax_load
from pinot_tpu.server.data_manager import \
    InstanceDataManager as JaxDataManager
from pinot_tpu.server.query_server import QueryServer as JaxQueryServer
from pinot_tpu.server.query_server import \
    ServerConnection as JaxConnection
from pinot_tpu.server.query_server import \
    ServerQueryExecutor as JaxServerExecutor
from pinot_tpu.utils.config import PinotConfiguration as JaxConfig
from pinot_tpu_torch.cluster.mini import MiniClusterServer
from pinot_tpu_torch.ops.engine import TorchOperatorExecutor
from pinot_tpu_torch.ops.residency import ResidencyManager
from pinot_tpu_torch.parallel import (default_devices, device_label,
                                      distinct_devices, make_mesh,
                                      segments_mesh)
from pinot_tpu_torch.query.executor import QueryExecutor
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.server.data_manager import InstanceDataManager
from pinot_tpu_torch.server.query_server import (ServerConnection,
                                                 ServerQueryExecutor)
from pinot_tpu_torch.utils.config import PinotConfiguration
from pinot_tpu_torch.utils.failpoints import FailpointError, failpoints
from pinot_tpu_torch.utils.metrics import get_registry
from tests import torch_tables as tt
from tests.test_torch_server import jax_rows, port_rows


class _Seg:
    def __init__(self, name):
        self.name = name


LABELS = [f"cuda:{i}" for i in range(4)]


def _state(mgr):
    return (list(mgr._entries), mgr.bytes, mgr.bytes_by_device(),
            mgr.max_device_bytes(), mgr.pressure(), mgr.admitted,
            mgr.evicted, mgr.rejected)


@pytest.mark.parametrize("admission", [True, False])
def test_per_chip_shares_match_jax(admission):
    """300 seeded steps of labelled admissions (rows skewed toward chip 0),
    gets that heat some columns, a seeded warm-up stretch and segment
    invalidations, at a budget of ~12 rows a chip."""
    rng = np.random.default_rng(17)
    ours = ResidencyManager(48_000, admission=admission, sample_window=64,
                            devices=LABELS)
    ref = JaxResidency(48_000, admission=admission, sample_window=64,
                       devices=LABELS)
    assert ours.device_budget_bytes == ref.device_budget_bytes == 12_000
    segs = [_Seg(f"s{i}") for i in range(10)]
    for step in range(300):
        seg = segs[int(rng.integers(0, len(segs)))]
        col = f"c{int(rng.integers(0, 6))}"
        op = rng.random()
        if op < 0.35:
            for m in (ours, ref):
                m.get(seg, "ids", col, "<i4")
        elif op < 0.95:
            chip = LABELS[min(int(rng.integers(0, 6)), 3)]
            nb = int(rng.integers(200, 2500))
            seeded = 150 <= step < 170
            got = []
            for m in (ours, ref):
                if seeded:
                    with m.seeding():
                        got.append(m.admit(seg, "ids", col, "<i4", object(),
                                           nb, device=chip))
                else:
                    got.append(m.admit(seg, "ids", col, "<i4", object(), nb,
                                       device=chip))
            assert got[0] == got[1], step
        else:
            assert ours.invalidate_segment(seg.name) == \
                ref.invalidate_segment(seg.name)
        assert _state(ours) == _state(ref), step
    assert ours.evicted and ours.bytes_by_device()
    assert max(ours.bytes_by_device().values()) <= 12_000
    if admission:
        assert ours.rejected
    ours.drop_all()
    ref.drop_all()
    assert _state(ours)[1:5] == _state(ref)[1:5] == (0, {}, 0, 0.0)


def test_unlabelled_and_single_chip_pressure_match_jax():
    """No labels: pooled pressure and max bytes; one chip: its share is the
    whole budget."""
    for devices in (None, ["cuda:0"]):
        ours = ResidencyManager(10_000, devices=devices)
        ref = JaxResidency(10_000, devices=devices)
        assert ours.device_budget_bytes == ref.device_budget_bytes == 10_000
        seg = _Seg("a")
        for i in range(6):
            label = devices[0] if devices else None
            for m in (ours, ref):
                m.admit(seg, "ids", f"c{i}", "<i4", object(), 3000,
                        device=label)
            assert _state(ours) == _state(ref)


# ---------------------------------------------------------------------------
# the engine's chips and gauges
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_residency"))
    return {"srv": tt.build_table(root, "srv"),
            "st": tt.build_table(root, "st", star_tree=True)}


@pytest.mark.parametrize("doc_axis", [1, 2])
def test_logical_mesh_is_one_chip(dirs, doc_axis):
    """Every slot on "cpu": one label, the whole resident budget, every
    admission charged to it, and one `device=` gauge of each kind holding
    the blocks and the resident rows."""
    segs = [load_segment(d) for d in dirs["srv"]]
    labels = {"instance": f"logical_{doc_axis}"}
    eng = TorchOperatorExecutor(
        "cpu", torch.float64, metrics_labels=labels,
        mesh=make_mesh(["cpu"] * 4, doc_axis=doc_axis),
        config=PinotConfiguration({"pinot.server.hbm.resident.bytes":
                                   1 << 24}))
    assert distinct_devices(eng._mesh) == [torch.device("cpu")]
    res = eng.residency
    assert res.devices == ["cpu:0"]
    assert res.device_budget_bytes == res.budget_bytes == 1 << 24
    QueryExecutor(segs, engine=eng).execute(tt.SHAPES["q1"][1])
    assert res.bytes > 0 and res.bytes_by_device() == {"cpu:0": res.bytes}
    assert res.pressure() == res.bytes / res.budget_bytes
    reg = get_registry("server")
    chip = dict(labels, device="cpu:0")
    assert reg.gauge("hbm_resident_bytes", labels=chip) == res.bytes
    assert reg.gauge("hbm_cache_bytes", labels=chip) == \
        reg.gauge("hbm_cache_bytes", labels=labels) == eng._cached + res.bytes
    assert eng._cached > 0


def test_one_device_engine_labels_its_chip(dirs):
    """A one-device engine labels its admissions too (JAX `_put_row`
    labels every row), with the whole budget and no `device=` gauge."""
    segs = [load_segment(d) for d in dirs["srv"]]
    ex = QueryExecutor(segs, device="cpu")
    ex.execute(tt.SHAPES["q1"][1])
    res = ex.engine.residency
    assert res.devices == ["cpu:0"] and res.bytes > 0
    assert res.bytes_by_device() == {"cpu:0": res.bytes}


def test_device_labels():
    assert device_label("cpu") == "cpu:0"
    assert device_label("cuda") == device_label("cuda:0") == "cuda:0"
    assert device_label(torch.device("cuda", 3)) == "cuda:3"
    mesh = make_mesh(["cpu"] * 8, doc_axis=2)
    assert distinct_devices(mesh) == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# the failpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


@pytest.mark.parametrize("doc_axis", [1, 2])
def test_collective_failpoint_keeps_the_host_fold(dirs, _clean_failpoints,
                                                  doc_axis):
    segs = [load_segment(d) for d in dirs["srv"]]
    mesh = make_mesh(["cpu"] * 4, doc_axis=doc_axis)
    off = PinotConfiguration({"pinot.server.mesh.collective.merge": False})
    for shape in ("q1", "groupby"):
        sql = tt.SHAPES[shape][1]
        merged = QueryExecutor(segs, device="cpu", value_dtype=torch.float64,
                               mesh=mesh)
        want = merged.execute(sql).rows
        assert merged.engine.meter("mesh_merge_served") == 1
        fold = QueryExecutor(segs, device="cpu", value_dtype=torch.float64,
                             mesh=mesh, config=off).execute(sql).rows
        chaos = QueryExecutor(segs, device="cpu", value_dtype=torch.float64,
                              mesh=mesh)
        with failpoints.armed("server.mesh.collective",
                              error=FailpointError("chaos")):
            got = chaos.execute(sql).rows
        assert chaos.engine.meter("mesh_merge_fallback", "chaos") == 1
        assert chaos.engine.meter("mesh_merge_served") == 0
        # the host fold's rows exactly; the merged rows, their float sums
        # added in another order, within rel 1e-9
        assert got == fold, shape
        for a, b in zip(got, want):
            assert a[:-1] == b[:-1] if shape == "groupby" else a == b
            assert abs(a[-1] - b[-1]) <= 1e-9 * max(1.0, abs(b[-1]))


# ---------------------------------------------------------------------------
# the default device set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cards", [1, 4])
def test_default_devices_span_every_card(monkeypatch, cards):
    """The function itself on a faked torch.cuda: no engine is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    devs = default_devices()
    assert devs == [torch.device("cuda", i) for i in range(cards)]
    mesh = segments_mesh(devs)
    if cards == 1:
        assert mesh is None
    else:
        assert mesh.shape == (4, 1) and mesh.lead == torch.device("cuda", 0)
        assert distinct_devices(mesh) == devs


def test_no_cuda_device_raises(dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    segs = [load_segment(d) for d in dirs["srv"]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchOperatorExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryExecutor(segs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServerQueryExecutor(InstanceDataManager())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiniClusterServer(devices=["cuda:0"] * 4)


# ---------------------------------------------------------------------------
# a server on a mesh
# ---------------------------------------------------------------------------

#: Q1-shaped, a selection, and a star-tree group-by its tree serves
#: (COUNT__* only: m_int's negative values keep SUM on the scan)
SERVED = {"q1": tt.SHAPES["q1"], "selection": tt.SHAPES["selection"],
          "startree": ("st", "SELECT d_str, COUNT(*) FROM st WHERE d_int "
                             "BETWEEN 3 AND 9 GROUP BY d_str ORDER BY d_str")}


def test_server_on_a_mesh_matches_jax(dirs):
    jdm = JaxDataManager("jax_mesh_server")
    cfg = JaxConfig(overrides={"pinot.server.segment.cache.enabled": False,
                               "pinot.server.admission.enabled": False})
    jexec = JaxServerExecutor(jdm, use_tpu=True, config=cfg)
    jexec._engine = TpuOperatorExecutor(devices=jax.devices()[:4],
                                        config=cfg)
    jserver = JaxQueryServer(jexec)
    port = MiniClusterServer("port_mesh", devices=["cpu"] * 4,
                             value_dtype=torch.float64)
    for table, table_dirs in dirs.items():
        for d in table_dirs:
            jdm.table(table).add_segment(jax_load(d))
            port.data_manager.table(table).add_segment(load_segment(d))
    jserver.start()
    port.start()
    try:
        eng = port.executor.engine
        assert eng._mesh.shape == (4, 1) and not eng._explicit_mesh
        jconn = JaxConnection("127.0.0.1", jserver.port)
        pconn = ServerConnection("127.0.0.1", port.transport.port)
        reg = get_registry("server")
        fb0 = reg.meter_total("host_fallback")
        for name, (table, sql) in SERVED.items():
            got = port_rows(pconn.request(table, sql), sql)
            want = jax_rows(jconn.request(table, sql), sql)
            assert got[0] == want[0], name
            assert len(got[1]) == len(want[1]) > 0, name
            for a, b in zip(got[1], want[1]):
                assert len(a) == len(b)
                for u, v in zip(a, b):
                    if isinstance(v, float):
                        assert abs(float(u) - v) <= 1e-9 * max(1.0, abs(v))
                    else:
                        assert u == v, (name, a, b)
        assert reg.meter_total("host_fallback") == fb0
        assert eng.meter("startree_served") == 1
        assert not any(k[0] == "mesh_refused" for k in eng.meters)
    finally:
        jserver.stop()
        port.stop()
