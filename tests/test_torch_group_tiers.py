"""K2's table tiers (csrc/group_agg.cu): the Python mirror `group_tier`
that the wrapper checks the kernel's choice against on every launch, on
the CPU.

The tier follows from the bytes of one on-chip copy of the [G, n_slots]
table alone: per slot a column of G words (4 bytes for a count and a
float32 min / max, else 8) padded to 8 bytes. Up to 4 KB a private copy
per warp, up to 100 KB one per block, else the global table. The phase-3
cases of chip_smoke.py land where csrc/group_agg.cu's header says they
do.
"""
import pytest

from pinot_tpu_torch.ops import _cuda

SUM_MIN_MAX_COUNT = ["sum", "min", "max", "count"]

#: chip_smoke.py's phase-3 K2 cases: (slot ops, G, float64) -> tier
PHASE3 = [
    ("dense G=35", SUM_MIN_MAX_COUNT, 35, False, "warp"),
    ("ts.1 G=1024", ["max", "sum", "count"], 1024, False, "block"),
    ("ts.3 G=64,000", ["max", "sum", "count"], 64_000, False, "global"),
    ("cb.3 G=2^16", SUM_MIN_MAX_COUNT, 1 << 16, False, "global"),
    ("compact G=2^17", ["sum", "count"], 1 << 17, False, "global"),
    ("compact G=2^20", ["sum", "count"], 1 << 20, False, "global"),
    ("dense G=35 float64", SUM_MIN_MAX_COUNT, 35, True, "warp"),
    ("ts.1 G=1024 float64", ["max", "sum", "count"], 1024, True, "block"),
]


@pytest.mark.parametrize("name,ops,G,f64,want", PHASE3,
                         ids=[c[0] for c in PHASE3])
def test_phase3_cases_take_their_tiers(name, ops, G, f64, want):
    assert _cuda.group_tier(ops, G, f64) == want, name


@pytest.mark.parametrize("ops,G,f64,nbytes", [
    (["count"], 1, False, 8),            # 4 bytes padded to 8
    (["count"], 2, False, 8),
    (["count"], 3, False, 16),
    (["min", "max"], 5, False, 24 + 24),
    (["min", "max"], 5, True, 40 + 40),
    (["sum", "sumsq", "count"], 10, False, 80 + 80 + 40),
])
def test_table_bytes_pad_each_slot_column(ops, G, f64, nbytes):
    assert _cuda.group_table_bytes(ops, G, f64) == nbytes


@pytest.mark.parametrize("ops", [SUM_MIN_MAX_COUNT, ["sum", "count"],
                                 ["max"], ["sum4", "min", "count"]])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_tiers_grow_with_G_at_their_byte_thresholds(ops, f64):
    """Walking G up, the tier never steps back, and each step happens
    exactly where the bytes pass a threshold."""
    order = _cuda.GROUP_TIERS
    prev = 0
    G = 1
    while G <= _cuda.MAX_GROUPS:
        tier = _cuda.group_tier(ops, G, f64)
        assert order.index(tier) >= prev, (G, tier)
        prev = order.index(tier)
        tb = _cuda.group_table_bytes(ops, G, f64)
        if tier == "warp":
            assert tb <= _cuda.GROUP_WARP_BYTES
        elif tier == "block":
            assert _cuda.GROUP_WARP_BYTES < tb <= _cuda.GROUP_BLOCK_BYTES
        else:
            assert tb > _cuda.GROUP_BLOCK_BYTES
        G = G * 5 // 4 + 1
