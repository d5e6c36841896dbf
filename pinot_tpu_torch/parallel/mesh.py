"""The (segments, docs) device mesh of the port, and block sharding.

Counterpart of pinot_tpu/parallel/mesh.py (`make_mesh` :22,
`segment_sharding` :35, `block_sharding` :40). A query mesh has two axes:

  `segments`: the stacked segments split over devices (the reference's
              per-segment fan-out);
  `docs`:     a segment's doc range split over devices; partial
              aggregates then combine per slot (ops/kernels.py
              `DOC_COMBINE`).

The JAX mesh is an array of devices that one program spans under
`shard_map`. Here one process owns the mesh: a 2-D array of
`torch.device`s, row-major over (segments, docs), whose engine stages each
slot's shard on that slot's device, launches K1-K3 there and folds the
partials on the lead device (K9 `mesh_fold`). A device may fill more than
one slot: a logical mesh, the port's counterpart of the JAX tests'
`--xla_force_host_platform_device_count=8`. It runs the whole sharded
path, with a launch per slot and a real fold, on one card or on "cpu".

`default_devices` is the device set an engine takes when given none
(every CUDA device, as JAX's `jax.devices()` default); `segments_mesh`
turns a device list into the implicit segments-only mesh the engine builds
from it (none for one device). A logical mesh repeats a device, so
per-chip accounting walks `distinct_devices` and names each chip by
`device_label` (`cuda:1`, `cpu:0`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

AXIS_NAMES = ("segments", "docs")


class Mesh:
    """A (segments, docs) array of devices. `devices[i][j]` holds the
    shard of segment slice i and doc slice j; `flat` lists the slots in
    mesh order (row-major), the order shards and partials keep."""

    axis_names = AXIS_NAMES

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        rows = [list(r) for r in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangle of devices")
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(torch.device(d) for d in r) for r in rows)
        self.shape: Tuple[int, int] = (len(rows), len(rows[0]))
        self.flat: Tuple[torch.device, ...] = tuple(
            d for r in self.devices for d in r)
        self.key = (self.shape, tuple(str(d) for d in self.flat))

    @property
    def size(self) -> int:
        return len(self.flat)

    @property
    def lead(self) -> torch.device:
        """The device that holds the assembled blocks and folds the
        partials (the JAX engine's anchor, `engine.py:2548-2552`)."""
        return self.flat[0]

    def slot(self, p: int) -> Tuple[int, int]:
        """(segment slice, doc slice) of slot p."""
        return divmod(p, self.shape[1])

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other.key == self.key

    def __hash__(self) -> int:
        return hash(self.key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape[0]}x{self.shape[1]}, {list(self.key[1])})"


def default_devices() -> List[torch.device]:
    """Every CUDA device of the host, in index order (the counterpart of
    JAX's `jax.devices()` default); RuntimeError where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the cards; "
                           "pass device='cpu' (or devices=['cpu'] * n for "
                           "a CPU mesh) for the plain PyTorch kernels")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def segments_mesh(devices: Sequence) -> Optional[Mesh]:
    """The implicit mesh of a device list (JAX engine :98-105): None for
    one device, else a segments-only mesh (doc axis 1) over them."""
    devices = list(devices)
    if not devices:
        raise ValueError("no devices")
    return make_mesh(devices, doc_axis=1) if len(devices) > 1 else None


def device_label(device) -> str:
    """`type:index` of a device, the chip's name in the per-chip
    residency shares and the `device=` gauges; "cuda" names card 0."""
    d = torch.device(device)
    return f"{d.type}:{d.index or 0}"


def distinct_devices(mesh: Mesh) -> List[torch.device]:
    """The mesh's devices, each once, in slot order: the chips of a
    logical mesh, which fills several slots from one device."""
    return list(dict.fromkeys(mesh.flat))


def make_mesh(devices: Optional[Sequence] = None, doc_axis: int = 1) -> Mesh:
    """Mesh over (segments, docs): doc_axis devices per segment slice, the
    rest on the segment axis. devices=None means every CUDA device, and
    raises RuntimeError where there is none; a list may repeat a device
    (a logical mesh), but may not mix CPU and CUDA devices."""
    if devices is None:
        devices = default_devices()
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if doc_axis < 1 or n == 0 or n % doc_axis != 0:
        raise ValueError(f"doc_axis {doc_axis} must divide device count {n}")
    types = {d.type for d in devs}
    if len(types) > 1:
        raise ValueError(f"a mesh mixes device types {sorted(types)}: "
                         "every slot is a CPU or every slot a CUDA device")
    kind = types.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernels for device type {kind}")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a CUDA mesh")
        devs = [torch.device("cuda", 0 if d.index is None else d.index)
                for d in devs]
    return Mesh([devs[r * doc_axis:(r + 1) * doc_axis]
                 for r in range(n // doc_axis)])


class ShardedBlock:
    """An [S, D] block cut into a mesh's [S / segments, D / docs] shards:
    `shards[p]` is slot p's, a contiguous tensor on that slot's device.
    `shape` and `dtype` are the whole block's; `numel` and `element_size`
    give its bytes, as a tensor's do, for the engine's block budget."""

    __slots__ = ("shards", "shape", "dtype", "mesh")

    def __init__(self, shards: List[torch.Tensor], shape, dtype, mesh: Mesh):
        self.shards = shards
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.mesh = mesh

    def numel(self) -> int:
        return sum(t.numel() for t in self.shards)

    def element_size(self) -> int:
        return self.shards[0].element_size()


def local_shape(mesh: Mesh, S: int, D: int) -> Tuple[int, int]:
    """(S_loc, D_loc) of an [S, D] block on `mesh`; raises unless both
    axes tile evenly."""
    n_seg, n_doc = mesh.shape
    if S % n_seg or D % n_doc:
        raise ValueError(f"block [{S}, {D}] does not tile a "
                         f"{n_seg}x{n_doc} mesh")
    return S // n_seg, D // n_doc


def shard_block(mesh: Mesh, block: torch.Tensor) -> ShardedBlock:
    """The block's [S_loc, D_loc] shards, one per slot, each contiguous on
    its slot's device (in place of `block_sharding`). With one doc slice a
    shard on the block's own device is a view of its rows."""
    S, D = block.shape
    s_loc, d_loc = local_shape(mesh, S, D)
    shards = []
    for p, dev in enumerate(mesh.flat):
        i, j = mesh.slot(p)
        t = block[i * s_loc:(i + 1) * s_loc, j * d_loc:(j + 1) * d_loc]
        shards.append(t.contiguous().to(dev, non_blocking=True))
    return ShardedBlock(shards, (S, D), block.dtype, mesh)


def shard_segments(mesh: Mesh, arr: torch.Tensor) -> List[torch.Tensor]:
    """Per slot, the rows of an [S, ...] array (a leaf parameter, a doc
    count) of its segment slice, on the slot's device (in place of
    `segment_sharding`): a view where the slot's device holds `arr`. An
    array on the host stays there: on a card it is a kernel's host-side
    bound (K8's 'vq:nc')."""
    n_seg = mesh.shape[0]
    if arr.shape[0] % n_seg:
        raise ValueError(f"{arr.shape[0]} segments do not tile "
                         f"{n_seg} segment slices")
    s_loc = arr.shape[0] // n_seg
    out = []
    for p, dev in enumerate(mesh.flat):
        i = mesh.slot(p)[0]
        part = arr[i * s_loc:(i + 1) * s_loc]
        out.append(part if arr.device.type == "cpu"
                   else part.to(dev, non_blocking=True))
    return out
