"""Build, bind and launch the hand-written CUDA kernels.

K1 `scan_agg` (csrc/scan_agg.cu), K2 `group_agg` (csrc/group_agg.cu),
K3 `sketch_agg` (csrc/sketch_agg.cu), K4 `topn` (csrc/topn.cu), K5
`startree_agg` (csrc/startree_agg.cu), K6 `row_assemble`
(csrc/row_assemble.cu), K7 `clp_match` (csrc/clp_match.cu), K8
`vector_topk` (csrc/vector_topk.cu) and K9 `mesh_fold`
(csrc/mesh_fold.cu) are plain-C-interface shared libraries
built with `nvcc` for sm_90a at first use, into the git-ignored
`build/kernels/` directory beside the package, and loaded with ctypes. All
sources build at once, one `nvcc` each, in parallel. A library's file name
carries a hash of its source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate outputs and scratch with `torch.empty`, launch on the
current stream, raise if the launch failed, and count their launches. They
never fall back to the plain PyTorch version.

K1-K5, K7 and K8 carry a member axis (csrc/interp.cuh,
csrc/startree_agg.cu, csrc/clp_match.cu, csrc/vector_topk.cu): one launch
computes B coalesced queries of one plan over U column sets, member m
reading set idx[m]. `scan_agg`, `group_agg`, `sketch_agg`, `topn`,
`startree_agg`, `clp_match` and `vector_topk` are the single launch
(B = U = 1); the `*_batched` forms take the members' column sets,
parameters, doc counts and member-to-set map and return [B, S, ...].
`mesh_fold` folds a mesh's per-slot partials, each with the query axis
it carries: a strided doc fold, or through host-built lists
(ops/kernels.py `MeshFold`). A
kernel counts single launches in `launches`, batched ones in
`batched_launches` and their members in `batched_members`, under a lock:
pool threads launch concurrently, and ctypes releases the GIL for the call.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import torch

from pinot_tpu_torch.ops import program as prog_mod
from pinot_tpu_torch.ops.plan_ir import DevicePlan, is_grouped

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
#: <repo>/build/kernels — listed in .gitignore
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
THREADS = 256
#: each thread of K2-K4 walks about this many docs of its segment
DOCS_PER_THREAD = 32
#: and each thread of K1 about this many, PT_TILE (16) at a time
#: (csrc/scan_agg.cu), so a block's staging is spread over more docs
SCAN_DOCS_PER_THREAD = 512
MAX_BLOCKS_PER_SEGMENT = 1024
#: K8's score + compact pass over short segments: enough blocks a segment
#: for about this many over the launch's rows (2 per SM of an H100), each
#: over at least VECTOR_MIN_DOCS docs (a 64-doc tile for each of its 8
#: warps: csrc/vector_topk.cu VT_TILE), where DOCS_PER_THREAD gives fewer
VECTOR_BLOCKS = 264
VECTOR_MIN_DOCS = 512
#: K2's largest group count: the int key and its [B, S, G, n_slots] table
#: offsets (csrc/group_agg.cu); the engine caps G at 2^20 (JAX's
#: MAX_DEVICE_GROUPS)
MAX_GROUPS = 1 << 24
#: K2's table tiers (csrc/group_agg.cu K2_*), chosen from the bytes of one
#: on-chip copy of the [G, n_slots] table alone (`group_table_bytes`): a
#: private copy per warp up to GROUP_WARP_BYTES, one per block up to
#: GROUP_BLOCK_BYTES, else the global table
GROUP_TIERS = ("warp", "block", "global")
GROUP_WARP_BYTES = 4096
GROUP_BLOCK_BYTES = 100 * 1024
#: K4 sorts its k candidates in one block's shared memory (csrc/topn.cu)
TOPN_MAX_K = 8192
#: K4's and K8's per-row select state words (csrc/topk_select.cuh TS_*)
TOPN_ROW_WORDS = 7
#: column sets and members of one K1-K4 launch (csrc/interp.cuh
#: PT_MAX_SETS, PT_MAX_MEMBERS)
MAX_SETS = 16
MAX_MEMBERS = 16
#: K4's grid carries B x S rows on its y axis
TOPN_MAX_ROWS = 65535
#: K5's slot and group-dimension capacity (csrc/startree_agg.cu ST_MAX_*)
ST_MAX_SLOTS = 16
ST_MAX_DIMS = 8
#: planes of 7 bits per 24-bit digit of a K5 exact-sum (usum) slot
USUM_PLANES = 4
#: K5's accumulator columns: the record count, 2 * USUM_PLANES per usum
#: slot, one per float slot
ST_MAX_ACC = 1 + 2 * USUM_PLANES * ST_MAX_SLOTS
#: block rows K6 takes per launch (csrc/row_assemble.cu RA_MAX_ROWS)
RA_MAX_ROWS = 1024
#: K7's leaves per launch, slot blocks per column, padded groups and
#: conditions (csrc/clp_match.cu CLP_MAX_*)
CLP_MAX_LEAVES = 4
CLP_MAX_SLOTS = 16
CLP_MAX_GROUPS = 64
CLP_MAX_CONDS = 16


class _Args(ctypes.Structure):
    """csrc/interp.cuh `struct Args`, passed to the kernel by value: per
    column set its column pointers and its upsert validity mask (null: no
    mask), the LUT pointers, the program and the member-to-set map."""
    _fields_ = [("cols", (ctypes.c_void_p * prog_mod.MAX_COLS) * MAX_SETS),
                ("vmask", ctypes.c_void_p * MAX_SETS),
                ("luts", ctypes.c_void_p * prog_mod.MAX_LUTS),
                ("code", ctypes.c_int * prog_mod.MAX_CODE),
                ("set_of", ctypes.c_int * MAX_MEMBERS)]


class _VecArgs(ctypes.Structure):
    """csrc/vector_topk.cu `struct VecArgs`, passed to the kernel by value:
    the residual filter's `Args`, then per column set the vector block's
    and the IVF cell block's pointers (null: no cells)."""
    _fields_ = [("a", _Args), ("vec", ctypes.c_void_p * MAX_SETS),
                ("cell", ctypes.c_void_p * MAX_SETS)]


class _StArgs(ctypes.Structure):
    """csrc/startree_agg.cu `struct StArgs`, passed to the kernel by value:
    per column set the slots' and group dimensions' row pointers, per
    member its selection mask and its set."""
    _fields_ = [("a", (ctypes.c_void_p * ST_MAX_SLOTS) * MAX_SETS),
                ("b", (ctypes.c_void_p * ST_MAX_SLOTS) * MAX_SETS),
                ("gid", (ctypes.c_void_p * ST_MAX_DIMS) * MAX_SETS),
                ("sel", ctypes.c_void_p * MAX_MEMBERS),
                ("set_of", ctypes.c_int * MAX_MEMBERS),
                ("op", ctypes.c_int * ST_MAX_SLOTS),
                ("stride", ctypes.c_int * ST_MAX_DIMS),
                ("acc_op", ctypes.c_int * ST_MAX_ACC),
                ("acc_out", ctypes.c_int * ST_MAX_ACC),
                ("nslot", ctypes.c_int), ("ndim", ctypes.c_int)]


class _RowArgs(ctypes.Structure):
    """csrc/row_assemble.cu `struct RowArgs`, passed to the kernel by
    value: each row's pointer and its length in bytes."""
    _fields_ = [("src", ctypes.c_void_p * RA_MAX_ROWS),
                ("len", ctypes.c_longlong * RA_MAX_ROWS)]


_PM = ctypes.c_void_p * MAX_MEMBERS
_IM = ctypes.c_int * MAX_MEMBERS


class _ClpLeaf(ctypes.Structure):
    """csrc/clp_match.cu `struct ClpLeaf`: a leaf's mode and slot counts,
    and per member its parameter tables and their widths."""
    _fields_ = [("alut", _PM), ("vlut", _PM), ("glt", _PM), ("gmem", _PM),
                ("ck", _PM), ("cs", _PM), ("chi", _PM), ("clo", _PM),
                ("cl", _PM), ("cp", _IM), ("vp", _IM), ("gp", _IM),
                ("ncp", _IM), ("nlp", _IM), ("mode_b", ctypes.c_int),
                ("kd", ctypes.c_int), ("ke", ctypes.c_int),
                ("pad_", ctypes.c_int)]


class _ClpArgs(ctypes.Structure):
    """csrc/clp_match.cu `struct ClpArgs`, passed to the kernel by value:
    per column set the CLP column's pseudo-column blocks, the leaves, the
    member-to-set map."""
    _fields_ = [("id", ctypes.c_void_p * MAX_SETS),
                ("dv", (ctypes.c_void_p * CLP_MAX_SLOTS) * MAX_SETS),
                ("ehi", (ctypes.c_void_p * CLP_MAX_SLOTS) * MAX_SETS),
                ("elo", (ctypes.c_void_p * CLP_MAX_SLOTS) * MAX_SETS),
                ("leaf", _ClpLeaf * CLP_MAX_LEAVES),
                ("set_of", ctypes.c_int * MAX_MEMBERS)]


#: partials one K9 launch folds (csrc/mesh_fold.cu MF_MAX_PARTS)
MF_MAX_PARTS = 64


class _FoldArgs(ctypes.Structure):
    """csrc/mesh_fold.cu `struct FoldArgs`, passed to the kernel by value:
    the partials' pointers, in mesh order."""
    _fields_ = [("part", ctypes.c_void_p * MF_MAX_PARTS)]


class CudaKernel:
    """One hand-written kernel: its source, its entry point and the number
    of times it was launched, single and batched. `layout`: the ctypes
    mirror of the struct it takes by value and the library's function that
    returns that struct's size, checked when the library loads."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list,
                 layout: Optional[Tuple[type, str]] = None):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.layout = layout
        self.launches = 0
        self.batched_launches = 0
        self.batched_members = 0
        self._fn = self._lib = None
        self._symbols: Dict[str, object] = {}
        self._lock = threading.Lock()

    def count(self, members: int, batched: bool) -> None:
        """One launch of `members` members: a single launch, or a batched
        one."""
        with self._lock:
            if batched:
                self.batched_launches += 1
                self.batched_members += members
            else:
                self.launches += 1

    def reset_counts(self) -> None:
        with self._lock:
            self.launches = self.batched_launches = 0
            self.batched_members = 0

    @property
    def library(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
        for f in (self.source, *headers):
            with open(os.path.join(_CSRC, f), "rb") as fh:
                h.update(fh.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def symbol(self, name: str, argtypes: list):
        """Another C function of the kernel's library (int result), bound
        once."""
        self.fn()
        with self._lock:
            f = self._symbols.get(name)
            if f is None:
                f = getattr(self._lib, name)
                f.argtypes, f.restype = argtypes, ctypes.c_int
                self._symbols[name] = f
            return f

    def fn(self):
        with self._lock:
            if self._fn is None:
                build([self])
                lib = self._lib = ctypes.CDLL(self.library)
                f = getattr(lib, self.entry)
                f.argtypes = self.argtypes
                f.restype = ctypes.c_int
                if self.layout is not None:
                    struct, sizer = self.layout
                    size = getattr(lib, sizer)
                    size.argtypes, size.restype = [], ctypes.c_int
                    if size() != ctypes.sizeof(struct):
                        raise RuntimeError(
                            f"{self.source}: argument struct of {size()} "
                            f"bytes, its ctypes mirror "
                            f"{ctypes.sizeof(struct)}")
                self._fn = f
            return self._fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_Args, "pt_args_bytes")
SCAN_AGG = CudaKernel("scan_agg", "scan_agg.cu", "pt_scan_agg",
                      [ctypes.POINTER(_Args), _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _I, _P], layout=_ARGS)
GROUP_AGG = CudaKernel("group_agg", "group_agg.cu", "pt_group_agg",
                       [ctypes.POINTER(_Args), _P, _P, _I, _I, _I, _I, _I, _I,
                        _P, _P, _I, _P], layout=_ARGS)
SKETCH_AGG = CudaKernel("sketch_agg", "sketch_agg.cu", "pt_sketch_agg",
                        [ctypes.POINTER(_Args), _P, _P, _I, _I, _I, _I, _I,
                         _I, _P, _P, _P, _I, _P], layout=_ARGS)
TOPN = CudaKernel("topn", "topn.cu", "pt_topn",
                  [ctypes.POINTER(_Args), _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _P, _P, _P, _P, _P, _P, _P, _I, _P], layout=_ARGS)
STARTREE_AGG = CudaKernel("startree_agg", "startree_agg.cu",
                          "pt_startree_agg",
                          [ctypes.POINTER(_StArgs), _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P, _P, _I, _P],
                          layout=(_StArgs, "pt_startree_args_bytes"))
ROW_ASSEMBLE = CudaKernel("row_assemble", "row_assemble.cu",
                          "pt_row_assemble",
                          [ctypes.POINTER(_RowArgs), _I, _I, ctypes.c_longlong,
                           _P, _I, _P],
                          layout=(_RowArgs, "pt_row_assemble_args_bytes"))
CLP_MATCH = CudaKernel("clp_match", "clp_match.cu", "pt_clp_match",
                       [ctypes.POINTER(_ClpArgs), _I, _I, _I, _I, _I, _P, _I,
                        _P], layout=(_ClpArgs, "pt_clp_args_bytes"))
VECTOR_TOPK = CudaKernel("vector_topk", "vector_topk.cu", "pt_vector_topk",
                         [ctypes.POINTER(_VecArgs), _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _I, _I, ctypes.c_longlong, _P, _P,
                          _P, _P, _P, _P, _P, _I, _P],
                         layout=(_VecArgs, "pt_vec_args_bytes"))
MESH_FOLD = CudaKernel("mesh_fold", "mesh_fold.cu", "pt_mesh_fold",
                       [ctypes.POINTER(_FoldArgs), _P, _P, _P, _P, _P, _P, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                        _P],
                       layout=(_FoldArgs, "pt_mesh_fold_args_bytes"))
KERNELS = (SCAN_AGG, GROUP_AGG, SKETCH_AGG, TOPN, STARTREE_AGG, ROW_ASSEMBLE,
           CLP_MATCH, VECTOR_TOPK, MESH_FOLD)

_build_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(kernels=KERNELS) -> List[str]:
    """Build the kernels' libraries that are missing, one nvcc per source,
    all started together. Returns the names it built."""
    with _build_lock:
        todo = [k for k in kernels if not os.path.exists(k.library)]
        if not todo:
            return []
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for k in todo:
            tmp = f"{k.library}.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(_CSRC, k.source)]
            procs.append((k, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for k, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{k.source}:\n{out.decode(errors='replace')}")
            else:
                os.replace(tmp, k.library)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        return [k.name for k in todo]


def _check(t: torch.Tensor, what: str, device: torch.device,
           dtypes: Tuple[torch.dtype, ...], shape: Tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


_COL_DTYPES = (torch.int8, torch.int16, torch.int32, torch.float32,
               torch.float64)

Tensors = Dict[str, torch.Tensor]


def _stack(ts: List[torch.Tensor]) -> torch.Tensor:
    """[n, ...] from n equal-shaped tensors (a view when n is 1)."""
    return ts[0].unsqueeze(0) if len(ts) == 1 else torch.stack(ts)


class _Launch:
    """A validated K1-K4 launch of B members: the ctypes Args struct
    (column pointers per set, LUT pointers, program, member-to-set map),
    the [B, S, P] float64 parameter matrix, the [U, S] doc counts and the
    [B, S, C] LUTs it points at (held here until the launch is
    enqueued). `luts` holds LUTs already stacked over the members ([B, S,
    C], the CLP leaves' K7 masks), by key, in place of the members' own
    entries."""

    def __init__(self, plan: DevicePlan, col_sets: List[Tensors],
                 params_list: List[Tensors], num_docs_list: List[torch.Tensor],
                 idx: List[int], D: int, value_dtype: torch.dtype,
                 luts: Optional[Tensors] = None):
        B, U = len(params_list), len(col_sets)
        if not 1 <= B <= MAX_MEMBERS or not 1 <= U <= MAX_SETS:
            raise ValueError(f"{B} members over {U} column sets: a launch "
                             f"takes 1-{MAX_MEMBERS} members and 1-{MAX_SETS}"
                             " sets")
        if len(num_docs_list) != U or len(idx) != B \
                or any(not 0 <= int(u) < U for u in idx):
            raise ValueError("num_docs per column set and a member-to-set "
                             "index in [0, U) per member")
        nd0 = num_docs_list[0]
        device = nd0.device
        if device.type != "cuda":
            raise ValueError(f"CUDA kernel given tensors on {device}")
        if value_dtype not in (torch.float32, torch.float64):
            raise ValueError(f"value dtype {value_dtype} is not float32/64")
        if nd0.dim() != 1:
            raise ValueError("num_docs must be 1-D")
        S = nd0.shape[0]
        for u, nd in enumerate(num_docs_list):
            _check(nd, f"num_docs[{u}]", device, (torch.int32,), (S,))
        if D <= 0 or D > (1 << 30):
            raise ValueError(f"doc block width {D} out of range")
        prog = prog_mod.compile_plan(plan)
        args = _Args()
        dtypes = []
        for c, name in enumerate(prog.cols):
            t0 = col_sets[0][name]
            for u, cols in enumerate(col_sets):
                _check(cols[name], f"{name} of set {u}", device,
                       (t0.dtype,) if u else _COL_DTYPES, (S, D))
                args.cols[u][c] = cols[name].data_ptr()
            dtypes.append(str(t0.dtype).replace("torch.", ""))
        if plan.tbucket:  # K2 reads the timestamp's planes as i32
            for plane in ("valhi:", "vallo:"):
                if col_sets[0][plane + plan.tbucket[0]].dtype != torch.int32:
                    raise ValueError(f"{plane}{plan.tbucket[0]} must be "
                                     "int32 split planes")
        for u, cols in enumerate(col_sets):
            vm = cols.get("vmask")
            if plan.valid_mask:
                if vm is None:
                    raise ValueError(f"set {u}: a valid-mask plan without "
                                     "its vmask block")
                _check(vm, f"vmask of set {u}", device,
                       (torch.uint8, torch.bool), (S, D))
                args.vmask[u] = vm.data_ptr()
        self.luts, widths = [], []
        for k, key in enumerate(prog.luts):
            if luts and key in luts:
                lut = luts[key]
                if lut.dim() != 3:
                    raise ValueError(f"{key} must be [B, S, C]")
                _check(lut, key, device, (torch.bool,),
                       (B, S, lut.shape[2]))
            else:
                ts = [p[key] for p in params_list]
                if ts[0].dim() != 2:
                    raise ValueError(f"{key} must be [S, C]")
                for m, t in enumerate(ts):
                    _check(t, f"{key} of member {m}", device, (torch.bool,),
                           (S, ts[0].shape[1]))
                lut = _stack(ts)
            self.luts.append(lut)
            args.luts[k] = lut.data_ptr()
            widths.append(int(lut.shape[2]))
        code = prog.for_launch(dtypes, widths)
        ctypes.memmove(args.code, code.ctypes.data, code.nbytes)
        for m, u in enumerate(idx):
            args.set_of[m] = int(u)
        columns = []
        for key, lit in prog.params:
            if key is None:
                columns.append(torch.full((B, S), lit, dtype=torch.float64,
                                          device=device))
                continue
            ts = [p[key] for p in params_list]
            for m, t in enumerate(ts):
                if t.device != device or tuple(t.shape) != (S,) \
                        or t.dtype != ts[0].dtype:
                    raise ValueError(f"{key} of member {m} must be a [S] "
                                     f"{ts[0].dtype} tensor on {device}")
            columns.append(_stack(ts).to(torch.float64))
        if not columns:
            columns.append(torch.zeros((B, S), dtype=torch.float64,
                                       device=device))
        self.pmat = torch.stack(columns, 2).contiguous()
        self.num_docs = _stack(num_docs_list).contiguous()
        self.args, self.prog, self.device = args, prog, device
        self.B, self.S, self.D = B, S, D
        self.P = self.pmat.shape[2]
        self.f64 = int(value_dtype == torch.float64)
        self.nb = max(1, min(MAX_BLOCKS_PER_SEGMENT,
                             math.ceil(D / (THREADS * DOCS_PER_THREAD))))

    @property
    def stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream


def _single(fn, plan, cols, params, num_docs, D, value_dtype, **kw):
    """A single launch (B = U = 1) of a batched wrapper, as [S, ...]."""
    return fn(plan, [cols], [params], [num_docs], [0], D, value_dtype,
              batched=False, **kw)[0]


def scan_agg_batched(plan: DevicePlan, col_sets: List[Tensors],
                     params_list: List[Tensors],
                     num_docs_list: List[torch.Tensor], idx: List[int],
                     D: int, value_dtype: torch.dtype,
                     batched: bool = True,
                     luts: Optional[Tensors] = None) -> torch.Tensor:
    """K1 over B members: the ungrouped packed [B, S, 1 + sum(w)] result
    of `plan`, member m over column set idx[m] (`luts`: see _Launch)."""
    if is_grouped(plan):
        raise ValueError("scan_agg takes ungrouped plans")
    L = _Launch(plan, col_sets, params_list, num_docs_list, idx, D,
                value_dtype, luts)
    nb = max(1, min(MAX_BLOCKS_PER_SEGMENT,
                    math.ceil(D / (THREADS * SCAN_DOCS_PER_THREAD))))
    partial = torch.empty((L.B, L.S, nb, L.prog.n_acc),
                          dtype=torch.float64, device=L.device)
    out = torch.empty((L.B, L.S, L.prog.out_width), dtype=value_dtype,
                      device=L.device)
    rc = SCAN_AGG.fn()(ctypes.byref(L.args), L.pmat.data_ptr(),
                       L.num_docs.data_ptr(), L.S, D, L.P, nb, L.B, L.f64,
                       partial.data_ptr(), out.data_ptr(), L.device.index,
                       L.stream)
    if rc != 0:
        raise RuntimeError(f"scan_agg launch failed: cudaError {rc}")
    SCAN_AGG.count(L.B, batched)
    return out


def scan_agg(plan: DevicePlan, cols: Tensors, params: Tensors,
             num_docs: torch.Tensor, D: int, value_dtype: torch.dtype,
             luts: Optional[Tensors] = None) -> torch.Tensor:
    """K1: the ungrouped packed [S, 1 + sum(w)] result of `plan`."""
    return _single(scan_agg_batched, plan, cols, params, num_docs, D,
                   value_dtype, luts=luts)


def group_agg_batched(plan: DevicePlan, col_sets: List[Tensors],
                      params_list: List[Tensors],
                      num_docs_list: List[torch.Tensor], idx: List[int],
                      D: int, value_dtype: torch.dtype,
                      batched: bool = True,
                      luts: Optional[Tensors] = None,
                      G: int = 0) -> torch.Tensor:
    """K2 over B members: the grouped packed [B, S, G, n_slots] result of
    `plan`, member m over column set idx[m] (`luts`: see _Launch). G: the
    group count of a compact-key plan, whose 'gkey' int32 [S, D] blocks
    hold each doc's code in [0, G); a dense plan's is its num_groups."""
    if not is_grouped(plan):
        raise ValueError("group_agg takes group-by plans")
    G = plan.num_groups or G
    if not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"group count {G} outside [1, {MAX_GROUPS}]")
    L = _Launch(plan, col_sets, params_list, num_docs_list, idx, D,
                value_dtype, luts)
    if plan.group_compact:
        for u, cols in enumerate(col_sets):
            _check(cols["gkey"], f"gkey of set {u}", L.device,
                   (torch.int32,), (L.S, D))
    shape = (L.B, L.S, G, L.prog.out_width)
    tier = group_tier([op for op, _v, _f in plan.agg_ops], G, L.f64)
    got = GROUP_AGG.symbol("pt_group_tier", [_P, _I, _I])(
        ctypes.addressof(L.args.code), G, L.f64)
    if GROUP_TIERS[got] != tier:
        raise RuntimeError(f"group_agg chose tier {GROUP_TIERS[got]}, its "
                           f"mirror {tier}")
    table = torch.empty(shape, dtype=torch.int64, device=L.device)
    out = torch.empty(shape, dtype=value_dtype, device=L.device)
    rc = GROUP_AGG.fn()(ctypes.byref(L.args), L.pmat.data_ptr(),
                        L.num_docs.data_ptr(), L.S, D, L.P, G, L.B, L.f64,
                        table.data_ptr(), out.data_ptr(), L.device.index,
                        L.stream)
    if rc != 0:
        raise RuntimeError(f"group_agg launch failed: cudaError {rc}")
    GROUP_AGG.count(L.B, batched)
    return out


def group_table_bytes(ops: List[str], G: int, f64: bool) -> int:
    """Bytes of one on-chip copy of K2's [G, n_slots] table: per slot a
    column of G words (4 bytes for a count and a float32 min / max, else
    8) padded to 8 bytes (csrc/group_agg.cu `slot_offsets`)."""
    def word(op):
        if op == "count" or (op in ("min", "max") and not f64):
            return 4
        return 8
    return sum((G * word(op) + 7) // 8 * 8 for op in ops)


def group_tier(ops: List[str], G: int, f64: bool) -> str:
    """K2's tier for a table of these slot ops at G: the mirror of
    csrc/group_agg.cu `choose_tier`, which the wrapper checks it against on
    every launch."""
    tb = group_table_bytes(ops, G, f64)
    if tb <= GROUP_WARP_BYTES:
        return "warp"
    return "block" if tb <= GROUP_BLOCK_BYTES else "global"


def group_agg(plan: DevicePlan, cols: Tensors, params: Tensors,
              num_docs: torch.Tensor, D: int, value_dtype: torch.dtype,
              luts: Optional[Tensors] = None, G: int = 0) -> torch.Tensor:
    """K2: the grouped packed [S, G, n_slots] result of `plan` (G: see
    group_agg_batched)."""
    return _single(group_agg_batched, plan, cols, params, num_docs, D,
                   value_dtype, luts=luts, G=G)


def sketch_agg_batched(plan: DevicePlan, col_sets: List[Tensors],
                       params_list: List[Tensors],
                       num_docs_list: List[torch.Tensor], idx: List[int],
                       D: int, value_dtype: torch.dtype,
                       batched: bool = True,
                       out: Optional[torch.Tensor] = None,
                       luts: Optional[Tensors] = None) -> torch.Tensor:
    """K3 over B members: the matched count and the sketch slots' columns
    of the packed [B, S, 1 + sum(w)] result of `plan`, written into `out`
    (K1's output, on the same stream, for a plan that also has scalar
    slots) or into a new tensor (`luts`: see _Launch)."""
    if is_grouped(plan):
        raise ValueError("sketch_agg takes ungrouped plans")
    L = _Launch(plan, col_sets, params_list, num_docs_list, idx, D,
                value_dtype, luts)
    for op, _v, _f in plan.agg_ops:
        if op.startswith("hll:"):
            col = op.split(":", 2)[2]
            for u, cols in enumerate(col_sets):
                for plane in ("valhi:", "vallo:"):
                    _check(cols[plane + col], f"{plane}{col} of set {u}",
                           L.device, (torch.int32,), (L.S, D))
    shape = (L.B, L.S, L.prog.out_width)
    if out is None:
        out = torch.empty(shape, dtype=value_dtype, device=L.device)
    else:
        _check(out, "out", L.device, (value_dtype,), shape)
    # the blocks a segment (as many as one wave of the card's resident
    # blocks holds at the launch's layout), one block's table bytes and
    # its on-chip histograms' bytes (its partial row); registers and
    # buckets are integers, exact under any partition
    tab, part = ctypes.c_int(), ctypes.c_int()
    nb = SKETCH_AGG.symbol("pt_sketch_grid", [
        ctypes.POINTER(_Args), _I, _I, _I, _I, _I, _I,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])(
            ctypes.byref(L.args), L.S, D, L.P, L.B, L.f64, L.device.index,
            ctypes.byref(tab), ctypes.byref(part))
    if nb < 0:
        raise RuntimeError(f"sketch_agg layout refused: cudaError {-nb}")
    if tab.value != L.prog.sketch_smem_bytes:
        raise RuntimeError(f"sketch_agg placed {tab.value} table bytes on "
                           f"chip, program.py {L.prog.sketch_smem_bytes}")
    partial = torch.empty(max(1, L.B * L.S * nb * part.value),
                          dtype=torch.uint8, device=L.device)
    gtab = torch.empty(shape, dtype=torch.int32, device=L.device)
    rc = SKETCH_AGG.fn()(ctypes.byref(L.args), L.pmat.data_ptr(),
                         L.num_docs.data_ptr(), L.S, D, L.P, nb, L.B, L.f64,
                         partial.data_ptr(), gtab.data_ptr(), out.data_ptr(),
                         L.device.index, L.stream)
    if rc != 0:
        raise RuntimeError(f"sketch_agg launch failed: cudaError {rc}")
    SKETCH_AGG.count(L.B, batched)
    return out


def sketch_agg(plan: DevicePlan, cols: Tensors, params: Tensors,
               num_docs: torch.Tensor, D: int, value_dtype: torch.dtype,
               out: Optional[torch.Tensor] = None,
               luts: Optional[Tensors] = None) -> torch.Tensor:
    """K3: the matched count and the sketch slots' columns of the packed
    [S, 1 + sum(w)] result of `plan`, written into `out` or a new
    tensor."""
    return _single(sketch_agg_batched, plan, cols, params, num_docs, D,
                   value_dtype, out=None if out is None else out[None],
                   luts=luts)


def topn_batched(plan: DevicePlan, col_sets: List[Tensors],
                 params_list: List[Tensors],
                 num_docs_list: List[torch.Tensor], idx: List[int], D: int,
                 value_dtype: torch.dtype,
                 batched: bool = True,
                 luts: Optional[Tensors] = None) -> torch.Tensor:
    """K4 over B members: the [B, S, 1 + k] int32 top-N of `plan`,
    k = min(topn_k, D), member m over column set idx[m] (`luts`: see
    _Launch)."""
    if plan.mode != "topn":
        raise ValueError("topn takes top-N plans")
    k = min(plan.topn_k, D)
    if not 1 <= k <= TOPN_MAX_K:
        raise ValueError(f"top-N k {k} outside [1, {TOPN_MAX_K}]")
    L = _Launch(plan, col_sets, params_list, num_docs_list, idx, D,
                value_dtype, luts)
    R = L.B * L.S
    if R > TOPN_MAX_ROWS:
        raise ValueError(f"{L.B} members x {L.S} segments exceed K4's "
                         f"{TOPN_MAX_ROWS} rows")
    dev = L.device
    kdt = torch.int64 if value_dtype == torch.float64 else torch.int32
    # the two candidate lists, each room for every doc of every row
    keys = torch.empty((2, L.B, L.S, D), dtype=kdt, device=dev)
    docs = torch.empty((2, L.B, L.S, D), dtype=torch.int32, device=dev)
    state = torch.empty((R, TOPN_ROW_WORDS), dtype=torch.int64, device=dev)
    hist = torch.empty((R, 256), dtype=torch.int32, device=dev)
    cand_key = torch.empty((R, k), dtype=kdt, device=dev)
    cand_doc = torch.empty((R, k), dtype=torch.int32, device=dev)
    out = torch.empty((L.B, L.S, 1 + k), dtype=torch.int32, device=dev)
    rc = TOPN.fn()(ctypes.byref(L.args), L.pmat.data_ptr(),
                   L.num_docs.data_ptr(), L.S, D, L.P, L.nb, L.B, L.f64, k,
                   int(plan.topn_asc), keys.data_ptr(), docs.data_ptr(),
                   state.data_ptr(), hist.data_ptr(), cand_key.data_ptr(),
                   cand_doc.data_ptr(), out.data_ptr(), dev.index, L.stream)
    if rc != 0:
        raise RuntimeError(f"topn launch failed: cudaError {rc}")
    TOPN.count(L.B, batched)
    return out


def topn(plan: DevicePlan, cols: Tensors, params: Tensors,
         num_docs: torch.Tensor, D: int, value_dtype: torch.dtype,
         luts: Optional[Tensors] = None) -> torch.Tensor:
    """K4: the [S, 1 + k] int32 top-N of `plan`, k = min(topn_k, D)."""
    return _single(topn_batched, plan, cols, params, num_docs, D,
                   value_dtype, luts=luts)


#: K5 slot op codes (csrc/startree_agg.cu OP_*)
_ST_OPS = {"usum": 0, "sum": 1, "min": 2, "max": 3}


@functools.lru_cache(maxsize=1024)
def _st_layout(plan, value_dtype: torch.dtype):
    """K5's plan-constant launch data, built once a (plan, value dtype):
    the bytes of a `_StArgs` with its slot ops, group strides and
    accumulator map set and no pointer, the staged blocks each column set
    must hold ((field, index, key, dtypes), in order), and the accumulator
    and output widths A and W."""
    if len(plan.slots) > ST_MAX_SLOTS or len(plan.group_dims) > ST_MAX_DIMS:
        raise ValueError(f"star-tree plan beyond {ST_MAX_SLOTS} slots or "
                         f"{ST_MAX_DIMS} group dims")
    args = _StArgs()
    args.nslot, args.ndim = len(plan.slots), len(plan.group_dims)
    layout = []
    A, W = 1, 1  # accumulator and output columns; column 0 is the count
    args.acc_op[0], args.acc_out[0] = _ST_OPS["sum"], 0
    for j, (op, name) in enumerate(plan.slots):
        if op not in _ST_OPS:
            raise ValueError(f"unknown star-tree slot op {op!r}")
        args.op[j] = _ST_OPS[op]
        if op == "usum":
            layout += [("a", j, "sthi:" + name, (torch.int32,)),
                       ("b", j, "stlo:" + name, (torch.int32,))]
            for p in range(2 * USUM_PLANES):
                args.acc_op[A + p] = _ST_OPS["usum"]
                args.acc_out[A + p] = W + 2 * p
            A += 2 * USUM_PLANES
            W += 4 * USUM_PLANES
        else:
            layout.append(("a", j, "stval:" + name, (value_dtype,)))
            args.acc_op[A], args.acc_out[A] = _ST_OPS[op], W
            A += 1
            W += 1
    for g, (dim, stride) in enumerate(zip(plan.group_dims,
                                          plan.group_strides)):
        layout.append(("gid", g, "stid:" + dim, (torch.int32,)))
        args.stride[g] = stride
    return bytes(args), tuple(layout), A, W


def startree_agg_batched(plan, col_sets: List[Tensors],
                         params_list: List[Tensors],
                         num_docs_list: List[torch.Tensor], idx: List[int],
                         D: int, value_dtype: torch.dtype,
                         batched: bool = True) -> torch.Tensor:
    """K5 over B members: the packed star-tree residual aggregation of
    `plan` (an ops/startree_device.StarTreePlan), [B, S, 1 + sum(w)] flat
    or [B, S, G, 1 + sum(w)] grouped, in the value dtype; member m over
    column set idx[m] with its own selection mask params_list[m]["sel"]."""
    B, U = len(params_list), len(col_sets)
    if not 1 <= B <= MAX_MEMBERS or not 1 <= U <= MAX_SETS:
        raise ValueError(f"{B} members over {U} column sets: a launch takes "
                         f"1-{MAX_MEMBERS} members and 1-{MAX_SETS} sets")
    if len(num_docs_list) != U or len(idx) != B \
            or any(not 0 <= int(u) < U for u in idx):
        raise ValueError("num_docs per column set and a member-to-set "
                         "index in [0, U) per member")
    device = num_docs_list[0].device
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {device}")
    if value_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"value dtype {value_dtype} is not float32/64")
    if num_docs_list[0].dim() != 1:
        raise ValueError("num_docs must be 1-D")
    S = num_docs_list[0].shape[0]
    for u, nd in enumerate(num_docs_list):
        _check(nd, f"num_docs[{u}]", device, (torch.int32,), (S,))
    if D <= 0 or D > (1 << 30):
        raise ValueError(f"record block width {D} out of range")
    const, layout, A, W = _st_layout(plan, value_dtype)
    args = _StArgs.from_buffer_copy(const)
    for m, (params, u) in enumerate(zip(params_list, idx)):
        _check(params["sel"], f"sel of member {m}", device, (torch.bool,),
               (S, D))
        args.sel[m] = params["sel"].data_ptr()
        args.set_of[m] = int(u)
    for field, j, key, dtypes in layout:
        row = getattr(args, field)
        for u, cols in enumerate(col_sets):
            _check(cols[key], f"{key} of set {u}", device, dtypes, (S, D))
            row[u][j] = cols[key].data_ptr()
    G = plan.num_groups
    nb = max(1, min(MAX_BLOCKS_PER_SEGMENT,
                    math.ceil(D / (THREADS * DOCS_PER_THREAD))))
    nrec = _stack(num_docs_list).contiguous()
    out = torch.empty((B, S, G, W) if G else (B, S, W), dtype=value_dtype,
                      device=device)
    scratch = None if startree_one_pass(G, nb, A) else torch.empty(
        (B, S, G or nb, A), dtype=torch.float64, device=device)
    rc = STARTREE_AGG.fn()(ctypes.byref(args), nrec.data_ptr(), S, D, G, nb,
                           A, W, B, int(value_dtype == torch.float64),
                           None if scratch is None else scratch.data_ptr(),
                           out.data_ptr(), device.index,
                           torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"startree_agg launch failed: cudaError {rc}")
    STARTREE_AGG.count(B, batched)
    return out


@functools.lru_cache(maxsize=1024)
def startree_one_pass(G: int, nb: int, A: int) -> bool:
    """Whether K5 runs a launch in one kernel and no scratch: a block a
    segment (nb = 1), flat or with its [G, A] float64 table in shared
    memory. csrc/startree_agg.cu `one_pass` decides, and refuses a null
    scratch where it does not hold; asked once a shape."""
    return bool(STARTREE_AGG.symbol("pt_startree_one_pass", [_I, _I, _I])(
        G, nb, A))


def empty_launch(device: Optional[torch.device] = None) -> None:
    """One empty kernel, launched as K5's wrapper launches (through ctypes,
    on the current stream): the floor of one call, which measurement
    scripts time beside K5. Counted nowhere."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    rc = STARTREE_AGG.symbol("pt_empty_launch", [_I, _P])(
        device.index, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty launch failed: cudaError {rc}")


def startree_agg(plan, cols: Tensors, params: Tensors,
                 num_docs: torch.Tensor, D: int,
                 value_dtype: torch.dtype) -> torch.Tensor:
    """K5: the packed star-tree residual aggregation of `plan` (an
    ops/startree_device.StarTreePlan): [S, 1 + sum(w)] flat or
    [S, G, 1 + sum(w)] grouped, in the value dtype."""
    return _single(startree_agg_batched, plan, cols, params, num_docs, D,
                   value_dtype)


def row_assemble(rows: List[torch.Tensor], S: int, D: int) -> torch.Tensor:
    """K6: the [S, D] block whose row s is rows[s] followed by zeros (rows
    past len(rows) all zero), from 1-D rows of one dtype on the card, each
    at most D long. One launch per RA_MAX_ROWS block rows."""
    if not rows or len(rows) > S:
        raise ValueError(f"{len(rows)} rows for a block of {S}")
    t0 = rows[0]
    device, dtype = t0.device, t0.dtype
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {device}")
    if D <= 0 or S > 65535 * RA_MAX_ROWS:
        raise ValueError(f"block [{S}, {D}] out of range")
    for i, r in enumerate(rows):
        if r.device != device or r.dtype != dtype or r.dim() != 1 \
                or r.shape[0] > D or not r.is_contiguous():
            raise ValueError(f"row {i}: {tuple(r.shape)} {r.dtype} on "
                             f"{r.device}; rows are contiguous 1-D {dtype} "
                             f"tensors on {device} of at most {D}")
    out = torch.empty((S, D), dtype=dtype, device=device)
    size = t0.element_size()
    row_bytes = D * size
    fn = ROW_ASSEMBLE.fn()
    stream = torch.cuda.current_stream(device).cuda_stream
    for c0 in range(0, S, RA_MAX_ROWS):
        chunk = rows[c0:c0 + RA_MAX_ROWS]
        args = _RowArgs()
        for i, r in enumerate(chunk):
            args.src[i] = r.data_ptr()
            args.len[i] = r.shape[0] * size
        rc = fn(ctypes.byref(args), len(chunk), min(RA_MAX_ROWS, S - c0),
                row_bytes, out.data_ptr() + c0 * row_bytes, device.index,
                stream)
        if rc != 0:
            raise RuntimeError(f"row_assemble launch failed: cudaError {rc}")
        ROW_ASSEMBLE.count(1, batched=False)
    return out


def mesh_fold(parts: List[torch.Tensor], fold,
              batched: bool = False) -> torch.Tensor:
    """K9: the [B, R * W + T] fold of P partials (one per mesh slot, each
    [B, ...] of fold.rows_in x fold.win values in the value dtype, on one
    card) by `fold` (ops/kernels.py `MeshFold`): a strided fold computes
    its sources, a listed one reads its lists, and its tails longer than
    MeshFold.LONG_LIST add in the lane order over a block's threads.
    `batched`: the partials carry a query axis of B coalesced members."""
    if not 1 <= len(parts) <= MF_MAX_PARTS:
        raise ValueError(f"{len(parts)} partials: K9 folds 1-{MF_MAX_PARTS}")
    t0 = parts[0]
    device, dtype = t0.device, t0.dtype
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"partials of dtype {dtype}, not float32/64")
    B = t0.shape[0]
    if t0.numel() != B * fold.rows_in * fold.win:
        raise ValueError(f"partial of shape {tuple(t0.shape)} is not "
                         f"[B, {fold.rows_in} rows of {fold.win}]")
    args = _FoldArgs()
    for p, t in enumerate(parts):
        _check(t, f"partial {p}", device, (dtype,), tuple(t0.shape))
        args.part[p] = t.data_ptr()
    if fold.parts > len(parts):
        raise ValueError(f"the fold reads {fold.parts} partials, "
                         f"given {len(parts)}")
    ops, off, src, toff, tsrc, ltail = fold.on(device)
    out = torch.empty((B, fold.R * fold.W + fold.T), dtype=dtype,
                      device=device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (*parts, out))

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = MESH_FOLD.fn()(
        ctypes.byref(args), ops.data_ptr(), ptr(off), ptr(src), ptr(toff),
        ptr(tsrc), ptr(ltail), len(fold.ltail), fold.R, fold.W, fold.T,
        fold.col0, fold.tail_col, fold.rows_in, fold.win, B, fold.n_doc,
        int(aligned), int(dtype == torch.float64), out.data_ptr(),
        device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mesh_fold launch failed: cudaError {rc}")
    MESH_FOLD.count(B, batched)
    return out


def clp_match_batched(leaves, col_sets: List[Tensors],
                      params_list: List[Tensors], idx: List[int], D: int,
                      batched: bool = True) -> torch.Tensor:
    """K7 over B members: the [L, B, S, D] bool match masks of `leaves`
    ((leaf index, DeviceLeaf) pairs, 'clp' leaves of one column, at most
    CLP_MAX_LEAVES), member m over column set idx[m] with its own
    parameters params_list[m]['leaf<i>:*'] (ops/clp_device.py
    `leaf_params`), the dict-var LUTs packed ('leaf<i>:dvlutp' /
    'leaf<i>:dlutp', `clp_device.pack_banks`)."""
    B, U, L = len(params_list), len(col_sets), len(leaves)
    if not 1 <= B <= MAX_MEMBERS or not 1 <= U <= MAX_SETS:
        raise ValueError(f"{B} members over {U} column sets: a launch takes "
                         f"1-{MAX_MEMBERS} members and 1-{MAX_SETS} sets")
    if not 1 <= L <= CLP_MAX_LEAVES \
            or len({lf.column for _i, lf in leaves}) != 1 \
            or any(lf.kind != "clp" for _i, lf in leaves):
        raise ValueError(f"K7 takes 1-{CLP_MAX_LEAVES} clp leaves of one "
                         "column")
    if len(idx) != B or any(not 0 <= int(u) < U for u in idx):
        raise ValueError("a member-to-set index in [0, U) per member")
    col = leaves[0][1].column
    t0 = col_sets[0]["clpid:" + col]
    device = t0.device
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {device}")
    if t0.dim() != 2 or t0.shape[1] != D or D <= 0 or D > (1 << 30):
        raise ValueError(f"clpid:{col} must be [S, {D}]")
    S = t0.shape[0]
    kd = max(lf.meta[1] for _i, lf in leaves)
    ke = max(lf.meta[2] for _i, lf in leaves)
    if kd > CLP_MAX_SLOTS or ke > CLP_MAX_SLOTS:
        raise ValueError(f"{kd} dict / {ke} encoded slots above "
                         f"{CLP_MAX_SLOTS}")
    args = _ClpArgs()

    def block(cols, key, u):
        _check(cols[key], f"{key} of set {u}", device, (torch.int32,), (S, D))
        return cols[key].data_ptr()
    for u, cols in enumerate(col_sets):
        args.id[u] = block(cols, "clpid:" + col, u)
        for j in range(kd):
            args.dv[u][j] = block(cols, f"clpdv{j}:{col}", u)
        for j in range(ke):
            args.ehi[u][j] = block(cols, f"clpehi{j}:{col}", u)
            args.elo[u][j] = block(cols, f"clpelo{j}:{col}", u)
    for m, u in enumerate(idx):
        args.set_of[m] = int(u)
    for l, (i, leaf) in enumerate(leaves):
        mode, lkd, lke = leaf.meta
        la = args.leaf[l]
        la.mode_b, la.kd, la.ke = int(mode == "b"), lkd, lke
        for m, params in enumerate(params_list):
            def table(name, dtypes, shape):
                t = params[f"leaf{i}:{name}"]
                _check(t, f"leaf{i}:{name} of member {m}", device, dtypes,
                       (S,) + tuple(shape(t)))
                return t.data_ptr()
            alut = params[f"leaf{i}:alut"]
            la.alut[m] = table("alut", (torch.bool,), lambda t: t.shape[1:])
            la.cp[m] = max(1, alut.shape[1])
            if mode == "a":
                if lkd:
                    la.vlut[m] = table("dvlutp", (torch.uint8,),
                                       lambda t: t.shape[1:])
                    la.vp[m] = 8 * params[f"leaf{i}:dvlutp"].shape[1]
                continue
            ck = params[f"leaf{i}:ck"]
            gp, ncp = params[f"leaf{i}:glt"].shape[1], ck.shape[1]
            if gp > CLP_MAX_GROUPS or ncp > CLP_MAX_CONDS:
                raise ValueError(f"leaf{i}: {gp} groups / {ncp} conditions "
                                 f"above {CLP_MAX_GROUPS} / {CLP_MAX_CONDS}")
            la.gp[m], la.ncp[m] = gp, ncp
            la.glt[m] = table("glt", (torch.int32,), lambda t: (gp,))
            la.gmem[m] = table("gmem", (torch.bool,), lambda t: (gp, ncp))
            la.ck[m] = table("ck", (torch.int8,), lambda t: (ncp,))
            for name in ("cs", "chi", "clo", "cl"):
                getattr(la, name)[m] = table(name, (torch.int32,),
                                             lambda t: (ncp,))
            if lkd:
                la.vlut[m] = table("dlutp", (torch.uint8,),
                                   lambda t: t.shape[1:])
                _S, la.nlp[m], vpb = params[f"leaf{i}:dlutp"].shape
                la.vp[m] = 8 * vpb
    out = torch.empty((L, B, S, D), dtype=torch.bool, device=device)
    ntile = max(1, min(MAX_BLOCKS_PER_SEGMENT,
                       math.ceil(D / (THREADS * DOCS_PER_THREAD))))
    rc = CLP_MATCH.fn()(ctypes.byref(args), S, D, B, L, ntile,
                        out.data_ptr(), device.index,
                        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"clp_match launch failed: cudaError {rc}")
    CLP_MATCH.count(B, batched)
    return out


def clp_match(leaves, cols: Tensors, params: Tensors, D: int) -> torch.Tensor:
    """K7: the [L, S, D] bool match masks of `leaves` (one column's 'clp'
    leaves) over one column set."""
    return clp_match_batched(leaves, [cols], [params], [0], D,
                             batched=False)[:, 0]


def vector_local_cap(kk: int) -> int:
    """The candidates K8 selects from in one block's shared memory at kk
    (csrc/vector_topk.cu `pt_vec_local_cap`): a launch whose rows hold at
    most this many runs three passes, else K4's sift passes as well."""
    return VECTOR_TOPK.symbol("pt_vec_local_cap", [_I])(kk)


def vector_cap(params_list: List[Tensors], D: int) -> int:
    """The bound on any row's candidates that sizes K8's lists: the largest
    of the members' host-side counts ('vq:nc', [S] int32 on the CPU:
    ops/vector_device.py `candidate_counts`), D where a member has none;
    at least 1. Read on the host: no synchronization with the card."""
    cap = D
    if all("vq:nc" in p for p in params_list):
        for m, p in enumerate(params_list):
            if p["vq:nc"].device.type != "cpu":
                raise ValueError(f"vq:nc of member {m} must lie on the host")
        cap = max(int(p["vq:nc"].max()) for p in params_list)
    return max(1, min(cap, D))


def vector_topk_batched(plan: DevicePlan, col_sets: List[Tensors],
                        params_list: List[Tensors],
                        num_docs_list: List[torch.Tensor], idx: List[int],
                        D: int, batched: bool = True,
                        luts: Optional[Tensors] = None) -> torch.Tensor:
    """K8 over B members: the [B, S, 1 + 2 kk] float32 similarity top-K of
    the vector plan `plan` (kk = min(k_pad, D)), member m over column set
    idx[m] with its own query vector, K and probe cells
    (params_list[m]['vq:q' / 'vq:k' / 'vq:cells']) and residual filter
    parameters (`luts`: see _Launch); the lists are sized by `vector_cap`
    (each member's 'vq:nc')."""
    if plan.mode != "vector":
        raise ValueError("vector_topk takes vector plans")
    kk = min(plan.k_pad, D)
    if not 1 <= kk <= TOPN_MAX_K:
        raise ValueError(f"vector top-K {kk} outside [1, {TOPN_MAX_K}]")
    L = _Launch(plan, col_sets, params_list, num_docs_list, idx, D,
                torch.float32, luts)
    B, S, dev = L.B, L.S, L.device
    R = B * S
    if R > TOPN_MAX_ROWS:
        raise ValueError(f"{B} members x {S} segments exceed K8's "
                         f"{TOPN_MAX_ROWS} rows")
    nb = max(L.nb, min(MAX_BLOCKS_PER_SEGMENT, math.ceil(D / VECTOR_MIN_DOCS),
                       math.ceil(VECTOR_BLOCKS / R)))
    dp = plan.dim_pad
    if dp < 8 or dp & (dp - 1):
        raise ValueError(f"dim_pad {dp} is not a power of two >= 8")
    va = _VecArgs()
    va.a = L.args
    for u, cols in enumerate(col_sets):
        vec = cols["vec:" + plan.vec_col]
        _check(vec, f"vec:{plan.vec_col} of set {u}", dev, (torch.float32,),
               (S, D * dp))
        if vec.data_ptr() % 16:
            raise ValueError("the vector block must be 16-byte aligned")
        va.vec[u] = vec.data_ptr()
        if plan.ivf:
            cell = cols["vcell:" + plan.vec_col]
            _check(cell, f"vcell:{plan.vec_col} of set {u}", dev,
                   (torch.int32,), (S, D))
            va.cell[u] = cell.data_ptr()

    def member(key, dtype, shape):
        for m, p in enumerate(params_list):
            _check(p[key], f"{key} of member {m}", dev, (dtype,), shape)
        return _stack([p[key] for p in params_list]).contiguous()
    q = member("vq:q", torch.float32, (S, dp))
    kq = member("vq:k", torch.int32, (S,))
    cells, cells_pad = None, 0
    if plan.ivf:
        cells_pad = plan.cells_pad
        cells = member("vq:cells", torch.bool, (S, cells_pad))
    cap = vector_cap(params_list, D)
    lists = 2 if cap > vector_local_cap(kk) else 1
    keys = torch.empty((lists, R, cap), dtype=torch.int32, device=dev)
    docs = torch.empty((lists, R, cap), dtype=torch.int32, device=dev)
    state = torch.empty((R, TOPN_ROW_WORDS), dtype=torch.int64, device=dev)
    rk = R if lists == 2 else 1  # read only by the sift passes
    hist = torch.empty((rk, 256), dtype=torch.int32, device=dev)
    cand_key = torch.empty((rk, kk), dtype=torch.int32, device=dev)
    cand_doc = torch.empty((rk, kk), dtype=torch.int32, device=dev)
    out = torch.empty((B, S, 1 + 2 * kk), dtype=torch.float32, device=dev)
    rc = VECTOR_TOPK.fn()(
        ctypes.byref(va), L.pmat.data_ptr(), L.num_docs.data_ptr(),
        q.data_ptr(), kq.data_ptr(),
        None if cells is None else cells.data_ptr(), S, D, L.P, dp,
        cells_pad, nb, B, kk, cap, keys.data_ptr(), docs.data_ptr(),
        state.data_ptr(), hist.data_ptr(), cand_key.data_ptr(),
        cand_doc.data_ptr(), out.data_ptr(), dev.index, L.stream)
    if rc != 0:
        raise RuntimeError(f"vector_topk launch failed: cudaError {rc}")
    VECTOR_TOPK.count(B, batched)
    return out


def vector_topk(plan: DevicePlan, cols: Tensors, params: Tensors,
                num_docs: torch.Tensor, D: int,
                luts: Optional[Tensors] = None) -> torch.Tensor:
    """K8: the [S, 1 + 2 kk] float32 similarity top-K of the vector plan
    `plan` over one column set."""
    return vector_topk_batched(plan, [cols], [params], [num_docs], [0], D,
                               batched=False, luts=luts)[0]
