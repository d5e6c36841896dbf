"""Build, bind and launch the hand-written CUDA kernels.

K1 `scan_agg` (csrc/scan_agg.cu), K2 `group_agg` (csrc/group_agg.cu),
K3 `sketch_agg` (csrc/sketch_agg.cu), K4 `topn` (csrc/topn.cu) and K5
`startree_agg` (csrc/startree_agg.cu) are plain-C-interface shared libraries
built with `nvcc` for sm_90a at first use, into the git-ignored
`build/kernels/` directory beside the package, and loaded with ctypes. All
sources build at once, one `nvcc` each, in parallel. A library's file name carries a hash of its sources and flags, so
an edited source rebuilds and an unchanged one is reused.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate outputs and scratch with `torch.empty`, launch on the
current stream, raise if the launch failed, and count their launches. They
never fall back to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import torch

from pinot_tpu_torch.ops import program as prog_mod
from pinot_tpu_torch.ops.plan_ir import DevicePlan

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
#: <repo>/build/kernels — listed in .gitignore
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
THREADS = 256
#: each thread of K1/K2 walks about this many docs of its segment
DOCS_PER_THREAD = 32
MAX_BLOCKS_PER_SEGMENT = 1024
#: K3's grid: about this many blocks over the launch (8 per SM of an H100),
#: each over at least SKETCH_MIN_DOCS docs of its segment, so a block's
#: table write-out stays small beside its scan
SKETCH_BLOCKS = 1056
SKETCH_MIN_DOCS = 1 << 16
#: K4 sorts its k candidates in one block's shared memory (csrc/topn.cu)
TOPN_MAX_K = 8192
#: K4's per-segment state words (csrc/topn.cu ST_*)
TOPN_STATE_WORDS = 5
#: K5's slot and group-dimension capacity (csrc/startree_agg.cu ST_MAX_*)
ST_MAX_SLOTS = 16
ST_MAX_DIMS = 8
#: planes of 7 bits per 24-bit digit of a K5 exact-sum (usum) slot
USUM_PLANES = 4
#: K5's accumulator columns: the record count, 2 * USUM_PLANES per usum
#: slot, one per float slot
ST_MAX_ACC = 1 + 2 * USUM_PLANES * ST_MAX_SLOTS


class _Args(ctypes.Structure):
    """csrc/interp.cuh `struct Args`, passed to the kernel by value."""
    _fields_ = [("cols", ctypes.c_void_p * prog_mod.MAX_COLS),
                ("luts", ctypes.c_void_p * prog_mod.MAX_LUTS),
                ("code", ctypes.c_int * prog_mod.MAX_CODE)]


class _StArgs(ctypes.Structure):
    """csrc/startree_agg.cu `struct StArgs`, passed to the kernel by value."""
    _fields_ = [("a", ctypes.c_void_p * ST_MAX_SLOTS),
                ("b", ctypes.c_void_p * ST_MAX_SLOTS),
                ("op", ctypes.c_int * ST_MAX_SLOTS),
                ("gid", ctypes.c_void_p * ST_MAX_DIMS),
                ("stride", ctypes.c_int * ST_MAX_DIMS),
                ("acc_op", ctypes.c_int * ST_MAX_ACC),
                ("acc_out", ctypes.c_int * ST_MAX_ACC),
                ("nslot", ctypes.c_int), ("ndim", ctypes.c_int)]


class CudaKernel:
    """One hand-written kernel: its source, its entry point and the number
    of times it was launched."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def library(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (self.source, "interp.cuh"):
            with open(os.path.join(_CSRC, f), "rb") as fh:
                h.update(fh.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def fn(self):
        if self._fn is None:
            build([self])
            lib = ctypes.CDLL(self.library)
            f = getattr(lib, self.entry)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn


_P, _I = ctypes.c_void_p, ctypes.c_int
SCAN_AGG = CudaKernel("scan_agg", "scan_agg.cu", "pt_scan_agg",
                      [ctypes.POINTER(_Args), _P, _P, _I, _I, _I, _I, _I, _P,
                       _P, _I, _P])
GROUP_AGG = CudaKernel("group_agg", "group_agg.cu", "pt_group_agg",
                       [ctypes.POINTER(_Args), _P, _P, _I, _I, _I, _I, _I, _I,
                        _P, _P, _I, _P])
SKETCH_AGG = CudaKernel("sketch_agg", "sketch_agg.cu", "pt_sketch_agg",
                        [ctypes.POINTER(_Args), _P, _P, _I, _I, _I, _I, _I,
                         _I, _P, _P, _P, _I, _P])
TOPN = CudaKernel("topn", "topn.cu", "pt_topn",
                  [ctypes.POINTER(_Args), _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P, _P, _I, _P])
STARTREE_AGG = CudaKernel("startree_agg", "startree_agg.cu",
                          "pt_startree_agg",
                          [ctypes.POINTER(_StArgs), _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P, _P, _I, _P])
KERNELS = (SCAN_AGG, GROUP_AGG, SKETCH_AGG, TOPN, STARTREE_AGG)

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


def _prepare(plan: DevicePlan, cols: Dict[str, torch.Tensor],
             params: Dict[str, torch.Tensor], num_docs: torch.Tensor,
             D: int, value_dtype: torch.dtype):
    """Validate a launch and pack its arguments: the ctypes Args struct
    (column and LUT pointers, program), the [S, P] float64 parameter matrix
    and the program."""
    device = num_docs.device
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {device}")
    if value_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"value dtype {value_dtype} is not float32/64")
    if num_docs.dim() != 1:
        raise ValueError("num_docs must be 1-D")
    S = num_docs.shape[0]
    _check(num_docs, "num_docs", device, (torch.int32,), (S,))
    if D <= 0 or D > (1 << 30):
        raise ValueError(f"doc block width {D} out of range")
    prog = prog_mod.compile_plan(plan)
    args = _Args()
    dtypes = []
    for c, name in enumerate(prog.cols):
        t = cols[name]
        _check(t, name, device, _COL_DTYPES, (S, D))
        args.cols[c] = t.data_ptr()
        dtypes.append(str(t.dtype).replace("torch.", ""))
    widths = []
    for k, key in enumerate(prog.luts):
        t = params[key]
        if t.dim() != 2:
            raise ValueError(f"{key} must be [S, C]")
        _check(t, key, device, (torch.bool,), (S, t.shape[1]))
        args.luts[k] = t.data_ptr()
        widths.append(int(t.shape[1]))
    code = prog.for_launch(dtypes, widths)
    ctypes.memmove(args.code, code.ctypes.data, code.nbytes)
    columns = []
    for key, lit in prog.params:
        if key is None:
            columns.append(torch.full((S,), lit, dtype=torch.float64,
                                      device=device))
            continue
        t = params[key]
        if t.device != device or tuple(t.shape) != (S,):
            raise ValueError(f"{key} must be a [S] tensor on {device}")
        columns.append(t.to(torch.float64))
    if not columns:
        columns.append(torch.zeros(S, dtype=torch.float64, device=device))
    pmat = torch.stack(columns, 1).contiguous()
    nb = max(1, min(MAX_BLOCKS_PER_SEGMENT,
                    math.ceil(D / (THREADS * DOCS_PER_THREAD))))
    return args, pmat, prog, S, nb


def scan_agg(plan: DevicePlan, cols: Dict[str, torch.Tensor],
             params: Dict[str, torch.Tensor], num_docs: torch.Tensor, D: int,
             value_dtype: torch.dtype) -> torch.Tensor:
    """K1: the ungrouped packed [S, 1 + sum(w)] result of `plan`."""
    if plan.num_groups:
        raise ValueError("scan_agg takes ungrouped plans")
    args, pmat, prog, S, nb = _prepare(plan, cols, params, num_docs, D,
                                       value_dtype)
    device = num_docs.device
    partial = torch.empty((S, nb, prog.n_acc), dtype=torch.float64,
                          device=device)
    out = torch.empty((S, prog.out_width), dtype=value_dtype, device=device)
    fn = SCAN_AGG.fn()
    rc = fn(ctypes.byref(args), pmat.data_ptr(), num_docs.data_ptr(), S,
                D, pmat.shape[1], nb, int(value_dtype == torch.float64),
                partial.data_ptr(), out.data_ptr(), device.index,
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scan_agg launch failed: cudaError {rc}")
    SCAN_AGG.launches += 1
    return out


def group_agg(plan: DevicePlan, cols: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor], num_docs: torch.Tensor,
              D: int, value_dtype: torch.dtype) -> torch.Tensor:
    """K2: the grouped packed [S, G, n_slots] result of `plan`."""
    G = plan.num_groups
    if not G:
        raise ValueError("group_agg takes group-by plans")
    args, pmat, prog, S, nb = _prepare(plan, cols, params, num_docs, D,
                                       value_dtype)
    device = num_docs.device
    shape = (S, G, prog.out_width)
    table = torch.empty(shape, dtype=torch.float64, device=device)
    out = torch.empty(shape, dtype=value_dtype, device=device)
    fn = GROUP_AGG.fn()
    rc = fn(ctypes.byref(args), pmat.data_ptr(), num_docs.data_ptr(), S,
                D, pmat.shape[1], G, nb, int(value_dtype == torch.float64),
                table.data_ptr(), out.data_ptr(), device.index,
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group_agg launch failed: cudaError {rc}")
    GROUP_AGG.launches += 1
    return out


def sketch_agg(plan: DevicePlan, cols: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], num_docs: torch.Tensor,
               D: int, value_dtype: torch.dtype,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: the matched count and the sketch slots' columns of the packed
    [S, 1 + sum(w)] result of `plan`, written into `out` (K1's output, on
    the same stream, for a plan that also has scalar slots) or into a new
    tensor."""
    if plan.num_groups:
        raise ValueError("sketch_agg takes ungrouped plans")
    args, pmat, prog, S, _nb = _prepare(plan, cols, params, num_docs, D,
                                        value_dtype)
    device = num_docs.device
    for op, _v, _f in plan.agg_ops:
        if op.startswith("hll:"):
            col = op.split(":", 2)[2]
            for plane in ("valhi:", "vallo:"):
                _check(cols[plane + col], plane + col, device,
                       (torch.int32,), (S, D))
    shape = (S, prog.out_width)
    if out is None:
        out = torch.empty(shape, dtype=value_dtype, device=device)
    else:
        _check(out, "out", device, (value_dtype,), shape)
    nb = max(1, min(math.ceil(SKETCH_BLOCKS / S),
                    math.ceil(D / SKETCH_MIN_DOCS)))
    words = prog.sketch_smem_words
    partial = torch.empty(max(1, S * nb * words), dtype=torch.int32,
                          device=device)
    gtab = torch.empty(shape, dtype=torch.int32, device=device)
    fn = SKETCH_AGG.fn()
    rc = fn(ctypes.byref(args), pmat.data_ptr(), num_docs.data_ptr(), S, D,
            pmat.shape[1], nb, words, int(value_dtype == torch.float64),
            partial.data_ptr(), gtab.data_ptr(), out.data_ptr(),
            device.index, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sketch_agg launch failed: cudaError {rc}")
    SKETCH_AGG.launches += 1
    return out


def topn(plan: DevicePlan, cols: Dict[str, torch.Tensor],
         params: Dict[str, torch.Tensor], num_docs: torch.Tensor, D: int,
         value_dtype: torch.dtype) -> torch.Tensor:
    """K4: the [S, 1 + k] int32 top-N of `plan`, k = min(topn_k, D)."""
    if plan.mode != "topn":
        raise ValueError("topn takes top-N plans")
    k = min(plan.topn_k, D)
    if not 1 <= k <= TOPN_MAX_K:
        raise ValueError(f"top-N k {k} outside [1, {TOPN_MAX_K}]")
    args, pmat, _prog, S, nb = _prepare(plan, cols, params, num_docs, D,
                                        value_dtype)
    device = num_docs.device
    kdt = torch.int64 if value_dtype == torch.float64 else torch.int32
    keys = torch.empty((S, D), dtype=kdt, device=device)
    state = torch.empty((S, TOPN_STATE_WORDS), dtype=torch.int64,
                        device=device)
    hist = torch.empty((S, 256), dtype=torch.int32, device=device)
    ties = torch.empty((S, nb), dtype=torch.int32, device=device)
    cand_key = torch.empty((S, k), dtype=kdt, device=device)
    cand_doc = torch.empty((S, k), dtype=torch.int32, device=device)
    out = torch.empty((S, 1 + k), dtype=torch.int32, device=device)
    fn = TOPN.fn()
    rc = fn(ctypes.byref(args), pmat.data_ptr(), num_docs.data_ptr(), S, D,
            pmat.shape[1], nb, int(value_dtype == torch.float64), k,
            int(plan.topn_asc), keys.data_ptr(), state.data_ptr(),
            hist.data_ptr(), ties.data_ptr(), cand_key.data_ptr(),
            cand_doc.data_ptr(), out.data_ptr(), device.index,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"topn launch failed: cudaError {rc}")
    TOPN.launches += 1
    return out


#: K5 slot op codes (csrc/startree_agg.cu OP_*)
_ST_OPS = {"usum": 0, "sum": 1, "min": 2, "max": 3}


def startree_agg(plan, cols: Dict[str, torch.Tensor],
                 params: Dict[str, torch.Tensor], num_docs: torch.Tensor,
                 D: int, value_dtype: torch.dtype) -> torch.Tensor:
    """K5: the packed star-tree residual aggregation of `plan` (an
    ops/startree_device.StarTreePlan): [S, 1 + sum(w)] flat or
    [S, G, 1 + sum(w)] grouped, in the value dtype."""
    device = num_docs.device
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {device}")
    if value_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"value dtype {value_dtype} is not float32/64")
    if num_docs.dim() != 1:
        raise ValueError("num_docs must be 1-D")
    S = num_docs.shape[0]
    _check(num_docs, "num_docs", device, (torch.int32,), (S,))
    if D <= 0 or D > (1 << 30):
        raise ValueError(f"record block width {D} out of range")
    if len(plan.slots) > ST_MAX_SLOTS or len(plan.group_dims) > ST_MAX_DIMS:
        raise ValueError(f"star-tree plan beyond {ST_MAX_SLOTS} slots or "
                         f"{ST_MAX_DIMS} group dims")
    sel = params["sel"]
    _check(sel, "sel", device, (torch.bool,), (S, D))
    args = _StArgs()
    args.nslot, args.ndim = len(plan.slots), len(plan.group_dims)
    A, W = 1, 1  # accumulator and output columns; column 0 is the count
    args.acc_op[0], args.acc_out[0] = _ST_OPS["sum"], 0
    for j, (op, name) in enumerate(plan.slots):
        if op not in _ST_OPS:
            raise ValueError(f"unknown star-tree slot op {op!r}")
        args.op[j] = _ST_OPS[op]
        if op == "usum":
            for field, key in (("a", "sthi:"), ("b", "stlo:")):
                t = cols[key + name]
                _check(t, key + name, device, (torch.int32,), (S, D))
                getattr(args, field)[j] = t.data_ptr()
            for p in range(2 * USUM_PLANES):
                args.acc_op[A + p] = _ST_OPS["usum"]
                args.acc_out[A + p] = W + 2 * p
            A += 2 * USUM_PLANES
            W += 4 * USUM_PLANES
        else:
            t = cols["stval:" + name]
            _check(t, "stval:" + name, device, (value_dtype,), (S, D))
            args.a[j] = t.data_ptr()
            args.acc_op[A], args.acc_out[A] = _ST_OPS[op], W
            A += 1
            W += 1
    for g, (dim, stride) in enumerate(zip(plan.group_dims,
                                          plan.group_strides)):
        t = cols["stid:" + dim]
        _check(t, "stid:" + dim, device, (torch.int32,), (S, D))
        args.gid[g] = t.data_ptr()
        args.stride[g] = stride
    G = plan.num_groups
    nb = max(1, min(MAX_BLOCKS_PER_SEGMENT,
                    math.ceil(D / (THREADS * DOCS_PER_THREAD))))
    if G:
        scratch = torch.empty((S, G, A), dtype=torch.float64, device=device)
        out = torch.empty((S, G, W), dtype=value_dtype, device=device)
    else:
        scratch = torch.empty((S, nb, A), dtype=torch.float64, device=device)
        out = torch.empty((S, W), dtype=value_dtype, device=device)
    fn = STARTREE_AGG.fn()
    rc = fn(ctypes.byref(args), sel.data_ptr(), num_docs.data_ptr(), S, D,
            G, nb, A, W, int(value_dtype == torch.float64),
            scratch.data_ptr(), out.data_ptr(), device.index,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"startree_agg launch failed: cudaError {rc}")
    STARTREE_AGG.launches += 1
    return out
