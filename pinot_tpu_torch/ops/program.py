"""Compile a DevicePlan into the int32 program the CUDA kernels interpret.

The JAX package traces one XLA program per plan under `jax.jit`
(pinot_tpu/ops/kernels.py:643 `compiled_kernel`). The port instead builds
its CUDA kernels once and hands them the plan as data: a small postfix
program over the filter tree, the value expressions and the aggregation
slots. One `nvcc` build then serves every plan.

Layout of `Program.code` (all int32; offsets are absolute indexes into it):

    header  [H_*]                       see the H_ constants below
    leaves  n_leaves x LEAF_W           (kind, col_a, col_b, param, lut)
    filters n_filters x (start, len)    postfix, 2 ints per instruction
    values  n_values  x (start, len)    postfix, 2 ints per instruction
    slots   n_slots   x SLOT_W          (op, value, filter, acc, n, out,
                                         c0, c1)
    gcols   n_gcols   x (col, stride)   dense mixed-radix group key, or
                                        the compact key block at stride 1
    accs    n_acc     x ACC_W           (reduction, out kind, out column)
    coldt   n_cols                      dtype code of each staged column
    lutc    n_luts                      width C of each [S, C] LUT
    instructions

Filter instructions: (F_LEAF, leaf) / (F_AND, 0) / (F_OR, 0) / (F_NOT, 0).
Value instructions:  (V_COL, col) / (V_IDS, col) / (V_LIT, param) /
(V_ADD|V_SUB|V_MUL|V_DIV|V_NEG, 0). V_IDS reads a staged dictId block
(i8/i16/i32) as a value, the order value of a top-N plan on a dictionary
column. Literals live in the per-segment parameter matrix after
the leaf bounds (replicated over segments), so the code itself holds only
ints.

A slot row: `value` is the value-expression index (-1: none), `filter`
the agg FILTER tree (-1: none), `n` the isum plane count, HLL log2m or
histogram bucket count, and `out` the slot's first column in the packed
ungrouped output. `acc` is a scalar slot's first accumulator word; for a
sketch slot, which has none, it is the byte offset of the slot's table in
K3's shared memory (a byte a HLL register, a uint32 word a histogram
bucket: `sketch_table_bytes`; each table 16-byte aligned), or -1 where the
tables before it leave no room under SKETCH_SMEM_BYTES (the slot then
updates its global uint32 table with atomics).
`c0`/`c1` are the HLL slot's valhi/vallo column indexes, or the histogram
slot's `hlo`/`hscale` parameter indexes.

Scalar slots (count ... isum) are K1's (csrc/scan_agg.cu); sketch slots
(S_HLL, S_HIST) are K3's (csrc/sketch_agg.cu), which also counts the
matched docs. A plan holding both launches both kernels into one output:
each writes its own slots' columns, and both write the same matched count.

A top-N plan (mode 'topn', K4 csrc/topn.cu) has no slots and at most one
value expression, the order value (none: the first docs in doc order); K4
takes `topn_k` and `topn_asc` as launch arguments. A vector plan (mode
'vector', K8 csrc/vector_topk.cu) has no slots and no value expression:
its program is the residual filter alone, which K8 evaluates at each
winner.

A compact-key plan (plan.group_compact, K2 only) has one gcols row, the
int32 `gkey` block at stride 1: each doc's key is one load of its
per-segment code (JAX kernels.py:488-491), and G comes with the launch.

The fused time bucket (plan.tbucket, K2 only): H_TBHI / H_TBLO are the
timestamp's valhi / vallo column indexes (-1: no bucket), H_TBPRM the
parameter index of the four consecutive cells tb:shi, tb:slo, tb:step,
tb:count, and H_TBPAD count_pad, the bucket digit's width. count_pad is the
only plan constant of the bucket: start, step and count are parameters, so
a window that slides keeps its program. The upsert validity mask is not in
the program: a launch passes each column set's `vmask` block pointer
(null: no mask) in `Args`.

A CLP leaf (kind 'clp', L_MASK) reads no column: its value is K7's match
mask (csrc/clp_match.cu), passed as the LUT `leaf<i>:mask` of width D and
read at the doc's own index, so each member of a batch reads its own mask
rows.

Filter index 0 is the main WHERE tree when the plan has one
(header H_MAIN = 0, else -1); agg FILTER trees follow. Each ungrouped
kernel accumulator word ("acc") is one double per thread: word 0 is the
matched count, then one word per scalar slot and one per isum plane. The
`accs` table says how the finalize pass reduces each word across blocks and
where it lands in the packed output — the JAX layout `[S, 1 + sum(w)]`
(kernels.py:574 `_pack_flat`), isum planes split into (hi, lo) 12-bit
halves. Grouped plans have one accumulator per slot and the `[S, G, slots]`
layout.
"""
from __future__ import annotations

import functools
import hashlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.ops.plan_ir import DevicePlan, is_grouped

# header slots
H_NLEAVES, H_NFILT, H_MAIN, H_NVAL, H_NSLOT, H_NACC, H_NGCOL, H_OUTW, \
    H_NPARAM, H_LEAF, H_FILT, H_VAL, H_SLOT, H_GCOL, H_ACC, H_NCOL, \
    H_COLDT, H_LUTC, H_LEN, H_TBHI, H_TBLO, H_TBPRM, H_TBPAD = range(23)
HEADER = 23

LEAF_W, SLOT_W, ACC_W = 5, 8, 3

# leaf kinds
L_RANGE, L_NEQ, L_LUT, L_VRANGE, L_VRANGE64, L_MASK = range(6)
_LEAF_KIND = {"range": L_RANGE, "neq": L_NEQ, "lut": L_LUT,
              "vrange": L_VRANGE, "vrange64": L_VRANGE64, "clp": L_MASK}
# filter ops
F_LEAF, F_AND, F_OR, F_NOT = range(4)
# value ops
V_COL, V_LIT, V_ADD, V_SUB, V_MUL, V_DIV, V_NEG, V_IDS = range(8)
_VALUE_OP = {"add": V_ADD, "sub": V_SUB, "mul": V_MUL, "div": V_DIV}
# slot ops
S_COUNT, S_SUM, S_SUMSQ, S_SUM3, S_SUM4, S_MIN, S_MAX, S_ISUM, S_ISUM_U, \
    S_HLL, S_HIST = range(11)
SKETCH_OPS = (S_HLL, S_HIST)
_SLOT_OP = {"count": S_COUNT, "sum": S_SUM, "sumsq": S_SUMSQ,
            "sum3": S_SUM3, "sum4": S_SUM4, "min": S_MIN, "max": S_MAX}
# accumulator reductions and output kinds
R_ADD, R_MIN, R_MAX = range(3)
O_SCALAR, O_PLANE = range(2)
# column dtype codes (order of csrc/interp.cuh `load_col`)
DTYPE_CODES = {"int8": 0, "int16": 1, "int32": 2, "float32": 3,
               "float64": 4}

#: limits the CUDA side is compiled with (csrc/interp.cuh)
MAX_CODE = 768
MAX_COLS = 32
MAX_LUTS = 16
MAX_PARAMS = 64
MAX_ACC = 64
MAX_FILTERS = 32
MAX_VALUES = 16
MAX_FILTER_DEPTH = 32
MAX_VALUE_DEPTH = 16

#: exact integer SUM: signed six-bit planes, or unsigned seven-bit planes
ISUM_PLANES = 6
ISUM_U_BITS = 7
#: HLL register counts and histogram widths K3 takes (csrc/sketch_agg.cu)
HLL_LOG2M_RANGE = (4, 16)
MAX_HIST_BUCKETS = 1 << 16
MAX_SKETCH_SLOTS = 8
#: bytes of K3's shared-memory sketch tables (csrc/sketch_agg.cu): a byte
#: an HLL register, a word a histogram bucket. 104 KB leaves two blocks an
#: SM of an H100 (228 KB) room for the rest of a block's shared memory, and
#: holds an HLL at log2m 16 (64 KB) beside one at log2m 12 (4 KB) and an
#: 8192-bucket histogram (32 KB); a second log2m-16 HLL goes to global
#: atomics
SKETCH_SMEM_BYTES = 104 * 1024


# ---------------------------------------------------------------------------
# codegen odometer: the port's counterpart of the JAX package's trace count
# (pinot_tpu/ops/kernels.py:46-85). The CUDA kernels are built once and take
# the batch's member count at run time; what a new plan costs is a program
# compiled here (a compile_plan cache miss). The dispatch ring meters the
# delta as `kernel_retrace`, so steady-state traffic over seen plans keeps
# it flat.
# ---------------------------------------------------------------------------
_trace_lock = threading.Lock()
_trace_count = 0
_trace_by_plan: Dict[str, int] = {}


def note_trace(plan_fp: str = "") -> None:
    global _trace_count
    with _trace_lock:
        _trace_count += 1
        if plan_fp:
            _trace_by_plan[plan_fp] = _trace_by_plan.get(plan_fp, 0) + 1


def trace_count() -> int:
    with _trace_lock:
        return _trace_count


def trace_count_by_plan() -> Dict[str, int]:
    """Codegens per plan fingerprint (a snapshot)."""
    with _trace_lock:
        return dict(_trace_by_plan)


@functools.lru_cache(maxsize=4096)
def plan_fingerprint(plan) -> str:
    """Short stable id of a plan's structure: the `plan` label of the
    kernel_retrace_by_plan meter (repr of the frozen dataclass)."""
    return hashlib.sha1(repr(plan).encode()).hexdigest()[:12]


@dataclass(frozen=True)
class Program:
    """A compiled plan. `code` still lacks the column dtype codes and the
    LUT widths, which depend on how a launch staged its blocks:
    `for_launch` fills them."""
    code: Tuple[int, ...]
    #: staged column names, in column-index order ('ids:x', 'val:y', ...)
    cols: Tuple[str, ...]
    #: LUT parameter keys, in lut-index order ('leaf3:lut', ...)
    luts: Tuple[str, ...]
    #: per-segment parameter matrix columns: (param key, None) or
    #: (None, literal value)
    params: Tuple[Tuple[Optional[str], Optional[float]], ...]
    n_acc: int
    out_width: int
    #: bytes of K3's shared-memory tables (0: no sketch slot there)
    sketch_smem_bytes: int = 0

    def for_launch(self, dtypes: List[str],
                   lut_widths: List[int]) -> np.ndarray:
        code = np.array(self.code, dtype=np.int32)
        off = code[H_COLDT]
        code[off:off + len(dtypes)] = [DTYPE_CODES[d] for d in dtypes]
        off = code[H_LUTC]
        code[off:off + len(lut_widths)] = lut_widths
        return code


def is_sketch(op: str) -> bool:
    """A K3 slot: HLL registers or histogram buckets."""
    return op.startswith(("hll:", "hist:"))


def sketch_table_bytes(op: str) -> int:
    """Bytes of a sketch slot's table in K3's shared memory: a byte an HLL
    register (a rank is at most 33), a uint32 word a histogram bucket."""
    return slot_width(op) * (1 if op.startswith("hll:") else 4)


def slot_width(op: str) -> int:
    """Output width of a slot in the ungrouped packed layout: 2^log2m HLL
    registers ('hll:<log2m>[:<col>]'), B histogram buckets ('hist:<B>'),
    two halves per exact-sum plane, else 1."""
    if op.startswith("hll:"):
        return 1 << int(op.split(":")[1])
    if op.startswith("hist:"):
        return int(op.split(":")[1])
    if op == "isum":
        return 2 * ISUM_PLANES
    if op.startswith("isum:u"):
        return 2 * int(op.split(":")[1][1:])
    return 1


@functools.lru_cache(maxsize=256)
def compile_plan(plan: DevicePlan) -> Program:
    if plan.mode == "topn":
        if plan.agg_ops or is_grouped(plan) or len(plan.value_irs) > 1 \
                or plan.topn_k < 1:
            raise ValueError("a top-N plan takes no slots or groups, at "
                             "most one order value and k >= 1")
    elif plan.mode == "vector":
        if plan.agg_ops or is_grouped(plan) or plan.value_irs \
                or plan.k_pad < 1 or plan.dim_pad < 8:
            raise ValueError("a vector plan takes no slots, groups or "
                             "values, k_pad >= 1 and dim_pad >= 8")
    elif plan.mode != "agg":
        raise ValueError(f"plan mode {plan.mode!r} is not in this port")
    grouped = is_grouped(plan)
    cols: List[str] = []
    luts: List[str] = []
    params: List[Tuple[Optional[str], Optional[float]]] = []

    def col(name: str) -> int:
        if name not in cols:
            cols.append(name)
        return cols.index(name)

    leaves = []
    for i, leaf in enumerate(plan.leaves):
        kind = _LEAF_KIND.get(leaf.kind)
        if kind is None:
            raise ValueError(f"leaf kind {leaf.kind!r} is not in this port")
        a = b = lut = 0
        p = len(params)
        if kind in (L_RANGE, L_NEQ, L_LUT):
            a = col("ids:" + leaf.column)
        elif kind == L_VRANGE:
            a = col("val:" + leaf.column)
        elif kind == L_VRANGE64:
            a = col("valhi:" + leaf.column)
            b = col("vallo:" + leaf.column)
        names = {L_RANGE: ("lo", "hi"), L_NEQ: ("idx",), L_LUT: (),
                 L_VRANGE: ("lo", "hi"),
                 L_VRANGE64: ("lohi", "lolo", "hihi", "hilo"),
                 L_MASK: ()}[kind]
        params += [(f"leaf{i}:{n}", None) for n in names]
        if kind in (L_LUT, L_MASK):
            lut = len(luts)
            luts.append(f"leaf{i}:lut" if kind == L_LUT else f"leaf{i}:mask")
        leaves.append((kind, a, b, p, lut))

    instr: List[Tuple[int, int]] = []

    def emit_filter(node, depth: int) -> int:
        """Postfix-emit a filter tree; returns the stack depth it needs."""
        op = node[0]
        if op == "leaf":
            instr.append((F_LEAF, node[1]))
            return depth + 1
        if op == "not":
            need = emit_filter(node[1], depth)
            instr.append((F_NOT, 0))
            return need
        if op not in ("and", "or"):
            raise ValueError(f"unknown filter op {op!r}")
        need = emit_filter(node[1], depth)
        for child in node[2:]:
            need = max(need, emit_filter(child, depth + 1))
            instr.append((F_AND if op == "and" else F_OR, 0))
        return need

    def emit_value(ir, depth: int) -> int:
        op = ir[0]
        if op == "col":
            instr.append((V_COL, col("val:" + ir[1])))
            return depth + 1
        if op == "ids":
            instr.append((V_IDS, col("ids:" + ir[1])))
            return depth + 1
        if op == "lit":
            instr.append((V_LIT, len(params)))
            params.append((None, float(ir[1])))
            return depth + 1
        if op == "neg":
            need = emit_value(ir[1], depth)
            instr.append((V_NEG, 0))
            return need
        if op not in _VALUE_OP:
            raise ValueError(f"unknown value ir op {op!r}")
        need = max(emit_value(ir[1], depth), emit_value(ir[2], depth + 1))
        instr.append((_VALUE_OP[op], 0))
        return need

    filter_trees = ([plan.filter_ir] if plan.filter_ir is not None else []) \
        + list(plan.agg_filter_irs)
    agg_base = 1 if plan.filter_ir is not None else 0
    filters = []
    for tree in filter_trees:
        start = len(instr)
        if emit_filter(tree, 0) > MAX_FILTER_DEPTH:
            raise ValueError("filter tree too deep for the device program")
        filters.append((start, len(instr) - start))
    values = []
    for ir in plan.value_irs:
        start = len(instr)
        if ir is not None and emit_value(ir, 0) > MAX_VALUE_DEPTH:
            raise ValueError("value expression too deep for the device "
                             "program")
        values.append((start, len(instr) - start))

    slots, accs = [], []
    smem = 0
    out_col = 0 if grouped else 1
    if not grouped:
        accs.append((R_ADD, O_SCALAR, 0))   # matched count
    for j, (op, vidx, fidx) in enumerate(plan.agg_ops):
        f = -1 if fidx is None else agg_base + fidx
        v = -1 if vidx is None else vidx
        acc = len(accs)
        if is_sketch(op):
            if grouped:
                raise ValueError("sketch slots are ungrouped only")
            width = slot_width(op)
            nbytes = sketch_table_bytes(op)
            sm = smem if smem + nbytes <= SKETCH_SMEM_BYTES else -1
            smem += -(-nbytes // 16) * 16 if sm >= 0 else 0
            if op.startswith("hll:"):
                _, log2m, column = op.split(":", 2)
                lo_m, hi_m = HLL_LOG2M_RANGE
                if not lo_m <= int(log2m) <= hi_m:
                    raise ValueError(f"HLL log2m {log2m} outside "
                                     f"[{lo_m}, {hi_m}]")
                slots.append((S_HLL, -1, f, sm, int(log2m), out_col,
                              col("valhi:" + column),
                              col("vallo:" + column)))
            else:
                if not 1 <= width <= MAX_HIST_BUCKETS or vidx is None:
                    raise ValueError(f"histogram slot {op!r} out of range")
                p = len(params)
                params += [(f"slot{j}:hlo", None), (f"slot{j}:hscale", None)]
                slots.append((S_HIST, v, f, sm, width, out_col, p, p + 1))
            out_col += width
            continue
        if op == "isum" or op.startswith("isum:u"):
            if grouped:
                raise ValueError("exact-sum slots are ungrouped only")
            signed = op == "isum"
            planes = ISUM_PLANES if signed else int(op.split(":")[1][1:])
            slots.append((S_ISUM if signed else S_ISUM_U, v, f, acc, planes,
                          out_col, 0, 0))
            for k in range(planes):
                accs.append((R_ADD, O_PLANE, out_col + 2 * k))
            out_col += 2 * planes
            continue
        code = _SLOT_OP.get(op)
        if code is None:
            raise ValueError(f"slot op {op!r} is not in this port")
        red = {S_MIN: R_MIN, S_MAX: R_MAX}.get(code, R_ADD)
        slots.append((code, v, f, acc, 0, out_col, 0, 0))
        accs.append((red, O_SCALAR, out_col))
        out_col += 1
    n_sketch = sum(1 for sl in slots if sl[0] in SKETCH_OPS)

    if plan.group_compact:
        if plan.num_groups or plan.group_strides:
            raise ValueError("a compact-key plan has no dense key space")
        gcols = [(col("gkey"), 1)]
    else:
        gcols = [(col("ids:" + c), s)
                 for c, s in zip(plan.group_cols, plan.group_strides)]
    tb_hi = tb_lo = tb_prm = -1
    tb_pad = 0
    if plan.tbucket:
        if not plan.num_groups:
            raise ValueError("a time bucket needs a dense group-by plan")
        tcol, tb_pad = plan.tbucket
        tb_hi, tb_lo = col("valhi:" + tcol), col("vallo:" + tcol)
        tb_prm = len(params)
        params += [(f"tb:{n}", None) for n in ("shi", "slo", "step",
                                               "count")]

    checks = ((len(cols), MAX_COLS, "staged columns"),
              (len(luts), MAX_LUTS, "LUT leaves"),
              (len(params), MAX_PARAMS, "leaf bounds and literals"),
              (len(accs), MAX_ACC, "accumulator words"),
              (len(filters), MAX_FILTERS, "filter trees"),
              (len(values), MAX_VALUES, "value expressions"),
              (n_sketch, MAX_SKETCH_SLOTS, "sketch slots"))
    for n, cap, what in checks:
        if n > cap:
            raise ValueError(f"{n} {what} exceed the device program's {cap}")

    code: List[int] = [0] * HEADER
    sections = {}
    for name, rows in (("leaf", leaves), ("filt", filters), ("val", values),
                       ("slot", slots), ("gcol", gcols), ("acc", accs)):
        sections[name] = len(code)
        for row in rows:
            code.extend(row)
    sections["coldt"] = len(code)
    code.extend([0] * len(cols))
    sections["lutc"] = len(code)
    code.extend([0] * len(luts))
    ibase = len(code)
    for op, arg in instr:
        code.extend((op, arg))
    # instruction starts were recorded relative to the instruction list
    for name, table in (("filt", filters), ("val", values)):
        off = sections[name]
        for k, (start, n) in enumerate(table):
            code[off + 2 * k] = ibase + 2 * start
            code[off + 2 * k + 1] = n
    if len(code) > MAX_CODE:
        raise ValueError(f"device program of {len(code)} ints exceeds "
                         f"{MAX_CODE}")
    code[H_NLEAVES] = len(leaves)
    code[H_NFILT] = len(filters)
    code[H_MAIN] = 0 if plan.filter_ir is not None else -1
    code[H_NVAL] = len(values)
    code[H_NSLOT] = len(slots)
    code[H_NACC] = len(accs)
    code[H_NGCOL] = len(gcols)
    code[H_OUTW] = len(plan.agg_ops) if grouped else out_col
    code[H_NPARAM] = len(params)
    code[H_LEAF], code[H_FILT], code[H_VAL] = (
        sections["leaf"], sections["filt"], sections["val"])
    code[H_SLOT], code[H_GCOL], code[H_ACC] = (
        sections["slot"], sections["gcol"], sections["acc"])
    code[H_NCOL] = len(cols)
    code[H_COLDT] = sections["coldt"]
    code[H_LUTC] = sections["lutc"]
    code[H_LEN] = len(code)
    code[H_TBHI], code[H_TBLO], code[H_TBPRM], code[H_TBPAD] = (
        tb_hi, tb_lo, tb_prm, tb_pad)
    note_trace(plan_fingerprint(plan))
    return Program(code=tuple(code), cols=tuple(cols), luts=tuple(luts),
                   params=tuple(params), n_acc=len(accs),
                   out_width=code[H_OUTW], sketch_smem_bytes=smem)
