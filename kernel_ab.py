#!/usr/bin/env python3
"""K1-K5's and K7-K9's phase-3, 3b and 3c launch times and the main
path's single-query p50 of two checkouts, in turns, on one card.

    python3 kernel_ab.py PARENT_DIR CHANGE_DIR [--seed N] [--iters N]
                         [--no-queries] [--splits] [--logs] [--vector]
                         [--only REGEX]

Runs the turns parent / change / change / parent, each in a fresh process
whose working directory is that checkout: it builds the checkout's CUDA
kernels (pinot_tpu_torch/ops/_cuda.py `build`), makes chip_smoke.py's
phase-3 and 3b inputs with that checkout's generators and times each
case's launch by CUDA events (chip_smoke `cuda_ms`, median of --iters):
K1 and K2's dense case (`kernel_inputs`), K2's time-bucket cases ts.3
and ts.1 (`bucket_kernel_inputs`) and its compact cases
(`compact_kernel_inputs` over COMPACT_CASES), K2's B = 8 broadcast forms
(the dense case over `batched_inputs`' first column set, ts.3 with member
m's window m hours later, each compact case with member m excluding
phrase id m), K3 (`sketch_kernel_inputs`; "sketch_agg split ...": the
same inputs with the plan cut to each sketch slot alone, HLL log2m 12,
log2m 16 and the histogram, with and without the filter, and all three
without it; "sketch_agg x8": its B = 8 broadcast form), K4's cases (a)-(d)
(`topn_kernel_inputs`; "topn" is case (a), the kernels line's) and K4's
B = 8 broadcast form of case (a), K1 under phase 3's validity mask
(`with_mask`), K1 on a plan at program.py's limits together on phase 3's
scan columns ("scan_agg widest": 64 accumulator words, 32 filter trees,
the filter 32 and a value 16 deep), K1's B = 8 broadcast, stacked and
dedup forms (`batched_inputs`), K7's mode 'a', mode 'b' and B = 8 cases
(`clp_kernel_inputs`), K8's phase-3 cases and phase 3b's B = 8 forms
(`vector_case` over `vector_block`: K8_CASES, K8_BATCHED), K5's three
phase-3 cases (`startree_kernel_inputs`), each also by its device time a
call in a torch.profiler trace ("... device") and by the host clock a
call over 200 calls back to back ("... wall"), the same three times of
one empty kernel launched through a wrapper ("empty launch":
`_cuda.empty_launch`, where the checkout has it), K9's phase-3c cases
("mesh_fold ...": the CHANGE checkout's chip_smoke `mesh_fold_cases`,
each fold built by the turn's own `doc_fold` / `merged_plan` and checked
bit for bit against the turn's plain version; by events and by device
time a call), and K6 against
`torch.stack` on phase 3's full float32 rows (`RA_S` x `RA_D`), in turns
within the process; --only times only the cases whose names it finds,
and builds a query leg below only where it finds the leg's table (ssb,
ssbgb, taxi, ssbst) or a case timed on the leg's staging. The first
turn of each checkout also prints `nvcc -Xptxas -v`'s registers,
spills and stack per kernel function of K1-K9, the atomic
instructions each function of K2 and K4 compiled to, and the constant
loads at a register
offset (LDC ...c[..][R..]) and local loads and stores (LDL, STL) in each
function of K1 and K7 (`cuobjdump -sass`). Then (unless
--no-queries) each turn builds chip_smoke.py's legs of phases 4-7 with
that checkout's generators and creator — SSB Q1 at 16 x 8M rows, the
config-#3 group-by at 8 x 4M, config #4 at 64 x 8M, config #5's
star-tree table at 8 x 4M — and takes
each leg query's p50 over 20 warm runs alone through its QueryExecutor
(chip_smoke `time_query`; host clock, the result on the host); with
--splits each turn also records each query's median host-clock stage
split (`stage_ms`: parse, plan, stage, kernel_fetch, assemble, reduce).
Each such turn also times K3 alone on the engine's own staging of q4.1
and q4.3 (64 x 2^23) and K5 alone on the blocks it stages for st5.1 and
for eight 9f pool queries in one broadcast launch (chip_smoke
`staged_startree`, `staged_startree_batch`), K5 by its three times as
above.
With --logs, the log leg's segments (phase 11's, 16 x 2^22 lines) are
built once before the turns, and each turn also takes logs.1-logs.6's
p50 (each held to its numpy truth) and runs phase 9h's windows (8
clients over LOG_POOL, serialized and pipelined: their QPS). With
--vector, the vector leg's segments (phase 12's vec and vecx tables) are
built once before the turns, and each turn also takes vec.1-vec.4's p50
(each held to its host search) and runs phase 9i's windows (8 clients
over VEC_POOL: their QPS), and times K8 alone on the engine's staging
of vec.1 and vec.4 (chip_smoke `staged_vector`).
One JSON line per turn, then the change's time over the parent's per
kernel and per query (the mean of its two turns over theirs), beside the
card's name and power limit. Needs a CUDA card; builds the kernels into each
checkout's git-ignored build/kernels/ and the segments into a temporary
directory.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

TURN = r"""
import json, os, re, subprocess, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from pinot_tpu_torch.ops import _cuda, kernels
seed, iters, ptxas = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "1"
queries = sys.argv[4] == "1"
splits = sys.argv[5] == "1"
logs = sys.argv[6]
vector = sys.argv[7]
only = re.compile(sys.argv[8])
change_smoke = sys.argv[9]
trace_dir = tempfile.TemporaryDirectory(prefix="kernel_ab_trace_")
_cuda.build()
out = {}
if ptxas:
    regs = {}
    for k in (_cuda.SCAN_AGG, _cuda.GROUP_AGG, _cuda.SKETCH_AGG, _cuda.TOPN,
              _cuda.STARTREE_AGG, _cuda.ROW_ASSEMBLE, _cuda.CLP_MATCH,
              _cuda.VECTOR_TOPK, _cuda.MESH_FOLD):
        flags = [f for f in _cuda.NVCC_FLAGS if f != "-shared"]
        r = subprocess.run([_cuda.nvcc(), *flags, "-c", "-Xptxas", "-v",
                            "-o", os.devnull,
                            os.path.join(_cuda._CSRC, k.source)],
                           capture_output=True, text=True)
        fn = None
        for line in (r.stdout + r.stderr).splitlines():
            # a device function's properties (a __noinline__ callee's) come
            # under its own name, not the kernel's
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)'?", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and fn:
                regs.setdefault(fn, {}).update(
                    stack=int(m.group(1)), spill_stores=int(m.group(2)),
                    spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                regs.setdefault(fn, {})["registers"] = int(m.group(1))
    out["ptxas"] = regs
    # the atomic instructions each K2 / K4 function compiled to
    # (cuobjdump -sass: a shared-memory CAS loop shows as ATOMS.CAS*)
    cuobj = os.path.join(os.path.dirname(_cuda.nvcc()), "cuobjdump")
    sass = {}
    for k in (_cuda.GROUP_AGG, _cuda.TOPN):
        r = subprocess.run([cuobj, "-sass", k.library], capture_output=True,
                           text=True)
        fn = None
        for line in r.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)",
                          line)
            if m and fn:
                ops = sass.setdefault(fn, {})
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    out["sass_atomics"] = sass
    # K1's and K7's constant loads at a register offset (a run-time index
    # into the argument struct, serialized where it differs across a
    # warp's lanes) and local-memory loads and stores
    sass = {}
    for k in (_cuda.SCAN_AGG, _cuda.CLP_MATCH):
        r = subprocess.run([cuobj, "-sass", k.library], capture_output=True,
                           text=True)
        fn = None
        for line in r.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                sass.setdefault(fn, {"LDC[R]": 0, "LDL": 0, "STL": 0})
                continue
            if fn is None:
                continue
            if re.search(r"\bLDC(\.\S+)?\s+\S+,\s*c\[0x[0-9a-f]+\]\[R", line):
                sass[fn]["LDC[R]"] += 1
            for op in ("LDL", "STL"):
                if re.search(r"\b" + op + r"(\.\S+)?\s", line):
                    sass[fn][op] += 1
    out["sass_k1_k7"] = sass
F32 = torch.float32


def single(make):
    # A single launch's timer over inputs (plan, cols, params, num_docs,
    # D[, G]).
    def build():
        inputs = make()
        plan, cols, params, nd, D = inputs[:5]
        G = inputs[5] if len(inputs) > 5 else 0
        if plan.mode == "topn":
            kern = kernels.make_topn_kernel(plan, F32)
            return lambda: kern(cols, params, nd, D)
        kern = kernels.make_kernel(plan, F32)
        return lambda: kern(cols, params, nd, D, G)
    return build


def broadcast(make_members, G=0):
    # A B = 8 broadcast launch's timer: members (plan, col set, params per
    # member, num_docs, D) over one column set.
    def build():
        plan, cols, plist, nd, D = make_members()
        run = kernels.batched_kernel(plan, F32)
        idx = cs.BATCH_FORMS["broadcast"]
        return lambda: run([cols], plist, [nd], idx, D, G)
    return build


def first_members(inputs_fn):
    # Phase 3b's members over the first column set (the broadcast form).
    def make():
        plan, sets, plist, ndlist, D = cs.batched_inputs(inputs_fn, seed)
        return plan, sets[0], plist, ndlist[0], D
    return make


def bucket_case(prefix):
    return next(k for k in cs.BUCKET_CASES if k.startswith(prefix))


def bucket_members():
    # Phase 3b's bucket case: ts.3's column set, member m's window m hours
    # later.
    case = bucket_case("ts.3")
    plan, cols, _p, nd, D = cs.bucket_kernel_inputs(seed, case)
    plist = [cs.bucket_kernel_inputs(
        seed, case, [cs.TS_T0 + 3_600_000 * (s % 48 + m)
                     for s in range(cs.TS_SEGMENTS)])[2]
        for m in range(cs.BATCH_B)]
    return plan, cols, plist, nd, D


def compact_members(G):
    # Phase 3b's compact case at G: member m excluding phrase id m.
    def make():
        plan, cols, _p, nd, D, _G = cs.compact_kernel_inputs(seed, G)
        plist = [cs.compact_kernel_inputs(seed, G, neq=m)[2]
                 for m in range(cs.BATCH_B)]
        return plan, cols, plist, nd, D
    return make


def topn_case(letter):
    def make():
        cases = cs.topn_kernel_inputs(seed)
        return cases[next(k for k in cases if k.startswith(letter + ":"))]
    return make


grouped = lambda s: cs.kernel_inputs(s, grouped=True)  # noqa: E731
cases = [("scan_agg", single(lambda: cs.kernel_inputs(seed, grouped=False))),
         ("group_agg", single(lambda: grouped(seed))),
         ("group_agg ts.3", single(lambda: cs.bucket_kernel_inputs(
             seed, bucket_case("ts.3")))),
         ("group_agg ts.1", single(lambda: cs.bucket_kernel_inputs(
             seed, bucket_case("ts.1"))))]
for cname, (G, cb3) in cs.COMPACT_CASES.items():
    cases.append((f"group_agg compact {cname}", single(
        lambda G=G, cb3=cb3: cs.compact_kernel_inputs(seed, G, cb3=cb3))))
cases += [("group_agg x8", broadcast(first_members(grouped))),
          ("group_agg x8 ts.3", broadcast(bucket_members))]
for cname, (G, _cb3) in cs.COMPACT_CASES.items():
    cases.append((f"group_agg x8 compact {cname}",
                  broadcast(compact_members(G), G)))
cases += [("sketch_agg", single(lambda: cs.sketch_kernel_inputs(seed)))]


def sketch_split(slot, filtered):
    # K3 on phase 3's inputs with the plan cut to one sketch slot (None:
    # all three), with or without its filter
    def make():
        import dataclasses
        plan, cols, params, nd, D = cs.sketch_kernel_inputs(seed)
        ops = plan.agg_ops if slot is None else (plan.agg_ops[slot],)
        params = dict(params)
        if slot is not None and ops[0][0].startswith("hist:"):
            for n in ("hlo", "hscale"):
                params[f"slot0:{n}"] = params[f"slot{slot}:{n}"]
        plan = dataclasses.replace(
            plan, agg_ops=ops,
            filter_ir=plan.filter_ir if filtered else None)
        return plan, cols, params, nd, D
    return make


for slot in (None, 0, 1, 2):
    for filtered in (True, False):
        if slot is None and filtered:
            continue
        what = "all" if slot is None else ("hll:12", "hll:16", "hist")[slot]
        cases.append((f"sketch_agg split {what} "
                      f"{'filtered' if filtered else 'unfiltered'}",
                      single(sketch_split(slot, filtered))))
cases.append(("sketch_agg x8", broadcast(first_members(
    cs.sketch_kernel_inputs))))
cases += [("topn" if c == "a" else f"topn {c}", single(topn_case(c)))
          for c in "abcd"]
cases.append(("topn x8", broadcast(first_members(
    lambda s: cs.topn_kernel_inputs(s)["a: raw value DESC k=10"]))))


def masked(inputs_fn):
    # A single launch's timer over inputs under phase 3's validity mask.
    def make():
        plan, cols, params, nd, D = inputs_fn(seed)
        plan, cols = cs.with_mask(plan, cols, seed)
        return plan, cols, params, nd, D
    return make


def scan_form(form):
    # K1's B = 8 launch in one of phase 3b's forms (BATCH_FORMS).
    def build():
        plan, sets, plist, ndl, D = cs.batched_inputs(
            lambda s: cs.kernel_inputs(s, grouped=False), seed)
        idx = cs.BATCH_FORMS[form]
        U = max(idx) + 1
        run = kernels.batched_kernel(plan, F32)
        return lambda: run(sets[:U], plist, ndl[:U], idx, D)
    return build


def clp_case(mode, B=1):
    # K7's phase-3 (mode 'a' / 'b') or 3b (B = 8) launch.
    def build():
        leaves, cols, params, D = cs.clp_kernel_inputs(seed, mode, B)
        plist = params if B > 1 else [params]
        return lambda: _cuda.clp_match_batched(leaves, [cols], plist,
                                               [0] * B, D, batched=B > 1)
    return build


def widest():
    # K1 at program.py's limits together (64 accumulator words, 32 filter
    # trees, the main one 32 deep, a value 16 deep) on phase 3's scan
    # columns and leaves
    from pinot_tpu_torch.ops.plan_ir import DevicePlan
    plan, cols, params, nd, D = cs.kernel_inputs(seed, grouped=False)
    deep = ("leaf", 0)
    for k in range(31):
        deep = ("or" if k % 2 else "and", ("leaf", (k + 1) % 3), deep)
    value = ("col", "disc")
    for k in range(15):
        value = ("sub" if k % 2 else "add",
                 ("col", "price" if k % 2 else "disc"), value)
    ops = [("isum", 0, f) for f in range(9)]
    ops += [(op, 1, 9 + k)
            for k, op in enumerate(("sum", "min", "max", "sumsq"))]
    ops += [("count", None, 13 + k) for k in range(5)]
    plan = DevicePlan(
        filter_ir=deep, leaves=plan.leaves,
        agg_filter_irs=tuple(("leaf", k % 3) if k % 2
                             else ("not", ("leaf", k % 3))
                             for k in range(31)),
        value_irs=(value, ("col", "price")), agg_ops=tuple(ops),
        dict_cols=plan.dict_cols, raw_cols=plan.raw_cols)
    return plan, cols, params, nd, D


cases += [("scan_agg masked",
           single(masked(lambda s: cs.kernel_inputs(s, grouped=False)))),
          ("scan_agg widest", single(widest))]
cases += [(f"scan_agg x8 {form}", scan_form(form)) for form in cs.BATCH_FORMS]
cases += [("clp_match a", clp_case("a")), ("clp_match b", clp_case("b")),
          ("clp_match x8", clp_case("b", cs.BATCH_B))]


def startree_timed(name, fn):
    # K5's three times: CUDA events, device time in a trace, host wall a
    # call back to back
    out[name] = cs.cuda_ms(fn, iters)
    out[name + " device"] = cs.trace_device_ms(fn, "startree_", 50,
                                               trace_dir.name)
    out[name + " wall"] = cs.wall_ms(fn)


def startree_case(name):
    # K5's phase-3 case `name` (chip_smoke STARTREE_CASES)
    def build():
        from pinot_tpu_torch.ops import startree_device as sd
        plan, cols, params, nd, D = cs.startree_kernel_inputs(seed)[name]
        kern = sd.make_startree_kernel(plan, F32)
        return lambda: kern(cols, params, nd, D)
    return build


cases += [(f"startree_agg {name}", startree_case(name))
          for name in cs.STARTREE_CASES]
for name, build in cases:
    if not only.search(name):
        continue
    fn = build()
    if name.startswith("startree_agg"):
        startree_timed(name, fn)
    else:
        out[name] = cs.cuda_ms(fn, iters)
    del fn
    torch.cuda.empty_cache()
if only.search("empty launch") and hasattr(_cuda, "empty_launch"):
    # the card's floor for one launch through a kernel wrapper: an empty
    # kernel, by events and in the trace
    out["empty launch"] = cs.cuda_ms(_cuda.empty_launch, iters)
    out["empty launch device"] = cs.trace_device_ms(
        _cuda.empty_launch, "pt_empty", 50, trace_dir.name)
    out["empty launch wall"] = cs.wall_ms(_cuda.empty_launch)
# K9's phase-3c cases as the change's chip_smoke.py makes them
# (`mesh_fold_cases`, each checked bit for bit there against this
# checkout's plain version), their folds built by this checkout's
# `doc_fold` / `merged_plan`: their CUDA-event times and device times a
# call in a trace
if only.search("mesh_fold"):
    import importlib.util
    spec = importlib.util.spec_from_file_location("change_cases",
                                                  change_smoke)
    change_cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(change_cases)
    for name, case in change_cases.mesh_fold_cases(
            seed, trace_dir.name).items():
        out[f"mesh_fold {name}"] = case["ms"]
        out[f"mesh_fold {name} device"] = case["device_ms"]
    torch.cuda.empty_cache()
# K8's phase-3 cases and phase 3b's B = 8 forms on phase 3's block, with
# chip_smoke's seeds (vector_kernel_cases)
block = cs.vector_block(seed, cs.K8_SEGMENTS + cs.BATCH_B - 1) \
    if only.search("vector_topk") else None
k8 = []
for i, (name, (k, ivf, resid, _st)) in enumerate(cs.K8_CASES.items()):
    if block is None:
        break
    plan, sets, plist, ndl, _idx, D = cs.vector_case(block, seed + i, k,
                                                     ivf, resid)
    kern = kernels.make_vector_kernel(plan)
    k8.append((f"vector_topk {name}",
               lambda kern=kern, sets=sets, plist=plist, ndl=ndl, D=D:
               kern(sets[0], plist[0], ndl[0], D)))
for i, (name, (k, ivf, resid, st)) in enumerate(cs.K8_BATCHED.items()):
    if block is None:
        break
    plan, sets, plist, ndl, idx, D = cs.vector_case(
        block, seed + 10 + i, k, ivf, resid, B=cs.BATCH_B, stacked=st)
    run = kernels.batched_kernel(plan)
    k8.append((f"vector_topk x8 {name}",
               lambda run=run, sets=sets, plist=plist, ndl=ndl, idx=idx,
               D=D: run(sets, plist, ndl, idx, D)))
for name, fn in k8:
    out[name] = cs.cuda_ms(fn, iters)
del block, k8
torch.cuda.empty_cache()
# K6 and torch.stack on phase 3's full float32 rows, in turns within the
# process (K6, stack, K6, stack)
gen = torch.Generator(device="cuda")
gen.manual_seed(seed + 4)
rows = [torch.randn(cs.RA_D, generator=gen, device="cuda")
        for _ in range(cs.RA_S)]
k6 = {"row_assemble": [], "torch.stack": []}
for _ in range(2 if only.search("row_assemble") else 0):
    k6["row_assemble"].append(cs.cuda_ms(
        lambda: kernels.assemble_rows(rows, cs.RA_S, cs.RA_D), iters))
    k6["torch.stack"].append(cs.cuda_ms(lambda: torch.stack(rows), iters))
if k6["row_assemble"]:
    out.update({k: sum(v) / len(v) for k, v in k6.items()})
    out["k6_turns"] = k6
del rows
torch.cuda.empty_cache()
if queries:
    import shutil, statistics, tempfile
    from pinot_tpu_torch.query.context import QueryContext
    from pinot_tpu_torch.query.executor import QueryExecutor
    ssb = [("lo_orderdate", "INT", False), ("lo_discount", "INT", False),
           ("lo_quantity", "INT", False), ("lo_extendedprice", "INT", True)]
    gb = [("lo_orderdate", "INT", False), ("lo_discount", "INT", False),
          ("lo_quantity", "INT", False), ("d_year", "INT", False),
          ("p_category", "STRING", False), ("s_region", "STRING", False),
          ("lo_revenue", "INT", True)]
    st_fields, st_tree, st_queries = cs.ST_TABLES["ssbst"]
    legs = (
        ("ssb", ssb, ["lo_extendedprice"], cs.Q1_SEGMENTS, cs.Q1_DOCS,
         cs.ssb_q1_columns, cs.q1_truth, None,
         {**cs.Q1_QUERIES,
          **{k: v[0] for k, v in cs.SEL_QUERIES.items()},
          "dist.1": cs.DIST_QUERY}),
        ("ssbgb", gb, ["lo_revenue"], cs.GB_SEGMENTS, cs.GB_DOCS,
         cs.ssb_flat_columns, cs.groupby_truth, None,
         {"groupby": cs.GB_QUERY, "distinct": cs.GB_DISTINCT}),
        ("taxi", [("trip_id", "LONG", False), ("fare", "DOUBLE", True)],
         ["trip_id", "fare"], cs.TAXI_SEGMENTS, cs.TAXI_DOCS,
         cs.taxi_columns, cs.taxi_truth, None, dict(cs.TAXI_QUERIES)),
        ("ssbst", st_fields, [], cs.ST_SEGMENTS, cs.ST_DOCS,
         cs.ssb_flat_columns, cs.startree_truth, st_tree,
         {k: v[0] for k, v in st_queries.items()}))
    tmp = tempfile.mkdtemp(prefix="kernel_ab_")
    p50, stage_ms = {}, {}
    try:
        staged = {"taxi": ("sketch_agg staged q4.1",
                           "sketch_agg staged q4.3"),
                  "ssbst": ("startree_agg staged st5.1",
                            "startree_agg staged x8")}
        for table, fields, no_dict, n, docs, cols_fn, truth_fn, tree, \
                sqls in legs:
            if not any(only.search(c)
                       for c in (table, *staged.get(table, ()))):
                continue
            segs, _truths = cs.build_segments(
                tmp, table, fields, no_dict, n, docs, cols_fn, truth_fn,
                seed, cs.BUILD_WORKERS, star_tree=tree)
            ex = QueryExecutor(segs)
            for name, sql in sqls.items():
                _resp, _cold, lats, split = cs.time_query(ex, sql, 20)
                p50[name] = statistics.median(lats) * 1e3
                stage_ms[name] = split
            vdt = ex.engine.value_dtype
            for q in ("q4.1", "q4.3") if table == "taxi" else ():
                # K3 alone on the engine's own staging of the query
                if not only.search(f"sketch_agg staged {q}"):
                    continue
                ctx = QueryContext.from_sql(sqls[q])
                with ex.engine._engine_lock:
                    plan, _ = ex.engine._plan(ex.segments, ctx)
                    cols, params, nd, D = ex.engine._stage(ex.segments, ctx,
                                                           plan)
                kern = kernels.make_kernel(plan, vdt)
                out[f"sketch_agg staged {q}"] = cs.cuda_ms(
                    lambda: kern(cols, params, nd, D), iters)
                out[f"sketch_agg staged {q} shape"] = list(
                    cols[next(iter(cols))].shape)
                del plan, cols, params, nd, kern
            if table == "ssbst" and only.search("startree_agg staged"):
                # K5 alone on the blocks the engine stages for st5.1, and
                # for eight 9f pool queries in one broadcast launch
                from pinot_tpu_torch.ops import startree_device as sd
                plan, cols, params, nd, D = cs.staged_startree(
                    ex, sqls["st5.1"])
                kern = sd.make_startree_kernel(plan, vdt)
                startree_timed("startree_agg staged st5.1",
                               lambda: kern(cols, params, nd, D))
                pool = [cs.st_pool_sql(*w) for w in cs.ST_POOL]
                every = tuple(range(len(ex.segments)))
                plan, sets, plist, nds, idx, D = cs.staged_startree_batch(
                    ex, pool[:cs.BATCH_B], [every] * cs.BATCH_B)
                run = sd.batched_kernel(plan, vdt)
                startree_timed("startree_agg staged x8",
                               lambda: run(sets, plist, nds, idx, D))
                del plan, cols, params, nd, sets, plist, nds
            del ex, segs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["p50_ms"] = p50
    if splits:
        out["stage_ms"] = stage_ms
if logs:
    # the log leg on the segments built once for every turn: logs.1-6
    # against their numpy truth and their p50, then 9h's windows
    import pickle, statistics, tempfile
    from pinot_tpu_torch.query.executor import QueryExecutor
    with open(logs, "rb") as fh:
        segs, truths = cs.load_log_segments(pickle.load(fh))
    ex = QueryExecutor(segs, value_dtype=torch.float64)
    p50 = out.setdefault("p50_ms", {})
    for name, (sql, _k) in cs.log_queries().items():
        resp, _cold, lats, _split = cs.time_query(ex, sql, 20)
        if cs.log_rows(name, resp) != cs.log_expected(truths, name):
            sys.exit(f"{name}: differs from its numpy truth")
        p50[name] = statistics.median(lats) * 1e3

    def pool_check(i, r):
        want = sum(t["pool"][i] for t in truths)
        return None if r in ([(want,)], [(float(want),)]) else f"{r}"
    leg = cs.concurrency_leg(
        "9h", cs.modes_of(segs, pipelined=ex, value_dtype=torch.float64),
        cs.LOG_POOL, [list(range(len(cs.LOG_POOL)))] * cs.CLIENTS,
        pool_check, cs.card_line(), tempfile.mkdtemp(prefix="kernel_ab_"),
        _cuda.KERNELS, ("scan_agg", "clp_match"))
    out["9h_qps"] = {mode: leg[mode]["qps"]
                     for mode in ("serialized", "pipelined")}
if vector:
    # the vector leg on the segments built once for every turn: vec.1-4
    # held to their host search and their p50, then 9i's windows
    import pickle, statistics, tempfile
    from pinot_tpu_torch.query.executor import QueryExecutor
    with open(vector, "rb") as fh:
        done, xdone = pickle.load(fh)
    segs, indexes = cs.load_vector_segments(done)
    xsegs, xindexes = cs.load_vector_segments(xdone)
    queries = cs.vector_queries(segs, indexes, xsegs, xindexes, seed)
    ex = QueryExecutor({"vec": segs, "vecx": xsegs})
    p50 = out.setdefault("p50_ms", {})
    for name, (sql, (want, band), limit) in queries.items():
        resp, _cold, lats, _split = cs.time_query(ex, sql, 20)
        if not cs.vec_rows_agree(cs.rows_of(resp), want, band, limit):
            sys.exit(f"{name}: differs from the host search")
        p50[name] = statistics.median(lats) * 1e3
    # K8 alone on the engine's staging of vec.1 (IVF) and vec.4 (exact
    # search over vecx's short segments): [S, D, kk] beside each time
    for name in ("vec.1", "vec.4"):
        plan, sets, plist, ndl, _idx, D = cs.staged_vector(
            ex, queries[name][0])
        kern = kernels.make_vector_kernel(plan)
        out[f"vector_topk staged {name}"] = cs.cuda_ms(
            lambda: kern(sets[0], plist[0], ndl[0], D), iters)
        out[f"vector_topk staged {name} shape"] = [
            int(ndl[0].shape[0]), D, min(plan.k_pad, D)]
        del plan, sets, plist, ndl, kern
    pool_q = cs.vec_query_vectors(indexes, seed, cs.VEC_POOL, 9)
    pool = [cs.vec_sql(qv, 10, 100) for qv in pool_q]
    truth = [cs.vec_expected(segs, indexes, qv, 10, 100) for qv in pool_q]

    def vec_check(i, r):
        want, band = truth[i]
        return None if cs.vec_rows_agree(r, want, band, 100) else f"{r[:3]}"
    leg = cs.concurrency_leg(
        "9i", cs.modes_of({"vec": segs, "vecx": xsegs}, pipelined=ex), pool,
        [list(range(len(pool)))] * cs.CLIENTS, vec_check, cs.card_line(),
        tempfile.mkdtemp(prefix="kernel_ab_"), _cuda.KERNELS, "vector_topk")
    out["9i_qps"] = {mode: leg[mode]["qps"]
                     for mode in ("serialized", "pipelined")}
print("TURN " + json.dumps(out))
"""


def build_logs(tmp: str, seed: int) -> str:
    """The log leg's segments (chip_smoke.py's phase 11), built once in
    spawned workers with this checkout's generator and creator; returns
    the path of their pickled build results, which every turn loads."""
    import multiprocessing
    import pickle
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    jobs = [(tmp, seed, i, cs.LOG_DOCS) for i in range(cs.LOG_SEGMENTS)]
    with multiprocessing.get_context("spawn").Pool(cs.BUILD_WORKERS) as pool:
        done = pool.map(cs.build_log_segment, jobs, chunksize=1)
    path = os.path.join(tmp, "logs.pkl")
    with open(path, "wb") as fh:
        pickle.dump(done, fh)
    return path


def build_vector(tmp: str, seed: int) -> str:
    """The vector leg's segments (chip_smoke.py's phase 12: the vec table
    and the exact-path vecx), built once in spawned workers, one a core,
    each with its BLAS on one thread, with this checkout's generator and
    creator; returns the path of their pickled build results, which every
    turn loads."""
    import multiprocessing
    import pickle
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    saved = {k: os.environ.get(k) for k in cs._BLAS_THREADS}
    os.environ.update({k: "1" for k in cs._BLAS_THREADS})
    try:
        with multiprocessing.get_context("spawn").Pool(
                min(cs.VEC_SEGMENTS, os.cpu_count() or 1)) as pool:
            done = pool.map(cs.build_vector_segment,
                            cs.vector_jobs(tmp, seed), chunksize=1)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    xdone = [cs.build_vector_segment(j) for j in cs.vector_jobs(
        tmp, seed, "vecx", cs.VEC_EXACT_SEGMENTS, cs.VEC_EXACT_DOCS, 100)]
    path = os.path.join(tmp, "vector.pkl")
    with open(path, "wb") as fh:
        pickle.dump((done, xdone), fh)
    return path


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--no-queries", action="store_true",
                    help="time the kernels only")
    ap.add_argument("--splits", action="store_true",
                    help="also record each query's host-clock stage split")
    ap.add_argument("--logs", action="store_true",
                    help="also time the log leg's queries and 9h's windows")
    ap.add_argument("--vector", action="store_true",
                    help="also time the vector leg's queries and 9i's "
                         "windows")
    ap.add_argument("--only", default="",
                    help="time only the kernel cases whose name this "
                         "regular expression finds (default: every case)")
    args = ap.parse_args()
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="kernel_ab_logs_")
    logs = build_logs(tmp, args.seed) if args.logs else ""
    vector = build_vector(tmp, args.seed) if args.vector else ""
    turns = []
    for label in ("parent", "change", "change", "parent"):
        tree = os.path.abspath(getattr(args, label))
        first = label not in [t["tree"] for t in turns]
        r = subprocess.run(
            [sys.executable, "-c", TURN, str(args.seed), str(args.iters),
             "1" if first else "0", "0" if args.no_queries else "1",
             "1" if args.splits else "0", logs, vector, args.only,
             os.path.join(os.path.abspath(args.change), "chip_smoke.py")],
            cwd=tree, capture_output=True, text=True, timeout=1800)
        line = next((x for x in r.stdout.splitlines()
                     if x.startswith("TURN ")), None)
        if r.returncode != 0 or line is None:
            sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
            sys.exit(f"kernel_ab: the {label} turn failed")
        turn = {"tree": label, **json.loads(line[5:])}
        turns.append(turn)
        print(json.dumps(turn) + f" | {card}", flush=True)

    def mean(label, get):
        vals = [get(t) for t in turns if t["tree"] == label]
        return sum(vals) / len(vals)

    ratio = {k: mean("change", lambda t: t[k]) / mean("parent",
                                                      lambda t: t[k])
             for k in turns[0]
             if all(isinstance(t.get(k), float) for t in turns)}
    for q in turns[0].get("p50_ms", {}):
        ratio[q] = mean("change", lambda t: t["p50_ms"][q]) \
            / mean("parent", lambda t: t["p50_ms"][q])
    for leg in ("9h", "9i"):
        for mode in turns[0].get(f"{leg}_qps", {}):
            ratio[f"{leg} {mode} qps"] = \
                mean("change", lambda t: sum(t[f"{leg}_qps"][mode])) \
                / mean("parent", lambda t: sum(t[f"{leg}_qps"][mode]))
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"change_over_parent": ratio}) + f" | {card}")


if __name__ == "__main__":
    main()
