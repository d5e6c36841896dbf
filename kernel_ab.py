#!/usr/bin/env python3
"""K1-K4's phase-3 single-launch times and the main path's single-query
p50 of two checkouts, in turns, on one card.

    python3 kernel_ab.py PARENT_DIR CHANGE_DIR [--seed N] [--iters N]
                         [--no-queries] [--splits]

Runs the turns parent / change / change / parent, each in a fresh process
whose working directory is that checkout: it builds the checkout's CUDA
kernels (pinot_tpu_torch/ops/_cuda.py `build`), makes chip_smoke.py's
phase-3 inputs with that checkout's generators (K1 and K2
`kernel_inputs`, K3 `sketch_kernel_inputs`, K4 `topn_kernel_inputs` case
(a), the case on the kernels line) and times each kernel's single launch
by CUDA events (chip_smoke `cuda_ms`, median of --iters). The first turn
of each checkout also prints `nvcc -Xptxas -v`'s registers, spills and
stack per kernel function of K1-K4. Then (unless --no-queries) each turn
builds chip_smoke.py's legs of phases 4-7 with that checkout's generators
and creator — SSB Q1 at 16 x 8M rows, the config-#3 group-by at 8 x 4M,
config #4 at 128 x 8M, config #5's star-tree table at 8 x 4M — and takes
each leg query's p50 over 20 warm runs alone through its QueryExecutor
(chip_smoke `time_query`; host clock, the result on the host); with
--splits each turn also records each query's median host-clock stage
split (`stage_ms`: parse, plan, stage, kernel_fetch, assemble, reduce).
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
import subprocess
import sys

TURN = r"""
import json, os, re, subprocess, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from pinot_tpu_torch.ops import _cuda, kernels
seed, iters, ptxas = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "1"
queries = sys.argv[4] == "1"
splits = len(sys.argv) > 5 and sys.argv[5] == "1"
_cuda.build()
out = {}
if ptxas:
    regs = {}
    for k in (_cuda.SCAN_AGG, _cuda.GROUP_AGG, _cuda.SKETCH_AGG, _cuda.TOPN):
        flags = [f for f in _cuda.NVCC_FLAGS if f != "-shared"]
        r = subprocess.run([_cuda.nvcc(), *flags, "-c", "-Xptxas", "-v",
                            "-o", os.devnull,
                            os.path.join(_cuda._CSRC, k.source)],
                           capture_output=True, text=True)
        fn = None
        for line in (r.stdout + r.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
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
cases = (("scan_agg", lambda: cs.kernel_inputs(seed, grouped=False)),
         ("group_agg", lambda: cs.kernel_inputs(seed, grouped=True)),
         ("sketch_agg", lambda: cs.sketch_kernel_inputs(seed)),
         ("topn", lambda: cs.topn_kernel_inputs(seed)[
             "a: raw value DESC k=10"]))
for name, make in cases:
    plan, cols, params, nd, D = make()
    kern = kernels.make_topn_kernel(plan, torch.float32) \
        if name == "topn" else kernels.make_kernel(plan, torch.float32)
    out[name] = cs.cuda_ms(lambda: kern(cols, params, nd, D), iters)
    del plan, cols, params, nd, kern
    torch.cuda.empty_cache()
if queries:
    import shutil, statistics, tempfile
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
        for table, fields, no_dict, n, docs, cols_fn, truth_fn, tree, \
                sqls in legs:
            segs, _truths = cs.build_segments(
                tmp, table, fields, no_dict, n, docs, cols_fn, truth_fn,
                seed, cs.BUILD_WORKERS, star_tree=tree)
            ex = QueryExecutor(segs)
            for name, sql in sqls.items():
                _resp, _cold, lats, split = cs.time_query(ex, sql, 20)
                p50[name] = statistics.median(lats) * 1e3
                stage_ms[name] = split
            del ex, segs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["p50_ms"] = p50
    if splits:
        out["stage_ms"] = stage_ms
print("TURN " + json.dumps(out))
"""


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
    args = ap.parse_args()
    card = card_line()
    turns = []
    for label in ("parent", "change", "change", "parent"):
        tree = os.path.abspath(getattr(args, label))
        first = label not in [t["tree"] for t in turns]
        r = subprocess.run(
            [sys.executable, "-c", TURN, str(args.seed), str(args.iters),
             "1" if first else "0", "0" if args.no_queries else "1",
             "1" if args.splits else "0"],
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
             for k in ("scan_agg", "group_agg", "sketch_agg", "topn")}
    for q in turns[0].get("p50_ms", {}):
        ratio[q] = mean("change", lambda t: t["p50_ms"][q]) \
            / mean("parent", lambda t: t["p50_ms"][q])
    print(json.dumps({"change_over_parent": ratio}) + f" | {card}")


if __name__ == "__main__":
    main()
