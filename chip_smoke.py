#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pinot_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:

1. Device: the card's name and power limit (nvidia-smi) and its torch name.
2. Build: the nine CUDA kernels from pinot_tpu_torch/ops/csrc with nvcc,
   one process per source, in parallel.
3. Kernels against their plain PyTorch versions, on the card, on seeded
   random inputs at the main path's shapes: K1 scan_agg at S=16, D=2^23
   (i16 / i8 ids, f32 values, a filter of range / lut / not-neq leaves,
   a product value, count / sum / min / max / exact-sum slots), K2
   group_agg at S=8, D=2^22, G=35, K3 sketch_agg at S=16, D=2^23
   (HLL slots at log2m 12 and 16 over i32 split planes of longs below
   2^55, 0 and negatives among them; an 8192-bucket histogram over f32
   values with NaN, +-inf and the bounds; a filter of range / lut /
   vrange64 leaves), and K4 topn at S=16, D=2^23 in four cases (a raw f32
   value DESC k=10 and an i16 ids value ASC k=1000 under a filter keeping
   about 0.3% of docs; the raw value ASC k=8192 and unordered k=1000
   under one keeping about 50%), its order values small integers with
   NaN, +-inf and +-0.0, and K5 startree_agg at S=16, D=2^20 pre-agg
   records (far past the star-tree leg's trees, many blocks per segment;
   phase 7 checks K5 at the leg's own shapes) in three shapes (flat;
   grouped with G=35, its table in shared memory; grouped with G=2^14,
   past shared memory) over one exact-sum (usum) pair, one float sum and
   one max, its selection contiguous record runs keeping about 10%, as
   traversal yields [start, end) slices. K6 row_assemble at the Q1 leg's
   block, [16, 2^23], element sizes 1, 4 and 8, in two cases: 13 rows of
   mixed power-of-two lengths (three padded segments) and 16 full-length
   rows (the stack form), bit for bit against its plain version (which
   takes CPU tensors: the same rows copied to the host, timed by the host
   clock); library: torch.stack on the full-length case. K6 runs first:
   the TSBS and log segments (phases 10, 11) then build in BUILD_WORKERS
   spawned processes beside the rest of phase 3 and 3b, whose times are
   the card's, and phase 4 waits for them.
   Counts, exact-sum planes, min / max, registers, buckets and K4's whole
   output must match bit for bit; float sums within 1e-5 of the slot's sum
   of |contribution|. Times: CUDA events,
   median of 20 launches. Bound: the bytes the function must move on
   these inputs (the filter's columns in full, the other columns, split
   planes and order values included, only in the 32-byte sectors holding
   a doc the filter keeps, parameters and output once) over 3.35 TB/s.
   Library: torch.Tensor.index_add_ of K2's kept values at their
   precomputed keys (the scatter alone); torch.histc over K3's histogram
   input, unfiltered (nearly K3's histogram; no PyTorch call computes
   HLL); torch.topk over K4's masked score block (it keeps no tie order: a
   time only; K4's cases also give the launch's peak device memory, its
   candidate lists sized for every doc); none for K5
   (no one PyTorch call computes its count, exact-sum planes and float
   slots together).
   K2 with the fused time bucket (BUCKET_CASES) at the time-series leg's
   block, S = 25, D = 2^22: ts.3's G = 16 x 4000 = 64,000 (K2's global
   tier) and ts.1's G = 1024 (its block tier), the timestamp's (hi, lo)
   planes under a vrange64 window, per-segment sliding starts, negative
   and wrapping deltas and both grid edges reaching the gate (counts,
   keys and max bit for bit, sums within 1e-5 of sum|contribution|;
   library: torch.bincount(keys, weights) on precomputed keys). K2 with
   compact keys (COMPACT_CASES) at phase 14's block, S = 8, D = 2^20: a
   seeded int32 gkey block (each segment's own tuple count between G/2
   and G, skewed toward low codes) at phase 14's G = 2^16 (CB_G) with
   cb.3's unfiltered SUM / MIN / MAX / COUNT slots, and at G = 2^17 and
   G = 2^20 (the cap) with a SUM and a COUNT slot under a neq leaf (cb.2's
   `<> ''`), all in K2's global tier;
   every K2 entry names its tier (`tier`); the bound counts the columns
   and the output as every K2 row does, and `scratch_bytes` gives the
   u64 table's memset and decode read beside it (16 bytes per B x S x G
   x n_slots word); library: torch.Tensor.index_add_ of the
   kept values at precomputed keys. K1-K4 again on their phase-3 inputs under a seeded uint8
   validity mask
   clearing about a third of docs (the bound counts the mask's byte per
   real doc). K7 clp_match at S = 32, D = 2^22 (K7_SEGMENTS; twice the
   log leg's segments; clp_kernel_inputs: var-dictionary LUTs of 2^20, a
   quarter of the
   dict-var slots at the sentinel), in mode 'a' (Kd = 2) and mode 'b'
   (Kd = Ke = 2, 16 conditions with padding, 64 groups with padding,
   equal and unequal (hi, lo) pairs), its masks bit for bit against its
   plain version; bound: (1 + Kd + 2 Ke) x 4 + 1 bytes per doc and the
   table bytes K7 can read once (clp_table_bytes: of the var LUTs only the
   dict banks that live conditions name, up to the largest dict-var id);
   library: none (no PyTorch call computes the match).
   K8 vector_topk at the vector leg's block (K8_SEGMENTS = 16 segments,
   the first 10 real with 999,000 unit vectors of d = 96 zero-padded to
   dim_pad 128, D = 2^20; made on the card from the seed) in four cases:
   exact k = 10 and k = 100, IVF k = 10 (999 cells, 8 probed per segment)
   and IVF k = 100 under a category filter and a uint8 validity mask
   (vec.3's shape); its whole packed output (counts, ids, scores) bit for
   bit against its plain version. Bound: each real doc's cell id (IVF),
   the row (dim_pad x 4 bytes) of each doc a member scores, the filter's
   columns and the mask at the winners, parameters and output once.
   Library: torch.bmm + torch.topk on the same block (two calls, no tie
   order: a time only).
3b. The query axis: K1-K4 with B = 8 members (8 seeded literal sets on
   phase 3's inputs, each column set its own seeded data) in three forms:
   broadcast (U = 1 column set), stacked (U = 8) and dedup (U = 3, member
   m over set m mod 3). Every member's output must equal the plain batched
   version's and the member's own single launch (the same bars as phase
   3). Prints the B = 8 time, 8 x the single launch's time (paired, in the
   same phase) and the bound: each column set's bytes once for the members
   that read it (filter columns in full, the others in the sectors some
   member keeps), plus each member's parameters and output. K5's case
   runs in phase 7, on the blocks the engine stages for eight seeded
   st5.1-shaped queries (9f's pool) over ssbst: broadcast (one segment
   batch), stacked (each member over the segments rotated by its index)
   and dedup (rotations m mod 3); each member against the plain batched
   version and its own single launch, as phase 3 holds K5. K2's bucket
   case at B = 8 over ts.3's column set (broadcast), member m's window m
   hours later. K2's compact cases at B = 8 (G = 2^16, 2^17, 2^20) over
   one column set (broadcast), member m excluding phrase id m, with the
   launch's peak device memory. K7's mode 'b' case at B = 8 over one column set, each
   member's own tables, against the plain version and its single launch.
   K8 at B = 8 (IVF, k = 10: 9i's shape) broadcast over one column set and
   stacked (member m over block rows m .. m + 15, its own column set),
   each member's own query and probe cells, against the plain batched
   version and its single launch.
4. Q1 leg: SSB-flat lineorder data (bench.py's column distributions), 16
   segments x 8M rows = 128M rows, built with the port's creator into a
   temp dir; SSB Q1.1 as bench.py runs it plus Q1.2- and Q1.3-shaped date
   windows through QueryExecutor(device="cuda"), each checked EXACTLY
   (integer SUM and COUNT) against numpy truth from the generated columns,
   and MOM_QUERY (VARIANCE, VAR_SAMP, STDDEV, STDDEV_SAMP, SKEWNESS,
   KURTOSIS, BOOL_AND, BOOL_OR ungrouped on K1): each moment within
   MOM_TOL = 2e-3 of max(1, |exact|), the exact value from the columns'
   integer raw moments, and each boolean equal. Then the selection leg
   on the same segments: four top-N queries on K4
   (a raw order value, a dictionary order value with OFFSET, unordered,
   an expression order value) and a DISTINCT on K2, every row equal to
   the numpy truth in order (selection_truth / selection_expected).
   Then the MSE leaf: engine.filtered_doc_ids on the same segments (K4
   with k = TOPN_MAX_K): MSE_FILTER's doc ids equal the numpy ones, and
   MSE_WIDE, past TOPN_MAX_K in every segment, gives None.
4c. Residency (after 9a and 9c): a fresh engine over the Q1 segments runs
   Q1.1 over segments 0-11, then over 4-15 (its column uploads must be
   exactly the rows of segments 12-15, by the transfer odometer), then 4-15
   again (no column byte, no K6 launch); invalidate_segment of segment 5's
   name must drop exactly its resident rows. Each step's launch counts are
   held as phase 8 holds a leg's (K1 once, K6 once per block assembled).
   Prints each step's column bytes, stage ms, K6 launches and peak device
   memory.
4d. Upserts (after 4c), on phase 4's segments: segments 0-11 carry
   validDocIds (the port's Bitmap) with a seeded third of docs cleared,
   12-15 stay append-only; UPSERT_QUERIES through a fresh executor (Q1.1
   and COUNT(*) on K1, a GROUP BY lo_discount and a DISTINCT on K2, sel.1
   on K4, a DISTINCTCOUNTHLL on K3, a LIMIT-only selection on the host),
   each exact against the numpy truth of the valid docs. Then a seeded 1%
   of segment 3's valid docs is cleared in place: the next Q1.1 equals
   the new truth and uploads exactly segment 3's mask row (2^23 bytes) by
   the transfer odometer, a repeat nothing.
5. Group-by leg: 8 x 4M rows of bench_extra.py config #3 data;
   SELECT d_year, p_category, SUM(lo_revenue) ... WHERE s_region =
   'AMERICA' GROUP BY d_year, p_category ORDER BY ... LIMIT 100, checked
   against numpy truth: keys exactly, float32 sums within rel 1e-6 (the
   kernel adds in double; one float32 rounding of the total is 6e-8); a
   DISTINCT over two string columns, equal to the numpy pairs; and
   GB_MOM_QUERY (the moment and boolean aggregations GROUP BY d_year on
   K2), held as MOM_QUERY is.
6. Config-#4 leg: BASELINE config #4 (NYC-taxi-shaped trip_id LONG and
   fare DOUBLE, bench_extra.py:200-209's draws) at 64 segments x 8M rows
   = 512M rows (half the config's 128 segments: the run's time limit),
   generated, written and folded into the truth one
   segment at a time; DISTINCTCOUNTHLL(trip_id) + PERCENTILETDIGEST95(fare)
   unfiltered (bench_extra.py:211-212), under a fare range and under a
   trip_id range. The HLL value must equal the port's numpy HyperLogLog
   over the (filtered) trip_ids, the p95 the per-segment
   TDigest.from_histogram of a numpy histogram built with the kernel's
   float32 formula merged in segment order, and within rel 0.02 of the
   exact percentile.
7. Star-tree leg (BASELINE config #5): two tables built with the port's
   creator, star-trees included, 8 x 4M = 32M rows each: `ssbst`, config
   #5 verbatim (bench_extra.py:224-234: the SSB-flat columns, no raw
   columns, tree [d_year, p_category] with SUM__lo_revenue and COUNT__*,
   max_leaf 1000) with its query, and `stb`, bench.py:2162-2194's table
   (tree [country, browser, locale] with SUM__impressions, MAX__cost and
   SUM__cost, max_leaf 10) with the four parity_sqls(3) of
   bench.py:2198-2208. Each query runs from the tree (K5) and again with
   OPTION(useStarTree=false) on K1 / K2; each answer must equal the numpy
   truth of the generated columns (integer sums and counts exactly from
   the tree; floats, and the scan's float32 grouped sums, within rel 1e-6)
   and the tree's answer its scan's within rel 1e-6. On ssbst the tree
   runs start with a prestage of st5.1 (the warm-up call), after which the
   leg must upload no column byte. After the tree runs of each table, K5
   is held against its plain version on the very inputs the engine staged
   for each query (S=8 segments of D=128 or 2048 pre-agg records: one
   block per segment, fewer records than a block has threads), as in
   phase 3; the kernels line carries config #5's query.
9. Concurrency leg: 8 closed-loop clients (bench.py:1744 batching_main)
   through one QueryExecutor per dispatch mode, `serialized` then
   `pipelined`, alternated twice in windows of WINDOW_S seconds, each
   client drawing seeded literal sets from its sub-leg's pool:
   9a Q1.1-shaped queries on phase 4's 128M rows (D = 2^23 is above the
   engine's DOC_BUCKET_MAX: the same-batch key, broadcast batches); 9b
   batching_main's three tables ssb_a / ssb_b / ssb_c at 16 x 750k, 16 x
   900k and 12 x 1M rows (one (S, D) bucket; 3 + 3 + 2 clients, so stacked
   and dedup batches both form), built after phase 7, with one held round
   per variant first (the ring held on its first pop by the
   server.dispatch.before failpoint, so a stacked and a dedup batch form
   whatever the timing); 9c sel.1-shaped top-N with seeded filters on the
   128M rows (K4's batched form: its key scratch is [B, S, D]); 9d
   config-#3-shaped group-bys on phase 5's 32M rows; 9e config #4's three
   sketch queries on phase 6's 512M rows; 9f st5.1-shaped star-tree
   queries (a p_category and a d_year range from a seeded pool, all
   filters on the tree's dimensions) on phase 7's ssbst segments, K5's
   member axis. Each pool query runs alone
   first through both executors and must equal its numpy truth (phase
   4-6's bars); every answer in the windows must equal the same query run
   alone. Per sub-leg and mode: QPS, per-query p50 / p99, the largest
   batch and the batched launches per variant, the card's busy share from
   a torch.profiler trace of one TRACE_S window, and peak device memory.
   The launch counts are set to 0 just before a sub-leg's windows and
   read just after them: the sub-leg's kernel must show one single launch
   per inline or single dispatch, one batched launch per broadcast,
   stacked or dedup dispatch and, over those, exactly the batches'
   members (no padding); every other kernel none. Fails on any other
   count, if a pipelined sub-leg never formed a batch of 2 or more, if 9a
   and 9b together did not show each variant, if a measured window
   compiled a program (kernels.trace_count moved: the solo runs before
   the windows compiled every plan of the pool), or if a window's peak
   device memory passed the card's 80 GB.
10. Time-series leg (after 9b): TSBS's devops cpu-only use case
   (github.com/timescale/tsbs, scale 4000, 10 s interval, 3 days):
   103,680,000 rows in time order, flushed every 2^22 rows into 25
   segments, `ts` an epoch-millis LONG without a dictionary (its window
   runs as vrange64 leaves on the planes the bucket reads), hostname /
   region / datacenter tags, usage_user / usage_system / usage_idle
   per-host walks clamped to [0, 100]. ts.1 (single-groupby-1-1-12),
   ts.2 (single-groupby-1-8-1), ts.3 (double-groupby-1: AVG by hour and
   host over 12 h, G = 64,000) through QueryExecutor, ts.4 through the
   port's time-series engine (simpleql, a region's hosts, 5-minute
   buckets, max() and keep_last_value()), each against the numpy truth
   of the generated columns (keys and buckets exactly, MAX equal to the
   float32 of the true maximum, sums and averages within rel 1e-6); then
   TS_SLIDES refreshes of ts.3, each an hour later, with no codegen.
   9g: 8 closed-loop clients of ts.3-shaped panels (eight hosts each,
   seeded hour-aligned windows) on K2's member axis, as 9a-9f run.
11. Log leg (after phase 10): CLP log search. LOG_SEGMENTS x LOG_DOCS
   = 67,108,864 lines of bench.py:3377-3391's six templates with their
   variable ranges, in time order (`ts` an epoch-millis LONG without a
   dictionary, `message` a CLP column), generated in numpy as CLP parts
   and written through the port's parts writer in spawned workers; a
   seeded sample of each segment is rendered, encoded by the port's
   encode_message into the generated parts and read back by
   reader.get. log_queries() through QueryExecutor (float64 values: logs.5
   orders by the raw timestamp), each against its numpy truth from the
   generator's templates and variables (counts and keys exactly, rows in
   order): logs.1 a bare substring (mode 'a', K1), logs.2 a dict-var
   equality, logs.3 an encoded-var equality (K1), logs.4 ERROR lines per
   minute over one hour (K2 with the bucket digit), logs.5 the last 100
   lines of code 503 (K4), logs.6 an OR of two CLP leaves under a ts
   bound (K1, both leaves in one K7 launch). Each query's cold run and
   its plan / stage split cold and warm are printed. LOG_WILDCARD must
   raise NotOffloadable with reason 'wildcard', counted in the engine's
   clp_fallback meter, with no launch. K7 is then held against its plain
   version on the inputs the engine staged for logs.2 and logs.6.
   9h: bench.py:3531's coalesce pool, 8 closed-loop clients over
   '%failed on host h<i>:%' (LOG_POOL), as 9a-9g run: batches of 2 or
   more on K7's and K1's member axes, no codegen, every answer its numpy
   truth.
12. Vector leg (after phase 11): ann-benchmarks' deep-image-96-angular
   shape, 9,990,000 vectors of d = 96, angular, in VEC_SEGMENTS = 10
   segments of 999,000 docs, each with its IVF layer of 999 cells,
   generated by bench.py:4674-4700's clustered mixture at d = 96 with an
   `id` and a `category` of 64 values, written through the port's creator
   from the float32 block (the JSON column rendered by json_rows) in
   VEC_WORKERS spawned processes at the lowest CPU priority from phase 3
   on (host-clock numbers of phases 3-6 may carry their load); vecx, an
   exact-path table
   of 4 x 4,000 docs, built here. vec.1 (k = 10, LIMIT 100), vec.2 (k =
   100, LIMIT 1000), vec.3 (k = 100 AND category = c: K before filter) and
   vec.4 (on vecx) through QueryExecutor, each equal to the host search of
   the same probe cells (VectorIndex.top_k's order; exact on vecx) outside
   a band of scores within 2 VEC_TOL of a segment's cut; K8 once per query
   run, K6 once per block assembled; the vector function under OR and
   an ORDER BY refused with reason 'hybrid' and no launch; recall@10 of
   VEC_RECALL queries against exact numpy ground truth printed (not
   gated); K8 held to its plain version on the engine's staging of vec.1
   and vec.3. 9i: 8 closed-loop clients over VEC_POOL vec.1-shaped
   queries with other vectors, as 9a-9h run: batches of 2 or more on K8's
   member axis, no codegen, every answer the query alone's and its host
   truth.
3c. (after phase 3b) K9 mesh_fold bit for bit against its plain version
   at the mesh leg's shapes: the doc fold of K1's and K3's packed Q1
   partials (HLL 2^16 registers, 8192 histogram buckets; P = 2 doc
   slices, S_loc = 4) at B = 1 and 8, and the remapped fold, with its
   matched tail, of config-#3-shaped K2 partials over the 8 slots of a 4x2
   mesh; CUDA-event times, the bound (the partials, the lists and the
   output once) and the plain version's time.
13. Mesh leg (after phase 9c), on phase 4's 128M Q1 rows, engines on a
   logical 4x2 mesh over cuda:0 (MESH_SHAPE: 8 slots; with more than one
   card, Q1.1 over a mesh of every card too). 13a: the sharded launch in
   float32 with pinot.server.mesh.collective.merge off: Q1.1-Q1.3 exact
   against numpy truth, MESH_SKETCH (K1 and K3 on each shard) equal to
   the single card's answer; in phase 5, the config-#3 group-by (K2 on
   each shard) against the single card's rows. 13b: the merge, float64
   on all 128M rows (MESH_SKETCH's p95 within rel 0.02 of the single
   card's: one digest of the batch's buckets), float32 on two segments
   (16M docs, table ssb2), and the float32 full batch, which must count
   mesh_merge_fallback{reason=precision}. 13c: row 14's
   distributed_query_step at S = 16, D = 2^23 over float64
   integer-valued measures, equal to its plain version and the numpy
   truth. Each query: p50 of ITERS warm runs, cold_s, kernel_fetch, K1-K3
   launched once per slot and K9 once per run, the merge meters, peak
   device memory. The launch sequences of rows 7, 8c (B = 8 pool queries
   broadcast) and 9 on the engines' own staging, and row 14's step,
   against their plain versions, with CUDA-event times and bounds (each
   shard's bytes as batch_bytes counts them, the partials once). 9j:
   8 closed-loop clients over Q1_POOL on the sharded mesh engine, as 9a
   runs: each dispatch one launch of K1 per slot (batched ones on its
   member axis) and one K9.
14. Compact group keys (after phase 12): ClickBench's `hits`
   (github.com/ClickHouse/ClickBench, queries.sql), generated from
   CB_POOL_SEED's pools and --seed: UserID (LONG, zipf-skewed over
   CB_USERS users), SearchPhrase (STRING, '' in 70% of the rows, else one
   of the user's phrases), RegionID (INT, the user's home region but for
   3% of the rows) and ResolutionWidth (INT, raw), CB_SEGMENTS x CB_DOCS
   = 8,388,608 rows built in the vector pool from phase 3 on; every
   query plans compact keys (each segment 2^15-2^16 tuples, G = 2^16 =
   CB_G, phase 3's compact case; another G fails the run; the dense
   products far above 2^20). cb.1 and cb.2 (ClickBench's, verbatim),
   cb.3 (its shape over (RegionID, UserID) with SUM / MIN / MAX, not
   ClickBench's) and cb.4 (DISTINCT UserID, SearchPhrase LIMIT 100000)
   through QueryExecutor: cold s, p50 of CB_ITERS warm runs, the stage
   split, G and the tuples per segment, peak device memory; each answer
   equal to the numpy truth folded from the segments (counts, integer
   sums, min / max and keys exact; at a tie at the 10th count, the keys
   tied there). K2 once per run. Then CB_BURST cb.1-shaped queries over
   one region each, held in the ring until all are queued: one batched
   K2 launch of them all at equal G, each equal to its single run. Then
   cb.1 and cb.3 once through the logical 4x2 mesh engines of phase 13
   (sharded float32 with the merge key off, merged float64): equal to one
   card's answer (up to the keys tied at the 10th count), K2 once per
   slot and K9 once per query, `mesh_merge_fallback{disabled}` and
   `mesh_merge_served` counting.
8. Launch counts: each kernel's counter is set to 0 just before a leg's
   timed queries and read just after them; the leg's kernels must have
   launched once per query run (a CLP query: K7 once, then K1, K2 or K4
   once), K6 once per block the leg assembled (the
   engines' hbm_block_miss meter), the others never, and no leg's peak
   device memory may pass 80 GB. Then a short
   torch.profiler trace of the same warm query gives the card's busy time
   per query and each port kernel's share. Prints each query's p50
   latency, rows/s and peak device memory, the host-clock stage split of
   the timed runs, the card line, the `kernels` JSON line, and last
   {"ok": true, "device": {...}}. The batched forms' entries (`*_batched`)
   carry phase 3b's broadcast times and their batched launches in phase
   9's windows; K6's entry the full float32 case of phase 3 and its
   launches in phases 4-7. `group_agg_tbucket` carries phase 3's ts.3
   bucket case and phase 10's K2 launches, `group_agg_tbucket_batched`
   phase 3b's bucket case and 9g's batched launches, `group_agg_compact`
   phase 3's compact G = 2^16 case (cb.3's slots) and phase 14's K2
   launches, `group_agg_compact_batched` phase 3b's compact G = 2^16 case
   and phase 14's burst, `*_masked` phase
   3's masked cases and phase 4d's launches (each a subset of its
   kernel's own entry). `clp_match` carries phase 3's mode 'b' case and
   the log leg's and 9h's single launches, `clp_match_batched` phase 3b's
   B = 8 case and 9h's batched launches. `vector_topk` carries phase 3's
   IVF k = 10 case (vec.1's shape) and phase 12's and 9i's single
   launches, `vector_topk_batched` phase 3b's broadcast case and 9i's
   batched launches. `mesh_fold` carries phase 3c's doc fold at B = 1 and
   phase 13's K9 launches, `mesh_fold_batched` the doc fold at B = 8 and
   9j's batched launches; `mesh_sharded`, `mesh_sharded_batched`,
   `mesh_merged` and `mesh_step` (rows 7, 8c, 9 and 14) each path's
   whole launch sequence and the K9 launches of that path.

Imports nothing of JAX or of pinot_tpu. Exits non-zero, printing no
result, where torch sees no CUDA device or the port's package is missing.
"""
from __future__ import annotations

import argparse
import atexit
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
SECTOR = 32  # bytes: the unit in which the card reads device memory

#: bench.py NUM_SEGMENTS x DOCS_PER_SEGMENT and bench_extra.py config #3
Q1_SEGMENTS, Q1_DOCS = 16, 8_000_000
GB_SEGMENTS, GB_DOCS = 8, 4_000_000
#: BASELINE config #4 (128 x 8M = 1,024M rows) cut to half its segments,
#: 512M rows, to keep the run inside its time limit
TAXI_SEGMENTS, TAXI_DOCS = 64, 8_000_000
#: warm runs per query, after one cold run
ITERS = 10
#: processes that generate and write segments (the card's host has 8 cores;
#: the main process waits while they run)
BUILD_WORKERS = max(1, min(8, os.cpu_count() or 1))

#: phase 3b's members per launch, and each form's member-to-set map
BATCH_B = 8
BATCH_FORMS = {"broadcast": [0] * BATCH_B,
               "stacked": list(range(BATCH_B)),
               "dedup": [m % 3 for m in range(BATCH_B)]}
#: phase 9: closed-loop clients (bench.py:1744), window and traced-window
#: lengths, and the seeded literal pools
CLIENTS = 8
WINDOW_S = 3.0
TRACE_S = 1.5
_POOL_RNG = np.random.default_rng(5150)
_MONTHS = [y * 10000 + m * 100 for y in range(1992, 1999)
           for m in range(1, 13)]
#: 9a: Q1.1's shape, a month, a discount window of 3, a quantity window
#: of 10 -> (date lo, date hi, discount lo, hi, quantity lo, hi)
Q1_POOL = [(int(d) + 1, int(d) + 31, int(c), int(c) + 2, int(q), int(q) + 9)
           for d, c, q in zip(_POOL_RNG.choice(_MONTHS, 16),
                              _POOL_RNG.integers(0, 9, 16),
                              _POOL_RNG.integers(1, 42, 16))]
#: 9c: sel.1's shape -> (date lo, date hi, discount lo, discount hi)
SEL_POOL = [(int(d) + 1, int(d) + 31, int(c), int(c) + 2)
            for d, c in zip(_POOL_RNG.choice(_MONTHS, 16),
                            _POOL_RNG.integers(0, 9, 16))]
#: 9d: config #3's shape -> (s_region, discount lo, discount hi)
GB_POOL = [(str(r), int(c), int(c) + int(w))
           for r, c, w in zip(_POOL_RNG.choice(["AMERICA", "ASIA", "EUROPE",
                                                 "AFRICA"], 16),
                              _POOL_RNG.integers(0, 8, 16),
                              _POOL_RNG.integers(1, 4, 16))]
#: 9b: batching_main's tables (bench.py:1751) at x500 docs and x4
#: segments; its query's discount windows a..a+2, a in 0..8; clients per
#: table
B9_TABLES = {"ssb_a": (16, 750_000), "ssb_b": (16, 900_000),
             "ssb_c": (12, 1_000_000)}
B9_CLIENTS = ["ssb_a"] * 3 + ["ssb_b"] * 3 + ["ssb_c"] * 2
B9_DISCOUNTS = range(9)
#: 9f: st5.1's shape under a filter on the tree's own dimensions ->
#: (p_category, first d_year, last d_year)
ST_POOL = [(str(c), int(y), int(y) + int(w))
           for c, y, w in zip(_POOL_RNG.choice(["MFGR#1", "MFGR#2", "MFGR#3",
                                                "MFGR#4", "MFGR#5"], 16),
                              _POOL_RNG.integers(1992, 1998, 16),
                              _POOL_RNG.integers(0, 4, 16))]

Q1_QUERIES = {
    # bench.py:42, verbatim
    "q1.1": ("SELECT SUM(lo_extendedprice * lo_discount), COUNT(*) FROM ssb "
             "WHERE lo_orderdate BETWEEN 19940101 AND 19940131 "
             "AND lo_discount BETWEEN 4 AND 6 AND lo_quantity BETWEEN 26 "
             "AND 35"),
    # SSB Q1.1's own shape: one year, discount 1-3, quantity < 25
    "q1.2": ("SELECT SUM(lo_extendedprice * lo_discount), COUNT(*) FROM ssb "
             "WHERE lo_orderdate BETWEEN 19930101 AND 19931231 "
             "AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"),
    # SSB Q1.3's shape: one week, discount 5-7, quantity 26-35
    "q1.3": ("SELECT SUM(lo_extendedprice * lo_discount), COUNT(*) FROM ssb "
             "WHERE lo_orderdate BETWEEN 19940206 AND 19940212 "
             "AND lo_discount BETWEEN 5 AND 7 AND lo_quantity BETWEEN 26 "
             "AND 35"),
}
Q1_TRUTH = {  # (date lo, date hi, discount lo, hi, quantity lo, hi)
    "q1.1": (19940101, 19940131, 4, 6, 26, 35),
    "q1.2": (19930101, 19931231, 1, 3, 1, 24),
    "q1.3": (19940206, 19940212, 5, 7, 26, 35),
}
GB_QUERY = ("SELECT d_year, p_category, SUM(lo_revenue) FROM ssbgb "
            "WHERE s_region = 'AMERICA' GROUP BY d_year, p_category "
            "ORDER BY d_year, p_category LIMIT 100")
GB_DISTINCT = ("SELECT DISTINCT p_category, s_region FROM ssbgb "
               "WHERE d_year = 1995 ORDER BY p_category, s_region LIMIT 100")
#: the moment and boolean aggregations on K1 / K2's raw-moment and min /
#: max slots: one ungrouped query in the Q1 leg, one grouped in the
#: group-by leg; each result column's (aggregation, column)
MOM_QUERY = ("SELECT VARIANCE(lo_quantity), VAR_SAMP(lo_discount), "
             "STDDEV(lo_quantity), STDDEV_SAMP(lo_discount), "
             "SKEWNESS(lo_quantity), KURTOSIS(lo_discount), "
             "BOOL_AND(lo_discount), BOOL_OR(lo_discount) FROM ssb "
             "WHERE lo_orderdate BETWEEN 19930101 AND 19931231 "
             "AND lo_discount BETWEEN 1 AND 3")
MOM_COLUMNS = [("variance", "lo_quantity"), ("var_samp", "lo_discount"),
               ("stddev", "lo_quantity"), ("stddev_samp", "lo_discount"),
               ("skewness", "lo_quantity"), ("kurtosis", "lo_discount"),
               ("bool_and", "lo_discount"), ("bool_or", "lo_discount")]
GB_MOM_QUERY = ("SELECT d_year, VARIANCE(lo_quantity), "
                "SKEWNESS(lo_quantity), KURTOSIS(lo_discount), "
                "BOOL_AND(lo_discount), BOOL_OR(lo_discount) FROM ssbgb "
                "WHERE s_region = 'ASIA' AND lo_discount < 2 "
                "GROUP BY d_year ORDER BY d_year LIMIT 10")
GB_MOM_COLUMNS = [("variance", "lo_quantity"), ("skewness", "lo_quantity"),
                  ("kurtosis", "lo_discount"), ("bool_and", "lo_discount"),
                  ("bool_or", "lo_discount")]
#: float32 values: each moment within MOM_TOL * max(1, |exact|) of the
#: exact value (tests/test_torch_moments.py's F32_JAX_ERR, the JAX float32
#: engine's own largest error on that test's data); booleans equal
MOM_TOL = 2e-3
#: the selection leg on the Q1 leg's segments: a dashboard's "top line
#: items" tile and a paged table view. name -> (SQL, limit, offset, asc)
SEL_QUERIES = {
    # a raw order value, about 0.3% of rows kept
    "sel.1": ("SELECT lo_orderdate, lo_discount, lo_quantity, "
              "lo_extendedprice FROM ssb WHERE lo_orderdate BETWEEN "
              "19940101 AND 19940131 AND lo_discount BETWEEN 4 AND 6 "
              "ORDER BY lo_extendedprice DESC LIMIT 10", 10, 0, False),
    # a dictionary (ids) order value, k = 1000, about 48% kept, dense ties
    "sel.2": ("SELECT * FROM ssb WHERE lo_quantity < 25 "
              "ORDER BY lo_orderdate LIMIT 100 OFFSET 900", 100, 900, True),
    # unordered: the first matched docs
    "sel.3": ("SELECT lo_orderdate, lo_extendedprice FROM ssb "
              "WHERE lo_discount = 7 AND lo_quantity BETWEEN 26 AND 35 "
              "LIMIT 100", 100, 0, True),
    # an expression order value
    "sel.4": ("SELECT lo_orderdate, lo_discount, lo_extendedprice FROM ssb "
              "WHERE lo_orderdate BETWEEN 19930101 AND 19931231 "
              "ORDER BY lo_extendedprice * lo_discount DESC LIMIT 10",
              10, 0, False),
}
#: DISTINCT on K2: 11 x 50 = 550 dense keys
DIST_QUERY = ("SELECT DISTINCT lo_discount, lo_quantity FROM ssb "
              "WHERE lo_orderdate BETWEEN 19940101 AND 19940131 "
              "ORDER BY lo_discount, lo_quantity LIMIT 1000")
SSB_COLS = ("lo_orderdate", "lo_discount", "lo_quantity", "lo_extendedprice")
_SKETCHES = ("SELECT DISTINCTCOUNTHLL(trip_id), PERCENTILETDIGEST95(fare) "
             "FROM taxi")
TAXI_QUERIES = {
    # bench_extra.py:211-212, verbatim
    "q4.1": _SKETCHES,
    # a vrange leaf on the histogram's own column
    "q4.2": _SKETCHES + " WHERE fare BETWEEN 10 AND 40",
    # a vrange64 leaf on the HLL column's own split planes (2^39)
    "q4.3": _SKETCHES + " WHERE trip_id < 549755813888",
}
#: the time-series leg: TSBS's devops `cpu-only` use case
#: (github.com/timescale/tsbs: --use-case=cpu-only --scale=4000
#: --log-interval=10s, 2016-01-01 to 2016-01-04): one row per host every
#: 10 s for 3 days, in time order, flushed every 2^22 rows (Pinot's
#: realtime.segment.flush.threshold.rows): 24 segments of 4,194,304 rows
#: and one of 3,016,704. TSBS's other 7 tags and 7 metrics are cut: no
#: query of the leg reads them
TS_HOSTS = 4000
TS_T0 = 1451606400000  # 2016-01-01T00:00:00Z in epoch millis
TS_INTERVAL = 10_000
TS_ROWS = 3 * 86400 * 1000 // TS_INTERVAL * TS_HOSTS
TS_FLUSH = 1 << 22
TS_SEGMENTS = -(-TS_ROWS // TS_FLUSH)
TS_REGIONS = ["us-east-1", "us-west-1", "us-west-2", "eu-west-1",
              "eu-central-1", "ap-southeast-1", "ap-southeast-2",
              "ap-northeast-1", "sa-east-1"]
TS_HOUR, TS_MIN, TS_5MIN, TS_12H = 3_600_000, 60_000, 300_000, 43_200_000
#: warm runs of ts.3 and ts.4 (tens of thousands of groups cross to the
#: host and reduce there), and ts.3's sliding refreshes
TS_HEAVY_ITERS = 3
TS_SLIDES = 20
_TS_RNG = np.random.default_rng(7107)
#: seeded windows, aligned to their steps: ts.1 one host, 12 h by minute;
#: ts.2 eight hosts, 1 h by minute; ts.3 every host, 12 h by hour (and
#: TS_SLIDES refreshes, each an hour later); ts.4 a region's hosts, 12 h
#: by 5 minutes through the time-series engine
TS_S1 = TS_T0 + TS_MIN * int(_TS_RNG.integers(0, 3 * 1440 - 720))
TS_H1 = int(_TS_RNG.integers(0, TS_HOSTS))
TS_S2 = TS_T0 + TS_MIN * int(_TS_RNG.integers(0, 3 * 1440 - 60))
TS_H2 = sorted(int(h) for h in _TS_RNG.choice(TS_HOSTS, 8, replace=False))
TS_S3 = TS_T0 + TS_HOUR * int(_TS_RNG.integers(0, 72 - 12 - TS_SLIDES))
TS_S4 = TS_T0 + TS_5MIN * int(_TS_RNG.integers(0, 864 - 144))
TS_R4 = str(_TS_RNG.choice(TS_REGIONS))
#: 9g: ts.3-shaped panels (AVG by hour and host over 12 h) on eight hosts
#: each -> (window start, hosts)
TS_POOL = [(TS_T0 + TS_HOUR * int(h),
            sorted(int(x) for x in _TS_RNG.choice(TS_HOSTS, 8,
                                                  replace=False)))
           for h in _TS_RNG.integers(0, 60, 16)]
#: phase 11: the log leg, bench.py:3377-3391's six templates (the
#: workload behind BENCH_logs.json) at 16 x 2^22 lines in time order (32
#: segments cut to 16 for the run's time limit), one line every 2 ms plus
#: a seeded 0/1 ms jitter from 2024-01-01
LOG_SEGMENTS, LOG_DOCS = 16, 1 << 22
#: phase 3's K7 block: 32 segments of 2^22 docs
K7_SEGMENTS = 32
LOG_T0 = 1704067200000  # 2024-01-01T00:00:00Z in epoch millis
LOG_HOUR = 3_600_000
#: logs.4's hour (the lines reach 37.3 h past LOG_T0)
LOG_T4 = LOG_T0 + 20 * LOG_HOUR
#: lines per segment rendered to hold the generator to the codec
LOG_SAMPLE = 2000
#: the dictionary-variable families of the templates, in code order:
#: (name, count, rendering of value v)
LOG_FAMILIES = (("req", 10**6, lambda v: f"req-{v}"),
                ("host", 8, lambda v: f"h{v}"),
                ("ip0", 32 * 256, lambda v: f"10.0.{v // 256}.{v % 256}"),
                ("user", 500, lambda v: f"u{v}"),
                ("ip1", 32 * 256, lambda v: f"10.1.{v // 256}.{v % 256}"),
                ("task", 9999, lambda v: f"t{v}"),
                ("disk", 4, lambda v: f"/dev/sd{'abcd'[v]}1"),
                ("pct", 100, lambda v: f"{v}%"))
#: per template: its dictionary and encoded variables per line
LOG_DV, LOG_EV = (2, 0, 1, 2, 2, 2), (1, 2, 2, 0, 1, 0)

#: phase 12: ann-benchmarks' deep-image-96-angular shape (9,990,000
#: vectors of d = 96, angular) as 10 segments of 999,000 docs, each with
#: its IVF layer (sqrt(999,000) = 999 cells), generated by
#: bench.py:4674-4700's clustered mixture at d = 96 (32 centres)
VEC_SEGMENTS, VEC_DOCS, VEC_DIM = 10, 999_000, 96
VEC_CENTERS = 32
VEC_CATEGORIES = 64
#: vec.4's exact-path table: segments below VectorIndex.IVF_THRESHOLD
VEC_EXACT_SEGMENTS, VEC_EXACT_DOCS = 4, 4000
#: the spawned processes that build the vector segments at the lowest CPU
#: priority from phase 3 on, each with its BLAS on one thread (a segment's
#: k-means holds a [docs, cells] float32 block: 4 GB at 999,000 docs; a
#: segment takes ~120 s on the card's host)
VEC_WORKERS = 4
_BLAS_THREADS = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                 "MKL_NUM_THREADS")
#: queries of the printed recall@10 against exact numpy ground truth
VEC_RECALL = 50
#: 9i's pool: vec.1-shaped queries over other stored vectors
VEC_POOL = 16
#: K8's scores against a float64 sum: cosines of unit vectors, rounded in
#: another order (numpy's BLAS, XLA's einsum) by a few ulps
VEC_TOL = 2.0 ** -20
#: phase 3's K8 block: the leg's 10 segments padded to 16, D = 2^20
K8_SEGMENTS, K8_D = 16, 1 << 20

#: phase 14: ClickBench's `hits` (github.com/ClickHouse/ClickBench,
#: queries.sql), generated (its data cannot be downloaded): 8 segments of
#: 2^20 rows, cut from ~100M rows because the host decodes and reduces
#: every present group in Python (the JAX package's design)
CB_SEGMENTS, CB_DOCS = 8, 1 << 20
#: the user pool, drawn zipf-skewed (p ~ rank^-CB_ZIPF: the busiest user
#: holds ~0.4% of the rows, so a grouped float32 SUM stays below 2^24 in a
#: segment); each user searches CB_USER_PHRASES phrases of the pool in
#: CB_PHRASE_SHARE of its rows (SearchPhrase '' otherwise) and stays in
#: one home region but for CB_AWAY of its rows: every segment holds
#: 2^15-2^16 (UserID, SearchPhrase) and (RegionID, UserID) tuples (G =
#: 2^16), while the dense products stay far above 2^20
CB_USERS, CB_ZIPF = 1 << 14, 0.5
CB_PHRASES, CB_USER_PHRASES, CB_PHRASE_SHARE = 50_000, 2, 0.3
CB_REGIONS, CB_AWAY = 3000, 0.03
CB_WIDTHS = (1366, 1920, 1280, 1440, 1536, 1600, 1024, 360, 375, 414, 390,
             768)
#: the pools' seed (the rows' seeds are [--seed, segment])
CB_POOL_SEED = 20_260
#: warm runs per query after the cold one
CB_ITERS = 3
CB_QUERIES = {
    # ClickBench queries.sql, verbatim
    "cb.1": "SELECT UserID, SearchPhrase, COUNT(*) FROM hits GROUP BY "
            "UserID, SearchPhrase ORDER BY COUNT(*) DESC LIMIT 10",
    "cb.2": "SELECT UserID, SearchPhrase, COUNT(*) FROM hits WHERE "
            "SearchPhrase <> '' GROUP BY UserID, SearchPhrase ORDER BY "
            "COUNT(*) DESC LIMIT 10",
    # not ClickBench's: its shape with (RegionID, UserID) keys and the
    # MIN / MAX / SUM slots
    "cb.3": "SELECT RegionID, UserID, SUM(ResolutionWidth), "
            "MIN(ResolutionWidth), MAX(ResolutionWidth), COUNT(*) FROM hits "
            "GROUP BY RegionID, UserID ORDER BY COUNT(*) DESC LIMIT 10",
    "cb.4": "SELECT DISTINCT UserID, SearchPhrase FROM hits LIMIT 100000",
}
#: phase 14's burst: CB_BURST cb.1-shaped queries over one region each,
#: held in the ring until all are queued (one batch at equal G)
CB_BURST = 8
CB_BURST_SQL = ("SELECT UserID, SearchPhrase, COUNT(*) FROM hits WHERE "
                "RegionID = {} GROUP BY UserID, SearchPhrase ORDER BY "
                "COUNT(*) DESC, UserID, SearchPhrase LIMIT 10")
#: the G every phase-14 query plans (checked there)
CB_G = 1 << 16
#: phase 3's compact-key K2 cases at phase 14's block (S = 8, D = 2^20):
#: name -> (G, cb.3's slots: else cb.2's filtered SUM and COUNT)
COMPACT_CASES = {"G=2^16 (phase 14's; cb.3's slots)": (CB_G, True),
                 "G=2^17": (1 << 17, False),
                 "G=2^20 (the cap)": (1 << 20, False)}

def log_queries() -> dict:
    """name -> (SQL, the kernel after K7) of the log leg."""
    t4, t4_end = LOG_T4, LOG_T4 + LOG_HOUR
    return {
        "logs.1": ("SELECT COUNT(*) FROM logs WHERE message LIKE "
                   "'%refused%'", "scan_agg"),
        "logs.2": ("SELECT COUNT(*) FROM logs WHERE message LIKE "
                   "'%failed on host h3:%'", "scan_agg"),
        "logs.3": ("SELECT COUNT(*) FROM logs WHERE message LIKE "
                   "'%served in 250 ms%'", "scan_agg"),
        "logs.4": (f"SELECT floor((ts - {t4}) / 60000), COUNT(*) FROM logs "
                   f"WHERE message LIKE 'ERROR%' AND ts >= {t4} AND "
                   f"ts < {t4_end} GROUP BY floor((ts - {t4}) / 60000) "
                   "LIMIT 100", "group_agg"),
        "logs.5": ("SELECT ts, message FROM logs WHERE message LIKE "
                   "'%code=503' ORDER BY ts DESC LIMIT 100", "topn"),
        "logs.6": ("SELECT COUNT(*) FROM logs WHERE (message LIKE 'WARN%' OR "
                   "message LIKE '%refused%') AND "
                   f"ts < {LOG_T0 + 12 * LOG_HOUR}", "scan_agg"),
    }


#: a pattern the planner refuses: a wildcard cuts the number 25...
LOG_WILDCARD = "SELECT COUNT(*) FROM logs WHERE message LIKE '%served in 25%'"
#: 9h: bench.py:3531's coalesce pool, one host per pattern
LOG_POOL = [f"SELECT COUNT(*) FROM logs WHERE message LIKE "
            f"'%failed on host h{i}:%'" for i in range(8)]
#: the upsert leg on phase 4's segments: segments 0-11 carry validDocIds
#: with a seeded third of docs cleared, 12-15 stay append-only; then a
#: seeded 1% of segment 3's valid docs is cleared
UPSERT_SEGMENTS = 12
#: name -> (SQL, the kernel it runs on)
UPSERT_QUERIES = {
    "q1.1": (Q1_QUERIES["q1.1"], "scan_agg"),
    "count": ("SELECT COUNT(*) FROM ssb", "scan_agg"),
    "gb": ("SELECT lo_discount, COUNT(*), MIN(lo_extendedprice), "
           "MAX(lo_quantity) FROM ssb GROUP BY lo_discount "
           "ORDER BY lo_discount LIMIT 20", "group_agg"),
    "sel.1": (SEL_QUERIES["sel.1"][0], "topn"),
    "dist.1": (DIST_QUERY, "group_agg"),
    "hll": ("SELECT DISTINCTCOUNTHLL(lo_extendedprice) FROM ssb "
            "WHERE lo_discount BETWEEN 4 AND 6", "sketch_agg"),
    "first": ("SELECT lo_orderdate, lo_extendedprice FROM ssb LIMIT 5",
              None),
}
#: BASELINE config #5 (bench_extra.py:224-234) and bench.py --startree's
#: table (bench.py:2162-2194), at the group-by leg's cut of SSB scale
ST_SEGMENTS, ST_DOCS = 8, 4_000_000
ST_TABLES = {
    # table -> (fields, star-tree config, queries: name -> (SQL, grouped))
    "ssbst": ([("lo_orderdate", "INT", False), ("lo_discount", "INT", False),
               ("lo_quantity", "INT", False), ("d_year", "INT", False),
               ("p_category", "STRING", False),
               ("s_region", "STRING", False), ("lo_revenue", "INT", True)],
              dict(dimensions_split_order=["d_year", "p_category"],
                   function_column_pairs=["SUM__lo_revenue", "COUNT__*"],
                   max_leaf_records=1000),
              {"st5.1": ("SELECT d_year, SUM(lo_revenue) FROM ssbst "
                         "GROUP BY d_year ORDER BY d_year LIMIT 100", True)}),
    "stb": ([("country", "STRING", False), ("browser", "STRING", False),
             ("locale", "STRING", False), ("impressions", "LONG", True),
             ("cost", "DOUBLE", True)],
            dict(dimensions_split_order=["country", "browser", "locale"],
                 function_column_pairs=["SUM__impressions", "MAX__cost",
                                        "SUM__cost"],
                 max_leaf_records=10),
            # bench.py:2198-2208 parity_sqls(3), verbatim
            {"stb.1": ("SELECT SUM(impressions), COUNT(*) FROM stb "
                       "WHERE country = 'c3'", False),
             "stb.2": ("SELECT SUM(impressions) FROM stb "
                       "WHERE country IN ('c1','c2','c3') AND browser = 'b2'",
                       False),
             "stb.3": ("SELECT MAX(cost), SUM(cost), COUNT(*) FROM stb",
                       False),
             "stb.4": ("SELECT browser, SUM(impressions), COUNT(*) FROM stb "
                       "WHERE locale = 'l3' "
                       "GROUP BY browser ORDER BY browser LIMIT 100", True)}),
}
NO_STAR_TREE = " OPTION(useStarTree=false)"
#: stb's strings as fixed-width numpy strings: the creator's and the
#: star-tree builder's np.unique sort them far faster than Python objects,
#: in the same order
STB_COUNTRIES = np.array([f"c{v}" for v in range(20)])
STB_BROWSERS = np.array([f"b{v}" for v in range(6)])
STB_LOCALES = np.array([f"l{v}" for v in range(10)])
#: the device sketches' shapes (DistinctCountHLL log2m, PercentileTDigest
#: DEVICE_BUCKETS) and the percentile
HLL_LOG2M, HIST_BUCKETS, PCT = 12, 8192, 95.0
REGIONS = np.array(["AMERICA", "ASIA", "EUROPE", "AFRICA"], dtype=object)
CATEGORIES = np.array([f"MFGR#{i}" for i in range(1, 6)], dtype=object)
#: SSB date keys as bench.py draws them: 1992-1998, 12 months, 28 days
DATES = np.array([y * 10000 + m * 100 + d for y in range(1992, 1999)
                  for m in range(1, 13) for d in range(1, 29)],
                 dtype=np.int32)


def ssb_q1_columns(rng, n: int) -> dict:
    """bench.py:82-116 `build_data` columns."""
    return {
        "lo_orderdate": DATES[rng.integers(0, len(DATES), n)],
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_extendedprice": rng.integers(90_000, 10_000_000, n
                                         ).astype(np.int32),
    }


def ssb_flat_columns(rng, n: int) -> dict:
    """bench_extra.py:175-187 `_ssb_flat_cols` (the same draws; strings
    picked from tables instead of formatted one by one)."""
    return {
        "lo_orderdate": rng.integers(19920101, 19981230, n).astype(np.int32),
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "p_category": CATEGORIES[rng.integers(1, 6, n) - 1],
        "s_region": REGIONS[rng.integers(0, 4, n)],
        "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int32),
    }


def q1_truth(cols: dict) -> dict:
    """Exact integer SUM(lo_extendedprice * lo_discount) and COUNT(*) of
    each Q1 query over one segment's columns."""
    out = {}
    for name, (d0, d1, c0, c1, q0, q1) in Q1_TRUTH.items():
        m = ((cols["lo_orderdate"] >= d0) & (cols["lo_orderdate"] <= d1)
             & (cols["lo_discount"] >= c0) & (cols["lo_discount"] <= c1)
             & (cols["lo_quantity"] >= q0) & (cols["lo_quantity"] <= q1))
        prod = cols["lo_extendedprice"][m].astype(np.int64) \
            * cols["lo_discount"][m]
        out[name] = (int(prod.sum()), int(m.sum()))
    return out


def groupby_truth(cols: dict) -> dict:
    """(d_year, p_category) -> exact SUM(lo_revenue) over one segment,
    WHERE s_region = 'AMERICA'."""
    m = cols["s_region"] == "AMERICA"
    years = cols["d_year"][m]
    cats = cols["p_category"][m]
    rev = cols["lo_revenue"][m].astype(np.int64)
    out = {}
    for y in np.unique(years):
        for c in CATEGORIES:
            sel = (years == y) & (cats == c)
            if sel.any():
                out[(int(y), str(c))] = int(rev[sel].sum())
    return out


def raw_moments(values: np.ndarray) -> tuple:
    """(count, sum, sum of squares, of cubes, of fourth powers, min, max)
    of integer values, exactly (Python ints; min / max None when empty)."""
    x = values.astype(np.int64)
    return (len(x),) + tuple(int((x ** k).sum()) for k in range(1, 5)) \
        + ((int(x.min()), int(x.max())) if len(x) else (None, None))


def moment_values(parts: list) -> dict:
    """Every moment and boolean aggregation over the union of the raw
    moments `parts`: the central moments from the exact sums in rational
    arithmetic, rounded once to float. A value is true when it is 1 or more
    (the columns are non-negative integers)."""
    from fractions import Fraction
    n, s1, s2, s3, s4 = (sum(p[k] for p in parts) for k in range(5))
    lo = min(p[5] for p in parts if p[0])
    hi = max(p[6] for p in parts if p[0])
    m2 = Fraction(n * s2 - s1 * s1, n * n)
    m3 = Fraction(n * n * s3 - 3 * n * s1 * s2 + 2 * s1 ** 3, n ** 3)
    m4 = Fraction(n ** 3 * s4 - 4 * n * n * s1 * s3
                  + 6 * n * s1 * s1 * s2 - 3 * s1 ** 4, n ** 4)
    samp = m2 * n / (n - 1)
    return {"variance": float(m2), "var_samp": float(samp),
            "stddev": float(m2) ** 0.5, "stddev_samp": float(samp) ** 0.5,
            "skewness": float(m3) / float(m2) ** 1.5,
            "kurtosis": float(m4 / (m2 * m2)) - 3.0,
            "bool_and": lo >= 1, "bool_or": hi >= 1}


def moments_truth(cols: dict) -> dict:
    """MOM_QUERY's raw moments over one Q1-leg segment (column ->
    raw_moments), or GB_MOM_QUERY's over one group-by-leg segment (d_year
    -> column -> raw_moments)."""
    if "lo_extendedprice" in cols:
        m = (cols["lo_orderdate"] >= 19930101) \
            & (cols["lo_orderdate"] <= 19931231) \
            & (cols["lo_discount"] >= 1) & (cols["lo_discount"] <= 3)
        return {c: raw_moments(cols[c][m])
                for c in ("lo_quantity", "lo_discount")}
    m = (cols["s_region"] == "ASIA") & (cols["lo_discount"] < 2)
    out = {}
    for y in np.unique(cols["d_year"][m]):
        sel = m & (cols["d_year"] == y)
        out[int(y)] = {c: raw_moments(cols[c][sel])
                       for c in ("lo_quantity", "lo_discount")}
    return out


def moments_error(row, parts: list, columns: list):
    """(the largest |got - exact| / max(1, |exact|) over the row's
    moments, its first disagreement or None) of one result row against
    the raw moments `parts` (column -> raw_moments, one per segment);
    `columns` the row's (aggregation, column) pairs."""
    worst, bad = 0.0, None
    for got, (agg, col) in zip(row, columns):
        want = moment_values([p[col] for p in parts])[agg]
        if agg.startswith("bool_"):
            if bool(got) is not want:
                bad = bad or f"{agg}({col}) {got} vs numpy truth {want}"
            continue
        err = abs(float(got) - want) / max(1.0, abs(want))
        worst = max(worst, err)
        if not err <= MOM_TOL:
            bad = bad or f"{agg}({col}) {got} vs numpy truth {want}"
    return worst, bad


def check_moments(rows, truths: list, grouped: bool) -> float:
    """MOM_QUERY's rows (grouped: GB_MOM_QUERY's) against the numpy truth
    of the segments whose moments_truth are `truths`: fails on any
    disagreement; returns the largest relative error."""
    if not grouped:
        worst, bad = moments_error(rows[0], truths, MOM_COLUMNS)
        if bad:
            fail(f"moments: {bad}")
        return worst
    years = sorted(set().union(*truths))
    if [int(r[0]) for r in rows] != years:
        fail(f"grouped moments: groups {[r[0] for r in rows]} vs numpy "
             f"truth {years}")
    worst = 0.0
    for r in rows:
        err, bad = moments_error(r[1:], [t[int(r[0])] for t in truths
                                         if int(r[0]) in t], GB_MOM_COLUMNS)
        if bad:
            fail(f"grouped moments, d_year {r[0]}: {bad}")
        worst = max(worst, err)
    return worst


def selection_truth(cols: dict, valid=None) -> dict:
    """Per selection query over one segment's columns, computed with numpy
    apart from the port: (the matched count, the winners in the kernel's
    order as (exact order value, row over SSB_COLS)). Winners: the first k
    of np.lexsort on (doc, -score), k = limit + offset; sel.4's score is
    the float32 product the kernel rounds. Also dist.1's (discount,
    quantity) pairs present. valid: the docs an upsert left valid (None:
    all)."""
    date, disc, qty, price = (cols[c] for c in SSB_COLS)
    jan94 = (date >= 19940101) & (date <= 19940131)
    if valid is None:
        valid = np.ones(len(date), dtype=bool)
    specs = {  # name -> (kept, score or None, exact order value)
        "sel.1": (jan94 & (disc >= 4) & (disc <= 6), price, price),
        "sel.2": (qty < 25, -date.astype(np.int64), date),
        "sel.3": ((disc == 7) & (qty >= 26) & (qty <= 35), None, None),
        "sel.4": ((date >= 19930101) & (date <= 19931231),
                  price.astype(np.float32) * disc.astype(np.float32),
                  price.astype(np.int64) * disc),
    }
    out = {}
    for name, (kept, score, value) in specs.items():
        _sql, limit, offset, _asc = SEL_QUERIES[name]
        kept = kept & valid
        docs = np.nonzero(kept)[0]
        if score is not None:
            docs = docs[np.lexsort((docs, -score[docs]))]
        docs = docs[:limit + offset]
        rows = [(None if value is None else int(value[d]),
                 tuple(int(cols[c][d]) for c in SSB_COLS)) for d in docs]
        out[name] = (int(kept.sum()), rows)
    jan94 &= valid
    out["dist.1"] = set(zip(disc[jan94].tolist(), qty[jan94].tolist()))
    return out


def selection_expected(truths: list, name: str, columns: list):
    """The response a selection query must give over segments whose
    selection_truth are `truths`, in segment order: their winners
    concatenated and stably sorted by the exact order value (rows that tie
    keep segment order, as the broker's reduce keeps them), then OFFSET and
    LIMIT; rows over `columns`. Returns (rows, total matched)."""
    _sql, limit, offset, asc = SEL_QUERIES[name]
    rows = [r for t in truths for r in t[name][1]]
    if rows and rows[0][0] is not None:
        rows = sorted(rows, key=lambda r: r[0] if asc else -r[0])
    pick = [SSB_COLS.index(c) for c in columns]
    return ([tuple(r[1][i] for i in pick)
             for r in rows[offset:offset + limit]],
            sum(t[name][0] for t in truths))


def q1_sql(d0, d1, c0, c1, q0, q1, table="ssb") -> str:
    return ("SELECT SUM(lo_extendedprice * lo_discount), COUNT(*) "
            f"FROM {table} WHERE lo_orderdate BETWEEN {d0} AND {d1} "
            f"AND lo_discount BETWEEN {c0} AND {c1} "
            f"AND lo_quantity BETWEEN {q0} AND {q1}")


def q1_window_truth(cols: dict, d0, d1, c0, c1, q0, q1):
    """Exact (SUM(lo_extendedprice * lo_discount), COUNT(*)) of one
    Q1-shaped window over one segment's columns."""
    m = ((cols["lo_orderdate"] >= d0) & (cols["lo_orderdate"] <= d1)
         & (cols["lo_discount"] >= c0) & (cols["lo_discount"] <= c1)
         & (cols["lo_quantity"] >= q0) & (cols["lo_quantity"] <= q1))
    prod = cols["lo_extendedprice"][m].astype(np.int64) \
        * cols["lo_discount"][m]
    return int(prod.sum()), int(m.sum())


def sel_pool_sql(d0, d1, c0, c1) -> str:
    return ("SELECT lo_orderdate, lo_discount, lo_quantity, "
            "lo_extendedprice FROM ssb WHERE lo_orderdate BETWEEN "
            f"{d0} AND {d1} AND lo_discount BETWEEN {c0} AND {c1} "
            "ORDER BY lo_extendedprice DESC LIMIT 10")


def sel_pool_truth(cols: dict, d0, d1, c0, c1):
    """(matched, the top 10 as (price, row over SSB_COLS)) of one
    sel.1-shaped query over one segment: np.lexsort on (doc, -price)."""
    date, disc, _qty, price = (cols[c] for c in SSB_COLS)
    kept = (date >= d0) & (date <= d1) & (disc >= c0) & (disc <= c1)
    docs = np.nonzero(kept)[0]
    docs = docs[np.lexsort((docs, -price[docs]))][:10]
    return int(kept.sum()), [(int(price[d]),
                              tuple(int(cols[c][d]) for c in SSB_COLS))
                             for d in docs]


def q1_leg_truth(cols: dict) -> dict:
    return {"q1": q1_truth(cols), "sel": selection_truth(cols),
            "mse": mse_truth(cols),
            "mom": moments_truth(cols),
            "q1pool": [q1_window_truth(cols, *w) for w in Q1_POOL],
            "selpool": [sel_pool_truth(cols, *w) for w in SEL_POOL]}


def gb_pool_sql(region, c0, c1) -> str:
    return ("SELECT d_year, p_category, SUM(lo_revenue), COUNT(*) "
            f"FROM ssbgb WHERE s_region = '{region}' AND lo_discount "
            f"BETWEEN {c0} AND {c1} GROUP BY d_year, p_category "
            "ORDER BY d_year, p_category LIMIT 100")


def gb_pool_truth(cols: dict, region, c0, c1) -> dict:
    """(d_year, p_category) -> exact (SUM(lo_revenue), COUNT(*)) of one
    config-#3-shaped group-by over one segment."""
    m = (cols["s_region"] == region) & (cols["lo_discount"] >= c0) \
        & (cols["lo_discount"] <= c1)
    keys = cols["d_year"][m].astype(np.int64) * 8 \
        + np.searchsorted(CATEGORIES, cols["p_category"][m])
    rev = cols["lo_revenue"][m].astype(np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=rev, minlength=len(uniq))
    cnts = np.bincount(inv, minlength=len(uniq))
    return {(int(k // 8), str(CATEGORIES[k % 8])): (int(round(sm)), int(c))
            for k, sm, c in zip(uniq, sums, cnts)}


def groupby_leg_truth(cols: dict) -> dict:
    """groupby_truth, the (p_category, s_region) pairs present in d_year
    1995 (GB_DISTINCT), and the 9d pool's group-bys."""
    y95 = cols["d_year"] == 1995
    return {"gb": groupby_truth(cols), "mom": moments_truth(cols),
            "dist": set(zip(cols["p_category"][y95].tolist(),
                            cols["s_region"][y95].tolist())),
            "gbpool": [gb_pool_truth(cols, *w) for w in GB_POOL]}


def b9_sql(table: str, a: int) -> str:
    """bench.py:1786 `sql_for`."""
    return q1_sql(19940101, 19940131, a, a + 2, 26, 35, table)


def b9_truth(cols: dict) -> dict:
    return {a: q1_window_truth(cols, 19940101, 19940131, a, a + 2, 26, 35)
            for a in B9_DISCOUNTS}


def stb_columns(rng, n: int) -> dict:
    """bench.py:2176-2188's draws (the strings picked from tables instead
    of formatted one by one)."""
    return {
        "country": STB_COUNTRIES[rng.integers(0, 20, n)],
        "browser": STB_BROWSERS[rng.integers(0, 6, n)],
        "locale": STB_LOCALES[rng.integers(0, 10, n)],
        "impressions": rng.integers(0, 1000, n).astype(np.int64),
        "cost": rng.random(n) * 100,
    }


def st_pool_sql(category, y0, y1) -> str:
    return ("SELECT d_year, SUM(lo_revenue) FROM ssbst "
            f"WHERE p_category = '{category}' AND d_year BETWEEN {y0} "
            f"AND {y1} GROUP BY d_year ORDER BY d_year LIMIT 100")


def startree_truth(cols: dict) -> dict:
    """The star-tree leg's answers over one segment's columns, in numpy:
    per query the partial rows that startree_expected merges (ssbst: also
    each 9f pool query's d_year -> SUM(lo_revenue))."""
    if "d_year" in cols:
        rev = cols["lo_revenue"].astype(np.int64)
        year, cat = cols["d_year"], cols["p_category"]
        pool = []
        for c, y0, y1 in ST_POOL:
            m = (cat == c) & (year >= y0) & (year <= y1)
            pool.append({int(y): int(rev[m & (year == y)].sum())
                         for y in np.unique(year[m])})
        return {"st5.1": {int(y): int(rev[year == y].sum())
                          for y in np.unique(year)}, "stpool": pool}
    imp, cost = cols["impressions"], cols["cost"]
    c3 = cols["country"] == "c3"
    q2 = np.isin(cols["country"], ["c1", "c2", "c3"]) \
        & (cols["browser"] == "b2")
    l3 = cols["locale"] == "l3"
    return {"stb.1": (int(imp[c3].sum()), int(c3.sum())),
            "stb.2": int(imp[q2].sum()),
            "stb.3": (float(cost.max()), float(cost.sum()), len(cost)),
            "stb.4": {str(b): (int(imp[l3 & (cols["browser"] == b)].sum()),
                               int((l3 & (cols["browser"] == b)).sum()))
                      for b in np.unique(cols["browser"][l3])}}


def startree_expected(truths: list, name: str) -> list:
    """A star-tree leg query's rows from the per-segment truths: integer
    sums and counts as Python ints, float sums and the max as floats."""
    parts = [t[name] for t in truths]
    if name == "st5.1":
        years = sorted(set().union(*parts))
        return [(y, sum(p.get(y, 0) for p in parts)) for y in years]
    if name == "stb.1":
        return [(sum(p[0] for p in parts), sum(p[1] for p in parts))]
    if name == "stb.2":
        return [(sum(parts),)]
    if name == "stb.3":
        return [(max(p[0] for p in parts), float(sum(p[1] for p in parts)),
                 sum(p[2] for p in parts))]
    keys = sorted(set().union(*parts))
    return [(b, sum(p.get(b, (0, 0))[0] for p in parts),
             sum(p.get(b, (0, 0))[1] for p in parts)) for b in keys]


def rows_agree(got, want, exact_ints: bool) -> bool:
    """Rows equal: strings and (where exact_ints) integers exactly, other
    numbers within rel 1e-6."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(b, str) or (exact_ints and isinstance(b, int)):
                if not (a == b if isinstance(b, str)
                        else float(a) == float(b)):
                    return False
            elif abs(float(a) - float(b)) > 1e-6 * abs(float(b)):
                return False
    return True


def taxi_columns(rng, n: int) -> dict:
    """bench_extra.py:200-209 `config4_distinct_percentile` columns."""
    return {
        "trip_id": rng.integers(0, 1 << 40, n).astype(np.int64),
        "fare": np.round(rng.gamma(2.5, 8.0, n), 2),
    }


def taxi_masks(cols: dict) -> dict:
    """Each config-#4 query's filter over one segment's columns; the fare
    range compares the float32 values the engine stages."""
    f32 = cols["fare"].astype(np.float32)
    return {"q4.1": np.ones(len(f32), dtype=bool),
            "q4.2": (f32 >= np.float32(10)) & (f32 <= np.float32(40)),
            "q4.3": cols["trip_id"] < (1 << 39)}


def taxi_truth(cols: dict) -> dict:
    """Per query, over one segment: the port's numpy HLL registers of the
    kept trip_ids, and the count of each kept fare in cents (fares are
    rounded to cents, so a value is cents / 100 exactly)."""
    from pinot_tpu_torch.query.sketches import HyperLogLog
    cents = np.rint(cols["fare"] * 100).astype(np.int64)
    out = {}
    for name, m in taxi_masks(cols).items():
        hll = HyperLogLog(HLL_LOG2M)
        hll.add_array(cols["trip_id"][m])
        out[name] = (hll.registers, np.bincount(cents[m]))
    return out


def taxi_expected(truths: list, segs: list) -> dict:
    """Per query: (the HLL cardinality, the p95 the engine must give, the
    exact 95th percentile). The p95 repeats the engine's arithmetic on a
    numpy histogram: bounds from the segments' fare min and max, bucket =
    clip((f32(v) - f32(lo)) * f32(B / span), 0, B - 1), one digest per
    segment merged in segment order."""
    from pinot_tpu_torch.query.sketches import HyperLogLog, TDigest
    metas = [s.metadata.columns["fare"] for s in segs]
    lo = min(float(m.min_value) for m in metas)
    span = max(max(float(m.max_value) for m in metas) - lo, 1e-30)
    out = {}
    for name in TAXI_QUERIES:
        regs = np.zeros(1 << HLL_LOG2M, dtype=np.uint8)
        width = max(len(t[name][1]) for t in truths)
        total = np.zeros(width, dtype=np.int64)
        v32 = (np.arange(width) / 100.0).astype(np.float32)
        t = np.clip((v32 - np.float32(lo)) * np.float32(HIST_BUCKETS / span),
                    0, HIST_BUCKETS - 1)
        bucket = t.astype(np.int64)
        digest = TDigest(100.0)
        for tr in truths:
            r, counts = tr[name]
            np.maximum(regs, r, out=regs)
            total[:len(counts)] += counts
            hist = np.bincount(bucket[:len(counts)], weights=counts,
                               minlength=HIST_BUCKETS)
            digest = digest.merge(TDigest.from_histogram(
                lo, span / HIST_BUCKETS, hist))
        # np.percentile's linear rule over the sorted kept fares
        n = int(total.sum())
        h = PCT / 100.0 * (n - 1)
        cum = np.cumsum(total)
        a, b = (np.searchsorted(cum, k, side="right") / 100.0
                for k in (int(np.floor(h)), min(int(np.floor(h)) + 1, n - 1)))
        exact = a + (b - a) * (h - np.floor(h))
        out[name] = (HyperLogLog.from_registers(regs, HLL_LOG2M)
                     .cardinality(), digest.quantile(PCT / 100.0), exact, n)
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Median of `iters` CUDA-event timings of fn() (after one warm-up).
    A spin kernel ahead of each timed launch keeps the card busy while the
    host enqueues the launch, so the events bracket device time only."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(diff.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(seed: int, grouped: bool):
    """Seeded inputs at the main path's shapes, made on the card."""
    import torch

    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)

    if not grouped:
        S, D = Q1_SEGMENTS, 1 << 23
        cols = {"ids:date": ints(0, 2352, (S, D), torch.int16),
                "ids:disc": ints(0, 11, (S, D), torch.int8),
                "ids:qty": ints(0, 50, (S, D), torch.int8),
                "val:price": ints(90_000, 10_000_000, (S, D), torch.float32),
                "val:disc": ints(0, 11, (S, D), torch.float32)}
        leaves = (DeviceLeaf("range", "date"), DeviceLeaf("lut", "disc"),
                  DeviceLeaf("neq", "qty"))
        filter_ir = ("and", ("leaf", 0), ("leaf", 1), ("not", ("leaf", 2)))
        value_irs = (("mul", ("col", "price"), ("col", "disc")),)
        agg_ops = (("count", None, None), ("sum", 0, None), ("min", 0, None),
                   ("max", 0, None), ("isum:u4", 0, None))
        plan = DevicePlan(filter_ir=filter_ir, leaves=leaves,
                          value_irs=value_irs, agg_ops=agg_ops,
                          dict_cols=("date", "disc", "qty"),
                          raw_cols=("price",))
        lo = ints(0, 600, (S,), torch.int32)
        params = {"leaf0:lo": lo, "leaf0:hi": lo + 1200,
                  "leaf1:lut": torch.rand((S, 16), generator=g,
                                          device=dev) < 0.3,
                  "leaf2:idx": ints(0, 50, (S,), torch.int32)}
        params["leaf0:hi"][0] = 2**31 - 1  # the 'all' sentinel
        # the last segment is padding, as a bucketed segment axis makes it
        num_docs = torch.full((S,), Q1_DOCS, dtype=torch.int32, device=dev)
        num_docs[-1] = 0
    else:
        S, D = GB_SEGMENTS, 1 << 22
        cols = {"ids:year": ints(0, 7, (S, D), torch.int8),
                "ids:cat": ints(0, 5, (S, D), torch.int8),
                "ids:region": ints(0, 4, (S, D), torch.int8),
                "ids:qty": ints(0, 50, (S, D), torch.int8),
                "val:rev": ints(100, 1_000_000, (S, D), torch.float32)}
        leaves = (DeviceLeaf("range", "region"), DeviceLeaf("lut", "qty"),
                  DeviceLeaf("neq", "year"))
        filter_ir = ("and", ("leaf", 0), ("or", ("leaf", 1),
                                          ("not", ("leaf", 2))))
        plan = DevicePlan(filter_ir=filter_ir, leaves=leaves,
                          value_irs=(("col", "rev"),),
                          agg_ops=(("sum", 0, None), ("min", 0, None),
                                   ("max", 0, None), ("count", None, None)),
                          group_cols=("year", "cat"), group_strides=(5, 1),
                          num_groups=35, dict_cols=("year", "cat", "region",
                                                    "qty"),
                          raw_cols=("rev",))
        params = {"leaf0:lo": ints(0, 2, (S,), torch.int32),
                  "leaf0:hi": ints(2, 4, (S,), torch.int32),
                  "leaf1:lut": torch.rand((S, 64), generator=g,
                                          device=dev) < 0.5,
                  "leaf2:idx": ints(0, 7, (S,), torch.int32)}
        num_docs = torch.full((S,), GB_DOCS, dtype=torch.int32, device=dev)
    return plan, cols, params, num_docs, D


def sketch_kernel_inputs(seed: int):
    """K3's seeded inputs at the config-#4 leg's block width, made on the
    card: longs below 2^55 as (hi, lo) i32 planes (0, -1, 1 and the most
    negative admissible among them), f32 values with NaN, +-inf and the
    histogram's bounds, a filter of range / lut / vrange64 leaves."""
    import torch

    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)

    S, D = Q1_SEGMENTS, 1 << 23
    hi = ints(-(1 << 31) + 1, 1 << 31, (S, D), torch.int32)
    lo = ints(0, 1 << 24, (S, D), torch.int32)
    # v = 0, -1, 1, -(2^55 - 2^24)
    hi[:, :4] = torch.tensor([0, -1, 0, -(1 << 31) + 1], dtype=torch.int32,
                             device=dev)
    lo[:, :4] = torch.tensor([0, (1 << 24) - 1, 1, 0], dtype=torch.int32,
                             device=dev)
    fare = torch.rand((S, D), generator=g, device=dev) * 250 - 25
    h_lo, h_span = 0.0, 200.0
    fare[:, 4:9] = torch.tensor([float("nan"), float("inf"), float("-inf"),
                                 h_lo, h_lo + h_span], device=dev)
    cols = {"ids:a": ints(0, 2000, (S, D), torch.int16),
            "ids:b": ints(0, 100, (S, D), torch.int8),
            "valhi:t": hi, "vallo:t": lo, "val:fare": fare}
    leaves = (DeviceLeaf("range", "a"), DeviceLeaf("lut", "b"),
              DeviceLeaf("vrange64", "t"))
    plan = DevicePlan(
        filter_ir=("or", ("and", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
        leaves=leaves, value_irs=(("col", "fare"),),
        agg_ops=(("hll:12:t", None, None), ("hll:16:t", None, None),
                 (f"hist:{HIST_BUCKETS}", 0, None)),
        dict_cols=("a", "b"), raw_cols=("fare",), raw64_cols=("t",))
    a_lo = ints(0, 800, (S,), torch.int32)
    v_lo, v_hi = -(1 << 54), 1 << 54

    def planes(v):
        return (torch.full((S,), v >> 24, dtype=torch.int32, device=dev),
                torch.full((S,), v & 0xFFFFFF, dtype=torch.int32,
                           device=dev))
    params = {"leaf0:lo": a_lo, "leaf0:hi": a_lo + 1200,
              "leaf1:lut": torch.rand((S, 128), generator=g,
                                      device=dev) < 0.3,
              "slot2:hlo": torch.full((S,), h_lo, device=dev),
              "slot2:hscale": torch.full((S,), HIST_BUCKETS / h_span,
                                         device=dev)}
    params["leaf2:lohi"], params["leaf2:lolo"] = planes(v_lo)
    params["leaf2:hihi"], params["leaf2:hilo"] = planes(v_hi)
    num_docs = torch.full((S,), Q1_DOCS, dtype=torch.int32, device=dev)
    num_docs[-1] = 0
    return plan, cols, params, num_docs, D


def histc_ms(plan, cols, params, num_docs) -> float:
    """torch.histc over the histogram slot's input, every real doc,
    unfiltered: the PyTorch call nearest K3's histogram (its edges and its
    NaN handling differ, so only its time is kept)."""
    import torch
    j, (op, vidx, _f) = next((j, s) for j, s in enumerate(plan.agg_ops)
                            if s[0].startswith("hist:"))
    vals = cols["val:" + plan.value_irs[vidx][1]][num_docs > 0]
    vals = torch.nan_to_num(vals.reshape(-1), nan=0.0)
    lo = float(params[f"slot{j}:hlo"][0])
    hi = lo + HIST_BUCKETS / float(params[f"slot{j}:hscale"][0])
    return cuda_ms(lambda: torch.histc(vals, bins=HIST_BUCKETS, min=lo,
                                       max=hi))


def check_kernel(name: str, plan, cols, params, num_docs, D,
                 G: int = 0) -> dict:
    """One kernel against its plain version on the card (G: a compact-key
    plan's group count): returns its entry of the `kernels` line
    (launches filled in by the legs)."""
    import torch

    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.ops.plan_ir import is_grouped
    kern = kernels.make_kernel(plan, torch.float32)
    plain = kernels.plain_kernel(plan, torch.float32)
    out = kern(cols, params, num_docs, D, G)
    ref = plain(cols, params, num_docs, D, G)
    scales = kernels.abs_contributions(plan, cols, params, num_docs, D, G)
    torch.cuda.synchronize()
    compare_packed(name, plan, out, ref, scales)
    moved, matched = bytes_needed(plan, cols, params, num_docs, D, out)
    ms = cuda_ms(lambda: kern(cols, params, num_docs, D, G))
    plain_ms = cuda_ms(lambda: plain(cols, params, num_docs, D, G))
    entry = {"max_abs_err": max_abs_err(out, ref), "ms": ms,
             "plain_ms": plain_ms,
             "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": None, "rows": int(num_docs.sum()),
             "matched": matched, "bytes": moved}
    if is_grouped(plan):
        entry["tier"] = group_tier_of(plan, out.shape[-2])
    if plan.group_compact:
        entry["scratch_bytes"] = scratch_bytes(out)
    return entry


def group_tier_of(plan, G: int) -> str:
    """K2's table tier for a float32 launch of `plan` at G."""
    from pinot_tpu_torch.ops import _cuda
    return _cuda.group_tier([op for op, _v, _f in plan.agg_ops], G, False)


def compare_packed(name: str, plan, out, ref, scales) -> None:
    """A kernel's packed output against its reference: counts, exact-sum
    planes, min / max (the sign of a zero and a NaN's bits too),
    registers and buckets bit for bit, float sums
    within 1e-5 of the slot's sum of |contribution| (`scales`); a top-N
    output whole, bit for bit."""
    import torch

    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.ops.plan_ir import is_grouped
    if out.shape != ref.shape:
        fail(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if plan.mode == "topn":
        if not torch.equal(out, ref):
            bad = (out != ref).nonzero()[:5].tolist()
            fail(f"{name}: differs at {bad}")
        return
    grouped = is_grouped(plan)
    col = 0 if grouped else 1
    if not grouped and not torch.equal(out[:, 0], ref[:, 0]):
        fail(f"{name}: matched counts differ")
    for j, (op, _v, _f) in enumerate(plan.agg_ops):
        w = kernels.slot_width(op)
        a = out[..., j] if grouped else out[:, col:col + w]
        b = ref[..., j] if grouped else ref[:, col:col + w]
        col += w
        if op == "sum":
            scale = scales[j] if grouped else scales[j][:, None]
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            err = torch.where(same, 0.0, (a.double() - b.double()).abs())
            if not bool((err <= 1e-5 * scale + 1e-30).all()):
                fail(f"{name}: slot {j} sum beyond 1e-5 of sum|contrib|: "
                     f"max err {float(err.max())}")
        elif not torch.equal(bits(a), bits(b)):
            fail(f"{name}: slot {j} {op} not bit-identical")


def bits(t):
    """A float tensor's bits as integers: a bit-for-bit compare that tells
    -0.0 from +0.0 and holds a NaN equal to the same NaN."""
    import torch
    t = t.contiguous()
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def filter_leaves(node) -> set:
    """Indices of the leaves a filter tree reads."""
    if node is None:
        return set()
    if node[0] == "leaf":
        return {node[1]}
    return set().union(*(filter_leaves(n) for n in node[1:]))


def leaf_columns(leaf) -> tuple:
    """The staged columns a filter leaf reads."""
    if leaf.kind == "vrange":
        return ("val:" + leaf.column,)
    if leaf.kind == "vrange64":
        return ("valhi:" + leaf.column, "vallo:" + leaf.column)
    return ("ids:" + leaf.column,)


def scratch_bytes(out) -> int:
    """A compact-key K2 launch's scratch traffic, reported beside its
    bound and not in it (the table is the kernel's design, not the
    function's): the u64 table's memset and its decode pass's read,
    B x S x G x n_slots words each."""
    return 2 * 8 * out.numel()


def bytes_needed(plan, cols, params, num_docs, D, out):
    """The bytes the kernel's function must move on these inputs, and the
    docs its filter keeps (batch_bytes of one member)."""
    return batch_bytes(plan, [cols], [params], [num_docs], [0], D, out)


def batch_bytes(plan, col_sets, plist, ndlist, idx, D, out):
    """The bytes a launch of members over column sets (member m over set
    idx[m]) must move, and the docs their filters keep: each set's main
    filter columns for every real doc, once; every other column the plan
    reads (value inputs, group keys, order values, the split planes an
    HLL slot hashes or a time bucket reads) only in the SECTOR-byte
    sectors that hold a doc some member over that set keeps (a time
    bucket's gate included), once; each member's parameters, each set's
    num_docs and the output once. Under an upsert validity mask: its byte
    for every real doc, and the filter's columns only in the sectors
    holding a valid doc."""
    import torch

    from pinot_tpu_torch.ops import kernels, program
    full = {c for i in filter_leaves(plan.filter_ir)
            for c in leaf_columns(plan.leaves[i])}
    moved, matched = 0, 0
    for u, (cols, num_docs) in enumerate(zip(col_sets, ndlist)):
        real = torch.arange(D, device=num_docs.device)[None, :] \
            < num_docs[:, None]
        # under an upsert validity mask: its byte for every real doc, and
        # the filter's columns in the sectors holding a valid doc
        valid = kernels.doc_validity(plan, cols, num_docs, D)
        if plan.valid_mask:
            moved += int(real.sum())
        kept = torch.zeros_like(valid)
        for params in [p for p, v in zip(plist, idx) if v == u]:
            mask = valid if plan.filter_ir is None else valid \
                & kernels.eval_filter(plan.filter_ir, plan, cols, params)
            if plan.tbucket:
                mask = mask & kernels.group_keys(plan, cols, params,
                                                 mask.shape)[1]
            kept |= mask
            matched += int(mask.sum())

        def sectors(docs, size):
            return SECTOR * int(docs.view(docs.shape[0], -1,
                                          SECTOR // size).any(-1).sum())
        for name in program.compile_plan(plan).cols:
            size = cols[name].element_size()
            if name in full and not plan.valid_mask:
                moved += int(real.sum()) * size
            else:
                moved += sectors(valid if name in full else kept, size)
        moved += num_docs.numel() * num_docs.element_size()
    moved += sum(v.numel() * v.element_size()
                 for params in plist for v in params.values()) \
        + out.numel() * out.element_size()
    return moved, matched


def topn_kernel_inputs(seed: int) -> dict:
    """K4's four phase-3 cases at the Q1 leg's block width, made on the
    card: name -> (plan, cols, params, num_docs, D). i16 / i8 id filters
    (range, lut, neq) keep about 50% ('wide') or 0.3% ('narrow') of the
    docs; the f32 order values are small integers (dense ties) with NaN,
    +-inf, -0.0 and +0.0 among them; the last segment is padding."""
    import torch

    from pinot_tpu_torch.ops import program
    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)

    S, D = Q1_SEGMENTS, 1 << 23
    v = ints(-4, 5, (S, D), torch.float32)
    special = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0,
                            0.0], device=dev)
    pick = torch.rand((S, D), generator=g, device=dev) < 0.05
    v[pick] = special[ints(0, 5, (int(pick.sum()),), torch.int64)]
    cols = {"ids:f16": ints(0, 2000, (S, D), torch.int16),
            "ids:f8": ints(0, 100, (S, D), torch.int8),
            "ids:o16": ints(0, 30000, (S, D), torch.int16), "val:v": v}
    lo = ints(0, 100, (S,), torch.int32)
    wide = dict(filter_ir=("and", ("leaf", 0), ("leaf", 1), ("leaf", 2)),
                leaves=(DeviceLeaf("range", "f16"), DeviceLeaf("neq", "f8"),
                        DeviceLeaf("lut", "f8")))
    wide_params = {"leaf0:lo": lo, "leaf0:hi": lo + 999,
                   "leaf1:idx": ints(0, 100, (S,), torch.int32),
                   "leaf2:lut": torch.rand((S, 128), generator=g,
                                           device=dev) < 0.99}
    narrow = dict(filter_ir=("and", ("leaf", 0), ("leaf", 1)),
                  leaves=(DeviceLeaf("range", "f16"),
                          DeviceLeaf("lut", "f8")))
    narrow_params = {"leaf0:lo": lo, "leaf0:hi": lo + 19,
                     "leaf1:lut": torch.rand((S, 128), generator=g,
                                             device=dev) < 0.3}
    num_docs = torch.full((S,), Q1_DOCS, dtype=torch.int32, device=dev)
    num_docs[-1] = 0
    cases = {  # name -> (filter, order value, ascending, k)
        "a: raw value DESC k=10": (narrow, ("col", "v"), False, 10),
        "b: raw value ASC k=8192": (wide, ("col", "v"), True, 8192),
        "c: unordered k=1000": (wide, None, True, 1000),
        "d: ids ASC k=1000": (narrow, ("ids", "o16"), True, 1000),
    }
    out = {}
    for name, (filt, ir, asc, k) in cases.items():
        plan = DevicePlan(**filt, value_irs=() if ir is None else (ir,),
                          agg_ops=(), dict_cols=("f16", "f8", "o16"),
                          raw_cols=("v",), mode="topn", topn_k=k,
                          topn_asc=asc)
        params = wide_params if filt is wide else narrow_params
        used = set(program.compile_plan(plan).cols)
        out[name] = (plan, {c: t for c, t in cols.items() if c in used},
                     params, num_docs, D)
    return out


def check_topn(name: str, plan, cols, params, num_docs, D) -> dict:
    """K4 against its plain version on the card, bit for bit over the whole
    [S, 1 + k] output; returns the case's entry (times, bound, the
    torch.topk yardstick)."""
    import torch

    from pinot_tpu_torch.ops import kernels
    kern = kernels.make_topn_kernel(plan, torch.float32)

    def plain():
        return kernels.topn_kernel(plan, cols, params, num_docs, D,
                                   torch.float32)
    out, peak = with_peak(lambda: kern(cols, params, num_docs, D))
    ref = plain()
    torch.cuda.synchronize()
    compare_packed(f"topn {name}", plan, out, ref, None)
    moved, matched = bytes_needed(plan, cols, params, num_docs, D, out)
    ms = cuda_ms(lambda: kern(cols, params, num_docs, D))
    plain_ms = cuda_ms(plain)
    _mask, score = kernels.topn_scores(plan, cols, params, num_docs, D,
                                       torch.float32)
    k = out.shape[1] - 1
    library_ms = cuda_ms(lambda: torch.topk(score, k, dim=1))
    return {"case": name, "max_abs_err": max_abs_err(out, ref), "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms,
            "library": "torch.topk over the masked score block (no tie "
                       "order: time only)",
            "rows": int(num_docs.sum()), "matched": matched, "k": k,
            "bytes": moved, "launch_peak_bytes": peak}


def with_peak(fn):
    """fn()'s result and the device memory it allocated at its peak, over
    what was allocated before (its scratch and output)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def batched_inputs(inputs_fn, seed: int):
    """Phase 3b's members on phase 3's inputs: member m's literal set and
    column set m from inputs_fn(seed + 100 + m), each set its own seeded
    data. Returns (plan, col_sets, params per member, num_docs per set,
    D)."""
    plan, sets, plist, ndlist = None, [], [], []
    for m in range(BATCH_B):
        plan, cols, params, num_docs, D = inputs_fn(seed + 100 + m)
        sets.append(cols)
        plist.append(params)
        ndlist.append(num_docs)
    return plan, sets, plist, ndlist, D


def check_batched(name: str, plan, sets, plist, ndlist, D) -> dict:
    """A kernel's query axis against its plain batched version and each
    member's own single launch, in the three forms of BATCH_FORMS; returns
    the times, bounds and errors per form, 8 x the single launch's time,
    and the kernels-line entry (the broadcast form's)."""
    import torch

    from pinot_tpu_torch.ops import kernels
    vdt = torch.float32
    run = kernels.batched_kernel(plan, vdt)
    plain = kernels.plain_batched_kernel(plan, vdt)
    single = kernels.make_topn_kernel(plan, vdt) if plan.mode == "topn" \
        else kernels.make_kernel(plan, vdt)
    forms = {}
    for form, idx in BATCH_FORMS.items():
        U = max(idx) + 1
        args = (sets[:U], plist, ndlist[:U], idx, D)
        out, peak = with_peak(lambda: run(*args))
        ref = plain(*args)
        torch.cuda.synchronize()
        for m, u in enumerate(idx):
            scales = None if plan.mode == "topn" else \
                kernels.abs_contributions(plan, sets[u], plist[m],
                                          ndlist[u], D)
            compare_packed(f"{name} {form} member {m} vs plain", plan,
                           out[m], ref[m], scales)
            compare_packed(f"{name} {form} member {m} vs its single launch",
                           plan, out[m],
                           single(sets[u], plist[m], ndlist[u], D), scales)
        moved, matched = batch_bytes(plan, *args, out)
        forms[form] = {"U": U, "ms": cuda_ms(lambda: run(*args)),
                       "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                       "bytes": moved, "matched": matched,
                       "max_abs_err": max_abs_err(out, ref),
                       "launch_peak_bytes": peak}
        del out, ref
    args = (sets[:1], plist, ndlist[:1], BATCH_FORMS["broadcast"], D)
    single_ms = cuda_ms(lambda: single(sets[0], plist[0], ndlist[0], D))
    entry = {"max_abs_err": max(f["max_abs_err"] for f in forms.values()),
             "ms": forms["broadcast"]["ms"],
             "plain_ms": cuda_ms(lambda: plain(*args), iters=3),
             "bound_ms": forms["broadcast"]["bound_ms"],
             "bound_by": "bytes", "library_ms": None,
             "library": "none: no single PyTorch call computes it"}
    return {"B": BATCH_B, "forms": forms, "single_ms": single_ms,
            "8x_single_ms": BATCH_B * single_ms, **entry}


STARTREE_CASES = {  # name -> group dims ((dim, card), ...)
    "flat": (),
    "grouped G=35 (shared memory)": (("a", 7), ("b", 5)),
    "grouped G=2^14 (global memory)": (("a", 128), ("b", 128)),
}


def startree_kernel_inputs(seed: int) -> dict:
    """K5's three phase-3 cases at S=16, D=2^20 pre-agg records, made on
    the card: name -> (plan, cols, params, num_docs, D). One usum pair
    (digits below 2^20 and 2^24), one float sum and one max (f32); the
    selection is a run of 52 records at a random offset in every 512
    (about 10%); one segment ragged, the last one padding."""
    import torch

    from pinot_tpu_torch.ops.startree_device import StarTreePlan
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    S, D = Q1_SEGMENTS, 1 << 20
    pos = torch.arange(D, device=dev)
    off = ints(0, 512 - 52, (S, D // 512)).long()[:, pos // 512]
    sel = (pos % 512 >= off) & (pos % 512 < off + 52)
    cols = {"sthi:sum__u": ints(0, 1 << 20, (S, D)),
            "stlo:sum__u": ints(0, 1 << 24, (S, D)),
            "stval:sum__x": (torch.rand((S, D), generator=g, device=dev)
                             - 0.3) * 1e6,
            "stval:max__y": torch.rand((S, D), generator=g, device=dev)}
    num_docs = torch.full((S,), D, dtype=torch.int32, device=dev)
    num_docs[S // 2] = D - 12345
    num_docs[-1] = 0
    out = {}
    for name, dims in STARTREE_CASES.items():
        cards = [c for _d, c in dims]
        plan = StarTreePlan(
            slots=(("usum", "sum__u"), ("sum", "sum__x"), ("max", "max__y")),
            group_dims=tuple(d for d, _c in dims), group_cards=tuple(cards),
            group_strides=tuple(int(np.prod(cards[i + 1:], dtype=np.int64))
                                for i in range(len(cards))),
            num_groups=int(np.prod(cards, dtype=np.int64)) if dims else 0)
        case_cols = dict(cols)
        for d, c in dims:
            case_cols["stid:" + d] = ints(0, c, (S, D))
        out[name] = (plan, case_cols, {"sel": sel}, num_docs, D)
    return out


def compare_startree(name: str, plan, out, ref, cols, params, num_docs,
                     D) -> None:
    """A K5 output against its reference: record counts, exact-sum planes
    and min / max bit for bit, float sums within 1e-5 of their sum of
    |contribution|."""
    import torch

    from pinot_tpu_torch.ops import startree_device as sd
    if out.shape != ref.shape:
        fail(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    valid = torch.arange(D, device=num_docs.device)[None, :] \
        < num_docs[:, None]
    mask = params["sel"] & valid
    col = 1
    for op, pair in plan.slots:
        w = sd.slot_width(op)
        a, b = out[..., col:col + w], ref[..., col:col + w]
        col += w
        if op == "sum":
            contrib = torch.where(mask, cols["stval:" + pair].double().abs(),
                                  0)
            if plan.num_groups:
                keys = sum(cols["stid:" + d].long() * st for d, st in
                           zip(plan.group_dims, plan.group_strides))
                scale = torch.zeros((mask.shape[0], plan.num_groups),
                                    dtype=torch.float64, device=mask.device
                                    ).scatter_add_(
                    1, torch.where(mask, keys, 0), contrib)[..., None]
            else:
                scale = contrib.sum(1)[:, None]
            err = (a.double() - b.double()).abs()
            if not bool((err <= 1e-5 * scale + 1e-30).all()):
                fail(f"{name}: sum beyond 1e-5 of sum|contrib|: max err "
                     f"{float(err.max())}")
        elif not torch.equal(a, b):
            fail(f"{name}: {op} {pair} not bit-identical")
    if not torch.equal(out[..., 0], ref[..., 0]):
        fail(f"{name}: record counts differ")


def check_startree(name: str, plan, cols, params, num_docs, D,
                   value_dtype=None) -> dict:
    """K5 against its plain version on the card: record counts, exact-sum
    planes and min / max bit for bit, float sums within 1e-5 of their sum
    of |contribution|; returns the case's entry. value_dtype: the value
    columns' (float32 unless given)."""
    import torch

    from pinot_tpu_torch.ops import startree_device as sd
    vdt = value_dtype or torch.float32
    kern = sd.make_startree_kernel(plan, vdt)

    def plain():
        return sd.startree_kernel(plan, cols, params, num_docs, D,
                                  value_dtype=vdt)
    out = kern(cols, params, num_docs, D)
    ref = plain()
    torch.cuda.synchronize()
    compare_startree(f"startree {name}", plan, out, ref, cols, params,
                     num_docs, D)
    valid = torch.arange(D, device=num_docs.device)[None, :] \
        < num_docs[:, None]
    mask = params["sel"] & valid
    # bytes: the mask of every real record, the other columns only in the
    # sectors holding a selected record, num_docs and the output once
    moved = int(valid.sum()) * params["sel"].element_size()
    for t in cols.values():
        size = t.element_size()
        sectors = mask.view(mask.shape[0], -1, SECTOR // size).any(-1)
        moved += SECTOR * int(sectors.sum())
    moved += num_docs.numel() * num_docs.element_size() \
        + out.numel() * out.element_size()
    ms = cuda_ms(lambda: kern(cols, params, num_docs, D))
    plain_ms = cuda_ms(plain)
    return {"case": name, "max_abs_err": max_abs_err(out, ref), "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "library": "none: no one PyTorch call computes the count, the "
                       "exact-sum planes and the float slots together",
            "records": int(num_docs.sum()), "selected": int(mask.sum()),
            "groups": plan.num_groups, "bytes": moved}


#: K6's phase-3 cases: 13 segments' rows into a block of 16 (three padded
#: segments), at the Q1 leg's doc bucket; row lengths (powers of two, as the
#: engine pads each segment's row to its own bucket) per case
RA_S, RA_D = 16, 1 << 23
RA_CASES = {"mixed": [RA_D >> k for k in (0, 3, 1, 0, 2, 0, 1, 3, 0, 2, 0,
                                          1, 0)],
            "full": [RA_D] * RA_S}


def check_row_assemble(seed: int) -> dict:
    """K6 against its plain version, bit for bit, at element sizes 1, 4 and
    8 (int8 ids, float32 values, float64 values) in two cases: 13 rows of
    mixed lengths into [16, 2^23] and 16 full-length rows (the stack
    form). The plain version runs on the host (it takes CPU tensors only):
    the same rows, copied there. Times: CUDA events for K6 and for
    torch.stack (the full case only: there it computes the same block),
    the host clock for the plain version; bound: the rows' bytes read and
    the block's written, over 3.35 TB/s. Returns the cases and the kernels
    line's entry (the full float32 case)."""
    import torch

    from pinot_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 4)
    cases = {}
    for dtype in (torch.int8, torch.float32, torch.float64):
        for case, lens in RA_CASES.items():
            if dtype.is_floating_point:
                rows = [torch.randn(n, generator=g, device=dev, dtype=dtype)
                        for n in lens]
            else:
                rows = [torch.randint(-128, 128, (n,), generator=g,
                                      device=dev, dtype=dtype) for n in lens]
            out = kernels.assemble_rows(rows, RA_S, RA_D)
            host = [r.cpu() for r in rows]
            t0 = time.perf_counter()
            ref = kernels.row_assemble(host, RA_S, RA_D)
            plain_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if not torch.equal(out.cpu().view(torch.uint8),
                               ref.view(torch.uint8)):
                fail(f"row_assemble {dtype} {case}: not bit-identical")
            size = rows[0].element_size()
            moved = sum(lens) * size + RA_S * RA_D * size
            name = f"{str(dtype).replace('torch.', '')} {case}"
            cases[name] = {
                "case": name, "max_abs_err": max_abs_err(out.cpu(), ref),
                "ms": cuda_ms(lambda: kernels.assemble_rows(rows, RA_S,
                                                            RA_D)),
                "plain_ms": plain_ms, "plain": "host CPU",
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": moved,
                "library_ms": cuda_ms(lambda: torch.stack(rows))
                if case == "full" else None,
                "library": "torch.stack (full-length rows only)"}
            del rows, host, out, ref
            torch.cuda.empty_cache()
    entry = dict(cases["float32 full"], max_abs_err=max(
        c["max_abs_err"] for c in cases.values()))
    return {"cases": cases, **entry}


def staged_startree_batch(ex, sqls, batches):
    """The inputs the engine stages for a batch of star-tree queries, as a
    coalesced launch reads them: member m is sqls[m] over the segment
    batch batches[m] (a tuple of segment indexes); members of one batch
    share its column set. Returns (plan, column sets, params per member,
    record counts per set, member-to-set map, D)."""
    staged = [staged_startree(ex, sql, [ex.segments[i] for i in batch])
              for sql, batch in zip(sqls, batches)]
    plan, D = staged[0][0], staged[0][4]
    if any(st[0] != plan or st[4] != D for st in staged):
        fail("phase 3b: the star-tree members do not share one plan and D")
    uniq = list(dict.fromkeys(batches))
    idx = [uniq.index(b) for b in batches]
    first = [idx.index(u) for u in range(len(uniq))]
    return (plan, [staged[m][1] for m in first], [st[2] for st in staged],
            [staged[m][3] for m in first], idx, D)


def check_startree_batched(ex, sqls) -> dict:
    """Phase 3b's K5 case, on the blocks the engine staged for the B = 8
    st5.1-shaped queries `sqls` over phase 7's ssbst segments: broadcast
    (every member over the same batch), stacked (member m over the
    segments rotated by m, each its own batch) and dedup (rotations m mod
    3). Each member against the plain batched version and its own single
    launch: record counts, exact-sum planes and min / max bit for bit,
    float sums within 1e-5 of their sum of |contribution| (as phase 3 holds
    K5's single launch). Returns the times per form, 8 x the single
    launch's, and the kernels line's entry (broadcast)."""
    import torch

    from pinot_tpu_torch.ops import startree_device as sd
    vdt = ex.engine.value_dtype
    n = len(ex.segments)
    rot = [tuple((i + m) % n for i in range(n)) for m in range(BATCH_B)]
    batches = {"broadcast": [rot[0]] * BATCH_B, "stacked": rot,
               "dedup": [rot[m % 3] for m in range(BATCH_B)]}
    forms = {}
    for form, bs in batches.items():
        plan, sets, plist, nds, idx, D = staged_startree_batch(ex, sqls, bs)
        run = sd.batched_kernel(plan, vdt)
        plain = sd.plain_batched_kernel(plan, vdt)
        single = sd.make_startree_kernel(plan, vdt)
        args = (sets, plist, nds, idx, D)
        out = run(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        for m, u in enumerate(idx):
            one = single(sets[u], plist[m], nds[u], D)
            for what, other in (("plain", ref[m]), ("its single launch",
                                                    one)):
                compare_startree(f"startree {form} member {m} vs {what}",
                                 plan, out[m], other, sets[u], plist[m],
                                 nds[u], D)
        moved = 0
        for u, (cols, nd) in enumerate(zip(sets, nds)):
            valid = torch.arange(D, device=nd.device)[None, :] < nd[:, None]
            kept = torch.zeros_like(valid)
            for p in [p for p, v in zip(plist, idx) if v == u]:
                kept |= p["sel"] & valid
                moved += int(valid.sum()) * p["sel"].element_size()
            for t in cols.values():
                size = t.element_size()
                moved += SECTOR * int(kept.view(kept.shape[0], -1,
                                                SECTOR // size).any(-1).sum())
            moved += nd.numel() * nd.element_size()
        moved += out.numel() * out.element_size()
        forms[form] = {"U": len(sets), "ms": cuda_ms(lambda: run(*args)),
                       "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                       "bytes": moved, "max_abs_err": max_abs_err(out, ref)}
        if form == "broadcast":
            single_ms = cuda_ms(lambda: single(sets[0], plist[0], nds[0], D))
            plain_ms = cuda_ms(lambda: plain(*args), iters=3)
        del out, ref
    return {"B": BATCH_B, "forms": forms, "single_ms": single_ms,
            "8x_single_ms": BATCH_B * single_ms,
            "max_abs_err": max(f["max_abs_err"] for f in forms.values()),
            "ms": forms["broadcast"]["ms"], "plain_ms": plain_ms,
            "bound_ms": forms["broadcast"]["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "library": "none: no one PyTorch call computes it"}


def with_mask(plan, cols, seed: int):
    """A plan and its inputs under an upsert validity mask: a seeded uint8
    [S, D] block clearing about a third of docs, made on the card."""
    import dataclasses

    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 7)
    t = next(iter(cols.values()))
    vmask = (torch.rand(t.shape, generator=g, device="cuda")
             >= 1 / 3).to(torch.uint8)
    return dataclasses.replace(plan, valid_mask=True), dict(cols,
                                                            vmask=vmask)


#: phase 3's time-bucket cases at the time-series leg's shapes: name ->
#: (tag cardinality, buckets, step ms); G = cardinality x count_pad
BUCKET_CASES = {"ts.3: G=64,000 (global tier)": (4000, 12, 3_600_000),
                "ts.1: G=1024 (block tier)": (1, 720, 60_000)}


def bucket_kernel_inputs(seed: int, case: str, starts=None):
    """K2 with the fused bucket digit at the time-series leg's block (S =
    25, D = 2^22), made on the card: the hostname ids (or none), the
    timestamp's (hi, lo) planes, f32 values, a vrange64 window filter on
    the planes and a sliding start per segment. The window filter is wider
    than the bucket grid on every other segment and open on the first, so
    negative deltas, both grid edges, b past count and deltas that wrap in
    i32 (timestamps 2^31 ms and more from the start) reach the gate.
    starts: a window start per segment (default: the case's own)."""
    import torch

    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    hosts, count, step = BUCKET_CASES[case]
    pad = 8
    while pad < count:
        pad *= 2
    S, D = TS_SEGMENTS, TS_FLUSH
    if starts is None:
        starts = [TS_T0 + 3_600_000 * (s % 48) for s in range(S)]
    st = torch.tensor(starts, dtype=torch.int64, device=dev)[:, None]
    t = st + torch.randint(-3 * step, (count + 3) * step, (S, D),
                           generator=g, device=dev)
    edges = torch.cat([st, st - 1, st + step * count - 1, st + step * count,
                       st + (1 << 31), st - (1 << 31), st + (1 << 32) + 5,
                       st + (1 << 40)], 1)
    t[:, :edges.shape[1]] = edges
    cols = {"valhi:ts": (t >> 24).to(torch.int32),
            "vallo:ts": (t & 0xFFFFFF).to(torch.int32),
            "val:usage": torch.rand((S, D), generator=g, device=dev) * 100}
    del t, edges
    lo = st[:, 0] - torch.where(torch.arange(S, device=dev) % 2 == 0, 0,
                                5 * step)
    hi = st[:, 0] + step * count - 1 + torch.where(
        torch.arange(S, device=dev) % 2 == 0, 0, 5 * step)
    lo[0], hi[0] = 0, (1 << 55) - 1
    params = {"leaf0:lohi": (lo >> 24).to(torch.int32),
              "leaf0:lolo": (lo & 0xFFFFFF).to(torch.int32),
              "leaf0:hihi": (hi >> 24).to(torch.int32),
              "leaf0:hilo": (hi & 0xFFFFFF).to(torch.int32),
              "tb:shi": (st[:, 0] >> 24).to(torch.int32),
              "tb:slo": (st[:, 0] & 0xFFFFFF).to(torch.int32),
              "tb:step": torch.full((S,), step, dtype=torch.int32,
                                    device=dev),
              "tb:count": torch.full((S,), count, dtype=torch.int32,
                                     device=dev)}
    group = {}
    if hosts > 1:
        cols["ids:hostname"] = torch.randint(0, hosts, (S, D), generator=g,
                                             device=dev).to(torch.int16)
        group = dict(group_cols=("hostname",), group_strides=(pad,),
                     dict_cols=("hostname",))
    plan = DevicePlan(filter_ir=("leaf", 0),
                      leaves=(DeviceLeaf("vrange64", "ts"),),
                      value_irs=(("col", "usage"),),
                      agg_ops=(("max", 0, None), ("sum", 0, None),
                               ("count", None, None)),
                      num_groups=hosts * pad, raw_cols=("usage",),
                      raw64_cols=("ts",), tbucket=("ts", pad), **group)
    num_docs = torch.full((S,), D, dtype=torch.int32, device=dev)
    num_docs[-1] = TS_ROWS - (S - 1) * TS_FLUSH
    return plan, cols, params, num_docs, D


def bincount_ms(plan, cols, params, num_docs, D) -> float:
    """torch.bincount(keys, weights) on the kept docs' precomputed flat
    (segment, group) keys: the scatter-add alone, the PyTorch call nearest
    K2's sum slot (no filter, bucket math, max or count)."""
    import torch

    from pinot_tpu_torch.ops import kernels
    keys, gate = kernels.group_keys(plan, cols, params,
                                    cols["val:usage"].shape)
    mask = kernels.doc_validity(plan, cols, num_docs, D) & gate \
        & kernels.eval_filter(plan.filter_ir, plan, cols, params)
    seg = torch.arange(mask.shape[0], device=mask.device)[:, None]
    flat = (seg * plan.num_groups + keys)[mask]
    w = cols["val:usage"][mask]
    n = mask.shape[0] * plan.num_groups
    return cuda_ms(lambda: torch.bincount(flat, weights=w, minlength=n))


def check_bucket_batched(seed: int) -> dict:
    """Phase 3b's bucket case: K2's member axis at B = 8 over ts.3's
    column set (broadcast), member m's window sliding by m hours, against
    the plain batched version and each member's single launch; returns
    the kernels-line entry (time, 8 x single, bound)."""
    import torch

    from pinot_tpu_torch.ops import kernels
    case = "ts.3: G=64,000 (global tier)"
    plan, cols, params, num_docs, D = bucket_kernel_inputs(seed, case)
    plist = []
    for m in range(BATCH_B):
        starts = [TS_T0 + 3_600_000 * (s % 48 + m)
                  for s in range(TS_SEGMENTS)]
        plist.append(bucket_kernel_inputs(seed, case, starts)[2])
    idx = BATCH_FORMS["broadcast"]
    args = ([cols], plist, [num_docs], idx, D)
    run = kernels.batched_kernel(plan, torch.float32)
    plain = kernels.plain_batched_kernel(plan, torch.float32)
    single = kernels.make_kernel(plan, torch.float32)
    out, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    for m in range(BATCH_B):
        scales = kernels.abs_contributions(plan, cols, plist[m], num_docs, D)
        compare_packed(f"K2 bucket batched member {m} vs plain", plan,
                       out[m], ref[m], scales)
        compare_packed(f"K2 bucket batched member {m} vs its single launch",
                       plan, out[m], single(cols, plist[m], num_docs, D),
                       scales)
    moved, matched = batch_bytes(plan, *args, out)
    single_ms = cuda_ms(lambda: single(cols, plist[0], num_docs, D))
    return {"case": "ts.3 x 8 sliding starts", "B": BATCH_B,
            "max_abs_err": max_abs_err(out, ref),
            "ms": cuda_ms(lambda: run(*args)), "single_ms": single_ms,
            "8x_single_ms": BATCH_B * single_ms,
            "plain_ms": cuda_ms(lambda: plain(*args), iters=3),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "bytes": moved, "matched": matched}


def compact_kernel_inputs(seed: int, G: int, neq=None, cb3: bool = False):
    """K2 with compact keys at phase 14's block (S = CB_SEGMENTS, D =
    CB_DOCS), made on the card: an int32 gkey block whose segment s holds
    its own tuple count (between G/2 and G) skewed toward the low codes,
    as zipf-drawn users make them; ResolutionWidth as f32 values. cb3:
    cb.3's plan, unfiltered SUM / MIN / MAX / COUNT slots; else an int32
    phrase-id column (a third of the docs at id 0, '') under cb.2's
    `<> ''` as a neq leaf (`neq`: a member's id per segment instead), a
    SUM and a COUNT slot. Returns (plan, cols, params, num_docs, D, G)."""
    import torch

    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 11)
    S, D = CB_SEGMENTS, CB_DOCS
    held = torch.randint(G // 2 + 1, G + 1, (S, 1), generator=g, device=dev)
    u = torch.rand((S, D), generator=g, device=dev) ** 2
    gkey = torch.minimum((u * held).long(), held - 1).to(torch.int32)
    phrase = torch.randint(0, 1 << 16, (S, D), generator=g, device=dev)
    phrase[torch.rand((S, D), generator=g, device=dev) < 1 / 3] = 0
    widths = torch.tensor(CB_WIDTHS, dtype=torch.float32, device=dev)
    width = widths[torch.randint(0, len(CB_WIDTHS), (S, D), generator=g,
                                 device=dev)]
    num_docs = torch.full((S,), D, dtype=torch.int32, device=dev)
    num_docs[-1] = D - 12_345  # a ragged last segment
    if cb3:
        plan = DevicePlan(filter_ir=None, leaves=(),
                          value_irs=(("col", "width"),),
                          agg_ops=(("sum", 0, None), ("min", 0, None),
                                   ("max", 0, None), ("count", None, None)),
                          group_cols=("region", "user"), group_compact=True,
                          raw_cols=("width",))
        return plan, {"gkey": gkey, "val:width": width}, {}, num_docs, D, G
    cols = {"gkey": gkey, "ids:phrase": phrase.to(torch.int32),
            "val:width": width}
    plan = DevicePlan(filter_ir=("leaf", 0),
                      leaves=(DeviceLeaf("neq", "phrase"),),
                      value_irs=(("col", "width"),),
                      agg_ops=(("sum", 0, None), ("count", None, None)),
                      group_cols=("user", "phrase"), group_compact=True,
                      dict_cols=("phrase",), raw_cols=("width",))
    idx = torch.zeros(S, dtype=torch.int32, device=dev) if neq is None \
        else torch.full((S,), neq, dtype=torch.int32, device=dev)
    return plan, cols, {"leaf0:idx": idx}, num_docs, D, G


def index_add_ms(plan, cols, params, num_docs, D, G=0) -> float:
    """torch.Tensor.index_add_ of the kept docs' values (the first value
    column) at their precomputed flat (segment, key) keys into an [S x G]
    table: the scatter-add alone, the PyTorch call nearest K2's sum slot
    (no filter, count, min / max or key load); dense keys or compact
    codes."""
    import torch

    from pinot_tpu_torch.ops import kernels
    mask = kernels.doc_validity(plan, cols, num_docs, D)
    if plan.filter_ir is not None:
        mask = mask & kernels.eval_filter(plan.filter_ir, plan, cols, params)
    keys, gate = kernels.group_keys(plan, cols, params, mask.shape)
    if gate is not None:
        mask = mask & gate
    G = kernels.group_count(plan, G)
    seg = torch.arange(mask.shape[0], device=mask.device)[:, None]
    flat = (seg * G + keys.long())[mask]
    w = cols["val:" + plan.value_irs[0][1]][mask]
    table = torch.zeros(mask.shape[0] * G, dtype=torch.float32,
                        device=mask.device)
    return cuda_ms(lambda: table.index_add_(0, flat, w))


def check_compact_batched(seed: int, G: int) -> dict:
    """Phase 3b's compact case: K2's member axis at B = 8 over one column
    set (broadcast) at G, member m excluding phrase id m, against the
    plain batched version and each member's single launch; returns the
    time, 8 x single, the bound, the scratch table's traffic and the
    launch's peak device memory."""
    import torch

    from pinot_tpu_torch.ops import kernels
    plan, cols, params, num_docs, D, G = compact_kernel_inputs(seed, G)
    plist = [compact_kernel_inputs(seed, G, neq=m)[2]
             for m in range(BATCH_B)]
    idx = BATCH_FORMS["broadcast"]
    args = ([cols], plist, [num_docs], idx, D)
    run = kernels.batched_kernel(plan, torch.float32)
    plain = kernels.plain_batched_kernel(plan, torch.float32)
    single = kernels.make_kernel(plan, torch.float32)
    out, peak = with_peak(lambda: run(*args, G))
    ref = plain(*args, G)
    torch.cuda.synchronize()
    for m in range(BATCH_B):
        scales = kernels.abs_contributions(plan, cols, plist[m], num_docs, D,
                                           G)
        compare_packed(f"K2 compact G={G} batched member {m} vs plain",
                       plan, out[m], ref[m], scales)
        compare_packed(f"K2 compact G={G} batched member {m} vs its single "
                       "launch", plan, out[m],
                       single(cols, plist[m], num_docs, D, G), scales)
    moved, matched = batch_bytes(plan, *args, out)
    single_ms = cuda_ms(lambda: single(cols, plist[0], num_docs, D, G))
    entry = {"case": f"G={G} x {BATCH_B} members (broadcast)",
             "B": BATCH_B, "G": G, "max_abs_err": max_abs_err(out, ref),
             "ms": cuda_ms(lambda: run(*args, G)), "single_ms": single_ms,
             "8x_single_ms": BATCH_B * single_ms,
             "plain_ms": cuda_ms(lambda: plain(*args, G), iters=3),
             "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": None,
             "library": "none: no single PyTorch call computes it",
             "bytes": moved, "scratch_bytes": scratch_bytes(out),
             "matched": matched, "launch_peak_bytes": peak}
    del out, ref
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# phases 4-5: the port's main path, from SQL to rows
# ---------------------------------------------------------------------------

def build_one_segment(job):
    """Generate segment i's columns from [seed, i], fold its truth and
    write it with the port's creator; returns (its directory, its truth).
    Runs in a worker process: only the truth comes back."""
    (root, name, fields, no_dict, docs, columns_fn, truth_fn, seed, i,
     star_tree) = job
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, StarTreeIndexConfig,
                                        TableConfig)
    from pinot_tpu_torch.segment.creator import SegmentCreator
    schema = Schema(name, [FieldSpec(f, getattr(DataType, t),
                                     FieldType.METRIC if m
                                     else FieldType.DIMENSION)
                           for f, t, m in fields])
    tc = TableConfig(name)
    tc.indexing.no_dictionary_columns = list(no_dict)
    tc.indexing.compression = "PASS_THROUGH"
    if star_tree is not None:
        tc.indexing.star_tree_configs = [StarTreeIndexConfig(**star_tree)]
    cols = columns_fn(np.random.default_rng([seed, i]), docs)
    truth = truth_fn(cols)
    out = os.path.join(root, f"{name}_{i}")
    SegmentCreator(tc, schema).build(cols, out, f"{name}_{i}")
    return out, truth


def build_segments(root: str, name: str, fields, no_dict, n_segments: int,
                   docs: int, columns_fn, truth_fn, seed: int,
                   workers: int = 1, star_tree=None):
    """Build n_segments with the port's creator, one segment at a time in
    each of `workers` spawned processes (1: in this one), and load them in
    order; returns (segments, the per-segment truths). star_tree: the
    StarTreeIndexConfig fields of the table's one star-tree, or None."""
    from pinot_tpu_torch.segment.loader import load_segment
    jobs = [(root, name, fields, no_dict, docs, columns_fn, truth_fn, seed,
             i, star_tree) for i in range(n_segments)]
    if workers > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            done = pool.map(build_one_segment, jobs, chunksize=1)
    else:
        done = [build_one_segment(job) for job in jobs]
    return [load_segment(out) for out, _t in done], [t for _o, t in done]


def time_query(ex, sql: str, iters: int):
    """Cold first run (staging included), then `iters` warm runs; returns
    (response, cold seconds, warm latencies, the median host-clock stage
    split of the warm runs in ms, from QueryExecutor.last_stage_ms)."""
    t0 = time.perf_counter()
    resp = ex.execute(sql)
    cold = time.perf_counter() - t0
    lats, splits = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        resp = ex.execute(sql)
        lats.append(time.perf_counter() - t0)
        splits.append(ex.last_stage_ms)
    split = {k: statistics.median(sp[k] for sp in splits)
             for k in splits[0]}
    return resp, cold, lats, split


def device_busy(ex, sql: str, iters: int, tmp: str):
    """`iters` warm runs of `sql` under torch.profiler: the card's busy
    time per query (the union of the trace's kernel, copy and set
    intervals), the traced host wall per query, and the device time per
    query of the busiest kernels. A trace that holds no device event (the
    profiler drops one now and then) is taken once more; None if that one
    holds none either."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ex.execute(sql)
    torch.cuda.synchronize()
    for _attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                ex.execute(sql)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, by_name = trace_busy_us(prof, tmp)
        if busy is not None:
            break
    if busy is None:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    # each port kernel's passes, summed (K4 runs a dozen small kernels),
    # by the prefix of the function's name (K5's startree_group_* are not
    # K2's group_*)
    port = {k: sum(v for n, v in by_name.items()
                   if n.removeprefix("void ").startswith(p)) / 1e3 / iters
            for k, p in (("scan_agg", "scan_"), ("group_agg", "group_"),
                         ("sketch_agg", "sketch_"), ("topn", "topn_"),
                         ("startree_agg", "startree_"),
                         ("row_assemble", "row_assemble"),
                         ("clp_match", "clp_match"),
                         ("vector_topk", "vec_"))}
    return {"busy_ms_per_query": busy / 1e3 / iters,
            "traced_wall_ms_per_query": wall * 1e3 / iters,
            "device_ms_per_query": {n: v / 1e3 / iters for n, v in top},
            "port_kernel_ms_per_query": {k: v for k, v in port.items()
                                         if v}}


def trace_busy_us(prof, tmp: str):
    """The card's busy time in a torch.profiler trace (the union of its
    kernel, copy and set intervals, us) and each device function's time;
    (None, {}) if the trace holds no device event."""
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "")) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    if not spans:
        return None, {}
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (b - a)
    return busy, by_name


def staged_startree(ex, sql: str, segments=None):
    """The inputs the engine stages for K5 on a tree query over
    `segments` (the executor's by default), as it stages them on the main
    path: (plan, cols, params, num_docs, D)."""
    from pinot_tpu_torch.query.context import QueryContext
    segments = ex.segments if segments is None else segments
    ctx = QueryContext.from_sql(sql)
    st = ex.engine._plan_startree(segments, ctx)
    if st is None:
        fail(f"the engine does not serve {sql!r} from the tree")
    plan, _needed, fits = st
    return (plan, *ex.engine._stage_startree(segments, ctx, plan, fits))


def startree_leg(tmp: str, seed: int, kernels, none: dict, card: str):
    """Phase 7: each star-tree table built, each query run from the tree
    and with OPTION(useStarTree=false), checked against the numpy truth
    and each other, and K5 held against its plain version on the inputs
    the engine staged for each query. On ssbst the tree runs start with a
    prestage of st5.1, after which the leg must upload no column byte;
    then phase 3b's K5 case (check_startree_batched on eight 9f pool
    queries) and phase 9f. Returns the leg's launches per kernel, K5's
    cases by query name, the batched K5 check and 9f's window launches."""
    import torch

    from pinot_tpu_torch.ops import residency
    from pinot_tpu_torch.query.context import QueryContext
    from pinot_tpu_torch.query.executor import QueryExecutor
    launches = {k.name: 0 for k in kernels}
    cases = {}
    batched, p9f = None, None
    for table, (fields, tree, queries) in ST_TABLES.items():
        t0 = time.perf_counter()
        segs, truths = build_segments(
            tmp, table, fields, [], ST_SEGMENTS, ST_DOCS,
            ssb_flat_columns if table == "ssbst" else stb_columns,
            startree_truth, seed, BUILD_WORKERS, star_tree=tree)
        rows = sum(s.num_docs for s in segs)
        records = [s.metadata.star_tree["trees"][0]["numRecords"]
                   for s in segs]
        print(f"[startree] built {table}: {len(segs)} segments, {rows} "
              f"rows, {min(records)}-{max(records)} pre-agg records per "
              f"segment in {time.perf_counter() - t0:.1f} s", flush=True)
        ex = QueryExecutor(segs)
        grouped = sum(g for _sql, g in queries.values())
        for path, suffix in (("tree", ""), ("scan", NO_STAR_TREE)):
            torch.cuda.reset_peak_memory_stats()
            zero_launches(kernels)
            legs, splits, answers = [], {}, {}
            if path == "tree" and table == "ssbst":
                c0 = residency.column_transfer_bytes()
                if not ex.engine.prestage(segs, QueryContext.from_sql(
                        queries["st5.1"][0])):
                    fail("prestage of st5.1 staged nothing")
                prestaged = residency.column_transfer_bytes()
            for name, (sql, is_grouped) in queries.items():
                resp, cold, lats, splits[name] = time_query(
                    ex, sql + suffix, ITERS)
                got = [tuple(r) for r in resp.rows]
                want = startree_expected(truths, name)
                exact = path == "tree" or not is_grouped
                if not rows_agree(got, want, exact):
                    fail(f"{name} {path}: {got[:4]} vs numpy truth "
                         f"{want[:4]}")
                answers[name] = got
                legs.append({"query": name, "path": path, "rows": rows,
                             "selected": resp.stats.num_docs_scanned,
                             "p50_ms": statistics.median(lats) * 1e3,
                             "cold_s": cold,
                             "rows_per_s": rows / statistics.median(lats)})
            if path == "tree" and table == "ssbst":
                after = residency.column_transfer_bytes() - prestaged
                print(f"[startree] prestage st5.1: "
                      f"{json.dumps({'prestage_column_bytes': prestaged - c0, 'column_bytes_after': after})}"
                      f" | {card}", flush=True)
                if after:
                    fail(f"st5.1 after its prestage uploaded {after} column "
                         "bytes")
            runs = 1 + ITERS
            want_launches = {**none, "startree_agg": len(queries) * runs} \
                if path == "tree" else \
                {**none, "scan_agg": (len(queries) - grouped) * runs,
                 "group_agg": grouped * runs}
            got = launches_of_leg(f"star-tree leg {table} {path}", kernels,
                                  want_launches)
            for k, v in got.items():
                launches[k] += v
            peak = torch.cuda.max_memory_allocated()
            for leg in legs:
                leg["max_memory_allocated"] = peak
                leg["stage_ms"] = splits[leg["query"]]
                print(f"[startree] {json.dumps(leg)} | {card}", flush=True)
            if path == "tree":
                tree_answers = answers
                # after the launch counts were read: these launches are
                # the comparison's, not the main path's
                for name, (sql, _g) in queries.items():
                    cases[name] = check_startree(
                        f"{table} {name}", *staged_startree(ex, sql),
                        value_dtype=ex.engine.value_dtype)
                    print(f"[kernel] startree_agg {json.dumps(cases[name])}"
                          f" | {card}", flush=True)
            else:
                for name, got in answers.items():
                    if not rows_agree(got, tree_answers[name], False):
                        fail(f"{name}: tree {tree_answers[name][:4]} vs "
                             f"scan {got[:4]}")
        for name, (sql, _g) in list(queries.items())[:2]:
            for path, suffix in (("tree", ""), ("scan", NO_STAR_TREE)):
                busy = device_busy(ex, sql + suffix, ITERS, tmp)
                print(f"[startree] trace {name} {path} "
                      f"{json.dumps(busy or 'not measured')} | {card}",
                      flush=True)
        if table == "ssbst":
            pool = [st_pool_sql(*w) for w in ST_POOL]
            # phase 3b's K5 case, on the blocks the engine stages for the
            # pool's first eight queries
            batched = check_startree_batched(ex, pool[:BATCH_B])
            print(f"[kernel] startree_agg batched {json.dumps(batched)} "
                  f"| {card}", flush=True)

            # phase 9f: st5.1-shaped queries under concurrency (K5)
            def st_check(i, rows):
                want = sorted(set().union(*(t["stpool"][i] for t in truths)))
                want = [(y, sum(t["stpool"][i].get(y, 0) for t in truths))
                        for y in want]
                return None if rows_agree(rows, want, True) else \
                    f"{rows[:3]} vs numpy truth {want[:3]}"
            leg = concurrency_leg(
                "9f", modes_of(segs, pipelined=ex), pool,
                [list(range(len(pool)))] * CLIENTS, st_check, card, tmp,
                kernels, "startree_agg")
            p9f = leg["launches"]
        del ex, segs
        torch.cuda.empty_cache()
    return launches, cases, batched, p9f


def launches_of_leg(leg: str, kernels, want: dict) -> dict:
    """The leg's launch counts, read just after its timed runs, against
    the counts it must show (name -> launches): its kernels once per query
    run, K6 (row_assemble) once per block the leg assembled (the engines'
    `hbm_block_miss` meter since zero_launches), the others never, and no
    batched launch (one query at a time). Also holds the leg's peak device
    memory to the card's 80 GB."""
    want = {**want, "row_assemble": int(block_misses() - _MISSES[0])}
    got = {k.name: k.launches for k in kernels}
    if got != want or any(k.batched_launches for k in kernels):
        fail(f"{leg}: launches {got}, expected {want}; batched "
             f"{ {k.name: k.batched_launches for k in kernels} }")
    check_peak(leg)
    return got


#: the block-miss meter when the launch counts were last set to 0
_MISSES = [0.0]
#: the card's memory (H100 80GB): no leg may peak above it
PEAK_LIMIT = 80e9


def block_misses() -> float:
    """Blocks the engines assembled so far: each one K6 launch."""
    from pinot_tpu_torch.utils.metrics import get_registry
    return get_registry("server").meter("hbm_block_miss")


def check_peak(where: str) -> None:
    import torch
    peak = torch.cuda.max_memory_allocated()
    if peak > PEAK_LIMIT:
        fail(f"{where}: peak device memory {peak} above {PEAK_LIMIT}")


def zero_launches(kernels) -> None:
    _MISSES[0] = block_misses()
    for k in kernels:
        k.reset_counts()


def residency_phase(segs, truths, kernels, none: dict, card: str) -> int:
    """Phase 4c: the staging levels on phase 4's 16 x 8M Q1 segments, through
    a fresh engine (nothing staged): Q1.1 over segments 0-11; over 4-15,
    whose column uploads must be exactly the rows of segments 12-15 (each
    staged column's element size times the segment's power-of-two doc
    bucket); over 4-15 again, adding no column byte and no K6 launch;
    then invalidate_segment of segment 5's name must drop exactly its
    resident rows. Every answer equals the numpy truth of its segments.
    The launch counts are set to 0 just before each step and held just
    after it as every leg's are (launches_of_leg: K1 once, K6 once per
    block assembled, nothing else). Prints each step's column bytes, stage
    ms, K6 launches and peak device memory; returns K6's launches."""
    import torch

    from pinot_tpu_torch.ops import residency
    from pinot_tpu_torch.ops.engine import _batch_key, _pow2
    from pinot_tpu_torch.query.context import QueryContext
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.query.reduce import reduce_results
    eng = QueryExecutor(segs).engine
    ctx = QueryContext.from_sql(Q1_QUERIES["q1.1"])
    launches = 0

    def step(name, lo, hi, want_bytes=None):
        nonlocal launches
        batch = segs[lo:hi]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = residency.column_transfer_bytes()
        zero_launches(kernels)
        rows = reduce_results(ctx, eng.execute(batch, ctx)).rows
        torch.cuda.synchronize()
        moved = residency.column_transfer_bytes() - c0
        k6 = launches_of_leg(f"residency {name}", kernels,
                             {**none, "scan_agg": 1})["row_assemble"]
        launches += k6
        err = exact_pair(rows, sum(t["q1"]["q1.1"][0] for t in truths[lo:hi]),
                         sum(t["q1"]["q1.1"][1] for t in truths[lo:hi]))
        if err is not None:
            fail(f"residency {name}: {err}")
        if want_bytes is not None and moved != want_bytes:
            fail(f"residency {name}: {moved} column bytes uploaded, "
                 f"expected {want_bytes}")
        out = {"step": name, "segments": [lo, hi - 1],
               "column_bytes": moved, "stage_ms": eng.last_stage_ms["stage"],
               "row_assemble_launches": k6,
               "resident_rows": len(eng.residency),
               "resident_bytes": eng.residency.bytes,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        print(f"[residency] {json.dumps(out)} | {card}", flush=True)
        return out

    first = step("1: segments 0-11", 0, 12)
    if not first["row_assemble_launches"]:
        fail("residency: the cold batch launched no row_assemble")
    # each block the first batch staged: its element size times the new
    # segments' doc buckets
    key0 = _batch_key(segs[:12])
    sizes = [dev.element_size() for key, (_s, dev) in eng._blocks.items()
             if key[0] == key0]
    want = sum(_pow2(seg.num_docs) * size for seg in segs[12:16]
               for size in sizes)
    second = step("2: segments 4-15", 4, 16, want)
    if second["row_assemble_launches"] != len(sizes):
        fail(f"residency: {second['row_assemble_launches']} row_assemble "
             f"launches for {len(sizes)} blocks")
    third = step("3: segments 4-15 again", 4, 16, 0)
    if third["row_assemble_launches"]:
        fail("residency: a repeat batch assembled a block")
    name = segs[5].name
    before, mine = len(eng.residency), eng.residency.resident_for(name)
    eng.invalidate_segment(name)
    after = len(eng.residency)
    print(f"[residency] {json.dumps({'step': '4: invalidate ' + name, 'rows_before': before, 'rows_of_segment': mine, 'rows_after': after})}"
          f" | {card}", flush=True)
    if mine != len(sizes) or after != before - mine \
            or eng.residency.resident_for(name):
        fail(f"residency: invalidate_segment({name}) left {after} of "
             f"{before} rows ({mine} of them its own)")
    if any(any(x.name == name for x in s) for s, _d in eng._blocks.values()):
        fail(f"residency: a block of {name} survived invalidate_segment")
    del eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: the time-series leg (TSBS cpu-only); phase 4d: upserts
# ---------------------------------------------------------------------------

def start_late_builds(tmp: str, seed: int):
    """Start the time-series and log legs' segment builds in a pool of
    BUILD_WORKERS spawned processes, to run while phase 3 times the
    kernels by CUDA events; returns (the pool, {leg: (its async result,
    its start time, [its end time])})."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(BUILD_WORKERS)
    pending = {}
    for leg, fn, jobs in (
            ("tsbs", build_tsbs_segment,
             [(tmp, seed, i) for i in range(TS_SEGMENTS)]),
            ("logs", build_log_segment,
             [(tmp, seed, i, LOG_DOCS) for i in range(LOG_SEGMENTS)])):
        pending[leg] = _start_map(pool, fn, jobs)
    return pool, pending


def start_vector_builds(tmp: str, seed: int):
    """Start the vector leg's segment builds in a pool of VEC_WORKERS
    spawned processes at the lowest CPU priority, each worker's BLAS on
    one thread, to run on the cores the phases before phase 12 leave idle;
    returns (the pool, {'vector': (its async result, its start time, [its
    end time])})."""
    import multiprocessing
    saved = {k: os.environ.get(k) for k in _BLAS_THREADS}
    os.environ.update({k: "1" for k in _BLAS_THREADS})
    try:
        pool = multiprocessing.get_context("spawn").Pool(
            VEC_WORKERS, initializer=os.nice, initargs=(19,))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return pool, {"vector": _start_map(pool, build_vector_segment,
                                       vector_jobs(tmp, seed))}


def _start_map(pool, fn, jobs):
    end = []
    return (pool.map_async(
        fn, jobs, chunksize=1,
        callback=lambda _r: end.append(time.perf_counter())),
        time.perf_counter(), end)


def finish_late_builds(pool, pending, legs, card: str) -> dict:
    """Wait for the builds of `legs` in `pool` (start_late_builds',
    start_vector_builds') and stop the pool: {leg: its builds' results},
    each leg's build time and the wait printed."""
    t0 = time.perf_counter()
    done = {leg: pending[leg][0].get() for leg in legs}
    pool.close()
    pool.join()
    # (a map over no jobs never calls its callback)
    built = {leg: round((pending[leg][2] or [pending[leg][1]])[0]
                        - pending[leg][1], 1) for leg in legs}
    print(f"[build] {' and '.join(legs)} segments, built in "
          f"{json.dumps(built)} s (from the pools' start), waited "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return done


def tsbs_host_tags(seed: int):
    """Each host's hostname, region and datacenter, fixed per host from a
    seeded draw (TSBS's tags: a region and one of its datacenters)."""
    rng = np.random.default_rng([seed, TS_HOSTS])
    region = rng.integers(0, len(TS_REGIONS), TS_HOSTS)
    zone = rng.integers(0, 3, TS_HOSTS)
    names = np.array([f"host_{h}" for h in range(TS_HOSTS)], dtype=object)
    regions = np.array(TS_REGIONS, dtype=object)[region]
    dcs = np.array([TS_REGIONS[r] + "abc"[z] for r, z in zip(region, zone)],
                   dtype=object)
    return names, regions, dcs


def tsbs_columns(seed: int, i: int):
    """Segment i's rows: row r is host r mod 4000 at 10 s interval
    r div 4000; the three metrics are per-host walks (a seeded start in
    [0, 100] and seeded normal steps of 0.5, clamped to [0, 100]) over the
    segment's intervals. Returns (columns, host of each row)."""
    a = i * TS_FLUSH
    b = min(TS_ROWS, a + TS_FLUSH)
    r = np.arange(a, b, dtype=np.int64)
    k0, k1 = a // TS_HOSTS, (b - 1) // TS_HOSTS + 1
    rng = np.random.default_rng([seed, i])
    names, regions, dcs = tsbs_host_tags(seed)
    host = r % TS_HOSTS
    cols = {"ts": TS_T0 + (r // TS_HOSTS) * TS_INTERVAL,
            "hostname": names[host], "region": regions[host],
            "datacenter": dcs[host]}
    for m in ("usage_user", "usage_system", "usage_idle"):
        walk = rng.uniform(0, 100, TS_HOSTS)[None, :] + np.cumsum(
            rng.normal(0, 0.5, (k1 - k0, TS_HOSTS)), axis=0)
        cols[m] = np.clip(walk, 0, 100).reshape(-1)[
            a - k0 * TS_HOSTS:b - k0 * TS_HOSTS]
    return cols, host


def tsbs_truth(cols: dict, host, seed: int) -> dict:
    """One segment's part of the leg's answers, from its generated columns
    in float64: ts.1's and ts.2's per-minute maxima; per (hour since
    2016-01-01, host) usage_user sums and counts (ts.3, its refreshes and
    9g); per 5-minute bucket of ts.4's window, each host's sum."""
    ts, v = cols["ts"], cols["usage_user"]
    out = {}
    w = (ts >= TS_S1) & (ts < TS_S1 + TS_12H) & (host == TS_H1)
    out["ts.1"] = np.full(720, -np.inf)
    np.maximum.at(out["ts.1"], (ts[w] - TS_S1) // TS_MIN, v[w])
    w = (ts >= TS_S2) & (ts < TS_S2 + TS_HOUR) & np.isin(host, TS_H2)
    out["ts.2"] = np.full(60, -np.inf)
    np.maximum.at(out["ts.2"], (ts[w] - TS_S2) // TS_MIN, v[w])
    hour = (ts - TS_T0) // TS_HOUR
    out["hour"] = {}
    for h in np.unique(hour):
        m = hour == h
        out["hour"][int(h)] = (np.bincount(host[m], v[m], TS_HOSTS),
                               np.bincount(host[m], minlength=TS_HOSTS))
    _names, regions, _dcs = tsbs_host_tags(seed)
    w = (ts >= TS_S4) & (ts < TS_S4 + TS_12H) & (regions[host] == TS_R4)
    m5 = (ts[w] - TS_S4) // TS_5MIN
    out["ts.4"] = {int(j): np.bincount(host[w][m5 == j], v[w][m5 == j],
                                       TS_HOSTS) for j in np.unique(m5)}
    return out


def build_tsbs_segment(job):
    """Generate, fold the truth of and write TSBS segment i (a worker
    process: only the truth comes back)."""
    root, seed, i = job
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, TableConfig)
    from pinot_tpu_torch.segment.creator import SegmentCreator
    schema = Schema("cpu", [
        FieldSpec("ts", DataType.LONG, FieldType.DIMENSION),
        *(FieldSpec(c, DataType.STRING, FieldType.DIMENSION)
          for c in ("hostname", "region", "datacenter")),
        *(FieldSpec(c, DataType.DOUBLE, FieldType.METRIC)
          for c in ("usage_user", "usage_system", "usage_idle"))])
    tc = TableConfig("cpu")
    tc.indexing.no_dictionary_columns = ["ts", "usage_user", "usage_system",
                                         "usage_idle"]
    tc.indexing.compression = "PASS_THROUGH"
    cols, host = tsbs_columns(seed, i)
    truth = tsbs_truth(cols, host, seed)
    out = os.path.join(root, f"cpu_{i}")
    SegmentCreator(tc, schema).build(cols, out, f"cpu_{i}")
    return out, truth


def ts_sql(start, window, step, group_host=True, where="", agg=None):
    """The time-series leaf SQL over `cpu`: floor((ts - start) / step)
    [, hostname] over [start, start + window)."""
    b = f"floor((ts - {start}) / {step})"
    tags = ", hostname" if group_host else ""
    agg = agg or ("AVG(usage_user)" if group_host else "MAX(usage_user)")
    extra = f" AND {where}" if where else ""
    return (f"SELECT {b}{tags}, {agg} FROM cpu WHERE ts >= {start} AND "
            f"ts < {start + window}{extra} GROUP BY {b}{tags} LIMIT 100000")


def hosts_in(hosts) -> str:
    return "hostname IN (" + ", ".join(f"'host_{h}'" for h in hosts) + ")"


def ts_avg_check(rows, hours: dict, start: int, hosts=None):
    """None where rows are the AVG by hour and host over 12 h from `start`
    (hosts: every host, or these): the same (bucket, hostname) keys, each
    average within rel 1e-6 of the true one (values are >= 0: their sum is
    the sum of |contribution|)."""
    h0 = (start - TS_T0) // TS_HOUR
    want = {}
    for b in range(12):
        s, c = hours[h0 + b]
        for h in (range(TS_HOSTS) if hosts is None else hosts):
            if c[h]:
                want[(float(b), f"host_{h}")] = s[h] / c[h]
    got = {(r[0], r[1]): float(r[2]) for r in rows}
    if set(got) != set(want) or len(rows) != len(want):
        return f"{len(got)} groups, numpy truth {len(want)}"
    for k, v in want.items():
        if abs(got[k] - v) > 1e-6 * v:
            return f"group {k}: {got[k]} vs numpy truth {v}"
    return None


def ts_max_check(rows, maxima):
    """None where rows are one (bucket, MAX) per bucket with data, each
    equal to the float32 of the true maximum."""
    want = {float(b): float(np.float32(m)) for b, m in enumerate(maxima)
            if np.isfinite(m)}
    got = {r[0]: float(r[1]) for r in rows}
    if got != want:
        bad = next((k for k in want if got.get(k) != want[k]), None)
        return (f"{len(got)} buckets, numpy truth {len(want)}; bucket {bad}: "
                f"{got.get(bad)} vs {want.get(bad)}")
    return None


def tsbs_leg(tmp: str, seed: int, kernels, none: dict, card: str, done):
    """Phase 10: TSBS cpu-only at scale 4000 (103,680,000 rows in 25
    segments, `done`: build_tsbs_segment's results), ts.1-ts.3 through
    QueryExecutor and ts.4 through the port's time-series engine, each
    against its numpy truth; ts.3's sliding refreshes with no codegen;
    then 9g. Returns (K2's single launches of the leg, 9g's window
    launches, the leg's query lines)."""
    import torch

    from pinot_tpu_torch.ops import kernels as kmod
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.timeseries.engine import query as ts_query
    from pinot_tpu_torch.segment.loader import load_segment
    segs = [load_segment(out) for out, _t in done]
    truths = [t for _o, t in done]
    rows = sum(s.num_docs for s in segs)
    if rows != TS_ROWS or segs[-1].num_docs != \
            TS_ROWS - (TS_SEGMENTS - 1) * TS_FLUSH:
        fail(f"tsbs: {rows} rows in {len(segs)} segments")
    hours = {}
    for t in truths:
        for h, (s, c) in t["hour"].items():
            a, b = hours.get(h, (0.0, 0))
            hours[h] = (a + s, b + c)
    ts1 = np.max([t["ts.1"] for t in truths], 0)
    ts2 = np.max([t["ts.2"] for t in truths], 0)
    m5 = {}
    for t in truths:
        for j, s in t["ts.4"].items():
            m5[j] = m5.get(j, 0.0) + s
    ts4 = np.array([m5[j].max() for j in range(144)])
    queries = {
        "ts.1": (ts_sql(TS_S1, TS_12H, TS_MIN, False,
                        f"hostname = 'host_{TS_H1}'"), ITERS,
                 lambda r: ts_max_check(r, ts1)),
        "ts.2": (ts_sql(TS_S2, TS_HOUR, TS_MIN, False, hosts_in(TS_H2)),
                 ITERS, lambda r: ts_max_check(r, ts2)),
        "ts.3": (ts_sql(TS_S3, TS_12H, TS_HOUR), TS_HEAVY_ITERS,
                 lambda r: ts_avg_check(r, hours, TS_S3)),
    }
    ex = QueryExecutor(segs)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    legs, runs = [], 0
    for name, (sql, iters, check) in queries.items():
        resp, cold, lats, split = time_query(ex, sql, iters)
        why = check([tuple(r) for r in resp.rows])
        if why is not None:
            fail(f"{name}: {why}")
        runs += 1 + iters
        legs.append({"query": name, "rows": rows,
                     "groups": len(resp.rows),
                     "p50_ms": statistics.median(lats) * 1e3,
                     "cold_s": cold,
                     "rows_per_s": rows / statistics.median(lats),
                     "stage_ms": split})
    ts4_text = (f"fetch(cpu, usage_user, ts, {TS_S4}, {TS_S4 + TS_12H}, "
                f"{TS_5MIN}) | where(region = '{TS_R4}') | groupby(hostname) "
                f"| max() | keep_last_value()")
    lats = []
    for k in range(1 + TS_HEAVY_ITERS):
        t1 = time.perf_counter()
        block = ts_query(ts4_text, ex)
        lats.append(time.perf_counter() - t1)
        runs += 1
    got = block.series[0].values if len(block.series) == 1 else None
    if got is None or len(got) != 144 or not bool(
            (np.abs(got - ts4) <= 1e-6 * ts4).all()):
        fail(f"ts.4: {None if got is None else got[:4]} vs numpy truth "
             f"{ts4[:4]}")
    legs.append({"query": "ts.4", "rows": rows, "series": len(block.series),
                 "p50_ms": statistics.median(lats[1:]) * 1e3,
                 "cold_s": lats[0],
                 "rows_per_s": rows / statistics.median(lats[1:]),
                 "stage_ms": ex.last_stage_ms})
    # ts.3's sliding refreshes: only the start moves, nothing compiles
    codegen = kmod.trace_count()
    slide = []
    for k in range(1, TS_SLIDES + 1):
        start = TS_S3 + k * TS_HOUR
        t1 = time.perf_counter()
        resp = ex.execute(ts_sql(start, TS_12H, TS_HOUR))
        slide.append(time.perf_counter() - t1)
        why = ts_avg_check([tuple(r) for r in resp.rows], hours, start)
        if why is not None:
            fail(f"ts.3 refresh {k}: {why}")
    runs += TS_SLIDES
    if kmod.trace_count() != codegen:
        fail(f"ts.3's sliding refreshes compiled "
             f"{kmod.trace_count() - codegen} programs")
    got = launches_of_leg("time-series leg", kernels,
                          {**none, "group_agg": runs})
    if ex.engine.meter("timeseries_leaf_device") != runs:
        fail(f"{ex.engine.meter('timeseries_leaf_device')} leaves served "
             f"with the fused bucket of {runs}")
    peak = torch.cuda.max_memory_allocated()
    for leg in legs:
        leg["max_memory_allocated"] = peak
        print(f"[tsbs] {json.dumps(leg)} | {card}", flush=True)
    print(f"[tsbs] {json.dumps({'query': 'ts.3 sliding refreshes', 'refreshes': TS_SLIDES, 'p50_ms': statistics.median(slide) * 1e3, 'codegen': 0})}"
          f" | {card}", flush=True)
    for name in ("ts.1", "ts.3"):
        busy = device_busy(ex, queries[name][0], 3, tmp)
        print(f"[tsbs] trace {name} {json.dumps(busy or 'not measured')} "
              f"| {card}", flush=True)

    # phase 9g: ts.3-shaped panels (eight hosts each) under concurrency
    pool = [ts_sql(s, TS_12H, TS_HOUR, where=hosts_in(h))
            for s, h in TS_POOL]
    leg = concurrency_leg(
        "9g", modes_of(segs, pipelined=ex), pool,
        [list(range(len(pool)))] * CLIENTS,
        lambda i, r: ts_avg_check(r, hours, TS_POOL[i][0], TS_POOL[i][1]),
        card, tmp, kernels, "group_agg")
    del ex, segs
    torch.cuda.empty_cache()
    return got["group_agg"], got["row_assemble"], leg["launches"]


def upsert_truth(cols: dict, valid) -> dict:
    """One segment's answers to UPSERT_QUERIES over the docs `valid`
    keeps (None: every doc), from its generated columns."""
    from pinot_tpu_torch.query.sketches import HyperLogLog
    date, disc, qty, price = (cols[c] for c in SSB_COLS)
    v = np.ones(len(date), dtype=bool) if valid is None else valid
    lo, hi, c0, c1, q0, q1 = Q1_TRUTH["q1.1"]
    m = v & (date >= lo) & (date <= hi) & (disc >= c0) & (disc <= c1) \
        & (qty >= q0) & (qty <= q1)
    hll = HyperLogLog(HLL_LOG2M)
    hll.add_array(price[v & (disc >= 4) & (disc <= 6)].astype(np.int64))
    gb = {}
    for d in np.unique(disc[v]):
        k = v & (disc == d)
        gb[int(d)] = (int(k.sum()), int(price[k].min()), int(qty[k].max()))
    first = np.flatnonzero(v)[:5]
    return {"q1.1": (int((price[m].astype(np.int64) * disc[m]).sum()),
                     int(m.sum())),
            "count": int(v.sum()), "gb": gb,
            "sel": selection_truth(cols, v), "hll": hll.registers,
            "first": [(int(date[d]), int(price[d])) for d in first]}


def upsert_keep(seed: int, i: int, n: int):
    """Segment i's seeded valid docs (a third cleared) for i <
    UPSERT_SEGMENTS, else None (append-only)."""
    if i >= UPSERT_SEGMENTS:
        return None
    return np.random.default_rng([seed, 77, i]).random(n) >= 1 / 3


def upsert_segment_truth(job):
    """Segment i's upsert truth from its regenerated Q1 columns and valid
    docs (a worker process)."""
    seed, i, n = job
    cols = ssb_q1_columns(np.random.default_rng([seed, i]), n)
    return upsert_truth(cols, upsert_keep(seed, i, n))


def upsert_leg(segs, seed: int, kernels, none: dict, card: str):
    """Phase 4d: segments 0-11 of phase 4 carry validDocIds (the port's
    Bitmap) with a seeded third of docs cleared, 12-15 stay append-only;
    UPSERT_QUERIES through a fresh executor, each exact against the masked
    numpy truth. Then a seeded 1% of segment 3's valid docs is cleared:
    the next Q1.1 equals the new truth and uploads exactly segment 3's
    mask row (2^23 bytes) by the transfer odometer, a repeat nothing.
    Returns the leg's launches per kernel."""
    import torch

    from pinot_tpu_torch.ops import residency
    from pinot_tpu_torch.ops.engine import _pow2
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.query.sketches import HyperLogLog
    from pinot_tpu_torch.segment.bitmap import Bitmap
    t0 = time.perf_counter()
    valid = [upsert_keep(seed, i, seg.num_docs) for i, seg in enumerate(segs)]
    for seg, keep in zip(segs, valid):
        if keep is not None:
            seg.valid_doc_ids = Bitmap.from_mask(keep)
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(BUILD_WORKERS) as pool:
        truths = pool.map(upsert_segment_truth,
                          [(seed, i, seg.num_docs)
                           for i, seg in enumerate(segs)], chunksize=1)
    print(f"[upsert] {UPSERT_SEGMENTS} of {len(segs)} segments masked, "
          f"truth in {time.perf_counter() - t0:.1f} s", flush=True)
    rows = sum(s.num_docs for s in segs)
    total = sum(t["count"] for t in truths)

    def check(name, resp):
        got = [tuple(r) for r in resp.rows]
        if name == "q1.1":
            return exact_pair(got, sum(t["q1.1"][0] for t in truths),
                              sum(t["q1.1"][1] for t in truths))
        if name == "count":
            want = [(total,)]
        elif name == "gb":
            keys = sorted(set().union(*(t["gb"] for t in truths)))
            want = [(d, sum(t["gb"][d][0] for t in truths if d in t["gb"]),
                     float(min(t["gb"][d][1] for t in truths
                               if d in t["gb"])),
                     float(max(t["gb"][d][2] for t in truths
                               if d in t["gb"]))) for d in keys]
            got = [(int(r[0]), int(r[1]), float(r[2]), float(r[3]))
                   for r in got]
        elif name == "sel.1":
            want, matched = selection_expected(
                [t["sel"] for t in truths], "sel.1",
                resp.result_table.columns)
            if resp.stats.num_docs_scanned != matched:
                return f"{resp.stats.num_docs_scanned} matched, {matched}"
        elif name == "dist.1":
            want = sorted(set().union(*(t["sel"]["dist.1"]
                                        for t in truths)))
        elif name == "hll":
            regs = np.max([t["hll"] for t in truths], 0)
            want = [(HyperLogLog.from_registers(regs, HLL_LOG2M)
                     .cardinality(),)]
            got = [(int(got[0][0]),)]
        else:
            want = truths[0]["first"]
            if resp.stats.num_docs_scanned != total:
                return f"{resp.stats.num_docs_scanned} docs scanned, {total}"
        return None if got == want else f"{got[:4]} vs numpy truth {want[:4]}"

    ex = QueryExecutor(segs)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    want = dict(none)
    for name, (sql, kname) in UPSERT_QUERIES.items():
        resp, cold, lats, split = time_query(ex, sql, ITERS)
        why = check(name, resp)
        if why is not None:
            fail(f"upsert {name}: {why}")
        if kname is not None:
            want[kname] += 1 + ITERS
        leg = {"query": f"upsert {name}", "rows": rows, "valid": total,
               "p50_ms": statistics.median(lats) * 1e3, "cold_s": cold,
               "rows_per_s": rows / statistics.median(lats),
               "stage_ms": split}
        print(f"[upsert] {json.dumps(leg)} | {card}", flush=True)
    # an in-place clear of 1% of segment 3's valid docs
    v3 = segs[3].valid_doc_ids
    live = np.flatnonzero(valid[3])
    victims = np.random.default_rng([seed, 78]).choice(
        live, len(live) // 100, replace=False)
    for d in victims:
        v3.clear(int(d))
    valid[3][victims] = False
    truths[3] = upsert_truth(ssb_q1_columns(np.random.default_rng([seed, 3]),
                                            segs[3].num_docs), valid[3])
    moved = []
    for _ in range(2):
        torch.cuda.synchronize()
        b0 = residency.column_transfer_bytes()
        why = check("q1.1", ex.execute(UPSERT_QUERIES["q1.1"][0]))
        torch.cuda.synchronize()
        moved.append(residency.column_transfer_bytes() - b0)
        if why is not None:
            fail(f"upsert q1.1 after clear(): {why}")
    want["scan_agg"] += 2
    print(f"[upsert] {json.dumps({'cleared': len(victims), 'mask_bytes_uploaded': moved[0], 'repeat_bytes': moved[1]})}"
          f" | {card}", flush=True)
    # one byte per doc of segment 3's power-of-two bucket (2^23 at 8M docs)
    row = _pow2(segs[3].num_docs)
    if moved != [row, 0]:
        fail(f"upsert: the re-staging after clear() uploaded {moved} bytes, "
             f"expected [{row}, 0]")
    got = launches_of_leg("upsert leg", kernels, want)
    for seg in segs:
        seg.valid_doc_ids = None
    del ex
    torch.cuda.empty_cache()
    return got


# ---------------------------------------------------------------------------
# phase 11: the log leg (CLP); phase 3's K7 cases
# ---------------------------------------------------------------------------

class LogTokens:
    """code -> dictionary-variable token over LOG_FAMILIES (the families'
    codes concatenated in order): the parts writer renders only the codes
    a segment uses."""

    def __init__(self):
        self.base, b = {}, 0
        for name, n, _render in LOG_FAMILIES:
            self.base[name] = b
            b += n
        self._starts = [self.base[name] for name, _n, _r in LOG_FAMILIES]

    def __getitem__(self, code: int) -> str:
        import bisect
        f = bisect.bisect_right(self._starts, code) - 1
        return LOG_FAMILIES[f][2](code - self._starts[f])


def log_line(t: int, dv: list, ev: list) -> str:
    """Template t of bench.py:3377-3391 rendered from its dictionary
    variables' tokens and its encoded variables (a float as its IEEE bits,
    rendered as Python renders the float)."""
    import struct
    if t == 0:
        return f"INFO  request {dv[0]} served in {ev[0]} ms from host {dv[1]}"
    if t == 1:
        x = struct.unpack("<d", struct.pack("<q", ev[0]))[0]
        return f"WARN  GC pause of {x} seconds detected at offset {ev[1]}"
    if t == 2:
        return (f"ERROR Connection to {dv[0]}:{ev[0]} refused after "
                f"{ev[1]} retries")
    if t == 3:
        return f"INFO  user {dv[0]} logged in from {dv[1]}"
    if t == 4:
        return f"ERROR task {dv[0]} failed on host {dv[1]}: code={ev[0]}"
    return f"WARN  disk {dv[0]} at {dv[1]} capacity"


def log_columns(seed: int, i: int, n: int):
    """Segment i's n lines: `ts` (one line every 2 ms from LOG_T0 plus a
    seeded 0/1 ms jitter, so strictly increasing across segments) and the
    message as its CLP parts, drawn in numpy from the template ranges of
    bench.py:3377-3391 (the GC pause's seconds as hundredths in [0, 4],
    as round(random * 4, 2) gives them). Returns (columns, per line: its
    template, host (-1: none), served ms (-1: none), code (-1: none))."""
    from pinot_tpu_torch.segment.clp import ClpParts, encode_message
    rng = np.random.default_rng([seed, 1700, i])
    g = i * n + np.arange(n, dtype=np.int64)
    ts = LOG_T0 + 2 * g + rng.integers(0, 2, n)
    tpl = rng.integers(0, 6, n)
    tok = LogTokens()
    dv = np.full((n, 2), -1, dtype=np.int64)
    ev = np.zeros((n, 2), dtype=np.int64)
    host = np.full(n, -1, dtype=np.int64)
    served = np.full(n, -1, dtype=np.int64)
    code = np.full(n, -1, dtype=np.int64)
    for t in range(6):
        k = np.nonzero(tpl == t)[0]
        m = len(k)

        def draw(lo, hi):
            return rng.integers(lo, hi, m)
        if t == 0:
            h, served[k] = draw(0, 8), draw(1, 500)
            host[k] = h
            dv[k, 0] = tok.base["req"] + draw(0, 10**6)
            dv[k, 1] = tok.base["host"] + h
            ev[k, 0] = served[k]
        elif t == 1:
            ev[k, 0] = (draw(0, 401) / 100.0).view(np.int64)
            ev[k, 1] = draw(0, 10**9)
        elif t == 2:
            dv[k, 0] = tok.base["ip0"] + draw(0, 32) * 256 + draw(1, 255)
            ev[k, 0], ev[k, 1] = draw(1000, 9000), draw(1, 6)
        elif t == 3:
            dv[k, 0] = tok.base["user"] + draw(0, 500)
            dv[k, 1] = tok.base["ip1"] + draw(0, 32) * 256 + draw(1, 255)
        elif t == 4:
            h, code[k] = draw(0, 8), draw(400, 600)
            host[k] = h
            dv[k, 0] = tok.base["task"] + draw(0, 9999)
            dv[k, 1] = tok.base["host"] + h
            ev[k, 0] = code[k]
        else:
            dv[k, 0] = tok.base["disk"] + draw(0, 4)
            dv[k, 1] = tok.base["pct"] + draw(1, 99)
    ndv = np.array(LOG_DV, dtype=np.int32)[tpl]
    nev = np.array(LOG_EV, dtype=np.int32)[tpl]
    # each template's logtype, from the codec itself
    logtypes = []
    for t in range(6):
        d = int(np.nonzero(tpl == t)[0][0]) if (tpl == t).any() else None
        sample_dv = [tok[int(c)] for c in dv[d, :LOG_DV[t]]] if d is not None \
            else ["x1"] * LOG_DV[t]
        sample_ev = ev[d, :LOG_EV[t]].tolist() if d is not None \
            else [1] * LOG_EV[t]
        logtypes.append(encode_message(log_line(t, sample_dv, sample_ev))[0])
    parts = ClpParts(logtypes, tpl.astype(np.int32), ndv,
                     dv[np.arange(2)[None, :] < ndv[:, None]], tok, nev,
                     ev[np.arange(2)[None, :] < nev[:, None]])
    return {"ts": ts, "message": parts}, (tpl, host, served, code)


def log_message(cols: dict, d: int) -> str:
    """Line d of a segment's generated message column, rendered."""
    p = cols["message"]
    dvo = int(np.sum(p.dv_counts[:d]))
    evo = int(np.sum(p.ev_counts[:d]))
    t = int(p.lt_ids[d])
    dv = [p.dv_tokens[int(c)] for c in p.dv_codes[dvo:dvo + LOG_DV[t]]]
    return log_line(t, dv, p.ev[evo:evo + LOG_EV[t]].tolist())


def log_truth(cols: dict, lines) -> dict:
    """One segment's part of the log leg's answers, from the generator's
    templates and variables: logs.1-3 and logs.6 counts, logs.4's ERROR
    lines per minute of its hour, logs.5's last 100 (ts, message) of
    code 503 in the segment, and 9h's count per host."""
    tpl, host, served, code = lines
    ts = cols["ts"]
    w = (tpl == 2) | (tpl == 4)
    w &= (ts >= LOG_T4) & (ts < LOG_T4 + LOG_HOUR)
    tail = np.nonzero((tpl == 4) & (code == 503))[0][-100:]
    return {"logs.1": int((tpl == 2).sum()),
            "logs.2": int(((tpl == 4) & (host == 3)).sum()),
            "logs.3": int(((tpl == 0) & (served == 250)).sum()),
            "logs.4": np.bincount((ts[w] - LOG_T4) // 60000, minlength=60),
            "logs.5": [(int(ts[d]), log_message(cols, int(d)))
                       for d in tail],
            "logs.6": int((((tpl == 1) | (tpl == 5) | (tpl == 2))
                           & (ts < LOG_T0 + 12 * LOG_HOUR)).sum()),
            "pool": [int(((tpl == 4) & (host == h)).sum()) for h in range(8)]}


def log_honest(cols: dict, lines, seg, seed: int, i: int):
    """None where a seeded sample of the segment's lines, rendered, encodes
    to the generated parts (the port's encode_message) and reads back
    from the written segment (reader.get); else what differs."""
    from pinot_tpu_torch.segment.clp import encode_message
    p = cols["message"]
    n = p.num_docs
    rng = np.random.default_rng([seed, 1701, i])
    dvo = np.concatenate([[0], np.cumsum(p.dv_counts)])
    evo = np.concatenate([[0], np.cumsum(p.ev_counts)])
    reader = seg.data_source("message").clp_reader
    for d in sorted(int(x) for x in rng.choice(n, min(n, LOG_SAMPLE),
                                               replace=False)):
        t = int(p.lt_ids[d])
        dv = [p.dv_tokens[int(c)] for c in p.dv_codes[dvo[d]:dvo[d + 1]]]
        ev = p.ev[evo[d]:evo[d + 1]].tolist()
        line = log_line(t, dv, ev)
        if encode_message(line) != (p.logtypes[t], dv, ev):
            return f"line {d} {line!r} encodes to {encode_message(line)}"
        if reader.get(d) != line:
            return f"line {d}: reader {reader.get(d)!r}, generated {line!r}"
    return None


def build_log_segment(job):
    """Generate, fold the truth of, write and check log segment i (a worker
    process: the truth and the check's finding come back)."""
    root, seed, i, n = job
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, TableConfig)
    from pinot_tpu_torch.segment.creator import SegmentCreator
    from pinot_tpu_torch.segment.loader import load_segment
    schema = Schema("logs", [
        FieldSpec("ts", DataType.LONG, FieldType.DATE_TIME),
        FieldSpec("message", DataType.STRING, FieldType.DIMENSION)])
    tc = TableConfig("logs")
    tc.indexing.no_dictionary_columns = ["ts"]
    tc.indexing.clp_columns = ["message"]
    tc.indexing.compression = "PASS_THROUGH"
    cols, lines = log_columns(seed, i, n)
    truth = log_truth(cols, lines)
    out = os.path.join(root, f"logs_{i}")
    SegmentCreator(tc, schema).build(cols, out, f"logs_{i}")
    return out, truth, log_honest(cols, lines, load_segment(out), seed, i)


def build_log_segments(root: str, seed: int, n_segments: int, docs: int,
                       workers: int = 1):
    """The log table's segments, built in `workers` spawned processes (1:
    in this one): (segments, per-segment truths)."""
    jobs = [(root, seed, i, docs) for i in range(n_segments)]
    if workers > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            done = pool.map(build_log_segment, jobs, chunksize=1)
    else:
        done = [build_log_segment(job) for job in jobs]
    return load_log_segments(done)


def load_log_segments(done):
    """The log segments that build_log_segment wrote, loaded in order, and
    their truths; fails where a segment's generator check failed."""
    from pinot_tpu_torch.segment.loader import load_segment
    for i, (_o, _t, why) in enumerate(done):
        if why is not None:
            fail(f"log segment {i}: the generator disagrees with the codec: "
                 f"{why}")
    return [load_segment(out) for out, _t, _w in done], \
        [t for _o, t, _w in done]


def log_expected(truths: list, name: str):
    """A log query's numpy truth over the segments, as result rows."""
    if name == "logs.4":
        per_min = np.sum([t["logs.4"] for t in truths], axis=0)
        return [(float(m), int(c)) for m, c in enumerate(per_min) if c]
    if name == "logs.5":
        rows = sorted((r for t in truths for r in t["logs.5"]),
                      reverse=True)
        return rows[:100]
    return [(sum(t[name] for t in truths),)]


def log_rows(name: str, resp) -> list:
    """A log query's result rows in the shape log_expected gives."""
    if name == "logs.4":
        return sorted((float(r[0]), int(r[1])) for r in resp.rows)
    if name == "logs.5":
        return [(int(r[0]), str(r[1])) for r in resp.rows]
    return [(int(r[0]),) for r in resp.rows]


def staged_clp(ex, sql: str):
    """The inputs the engine stages for a CLP query, as on the main path:
    (its CLP leaves [(i, leaf)], cols, params, D)."""
    from pinot_tpu_torch.ops import kernels as kmod
    from pinot_tpu_torch.query.context import QueryContext
    ctx = QueryContext.from_sql(sql)
    eng = ex.engine
    with eng._engine_lock:
        if ctx.aggregations:
            plan, _ = eng._plan(ex.segments, ctx)
        else:
            plan = eng._plan_topn(ex.segments, ctx)
        cols, params, _nd, D = eng._stage(ex.segments, ctx, plan)
    (leaves,) = kmod.clp_leaves(plan).values()
    return leaves, cols, params, D


def check_clp(name: str, leaves, cols, params, D, B: int = 1) -> dict:
    """K7 against its plain version on the card, bit for bit: one launch
    over `leaves` (B = 1), or B members over one column set, each member's
    masks also against its own single launch. Returns its times, bound and
    error. Bound: the logtype id, the Kd dict-var and 2 Ke encoded-var
    int32 blocks read once, a byte per doc and leaf and member written,
    and the table bytes K7 can read (clp_table_bytes)."""
    import torch

    from pinot_tpu_torch.ops import _cuda
    from pinot_tpu_torch.ops import kernels as kmod
    plist = params if B > 1 else [params]
    out = _cuda.clp_match_batched(leaves, [cols], plist, [0] * B, D,
                                  batched=B > 1)

    def plain():
        return torch.stack([torch.stack([kmod.clp_match(i, lf, cols, p)
                                         for p in plist])
                            for i, lf in leaves])
    ref = plain()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        bad = (out != ref).nonzero()[:5].tolist()
        fail(f"{name}: K7 differs from its plain version at {bad}")
    single_ms = None
    if B > 1:
        for m, p in enumerate(plist):
            if not torch.equal(out[:, m], _cuda.clp_match(leaves, cols, p,
                                                          D)):
                fail(f"{name}: member {m} differs from its single launch")
        single_ms = cuda_ms(lambda: _cuda.clp_match(leaves, cols, plist[0],
                                                    D))
    kd = max(lf.meta[1] for _i, lf in leaves)
    ke = max(lf.meta[2] for _i, lf in leaves)
    S = cols[f"clpid:{leaves[0][1].column}"].shape[0]
    moved = S * D * ((1 + kd + 2 * ke) * 4 + len(leaves) * B) + sum(
        clp_table_bytes(i, lf, cols, p) for i, lf in leaves for p in plist)
    entry = {"case": name, "S": S, "D": D, "B": B, "Kd": kd, "Ke": ke,
             "leaves": len(leaves), "matched": int(out.sum()),
             "ms": cuda_ms(lambda: _cuda.clp_match_batched(
                 leaves, [cols], plist, [0] * B, D, batched=B > 1)),
             "plain_ms": cuda_ms(plain, iters=1 if B > 1 else 3),
             "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved,
             "bound_by": "bytes", "library_ms": None,
             "library": "none: no single PyTorch call computes the match",
             "max_abs_err": 0.0}
    if B > 1:
        entry.update(single_ms=single_ms, **{"8x_single_ms": B * single_ms})
    return entry


def clp_table_bytes(i: int, leaf, cols, params) -> int:
    """The bytes of leaf i's parameter tables that K7 can read for one
    member: the logtype LUT, the condition and group rows whole; of each
    var LUT row (mode 'a': the dict-var LUT; mode 'b': each dict LUT bank
    named by a dict condition of a live group, ck = 2 and a member of a
    group with glt >= 0), the entries up to the segment's largest staged
    dict-var id, the most any doc can index."""
    import torch
    mode, kd, _ke = leaf.meta
    tab = {k.split(":", 1)[1]: v for k, v in params.items()
           if k.startswith(f"leaf{i}:")}

    def size(t):
        return t.numel() * t.element_size()
    n = size(tab["alut"])
    if mode == "b":
        n += sum(size(tab[k]) for k in ("glt", "gmem", "ck", "cs", "chi",
                                         "clo", "cl"))
    if not kd:
        return n
    dv = torch.stack([cols[f"clpdv{j}:{leaf.column}"] for j in range(kd)])
    reach = dv.amax(dim=(0, 2)).to(torch.int64) + 1  # [S]
    if mode == "a":
        return n + int(reach.clamp(max=tab["dvlut"].shape[1]).sum())
    dlut = tab["dlut"]  # [S, nlp, vp]
    nlp, vp = dlut.shape[1], dlut.shape[2]
    live = ((tab["glt"] >= 0)[:, :, None] & tab["gmem"]).any(dim=1)
    named = live & (tab["ck"] == 2)  # [S, ncp]
    bank = tab["cl"].clamp(0, nlp - 1).to(torch.int64)
    used = torch.zeros((dlut.shape[0], nlp), dtype=torch.int32,
                       device=dlut.device)
    used.scatter_add_(1, bank, named.to(torch.int32))
    return n + int(((used > 0).sum(dim=1) * reach.clamp(max=vp)).sum())


def clp_kernel_inputs(seed: int, mode: str, B: int = 1):
    """K7's phase-3 cases at S = K7_SEGMENTS = 32, D = 2^22, made
    on the card: (leaves, cols, params or B members' params, D). Logtype
    ids 0-5 of an 8-wide LUT; var-dictionary cardinalities of 2^19 to 2^20
    per segment (vp = 2^20, as 2^22 bench lines give), a quarter of the
    dict-var slots at the sentinel (the cardinality); mode 'a' Kd = 2;
    mode 'b' Kd = Ke = 2, encoded (hi, lo) pairs drawn from a few values
    (negative lows included) so equal and unequal pairs both occur, 16
    conditions (the last three padding, ck = 0) and 64 groups (the last 8
    padding, glt = -1) over 8 dict LUT banks."""
    import torch

    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    S, D, vp, cp = K7_SEGMENTS, LOG_DOCS, 1 << 20, 8

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)
    card = ints(1 << 19, vp - 1, (S,))
    kd, ke = 2, 0 if mode == "a" else 2
    cols = {"clpid:m": ints(0, 6, (S, D))}
    for j in range(kd):
        v = (rand((S, D)) * (card[:, None] + 1)).to(torch.int32)
        cols[f"clpdv{j}:m"] = torch.where(rand((S, D)) < 0.25,
                                          card[:, None], v)
    for j in range(ke):
        cols[f"clpehi{j}:m"] = ints(-2, 2, (S, D))
        cols[f"clpelo{j}:m"] = ints(-3, 3, (S, D))
    live = torch.arange(vp, device=dev)[None, :] < card[:, None]

    def member():
        p = {"leaf0:alut": rand((S, cp)) < 0.1}
        if mode == "a":
            p["leaf0:dvlut"] = (rand((S, vp)) < 0.2) & live
            return p
        ck = ints(0, 3, (S, 16)).to(torch.int8)
        ck[:, 13:] = 0
        glt = ints(0, 6, (S, 64))
        glt[:, 56:] = -1
        p.update({"leaf0:glt": glt, "leaf0:gmem": rand((S, 64, 16)) < 0.15,
                  "leaf0:ck": ck, "leaf0:cs": ints(0, 2, (S, 16)),
                  "leaf0:chi": ints(-2, 2, (S, 16)),
                  "leaf0:clo": ints(-3, 3, (S, 16)),
                  "leaf0:cl": ints(0, 8, (S, 16)),
                  "leaf0:dlut": (rand((S, 8, vp)) < 0.5) & live[:, None]})
        return p
    leaves = [(0, DeviceLeaf("clp", "m", (mode, kd, ke)))]
    params = member() if B == 1 else [member() for _ in range(B)]
    return leaves, cols, params, D


def log_leg(tmp: str, seed: int, kernels, none: dict, card: str, done):
    """Phase 11: the log table (LOG_SEGMENTS x LOG_DOCS lines of bench.py's
    templates, `ts` an epoch-millis LONG without a dictionary, `message` a
    CLP column) built from the generator's parts (`done`:
    build_log_segment's results), logs.1-logs.6 through
    QueryExecutor against their numpy truth (float64 values: logs.5 orders
    by the raw epoch-millis ts), the wildcard pattern refused with its
    reason and no launch, K7 held against its plain version on the inputs
    the engine staged for logs.2 and logs.6 (two leaves, one launch), then
    9h. Returns (the leg's launches per kernel, 9h's window launches)."""
    import torch

    from pinot_tpu_torch.ops.engine import NotOffloadable
    from pinot_tpu_torch.query.executor import QueryExecutor
    segs, truths = load_log_segments(done)
    rows = sum(s.num_docs for s in segs)
    ex = QueryExecutor(segs, value_dtype=torch.float64)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    legs, runs = [], Counter()
    queries = log_queries()
    for name, (sql, kname) in queries.items():
        t1 = time.perf_counter()
        resp = ex.execute(sql)
        cold, cold_split = time.perf_counter() - t1, ex.last_stage_ms
        lats, splits = [], []
        for _ in range(ITERS):
            t1 = time.perf_counter()
            resp = ex.execute(sql)
            lats.append(time.perf_counter() - t1)
            splits.append(ex.last_stage_ms)
        got, want = log_rows(name, resp), log_expected(truths, name)
        if got != want:
            fail(f"{name}: {got[:3]} ({len(got)} rows) vs numpy truth "
                 f"{want[:3]} ({len(want)} rows)")
        runs[kname] += 1 + ITERS
        runs["clp_match"] += 1 + ITERS
        legs.append({"query": name, "rows": rows, "result_rows": len(got),
                     "p50_ms": statistics.median(lats) * 1e3,
                     "cold_s": cold,
                     "rows_per_s": rows / statistics.median(lats),
                     "cold_stage_ms": cold_split,
                     "stage_ms": {k: statistics.median(sp[k] for sp in splits)
                                  for k in splits[0]}})
    got = launches_of_leg("log leg", kernels, {**none, **runs})
    served = ex.engine.meter("clp_served")
    if served != sum(runs[k] for k in runs if k != "clp_match"):
        fail(f"clp_served {served}, expected one per query run")
    # the refused pattern: its reason, and no launch
    zero_launches(kernels)
    try:
        ex.execute(LOG_WILDCARD)
        fail(f"{LOG_WILDCARD} was not refused")
    except NotOffloadable as e:
        if e.reason != "wildcard" \
                or ex.engine.meter("clp_fallback", "wildcard") != 1:
            fail(f"{LOG_WILDCARD}: reason {e.reason!r}, meter "
                 f"{ex.engine.meter('clp_fallback', 'wildcard')}")
    launches_of_leg("the refused pattern", kernels, none)
    peak = torch.cuda.max_memory_allocated()
    for leg in legs:
        leg["max_memory_allocated"] = peak
        print(f"[logs] {json.dumps(leg)} | {card}", flush=True)
    print(f"[logs] {json.dumps({'refused': LOG_WILDCARD, 'reason': 'wildcard', 'launches': 0})}"
          f" | {card}", flush=True)
    busy = device_busy(ex, queries["logs.2"][0], ITERS, tmp)
    print(f"[logs] trace logs.2 {json.dumps(busy or 'not measured')} "
          f"| {card}", flush=True)
    # after the launch counts were read: these launches are the
    # comparison's, not the main path's
    for name in ("logs.2", "logs.6"):
        case = check_clp(f"staged {name}", *staged_clp(
            ex, queries[name][0]))
        print(f"[kernel] clp_match {json.dumps(case)} | {card}", flush=True)

    # phase 9h: bench.py:3531's coalesce pool under concurrency (K7, K1)
    def pool_check(i, r):
        want = sum(t["pool"][i] for t in truths)
        return None if r == [(want,)] or r == [(float(want),)] else \
            f"{r} vs numpy truth {want}"
    leg = concurrency_leg(
        "9h", modes_of(segs, pipelined=ex, value_dtype=torch.float64),
        LOG_POOL, [list(range(len(LOG_POOL)))] * CLIENTS, pool_check, card,
        tmp, kernels, ("scan_agg", "clp_match"))
    del ex, segs
    torch.cuda.empty_cache()
    return got, leg["launches"]


# ---------------------------------------------------------------------------
# phase 12: the vector leg (K8); phase 3's K8 cases; the MSE leaf
# ---------------------------------------------------------------------------

def vector_columns(seed: int, i: int, n: int, offset: int) -> dict:
    """Segment i of a vector table: bench.py:4674-4700's clustered mixture
    at d = VEC_DIM (VEC_CENTERS centres drawn from seed 5999, scaled by
    2.0; each doc a seeded centre plus 0.3 Gaussian noise), its global
    `id`s from `offset` and a `category` of VEC_CATEGORIES values for the
    residual filter."""
    centers = np.random.default_rng(5999).normal(
        size=(VEC_CENTERS, VEC_DIM)) * 2.0
    rng = np.random.default_rng([seed, 12, i])
    which = rng.integers(0, VEC_CENTERS, n)
    vecs = (centers[which] + 0.3 * rng.normal(size=(n, VEC_DIM))
            ).astype(np.float32)
    return {"id": np.arange(offset, offset + n, dtype=np.int32),
            "category": rng.integers(0, VEC_CATEGORIES, n).astype(np.int32),
            "vec": vecs}


def build_vector_segment(job):
    """Generate and write segment i of vector table `table` with the port's
    creator, the vector column given as its float32 block (the creator
    renders its JSON arrays and builds the index, IVF cells from
    IVF_THRESHOLD docs on); returns (its directory, the seconds it took).
    Runs in a worker process."""
    root, table, seed, i, n, offset = job
    from pinot_tpu_torch.models import (DataType, FieldSpec, FieldType,
                                        Schema, TableConfig)
    from pinot_tpu_torch.segment.creator import SegmentCreator
    t0 = time.perf_counter()
    schema = Schema(table, [
        FieldSpec("id", DataType.INT, FieldType.DIMENSION),
        FieldSpec("category", DataType.INT, FieldType.DIMENSION),
        FieldSpec("vec", DataType.STRING, FieldType.DIMENSION)])
    tc = TableConfig(table)
    tc.indexing.vector_index_columns = ["vec"]
    tc.indexing.no_dictionary_columns = ["id", "vec"]
    tc.indexing.compression = "PASS_THROUGH"
    out = os.path.join(root, f"{table}_{i}")
    SegmentCreator(tc, schema).build(vector_columns(seed, i, n, offset), out,
                                     f"{table}_{i}")
    return out, time.perf_counter() - t0


def vector_jobs(root: str, seed: int, table: str = "vec",
                n_segments: int = 0, docs: int = 0, first: int = 0) -> list:
    """build_vector_segment's jobs: n_segments segments (VEC_SEGMENTS by
    default) of `docs` docs (VEC_DOCS), generator streams from `first`."""
    n_segments, docs = n_segments or VEC_SEGMENTS, docs or VEC_DOCS
    return [(root, table, seed, first + i, docs, i * docs)
            for i in range(n_segments)]


def vec_query_vectors(indexes, seed: int, n: int, tag: int) -> list:
    """n query vectors of the lookup workload (bench.py:4719-4724): a
    seeded stored vector (normalized) plus 0.05 Gaussian noise."""
    rng = np.random.default_rng([seed, 12, tag])
    out = []
    for _ in range(n):
        ix = indexes[int(rng.integers(0, len(indexes)))]
        base = ix.vectors[int(rng.integers(0, len(ix.vectors)))]
        out.append((base + 0.05 * rng.normal(size=base.shape)
                    ).astype(np.float32))
    return out


def vec_sql(qv, k: int, limit: int, table: str = "vec",
            where: str = "") -> str:
    lit = json.dumps([float(x) for x in qv])
    return (f"SELECT id FROM {table} WHERE "
            f"vector_similarity(vec, '{lit}', {k}){where} LIMIT {limit}")


def vec_expected(segs, indexes, qv, k: int, limit: int, category=None):
    """(rows, band) of a vector query from the host search: per segment
    VectorIndex.top_k's search (score descending, ties toward the lower
    doc) over the probe cells the engine stages for this query (IVF; every
    doc without cells), its K winners in doc order, those of `category`
    where given; segments in order, cut to `limit`. `band`: the ids whose
    float64 score lies within 2 VEC_TOL of a segment's K-th, which sums in
    another order may rank across the cut."""
    from pinot_tpu_torch.ops.vector_device import NPROBE
    q = (qv / max(float(np.linalg.norm(qv)), 1e-30)).astype(np.float32)
    rows, band = [], set()
    for seg, ix in zip(segs, indexes):
        probe = ix.probe_cells(q, NPROBE)
        cand = np.arange(len(ix.vectors)) if probe is None \
            else np.nonzero(np.isin(ix.assignments, probe))[0]
        scores = ix.vectors[cand] @ q
        win = np.sort(cand[np.lexsort((cand, -scores))[:k]])
        ids = seg.data_source("id").values()
        if len(cand) > k:
            exact = ix.vectors[cand].astype(np.float64) @ q.astype(np.float64)
            t = np.sort(exact)[::-1][k - 1]
            near = cand[np.abs(exact - t) <= 2 * VEC_TOL]
            if len(near) > 1:
                band |= set(ids[near].tolist())
        if category is not None:
            cat = seg.data_source("category").values()
            win = win[cat[win] == category]
        rows += [(int(ids[d]),) for d in win]
    return rows[:limit], band


def vec_rows_agree(got, want, band, limit: int) -> bool:
    """got equals want, or, where a band of near-tied scores reaches a
    segment's cut, the two agree outside the band (as far as the LIMIT
    leaves both comparable)."""
    if not band:
        return got == want
    g = [r for r in got if r[0] not in band]
    w = [r for r in want if r[0] not in band]
    if len(got) < limit and len(want) < limit:
        return g == w
    m = max(0, min(len(g), len(w)) - len(band))
    return g[:m] == w[:m]


def vec_recall(ex, segs, indexes, qvs, k: int = 10) -> float:
    """recall@k of vec.1-shaped queries against the exact numpy ground
    truth: each segment's exact top k over every doc, the union across
    segments (bench.py's recall leg: vector_similarity is a per-segment
    filter, and the LIMIT spans the union)."""
    Q = np.stack([qv / max(float(np.linalg.norm(qv)), 1e-30) for qv in qvs]
                 ).astype(np.float32)
    want = [set() for _ in qvs]
    for seg, ix in zip(segs, indexes):
        ids = seg.data_source("id").values()
        top = np.argpartition(-(Q @ ix.vectors.T), k, axis=1)[:, :k]
        for j, w in enumerate(want):
            w |= set(ids[top[j]].tolist())
    hits = total = 0
    for qv, w in zip(qvs, want):
        got = {r[0] for r in ex.execute(vec_sql(qv, k, k * len(segs))).rows}
        hits += len(got & w)
        total += len(w)
    return hits / total


def vector_block(seed: int, rows: int):
    """Phase 3's K8 inputs on the card, made from `seed`: `rows` rows of
    K8_D docs, the first VEC_DOCS of each a unit vector of VEC_DIM
    Gaussian values zero-padded to dim_pad 128 (the leg's shapes), with
    IVF cells of 999 ids, a category of VEC_CATEGORIES values and a uint8
    validity mask keeping about two thirds of docs."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    vec = torch.zeros((rows, K8_D, 128), dtype=torch.float32, device=dev)
    for r in range(rows):
        v = torch.randn((VEC_DOCS, VEC_DIM), generator=g, device=dev)
        vec[r, :VEC_DOCS, :VEC_DIM] = v / v.norm(dim=1, keepdim=True)
        del v
    cells = torch.randint(0, 999, (rows, K8_D), generator=g, device=dev,
                          dtype=torch.int32)
    cat = torch.randint(0, VEC_CATEGORIES, (rows, K8_D), generator=g,
                        device=dev, dtype=torch.int8)
    vmask = (torch.rand((rows, K8_D), generator=g, device=dev)
             < 2 / 3).to(torch.uint8)
    return {"vec": vec.view(rows, K8_D * 128), "vcell": cells,
            "category": cat, "vmask": vmask}


def vector_case(block, seed: int, k: int, ivf: bool, resid: bool,
                B: int = 1, stacked: bool = False):
    """(plan, column sets, member params, num_docs per set, member-to-set
    map, D) of one K8 phase-3 case over `block`: K8_SEGMENTS segments, the
    first VEC_SEGMENTS real (VEC_DOCS docs), the rest padding; member m
    over rows m .. m + K8_SEGMENTS - 1 of the block when stacked (each its
    own column set), over rows 0 .. K8_SEGMENTS - 1 otherwise; each
    member's own query (one unit vector, zero-padded), K, probe cells
    (IVF: NPROBE of 999 per real segment) and category."""
    import torch

    from pinot_tpu_torch.ops.plan_ir import DeviceLeaf, DevicePlan
    from pinot_tpu_torch.ops.vector_device import NPROBE, _pow2
    dev = block["vec"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    S, D = K8_SEGMENTS, K8_D
    plan = DevicePlan(
        filter_ir=("leaf", 0) if resid else None,
        leaves=(DeviceLeaf("range", "category"),) if resid else (),
        value_irs=(), agg_ops=(),
        dict_cols=("category",) if resid else (), mode="vector",
        valid_mask=resid, vec_col="vec", dim_pad=128, k_pad=_pow2(k),
        ivf=ivf, cells_pad=1024 if ivf else 0)
    nd = torch.tensor([VEC_DOCS] * VEC_SEGMENTS
                      + [0] * (S - VEC_SEGMENTS), dtype=torch.int32,
                      device=dev)
    sets = []
    for u in range(B if stacked else 1):
        cols = {"vec:vec": block["vec"][u:u + S]}
        if ivf:
            cols["vcell:vec"] = block["vcell"][u:u + S]
        if resid:
            cols["ids:category"] = block["category"][u:u + S]
            cols["vmask"] = block["vmask"][u:u + S]
        sets.append(cols)
    plist = []
    for _m in range(B):
        q = torch.zeros(128, dtype=torch.float32, device=dev)
        v = torch.randn(VEC_DIM, generator=g, device=dev)
        q[:VEC_DIM] = v / v.norm()
        p = {"vq:q": q.expand(S, 128).contiguous(),
             "vq:k": torch.full((S,), k, dtype=torch.int32, device=dev)}
        if ivf:
            pick = torch.rand((S, 999), generator=g, device=dev).topk(
                NPROBE, dim=1).indices
            cells = torch.zeros((S, 1024), dtype=torch.bool, device=dev)
            cells[:VEC_SEGMENTS].scatter_(1, pick[:VEC_SEGMENTS], True)
            p["vq:cells"] = cells
        if resid:
            c = torch.randint(0, VEC_CATEGORIES, (S,), generator=g,
                              device=dev, dtype=torch.int32)
            p["leaf0:lo"], p["leaf0:hi"] = c, c.clone()
        plist.append(p)
    idx = list(range(B)) if stacked else [0] * B
    return plan, sets, plist, [nd] * len(sets), idx, D


def vector_bytes(plan, col_sets, plist, ndlist, idx, D, out) -> int:
    """The bytes K8's function must move on these inputs: per column set,
    the cell id of each real doc (IVF) and the row (dim_pad x 4 bytes) of
    each doc some member over the set scores (every real doc without IVF,
    those in a probed cell with it), once; the residual filter's columns
    and the validity mask at each member's winners; each member's
    parameters, each set's num_docs and the output once."""
    import torch

    from pinot_tpu_torch.ops import program
    moved = winners = 0
    kk = min(plan.k_pad, D)
    for u, (cols, nd) in enumerate(zip(col_sets, ndlist)):
        real = torch.arange(D, device=nd.device)[None, :] < nd[:, None]
        scored = torch.zeros_like(real)
        for p in [p for p, v in zip(plist, idx) if v == u]:
            cand = real
            if plan.ivf:
                cell = cols["vcell:" + plan.vec_col].long().clamp(
                    0, plan.cells_pad - 1)
                cand = real & torch.gather(p["vq:cells"], 1, cell)
            scored |= cand
            winners += int(cand.sum(1).clamp(max=kk).sum())
        if plan.ivf:
            moved += int(real.sum()) * 4
        moved += int(scored.sum()) * plan.dim_pad * 4
        moved += nd.numel() * nd.element_size()
    per_doc = sum(col_sets[0][c].element_size()
                  for c in program.compile_plan(plan).cols) \
        + (1 if plan.valid_mask else 0)
    moved += winners * per_doc
    moved += sum(v.numel() * v.element_size()
                 for p in plist for v in p.values()) \
        + out.numel() * out.element_size()
    return moved


def check_vector(name: str, plan, sets, plist, ndlist, idx, D) -> dict:
    """K8 against its plain version on the card, bit for bit over the whole
    [.., S, 1 + 2 kk] output (scores included): one launch (B = 1) or B
    members, each member also against its own single launch. Returns the
    case's entry: times, bound, the plain version's time and the
    torch.bmm + torch.topk yardstick on the same block (two calls; topk
    keeps no tie order: a time only; none where members read other
    column sets)."""
    import torch

    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.ops import vector_device as vd
    B = len(plist)
    if B == 1:
        kern = kernels.make_vector_kernel(plan)

        def run():
            return kern(sets[0], plist[0], ndlist[0], D)

        def plain():
            return vd.vector_topk(plan, sets[0], plist[0], ndlist[0], D)
    else:
        batched = kernels.batched_kernel(plan)

        def run():
            return batched(sets, plist, ndlist, idx, D)

        def plain():
            return kernels.plain_batched_kernel(plan)(sets, plist, ndlist,
                                                      idx, D)
    out = run()
    ref = plain()
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        bad = (out.view(torch.int32) != ref.view(torch.int32)).nonzero()
        fail(f"vector_topk {name}: K8 differs from its plain version at "
             f"{bad[:5].tolist()}")
    entry = {"case": name, "S": int(ndlist[0].shape[0]), "D": D, "B": B,
             "k": int(plist[0]["vq:k"][0]), "kk": min(plan.k_pad, D),
             "ivf": plan.ivf, "residual": plan.filter_ir is not None,
             "kept": int(out[..., 0].sum())}
    if B > 1:
        single = kernels.make_vector_kernel(plan)
        for m in range(B):
            one = single(sets[idx[m]], plist[m], ndlist[idx[m]], D)
            if not torch.equal(one.view(torch.int32),
                               out[m].view(torch.int32)):
                fail(f"vector_topk {name}: member {m} differs from its "
                     "single launch")
        entry["single_ms"] = cuda_ms(lambda: single(sets[0], plist[0],
                                                    ndlist[0], D))
        entry["8x_single_ms"] = B * entry["single_ms"]
    moved = vector_bytes(plan, sets, plist, ndlist, idx, D, out)
    kk = entry["kk"]
    library_ms = None
    if len(sets) == 1:
        V = sets[0]["vec:" + plan.vec_col].view(-1, D, plan.dim_pad)
        Q = torch.stack([p["vq:q"] for p in plist], 2)

        def library():
            return torch.topk(torch.bmm(V, Q), kk, dim=1)
        library_ms = cuda_ms(library)
    entry.update(
        ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=1 if B > 1 else 3),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bytes=moved,
        bound_by="bytes", library_ms=library_ms,
        library="torch.bmm + torch.topk on the same block (two calls, no "
                "tie order: a time only)" if library_ms is not None else
                "none: no one PyTorch call reads the members' own blocks",
        max_abs_err=max_abs_err(out, ref))
    return entry


#: phase 3's K8 single-launch cases and phase 3b's B = 8 forms: name ->
#: (k, ivf, residual and validity mask, stacked)
K8_CASES = {"exact k=10": (10, False, False, False),
            "exact k=100": (100, False, False, False),
            "ivf k=10": (10, True, False, False),
            "ivf k=100 + residual + vmask": (100, True, True, False)}
K8_BATCHED = {"broadcast ivf k=10": (10, True, False, False),
              "stacked ivf k=10": (10, True, False, True)}


def vector_kernel_cases(seed: int, card: str):
    """Phase 3's K8 cases and phase 3b's B = 8 forms on one generated block
    (K8_SEGMENTS + BATCH_B - 1 rows, so each stacked member reads its own
    rows); returns ({case: entry}, {form: entry})."""
    import torch
    block = vector_block(seed, K8_SEGMENTS + BATCH_B - 1)
    single, batched = {}, {}
    for i, (name, (k, ivf, resid, _st)) in enumerate(K8_CASES.items()):
        single[name] = check_vector(name, *vector_case(block, seed + i, k,
                                                       ivf, resid))
        print(f"[kernel] vector_topk {json.dumps(single[name])} | {card}",
              flush=True)
    for i, (name, (k, ivf, resid, st)) in enumerate(K8_BATCHED.items()):
        batched[name] = check_vector(name, *vector_case(
            block, seed + 10 + i, k, ivf, resid, B=BATCH_B, stacked=st))
        print(f"[kernel] vector_topk batched {json.dumps(batched[name])} "
              f"| {card}", flush=True)
        torch.cuda.empty_cache()
    del block
    torch.cuda.empty_cache()
    return single, batched


def staged_vector(ex, sql: str):
    """The inputs the engine stages for K8 on a vector query, as it stages
    them on the main path: (plan, [cols], [params], [num_docs], [0], D)."""
    from pinot_tpu_torch.query.context import QueryContext
    ctx = QueryContext.from_sql(sql)
    segs = ex.segments_of(ctx.table)
    eng = ex.engine
    with eng._engine_lock:
        plan, (fn, qv, k), rctx = eng._plan_vector(segs, ctx, meter=False)
        cols, params, nd, D = eng._stage_vector(segs, rctx, plan, fn, qv, k,
                                                None)
    return plan, [cols], [params], [nd], [0], D


def load_vector_segments(done):
    from pinot_tpu_torch.segment.loader import load_segment
    segs = [load_segment(out) for out, _s in done]
    return segs, [s.data_source("vec").vector_index for s in segs]


def vector_queries(segs, indexes, xsegs, xindexes, seed: int) -> dict:
    """vec.1-vec.4: name -> (sql, (rows, band) of the host search, LIMIT).
    vec.3's category is the first query vector's nearest doc's."""
    q1, q2, q3 = vec_query_vectors(indexes, seed, 3, 1)
    (q4,) = vec_query_vectors(xindexes, seed, 1, 4)
    ix = indexes[0]
    c = int(segs[0].data_source("category").values()[
        int(np.argmax(ix.vectors @ (q3 / np.linalg.norm(q3))))])
    specs = {"vec.1": (segs, indexes, q1, 10, 100, None, "vec"),
             "vec.2": (segs, indexes, q2, 100, 1000, None, "vec"),
             "vec.3": (segs, indexes, q3, 100, 1000, c, "vec"),
             "vec.4": (xsegs, xindexes, q4, 10, 100, None, "vecx")}
    out = {}
    for name, (ss, ixs, qv, k, limit, cat, table) in specs.items():
        where = "" if cat is None else f" AND category = {cat}"
        out[name] = (vec_sql(qv, k, limit, table, where),
                     vec_expected(ss, ixs, qv, k, limit, cat), limit)
    return out


def vector_leg(tmp: str, seed: int, kernels, none: dict, card: str, done):
    """Phase 12: the vector table (VEC_SEGMENTS x VEC_DOCS vectors of d =
    VEC_DIM with their IVF cells, built beside phase 3: `done`) and the
    exact-path table vecx (VEC_EXACT_SEGMENTS x VEC_EXACT_DOCS, below
    IVF_THRESHOLD, built here) on one server; vec.1-vec.4 through
    QueryExecutor, each equal to the host search of the same probe cells
    (VectorIndex.top_k's; exact on vecx) up to a band of near-tied
    scores; launches K8 once per query run, K6 once per block assembled;
    an OR and an ORDER BY refused with reason 'hybrid' and no launch;
    recall@10 of VEC_RECALL queries printed; K8 held to its plain version
    on the engine's staging of vec.1 and vec.3; then 9i. Returns (the
    leg's launches per kernel, 9i's window launches)."""
    import torch

    from pinot_tpu_torch.ops.engine import NotOffloadable
    from pinot_tpu_torch.query.executor import QueryExecutor
    t0 = time.perf_counter()
    segs, indexes = load_vector_segments(done)
    xsegs, xindexes = load_vector_segments(
        [build_vector_segment(j) for j in vector_jobs(
            tmp, seed, "vecx", VEC_EXACT_SEGMENTS, VEC_EXACT_DOCS, 100)])
    if any(ix.centroids is None for ix in indexes) \
            or any(ix.centroids is not None for ix in xindexes):
        fail("the vector tables do not have the IVF layer they need")
    rows = sum(s.num_docs for s in segs)
    print(f"[vector] loaded {len(segs)} segments, {rows} vectors "
          f"({len(indexes[0].centroids)} cells each) and vecx in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    queries = vector_queries(segs, indexes, xsegs, xindexes, seed)
    ex = QueryExecutor({"vec": segs, "vecx": xsegs})
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    legs = []
    for name, (sql, (want, band), limit) in queries.items():
        t1 = time.perf_counter()
        resp = ex.execute(sql)
        cold, cold_split = time.perf_counter() - t1, ex.last_stage_ms
        lats, splits = [], []
        for _ in range(ITERS):
            t1 = time.perf_counter()
            resp = ex.execute(sql)
            lats.append(time.perf_counter() - t1)
            splits.append(ex.last_stage_ms)
        got = rows_of(resp)
        if not vec_rows_agree(got, want, band, limit):
            fail(f"{name}: {got[:5]} ({len(got)} rows) vs the host search "
                 f"{want[:5]} ({len(want)} rows), band {sorted(band)[:5]}")
        legs.append({"query": name, "rows": rows if name != "vec.4"
                     else sum(s.num_docs for s in xsegs),
                     "result_rows": len(got), "band": len(band),
                     "p50_ms": statistics.median(lats) * 1e3,
                     "cold_s": cold, "cold_stage_ms": cold_split,
                     "stage_ms": {k: statistics.median(sp[k] for sp in splits)
                                  for k in splits[0]}})
    runs = len(queries) * (1 + ITERS)
    got = launches_of_leg("vector leg", kernels,
                          {**none, "vector_topk": runs})
    if ex.engine.meter("vector_served") != runs:
        fail(f"vector_served {ex.engine.meter('vector_served')}, expected "
             "one per query run")
    zero_launches(kernels)
    q1 = json.loads(queries["vec.1"][0].split("'")[1])
    for what, sql in (
            ("OR", vec_sql(q1, 10, 100, where=" OR category = 3")),
            ("ORDER BY", vec_sql(q1, 10, 100).replace(
                " LIMIT", " ORDER BY id LIMIT"))):
        try:
            ex.execute(sql)
            fail(f"a vector query under {what} was not refused")
        except NotOffloadable as e:
            if e.reason != "hybrid":
                fail(f"a vector query under {what}: reason {e.reason!r}")
    if ex.engine.meter("vector_fallback", "hybrid") != 2:
        fail("the refused vector queries were not counted as 'hybrid'")
    launches_of_leg("the refused vector queries", kernels, none)
    peak = torch.cuda.max_memory_allocated()
    for leg in legs:
        leg["max_memory_allocated"] = peak
        print(f"[vector] {json.dumps(leg)} | {card}", flush=True)
    t1 = time.perf_counter()
    recall = vec_recall(ex, segs, indexes,
                        vec_query_vectors(indexes, seed, VEC_RECALL, 50))
    line = {"recall@10": recall, "queries": VEC_RECALL, "nprobe": 8,
            "seconds": time.perf_counter() - t1}
    print(f"[vector] {json.dumps(line)} | {card}", flush=True)
    busy = device_busy(ex, queries["vec.1"][0], ITERS, tmp)
    print(f"[vector] trace vec.1 {json.dumps(busy or 'not measured')} "
          f"| {card}", flush=True)
    # after the launch counts were read: these launches are the
    # comparison's, not the main path's
    for name in ("vec.1", "vec.3"):
        case = check_vector(f"staged {name}",
                            *staged_vector(ex, queries[name][0]))
        print(f"[kernel] vector_topk {json.dumps(case)} | {card}",
              flush=True)

    # phase 9i: vec.1-shaped queries with other vectors under concurrency
    pool_q = vec_query_vectors(indexes, seed, VEC_POOL, 9)
    pool = [vec_sql(qv, 10, 100) for qv in pool_q]
    truth = [vec_expected(segs, indexes, qv, 10, 100) for qv in pool_q]

    def pool_check(i, r):
        want, band = truth[i]
        return None if vec_rows_agree(r, want, band, 100) else \
            f"{r[:3]} vs the host search {want[:3]}"
    leg = concurrency_leg(
        "9i", modes_of({"vec": segs, "vecx": xsegs}, pipelined=ex), pool,
        [list(range(len(pool)))] * CLIENTS, pool_check, card, tmp, kernels,
        "vector_topk")
    del ex, segs, indexes
    torch.cuda.empty_cache()
    return got, leg["launches"]


#: the MSE leaf's filters on phase 4's segments: a selective one (a day, a
#: discount and a quantity: ~6 docs a segment) and one that keeps ~1/11
#: of the docs, past TOPN_MAX_K
MSE_FILTER = ("lo_orderdate = 19940101 AND lo_discount = 5 AND "
              "lo_quantity = 10")
MSE_WIDE = "lo_discount = 5"


def mse_truth(cols: dict) -> dict:
    """The doc ids MSE_FILTER keeps in one segment, and MSE_WIDE's
    count."""
    sel = (cols["lo_orderdate"] == 19940101) & (cols["lo_discount"] == 5) \
        & (cols["lo_quantity"] == 10)
    return {"docs": np.nonzero(sel)[0].astype(np.int64),
            "wide": int((cols["lo_discount"] == 5).sum())}


def mse_leaf(ex, segs, truths, kernels, none: dict, card: str) -> int:
    """The MSE leaf's filtered doc ids (engine.filtered_doc_ids, K4 with
    k = TOPN_MAX_K) on phase 4's segments: MSE_FILTER's equal the numpy
    doc ids, MSE_WIDE (past TOPN_MAX_K in every segment) gives None. One
    K4 launch each. Returns K4's launches."""
    from pinot_tpu_torch.ops._cuda import TOPN_MAX_K
    from pinot_tpu_torch.query.context import QueryContext

    def expr(where):
        return QueryContext.from_sql(
            f"SELECT lo_discount FROM ssb WHERE {where}").filter
    zero_launches(kernels)
    t0 = time.perf_counter()
    got = ex.engine.filtered_doc_ids(segs, expr(MSE_FILTER))
    ms = (time.perf_counter() - t0) * 1e3
    wide = ex.engine.filtered_doc_ids(segs, expr(MSE_WIDE))
    launches_of_leg("MSE leaf", kernels, {**none, "topn": 2})
    for s, (g, t) in enumerate(zip(got, truths)):
        if g is None or not np.array_equal(g, t["mse"]["docs"]):
            fail(f"MSE leaf: segment {s}: {g} vs numpy {t['mse']['docs']}")
    if any(t["mse"]["wide"] <= TOPN_MAX_K for t in truths) \
            or any(w is not None for w in wide):
        fail(f"MSE leaf: {MSE_WIDE} past TOPN_MAX_K must give None")
    line = {"filter": MSE_FILTER, "docs": sum(len(g) for g in got),
            "ms": ms, "wide": MSE_WIDE, "wide_overflow": True}
    print(f"[mse] {json.dumps(line)} | {card}", flush=True)
    return 2


# ---------------------------------------------------------------------------
# phase 3c: K9 mesh_fold; phase 13: the mesh leg (with 9j)
# ---------------------------------------------------------------------------

#: phase 13's logical mesh: 4 segment slices x 2 doc slices, every slot on
#: cuda:0 (a card fills more than one slot)
MESH_SHAPE = (4, 2)
#: phase 13's sketch query on the Q1 rows: K1 and K3 on every shard
MESH_SKETCH = ("SELECT DISTINCTCOUNTHLL(lo_orderdate), "
               "PERCENTILETDIGEST95(lo_extendedprice), COUNT(*) FROM ssb "
               "WHERE lo_discount BETWEEN 1 AND 3")
#: 13c: row 14's step at S = 16, D = 2^23 over this many group ids
STEP_GROUPS = 64


def logical_mesh():
    from pinot_tpu_torch.parallel import make_mesh
    n_seg, n_doc = MESH_SHAPE
    return make_mesh(["cuda:0"] * (n_seg * n_doc), doc_axis=n_doc)


def fold_bytes(fold, parts, out) -> int:
    """K9's bytes: the partials read once (the rows its lists name), the
    lists and the output once."""
    B = parts[0].shape[0]
    size = parts[0].element_size()
    rows = len(fold.src) + (len(fold.tsrc) if fold.T else 0)
    return rows * B * fold.W * size + fold.nbytes \
        + out.numel() * out.element_size()


def check_fold(name: str, parts, fold, batched: bool) -> dict:
    """K9 against its plain version on the card, bit for bit (NaN where
    NaN): its times, bound and error."""
    import torch

    from pinot_tpu_torch.ops import _cuda
    from pinot_tpu_torch.ops import kernels as kmod
    out = _cuda.mesh_fold(parts, fold, batched=batched)
    ref = kmod.mesh_fold_plain(parts, fold)
    torch.cuda.synchronize()
    same = (out == ref) | (torch.isnan(out) & torch.isnan(ref))
    if out.shape != ref.shape or not bool(same.all()):
        fail(f"{name}: K9 differs from its plain version")
    moved = fold_bytes(fold, parts, out)
    return {"case": name, "B": parts[0].shape[0], "P": len(parts),
            "R": fold.R, "W": fold.W, "T": fold.T,
            "ms": cuda_ms(lambda: _cuda.mesh_fold(parts, fold,
                                                  batched=batched)),
            "plain_ms": cuda_ms(lambda: kmod.mesh_fold_plain(parts, fold),
                                iters=3),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved,
            "bound_by": "bytes", "library_ms": None,
            "library": "none: no single PyTorch call folds columns of "
                       "mixed op codes through a remap",
            "max_abs_err": max_abs_err(out, ref)}


def mesh_fold_cases(seed: int) -> dict:
    """Phase 3c's K9 cases at the mesh leg's shapes: the doc fold of K1's
    and K3's packed Q1 partials (count, sum, min, max, exact-sum planes,
    HLL 2^16 registers and 8192 histogram buckets; P = 2 doc slices, S_loc
    = 4) at B = 1 and 8, and the remapped fold, with its matched tail, of
    config-#3-shaped K2 partials (G_local = 35, 4 slots) over the 8 slots
    of a 4x2 mesh into 64 global groups."""
    import torch

    from pinot_tpu_torch.ops import collective
    from pinot_tpu_torch.ops import kernels as kmod
    from pinot_tpu_torch.ops.plan_ir import DevicePlan
    from pinot_tpu_torch.parallel import make_mesh
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 13)
    plan = DevicePlan(
        filter_ir=None, leaves=(), value_irs=(("col", "x"),),
        agg_ops=(("count", None, None), ("sum", 0, None), ("min", 0, None),
                 ("max", 0, None), ("isum:u4", 0, None),
                 ("hll:16:t", None, None), (f"hist:{HIST_BUCKETS}", 0, None)),
        raw64_cols=("t",))
    codes = kmod.packed_fold_codes(plan)
    W = kmod.packed_width(plan)

    def partials(B, rows, width, P):
        out = []
        for _ in range(P):
            t = torch.randint(0, 1000, (B, rows, width), generator=g,
                              device=dev).float()
            t[:, :, 2:4] = torch.randn((B, rows, 2), generator=g,
                                       device=dev) * 1e6
            t[:, 0, 2] = float("nan")
            t[:, 1, 3] = float("inf")
            out.append(t)
        return out
    cases = {}
    fold = kmod.doc_fold(1, 2, 4, 1, W, codes)
    for B in (1, BATCH_B):
        cases[f"doc fold B={B}"] = check_fold(
            f"doc fold of Q1 K1+K3 partials, B={B}", partials(B, 4, W, 2),
            fold, B > 1)
    gplan = DevicePlan(
        filter_ir=None, leaves=(), value_irs=(("col", "rev"),),
        agg_ops=(("sum", 0, None), ("min", 0, None), ("max", 0, None),
                 ("count", None, None)),
        group_cols=("year", "cat"), group_strides=(5, 1), num_groups=35)
    rng = np.random.default_rng(seed + 29)
    remap = np.stack([rng.permutation(64)[:35] for _ in range(GB_SEGMENTS)])
    remap[:, -3:] = -1  # local keys past a segment's cardinalities
    mesh = make_mesh(["cuda:0"] * 8, doc_axis=2)
    fold = collective.merged_plan(gplan, mesh, GB_SEGMENTS, 64, remap)
    cases["remap P=8"] = check_fold(
        "remapped fold of config-#3 K2 partials, P=8",
        partials(1, GB_SEGMENTS // 4 * 35, 4, 8), fold, False)
    return cases


def staged_mesh(ex, sql: str):
    """(plan, the Launch, the merge's minfo or None) that a mesh engine
    stages for an aggregation, as on the main path (the merge where its
    gates pass)."""
    from pinot_tpu_torch.query.context import QueryContext
    ctx = QueryContext.from_sql(sql)
    eng = ex.engine
    segs = ex.segments_of(ctx.table)
    with eng._engine_lock:
        plan, _ = eng._plan(segs, ctx)
        minfo = None
        if eng._explicit_mesh and eng._collective_merge:
            S = eng._padded_S(len(segs), eng._padded_D(segs))
            try:
                minfo = eng._merged_prepare(segs, plan, S)
            except Exception:  # noqa: BLE001 — a gate: the sharded launch
                minfo = None
        launch = eng._launch(segs, ctx, plan, None, None, "agg", minfo)
    return plan, launch, minfo


def column_ops(plan, merged: bool, S: int) -> list:
    """Each output column's op, in the sharded (per-segment) or merged
    layout: 'sum' columns compare within 1e-5, the others bit for bit."""
    from pinot_tpu_torch.ops import kernels as kmod
    ops = [] if merged else ["count"]
    for op, _v, _f in plan.agg_ops:
        ops += [op if op in ("sum", "sumsq", "sum3", "sum4") else "exact"] \
            * kmod.slot_width(op)
    return ops + (["exact"] * S if merged else [])


def compare_mesh(name: str, plan, out, ref, merged: bool, S: int) -> None:
    import torch
    if out.shape != ref.shape:
        fail(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    ops = column_ops(plan, merged, S)
    a, b = out.double().reshape(-1, len(ops)), ref.double().reshape(
        -1, len(ops))
    for c, op in enumerate(ops):
        x, y = a[:, c], b[:, c]
        same = (x == y) | (torch.isnan(x) & torch.isnan(y))
        if op == "exact" or op == "count":
            if not bool(same.all()):
                fail(f"{name}: column {c} not bit-identical")
        elif not bool((same | ((x - y).abs() <= 1e-5 * y.abs())).all()):
            fail(f"{name}: column {c} sum beyond rel 1e-5")


def mesh_launch_bytes(plan, launch, minfo, out) -> int:
    """The bytes a mesh launch must move: each slot's shard as its kernel
    must read it (batch_bytes, its partial written once), the partials
    read once by K9, the output once."""
    import torch

    from pinot_tpu_torch.ops import kernels as kmod
    mesh = next(iter(launch.cols.values())).mesh
    shards, s_loc, d_loc = kmod.mesh_shards(
        mesh, [launch.cols], [launch.params], [launch.num_docs], launch.D)
    part = torch.empty((s_loc, kmod.packed_width(plan)) if not plan.num_groups
                       else (s_loc, plan.num_groups, len(plan.agg_ops)),
                       dtype=out.dtype, device=out.device)
    moved = 0
    for cs, ps, ns in shards:
        moved += batch_bytes(plan, cs, ps, ns, [0], d_loc, part)[0] \
            + part.numel() * part.element_size()
    return moved + out.numel() * out.element_size()


def check_mesh_launch(name: str, ex, sql: str, B: int = 1,
                      pool=()) -> dict:
    """One mesh launch of the engine's own staging of `sql` (B > 1: B pool
    queries of its plan as one batched launch over the same blocks)
    against its plain version on the card: CUDA events around its whole
    launch sequence (a launch per slot, then K9)."""
    import torch

    from pinot_tpu_torch.ops import collective
    from pinot_tpu_torch.ops import kernels as kmod
    plan, launch, minfo = staged_mesh(ex, sql)
    mesh = next(iter(launch.cols.values())).mesh
    vdt = ex.engine.value_dtype
    S = int(launch.num_docs.shape[0])
    if B > 1:
        members = [launch] + [staged_mesh(ex, q)[1] for q in pool[:B - 1]]
        args = ([launch.cols], [m.params for m in members],
                [launch.num_docs], [0] * B, launch.D)

        def run():
            return launch.batched(*args)
        plain_fn = kmod.plain_batched_sharded_kernel(plan, mesh, vdt)

        def plain():
            return plain_fn(*args)
    else:
        run = launch.call
        if minfo is None:
            pf = kmod.plain_sharded_kernel(plan, mesh, vdt)
        else:
            mf = collective.plain_merged_kernel(plan, mesh, vdt)

            def pf(c, p, n, d):
                return mf(c, p, n, d, minfo["G"], minfo["fold"])

        def plain():
            return pf(launch.cols, launch.params, launch.num_docs, launch.D)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    compare_mesh(f"{name} vs plain", plan, out, ref, minfo is not None, S)
    if B > 1:
        for m, member in enumerate(members):
            compare_mesh(f"{name} member {m} vs its single launch", plan,
                         out[m], member.call(), False, S)
    moved = mesh_launch_bytes(plan, launch, minfo, out)
    if B > 1:
        moved += sum(v.numel() * v.element_size()
                     for m in members[1:] for v in m.params.values())
    return {"case": name, "mesh": "x".join(map(str, MESH_SHAPE)),
            "merged": minfo is not None, "B": B, "S": S, "D": launch.D,
            "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, iters=3),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved,
            "bound_by": "bytes", "library_ms": None,
            "library": "none: no single PyTorch call folds columns of "
                       "mixed op codes through a remap",
            "max_abs_err": max_abs_err(out, ref)}


def mesh_query(ex, name: str, sql: str, want, kernels, none: dict,
               shard_kernels: tuple, card: str, label: str) -> dict:
    """One phase-13 query: a cold run and ITERS warm runs through the
    mesh engine, its rows held to `want` (rows -> None or what differs),
    each run one launch of `shard_kernels` per slot and one K9 (the
    launch counts set to 0 just before and read just after); prints the
    p50, cold_s, kernel_fetch, launches, merges and peak memory."""
    import torch

    from pinot_tpu_torch.query.context import QueryContext
    reset = dict(ex.engine.meters)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    resp, cold, lats, split = time_query(ex, sql, ITERS)
    runs = 1 + ITERS
    slots = MESH_SHAPE[0] * MESH_SHAPE[1]
    got = launches_of_leg(
        f"phase 13 {label} {name}", kernels,
        {**none, **{k: slots * runs for k in shard_kernels},
         "mesh_fold": runs})
    why = want(rows_of(resp))
    if why is not None:
        fail(f"phase 13 {label} {name}: {why}")
    meters = {f"{k[0]}{'{' + k[1] + '}' if k[1] else ''}": v - reset.get(k, 0)
              for k, v in ex.engine.meters.items()
              if k[0].startswith("mesh_merge") and v - reset.get(k, 0)}
    table = QueryContext.from_sql(sql).table
    leg = {"query": name, "leg": label,
           "rows": sum(s.num_docs for s in ex.segments_of(table)),
           "p50_ms": statistics.median(lats) * 1e3, "cold_s": cold,
           "kernel_fetch_ms": split.get("kernel_fetch"),
           "launches": {k: v for k, v in got.items() if v},
           "meters": meters,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(f"[mesh] {json.dumps(leg)} | {card}", flush=True)
    return {"launches": got, "meters": meters}


def q1_want(truths, name: str, n_segs=None):
    """rows -> None or what differs: Q1 query `name`'s (SUM, COUNT) equal
    to the numpy truth of the first n_segs segments."""
    ts = truths[:n_segs] if n_segs else truths
    return lambda rows: exact_pair(rows, sum(t["q1"][name][0] for t in ts),
                                   sum(t["q1"][name][1] for t in ts))


def sketch_want(ref_rows, merged: bool):
    """rows -> None or what differs: DISTINCTCOUNTHLL and COUNT equal to
    the single card's; the p95 equal to it where each segment keeps its
    digest (the sharded launch), within rel 0.02 (PERF.md's t-digest row)
    where the merge builds one digest from the batch's buckets."""
    def check(rows):
        (h, p, c), (rh, rp, rc) = rows[0], ref_rows[0]
        if int(h) != int(rh) or int(c) != int(rc):
            return f"{rows[0]} vs the single card's {ref_rows[0]}"
        if (abs(float(p) - float(rp)) > 0.02 * abs(float(rp))) if merged \
                else float(p) != float(rp):
            return f"p95 {p} vs the single card's {rp}"
        return None
    return check


def mesh_leg(segs, truths, sketch_ref, kernels, none: dict, card: str,
             tmp: str):
    """Phase 13 and 9j on the Q1 leg's 16 x 8M rows (see the module
    docstring). Returns (per-kernel launches of the leg, the kernels-line
    entries of rows 7, 8c, 9 and 14, the 9j window launches)."""
    import torch

    from pinot_tpu_torch.ops import _cuda
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.utils.config import PinotConfiguration
    mesh = logical_mesh()
    n_cards = torch.cuda.device_count()
    print(f"[mesh] {MESH_SHAPE[0]}x{MESH_SHAPE[1]} logical mesh over "
          f"cuda:0; {n_cards} CUDA device(s) | {card}", flush=True)
    total: Counter = Counter()
    k9 = {"sharded": 0, "merged": 0, "step": 0}

    def add(res, form):
        total.update(res["launches"])
        k9[form] += res["launches"]["mesh_fold"]

    # 13a: the sharded launch, float32, the merge key off
    off = PinotConfiguration({"pinot.server.mesh.collective.merge": False})
    ex_a = QueryExecutor(segs, mesh=mesh, config=off)
    for name, sql in Q1_QUERIES.items():
        add(mesh_query(ex_a, name, sql, q1_want(truths, name), kernels,
                       none, ("scan_agg",), card, "13a sharded f32"),
            "sharded")
    add(mesh_query(ex_a, "sketch", MESH_SKETCH,
                   sketch_want(sketch_ref, merged=False), kernels, none,
                   ("scan_agg", "sketch_agg"), card, "13a sharded f32"),
        "sharded")
    if ex_a.engine.meter("mesh_merge_fallback", "disabled") == 0:
        fail("phase 13a: the merge-off engine counted no 'disabled'")
    sharded = check_mesh_launch("row 7: q1.1 sharded", ex_a,
                                Q1_QUERIES["q1.1"])
    print(f"[kernel] mesh sharded {json.dumps(sharded)} | {card}",
          flush=True)
    batched = check_mesh_launch(
        "row 8c: q1.1-shaped, B=8 broadcast", ex_a, q1_sql(*Q1_POOL[0]),
        B=BATCH_B, pool=[q1_sql(*w) for w in Q1_POOL[1:]])
    print(f"[kernel] mesh sharded batched {json.dumps(batched)} | {card}",
          flush=True)
    if n_cards > 1:
        n_doc = 2 if n_cards % 2 == 0 else 1
        ex_n = QueryExecutor(segs, mesh=make_mesh(doc_axis=n_doc))
        why = q1_want(truths, "q1.1")(rows_of(ex_n.execute(
            Q1_QUERIES["q1.1"])))
        if why is not None:
            fail(f"phase 13 over {n_cards} cards: {why}")
        print(f"[mesh] q1.1 over {n_cards} cards equals its truth | {card}",
              flush=True)
        del ex_n

    # 13b: the merge, float64 on all rows; float32 on two segments; the
    # float32 full batch held back by the precision gate
    ex_b = QueryExecutor(segs, value_dtype=torch.float64, mesh=mesh)
    for name, sql in Q1_QUERIES.items():
        add(mesh_query(ex_b, name, sql, q1_want(truths, name), kernels,
                       none, ("scan_agg",), card, "13b merged f64"),
            "merged")
    add(mesh_query(ex_b, "sketch", MESH_SKETCH, sketch_want(sketch_ref, merged=True), kernels, none,
                   ("scan_agg", "sketch_agg"), card, "13b merged f64"),
        "merged")
    if ex_b.engine.meter("mesh_merge_served") == 0:
        fail("phase 13b: the float64 engine never merged")
    merged = check_mesh_launch("row 9: q1.1 merged, float64", ex_b,
                               Q1_QUERIES["q1.1"])
    print(f"[kernel] mesh merged {json.dumps(merged)} | {card}", flush=True)
    del ex_b
    torch.cuda.empty_cache()
    ex_c = QueryExecutor({"ssb": segs, "ssb2": segs[:2]}, mesh=mesh)
    for name, sql in Q1_QUERIES.items():
        add(mesh_query(ex_c, name, sql.replace(" FROM ssb ", " FROM ssb2 "),
                       q1_want(truths, name, 2), kernels, none,
                       ("scan_agg",), card, "13b merged f32, 2 segments"),
            "merged")
    served = ex_c.engine.meter("mesh_merge_served")
    if served == 0:
        fail("phase 13b: the float32 engine never merged two segments")
    add(mesh_query(ex_c, "q1.1", Q1_QUERIES["q1.1"], q1_want(truths, "q1.1"),
                   kernels, none, ("scan_agg",), card,
                   "13b f32 full batch"), "sharded")
    if ex_c.engine.meter("mesh_merge_fallback", "precision") == 0:
        fail("phase 13b: the float32 full batch passed the precision gate")
    del ex_c
    torch.cuda.empty_cache()

    # 13c: row 14's step
    step, step_launches = step_case(mesh, kernels, none, card)
    total.update(step_launches)
    k9["step"] = step_launches["mesh_fold"]
    step["launches"] = k9["step"]

    # 9j: Q1.1-shaped queries under concurrency on the mesh engine
    execs = modes_of(segs, pipelined=ex_a, mesh=mesh, config={
        "pinot.server.mesh.collective.merge": False})
    leg = concurrency_leg(
        "9j", execs, [q1_sql(*w) for w in Q1_POOL],
        [list(range(len(Q1_POOL)))] * CLIENTS,
        lambda i, rows: exact_pair(
            rows, sum(t["q1pool"][i][0] for t in truths),
            sum(t["q1pool"][i][1] for t in truths)), card, tmp, kernels,
        {"scan_agg": MESH_SHAPE[0] * MESH_SHAPE[1], "mesh_fold": 1})
    del execs, ex_a
    torch.cuda.empty_cache()
    sharded["launches"] = k9["sharded"]
    merged["launches"] = k9["merged"]
    batched["launches"] = leg["launches"]["mesh_fold"][1]
    if not batched["launches"]:
        fail("phase 9j never launched K9's batched form")
    for form, n in k9.items():
        if not n:
            fail(f"phase 13 never launched K9 on the {form} path")
    if _cuda.MESH_FOLD.name not in total:
        fail("phase 13 never launched mesh_fold")
    return dict(total), {"sharded": sharded, "batched": batched,
                         "merged": merged, "step": step}, leg["launches"]


def step_case(mesh, kernels, none: dict, card: str):
    """13c: row 14's step at S = 16, D = 2^23 on the logical mesh, over
    float64 integer-valued measures (exact sums and counts): its answer
    against its plain version and the numpy truth, ITERS + 1 host-clock
    runs (the launch counts set to 0 just before), CUDA-event times of the
    step and its plain version, and the bound (the inputs as the step must
    read them, the partials once)."""
    import torch

    from pinot_tpu_torch.ops import kernels as kmod
    from pinot_tpu_torch.parallel import distributed_query_step, shard_block
    from pinot_tpu_torch.parallel.distributed_query import (
        groups_plan, plain_distributed_query_step)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(131)
    S, D, G = Q1_SEGMENTS, 1 << 23, STEP_GROUPS

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)
    ids = ints(0, 100, (S, D), torch.int32)
    vals = ints(0, 1000, (S, D), torch.float64)
    gids = ints(0, G, (S, D), torch.int32)
    lo = ints(0, 30, (S,), torch.int32)
    hi = lo + ints(10, 60, (S,), torch.int32)
    ndocs = torch.full((S,), Q1_DOCS, dtype=torch.int32, device=dev)
    doc_pos = torch.arange(D, dtype=torch.int32, device=dev)[None]
    # numpy truth, on the host
    h_ids, h_vals, h_gids = ids.cpu().numpy(), vals.cpu().numpy(), \
        gids.cpu().numpy()
    mask = (h_ids >= lo.cpu().numpy()[:, None]) \
        & (h_ids <= hi.cpu().numpy()[:, None])
    mask[:, Q1_DOCS:] = False
    kept = h_vals[mask]
    want = (float(kept.sum()), float(mask.sum()),
            np.bincount(h_gids[mask], weights=kept, minlength=G))
    del h_ids, h_vals, h_gids, mask, kept
    gplan = groups_plan(G)
    cols = {"ids:ids": ids, "val:vals": vals, "ids:gids": gids}
    params = {"leaf0:lo": lo, "leaf0:hi": hi}
    inputs_bytes = batch_bytes(gplan, [cols], [params], [ndocs], [0], D,
                               torch.empty(G, dtype=torch.float64,
                                           device=dev))[0]
    blocks = [shard_block(mesh, t) for t in (ids, vals, gids)]
    del ids, vals, gids, cols
    torch.cuda.empty_cache()
    args = (*blocks, lo, hi, ndocs, doc_pos)
    step = distributed_query_step(mesh)(G)
    plain = plain_distributed_query_step(mesh)(G)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    lats = []
    for _ in range(1 + ITERS):
        t0 = time.perf_counter()
        got = [float(x) if x.dim() == 0 else x.cpu().numpy()
               for x in step(*args)]
        lats.append(time.perf_counter() - t0)
    slots = MESH_SHAPE[0] * MESH_SHAPE[1]
    launches = launches_of_leg(
        "phase 13c", kernels,
        {**none, "scan_agg": slots * len(lats),
         "group_agg": slots * len(lats), "mesh_fold": 2 * len(lats)})
    if got[0] != want[0] or got[1] != want[1] \
            or not np.array_equal(got[2], want[2]):
        fail(f"phase 13c: step ({got[0]}, {got[1]}) vs numpy truth "
             f"({want[0]}, {want[1]}), groups equal: "
             f"{np.array_equal(got[2], want[2])}")
    ref = [x.cpu() for x in plain(*args)]
    out = [x.cpu() for x in step(*args)]
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        fail("phase 13c: the step differs from its plain version")
    s_loc, d_loc = S // MESH_SHAPE[0], D // MESH_SHAPE[1]
    partial_bytes = slots * s_loc * (3 + G) * 8
    moved = inputs_bytes + 2 * partial_bytes
    entry = {"case": f"row 14: S={S}, D=2^23, G={G}",
             "mesh": "x".join(map(str, MESH_SHAPE)),
             "p50_ms": statistics.median(lats[1:]) * 1e3,
             "cold_s": lats[0],
             "ms": cuda_ms(lambda: step(*args)),
             "plain_ms": cuda_ms(lambda: plain(*args), iters=3),
             "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved,
             "bound_by": "bytes", "library_ms": None,
             "library": "none: no single PyTorch call folds columns of "
                        "mixed op codes through a remap",
             "max_abs_err": max(float((a.double() - b.double()).abs().max())
                                for a, b in zip(out, ref)),
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(f"[kernel] mesh step {json.dumps(entry)} | {card}", flush=True)
    del blocks, args
    torch.cuda.empty_cache()
    return entry, launches


def mesh_groupby(segs, want_rows, kernels, none: dict, card: str) -> dict:
    """13a's config-#3 group-by on phase 5's rows: the sharded K2 (merge
    key off) on the logical mesh, its group keys equal to the single
    card's and its sums within rel 1e-6 of them (float32 sums of a group
    past 2^24 round per doc slice). Returns the launches."""
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.utils.config import PinotConfiguration
    ex = QueryExecutor(segs, mesh=logical_mesh(), config=PinotConfiguration(
        {"pinot.server.mesh.collective.merge": False}))

    def same(rows):
        if [tuple(r[:2]) for r in rows] != [tuple(r[:2]) for r in want_rows]:
            return f"group keys {rows[:3]} vs the single card's " \
                f"{want_rows[:3]}"
        for r, w in zip(rows, want_rows):
            if abs(float(r[2]) - float(w[2])) > 1e-6 * abs(float(w[2])):
                return f"group {r} vs the single card's {w}"
        return None
    res = mesh_query(ex, "groupby", GB_QUERY, same, kernels, none,
                     ("group_agg",), card, "13a sharded f32, config #3")
    return res["launches"]


# ---------------------------------------------------------------------------
# phase 14: compact group keys on ClickBench's hits (K2 at compact G)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def cb_pools() -> dict:
    """The hits generator's pools, from CB_POOL_SEED: user ids (distinct
    positive longs) with each user's home region and phrases, the phrase
    strings ('' first, then strings that sort in index order), and the
    zipf draw (users by rank, cumulative weights)."""
    rng = np.random.default_rng(CB_POOL_SEED)
    ids = np.unique(rng.integers(1, 1 << 62, 2 * CB_USERS))
    ids = rng.permutation(ids)[:CB_USERS]
    words = ("weather", "news", "maps", "video", "music", "games", "shop",
             "recipes", "cars", "flights")
    phrases = np.array([""] + [f"q{k:05d} {words[k % len(words)]}"
                               for k in range(1, CB_PHRASES)], dtype=object)
    w = np.arange(1, CB_USERS + 1, dtype=np.float64) ** -CB_ZIPF
    return {"ids": ids, "ids_sorted": np.sort(ids),
            "home": rng.integers(0, CB_REGIONS, CB_USERS),
            "phrase_of": rng.integers(1, CB_PHRASES,
                                      (CB_USERS, CB_USER_PHRASES)),
            "phrases": phrases, "rank_user": rng.permutation(CB_USERS),
            "cdf": np.cumsum(w) / w.sum()}


def hits_columns(rng, n: int) -> dict:
    """One segment of hits: UserID (LONG) zipf-drawn, SearchPhrase
    (STRING) one of the user's phrases in CB_PHRASE_SHARE of the rows,
    RegionID (INT) the user's home region but for CB_AWAY of the rows,
    ResolutionWidth (INT, raw) one of CB_WIDTHS."""
    P = cb_pools()
    user = P["rank_user"][np.minimum(
        np.searchsorted(P["cdf"], rng.random(n), side="right"),
        CB_USERS - 1)]
    pick = rng.integers(0, CB_USER_PHRASES, n)
    phrase = np.where(rng.random(n) < CB_PHRASE_SHARE,
                      P["phrase_of"][user, pick], 0)
    region = np.where(rng.random(n) < CB_AWAY,
                      rng.integers(0, CB_REGIONS, n), P["home"][user])
    width = np.asarray(CB_WIDTHS, np.int32)[
        rng.integers(0, len(CB_WIDTHS), n)]
    return {"UserID": P["ids"][user], "SearchPhrase": P["phrases"][phrase],
            "RegionID": region.astype(np.int32), "ResolutionWidth": width}


def _cb_keys(cols: dict):
    """(user rank in the sorted ids, phrase index) of each row."""
    P = cb_pools()
    uid = np.searchsorted(P["ids_sorted"], cols["UserID"])
    pid = np.searchsorted(P["phrases"], cols["SearchPhrase"])
    return uid.astype(np.int64), pid.astype(np.int64)


def hits_truth(cols: dict) -> dict:
    """One segment's truth, folded by key: (UserID, SearchPhrase) counts
    ('up', key uid * CB_PHRASES + phrase) and (RegionID, UserID) counts,
    width sums, minima and maxima ('ru', key region * CB_USERS + uid)."""
    uid, pid = _cb_keys(cols)
    up, up_n = np.unique(uid * CB_PHRASES + pid, return_counts=True)
    key = cols["RegionID"].astype(np.int64) * CB_USERS + uid
    order = np.argsort(key, kind="stable")
    k, w = key[order], cols["ResolutionWidth"][order].astype(np.int64)
    ru, start, ru_n = np.unique(k, return_index=True, return_counts=True)
    return {"up": (up, up_n),
            "ru": (ru, ru_n, np.add.reduceat(w, start),
                   np.minimum.reduceat(w, start),
                   np.maximum.reduceat(w, start))}


def cb_merged(truths: list) -> dict:
    """The whole table's truth from the segments': 'up' (keys, counts)
    and 'ru' (keys, counts, sums, minima, maxima)."""
    k = np.concatenate([t["up"][0] for t in truths])
    up, inv = np.unique(k, return_inverse=True)
    up_n = np.bincount(inv, np.concatenate([t["up"][1] for t in truths]))
    k = np.concatenate([t["ru"][0] for t in truths])
    ru, inv = np.unique(k, return_inverse=True)
    parts = [np.concatenate([t["ru"][j] for t in truths]) for j in (1, 2)]
    mins = np.full(len(ru), np.iinfo(np.int64).max)
    maxs = np.full(len(ru), np.iinfo(np.int64).min)
    np.minimum.at(mins, inv, np.concatenate([t["ru"][3] for t in truths]))
    np.maximum.at(maxs, inv, np.concatenate([t["ru"][4] for t in truths]))
    return {"up": (up, up_n.astype(np.int64)),
            "ru": (ru, np.bincount(inv, parts[0]).astype(np.int64),
                   np.bincount(inv, parts[1]).astype(np.int64), mins, maxs)}


def cb_row_keys(name: str, rows) -> np.ndarray:
    """Each cb row's truth key, from its decoded values (-1 for a value
    the generator never made)."""
    P = cb_pools()
    if not rows:
        return np.zeros(0, np.int64)
    cols = list(zip(*rows))
    ucol = 1 if name == "cb.3" else 0
    users = np.array(cols[ucol], np.int64)
    uid = np.minimum(np.searchsorted(P["ids_sorted"], users), CB_USERS - 1)
    ok = P["ids_sorted"][uid] == users
    if name == "cb.3":
        keys = np.array(cols[0], np.int64) * CB_USERS + uid
    else:
        text = np.array(cols[1], object)
        pid = np.minimum(np.searchsorted(P["phrases"], text),
                         CB_PHRASES - 1)
        ok &= P["phrases"][pid] == text
        keys = uid * CB_PHRASES + pid
    return np.where(ok, keys, -1)


def cb_check(name: str, rows, truth: dict):
    """None, or what differs from the numpy truth: a top-10 by COUNT(*)
    holds every key counted above the 10th count and only keys tied at
    it, in count order, each count (and cb.3's sum, min and max) exact;
    cb.4 the distinct pairs (all of them when they number at most its
    LIMIT), each once."""
    if name == "cb.4":
        keys = cb_row_keys(name, rows).tolist()
        want = truth["up"][0]
        if len(set(keys)) != len(keys) or min(keys, default=0) < 0:
            return "a DISTINCT pair repeats or is not a generated pair"
        if len(keys) != min(len(want), 100_000) \
                or not set(keys) <= set(want.tolist()):
            return f"{len(keys)} pairs vs {len(want)} distinct in the truth"
        return None
    keys_all, counts = truth["ru" if name == "cb.3" else "up"][:2]
    sel = np.ones(len(keys_all), bool)
    if name == "cb.2":
        sel = keys_all % CB_PHRASES != 0
    keys_all, counts = keys_all[sel], counts[sel]
    c10 = np.sort(counts)[::-1][9]
    above = set(keys_all[counts > c10].tolist())
    tied = set(keys_all[counts == c10].tolist())
    got = cb_row_keys(name, rows).tolist()
    if len(rows) != 10 or not above <= set(got) \
            or not set(got) <= above | tied:
        return f"top keys {got} vs {len(above)} above and {len(tied)} tied"
    pos = {k: i for i, k in enumerate(keys_all.tolist())}
    prev = None
    for r, k in zip(rows, got):
        i = pos[k]
        n = int(r[-1])
        if n != int(counts[i]) or (prev is not None and n > prev):
            return f"row {r}: count {n} vs the truth's {int(counts[i])}"
        prev = n
        if name == "cb.3":
            j = int(np.searchsorted(truth["ru"][0], k))
            want = tuple(int(truth["ru"][c][j]) for c in (2, 3, 4))
            if (float(r[2]), float(r[3]), float(r[4])) != tuple(
                    map(float, want)):
                return f"row {r}: (sum, min, max) vs the truth's {want}"
    return None


def cb_same(name: str, rows, ref) -> bool:
    """Two answers to one cb query equal up to the order and choice of
    the keys tied at the 10th count."""
    if name == "cb.4":
        return sorted(map(tuple, rows)) == sorted(map(tuple, ref))
    c10 = int(ref[-1][-1])
    strip = [[tuple(r) for r in x if int(r[-1]) > c10] for x in (rows, ref)]
    return strip[0] == strip[1] and [int(r[-1]) for r in rows] == \
        [int(r[-1]) for r in ref]


def cb_groups(ex, sql: str):
    """(G, key tuples per segment) of a cb query's compact plan."""
    from pinot_tpu_torch.ops.engine import _distinct_context
    from pinot_tpu_torch.query.context import QueryContext
    eng = ex.engine
    ctx = QueryContext.from_sql(sql)
    if ctx.distinct:
        ctx = _distinct_context(ctx)
    segs = ex.segments_of(ctx.table)
    with eng._engine_lock:
        plan, _ = eng._plan(segs, ctx)
        if not plan.group_compact:
            fail(f"phase 14: {sql!r} did not plan compact keys")
        D = eng._padded_D(segs)
        G = eng._compact_groups(segs, plan, eng._padded_S(len(segs), D))
        held = [int(eng._gkey_table(seg, plan).shape[0])
                for seg in segs]
    return G, held


def queue_depth(disp) -> int:
    """The ring's pending launches: its `dispatch_queue_depth` gauge."""
    return int(disp._metrics.gauge("dispatch_queue_depth",
                                   labels=disp._labels) or 0)


def cb_burst(ex, sqls: list):
    """sqls run concurrently, the ring held until all are queued (a bound
    hold of the dispatch site, which ends once the holds' firings plus the
    ring's depth reach their number), with one more active caller so none
    takes the inline path: one batch of them all at equal G. Returns the
    rows of each."""
    from concurrent.futures import ThreadPoolExecutor

    from pinot_tpu_torch.utils.failpoints import failpoints
    disp = ex.engine.dispatcher
    seen = []

    def queued() -> bool:
        if not seen and fp.fired + queue_depth(disp) >= len(sqls):
            seen.append(True)
        return bool(seen)
    fp = failpoints.arm("server.dispatch.before", delay=30.0, times=2,
                        until=queued)
    try:
        with disp.active(), ThreadPoolExecutor(len(sqls)) as pool:
            return [rows_of(f.result(timeout=300)) for f in
                    [pool.submit(ex.execute, q) for q in sqls]]
    finally:
        failpoints.disarm("server.dispatch.before")


def hits_jobs(tmp: str, seed: int) -> list:
    """build_one_segment's jobs for phase 14's segments."""
    fields = [("UserID", "LONG", False), ("SearchPhrase", "STRING", False),
              ("RegionID", "INT", False), ("ResolutionWidth", "INT", True)]
    return [(tmp, "hits", fields, ["ResolutionWidth"], CB_DOCS,
             hits_columns, hits_truth, seed, i, None)
            for i in range(CB_SEGMENTS)]


def cb_leg(segs, truths, kernels, none: dict, card: str):
    """Phase 14 (see the module docstring). Returns (its launches per
    kernel, the burst's batched K2 launches); every K2 single launch of
    the phase is a compact-key one."""
    import torch

    from pinot_tpu_torch.ops import _cuda
    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.utils.config import PinotConfiguration
    t0 = time.perf_counter()
    truth = cb_merged(truths)
    rows_n = sum(s.num_docs for s in segs)
    print(f"[cb] {len(segs)} segments, {rows_n} rows; truth folded in "
          f"{time.perf_counter() - t0:.1f} s: {len(truth['up'][0])} "
          f"(UserID, SearchPhrase) pairs, {len(truth['ru'][0])} "
          f"(RegionID, UserID) pairs | {card}", flush=True)
    ex = QueryExecutor(segs)
    total: Counter = Counter()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    answers = {}
    for name, sql in CB_QUERIES.items():
        resp, cold, lats, split = time_query(ex, sql, CB_ITERS)
        rows = rows_of(resp)
        why = cb_check(name, rows, truth)
        if why is not None:
            fail(f"phase 14 {name}: {why}")
        answers[name] = rows
        G, held = cb_groups(ex, sql)
        if G != CB_G:
            fail(f"phase 14 {name}: G = {G}, not phase 3's compact case's "
                 f"{CB_G}")
        leg = {"query": name, "rows": rows_n, "G": G,
               "tuples_per_segment": held,
               "p50_ms": statistics.median(lats) * 1e3, "cold_s": cold,
               "rows_per_s": rows_n / statistics.median(lats),
               "stage_ms": split,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        print(f"[cb] {json.dumps(leg)} | {card}", flush=True)
    runs = len(CB_QUERIES) * (1 + CB_ITERS)
    launches_of_leg("phase 14", kernels, {**none, "group_agg": runs})

    # the burst: one batch of cb.1-shaped queries over eight regions, each
    # equal to its own single run
    P = cb_pools()
    regions = [int(P["home"][P["rank_user"][r]]) for r in range(CB_BURST)]
    sqls = [CB_BURST_SQL.format(r) for r in regions]
    if {cb_groups(ex, q)[0] for q in sqls} != {CB_G}:
        fail(f"phase 14 burst: G is not phase 3b's compact case's {CB_G}")
    alone = [rows_of(ex.execute(q)) for q in sqls]
    before = (_cuda.GROUP_AGG.batched_launches,
              _cuda.GROUP_AGG.batched_members)
    held_rows = cb_burst(ex, sqls)
    batched = _cuda.GROUP_AGG.batched_launches - before[0]
    members = _cuda.GROUP_AGG.batched_members - before[1]
    if held_rows != alone or batched != 1 or members != CB_BURST:
        fail(f"phase 14 burst: {batched} batched launches of {members} "
             f"members; rows equal alone: {held_rows == alone}")
    print(f"[cb] burst: {CB_BURST} cb.1-shaped queries in {batched} "
          f"batched K2 launch of {members} members, each equal to its "
          f"single run | {card}", flush=True)
    # the one-card runs' launches: the timed queries', the burst's alone
    total.update({k.name: k.launches for k in kernels})
    del ex
    torch.cuda.empty_cache()

    # cb.1 and cb.3 once more on the logical 4x2 mesh: sharded float32
    # (the merge key off) and merged float64
    off = PinotConfiguration({"pinot.server.mesh.collective.merge": False})
    for label, kw, kern in (
            ("sharded f32", {"config": off}, "mesh_merge_fallback"),
            ("merged f64", {"value_dtype": torch.float64},
             "mesh_merge_served")):
        mx = QueryExecutor(segs, mesh=logical_mesh(), **kw)
        torch.cuda.reset_peak_memory_stats()
        zero_launches(kernels)
        for name in ("cb.1", "cb.3"):
            t0 = time.perf_counter()
            rows = rows_of(mx.execute(CB_QUERIES[name]))
            leg = {"query": name, "leg": label,
                   "cold_s": time.perf_counter() - t0,
                   "stage_ms": mx.last_stage_ms}
            why = cb_check(name, rows, truth)
            if why is None and not cb_same(name, rows, answers[name]):
                why = "differs from one card's answer"
            if why is not None:
                fail(f"phase 14 {label} {name}: {why}")
            leg["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            print(f"[cb] {json.dumps(leg)} | {card}", flush=True)
        slots = MESH_SHAPE[0] * MESH_SHAPE[1]
        got = launches_of_leg(f"phase 14 {label}", kernels,
                              {**none, "group_agg": 2 * slots,
                               "mesh_fold": 2})
        total.update(got)
        meter = mx.engine.meter(kern, "disabled" if kern.endswith(
            "fallback") else None)
        if meter != 2:
            fail(f"phase 14 {label}: {kern} counted {meter}, not 2")
        del mx
        torch.cuda.empty_cache()
    return dict(total), batched


# ---------------------------------------------------------------------------
# phase 9: the concurrency leg
# ---------------------------------------------------------------------------

def rows_of(resp) -> list:
    return [tuple(r) for r in resp.rows]


def run_window(ex, pool, client_pools, alone, seconds, seed, tmp=None):
    """len(client_pools) closed-loop clients through `ex` for `seconds`:
    client c draws indexes of `pool` from client_pools[c] with a seeded
    generator, and every answer must equal alone[i], the same query run
    alone. With `tmp`, the window runs under torch.profiler and reports
    the card's busy share. Returns the window's numbers."""
    import torch

    from pinot_tpu_torch.ops import kernels
    disp = ex.engine.dispatcher
    stats0, codegen0 = disp.stats(), kernels.trace_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lats = [[] for _ in client_pools]
    errors = []
    gate = threading.Barrier(len(client_pools) + 1)
    end = [0.0]

    def client(c):
        rng = np.random.default_rng([seed, c])
        gate.wait()
        while time.perf_counter() < end[0] and not errors:
            i = int(rng.choice(client_pools[c]))
            t0 = time.perf_counter()
            try:
                got = rows_of(ex.execute(pool[i]))
            except Exception as e:  # noqa: BLE001 — fails the run below
                errors.append(f"{pool[i]}: {e!r}")
                return
            lats[c].append(time.perf_counter() - t0)
            if got != alone[i]:
                errors.append(f"{pool[i]}: {got[:3]} vs the query alone "
                              f"{alone[i][:3]}")
                return

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(client_pools))]
    for t in threads:
        t.start()
    prof = None
    if tmp is not None:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    end[0] = t0 + seconds
    gate.wait()
    for t in threads:
        t.join(timeout=seconds + 300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    if any(t.is_alive() for t in threads):
        fail("a phase 9 client did not finish")
    if errors:
        fail(f"phase 9: {errors[0]}")
    stats = disp.stats()
    stats.subtract(stats0)
    sizes = [k[1] for k, v in stats.items() if isinstance(k, tuple) and v]
    flat = sorted(x for c in lats for x in c)
    out = {"queries": len(flat), "wall_s": wall, "qps": len(flat) / wall,
           "p50_ms": float(np.percentile(flat, 50)) * 1e3 if flat else None,
           "p99_ms": float(np.percentile(flat, 99)) * 1e3 if flat else None,
           "max_batch": max(sizes, default=0),
           "launches": {v: stats[v] for v in ("inline", "single",
                                              "broadcast", "stacked",
                                              "dedup")},
           "codegen": kernels.trace_count() - codegen0,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "latencies": flat}
    if prof is not None:
        busy, _by = trace_busy_us(prof, tmp)
        out["busy_share"] = None if busy is None else busy / 1e6 / wall
    return out


def concurrency_leg(name: str, executors: dict, pool: list,
                    client_pools: list, check, card: str, tmp: str,
                    kernels, runs: str, probes=()) -> dict:
    """Phase 9's sub-leg `name`: every pool query alone through each
    executor ({mode: QueryExecutor}) against its numpy truth (check(i,
    rows) -> None or what differs), the held probe rounds (each a list of
    pool indexes that must form one batch), then WINDOW_S windows
    alternating serialized and pipelined twice and one traced TRACE_S
    window per mode, with the launch counts of `kernels` set to 0 just
    before the windows and held just after them against the dispatchers'
    own counts (`runs`: the kernel the pool's queries launch, or a tuple
    of kernels, each launched once per dispatch). Prints
    each mode's numbers; returns them, with the windows' launches."""
    from pinot_tpu_torch.utils.failpoints import failpoints
    alone = {}
    seen0 = executors["pipelined"].engine.dispatcher.stats()
    for mode, ex in executors.items():
        for i, sql in enumerate(pool):
            rows = rows_of(ex.execute(sql))
            why = check(i, rows)
            if why is not None:
                fail(f"{name} {mode}: {sql}: {why}")
            if alone.setdefault(i, rows) != rows:
                fail(f"{name}: {sql} alone differs between the modes")
    pipe = executors["pipelined"]
    for members in probes:
        # an extra active caller keeps every member off the inline path;
        # the held first pop lets them all enqueue: one batch
        with pipe.engine.dispatcher.active(), \
                failpoints.armed("server.dispatch.before", delay=0.5,
                                 times=1):
            got = {}
            threads = [threading.Thread(
                target=lambda i=i: got.__setitem__(
                    i, rows_of(pipe.execute(pool[i]))), daemon=True)
                for i in members]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        if any(got.get(i) != alone[i] for i in members):
            fail(f"{name}: a held round's answer differs from alone")
    disps = [ex.engine.dispatcher for ex in executors.values()]
    stats0 = [d.stats() for d in disps]
    zero_launches(kernels)
    windows = {"serialized": [], "pipelined": []}
    for rep in range(2):
        for mode in windows:
            w = run_window(executors[mode], pool, client_pools, alone,
                           WINDOW_S, seed=[rep, len(windows[mode])])
            if w["codegen"]:
                fail(f"{name} {mode}: a steady-state window compiled "
                     f"{w['codegen']} programs")
            if w["max_memory_allocated"] > PEAK_LIMIT:
                fail(f"{name} {mode}: peak device memory "
                     f"{w['max_memory_allocated']} above {PEAK_LIMIT}")
            windows[mode].append(w)
    out = {}
    for mode, ws in windows.items():
        traced = run_window(executors[mode], pool, client_pools, alone,
                            TRACE_S, seed=[9, 9], tmp=tmp)
        lats = sorted(x for w in ws for x in w["latencies"])
        launches = {v: sum(w["launches"][v] for w in ws)
                    for v in ws[0]["launches"]}
        out[mode] = {
            "sub_leg": name, "mode": mode, "clients": len(client_pools),
            "window_s": WINDOW_S, "qps": [w["qps"] for w in ws],
            "queries": sum(w["queries"] for w in ws),
            "p50_ms": float(np.percentile(lats, 50)) * 1e3,
            "p99_ms": float(np.percentile(lats, 99)) * 1e3,
            "max_batch": max(w["max_batch"] for w in ws),
            "launches": launches,
            "busy_share": traced.get("busy_share"),
            "traced_qps": traced["qps"],
            "max_memory_allocated": max(w["max_memory_allocated"]
                                        for w in ws)}
        print(f"[concurrency] {json.dumps(out[mode])} | {card}", flush=True)
    out["launches"] = window_launches(name, kernels, runs, disps, stats0)
    if out["pipelined"]["max_batch"] < 2:
        fail(f"{name}: the pipelined windows never formed a batch of 2")
    seen = pipe.engine.dispatcher.stats()
    seen.subtract(seen0)
    out["seen"] = {v: seen[v] for v in ("broadcast", "stacked", "dedup")}
    return out


def modes_of(segments, pipelined=None, value_dtype=None, mesh=None,
             config=None) -> dict:
    """A QueryExecutor per dispatch mode over the same segments (one
    table's, or {table: segments}); `pipelined`: an executor of the
    default (pipelined) configuration to reuse; value_dtype: the
    executors' (float32 by default); mesh and config (overrides): the
    executors' mesh and further keys."""
    import torch

    from pinot_tpu_torch.query.executor import QueryExecutor
    from pinot_tpu_torch.utils.config import PinotConfiguration

    def of(mode):
        return QueryExecutor(
            segments, value_dtype=value_dtype or torch.float32, mesh=mesh,
            config=PinotConfiguration(
                overrides={**(config or {}),
                           "pinot.server.dispatch.mode": mode}))
    return {"serialized": of("serialized"),
            "pipelined": pipelined or of("pipelined")}


def window_launches(name: str, kernels, runs: str, disps: list,
                    stats0: list) -> dict:
    """The launch counts of a sub-leg's windows (name -> [single,
    batched]), read just after them, against what the dispatchers `disps`
    counted since `stats0`: the kernel `runs` (a name, or a tuple of the
    names a query launches, K7 and K1 for a CLP query) one single launch
    per inline or single dispatch, one batched launch per broadcast,
    stacked or dedup dispatch, as many batched members as those batches
    held (`runs` a dict: name -> launches per dispatch, a mesh launch's K1
    once per slot); every other kernel none."""
    mult = dict(runs) if isinstance(runs, dict) else \
        {r: 1 for r in ((runs,) if isinstance(runs, str) else runs)}
    seen: Counter = Counter()
    for d, s0 in zip(disps, stats0):
        s = d.stats()
        s.subtract(s0)
        seen.update(s)
    single = seen["inline"] + seen["single"]
    batched = seen["broadcast"] + seen["stacked"] + seen["dedup"]
    members = sum(k[1] * c for k, c in seen.items()
                  if isinstance(k, tuple) and k[1] > 1)
    got = {k.name: (k.launches, k.batched_launches, k.batched_members)
           for k in kernels}
    want = {k.name: (single * mult[k.name], batched * mult[k.name],
                     members * mult[k.name]) if k.name in mult
            else (0, 0, 0) for k in kernels}
    if got != want:
        fail(f"{name}: launches (single, batched, batched members) {got}, "
             f"the dispatchers counted {want}")
    return {k.name: [k.launches, k.batched_launches] for k in kernels}


def count_phase9(leg_launches: dict, totals: dict) -> None:
    """Add a phase 9 sub-leg's window launches to `totals` (name ->
    [single, batched])."""
    for kname, (single, batched) in leg_launches.items():
        totals[kname][0] += single
        totals[kname][1] += batched


def exact_pair(rows, want_sum: int, want_cnt: int):
    """None where rows hold one (SUM, COUNT) equal to the truth."""
    got = rows[0]
    if int(got[1]) != want_cnt or float(got[0]) != float(want_sum):
        return f"got {got}, numpy truth ({want_sum}, {want_cnt})"
    return None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated column and kernel input")
    args = ap.parse_args()
    t_start = time.perf_counter()
    marks = [t_start]

    def lap(what: str) -> None:
        """Print the seconds since the last lap and since the start."""
        now = time.perf_counter()
        print(f"[time] {what} {now - marks[-1]:.1f} s (at "
              f"{now - t_start:.1f} s)", flush=True)
        marks.append(now)

    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from pinot_tpu_torch.ops import _cuda
        from pinot_tpu_torch.query.executor import QueryExecutor
    except ImportError as e:
        fail(f"the port's package is missing beside chip_smoke.py: {e}")

    # phase 1: device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"[build] {built or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lap("phases 1-2")

    # phase 3: kernels against their plain versions
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    k6 = check_row_assemble(args.seed)
    for name, case in k6.pop("cases").items():
        print(f"[kernel] row_assemble {json.dumps(case)} | {card}",
              flush=True)
    # the last two legs' segments build on the host from here to phase 4:
    # every check below is timed on the card (K6's plain version, timed
    # on the host, ran above)
    pool, pending = start_late_builds(tmp, args.seed)
    # the vector segments build from here on at the lowest priority: on
    # the card's 8-core host they finish by phase 6 (started after phase
    # 3 instead, they overlap and slow phases 4-11; PERF.md)
    vpool, vpending = start_vector_builds(tmp, args.seed)
    # phase 14's segments build in the same low-priority pool, after the
    # vector segments
    vpending["hits"] = _start_map(vpool, build_one_segment,
                                  hits_jobs(tmp, args.seed))
    k1 = check_kernel("scan_agg", *kernel_inputs(args.seed, grouped=False))
    print(f"[kernel] scan_agg {json.dumps(k1)}", flush=True)
    k2_inputs = kernel_inputs(args.seed, grouped=True)
    k2 = check_kernel("group_agg", *k2_inputs)
    k2["library_ms"] = index_add_ms(*k2_inputs)
    k2["library"] = ("torch.Tensor.index_add_ of the kept docs' values at "
                     "precomputed keys: the scatter alone")
    print(f"[kernel] group_agg {json.dumps(k2)}", flush=True)
    del k2_inputs
    k3_inputs = sketch_kernel_inputs(args.seed)
    k3 = check_kernel("sketch_agg", *k3_inputs)
    k3["library_ms"] = histc_ms(*k3_inputs[:4])
    k3["library"] = "torch.histc, unfiltered histogram only"
    print(f"[kernel] sketch_agg {json.dumps(k3)}", flush=True)
    del k3_inputs
    torch.cuda.empty_cache()
    k4_cases = {}
    for name, inputs in topn_kernel_inputs(args.seed).items():
        k4_cases[name] = check_topn(name, *inputs)
        print(f"[kernel] topn {json.dumps(k4_cases[name])}", flush=True)
    # the kernels line carries case (a), the shape of sel.1 and sel.4, and
    # the largest error over all four cases
    k4 = dict(k4_cases["a: raw value DESC k=10"],
              max_abs_err=max(c["max_abs_err"] for c in k4_cases.values()))
    torch.cuda.empty_cache()
    k5_cases = {}
    for name, inputs in startree_kernel_inputs(args.seed).items():
        k5_cases[name] = check_startree(name, *inputs)
        print(f"[kernel] startree_agg {json.dumps(k5_cases[name])}",
              flush=True)
    torch.cuda.empty_cache()
    # K2 with the fused time bucket, at the time-series leg's shapes
    kb_cases = {}
    for name in BUCKET_CASES:
        inputs = bucket_kernel_inputs(args.seed, name)
        kb_cases[name] = dict(check_kernel(f"group_agg bucket {name}",
                                           *inputs), case=name,
                              library_ms=bincount_ms(*inputs),
                              library="torch.bincount(keys, weights) on "
                                      "precomputed keys: the scatter alone")
        print(f"[kernel] group_agg bucket {json.dumps(kb_cases[name])} "
              f"| {card}", flush=True)
        del inputs
        torch.cuda.empty_cache()
    kb = dict(kb_cases["ts.3: G=64,000 (global tier)"],
              max_abs_err=max(c["max_abs_err"] for c in kb_cases.values()))
    # K2 with compact keys at phase 14's block, below and at the cap
    kc_cases = {}
    for name, (G, cb3) in COMPACT_CASES.items():
        inputs = compact_kernel_inputs(args.seed, G, cb3=cb3)
        kc_cases[name] = dict(
            check_kernel(f"group_agg compact {name}", *inputs), case=name,
            G=G, library_ms=index_add_ms(*inputs),
            library="torch.Tensor.index_add_ of the kept docs' values at "
                    "precomputed keys: the scatter alone")
        print(f"[kernel] group_agg compact {json.dumps(kc_cases[name])} "
              f"| {card}", flush=True)
        del inputs
        torch.cuda.empty_cache()
    kc = dict(next(iter(kc_cases.values())),
              max_abs_err=max(c["max_abs_err"] for c in kc_cases.values()))
    # K1-K4 under an upsert validity mask clearing about a third of docs
    masked = {}
    for kname, inputs_fn in (
            ("scan_agg", lambda s: kernel_inputs(s, grouped=False)),
            ("group_agg", lambda s: kernel_inputs(s, grouped=True)),
            ("sketch_agg", sketch_kernel_inputs),
            ("topn",
             lambda s: topn_kernel_inputs(s)["a: raw value DESC k=10"])):
        plan, cols, params, num_docs, D = inputs_fn(args.seed)
        plan, cols = with_mask(plan, cols, args.seed)
        check = check_topn if kname == "topn" else check_kernel
        masked[kname] = check(f"{kname} masked", plan, cols, params,
                              num_docs, D)
        if kname == "sketch_agg":
            masked[kname]["library_ms"] = histc_ms(plan, cols, params,
                                                   num_docs)
        print(f"[kernel] {kname} masked {json.dumps(masked[kname])} "
              f"| {card}", flush=True)
        del plan, cols, params, num_docs
        torch.cuda.empty_cache()

    # K7 clp_match at the log leg's block, in both modes
    k7_cases = {}
    for mode in ("a", "b"):
        k7_cases[mode] = check_clp(f"mode {mode}",
                                   *clp_kernel_inputs(args.seed, mode))
        print(f"[kernel] clp_match {json.dumps(k7_cases[mode])} | {card}",
              flush=True)
        torch.cuda.empty_cache()
    k7 = dict(k7_cases["b"], launches=0)

    # phase 3b: the query axis against its plain version and the single
    # launches (K5's case runs in phase 7, on the blocks it stages)
    batched = {}
    for kname, inputs_fn in (
            ("scan_agg", lambda s: kernel_inputs(s, grouped=False)),
            ("group_agg", lambda s: kernel_inputs(s, grouped=True)),
            ("sketch_agg", sketch_kernel_inputs),
            ("topn",
             lambda s: topn_kernel_inputs(s)["a: raw value DESC k=10"])):
        batched[kname] = check_batched(kname,
                                       *batched_inputs(inputs_fn, args.seed))
        print(f"[kernel] {kname} batched {json.dumps(batched[kname])} "
              f"| {card}", flush=True)
        torch.cuda.empty_cache()
    kb_batched = check_bucket_batched(args.seed)
    print(f"[kernel] group_agg bucket batched {json.dumps(kb_batched)} "
          f"| {card}", flush=True)
    torch.cuda.empty_cache()
    kcb_cases = {}
    for name, (G, _cb3) in COMPACT_CASES.items():
        kcb_cases[name] = check_compact_batched(args.seed, G)
        print(f"[kernel] group_agg compact batched "
              f"{json.dumps(kcb_cases[name])} | {card}", flush=True)
    kc_batched = dict(next(iter(kcb_cases.values())), max_abs_err=max(
        c["max_abs_err"] for c in kcb_cases.values()))
    k7_batched = check_clp("mode b, B = 8 over one column set",
                           *clp_kernel_inputs(args.seed, "b", BATCH_B),
                           B=BATCH_B)
    print(f"[kernel] clp_match batched {json.dumps(k7_batched)} | {card}",
          flush=True)
    torch.cuda.empty_cache()
    # K8 vector_topk: phase 3's single-launch cases and phase 3b's forms
    k8_cases, k8b_cases = vector_kernel_cases(args.seed, card)
    # the kernels line carries vec.1's shape (IVF, k = 10) and the largest
    # error over every case
    k8 = dict(k8_cases["ivf k=10"], launches=0, max_abs_err=max(
        c["max_abs_err"] for c in k8_cases.values()))
    k8_batched = dict(k8b_cases["broadcast ivf k=10"], max_abs_err=max(
        c["max_abs_err"] for c in k8b_cases.values()))
    kernels = _cuda.KERNELS
    none = {k.name: 0 for k in kernels}
    p9 = {k.name: [0, 0] for k in kernels}
    variants = {}
    lap("phase 3")
    # phase 3c: K9 mesh_fold against its plain version, bit for bit
    k9_cases = mesh_fold_cases(args.seed)
    for case in k9_cases.values():
        print(f"[kernel] mesh_fold {json.dumps(case)} | {card}", flush=True)
    k9 = dict(k9_cases["doc fold B=1"], launches=0, max_abs_err=max(
        c["max_abs_err"] for c in k9_cases.values()))
    k9_batched = dict(k9_cases[f"doc fold B={BATCH_B}"], launches=0)
    torch.cuda.empty_cache()
    mesh_total: Counter = Counter()
    lap("phase 3c")
    late = finish_late_builds(pool, pending, ("tsbs", "logs"), card)
    lap("wait for the late builds")

    try:
        # phase 4: Q1 leg
        t0 = time.perf_counter()
        segs, truths = build_segments(
            tmp, "ssb", [("lo_orderdate", "INT", False),
                         ("lo_discount", "INT", False),
                         ("lo_quantity", "INT", False),
                         ("lo_extendedprice", "INT", True)],
            ["lo_extendedprice"], Q1_SEGMENTS, Q1_DOCS, ssb_q1_columns,
            q1_leg_truth, args.seed, BUILD_WORKERS)
        rows = sum(s.num_docs for s in segs)
        print(f"[q1] built {len(segs)} segments, {rows} rows in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ex = QueryExecutor(segs)  # device=None: the card
        torch.cuda.reset_peak_memory_stats()
        zero_launches(kernels)
        legs, splits = [], {}
        for name, sql in Q1_QUERIES.items():
            resp, cold, lats, splits[name] = time_query(ex, sql, ITERS)
            want_sum = sum(t["q1"][name][0] for t in truths)
            want_cnt = sum(t["q1"][name][1] for t in truths)
            got = resp.rows[0]
            if int(got[1]) != want_cnt or float(got[0]) != float(want_sum):
                fail(f"{name}: got {got}, numpy truth "
                     f"({want_sum}, {want_cnt})")
            legs.append({"query": name, "rows": rows,
                         "p50_ms": statistics.median(lats) * 1e3,
                         "cold_s": cold,
                         "rows_per_s": rows / statistics.median(lats),
                         "sum": want_sum, "count": want_cnt})
        resp, cold, lats, splits["mom"] = time_query(ex, MOM_QUERY, ITERS)
        legs.append({"query": "mom", "rows": rows,
                     "p50_ms": statistics.median(lats) * 1e3,
                     "cold_s": cold,
                     "rows_per_s": rows / statistics.median(lats),
                     "max_rel_err": check_moments(
                         resp.rows, [t["mom"] for t in truths], False),
                     "tolerance": MOM_TOL})
        got = launches_of_leg(
            "Q1 leg", kernels,
            {**none, "scan_agg": (len(Q1_QUERIES) + 1) * (1 + ITERS)})
        k1["launches"] = got["scan_agg"]
        k6["launches"] = got["row_assemble"]
        q1_peak = torch.cuda.max_memory_allocated()
        for leg in legs:
            leg["max_memory_allocated"] = q1_peak
            leg["stage_ms"] = splits[leg["query"]]
            print(f"[q1] {json.dumps(leg)} | {card}", flush=True)
        busy = device_busy(ex, Q1_QUERIES["q1.1"], ITERS, tmp)
        print(f"[q1] trace q1.1 {json.dumps(busy or 'not measured')} "
              f"| {card}", flush=True)

        # phase 4b: selection leg, on the Q1 leg's segments
        sel_truths = [t["sel"] for t in truths]
        torch.cuda.reset_peak_memory_stats()
        zero_launches(kernels)
        legs, splits = [], {}
        for name, (sql, _limit, _offset, _asc) in SEL_QUERIES.items():
            resp, cold, lats, splits[name] = time_query(ex, sql, ITERS)
            want, matched = selection_expected(
                sel_truths, name, resp.result_table.columns)
            if resp.rows != want:
                bad = next((i for i, (a, b) in enumerate(zip(resp.rows,
                                                             want))
                            if a != b), min(len(resp.rows), len(want)))
                fail(f"{name}: {len(resp.rows)} rows, numpy truth "
                     f"{len(want)}; first difference at row {bad}")
            if resp.stats.num_docs_scanned != matched:
                fail(f"{name}: {resp.stats.num_docs_scanned} docs matched, "
                     f"numpy truth {matched}")
            legs.append({"query": name, "rows": rows, "matched": matched,
                         "returned": len(want),
                         "p50_ms": statistics.median(lats) * 1e3,
                         "cold_s": cold,
                         "rows_per_s": rows / statistics.median(lats)})
        resp, cold, lats, splits["dist.1"] = time_query(ex, DIST_QUERY,
                                                        ITERS)
        want = sorted(set().union(*(t["dist.1"] for t in sel_truths)))
        if [tuple(r) for r in resp.rows] != want:
            fail(f"dist.1: {len(resp.rows)} pairs, numpy truth {len(want)}")
        legs.append({"query": "dist.1", "rows": rows, "returned": len(want),
                     "p50_ms": statistics.median(lats) * 1e3, "cold_s": cold,
                     "rows_per_s": rows / statistics.median(lats)})
        got = launches_of_leg(
            "selection leg", kernels,
            {**none, "topn": len(SEL_QUERIES) * (1 + ITERS),
             "group_agg": 1 + ITERS})
        k4["launches"] = got["topn"]
        k2_launches = got["group_agg"]
        k6["launches"] += got["row_assemble"]
        peak = torch.cuda.max_memory_allocated()
        for leg in legs:
            leg["max_memory_allocated"] = peak
            leg["stage_ms"] = splits[leg["query"]]
            print(f"[sel] {json.dumps(leg)} | {card}", flush=True)
        for name in ("sel.1", "sel.2"):
            busy = device_busy(ex, SEL_QUERIES[name][0], ITERS, tmp)
            print(f"[sel] trace {name} {json.dumps(busy or 'not measured')} "
                  f"| {card}", flush=True)
        # the MSE leaf's filtered doc ids on the same segments (K4)
        k4["launches"] += mse_leaf(ex, segs, truths, kernels, none, card)

        lap("phases 4 and 4b")
        # phase 9a: Q1.1-shaped concurrency, broadcast batches (K1)
        execs = modes_of(segs, pipelined=ex)
        leg = concurrency_leg(
            "9a", execs, [q1_sql(*w) for w in Q1_POOL],
            [list(range(len(Q1_POOL)))] * CLIENTS,
            lambda i, rows: exact_pair(
                rows, sum(t["q1pool"][i][0] for t in truths),
                sum(t["q1pool"][i][1] for t in truths)), card, tmp,
            kernels, "scan_agg")
        count_phase9(leg["launches"], p9)
        variants["9a"] = leg["seen"]

        # phase 9c: sel.1-shaped top-N concurrency (K4)
        def sel_check(i, rows):
            parts = [t["selpool"][i][1] for t in truths]
            want = [r[1] for r in sorted((r for p in parts for r in p),
                                         key=lambda r: -r[0])][:10]
            return None if rows == want else \
                f"{rows[:3]} vs numpy truth {want[:3]}"
        leg = concurrency_leg(
            "9c", execs, [sel_pool_sql(*w) for w in SEL_POOL],
            [list(range(len(SEL_POOL)))] * CLIENTS, sel_check, card, tmp,
            kernels, "topn")
        count_phase9(leg["launches"], p9)
        # the single card's sketch answer on these rows, phase 13's
        # reference
        sketch_ref = rows_of(ex.execute(MESH_SKETCH))
        del ex, execs
        torch.cuda.empty_cache()
        lap("phases 9a and 9c")

        # phase 13: the mesh leg on the Q1 rows, with 9j
        got, mesh_entries, p9j = mesh_leg(segs, truths, sketch_ref, kernels,
                                          none, card, tmp)
        mesh_total.update(got)
        count_phase9(p9j, p9)
        torch.cuda.empty_cache()
        lap("phase 13 and 9j")

        # phase 4c: the staging levels (residency) on the Q1 segments
        k6["launches"] += residency_phase(segs, truths, kernels, none,
                                          card)
        # phase 4d: upserts on the same segments (K1-K4 with the mask)
        got = upsert_leg(segs, args.seed, kernels, none, card)
        for kname, entry in masked.items():
            entry["launches"] = got[kname]
        upsert_launches = got
        k6["launches"] += got["row_assemble"]
        del segs
        torch.cuda.empty_cache()
        lap("phases 4c and 4d")

        # phase 5: group-by leg
        t0 = time.perf_counter()
        segs, truths = build_segments(
            tmp, "ssbgb", [("lo_orderdate", "INT", False),
                           ("lo_discount", "INT", False),
                           ("lo_quantity", "INT", False),
                           ("d_year", "INT", False),
                           ("p_category", "STRING", False),
                           ("s_region", "STRING", False),
                           ("lo_revenue", "INT", True)],
            ["lo_revenue"], GB_SEGMENTS, GB_DOCS, ssb_flat_columns,
            groupby_leg_truth, args.seed, BUILD_WORKERS)
        rows = sum(s.num_docs for s in segs)
        print(f"[groupby] built {len(segs)} segments, {rows} rows in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ex = QueryExecutor(segs)
        torch.cuda.reset_peak_memory_stats()
        zero_launches(kernels)
        resp, cold, lats, split = time_query(ex, GB_QUERY, ITERS)
        dresp, dcold, dlats, dsplit = time_query(ex, GB_DISTINCT, ITERS)
        mresp, mcold, mlats, msplit = time_query(ex, GB_MOM_QUERY, ITERS)
        got = launches_of_leg("group-by leg", kernels,
                              {**none, "group_agg": 3 * (1 + ITERS)})
        k2["launches"] = k2_launches + got["group_agg"]
        k6["launches"] += got["row_assemble"]
        want = {}
        for t in truths:
            for key, v in t["gb"].items():
                want[key] = want.get(key, 0) + v
        got = {(int(r[0]), str(r[1])): float(r[2]) for r in resp.rows}
        if sorted(got) != sorted(want) or \
                [tuple(r[:2]) for r in resp.rows] != sorted(want):
            fail(f"group keys differ: {sorted(got)[:5]} vs "
                 f"{sorted(want)[:5]}")
        for key, v in want.items():
            if abs(got[key] - v) > 1e-6 * abs(v):
                fail(f"group {key}: {got[key]} vs numpy truth {v}")
        leg = {"query": "groupby", "rows": rows, "groups": len(want),
               "p50_ms": statistics.median(lats) * 1e3, "cold_s": cold,
               "rows_per_s": rows / statistics.median(lats),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "stage_ms": split}
        print(f"[groupby] {json.dumps(leg)} | {card}", flush=True)
        dwant = sorted(set().union(*(t["dist"] for t in truths)))
        if [tuple(r) for r in dresp.rows] != dwant:
            fail(f"string DISTINCT: {[tuple(r) for r in dresp.rows][:5]} "
                 f"vs numpy truth {dwant[:5]}")
        leg = {"query": "distinct", "rows": rows, "returned": len(dwant),
               "p50_ms": statistics.median(dlats) * 1e3, "cold_s": dcold,
               "rows_per_s": rows / statistics.median(dlats),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "stage_ms": dsplit}
        print(f"[groupby] {json.dumps(leg)} | {card}", flush=True)
        leg = {"query": "mom", "rows": rows, "groups": len(mresp.rows),
               "p50_ms": statistics.median(mlats) * 1e3, "cold_s": mcold,
               "rows_per_s": rows / statistics.median(mlats),
               "max_rel_err": check_moments(
                   mresp.rows, [t["mom"] for t in truths], True),
               "tolerance": MOM_TOL,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "stage_ms": msplit}
        print(f"[groupby] {json.dumps(leg)} | {card}", flush=True)
        busy = device_busy(ex, GB_QUERY, ITERS, tmp)
        print(f"[groupby] trace {json.dumps(busy or 'not measured')} "
              f"| {card}", flush=True)

        # phase 9d: config-#3-shaped group-by concurrency (K2)
        def gb_check(i, rows):
            want = {}
            for t in truths:
                for key, (sm, cnt) in t["gbpool"][i].items():
                    a, b = want.get(key, (0, 0))
                    want[key] = (a + sm, b + cnt)
            keys = sorted(want)
            if [(int(r[0]), str(r[1])) for r in rows] != keys:
                return f"group keys {rows[:3]} vs numpy truth {keys[:3]}"
            for r in rows:
                sm, cnt = want[(int(r[0]), str(r[1]))]
                if int(r[3]) != cnt or abs(float(r[2]) - sm) > 1e-6 * sm:
                    return f"group {r} vs numpy truth ({sm}, {cnt})"
            return None
        leg = concurrency_leg(
            "9d", modes_of(segs, pipelined=ex),
            [gb_pool_sql(*w) for w in GB_POOL],
            [list(range(len(GB_POOL)))] * CLIENTS, gb_check, card, tmp,
            kernels, "group_agg")
        count_phase9(leg["launches"], p9)
        del ex
        # phase 13a's config-#3 group-by: the sharded K2 on these rows
        got = mesh_groupby(segs, resp.rows, kernels, none, card)
        mesh_total.update(got)
        mesh_entries["sharded"]["launches"] += got["mesh_fold"]
        del segs
        torch.cuda.empty_cache()

        lap("phases 5, 9d and 13a's group-by")
        # phase 6: config-#4 sketch leg
        t0 = time.perf_counter()
        segs, truths = build_segments(
            tmp, "taxi", [("trip_id", "LONG", False),
                          ("fare", "DOUBLE", True)],
            ["trip_id", "fare"], TAXI_SEGMENTS, TAXI_DOCS, taxi_columns,
            taxi_truth, args.seed, BUILD_WORKERS)
        expected = taxi_expected(truths, segs)
        rows = sum(s.num_docs for s in segs)
        print(f"[config4] built {len(segs)} segments, {rows} rows and "
              f"their truth in {time.perf_counter() - t0:.1f} s",
              flush=True)
        ex = QueryExecutor(segs)
        torch.cuda.reset_peak_memory_stats()
        zero_launches(kernels)
        legs, splits = [], {}
        for name, sql in TAXI_QUERIES.items():
            resp, cold, lats, splits[name] = time_query(ex, sql, ITERS)
            card_hll, p95, exact, kept = expected[name]
            got = resp.rows[0]
            if int(got[0]) != card_hll:
                fail(f"{name}: DISTINCTCOUNTHLL {got[0]}, numpy HLL "
                     f"{card_hll}")
            if float(got[1]) != p95:
                fail(f"{name}: p95 {got[1]}, numpy histogram digest {p95}")
            if abs(float(got[1]) - exact) > 0.02 * abs(exact):
                fail(f"{name}: p95 {got[1]} beyond rel 0.02 of the exact "
                     f"{exact}")
            legs.append({"query": name, "rows": rows, "kept": kept,
                         "p50_ms": statistics.median(lats) * 1e3,
                         "cold_s": cold,
                         "rows_per_s": rows / statistics.median(lats),
                         "distinctcounthll": card_hll, "p95": p95,
                         "exact_p95": exact})
        got = launches_of_leg(
            "config-#4 leg", kernels,
            {**none, "sketch_agg": len(TAXI_QUERIES) * (1 + ITERS)})
        k3["launches"] = got["sketch_agg"]
        k6["launches"] += got["row_assemble"]
        peak = torch.cuda.max_memory_allocated()
        for leg in legs:
            leg["max_memory_allocated"] = peak
            leg["stage_ms"] = splits[leg["query"]]
            print(f"[config4] {json.dumps(leg)} | {card}", flush=True)
        for name, sql in TAXI_QUERIES.items():
            busy = device_busy(ex, sql, ITERS, tmp)
            print(f"[config4] trace {name} "
                  f"{json.dumps(busy or 'not measured')} | {card}",
                  flush=True)

        # phase 9e: config #4's sketches under concurrency (K3)
        names = list(TAXI_QUERIES)

        def taxi_check(i, rows):
            card_hll, p95, _exact, _kept = expected[names[i]]
            if int(rows[0][0]) != card_hll or float(rows[0][1]) != p95:
                return f"{rows[0]} vs numpy ({card_hll}, {p95})"
            return None
        leg = concurrency_leg(
            "9e", modes_of(segs, pipelined=ex), list(TAXI_QUERIES.values()),
            [list(range(len(names)))] * CLIENTS, taxi_check, card, tmp,
            kernels, "sketch_agg")
        count_phase9(leg["launches"], p9)
        del ex, segs
        torch.cuda.empty_cache()

        lap("phases 6 and 9e")
        # phase 7: star-tree leg (config #5 and bench.py --startree's
        # table), with phase 3b's K5 case and phase 9f
        got, leg_cases, batched["startree_agg"], p9f = startree_leg(
            tmp, args.seed, kernels, none, card)
        count_phase9(p9f, p9)
        # the kernels line carries config #5's query on the inputs the
        # engine staged for it, and the largest error over every case,
        # phase 3's and the leg's
        k5 = dict(leg_cases["st5.1"], launches=got["startree_agg"],
                  max_abs_err=max(c["max_abs_err"] for c in
                                  [*k5_cases.values(), *leg_cases.values()]))
        k1["launches"] += got["scan_agg"]
        k2["launches"] += got["group_agg"]
        k6["launches"] += got["row_assemble"]

        lap("phases 7 and 9f")
        # phase 9b: batching_main's three tables, stacked and dedup (K1)
        t0 = time.perf_counter()
        tables, b9 = {}, {}
        for ti, (table, (n_segs, docs)) in enumerate(B9_TABLES.items()):
            tables[table], b9[table] = build_segments(
                tmp, table, [("lo_orderdate", "INT", False),
                             ("lo_discount", "INT", False),
                             ("lo_quantity", "INT", False),
                             ("lo_extendedprice", "INT", True)],
                ["lo_extendedprice"], n_segs, docs, ssb_q1_columns,
                b9_truth, args.seed + 1000 * (ti + 1), BUILD_WORKERS)
        print(f"[9b] built {sum(len(v) for v in tables.values())} segments,"
              f" {sum(s.num_docs for v in tables.values() for s in v)} rows"
              f" in {time.perf_counter() - t0:.1f} s", flush=True)
        names = list(B9_TABLES)
        pool = [b9_sql(t, a) for t in names for a in B9_DISCOUNTS]
        width = len(B9_DISCOUNTS)

        def b9_check(i, rows):
            table, a = names[i // width], i % width
            return exact_pair(rows, sum(t[a][0] for t in b9[table]),
                              sum(t[a][1] for t in b9[table]))
        leg = concurrency_leg(
            "9b", modes_of(tables), pool,
            [[names.index(t) * width + a for a in B9_DISCOUNTS]
             for t in B9_CLIENTS], b9_check, card, tmp, kernels, "scan_agg",
            probes=([0, width + 1, 2 * width + 2], [0, 3, width + 1]))
        count_phase9(leg["launches"], p9)
        variants["9b"] = leg["seen"]
        del tables
        torch.cuda.empty_cache()

        lap("phase 9b")
        # phase 10: the time-series leg (TSBS cpu-only), with phase 9g
        kb["launches"], k6_ts, p9g = tsbs_leg(tmp, args.seed, kernels, none,
                                              card, late.pop("tsbs"))
        lap("phase 10 and 9g")
        k2["launches"] += kb["launches"]
        k6["launches"] += k6_ts
        count_phase9(p9g, p9)
        kb_batched["launches"] = p9g["group_agg"][1]

        # phase 11: the log leg (CLP log search on K7), with phase 9h
        log_launches, p9h = log_leg(tmp, args.seed, kernels, none, card,
                                    late.pop("logs"))
        lap("phase 11 and 9h")
        for kern, entry in ((_cuda.SCAN_AGG, k1), (_cuda.GROUP_AGG, k2),
                            (_cuda.TOPN, k4), (_cuda.ROW_ASSEMBLE, k6),
                            (_cuda.CLP_MATCH, k7)):
            entry["launches"] += log_launches[kern.name]
        count_phase9(p9h, p9)

        # phase 12: the vector leg (K8), with phase 9i
        done = finish_late_builds(vpool, vpending, ("vector",),
                                  card)["vector"]
        print(f"[build] a vector segment took "
              f"{max(sec for _o, sec in done):.1f} s at most | {card}",
              flush=True)
        vec_launches, p9i = vector_leg(tmp, args.seed, kernels, none, card,
                                       done)
        lap("phase 12 and 9i")
        k8["launches"] = vec_launches["vector_topk"]
        k6["launches"] += vec_launches["row_assemble"]
        count_phase9(p9i, p9)

        # phase 14: compact group keys on ClickBench's hits (its segments
        # built in the vector pool, which phase 12 closed)
        from pinot_tpu_torch.segment.loader import load_segment
        done = vpending["hits"][0].get()
        cb_launches, kc_batched["launches"] = cb_leg(
            [load_segment(out) for out, _t in done], [t for _o, t in done],
            kernels, none, card)
        lap("phase 14")
        kc["launches"] = cb_launches["group_agg"]
        for kern, entry in ((_cuda.GROUP_AGG, k2), (_cuda.ROW_ASSEMBLE, k6),
                            (_cuda.MESH_FOLD, k9)):
            entry["launches"] += cb_launches[kern.name]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # phase 8: the kernels line, the card line, the result
    print(f"[concurrency] batched launches per variant {json.dumps(variants)}"
          f" | {card}", flush=True)
    for v in ("broadcast", "stacked", "dedup"):
        if not any(seen[v] for seen in variants.values()):
            fail(f"phase 9a-9b never formed a {v} batch")
    for kern, entry in ((_cuda.SCAN_AGG, k1), (_cuda.GROUP_AGG, k2),
                        (_cuda.SKETCH_AGG, k3), (_cuda.TOPN, k4),
                        (_cuda.STARTREE_AGG, k5)):
        single, batch = p9[kern.name]
        entry["launches"] += single + upsert_launches[kern.name]
        batched[kern.name]["launches"] = batch
        if not batch:
            fail(f"phase 9 never launched {kern.name}'s batched form")
    batched["group_agg"]["launches"] += kc_batched["launches"]
    if not k6["launches"]:
        fail("the main path never launched row_assemble")
    k7["launches"] += p9["clp_match"][0]
    k7_batched["launches"] = p9["clp_match"][1]
    if not k7["launches"] or not k7_batched["launches"]:
        fail("the main path never launched clp_match, single and batched")
    k8["launches"] += p9["vector_topk"][0]
    k8_batched["launches"] = p9["vector_topk"][1]
    if not k8["launches"] or not k8_batched["launches"]:
        fail("the main path never launched vector_topk, single and batched")
    # phase 13's launches (the mesh legs run K1-K3 and K6 as well)
    for kern, entry in ((_cuda.SCAN_AGG, k1), (_cuda.GROUP_AGG, k2),
                        (_cuda.SKETCH_AGG, k3), (_cuda.ROW_ASSEMBLE, k6),
                        (_cuda.MESH_FOLD, k9)):
        entry["launches"] += mesh_total[kern.name]
    k9["launches"] += p9["mesh_fold"][0]
    k9_batched["launches"] = p9["mesh_fold"][1]
    if not k9["launches"] or not k9_batched["launches"]:
        fail("the main path never launched mesh_fold, single and batched")
    for name, entry in [("group_agg bucket", kb),
                        ("group_agg bucket batched", kb_batched),
                        ("group_agg compact", kc),
                        ("group_agg compact batched", kc_batched),
                        *((f"{k} masked", e) for k, e in masked.items())]:
        if not entry["launches"]:
            fail(f"the main path never launched {name}")
    entries = []
    for kern, entry, replaces in (
            (_cuda.SCAN_AGG, k1, "pinot_tpu/ops/kernels.py:537"),
            (_cuda.GROUP_AGG, k2, "pinot_tpu/ops/kernels.py:252"),
            (_cuda.SKETCH_AGG, k3, "pinot_tpu/ops/kernels.py:429,451"),
            (_cuda.TOPN, k4, "pinot_tpu/ops/kernels.py:583"),
            (_cuda.STARTREE_AGG, k5,
             "pinot_tpu/ops/startree_device.py:99,81"),
            (_cuda.ROW_ASSEMBLE, k6, "pinot_tpu/ops/kernels.py:100"),
            (_cuda.CLP_MATCH, k7, "pinot_tpu/ops/clp_device.py:700,757"),
            (_cuda.VECTOR_TOPK, k8, "pinot_tpu/ops/vector_device.py:104"),
            (_cuda.MESH_FOLD, k9, "pinot_tpu/ops/kernels.py:685,"
             "pinot_tpu/ops/collective.py:131,167")):
        entries.append({
            "name": kern.name, "route": "cuda",
            "source": f"pinot_tpu_torch/ops/csrc/{kern.source}",
            "replaces": replaces, "launches": entry["launches"],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"]})
    for kern, replaces in (
            (_cuda.SCAN_AGG, "pinot_tpu/ops/kernels.py:793,823"),
            (_cuda.GROUP_AGG, "pinot_tpu/ops/kernels.py:793,823"),
            (_cuda.SKETCH_AGG, "pinot_tpu/ops/kernels.py:793,823"),
            (_cuda.TOPN, "pinot_tpu/ops/kernels.py:858"),
            (_cuda.STARTREE_AGG, "pinot_tpu/ops/startree_device.py:152"),
            (_cuda.CLP_MATCH, "pinot_tpu/ops/clp_device.py:700,757"),
            (_cuda.VECTOR_TOPK, "pinot_tpu/ops/vector_device.py:163"),
            (_cuda.MESH_FOLD, "pinot_tpu/ops/kernels.py:893")):
        entry = {_cuda.CLP_MATCH: k7_batched,
                 _cuda.VECTOR_TOPK: k8_batched,
                 _cuda.MESH_FOLD: k9_batched}.get(kern) \
            or batched[kern.name]
        entries.append({
            "name": f"{kern.name}_batched", "route": "cuda",
            "source": f"pinot_tpu_torch/ops/csrc/{kern.source}",
            "replaces": replaces, "launches": entry["launches"],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"]})
    # the time bucket (K2's digit), compact keys (K2's key block) and the
    # validity mask (K1-K4): launches are those of the legs whose every
    # launch carries them (phase 10 and 9g; phase 14; phase 4d), a subset
    # of the kernel's own entry above
    for name, kern, entry, replaces in (
            ("group_agg_tbucket", _cuda.GROUP_AGG, kb,
             "pinot_tpu/ops/timeseries_device.py:166"),
            ("group_agg_tbucket_batched", _cuda.GROUP_AGG, kb_batched,
             "pinot_tpu/ops/timeseries_device.py:166,"
             "pinot_tpu/ops/kernels.py:793"),
            ("group_agg_compact", _cuda.GROUP_AGG, kc,
             "pinot_tpu/ops/kernels.py:488"),
            ("group_agg_compact_batched", _cuda.GROUP_AGG, kc_batched,
             "pinot_tpu/ops/kernels.py:488,793"),
            *((f"{k}_masked", kern, masked[k], f"pinot_tpu/ops/kernels.py:"
               f"{604 if k == 'topn' else 565}")
              for k, kern in (("scan_agg", _cuda.SCAN_AGG),
                              ("group_agg", _cuda.GROUP_AGG),
                              ("sketch_agg", _cuda.SKETCH_AGG),
                              ("topn", _cuda.TOPN)))):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"pinot_tpu_torch/ops/csrc/{kern.source}",
            "replaces": replaces, "launches": entry["launches"],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"]})
    # rows 7, 8c, 9 and 14: each mesh path's whole launch sequence on the
    # logical 4x2 mesh (a launch per slot, then K9); launches are K9's on
    # that path
    for name, key, replaces in (
            ("mesh_sharded", "sharded",
             "pinot_tpu/ops/kernels.py:710,668,685"),
            ("mesh_sharded_batched", "batched",
             "pinot_tpu/ops/kernels.py:893"),
            ("mesh_merged", "merged",
             "pinot_tpu/ops/collective.py:187,234,68"),
            ("mesh_step", "step",
             "pinot_tpu/parallel/distributed_query.py:30")):
        entry = mesh_entries[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"pinot_tpu_torch/ops/csrc/{_cuda.MESH_FOLD.source}",
            "replaces": replaces, "launches": entry["launches"],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"]})
    print(f"[time] whole run {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
