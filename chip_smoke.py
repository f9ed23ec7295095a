#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (dragnet_tpu_torch) on one GPU.

    python3 chip_smoke.py [--records N] [--seed S] [--reps R] [--json F]
                          [--only-scl | --only-devbench | --only-body]

Phases, each ending in torch.cuda.synchronize() so a fault shows where
it happened and printing its wall (`phase ...: N s`) with the device
folds it ran and the scan program's launches in them; any failed check
exits non-zero.  `--only-scl` runs phases 1-4, 3b, 7 and 15 alone,
`--only-devbench` phases 1 and 16 over the generated data,
`--only-body` phases 1, 3b and 16, and none prints a result line.
Every device fold of the run, on every path and thread (forced, the
stack, sparse, the mesh, auto, follow, serve, the cluster and its
child processes), must launch the scan program K2 exactly once per
mesh shard (once off a mesh): a ledger around DeviceScan._fold_staged
counts it, and a phase whose folds launched otherwise fails.

1. build   the kernels (ops/csrc/onehot_agg.cu, the one-hot aggregation;
           ops/csrc/quote_parity.cu, the byte lane's quote parity;
           ops/csrc/scan_body.cu, the scan program K2) from the sources
           in this checkout, one nvcc per source started together;
           prints ptxas's registers, shared memory and spills
           (-Xptxas -v).
2. kernel  the kernel against its plain torch version, exactly, at the
           four shapes of tests/test_pallas.py (through onehot_dense),
           at one batch (65,536 records) with each kernel query's caps,
           over a sweep at the main path's batch size (74,800 records x
           256-4,096 segments, unit weights) on uniform keys, on keys
           all in one bin and on linear-timestamp runs, at n = 0 and 1,
           into a non-zero accumulator with signed weights and i64 keys,
           and at 2,000,000 records x 4,096 segments.  Each timed shape
           prints the kernel's, the plain version's and the yardstick's
           times (device and eager) and the bound; the yardstick is
           index_add_ of the same fused key into a preallocated i64
           accumulator, the same function.  Beside the 2,000,000-record
           call, two floors (any launch; a copy of the same keys), and
           the wrapper's private stream lookup checked against
           torch.cuda.current_stream, with the host cost of each.
3. data    N generated muskie request-log records (native/dngen.cc) in a
           temporary directory, with a DRAGNET_CONFIG holding one file
           datasource (timeField=time, filter {"ne":["host","zzz"]}),
           and a cold pass: the three queries over 20,000 records, once,
           which pays the process's one-time CUDA warm-up (timed
           separately) before the measured main path.
3b. body   the scan program K2 against its plain version
           (scan_program.scan_body_ref) on the card, exactly, on the
           first batch (65,536 records) of phase 3's file for bench.py's
           QUERY and PALLAS_QUERY, the timestamp query of phase 4, the
           two sparse queries of phase 5 and the build's per-minute
           metric with its hour key, and of generated records holding
           every tag kind and bad dates for a filter over every leaf
           kind, nested 4 deep, with time bounds, signed weights, a
           host-translated key, kvalid and linear buckets over negative
           values: counters, first occurrences, dense sums, fused keys
           and sparse rows, in every output mode the key space allows
           (K1's fused key, dense atomics, sparse) and as two mesh
           shards.  Each case's own route timed: K2 in a CUDA graph of
           `reps` calls and issued one by one, the plain version (the
           torch interpreter of the same descriptor, the old eager
           body's successor) issued one by one, and the bound (bytes:
           each input read once, each output written once; or the
           integer operations a record needs); a `body` JSON line.
4. scans   `scan` through the port's CLI code path, in-process, on the
           card, for three queries; each output (--points and
           --counters) must equal the port's host engine on the same
           file byte for byte, every batch must run on the device, K2
           must launch once per batch on every query, and K1 once per
           batch on the two kernel queries and never on the scatter
           query.
5. sparse  two high-cardinality scans on the card (the sparse program:
           fused i64 keys sort-merged into a resident set): the
           per-minute timestamp x host x url x latency query, which
           starts dense and turns sparse as its time window grows, and a
           wider query without a time window, sparse from its first
           batch, whose ~1.8M unique tuples make the guard grow the set
           past its 2^20 initial capacity.  Every batch must run on the
           device, the sparse fold must run (its call count), the set
           must grow, and the output must equal the host engine's byte
           for byte.  Prints records/s of both engines, the fold's
           device ms per batch (CUDA events) and the capacity reached;
           beside it, the fold alone at 2^20 and 2^22 slots (nearly
           full, one main-path batch) with its sort's share.
6. build   three metrics (metric-add), `build --interval=hour
           --counters` on the card through the CLI and with the host
           engine into a second tree: the trees (shards and integrity
           catalog) must be byte-identical, every batch must fold
           through the stack (DeviceScanStack), one metric on each fold
           route (one-hot kernel, index_add_, sparse), the kernel
           launching once per stacked batch; then `index-scan` on both
           engines over the data's first 20 minutes (the whole file
           scanned), identical.  Prints wall s and records/s of both
           builds, the index writer's share, shards and bytes, and
           whether libdnindex.so was loaded.
6b. pipe   the pipelined dispatch: the K1 query (host x latency) and
           the phase 6 build at DN_DEVICE_PIPELINE_DEPTH 1 and 2, and
           the build at 2 without the flush prefetch (DN_PREFETCH=0):
           outputs equal to phase 4's, trees and --counters to phase
           6's, byte for byte; K1 once per device batch; every
           per-record upload from page-locked memory (the ring counts
           device_h2d_pinned_bytes from is_pinned() at each copy, and
           it must equal device_h2d_bytes); never more than `depth`
           batches running after a dispatch; no synchronizing CUDA call
           inside the kernel query's device batches between flushes
           (torch's sync debug mode, each one listed); then the K1
           query at depths 1 and 2 with ~20 ms of device work added
           after each fold, which must leave the output unchanged and
           fill the window to exactly its depth (1 batch in flight at
           depth 1, 2 at depth 2).  Prints wall, records/s, dispatches,
           overlapped dispatches and bytes, the most batches in flight,
           H2D bytes, the staging slots allocated, the host seconds of
           staging + upload and of the fetch wait, and a `pipeline` JSON
           line.
7. query   `dn query` on the card: N records spread over 30 days, the
           three metrics of phase 6 built on the card with
           --interval=hour (720 shards) and --interval=day (30 shards),
           then QUERY_CASES through the CLI (--points --counters) on the
           card and with the port's host engine on the same tree,
           byte for byte.  The stacked queries must aggregate on the
           device (the hidden `index device sums` counter, a non-zero
           dispatch count of the slot-packed fold); the bare query must
           take its host route; the windowed query must prune.  Prints
           per query the wall time of both engines, the fold's device
           ms per dispatch (CUDA events), dispatches, upload bytes, the
           host seconds of load / sort / aggregate and the fold's
           bound, and a `query` JSON line.
8. auto    the default engine (DN_ENGINE=auto), after phases 3-7 ran
           the forced lane (DN_ENGINE=jax) against the single-threaded
           host engine: per phase 4 query, the host engine at one
           worker and at the default count, auto with an empty verdict
           cache, again with the cache it wrote, and auto with eager
           constants (escalate after 1,024 records, no accelerator
           requirement, no remaining-time bar, margin 0; the stream
           waits for a fed audition instead of racing it), which must
           take over on the card, K1 launching on the two kernel
           queries and never on the scatter query; each output equal
           to the forced lane's.  Then an eager auto build, through the
           stack, its tree equal to phase 6's, the same racing its
           audition (whether and when the audition concluded is
           printed, with the replay's wall and CPU seconds), again on
           the verdict that run persisted (which it must follow), and a
           default one; then auto queries (a) and (d) of phase 7: the
           first auditions (CUDA is warm), both paths equal, the repeat
           follows the persisted verdict.  Prints every route
           (escalation record, audition and probation rates, device
           batches, cached verdicts) and an `auto` JSON line.
9. parse   the byte lane (DN_PARSE) and its quote-parity kernel (K8):
           the kernel against its plain torch version and parity_numpy,
           exactly, at 13 lengths (0 to 2^20 + 1 bytes) x 5 quote
           densities on bytes that are not JSON, and on the whole data
           file in one call; its device ms, the plain version's, the
           per-block round trip (page-locked copy, H2D, kernel, D2H,
           event wait) against parity_numpy's host ms, and its bound,
           (n + n/8) bytes at 3.35 TB/s.  Then the K1 query on the
           forced lane at DN_PARSE=device over the N records: output and
           --counters equal to phase 4's, the parity kernel launching
           once per parse block, K1 once per device batch; the
           three-metric hour build at DN_PARSE=device, tree and
           --counters equal to phase 6's (its dotted paths keep the
           native lane, counted as ineligible); an hour build of two
           flat metrics at DN_PARSE=device, tree and --counters equal
           to the native lane's, one parity launch per parse block.
           Then 200,000 records through every lane (native, vector,
           device) on the host engine, the device lane on the forced
           lane, and the per-record engine (DN_ENGINE=host, and
           --warnings), each output equal to the native lane's;
           records/s, MB/s and the parity's share of the parser's
           parse_seconds; a `parse` JSON line.
9b. life  the index tree's lifecycle.  `dn follow --once` on the card
           (DN_ENGINE=jax, DN_FOLLOW_APPEND=1, 16 MiB mini-batches cut by
           the byte budget) after each of 4 appends of the N records to
           a followed file, with phase 9's two flat metrics at
           --interval=hour: every mini-batch folding through the stack,
           K1 once per device batch, generations pending after rounds 2
           on; `query --points` of two queries equal to the same over
           phase 9's native-lane build; `dn compact`, its tree byte-equal
           to that build (catalog included, follow state and quarantine
           left out), the queries then equal with their --counters;
           device memory allocated after the last mini-batch no more
           than one batch's accumulators above the first, with the
           page-locked staging slots allocated; the rewrite mode (no
           DN_FOLLOW_APPEND) over the first 500,000 records, its tree
           equal to a build of them; a kernel fault planted in one
           mini-batch, which must exit 1 with the error and no publish
           retry, its checkpoint at the last good batch; then `dn
           rollup` on copies of phase 7's trees (--interval hour and
           day), phase 7's query cases equal to its outputs, the bare
           query through the rollups, a second rollup building nothing.
           Prints each round's wall, records/s and follow.scan /
           follow.publish seconds, the compaction's and the rollups'
           walls, query walls before and after, and a `lifecycle` JSON
           line.
12. serve  `dn serve` on the card (serve/server.py, in-process on a
           unix socket, DN_ENGINE=jax, DN_DEVICE_RESIDENCY_MB=4096,
           pre-warm on, 4 execution slots) over a copy of phase 7's
           tree, every request through the port's `--remote` client:
           the pre-warm's doc (state ok, both K7a shapes, its ms);
           phase 7's QUERY_CASES three times, each output equal to phase
           7's — misses that pin the shards, then one accumulator hit
           per stacked case with no fold dispatch, then, after
           drop_host_pins(), a pinned-shard hit for every staged shard
           with only the translation tables uploaded; the two K1 scans
           of phase 4 (outputs equal, K1 once per device batch); 8
           client threads sending the queries and the K1 scan at once
           (every answer equal to its serial one; K1 launches made on
           worker threads printed); `build --remote` into the copy (the
           next query drops stale pins and still equals phase 7's); a
           fault planted in the K7 fold (that request rc 1 with "dn:
           ...", the next one right); p50 and p99 of 30 repeats of query
           (b) with residency, on a server without it, and (3 repeats)
           in a cold `python -m dragnet_tpu_torch query` process; the
           drain (stop() returns, the pins dropped, device memory back
           within one batch's accumulators of its level before the
           server).  Then K7 on a dispatch the served path gave it and
           K7a at both pre-warm shapes against their plain versions,
           exactly, with their times and bounds; a `serve` JSON line.
13. cluster the cluster backend (--backend=cluster) over phase 7's
           records split into 30 day files under %Y/%m-%d, each output
           held to a file datasource over the same files: (i) the two
           kernel scans of phase 4 through the CLI on the card's own
           mesh (--counters equal, every batch on the device, K1 once
           per batch on host x latency, one K9 merge per batch); (ii)
           the same through the library on a mesh of two shards on the
           one card (K1 twice per batch); (iii) two processes sharing
           the card over gloo (`chip_smoke.py --cluster-child`, killed
           at a deadline): the scans, `build --interval=hour` of phase
           6's metrics (the tree byte-equal to phase 7's), index-scan
           of its first metric over every day (the same lines) and over
           two days (the same bytes), queries (b) and (d) over the
           cluster-built tree; process 0 prints the file backend's
           stdout, process 1 nothing; (iv) the build with a write fault
           planted on process 0: both exit 1 within the deadline.  Per
           leg the walls against the file backend's, K1 launches per
           process, the gloo exchanges' bytes and seconds, the host
           stages, and K9's device ms (CUDA events) against its bound;
           then K9 against its plain version on the largest partials;
           a `cluster` JSON line.
14. sub    standing queries and the fleet view (serve/subscribe.py,
           fleet.py, top.py, obs/history.py): phase 13's day files and a
           copy of phase 7's trees behind a datasource, served on the
           card as in phase 12 (plus DN_METRICS_HISTORY_S=1); 8
           subscribers on query (b), 1 on (d) and a `watch: fleet`
           group, each seed frame equal to a `query --remote` poll;
           500,000 records of the two hours after the month in a new
           day file, built through `build --remote --interval=hour`
           bounded to those hours (two new hour shards; K1 once per
           stacked batch; the write hook fires), then 200,000 more
           built by a separate `python -m dragnet_tpu_torch build`
           (caught by the revalidation tick); after each, every
           subscriber's frame equal to a served poll (K7), one
           recompute per group, 2 shards folded and the rest reused,
           the push latency from the publish (the write hook; the
           catalog's mtime for the other process) to receipt; the
           pusher thread never on a device entry (K1, K7's fold, the
           residency pins); `dn subscribe --frames 2`, `dn top --once`
           (members 1/1 up, the residency row), `stats --cluster
           --prom` (dn_fleet_*), the `history` section's qps series;
           the drain's `end` frame on every stream and device memory
           back within 16 MiB of its level before the server; a
           `subscribe` JSON line.
15. scl    the serve cluster (serve/topology.py, router.py,
           coordinator.py, rebalance.py, scrub.py): members a, b, c in
           this process on the card (DN_ENGINE=jax, the pre-warm on,
           residency off), each over a private copy of phase 7's trees
           through its topology entry's dragnetrc, partitions [a,b],
           [b,c], [c,a], the disk reading pinned (DN_DISK_SIM_FILE, the
           governor's mode printed).  (i) phase 7's queries (a)-(e)
           through each member as router: stdout = phase 7's, and
           --counters phase 7's from `Index List` on (the walk runs on
           the members); the routed p50 of (b) and (d) beside phase
           12's served p50; (ii) each member's pre-warm (K7a at both
           shapes), the K1 scan of phase 4 through each (= phase 4, K1
           once per device batch), and 300,000 records of a shared
           datasource built through `b` (`build --remote`, K1 counted);
           (iii) b stopped: (a)-(e) through a still equal (failovers
           counted); c stopped too: DN_ROUTER_PARTIAL=error answers rc 1
           naming partition 1, and a restarted with =allow answers rc 0
           flagged partial; (iv) d joins with an empty tree and takes
           partition 2 (`begin_transition`, its pull, `wait_ready`,
           `commit`): its shards byte-equal to the donors', the shards
           and bytes pulled and their time printed, epoch 2 on all
           four, (a)-(e) through d equal; (v) under DN_VERIFY=open a
           byte of one of a's hour shards flipped: (b) through a still
           equal (a corrupt failover), the repair lands a shard
           byte-equal to b's, `dn scrub --remote` finds 0 corrupt and 0
           missing, `dn quarantine list` shows the forensics; (vi) a
           standing query (b) on the shared datasource through a: its
           seed = a routed poll, and 100,000 records published through
           a give 1 recompute and 1 frame = the routed poll; (vii) `dn
           top --once` shows members 4/4 up, `stats --cluster` every
           member; (viii) the drain: the stream's `end` frame, device
           memory back within 16 MiB; a `serve_cluster` JSON line.
16. devb   the kernel-resident microbenchmark (devbench.kernel_bench)
           over the first scan batch (65,536 records) of phase 3's
           file, for bench.py's QUERY (32,768 segments: K2's dense
           atomics) and PALLAS_QUERY (256: K2's fused key, then K1), 32
           folds each: K2 launching once per fold of the resident loop
           on both, K1 once per fold on PALLAS_QUERY and never on
           QUERY, the resident accumulator equal to 33 plain folds of
           the batch (scan_body_ref with index_add_, on the card),
           bound_share (the reference's bytes at 3.35 TB/s over the
           measured ms) below 1.05; each leg again under
           DN_BENCH_TRACE, whose torch.profiler trace must hold exactly
           K2 and K1 (PALLAS_QUERY) or K2 alone (QUERY) as each fold's
           device kernels; device memory back to its level.  Prints per
           leg the resident ms per batch (host clock and CUDA events),
           H2D through the staging ring, D2H, the reupload contrast;
           from each trace, the device kernels a fold runs and their
           time; and a `devbench` JSON line.
10. main   the kernel again, on the fused keys the main path gave it:
   keys    the largest batch of each kernel query at each segment count
           (the time window, and with it the accumulator, grows during
           the timestamp query), captured in phase 4.
11. result the card's name and power limit (nvidia-smi), a `kernels`
           JSON line (per kernel: launches on the main path, the build,
           K2's launches and folds per phase,
           the query phase, the eager auto runs, the follow rounds,
           the served path, phases 13, 14 and 15, phase 16's resident
           loops, times, bound; K7,
           K7a and K9,
           torch ops that replace the reference's jitted XLA programs,
           with theirs),
           and as the last line {"ok": true, "device": {...}}.

Without CUDA, or without the rest of the repository beside it, the
script exits non-zero and prints no result.
"""

import argparse
import calendar
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12      # H100 SXM: half the 67 TFLOP/s fp32 rate

DEVICE = 'cuda'
# K2's launches on the main path (phase 4), counted from zero there
BODY_LAUNCHES = {}
KERNEL_SOURCE = 'dragnet_tpu_torch/ops/csrc/onehot_agg.cu'
KERNEL_REPLACES = 'dragnet_tpu/ops/pallas_kernels.py:102'

PALLAS_SHAPES = [((8, 64), 1000), ((3, 5, 7), 4096), ((513,), 700),
                 ((8, 16, 32), 8192)]
COLD_RECORDS = 20000

# one batch with each kernel query's staged caps, unit weights (as the
# main path calls it)
SLICE_SHAPES = [((8, 32), 65536), ((256, 16), 65536)]

# the main path's batch (16 MiB reads of ~225-byte records) and every
# segment count the gate sends to the kernel
BATCH_RECORDS = 74800
SWEEP_SEGMENTS = [256, 512, 1024, 2048, 4096]
# one call at the bound-share shape: unit weights keep the total < 2^24;
# the keys rotate over copies larger than the 50 MB L2 cache
LARGE_RECORDS = 2000000
LARGE_SEGMENTS = 4096
L2_BYTES = 50 << 20
# phase 6b: device work added after each fold of the K1 query to make
# the device the slower side (torch.cuda._sleep, SM clock cycles: about
# 60 ms at 1.98 GHz, three times the ~20-30 ms of host work a batch; at
# 20 ms the device was the slower side on some hosts and not on others)
BUSY_CYCLES = 120 * 1000 * 1000

# (name, scan arguments, expected route): the large-scan query of the
# repository's benchmark, its small-accumulator query, and the synthetic
# date column with the time masks
QUERIES = [
    ('host x method x operation x latency',
     ['-b', 'host,req.method,operation,latency[aggr=quantize]',
      '-f', '{"ne": ["res.statusCode", 599]}'], 'scatter'),
    ('host x latency',
     ['-b', 'host,latency[aggr=quantize]'], 'kernel'),
    ('timestamp(60s) x statusCode >= 500',
     ['-b', 'timestamp[field=time,date,aggr=lquantize,step=60],'
      'res.statusCode', '-f', '{"ge": ["res.statusCode", 500]}'],
     'kernel'),
]


# phase 5: (name, scan arguments, expected routes).  The first is the
# per-minute breakdown that passes the 2^24 dense budget once its time
# window passes 128 minutes; its time-window epochs hold at most ~710k
# records each (every window growth flushes), too few uniques to fill
# the set.  Its nspillrecords counter differs from the host engine's
# where the reference documents it (DeviceScan._build_static): the
# host decides dense vs sparse per batch on the exact radices (and
# spills any batch whose key space passes 4x its rows), the device on
# pow2 caps against 2^24.  The second has no time window and passes
# 2^24 either way: one epoch of 2M records and ~1.8M unique tuples, so
# the guard must grow the set.
SPARSE_QUERIES = [
    ('timestamp(60s) x host x url x latency',
     ['-b', 'timestamp[field=time,date,aggr=lquantize,step=60],host,'
      'req.url,latency[aggr=quantize]'], 'dense then sparse'),
    ('host x url x op x method x status x lat x dlat',
     ['-b', 'host,req.url,operation,req.method,res.statusCode,'
      'latency[aggr=quantize],dataLatency[aggr=quantize]'],
     'sparse, grows'),
]
SPARSE_BENCH_CAPS = [1 << 20, 1 << 22]

# phase 6: (metric, breakdowns, fold route at --interval=hour, where
# the hourly __dn_ts key is prepended)
# phase 6's index-scan window (all 180 minutes until phase 15 needed
# the time)
INDEX_SCAN_MINUTES = 20
BUILD_METRICS = [
    ('byhour', 'timestamp[field=time,date,aggr=lquantize,step=3600],host',
     'kernel'),
    ('requests', 'timestamp[field=time,date,aggr=lquantize,step=60],'
     'req.method,res.statusCode,latency[aggr=quantize]', 'index_add'),
    ('byurl', 'timestamp[field=time,date,aggr=lquantize,step=60],host,'
     'req.url,latency[aggr=quantize]', 'sparse'),
]

# phase 7: the records spread over 30 days from 2014-05-01 UTC, and
# (name, query arguments, the aggregation route expected on the card).
# Each resolves to one of BUILD_METRICS (find_metric takes the first
# that covers the breakdowns and the filter's fields): byurl, requests,
# requests, byurl and byhour.
QUERY_MIN_MS = 1398902400000
QUERY_DAYS = 30
QUERY_CASES = [
    ('a host x url, day', ['-b', 'host,req.url', '--interval=day'],
     'device'),
    ('b method x status >= 500, hour',
     ['-b', 'req.method,res.statusCode', '-f',
      '{"ge":["res.statusCode",500]}', '--interval=hour'], 'device'),
    ('c (b) over one week, hour',
     ['-b', 'req.method,res.statusCode', '-f',
      '{"ge":["res.statusCode",500]}', '--interval=hour',
      '--after', '2014-05-08', '--before', '2014-05-15'], 'device'),
    ('d host x url x latency, hour',
     ['-b', 'host,req.url,latency[aggr=quantize]', '--interval=hour'],
     'device'),
    ('e no breakdowns, hour', ['--interval=hour'], 'host: no breakdowns'),
]
# phase 8: auto's constants for the eager runs (the tests' values:
# escalate after 1,024 records, no accelerator requirement, no
# remaining-time bar, margin 0), and the phase 7 queries it runs
AUTO_EAGER = {'ESCALATE_RECORDS': 1024, 'REQUIRE_ACCELERATOR': False,
              'MIN_REMAINING_SECONDS': 0.0, 'UNKNOWN_SIZE_RECORDS': 0,
              'SHADOW_MARGIN': 0.0}
AUTO_QUERY_CASES = ('a', 'd')
# phase 9: the byte lane.  Buffer lengths of the kernel check (and of
# tests/test_torch_byteparse.py), the quote densities at each, the
# per-record runs' size, and the parse block the round trip is timed at
# (the largest block byteparse.ByteParser.parse passes whole)
PARITY_LENGTHS = [0, 1, 7, 8, 9, 31, 32, 33, 1 << 19, (1 << 19) + (1 << 17),
                  (1 << 20) - 1, 1 << 20, (1 << 20) + 1]
PARITY_DENSITIES = [0.0, 0.001, 0.05, 0.5, 1.0]
PARSE_SMALL_RECORDS = 200000
PARSE_BLOCK = (1 << 19) + (1 << 17)
PARITY_SOURCE = 'dragnet_tpu_torch/ops/csrc/quote_parity.cu'
# a build the byte lane can project (flat paths only; BUILD_METRICS read
# req.method, res.statusCode and req.url)
FLAT_METRICS = [
    ('byhour', 'timestamp[field=time,date,aggr=lquantize,step=3600],host'),
    ('bylatency', 'timestamp[field=time,date,aggr=lquantize,step=60],host,'
     'operation,latency[aggr=quantize]'),
]
PARITY_REPLACES = 'dragnet_tpu/ops/byteparse_kernels.py:94'
# phase 9b: `dn follow` of the N records in LIFECYCLE_ROUNDS appends,
# each mini-batch cut by the byte budget (a large latency target: with
# DN_FOLLOW_LATENCY_MS=0 every 1 MiB poll of the tailer would be its own
# batch), about one device batch each; the rewrite-mode run over the
# first LIFECYCLE_REWRITE_RECORDS, the device fault over the first
# LIFECYCLE_FAULT_RECORDS (its third mini-batch fails), and the queries
# held between the follow tree and phase 9's build
LIFECYCLE_ROUNDS = 4
LIFECYCLE_REWRITE_RECORDS = 500000
LIFECYCLE_FAULT_RECORDS = 300000
LIFECYCLE_FAULT_BATCH = 3
FOLLOW_KNOBS = {'DN_ENGINE': 'jax', 'DN_FOLLOW_MAX_BYTES': str(16 << 20),
                'DN_FOLLOW_LATENCY_MS': '600000', 'DN_FOLLOW_POLL_MS': '5',
                # the disk watermarks of a scratch run on a shared host
                # (the defaults, 10 % and 5 % free, would pause the
                # publishes of a test machine whose disk is nearly full)
                'DN_DISK_LOW_PCT': '1', 'DN_DISK_CRITICAL_PCT': '0.5'}
LIFECYCLE_QUERIES = [
    ('host', ['-b', 'host']),
    ('host x operation, latency >= 100',
     ['-b', 'host,operation', '-f', '{"ge":["latency",100]}']),
]
# phase 12: the served path.  Query (b) is timed LATENCY_REPEATS times
# on a server with residency and on one without, and COLD_REPEATS times
# in a fresh process (each pays the interpreter, torch and CUDA start-up,
# so fewer; 30 and 3 until phase 15 needed the time);
# CONCURRENT_CLIENTS threads each send two requests;
# after the drain, device memory may stay above its level before the
# server by at most one scan batch's accumulators (8,396,912 B for phase
# 9b's flat metrics on an H100), rounded up
LATENCY_REPEATS = 5
COLD_REPEATS = 1
CONCURRENT_CLIENTS = 8
DRAIN_SLACK_BYTES = 16 << 20
K7_REPLACES = 'dragnet_tpu/device_index.py:257'
K7A_REPLACES = 'dragnet_tpu/index_query_stack.py:416'
# K7's least traffic: each row's local code and weight (16 B), each
# translation entry (8 B), each accumulator segment read and written
# (16 B)
K7_ROW_BYTES, K7_TAB_BYTES, K7_SEG_BYTES = 16, 8, 16
# phase 16: the kernel-resident microbenchmark's two legs, bench.py's
# QUERY (8*8*16*32 = 32,768 segments, past K1's gate: index_add_) and
# PALLAS_QUERY (8*32 = 256 segments: K1), with whether K1 carries each,
# over the first scan batch of phase 3's file; the symbol a trace of
# the K1 leg must name
DEVBENCH_LEGS = [
    ('QUERY', {'breakdowns': [{'name': 'host'}, {'name': 'req.method'},
                              {'name': 'operation'},
                              {'name': 'latency', 'aggr': 'quantize'}],
               'filter': {'ne': ['res.statusCode', 599]}}, False),
    ('PALLAS_QUERY', {'breakdowns': [{'name': 'host'},
                                     {'name': 'latency',
                                      'aggr': 'quantize'}]}, True),
]
DEVBENCH_ITERS = 32
K1_SYMBOL = 'onehot_into_kernel'
# phase 3b: the scan program K2 (ops/csrc/scan_body.cu), which replaces
# the reference's jitted per-batch program (jax.jit of `fold` ->
# `run_body` -> `body`), held against its plain version on real batches
BODY_SOURCE = 'dragnet_tpu_torch/ops/csrc/scan_body.cu'
BODY_REPLACES = 'dragnet_tpu/device_scan.py:2069'
K2_SYMBOL = 'scan_body_kernel'
TS_60 = {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 60}
LAT_Q = {'name': 'latency', 'aggr': 'quantize'}
MAIN_DS_FILTER = {'ne': ['host', 'zzz']}
# a filter over every leaf kind (string tables, numeric eq/ne/lt/le/gt/
# ge, NaN, +-Infinity and beyond-i32 constants, booleans, strings
# compared as numbers), and/or nested 4 deep, over records holding every
# tag kind, bad dates, time bounds, signed weights, a host-translated key
# (code: numbers and strings), kvalid (latency: numbers and strings) and
# linear buckets over negative values
EDGE_QUERY = {
    'timeAfter': '2014-05-01T06:00:00Z', 'timeBefore': '2014-05-03T12:00:00Z',
    'breakdowns': [dict(TS_60, step=3600), {'name': 'code'},
                   {'name': 'delta', 'aggr': 'lquantize', 'step': 7},
                   LAT_Q],
    'filter': {'or': [
        {'and': [{'or': [{'eq': ['host', 'a']}, {'eq': ['host', True]},
                         {'and': [{'eq': ['host', 17]},
                                  {'ne': ['code', '500']}]}]},
                 {'ne': ['latency', 'abc']},
                 {'lt': ['latency', 'Infinity']}]},
        {'and': [{'ge': ['latency', 16.5]},
                 {'or': [{'le': ['code', '404']},
                         {'eq': ['req.method', 'GET']},
                         {'gt': ['latency', -1e20]}]}]},
        {'and': [{'eq': ['latency', 'abc']}, {'ge': ['latency', '-Infinity']},
                 {'le': ['latency', 3e9]}]}]}}
# (name, query, time field, datasource filter, signed weights, the
# generated edge records instead of phase 3's file)
BODY_CASES = [
    ('QUERY', DEVBENCH_LEGS[0][1], None, MAIN_DS_FILTER, False, False),
    ('PALLAS_QUERY', DEVBENCH_LEGS[1][1], None, MAIN_DS_FILTER, False,
     False),
    ('timestamp(60s) x statusCode >= 500',
     {'breakdowns': [TS_60, {'name': 'res.statusCode'}],
      'filter': {'ge': ['res.statusCode', 500]}}, 'time', MAIN_DS_FILTER,
     False, False),
    ('timestamp(60s) x host x url x latency',
     {'breakdowns': [TS_60, {'name': 'host'}, {'name': 'req.url'}, LAT_Q]},
     'time', MAIN_DS_FILTER, False, False),
    ('host x url x op x method x status x lat x dlat',
     {'breakdowns': [{'name': 'host'}, {'name': 'req.url'},
                     {'name': 'operation'}, {'name': 'req.method'},
                     {'name': 'res.statusCode'}, LAT_Q,
                     {'name': 'dataLatency', 'aggr': 'quantize'}]},
     None, MAIN_DS_FILTER, False, False),
    ('build requests (hour key)',
     {'breakdowns': [dict(TS_60, name='hour', step=3600), TS_60,
                     {'name': 'req.method'}, {'name': 'res.statusCode'},
                     LAT_Q]}, 'time', None, False, False),
    ('every leaf kind, signed weights', EDGE_QUERY, 'time', None, True,
     True),
]


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit('chip_smoke: FAILED: %s' % msg)


def cuda_time_ms(fn, reps):
    """(device ms, eager ms) per call of fn.  Device time: reps calls
    captured in one CUDA graph and replayed between CUDA events, so the
    host's per-call Python and launch cost is not counted.  Eager time:
    the same calls issued one by one, as a caller issues them."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / reps
    del graph
    return device, eager


def kernel_inputs(radices, n, seed, unit_weights):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, r, n)
                      for r in radices]).astype(np.int32)
    w = None if unit_weights else rng.integers(-3, 10, n).astype(np.int32)
    alive = rng.random(n) < 0.9
    dev = torch.device(DEVICE)
    return (torch.from_numpy(codes).to(dev),
            None if w is None else torch.from_numpy(w).to(dev),
            torch.from_numpy(alive).to(dev))


def fused_keys(kind, ns, n, seed=1):
    """i32 fused keys [n] with dead rows at ns, as the device scan gives
    them: 'uniform' (10 % dead), 'one bin' (every live row on one bin,
    the worst contention), or 'linear ts' (a timestamp(60s) x
    statusCode batch: linear timestamps put ~7 minutes in one batch, so
    a warp's records share one or two minute buckets; 7 status codes,
    4 of them dead under the >= 500 filter)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if kind == 'uniform':
        keys = rng.integers(0, ns, n)
        keys[rng.random(n) < 0.1] = ns
    elif kind == 'one bin':
        keys = np.full(n, ns // 3)
        keys[rng.random(n) < 0.1] = ns
    else:
        minute = np.arange(n) * 7 // max(n, 1)
        code = rng.integers(0, 7, n)
        keys = np.where(code < 4, ns, (minute * 16 + code) % ns)
    return torch.from_numpy(keys.astype(np.int32)).to(DEVICE)


def kernel_bound_ms(radices, n, weighted):
    """Least time for the codes entry: its bytes (codes, weights, alive
    read once; the i64 output written once) over the memory rate, or its
    integer operations (a multiply-add per column and a compare per
    record) over the int32 rate, whichever is larger."""
    ns = 1
    for r in radices:
        ns *= r
    nbytes = n * (4 * len(radices) + (4 if weighted else 0) + 1) + 8 * ns
    nops = n * (2 * len(radices) + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def into_bound_ms(ns, n, key_bytes, weighted):
    """Least time for onehot_dense_into: each fused key (and weight)
    read once, the i64 accumulator read and written once, over the
    memory rate; or a compare and an add per record over the int32
    rate, whichever is larger."""
    nbytes = n * (key_bytes + (4 if weighted else 0)) + 16 * ns
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n / INT32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check_into(ck, label, ns, fused, w, reps, out0=None, copies=1):
    """onehot_dense_into against its plain version on the card at one
    shape, exactly (into a copy of out0, zeros by default), then the
    device and eager times per call of the kernel, the plain version and
    the yardstick: index_add_ of the same fused key (out-of-range rows
    sent to a pad slot) into a preallocated i64 accumulator.  With
    copies > 1 the calls cycle over that many copies of the keys, so
    they find them out of L2 as a cold caller would."""
    import itertools
    import torch
    dev = fused.device
    if out0 is None:
        out0 = torch.zeros(ns, dtype=torch.int64, device=dev)
    got = ck.onehot_dense_into(out0.clone(), fused, w)
    want = ck.onehot_dense_into_ref(out0.clone(), fused, w)
    torch.cuda.synchronize()
    n = fused.shape[0]
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          'one-hot kernel differs from its plain version at %s, %d '
          'segments x %d (max abs err %d)' % (label, ns, n, err))
    keys = [fused] + [fused.clone() for _ in range(copies - 1)]
    idx = [torch.where((k >= 0) & (k < ns), k, ns) for k in keys]
    src = torch.ones(n, dtype=torch.int64, device=dev) if w is None \
        else w.to(torch.int64)
    out = torch.zeros(ns, dtype=torch.int64, device=dev)
    pad = torch.zeros(ns + 1, dtype=torch.int64, device=dev)
    k_it, i_it = itertools.cycle(keys), itertools.cycle(idx)
    t_kernel, e_kernel = cuda_time_ms(
        lambda: ck.onehot_dense_into(out, next(k_it), w), reps)
    t_plain, e_plain = cuda_time_ms(
        lambda: ck.onehot_dense_into_ref(out, next(k_it), w), reps)
    t_lib, e_lib = cuda_time_ms(
        lambda: pad.index_add_(0, next(i_it), src), reps)
    bound, bound_by = into_bound_ms(ns, n, fused.element_size(),
                                    w is not None)
    log('kernel onehot_dense_into %-24s %4d x %7d  exact  device ms: '
        'kernel %.4f plain %.4f index_add_ %.4f  (eager per call: %.4f '
        '%.4f %.4f)  bound %.6f ms (%s), %.1f %% of it'
        % (label, ns, n, t_kernel, t_plain, t_lib, e_kernel, e_plain,
           e_lib, bound, bound_by, 100 * bound / t_kernel))
    return {'keys': label, 'ns': ns, 'n': n, 'max_abs_err': err,
            'weighted': w is not None, 'key_bytes': fused.element_size(),
            'ms': t_kernel, 'plain_ms': t_plain, 'library_ms': t_lib,
            'bound_ms': bound, 'bound_by': bound_by,
            'bound_share': bound / t_kernel, 'eager_ms': e_kernel,
            'eager_plain_ms': e_plain, 'eager_library_ms': e_lib}


def check_kernel(ck, radices, n, unit_weights, reps, seed=1):
    """The codes entry (onehot_dense: fuse, zero-fill, kernel) against
    its plain version on the card at one shape, exactly, with its own
    times; then the kernel itself on the same fused key (check_into)."""
    import torch
    codes, w, alive = kernel_inputs(radices, n, seed, unit_weights)
    got = ck.onehot_dense(radices, codes, w, alive)
    want = ck.onehot_dense_ref(radices, codes, w, alive)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          'one-hot kernel differs from its plain version at %r x %d '
          '(max abs err %d)' % (radices, n, err))
    ns = got.shape[0]
    t_entry, e_entry = cuda_time_ms(
        lambda: ck.onehot_dense(radices, codes, w, alive), reps)
    bound, bound_by = kernel_bound_ms(radices, n, w is not None)
    log('entry onehot_dense %-14s x %6d  exact  device ms %.4f  eager '
        'per call %.4f  bound %.6f ms (%s)'
        % (str(tuple(radices)), n, t_entry, e_entry, bound, bound_by))
    from dragnet_tpu_torch.ops.kernels import fuse_keys
    fused = torch.where(alive, fuse_keys(radices, codes), ns).to(
        torch.int32)
    r = check_into(ck, 'codes %s' % (tuple(radices),), ns, fused, w,
                   reps)
    r.update({'radices': list(radices), 'entry_ms': t_entry,
              'eager_entry_ms': e_entry, 'entry_bound_ms': bound,
              'max_abs_err': max(err, r['max_abs_err'])})
    return r


def kernel_sweep(ck, reps):
    """Phase 2 beyond the reference's shapes: the main path's batch size
    over every segment count the gate allows, skewed and uniform; n = 0
    and 1; signed weights and i64 keys into a non-zero accumulator; and
    the 2,000,000-record call."""
    import numpy as np
    import torch
    results = []
    for ns in SWEEP_SEGMENTS:
        for kind in ('uniform', 'linear ts', 'one bin'):
            results.append(check_into(
                ck, kind, ns, fused_keys(kind, ns, BATCH_RECORDS), None,
                reps))
    for n in (0, 1):
        for ns in (SWEEP_SEGMENTS[0], SWEEP_SEGMENTS[-1]):
            results.append(check_into(
                ck, 'uniform', ns, fused_keys('uniform', ns, n), None,
                reps))
    rng = np.random.default_rng(4)
    ns = SWEEP_SEGMENTS[-1]
    out0 = torch.from_numpy(rng.integers(-1 << 40, 1 << 40, ns)).to(DEVICE)
    w = torch.from_numpy(rng.integers(-3, 10, BATCH_RECORDS).astype(
        np.int32)).to(DEVICE)
    keys = torch.from_numpy(rng.integers(-5, ns + 5, BATCH_RECORDS)).to(
        DEVICE)
    results.append(check_into(ck, 'i64 signed, out != 0', ns, keys, w,
                              reps, out0=out0))
    results.append(check_into(ck, 'i32 signed, out != 0', ns,
                              keys.to(torch.int32), w, reps, out0=out0))
    large = fused_keys('uniform', LARGE_SEGMENTS, LARGE_RECORDS)
    copies = 1 + L2_BYTES // (4 * LARGE_RECORDS)
    results.append(check_into(ck, 'uniform, L2-cold', LARGE_SEGMENTS,
                              large, None, reps, copies=copies))
    results[-1]['floors'] = floors(large, copies, reps)
    del large
    torch.cuda.synchronize()
    return results


def floors(keys, copies, reps):
    """Device ms per call of two floors under the kernel's times: any
    launch (add_ on a 4,096-element i64 tensor), and a copy of the keys
    cycling over `copies` copies as check_into cycles them (out of L2),
    beside that copy's own bound."""
    import itertools
    import torch
    small = torch.zeros(4096, dtype=torch.int64, device=keys.device)
    t_launch, _ = cuda_time_ms(lambda: small.add_(1), reps)
    k_it = itertools.cycle([keys] + [keys.clone()
                                     for _ in range(copies - 1)])
    dst = torch.empty_like(keys)
    t_copy, _ = cuda_time_ms(lambda: dst.copy_(next(k_it)), reps)
    copy_bound = 2 * keys.numel() * keys.element_size() / \
        HBM_BYTES_PER_S * 1e3
    log('floors: a launch (add_ on 4,096 i64) %.4f ms; a copy of the %d '
        'L2-cold keys %.4f ms (its bound %.4f ms)'
        % (t_launch, keys.numel(), t_copy, copy_bound))
    return {'launch_ms': t_launch, 'copy_ms': t_copy,
            'copy_bound_ms': copy_bound}


def host_costs(ck, calls=2000):
    """The wrapper's stream lookup: the private raw handle it passes
    must equal torch.cuda.current_stream's, on the default stream and
    on a side stream; then the host ms per call of each lookup (host
    clock, `calls` calls)."""
    import torch
    dev = torch.device(DEVICE, torch.cuda.current_device())
    for s in (torch.cuda.current_stream(dev), torch.cuda.Stream(dev)):
        with torch.cuda.stream(s):
            check(ck.current_stream_handle(dev.index) == s.cuda_stream ==
                  torch.cuda.current_stream(dev).cuda_stream,
                  'the raw stream handle differs from '
                  'torch.cuda.current_stream')
    times = {}
    for name, fn in (
            ('current_stream', lambda: torch.cuda.current_stream(
                dev).cuda_stream),
            ('raw handle', lambda: ck.current_stream_handle(dev.index))):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times[name] = (time.perf_counter() - t0) / calls * 1e3
    log('stream lookup, host ms per call: torch.cuda.current_stream '
        '%.4f, raw handle %.4f (the same handle)'
        % (times['current_stream'], times['raw handle']))
    return times


def run_cli(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def host_output(cli, argv, ds):
    """The same CLI output, rendered from the port's host engine."""
    opts = cli.dn_parse_args(argv[1:], ['before', 'after', 'filter',
                                        'breakdowns', 'raw', 'points',
                                        'counters', 'gnuplot'])
    query = cli.dn_query_config(opts)
    result = ds.scan(query, engine='vector')
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.dn_output(query, opts, result, opts._args[0])
    return out.getvalue(), err.getvalue()


def main_path(cli, mod_ds, ck, ds, records):
    """Phase 4: the three scans through the CLI on DN_TORCH_DEVICE, with
    the batch and launch counts zeroed just before and read just after,
    then the same outputs from the host engine.  Returns the kernel
    shapes the main path used, a copy of the fused keys of each kernel
    query's largest batch at each segment count, and the launch
    count."""
    import torch
    # 4. the main path: counters zeroed just before, read just after
    batches = {'total': 0, 'device': 0}
    shapes = []
    captured = {}
    current = [None]
    orig_try = mod_ds.DeviceScan._try_device
    orig_kernel = ck.onehot_dense_into

    def try_device(self, provider, weights, alive):
        ok = orig_try(self, provider, weights, alive)
        batches['total'] += 1
        batches['device'] += int(ok)
        return ok

    def onehot_dense_into(out, fused, weights):
        ns, n = int(out.shape[0]), int(fused.shape[0])
        shapes.append((ns, n, weights is not None))
        best = captured.get((current[0], ns))
        if best is None or n > best[0].shape[0]:
            captured[(current[0], ns)] = (fused.clone(), weights)
        return orig_kernel(out, fused, weights)
    mod_ds.DeviceScan._try_device = try_device
    ck.onehot_dense_into = onehot_dense_into

    ck.reset_launches()
    per_query = []
    t_main = time.monotonic()
    for name, qargs, route in QUERIES:
        argv = ['scan', '--points', '--counters'] + qargs + ['muskie']
        current[0] = name
        b0 = dict(batches)
        l0 = ck.launches['onehot_dense']
        k0 = ck.launches['scan_body']
        s0 = len(shapes)
        t0 = time.monotonic()
        rc, out, err = run_cli(cli, argv)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        check(rc == 0, '%s: scan failed: %s' % (name, err))
        nb = batches['total'] - b0['total']
        nd = batches['device'] - b0['device']
        nl = ck.launches['onehot_dense'] - l0
        nk2 = ck.launches['scan_body'] - k0
        segs = sorted(set(s[0] for s in shapes[s0:]))
        per_query.append((name, route, argv, out, err, dt, nb, nd, nl))
        log('scan %-36s %8.2f s  %11.0f records/s  batches %d '
            '(device %d)  K2 launches %d  kernel launches %d  kernel '
            'segments %s' % (name, dt, records / dt, nb, nd, nk2, nl, segs))
        check(nb > 0 and nd == nb,
              '%s: %d of %d batches ran on the device' % (name, nd, nb))
        check(nk2 == nd, '%s: the scan program launched %d times for %d '
              'device batches' % (name, nk2, nd))
        if route == 'kernel':
            check(nl == nb, '%s: kernel launched %d times for %d '
                  'batches (segments %s)' % (name, nl, nb, segs))
        else:
            check(nl == 0, '%s: expected the scatter path, the kernel '
                  'launched %d times' % (name, nl))
    main_launches = ck.launches['onehot_dense']
    BODY_LAUNCHES['main'] = ck.launches['scan_body']
    main_s = time.monotonic() - t_main
    forced = {q[0]: (q[3], q[4], q[5]) for q in per_query}
    mod_ds.DeviceScan._try_device = orig_try
    ck.onehot_dense_into = orig_kernel
    log('main path: %.2f s, scan program launches %d, one-hot kernel '
        'launches %d' % (main_s, BODY_LAUNCHES['main'], main_launches))

    # the same outputs from the port's host engine
    for name, route, argv, out, err, dt, nb, nd, nl in per_query:
        t0 = time.monotonic()
        hout, herr = host_output(cli, argv, ds)
        ht = time.monotonic() - t0
        check(out == hout and err == herr,
              '%s: device output differs from the host engine' % name)
        check(out.count('\n') > 0 and 'Aggregator' in err,
              '%s: empty result' % name)
        log('host %-36s %8.2f s  %11.0f records/s  identical output '
            '(%d points)' % (name, ht, records / ht,
                             out.count('\n')))
    return shapes, captured, main_launches, forced


class Spy(object):
    """Wraps attributes for the length of a phase and restores them."""

    def __init__(self):
        self.saved = []

    def wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self.saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def restore(self):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)
        self.saved = []


class Timers(object):
    """Exclusive host-clock seconds per label over wrapped calls (a
    timed call inside another is taken out of the outer's time)."""

    def __init__(self):
        self.t = {}
        self._stack = []

    def wrap(self, spy, owner, name, label):
        def make(orig):
            def timed(*a, **k):
                t0 = time.perf_counter()
                self._stack.append(0.0)
                try:
                    return orig(*a, **k)
                finally:
                    inner = self._stack.pop()
                    dt = time.perf_counter() - t0
                    self.t[label] = self.t.get(label, 0.0) + dt - inner
                    if self._stack:
                        self._stack[-1] += dt
            return timed
        spy.wrap(owner, name, make)

    def take(self, total):
        """The seconds per label, the rest of `total` under 'rest',
        and reset."""
        out = dict(self.t)
        out['rest'] = total - sum(self.t.values())
        self.t = {}
        return out


def fmt_times(times, digits=2):
    return ', '.join('%s %.*f' % (k, digits, v) for k, v in sorted(
        times.items(), key=lambda kv: -kv[1]))


def sparse_fold_bench(mod_ds, reps):
    """The sparse fold alone on the card at each SPARSE_BENCH_CAPS
    capacity, the set as full as the guard lets it get (cap - n occupied
    slots) and one main-path batch of n keys already in the set (10 %
    dead), so repeated folds keep its size: device ms per fold (CUDA
    events over `reps` folds), and the ms of its sort (argsort of the
    occupied prefix plus the batch) alone."""
    import torch
    dev = torch.device(DEVICE)
    n = BATCH_RECORDS
    out = []
    g = torch.Generator(device=dev).manual_seed(5)
    for cap in SPARSE_BENCH_CAPS:
        occ = cap - n
        keys = torch.sort(torch.randperm(4 * cap, device=dev,
                                         generator=g)[:occ]).values
        acc = (torch.full((cap,), mod_ds.I64MAX, dtype=torch.int64,
                          device=dev),
               torch.zeros(cap, dtype=torch.int64, device=dev),
               torch.full((cap,), mod_ds.I64MAX, dtype=torch.int64,
                          device=dev),
               torch.zeros(8, dtype=torch.int64, device=dev),
               torch.zeros(2, dtype=torch.int64, device=dev))
        acc[0][:occ] = keys
        acc[1][:occ] = 1
        acc[2][:occ] = torch.arange(occ, device=dev)
        pick = torch.randint(0, occ, (n,), device=dev, generator=g)
        fused = keys[pick]
        dead = torch.rand(n, device=dev, generator=g) < 0.1
        fused[dead] = mod_ds.I64MAX
        wb = (~dead).to(torch.int64)
        first = torch.where(dead, mod_ds.I64MAX,
                            torch.arange(n, device=dev) + (1 << 32))
        cvec = torch.zeros(8, dtype=torch.int32, device=dev)
        state = [acc]

        def fold():
            state[0] = mod_ds.fold_sparse(state[0], cvec, fused, wb,
                                          first, occupied=occ)
        concat = torch.cat([keys, fused])
        t_fold, _ = cuda_time_events(fold, reps)
        t_sort, _ = cuda_time_events(lambda: torch.argsort(concat), reps)
        st = state[0][4].cpu().tolist()
        check(st == [occ, 0], 'sparse fold bench: the set changed size '
              '(%r, expected [%d, 0])' % (st, occ))
        nbytes = 8 * 3 * (occ + n) * 2
        log('sparse fold at %d slots (%d occupied + %d batch keys): '
            '%.4f ms per fold, its sort %.4f ms (%.0f %%); %.0f MB '
            'moved at least (%.4f ms at %.2f TB/s)'
            % (cap, occ, n, t_fold, t_sort, 100 * t_sort / t_fold,
               nbytes / 1e6, nbytes / HBM_BYTES_PER_S * 1e3,
               HBM_BYTES_PER_S / 1e12))
        out.append({'cap': cap, 'occupied': occ, 'n': n,
                    'fold_ms': t_fold, 'sort_ms': t_sort})
        del state, acc, keys, concat
    torch.cuda.synchronize()
    return out


def cuda_time_events(fn, reps):
    """(device ms, host ms) per call of fn, issued eagerly: CUDA events
    around `reps` calls after a warm-up (for work a CUDA graph cannot
    capture: host-side shape logic, in-place state)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / reps
    return start.elapsed_time(end) / reps, host


def without_spill(what, dev_err, host_err, sparse_rows):
    """The --counters dumps without the one counter the reference
    documents as differing (DeviceScan._build_static): the host engine
    spills a batch to its sort merge on its own per-batch decision,
    the device turns sparse on pow2 caps against 2^24.  The device's
    count is pinned exactly: every record its sparse batches
    aggregated (nothing is filtered out in these runs)."""
    spill = 'Aggregator         nspillrecords:%8d\n' % sum(sparse_rows)
    check(spill in dev_err, '%s: expected %r' % (what, spill))
    dev_err = dev_err.replace(spill, '', 1)
    check('nspillrecords' not in dev_err,
          '%s: a second spill count on the device' % what)
    host_err = ''.join(ln for ln in host_err.splitlines(True)
                       if 'nspillrecords' not in ln)
    return dev_err, host_err


def sparse_phase(cli, mod_ds, ds, records):
    """Phase 5: the SPARSE_QUERIES through the CLI on the card, counts
    zeroed just before each and read just after, each held to the host
    engine's output."""
    import torch
    from dragnet_tpu_torch import datasource_file as mod_dsf
    spy = Spy()
    batches = {'total': 0, 'device': 0}
    routes = []
    sparse_rows = []
    folds = []
    caps = []

    def wrap_try(orig):
        def try_device(self, provider, weights, alive):
            ok = orig(self, provider, weights, alive)
            batches['total'] += 1
            batches['device'] += int(ok)
            return ok
        return try_device

    def wrap_fold(orig):
        def fold(self, *a):
            routes.append('dense')
            return orig(self, *a)
        return fold

    def wrap_fold_sparse(orig):
        def fold_sparse(self, args, n, profile, caps_, occupied, base):
            routes.append('sparse')
            sparse_rows.append(n)
            return orig(self, args, n, profile, caps_, occupied, base)
        return fold_sparse

    def wrap_program(orig):
        def timed(acc, cvec, fused, wb, first_b, occupied=None):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = orig(acc, cvec, fused, wb, first_b, occupied=occupied)
            e.record()
            folds.append((s, e, int(acc[0].shape[0]),
                          int(fused.shape[0]) + (occupied or 0)))
            return out
        return timed

    def wrap_guard(orig):
        def guard(self, n):
            ok = orig(self, n)
            caps.append(self._sparse_cap)
            return ok
        return guard

    def wrap_scan(orig):
        def scan(self, *a, **k):
            t0 = time.monotonic()
            rv = orig(self, *a, **k)
            scan_times.append(time.monotonic() - t0)
            return rv
        return scan
    scan_times = []
    spy.wrap(mod_dsf.DatasourceFile, 'scan', wrap_scan)
    # where a scan's host time goes (the device work surfaces where the
    # host waits for it: in uploads behind queued folds, and the flush)
    from dragnet_tpu_torch import engine as mod_engine
    timers = Timers()
    for owner, name, label in (
            (mod_ds.DeviceScan, '_stage_device', 'stage'),
            (mod_ds.DeviceScan, '_upload_inputs', 'upload'),
            (mod_ds.DeviceScan, '_fold_staged', 'fold submit'),
            (mod_ds.DeviceScan, '_flush', 'flush fetch'),
            (mod_engine.VectorScan, '_emit_unique', 'emit'),
            (mod_engine.VectorScan, '_defer_compact', 'deferred merge'),
            (mod_engine.VectorScan, '_defer_final', 'deferred merge'),
            (mod_engine.VectorScan, '_process', 'host engine batch')):
        timers.wrap(spy, owner, name, label)
    spy.wrap(mod_ds.DeviceScan, '_try_device', wrap_try)
    spy.wrap(mod_ds.DeviceScan, '_fold', wrap_fold)
    spy.wrap(mod_ds.DeviceScan, '_fold_sparse', wrap_fold_sparse)
    spy.wrap(mod_ds, 'fold_sparse', wrap_program)
    spy.wrap(mod_ds.DeviceScan, '_sparse_guard', wrap_guard)
    out = []
    try:
        for name, qargs, expect in SPARSE_QUERIES:
            argv = ['scan', '--points', '--counters'] + qargs + ['muskie']
            batches.update(total=0, device=0)
            del routes[:], sparse_rows[:], folds[:], caps[:]
            mod_ds.sparse_folds['fold_sparse'] = 0
            t0 = time.monotonic()
            rc, sout, serr = run_cli(cli, argv)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            dev_times = timers.take(scan_times[-1])
            nfolds = mod_ds.sparse_folds['fold_sparse']
            check(rc == 0, '%s: scan failed: %s' % (name, serr))
            nb, nd = batches['total'], batches['device']
            check(nb > 0 and nd == nb, '%s: %d of %d batches ran on the '
                  'device' % (name, nd, nb))
            check(nfolds == routes.count('sparse') > 0 and
                  len(routes) == nb,
                  '%s: sparse fold ran %d times, routes %r'
                  % (name, nfolds, routes))
            if expect == 'dense then sparse':
                check(routes[0] == 'dense' and routes == sorted(routes),
                      '%s: expected dense batches, then sparse: %r'
                      % (name, routes))
            else:
                check(set(routes) == {'sparse'} and
                      max(caps) > mod_ds.SPARSE_CAP0,
                      '%s: expected every batch sparse and the set to '
                      'grow past %d: routes %r, capacities %r'
                      % (name, mod_ds.SPARSE_CAP0, routes, sorted(set(caps))))
            fold_ms = [s.elapsed_time(e) for s, e, _, _ in folds]
            by_cap = {}
            for (s, e, cap, nsort), ms in zip(folds, fold_ms):
                by_cap.setdefault(cap, []).append((ms, nsort))
            t0 = time.monotonic()
            hout, herr = host_output(cli, argv, ds)
            ht = time.monotonic() - t0
            scan_s, hscan_s = scan_times[-2:]
            host_times = timers.take(hscan_s)
            if expect == 'dense then sparse':
                serr, herr = without_spill(name, serr, herr, sparse_rows)
            check(sout == hout and serr == herr,
                  '%s: device output differs from the host engine' % name)
            npoints = sout.count('\n')
            log('sparse %-40s device %7.2f s %10.0f records/s (scan '
                '%.2f s, %.0f records/s) | host %7.2f s %10.0f records/s '
                '(scan %.2f s, %.0f records/s) | identical (%d points) | '
                'batches %d (dense %d, sparse %d) | capacity reached %d'
                % (name, dt, records / dt, scan_s, records / scan_s, ht,
                   records / ht, hscan_s, records / hscan_s, npoints, nb,
                   routes.count('dense'), nfolds, max(caps or [0])))
            log('    scan host s, device: %s | host engine: %s'
                % (fmt_times(dev_times), fmt_times(host_times)))
            for cap, v in sorted(by_cap.items()):
                ms = [m for m, _ in v]
                log('    fold at %d slots: %d folds, device ms per fold '
                    'mean %.4f min %.4f max %.4f, keys sorted per fold '
                    '%d-%d' % (cap, len(ms), sum(ms) / len(ms), min(ms),
                               max(ms), min(k for _, k in v),
                               max(k for _, k in v)))
            out.append({'query': name, 'device_s': dt, 'host_s': ht,
                        'device_scan_s': scan_s, 'host_scan_s': hscan_s,
                        'device_times': dev_times,
                        'host_times': host_times,
                        'batches': nb, 'sparse_folds': nfolds,
                        'dense_batches': routes.count('dense'),
                        'capacity': max(caps or [0]), 'points': npoints,
                        'fold_ms_by_cap': {
                            str(c): [m for m, _ in v]
                            for c, v in by_cap.items()}})
    finally:
        spy.restore()
    return out


def tree_files(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def build_phase(cli, mod_ds, ck, tmp, data, records):
    """Phase 6: BUILD_METRICS built on the card through the CLI (counts
    zeroed just before, read just after) and with the host engine, then
    index-scan on both; trees and outputs held byte for byte."""
    import torch
    from dragnet_tpu_torch import config as mod_config
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch import datasource_for_name, metrics_for_index
    from dragnet_tpu_torch import index_build_mt as mod_ibmt
    from dragnet_tpu_torch import native_index
    dev_idx = os.path.join(tmp, 'idx_device')
    host_idx = os.path.join(tmp, 'idx_host')
    rc, _, err = run_cli(cli, [
        'datasource-add', 'idx', '--path=' + data, '--time-field=time',
        '--index-path=' + dev_idx])
    check(rc == 0, 'datasource-add failed: %s' % err)
    for metric, breakdowns, route in BUILD_METRICS:
        rc, _, err = run_cli(cli, ['metric-add', '-b', breakdowns, 'idx',
                                   metric])
        check(rc == 0, 'metric-add %s failed: %s' % (metric, err))
    rc, mlist, err = run_cli(cli, ['metric-list', 'idx'])
    check(rc == 0 and all(m in mlist for m, _, _ in BUILD_METRICS),
          'metric-list: %s %s' % (mlist, err))
    # the DNC writer's library builds on first use: build it before the
    # timed builds, so neither engine's writer time includes g++
    t0 = time.monotonic()
    dnc = native_index.get_lib() is not None
    log('libdnindex.so %s (%.2f s, before the timed builds)'
        % ('loaded' if dnc else 'NOT loaded: the numpy writer runs',
           time.monotonic() - t0))

    spy = Spy()
    stack = {'batches': 0, 'stacked': 0}
    routes = {}
    sparse_rows = []
    writes = []

    def wrap_process(orig):
        def process(self, provider, weights, alive):
            stack['batches'] += 1
            return orig(self, provider, weights, alive)
        return process

    def wrap_device(orig):
        def process_device(self, provider, weights, alive):
            ok = orig(self, provider, weights, alive)
            stack['stacked'] += int(ok)
            return ok
        return process_device

    def wrap_fold(orig):
        def fold(self, args, n, profile, caps, ns, use_kernel, base):
            routes.setdefault(self._pfx, []).append(
                'kernel' if use_kernel else 'index_add')
            return orig(self, args, n, profile, caps, ns, use_kernel, base)
        return fold

    def wrap_fold_sparse(orig):
        def fold_sparse(self, args, n, *a):
            routes.setdefault(self._pfx, []).append('sparse')
            sparse_rows.append(n)
            return orig(self, args, n, *a)
        return fold_sparse

    def wrap_write(orig):
        def write(*a, **k):
            t0 = time.monotonic()
            rv = orig(*a, **k)
            writes.append(time.monotonic() - t0)
            return rv
        return write
    spy.wrap(mod_ds.DeviceScanStack, 'process', wrap_process)
    spy.wrap(mod_ds.DeviceScanStack, '_process_device', wrap_device)
    spy.wrap(mod_ds.DeviceScan, '_fold', wrap_fold)
    spy.wrap(mod_ds.DeviceScan, '_fold_sparse', wrap_fold_sparse)
    spy.wrap(mod_ibmt, 'write_index_blocks', wrap_write)
    from dragnet_tpu_torch import engine as mod_engine
    timers = Timers()
    for owner, name, label in (
            (mod_ds.DeviceScanStack, 'process', 'stack stage + fold'),
            (mod_ds.DeviceScan, '_flush', 'flush fetch'),
            (mod_engine.VectorScan, '_emit_unique', 'emit'),
            (mod_engine.VectorScan, '_defer_compact', 'deferred merge'),
            (mod_engine.VectorScan, '_defer_final', 'deferred merge'),
            (mod_engine.VectorScan, '_process', 'host engine batch'),
            (mod_ibmt, '_publish_buckets', 'index write + publish')):
        timers.wrap(spy, owner, name, label)
    try:
        # the build path: counts zeroed just before, read just after
        ck.reset_launches()
        t0 = time.monotonic()
        rc, bout, berr = run_cli(cli, ['build', '--interval=hour',
                                       '--counters', 'idx'])
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        build_launches = ck.launches['onehot_dense']
        dev_times = timers.take(dt)
        check(rc == 0, 'build failed: %s' % berr)
        dev_write = writes[-1]
        nb, ns_ = stack['batches'], stack['stacked']
        check(nb > 0 and ns_ == nb, 'build: %d of %d batches went through '
              'the stacked fold' % (ns_, nb))
        for i, (metric, _, route) in enumerate(BUILD_METRICS):
            got = routes.get('m%d_' % i, [])
            check(len(got) == nb and route in got and
                  (route != 'kernel' or set(got) == {'kernel'}),
                  'build: %s expected the %s route, got %r'
                  % (metric, route, sorted(set(got))))
            log('build metric %-9s folds %d, routes %s'
                % (metric, len(got),
                   ', '.join('%s %d' % (r, got.count(r))
                             for r in ('kernel', 'index_add', 'sparse')
                             if r in got)))
        check(build_launches == nb,
              'build: the one-hot kernel launched %d times for %d stacked '
              'batches' % (build_launches, nb))

        # the host engine into a second tree
        _, config = mod_config.ConfigBackendLocal().load()
        dsconfig = dict(config.datasource_get('idx'))
        bc = dict(dsconfig['ds_backend_config'], indexPath=host_idx)
        dsconfig['ds_backend_config'] = bc
        hds = mod_dsf.DatasourceFile(dsconfig)
        metrics = metrics_for_index(config, 'idx')
        t0 = time.monotonic()
        hres = hds.build(metrics, 'hour', engine='vector')
        ht = time.monotonic() - t0
        host_times = timers.take(ht)
        host_write = writes[-1]
    finally:
        spy.restore()
    herr = io.StringIO()
    herr.write('indexes for "idx" built\n')
    hres.pipeline.dump_counters(herr)
    dev_counters = berr
    berr, herr = without_spill('build', berr, herr.getvalue(), sparse_rows)
    check(berr == herr, 'build --counters differs from the host engine:'
          '\n%s\n%s' % (berr, herr))
    dtree, htree = tree_files(dev_idx), tree_files(host_idx)
    check(dtree.keys() == htree.keys() and
          all(dtree[k] == htree[k] for k in dtree),
          'build: the device tree differs from the host engine\'s: %r'
          % sorted(k for k in set(dtree) | set(htree)
                   if dtree.get(k) != htree.get(k)))
    shards = [k for k in dtree if k.endswith('.sqlite')]
    check(len(shards) >= 3 and '.dn_integrity.json' in dtree,
          'build: shards %r' % sorted(dtree))
    nbytes = sum(len(dtree[k]) for k in shards)
    log('build device %7.2f s %10.0f records/s (index write + publish '
        '%.2f s) | host %7.2f s %10.0f records/s (write %.2f s) | trees '
        'identical: %d shards, %d bytes, + integrity catalog | '
        'libdnindex.so %s | stacked batches %d, kernel launches %d'
        % (dt, records / dt, dev_write, ht, records / ht, host_write,
           len(shards), nbytes, 'loaded' if dnc else 'NOT loaded (numpy '
           'writer)', nb, build_launches))

    log('    build host s, device: %s | host engine: %s'
        % (fmt_times(dev_times), fmt_times(host_times)))

    # index-scan on both engines, over the first INDEX_SCAN_MINUTES of
    # the three hours (the whole file is scanned; the window keeps the
    # printed points, 1.4M over the three hours, to its share)
    first = sorted(k for k in shards if k.startswith('by_hour'))[0]
    t0 = calendar.timegm(time.strptime(os.path.basename(first)[:13],
                                       '%Y-%m-%d-%H'))
    window = ['--after', time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                       time.gmtime(t0)),
              '--before', time.strftime(
                  '%Y-%m-%dT%H:%M:%SZ',
                  time.gmtime(t0 + 60 * INDEX_SCAN_MINUTES))]
    t0 = time.monotonic()
    rc, sout, serr = run_cli(cli, ['index-scan', '--interval=hour'] +
                             window + ['idx'])
    torch.cuda.synchronize()
    st = time.monotonic() - t0
    check(rc == 0, 'index-scan failed: %s' % serr)
    ds = datasource_for_name(config, 'idx')
    t0 = time.monotonic()
    wopts = cli.dn_parse_args(window + ['idx'], ['after', 'before'])
    res = ds.index_scan(metrics, 'hour', time_after=wopts.after,
                        time_before=wopts.before, engine='vector')
    opts = cli.dn_parse_args(['idx'], ['counters'])
    opts.points = True
    hout, herr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(hout), contextlib.redirect_stderr(herr):
        cli.dn_output(None, opts, res, 'idx')
    hst = time.monotonic() - t0
    check(sout == hout.getvalue() and sout.count('\n') > 0,
          'index-scan differs from the host engine')
    log('index-scan %s device %.2f s | host %.2f s (each with its output) '
        '| identical (%d points)' % (' '.join(window), st, hst,
                                     sout.count('\n')))
    return {'device_s': dt, 'host_s': ht, 'device_times': dev_times,
            'host_times': host_times, 'device_write_s': dev_write,
            'host_write_s': host_write, 'batches': nb, 'stacked': ns_,
            'build_launches': build_launches, 'counters': dev_counters,
            'shards': len(shards),
            'shard_bytes': nbytes, 'libdnindex': dnc,
            'index_scan_device_s': st, 'index_scan_host_s': hst,
            'routes': {m: sorted(set(routes.get('m%d_' % i, [])))
                       for i, (m, _, _) in enumerate(BUILD_METRICS)}}


def pipeline_phase(cli, mod_ds, ck, tmp, records, forced, build):
    """Phase 6b: the pipelined dispatch.  The K1 query (QUERIES[1]) and
    the three-metric hour build at DN_DEVICE_PIPELINE_DEPTH 1 and 2, and
    the build at 2 again without the flush prefetch (DN_PREFETCH=0):
    each scan output held to phase 4's, each tree and --counters dump to
    phase 6's, byte for byte; K1 launching once per device batch; every
    per-record upload from page-locked memory; no synchronizing CUDA
    call inside the kernel query's device batches between flushes
    (torch's sync debug mode, in its warning form so that each one is
    listed).  Then the K1 query at depths 1 and 2 with the device made
    the slower side (BUSY_CYCLES of device work after each fold): the
    output unchanged, and the window held: after each dispatch at most
    `depth` batches are still running on the device, and with the
    device the slower side exactly `depth` at some dispatch (1 at depth
    1, 2 at depth 2).  Prints each run's wall, records/s, the pipeline
    counters, the most batches in flight, the staging slots allocated,
    the host seconds of staging + upload and of the fetch wait."""
    import warnings
    import torch
    from dragnet_tpu_torch import config as mod_config
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch import engine as mod_engine
    from dragnet_tpu_torch import metrics_for_index
    from dragnet_tpu_torch.obs import metrics as obs_metrics
    name, qargs, _ = QUERIES[1]
    argv = ['scan', '--points', '--counters'] + qargs + ['muskie']
    fout, ferr, _ = forced[name]
    _, config = mod_config.ConfigBackendLocal().load()
    metrics = metrics_for_index(config, 'idx')
    ref_tree = tree_files(os.path.join(tmp, 'idx_device'))
    spy = Spy()
    timers = Timers()
    for owner, attr, label in (
            (mod_ds.DeviceScan, '_stage_device', 'stage'),
            (mod_ds.DeviceScan, '_upload_inputs', 'upload'),
            (mod_ds, '_wait_fetched', 'fetch wait')):
        timers.wrap(spy, owner, attr, label)
    batches = {'total': 0, 'device': 0}
    # the window: most batches still running after a dispatch returned;
    # the staging ring's slot allocations and their largest size
    window = {'inflight': 0, 'allocs': 0, 'slot_bytes': 0}
    sync = {'on': False, 'found': []}

    def wrap_try(orig):
        def try_device(self, provider, weights, alive):
            if not sync['on']:
                ok = orig(self, provider, weights, alive)
            else:
                with warnings.catch_warnings(record=True) as got:
                    warnings.simplefilter('always')
                    torch.cuda.set_sync_debug_mode('warn')
                    try:
                        ok = orig(self, provider, weights, alive)
                    finally:
                        torch.cuda.set_sync_debug_mode('default')
                sync['found'] += ['%s:%d' % (w.filename, w.lineno)
                                  for w in got if 'called a synchronizing'
                                  in str(w.message)]
            batches['total'] += 1
            batches['device'] += int(ok)
            return ok
        return try_device

    def wrap_flush(orig):
        # a flush fetches by design: outside the checked window
        def flush(self):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode('default')
            try:
                return orig(self)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return flush

    def wrap_dispatch(orig):
        def note_dispatch(self, token, nbytes):
            rv = orig(self, token, nbytes)
            running = sum(1 for t in self._pipe
                          if t is not None and not t.query())
            window['inflight'] = max(window['inflight'], running)
            return rv
        return note_dispatch

    def wrap_alloc(orig):
        def alloc(self, slot, nbytes, compute):
            window['allocs'] += 1
            window['slot_bytes'] = max(window['slot_bytes'], nbytes)
            return orig(self, slot, nbytes, compute)
        return alloc
    busy = {'on': False}

    def wrap_fold(orig):
        # the device made the slower side: BUSY_CYCLES of device work on
        # the scan's compute stream after each fold
        def fold_staged(self, staged, args):
            rv = orig(self, staged, args)
            if busy['on']:
                with torch.cuda.stream(self._compute):
                    torch.cuda._sleep(BUSY_CYCLES)
            return rv
        return fold_staged
    spy.wrap(mod_ds.DeviceScan, '_try_device', wrap_try)
    spy.wrap(mod_ds.DeviceScan, '_flush', wrap_flush)
    spy.wrap(mod_ds.DeviceScan, '_note_dispatch', wrap_dispatch)
    spy.wrap(mod_ds._StagingRing, '_alloc', wrap_alloc)
    spy.wrap(mod_ds.DeviceScan, '_fold_staged', wrap_fold)

    def counters():
        return dict(obs_metrics.pipeline_doc())

    def measured(fn):
        """(seconds, pipeline counter deltas, host times, K1 launches)"""
        window.update(inflight=0, allocs=0, slot_bytes=0)
        ck.reset_launches()
        c0 = counters()
        t0 = time.monotonic()
        rv = fn()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        c1 = counters()
        delta = {k: c1[k] - c0[k] for k in ('dispatches', 'overlapped',
                                            'h2d_bytes', 'h2d_pinned_bytes',
                                            'h2d_overlapped_bytes')}
        delta['depth'] = c1['depth']
        delta.update(window)
        return rv, dt, delta, timers.take(dt), ck.launches['onehot_dense']

    # the detector itself: a known synchronizing call must be listed
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            int(torch.ones(1, device=DEVICE).sum())
        finally:
            torch.cuda.set_sync_debug_mode('default')
    check(any('called a synchronizing' in str(w.message) for w in got),
          'pipeline: torch\'s sync debug mode did not report a known '
          'synchronizing call: %r' % [str(w.message) for w in got])
    runs = []
    try:
        for depth, prefetch in (('1', '1'), ('2', '1'), ('2', '0')):
            with env_scope(DN_DEVICE_PIPELINE_DEPTH=depth,
                           DN_PREFETCH=prefetch):
                if prefetch == '1':
                    batches.update(total=0, device=0)
                    sync.update(on=True, found=[])
                    (rc, out, err), dt, c, times, nl = measured(
                        lambda: run_cli(cli, argv))
                    sync['on'] = False
                    check(rc == 0, 'pipeline %s depth %s: scan failed: %s'
                          % (name, depth, err))
                    check((out, err) == (fout, ferr), 'pipeline %s depth '
                          '%s: output differs from phase 4' % (name, depth))
                    nb = batches['total']
                    check(nb > 0 and batches['device'] == nb and nl == nb,
                          'pipeline %s depth %s: %d of %d batches on the '
                          'device, K1 launched %d times'
                          % (name, depth, batches['device'], nb, nl))
                    check(not sync['found'], 'pipeline %s depth %s: '
                          'synchronizing CUDA calls inside device batches: '
                          '%s' % (name, depth, sync['found'][:8]))
                    runs.append(('scan ' + name, depth, prefetch, dt, c,
                                 times, nl, nb))
                idx = os.path.join(tmp, 'idx_pipe_%s_%s' % (depth, prefetch))
                dsconfig = dict(config.datasource_get('idx'))
                dsconfig['ds_backend_config'] = dict(
                    dsconfig['ds_backend_config'], indexPath=idx)
                bds = mod_dsf.DatasourceFile(dsconfig)
                res, dt, c, times, nl = measured(
                    lambda: bds.build(metrics, 'hour', engine='device',
                                      device=DEVICE))
                tree = tree_files(idx)
                check(tree.keys() == ref_tree.keys() and
                      all(tree[k] == ref_tree[k] for k in tree),
                      'pipeline build depth %s prefetch %s: the tree '
                      'differs from phase 6\'s' % (depth, prefetch))
                berr = io.StringIO()
                berr.write('indexes for "idx" built\n')
                res.pipeline.dump_counters(berr)
                check(berr.getvalue() == build['counters'],
                      'pipeline build depth %s prefetch %s: --counters '
                      'differ from phase 6\'s' % (depth, prefetch))
                nb = sum(st.counters.get('nstackedbatches', 0)
                         for st in res.pipeline.stages) // len(metrics)
                check(nl == nb and c['dispatches'] == nb,
                      'pipeline build depth %s: K1 launched %d times, %d '
                      'dispatches, for %d stacked batches'
                      % (depth, nl, c['dispatches'], nb))
                runs.append(('build hour x3', depth, prefetch, dt, c,
                             times, nl, nb))
        busy['on'] = True
        for depth in ('1', '2'):
            with env_scope(DN_DEVICE_PIPELINE_DEPTH=depth):
                batches.update(total=0, device=0)
                (rc, out, err), dt, c, times, nl = measured(
                    lambda: run_cli(cli, argv))
            check(rc == 0 and (out, err) == (fout, ferr),
                  'pipeline %s, device busy, depth %s: output differs '
                  'from phase 4 (%s)' % (name, depth, err[-200:]))
            runs.append(('scan %s, device busy' % name, depth, '1', dt, c,
                         times, nl, batches['total']))
            # the device is the slower side: the window fills to its
            # depth and no further
            check(c['inflight'] == int(depth) and c['overlapped'] > 0,
                  'pipeline %s, device busy, depth %s: at most %d batches '
                  'in flight after a dispatch (%r)'
                  % (name, depth, c['inflight'], c))
    finally:
        busy['on'] = False
        torch.cuda.set_sync_debug_mode('default')
        spy.restore()
    out = []
    for what, depth, prefetch, dt, c, times, nl, nb in runs:
        check(c['h2d_bytes'] > 0 and c['h2d_pinned_bytes'] == c['h2d_bytes'],
              'pipeline %s depth %s: %d of %d per-record upload bytes from '
              'page-locked memory' % (what, depth, c['h2d_pinned_bytes'],
                                      c['h2d_bytes']))
        check(c['inflight'] <= int(depth), 'pipeline %s depth %s: %d '
              'batches in flight after a dispatch' % (what, depth,
                                                       c['inflight']))
        staging = times.get('stage', 0.0) + times.get('upload', 0.0)
        log('pipeline %-32s depth %s prefetch %s: %.2f s %11.0f records/s '
            '| dispatches %d, overlapped %d (%d bytes), most in flight %d '
            '| H2D %d bytes, all page-locked | %d slot allocations, the '
            'largest %d bytes | staging + upload %.3f s | fetch wait '
            '%.4f s | K1 launches %d for %d batches | identical output'
            % (what, depth, prefetch, dt, records / dt, c['dispatches'],
               c['overlapped'], c['h2d_overlapped_bytes'], c['inflight'],
               c['h2d_bytes'], c['allocs'], c['slot_bytes'], staging,
               times.get('fetch wait', 0.0), nl, nb))
        out.append({'run': what, 'depth': int(depth),
                    'prefetch': prefetch == '1', 's': dt,
                    'records_per_s': records / dt, 'counters': c,
                    'staging_upload_s': staging,
                    'fetch_wait_s': times.get('fetch wait', 0.0),
                    'launches': nl, 'batches': nb})
    log('pipeline: staging slots start at BATCH_SIZE = %d rows (no '
        'padding is copied); no synchronizing CUDA call inside the kernel '
        'query\'s device batches' % mod_engine.BATCH_SIZE)
    return out


class FoldTimer(object):
    """CUDA events around each call of device_index._fold_program, and
    the host-side sizes of the work K7 must do (rows, translation
    entries, accumulator segments)."""

    def __init__(self, spy, mod_di):
        import torch
        self.events = []
        self.rows = self.tab = self.segs = 0

        def wrap_fold(orig):
            def fold(lmat, wmat, ttabs, acc):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                rv = orig(lmat, wmat, ttabs, acc)
                e1.record()
                self.events.append((e0, e1))
                return rv
            return fold

        def wrap_stage(orig):
            def stage(inv_sl):
                local, ttable, nlocal = orig(inv_sl)
                self.rows += len(local)
                self.tab += nlocal
                return local, ttable, nlocal
            return stage

        def wrap_batched(orig):
            def batched(inv, weights, nuniq, **k):
                rv = orig(inv, weights, nuniq, **k)
                if rv is not None:
                    self.segs += nuniq
                return rv
            return batched
        spy.wrap(mod_di, '_fold_program', wrap_fold)
        spy.wrap(mod_di, '_stage_shard', wrap_stage)
        spy.wrap(mod_di, 'batched_sums', wrap_batched)

    def take(self):
        """(device ms per dispatch list, bound ms) since the last take."""
        import torch
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        nbytes = (self.rows * K7_ROW_BYTES + self.tab * K7_TAB_BYTES +
                  self.segs * K7_SEG_BYTES)
        self.events = []
        self.rows = self.tab = self.segs = 0
        return ms, nbytes / HBM_BYTES_PER_S * 1e3


def query_phase(cli, ck, tmp, records, seed):
    """Phase 7: `dn query` over index trees built on the card, each of
    QUERY_CASES through the CLI on the card (the K1 launch count and
    the fold's engagement zeroed just before the queries, read just
    after) and with the port's host engine on the same tree."""
    import torch
    from dragnet_tpu_torch import native as mod_native
    from dragnet_tpu_torch import device_index as mod_di
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch import index_query_mt as mod_iqmt
    from dragnet_tpu_torch.obs import metrics as obs_metrics
    from dragnet_tpu_torch.config import ConfigBackendLocal
    from dragnet_tpu_torch import datasource_for_name
    data = os.path.join(tmp, 'month.log')
    t0 = time.monotonic()
    mod_native.gen_to_file(records, data, mindate_ms=QUERY_MIN_MS,
                           maxdate_ms=QUERY_MIN_MS + QUERY_DAYS * 86400000,
                           seed=seed)
    log('query data: %d records over %d days (%d bytes) in %.2f s'
        % (records, QUERY_DAYS, os.path.getsize(data),
           time.monotonic() - t0))
    rc, _, err = run_cli(cli, [
        'datasource-add', 'month', '--path=' + data, '--time-field=time',
        '--index-path=' + os.path.join(tmp, 'idx_month')])
    check(rc == 0, 'datasource-add failed: %s' % err)
    for metric, breakdowns, _route in BUILD_METRICS:
        rc, _, err = run_cli(cli, ['metric-add', '-b', breakdowns,
                                   'month', metric])
        check(rc == 0, 'metric-add %s failed: %s' % (metric, err))
    builds = {}
    for interval in ('hour', 'day'):
        t0 = time.monotonic()
        rc, _, err = run_cli(cli, ['build', '--interval=' + interval,
                                   'month'])
        torch.cuda.synchronize()
        builds[interval] = time.monotonic() - t0
        check(rc == 0, 'build --interval=%s failed: %s' % (interval, err))
        shards = os.listdir(os.path.join(tmp, 'idx_month',
                                         'by_' + interval))
        log('query tree: build --interval=%s on the card %.2f s, %d '
            'shards' % (interval, builds[interval],
                        len([s for s in shards if s.endswith('.sqlite')])))
    _, config = ConfigBackendLocal().load()
    ds = datasource_for_name(config, 'month')

    spy = Spy()
    results = []
    captured = []
    stages = {}
    outputs = {}

    def wrap_query(orig):
        def query(self, *a, **k):
            rv = orig(self, *a, **k)
            captured.append(rv)
            return rv
        return query

    def wrap_timed(orig):
        @contextlib.contextmanager
        def timed_stage(name, *a, **k):
            t0 = time.perf_counter()
            try:
                with orig(name, *a, **k) as sp:
                    yield sp
            finally:
                stages[name] = stages.get(name, 0.0) + \
                    time.perf_counter() - t0
        return timed_stage
    spy.wrap(mod_dsf.DatasourceFile, 'query', wrap_query)
    spy.wrap(obs_metrics, 'timed_stage', wrap_timed)
    folds = FoldTimer(spy, mod_di)
    timers = Timers()
    for owner, name, label in (
            (mod_di, '_stage_shard', 'staging'),
            (mod_di, '_pad_slot', 'staging'),
            (mod_di, '_fold_program', 'fold submit'),
            (mod_di, '_device_fold', 'pack + upload + fetch')):
        timers.wrap(spy, owner, name, label)
    try:
        # the query path: counts zeroed just before, read just after
        ck.reset_launches()
        mod_di._reset_engagement()
        for name, qargs, route in QUERY_CASES:
            argv = ['query', '--points', '--counters'] + qargs + ['month']
            mod_iqmt.shard_cache_clear()
            runs = []
            for attempt in range(2):
                e0 = mod_di.stats_doc()
                stages.clear()
                timers.take(0.0)
                t0 = time.monotonic()
                rc, out, err = run_cli(cli, argv)
                torch.cuda.synchronize()
                dt = time.monotonic() - t0
                check(rc == 0, '%s: query failed: %s' % (name, err))
                e1 = mod_di.stats_doc()
                fold_ms, bound_ms = folds.take()
                runs.append({
                    'wall_s': dt, 'out': out, 'err': err,
                    'dispatches': e1['dispatches'] - e0['dispatches'],
                    'h2d_bytes': e1['h2d_bytes'] - e0['h2d_bytes'],
                    'rows': e1['rows'] - e0['rows'],
                    'routes': {r: n - e0['routes'].get(r, 0)
                               for r, n in e1['routes'].items()
                               if n != e0['routes'].get(r, 0)},
                    'fold_ms': fold_ms, 'bound_ms': bound_ms,
                    'stages': dict(stages),
                    'device_times': timers.take(0.0),
                    'index_list': dict(
                        [s for s in captured[-1].pipeline.stages
                         if s.name == 'Index List'][0].counters)})
            # the host engine on the same tree, the same rendering
            opts = cli.dn_parse_args(argv[1:], [
                'before', 'after', 'filter', 'breakdowns', 'raw',
                'points', 'counters', 'interval', 'gnuplot', 'dry-run'])
            query = cli.dn_query_config(opts)
            stages.clear()
            t0 = time.monotonic()
            hres = ds.query(query, opts.interval, engine='vector')
            hout, herr = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(hout), \
                    contextlib.redirect_stderr(herr):
                cli.dn_output(query, opts, hres, 'month')
            ht = time.monotonic() - t0
            host_stages = dict(stages)
            outputs[name] = (hout.getvalue(), herr.getvalue())
            for r in runs:
                check(r['out'] == hout.getvalue() and
                      r['err'] == herr.getvalue(),
                      '%s: device output differs from the host engine'
                      % name)
                check(r['routes'] == {route: 1},
                      '%s: expected the route %r, got %r'
                      % (name, route, r['routes']))
                il = r['index_list']
                if route == 'device':
                    check(il.get('index device sums') == 1 and
                          r['dispatches'] > 0,
                          '%s: the device fold did not run: %r, %d '
                          'dispatches' % (name, il, r['dispatches']))
                else:
                    check('index device sums' not in il and
                          r['dispatches'] == 0,
                          '%s: the host route engaged the device' % name)
            check(hout.getvalue().count('\n') > 0 and
                  'Index List' in herr.getvalue(),
                  '%s: empty result' % name)
            il = runs[0]['index_list']
            if '--after' in qargs:
                check(il.get('index shards pruned', 0) > 0,
                      '%s: no shard pruned: %r' % (name, il))
            npoints = hout.getvalue().count('\n')
            r = runs[1]
            fold_ms = r['fold_ms']
            log('query %-33s device %.3f s (first %.3f s) | host %.3f s '
                '| identical, %d points | %d index rows, shards queried '
                '%d pruned %d | route %s'
                % (name, r['wall_s'], runs[0]['wall_s'], ht, npoints,
                   r['rows'], il.get('index shards queried', 0),
                   il.get('index shards pruned', 0), route))
            if fold_ms:
                log('    K7 fold: %d dispatches, device ms per dispatch '
                    '%.4f (min %.4f, max %.4f, total %.3f), bound %.4f '
                    'ms, H2D %d bytes'
                    % (len(fold_ms), sum(fold_ms) / len(fold_ms),
                       min(fold_ms), max(fold_ms), sum(fold_ms),
                       r['bound_ms'], r['h2d_bytes']))
            log('    host s: %s | inside aggregate: %s | host engine: %s'
                % (fmt_times(r['stages'], 4),
                   fmt_times({k: v for k, v in r['device_times'].items()
                              if k != 'rest'}, 4),
                   fmt_times(host_stages, 4)))
            results.append({
                'name': name, 'args': qargs, 'route': route,
                'points': npoints, 'host_s': ht,
                'device_s': [x['wall_s'] for x in runs],
                'dispatches': r['dispatches'], 'rows': r['rows'],
                'h2d_bytes': r['h2d_bytes'], 'fold_ms': fold_ms,
                'bound_ms': r['bound_ms'], 'stages': r['stages'],
                'host_stages': host_stages,
                'aggregate_parts': r['device_times'],
                'shards_queried': il.get('index shards queried', 0),
                'shards_pruned': il.get('index shards pruned', 0)})
        query_launches = ck.launches['onehot_dense']
    finally:
        spy.restore()
    return {'builds_s': builds, 'queries': results,
            'onehot_launches': query_launches}, outputs


@contextlib.contextmanager
def env_scope(**env):
    """Set (a value) or unset (None) environment variables for the
    length of a block, then restore them."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fmt_route(doc):
    """One line for a scan's route record (DeviceScan.route_doc)."""
    if doc.get('engine') == 'VectorScan':
        return 'host engine (VectorScan)'
    parts = ['escalated at record %d' % doc['escalated_at']
             if doc['escalated'] else 'stayed on the host',
             'device batches %d' % doc['device_batches'],
             'probe %s' % doc.get('probe_status')]
    if doc.get('cached_verdict') is not None:
        parts.append('cached verdict %s' % doc['cached_verdict'])
    if doc.get('audition'):
        a = doc['audition']
        parts.append('audition failed' if a.get('failed') else
                     'audition %s (device %s records/s, host %s; replay '
                     '%.3f s, its thread\'s CPU %.3f s; created, batches '
                     'in, replay start, done, verdict at %s s)%s'
                     % ('won' if a['won'] else 'lost', a['device_rate'],
                        a['host_rate'], a['replay_s'], a['replay_cpu_s'],
                        a['timeline_s'],
                        ' at the stream\'s end' if a['at_finish'] else ''))
    if doc.get('probation'):
        p = doc['probation']
        parts.append('probation %s (device %s records/s, host %s)'
                     % ('passed' if p['won'] else 'lost',
                        p['device_rate'], p['host_rate']))
    return ', '.join(parts)


def auto_phase(cli, mod_ds, ck, tmp, records, forced, query_outputs):
    """Phase 8: the default engine.  For each main-path query the host
    engine at one and at the default worker count, auto with an empty
    verdict cache, again with the cache it wrote, and auto with eager
    constants (which must take over on the card) and the same constants
    racing the audition against the stream, as a user's run does; then
    eager builds (waiting, then racing) and a default auto build, and
    auto queries that audition and then follow their verdict.  Every
    output must equal the forced device lane's.  K1's count is zeroed
    just before each run, read when the stream is taken over (the
    audition's own launches come before) and read just after."""
    import torch
    from dragnet_tpu_torch import config as mod_config
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch import device_index as mod_di
    from dragnet_tpu_torch import index_query_mt as mod_iqmt
    from dragnet_tpu_torch import metrics_for_index
    from dragnet_tpu_torch.obs import metrics as obs_metrics
    cache = os.path.join(tmp, 'auditions')
    scans = []
    routes = []
    spy = Spy()

    def wrap_scan(orig):
        def scan(self, *a, **k):
            rv = orig(self, *a, **k)
            routes.append(self.last_route)
            return rv
        return scan
    spy.wrap(mod_dsf.DatasourceFile, 'scan', wrap_scan)
    # K1's count at the first takeover of a run
    at_takeover = []

    def wrap_escalated(orig):
        def note(self):
            if self.route['escalated_at'] is None and not at_takeover:
                at_takeover.append(ck.launches['onehot_dense'])
            return orig(self)
        return note
    # held through the builds too (the scans' spy is restored first)
    tspy = Spy()
    tspy.wrap(mod_ds.AutoDeviceScan, '_note_escalated', wrap_escalated)

    def eager(spy, wait):
        consts = dict(AUTO_EAGER, AWAIT_DECISION=wait)
        for name, v in consts.items():
            spy.wrap(mod_ds.AutoDeviceScan, name, lambda orig, v=v: v)

    def reset():
        ck.reset_launches()
        del at_takeover[:]

    def after_takeover():
        n = ck.launches['onehot_dense']
        return n - at_takeover[0] if at_takeover else 0

    def run(argv, env, want):
        """(seconds, K1 launches, of them after the takeover)"""
        with env_scope(**env):
            reset()
            t0 = time.monotonic()
            rc, out, err = run_cli(cli, argv)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            launches = ck.launches['onehot_dense']
        check(rc == 0, '%s: failed: %s' % (argv, err))
        check((out, err) == want, '%s under %s: output differs from the '
              'forced device lane' % (argv, env))
        return dt, launches, after_takeover()

    auto_launches = 0
    try:
        for name, qargs, kroute in QUERIES:
            argv = ['scan', '--points', '--counters'] + qargs + ['muskie']
            fout, ferr, fdt = forced[name]
            row = {'name': name, 'forced_s': fdt}
            row['vector_1_s'] = run(argv, {'DN_ENGINE': 'vector',
                                           'DN_SCAN_THREADS': '0'},
                                    (fout, ferr))[0]
            row['vector_mt_s'] = run(argv, {'DN_ENGINE': 'vector',
                                            'DN_SCAN_THREADS': None},
                                     (fout, ferr))[0]
            auto_env = {'DN_ENGINE': 'auto', 'DN_SCAN_THREADS': None,
                        'DN_AUDITION_CACHE': '1',
                        'DN_TORCH_CACHE_DIR': cache}
            for label in ('cold', 'warm'):
                dt, nl, _ = run(argv, auto_env, (fout, ferr))
                row['auto_%s_s' % label] = dt
                row['auto_%s_route' % label] = routes[-1][0]
                row['auto_%s_launches' % label] = nl
            warm = row['auto_warm_route']
            row['warm_skipped_audition'] = \
                warm.get('cached_verdict') is not None
            # eager constants, the stream waiting for its decision: the
            # takeover must reach the card; then racing, as users run
            for wait in (True, False):
                espy = Spy()
                eager(espy, wait)
                try:
                    dt, nl, na = run(argv, dict(auto_env,
                                                DN_AUDITION_CACHE='0'),
                                     (fout, ferr))
                finally:
                    espy.restore()
                if wait:
                    row.update(auto_eager_s=dt,
                               auto_eager_route=routes[-1][0],
                               auto_eager_launches=nl,
                               auto_eager_takeover_launches=na)
                else:
                    row.update(auto_racing_s=dt,
                               auto_racing_route=routes[-1][0],
                               auto_racing_takeover_launches=na)
            doc = row['auto_eager_route']
            nl = row['auto_eager_launches']
            na = row['auto_eager_takeover_launches']
            dt = row['auto_eager_s']
            check(doc['escalated'] and doc['device_batches'] > 0,
                  '%s: eager auto never took over on the card: %r'
                  % (name, doc))
            if kroute == 'kernel':
                check(na == doc['device_batches'],
                      '%s: K1 launched %d times after the eager takeover '
                      'for %d device batches' % (name, na,
                                                 doc['device_batches']))
            else:
                check(nl == 0, '%s: K1 launched %d times on the scatter '
                      'query' % (name, nl))
            auto_launches += na
            log('auto scan %-36s forced %.2f s | vector 1 thread %.2f s '
                '(%.0f records/s) | vector MT %.2f s (%.0f records/s) | '
                'auto cold %.2f s (%.0f records/s) | warm %.2f s | eager '
                '%.2f s, K1 launches %d (%d after the takeover) | racing '
                '%.2f s | identical output'
                % (name, fdt, row['vector_1_s'],
                   records / row['vector_1_s'], row['vector_mt_s'],
                   records / row['vector_mt_s'], row['auto_cold_s'],
                   records / row['auto_cold_s'], row['auto_warm_s'],
                   dt, nl, na, row['auto_racing_s']))
            log('    auto cold: %s' % fmt_route(row['auto_cold_route']))
            log('    auto warm: %s (%s)' % (
                fmt_route(warm), 'skipped the audition: cached verdict'
                if row['warm_skipped_audition'] else
                'no verdict was persisted, nothing to skip'))
            log('    auto eager: %s' % fmt_route(doc))
            log('    auto eager, racing: %s, K1 launches after the '
                'takeover %d' % (fmt_route(row['auto_racing_route']),
                                 row['auto_racing_takeover_launches']))
            scans.append(row)
    finally:
        spy.restore()

    # builds: eager (through the stack, the tree held to phase 6's),
    # eager racing the audition, and with the default constants
    _, config = mod_config.ConfigBackendLocal().load()
    metrics = metrics_for_index(config, 'idx')
    ref_tree = tree_files(os.path.join(tmp, 'idx_device'))
    builds = {}
    # the racing build persists its verdict (reached mid-stream, or at
    # the stream's end when the replay finished after the last decision
    # point); 'racing, warm' runs on that verdict
    build_cache = os.path.join(tmp, 'auditions_build')
    for label in ('eager', 'racing', 'racing, warm', 'default'):
        idx = os.path.join(tmp, 'idx_auto_' + label)
        dsconfig = dict(config.datasource_get('idx'))
        dsconfig['ds_backend_config'] = dict(
            dsconfig['ds_backend_config'], indexPath=idx)
        bds = mod_dsf.DatasourceFile(dsconfig)
        bspy = Spy()
        if label != 'default':
            eager(bspy, label == 'eager')
        cache_env = {'DN_AUDITION_CACHE': '0'}
        if label.startswith('racing'):
            cache_env = {'DN_AUDITION_CACHE': '1',
                         'DN_TORCH_CACHE_DIR': build_cache}
        try:
            with env_scope(DN_SCAN_THREADS=None, **cache_env):
                reset()
                c0 = obs_metrics.pipeline_doc()
                t0 = time.monotonic()
                res = bds.build(metrics, 'hour', engine='auto',
                                device=DEVICE)
                torch.cuda.synchronize()
                dt = time.monotonic() - t0
                c1 = obs_metrics.pipeline_doc()
                nl = ck.launches['onehot_dense']
                na = after_takeover()
        finally:
            bspy.restore()
        tree = tree_files(idx)
        check(tree.keys() == ref_tree.keys() and
              all(tree[k] == ref_tree[k] for k in tree),
              'auto build (%s): the tree differs from phase 6\'s' % label)
        stacked = sum(st.counters.get('nstackedbatches', 0)
                      for st in res.pipeline.stages)
        if label == 'eager':
            check(stacked > 0 and all(d['escalated']
                                      for d in bds.last_route),
                  'eager auto build did not take over through the stack: '
                  '%d stacked batches, %r' % (stacked, bds.last_route))
            check(na > 0, 'eager auto build: K1 did not launch after the '
                  'takeover')
            auto_launches += na
        aud = bds.last_route[0].get('audition')
        concluded = 'no audition'
        if aud:
            concluded = 'did not conclude' if aud.get('failed') else \
                'concluded at the stream\'s end' if aud.get('at_finish') \
                else 'concluded mid-stream'
        elif bds.last_route[0].get('probe_status') == 'ok' and \
                bds.last_route[0].get('cached_verdict') is None:
            concluded = 'did not conclude'
        if label == 'racing, warm' and builds['racing']['audition'] in (
                'concluded mid-stream', 'concluded at the stream\'s end'):
            check(bds.last_route[0]['cached_verdict'] is True and
                  stacked > 0,
                  'auto build (racing, warm) did not follow the verdict '
                  'the racing build persisted: %r' % bds.last_route[0])
        pipe = {k: c1[k] - c0[k] for k in ('dispatches', 'overlapped')}
        builds[label] = {'s': dt, 'stacked_batches': stacked,
                         'launches': nl, 'takeover_launches': na,
                         'audition': concluded,
                         'pipeline': pipe, 'routes': bds.last_route}
        log('auto build %-12s %.2f s (%.0f records/s) | stacked batches '
            '%d | K1 launches %d (%d after the takeover) | tree identical '
            'to phase 6 | audition: %s | dispatches %d, overlapped %d | %s'
            % (label, dt, records / dt, stacked, nl, na, concluded,
               pipe['dispatches'], pipe['overlapped'],
               '; '.join(fmt_route(d) for d in bds.last_route)))

    tspy.restore()

    # queries: the first auditions (CUDA is warm in this process), the
    # repeat follows the persisted verdict
    iq = []
    with env_scope(DN_ENGINE='auto', DN_AUDITION_CACHE='1',
                   DN_TORCH_CACHE_DIR=os.path.join(tmp, 'auditions_iq')):
        for name, qargs, _route in QUERY_CASES:
            if name[0] not in AUTO_QUERY_CASES:
                continue
            argv = ['query', '--points', '--counters'] + qargs + ['month']
            runs = []
            for attempt in range(2):
                mod_iqmt.shard_cache_clear()
                e0 = mod_di.stats_doc()
                dt = run(argv, {}, query_outputs[name])[0]
                e1 = mod_di.stats_doc()
                routes_run = {r: n - e0['routes'].get(r, 0)
                              for r, n in e1['routes'].items()
                              if n != e0['routes'].get(r, 0)}
                runs.append({'s': dt, 'routes': routes_run,
                             'auditions': e1['auditions'] -
                             e0['auditions'],
                             'audition': e1['last_audition']})
            first, second = runs
            aud = first['audition']
            check(first['routes'] == {'audition': 1} and
                  first['auditions'] == 1 and aud['equal'],
                  '%s: the first auto query did not audition: %r'
                  % (name, first))
            want = 'device: audition verdict' if aud['won'] \
                else 'host: audition verdict'
            check(second['routes'] == {want: 1} and
                  second['auditions'] == 0,
                  '%s: the repeat did not follow the verdict (%s): %r'
                  % (name, want, second['routes']))
            iq.append({'name': name, 'first_s': first['s'],
                       'repeat_s': second['s'], 'key': aud['key'],
                       'won': aud['won'],
                       'device_rate': aud['device_rate'],
                       'host_rate': aud['host_rate'],
                       'repeat_route': want})
            log('auto query %-33s first %.3f s: audition, sums equal, '
                'device %s: %.0f rows/s vs host bincount %.0f rows/s '
                '(%s) | repeat %.3f s: route %s | identical output'
                % (name, first['s'], 'won' if aud['won'] else 'lost',
                   aud['device_rate'], aud['host_rate'], aud['key'],
                   second['s'], want))
    log('auto: auditions %d in the query phase'
        % mod_di.stats_doc()['auditions'])
    return {'scans': scans, 'builds': builds, 'queries': iq,
            'auto_launches': auto_launches}


def parity_bytes(n, density, seed):
    """n random bytes over all 256 values (not JSON), quotes at the given
    density and nowhere else."""
    import numpy as np
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, n, dtype=np.uint8)
    quote = rng.random(n) < density
    arr[(arr == 34) & ~quote] = ord('#')
    arr[quote] = 34
    return arr


def parity_bound_ms(n):
    """Least time for the packed parity: n bytes read once and
    ceil(n / 8) written once, over the memory rate (its operations, a
    compare and an XOR step a byte, are far below the int32 rate)."""
    return (n + (n + 7) // 8) / HBM_BYTES_PER_S * 1e3


def check_parity(bk, arr, label):
    """The kernel against its plain version on the card and against
    parity_numpy, on [:n], exactly."""
    import numpy as np
    import torch
    n = arr.size
    dev = torch.from_numpy(arr.copy()).to(DEVICE)
    got = bk.quote_parity(dev)
    want = bk.quote_parity_ref(dev)
    torch.cuda.synchronize()
    gbits = np.unpackbits(got.cpu().numpy())[:n]
    pbits = np.unpackbits(want.cpu().numpy())[:n]
    nbits = np.asarray(bk.parity_numpy(arr))
    err = int(np.abs(gbits.astype(np.int16) - pbits).max()) if n else 0
    check(np.array_equal(gbits, pbits) and np.array_equal(gbits, nbits),
          'quote-parity kernel differs at %s (n %d): %d bits from the '
          'plain version, %d from parity_numpy'
          % (label, n, int((gbits != pbits).sum()),
             int((gbits != nbits).sum())))
    return err


def time_parity(bk, arr, reps):
    """Device ms per call (CUDA graph of `reps` calls) and eager ms of
    the kernel and of the plain version, on one buffer already on the
    card, the outputs and scratch preallocated."""
    import torch
    dev = torch.from_numpy(arr.copy()).to(DEVICE)
    n = arr.size
    out = torch.empty((n + 7) // 8, dtype=torch.uint8, device=DEVICE)
    scratch = torch.empty(bk.scratch_len(n), dtype=torch.uint8,
                          device=DEVICE)
    t_kernel, e_kernel = cuda_time_ms(
        lambda: bk.quote_parity_into(out, dev, scratch), reps)
    t_plain, e_plain = cuda_time_ms(lambda: bk.quote_parity_ref(dev),
                                    max(3, reps // 10))
    return t_kernel, e_kernel, t_plain, e_plain


def parse_spy(spy, bp):
    """Every ByteParser built while the spy is on, with its parity
    calls counted and timed (host clock): the parse blocks, and the
    parity's share of the parser's parse_seconds."""
    parsers = []

    def wrap_init(orig):
        def init(self, *a, **k):
            orig(self, *a, **k)
            inner = self._parity
            rec = {'calls': 0, 's': 0.0, 'bytes': 0, 'parser': self}

            def parity(arr):
                t0 = time.perf_counter()
                try:
                    return inner(arr)
                finally:
                    rec['s'] += time.perf_counter() - t0
                    rec['calls'] += 1
                    rec['bytes'] += int(arr.size)
            self._parity = parity
            parsers.append(rec)
        return init
    spy.wrap(bp.ByteParser, '__init__', wrap_init)
    return parsers


def parse_phase(cli, mod_ds, ck, tmp, data, records, seed, forced, build,
                reps):
    """Phase 9: the byte lane and K8 on the card.  The kernel against
    its plain version and parity_numpy at PARITY_LENGTHS x
    PARITY_DENSITIES and on the whole data file in one call; its device
    ms, the plain version's, the per-block round trip against
    parity_numpy's host ms, and the bound.  Then the K1 query on the
    forced lane at DN_PARSE=device over the N records (output and
    --counters equal to phase 4's; parity launches equal to the parse
    blocks; K1 once per device batch); the three-metric hour build at
    DN_PARSE=device (tree and --counters equal to phase 6's: its dotted
    paths keep the native lane, with the hidden ineligibility counter);
    and an hour build of FLAT_METRICS at DN_PARSE=device against the
    same on the native lane (tree and --counters identical, one parity
    launch per parse block).  Then,
    at PARSE_SMALL_RECORDS, every lane on the host engine (native,
    vector, device) and the per-record engine (DN_ENGINE=host, and
    --warnings): each output equal to the native lane's, with
    records/s, MB/s and the parity's share of parse_seconds."""
    import numpy as np
    import torch
    from dragnet_tpu_torch import byteparse as bp
    from dragnet_tpu_torch import config as mod_config
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch import metrics_for_index
    from dragnet_tpu_torch import native as mod_native
    from dragnet_tpu_torch.ops import byteparse_kernels as bk
    out = {'shapes': []}
    # the kernel at every length and density, then the whole file
    err = 0
    for n in PARITY_LENGTHS:
        for i, density in enumerate(PARITY_DENSITIES):
            err = max(err, check_parity(
                bk, parity_bytes(n, density, n * 10 + i),
                'density %g' % density))
    log('parse kernel: exact against its plain version and parity_numpy '
        'at %d lengths (0 to %d bytes) x %d quote densities'
        % (len(PARITY_LENGTHS), PARITY_LENGTHS[-1], len(PARITY_DENSITIES)))
    whole = np.fromfile(data, dtype=np.uint8)
    t0 = time.perf_counter()
    check_parity(bk, whole, 'the whole file')
    log('parse kernel: exact on the whole file, %d bytes in one call '
        '(%.2f s with the checks)' % (whole.size, time.perf_counter() - t0))
    for label, arr in (('parse block', parity_bytes(PARSE_BLOCK, 0.05, 3)),
                       ('whole file', whole)):
        n = arr.size
        t_k, e_k, t_p, e_p = time_parity(
            bk, arr, reps if n <= PARSE_BLOCK else 5)
        bound = parity_bound_ms(n)
        row = {'label': label, 'n': n, 'ms': t_k, 'eager_ms': e_k,
               'plain_ms': t_p, 'eager_plain_ms': e_p, 'bound_ms': bound,
               'bound_by': 'bytes', 'library_ms': None,
               'max_abs_err': err}
        if n == PARSE_BLOCK:
            # the device lane's whole call (page-locked copy in, H2D,
            # kernel, D2H, event wait) against parity_numpy on the host
            call = bk.DeviceParity(DEVICE)
            for _ in range(3):
                call(arr)
            t0 = time.perf_counter()
            for _ in range(reps):
                call(arr)
            row['round_trip_ms'] = (time.perf_counter() - t0) / reps * 1e3
            t0 = time.perf_counter()
            for _ in range(max(3, reps // 5)):
                bk.parity_numpy(arr)
            row['numpy_ms'] = (time.perf_counter() - t0) / \
                max(3, reps // 5) * 1e3
        out['shapes'].append(row)
        log('parse kernel quote_parity %-11s %10d B  device ms: kernel '
            '%.4f plain %.4f (eager per call %.4f %.4f)  bound %.6f ms '
            '(bytes), %.1f %% of it%s'
            % (label, n, t_k, t_p, e_k, e_p, bound, 100 * bound / t_k,
               '' if 'round_trip_ms' not in row else
               ' | round trip (pinned copy, H2D, kernel, D2H, wait) %.4f '
               'ms vs parity_numpy %.4f ms on the host'
               % (row['round_trip_ms'], row['numpy_ms'])))
    del whole
    torch.cuda.synchronize()

    spy = Spy()
    parsers = parse_spy(spy, bp)
    batches = {'total': 0, 'device': 0}

    def wrap_try(orig):
        def try_device(self, provider, weights, alive):
            ok = orig(self, provider, weights, alive)
            batches['total'] += 1
            batches['device'] += int(ok)
            return ok
        return try_device
    spy.wrap(mod_ds.DeviceScan, '_try_device', wrap_try)

    def lane_line(rec, what, dt, nbytes, nrec):
        p = rec['parser']
        share = rec['s'] / p.parse_seconds if p.parse_seconds else 0.0
        log('parse %-40s %7.2f s %11.0f records/s %8.1f MB/s | parse %.2f '
            's, parity %.3f s (%.1f %% of it), %d blocks, %d lines '
            'fast, %d fallback'
            % (what, dt, nrec / dt, nbytes / dt / 1e6, p.parse_seconds,
               rec['s'], 100 * share, rec['calls'], p.lines_fast,
               p.lines_fb))
        return {'run': what, 's': dt, 'records_per_s': nrec / dt,
                'mb_per_s': nbytes / dt / 1e6,
                'parse_s': p.parse_seconds, 'parity_s': rec['s'],
                'parity_share': share, 'blocks': rec['calls'],
                'lines_fast': p.lines_fast, 'lines_fallback': p.lines_fb}
    nbytes = os.path.getsize(data)
    runs = []
    try:
        # the K1 query on the forced lane at DN_PARSE=device: launches
        # zeroed just before, read just after
        name, qargs, _ = QUERIES[1]
        argv = ['scan', '--points', '--counters'] + qargs + ['muskie']
        fout, ferr, _ = forced[name]
        del parsers[:]
        with env_scope(DN_PARSE='device'):
            ck.reset_launches()
            t0 = time.monotonic()
            rc, sout, serr = run_cli(cli, argv)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
        nl, npar = ck.launches['onehot_dense'], ck.launches['quote_parity']
        check(rc == 0, 'parse: %s at DN_PARSE=device failed: %s'
              % (name, serr))
        check((sout, serr) == (fout, ferr), 'parse: %s at DN_PARSE=device '
              'differs from phase 4' % name)
        check(len(parsers) == 1, 'parse: %d byte-lane parsers' % len(parsers))
        rec = parsers[0]
        nb = batches['total']
        check(npar == rec['calls'] > 0, 'parse: the parity kernel launched '
              '%d times for %d parse blocks' % (npar, rec['calls']))
        check(nb > 0 and batches['device'] == nb and nl == nb,
              'parse: %d of %d batches on the device, K1 launched %d times'
              % (batches['device'], nb, nl))
        runs.append(lane_line(rec, 'K1 query, forced lane, device lane',
                              dt, nbytes, records))
        runs[-1].update(parity_launches=npar, k1_launches=nl, batches=nb)
        out['launches'] = npar

        # the three-metric hour build at DN_PARSE=device
        _, config = mod_config.ConfigBackendLocal().load()
        metrics = metrics_for_index(config, 'idx')
        ref_tree = tree_files(os.path.join(tmp, 'idx_device'))
        idx = os.path.join(tmp, 'idx_parse_device')
        dsconfig = dict(config.datasource_get('idx'))
        dsconfig['ds_backend_config'] = dict(
            dsconfig['ds_backend_config'], indexPath=idx)
        del parsers[:]
        with env_scope(DN_PARSE='device'):
            ck.reset_launches()
            t0 = time.monotonic()
            res = mod_dsf.DatasourceFile(dsconfig).build(
                metrics, 'hour', engine='device', device=DEVICE)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
        npar = ck.launches['quote_parity']
        tree = tree_files(idx)
        check(tree.keys() == ref_tree.keys() and
              all(tree[k] == ref_tree[k] for k in tree),
              'parse: the DN_PARSE=device build\'s tree differs from phase '
              '6\'s')
        berr = io.StringIO()
        berr.write('indexes for "idx" built\n')
        res.pipeline.dump_counters(berr)
        check(berr.getvalue() == build['counters'], 'parse: the '
              'DN_PARSE=device build\'s --counters differ from phase 6\'s')
        # its metrics read dotted paths (req.method, res.statusCode,
        # req.url), which the byte lane cannot project: the native lane
        # answers, with the hidden ineligibility counter, as in bin/dn
        inel = sum(st.counters.get('parse lane ineligible', 0)
                   for st in res.pipeline.stages)
        check(not parsers and npar == 0 and inel == 1,
              'parse: the dotted three-metric build at DN_PARSE=device: %d '
              'byte-lane parsers, %d parity launches, ineligible counter %d'
              % (len(parsers), npar, inel))
        log('parse build hour x3 at DN_PARSE=device %7.2f s: dotted '
            'projection, the native lane answered (parse lane ineligible '
            '1) | tree and --counters identical to phase 6' % dt)
        runs.append({'run': 'build hour x3 (dotted), DN_PARSE=device',
                     's': dt, 'records_per_s': records / dt,
                     'lane': 'native (ineligible)'})

        # a build the byte lane can take: FLAT_METRICS, at
        # DN_PARSE=device and on the native lane, both on the card
        flat_idx = os.path.join(tmp, 'idx_flat')
        rc, _, err = run_cli(cli, [
            'datasource-add', 'flat', '--path=' + data, '--time-field=time',
            '--index-path=' + flat_idx])
        check(rc == 0, 'datasource-add failed: %s' % err)
        for metric, breakdowns in FLAT_METRICS:
            rc, _, err = run_cli(cli, ['metric-add', '-b', breakdowns,
                                       'flat', metric])
            check(rc == 0, 'metric-add %s failed: %s' % (metric, err))
        argv = ['build', '--interval=hour', '--counters', 'flat']
        flat = {}
        for lane in ('host', 'device'):
            del parsers[:]
            with env_scope(DN_PARSE=lane):
                ck.reset_launches()
                t0 = time.monotonic()
                rc, bout, berr = run_cli(cli, argv)
                torch.cuda.synchronize()
                dt = time.monotonic() - t0
            check(rc == 0, 'parse: flat build at DN_PARSE=%s failed: %s'
                  % (lane, berr))
            flat[lane] = (berr, tree_files(flat_idx),
                          ck.launches['quote_parity'], dt)
            os.rename(flat_idx, flat_idx + '.' + lane)
        check(flat['host'][0] == flat['device'][0] and
              flat['host'][1] == flat['device'][1] and
              len(flat['host'][1]) > 2, 'parse: the flat build\'s tree or '
              '--counters at DN_PARSE=device differ from the native lane\'s')
        npar = flat['device'][2]
        rec = parsers[0]
        check(npar == rec['calls'] > 0 and flat['host'][2] == 0,
              'parse flat build: the parity kernel launched %d times for %d '
              'parse blocks' % (npar, rec['calls']))
        log('parse build hour, flat metrics, native lane %7.2f s | tree '
            'identical to the device lane\'s' % flat['host'][3])
        runs.append(lane_line(rec, 'build hour x2 (flat), device lane',
                              flat['device'][3], nbytes, records))
        runs[-1].update(parity_launches=npar,
                        native_s=flat['host'][3],
                        k1_launches=ck.launches['onehot_dense'])
        out['build_launches'] = npar

        # every lane at PARSE_SMALL_RECORDS, on the host engine and the
        # per-record engine, each output equal to the native lane's
        small = os.path.join(tmp, 'small.log')
        mod_native.gen_to_file(PARSE_SMALL_RECORDS, small, seed=seed + 2)
        sbytes = os.path.getsize(small)
        rc, _, err = run_cli(cli, [
            'datasource-add', 'small', '--path=' + small,
            '--time-field=time', '--filter={"ne":["host","zzz"]}'])
        check(rc == 0, 'datasource-add failed: %s' % err)
        ref = None
        for what, env, extra in (
                ('native lane, host engine', {'DN_PARSE': 'host'}, []),
                ('vector lane, host engine', {'DN_PARSE': 'vector'}, []),
                ('device lane, host engine', {'DN_PARSE': 'device'}, []),
                ('device lane, forced lane', {'DN_PARSE': 'device',
                                              'DN_ENGINE': 'jax'}, []),
                ('per-record engine (DN_ENGINE=host)',
                 {'DN_ENGINE': 'host'}, []),
                ('per-record engine, --warnings', {}, ['--warnings'])):
            env = dict({'DN_ENGINE': 'vector'}, **env)
            argv = ['scan', '--points', '--counters'] + extra + qargs + \
                ['small']
            del parsers[:]
            with env_scope(**env):
                t0 = time.monotonic()
                rc, sout, serr = run_cli(cli, argv)
                torch.cuda.synchronize()
                dt = time.monotonic() - t0
            check(rc == 0, 'parse %s failed: %s' % (what, serr))
            if ref is None:
                ref = (sout, serr)
            check((sout, serr) == ref, 'parse %s: output differs from the '
                  'native lane\'s' % what)
            if parsers:
                runs.append(lane_line(parsers[0], what + ', 200k', dt,
                                      sbytes, PARSE_SMALL_RECORDS))
            else:
                log('parse %-40s %7.2f s %11.0f records/s %8.1f MB/s'
                    % (what + ', 200k', dt, PARSE_SMALL_RECORDS / dt,
                       sbytes / dt / 1e6))
                runs.append({'run': what + ', 200k', 's': dt,
                             'records_per_s': PARSE_SMALL_RECORDS / dt,
                             'mb_per_s': sbytes / dt / 1e6})
        log('parse: every lane and engine identical to the native lane '
            '(%d points)' % ref[0].count('\n'))
    finally:
        spy.restore()
    out['runs'] = runs
    return out


def line_offsets(path, counts):
    """The byte offset just past line counts[i] of a file, for ascending
    counts."""
    out = []
    todo = list(counts)
    off = 0
    with open(path, 'rb') as f:
        for i, line in enumerate(f, 1):
            off += len(line)
            if todo and i == todo[0]:
                out.append(off)
                todo.pop(0)
                if not todo:
                    break
    check(not todo, 'the data file has fewer lines than %r' % counts)
    return out


def copy_bytes(src, dst, start, end):
    """Append src[start:end] to dst."""
    with open(src, 'rb') as f, open(dst, 'ab') as g:
        f.seek(start)
        left = end - start
        while left > 0:
            buf = f.read(min(left, 64 << 20))
            check(buf, 'short read of %s' % src)
            g.write(buf)
            left -= len(buf)


def index_tree_files(root):
    """tree_files without the follow state and the quarantine, which
    are not part of what a query reads."""
    from dragnet_tpu_torch import index_journal as mod_journal
    skip = (mod_journal.FOLLOW_DIR, mod_journal.QUARANTINE_DIR)
    return {k: v for k, v in tree_files(root).items()
            if k.split(os.sep)[0] not in skip}


def add_datasource(cli, name, path, idx, metrics):
    rc, _, err = run_cli(cli, ['datasource-add', name, '--path=' + path,
                               '--time-field=time', '--index-path=' + idx])
    check(rc == 0, 'datasource-add %s failed: %s' % (name, err))
    for metric, breakdowns in metrics:
        rc, _, err = run_cli(cli, ['metric-add', '-b', breakdowns, name,
                                   metric])
        check(rc == 0, 'metric-add %s failed: %s' % (metric, err))


def lifecycle_phase(cli, mod_ds, ck, tmp, data, records, query_outputs):
    """Phase 9b: the index tree's lifecycle on the card.  `dn follow
    --once` (DN_ENGINE=jax, DN_FOLLOW_APPEND=1) after each of
    LIFECYCLE_ROUNDS appends of the N records, every mini-batch folding
    through DeviceScanStack and K1 once per device batch, generations
    pending after rounds 2 on; the queries held to phase 9's flat build;
    `dn compact`, its tree byte-equal to phase 9's native-lane build;
    device memory and page-locked staging across the daemon's batches;
    the rewrite mode over LIFECYCLE_REWRITE_RECORDS against a build; a
    planted kernel fault in one mini-batch, which must end the run with
    rc 1 and no retry; then `dn rollup` on copies of phase 7's trees,
    the query cases equal to phase 7's outputs, the bare one through
    the rollups, and a second rollup a no-op."""
    import shutil
    import torch
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch import rollup as mod_rollup
    from dragnet_tpu_torch.config import ConfigBackendLocal
    from dragnet_tpu_torch.follow import loop as mod_floop
    from dragnet_tpu_torch.follow.checkpoint import Checkpointer
    from dragnet_tpu_torch.obs import metrics as obs_metrics
    reg = obs_metrics.global_registry()
    spy = Spy()
    state = {'batch': 0, 'stack': 0, 'device': 0, 'acc_bytes': 0,
             'ring_allocs': 0, 'ring_bytes': 0, 'fault_at': None,
             'batches': []}

    def wrap_publish(orig):
        def publish_batch(self, batch, recover=True):
            state['batch'] += 1
            d0 = state['device']
            rv = orig(self, batch, recover)
            torch.cuda.synchronize()
            state['batches'].append({
                'records': batch.nlines, 'bytes': batch.nbytes,
                'device_batches': state['device'] - d0,
                'allocated': torch.cuda.memory_allocated(),
                'reserved': torch.cuda.memory_reserved(),
                'ring_allocs': state['ring_allocs'],
                'ring_bytes': state['ring_bytes'],
                'host_pinned': host_pinned()})
            return rv
        return publish_batch

    def wrap_process(orig):
        def process(self, provider, weights, alive):
            state['stack'] += 1
            return orig(self, provider, weights, alive)
        return process

    def wrap_device(orig):
        def process_device(self, provider, weights, alive):
            ok = orig(self, provider, weights, alive)
            state['device'] += int(ok)
            acc = sum(t.numel() * t.element_size() for sc in self.scans
                      for t in (sc._acc or ()) if torch.is_tensor(t))
            state['acc_bytes'] = max(state['acc_bytes'], acc)
            return ok
        return process_device

    def wrap_alloc(orig):
        def alloc(self, slot, nbytes, compute):
            state['ring_allocs'] += 1
            state['ring_bytes'] += nbytes
            return orig(self, slot, nbytes, compute)
        return alloc

    def wrap_kernel(orig):
        def onehot_dense_into(out, fused, weights):
            if state['batch'] == state['fault_at']:
                raise RuntimeError('planted one-hot kernel fault')
            return orig(out, fused, weights)
        return onehot_dense_into

    def host_pinned():
        # the caching host allocator's page-locked bytes in use and
        # held, where this torch reports them
        stats = getattr(torch.cuda, 'host_memory_stats', None)
        if stats is None:
            return None
        keys = ('allocations.current', 'allocated_bytes.current',
                'active_requests.current', 'active_bytes.current',
                'num_host_alloc', 'num_host_free')
        try:
            doc = stats()
        except RuntimeError:
            return None
        return {k: doc[k] for k in keys if k in doc}

    def stage_s(name):
        return reg.histogram(name).sum / 1e3

    def follow(name, extra_env):
        """One `follow --once` of datasource `name`: (rc, stdout,
        stderr, wall s, its mini-batches, scan s, publish s)."""
        b0 = len(state['batches'])
        s0, p0 = stage_s('follow_scan_ms'), stage_s('follow_publish_ms')
        with env_scope(**dict(FOLLOW_KNOBS, **extra_env)):
            t0 = time.monotonic()
            rc, out, err = run_cli(cli, ['follow', '--once',
                                         '--interval=hour', name])
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
        return (rc, out, err, dt, state['batches'][b0:],
                stage_s('follow_scan_ms') - s0,
                stage_s('follow_publish_ms') - p0)

    def query(args, name):
        t0 = time.monotonic()
        rc, out, err = run_cli(cli, ['query', '--points', '--counters',
                                     '--interval=hour'] + args + [name])
        torch.cuda.synchronize()
        check(rc == 0 and out, 'lifecycle: query %r of %s failed: %s'
              % (args, name, err))
        return out, err, time.monotonic() - t0

    spy.wrap(mod_floop.FollowLoop, 'publish_batch', wrap_publish)
    spy.wrap(mod_ds.DeviceScanStack, 'process', wrap_process)
    spy.wrap(mod_ds.DeviceScanStack, '_process_device', wrap_device)
    spy.wrap(mod_ds._StagingRing, '_alloc', wrap_alloc)
    spy.wrap(ck, 'onehot_dense_into', wrap_kernel)
    doc = {}
    try:
        flat_ref = os.path.join(tmp, 'idx_flat.host')
        add_datasource(cli, 'flat_ref', data, flat_ref, FLAT_METRICS)
        ref_tree = index_tree_files(flat_ref)
        check(len(ref_tree) > 2, 'lifecycle: phase 9\'s flat tree is '
              'missing')

        # follow, append mode, on the card: the follow path's counts
        # zeroed just before its rounds, read just after
        log_path = os.path.join(tmp, 'follow.log')
        idx = os.path.join(tmp, 'idx_follow')
        add_datasource(cli, 'follow', log_path, idx, FLAT_METRICS)
        open(log_path, 'wb').close()
        per = records // LIFECYCLE_ROUNDS
        offs = [0] + line_offsets(data, [per * (i + 1) for i in
                                         range(LIFECYCLE_ROUNDS - 1)]) + \
            [os.path.getsize(data)]
        rounds = []
        ck.reset_launches()
        st0, dv0 = state['stack'], state['device']
        for r in range(LIFECYCLE_ROUNDS):
            copy_bytes(data, log_path, offs[r], offs[r + 1])
            nrec = per if r < LIFECYCLE_ROUNDS - 1 else \
                records - per * (LIFECYCLE_ROUNDS - 1)
            rc, out, err, dt, batches, scan_s, pub_s = follow(
                'follow', {'DN_FOLLOW_APPEND': '1'})
            check(rc == 0 and not out and not err,
                  'lifecycle: follow round %d failed (rc %d): %s'
                  % (r + 1, rc, err[-400:]))
            check(batches and all(b['device_batches'] > 0
                                  for b in batches),
                  'lifecycle: round %d: a mini-batch did not fold on the '
                  'device: %r' % (r + 1, [b['device_batches']
                                          for b in batches]))
            gens = mod_rollup.compaction_backlog(idx, 'hour')
            if r >= 1:
                check(gens > 0, 'lifecycle: no generation pending after '
                      'round %d' % (r + 1))
            rounds.append({
                'round': r + 1, 'records': nrec, 'wall_s': dt,
                'records_per_s': nrec / dt, 'mini_batches': len(batches),
                'device_batches': sum(b['device_batches']
                                      for b in batches),
                'scan_s': scan_s, 'publish_s': pub_s,
                'generations_pending': gens})
            log('lifecycle follow round %d (append): %d records in %.2f s '
                '(%.0f records/s), %d mini-batches, %d device batches | '
                'follow.scan %.2f s, follow.publish %.2f s | %d '
                'generations pending'
                % (r + 1, nrec, dt, nrec / dt, len(batches),
                   rounds[-1]['device_batches'], scan_s, pub_s, gens))
        follow_launches = ck.launches['onehot_dense']
        nstack, ndev = state['stack'] - st0, state['device'] - dv0
        check(ndev > 0 and nstack == ndev and follow_launches == ndev,
              'lifecycle: %d stacked batches, %d on the device, K1 '
              'launched %d times' % (nstack, ndev, follow_launches))
        doc['follow'] = {'rounds': rounds, 'stacked_batches': ndev,
                         'k1_launches': follow_launches}
        log('lifecycle follow: %d stacked batches, all on the device, K1 '
            'launched %d times (once per device batch)'
            % (ndev, follow_launches))

        # memory across the daemon's batches
        run_batches = state['batches'][:sum(r['mini_batches']
                                            for r in rounds)]
        first, last = run_batches[0], run_batches[-1]
        grew = last['allocated'] - first['allocated']
        doc['memory'] = {'first': first, 'last': last,
                         'allocated_growth': grew,
                         'accumulator_bytes': state['acc_bytes']}
        log('lifecycle memory after mini-batch 1 | %d: allocated %d | %d '
            'B, reserved %d | %d B, staging slots allocated %d | %d '
            '(%d | %d page-locked B); growth %d B against one batch\'s '
            'accumulators, %d B'
            % (len(run_batches), first['allocated'], last['allocated'],
               first['reserved'], last['reserved'], first['ring_allocs'],
               last['ring_allocs'], first['ring_bytes'],
               last['ring_bytes'], grew, state['acc_bytes']))
        log('lifecycle page-locked host memory (caching allocator) after '
            'mini-batch 1 | %d: %r | %r' % (len(run_batches),
                                            first['host_pinned'],
                                            last['host_pinned']))
        check(grew <= state['acc_bytes'], 'lifecycle: device memory grew '
              'by %d B across %d mini-batches' % (grew, len(run_batches)))

        # the queries over the generation-bearing tree (the walk finds
        # the generation files too, so only the points are compared),
        # then compaction, then the same queries with their counters
        qdoc = []
        for qname, qargs in LIFECYCLE_QUERIES:
            fout, ferr, ft = query(qargs, 'follow')
            rout, rerr, rt = query(qargs, 'flat_ref')
            check(fout == rout, 'lifecycle: query %s over the follow '
                  'tree differs from phase 9\'s build' % qname)
            qdoc.append({'name': qname, 'points': rout.count('\n'),
                         'generations_s': ft, 'build_tree_s': rt})
        gens = mod_rollup.compaction_backlog(idx, 'hour')
        t0 = time.monotonic()
        rc, out, err = run_cli(cli, ['compact', '--tree', idx,
                                     '--interval', 'hour'])
        ct = time.monotonic() - t0
        check(rc == 0 and err.startswith('dn compact: '),
              'lifecycle: compact failed: %s' % err)
        check(mod_rollup.compaction_backlog(idx, 'hour') == 0,
              'lifecycle: generations left after compact')
        tree = index_tree_files(idx)
        check(tree.keys() == ref_tree.keys() and
              all(tree[k] == ref_tree[k] for k in tree),
              'lifecycle: the compacted follow tree differs from phase '
              '9\'s native-lane build: %r'
              % sorted(k for k in set(tree) | set(ref_tree)
                       if tree.get(k) != ref_tree.get(k)))
        for q, (qname, qargs) in zip(qdoc, LIFECYCLE_QUERIES):
            fout, ferr, ft = query(qargs, 'follow')
            rout, rerr, rt = query(qargs, 'flat_ref')
            check((fout, ferr) == (rout, rerr), 'lifecycle: query %s '
                  'after compaction differs' % qname)
            q['compacted_s'] = ft
        doc['compact'] = {'wall_s': ct, 'generations_removed': gens,
                          'message': err.strip(), 'queries': qdoc}
        log('lifecycle compact: %.2f s, %d generations removed (%s); the '
            'tree byte-equal to phase 9\'s build (%d files, catalog '
            'included); queries equal before and after: %s'
            % (ct, gens, err.strip(), len(tree),
               ', '.join('%s %d points (%.3f s with generations, %.3f s '
                         'compacted)' % (q['name'], q['points'],
                                         q['generations_s'],
                                         q['compacted_s'])
                         for q in qdoc)))

        # rewrite mode over the first LIFECYCLE_REWRITE_RECORDS
        rw_log = os.path.join(tmp, 'follow_rw.log')
        rw_idx = os.path.join(tmp, 'idx_follow_rw')
        nrw = min(records, LIFECYCLE_REWRITE_RECORDS)
        open(rw_log, 'wb').close()
        copy_bytes(data, rw_log, 0, line_offsets(data, [nrw])[0])
        add_datasource(cli, 'follow_rw', rw_log, rw_idx, FLAT_METRICS)
        add_datasource(cli, 'rw_ref', rw_log,
                       os.path.join(tmp, 'idx_rw_ref'), FLAT_METRICS)
        rc, out, err, dt, batches, scan_s, pub_s = follow('follow_rw', {})
        check(rc == 0 and not err, 'lifecycle: rewrite-mode follow '
              'failed: %s' % err[-400:])
        check(all(b['device_batches'] > 0 for b in batches),
              'lifecycle: a rewrite-mode mini-batch did not fold on the '
              'device')
        with env_scope(DN_ENGINE='jax'):
            rc, _, err = run_cli(cli, ['build', '--interval=hour',
                                       'rw_ref'])
        check(rc == 0, 'lifecycle: rw_ref build failed: %s' % err)
        check(index_tree_files(rw_idx) ==
              index_tree_files(os.path.join(tmp, 'idx_rw_ref')),
              'lifecycle: the rewrite-mode follow tree differs from a '
              'build of the same records')
        doc['rewrite'] = {'records': nrw, 'wall_s': dt,
                          'records_per_s': nrw / dt,
                          'mini_batches': len(batches),
                          'scan_s': scan_s, 'publish_s': pub_s}
        log('lifecycle follow (rewrite): %d records in %.2f s (%.0f '
            'records/s), %d mini-batches | follow.scan %.2f s, '
            'follow.publish %.2f s | tree = a build of the same records'
            % (nrw, dt, nrw / dt, len(batches), scan_s, pub_s))

        # a device fault in one mini-batch: rc 1, no retry, checkpoint at
        # the last good batch
        f_log = os.path.join(tmp, 'follow_fault.log')
        f_idx = os.path.join(tmp, 'idx_follow_fault')
        nf = min(records, LIFECYCLE_FAULT_RECORDS)
        open(f_log, 'wb').close()
        copy_bytes(data, f_log, 0, line_offsets(data, [nf])[0])
        add_datasource(cli, 'follow_fault', f_log, f_idx, FLAT_METRICS)
        state['fault_at'] = state['batch'] + LIFECYCLE_FAULT_BATCH
        try:
            rc, out, err, dt, batches, _, _ = follow('follow_fault', {})
        finally:
            state['fault_at'] = None
        ckpt = Checkpointer(f_idx).load()
        check(rc == 1 and not out and
              err.startswith('dn: mini-batch %d (' % LIFECYCLE_FAULT_BATCH)
              and 'planted one-hot kernel fault' in err and
              'publish failed (attempt' not in err,
              'lifecycle: the planted device fault: rc %d, stderr %r'
              % (rc, err[-400:]))
        check(ckpt is not None and
              ckpt['seq'] == LIFECYCLE_FAULT_BATCH - 1 and
              len(batches) == LIFECYCLE_FAULT_BATCH - 1 and
              ckpt['sources'][0]['offset'] ==
              sum(b['bytes'] for b in batches),
              'lifecycle: the checkpoint after the fault: %r' % ckpt)
        doc['fault'] = {'rc': rc, 'stderr': err.strip(),
                        'checkpoint_seq': ckpt['seq'],
                        'checkpoint_offset': ckpt['sources'][0]['offset']}
        log('lifecycle device fault: rc 1 in %.2f s, no retry, checkpoint '
            'seq %d at byte %d | %s'
            % (dt, ckpt['seq'], ckpt['sources'][0]['offset'],
               err.strip()[:160]))

        # rollups on copies of phase 7's trees
        month = os.path.join(tmp, 'idx_month')
        _, config = ConfigBackendLocal().load()
        mdoc = config.datasource_get('month')
        mdata = mdoc['ds_backend_config']['path']
        rdoc = {}
        captured = []

        def wrap_query(orig):
            def q(self, *a, **k):
                rv = orig(self, *a, **k)
                captured.append(rv)
                return rv
            return q
        spy.wrap(mod_dsf.DatasourceFile, 'query', wrap_query)
        for interval in ('hour', 'day'):
            copy = os.path.join(tmp, 'idx_month_rollup_' + interval)
            shutil.copytree(month, copy)
            name = 'month_' + interval
            add_datasource(cli, name, mdata, copy,
                           [(m, b) for m, b, _ in BUILD_METRICS])
            cases = [c for c in QUERY_CASES
                     if '--interval=' + interval in c[1]]
            before = {}
            for qname, qargs, _ in cases:
                t0 = time.monotonic()
                rc, out, err = run_cli(cli, ['query', '--points',
                                             '--counters'] + qargs +
                                       [name])
                torch.cuda.synchronize()
                before[qname] = time.monotonic() - t0
            t0 = time.monotonic()
            rc, out, err = run_cli(cli, ['rollup', '--tree', copy,
                                         '--interval', interval])
            rt = time.monotonic() - t0
            check(rc == 0 and 'shard(s) built' in err,
                  'lifecycle: rollup --interval %s failed: %s'
                  % (interval, err))
            first_msg = err.strip()
            built = int(err.split(': ')[1].split(' ')[0])
            check(built > 0, 'lifecycle: rollup built nothing')
            rc, _, err2 = run_cli(cli, ['rollup', '--tree', copy,
                                        '--interval', interval])
            check(rc == 0 and err2.startswith('dn rollup: 0 shard(s) '
                                              'built'),
                  'lifecycle: a second rollup built shards: %s' % err2)
            qrows = []
            for qname, qargs, _ in cases:
                del captured[:]
                t0 = time.monotonic()
                rc, out, err = run_cli(cli, ['query', '--points',
                                             '--counters'] + qargs +
                                       [name])
                torch.cuda.synchronize()
                qt = time.monotonic() - t0
                check(rc == 0 and (out, err) == query_outputs[qname],
                      'lifecycle: query %s over the rollups differs from '
                      'phase 7\'s output' % qname)
                via = sum(st.counters.get('index shards via rollup', 0)
                          for st in captured[-1].pipeline.stages)
                if qargs == ['--interval=hour']:
                    check(via > 0, 'lifecycle: the bare query did not '
                          'engage the rollups')
                qrows.append({'name': qname, 'before_s': before[qname],
                              'after_s': qt, 'via_rollup': via})
                log('lifecycle query %-33s %.3f s before the rollups, '
                    '%.3f s after (%d shards via rollups) | = phase 7'
                    % (qname, before[qname], qt, via))
            rdoc[interval] = {'wall_s': rt, 'built': built,
                              'message': first_msg,
                              'again': err2.strip(), 'queries': qrows}
            log('lifecycle rollup --interval %s: %s in %.2f s; again: %s'
                % (interval, first_msg, rt, err2.strip()))
        doc['rollup'] = rdoc
    finally:
        spy.restore()
    return doc


def percentile(values, q):
    """The q-quantile (0..1) of `values`, nearest rank."""
    s = sorted(values)
    return s[min(len(s) - 1, max(0, int(round(q * len(s) + 0.5)) - 1))]


def served(tserver, cli, argv):
    """One CLI call through the server's thread-stdio router (the
    in-process server's workers write through it too, so a global
    redirect would swallow their bytes): (rc, stdout, stderr, s)."""
    t0 = time.monotonic()
    with tserver.thread_stdio() as cap:
        rc = cli.main(list(argv))
    out, err = cap.finish()
    return rc, out.decode(), err.decode(), time.monotonic() - t0


def serve_phase(cli, ck, tmp, records, query_outputs, forced,
                main_launches, reps):
    """Phase 12: `dn serve` on the card over a copy of phase 7's hour
    tree (see the module docstring).  Returns the `serve` doc and the
    K7 and K7a kernel entries."""
    import gc
    import shutil
    import threading
    import torch
    from dragnet_tpu_torch import device_index as mod_di
    from dragnet_tpu_torch import index_query_stack as mod_iqs
    from dragnet_tpu_torch.serve import residency as mod_res
    from dragnet_tpu_torch.serve import server as tserver
    from dragnet_tpu_torch.config import ConfigBackendLocal
    t_phase = time.monotonic()
    doc = {}
    copy = os.path.join(tmp, 'idx_serve')
    shutil.copytree(os.path.join(tmp, 'idx_month'), copy)
    _, config = ConfigBackendLocal().load()
    mdata = config.datasource_get('month')['ds_backend_config']['path']
    add_datasource(cli, 'served', mdata, copy,
                   [(m, b) for m, b, _ in BUILD_METRICS])
    qargv = {name: ['--points', '--counters'] + qargs + ['served']
             for name, qargs, _ in QUERY_CASES}
    kernel_scans = [(name, qargs) for name, qargs, route in QUERIES
                    if route == 'kernel']
    sock = os.path.join(tmp, 'dn.sock')
    spy = Spy()
    stage_calls = [0]
    worker_k1 = [0]
    fold_args = []

    def wrap_stage(orig):
        def stage(inv_sl):
            stage_calls[0] += 1
            return orig(inv_sl)
        return stage

    def wrap_fold(orig):
        def fold(lmat, wmat, ttabs, acc):
            if not fold_args:
                # kept on the host, out of the drain's memory check
                fold_args.append(tuple(x.to('cpu', copy=True) for x in
                                       (lmat, wmat, ttabs, acc)))
            return orig(lmat, wmat, ttabs, acc)
        return fold

    def wrap_k1(orig):
        def k1(out, fused, weights):
            if threading.current_thread() is not threading.main_thread():
                worker_k1[0] += 1
            return orig(out, fused, weights)
        return k1
    spy.wrap(mod_di, '_stage_shard', wrap_stage)
    spy.wrap(mod_di, '_fold_program', wrap_fold)
    spy.wrap(ck, 'onehot_dense_into', wrap_k1)
    knobs = {'DN_ENGINE': 'jax', 'DN_DEVICE_RESIDENCY_MB': '4096',
             'DN_DEVICE_PREWARM': '1'}
    try:
        with env_scope(**knobs):
            gc.collect()
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            # the counts: zeroed just before the served path, read
            # just after it
            ck.reset_launches()
            mod_di._reset_engagement()
            mod_iqs.launches['sums'] = 0
            t0 = time.monotonic()
            srv = tserver.DnServer(socket_path=sock,
                                   conf={'max_inflight': 4}).start()
            bind_s = time.monotonic() - t0
            try:
                doc.update(_serve_checks(
                    cli, ck, tserver, srv, mod_di, mod_res, qargv,
                    query_outputs, kernel_scans, forced, main_launches,
                    stage_calls, worker_k1))
                lat_on = _latency(cli, tserver, sock, qargv, query_outputs)
            finally:
                srv.stop()
            torch.cuda.synchronize()
            serve_launches = {'onehot_dense': ck.launches['onehot_dense'],
                              'quote_parity': ck.launches['quote_parity'],
                              'fold': mod_di.stats_doc()['dispatches'],
                              'sums': mod_iqs.launches['sums'],
                              'onehot_dense_from_workers': worker_k1[0]}
            mem_after = torch.cuda.memory_allocated()
            check(mod_res.active() is None, 'serve: residency survived '
                  'the drain')
            check(mem_after - mem_before <= DRAIN_SLACK_BYTES,
                  'serve: device memory after the drain %d B, before the '
                  'server %d B' % (mem_after, mem_before))
            log('serve drain: stop() done, device memory %d B before the '
                'server, %d B after its drain (bind %.3f s)'
                % (mem_before, mem_after, bind_s))
        spy.restore()
        with env_scope(DN_ENGINE='jax', DN_DEVICE_RESIDENCY_MB='0',
                       DN_DEVICE_PREWARM='0'):
            srv = tserver.DnServer(socket_path=sock,
                                   conf={'max_inflight': 4}).start()
            try:
                lat_off = _latency(cli, tserver, sock, qargv,
                                   query_outputs)
            finally:
                srv.stop()
            lat_cold = _cold_latency(qargv, query_outputs)
    finally:
        spy.restore()
    doc['latency_s'] = {'residency': lat_on, 'no_residency': lat_off,
                        'cold_process': lat_cold}
    for label, lat in doc['latency_s'].items():
        log('serve latency of query (b), %-13s n=%d  p50 %.4f s  p99 '
            '%.4f s  min %.4f s  max %.4f s'
            % (label, len(lat), percentile(lat, 0.5),
               percentile(lat, 0.99), min(lat), max(lat)))
    doc['memory'] = {'before_server': mem_before, 'after_drain': mem_after}
    doc['launches'] = serve_launches
    doc['wall_s'] = time.monotonic() - t_phase
    log('serve: launches %r; phase %.1f s' % (serve_launches,
                                              doc['wall_s']))
    k7 = _k7_entry(mod_di, fold_args, serve_launches['fold'], reps)
    k7a = _k7a_entry(mod_iqs, serve_launches['sums'], reps)
    return doc, k7, k7a


def _serve_checks(cli, ck, tserver, srv, mod_di, mod_res, qargv,
                  query_outputs, kernel_scans, forced, main_launches,
                  stage_calls, worker_k1):
    import threading
    import torch
    from dragnet_tpu_torch.obs import metrics as obs_metrics
    doc = {}
    sock = srv.socket_path
    deadline = srv.device_conf['probe_timeout_s']
    pw = srv.wait_prewarm(deadline)
    check(pw is not None and pw['state'] == 'ok' and pw['programs'] == 2,
          'serve: prewarm %r' % (pw,))
    doc['prewarm'] = pw
    log('serve prewarm: %s, %d K7a shapes, %.3f ms (backend %s)'
        % (pw['state'], pw['programs'], pw['ms'], pw['backend']))
    mgr = mod_res.active()
    stacked = [n for n, _, route in QUERY_CASES if route == 'device']

    def run_pass(label):
        r0, e0, s0 = mgr.stats(), mod_di.stats_doc(), stage_calls[0]
        walls = {}
        for name, _, _ in QUERY_CASES:
            rc, out, err, dt = served(tserver, cli, ['query', '--remote',
                                                     sock] + qargv[name])
            check(rc == 0 and (out, err) == query_outputs[name],
                  'serve %s: query %s differs from phase 7 (rc %d): %s'
                  % (label, name, rc, err[-300:]))
            walls[name] = dt
        torch.cuda.synchronize()
        r1, e1 = mgr.stats(), mod_di.stats_doc()
        d = {k: r1[k] - r0[k] for k in ('hits', 'misses', 'stale_drops',
                                        'h2d_saved_bytes',
                                        'd2h_saved_bytes')}
        d.update({k: e1[k] - e0[k] for k in ('dispatches', 'h2d_bytes',
                                              'pinned_shard_hits',
                                              'h2d_saved_bytes')
                  if k != 'h2d_saved_bytes'})
        d['shard_h2d_saved'] = e1['h2d_saved_bytes'] - e0['h2d_saved_bytes']
        d['staged_shards'] = stage_calls[0] - s0
        d['pinned_bytes'] = r1['bytes']
        d['shard_bytes'] = r1['shard_bytes']
        d['walls_s'] = walls
        log('serve %s: %s | %s' % (label, fmt_times(walls, 3), ', '.join(
            '%s %s' % (k, v) for k, v in sorted(d.items())
            if k != 'walls_s')))
        return d

    p1 = run_pass('pass 1 (misses)')
    check(p1['dispatches'] > 0 and p1['shard_bytes'] > 0,
          'serve pass 1: no fold or no shard pin: %r' % p1)
    p2 = run_pass('pass 2 (accumulator hits)')
    check(p2['hits'] == len(stacked) and p2['dispatches'] == 0 and
          p2['d2h_saved_bytes'] > 0,
          'serve pass 2: expected %d accumulator hits and no dispatch: %r'
          % (len(stacked), p2))
    mgr.drop_host_pins()
    p3 = run_pass('pass 3 (pinned shards)')
    check(p3['pinned_shard_hits'] == p3['staged_shards'] ==
          p1['staged_shards'] and p3['dispatches'] == p1['dispatches'],
          'serve pass 3: pinned shard hits %d of %d staged (pass 1 %d)'
          % (p3['pinned_shard_hits'], p3['staged_shards'],
             p1['staged_shards']))
    check(p3['h2d_bytes'] == p1['h2d_bytes'] - p3['shard_h2d_saved'],
          'serve pass 3: uploaded %d B, expected only the translation '
          'tables (%d B)' % (p3['h2d_bytes'],
                             p1['h2d_bytes'] - p3['shard_h2d_saved']))
    doc['passes'] = [p1, p2, p3]

    # served scans through K1
    scans = {}
    for name, qargs in kernel_scans:
        l0 = ck.launches['onehot_dense']
        rc, out, err, dt = served(tserver, cli, [
            'scan', '--remote', sock, '--points', '--counters'] + qargs +
            ['muskie'])
        torch.cuda.synchronize()
        check(rc == 0 and (out, err) == forced[name][:2],
              'serve: scan %s differs from phase 4: %s' % (name, err[-300:]))
        scans[name] = {'wall_s': dt,
                       'launches': ck.launches['onehot_dense'] - l0}
        log('serve scan %-36s %.2f s, K1 launches %d | = phase 4'
            % (name, dt, scans[name]['launches']))
    nk1 = sum(s['launches'] for s in scans.values())
    check(nk1 == main_launches, 'serve: served scans launched K1 %d '
          'times, phase 4 %d (once per device batch)' % (nk1, main_launches))
    doc['scans'] = scans

    # concurrency: 8 client threads, the remote queries and the K1 scan
    mix = [('query', n) for n in ('a host x url, day',
                                  'b method x status >= 500, hour',
                                  'c (b) over one week, hour',
                                  'e no breakdowns, hour')]
    mix.append(('scan', kernel_scans[0][0]))
    scan_argv = ['--points', '--counters'] + kernel_scans[0][1] + ['muskie']
    errors = []
    w0 = worker_k1[0]
    barrier = threading.Barrier(CONCURRENT_CLIENTS)

    def client(tid):
        barrier.wait()
        for k in range(2):
            kind, name = mix[(tid + 2 * k) % len(mix)]
            if kind == 'query':
                argv = ['query', '--remote', sock] + qargv[name]
                want = query_outputs[name]
            else:
                argv = ['scan', '--remote', sock] + scan_argv
                want = forced[name][:2]
            rc, out, err, dt = served(tserver, cli, argv)
            if rc != 0 or (out, err) != want:
                errors.append((tid, name, rc, err[-200:]))
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(CONCURRENT_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    conc_s = time.monotonic() - t0
    check(not errors, 'serve concurrency: %r' % errors[:3])
    st = srv.stats_doc()
    doc['concurrency'] = {'clients': CONCURRENT_CLIENTS,
                          'requests': 2 * CONCURRENT_CLIENTS,
                          'wall_s': conc_s,
                          'k1_worker_launches': worker_k1[0] - w0,
                          'coalesced': st['requests']['coalesced']}
    log('serve concurrency: %d clients x 2 requests in %.2f s, all equal '
        'to the serial answers; K1 launches from worker threads %d; '
        'coalesced %d' % (CONCURRENT_CLIENTS, conc_s, worker_k1[0] - w0,
                          st['requests']['coalesced']))

    # a write through the server bumps the epoch
    rc, out, err, dt = served(tserver, cli, ['build', '--remote', sock,
                                             '--interval=hour', 'served'])
    check(rc == 0 and err == 'indexes for "served" built\n',
          'serve: build --remote failed: %s' % err[-300:])
    b = 'b method x status >= 500, hour'
    s0 = mgr.stats()['stale_drops']
    rc, out, err, _ = served(tserver, cli, ['query', '--remote', sock] +
                             qargv[b])
    stale = mgr.stats()['stale_drops'] - s0
    check(rc == 0 and (out, err) == query_outputs[b] and stale > 0,
          'serve: after the write, stale drops %d, output %s'
          % (stale, 'equal' if (out, err) == query_outputs[b] else err))
    doc['write'] = {'build_s': dt, 'stale_drops': stale}
    log('serve write: build --remote --interval=hour %.2f s; the next '
        'query (b) dropped %d stale pins | = phase 7' % (dt, stale))

    # a planted fault in the K7 fold fails one request only
    mgr.clear()
    real = mod_di._fold_program
    planted = []

    def broken(*a):
        if not planted:
            planted.append(1)
            raise RuntimeError('planted K7 fold fault')
        return real(*a)
    mod_di._fold_program = broken
    try:
        rc, out, err, _ = served(tserver, cli, ['query', '--remote',
                                                sock] + qargv[b])
    finally:
        mod_di._fold_program = real
    check(rc == 1 and out == '' and err.startswith('dn: ') and
          'planted K7 fold fault' in err,
          'serve: the planted fault gave rc %d: %s' % (rc, err[-300:]))
    rc2, out2, err2, _ = served(tserver, cli, ['query', '--remote', sock] +
                                qargv[b])
    check(rc2 == 0 and (out2, err2) == query_outputs[b],
          'serve: the request after the fault failed: %s' % err2[-300:])
    doc['fault'] = {'rc': rc, 'stderr': err.strip()}
    log('serve fault: rc %d, %s; the next request = phase 7'
        % (rc, err.strip()[:120]))
    doc['stats_requests'] = srv.stats_doc()['requests']
    doc['pipeline'] = obs_metrics.pipeline_doc()
    return doc


def _latency(cli, tserver, sock, qargv, query_outputs):
    b = 'b method x status >= 500, hour'
    walls = []
    for _ in range(LATENCY_REPEATS):
        rc, out, err, dt = served(tserver, cli, ['query', '--remote',
                                                 sock] + qargv[b])
        check(rc == 0 and (out, err) == query_outputs[b],
              'serve latency: query (b) differs: %s' % err[-300:])
        walls.append(dt)
    return walls


def _cold_latency(qargv, query_outputs):
    """Query (b) in a fresh `python -m dragnet_tpu_torch` process."""
    b = 'b method x status >= 500, hour'
    here = os.path.dirname(os.path.abspath(__file__))
    walls = []
    for _ in range(COLD_REPEATS):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, '-m', 'dragnet_tpu_torch', 'query'] +
            qargv[b], cwd=here, env=dict(os.environ),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            timeout=300)
        walls.append(time.monotonic() - t0)
        check(proc.returncode == 0 and
              (proc.stdout, proc.stderr) == query_outputs[b],
              'serve: the cold query differs: %s' % proc.stderr[-300:])
    return walls


def _k7_entry(mod_di, fold_args, launches, reps):
    """K7 on one dispatch the served path gave it, against the plain
    numpy sums, timed with the plain torch version (a per-slot loop)."""
    import numpy as np
    import torch
    check(fold_args, 'serve: no K7 dispatch was captured')
    lmat, wmat, ttabs, acc0 = (x.to(DEVICE) for x in fold_args[0])
    out = mod_di._fold_program(lmat, wmat, ttabs, acc0.clone())
    ref = acc0.cpu().numpy().copy()
    ln, wn, tn = (x.cpu().numpy() for x in (lmat, wmat, ttabs))
    for j in range(ln.shape[0]):
        np.add.at(ref, tn[j][ln[j]], wn[j])
    err = int(np.abs(out.cpu().numpy() - ref).max())
    check(err == 0, 'K7: the fold differs from the plain sums by %d' % err)
    scratch = acc0.clone()
    ms, eager = cuda_time_ms(
        lambda: mod_di._fold_program(lmat, wmat, ttabs, scratch), reps)

    def plain():
        for j in range(lmat.shape[0]):
            scratch.index_add_(0, ttabs[j][lmat[j]], wmat[j])
    plain_ms, _ = cuda_time_ms(plain, reps)
    s, prow = lmat.shape
    nbytes = s * prow * K7_ROW_BYTES + ttabs.numel() * K7_TAB_BYTES + \
        acc0.numel() * K7_SEG_BYTES
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log('K7 on a served dispatch (%d slots x %d rows, %d segments): exact, '
        '%.4f ms (eager %.4f), plain %.4f ms, bound %.6f ms'
        % (s, prow, acc0.numel(), ms, eager, plain_ms, bound))
    return {'name': 'index_fold', 'route': 'cuda',
            'impl': 'torch ops (gather + i64 index_add_), the reference\'s '
                    'jitted XLA program; not a Pallas kernel',
            'source': 'dragnet_tpu_torch/device_index.py',
            'replaces': K7_REPLACES, 'launches': launches,
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': 'bytes', 'library_ms': None,
            'eager_ms': eager,
            'shape': {'slots': s, 'rows': prow, 'segments': acc0.numel()}}


def _k7a_entry(mod_iqs, launches, reps):
    """K7a at both pre-warm shapes against the plain numpy sums, timed
    with the plain torch version (scatter_add_) and index_add_ alone."""
    import numpy as np
    import torch
    from dragnet_tpu_torch.serve import residency as mod_res
    rows = []
    for pn, pu in mod_res._PREWARM_SHAPES:
        rng = np.random.RandomState(pn)
        seg_n = rng.randint(0, pu, size=pn).astype(np.int64)
        w_n = rng.randint(0, 1 << 20, size=pn).astype(np.int64)
        seg = torch.from_numpy(seg_n).to(DEVICE)
        w = torch.from_numpy(w_n).to(DEVICE)
        prog = mod_iqs._sums_program(pn, pu)
        ref = np.zeros(pu, dtype=np.int64)
        np.add.at(ref, seg_n, w_n)
        err = int(np.abs(prog(seg, w).cpu().numpy() - ref).max())
        check(err == 0, 'K7a: (%d, %d) differs by %d' % (pn, pu, err))
        ms, eager = cuda_time_ms(lambda: prog(seg, w), reps)
        plain_ms, _ = cuda_time_ms(
            lambda: torch.zeros(pu, dtype=torch.int64,
                                device=DEVICE).scatter_add_(0, seg, w),
            reps)
        acc = torch.zeros(pu, dtype=torch.int64, device=DEVICE)
        lib_ms, _ = cuda_time_ms(lambda: acc.index_add_(0, seg, w), reps)
        bound = (16 * pn + 8 * pu) / HBM_BYTES_PER_S * 1e3
        rows.append({'pn': pn, 'pu': pu, 'max_abs_err': err, 'ms': ms,
                     'eager_ms': eager, 'plain_ms': plain_ms,
                     'library_ms': lib_ms, 'bound_ms': bound})
        log('K7a at (%d, %d): exact, %.4f ms (eager %.4f), plain %.4f ms, '
            'index_add_ alone %.4f ms, bound %.6f ms'
            % (pn, pu, ms, eager, plain_ms, lib_ms, bound))
    big = rows[-1]
    return {'name': 'index_sums', 'route': 'cuda',
            'impl': 'torch ops (one i64 index_add_ into zeros), the '
                    'reference\'s jitted XLA program; not a Pallas kernel',
            'source': 'dragnet_tpu_torch/index_query_stack.py',
            'replaces': K7A_REPLACES, 'launches': launches,
            'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': big['ms'], 'plain_ms': big['plain_ms'],
            'bound_ms': big['bound_ms'], 'bound_by': 'bytes',
            'library_ms': big['library_ms'], 'eager_ms': big['eager_ms'],
            'shape': {'pn': big['pn'], 'pu': big['pu']}, 'shapes': rows}


# phase 13: the cluster backend.  Phase 7's records split into one file
# a day under %Y/%m-%d, behind a file datasource and a --backend=cluster
# one; phase 4's two kernel scans on (i) the process's own mesh (one
# card: one shard) and (ii) a mesh of two shards on the one card
# (make_mesh through the library); (iii) two processes sharing the card
# over gloo (`chip_smoke.py --cluster-child`): the scans, the hour build
# of phase 6's metrics, index-scan of its first metric and queries (b)
# and (d) of phase 7 over the cluster-built tree; (iv) the same build
# with a write fault planted on process 0 only.  Each pair runs under a
# hard deadline and is killed at it.
# phase 4's kernel scans, with their route over phase 7's 30 days: the
# per-minute window of a month passes K1's 4,096 segments from the first
# batch, so the timestamp scan aggregates with index_add_ here
CLUSTER_SCANS = [(name, qargs, 'kernel' if name.startswith('host')
                  else 'index_add')
                 for name, qargs, route in QUERIES if route == 'kernel']
CLUSTER_QUERY_CASES = ('b', 'd')
# index-scan of the first metric over every day, and over the first two
# (one file each, so process order is file order)
CLUSTER_INDEX_SCANS = [
    ('index-scan', []),
    ('index-scan, 2 days', ['--after', '2014-05-01',
                            '--before', '2014-05-03'])]
CLUSTER_PAIR_TIMEOUT_S = 300
CLUSTER_FAIL_TIMEOUT_S = 120
CLUSTER_FAULT = 'sink.create:error:1.0'
K9_SOURCE = 'dragnet_tpu_torch/parallel/mesh.py'
K9_REPLACES = 'dragnet_tpu/device_scan.py:1906'


def split_days(src, root):
    """The records of `src` (sorted by time, one per line, each starting
    with its "time") into root/%Y/%m-%d/muskie.log.  Returns the number
    of files."""
    nfiles = 0
    cur = out = None
    with open(src, 'rb') as f:
        for line in f:
            day = line[9:19]
            if day != cur:
                if out is not None:
                    out.close()
                cur = day
                d = os.path.join(root, day[:4].decode(), day[5:].decode())
                os.makedirs(d)
                out = open(os.path.join(d, 'muskie.log'), 'wb')
                nfiles += 1
            out.write(line)
    if out is not None:
        out.close()
    return nfiles


class MergeTimer(object):
    """CUDA events around each K9 merge (parallel/mesh.merge_partials),
    the bytes it must move (every partial read once, the result written
    once) and the largest call's partials, kept for the replay bench."""

    def __init__(self, spy, mod_mesh, cuda=True):
        import torch
        self.events, self.nbytes = [], []
        self.largest = None
        self.cuda = cuda

        def nb(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        def wrap(orig):
            def merge(parts, device):
                if not self.cuda:
                    # a CPU run of the child (debugging): host ms
                    t0 = time.perf_counter()
                    rv = orig(parts, device)
                    self.events.append((t0, time.perf_counter()))
                    self.nbytes.append(0)
                    return rv
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                rv = orig(parts, device)
                e1.record()
                self.events.append((e0, e1))
                self.nbytes.append(sum(nb(p) for p in parts) + nb(rv))
                if self.largest is None or \
                        nb(parts[0]) >= nb(self.largest[0]):
                    self.largest = parts
                return rv
            return merge
        spy.wrap(mod_mesh, 'merge_partials', wrap)

    def take(self):
        """(device ms per merge, bound ms per merge), and reset."""
        import torch
        if self.cuda:
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in self.events]
        else:
            ms = [(b - a) * 1e3 for a, b in self.events]
        bound = [n / HBM_BYTES_PER_S * 1e3 for n in self.nbytes]
        self.events, self.nbytes = [], []
        return ms, bound


def batch_counter(spy, mod_ds):
    """Counts DeviceScan._try_device calls: {'total', 'device'}."""
    batches = {'total': 0, 'device': 0}

    def wrap(orig):
        def try_device(self, provider, weights, alive):
            ok = orig(self, provider, weights, alive)
            batches['total'] += 1
            batches['device'] += int(ok)
            return ok
        return try_device
    spy.wrap(mod_ds.DeviceScan, '_try_device', wrap)
    return batches


def fmt_merge(ms, bound):
    if not ms:
        return 'no merge'
    return ('%d merges, device %.4f ms each (CUDA events; min %.4f, max '
            '%.4f), bound %.6f ms' % (len(ms), sum(ms) / len(ms), min(ms),
                                       max(ms), sum(bound) / len(bound)))


def cluster_child(spec_path):
    """One process of a phase-13 pair: the spec's CLI commands in order,
    in-process, each one's stdout and stderr captured; per command its
    rc, wall, device batches, K1 launches, K9 merges (CUDA events) and
    the gloo exchanges, written to <out>.<pid>.json.  Stops at the first
    failing command (its peer then fails in its next exchange) and
    exits with its rc.  Never builds a kernel: the parent did."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from dragnet_tpu_torch import cli
    from dragnet_tpu_torch import device_scan as mod_ds
    from dragnet_tpu_torch.ops import cuda_kernels as ck
    from dragnet_tpu_torch.parallel import cluster as mod_cl
    from dragnet_tpu_torch.parallel import mesh as mod_mesh
    with open(spec_path) as f:
        spec = json.load(f)
    pid = int(os.environ['DN_PROCESS_ID'])
    cuda = os.environ.get('DN_TORCH_DEVICE', DEVICE) != 'cpu'
    if cuda and (not torch.cuda.is_available() or
                 not all(ck._fresh(n) for n in ck.KERNELS)):
        sys.stderr.write('cluster child: no CUDA, or a kernel library '
                         'is not built\n')
        return 1
    from dragnet_tpu_torch import datasource_file as mod_dsf
    from dragnet_tpu_torch.parallel import distributed as mod_dist
    spy = Spy()
    ledger = FoldLedger(mod_ds, ck)
    timer = MergeTimer(spy, mod_mesh, cuda=cuda)
    batches = batch_counter(spy, mod_ds)
    stages = Timers()
    for owner, name, label in (
            (mod_dsf.DatasourceFile, '_index_scan_impl', 'local scan'),
            (mod_dsf.DatasourceFile, 'scan', 'local scan'),
            (mod_dsf.DatasourceFile, 'query', 'local query'),
            (mod_cl, '_allgather_bytes', 'allgather'),
            (mod_cl, '_allgather_merge_tagged', 'json + merge'),
            (mod_cl, '_allgather_merge_points', 'json + merge'),
            (mod_dsf.DatasourceFile, '_index_write', 'write'),
            (mod_dist, 'barrier', 'barrier')):
        stages.wrap(spy, owner, name, label)
    results = []
    rc = 0
    for argv in spec['commands']:
        ck.reset_launches()
        mod_mesh.reset_launches()
        mod_cl.reset_allgather_stats()
        b0 = dict(batches)
        m = ledger.mark()
        t0 = time.monotonic()
        rc, out, err = run_cli(cli, argv)
        if cuda:
            torch.cuda.synchronize()
        dt = time.monotonic() - t0
        folds, _, bad = ledger.since(m)
        ms, bound = timer.take()
        results.append({
            'argv': argv, 'rc': rc, 'wall_s': dt, 'stdout': out,
            'stderr': err, 'stages': stages.take(dt),
            'batches': batches['total'] - b0['total'],
            'device_batches': batches['device'] - b0['device'],
            'k1': ck.launches['onehot_dense'],
            'k2': ck.launches['scan_body'], 'folds': folds,
            'k2_bad': bad[:3],
            'merges': mod_mesh.launches['scan_merge'],
            'merge_ms': ms, 'merge_bound_ms': bound,
            'allgather': dict(mod_cl.allgather_stats)})
        if rc != 0:
            break
    spy.restore()
    with open('%s.%d.json' % (spec['out'], pid), 'w') as f:
        json.dump(results, f)
    return rc


def run_pair(tmp, tag, commands, timeout, env0=None):
    """The spec's commands on processes 0 and 1 of a two-process gloo
    group (`chip_smoke.py --cluster-child`), both on this card.  Both
    are killed at `timeout`.  Returns (wall s, [(rc, stdout, stderr)],
    [per-command results or None] per process)."""
    import socket
    spec = os.path.join(tmp, 'pair_%s.json' % tag)
    out = os.path.join(tmp, 'pair_%s' % tag)
    with open(spec, 'w') as f:
        json.dump({'commands': commands, 'out': out}, f)
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, DN_COORDINATOR='127.0.0.1:%d' % port,
               DN_NUM_PROCESSES='2')
    procs = []
    t0 = time.monotonic()
    try:
        for pid in range(2):
            e = dict(env, DN_PROCESS_ID=str(pid))
            if pid == 0 and env0:
                e.update(env0)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 '--cluster-child', spec], env=e, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            left = max(1.0, t0 + timeout - time.monotonic())
            try:
                o, e = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                check(False, 'cluster %s: the pair did not end within %d '
                      's (both killed)' % (tag, timeout))
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.monotonic() - t0
    results = []
    for pid in range(2):
        path = '%s.%d.json' % (out, pid)
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
        else:
            results.append(None)
    return wall, outs, results


def shard_bytes(root):
    """{shard name: bytes} of an index tree's by_hour shards."""
    d = os.path.join(root, 'by_hour')
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith('.sqlite'):
            with open(os.path.join(d, name), 'rb') as f:
                out[name] = f.read()
    return out


def k9_entry(mod_mesh, parts, launches, child_launches, reps):
    """K9's merge on the largest partials the two-shard leg gave it,
    against its plain version (a stack and a sum or min per output),
    exactly; CUDA-graph times, L2-cold (the calls rotate over copies
    larger than the L2 cache, as a scan's batches do), and the bound
    (every partial read once, the result written once)."""
    import itertools
    import torch
    dev = parts[0][0].device

    def nb(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def plain(ps):
        return (torch.stack([p[0] for p in ps]).sum(0),
                torch.stack([p[1] for p in ps]).amin(0),
                torch.stack([p[2] for p in ps]).sum(0))

    def fresh():
        # the merge consumes its partials (it adds into the first)
        return [tuple(t.clone() for t in p) for p in parts]
    want = plain(parts)
    got = mod_mesh.merge_partials(fresh(), dev)
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              if a.numel() else 0 for a, b in zip(got, want))
    check(err == 0, 'K9 merge differs from its plain version by %d' % err)
    copies = 2 + L2_BYTES // max(1, sum(nb(p) for p in parts))
    sets = [fresh() for _ in range(copies)]
    n0 = dict(mod_mesh.launches)
    cycle = itertools.cycle(sets)
    ms, eager = cuda_time_ms(
        lambda: mod_mesh.merge_partials(next(cycle), dev), reps)
    cycle = itertools.cycle(sets)
    plain_ms, _ = cuda_time_ms(lambda: plain(next(cycle)), reps)
    mod_mesh.launches.update(n0)
    del sets
    nbytes = sum(nb(p) for p in parts) + nb(got)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log('K9 merge of %d partials of %d segments: exact, %.4f ms (eager '
        '%.4f), plain (stack + sum/amin) %.4f ms, L2-cold over %d copies; '
        'bound %.6f ms (%d bytes), %.1f %% of it'
        % (len(parts), parts[0][0].numel(), ms, eager, plain_ms, copies,
           bound, nbytes, 100 * bound / ms))
    return {'name': 'mesh_merge', 'route': 'cuda',
            'impl': 'torch ops (in-place adds and minimum into the '
                    'first shard\'s partials, on the accumulator\'s '
                    'device): the psum/pmin merge of the reference\'s '
                    'shard_map programs; not a Pallas kernel',
            'source': K9_SOURCE, 'replaces': K9_REPLACES,
            'launches': launches, 'cluster_process_launches':
            child_launches, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': 'bytes',
            'library_ms': None,
            'library_note': 'no single torch call sums and takes the min '
                            'of the partials (torch.distributed '
                            'all_reduce needs a process per shard)',
            'eager_ms': eager,
            'shape': {'shards': len(parts), 'ns': parts[0][0].numel(),
                      'ncounters': parts[0][2].numel(), 'l2_cold': True}}


def cluster_phase(cli, mod_ds, ck, tmp, records, build_s, reps):
    """Phase 13: the cluster backend, legs (i)-(iv) (see the constants
    above).  Every output is held to the file backend's, byte for
    byte: scans with their --counters in one process, stdout across two
    (counters are each process's own, as in the reference); the
    cluster-built tree to phase 7's file-backend tree."""
    import torch
    from dragnet_tpu_torch.parallel import cluster as mod_cl
    from dragnet_tpu_torch.parallel import mesh as mod_mesh
    from dragnet_tpu_torch.config import ConfigBackendLocal
    t_phase = time.monotonic()
    doc = {'legs': {}}
    days = os.path.join(tmp, 'days')
    t0 = time.monotonic()
    nfiles = split_days(os.path.join(tmp, 'month.log'), days)
    check(nfiles == QUERY_DAYS, 'cluster: %d day files' % nfiles)
    log('cluster data: phase 7\'s %d records in %d day files under '
        '%%Y/%%m-%%d (%.2f s)' % (records, nfiles, time.monotonic() - t0))
    common = ['--path=' + days, '--time-format=%Y/%m-%d',
              '--time-field=time']
    for name, extra in (
            ('days_file', []),
            ('days', ['--backend=cluster',
                      '--index-path=' + os.path.join(tmp, 'idx_days')]),
            ('days_fail', ['--backend=cluster', '--index-path=' +
                           os.path.join(tmp, 'idx_days_fail')])):
        rc, _, err = run_cli(cli, ['datasource-add', name] + extra + common)
        check(rc == 0, 'datasource-add %s failed: %s' % (name, err))
    for ds, metrics in (('days', BUILD_METRICS), ('days_fail',
                                                  BUILD_METRICS[:1])):
        for metric, breakdowns, _route in metrics:
            rc, _, err = run_cli(cli, ['metric-add', '-b', breakdowns, ds,
                                       metric])
            check(rc == 0, 'metric-add %s failed: %s' % (metric, err))
    rc, icfg, err = run_cli(cli, ['index-config', 'days'])
    check(rc == 0, 'index-config failed: %s' % err)
    icfg = json.loads(icfg)
    icfg['metrics'] = icfg['metrics'][:1]
    icfg_path = os.path.join(tmp, 'index_config_byhour.json')
    with open(icfg_path, 'w') as f:
        json.dump(icfg, f)

    # the file backend's outputs and walls
    ref = {}
    for name, qargs, _ in CLUSTER_SCANS:
        t0 = time.monotonic()
        rc, out, err = run_cli(cli, ['scan', '--counters'] + qargs +
                               ['days_file'])
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        check(rc == 0 and out, 'cluster: file scan %s failed: %s'
              % (name, err))
        ref[name] = (out, err, dt)
        log('cluster file backend %-36s %.2f s  %11.0f records/s'
            % (name, dt, records / dt))
    qcases = [(c[0][0], c[1]) for c in QUERY_CASES
              if c[0][0] in CLUSTER_QUERY_CASES]
    for key, qargs in qcases:
        t0 = time.monotonic()
        rc, out, err = run_cli(cli, ['query'] + qargs + ['month'])
        dt = time.monotonic() - t0
        check(rc == 0 and out, 'cluster: file query %s failed: %s'
              % (key, err))
        ref['query ' + key] = (out, err, dt)
    iscan = ['index-scan', '--interval=hour', '--index-config', icfg_path]
    for label, extra in CLUSTER_INDEX_SCANS:
        rc, out, err = run_cli(cli, iscan + extra + ['days_file'])
        check(rc == 0 and out, 'cluster: file %s failed: %s' % (label, err))
        ref[label] = (out, err, None)

    spy = Spy()
    timer = MergeTimer(spy, mod_mesh)
    batches = batch_counter(spy, mod_ds)
    captured = []

    def wrap_scan(orig):
        def scan(self, *a, **k):
            rv = orig(self, *a, **k)
            captured.append(rv)
            return rv
        return scan
    spy.wrap(mod_cl.DatasourceCluster, 'scan', wrap_scan)
    cluster_k1 = 0
    mesh_merges = 0
    try:
        # (i) the process's own mesh through the CLI, and (ii) two shards
        # on the one card through the library, rendered by the CLI
        _, config = ConfigBackendLocal().load()
        dev0 = mod_mesh.make_mesh(device=DEVICE).devices[0]
        mesh2 = mod_mesh.make_mesh(devices=[dev0, dev0])
        ds2 = mod_cl.DatasourceCluster(config.datasource_get('days'),
                                       mesh=mesh2)
        for leg, shards in (('i', None), ('ii', 2)):
            rows = []
            for name, qargs, route in CLUSTER_SCANS:
                argv = ['scan', '--counters'] + qargs + ['days']
                ck.reset_launches()
                mod_mesh.reset_launches()
                b0 = dict(batches)
                t0 = time.monotonic()
                if shards is None:
                    rc, out, err = run_cli(cli, argv)
                else:
                    opts = cli.dn_parse_args(argv[1:], [
                        'before', 'after', 'filter', 'breakdowns', 'raw',
                        'points', 'counters', 'gnuplot'])
                    query = cli.dn_query_config(opts)
                    res = ds2.scan(query, device=DEVICE, engine='device')
                    o, e = io.StringIO(), io.StringIO()
                    with contextlib.redirect_stdout(o), \
                            contextlib.redirect_stderr(e):
                        cli.dn_output(query, opts, res, 'days')
                    rc, out, err = 0, o.getvalue(), e.getvalue()
                torch.cuda.synchronize()
                dt = time.monotonic() - t0
                check(rc == 0, 'cluster (%s) %s failed: %s'
                      % (leg, name, err))
                nb = batches['total'] - b0['total']
                nd = batches['device'] - b0['device']
                k1 = ck.launches['onehot_dense']
                merges = mod_mesh.launches['scan_merge']
                cluster_k1 += k1
                mesh_merges += merges
                hidden = [s for s in captured[-1].pipeline.stages
                          if s.name == 'Aggregator'][0].counters
                ms, bound = timer.take()
                fout, ferr, fdt = ref[name]
                check(out == fout and err == ferr,
                      'cluster (%s) %s: output or --counters differ from '
                      'the file backend\'s' % (leg, name))
                per = (shards or 1) if route == 'kernel' else 0
                check(nb > 0 and nd == nb and
                      hidden.get('ndevicebatches') == nd,
                      'cluster (%s) %s: %d of %d batches on the device, '
                      'ndevicebatches %r' % (leg, name, nd, nb,
                                             hidden.get('ndevicebatches')))
                check(k1 == per * nd and merges == nd,
                      'cluster (%s) %s: K1 launched %d times and K9 merged '
                      '%d times for %d batches (%s route, %d shards)'
                      % (leg, name, k1, merges, nd, route, shards or 1))
                log('cluster (%s) %-36s %.2f s (file %.2f s)  %11.0f '
                    'records/s | = file backend, --counters too | %d '
                    'batches, K1 %d, %s'
                    % (leg, name, dt, fdt, records / dt, nd, k1,
                       fmt_merge(ms, bound)))
                rows.append({'name': name, 'wall_s': dt, 'file_s': fdt,
                             'batches': nd, 'k1': k1, 'merges': merges,
                             'merge_ms': ms, 'merge_bound_ms': bound})
            doc['legs'][leg] = rows
    finally:
        spy.restore()
    parts = timer.largest

    # (iii) two processes sharing the card
    commands = [['scan'] + qargs + ['days']
                for _, qargs, _ in CLUSTER_SCANS]
    commands.append(['build', '--interval=hour', 'days'])
    commands += [iscan + extra + ['days']
                 for _, extra in CLUSTER_INDEX_SCANS]
    commands += [['query'] + qargs + ['days'] for _, qargs in qcases]
    labels = [n for n, _, _ in CLUSTER_SCANS] + ['build'] + \
        [n for n, _ in CLUSTER_INDEX_SCANS] + \
        ['query ' + k for k, _ in qcases]
    wall, outs, results = run_pair(tmp, 'main', commands,
                                   CLUSTER_PAIR_TIMEOUT_S)
    for pid, (rc, o, e) in enumerate(outs):
        check(rc == 0 and results[pid] is not None and
              len(results[pid]) == len(commands),
              'cluster (iii): process %d exited %r: %s' % (pid, rc, e[-800:]))
        check(o == '', 'cluster (iii): process %d printed %r outside its '
              'commands' % (pid, o[:200]))
    rows = []
    routes = {name: route for name, _, route in CLUSTER_SCANS}
    child_k1 = [0, 0]
    child_merges = [0, 0]
    for i, label in enumerate(labels):
        r0, r1 = results[0][i], results[1][i]
        check(r1['stdout'] == '', 'cluster (iii) %s: process 1 printed '
              '%d bytes' % (label, len(r1['stdout'])))
        if label == 'build':
            check('built' in r0['stderr'] and 'built' not in r1['stderr'],
                  'cluster (iii) build: %r | %r' % (r0['stderr'][-200:],
                                                    r1['stderr'][-200:]))
            fdt = build_s
        elif label == CLUSTER_INDEX_SCANS[0][0]:
            # every day: process 0 holds the even days, process 1 the
            # odd ones, and the merge keeps process order (the
            # reference's), so the points are the file backend's in
            # another order
            fout, _, fdt = ref[label]
            check(sorted(r0['stdout'].splitlines()) ==
                  sorted(fout.splitlines()),
                  'cluster (iii) %s: process 0\'s points differ from the '
                  'file backend\'s' % label)
        else:
            fout, _, fdt = ref[label]
            check(r0['stdout'] == fout, 'cluster (iii) %s: process 0\'s '
                  'output differs from the file backend\'s' % label)
        for pid, r in enumerate((r0, r1)):
            child_k1[pid] += r['k1']
            child_merges[pid] += r['merges']
            check(not r['k2_bad'] and r['k2'] >= r['folds'],
                  'cluster (iii) %s, process %d: the scan program launched '
                  '%d times in %d folds (%s)'
                  % (label, pid, r['k2'], r['folds'], r['k2_bad']))
            if label in routes:
                check(r['folds'] == r['device_batches'],
                      'cluster (iii) %s, process %d: %d folds for %d '
                      'device batches' % (label, pid, r['folds'],
                                          r['device_batches']))
            if label in routes:
                want = r['merges'] if routes[label] == 'kernel' else 0
                check(r['k1'] == want and
                      r['device_batches'] == r['batches'] == r['merges'] > 0,
                      'cluster (iii) %s, process %d: %d of %d batches on '
                      'the device, K1 %d, K9 %d'
                      % (label, pid, r['device_batches'], r['batches'],
                         r['k1'], r['merges']))
        w = max(r0['wall_s'], r1['wall_s'])
        ag = [r['allgather'] for r in (r0, r1)]
        log('cluster (iii) %-36s %.2f s (%s)%s | process 0: %d batches, '
            'K1 %d; process 1: %d batches, K1 %d | gloo allgather %d + %d '
            'bytes, %.3f + %.3f s | %s | %s'
            % (label, w, 'file %.2f s' % fdt if fdt else 'no file time',
               '  %.0f records/s' % (records / w)
               if not label.startswith(('query', 'index')) else '',
               r0['device_batches'], r0['k1'], r1['device_batches'],
               r1['k1'], ag[0]['bytes'], ag[1]['bytes'], ag[0]['seconds'],
               ag[1]['seconds'], fmt_merge(r0['merge_ms'],
                                           r0['merge_bound_ms']),
               fmt_merge(r1['merge_ms'], r1['merge_bound_ms'])))
        log('    host s, process 0: %s | process 1: %s'
            % (fmt_times(r0['stages'], 3), fmt_times(r1['stages'], 3)))
        rows.append({'name': label, 'wall_s': [r0['wall_s'], r1['wall_s']],
                     'stages': [r0['stages'], r1['stages']],
                     'file_s': fdt,
                     'batches': [r0['device_batches'], r1['device_batches']],
                     'k1': [r0['k1'], r1['k1']],
                     'merges': [r0['merges'], r1['merges']],
                     'allgather': ag,
                     'merge_ms': [r0['merge_ms'], r1['merge_ms']]})
    tree = shard_bytes(os.path.join(tmp, 'idx_days'))
    month_tree = shard_bytes(os.path.join(tmp, 'idx_month'))
    check(len(tree) == 24 * QUERY_DAYS and tree == month_tree,
          'cluster (iii): the two-process tree (%d shards) differs from '
          'phase 7\'s file-backend tree (%d shards)'
          % (len(tree), len(month_tree)))
    log('cluster (iii) pair: %.2f s in all (two processes starting on the '
        'card included) | tree byte-equal to phase 7\'s (%d shards) | '
        'process 1 printed nothing' % (wall, len(tree)))
    doc['legs']['iii'] = {'commands': rows, 'wall_s': wall,
                          'shards': len(tree)}

    # (iv) the write fails on process 0 only
    wall, outs, results = run_pair(
        tmp, 'fail', [['build', '--interval=hour', 'days_fail']],
        CLUSTER_FAIL_TIMEOUT_S, env0={'DN_FAULTS': CLUSTER_FAULT})
    rcs = [rc for rc, _, _ in outs]
    errs = [r[0]['stderr'] if r else e for r, (_, _, e) in
            zip(results, outs)]
    check(all(rc != 0 for rc in rcs),
          'cluster (iv): exit codes %r (both must fail)' % rcs)
    check('injected' in errs[0] and
          'index write failed on process 0' in errs[1],
          'cluster (iv): %r | %r' % (errs[0][-300:], errs[1][-300:]))
    log('cluster (iv) planted write fault on process 0: exit codes %r '
        'within %.2f s (deadline %d s) | %s | %s'
        % (rcs, wall, CLUSTER_FAIL_TIMEOUT_S, errs[0].strip()[-120:],
           errs[1].strip()[-120:]))
    doc['legs']['iv'] = {'rcs': rcs, 'wall_s': wall}

    k9 = k9_entry(mod_mesh, parts, mesh_merges, child_merges, reps)
    doc['wall_s'] = time.monotonic() - t_phase
    doc['cluster_launches'] = cluster_k1
    doc['cluster_process_launches'] = child_k1
    log('cluster phase: %.1f s' % doc['wall_s'])
    return doc, k9


# phase 14: standing queries and the fleet view.  Phase 13's day files
# (linked) and a copy of phase 7's trees behind a datasource, served on
# the card (as phase 12); SUB_CLIENTS subscribers on query (b), one on
# (d) and one `watch: fleet` group through the port's client.  The
# in-process publish: SUB_APPEND_RECORDS records of the first SUB_HOURS
# hours after the month, in a new day file, built through `build
# --remote` bounded to those hours — two new hour shards at the head of
# the tree, as `dn follow` publishes the latest hours (a whole day's
# window would not launch K1: the byhour metric's hour x hour x host
# caps over a day, 32 x 32 x 8, pass its 4,096 segments).  The
# cross-process publish: SUB_XPROC_RECORDS more in the same hours,
# built by a separate `python -m dragnet_tpu_torch build` at
# DN_ENGINE=jax and caught by the revalidation tick.  Every frame after
# each equals a `query --remote` poll.  SUB_WAIT_S bounds every wait on
# a frame.  Between the two, the day rebuild: SUB_DAY_RECORDS records
# appended to the month's last day file, rebuilt through `build
# --remote --interval=hour` bounded to that day — its 24 hour shards
# fold again, the rest are reused.  It launches K1 0 times (those caps
# again: the device scan sizes them from the batch's time range before
# the window mask, ROADMAP §2), and the phase prints that count.
SUB_CLIENTS = 8
SUB_CASES = ('b', 'd')
SUB_APPEND_RECORDS = 500000
SUB_XPROC_RECORDS = 200000
SUB_HOURS = 2
SUB_AFTER, SUB_BEFORE = '2014-05-31T00:00:00Z', '2014-05-31T02:00:00Z'
SUB_DAY_RECORDS = 500000
SUB_DAY_AFTER, SUB_DAY_BEFORE = '2014-05-30T00:00:00Z', '2014-05-31T00:00:00Z'
SUB_DAY_SHARDS = 24
SUB_FLEET_INTERVAL_MS = 1000
SUB_WAIT_S = 120.0
SUB_DS = 'subd'


class FrameReader(object):
    """One subscription's frames, read on a thread of its own: each
    pushed frame with its receipt wall time.  `ended` is 'end' once the
    server's end frame closed the stream, else the error that cut it."""

    def __init__(self, tclient, sock, req, label):
        import threading
        self.label = label
        self.frames = []
        self.ended = None
        self.cond = threading.Condition()
        self._stream = tclient.subscribe_stream(sock, req)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='smoke-sub-' + label)
        self._thread.start()

    def _run(self):
        ended = 'end'
        try:
            for fr in self._stream:
                with self.cond:
                    self.frames.append((time.time(), fr))
                    self.cond.notify_all()
        except Exception as e:
            ended = repr(e)
        with self.cond:
            self.ended = ended
            self.cond.notify_all()

    def mark(self):
        """The number of frames received so far."""
        with self.cond:
            return len(self.frames)

    def wait(self, pred, what, since=0):
        """The first frame from index `since` on that `pred` accepts,
        waiting up to SUB_WAIT_S."""
        deadline = time.monotonic() + SUB_WAIT_S
        with self.cond:
            while True:
                for t, fr in self.frames[since:]:
                    if pred(fr):
                        return t, fr
                left = deadline - time.monotonic()
                check(left > 0 and self.ended is None,
                      'subscribe: %s never got %s (ended %r)'
                      % (self.label, what, self.ended))
                self.cond.wait(min(left, 1.0))

    def join(self):
        self._thread.join(SUB_WAIT_S)
        check(not self._thread.is_alive(), 'subscribe: %s did not end'
              % self.label)


def sub_request(cli, qargs, dsname):
    """The standing query `dn subscribe` ships for these query
    arguments (its own parse, and no output options)."""
    from dragnet_tpu_torch.config import ConfigBackendLocal
    opts = cli.dn_parse_args(list(qargs) + [dsname], [
        'before', 'after', 'filter', 'breakdowns', 'raw', 'points',
        'interval', 'remote', 'frames'])
    cli.dn_query_config(opts)
    return {'op': 'subscribe', 'ds': dsname, 'interval': opts.interval,
            'queryconfig': cli.dn_query_doc(opts),
            'opts': {'raw': False, 'points': False},
            'config': ConfigBackendLocal().cbl_path}


def append_records(path, n, seed, after=SUB_AFTER, before=SUB_BEFORE):
    """n generated records of the publish window (`after` to `before`)
    appended to `path`; the seconds it took."""
    import calendar
    from dragnet_tpu_torch import native as mod_native
    t0 = time.monotonic()
    lo, hi = (calendar.timegm(time.strptime(t, '%Y-%m-%dT%H:%M:%SZ'))
              * 1000 for t in (after, before))
    extra = path + '.gen'
    mod_native.gen_to_file(n, extra, mindate_ms=lo, maxdate_ms=hi - 1,
                           seed=seed)
    with open(extra, 'rb') as src, open(path, 'ab') as dst:
        while True:
            chunk = src.read(16 << 20)
            if not chunk:
                break
            dst.write(chunk)
    os.unlink(extra)
    return time.monotonic() - t0


def subscribe_phase(cli, ck, tmp, seed, serve_memory):
    """Phase 14 (see the constants above).  Returns the `subscribe`
    doc; its `launches` are the counts of this phase's path (zeroed
    just before the server starts, read after its drain)."""
    import gc
    import shutil
    import threading
    import torch
    from dragnet_tpu_torch import device_index as mod_di
    from dragnet_tpu_torch import index_build_mt as mod_build
    from dragnet_tpu_torch import index_query_stack as mod_iqs
    from dragnet_tpu_torch import integrity as mod_integrity
    from dragnet_tpu_torch.serve import client as tclient
    from dragnet_tpu_torch.serve import residency as mod_res
    from dragnet_tpu_torch.serve import server as tserver
    t_phase = time.monotonic()
    doc = {}
    days = os.path.join(tmp, 'days_sub')
    src_days = os.path.join(tmp, 'days')
    for root, dirs, files in os.walk(src_days):
        rel = os.path.relpath(root, src_days)
        os.makedirs(os.path.join(days, rel), exist_ok=True)
        for fn in files:
            os.link(os.path.join(root, fn), os.path.join(days, rel, fn))
    head = os.path.join(days, SUB_AFTER[:4], SUB_AFTER[5:10], 'muskie.log')
    check(not os.path.exists(head), 'subscribe: %s exists' % head)
    os.makedirs(os.path.dirname(head))
    # the day rebuild appends to the last day's file: a copy of its own,
    # not a link to phase 13's
    last_day = os.path.join(days, SUB_DAY_AFTER[:4], SUB_DAY_AFTER[5:10],
                            'muskie.log')
    check(os.path.exists(last_day), 'subscribe: no %s' % last_day)
    shutil.copyfile(last_day, last_day + '.copy')
    os.replace(last_day + '.copy', last_day)
    idx = os.path.join(tmp, 'idx_sub')
    shutil.copytree(os.path.join(tmp, 'idx_month'), idx)
    rc, _, err = run_cli(cli, ['datasource-add', SUB_DS, '--path=' + days,
                               '--time-format=%Y/%m-%d',
                               '--time-field=time', '--index-path=' + idx])
    check(rc == 0, 'datasource-add %s failed: %s' % (SUB_DS, err))
    for metric, breakdowns, _route in BUILD_METRICS:
        rc, _, err = run_cli(cli, ['metric-add', '-b', breakdowns, SUB_DS,
                                   metric])
        check(rc == 0, 'metric-add %s failed: %s' % (metric, err))
    cases = {c[0][0]: c[1] for c in QUERY_CASES if c[0][0] in SUB_CASES}
    sock = os.path.join(tmp, 'dn_sub.sock')

    # the pusher thread must stay off the card: every device entry of
    # the path records the threads that reached it
    spy = Spy()
    device_threads = set()

    def on_thread(orig):
        def wrapped(*a, **k):
            device_threads.add(threading.current_thread().name)
            return orig(*a, **k)
        return wrapped
    spy.wrap(ck, 'onehot_dense_into', on_thread)
    spy.wrap(mod_di, '_device_fold', on_thread)
    for name in ('get', 'put', 'get_device', 'put_device'):
        spy.wrap(mod_res.DeviceResidency, name, on_thread)
    publish_t = []

    def on_publish(indexroot, paths):
        if os.path.abspath(indexroot) == os.path.abspath(idx):
            publish_t.append(time.time())
    mod_build.register_index_write_hook(on_publish)
    knobs = {'DN_ENGINE': 'jax', 'DN_DEVICE_RESIDENCY_MB': '4096',
             'DN_DEVICE_PREWARM': '1', 'DN_METRICS_HISTORY_S': '1',
             'DN_SUB_COALESCE_MS': None, 'DN_SUB_DELTA_PCT': None}
    readers = []
    try:
        with env_scope(**knobs):
            gc.collect()
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            # the counts: zeroed just before this phase's path, read
            # just after the drain
            ck.reset_launches()
            mod_di._reset_engagement()
            mod_iqs.launches['sums'] = 0
            srv = tserver.DnServer(socket_path=sock,
                                   conf={'max_inflight': 4}).start()
            try:
                doc.update(_subscribe_checks(
                    cli, ck, tserver, tclient, srv, cases, head, last_day,
                    idx, seed, readers, publish_t, mod_integrity))
            finally:
                srv.stop()
            for r in readers:
                r.join()
            torch.cuda.synchronize()
            launches = {'onehot_dense': ck.launches['onehot_dense'],
                        'fold': mod_di.stats_doc()['dispatches'],
                        'sums': mod_iqs.launches['sums']}
            gc.collect()
            mem_after = torch.cuda.memory_allocated()
    finally:
        mod_build.unregister_index_write_hook(on_publish)
        spy.restore()
    ends = {r.label: r.ended for r in readers}
    check(all(e == 'end' for e in ends.values()),
          'subscribe: streams not ended by an end frame: %r' % ends)
    check(mod_res.active() is None, 'subscribe: residency survived the '
          'drain')
    check(mem_after - mem_before <= DRAIN_SLACK_BYTES,
          'subscribe: device memory after the drain %d B, before the '
          'server %d B' % (mem_after, mem_before))
    check('dn-subscribe' not in device_threads,
          'subscribe: the pusher thread reached the card (%r)'
          % sorted(device_threads))
    check(launches['onehot_dense'] > 0 and launches['fold'] > 0,
          'subscribe: K1 %d and K7 %d launches'
          % (launches['onehot_dense'], launches['fold']))
    doc['memory'] = {'before_server': mem_before, 'after_drain': mem_after,
                     'phase_12_after_drain': serve_memory['after_drain']}
    doc['device_threads'] = sorted(device_threads)
    doc['launches'] = launches
    doc['ends'] = len(ends)
    doc['wall_s'] = time.monotonic() - t_phase
    log('subscribe drain: %d end frames; device memory %d B before the '
        'server, %d B after its drain (phase 12: %d B after its drain); '
        'device entries reached from threads %s'
        % (len(ends), mem_before, mem_after, serve_memory['after_drain'],
           ', '.join(sorted(device_threads))))
    log('subscribe: launches K1 %d, K7 %d, K7a %d; phase %.1f s'
        % (launches['onehot_dense'], launches['fold'], launches['sums'],
           doc['wall_s']))
    return doc


def _sub_counters(tclient, sock):
    """The /stats `subscriptions` counters and the whole section."""
    st = tclient.stats(sock)['subscriptions']
    return st['counters'], st


def _publish_round(label, tserver, cli, tclient, srv, cases, readers,
                   marks, t_publish, sub_before):
    """After one publish: every query subscriber's first frame since
    `marks` (the frame counts before the publish), the push latencies
    from `t_publish`, and a poll that the subscribers' frames reach;
    the group counters' deltas."""
    sock = srv.socket_path
    lat, out = [], {}
    for r in readers:
        if r.label == 'fleet':
            continue
        t, fr = r.wait(lambda fr: True, 'a frame after the %s publish'
                       % label, since=marks[r.label])
        lat.append(t - t_publish)
        out.setdefault(r.label.split('#')[0], []).append(fr)
    polls = {}
    for case, qargs in cases.items():
        rc, text, err, dt = served(tserver, cli, ['query', '--remote',
                                                  sock] + qargs + [SUB_DS])
        check(rc == 0, 'subscribe: poll (%s) failed: %s' % (case, err))
        polls[case] = (text.encode(), dt)
        # the latest frame of every subscriber: a tick may have pushed
        # an intermediate state before the publish settled
        for r in readers:
            if r.label.split('#')[0] != case:
                continue
            r.wait(lambda fr: fr['payload'] == polls[case][0],
                   'the polled bytes of (%s)' % case,
                   since=marks[r.label])
    counters, st = _sub_counters(tclient, sock)
    delta = {k: counters[k] - sub_before[k] for k in counters}
    groups = [g for g in st['groups'] if g['watch'] == 'query']
    frames = [fr for frs in out.values() for fr in frs]
    return {'latency_s': lat, 'polls': polls, 'delta': delta,
            'groups': groups, 'frames': frames}


def _subscribe_checks(cli, ck, tserver, tclient, srv, cases, head,
                      last_day, idx, seed, readers, publish_t,
                      mod_integrity):
    import threading
    import torch
    doc = {}
    sock = srv.socket_path
    check(srv.wait_prewarm(SUB_WAIT_S) is not None,
          'subscribe: the pre-warm did not report')
    t0 = time.monotonic()
    reqs = {c: sub_request(cli, qargs, SUB_DS) for c, qargs in cases.items()}
    for i in range(SUB_CLIENTS):
        readers.append(FrameReader(tclient, sock, dict(reqs['b']),
                                   'b#%d' % i))
    readers.append(FrameReader(tclient, sock, dict(reqs['d']), 'd#0'))
    readers.append(FrameReader(
        tclient, sock, {'op': 'subscribe', 'watch': 'fleet',
                        'interval_ms': SUB_FLEET_INTERVAL_MS}, 'fleet'))
    seed_payload = {}
    for r in readers:
        t, fr = r.wait(lambda fr: fr['seq'] == 1, 'its seed frame')
        seed_payload[r.label] = fr['payload']
    seed_s = time.monotonic() - t0
    for case, qargs in cases.items():
        rc, text, err, _ = served(tserver, cli, ['query', '--remote',
                                                 sock] + qargs + [SUB_DS])
        check(rc == 0, 'subscribe: poll (%s) failed: %s' % (case, err))
        seeds = {seed_payload[r.label] for r in readers
                 if r.label.split('#')[0] == case}
        check(seeds == {text.encode()}, 'subscribe: the seed frames of '
              '(%s) differ from the poll' % case)
    log('subscribe seed: %d subscribers on (b), 1 on (d), 1 fleet watch; '
        'seed frames in %.2f s, each = a query --remote poll'
        % (SUB_CLIENTS, seed_s))
    doc['seed_s'] = seed_s

    # the in-process publish: two new hour shards built through the
    # server (DeviceScanStack on the card: K1 once per batch)
    before, _ = _sub_counters(tclient, sock)
    gen_s = append_records(head, SUB_APPEND_RECORDS, seed + 14)
    del publish_t[:]
    marks = {r.label: r.mark() for r in readers}
    rc, out, err, build_s = served(tserver, cli, [
        'build', '--remote', sock, '--interval=hour',
        '--after', SUB_AFTER, '--before', SUB_BEFORE, SUB_DS])
    check(rc == 0 and err == 'indexes for "%s" built\n' % SUB_DS,
          'subscribe: build --remote failed: %s' % err[-300:])
    check(publish_t, 'subscribe: the build fired no write hook')
    rnd = _publish_round('in-process', tserver, cli, tclient, srv, cases,
                         readers, marks, publish_t[-1], before)
    recomputes = [g['recomputes'] for g in rnd['groups']]
    check(rnd['delta']['recomputes'] == len(cases) and
          recomputes == [2] * len(cases),
          'subscribe: the in-process publish cost %d recomputes (groups '
          '%r), not one per group' % (rnd['delta']['recomputes'],
                                      recomputes))
    check(rnd['delta']['shards_folded'] == SUB_HOURS * len(cases),
          'subscribe: %d shards folded, not the %d hours\' per group'
          % (rnd['delta']['shards_folded'], SUB_HOURS))
    doc['in_process'] = _round_doc(rnd, build_s, gen_s)
    _log_round('in-process (build --remote, %d records appended)'
               % SUB_APPEND_RECORDS, doc['in_process'])

    # the day rebuild: the month's last day, in process as well
    before, _ = _sub_counters(tclient, sock)
    gen_s = append_records(last_day, SUB_DAY_RECORDS, seed + 16,
                           SUB_DAY_AFTER, SUB_DAY_BEFORE)
    del publish_t[:]
    marks = {r.label: r.mark() for r in readers}
    k1_before = ck.launches['onehot_dense']
    rc, out, err, build_s = served(tserver, cli, [
        'build', '--remote', sock, '--interval=hour',
        '--after', SUB_DAY_AFTER, '--before', SUB_DAY_BEFORE, SUB_DS])
    check(rc == 0 and err == 'indexes for "%s" built\n' % SUB_DS,
          'subscribe: the day rebuild failed: %s' % err[-300:])
    day_k1 = ck.launches['onehot_dense'] - k1_before
    check(publish_t, 'subscribe: the day rebuild fired no write hook')
    rnd = _publish_round('day rebuild', tserver, cli, tclient, srv, cases,
                         readers, marks, publish_t[-1], before)
    check(rnd['delta']['recomputes'] == len(cases),
          'subscribe: the day rebuild cost %d recomputes, not one per '
          'group' % rnd['delta']['recomputes'])
    check(0 < rnd['delta']['shards_folded'] <= SUB_DAY_SHARDS * len(cases),
          'subscribe: the day rebuild folded %d shards, past the day\'s '
          '%d per group' % (rnd['delta']['shards_folded'], SUB_DAY_SHARDS))
    doc['day_rebuild'] = _round_doc(rnd, build_s, gen_s)
    doc['day_rebuild']['k1_launches'] = day_k1
    _log_round('day rebuild (build --remote of %s, %d records appended)'
               % (SUB_DAY_AFTER[:10], SUB_DAY_RECORDS), doc['day_rebuild'])
    log('subscribe day rebuild: K1 %d launches (the caps of a day\'s '
        'window pass 4,096 segments)' % day_k1)
    b_after = rnd['polls']['b'][0]

    # `dn subscribe --frames 2` across the cross-process publish (its
    # seed, then that push), `dn top --once`, `stats --cluster --prom`
    sub_cli = {}

    def run_sub_cli():
        sub_cli['r'] = served(tserver, cli, [
            'subscribe', '--remote', sock, '--frames', '2'] +
            cases['b'] + [SUB_DS])
    cli_thread = threading.Thread(target=run_sub_cli, daemon=True)
    cli_thread.start()
    before, _ = _sub_counters(tclient, sock)
    deadline = time.monotonic() + SUB_WAIT_S
    while _sub_counters(tclient, sock)[0]['pushes'] == before['pushes']:
        # its seed frame is the push that follows its registration
        check(time.monotonic() < deadline,
              'subscribe: dn subscribe got no seed frame')
        time.sleep(0.05)
    before, _ = _sub_counters(tclient, sock)
    marks = {r.label: r.mark() for r in readers}
    gen_s = append_records(head, SUB_XPROC_RECORDS, seed + 15)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, '-m', 'dragnet_tpu_torch', 'build',
         '--interval=hour', '--after', SUB_AFTER,
         '--before', SUB_BEFORE, SUB_DS], cwd=here,
        env=dict(os.environ, DN_ENGINE='jax'),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=600)
    xbuild_s = time.monotonic() - t0
    check(proc.returncode == 0, 'subscribe: the cross-process build '
          'failed: %s' % proc.stderr[-300:])
    t_pub = os.stat(mod_integrity.catalog_path(idx)).st_mtime
    rnd = _publish_round('cross-process', tserver, cli, tclient, srv,
                         cases, readers, marks, t_pub, before)
    check(rnd['delta']['recomputes'] == len(cases),
          'subscribe: the cross-process publish cost %d recomputes, not '
          'one per group (0: the revalidation tick missed it)'
          % rnd['delta']['recomputes'])
    doc['cross_process'] = _round_doc(rnd, xbuild_s, gen_s)
    _log_round('cross-process (a build by another process, %d records '
               'appended)' % SUB_XPROC_RECORDS, doc['cross_process'])
    cli_thread.join(SUB_WAIT_S)
    check('r' in sub_cli, 'subscribe: dn subscribe --frames 2 never ended')
    rc, text, err, dt = sub_cli['r']
    lines = [json.loads(ln) for ln in text.splitlines()]
    # its seed, then a frame the (b) subscribers were pushed too
    pushed_b = {fr['payload'] for t, fr in
                readers[0].frames[marks[readers[0].label]:]}
    check(rc == 0 and len(lines) == 2 and
          lines[0]['payload'].encode() == b_after and
          lines[1]['payload'].encode() in pushed_b,
          'subscribe: dn subscribe --frames 2 gave rc %d, %d lines: %s'
          % (rc, len(lines), err[-300:]))
    rc, top, err, _ = served(tserver, cli, ['top', '--remote', sock,
                                            '--once'])
    check(rc == 0 and 'members 1/1 up' in top and
          'device resid hit' in top,
          'subscribe: dn top --once: rc %d\n%s%s' % (rc, top, err))
    rc, prom, err, _ = served(tserver, cli, ['stats', '--cluster',
                                             '--prom', '--remote', sock])
    check(rc == 0 and 'dn_fleet_members_up 1' in prom and
          'dn_fleet_subscriptions ' in prom,
          'subscribe: stats --cluster --prom: rc %d: %s' % (rc, err))
    hist = tclient.stats(sock)['history']
    qps = [k for k in hist['series'] if k.startswith(
        'serve_op_latency_ms') and k.endswith(':count')]
    check(hist['enabled'] and qps and 'serve.requests' in hist['series'],
          'subscribe: /stats history has no qps series: %r'
          % sorted(hist['series'])[:20])
    fleet = [r for r in readers if r.label == 'fleet'][0]
    nfleet = len(fleet.frames)
    check(nfleet >= 2, 'subscribe: %d fleet frames' % nfleet)
    log('subscribe front ends: dn subscribe --frames 2 (%d JSONL lines, '
        'the second = the poll); dn top --once:\n%s'
        % (len(lines), '\n'.join('    ' + ln for ln in
                                 top.rstrip('\n').splitlines()[:6])))
    log('subscribe fleet: %d fleet-watch frames; stats --cluster --prom '
        '%d dn_fleet_* lines; history: %d samples, %d series, qps %s'
        % (nfleet, sum(1 for ln in prom.splitlines()
                       if ln.startswith('dn_fleet_')),
           hist['samples'], hist['nseries'],
           ', '.join('%s rate_1m %s' % (k, hist['series'][k]['rate_1m'])
                     for k in qps)))
    doc['front_ends'] = {'subscribe_lines': len(lines),
                         'top_lines': len(top.splitlines()),
                         'fleet_frames': nfleet,
                         'prom_fleet_lines': sum(
                             1 for ln in prom.splitlines()
                             if ln.startswith('dn_fleet_')),
                         'history_samples': hist['samples']}
    doc['counters'] = _sub_counters(tclient, sock)[0]
    torch.cuda.synchronize()
    return doc


def _round_doc(rnd, build_s, gen_s):
    lat = rnd['latency_s']
    frames = rnd['frames']
    return {'build_s': build_s, 'append_s': gen_s,
            'push_latency_s': {'p50': percentile(lat, 0.5),
                               'max': max(lat), 'n': len(lat)},
            'frames': {'full': sum(1 for f in frames
                                   if f['kind'] == 'full'),
                       'delta': sum(1 for f in frames
                                    if f['kind'] == 'delta'),
                       'payload_bytes': sorted({len(f['payload'])
                                                for f in frames})},
            'poll_s': {c: p[1] for c, p in rnd['polls'].items()},
            'recomputes': rnd['delta']['recomputes'],
            'shards_folded': rnd['delta']['shards_folded'],
            'shards_reused': rnd['delta']['shards_reused'],
            'pushes': rnd['delta']['pushes'],
            'push_bytes': rnd['delta']['push_bytes'],
            'frames_full': rnd['delta']['frames_full'],
            'frames_delta': rnd['delta']['frames_delta']}


def _log_round(label, d):
    log('subscribe %s: build %.2f s (append %.2f s); push latency p50 '
        '%.4f s max %.4f s over %d subscribers; frames %d full + %d delta '
        '(payload bytes %s, %d B pushed); recomputes %d, shards folded %d, '
        'reused %d; polls %s; every frame = the poll'
        % (label, d['build_s'], d['append_s'],
           d['push_latency_s']['p50'], d['push_latency_s']['max'],
           d['push_latency_s']['n'], d['frames']['full'],
           d['frames']['delta'], d['frames']['payload_bytes'],
           d['push_bytes'], d['recomputes'], d['shards_folded'],
           d['shards_reused'],
           ', '.join('(%s) %.3f s' % kv for kv in sorted(
               d['poll_s'].items()))))


# phase 15: the serve cluster on the card.  Three members `a`, `b`, `c`
# in this process (one CUDA context), each over a private copy of phase
# 7's month tree through its topology entry's `config` (a dragnetrc of
# its own: that tree, phase 4's `muskie` file and the shared SCL_DS),
# partitions [a,b], [b,c], [c,a]; the disk reading pinned through
# DN_DISK_SIM_FILE (a shared host's disk below DN_DISK_LOW_PCT would
# hold the handoff and the repairs); residency off (a process-wide pin
# set that the first member's drain would take from the others).  In
# order: (i) phase 7's queries through each member as router; (ii) each
# member's device work: its pre-warm (K7a), one served K1 scan, and a
# stacked build of SCL_DS through `b`; (iii) failover with `b` stopped,
# then `c` too under DN_ROUTER_PARTIAL=error and =allow; (iv) member
# `d` joins with an empty tree and takes partition 2 from `c` through
# the coordinator; (v) a flipped byte on `a` under DN_VERIFY=open, the
# failover and the repair from `b`, `dn scrub --remote`, `dn quarantine
# list`; (vi) a routed standing query on SCL_DS through `a` across a
# publish through `a`; (vii) the fleet view; (viii) the drain.
SCL_PARTITIONS = [['a', 'b'], ['b', 'c'], ['c', 'a']]
SCL_JOIN_PARTITIONS = [['a', 'b'], ['b', 'c'], ['d', 'a']]
SCL_DS = 'sclsub'
SCL_SUB_RECORDS = 300000
SCL_SUB_AFTER, SCL_SUB_BEFORE = '2014-06-01T00:00:00Z', '2014-06-03T00:00:00Z'
SCL_PUB_RECORDS = 100000
SCL_PUB_AFTER, SCL_PUB_BEFORE = '2014-06-03T00:00:00Z', '2014-06-03T02:00:00Z'
SCL_WAIT_S = 180.0
SCL_KNOBS = {'DN_ENGINE': 'jax', 'DN_DEVICE_RESIDENCY_MB': '0',
             'DN_DEVICE_PREWARM': '1', 'DN_TOPO_POLL_MS': '500',
             'DN_REMOTE_RETRIES': '0', 'DN_REMOTE_CONNECT_TIMEOUT_S': '2',
             'DN_SCRUB_RATE_MB_S': '0', 'DN_ROUTER_PARTIAL': None,
             'DN_VERIFY': None, 'DN_SUB_COALESCE_MS': None}


def without_walk(err):
    """A local query's --counters without the walk's stages (Find* or
    PathEnumerator, before `Index List`): a routed query walks on the
    members, and its router's pipeline has the merge's stages only (the
    reference's router too)."""
    at = err.find('Index List ')
    return err[at:] if at >= 0 else err


def member_rc(tmp, name, month_idx):
    """A member's dragnetrc: the process's configuration cut to the
    datasources this phase serves, with `month` on the member's own
    tree."""
    from dragnet_tpu_torch.config import ConfigBackendLocal
    with open(ConfigBackendLocal().cbl_path) as f:
        doc = json.load(f)
    keep = ('month', 'muskie', SCL_DS)
    doc['datasources'] = [d for d in doc['datasources']
                          if d['name'] in keep]
    doc['metrics'] = [m for m in doc.get('metrics', [])
                      if m.get('datasource') in keep]
    for d in doc['datasources']:
        if d['name'] == 'month':
            d['backend_config']['indexPath'] = month_idx
    path = os.path.join(tmp, 'rc_scl_%s.json' % name)
    with open(path, 'w') as f:
        json.dump(doc, f)
    return path


def scl_phase(cli, mod_ds, ck, tmp, query_outputs, forced, serve_p50):
    """Phase 15 (see the constants above).  Returns the `serve_cluster`
    doc; its `launches` are the counts of this phase's path (zeroed just
    before the members start, read after their drain)."""
    import gc
    import shutil
    import torch
    from dragnet_tpu_torch import index_query_mt as mod_iqmt
    from dragnet_tpu_torch import index_query_stack as mod_iqs
    from dragnet_tpu_torch import integrity as mod_integ
    from dragnet_tpu_torch import native as mod_native
    from dragnet_tpu_torch.serve import client as tclient
    from dragnet_tpu_torch.serve import coordinator as tcoord
    from dragnet_tpu_torch.serve import scrub as mod_scrub
    from dragnet_tpu_torch.serve import server as tserver
    from dragnet_tpu_torch.serve import topology as ttopology
    t_phase = time.monotonic()
    doc = {'walls_s': {}}
    # the shared datasource of (ii)'s build and (vi)'s standing query
    sub_data = os.path.join(tmp, 'scl_sub.log')
    lo, hi = (calendar.timegm(time.strptime(t, '%Y-%m-%dT%H:%M:%SZ'))
              * 1000 for t in (SCL_SUB_AFTER, SCL_SUB_BEFORE))
    mod_native.gen_to_file(SCL_SUB_RECORDS, sub_data, mindate_ms=lo,
                           maxdate_ms=hi - 1, seed=15)
    add_datasource(cli, SCL_DS, sub_data, os.path.join(tmp, 'idx_scl_sub'),
                   [(m, b) for m, b, _ in BUILD_METRICS])
    socks = {m: os.path.join(tmp, 'scl_%s.sock' % m) for m in 'abcd'}
    trees, rcs = {}, {}
    t0 = time.monotonic()
    for m in 'abcd':
        trees[m] = os.path.join(tmp, 'idx_scl_%s' % m)
        if m != 'd':
            shutil.copytree(os.path.join(tmp, 'idx_month'), trees[m])
        rcs[m] = member_rc(tmp, m, trees[m])
    copy_s = time.monotonic() - t0
    topo_path = os.path.join(tmp, 'scl_topo.json')

    def topo_doc(names, parts):
        return {'assign': 'hash',
                'members': {m: {'endpoint': socks[m], 'config': rcs[m]}
                            for m in names},
                'partitions': [{'id': i, 'replicas': r}
                               for i, r in enumerate(parts)]}
    tcoord.publish_topology(topo_path, dict(topo_doc('abc',
                                                     SCL_PARTITIONS),
                                            epoch=1))
    disk = os.path.join(tmp, 'scl_disk_free_pct')
    with open(disk, 'w') as f:
        f.write('50\n')
    qargv = {name: ['--points', '--counters'] + qargs + ['month']
             for name, qargs, _ in QUERY_CASES}
    kernel_scan = [(name, qargs) for name, qargs, route in QUERIES
                   if route == 'kernel'][0]
    servers = {}
    readers = []

    def start(m, **env):
        with env_scope(**env):
            committed, pending = ttopology.load_topology_state(
                topo_path, member=m)
            servers[m] = tserver.DnServer(
                socket_path=socks[m], conf={'max_inflight': 4},
                cluster=committed, member=m, pending=pending).start()
        return servers[m]

    def stop(m):
        servers.pop(m).stop()

    def routed(m, name):
        rc, out, err, dt = served(tserver, cli, ['query', '--remote',
                                                 socks[m]] + qargv[name])
        want = query_outputs[name]
        check(rc == 0 and (out, err) == (want[0], without_walk(want[1])),
              'scl: routed query %s through %s differs from phase 7 (rc '
              '%d, stdout %s): %s | phase 7: %s'
              % (name, m, rc, 'equal' if out == want[0] else 'differs',
                 err[-400:], without_walk(want[1])[-400:]))
        return dt

    def lap(label, t):
        doc['walls_s'][label] = time.monotonic() - t
        return time.monotonic()

    try:
        with env_scope(DN_DISK_SIM_FILE=disk, **SCL_KNOBS):
            gc.collect()
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            # the counts: zeroed just before the members start, read
            # just after their drain
            ck.reset_launches()
            mod_iqs.launches['sums'] = 0
            t = time.monotonic()
            for m in 'abc':
                start(m)
            modes = {m: s.governor.mode() for m, s in servers.items()}
            log('scl: members a, b, c on %s (private trees copied in %.2f '
                's); disk reading pinned at 50 %% free, governor %s'
                % (servers['a'].device, copy_s, modes))
            check(set(modes.values()) == {'ok'}, 'scl: governor %r'
                  % modes)

            # (i) phase 7's queries, each member as router
            walls = {}
            for m in 'abc':
                for name, _, _ in QUERY_CASES:
                    walls['%s %s' % (m, name[0])] = routed(m, name)
            # the p50 of (b) and (d) over their three routed runs
            p50 = {c: percentile([walls['%s %s' % (m, c)]
                                  for m in 'abc'], 0.5) for c in 'bd'}
            cl = tclient.stats(socks['a'])['cluster']['counters']
            doc['routed'] = {'walls_s': walls, 'p50_s': p50,
                             'served_p50_s': serve_p50,
                             'counters': cl}
            log('scl (i) routed: phase 7\'s (a)-(e) through a, b and c '
                '= phase 7 (--counters less the walk\'s stages); '
                '%s' % fmt_times(walls, 3))
            log('scl (i) routed p50 over the 3 routers: (b) %.4f s, (d) '
                '%.4f s; phase 12 served (b) p50 %s; a\'s scatters %d, '
                'local partials %d, remote %d'
                % (p50['b'], p50['d'],
                   '%.4f s' % serve_p50 if serve_p50 is not None
                   else 'not run', cl['scatters'], cl['partials_local'],
                   cl['partials_remote']))
            t = lap('i', t)

            # (ii) each member's own device work
            prewarm = {}
            for m in 'abc':
                pw = servers[m].wait_prewarm(SCL_WAIT_S)
                check(pw is not None and pw['state'] == 'ok' and
                      pw['programs'] == 2, 'scl: %s prewarm %r' % (m, pw))
                prewarm[m] = pw['ms']
            batches = {'total': 0, 'device': 0}
            orig_try = mod_ds.DeviceScan._try_device

            def try_device(self, provider, weights, alive):
                ok = orig_try(self, provider, weights, alive)
                batches['total'] += 1
                batches['device'] += int(ok)
                return ok
            mod_ds.DeviceScan._try_device = try_device
            scans = {}
            try:
                for m in 'abc':
                    b0, l0 = dict(batches), ck.launches['onehot_dense']
                    rc, out, err, dt = served(tserver, cli, [
                        'scan', '--remote', socks[m], '--points',
                        '--counters'] + kernel_scan[1] + ['muskie'])
                    torch.cuda.synchronize()
                    nb = batches['total'] - b0['total']
                    nd = batches['device'] - b0['device']
                    nl = ck.launches['onehot_dense'] - l0
                    check(rc == 0 and (out, err) == forced[kernel_scan[0]][:2],
                          'scl: scan through %s differs from phase 4: %s'
                          % (m, err[-300:]))
                    check(nb > 0 and nd == nb == nl,
                          'scl: scan through %s: %d device batches of %d, '
                          'K1 %d launches' % (m, nd, nb, nl))
                    scans[m] = {'wall_s': dt, 'batches': nb,
                                'k1_launches': nl}
                l0 = ck.launches['onehot_dense']
                rc, out, err, build_s = served(tserver, cli, [
                    'build', '--remote', socks['b'], '--interval=hour',
                    SCL_DS])
                torch.cuda.synchronize()
                build_k1 = ck.launches['onehot_dense'] - l0
                check(rc == 0 and build_k1 > 0,
                      'scl: build --remote through b: rc %d, K1 %d: %s'
                      % (rc, build_k1, err[-300:]))
            finally:
                mod_ds.DeviceScan._try_device = orig_try
            doc['device'] = {'prewarm_ms': prewarm, 'scans': scans,
                             'build': {'wall_s': build_s,
                                       'k1_launches': build_k1}}
            log('scl (ii) device: pre-warm (K7a at both shapes) %s ms; '
                'the K1 scan (%s) through a, b, c %s, each = phase 4, K1 '
                'once per device batch (%s); %s built through b in %.2f '
                's, K1 %d' % (
                    ', '.join('%s %.3f' % kv for kv in sorted(
                        prewarm.items())), kernel_scan[0],
                    fmt_times({m: s['wall_s'] for m, s in scans.items()},
                              2),
                    ', '.join('%s %d' % (m, s['k1_launches'])
                              for m, s in sorted(scans.items())),
                    SCL_DS, build_s, build_k1))
            t = lap('ii', t)

            # (iii) failover and the degraded modes
            stop('b')
            for name, _, _ in QUERY_CASES:
                routed('a', name)
            fo = tclient.stats(socks['a'])['cluster']['counters']
            check(fo['failovers'] >= 1 and fo['degraded'] == 0,
                  'scl: b stopped, failovers %d degraded %d'
                  % (fo['failovers'], fo['degraded']))
            stop('c')
            req = dict(sub_request(cli, QUERY_CASES[1][1], 'month'),
                       op='query')
            rc, hd, out, err = tclient.request_bytes(socks['a'], req,
                                                     timeout_s=SCL_WAIT_S)
            check(rc == 1 and out == b'' and hd.get('retryable') and
                  hd['stats'].get('missing_partitions') == [1] and
                  b'partition(s) unavailable: 1' in err,
                  'scl: b and c stopped, DN_ROUTER_PARTIAL=error gave rc '
                  '%d %r: %s' % (rc, hd.get('stats'), err[-300:]))
            err_mode = err.decode().strip()
            stop('a')
            start('a', DN_ROUTER_PARTIAL='allow')
            rc, hd, out, err = tclient.request_bytes(socks['a'], req,
                                                     timeout_s=SCL_WAIT_S)
            check(rc == 0 and hd['stats'].get('partial') is True and
                  hd['stats'].get('missing_partitions') == [1] and out and
                  b'partition(s) 1 unavailable' in err,
                  'scl: DN_ROUTER_PARTIAL=allow gave rc %d %r: %s'
                  % (rc, hd.get('stats'), err[-300:]))
            allow_mode = err.decode().strip()
            stop('a')
            for m in 'abc':
                start(m)
            doc['failover'] = {'failovers': fo['failovers'],
                               'error': err_mode, 'allow': allow_mode}
            log('scl (iii) failover: b stopped, (a)-(e) through a = phase '
                '7 (%d failovers); c stopped too: error mode "%s"; allow '
                'mode rc 0, partial, "%s"' % (fo['failovers'], err_mode,
                                              allow_mode))
            t = lap('iii', t)

            # (iv) d joins with an empty tree: the handoff
            new = topo_doc('abcd', SCL_JOIN_PARTITIONS)
            t_join = time.monotonic()
            committed, pending = tcoord.begin_transition(topo_path, new)
            for s in servers.values():
                s.topo_watcher.poll_now()
            srv_d = start('d')
            check(srv_d.puller is not None and
                  srv_d.puller.wait(SCL_WAIT_S) and srv_d.puller.ready,
                  'scl: d\'s handoff: %r' % (srv_d.puller.status()
                                             if srv_d.puller else None))
            pull_s = time.monotonic() - t_join
            hand = dict(srv_d.puller.counters)
            status = tcoord.wait_ready(topo_path, timeout_s=SCL_WAIT_S)
            check(status.get('ready'), 'scl: transition not ready: %r'
                  % status)
            tcoord.commit_transition(topo_path)
            for s in servers.values():
                s.topo_watcher.poll_now()
            epochs = {m: s.cluster.epoch for m, s in servers.items()}
            check(set(epochs.values()) == {pending.epoch},
                  'scl: epochs after the commit %r' % epochs)
            want = {rel: path for rel, path in mod_integ.iter_tree_shards(
                os.path.join(tmp, 'idx_month'))
                if pending.partition_of(
                    path, mod_scrub.rel_timeformat(rel)) == 2}
            got = dict(mod_integ.iter_tree_shards(trees['d']))
            check(got and set(got) == set(want),
                  'scl: d holds %d shards, partition 2 has %d'
                  % (len(got), len(want)))
            for rel in got:
                check(file_bytes(got[rel]) == file_bytes(want[rel]),
                      'scl: d\'s %s differs from its donors\'' % rel)
            check(hand['shards_streamed'] == len(want) and
                  hand['bytes_streamed'] == sum(
                      os.path.getsize(p) for p in got.values()),
                  'scl: the puller counted %r' % hand)
            for name, _, _ in QUERY_CASES:
                routed('d', name)
            doc['handoff'] = {'shards': hand['shards_streamed'],
                              'bytes': hand['bytes_streamed'],
                              'pull_s': pull_s, 'epoch': pending.epoch}
            log('scl (iv) handoff: d joined with an empty tree, pulled %d '
                'shards (%d B) of partition 2 in %.2f s, byte-equal to its '
                'donors\'; epoch %d committed on all 4; (a)-(e) through d '
                '= phase 7' % (hand['shards_streamed'],
                               hand['bytes_streamed'], pull_s,
                               pending.epoch))
            t = lap('iv', t)

            # (v) a flipped byte on a: failover, then the repair
            with env_scope(DN_VERIFY='open'):
                mod_integ.reset_memo()
                topo = servers['a'].cluster
                catalog = mod_integ.load_catalog(trees['a'])
                rel = [r for r in sorted(catalog) if r.startswith('by_hour')
                       and topo.partition_of(
                           os.path.join(trees['a'], r),
                           mod_scrub.rel_timeformat(r)) == 0][0]
                shard = os.path.join(trees['a'], rel)
                size = os.path.getsize(shard)
                with open(shard, 'r+b') as f:
                    f.seek(size // 2)
                    byte = f.read(1)
                    f.seek(size // 2)
                    f.write(bytes([byte[0] ^ 0x5a]))
                mod_iqmt.shard_cache_clear()
                b = QUERY_CASES[1][0]
                routed('a', b)
                deadline = time.monotonic() + SCL_WAIT_S
                while True:
                    try:
                        if mod_integ.file_crc(shard) == catalog[rel]:
                            break
                    except OSError:
                        pass
                    check(time.monotonic() < deadline,
                          'scl: the repair of %s never landed' % rel)
                    time.sleep(0.1)
                check(file_bytes(shard) == file_bytes(
                    os.path.join(trees['b'], rel)),
                      'scl: the repaired %s differs from b\'s' % rel)
                rep = tclient.stats(socks['a'])['integrity']['repair']
                cf = tclient.stats(socks['a'])['cluster']['counters']
                rc, out, err, scrub_s = served(tserver, cli, [
                    'scrub', '--remote', socks['a']])
                sdoc = json.loads(out) if rc == 0 else {}
                tree = sdoc.get('trees', {}).get('month', {})
                check(rc == 0 and tree.get('corrupt') == 0 and
                      tree.get('missing') == 0 and tree.get('verified'),
                      'scl: scrub --remote a: rc %d %r: %s'
                      % (rc, tree, err[-300:]))
                rc, qlist, err, _ = served(tserver, cli, [
                    'quarantine', 'list', '--tree', trees['a']])
                check(rc == 0 and os.path.basename(rel) in qlist,
                      'scl: quarantine list: rc %d: %s%s'
                      % (rc, qlist, err))
            doc['repair'] = {'shard': rel, 'repair': rep,
                             'corrupt_failovers': cf['corrupt_failovers'],
                             'scrub': {'verified': tree['verified'],
                                       'wall_s': scrub_s},
                             'quarantine_lines': len(qlist.splitlines())}
            log('scl (v) self-repair: %s flipped on a; (b) through a = '
                'phase 7 (%d corrupt failovers); repaired from b, '
                'byte-equal (repair %r); scrub --remote a: %d verified, 0 '
                'corrupt, 0 missing in %.2f s; quarantine list: %s'
                % (rel, cf['corrupt_failovers'], rep, tree['verified'],
                   scrub_s, qlist.strip()[:160]))
            t = lap('v', t)

            # (vi) a routed standing query across a publish through a
            b_args = QUERY_CASES[1][1]
            reader = FrameReader(tclient, socks['a'],
                                 sub_request(cli, b_args, SCL_DS), 'scl')
            readers.append(reader)
            _, seed = reader.wait(lambda fr: fr['seq'] == 1, 'its seed')
            poll = served(tserver, cli, ['query', '--remote', socks['a']] +
                          b_args + [SCL_DS])
            check(poll[0] == 0 and seed['payload'] == poll[1].encode(),
                  'scl: the routed seed frame differs from a routed poll')
            time.sleep(2.0)        # past the seed's confirming scatter
            before, _ = _sub_counters(tclient, socks['a'])
            mark = reader.mark()
            gen_s = append_records(sub_data, SCL_PUB_RECORDS, 16,
                                   SCL_PUB_AFTER, SCL_PUB_BEFORE)
            l0 = ck.launches['onehot_dense']
            rc, out, err, pub_s = served(tserver, cli, [
                'build', '--remote', socks['a'], '--interval=hour',
                '--after', SCL_PUB_AFTER, '--before', SCL_PUB_BEFORE,
                SCL_DS])
            pub_k1 = ck.launches['onehot_dense'] - l0
            check(rc == 0, 'scl: the publish through a: %s' % err[-300:])
            poll = served(tserver, cli, ['query', '--remote', socks['a']] +
                          b_args + [SCL_DS])
            check(poll[0] == 0, 'scl: routed poll failed: %s' % poll[2])
            tf, fr = reader.wait(lambda fr: fr['payload'] ==
                                 poll[1].encode(), 'the routed poll\'s '
                                 'bytes', since=mark)
            time.sleep(2.0)        # past the publish's confirm
            after, _ = _sub_counters(tclient, socks['a'])
            recomputes = (after['recomputes'] - after['reconfirms']) - \
                (before['recomputes'] - before['reconfirms'])
            check(recomputes == 1 and reader.mark() - mark == 1,
                  'scl: the publish cost %d recomputes and %d frames'
                  % (recomputes, reader.mark() - mark))
            doc['subscribe'] = {'publish_s': pub_s, 'append_s': gen_s,
                                'k1_launches': pub_k1,
                                'recomputes': recomputes,
                                'reconfirms': after['reconfirms'] -
                                before['reconfirms'],
                                'frame_bytes': len(fr['payload'])}
            log('scl (vi) routed standing query (b) on %s through a: seed '
                '= a routed poll; %d records published through a in %.2f '
                's (K1 %d): 1 recompute, 1 frame (%d B) = the routed poll, '
                '%d confirming scatters' % (
                    SCL_DS, SCL_PUB_RECORDS, pub_s, pub_k1,
                    len(fr['payload']), doc['subscribe']['reconfirms']))
            t = lap('vi', t)

            # (vii) the fleet view
            rc, top, err, _ = served(tserver, cli, ['top', '--remote',
                                                    socks['a'], '--once'])
            up = sorted(ln.split()[0] for ln in top.splitlines()
                        if re.match(r'[abcd] +up\b', ln))
            check(rc == 0 and 'members 4/4 up' in top and
                  up == list('abcd'),
                  'scl: dn top --once: rc %d\n%s%s' % (rc, top, err))
            rc, st, err, _ = served(tserver, cli, ['stats', '--cluster',
                                                   '--remote', socks['a']])
            fleet = json.loads(st) if rc == 0 else {}
            check(rc == 0 and fleet.get('members_up') == 4 and
                  sorted(fleet.get('members', {})) == list('abcd'),
                  'scl: stats --cluster: rc %d: %s' % (rc, err[-300:]))
            log('scl (vii) fleet: dn top --once:\n%s'
                % '\n'.join('    ' + ln for ln in
                            top.rstrip('\n').splitlines()[:8]))
            t = lap('vii', t)
            for m in list(servers):
                stop(m)
            for r in readers:
                r.join()
            torch.cuda.synchronize()
            launches = {'onehot_dense': ck.launches['onehot_dense'],
                        'sums': mod_iqs.launches['sums']}
            gc.collect()
            mem_after = torch.cuda.memory_allocated()
            t = lap('viii', t)
    finally:
        for m in list(servers):
            stop(m)
    check(all(r.ended == 'end' for r in readers),
          'scl: the stream was not ended by an end frame')
    check(mem_after - mem_before <= DRAIN_SLACK_BYTES,
          'scl: device memory after the drain %d B, before the members '
          '%d B' % (mem_after, mem_before))
    doc['memory'] = {'before': mem_before, 'after_drain': mem_after}
    doc['launches'] = launches
    doc['wall_s'] = time.monotonic() - t_phase
    log('scl (viii) drain: device memory %d B before the members, %d B '
        'after their drain; launches K1 %d, K7a %d; phase %.1f s (%s)'
        % (mem_before, mem_after, launches['onehot_dense'],
           launches['sums'], doc['wall_s'],
           fmt_times(doc['walls_s'], 1)))
    return doc


class FoldLedger(object):
    """Every device-scan fold of the run (DeviceScan._fold_staged, one a
    metric and batch, on any thread) and the scan program's launches it
    made, which must be one per shard of its mesh (one off a mesh).
    Folds run one at a time under the ledger's lock, so a fold's launch
    count is its own; `since` reads a phase's share."""

    def __init__(self, mod_ds, ck):
        import threading
        self.lock = threading.RLock()
        self.folds = 0
        self.launches = 0
        self.bad = []
        orig = mod_ds.DeviceScan._fold_staged
        ledger = self

        def fold_staged(scan, staged, args):
            mesh = scan._device_mesh()
            want = 1 if mesh is None or staged[1][-1] else mesh[0].size
            with ledger.lock:
                l0 = ck.launches['scan_body']
                rv = orig(scan, staged, args)
                got = ck.launches['scan_body'] - l0
                ledger.folds += 1
                ledger.launches += got
                if got != want:
                    ledger.bad.append('%d launches for %d shard(s) (%d '
                                      'records, segments %d)'
                                      % (got, want, staged[0], staged[3]))
            return rv
        mod_ds.DeviceScan._fold_staged = fold_staged

    def mark(self):
        return self.folds, self.launches, len(self.bad)

    def since(self, mark):
        """(folds, K2 launches, the folds that launched otherwise) since
        `mark`."""
        return (self.folds - mark[0], self.launches - mark[1],
                self.bad[mark[2]:])


def edge_records(path, n, seed):
    """n records of every tag kind in the fields EDGE_QUERY reads, with
    bad dates and negative values (phase 3b)."""
    import random
    rng = random.Random(seed)
    hosts = ['a', 'b', 'c', None, True, False, {'x': 1}, 17, -3]
    lats = [0, 1, 2, 16, 17, 200, 4096, 2147483647, -1, -7, -2147483648,
            '26', 'x', None, True]
    with open(path, 'w') as f:
        for i in range(n):
            rec = {}
            if rng.random() < 0.93:
                rec['host'] = rng.choice(hosts + ['host-%d' % (i % 40)])
            if rng.random() < 0.9:
                rec['req'] = {'method': rng.choice(['GET', 'PUT', None])}
            if rng.random() < 0.95:
                rec['latency'] = rng.choice(lats + [rng.randrange(5000)])
            if rng.random() < 0.95:
                rec['code'] = rng.choice([200, 204, 404, 500, '500', None])
            if rng.random() < 0.9:
                rec['delta'] = rng.choice([rng.randrange(-60, 60), 'n/a'])
            r = rng.random()
            if r < 0.9:
                rec['time'] = '2014-05-%02dT%02d:%02d:%02dZ' % (
                    1 + i * 3 // n, rng.randrange(24), rng.randrange(60),
                    rng.randrange(60))
            elif r < 0.95:
                rec['time'] = 'invalid'
            f.write(json.dumps(rec) + '\n')


def _body_bound(prog, args, n, occ):
    """(bound ms, 'bytes' or 'operations') of one scan-program call:
    each per-record input and table byte read once and each output byte
    written once (the fused key or the sparse rows, the first-occurrence
    and dense bins this batch touched, the counters), at 3.35 TB/s;
    against the integer operations the program needs a record (a
    compare or select per leaf, fold and counter, a multiply-add per key
    column) at the int32 rate."""
    from dragnet_tpu_torch import scan_program as sp
    nbytes = sum(args[k].numel() * args[k].element_size()
                 for k in prog.slot_keys)
    if prog.mode == sp.MODE_SPARSE:
        nbytes += 24 * n
    else:
        nbytes += (4 * n if prog.mode == sp.MODE_K1 else 8 * occ) + \
            8 * occ
    nbytes += 8 * prog.ncounters
    nleaf = sum(1 for op in prog.ops if op[0] == sp.OP_LEAF)
    nkey = prog.header['key_end'] - prog.header['key_begin']
    per_record = 2 * nleaf + (len(prog.ops) - nleaf - nkey) + \
        3 * nkey + prog.ncounters + 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * per_record / INT32_OPS_PER_S * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else \
        (ops_ms, 'operations')


def body_phase(tmp, data, reps):
    """Phase 3b: the scan program K2 against its plain version on the
    card, exactly, on the first batch of phase 3's file for each
    BODY_CASES query (and of generated edge records for the last), in
    every output mode the batch's key space allows and as two mesh
    shards; each case's own route timed (K2 in a CUDA graph of `reps`
    calls and issued one by one; the plain version issued one by one)
    against its bound."""
    import numpy as np
    import torch
    from dragnet_tpu_torch import devbench
    from dragnet_tpu_torch import query as mod_query
    from dragnet_tpu_torch import scan_program as sp
    from dragnet_tpu_torch.device_scan import (DeviceScan,
                                               MAX_DENSE_SEGMENTS, I64MAX)
    from dragnet_tpu_torch.engine import NativeColumns, BATCH_SIZE
    from dragnet_tpu_torch.vpipe import Pipeline
    dev = torch.device('cuda')
    edge = os.path.join(tmp, 'edge.log')
    edge_records(edge, BATCH_SIZE + 1000, 7)
    shapes = []
    worst = 0
    for name, qconf, tfield, dsf, signed, use_edge in BODY_CASES:
        scan = DeviceScan(mod_query.query_load(json.loads(json.dumps(
            qconf))), tfield, Pipeline(), ds_filter=dsf, device=dev)
        parser = devbench._one_batch_parser(edge if use_edge else data,
                                            scan, BATCH_SIZE)
        n = parser.batch_size()
        rng = np.random.default_rng(len(name))
        w = rng.integers(-3, 9, n).astype(np.float64) if signed \
            else np.ones(n)
        scan.capture_next = True
        check(scan._try_device(NativeColumns(parser), w, None),
              'body %s: the batch was refused' % name)
        torch.cuda.synchronize()
        inputs, staged, use_kernel = scan.captured
        _, profile, caps, ns, _ = staged
        own = sp.MODE_SPARSE if profile[-1] else \
            sp.MODE_K1 if use_kernel else sp.MODE_DENSE
        args = {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    if isinstance(v, np.ndarray) else v)
                for k, v in inputs.items()}
        nsb = max(ns, 1)
        modes = [m for m in (sp.MODE_K1, sp.MODE_DENSE, sp.MODE_SPARSE)
                 if m == sp.MODE_SPARSE or nsb <= MAX_DENSE_SEGMENTS]
        checked = 0
        for mode in modes:
            prog = scan._program(profile, caps, ns, mode)
            rowkeys = {prog.slot_keys[i] for i in prog.rows}
            shards = [(0, n, None)]
            if mode != sp.MODE_SPARSE and profile[1]:
                shards += [(0, n // 2, n - 3), (n // 2, n - n // 2, n - 3)]
            for row0, sn, nvalid in shards:
                sargs = {k: args[k][row0:row0 + sn].contiguous()
                         if k in rowkeys else args[k]
                         for k in prog.slot_keys}
                accs = []
                nacc = 1 if mode == sp.MODE_SPARSE else nsb
                for _ in range(2):
                    accs.append([
                        torch.zeros(nacc, dtype=torch.int64, device=dev),
                        torch.full((nacc,), I64MAX, dtype=torch.int64,
                                   device=dev),
                        torch.zeros(prog.ncounters, dtype=torch.int64,
                                    device=dev)])
                kouts = [torch.empty(sn, dtype=torch.int32, device=dev)
                         for _ in range(2)]
                got = sp.scan_body(prog, sargs, sn, *accs[0], base=9 << 32,
                                   row0=row0, nvalid=nvalid,
                                   key_out=kouts[0])
                want = sp.scan_body_ref(prog, sargs, sn, *accs[1],
                                        base=9 << 32, row0=row0,
                                        nvalid=nvalid, key_out=kouts[1])
                torch.cuda.synchronize()
                pairs = list(zip(accs[0], accs[1]))
                if mode == sp.MODE_K1:
                    pairs.append((got, want))
                elif mode == sp.MODE_SPARSE:
                    pairs += list(zip(got, want))
                    pairs = pairs[2:]      # dense and first are unused
                err = max(int((a.to(torch.float64) - b.to(torch.float64))
                              .abs().max()) if a.numel() else 0
                          for a, b in pairs)
                worst = max(worst, err)
                check(err == 0 and all(torch.equal(a, b)
                                       for a, b in pairs),
                      'body %s: K2 differs from its plain version in mode '
                      '%d (rows %d+%d, max abs err %d)'
                      % (name, mode, row0, sn, err))
                checked += 1
        # the case's own route, timed
        prog = scan._program(profile, caps, ns, own)
        nacc = 1 if own == sp.MODE_SPARSE else nsb
        acc = [torch.zeros(nacc, dtype=torch.int64, device=dev),
               torch.full((nacc,), I64MAX, dtype=torch.int64, device=dev),
               torch.zeros(prog.ncounters, dtype=torch.int64, device=dev)]
        kout = torch.empty(n, dtype=torch.int32, device=dev)
        sp.scan_body(prog, args, n, *acc, key_out=kout)
        torch.cuda.synchronize()
        occurred = int((acc[1] < I64MAX).sum()) if own != sp.MODE_SPARSE \
            else 0
        ms, eager = cuda_time_ms(
            lambda: sp.scan_body(prog, args, n, *acc, key_out=kout), reps)
        plain_ms, plain_host = cuda_time_events(
            lambda: sp.scan_body_ref(prog, args, n, *acc, key_out=kout),
            max(3, reps // 10))
        bound, by = _body_bound(prog, args, n, occurred)
        r = {'case': name, 'mode': ['k1', 'dense', 'sparse'][own],
             'n': n, 'ns': ns, 'slots': len(prog.slot_keys),
             'ops': len(prog.ops), 'stack': prog.stack_depth(),
             'modes_checked': checked, 'max_abs_err': worst, 'ms': ms,
             'eager_ms': eager, 'plain_ms': plain_ms,
             'plain_host_ms': plain_host, 'bound_ms': bound,
             'bound_by': by, 'library_ms': None}
        shapes.append(r)
        log('body %-44s %-6s %6d records, %9d segments, %2d slots, %3d '
            'ops: exact in %d mode/shard runs; K2 %.4f ms (one by one '
            '%.4f), plain %.4f ms (host %.4f), bound %.6f ms (%s, %.1f %%)'
            % (name, r['mode'], n, ns, r['slots'], r['ops'], checked, ms,
               eager, plain_ms, plain_host, bound, by, 100 * bound / ms))
        del scan, args, acc, kout
    torch.cuda.synchronize()
    return {'shapes': shapes, 'max_abs_err': worst}


def devbench_phase(tmp, data):
    """Phase 16: devbench.kernel_bench on the card over the first scan
    batch of the data file, for both legs: the scan program K2 launching
    once per fold of the resident loop on both, K1 once per fold on
    PALLAS_QUERY and never on QUERY, the resident accumulator equal to
    DEVBENCH_ITERS + 1 plain folds (scan_body_ref with index_add_, no
    kernel) of the batch on the card, bound_share below 1.05; then each
    leg under DN_BENCH_TRACE, whose trace must hold exactly K2 and K1
    (PALLAS_QUERY) or K2 alone (QUERY) as the device kernels of each
    fold, and device memory back to its level."""
    import torch
    from dragnet_tpu_torch import devbench
    from dragnet_tpu_torch.engine import BATCH_SIZE
    import numpy as np
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    legs = []
    for name, qconf, kernel in DEVBENCH_LEGS:
        cap = {}
        r = devbench.kernel_bench(data, qconf, iters=DEVBENCH_ITERS,
                                  max_records=BATCH_SIZE, capture=cap)
        check(r is not None, 'devbench %s: refused the batch' % name)
        check(r['records'] == BATCH_SIZE and r['platform'] == 'gpu',
              'devbench %s: %d records on %s'
              % (name, r['records'], r['platform']))
        check((r['segments'] <= 4096) == kernel,
              'devbench %s: %d segments' % (name, r['segments']))
        check(r['onehot_kernel'] is kernel and r['kernel_launches'] ==
              (DEVBENCH_ITERS if kernel else 0),
              'devbench %s: onehot_kernel %s, K1 %d launches in %d folds'
              % (name, r['onehot_kernel'], r['kernel_launches'],
                 DEVBENCH_ITERS))
        check(r['body_kernel'] and r['body_launches'] == DEVBENCH_ITERS,
              'devbench %s: K2 %d launches in %d folds'
              % (name, r['body_launches'], DEVBENCH_ITERS))
        check(r['bound_share'] is not None and r['bound_share'] < 1.05,
              'devbench %s: bound share %r' % (name, r['bound_share']))
        folds = DEVBENCH_ITERS + 1
        dense, first, cvec = cap['resident']
        pdense, pfirst, pcvec = cap['plain']
        err = int(np.abs(dense - folds * pdense).max())
        check(pdense.sum() > 0 and err == 0 and
              np.array_equal(cvec, folds * pcvec) and
              np.array_equal(first, pfirst),
              'devbench %s: the resident accumulator is not %d plain '
              'folds (max abs err %d)' % (name, folds, err))
        log('devbench %-12s %6d segments  resident %.4f ms/batch (events '
            '%.4f)  %.0f records/s  bound %.6f ms (%.4f %%)  K2 %d  K1 %d  '
            'H2D %.3f GB/s (%.1f B/record)  D2H %.1f MB/s  reupload '
            '%.0f records/s  residency x%.2f'
            % (name, r['segments'], r['kernel_ms_per_batch'],
               r['device_ms_per_batch'], r['kernel_records_per_sec'],
               r['bound_ms'], 100 * r['bound_share'], r['body_launches'],
               r['kernel_launches'], r['h2d_gb_per_sec'],
               r['h2d_bytes_per_record'], r['d2h_mb_per_sec'],
               r['reupload_records_per_sec'], r['residency_speedup']))
        legs.append(dict(r, name=name, max_abs_err=err))
    # where a traced fold's time goes: the device kernels it ran (the
    # trace's `kernel` events) against its wall, per leg
    trace = {}
    for name, qconf, kernel in DEVBENCH_LEGS:
        tracedir = os.path.join(tmp, 'devbench_trace_' + name)
        with env_scope(DN_BENCH_TRACE=tracedir):
            traced = devbench.kernel_bench(data, qconf,
                                           iters=DEVBENCH_ITERS,
                                           max_records=BATCH_SIZE)
        files = [os.path.join(d, f) for d, _, fs in os.walk(tracedir)
                 for f in fs]
        named = [f for f in files if K2_SYMBOL.encode() in file_bytes(f)]
        check(traced is not None and traced['body_kernel'] and
              len(named) == 1,
              'devbench trace %s: %d files, %d naming %s'
              % (name, len(files), len(named), K2_SYMBOL))
        with open(named[0]) as f:
            events = json.load(f)['traceEvents']
        kernels = [e for e in events if e.get('cat') == 'kernel']
        k1 = [e for e in kernels if K1_SYMBOL in e.get('name', '')]
        k2 = [e for e in kernels if K2_SYMBOL in e.get('name', '')]
        want = (2 if kernel else 1) * DEVBENCH_ITERS
        check(len(k2) == DEVBENCH_ITERS and
              len(k1) == (DEVBENCH_ITERS if kernel else 0) and
              len(kernels) == want,
              'devbench trace %s: %d device kernels (K2 %d, K1 %d) in %d '
              'folds, want %d' % (name, len(kernels), len(k2), len(k1),
                                  DEVBENCH_ITERS, want))
        t = {
            'file_bytes': os.path.getsize(named[0]),
            'ms_per_fold': traced['kernel_ms_per_batch'],
            'kernels_per_fold': len(kernels) / DEVBENCH_ITERS,
            'kernel_ms_per_fold':
            sum(e.get('dur', 0) for e in kernels) / 1e3 / DEVBENCH_ITERS,
            'k2_launches': len(k2),
            'k2_ms_per_fold':
            sum(e.get('dur', 0) for e in k2) / 1e3 / DEVBENCH_ITERS,
            'k1_launches': len(k1),
            'k1_ms_per_fold':
            sum(e.get('dur', 0) for e in k1) / 1e3 / DEVBENCH_ITERS}
        trace[name] = t
        log('devbench trace %s: %s (%d B); a traced fold %.4f ms, %.1f '
            'device kernels (%.4f ms on the device: K2 %d launches, %.4f '
            'ms a fold; K1 %d, %.4f ms)'
            % (name, os.path.basename(named[0]), t['file_bytes'],
               t['ms_per_fold'], t['kernels_per_fold'],
               t['kernel_ms_per_fold'], t['k2_launches'],
               t['k2_ms_per_fold'], t['k1_launches'], t['k1_ms_per_fold']))
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    check(mem_after <= mem_before,
          'devbench: device memory %d B after, %d B before'
          % (mem_after, mem_before))
    log('devbench: device memory %d B before, %d B after'
        % (mem_before, mem_after))
    return {'iters': DEVBENCH_ITERS, 'legs': legs, 'trace': trace,
            'memory': {'before': mem_before, 'after': mem_after}}


def file_bytes(path):
    with open(path, 'rb') as f:
        return f.read()


def main_path_keys(ck, captured, reps):
    """Phase 5: the kernel on the fused keys the main path gave it, the
    largest batch of each query at each segment count."""
    import torch
    results = []
    for (name, ns), (fused, w) in sorted(captured.items()):
        results.append(check_into(ck, 'main path: %s' % name, ns, fused,
                                  w, reps))
        results[-1]['query'] = name
    torch.cuda.synchronize()
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--records', type=int, default=2000000)
    ap.add_argument('--seed', type=int, default=12345)
    ap.add_argument('--reps', type=int, default=100)
    ap.add_argument('--json', help='also write every kernel shape\'s '
                    'result to this file')
    ap.add_argument('--cluster-child', metavar='SPEC',
                    help=argparse.SUPPRESS)
    ap.add_argument('--only-scl', action='store_true',
                    help='run only what phase 15 needs (phases 1-4 and '
                    '7) and phase 15; prints no result line')
    ap.add_argument('--only-devbench', action='store_true',
                    help='run only phases 1 and 16 (over the generated '
                    'data); prints no result line')
    ap.add_argument('--only-body', action='store_true',
                    help='run only phases 1, 3b and 16 (over the '
                    'generated data); prints no result line')
    args = ap.parse_args()
    if args.cluster_child:
        return cluster_child(args.cluster_child)

    t_smoke = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: CUDA is not available\n')
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from dragnet_tpu_torch import cli
    from dragnet_tpu_torch import native as mod_native
    from dragnet_tpu_torch import device_scan as mod_ds
    from dragnet_tpu_torch.config import ConfigBackendLocal
    from dragnet_tpu_torch import datasource_for_name
    from dragnet_tpu_torch.ops import cuda_kernels as ck
    # every fold of the run, on every path: K2 once per fold and shard
    ledger = FoldLedger(mod_ds, ck)

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log('card: %s (torch %s, CUDA %s)' % (card, torch.__version__,
                                          torch.version.cuda))

    # 1. build: one nvcc per kernel source, started together
    t0 = time.monotonic()
    nvcc_log = ck.build()
    ck._load()
    from dragnet_tpu_torch.ops import byteparse_kernels as bk
    bk.scratch_len(1)
    log('build: %s in %.2f s' % (', '.join(k + '.cu' for k in ck.KERNELS),
                                 time.monotonic() - t0))
    log(nvcc_log.rstrip() if nvcc_log else
        '(library up to date, not rebuilt)')
    if args.only_devbench or args.only_body:
        with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
            data = os.path.join(tmp, 'muskie.log')
            mod_native.gen_to_file(args.records, data, seed=args.seed)
            if args.only_body:
                t0 = time.monotonic()
                body = body_phase(tmp, data, args.reps)
                torch.cuda.synchronize()
                log('phase 3b body: %.1f s' % (time.monotonic() - t0))
                print(json.dumps({'body': body}), flush=True)
            t0 = time.monotonic()
            m = ledger.mark()
            devb = devbench_phase(tmp, data)
            torch.cuda.synchronize()
            folds, k2, bad = ledger.since(m)
            check(not bad and k2 == folds > 0,
                  'phase 16: %d K2 launches in %d folds (%s)'
                  % (k2, folds, bad[:3]))
            log('phase 16 devbench: %.1f s (%d folds, K2 %d launches)'
                % (time.monotonic() - t0, folds, k2))
        print(json.dumps({'devbench': dict(devb, card=card)}), flush=True)
        log('smoke (phases 1, %s16 only): %.1f s'
            % ('3b and ' if args.only_body else '',
               time.monotonic() - t_smoke))
        return 0

    # 2. kernel vs plain at the reference's test shapes (weighted), at
    # one batch with each kernel query's caps (unit weights, as the main
    # path calls it), and over the sweep
    results = [check_kernel(ck, radices, n, False, args.reps)
               for radices, n in PALLAS_SHAPES]
    slice_results = [check_kernel(ck, radices, n, True, args.reps)
                     for radices, n in SLICE_SHAPES]
    sweep_results = kernel_sweep(ck, args.reps)
    stream_costs = host_costs(ck)
    fold_bench = sparse_fold_bench(mod_ds, args.reps)
    torch.cuda.synchronize()

    # 3. data
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        data = os.path.join(tmp, 'muskie.log')
        t0 = time.monotonic()
        mod_native.gen_to_file(args.records, data, seed=args.seed)
        log('data: %d records (%d bytes) in %.2f s'
            % (args.records, os.path.getsize(data),
               time.monotonic() - t0))
        os.environ['DRAGNET_CONFIG'] = os.path.join(tmp, 'dragnetrc')
        os.environ['DN_TORCH_DEVICE'] = DEVICE
        # phases 3-7: the forced device lane (DN_ENGINE=jax), held
        # against the single-threaded host engine as in earlier runs;
        # phase 8 runs the default engine
        os.environ['DN_ENGINE'] = 'jax'
        os.environ['DN_SCAN_THREADS'] = '0'
        os.environ['DN_AUDITION_CACHE'] = '0'
        rc, out, err = run_cli(cli, [
            'datasource-add', 'muskie', '--path=' + data,
            '--time-field=time', '--filter={"ne":["host","zzz"]}'])
        check(rc == 0, 'datasource-add failed: %s' % err)
        _, config = ConfigBackendLocal().load()
        ds = datasource_for_name(config, 'muskie')
        cold = os.path.join(tmp, 'cold.log')
        mod_native.gen_to_file(COLD_RECORDS, cold, seed=args.seed + 1)
        rc, out, err = run_cli(cli, [
            'datasource-add', 'cold', '--path=' + cold,
            '--time-field=time', '--filter={"ne":["host","zzz"]}'])
        check(rc == 0, 'datasource-add failed: %s' % err)
        for name, qargs, route in QUERIES:
            t0 = time.monotonic()
            rc, out, err = run_cli(cli, ['scan'] + qargs + ['cold'])
            torch.cuda.synchronize()
            check(rc == 0, 'cold %s: scan failed: %s' % (name, err))
            log('cold %-36s %8.3f s  (%d records, first scans of the '
                'process)' % (name, time.monotonic() - t0, COLD_RECORDS))

        walls = {}
        body_folds = {}

        def phase(label, fn, *a):
            t0 = time.monotonic()
            m = ledger.mark()
            rv = fn(*a)
            torch.cuda.synchronize()
            walls[label] = time.monotonic() - t0
            folds, k2, bad = ledger.since(m)
            check(not bad, 'phase %s: the scan program did not launch '
                  'once per fold and shard: %d of %d folds, e.g. %s'
                  % (label, len(bad), folds, bad[:3]))
            body_folds[label] = {'folds': folds, 'launches': k2}
            log('phase %s: %.1f s (%d device folds, K2 %d launches)'
                % (label, walls[label], folds, k2))
            return rv
        body = phase('3b body', body_phase, tmp, data, args.reps)
        shapes, captured, main_launches, forced = phase(
            '4 scans', main_path, cli, mod_ds, ck, ds, args.records)
        if args.only_scl:
            queries, query_outputs = phase(
                '7 query', query_phase, cli, ck, tmp, args.records,
                args.seed)
            scl = phase('15 scl', scl_phase, cli, mod_ds, ck, tmp,
                        query_outputs, forced, None)
            print(json.dumps({'serve_cluster': scl}), flush=True)
            log('smoke (phases 1-4, 7 and 15 only): %.1f s'
                % (time.monotonic() - t_smoke))
            return 0
        sparse = phase('5 sparse', sparse_phase, cli, mod_ds, ds,
                       args.records)
        build = phase('6 build', build_phase, cli, mod_ds, ck, tmp, data,
                      args.records)
        pipeline = phase('6b pipe', pipeline_phase, cli, mod_ds, ck, tmp,
                         args.records, forced, build)
        queries, query_outputs = phase('7 query', query_phase, cli, ck,
                                       tmp, args.records, args.seed)
        auto = phase('8 auto', auto_phase, cli, mod_ds, ck, tmp,
                     args.records, forced, query_outputs)
        parse = phase('9 parse', parse_phase, cli, mod_ds, ck, tmp, data,
                      args.records, args.seed, forced, build, args.reps)
        lifecycle = phase('9b lifecycle', lifecycle_phase, cli, mod_ds,
                          ck, tmp, data, args.records, query_outputs)
        serve, k7, k7a = phase('12 serve', serve_phase, cli, ck, tmp,
                               args.records, query_outputs, forced,
                               main_launches, args.reps)
        cluster, k9 = phase('13 cluster', cluster_phase, cli, mod_ds, ck,
                            tmp, args.records,
                            queries['builds_s']['hour'], args.reps)
        subscribe = phase('14 sub', subscribe_phase, cli, ck, tmp,
                          args.seed, serve['memory'])
        scl = phase('15 scl', scl_phase, cli, mod_ds, ck, tmp,
                    query_outputs, forced,
                    percentile(serve['latency_s']['residency'], 0.5))
        devb = phase('16 devbench', devbench_phase, tmp, data)
    torch.cuda.synchronize()

    # 10. the kernel on the main path's own keys, and on uniform keys at
    # the largest batch of each accumulator shape it gave the kernel
    largest = {}
    for ns, n, weighted in shapes:
        key = (ns, weighted)
        largest[key] = max(largest.get(key, 0), n)
    log('main path kernel shapes (segments, weighted: largest batch): %s'
        % sorted(largest.items()))
    main_results = main_path_keys(ck, captured, args.reps)
    check(len(main_results) >= 2, 'no main-path keys were captured')
    results += slice_results + sweep_results + main_results
    results += [check_into(ck, 'uniform', ns,
                           fused_keys('uniform', ns, n), None, args.reps)
                for (ns, weighted), n in sorted(largest.items())]
    torch.cuda.synchronize()

    at_batch = [r for r in sweep_results + main_results
                if r['n'] == BATCH_RECORDS or r['keys'].startswith('main')]
    for weighted in (False, True):
        timed = [r for r in at_batch if r['weighted'] == weighted]
        slower = [(r['keys'], r['ns'], r['ms'], r['library_ms'])
                  for r in timed if r['ms'] > r['library_ms']]
        log('kernel vs index_add_ at the main path\'s batch, %s weights '
            '(%d shapes): %s' % ('signed' if weighted else 'unit',
                                 len(timed), 'never slower' if not slower
                                 else 'slower at %r' % slower))
    main = [r for r in main_results if r['query'] == QUERIES[1][0]][0]
    large = [r for r in sweep_results if r['n'] == LARGE_RECORDS][0]
    log('bound share at %d x %d: %.1f %% (%.4f ms for a bound of %.4f ms)'
        % (LARGE_RECORDS, LARGE_SEGMENTS, 100 * large['bound_share'],
           large['ms'], large['bound_ms']))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump({'card': card, 'stream_lookup_ms': stream_costs,
                       'shapes': results, 'sparse_fold_bench': fold_bench,
                       'sparse_scans': sparse, 'build': build,
                       'pipeline': pipeline,
                       'query': queries, 'auto': auto, 'parse': parse,
                       'lifecycle': lifecycle, 'serve': serve,
                       'cluster': cluster, 'subscribe': subscribe,
                       'serve_cluster': scl, 'devbench': devb,
                       'body': body, 'body_folds': body_folds,
                       'index_kernels': [k7, k7a, k9]}, f, indent=1)
    print(json.dumps({'query': [
        {k: q[k] for k in ('name', 'route', 'points', 'device_s',
                           'host_s', 'dispatches', 'rows', 'h2d_bytes',
                           'bound_ms', 'stages')} for q in
        queries['queries']], 'builds_s': queries['builds_s']}),
        flush=True)
    print(json.dumps({'pipeline': pipeline}), flush=True)
    print(json.dumps({'auto': {
        'scans': [{k: v for k, v in r.items()} for r in auto['scans']],
        'builds': auto['builds'], 'queries': auto['queries']}}),
        flush=True)
    print(json.dumps({'parse': parse}), flush=True)
    print(json.dumps({'lifecycle': lifecycle}), flush=True)
    print(json.dumps({'serve': {k: serve[k] for k in (
        'prewarm', 'passes', 'scans', 'concurrency', 'write', 'fault',
        'latency_s', 'memory', 'launches', 'wall_s')}}), flush=True)
    print(json.dumps({'cluster': cluster}), flush=True)
    print(json.dumps({'subscribe': subscribe}), flush=True)
    print(json.dumps({'serve_cluster': scl}), flush=True)
    print(json.dumps({'devbench': dict(devb, card=card)}), flush=True)
    print(json.dumps({'body': dict(body, folds=body_folds)}), flush=True)
    block = parse['shapes'][0]
    bmain = [r for r in body['shapes'] if r['case'] == 'QUERY'][0]
    log('phase walls: %s' % fmt_times(walls, 1))
    log('smoke: %.1f s' % (time.monotonic() - t_smoke))
    log('gpu: %s' % card)
    print(json.dumps({'kernels': [{
        'name': 'onehot_dense', 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': KERNEL_REPLACES, 'launches': main_launches,
        'build_launches': build['build_launches'],
        'query_launches': queries['onehot_launches'],
        'auto_launches': auto['auto_launches'],
        'follow_launches': lifecycle['follow']['k1_launches'],
        'serve_launches': serve['launches']['onehot_dense'],
        'serve_worker_launches':
        serve['launches']['onehot_dense_from_workers'],
        'cluster_launches': cluster['cluster_launches'],
        'cluster_process_launches': cluster['cluster_process_launches'],
        'subscribe_launches': subscribe['launches']['onehot_dense'],
        'scl_launches': scl['launches']['onehot_dense'],
        'devbench_launches': sum(r['kernel_launches']
                                 for r in devb['legs']),
        'max_abs_err': max(r['max_abs_err'] for r in results),
        'ms': main['ms'], 'plain_ms': main['plain_ms'],
        'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
        'library_ms': main['library_ms'], 'eager_ms': main['eager_ms'],
        'shape': {'keys': main['keys'], 'ns': main['ns'],
                  'n': main['n']},
        'shapes': results}, dict(
        {'name': 'quote_parity', 'route': 'cuda', 'source': PARITY_SOURCE,
         'replaces': PARITY_REPLACES, 'launches': parse['launches'],
         'build_launches': parse['build_launches'],
         'serve_launches': serve['launches']['quote_parity'],
         'max_abs_err': block['max_abs_err'], 'ms': block['ms'],
         'plain_ms': block['plain_ms'], 'bound_ms': block['bound_ms'],
         'bound_by': block['bound_by'], 'library_ms': None,
         'library_note': 'no single torch call computes the packed '
                         'exclusive parity (cumsum is the plain '
                         'version\'s first step)',
         'eager_ms': block['eager_ms'],
         'round_trip_ms': block['round_trip_ms'],
         'numpy_ms': block['numpy_ms'],
         'shape': {'n': block['n']}, 'shapes': parse['shapes']}),
        {'name': 'scan_body', 'route': 'cuda', 'source': BODY_SOURCE,
         'replaces': BODY_REPLACES, 'launches': BODY_LAUNCHES['main'],
         'phase_launches': {k: v['launches']
                            for k, v in body_folds.items()},
         'phase_folds': {k: v['folds'] for k, v in body_folds.items()},
         'devbench_launches': sum(r['body_launches']
                                  for r in devb['legs']),
         'max_abs_err': body['max_abs_err'], 'ms': bmain['ms'],
         'plain_ms': bmain['plain_ms'], 'bound_ms': bmain['bound_ms'],
         'bound_by': bmain['bound_by'], 'library_ms': None,
         'library_note': 'no single torch call runs the scan program',
         'eager_ms': bmain['eager_ms'],
         'shape': {'case': bmain['case'], 'n': bmain['n'],
                   'ns': bmain['ns']},
         'shapes': body['shapes']},
        dict(k7, query_launches=sum(q['dispatches'] for q in
                                    queries['queries']),
             subscribe_launches=subscribe['launches']['fold']),
        dict(k7a, subscribe_launches=subscribe['launches']['sums'],
             scl_launches=scl['launches']['sums']),
        k9]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
