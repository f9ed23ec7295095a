"""dn serve on the card: the resident query server and its cluster.

Counterpart of dragnet_tpu/serve (whole).  A long-lived daemon
holds the warm state every other layer builds — the shard-handle LRU,
the whole-tree find memo, the audition verdicts, the CUDA context and
the built kernel libraries, and the device residency pins — and
executes scan/build/query requests over a newline-JSON socket
protocol with byte-identical output framing.  Modules:

* server.py    — the multi-threaded daemon + request execution
* admission.py — bounded admission, deadlines, request coalescing
* qcache.py    — the query-result cache
* residency.py — device-memory pins and the serve pre-warm (K7a)
* client.py    — the `--remote` thin client with local fallback
* lifecycle.py — pidfile/socket hygiene, drain, writer invalidation
* protocol.py  — wire framing (v1 and multiplexed v2)
* ioloop.py    — the selector connection front end
* pool.py      — pooled persistent multiplexed client connections
* subscribe.py — standing queries: pushed result frames per publish
* fleet.py     — the fleet document, merged over every member
* top.py       — `dn top`, the terminal console over the fleet view
* topology.py  — the cluster map: members, partitions, shard assignment
* router.py    — the scatter-gather router (failover, hedging, degraded
                 modes) and the member side of a partial
* coordinator.py — epoch publication, transitions, the topology watcher
* rebalance.py — partition handoff (shard streaming), the planner
* scrub.py     — self-repair, the scrub thread, anti-entropy, and the
                 rollup/compaction timer

The cluster modules are host code: routing, handoff and repair move
key items and shard files, and each member's requests run on its own
device.

Import-light on purpose: the heavy modules load lazily.
"""
