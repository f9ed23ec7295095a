"""dn serve on the card: the resident single-member query server.

Counterpart of dragnet_tpu/serve for one member.  A long-lived daemon
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
* fleet.py     — the fleet document (here the one-member fleet)
* top.py       — `dn top`, the terminal console over the fleet view

The cluster modules (topology, router, coordinator, rebalance) and the
scrub and maintenance threads (scrub) are not ported; the server
refuses every knob and op that would reach them.

Import-light on purpose: the heavy modules load lazily.
"""
