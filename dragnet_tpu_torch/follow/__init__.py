"""`dn follow` — continuous ingest: tail live streams into
incrementally-published indexes.

Counterpart of dragnet_tpu/follow: a long-lived ingest daemon.

* ``tailer``     — tail growing files (and stdin): bounded reads,
  rotation/truncation detection via stat identity, and the
  held-partial-line discipline (ingest.LineAssembler) so a chunk
  ending mid-line is never parsed as a truncated record.
* ``batcher``    — assemble complete-line buffers into mini-batches
  cut by target latency (DN_FOLLOW_LATENCY_MS) and/or byte budget
  (DN_FOLLOW_MAX_BYTES).
* ``publisher``  — merge each mini-batch's points into the affected
  shards (read-modify-publish through the metric_rows seam, or a
  mini-generation under DN_FOLLOW_APPEND=1), and publish the whole
  touched-shard set two-phase through the commit journal.
* ``checkpoint`` — the durable source-offset record
  (`<indexroot>/.dn_follow/checkpoint.json`).  Its update rides the
  SAME commit journal as the shards (publish_prepared extra_paths),
  which is what makes ingest exactly-once across kill -9.
* ``loop``       — the daemon: poll -> batch -> scan (the build's own
  scan path, on the engine and device the CLI resolved) -> publish,
  drain-safe stop, --once catch-up mode, follow.* fault seams, and
  the follow telemetry (stats_doc + follow_* metrics).
"""

from .loop import stats_doc  # noqa: F401  (the /stats `follow` seam)
