"""Distributed execution: a device mesh inside a process and
torch.distributed across processes.

Counterpart of dragnet_tpu/parallel/.  The reference replaced Manta's
map-reduce (job templates, asset tarballs, polling) with SPMD over a
jax.sharding.Mesh; the port keeps its shape on torch:

* mesh.py: a Mesh is an explicit list of torch devices.  A batch's
  record axis splits into one equal slice per device (padded with dead
  rows), each slice runs its local step on its device (K1, the one-hot
  kernel, where its gate allows, else an i64 index_add_), and the
  partials merge by sum or min on the first device (K9's merge, torch
  ops),
* distributed.py: DN_COORDINATOR / DN_NUM_PROCESSES / DN_PROCESS_ID
  start a gloo process group, and shutdown() ends it in order; each
  process scans its slice of the found files,
* cluster.py: the cluster datasource, whose processes exchange
  serialized points (host data, so gloo carries them) and merge them
  in process order.
"""
