"""Cluster (distributed) datasource backend.

Counterpart of dragnet_tpu/datasource_cluster.py, the replacement for
the reference's Manta map-reduce backend (lib/datasource-manta.js):
instead of fanning `dn` invocations out as compute-job phases, scans and
builds shard each batch across a device mesh and the found files across
torch.distributed processes, and merge partial aggregates, which compose
because points form a commutative monoid (parallel/cluster.py).

The backend accepts the reference's `--backend=manta` spelling as an
alias.
"""


def create_datasource(dsconfig):
    from .parallel import cluster
    return cluster.create_datasource(dsconfig)
