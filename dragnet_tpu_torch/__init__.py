"""dragnet-tpu on PyTorch and CUDA: `dn scan`, `dn build`,
`dn index-scan` and `dn query` with the device lane on an NVIDIA GPU,
over the file backend or the cluster backend (a device mesh and
torch.distributed processes).

The port of the dragnet_tpu package (the JAX reference, which stays
beside it) to torch.  It imports neither jax nor dragnet_tpu: the
backend-free modules it needs (query model, JS value semantics,
aggregator, output) are its own copies.  Entry points run on CUDA unless
the caller asks for the CPU.

Library facade: datasource_for_config, datasource_for_name,
metrics_for_index, index_config; the CLI is `python -m dragnet_tpu_torch`.
"""

from .errors import DNError
from .query import metric_serialize, metric_deserialize
from . import datasource_file

__version__ = '0.1.0'


def datasource_for_name(config, dsname):
    dsconfig = config.datasource_get(dsname)
    if dsconfig is None:
        return DNError('unknown datasource: "%s"' % dsname)
    return datasource_for_config(dsconfig)


def datasource_for_config(dsconfig):
    bename = dsconfig['ds_backend']
    if bename in ('cluster', 'manta'):
        from . import datasource_cluster
        return datasource_cluster.create_datasource(dsconfig)
    if bename == 'file':
        return datasource_file.create_datasource(dsconfig)
    return DNError('unknown datasource backend: "%s"' % bename)


def metrics_for_index(config, dsname, index_config=None):
    """(reference: lib/dragnet.js:573-598)"""
    metrics = []
    if not index_config:
        for metname, mconfig in config.datasource_list_metrics(dsname):
            metrics.append(mconfig)
    else:
        for mserialized in index_config['metrics']:
            metrics.append(metric_deserialize(mserialized))
    return metrics


def index_config(config, dsname, mtime_iso):
    """Generate the index configuration document.
    (reference: lib/dragnet.js:400-440, lib/dragnet-impl.js:154-169)"""
    dsconfig = config.datasource_get(dsname)
    if dsconfig is None:
        return DNError('unknown datasource: "%s"' % dsname)
    metrics = metrics_for_index(config, dsname)
    if len(metrics) == 0:
        return DNError('no metrics defined for dataset "%s"' % dsname)
    return {
        'user': 'nobody',
        'mtime': mtime_iso,
        'datasource': {
            'backend': dsconfig['ds_backend'],
            'datapath': dsconfig['ds_backend_config'].get('path'),
        },
        'metrics': [metric_serialize(m, skip_datasource=True)
                    for m in metrics],
    }
