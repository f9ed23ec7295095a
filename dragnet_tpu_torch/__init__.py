"""dragnet-tpu on PyTorch and CUDA: `dn scan` with the device lane on an
NVIDIA GPU.

The port of the dragnet_tpu package (the JAX reference, which stays
beside it) to torch.  It imports neither jax nor dragnet_tpu: the
backend-free modules it needs (query model, JS value semantics,
aggregator, output) are its own copies.  Entry points run on CUDA unless
the caller asks for the CPU.

Library facade: datasource_for_config, datasource_for_name; the CLI is
`python -m dragnet_tpu_torch`.
"""

from .errors import DNError
from . import datasource_file

__version__ = '0.1.0'


def datasource_for_name(config, dsname):
    dsconfig = config.datasource_get(dsname)
    if dsconfig is None:
        return DNError('unknown datasource: "%s"' % dsname)
    return datasource_for_config(dsconfig)


def datasource_for_config(dsconfig):
    bename = dsconfig['ds_backend']
    if bename == 'file':
        return datasource_file.create_datasource(dsconfig)
    return DNError('datasource backend "%s" is not ported' % bename)
