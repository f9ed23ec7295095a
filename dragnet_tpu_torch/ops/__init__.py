"""Device resolution for the port's entry points.

Every entry point runs on CUDA unless its caller asks for the CPU
(`device='cpu'`, or DN_TORCH_DEVICE=cpu for the CLI).  There is no
silent CPU: asking for CUDA on a machine without it raises.
"""

import torch

from ..errors import DNError

DEFAULT_DEVICE = 'cuda'


def resolve_device(device=None):
    """The torch.device an entry point runs on: `device` (a string or
    torch.device) when given, else CUDA.  Raises DNError when a CUDA
    device is asked for and CUDA is unavailable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise DNError('CUDA device "%s" requested but CUDA is not '
                      'available (pass device="cpu" or set '
                      'DN_TORCH_DEVICE=cpu to run on the CPU)' % dev)
    if dev.type not in ('cuda', 'cpu'):
        raise DNError('unsupported device "%s"' % dev)
    return dev
