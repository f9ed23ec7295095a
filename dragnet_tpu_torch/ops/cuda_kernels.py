"""The one-hot aggregation kernel for Hopper, its plain torch version
and its routing gate.

Counterpart of dragnet_tpu/ops/pallas_kernels.py (`onehot_dense`,
`should_use`).  The kernel (csrc/onehot_agg.cu, CUDA C++ for sm_90a) is
a shared-memory histogram with integer atomics, not a one-hot GEMM: see
the source for why.  It is built at first use with nvcc into
`_build/libonehot_agg.so` (a plain C entry point, loaded with ctypes),
so nothing but the CUDA toolkit is needed.

The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  `launches` counts kernel
launches, so a run can show the main path went through the kernel.
"""

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from .kernels import fuse_keys

# The reference's limits, kept as defaults: whether the ceiling should
# move on the H100 is an open measurement.
MAX_SEGMENTS = 4096
MAX_TOTAL_WEIGHT = 2 ** 24
MAX_COLS = 32

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'csrc', 'onehot_agg.cu')
BUILD_DIR = os.path.join(_HERE, '_build')
_SO_PATH = os.path.join(BUILD_DIR, 'libonehot_agg.so')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

launches = {'onehot_dense': 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches():
    for k in launches:
        launches[k] = 0


def segments_ok(num_segments):
    """Whether the accumulator fits the kernel's shared histogram."""
    return 0 < num_segments <= MAX_SEGMENTS


def should_use(num_segments, total_weight):
    """The routing gate for the kernel: accumulator within the
    histogram ceiling, and a batch total |weight| below 2^24 so that no
    int32 bin can overflow (the reference's f32-exact limit)."""
    return segments_ok(num_segments) and total_weight < MAX_TOTAL_WEIGHT


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (set CUDA_HOME); the one-hot '
                           'kernel cannot be built')
    return path


def build():
    """Compile the kernel if its library is missing or older than its
    source; returns the library path.  Raises on a failed build."""
    if os.path.exists(_SO_PATH) and \
            os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC):
        return _SO_PATH
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, '.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_SO_PATH) and \
                os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC):
            return _SO_PATH
        tmp = _SO_PATH + '.tmp%d' % os.getpid()
        proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ['-o', tmp, _SRC],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed building %s:\n%s'
                               % (_SRC, proc.stdout))
        os.replace(tmp, _SO_PATH)
    return _SO_PATH


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.dn_onehot_dense.restype = ctypes.c_int
            lib.dn_onehot_dense.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            _lib = lib
        return _lib


def _num_segments(radices):
    ns = 1
    for r in radices:
        ns *= int(r)
    return ns


def onehot_dense_ref(radices, codes, weights, alive):
    """Plain version: (codes[ncols, n] i32, weights[n] i32 or None for
    all-ones, alive[n] bool) -> dense i64[prod(radices)].  Dead rows and
    fused keys outside [0, ns) drop out, as in the kernel."""
    ns = _num_segments(radices)
    fused = fuse_keys(radices, codes)
    keep = alive & (fused >= 0) & (fused < ns)
    w = torch.ones_like(fused) if weights is None \
        else weights.to(torch.int64)
    dense = torch.zeros(ns + 1, dtype=torch.int64, device=codes.device)
    dense.index_add_(0, torch.where(keep, fused, ns),
                     torch.where(keep, w, 0))
    return dense[:ns]


def _check(radices, codes, weights, alive):
    ns = _num_segments(radices)
    if not segments_ok(ns):
        raise ValueError('one-hot kernel: %d segments outside (0, %d]'
                         % (ns, MAX_SEGMENTS))
    if codes.dim() != 2 or codes.shape[0] != len(radices) or \
            not 1 <= len(radices) <= MAX_COLS:
        raise ValueError('one-hot kernel: codes must be [ncols, n] with '
                         'ncols == len(radices) <= %d' % MAX_COLS)
    n = codes.shape[1]
    for name, t, dtype in (('codes', codes, torch.int32),
                           ('weights', weights, torch.int32),
                           ('alive', alive, torch.bool)):
        if t is None:
            continue
        if t.dtype != dtype or not t.is_contiguous() or \
                t.device != codes.device:
            raise ValueError('one-hot kernel: %s must be a contiguous %s '
                             'tensor on %s' % (name, dtype, codes.device))
        if name != 'codes' and tuple(t.shape) != (n,):
            raise ValueError('one-hot kernel: %s must have shape (%d,)'
                             % (name, n))
    return ns, n


def onehot_dense(radices, codes, weights, alive):
    """dense[s] = sum of weights[r] over alive r with fused key s.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    on the current stream (no synchronisation)."""
    if codes.device.type == 'cpu':
        return onehot_dense_ref(radices, codes, weights, alive)
    if codes.device.type != 'cuda':
        raise ValueError('one-hot kernel: unsupported device %s'
                         % codes.device)
    ns, n = _check(radices, codes, weights, alive)
    lib = _load()
    out = torch.zeros(ns, dtype=torch.int64, device=codes.device)
    rad = (ctypes.c_int32 * len(radices))(*[int(r) for r in radices])
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dn_onehot_dense(
            codes.data_ptr(), len(radices), n, rad, ns,
            weights.data_ptr() if weights is not None else None,
            alive.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('one-hot kernel launch failed: CUDA error %d'
                           % rc)
    launches['onehot_dense'] += 1
    return out
