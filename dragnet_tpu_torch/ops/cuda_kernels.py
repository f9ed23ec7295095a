"""The one-hot aggregation kernel for Hopper, its plain torch version
and its routing gate.

Counterpart of dragnet_tpu/ops/pallas_kernels.py (`onehot_dense`,
`should_use`).  The kernel (csrc/onehot_agg.cu, CUDA C++ for sm_90a) is
a cluster-merged shared-memory histogram with integer atomics, not a
one-hot GEMM: see the source for why.  It is built at first use with
nvcc into `_build/libonehot_agg.so` (a plain C entry point, loaded with
ctypes), so nothing but the CUDA toolkit is needed.

Two entries: `onehot_dense_into(out, fused, weights)` adds into a
caller-given i64 accumulator from a precomputed fused key (the device
scan's route), and `onehot_dense(radices, codes, weights, alive)`
fuses, zero-fills and calls it (the engine's route).  The wrappers take
the plain version only for tensors on the CPU; for a CUDA tensor they
launch the kernel or raise.  `launches` counts kernel launches, so a
run can show the main path went through the kernel.
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
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

launches = {'onehot_dense': 0}

_lib = None
_lib_lock = threading.Lock()
_KEY_BYTES = {torch.int32: 4, torch.int64: 8}


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


def _fresh():
    return os.path.exists(_SO_PATH) and \
        os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC)


def build():
    """Compile the kernel into _build/ if the library is missing or
    older than its source.  Returns nvcc's output (ptxas's registers,
    shared memory and spills), or None when the library was up to date.
    Raises on a failed build."""
    if _fresh():
        return None
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(_SO_PATH + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():
            return None
        tmp = _SO_PATH + '.tmp%d' % os.getpid()
        proc = subprocess.run(
            [_nvcc()] + NVCC_FLAGS + ['-o', tmp, _SRC],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed building %s:\n%s'
                               % (_SRC, proc.stdout))
        os.replace(tmp, _SO_PATH)
    return proc.stdout


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(_SO_PATH)
            fn = lib.dn_onehot_dense_into
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p]
            _lib = lib
        return _lib


def current_stream_handle(index):
    """The raw cudaStream_t of CUDA device `index`'s current stream: the
    handle torch.cuda.current_stream(index).cuda_stream gives, without
    building a Stream object (that lookup cost more host time than the
    rest of a call; chip_smoke.py times both).  A private torch call:
    the card tests and chip_smoke.py check it against the public one."""
    return torch._C._cuda_getCurrentRawStream(index)


def _num_segments(radices):
    ns = 1
    for r in radices:
        ns *= int(r)
    return ns


def onehot_dense_into_ref(out, fused, weights):
    """Plain version: out[s] += sum of weights[r] (1 when weights is
    None) over r with fused[r] == s; keys outside [0, len(out)) drop
    out.  Adds in place and returns `out`."""
    ns = out.shape[0]
    f = fused.to(torch.int64)
    keep = (f >= 0) & (f < ns)
    w = torch.ones_like(f) if weights is None else weights.to(torch.int64)
    out.index_add_(0, torch.where(keep, f, 0), torch.where(keep, w, 0))
    return out


def _check_into(out, fused, weights):
    """The kernel's contract on its arguments; raises ValueError."""
    if out.dtype != torch.int64 or out.dim() != 1 or \
            not out.is_contiguous():
        raise ValueError('one-hot kernel: out must be a contiguous 1-d '
                         'int64 tensor')
    ns = out.shape[0]
    if not 0 < ns <= MAX_SEGMENTS:
        raise ValueError('one-hot kernel: %d segments outside (0, %d]'
                         % (ns, MAX_SEGMENTS))
    dev = out.device
    if fused.dtype not in _KEY_BYTES or fused.dim() != 1 or \
            not fused.is_contiguous() or fused.device != dev:
        raise ValueError('one-hot kernel: fused must be a contiguous 1-d '
                         'int32 or int64 tensor on %s' % dev)
    if weights is not None and (
            weights.dtype != torch.int32 or not weights.is_contiguous() or
            weights.shape != fused.shape or weights.device != dev):
        raise ValueError('one-hot kernel: weights must be a contiguous '
                         'int32 tensor shaped like fused, on %s' % dev)
    return ns


def onehot_dense_into(out, fused, weights):
    """out[s] += sum of weights[r] over r with fused key s in [0, ns):
    the kernel's own function.  out: i64[ns] (ns <= 4096); fused: i32 or
    i64[n], dead rows at any value outside [0, ns); weights: i32[n] or
    None for all-ones.  CPU tensors take the plain version; CUDA tensors
    launch the kernel on the device's current stream (no
    synchronisation).  Returns `out`."""
    dev = out.device
    if dev.type == 'cpu':
        return onehot_dense_into_ref(out, fused, weights)
    if dev.type != 'cuda':
        raise ValueError('one-hot kernel: unsupported device %s' % dev)
    ns = _check_into(out, fused, weights)
    lib = _lib or _load()
    rc = lib.dn_onehot_dense_into(
        out.data_ptr(), ns, fused.data_ptr(), _KEY_BYTES[fused.dtype],
        fused.shape[0], None if weights is None else weights.data_ptr(),
        dev.index, current_stream_handle(dev.index))
    if rc != 0:
        raise RuntimeError('one-hot kernel launch failed: CUDA error %d'
                           % rc)
    launches['onehot_dense'] += 1
    return out


def _fuse_alive(radices, codes, alive):
    """The fused i64 key, with dead rows at -1 (outside every
    accumulator)."""
    return torch.where(alive, fuse_keys(radices, codes), -1)


def onehot_dense_ref(radices, codes, weights, alive):
    """Plain version: (codes[ncols, n] i32, weights[n] i32 or None for
    all-ones, alive[n] bool) -> dense i64[prod(radices)].  Dead rows and
    fused keys outside [0, ns) drop out, as in the kernel."""
    out = torch.zeros(_num_segments(radices), dtype=torch.int64,
                      device=codes.device)
    return onehot_dense_into_ref(out, _fuse_alive(radices, codes, alive),
                                 weights)


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
    CPU tensors take the plain version; CUDA tensors fuse in torch,
    zero-fill and launch the kernel through `onehot_dense_into`."""
    if codes.device.type == 'cpu':
        return onehot_dense_ref(radices, codes, weights, alive)
    if codes.device.type != 'cuda':
        raise ValueError('one-hot kernel: unsupported device %s'
                         % codes.device)
    ns, _ = _check(radices, codes, weights, alive)
    out = torch.zeros(ns, dtype=torch.int64, device=codes.device)
    return onehot_dense_into(out, _fuse_alive(radices, codes, alive),
                             weights)
