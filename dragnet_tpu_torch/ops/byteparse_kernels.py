"""The byte lane's structural kernel (K8): the exclusive quote parity.

Counterpart of dragnet_tpu/ops/byteparse_kernels.py.  The only
sequential dependency in parsing escape-free newline-JSON is the
in-string test: a byte is inside a string iff an odd number of quote
bytes come before it.  Everything else byteparse.py does is elementwise
or token-level work, so the kernel's contract is that scan: the
exclusive quote parity of every byte, bit-packed 8 to a byte, MSB first
(the np.packbits layout); only the first n bits are the contract.

Three implementations, bit-identical (tests/test_torch_byteparse.py):

* ``parity_numpy`` — the reference's bit-packed numpy scan, copied:
  the vector lane (DN_PARSE=vector) runs it.
* ``quote_parity_ref`` — the plain torch version: a cumsum of the quote
  indicator in int32, mod 2, then a reshape-multiply-sum to pack.
* the kernel, csrc/quote_parity.cu (CUDA C++ for sm_90a): an XOR scan
  over 32-bit quote masks in registers, across tiles in a second pass.

``quote_parity`` / ``quote_parity_into`` take the plain version only for
tensors on the CPU; on a CUDA tensor they launch the kernel or raise.
``cuda_kernels.launches['quote_parity']`` counts the launches.

The device lane (DN_PARSE=device) calls ``device_parity(device)``: per
parse block, one copy into a reused page-locked buffer, one
non_blocking upload, the kernel on the current stream, a download of
the ceil(n / 8) packed bytes into page-locked memory, one event wait.
Its first call runs under the device probe deadline
(DN_DEVICE_PROBE_TIMEOUT); a timeout or an error raises DNError ("device
parse kernel ...").  The reference warns there and goes on with the
numpy kernel; the port never falls back from the lane it was asked
for, and pads nothing (the reference pads to PAD_QUANTUM so that its
compiled program sees few shapes; eager CUDA compiles nothing per
shape).
"""

import ctypes
import threading

import numpy as np
import torch

from ..errors import DNError
from . import cuda_kernels as ck

QUOTE = ord('"')


def _build_parity_tables():
    """POPPAR[b]: parity of b's bits.  PREFIX[b]: byte whose bit j
    (MSB-first, matching np.packbits) is the parity of b's bits before
    j."""
    poppar = np.zeros(256, dtype=np.uint8)
    prefix = np.zeros(256, dtype=np.uint8)
    for b in range(256):
        p = 0
        pat = 0
        for bit in range(8):
            if p:
                pat |= 1 << (7 - bit)
            if b & (1 << (7 - bit)):
                p ^= 1
        poppar[b] = p
        prefix[b] = pat
    return poppar, prefix


_POPPAR, _PREFIX = _build_parity_tables()


def parity_numpy(arr):
    """uint8[n] exclusive quote parity over a byte array."""
    n = arr.size
    is_q = arr == QUOTE
    packed = np.packbits(is_q)
    bytepar = _POPPAR[packed]
    into = ((np.cumsum(bytepar, dtype=np.int32) - bytepar) & 1) \
        .astype(np.uint8)
    pattern = _PREFIX[packed]
    out_packed = pattern ^ (into * np.uint8(0xFF))
    return np.unpackbits(out_packed)[:n]


def packed_len(n):
    return (n + 7) // 8


def quote_parity_ref(data):
    """Plain version: u8[n] -> u8[ceil(n / 8)], the exclusive quote
    parity packed MSB first; tail bits past n are 0."""
    n = data.shape[0]
    q = (data == QUOTE).to(torch.int32)
    par = (torch.cumsum(q, 0, dtype=torch.int32) - q) & 1
    nout = packed_len(n)
    if nout * 8 != n:
        par = torch.cat([par, par.new_zeros(nout * 8 - n)])
    # MSB first: 128, 64, ..., 1 (made on the device: no host copy, so
    # the plain version can be captured in a CUDA graph)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=data.device)
    bitw = torch.bitwise_left_shift(torch.ones_like(shifts), shifts)
    return (par.view(nout, 8) * bitw).sum(1).to(torch.uint8)


def _setup(lib):
    fn = lib.dn_quote_parity
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.dn_quote_parity_tile_bytes.restype = ctypes.c_int64
    lib.dn_quote_parity_tile_bytes.argtypes = []


def _lib():
    return ck._libs.get('quote_parity') or \
        ck.load_library('quote_parity', _setup)


def scratch_len(n):
    """Bytes of tile scratch the kernel needs for n input bytes."""
    tile = _lib().dn_quote_parity_tile_bytes()
    return max(1, -(-n // tile))


def _check(out, data):
    dev = data.device
    if data.dtype != torch.uint8 or data.dim() != 1 or \
            not data.is_contiguous():
        raise ValueError('quote-parity kernel: data must be a contiguous '
                         '1-d uint8 tensor')
    n = data.shape[0]
    if out.dtype != torch.uint8 or out.dim() != 1 or \
            not out.is_contiguous() or out.device != dev or \
            out.shape[0] != packed_len(n) or out.data_ptr() % 4:
        raise ValueError('quote-parity kernel: out must be a contiguous, '
                         '4-byte aligned uint8 tensor of %d bytes on %s'
                         % (packed_len(n), dev))
    return n


def quote_parity_into(out, data, scratch=None):
    """out[:] = the packed exclusive quote parity of data (u8[n]); out
    is u8[ceil(n / 8)].  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the device's current stream (no
    synchronisation), with `scratch` (u8, at least scratch_len(n)) or a
    fresh one.  n = 0 launches nothing.  Returns `out`."""
    dev = data.device
    if dev.type == 'cpu':
        out.copy_(quote_parity_ref(data))
        return out
    if dev.type != 'cuda':
        raise ValueError('quote-parity kernel: unsupported device %s' % dev)
    n = _check(out, data)
    if n == 0:
        return out
    lib = _lib()
    need = scratch_len(n)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.uint8, device=dev)
    elif scratch.dtype != torch.uint8 or scratch.device != dev or \
            not scratch.is_contiguous() or scratch.numel() < need:
        raise ValueError('quote-parity kernel: scratch must be a '
                         'contiguous uint8 tensor of %d bytes on %s'
                         % (need, dev))
    rc = lib.dn_quote_parity(data.data_ptr(), n, out.data_ptr(),
                             scratch.data_ptr(), dev.index,
                             ck.current_stream_handle(dev.index))
    if rc != 0:
        raise RuntimeError('quote-parity kernel launch failed: CUDA error '
                           '%d' % rc)
    ck.launches['quote_parity'] += 1
    return out


def quote_parity(data):
    """The packed exclusive quote parity of data (u8[n]) as a new
    u8[ceil(n / 8)] tensor on data's device (see quote_parity_into)."""
    out = torch.empty(packed_len(data.shape[0]), dtype=torch.uint8,
                      device=data.device)
    return quote_parity_into(out, data)


class DeviceParity(object):
    """The device lane's per-block call on one torch device: numpy
    u8[n] in, u8[n] parity bits out (the parse needs the mask at once,
    so each call waits for its own result).  On CUDA the staging
    buffers (page-locked in and out, device in and out, tile scratch)
    are reused and grow by doubling; on the CPU the plain version
    runs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cap = 0

    def _ensure(self, n):
        if n <= self._cap:
            return
        cap = max(n, 2 * self._cap, 1 << 16)
        nout = packed_len(cap)
        dev = self.device
        self._h_in = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
        self._h_out = torch.empty(nout, dtype=torch.uint8,
                                  pin_memory=True)
        self._d_in = torch.empty(cap, dtype=torch.uint8, device=dev)
        self._d_out = torch.empty(nout, dtype=torch.uint8, device=dev)
        self._scratch = torch.empty(scratch_len(cap), dtype=torch.uint8,
                                    device=dev)
        self._event = torch.cuda.Event()
        self._cap = cap

    def __call__(self, arr):
        n = int(arr.size)
        if self.device.type == 'cpu':
            # the parser's blocks are read-only views of bytes objects;
            # torch wants a writable array
            packed = quote_parity(torch.from_numpy(
                np.array(arr, dtype=np.uint8)))
            return np.unpackbits(packed.numpy())[:n]
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        self._ensure(n)
        nout = packed_len(n)
        self._h_in.numpy()[:n] = arr
        stream = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            d_in = self._d_in[:n]
            d_out = self._d_out[:nout]
            d_in.copy_(self._h_in[:n], non_blocking=True)
            quote_parity_into(d_out, d_in, self._scratch)
            self._h_out[:nout].copy_(d_out, non_blocking=True)
            self._event.record(stream)
        self._event.synchronize()
        return np.unpackbits(self._h_out.numpy()[:nout])[:n]


_DEVICE_LOCK = threading.Lock()
_DEVICE_STATE = {}     # str(device) -> DeviceParity, or the DNError raised


def reset_device_state():
    """Forget every device's probe result (tests)."""
    with _DEVICE_LOCK:
        _DEVICE_STATE.clear()


def device_parity(device):
    """The parity callable of the device lane on `device` (a resolved
    torch.device).  The first call on a device runs under the probe
    deadline; a timeout or an error raises DNError, then and on every
    later call."""
    key = str(torch.device(device))

    def call(arr):
        state = _DEVICE_STATE.get(key)
        if isinstance(state, DeviceParity):
            return state(arr)
        if isinstance(state, DNError):
            raise state
        return _probe(key, arr)
    return call


def _probe(key, arr):
    from ..device_scan import probe_deadline_s, run_with_deadline
    with _DEVICE_LOCK:
        state = _DEVICE_STATE.get(key)
        if isinstance(state, DNError):
            raise state
        if state is None:
            state = DeviceParity(key)
        else:
            return state(arr)
        status, result = run_with_deadline(
            lambda: state(arr), probe_deadline_s(), 'byteparse-parity')
        if status == 'ok':
            _DEVICE_STATE[key] = state
            return result
        err = DNError('device parse kernel %s on %s' % (
            'probe timed out' if status == 'timeout'
            else 'failed (%s)' % (result,), key))
        _DEVICE_STATE[key] = err
        raise err
