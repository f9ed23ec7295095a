"""ctypes binding for the native columnar index store (native/dnindex.cc).

Counterpart of dragnet_tpu/native_index.py.  Loads the C++ mmap
reader/writer and GROUP BY / SUM kernel, built on demand through
native._build_target (the shared Makefile) into native/build/, as the
ingest parser is.  Falls back cleanly when the shared library cannot be
built, or when DN_NATIVE=0 asks for it: index_dnc.py carries a pure
numpy implementation of the same format, byte-identical on disk.
"""

import ctypes
import os
import threading

import numpy as np

from . import native as mod_native

_lib = None
_lib_lock = threading.Lock()
_SO_PATH = os.path.join(mod_native._NATIVE_DIR, 'build', 'libdnindex.so')

MAGIC = b'DNCIDX1\n'
HEADER_SIZE = 32
FORMAT_VERSION = 1


def get_lib():
    """Load (building if needed) the native index library; None if
    unavailable or disabled via DN_NATIVE=0."""
    global _lib
    if os.environ.get('DN_NATIVE', '1') == '0':
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        src = os.path.join(mod_native._NATIVE_DIR, 'dnindex.cc')
        if not mod_native._build_target(_SO_PATH, src):
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _lib = False
            return None

        lib.dn_idx_writer_create.restype = ctypes.c_void_p
        lib.dn_idx_writer_create.argtypes = [ctypes.c_char_p]
        lib.dn_idx_writer_block.restype = ctypes.c_int64
        lib.dn_idx_writer_block.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.dn_idx_writer_finalize.restype = ctypes.c_int32
        lib.dn_idx_writer_finalize.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.dn_idx_writer_abort.argtypes = [ctypes.c_void_p]

        lib.dn_idx_open.restype = ctypes.c_void_p
        lib.dn_idx_open.argtypes = [ctypes.c_char_p]
        lib.dn_idx_base.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.dn_idx_base.argtypes = [ctypes.c_void_p]
        for name in ('dn_idx_size', 'dn_idx_footer_off',
                     'dn_idx_footer_len'):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.dn_idx_close.argtypes = [ctypes.c_void_p]

        lib.dn_idx_groupby.restype = ctypes.c_void_p
        lib.dn_idx_groupby.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        lib.dn_gb_ngroups.restype = ctypes.c_int64
        lib.dn_gb_ngroups.argtypes = [ctypes.c_void_p]
        lib.dn_gb_keys.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.POINTER(ctypes.c_int64)]
        lib.dn_gb_sums.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_double)]
        lib.dn_gb_isint.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8)]
        lib.dn_gb_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def groupby_native(keycols, values, isint, mask):
    """GROUP BY / SUM via the C++ kernel; returns (keys [list of i64
    arrays], sums f64, isint u8) with groups in ascending key order, or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nrows = len(values)
    nkeys = len(keycols)
    cols = [np.ascontiguousarray(k, dtype=np.int64) for k in keycols]
    values = np.ascontiguousarray(values, dtype=np.float64)
    isint = np.ascontiguousarray(isint, dtype=np.uint8)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    pp = (ctypes.POINTER(ctypes.c_int64) * max(nkeys, 1))()
    for i, c in enumerate(cols):
        pp[i] = c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    gh = lib.dn_idx_groupby(
        pp, nkeys,
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        isint.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nrows)
    try:
        n = lib.dn_gb_ngroups(gh)
        out_keys = []
        for k in range(nkeys):
            arr = np.empty(n, dtype=np.int64)
            if n:
                lib.dn_gb_keys(
                    gh, k,
                    arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            out_keys.append(arr)
        sums = np.empty(n, dtype=np.float64)
        flags = np.empty(n, dtype=np.uint8)
        if n:
            lib.dn_gb_sums(
                gh, sums.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            lib.dn_gb_isint(
                gh, flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out_keys, sums, flags
    finally:
        lib.dn_gb_free(gh)
