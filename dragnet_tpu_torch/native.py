"""ctypes binding for the native ingest parser (native/dnparse.cc) and
the muskie record generator (native/dngen.cc).

Loads (building on demand via `make -C native` if a toolchain is
present) the C++ newline-JSON -> columnar parser and adapts its
tagged-value output to the engine's column interfaces.  Without it
(no toolchain, or DN_NATIVE=0) scans take the byte lane (byteparse.py)
or the Python record path, with identical results.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np


TAG_MISSING = 0
TAG_NULL = 1
TAG_FALSE = 2
TAG_TRUE = 3
TAG_NUMBER = 4
TAG_INT = 5
TAG_STRING = 6
TAG_OBJECT = 7
TAG_ARRAY = 8

_lib = None
_lib_lock = threading.Lock()
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native')
_SO_PATH = os.path.join(_NATIVE_DIR, 'build', 'libdnparse.so')


def _build_target(so_path, src):
    """Build (via the shared Makefile) the native library at so_path
    from src if it is missing or stale; True when a loadable library is
    present afterward."""
    if not os.path.exists(src):
        return os.path.exists(so_path)
    if os.path.exists(so_path) and \
            os.path.getmtime(so_path) >= os.path.getmtime(src):
        return True
    try:
        # serialize concurrent builds (multi-process cluster launches)
        import fcntl
        os.makedirs(os.path.join(_NATIVE_DIR, 'build'), exist_ok=True)
        lockpath = os.path.join(_NATIVE_DIR, 'build', '.lock')
        with open(lockpath, 'w') as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not (os.path.exists(so_path) and os.path.getmtime(
                    so_path) >= os.path.getmtime(src)):
                # build the specific target so a compile failure in one
                # library cannot fail the other's build
                target = os.path.relpath(so_path, _NATIVE_DIR)
                subprocess.run(['make', '-C', _NATIVE_DIR, target],
                               check=True, stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
    except Exception:
        # a stale-but-loadable library beats none, but its semantics
        # may lag the source — say so
        if os.path.exists(so_path):
            import sys
            sys.stderr.write(
                'dn: warning: native rebuild failed; using stale %s '
                '(set DN_NATIVE=0 to force the Python path)\n'
                % so_path)
            return True
        return False
    return os.path.exists(so_path)


def _build():
    return _build_target(_SO_PATH, os.path.join(_NATIVE_DIR,
                                                'dnparse.cc'))


def get_lib():
    """Load (building if needed) the native parser; None if unavailable
    or disabled via DN_NATIVE=0."""
    global _lib
    if os.environ.get('DN_NATIVE', '1') == '0':
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        if not _build():
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _lib = False
            return None

        lib.dn_parser_create.restype = ctypes.c_void_p
        lib.dn_parser_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
        try:
            lib.dn_parser_create2.restype = ctypes.c_void_p
            lib.dn_parser_create2.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
        except AttributeError:
            pass
        lib.dn_parser_destroy.argtypes = [ctypes.c_void_p]
        lib.dn_parser_parse.restype = ctypes.c_int64
        lib.dn_parser_parse.argtypes = [ctypes.c_void_p,
                                        ctypes.c_char_p, ctypes.c_int64]
        try:
            lib.dn_parser_parse_mt.restype = ctypes.c_int64
            lib.dn_parser_parse_mt.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int32]
        except AttributeError:
            pass
        for name in ('dn_parser_nlines', 'dn_parser_nbad',
                     'dn_parser_batch_size'):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.dn_parser_tags.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.dn_parser_tags.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.dn_parser_nums.restype = ctypes.POINTER(ctypes.c_double)
        lib.dn_parser_nums.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.dn_parser_strcodes.restype = ctypes.POINTER(ctypes.c_int32)
        lib.dn_parser_strcodes.argtypes = [ctypes.c_void_p,
                                           ctypes.c_int32]
        lib.dn_parser_datesecs.restype = ctypes.POINTER(ctypes.c_double)
        lib.dn_parser_datesecs.argtypes = [ctypes.c_void_p,
                                           ctypes.c_int32]
        lib.dn_parser_dateerr.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.dn_parser_dateerr.argtypes = [ctypes.c_void_p,
                                          ctypes.c_int32]
        for name in ('dn_parser_field_stats', 'dn_parser_date_stats'):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                               ctypes.POINTER(ctypes.c_double)]
        for name in ('dn_parser_nums_i32', 'dn_parser_date_i32'):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                               ctypes.POINTER(ctypes.c_int32)]
        lib.dn_parser_dict_size.restype = ctypes.c_int32
        lib.dn_parser_dict_size.argtypes = [ctypes.c_void_p,
                                            ctypes.c_int32]
        lib.dn_parser_dict_get.restype = ctypes.POINTER(ctypes.c_char)
        lib.dn_parser_dict_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        lib.dn_parser_reset_batch.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def parse_threads():
    """Worker threads for the native parser: DN_PARSE_THREADS, else the
    machine's core count (capped; 1 disables threading)."""
    v = os.environ.get('DN_PARSE_THREADS', 'auto')
    if v != 'auto':
        try:
            return max(1, int(v))
        except ValueError:
            return 1
    return min(16, os.cpu_count() or 1)


class NativeParser(object):
    """One parser per scan: dictionaries persist across batches."""

    def __init__(self, paths, date_hints, need_dicts=None):
        self.lib = get_lib()
        assert self.lib is not None
        self.nthreads = parse_threads()
        if not hasattr(self.lib, 'dn_parser_parse_mt'):
            self.nthreads = 1
        self.paths = list(paths)
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        hints = (ctypes.c_uint8 * len(paths))(
            *[1 if h else 0 for h in date_hints])
        if need_dicts is not None and \
                hasattr(self.lib, 'dn_parser_create2'):
            # date-only fields skip string interning entirely (their
            # dictionaries would hold ~one entry per record)
            dicts = (ctypes.c_uint8 * len(paths))(
                *[1 if d else 0 for d in need_dicts])
            self.h = self.lib.dn_parser_create2(arr, hints, dicts,
                                                len(paths))
        else:
            self.h = self.lib.dn_parser_create(arr, hints, len(paths))
        self.field_index = {p: i for i, p in enumerate(paths)}
        # per-field python mirror of the native dictionary
        self._dicts = [[] for _ in paths]

    def __del__(self):
        try:
            if getattr(self, 'h', None):
                self.lib.dn_parser_destroy(self.h)
        except Exception:
            pass

    def parse(self, buf):
        """Parse a bytes buffer of complete lines; returns the number of
        records appended to the current batch."""
        return self.parse_at(buf, len(buf))

    def parse_at(self, buf, length):
        """parse() from bytes or a raw integer address (the zero-copy
        entry for parsing a slice of a read buffer without materializing
        a copy).  With an address, the caller must keep the backing
        buffer alive for the duration of the call."""
        if isinstance(buf, int):
            buf = ctypes.c_char_p(buf)
        if self.nthreads > 1:
            return self.lib.dn_parser_parse_mt(self.h, buf, length,
                                               self.nthreads)
        return self.lib.dn_parser_parse(self.h, buf, length)

    def counters(self):
        return (self.lib.dn_parser_nlines(self.h),
                self.lib.dn_parser_nbad(self.h))

    def batch_size(self):
        return self.lib.dn_parser_batch_size(self.h)

    def dictionary(self, field):
        """Python mirror of the native per-field string dictionary."""
        fi = self.field_index[field]
        d = self._dicts[fi]
        size = self.lib.dn_parser_dict_size(self.h, fi)
        while len(d) < size:
            ln = ctypes.c_int32()
            p = self.lib.dn_parser_dict_get(self.h, fi, len(d),
                                            ctypes.byref(ln))
            raw = ctypes.string_at(p, ln.value)
            try:
                # surrogatepass round-trips lone \uD800-class escapes
                # exactly like json.loads does
                d.append(raw.decode('utf-8', 'surrogatepass'))
            except UnicodeDecodeError:
                d.append(raw.decode('utf-8', 'surrogateescape'))
        return d

    def _np(self, fn, field, dtype, n):
        fi = self.field_index[field]
        ptr = fn(self.h, fi)
        if n == 0:
            return np.zeros(0, dtype=dtype)
        return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype,
                                                            copy=True)

    def columns(self, field):
        """(tags u8, nums f64, strcodes i32) for the current batch."""
        n = self.batch_size()
        return (self._np(self.lib.dn_parser_tags, field, np.uint8, n),
                self._np(self.lib.dn_parser_nums, field, np.float64, n),
                self._np(self.lib.dn_parser_strcodes, field, np.int32,
                         n))

    def tags_col(self, field):
        """The tags column alone (device path: skips extracting the
        nums/strcodes columns its upload profile proved dead)."""
        return self._np(self.lib.dn_parser_tags, field, np.uint8,
                        self.batch_size())

    def strcodes_col(self, field):
        return self._np(self.lib.dn_parser_strcodes, field, np.int32,
                        self.batch_size())

    def date_columns(self, field):
        n = self.batch_size()
        return (self._np(self.lib.dn_parser_datesecs, field, np.float64,
                         n),
                self._np(self.lib.dn_parser_dateerr, field, np.uint8, n))

    def reset_batch(self):
        self.lib.dn_parser_reset_batch(self.h)

    # -- one-pass batch statistics (device-path eligibility) -----------

    def field_stats(self, field):
        """(n_array, all_nums_i32, num_min, num_max, n_num, n_str) of
        the current batch, in one native pass."""
        if not hasattr(self.lib, 'dn_parser_field_stats'):
            return None
        out = (ctypes.c_double * 6)()
        self.lib.dn_parser_field_stats(self.h, self.field_index[field],
                                       out)
        return (int(out[0]), bool(out[1]), out[2], out[3],
                int(out[4]), int(out[5]))

    def nums_i32(self, field):
        """Numeric rows cast to i32 (others 0); only valid after
        field_stats reported all_nums_i32."""
        n = self.batch_size()
        arr = np.zeros(n, dtype=np.int32)
        if n:
            self.lib.dn_parser_nums_i32(
                self.h, self.field_index[field],
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return arr

    def date_stats(self, field):
        """(all_ok_rows_i32, n_ok) over error-free date rows."""
        if not hasattr(self.lib, 'dn_parser_date_stats'):
            return None
        out = (ctypes.c_double * 2)()
        self.lib.dn_parser_date_stats(self.h, self.field_index[field],
                                      out)
        return (bool(out[0]), int(out[1]))

    def date_i32(self, field):
        """Epoch seconds as i32 (error rows 0)."""
        n = self.batch_size()
        arr = np.zeros(n, dtype=np.int32)
        if n:
            self.lib.dn_parser_date_i32(
                self.h, self.field_index[field],
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return arr

    def date_err(self, field):
        """The date-error column alone (no epoch-seconds copy)."""
        return self._np(self.lib.dn_parser_dateerr, field, np.uint8,
                        self.batch_size())


# muskie generator window (tools/mktestdata MINDATE..MAXDATE: three
# hours of linear timestamps, 2014-05-31T21:00:00Z..23:59:59Z)
GEN_MINDATE_MS = 1401570000000
GEN_MAXDATE_MS = 1401580799000


def gen_to_file(n, path, mindate_ms=GEN_MINDATE_MS,
                maxdate_ms=GEN_MAXDATE_MS, seed=12345):
    """Write n generated muskie records to path with native/dngen.cc
    (same shape and distributions as tools/mktestdata: 5 hosts, 4
    methods, 10 operations, 7 status codes, 500 URLs, mixed latency).
    Timestamps increase linearly over [mindate_ms, maxdate_ms).
    Raises when the generator cannot be built."""
    so = os.path.join(_NATIVE_DIR, 'build', 'libdngen.so')
    if not _build_target(so, os.path.join(_NATIVE_DIR, 'dngen.cc')):
        raise RuntimeError('native generator %s could not be built' % so)
    lib = ctypes.CDLL(so)
    lib.dn_gen.restype = ctypes.c_int64
    lib.dn_gen.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_uint64]
    chunk = 200000
    buf = ctypes.create_string_buffer(max(min(chunk, n), 1) * 512)
    with open(path, 'wb') as f:
        for start in range(0, n, chunk):
            cnt = min(chunk, n - start)
            nb = lib.dn_gen(buf, len(buf), start, cnt, n,
                            mindate_ms, maxdate_ms, seed)
            if nb <= 0:
                raise RuntimeError('dn_gen failed (rv=%d)' % nb)
            f.write(ctypes.string_at(buf, nb))
