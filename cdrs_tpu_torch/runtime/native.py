"""ctypes bindings of the host runtime library (``csrc/host/cdrs_native.cpp``).

The counterpart of ``cdrs_tpu/runtime/native.py``, with the same ctypes
signatures: the threaded event engine (``simulate_events_native``), the
access.log writer (``write_access_log_native``), the chunked CSV parser
(``parse_log_chunk_native``) and native string interning (``InternMap``).
This is host C++, not device code.

``load()`` builds the library with ``g++`` at first use into
``cdrs_tpu_torch/_build/`` (``ops/_build``) and raises with the
compiler's output when the build fails: no Python path stands in silently
(a per-row loop over a 42M-row log would).  Foreign calls release the GIL.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..ops import _build

__all__ = ["load", "simulate_events_native", "parse_log_chunk_native",
           "write_access_log_native", "InternMap"]

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_f64 = ctypes.c_double
_p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_p_char = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


#: Each function's (restype, argtypes), set once by ``ops/_build.bind``.
_SIGNATURES = {
    "sim_counts": (_i64, [_i64, _p_f64, _p_f64, _f64, _u64, _p_i64]),
    "sim_fill": (None, [_i64, _p_i64, _p_f64, _p_f64, _p_f64, _p_i32, _p_i32, _i64,
                        _f64, _f64, _u64, _i64, _p_f64, _p_i32, _p_i8, _p_i32]),
    "log_write": (_i64, [ctypes.c_char_p, _i64, _p_f64, _p_i32, _p_i8, _p_i32,
                         _p_char, _p_i64, _p_char, _p_i64, _i64]),
    "log_fill_chunk": (_i64, [ctypes.c_char_p, _i64, _i64, _i64, _i64, _p_f64, _p_i8,
                              _p_char, _p_i64, _p_char, _p_i64, ctypes.POINTER(_i64)]),
    "intern_build": (ctypes.c_void_p, [_p_char, _p_i64, _i64]),
    "intern_free": (None, [ctypes.c_void_p]),
    "intern_size": (_i64, [ctypes.c_void_p]),
    "intern_lookup": (None, [ctypes.c_void_p, _p_char, _p_i64, _i64, _p_i32]),
    "intern_insert_lookup": (_i64, [ctypes.c_void_p, _p_char, _p_i64, _i64, _p_i32]),
    "intern_export_bytes": (_i64, [ctypes.c_void_p, _i64]),
    "intern_export": (None, [ctypes.c_void_p, _i64, _p_char, _p_i64]),
}


def load():
    """The loaded library with its signatures set, built first if needed.
    Raises RuntimeError (with the compiler's output) when it cannot be built."""
    lib = _build.load(_build.HOST)
    for name, (restype, argtypes) in _SIGNATURES.items():
        _build.bind(_build.HOST, name, argtypes, restype)
    return lib


def simulate_events_native(read_rate: np.ndarray, write_rate: np.ndarray,
                           locality: np.ndarray, primary_node: np.ndarray,
                           client_pool: np.ndarray, duration: float, sim_start: float,
                           seed: int, n_threads: int = 0):
    """Threaded Poisson event generation: ``(ts, pid, op, client)``, globally
    time-sorted.  Each file's events come from its own ``(seed, file)``
    stream, so the output does not depend on ``n_threads`` (0 = every core)."""
    lib = load()
    if len(client_pool) == 0:
        raise ValueError("client_pool must be non-empty")
    n = len(read_rate)
    read_rate = np.ascontiguousarray(read_rate, dtype=np.float64)
    write_rate = np.ascontiguousarray(write_rate, dtype=np.float64)
    locality = np.ascontiguousarray(locality, dtype=np.float64)
    primary_node = np.ascontiguousarray(primary_node, dtype=np.int32)
    client_pool = np.ascontiguousarray(client_pool, dtype=np.int32)
    seed = int(seed) & (2**64 - 1)

    counts = np.empty(n, dtype=np.int64)
    total = int(lib.sim_counts(n, read_rate, write_rate, float(duration), seed, counts))
    ts = np.empty(total, dtype=np.float64)
    pid = np.empty(total, dtype=np.int32)
    op = np.empty(total, dtype=np.int8)
    client = np.empty(total, dtype=np.int32)
    lib.sim_fill(n, counts, read_rate, write_rate, locality, primary_node, client_pool,
                 len(client_pool), float(duration), float(sim_start), seed, int(n_threads),
                 ts, pid, op, client)
    return ts, pid, op, client


def _strings_to_blob(strings):
    """(uint8 blob, int64 offsets) encoding of a string list."""
    encoded = [s.encode("utf-8") for s in strings]
    off = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=off[1:])
    blob = np.frombuffer(b"".join(encoded), dtype=np.uint8).copy() \
        if encoded else np.zeros(0, dtype=np.uint8)
    return np.ascontiguousarray(blob), off


def _nonempty(blob: np.ndarray) -> np.ndarray:
    """A non-null pointer for an empty blob."""
    return np.ascontiguousarray(blob) if len(blob) else np.zeros(1, dtype=np.uint8)


def write_access_log_native(path: str, ts, pid, op, client, paths, clients,
                            append: bool = False) -> int:
    """Write access.log rows ``iso_ts,path,op,client,tag``; ``paths`` and
    ``clients`` are the string tables ``pid`` and ``client`` index (rows with
    pid < 0 are the caller's to filter).  Returns the rows written."""
    lib = load()
    pblob, poff = _strings_to_blob(paths)
    cblob, coff = _strings_to_blob(clients)
    n = len(ts)
    got = int(lib.log_write(
        path.encode(), n,
        np.ascontiguousarray(ts, dtype=np.float64),
        np.ascontiguousarray(pid, dtype=np.int32),
        np.ascontiguousarray(op, dtype=np.int8),
        np.ascontiguousarray(client, dtype=np.int32),
        _nonempty(pblob), poff, _nonempty(cblob), coff, 1 if append else 0))
    if got != n:
        raise OSError(f"log_write wrote {got} of {n} rows to {path}")
    return got


class InternMap:
    """Native string -> id map.  Ids are the positions of ``strings`` at
    construction (a duplicate looks up its first position); ``lookup`` maps
    a (blob, offsets) batch of byte strings to int32 ids, -1 when absent."""

    def __init__(self, strings):
        lib = load()
        self._lib = lib
        blob, off = _strings_to_blob(strings)
        self._handle = ctypes.c_void_p(lib.intern_build(_nonempty(blob), off, len(strings)))

    def lookup(self, blob: np.ndarray, off: np.ndarray) -> np.ndarray:
        n = len(off) - 1
        out = np.empty(n, dtype=np.int32)
        self._lib.intern_lookup(self._handle, _nonempty(blob), np.ascontiguousarray(off),
                                n, out)
        return out

    def insert_lookup(self, blob: np.ndarray, off: np.ndarray) -> np.ndarray:
        """Lookup that gives unseen strings the next ids in insertion order
        (a growing vocabulary; the new names are ``names_from``)."""
        n = len(off) - 1
        out = np.empty(n, dtype=np.int32)
        self._lib.intern_insert_lookup(self._handle, _nonempty(blob),
                                       np.ascontiguousarray(off), n, out)
        return out

    def __len__(self) -> int:
        return int(self._lib.intern_size(self._handle))

    def names_from(self, start: int) -> list[str]:
        """Names with id >= start, in id order."""
        count = len(self) - int(start)
        if count <= 0:
            return []
        nbytes = int(self._lib.intern_export_bytes(self._handle, int(start)))
        blob = np.empty(max(nbytes, 1), dtype=np.uint8)
        off = np.empty(count + 1, dtype=np.int64)
        self._lib.intern_export(self._handle, int(start), blob, off)
        raw = blob.tobytes()
        return [raw[off[i]:off[i + 1]].decode("utf-8", "replace") for i in range(count)]

    def __del__(self):  # pragma: no cover - interpreter-shutdown dependent
        h, lib = getattr(self, "_handle", None), getattr(self, "_lib", None)
        if h and lib is not None:
            lib.intern_free(h)


#: Blob bytes reserved per row in a chunk (a longer row ends the chunk early).
_CHUNK_BYTES_PER_ROW = 256


def parse_log_chunk_native(path: str, offset: int, max_rows: int):
    """Parse up to ``max_rows`` rows of an access.log from byte ``offset``.

    Returns ``(ts, op, path_blob, path_off, client_blob, client_off,
    next_offset)``, the columns for ``InternMap`` lookups, or None when the
    rows from ``offset`` need Python's csv parser: CSV quoting, a malformed
    row, a timestamp outside the native grammar, or a single row larger
    than the chunk's budget.  An empty chunk at the end of the file returns
    arrays of length 0.
    """
    lib = load()
    cap = max_rows * _CHUNK_BYTES_PER_ROW
    ts = np.empty(max_rows, dtype=np.float64)
    op = np.empty(max_rows, dtype=np.int8)
    path_blob = np.empty(cap, dtype=np.uint8)
    client_blob = np.empty(cap, dtype=np.uint8)
    path_off = np.empty(max_rows + 1, dtype=np.int64)
    client_off = np.empty(max_rows + 1, dtype=np.int64)
    nxt = _i64(0)
    rows = int(lib.log_fill_chunk(path.encode(), int(offset), int(max_rows), cap, cap, ts, op,
                                  path_blob, path_off, client_blob, client_off,
                                  ctypes.byref(nxt)))
    if rows < 0:
        return None
    if rows == 0 and int(nxt.value) == int(offset) and offset < os.path.getsize(path):
        return None   # one row larger than the whole chunk budget
    if rows and np.isnan(ts[:rows]).any():
        return None
    return (ts[:rows], op[:rows], path_blob[:path_off[rows]], path_off[:rows + 1],
            client_blob[:client_off[rows]], client_off[:rows + 1], int(nxt.value))
