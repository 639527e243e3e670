"""Struct-of-arrays manifest and event log, their readers and writers.

Copied from ``cdrs_tpu/io/events.py``: paths and client nodes are interned
to int32 ids, timestamps are float64 epoch seconds.  ``metadata.csv`` and
``access.log`` keep the byte format of the JAX package's writers, and the
binary columnar log (``.cdrsb``) its layout, so either package reads what
the other wrote.  CSV logs are read by the host library's chunked C++
parser with native interning (``runtime/native.py``), which reports a
resumable byte offset on every batch; rows its grammar rejects (CSV
quoting, malformed rows, other timestamps) hand over to Python's ``csv``
module at the exact byte reached.  ``write_csv`` uses the native writer
whenever no string needs quoting.
"""

from __future__ import annotations

import csv
import hashlib
import os
from dataclasses import dataclass
from datetime import datetime, timezone
from functools import cached_property

import numpy as np

__all__ = ["Manifest", "EventLog", "client_vocabulary", "parse_iso_ts",
           "BINARY_MAGIC", "is_binary_log"]

#: Magic prefix of the binary columnar event log (.cdrsb).
BINARY_MAGIC = b"CDRSBEV1"


def is_binary_log(path) -> bool:
    """True when ``path`` starts with the binary event-log magic."""
    try:
        with open(path, "rb") as f:
            return f.read(len(BINARY_MAGIC)) == BINARY_MAGIC
    except OSError:
        return False


def client_vocabulary(manifest: "Manifest", extra_clients=()):
    """Client-id vocabulary: manifest nodes first (so ids align with
    ``primary_node_id``), then any extra simulator clients.  Returns
    (clients list, int32 ids of ``extra_clients``)."""
    clients = list(manifest.nodes)
    for c in extra_clients:
        if c not in clients:
            clients.append(c)
    pool = np.asarray([clients.index(c) for c in extra_clients], dtype=np.int32)
    return clients, pool


def parse_iso_ts(s: str) -> float:
    """ISO-8601 (optionally ``Z``-suffixed) -> epoch seconds; naive stamps
    are UTC."""
    s = s.strip()
    if s.endswith("Z"):
        s = s[:-1]
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


@dataclass
class Manifest:
    """Interned file population (metadata.csv columns)."""

    paths: list[str]
    creation_ts: np.ndarray          # (n,) float64 epoch seconds
    primary_node_id: np.ndarray      # (n,) int32, index into ``nodes``
    size_bytes: np.ndarray           # (n,) int64
    category: list[str]              # planted ground truth, lowercase
    nodes: list[str]

    def __len__(self) -> int:
        return len(self.paths)

    @cached_property
    def path_to_id(self) -> dict[str, int]:
        """Path -> id, built on first use (only readers that meet a path
        table other than this manifest's need it)."""
        return {p: i for i, p in enumerate(self.paths)}

    #: Columns a manifest CSV cannot be read without.
    _REQUIRED_COLUMNS = ("path", "creation_ts", "primary_node")

    @classmethod
    def read_csv(cls, path: str) -> "Manifest":
        """Read metadata.csv.  A missing file raises FileNotFoundError, a
        header- or row-level defect one ValueError naming the path."""
        paths, creation, nodes_col, sizes, cats = [], [], [], [], []
        try:
            f = open(path, newline="")
        except FileNotFoundError:
            raise FileNotFoundError(f"missing manifest {path!r}: no such file") from None
        with f:
            reader = csv.DictReader(f)
            missing = [c for c in cls._REQUIRED_COLUMNS
                       if c not in (reader.fieldnames or ())]
            if missing:
                raise ValueError(
                    f"truncated/corrupt manifest {path!r}: "
                    + ("no header row" if not reader.fieldnames
                       else f"missing columns {missing}"))
            try:
                for row in reader:
                    paths.append(row["path"])
                    creation.append(parse_iso_ts(row["creation_ts"]))
                    nodes_col.append(row["primary_node"])
                    sizes.append(int(row.get("size_bytes", 0) or 0))
                    cats.append(row.get("category") or "moderate")
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                raise ValueError(
                    f"truncated/corrupt manifest {path!r}: row {reader.line_num} "
                    f"unreadable ({type(e).__name__}: {e})") from None
        node_vocab: dict[str, int] = {}
        node_ids = np.empty(len(nodes_col), dtype=np.int32)
        for i, nm in enumerate(nodes_col):
            node_ids[i] = node_vocab.setdefault(nm, len(node_vocab))
        return cls(
            paths=paths,
            # Creation timestamps are whole seconds, as the JAX package reads them.
            creation_ts=np.floor(np.asarray(creation, dtype=np.float64)),
            primary_node_id=node_ids,
            size_bytes=np.asarray(sizes, dtype=np.int64),
            category=cats,
            nodes=list(node_vocab),
        )

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", "creation_ts", "primary_node",
                        "size_bytes", "category"])
            for i, p in enumerate(self.paths):
                ts = datetime.fromtimestamp(float(self.creation_ts[i]),
                                            tz=timezone.utc)
                w.writerow([
                    p,
                    ts.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z",
                    self.nodes[int(self.primary_node_id[i])],
                    int(self.size_bytes[i]),
                    self.category[i],
                ])


#: Bytes of one row in a ``.cdrsb`` block: ts f64, pid i32, op i8, cid i32.
_BINARY_ROW_BYTES = 8 + 4 + 1 + 4


@dataclass
class EventLog:
    """Access events; ``path_id`` is -1 for paths absent from the manifest
    (the feature pass drops them)."""

    ts: np.ndarray          # (e,) float64 epoch seconds
    path_id: np.ndarray     # (e,) int32
    op: np.ndarray          # (e,) int8, 0 = READ, 1 = WRITE
    client_id: np.ndarray   # (e,) int32 into ``clients``
    clients: list[str]

    def __len__(self) -> int:
        return len(self.ts)

    # -- readers -----------------------------------------------------------

    @classmethod
    def read_csv(cls, path: str, manifest: Manifest,
                 native: bool = True) -> "EventLog":
        """The whole log (CSV or ``.cdrsb``) as one EventLog; ``native`` as
        in :meth:`read_csv_batches`."""
        batches = list(cls.read_csv_batches(path, manifest, batch_size=None, native=native))
        if not batches:
            return cls(ts=np.zeros(0), path_id=np.zeros(0, dtype=np.int32),
                       op=np.zeros(0, dtype=np.int8),
                       client_id=np.zeros(0, dtype=np.int32),
                       clients=list(manifest.nodes))
        return batches[0]

    @classmethod
    def concat(cls, parts: "list[EventLog]") -> "EventLog":
        """Concatenate batches.  The client vocabulary only grows along a
        batch stream, so the last batch's vocabulary covers every batch."""
        if not parts:
            raise ValueError("concat needs at least one batch")
        if len(parts) == 1:
            return parts[0]
        return cls(
            ts=np.concatenate([b.ts for b in parts]),
            path_id=np.concatenate([b.path_id for b in parts]),
            op=np.concatenate([b.op for b in parts]),
            client_id=np.concatenate([b.client_id for b in parts]),
            clients=parts[-1].clients,
        )

    #: Rows per native chunk when the whole file is read as one batch.
    _NATIVE_CHUNK_ROWS = 4_000_000

    @classmethod
    def read_csv_batches(cls, path: str, manifest: Manifest,
                         batch_size: int | None = 1_000_000,
                         native: bool = True,
                         start_offset: int = 0, with_offsets: bool = False):
        """Yield EventLog batches of up to ``batch_size`` rows (``None``:
        everything in one batch).

        The client vocabulary is threaded across batches, with ids shared
        with the manifest's node vocabulary so locality compares ids.

        A CSV log is read by the native chunk parser (``native=True``; a
        failed build of the host library raises) or, with ``native=False``,
        by Python's ``csv``.  Rows the native grammar
        rejects hand over to Python's parser from the exact byte reached.

        ``start_offset`` resumes the scan at a byte offset reported earlier
        with ``with_offsets=True``, which yields ``(batch, next_offset)``
        pairs: ``next_offset`` is the byte just past the batch's last row,
        valid as a later ``start_offset``, or None where no such byte is
        known (batches of the Python parser, which reads ahead, and the one
        batch of ``batch_size=None``).  A ``.cdrsb`` log reports offsets at
        block boundaries.
        """
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing event log {path!r}: no such file")
        if is_binary_log(path):
            gen = cls.read_binary_batches(path, manifest, batch_size=batch_size,
                                          start_offset=start_offset)
        else:
            if native:
                gen = cls._read_csv_native(path, manifest, batch_size, start_offset)
            else:
                gen = cls._read_csv_rows(path, manifest, batch_size, start_offset)
        if batch_size is not None:
            if with_offsets:
                yield from gen
            else:
                yield from (b for b, _ in gen)
            return
        batches = [b for b, _ in gen]
        if not batches:
            return
        out = cls.concat(batches)
        yield (out, None) if with_offsets else out

    @classmethod
    def _read_csv_native(cls, path: str, manifest: Manifest, batch_size: int | None,
                         start_offset: int = 0):
        """(batch, next_offset) pairs from the native chunk parser, then, from
        the byte where its grammar gave up (if anywhere), (batch, None) pairs
        from the Python parser with the vocabulary grown so far."""
        from ..runtime.native import InternMap, parse_log_chunk_native

        clients = list(manifest.nodes)
        rows_per_chunk = batch_size or cls._NATIVE_CHUNK_ROWS
        path_map = InternMap(manifest.paths)
        client_map = InternMap(clients)
        offset = int(start_offset)
        size = os.path.getsize(path)
        while True:
            chunk = parse_log_chunk_native(path, offset, rows_per_chunk)
            if chunk is None:
                break
            ts, op, pblob, poff, cblob, coff, nxt = chunk
            if len(ts) == 0:
                # No row parsed: the end of the file, or blank lines before
                # a row larger than the chunk's budget (Python's to read).
                if nxt >= size:
                    return
                offset = nxt
                break
            pid = path_map.lookup(pblob, poff)
            cid = client_map.insert_lookup(cblob, coff)
            clients.extend(client_map.names_from(len(clients)))
            yield cls(ts=ts, path_id=pid, op=op, client_id=cid, clients=list(clients)), nxt
            offset = nxt
        yield from cls._read_csv_rows(path, manifest, batch_size, offset, clients)

    @classmethod
    def _read_csv_rows(cls, path: str, manifest: Manifest,
                       batch_size: int | None, start_offset: int = 0, clients=None):
        """(batch, None) pairs from the Python csv parser; ``clients`` is the
        vocabulary grown before ``start_offset`` (the manifest's nodes when
        None)."""
        clients = list(manifest.nodes) if clients is None else list(clients)
        client_vocab = {nm: i for i, nm in enumerate(clients)}
        path_to_id = manifest.path_to_id

        def flush(ts, pid, op, cid):
            return cls(ts=np.asarray(ts, dtype=np.float64),
                       path_id=np.asarray(pid, dtype=np.int32),
                       op=np.asarray(op, dtype=np.int8),
                       client_id=np.asarray(cid, dtype=np.int32),
                       clients=list(clients))

        ts, pid, op, cid = [], [], [], []
        with open(path, newline="") as f:
            if start_offset:
                f.seek(int(start_offset))
            for row in csv.reader(f):
                if not row:
                    continue
                ts.append(parse_iso_ts(row[0]))
                pid.append(path_to_id.get(row[1], -1))
                op.append(1 if row[2] == "WRITE" else 0)
                c = row[3]
                if c not in client_vocab:
                    client_vocab[c] = len(clients)
                    clients.append(c)
                cid.append(client_vocab[c])
                if batch_size is not None and len(ts) >= batch_size:
                    yield flush(ts, pid, op, cid), None
                    ts, pid, op, cid = [], [], [], []
        if ts:
            yield flush(ts, pid, op, cid), None

    # -- binary columnar log (.cdrsb) ---------------------------------------

    @staticmethod
    def _vocab_bytes(strings) -> tuple[bytes, bytes]:
        """(offsets int64[(n+1)] bytes, utf-8 blob) for a string table."""
        enc = [s.encode("utf-8") for s in strings]
        off = np.zeros(len(enc) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in enc], out=off[1:])
        return off.tobytes(), b"".join(enc)

    @staticmethod
    def _vocab_hash(coff: bytes, cblob: bytes, poff: bytes, pblob: bytes) -> int:
        h = hashlib.blake2b(digest_size=8)
        for part in (coff, cblob, poff, pblob):
            h.update(part)
        return int.from_bytes(h.digest(), "little")

    #: Rows per block ``write_binary`` splits a log into, so readers stream
    #: block by block with bounded memory (8M rows = 136 MB of columns).
    BINARY_BLOCK_ROWS = 8_388_608

    def write_binary(self, path: str, manifest: Manifest, append: bool = False,
                     block_rows: int | None = None) -> int:
        """Write or append the binary columnar event log (.cdrsb).

        Layout (little-endian): ``CDRSBEV1``, int64 n_clients and n_paths,
        uint64 vocabulary hash, the client and path string tables (int64
        offsets + utf-8 blob each), then blocks of ``[int64 count][f64
        ts][i32 pid][i8 op][i32 cid]`` until the end of the file.  Rows with
        ``path_id == -1`` are skipped, as ``write_csv`` skips them.

        ``append=True`` adds blocks after checking that the file's header
        (and with it the vocabulary hash) is this log's; a mismatch raises.
        Returns the rows written.
        """
        coff, cblob = self._vocab_bytes(self.clients)
        poff, pblob = self._vocab_bytes(manifest.paths)
        vhash = self._vocab_hash(coff, cblob, poff, pblob)

        valid = self.path_id >= 0
        if valid.all():
            ts, pid, op, cid = self.ts, self.path_id, self.op, self.client_id
        else:
            ts, pid, op, cid = (self.ts[valid], self.path_id[valid],
                                self.op[valid], self.client_id[valid])

        header = (BINARY_MAGIC
                  + np.asarray([len(self.clients), len(manifest.paths)],
                               dtype=np.int64).tobytes()
                  + np.asarray([vhash], dtype=np.uint64).tobytes())
        if append and os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                head = f.read(len(header))
            if head[:len(BINARY_MAGIC)] != BINARY_MAGIC:
                raise ValueError(f"{path!r} is not a binary event log")
            if head != header:
                raise ValueError(
                    f"{path!r} was written with a different client/path "
                    "vocabulary; appending would corrupt its id columns")
            mode, parts = "ab", []
        else:
            mode, parts = "wb", [header, coff, cblob, poff, pblob]
        n = int(len(ts))
        if block_rows is not None and int(block_rows) <= 0:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        step = int(block_rows) if block_rows else self.BINARY_BLOCK_ROWS
        with open(path, mode) as f:
            for p in parts:
                f.write(p)
            for lo in range(0, max(n, 1), step):
                hi = min(n, lo + step)
                f.write(np.asarray([hi - lo], dtype=np.int64).tobytes())
                np.ascontiguousarray(ts[lo:hi], dtype=np.float64).tofile(f)
                np.ascontiguousarray(pid[lo:hi], dtype=np.int32).tofile(f)
                np.ascontiguousarray(op[lo:hi], dtype=np.int8).tofile(f)
                np.ascontiguousarray(cid[lo:hi], dtype=np.int32).tofile(f)
        return n

    @staticmethod
    def _binary_luts(file_clients, file_paths, manifest: Manifest):
        """Remap tables from a log's embedded vocabularies onto the caller's
        manifest: ``(plut or None, clut, clients)``.  ``plut`` is None when
        the file's path table is the manifest's; unknown paths map to -1 and
        unknown clients extend the vocabulary past ``manifest.nodes``."""
        if file_paths == manifest.paths:
            plut = None
        else:
            ids = manifest.path_to_id
            plut = np.asarray([ids.get(p, -1) for p in file_paths], dtype=np.int32)
        clients = list(manifest.nodes)
        cvocab = {nm: i for i, nm in enumerate(clients)}
        clut = np.empty(len(file_clients), dtype=np.int32)
        for i, nm in enumerate(file_clients):
            if nm not in cvocab:
                cvocab[nm] = len(clients)
                clients.append(nm)
            clut[i] = cvocab[nm]
        return plut, clut, clients

    @staticmethod
    def _read_block(f, pos: int, size: int, path: str, n_paths: int, n_clients: int):
        """Parse the block at byte ``pos`` (the file cursor is there).

        Returns ``(ts, pid, op, cid, next_pos)`` with the file's own ids
        (``ts`` None for a legal empty block).  A block that runs past
        ``size`` or holds ids outside the embedded tables raises."""
        head = np.fromfile(f, dtype=np.int64, count=1)
        bn = int(head[0]) if head.size == 1 else -1
        need = 8 + bn * _BINARY_ROW_BYTES
        if bn < 0 or pos + need > size:
            raise ValueError(f"truncated/corrupt block at byte {pos} of {path!r}")
        if bn == 0:
            return None, None, None, None, pos + need
        ts = np.fromfile(f, dtype=np.float64, count=bn)
        pid = np.fromfile(f, dtype=np.int32, count=bn)
        op = np.fromfile(f, dtype=np.int8, count=bn)
        cid = np.fromfile(f, dtype=np.int32, count=bn)
        # Range-check before the remap: numpy would wrap a negative id.
        if int(pid.min()) < 0 or int(pid.max()) >= n_paths:
            raise ValueError(f"truncated/corrupt block at byte {pos} of {path!r}: "
                             f"path id outside [0, {n_paths})")
        if int(cid.min()) < 0 or int(cid.max()) >= n_clients:
            raise ValueError(f"truncated/corrupt block at byte {pos} of {path!r}: "
                             f"client id outside [0, {n_clients})")
        return ts, pid, op, cid, pos + need

    @staticmethod
    def _read_binary_header(path: str):
        """``(clients, paths, first_block_offset)`` of a ``.cdrsb`` file.
        Every length is checked before it is used; a header the bytes
        cannot hold raises one ValueError naming the path."""
        def corrupt(why):
            return ValueError(f"truncated/corrupt header of {path!r}: {why}")

        with open(path, "rb") as f:
            head = f.read(len(BINARY_MAGIC) + 24)
            if head[:len(BINARY_MAGIC)] != BINARY_MAGIC:
                raise corrupt("bad magic")
            if len(head) < len(BINARY_MAGIC) + 24:
                raise corrupt("file ends inside the header")
            n_clients, n_paths = (int(v) for v in np.frombuffer(
                head[len(BINARY_MAGIC):len(BINARY_MAGIC) + 16], dtype=np.int64))
            if n_clients < 0 or n_paths < 0:
                raise corrupt("negative vocabulary size")

            def table(n):
                off_b = f.read(8 * (n + 1))
                if len(off_b) < 8 * (n + 1):
                    raise corrupt("file ends inside the vocabulary tables")
                off = np.frombuffer(off_b, dtype=np.int64)
                if int(off[0]) != 0 or (np.diff(off) < 0).any():
                    raise corrupt("non-monotonic string-table offsets")
                blob = f.read(int(off[-1]))
                if len(blob) < int(off[-1]):
                    raise corrupt("file ends inside the vocabulary tables")
                try:
                    return [blob[off[i]:off[i + 1]].decode("utf-8") for i in range(n)]
                except UnicodeDecodeError:
                    raise corrupt("undecodable string table") from None

            clients = table(n_clients)
            paths = table(n_paths)
            return clients, paths, f.tell()

    @classmethod
    def read_binary_batches(cls, path: str, manifest: Manifest,
                            batch_size: int | None = 1_000_000, start_offset: int = 0):
        """Yield ``(EventLog, next_offset or None)`` from a ``.cdrsb`` log.

        Ids are remapped onto the caller's manifest (``_binary_luts``).
        Blocks larger than ``batch_size`` are sliced (views); only the
        slice that ends a block reports an offset, so every reported offset
        is a valid later ``start_offset``.  ``batch_size=None`` yields every
        block as one EventLog, with offset None.
        """
        file_clients, file_paths, first_block = cls._read_binary_header(path)
        plut, clut, clients = cls._binary_luts(file_clients, file_paths, manifest)
        size = os.path.getsize(path)
        pos = int(start_offset) if start_offset else first_block
        if pos < first_block or pos > size:
            raise ValueError(f"start_offset {pos} outside the block region "
                             f"[{first_block}, {size}] of {path!r}")
        whole: list[EventLog] = []
        with open(path, "rb") as f:
            f.seek(pos)
            while pos < size:
                ts, pid, op, cid, pos = cls._read_block(
                    f, pos, size, path, len(file_paths), len(file_clients))
                if ts is None:
                    continue
                if plut is not None:
                    pid = plut[pid]
                cid = clut[cid]
                if batch_size is None:
                    whole.append(cls(ts=ts, path_id=pid, op=op, client_id=cid,
                                     clients=list(clients)))
                    continue
                bn, step = len(ts), max(1, int(batch_size))
                for lo in range(0, bn, step):
                    hi = min(bn, lo + step)
                    yield cls(ts=ts[lo:hi], path_id=pid[lo:hi], op=op[lo:hi],
                              client_id=cid[lo:hi], clients=list(clients)), \
                        (pos if hi == bn else None)
        if batch_size is None and whole:
            yield cls.concat(whole), None

    # -- writers -------------------------------------------------------------

    def write_csv(self, path: str, manifest: Manifest) -> None:
        """``access.log`` rows ``ts,path,op,client,pid``; rows with
        ``path_id == -1`` are skipped.  The native writer runs whenever no
        path or client needs CSV quoting, else Python's ``csv``; the files
        are byte-identical (the millisecond field truncates ``(t - floor(t))
        * 1000`` in both, as the JAX package's writers do)."""
        needs_quoting = any(any(ch in s for ch in (",", '"', "\n", "\r"))
                            for s in (*manifest.paths, *self.clients))
        if needs_quoting:
            self._write_csv_python(path, manifest)
            return
        from ..runtime.native import write_access_log_native

        valid = self.path_id >= 0
        if valid.all():
            cols = (self.ts, self.path_id, self.op, self.client_id)
        else:
            cols = (self.ts[valid], self.path_id[valid], self.op[valid],
                    self.client_id[valid])
        write_access_log_native(path, *cols, manifest.paths, self.clients)

    def _write_csv_python(self, path: str, manifest: Manifest) -> None:
        """The Python ``csv`` writer of :meth:`write_csv`."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            out_i = 0
            for i in range(len(self.ts)):
                if self.path_id[i] < 0:
                    continue
                t = float(self.ts[i])
                whole = int(np.floor(t))
                ms = min(int((t - whole) * 1000.0), 999)
                dt = datetime.fromtimestamp(whole, tz=timezone.utc)
                iso = dt.strftime("%Y-%m-%dT%H:%M:%S") + f".{ms:03d}Z"
                op = "WRITE" if self.op[i] else "READ"
                w.writerow([
                    iso, manifest.paths[int(self.path_id[i])], op,
                    self.clients[int(self.client_id[i])],
                    1000 + out_i % 9000,
                ])
                out_i += 1
