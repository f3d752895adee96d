"""HNSW incremental commit log: op deltas between condensed snapshots
(port of ``weaviate_tpu/index/hnsw/commitlog.py``, same file format: either
package replays the other's log).

Reference: ``hnsw/commit_logger.go:38`` (append-only op log: AddNode /
ReplaceLinksAtLevel / AddLinkAtLevel / AddTombstone / DeleteNode),
``condensor.go`` (periodic compaction into a condensed file),
``startup.go`` (snapshot + tail replay) and
``corrupt_commit_logs_fixer.go`` (quarantine unreadable logs).

The condensed form here is the ``graph.npz`` snapshot ``HostGraph``
already writes; this log covers the window SINCE that snapshot, so a crash
between snapshots replays cheap link ops instead of redoing
ef_construction searches. Framing is [u32 len][u32 crc32][msgpack op];
a torn tail truncates, an unreadable file quarantines as ``.corrupt``.

Op vocabulary (entrypoint election is deterministic from these, so no
explicit SetEntryPoint op is needed):
  ("an", node, level)        add_node
  ("sn", level, node, nbrs)  replace neighbor list (int32 array bytes)
  ("ap", level, node, nbr)   append one edge
  ("ts", node)               tombstone
  ("rm", node)               hard-remove (cleanup)
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import msgpack
import numpy as np

_FRAME = struct.Struct("<II")  # len, crc32


class HNSWCommitLog:
    ROTATE_BYTES = 32 << 20

    def __init__(self, dirpath: str):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self._seq = 0  # monotonically increasing log-file sequence
        self._f = None
        self._buf: list[bytes] = []
        self._cur_bytes = 0
        for fn in self._log_files():
            self._seq = max(self._seq, self._file_seq(fn) + 1)
        self._open_new()

    # -- file helpers ------------------------------------------------------
    def _log_files(self) -> list[str]:
        return sorted(
            f for f in os.listdir(self.dir)
            if f.startswith("commit-") and f.endswith(".log"))

    @staticmethod
    def _file_seq(fn: str) -> int:
        return int(fn[len("commit-"):-len(".log")])

    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, f"commit-{seq:08d}.log")

    def _open_new(self) -> None:
        if self._f is not None:
            self._f.close()
        self._f = open(self._path(self._seq), "ab")
        self._cur_bytes = self._f.tell()
        self._seq += 1

    # -- append ------------------------------------------------------------
    def _append(self, op: tuple) -> None:
        payload = msgpack.packb(op, use_bin_type=True)
        self._buf.append(
            _FRAME.pack(len(payload), zlib.crc32(payload)) + payload)
        if len(self._buf) >= 256:
            self.flush_soft()

    def op_an(self, node: int, level: int) -> None:
        self._append(("an", int(node), int(level)))

    def op_sn(self, level: int, node: int, nbrs: np.ndarray) -> None:
        self._append(("sn", int(level), int(node),
                      np.asarray(nbrs, np.int32).tobytes()))

    def op_ap(self, level: int, node: int, nbr: int) -> None:
        self._append(("ap", int(level), int(node), int(nbr)))

    def op_ts(self, node: int) -> None:
        self._append(("ts", int(node)))

    def op_rm(self, node: int) -> None:
        self._append(("rm", int(node)))

    def flush_soft(self) -> None:
        if not self._buf:
            return
        blob = b"".join(self._buf)
        self._buf.clear()
        self._f.write(blob)
        self._cur_bytes += len(blob)
        if self._cur_bytes >= self.ROTATE_BYTES:
            self._f.flush()
            self._open_new()

    def flush(self) -> None:
        self.flush_soft()
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self.flush_soft()
        self._f.flush()
        self._f.close()
        self._f = None

    @property
    def pending_bytes(self) -> int:
        """Bytes of ops not yet condensed into a snapshot."""
        return sum(
            os.path.getsize(os.path.join(self.dir, f))
            for f in self._log_files()) + sum(map(len, self._buf))

    # -- condense ----------------------------------------------------------
    def truncate_after_snapshot(self) -> None:
        """The snapshot the caller just wrote covers every op logged so
        far: drop the old files and start a fresh one (reference
        commit_log_combiner + condensor end state)."""
        self.flush_soft()
        self._f.close()
        for fn in self._log_files():
            os.remove(os.path.join(self.dir, fn))
        self._f = None
        self._open_new()

    # -- replay ------------------------------------------------------------
    def replay_into(self, graph) -> int:
        """Apply logged ops to ``graph`` (logging disabled while replaying).
        Returns ops applied. Torn tails truncate in place; unreadable files
        quarantine as ``.corrupt`` and replay continues (reference
        corrupt_commit_logs_fixer.go)."""
        saved, graph.log = graph.log, None
        applied = 0
        try:
            for fn in self._log_files():
                path = os.path.join(self.dir, fn)
                try:
                    applied += self._replay_file(path, graph)
                except (OSError, ValueError, msgpack.UnpackException):
                    os.replace(path, path + ".corrupt")
        finally:
            graph.log = saved
        return applied

    @staticmethod
    def _replay_file(path: str, graph) -> int:
        applied = 0
        good_end = 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _FRAME.size <= len(data):
            ln, crc = _FRAME.unpack_from(data, off)
            start = off + _FRAME.size
            end = start + ln
            if end > len(data):
                break  # torn tail
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                break  # torn/corrupt tail: stop here, truncate below
            op = msgpack.unpackb(payload, raw=False)
            _apply(graph, op)
            applied += 1
            off = end
            good_end = end
        if good_end < len(data):
            with open(path, "r+b") as f:
                f.truncate(good_end)
        return applied


def _apply(graph, op) -> None:
    kind = op[0]
    if kind == "an":
        graph.add_node(op[1], op[2])
    elif kind == "sn":
        graph.ensure_capacity(op[2] + 1)
        graph.set_neighbors(
            op[1], op[2], np.frombuffer(op[3], np.int32))
    elif kind == "ap":
        graph.ensure_capacity(op[2] + 1)
        # idempotent: a crash between the condensed snapshot and the log
        # truncation replays ops the snapshot already contains — a blind
        # append would fill layer0 rows with duplicate edges
        if op[3] not in graph.get_neighbors(op[1], op[2]):
            graph.append_neighbor(op[1], op[2], op[3])
    elif kind == "ts":
        graph.add_tombstone(op[1])
    elif kind == "rm":
        graph.remove_node_hard(op[1])
    # unknown ops skip silently: forward-compatible replay
