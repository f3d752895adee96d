"""Host-side HNSW graph: layered adjacency over internal doc ids (port of
``weaviate_tpu/index/hnsw/graph.py``, host numpy code kept as it is).

Reference: ``adapters/repos/db/vector/hnsw/vertex.go`` + ``packedconn/``
(packed adjacency lists). Layer 0 is a dense ``[capacity, 2M]`` int32 array
(-1 padded): the shape the device walk (``ops/device_beam.py``) uploads
wholesale and then keeps in sync row by row. Upper layers hold
~N/M^level nodes and live in compact dicts. ``to_arrays``/``from_arrays``
keep the JAX package's ``graph.npz`` format, so either package loads the
other's snapshot.
"""

from __future__ import annotations

import numpy as np

NO_NODE = -1


class HostGraph:
    def __init__(self, m: int = 32, capacity: int = 4096):
        self.m = m
        self.m0 = 2 * m
        self.levels = np.full(capacity, NO_NODE, np.int16)  # -1 = not present
        self.layer0 = np.full((capacity, self.m0), NO_NODE, np.int32)
        # level (>=1) -> {node: int32[<=m] array}
        self.upper: dict[int, dict[int, np.ndarray]] = {}
        self.entrypoint = NO_NODE
        self.max_level = -1
        self.node_count = 0
        # tombstoned nodes stay traversable (edges intact) but are excluded
        # from results + entrypoint election until cleanup rewires them
        # (reference delete.go tombstone semantics)
        self.tombstones: set[int] = set()
        # optional incremental op log (commitlog.HNSWCommitLog); mutations
        # mirror into it so a crash since the last condensed snapshot
        # replays link ops instead of redoing construction
        self.log = None
        # optional dirty-row callback (device adjacency mirror): called
        # with node ids whose layer-0 row / presence changed
        self.dirty_hook = None
        # bumped on any level>=1 topology change; the device mirror
        # rebuilds its compact upper-layer tables when this moves (the
        # upper layers hold ~N/(M-1) nodes, so wholesale rebuild is cheap)
        self.upper_version = 0

    @property
    def capacity(self) -> int:
        return self.levels.shape[0]

    def ensure_capacity(self, n: int) -> None:
        cap = self.capacity
        if n <= cap:
            return
        new_cap = max(n, cap * 2)
        levels = np.full(new_cap, NO_NODE, np.int16)
        levels[:cap] = self.levels
        self.levels = levels
        layer0 = np.full((new_cap, self.m0), NO_NODE, np.int32)
        layer0[:cap] = self.layer0
        self.layer0 = layer0

    def contains(self, node: int) -> bool:
        return (
            0 <= node < self.capacity
            and self.levels[node] >= 0
            and node not in self.tombstones
        )

    def is_present(self, node: int) -> bool:
        """Present in the graph structure (live OR tombstoned)."""
        return 0 <= node < self.capacity and self.levels[node] >= 0

    def add_node(self, node: int, level: int) -> None:
        self.ensure_capacity(node + 1)
        if self.levels[node] < 0:
            self.node_count += 1
        self.levels[node] = level
        if level >= 1:
            self.upper_version += 1
        for l in range(1, level + 1):
            self.upper.setdefault(l, {})[node] = np.empty(0, np.int32)
        if level > self.max_level:
            self.max_level = level
            self.entrypoint = node
        if self.log is not None:
            self.log.op_an(node, level)
        if self.dirty_hook is not None:
            self.dirty_hook(node)

    def add_tombstone(self, node: int) -> None:
        """Mark deleted: edges stay so traversal can route through; the node
        is excluded from results and entrypoint duty (reference delete.go)."""
        if not self.contains(node):
            return
        self.tombstones.add(node)
        self.node_count -= 1
        if node == self.entrypoint:
            self._elect_entrypoint()
        if self.log is not None:
            self.log.op_ts(node)
        if self.dirty_hook is not None:
            self.dirty_hook(node)

    def remove_node_hard(self, node: int) -> None:
        """Physically drop a node (cleanup only — callers must have rewired
        inbound edges first)."""
        if not (0 <= node < self.capacity) or self.levels[node] < 0:
            return
        level = int(self.levels[node])
        self.levels[node] = NO_NODE
        self.layer0[node] = NO_NODE
        if level >= 1:
            self.upper_version += 1
        for l in range(1, level + 1):
            self.upper.get(l, {}).pop(node, None)
        if node in self.tombstones:
            self.tombstones.discard(node)
        else:
            self.node_count -= 1
        if node == self.entrypoint:
            self._elect_entrypoint()
        if self.log is not None:
            self.log.op_rm(node)
        if self.dirty_hook is not None:
            self.dirty_hook(node)

    def _elect_entrypoint(self) -> None:
        """New entrypoint = any live (non-tombstoned) node at the highest
        level (reference ``delete.go`` entrypoint re-election)."""
        for l in range(self.max_level, 0, -1):
            for n in self.upper.get(l, {}):
                if self.contains(n):
                    self.entrypoint = n
                    self.max_level = l
                    return
        live = np.nonzero(self.levels >= 0)[0]
        for n in live:
            if int(n) not in self.tombstones:
                self.entrypoint = int(n)
                self.max_level = 0
                return
        self.entrypoint = NO_NODE
        self.max_level = -1

    # -- adjacency --------------------------------------------------------
    def width(self, level: int) -> int:
        return self.m0 if level == 0 else self.m

    def neighbors_batch(self, level: int, nodes: np.ndarray) -> np.ndarray:
        """[B] node ids -> [B, width] neighbor ids (-1 padded)."""
        if level == 0:
            return self.layer0[nodes]
        layer = self.upper.get(level, {})
        out = np.full((len(nodes), self.m), NO_NODE, np.int32)
        for i, n in enumerate(nodes):
            arr = layer.get(int(n))
            if arr is not None and len(arr):
                out[i, : len(arr)] = arr
        return out

    def get_neighbors(self, level: int, node: int) -> np.ndarray:
        if level == 0:
            row = self.layer0[node]
            return row[row >= 0]
        arr = self.upper.get(level, {}).get(node)
        return arr if arr is not None else np.empty(0, np.int32)

    def set_neighbors(self, level: int, node: int, nbrs: np.ndarray) -> None:
        nbrs = np.asarray(nbrs, np.int32)
        w = self.width(level)
        if len(nbrs) > w:
            raise ValueError(f"{len(nbrs)} neighbors > width {w} at level {level}")
        if level == 0:
            self.layer0[node] = NO_NODE
            self.layer0[node, : len(nbrs)] = nbrs
        else:
            self.upper.setdefault(level, {})[node] = nbrs.copy()
            self.upper_version += 1
        if self.log is not None:
            self.log.op_sn(level, node, nbrs)
        if level == 0 and self.dirty_hook is not None:
            self.dirty_hook(node)

    def append_neighbor(self, level: int, node: int, nbr: int) -> bool:
        """Add an edge if there's room; returns False when full (caller prunes)."""
        if level == 0:
            row = self.layer0[node]
            free = np.nonzero(row == NO_NODE)[0]
            if len(free) == 0:
                return False
            row[free[0]] = nbr
            if self.log is not None:
                self.log.op_ap(level, node, nbr)
            if self.dirty_hook is not None:
                self.dirty_hook(node)
            return True
        layer = self.upper.setdefault(level, {})
        arr = layer.get(node)
        if arr is None:
            arr = np.empty(0, np.int32)
        if len(arr) >= self.m:
            return False
        layer[node] = np.append(arr, np.int32(nbr))
        self.upper_version += 1
        if self.log is not None:
            self.log.op_ap(level, node, nbr)
        return True

    def set_neighbors_rows(self, level: int, nodes: np.ndarray,
                           rows: np.ndarray, counts: np.ndarray) -> None:
        """Batched ``set_neighbors``: node ``nodes[i]`` gets
        ``rows[i, :counts[i]]`` (``rows`` is -1 padded), with the same ops
        logged. ``nodes`` holds no node twice."""
        if level != 0 or rows.shape[1] != self.m0:
            for node, row, c in zip(nodes, rows, counts):
                self.set_neighbors(level, int(node), row[:c])
            return
        self.layer0[nodes] = rows
        if self.log is not None:
            for node, row, c in zip(nodes, rows, counts):
                self.log.op_sn(0, node, row[:c])
        if self.dirty_hook is not None and len(nodes):
            self.dirty_hook(*np.asarray(nodes).tolist())

    def append_neighbors(self, level: int, nodes: np.ndarray,
                         nbrs: np.ndarray, slots: np.ndarray) -> None:
        """Batched ``append_neighbor`` for edges the caller knows fit:
        edge e puts ``nbrs[e]`` into free column ``slots[e]`` of
        ``nodes[e]``'s row (layer 0) or appends it (upper levels), in
        order, logging the same ops."""
        if level != 0:
            for node, nbr in zip(nodes, nbrs):
                self.append_neighbor(level, int(node), int(nbr))
            return
        self.layer0[nodes, slots] = nbrs
        if self.log is not None:
            for node, nbr in zip(nodes, nbrs):
                self.log.op_ap(0, node, nbr)
        if self.dirty_hook is not None:
            self.dirty_hook(*np.unique(nodes).tolist())

    # -- persistence ------------------------------------------------------
    def to_arrays(self) -> dict:
        """Snapshot for npz persistence (HNSW commit-log condensed form —
        reference ``condensor.go`` writes a compacted graph the same way)."""
        upper_nodes, upper_levels, upper_flat, upper_len = [], [], [], []
        for l, layer in self.upper.items():
            for n, arr in layer.items():
                upper_nodes.append(n)
                upper_levels.append(l)
                upper_len.append(len(arr))
                upper_flat.append(arr)
        flat = (
            np.concatenate(upper_flat) if upper_flat else np.empty(0, np.int32)
        )
        return {
            "m": np.int64(self.m),
            "levels": self.levels,
            "layer0": self.layer0,
            "entrypoint": np.int64(self.entrypoint),
            "max_level": np.int64(self.max_level),
            "node_count": np.int64(self.node_count),
            "upper_nodes": np.asarray(upper_nodes, np.int32),
            "upper_levels": np.asarray(upper_levels, np.int16),
            "upper_len": np.asarray(upper_len, np.int32),
            "upper_flat": flat,
            "tombstones": np.asarray(sorted(self.tombstones), np.int64),
        }

    @staticmethod
    def from_arrays(d: dict) -> "HostGraph":
        g = HostGraph(m=int(d["m"]), capacity=len(d["levels"]))
        g.levels = np.asarray(d["levels"], np.int16)
        g.layer0 = np.asarray(d["layer0"], np.int32)
        g.entrypoint = int(d["entrypoint"])
        g.max_level = int(d["max_level"])
        g.node_count = int(d["node_count"])
        off = 0
        flat = np.asarray(d["upper_flat"], np.int32)
        for n, l, ln in zip(d["upper_nodes"], d["upper_levels"], d["upper_len"]):
            g.upper.setdefault(int(l), {})[int(n)] = flat[off : off + int(ln)].copy()
            off += int(ln)
        g.tombstones = set(int(t) for t in d.get("tombstones", []))
        return g
