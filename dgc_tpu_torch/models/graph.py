"""Graph model with the reference's JSON (de)serialization contract (the
port's copy of ``dgc_tpu.models.graph``).

Mirrors the responsibilities of the reference ``Graph`` class
(reference ``graph.py:5-43``) with an array-native core:

- ``serialize`` / ``deserialize``: same JSON schema — a list of
  ``{"id", "neighbors": [ids], "color"}`` objects, indent=4
  (``graph.py:10-12,15-28``). Ids may appear in any order in the file; we
  relink by id exactly like the reference's id→node dict (``graph.py:21-26``),
  but into CSR arrays instead of object pointers.
- construction from a generator (``Graph.generate``) rather than the
  reference's always-generate ``__init__`` (``graph.py:6-7``), which forced
  callers to pass a ``Graph(0,0)`` dummy before file loads
  (``coloring.py:176``).

Colors travel separately as an int32 vector (−1 = uncolored) — the engines'
state — but ``to_nodes``/``serialize`` accept one to fill the per-node
``"color"`` field for bit-compatible output.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from dgc_tpu_torch.models import generators
from dgc_tpu_torch.models.arrays import GraphArrays
from dgc_tpu_torch.models.node import UNCOLORED, Node


class Graph:
    def __init__(self, arrays: GraphArrays, colors: np.ndarray | None = None):
        self.arrays = arrays
        v = arrays.num_vertices
        if colors is None:
            colors = np.full(v, UNCOLORED, dtype=np.int32)
        self.colors = np.asarray(colors, dtype=np.int32)
        if len(self.colors) != v:
            raise ValueError(f"colors length {len(self.colors)} != num_vertices {v}")

    # ---- construction -------------------------------------------------

    @classmethod
    def generate(
        cls, node_count: int, max_degree: int, seed: int | None = None, method: str = "reference"
    ) -> "Graph":
        """Random graph. ``method='reference'`` follows the reference
        generator's semantics (``graph.py:30-43``, with a retry bound);
        ``'fast'`` is the vectorized large-V path; ``'rmat'`` is power-law."""
        if method == "reference":
            arrays = generators.generate_random_graph(node_count, max_degree, seed=seed)
        elif method == "fast":
            arrays = generators.generate_random_graph_fast(
                node_count, avg_degree=max_degree / 2.0, seed=seed, max_degree=max_degree
            )
        elif method == "rmat":
            arrays = generators.generate_rmat_graph(node_count, avg_degree=max_degree / 2.0, seed=seed)
        else:
            raise ValueError(f"unknown generation method: {method!r}")
        return cls(arrays)

    @classmethod
    def from_nodes(cls, nodes: list[Node]) -> "Graph":
        nodes_sorted = sorted(nodes, key=lambda n: n.id)
        ids = [n.id for n in nodes_sorted]
        if ids != list(range(len(ids))):
            id_map = {orig: new for new, orig in enumerate(ids)}
            lists = [[id_map[j] for j in n.neighbors] for n in nodes_sorted]
        else:
            lists = [list(n.neighbors) for n in nodes_sorted]
        colors = np.array([n.color for n in nodes_sorted], dtype=np.int32)
        return cls(GraphArrays.from_neighbor_lists([sorted(ns) for ns in lists]), colors)

    def to_nodes(self, colors: np.ndarray | None = None) -> list[Node]:
        colors = self.colors if colors is None else np.asarray(colors)
        lists = self.arrays.to_neighbor_lists()
        return [Node(i, lists[i], int(colors[i])) for i in range(self.arrays.num_vertices)]

    # ---- JSON I/O (reference schema) ----------------------------------

    @classmethod
    def deserialize(cls, path: str | Path) -> "Graph":
        """Load the reference graph schema (``graph.py:15-28``)."""
        with open(path) as f:
            data = json.load(f)
        return cls.from_nodes([Node.from_dict(d) for d in data])

    def serialize(self, path: str | Path, colors: np.ndarray | None = None) -> None:
        """Write the reference graph schema, indent=4 (``graph.py:10-12``)."""
        data = [n.to_dict() for n in self.to_nodes(colors)]
        with open(path, "w") as f:
            json.dump(data, f, indent=4)

    def save_coloring(self, path: str | Path, colors: np.ndarray) -> None:
        """Write the reference coloring schema: ``[{"id", "color"}]``,
        indent=4 (``coloring.py:239-241``)."""
        colors = np.asarray(colors)
        data = [{"id": i, "color": int(colors[i])} for i in range(len(colors))]
        with open(path, "w") as f:
            json.dump(data, f, indent=4)

    @staticmethod
    def load_coloring(path: str | Path) -> np.ndarray:
        with open(path) as f:
            data = json.load(f)
        colors = np.full(len(data), UNCOLORED, dtype=np.int32)
        for d in data:
            colors[int(d["id"])] = int(d["color"])
        return colors

    # ---- convenience --------------------------------------------------

    @property
    def num_vertices(self) -> int:
        return self.arrays.num_vertices

    @property
    def max_degree(self) -> int:
        return self.arrays.max_degree

    def initial_k(self) -> int:
        """The reference's starting color budget: max observed degree + 1
        (``coloring.py:212``)."""
        return self.arrays.max_degree + 1
