"""Vertex record with the reference's JSON contract (the port's copy of
``dgc_tpu.models.node``).

The reference (reference ``node.py:1-18``) stores neighbors as *object
pointers*, which forces whole-component pickling and a JVM stack bump
(``coloring.py:198``). Here neighbors are plain integer ids — the array-native
form the engines consume — while ``to_dict``/``from_dict`` keep the exact
JSON schema ``{"id": int, "neighbors": [int], "color": int}`` with −1 meaning
uncolored (``node.py:2``). Unlike the reference's dead ``from_dict``
(``node.py:16-18``, drops neighbors), ours round-trips faithfully.
"""

from __future__ import annotations

from dataclasses import dataclass, field

UNCOLORED = -1


@dataclass
class Node:
    id: int
    neighbors: list[int] = field(default_factory=list)
    color: int = UNCOLORED

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "neighbors": list(self.neighbors),
            "color": self.color,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        # "neighbors" is required: the graph schema always carries it
        # (graph.py:10-12); accepting its absence silently turns a coloring
        # file passed as --input into an edgeless graph.
        return cls(
            id=int(d["id"]),
            neighbors=[int(n) for n in d["neighbors"]],
            color=int(d.get("color", UNCOLORED)),
        )

    @property
    def degree(self) -> int:
        return len(self.neighbors)
