"""Graph data model: Node/Graph records, array forms (CSR/ELL), generators."""

from dgc_tpu_torch.models.node import Node
from dgc_tpu_torch.models.graph import Graph
from dgc_tpu_torch.models.arrays import GraphArrays, csr_to_ell, ell_to_csr
from dgc_tpu_torch.models.generators import (generate_random_graph,
                                             generate_random_graph_fast,
                                             generate_rmat_graph)

__all__ = [
    "Node",
    "Graph",
    "GraphArrays",
    "csr_to_ell",
    "ell_to_csr",
    "generate_random_graph",
    "generate_random_graph_fast",
    "generate_rmat_graph",
]
