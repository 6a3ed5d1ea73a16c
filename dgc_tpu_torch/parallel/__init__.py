"""The vertex mesh over ``torch.distributed`` (port of ``dgc_tpu.parallel``).

The JAX package's 1-D device mesh becomes a process group: one rank is
one device of the mesh, owns one contiguous block of the vertex axis and
exchanges through the group's collectives (NCCL on the card, gloo on the
CPU). ``multihost`` initializes the group from ``torchrun``'s
environment.
"""

from dgc_tpu_torch.parallel.mesh import fetch_global, make_mesh, pad_to_multiple

__all__ = ["fetch_global", "make_mesh", "pad_to_multiple"]
