"""Hand-written CUDA kernels for Hopper: their build step (``build``) and
their wrappers with launch counters and plain versions (``superstep``,
``compact``, ``hub``, ``block``, ``dense``). Nothing here imports a
compiler or touches a card at import time."""
