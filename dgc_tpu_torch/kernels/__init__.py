"""Hand-written CUDA kernels for Hopper: their build step (``build``) and
their wrappers with launch counters and plain versions (``superstep``).
Nothing here imports a compiler or touches a card at import time."""
