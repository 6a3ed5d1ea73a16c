"""Plain PyTorch versions of the superstep rule (``bitmask``,
``speculative``) and the host passes (``validate``, ``reduce_colors``)."""
