"""Host utilities of the port: checkpoint/resume of the minimal-k sweep and
the attempt block's sizing."""
