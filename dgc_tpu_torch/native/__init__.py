"""Native (C++) host paths of the port, bound with ctypes: graph
generation, the degree relabel and combined-table build, and the
post-pass walks (``bindings``; ``graphgen.cpp`` is ``dgc_tpu``'s source,
verbatim). Nothing is built at import time."""
