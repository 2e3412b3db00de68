"""The general parts of the benchmark: the spec, the world, the traffic loop,
the trace reduction, the roofline table and the comparison that decides
``correct``. Nothing here imports the port."""
