"""Entry points of the port: the single-cell DSE CLI, the kernel-cell loop
and the measured tier."""
