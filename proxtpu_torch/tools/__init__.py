"""Scripts that measure the port's kernels on one GPU (run with ``-m``)."""
