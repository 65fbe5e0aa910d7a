"""Scripts of the port, run with ``-m``: kernel measurements on one GPU, the
reference suite and application families, the entry points and the
multi-rank worker of the sharding layer."""
