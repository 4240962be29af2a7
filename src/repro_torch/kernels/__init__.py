"""Hand-written Hopper kernels of the port, their wrappers, their plain
versions (``ref``) and the dispatch by device (``ops``)."""
