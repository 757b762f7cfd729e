"""Hand-written Hopper kernels for BackPACK's reductions, their plain
PyTorch versions (:mod:`.ref`) and the dispatch between them (:mod:`.ops`)."""
