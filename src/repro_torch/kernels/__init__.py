"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and their public entry points (``ops``)."""
