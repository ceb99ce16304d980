"""Kernels of the serving path: plain PyTorch versions (``ref``), the
hand-written Hopper kernels (``csrc/`` bound by ``cuda``) and their
dispatch (``ops``)."""
