"""PyTorch/CUDA port of the CodecSight streaming VLM serving system.

Mirrors the subpackage layout of the JAX package (``configs``, ``data``,
``codec``, ``core``, ``kernels``, ``models``, ``serving``, ``launch``)
so each module's counterpart is found by path.  Imports ``torch`` and
``numpy`` only; the hot spots run hand-written Hopper kernels from
``csrc/`` on CUDA tensors and their plain PyTorch versions on CPU
tensors.
"""
