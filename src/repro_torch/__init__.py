"""repro_torch — the PyTorch/CUDA port of tSPM+ (transitive sequential
pattern mining) for NVIDIA Hopper.

It mirrors the layout and names of the JAX package ``repro`` module for
module, and never imports it: each module keeps its own copy of what it
needs.  Sequence ids are int64 tensors, spelled out everywhere, so no
global 64-bit switch is needed.

Kernels written by hand for ``sm_90a`` live in ``csrc/`` and are built on
first use by ``kernels/_build.py``.  A kernel wrapper launches its kernel
for a CUDA tensor and takes its plain PyTorch version only for a tensor
on the CPU.
"""

__version__ = "0.1.0"
