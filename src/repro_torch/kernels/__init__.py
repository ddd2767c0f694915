"""Kernels written by hand for Hopper (CUDA C++ in ``../csrc``), each with
an ``ops.py`` wrapper that dispatches on the tensor's device and a
``ref.py`` plain PyTorch version."""
