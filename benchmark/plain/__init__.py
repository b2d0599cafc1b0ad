"""Plain PyTorch references of the benchmark's configurations: the same
integer arithmetic as the frozen NumPy reference (``benchmark/reference``),
written in torch operations so that they run on the card as well as on the
CPU.  They import torch and the frozen reference's twiddle tables, nothing
of the port, of jax or of the JAX package."""
