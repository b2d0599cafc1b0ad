"""The PyTorch/CUDA port's benchmark: ``python -m bench_torch``.

Counterpart of ``bench.py``, which times the JAX package.  It lives outside
``intfftk_tpu_torch`` on purpose: what it reads (``timing``), the work it
counts and the rates of its bounds (``count``) are the benchmark's own
code, which a change to the program cannot move.  ``cells`` builds each
cell on a device from a seed, ``verify`` holds every bit-check family to
the golden model, ``__main__`` runs and prints them.  It imports torch,
numpy and ``intfftk_tpu_torch``, never JAX or the JAX package.
"""
