"""The benchmark of ``intfftk_tpu_torch``, the PyTorch/CUDA port, on NVIDIA
H100 cards.

``python -m benchmark --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line
(``run.py``).  What a cell is comes from data: its configuration
(``configs/``), its traffic (``traffic/``) and its per-layer metrics'
readers (``metrics/``), found by name (``manifest.py``); a configuration
names its builder (``builders/``), which makes the cell's ring of frames on
the card from the seed (``ring.py``) through the port's public API.  The
yardstick is here too, where no change to the port can move it: the
frozen count and peaks (``count.py``), the measured window (``window.py``),
the trace's reduction (``trace.py``) and the frozen NumPy reference
(``reference/``).  Nothing here imports jax, the JAX package or
``bench_torch``; the reference imports nothing of the port.
"""
