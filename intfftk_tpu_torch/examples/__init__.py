"""Runnable walkthroughs of the port, counterparts of the repository's
``examples/``: ``python -m intfftk_tpu_torch.examples.fft_single`` and
``python -m intfftk_tpu_torch.examples.fft_ifft_pair`` (on the card; add
``--device cpu`` for the plain version on the CPU)."""
