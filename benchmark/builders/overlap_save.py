"""Builder ``overlap_save``: overlap-save FIR filtering of a signal
through ``OverlapSaveConv``: per block of n samples a forward four-step
transform, the product with the taps' spectrum (P1) and the inverse.

Configuration keys: ``n``, ``taps_len``, ``data_width``, ``taps_width``,
``twiddle_width``, ``max_spectrum_width``, ``max_product_width``,
``rounding`` (the arguments of ``make_conv_spec``), ``taps_bits`` (real
taps uniform in +-2^(bits-1), made from the seed), and ``control``: the
``make_conv_spec`` arguments the control changes.  Traffic keys:
``items_per_call`` (T, the payloads of a call), ``amplitude_bits``,
``ring_bytes``, ``check_items`` (payload blocks).

A call counts its T x L payload samples (L = n - taps_len + 1).  Its
answer for payload block j is the golden overlap-save output of block j.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import count, reference, ring

#: the configuration keys that are ``make_conv_spec``'s arguments
SPEC_KEYS = ("n", "taps_len", "data_width", "taps_width", "twiddle_width",
             "max_spectrum_width", "max_product_width", "rounding")


def reference_spec(config: dict, control: bool = False):
    """The configuration as the frozen reference's ``ConvSpec``; with
    ``control``, the control's."""
    args = {k: config[k] for k in SPEC_KEYS}
    if control:
        args.update(config["control"])
    return reference.make_conv_spec(**args)


def sizes(config: dict, traffic: dict) -> ring.Sizes:
    """Samples, slot bytes, slots and work, from the files alone."""
    spec = reference_spec(config)
    n, blocks = spec.n, traffic["items_per_call"]
    if traffic["amplitude_bits"] > spec.cfg.data_width:
        raise ValueError("samples wider than the configuration's data")
    samples = blocks * spec.payload
    data = count.container(spec.cfg.data_width)
    spectrum = count.container(spec.fft_cfg.output_width)
    prod = count.container(spec.product_width)
    # the entry's buffers: an int32 signal in, the payload out at the
    # product's width
    slot_bytes = samples * 2 * (4 + prod)
    passes = (count.four_step(n, blocks, data, spectrum)
              + count.four_step(n, blocks, prod, prod))
    product = count.product(blocks * n, spectrum, prod, n)
    return ring.Sizes(samples_per_call=samples, slot_bytes=slot_bytes,
                      slots=count.ring_slots(slot_bytes,
                                             traffic["ring_bytes"]),
                      work={"pass": passes, "product": product})


def taps(config: dict, seed: int):
    """The real taps, made on the host from the seed."""
    rng = np.random.default_rng(ring.sub_seed(seed, "taps"))
    lim = 1 << (config["taps_bits"] - 1)
    m = config["taps_len"]
    return rng.integers(-lim, lim, m), np.zeros(m, np.int64)


def build(config: dict, traffic: dict, device: torch.device,
          seed: int) -> ring.Built:
    """The ring of ``sizes`` on ``device``, each slot's signal made there
    from the seed, each slot's call captured (on the card)."""
    from intfftk_tpu_torch import OverlapSaveConv
    from intfftk_tpu_torch.golden import make_conv_spec

    size = sizes(config, traffic)
    blocks, bits = traffic["items_per_call"], traffic["amplitude_bits"]
    h_re, h_im = taps(config, seed)
    conv = OverlapSaveConv(make_conv_spec(**{k: config[k]
                                             for k in SPEC_KEYS}),
                           h_re, h_im, device=device)
    lpay = conv.spec.payload

    def signal(k):
        return tuple(ring.uniform((blocks * lpay,), bits, torch.int32,
                                  ring.sub_seed(seed, "signal", k, part),
                                  device) for part in ("re", "im"))

    slots = [ring.make_slot(conv.capture, conv, signal(k), device)
             for k in range(size.slots)]

    def check(check_seed: int, control: bool = False) -> ring.Compared:
        picks = ring.draw(check_seed, len(slots), blocks,
                          traffic["check_items"])
        spec = reference_spec(config)
        spectrum = reference.taps_spectrum_int(h_re, h_im, spec)
        if control:
            cspec = reference_spec(config, control=True)
            cspectrum = reference.taps_spectrum_int(h_re, h_im, cspec)
        compared = ring.Compared()
        for k, chosen in picks.items():
            xr, xi = (t.cpu().numpy() for t in signal(k))
            want = reference.overlap_save_blocks(xr, xi, spectrum, spec,
                                                 chosen)
            if control:
                got = reference.overlap_save_blocks(xr, xi, cspectrum,
                                                    cspec, chosen)
            else:
                got = [o.reshape(blocks, lpay)[chosen].cpu().numpy()
                       for o in slots[k].outputs]
            compared.add(k, got, want)
        return compared

    return ring.Built(slots=slots, sizes=size, check=check)
