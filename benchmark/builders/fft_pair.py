"""Builder ``fft_pair``: batches of frames through the FFT -> spectrum
product -> IFFT pair, ``FFTPairPlan``: per frame a raw forward four-step
transform, the product with a spectrum table held in the forward's raw
order (P1), and the raw inverse back to natural order.

Configuration keys: ``n``, ``factors`` ([n1, n2]: the blocks are
[B, n1, n2], a flat frame reshaped), the forward's ``mode``, ``rounding``,
``data_width``, ``twiddle_width`` and ``twiddle_gen``, the inverse's
``inverse_mode`` and ``inverse_rounding`` (its data width is the
forward's output width), ``spectrum`` (the table's shape by name:
``"quadratic_phase"``), ``spectrum_width`` and ``product_shift`` (the
product is wrapped to the forward's output width), and ``control``: the
plain reference's options for the control, ``{"product_sums": "mod64"}``
(the product's and the inverse's product-sums formed modulo 2^64).
Traffic keys:
``items_per_call`` (the batch B), ``tone_log2`` and ``noise_bits`` (each
frame a carrier of amplitude 2^tone_log2 at a frequency and phase drawn
per frame, plus noise uniform in +-2^(noise_bits-1) on re and im),
``ring_bytes``, ``check_items``.

A call counts B x n samples.  Its answer for frame b is the plain
PyTorch reference's pair of frame b (``benchmark/plain/pair.py``), which
the check computes on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark import count, reference, ring
from benchmark.plain import pair as plain

#: the configuration keys that are the forward's ``FFTConfig`` fields
CONFIG_KEYS = ("n", "mode", "rounding", "data_width", "twiddle_width",
               "twiddle_gen")


def quadratic_phase(n: int, shift: int):
    """H_k = round(2^shift * e^(j*theta_k)), theta_k = pi * (k^2 mod 2n) / n
    for the natural frequency index k: a quadratic-phase all-pass across
    the band, the spectrum of a linear-FM matched filter, of unit gain
    once the product is shifted down by ``shift``."""
    k = np.arange(n, dtype=np.int64)
    theta = np.pi * ((k * k) % (2 * n)) / n
    mag = float(1 << shift)
    return (np.rint(mag * np.cos(theta)).astype(np.int64),
            np.rint(mag * np.sin(theta)).astype(np.int64))


def reference_configs(config: dict):
    """(forward, inverse) as the frozen reference's ``FFTConfig``s."""
    cfg = reference.FFTConfig(**{k: config[k] for k in CONFIG_KEYS})
    icfg = dataclasses.replace(cfg, mode=config["inverse_mode"],
                               rounding=config["inverse_rounding"],
                               data_width=cfg.output_width)
    return cfg, icfg


def spectrum(config: dict):
    """The configuration's spectrum table, natural order, on the host."""
    if config["spectrum"] != "quadratic_phase":
        raise ValueError(f"unknown spectrum {config['spectrum']!r}")
    return quadratic_phase(config["n"], config["product_shift"])


def sizes(config: dict, traffic: dict) -> ring.Sizes:
    """Samples, slot bytes, slots and work, from the files alone."""
    n, batch = config["n"], traffic["items_per_call"]
    n1, n2 = config["factors"]
    if n1 * n2 != n:
        raise ValueError(f"factors {n1} x {n2} are not n = {n}")
    cfg, icfg = reference_configs(config)
    peak = (1 << traffic["tone_log2"]) + (1 << (traffic["noise_bits"] - 1))
    if peak >= 1 << (cfg.data_width - 1):
        raise ValueError("frames wider than the configuration's data")
    data = count.container(cfg.data_width)
    spec = count.container(cfg.output_width)
    out = count.container(icfg.output_width)
    slot_bytes = batch * n * 2 * (data + out)
    inverse = count.four_step(n, batch, spec, out)
    return ring.Sizes(
        samples_per_call=batch * n, slot_bytes=slot_bytes,
        slots=count.ring_slots(slot_bytes, traffic["ring_bytes"]),
        work={"pass": count.four_step(n, batch, data, spec) + inverse,
              "inverse_pass": inverse,
              "product": count.product(batch * n, spec, spec, n)})


def tone_frames(batch: int, n: int, traffic: dict, seed: int,
                device: torch.device):
    """re and im [batch, n] int64 on ``device``: per frame
    round(2^tone_log2 * e^(j(2 pi f t / n + phi))) with f uniform in
    [0, n) and phi in [0, 2 pi), plus noise uniform in
    +-2^(noise_bits-1) on re and im, all from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(ring.sub_seed(seed, "tone"))
    f64 = dict(device=device, dtype=torch.float64)
    f = torch.rand((batch, 1), generator=gen, **f64) * n
    phi = torch.rand((batch, 1), generator=gen, **f64) * (2 * math.pi)
    t = torch.arange(n, **f64)
    angle = 2 * math.pi * torch.frac(f * t / n) + phi
    amp = float(1 << traffic["tone_log2"])
    return tuple(
        torch.round(amp * wave(angle)).long()
        + ring.uniform((batch, n), traffic["noise_bits"], torch.int64,
                       ring.sub_seed(seed, "noise", part), device)
        for wave, part in ((torch.cos, "re"), (torch.sin, "im")))


def build(config: dict, traffic: dict, device: torch.device,
          seed: int) -> ring.Built:
    """The ring of ``sizes`` on ``device``, each slot's frames made there
    from the seed, each slot's call captured (on the card)."""
    from intfftk_tpu_torch import FFTConfig, FFTPairPlan

    size = sizes(config, traffic)
    n, batch = config["n"], traffic["items_per_call"]
    factors = tuple(config["factors"])
    table = spectrum(config)
    pair = FFTPairPlan(FFTConfig(**{k: config[k] for k in CONFIG_KEYS}),
                       table, inverse_mode=config["inverse_mode"],
                       inverse_rounding=config["inverse_rounding"],
                       product_shift=config["product_shift"],
                       spectrum_width=config["spectrum_width"],
                       factors=factors, device=device)
    shape = (batch,) + tuple(pair.fwd.block_in_shape)

    def frames(k):
        return tuple(x.to(pair.fwd.in_dtype).reshape(shape) for x in
                     tone_frames(batch, n, traffic,
                                 ring.sub_seed(seed, "frames", k), device))

    slots = [ring.make_slot(pair.capture, pair, frames(k), device)
             for k in range(size.slots)]

    def check(check_seed: int, control: bool = False) -> ring.Compared:
        picks = ring.draw(check_seed, len(slots), batch,
                          traffic["check_items"])
        xs = [[x.reshape(batch, n)[items] for x in frames(k)]
              for k, items in picks.items()]
        xr, xi = (torch.cat([x[i] for x in xs]) for i in (0, 1))
        cfg, icfg = reference_configs(config)
        args = (cfg, icfg, table, config["product_shift"], factors)
        want = plain.pair(xr, xi, *args)
        if control:
            got = plain.pair(xr, xi, *args, **config["control"])
        else:
            got = [torch.cat([slots[k].outputs[i].reshape(batch, n)[items]
                              for k, items in picks.items()])
                   for i in (0, 1)]
        compared, row = ring.Compared(), 0
        for k, items in picks.items():
            rows = slice(row, row + len(items))
            compared.add(k, [g[rows].cpu().numpy() for g in got],
                         [w[rows].cpu().numpy() for w in want])
            row += len(items)
        return compared

    return ring.Built(slots=slots, sizes=size, check=check)
