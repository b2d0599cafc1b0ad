"""Builder ``core_fft``: batches of forward n-point transforms of the
integer FFT core on blocks, through ``LargeFFTPlan.apply_blocks``.

Configuration keys: ``n``, ``factors`` ([n1, n2]: the blocks are
[B, n1, n2] and natural order, so a block is its flat frame reshaped),
``direction`` ("forward"), ``mode``, ``rounding``, ``data_width``,
``twiddle_width``, ``twiddle_gen``, and ``control``: the keys that the
control, the reference one step below the stated precision, changes.
Traffic keys: ``items_per_call`` (the batch B), ``amplitude_bits`` (each
sample uniform in +-2^(bits-1)), ``ring_bytes``, ``check_items``.

A call counts B x n samples.  Its answer for frame b is the golden
``four_step_int`` of frame b on the factors (n1, n2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import count, reference, ring


#: the configuration keys that are ``FFTConfig``'s fields
CONFIG_KEYS = ("n", "mode", "rounding", "data_width", "twiddle_width",
               "twiddle_gen")


def reference_config(config: dict, control: bool = False):
    """The configuration as the frozen reference's ``FFTConfig``; with
    ``control``, the control's."""
    cfg = reference.FFTConfig(**{k: config[k] for k in CONFIG_KEYS})
    return dataclasses.replace(cfg, **config["control"]) if control else cfg


def sizes(config: dict, traffic: dict) -> ring.Sizes:
    """Samples, slot bytes, slots and work, from the files alone."""
    if config["direction"] != "forward":
        raise ValueError(f"core_fft runs forward transforms, not "
                         f"{config['direction']!r}")
    n, batch = config["n"], traffic["items_per_call"]
    n1, n2 = config["factors"]
    if n1 * n2 != n:
        raise ValueError(f"factors {n1} x {n2} are not n = {n}")
    cfg = reference_config(config)
    if traffic["amplitude_bits"] > cfg.data_width:
        raise ValueError("samples wider than the configuration's data")
    in_size = count.container(cfg.data_width)
    out_size = count.container(cfg.output_width)
    slot_bytes = batch * n * 2 * (in_size + out_size)
    return ring.Sizes(samples_per_call=batch * n, slot_bytes=slot_bytes,
                      slots=count.ring_slots(slot_bytes,
                                             traffic["ring_bytes"]),
                      work={"pass": count.four_step(n, batch, in_size,
                                                    out_size)})


def build(config: dict, traffic: dict, device: torch.device,
          seed: int) -> ring.Built:
    """The ring of ``sizes`` on ``device``, each slot's frames made there
    from the seed, each slot's call captured (on the card)."""
    from intfftk_tpu_torch import FFTConfig, LargeFFTPlan

    size = sizes(config, traffic)
    n, batch, bits = config["n"], traffic["items_per_call"], \
        traffic["amplitude_bits"]
    n1, n2 = config["factors"]
    plan = LargeFFTPlan(FFTConfig(**{k: config[k] for k in CONFIG_KEYS}),
                        n1, n2, device=device)
    shape = (batch,) + tuple(plan.block_in_shape)

    def frames(k):
        return tuple(ring.uniform(shape, bits, plan.in_dtype,
                                  ring.sub_seed(seed, "frames", k, part),
                                  device) for part in ("re", "im"))

    slots = [ring.make_slot(plan.capture, plan.apply_blocks, frames(k),
                            device) for k in range(size.slots)]

    def check(check_seed: int, control: bool = False) -> ring.Compared:
        picks = ring.draw(check_seed, len(slots), batch,
                          traffic["check_items"])
        xs = [[t.reshape(batch, n)[items].cpu().numpy().astype(np.int64)
               for t in frames(k)] for k, items in picks.items()]
        xr, xi = (np.concatenate([x[i] for x in xs]) for i in (0, 1))
        want = reference.four_step_int(xr, xi, reference_config(config),
                                       n1, n2)
        if control:
            got = reference.four_step_int(
                xr, xi, reference_config(config, control=True), n1, n2)
        else:
            got = [np.concatenate([
                slots[k].outputs[i].reshape(batch, n)[items].cpu().numpy()
                for k, items in picks.items()]) for i in (0, 1)]
        compared, row = ring.Compared(), 0
        for k, items in picks.items():
            rows = slice(row, row + len(items))
            compared.add(k, [g[rows] for g in got], [w[rows] for w in want])
            row += len(items)
        return compared

    return ring.Built(slots=slots, sizes=size, check=check)
