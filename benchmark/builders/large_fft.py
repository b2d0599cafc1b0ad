"""Builder ``large_fft``: forward transforms beyond the core's 512K as the
reference's 2-D scheme, through ``LargeFFTPlan``'s captured call on
blocks: pass 1 (the column transforms and the inter-factor twiddle, from
the plan's own source, ``epi_synth="auto"``), then pass 2 (the row
transforms).

Configuration and traffic keys as ``core_fft``'s: ``n``, ``factors`` ([n1,
n2]: the blocks are [B, n1, n2] in natural order), ``direction``
("forward"), ``mode``, ``rounding``, ``data_width``, ``twiddle_width``,
``twiddle_gen``, ``control``; ``items_per_call`` (the batch B),
``amplitude_bits``, ``ring_bytes``, ``check_items``.

A call counts B x n samples.  Its answer for frame b is the plain PyTorch
four-step of frame b on the factors (n1, n2)
(``benchmark/plain/four_step.py``, ``four_step_int``'s numerics), which
the check computes on the card, one slot's frames at a time.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import count, ring
from benchmark.builders.core_fft import CONFIG_KEYS, reference_config
from benchmark.builders.core_fft import sizes as core_sizes
from benchmark.plain.four_step import four_step_blocked
from benchmark.plain.pair import output_width


def sizes(config: dict, traffic: dict) -> ring.Sizes:
    """``core_fft``'s sizes, and the work of pass 1 of the call's
    transforms, ``work["epilogue_pass"]``: log2(n1) stages and the
    inter-factor twiddle on every sample, its input read and its output
    written at their widths' containers (no table bytes, so the same
    whatever supplies the twiddle)."""
    size = core_sizes(config, traffic)
    n1, _ = config["factors"]
    cfg = reference_config(config)
    samples = size.samples_per_call
    in_size = count.container(cfg.data_width)
    mid_size = count.container(output_width(cfg, n1, cfg.data_width))
    epilogue = count.Work(
        samples * (count.stages(n1) + 1) * count.OPS_PER_SAMPLE_STAGE,
        samples * 2 * (in_size + mid_size))
    return dataclasses.replace(size, work=dict(size.work,
                                               epilogue_pass=epilogue))


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
        cfg = reference_config(config)
        compared = ring.Compared()
        for k, items in picks.items():
            rows = torch.as_tensor(items, device=device)
            xr, xi = (x.reshape(batch, n)[rows] for x in frames(k))
            want = four_step_blocked(xr, xi, cfg, n1, n2)
            if control:
                got = four_step_blocked(
                    xr, xi, reference_config(config, control=True), n1, n2)
            else:
                got = [y.reshape(batch, n)[rows]
                       for y in slots[k].outputs]
            compared.add(k, [g.cpu().numpy() for g in got],
                         [w.cpu().numpy() for w in want])
        return compared

    return ring.Built(slots=slots, sizes=size, check=check)
