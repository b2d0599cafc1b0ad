"""Builder ``channelizer``: a bank of independent channels through
``Channelizer``, one call a bank: every channel's n-point forward
transform of the integer FFT core in one launch of the factor pass.

Configuration keys: ``n``, ``channels`` (the bank's C), ``direction``
("forward"), ``mode``, ``rounding``, ``data_width``, ``twiddle_width``,
``twiddle_gen``, and ``control``: the keys that the control, the
reference one step below the stated precision, changes.  Traffic keys:
``layout`` ("cn": int32 [C, n], a channel's samples contiguous; "nc":
int32 [n, C], a time step holding every channel), ``items_per_call`` (the
channels of a call: the bank's C), ``amplitude_bits`` (each sample
uniform in +-2^(bits-1)), ``ring_bytes``, ``check_items`` (channels).

A call counts C x n samples.  Its answer for channel c is the plain
PyTorch reference's transform of channel c
(``benchmark/plain/channelizer.py``), which the check computes on the
card.
"""

from __future__ import annotations

import torch

from benchmark import count, ring
from benchmark.builders.core_fft import CONFIG_KEYS, reference_config
from benchmark.plain import channelizer as plain

#: the container of the Channelizer's inputs and outputs, in bytes
INT32 = 4


def sizes(config: dict, traffic: dict) -> ring.Sizes:
    """Samples, slot bytes, slots and work, from the files alone."""
    if config["direction"] != "forward":
        raise ValueError(f"channelizer runs forward transforms, not "
                         f"{config['direction']!r}")
    if traffic["layout"] not in plain.LAYOUTS:
        raise ValueError(f"bad layout {traffic['layout']!r}")
    n, chans = config["n"], traffic["items_per_call"]
    if chans != config["channels"]:
        raise ValueError(f"a call is the bank of {config['channels']} "
                         f"channels, not {chans}")
    cfg = reference_config(config)
    if traffic["amplitude_bits"] > cfg.data_width:
        raise ValueError("samples wider than the configuration's data")
    if cfg.output_width > 8 * INT32:
        raise ValueError(f"{cfg.output_width}-bit outputs do not fit the "
                         f"channelizer's int32")
    samples = chans * n
    slot_bytes = samples * 2 * (INT32 + INT32)
    # log2(n) stages and no inter-factor twiddle; bytes at the widths'
    # containers, as the frozen count's rule has them
    work = count.Work(samples * count.stages(n) * count.OPS_PER_SAMPLE_STAGE,
                      samples * 2 * (count.container(cfg.data_width)
                                     + count.container(cfg.output_width)))
    return ring.Sizes(samples_per_call=samples, slot_bytes=slot_bytes,
                      slots=count.ring_slots(slot_bytes,
                                             traffic["ring_bytes"]),
                      work={"pass": work})


def build(config: dict, traffic: dict, device: torch.device,
          seed: int) -> ring.Built:
    """The ring of ``sizes`` on ``device``, each slot's bank made there
    from the seed, each slot's call captured (on the card)."""
    from intfftk_tpu_torch import FFTConfig
    from intfftk_tpu_torch.parallel import Channelizer

    size = sizes(config, traffic)
    n, chans, layout = config["n"], traffic["items_per_call"], \
        traffic["layout"]
    chz = Channelizer(FFTConfig(**{k: config[k] for k in CONFIG_KEYS}),
                      layout=layout, device=device)
    shape, axis = ((chans, n), 0) if layout == "cn" else ((n, chans), 1)

    def frames(k):
        return tuple(ring.uniform(shape, traffic["amplitude_bits"],
                                  torch.int32,
                                  ring.sub_seed(seed, "frames", k, part),
                                  device) for part in ("re", "im"))

    slots = [ring.make_slot(chz.capture, chz, frames(k), device)
             for k in range(size.slots)]

    def pick(t, items):
        """Channels ``items`` of a bank, in the cell's layout."""
        return t.index_select(axis, torch.as_tensor(items, device=t.device))

    def rows(t):
        """Channels as rows, [channels, n], on the host."""
        return (t if layout == "cn" else t.t()).cpu().numpy()

    def check(check_seed: int, control: bool = False) -> ring.Compared:
        picks = ring.draw(check_seed, len(slots), chans,
                          traffic["check_items"])
        xs = [[pick(x, items) for x in frames(k)]
              for k, items in picks.items()]
        xr, xi = (torch.cat([x[i] for x in xs], axis) for i in (0, 1))
        want = plain.channelize(xr, xi, reference_config(config), layout)
        if control:
            got = plain.channelize(xr, xi,
                                   reference_config(config, control=True),
                                   layout)
        else:
            got = [torch.cat([pick(slots[k].outputs[i], items)
                              for k, items in picks.items()], axis)
                   for i in (0, 1)]
        got, want = [rows(g) for g in got], [rows(w) for w in want]
        compared, row = ring.Compared(), 0
        for k, items in picks.items():
            sel = slice(row, row + len(items))
            compared.add(k, [g[sel] for g in got], [w[sel] for w in want])
            row += len(items)
        return compared

    return ring.Built(slots=slots, sizes=size, check=check)
