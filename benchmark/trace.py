"""The traced window: ``torch.profiler`` around the same replays of the
ring as the measured window, reduced to device time by kernel name, the
device's busy time and idle gaps, and what the host was doing in each gap.
"""

from __future__ import annotations

import dataclasses

from . import window

#: device activities that are no work of the card's: the profiler's own
#: annotations, which span the window
NOT_WORK = ("annotation",)


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass(frozen=True)
class Trace:
    """The device's activities and the host's, in ns of one clock."""

    device: tuple
    host: tuple

    @property
    def window_s(self) -> float:
        """From the first device activity's start to the last one's end."""
        if not self.device:
            return 0.0
        return (max(s.end_ns for s in self.device)
                - min(s.start_ns for s in self.device)) / 1e9

    def _merged(self):
        """The device's busy intervals, overlaps merged, in order."""
        out = []
        for s in sorted(self.device, key=lambda s: s.start_ns):
            if out and s.start_ns <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s.end_ns)
            else:
                out.append([s.start_ns, s.end_ns])
        return out

    @property
    def busy_s(self) -> float:
        """Seconds in which some activity ran on the device."""
        return sum(b - a for a, b in self._merged()) / 1e9

    def seconds_by_name(self) -> dict:
        """Device seconds of each activity's name, largest first."""
        total = {}
        for s in self.device:
            total[s.name] = total.get(s.name, 0.0) + (s.end_ns
                                                      - s.start_ns) / 1e9
        return dict(sorted(total.items(), key=lambda kv: -kv[1]))

    def seconds_where(self, keep) -> float:
        """Device seconds of the activities whose name ``keep`` accepts."""
        return sum(s.end_ns - s.start_ns for s in self.device
                   if keep(s.name)) / 1e9

    def idle_gaps(self, top: int = 10) -> list:
        """The ``top`` longest gaps between device activities, each as
        [what the host was doing at its middle, seconds]: the innermost
        host activity around that instant."""
        merged = self._merged()
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(merged, merged[1:])),
                      reverse=True)[:top]
        out = []
        for length, a, b in gaps:
            mid = (a + b) // 2
            around = [s for s in self.host if s.start_ns <= mid < s.end_ns]
            what = (min(around, key=lambda s: s.end_ns - s.start_ns).name
                    if around else "no host activity traced")
            out.append([f"host: {what}", length / 1e9])
        return out

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[name, s] for name, s in
                               list(self.seconds_by_name().items())[:top]],
                "idle_gaps": self.idle_gaps(top)}


def _flag(event, name: str, default):
    """``event.<name>()`` where this torch's events have it."""
    method = getattr(event, name, None)
    return method() if method is not None else default


def from_kineto(events) -> Trace:
    """A ``Trace`` of the profiler's raw events."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        span = Span(e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if not (_flag(e, "is_user_annotation", False)
                    or any(w in _flag(e, "activity_type", "")
                           for w in NOT_WORK)):
                device.append(span)
        else:
            host.append(span)
    return Trace(tuple(device), tuple(host))


def traced(slots, device, calls: int):
    """(``Trace``, ``window.Window``) of ``calls`` calls of the ring, replayed
    as the measured window replays them, under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        win = window.run(slots, device, calls=calls)
    return from_kineto(prof.profiler.kineto_results.events()), win
