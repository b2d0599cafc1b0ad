"""``epilogue_pass_roofline`` (%): pass 1 of a four-step forward call, the
factor pass with the inter-factor twiddle epilogue and the turned natural
store, as a share of its roofline.  The frozen count's bound for pass 1 of
the call's transforms (``ring.Sizes.work["epilogue_pass"]``) over the
device ms per call of the ``fused_pass_kernel`` instance whose ``kSkew``
template argument, the eighth, is ``true``, selected by name from the
trace with ``inverse_pass_roofline``'s parser of template arguments.

None where no instance, or more than one distinct instance, matches: a
change that moves the skewed tile to another pass, or to none, reads null
and not a share of the wrong kernel."""

from pathlib import Path

from benchmark import manifest

_parser = manifest.load_module(
    Path(__file__).resolve().parent / "inverse_pass_roofline.py",
    "benchmark_metric_inverse_pass_roofline")


def skewed(name: str) -> bool:
    args = _parser.template_args(name)
    return args is not None and len(args) > 7 and args[7] == "true"


def read(ctx):
    work = ctx.work.get("epilogue_pass")
    names = {s.name for s in ctx.trace.device if skewed(s.name)}
    if work is None or len(names) != 1:
        return None
    (name,) = names
    seconds = ctx.trace.seconds_where(lambda n: n == name)
    if not seconds:
        return None
    return 100.0 * work.bound_ms() / (seconds * 1e3 / ctx.calls)
