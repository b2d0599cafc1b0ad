"""``inverse_pass_roofline`` (%): the inverse factor pass's share of its
roofline.  The frozen count's bound for the call's inverse transforms
(``ring.Sizes.work["inverse_pass"]``) over the device ms per call of the
``fused_pass_kernel`` instances whose ``kInverse`` template argument, the
fourth, is ``true``, selected by name from the trace."""

KERNEL = "fused_pass_kernel<"


def template_args(name: str):
    """The template arguments of the first ``fused_pass_kernel<...>`` in a
    kernel's name, split at the commas outside any nested brackets, or
    None where the name holds none."""
    at = name.find(KERNEL)
    if at < 0:
        return None
    args, part, depth = [], [], 0
    for ch in name[at + len(KERNEL):]:
        if ch == ">" and depth == 0:
            return args + ["".join(part).strip()]
        if ch == "," and depth == 0:
            args.append("".join(part).strip())
            part = []
            continue
        depth += (ch in "<([") - (ch in ">)]")
        part.append(ch)
    return None


def inverse(name: str) -> bool:
    args = template_args(name)
    return args is not None and len(args) > 3 and args[3] == "true"


def read(ctx):
    seconds = ctx.trace.seconds_where(inverse)
    work = ctx.work.get("inverse_pass")
    if not seconds or work is None:
        return None
    return 100.0 * work.bound_ms() / (seconds * 1e3 / ctx.calls)
