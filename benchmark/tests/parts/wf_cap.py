"""A part for the tests: gives the server a waterfall capacity of the
configuration's ``wf_cap`` (a keyword argument of ``KiwiServer``), and
reports the capacity the server took and the sampled blocks it saw."""

NUMBERS = ("wf_cap_seen", "wf_cap_samples")


def build(ctx):
    ctx["wf_cap_samples"] = []
    return {"wf_chans": int(ctx["cfg"]["wf_cap"])}


def snapshot(ctx, n):
    ctx["wf_cap_samples"].append(n)


def numbers(ctx):
    return {"wf_cap_seen": float(ctx["server"].wf.capacity),
            "wf_cap_samples": float(len(ctx["wf_cap_samples"]))}
