"""A part for the tests: once the window's first sampled block has run,
the engine's ``retune_all(adc_clock * (1 + retune_ppm * 1e-6))`` runs on
the event loop, as the GPS receiver's clock correction does.  Its
numbers count the sampled blocks dispatched before the retune was
entered and after it returned."""

NUMBERS = ("sampled_before", "sampled_after")


def build(ctx):
    ctx["retune_sampled"] = []
    return {}


def snapshot(ctx, n):
    sampled = ctx["retune_sampled"]
    sampled.append(n)
    if n > 0 and sum(1 for b in sampled if b > 0) == 1:
        eng = ctx["engine"]
        clock = eng.params.adc_clock * (1 + ctx["cfg"]["retune_ppm"] * 1e-6)
        ctx["loop"].call_soon_threadsafe(eng.retune_all, clock)


def numbers(ctx):
    retunes = ctx["probes"].retunes
    if len(retunes) != 1:
        return {}                       # the probes saw no retune
    (_clock, a, b, _t0, _t1), = retunes
    sampled = [n for n in ctx["retune_sampled"] if n > 0]
    return {"sampled_before": float(sum(n < a for n in sampled)),
            "sampled_after": float(sum(n > b for n in sampled))}
