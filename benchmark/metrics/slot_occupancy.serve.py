"""Mean share of the slots decoding at a tick (``step()``'s active count over
the slot count), over the window's ticks that dispatched a decode, in %."""


def read(ctx: dict) -> float | None:
    active = [n for _, _, n in ctx.get("ticks") or () if n > 0]
    if not active:
        return None
    return sum(active) / len(active) / ctx["slots"] * 100.0
