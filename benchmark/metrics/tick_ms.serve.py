"""Mean host time of a scheduler tick that dispatched a decode chunk (the
harness's span around each ``ServingEngine.step()`` that returned active
slots), over the window, in ms."""


def read(ctx: dict) -> float | None:
    busy = [b - a for a, b, n in ctx.get("ticks") or () if n > 0]
    if not busy:
        return None
    return sum(busy) / len(busy) * 1e3
