"""img_per_s: images completed in the window over the window, which ends
when the last call of the closed loop returns. Host clock."""


def read(ctx):
    rec = ctx["record"]
    return rec["images"] / rec["window_s"] if rec.get("window_s") else None
