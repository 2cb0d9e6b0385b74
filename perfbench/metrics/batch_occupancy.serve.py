"""batch_occupancy.serve: requests over the batch slots run (requests plus
the ladder's padding), in %, from the server's own counters
(``ServerStats``) over every batch of the window and its drain."""


def read(ctx):
    s = ctx["record"].get("server")
    slots = s["requests"] + s["padded_slots"] if s else 0
    return 100.0 * s["requests"] / slots if slots else None
