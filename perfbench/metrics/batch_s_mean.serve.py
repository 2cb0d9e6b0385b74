"""batch_s_mean.serve: the server's batch seconds over its batches
(``ServerStats``): a batch's service time through the pipeline, without
the time its requests queued."""


def read(ctx):
    s = ctx["record"].get("server")
    return s["batch_seconds"] / s["batches"] if s and s["batches"] else None
