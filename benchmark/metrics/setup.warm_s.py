"""setup.warm_s — seconds of set-up spent in the service's ``warmup``,
which captures the cell's graphs (one with ``batch_max`` 1; one per batch
size up to ``batch_max`` otherwise)."""


def read(ctx):
    return ctx["setup"]["warm_s"]
