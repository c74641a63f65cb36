"""Device operations a process_frame call (the replay's kernels, the
upload and the readback)."""


def read(ctx):
    tr = ctx["trace"]
    return tr.count() / tr.units if tr.ops else None
