"""Device ms of one call's replay of the per-frame graph: the kernels of
the traced calls (not the frame's upload and the output's readback), a
call."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.ops:
        return None
    return tr.device_s(lambda n: not n.startswith("Memcpy")) / tr.units * 1e3
