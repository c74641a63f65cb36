"""Device operations of one train-step replay."""


def read(ctx):
    tr = ctx["trace"]
    return tr.count() / tr.units if tr.ops else None
