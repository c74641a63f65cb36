"""Seconds of the train program's warm-up step and of its capture with the
graph's instantiation (programs.StepProgram.warmup_s + capture_s)."""


def read(ctx):
    p = ctx["program"]
    return p["warmup_s"] + p["capture_s"] if "capture_s" in p else None
