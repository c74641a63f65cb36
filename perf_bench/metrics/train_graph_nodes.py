"""Nodes of the train step's graph (StepProgram.graph_nodes of the
TrainProgram): the device operations of one replay, as the program counts
them."""

from perf_bench.metrics import spans


def read(ctx):
    return spans.graph_nodes(ctx)
