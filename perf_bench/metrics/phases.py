"""Device time of one phase of a traced replay of a captured train step.

The program counts the nodes its step adds between host-side phase marks
while the graph is captured (``StepProgram.phase_nodes``, handed over by
the driver's ``program_stats()``).  A graph captured from one stream is a
chain, so a replay runs its nodes in capture order: the traced replay's
device operations, sorted by start, are split at those counts.  Where the
trace holds another number of operations than the graph's nodes, the split
cannot be placed and nothing is reported."""


def phase_ms(ctx, name: str):
    p, tr = ctx["program"], ctx["trace"]
    nodes = p.get("phase_nodes") or {}
    if name not in nodes or not tr.ops or tr.units != 1 or len(tr.ops) != p.get("graph_nodes"):
        return None
    start = 0
    for k, n in nodes.items():
        if k == name:
            break
        start += n
    ops = sorted(tr.ops, key=lambda op: op[1])[start : start + nodes[name]]
    return sum(d for _, _, d in ops) / 1e3
