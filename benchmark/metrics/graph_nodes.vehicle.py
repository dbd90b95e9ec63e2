"""Nodes of the cell's captured control step (cuGraphGetNodes)."""


def read(run):
    return run.get("graph_nodes")
