"""Vehicles x control steps completed over the window's wall seconds."""


def read(run):
    return run["vehicles"] * run["steps"] / run["window_s"]
