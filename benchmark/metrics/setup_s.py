"""Seconds from process start to the first timed step."""


def read(run):
    return run["setup_s"]
