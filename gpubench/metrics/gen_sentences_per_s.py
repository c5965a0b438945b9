"""Rows whose generate() call completed in the window, over the window from
its start to the end of the last such call."""


def read(run):
    return run.window["rows"] / run.window["seconds"]
