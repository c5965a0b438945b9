"""Rows of the training steps taken in the window, over the window from its
start to the synchronise after the last step."""


def read(run):
    return run.window["rows"] / run.window["seconds"]
