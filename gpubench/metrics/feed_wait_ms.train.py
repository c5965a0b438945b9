"""Host milliseconds a step spent waiting for the next batch from the feed
(training/trainer.py prefetch_to_device), over the window."""


def read(run):
    if "feed_wait_s" not in run.window or not run.window["units"]:
        return None
    return 1e3 * run.window["feed_wait_s"] / run.window["units"]
