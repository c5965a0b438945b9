"""Host milliseconds a step inside the optimizer's update
(training/adamw.py AdamW.update), over the window of a ``--trace 1`` run."""

HOST = {"optimizer": "kmbart_tpu_torch.training.adamw:AdamW.update"}


def read(run):
    if "optimizer" not in run.host:
        return None
    seconds, calls = run.host["optimizer"]
    return 1e3 * seconds / calls if calls else None
