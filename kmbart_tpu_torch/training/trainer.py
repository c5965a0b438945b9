"""The epoch loop.

Counterpart of kmbart_tpu/training/trainer.py: per-step train step, ETA log
lines, per-step TensorBoard scalars, a callback after each step, and the
per-epoch train-loss scalar. A background thread collates the next batches
and stages them on the device ``prefetch`` deep (pinned host memory and
non-blocking copies on a CUDA device), so the copy of batch t+1 overlaps
the compute of batch t. The loss is read on the host only at the logging
cadence; the epoch mean is reduced at the end of the epoch.
"""

import queue
import threading
from datetime import datetime

import numpy as np
import torch

from kmbart_tpu_torch.utils.profiling import span


def to_device(batch, device):
    """The array fields of a collated batch as tensors on ``device``
    (integer arrays as int64); other fields (index lists, raw strings) are
    dropped."""
    out = {}
    for key, value in batch.items():
        if not (isinstance(value, np.ndarray) and value.ndim >= 1):
            continue
        t = torch.from_numpy(np.ascontiguousarray(value))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out


def prefetch_to_device(loader, device, depth=4):
    """Yield ``to_device`` batches staged by a background thread, ``depth``
    ahead. An error in the thread is raised in the consumer."""
    q = queue.Queue(maxsize=depth)
    stop = object()
    errs = []

    def worker():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            for b in loader:
                with span("feed.stage"):
                    staged = to_device(b, device)
                q.put(staged)
        except BaseException as e:  # surfaced on the consumer side
            errs.append(e)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with span("feed.wait"):
            item = q.get()
        if item is stop:
            if errs:
                raise errs[0]
            return
        yield item


def run_epoch(epoch, state, train_step, train_loader, seed, *, device, epochs=None,
              logger=None, callback=None, log_interval=1, tb_writer=None, tb_interval=1,
              metric_name="loss", prefetch=4):
    """Run one epoch. Returns (state, mean train loss)."""
    total_step = len(train_loader)
    step_losses = []
    start_time = datetime.now()
    if prefetch:
        batches = prefetch_to_device(train_loader, device, prefetch)
    else:
        batches = (to_device(b, device) for b in train_loader)

    for i, batch in enumerate(batches):
        state, metrics = train_step(state, batch, seed)
        step_losses.append(metrics[metric_name])
        loss = None

        if logger is not None and i % log_interval == 0:
            loss = float(step_losses[-1])
            eta = (total_step - (i + 1)) / (i + 1) * (datetime.now() - start_time)
            logger.info("Epoch [{}/{}], Step [{}/{}], Loss: {:.4f}, ETA: {}".format(
                epoch + 1, epochs if epochs is not None else "?",
                i + 1, total_step, loss, str(eta)))

        if tb_writer is not None and i % tb_interval == 0:
            if loss is None:
                loss = float(step_losses[-1])
            step = epoch * total_step + i + 1
            tb_writer.add_scalars("loss/step", {"total loss": loss}, step)
            for name, value in metrics.items():
                if name != metric_name:
                    tb_writer.add_scalars(
                        "loss/step", {name.replace("_", " "): float(value)}, step)

        if callback is not None:
            callback(step=i, epoch=epoch, state=state, logger=logger)

    total_loss = float(torch.stack(step_losses).sum()) if step_losses else 0.0
    if tb_writer is not None and total_step:
        tb_writer.add_scalars("loss/epoch", {"train": total_loss / total_step}, epoch + 1)
    return state, (total_loss / total_step if total_step else 0.0)
