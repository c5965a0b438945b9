"""Validation loops.

Counterpart of kmbart_tpu/training/validation.py: the validation loss
loop with ETA logging, and the generation-score validation that decodes
the eval split and scores BLEU-2, METEOR and CIDEr against the reference.
"""

from datetime import datetime

from kmbart_tpu_torch.eval.metrics import compute_metric_inference
from kmbart_tpu_torch.generation.driver import generate_text
from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.training.trainer import to_device


def validate_loss(epoch, model, eval_step, val_loader, *, device, logger=None,
                  log_interval=1, tb_writer=None, tag="val"):
    """Mean of the per-batch losses over the batches the loader yielded
    (not ``len(val_loader)``, which may count a batch the loader skips).
    Under data parallelism each rank's loader yields its share of every
    global batch and ``eval_step`` (``build_eval_step`` with a ``grid``)
    returns the global batch's loss, its sums and counts
    all-reduced over the data axis, so every rank averages the same
    numbers; under tensor and pipeline parallelism the ranks of a data
    coordinate load the same rows and run their parts of one forward
    (the pipelined loss under ``--pipeline_stages``)."""
    total_step = len(val_loader)
    loss = 0.0
    steps = 0
    start_time = datetime.now()
    for i, batch in enumerate(val_loader):
        metrics = eval_step(model, to_device(batch, device))
        loss += float(metrics["loss"])
        steps += 1
        if logger is not None and i % log_interval == 0:
            eta = (total_step - (i + 1)) / (i + 1) * (datetime.now() - start_time)
            logger.info("Computing validation loss, Step [{}/{}], Loss: {:.4f}, ETA: {}".format(
                i + 1, total_step, loss / (i + 1), str(eta)))
    loss /= max(steps, 1)
    if logger is not None:
        logger.info("Validation loss", pad=True)
        logger.info("Epoch: {}, Val loss: {}".format(epoch + 1, loss))
        logger.line()
    if tb_writer is not None:
        tb_writer.add_scalars("loss/epoch", {tag: loss}, epoch + 1)
    return loss


def validate_generation_score(epoch, model, cfg, gen_loader, reference, tokenizer, args, *,
                              logger=None, log_interval=1, tb_writer=None, grid=None):
    """Decode the eval split with the port and score it. Under a process
    grid (``grid``, without pipeline stages) every rank decodes on its part
    of the model and rank 0 scores; the other ranks return None."""
    generated = generate_text(model, cfg, gen_loader, tokenizer, args, logger=logger,
                              log_interval=log_interval, grid=grid)
    if not distributed.is_main_process():
        return None
    scores = compute_metric_inference(gens_list=generated, refs_list=reference)
    if logger is not None:
        logger.info("Validation scores", pad=True)
        logger.info("Epoch: {}, BLEU2: {}, METEOR: {}, CIDEr: {}".format(
            epoch + 1, scores.get("BLEU2"), scores.get("METEOR"), scores.get("CIDEr")))
        logger.line()
    if tb_writer is not None:
        for k, v in scores.items():
            tb_writer.add_scalar("score/{}".format(k), v, epoch + 1)
    return scores
