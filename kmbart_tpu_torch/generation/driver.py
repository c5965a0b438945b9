"""Batch generation driver.

Counterpart of kmbart_tpu/generation/driver.py (the reference's
``generate_text``): loop over the loader, generate with the CLI's
settings, decode with skip_special_tokens, and group ``num_gen`` outputs
per input row into ``[{index, task_type, generations}]``. Sampling draws
from ``generator`` across the whole run. Under a process grid (``grid``)
every rank decodes its part of each batch and returns the same list.
"""

from datetime import datetime

from kmbart_tpu_torch.generation.api import generate


def generate_text(model, cfg, gen_loader, tokenizer, args, *, logger=None,
                  log_interval=1, generator=None, grid=None):
    total_step = len(gen_loader)
    generated = []
    start_time = datetime.now()
    num_gen = getattr(args, "num_gen", 1)
    for i, batch in enumerate(gen_loader):
        outputs = generate(
            model, cfg,
            {"input_ids": batch["input_ids"],
             "attention_mask": batch.get("attention_mask"),
             "image_features": batch.get("image_features")},
            num_beams=getattr(args, "num_beams", 1),
            num_return_sequences=num_gen,
            do_sample=getattr(args, "do_sample", False),
            top_p=getattr(args, "top_p", 1.0),
            top_k=getattr(args, "top_k", 0),
            temperature=getattr(args, "temperature", None),
            max_length=getattr(args, "max_length", None),
            early_stopping=True, generator=generator, grid=grid)
        for j in range(len(batch["index"])):
            generated.append({
                "index": batch["index"][j],
                "task_type": batch["task_type"][j],
                "generations": [tokenizer.decode(outputs[j * num_gen + k],
                                                 skip_special_tokens=True)
                                for k in range(num_gen)],
            })
        if logger is not None and (i + 1) % log_interval == 0:
            eta = (total_step - (i + 1)) / (i + 1) * (datetime.now() - start_time)
            logger.info("Generating, Step [{}/{}], ETA: {}".format(
                i + 1, total_step, str(eta)))
    return generated
