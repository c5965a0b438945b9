"""Pipeline parallelism: the GPipe schedule over the grid's stage axis.

Counterpart of kmbart_tpu/parallel/pp.py. There one ``lax.scan`` over
M + S - 1 ticks inside a ``shard_map`` runs every stage, with a
``ppermute`` ring shift a tick, and ``jax.grad`` replays the ring in
reverse. Eager PyTorch has no such transpose, so each stack's pipeline is
one autograd function (``_Pipeline``) that runs the schedule itself:

- forward: stage s takes micro-batch m (from the stack input on stage 0,
  else as a [mb, T, D] point-to-point receive from stage s - 1), runs its
  layers on it and sends the result on; the last stage gathers the M
  outputs and broadcasts them to every stage, as the JAX package's final
  psum does. Each micro-batch's graph is kept (or, under ``cfg.remat``,
  only its input, and the layers run again in the backward);
- backward: the same ring in reverse: stage s receives the gradient of each
  micro-batch's output from stage s + 1 (the last stage takes it from its
  own replicated consumers), back-propagates its layers, and sends the
  input's gradient to stage s - 1; stage 0 broadcasts the stack input's
  gradient to every stage.

So every part of the model outside the layer stacks runs whole on every
stage, and its gradients are whole there: the embeddings (their input's
gradient is broadcast from stage 0), the LM head and the pretraining heads
(on the broadcast decoder output, each stage computing the same
gradient). The encoder output feeds every stage's cross-attention, so its
gradient is summed over the stages (``copy_to`` over the stage axis) before
it reaches the encoder pipeline. The tied shared embedding thus takes the
lookup's gradient once and the LM head's once.

Layer weights live only on their stage: ``parallel/tp.py shard_model_``
keeps stage s's layers, under their global indices. Tensor parallelism
composes inside each stage (the model axis innermost, parallel/mesh.py).
Dropout inside a layer draws from a generator of its own per (layer,
micro-batch), as the JAX package folds its key, so its masks differ from
the sequential path's; with dropout off the forward equals it. LayerDrop,
layer counts the stage count does not divide and batches the micro-batch
count does not divide are refused (pp.py:211-216, 320-329). A CUDA tensor's
send, receive and broadcast go through the host under gloo
(parallel/distributed.py), never under NCCL.
"""

import torch

from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.parallel.tp import copy_to


def stage_layers(stack, cfg, grid, encoder):
    """[(global index, layer)] of this stage's layers of ``stack``, from a
    model cut by ``shard_model_`` or from a whole one."""
    layers = stack.layers
    if isinstance(layers, torch.nn.ModuleDict):
        return [(int(k), layer) for k, layer in layers.items()]
    per = (cfg.encoder_layers if encoder else cfg.decoder_layers) // grid.stage.size
    first = grid.coords[1] * per
    return [(i, layers[i]) for i in range(first, first + per)]


def _layer_generator(generator, salt, layer, micro):
    if generator is None:
        return None
    from kmbart_tpu_torch.parallel.train_step import step_seed
    seed = step_seed(generator.initial_seed(), salt * 4096 + layer, micro)
    return torch.Generator(device=generator.device).manual_seed(seed)


class _Schedule:
    """One stack's GPipe schedule on this rank. ``run(x_mb, side_mb, m)``
    applies this stage's layers to micro-batch m; ``side`` are the
    differentiable inputs every micro-batch slices (the encoder output for
    the decoder)."""

    def __init__(self, grid, run, n_micro, remat, grad):
        self.stage, self.run, self.M = grid.stage, run, n_micro
        self.remat, self.grad = remat, grad
        s = self.stage.index
        self.prev = self.stage.ranks[s - 1] if s > 0 else None
        self.next = self.stage.ranks[s + 1] if s < self.stage.size - 1 else None

    def forward(self, x, side):
        mb = x.shape[0] // self.M
        shape = (mb,) + tuple(x.shape[1:])
        self.shape, self.dtype, self.side = shape, x.dtype, [t.shape for t in side]
        self.saved, outs = [], []
        for m in range(self.M):
            if self.prev is None:
                inp = x[m * mb:(m + 1) * mb]
            else:
                inp = distributed.recv(shape, x.dtype, x.device, self.prev)
            side_m = [t[m * mb:(m + 1) * mb] for t in side]
            if self.grad and not self.remat:
                inp = inp.detach().requires_grad_(True)
                side_m = [t.detach().requires_grad_(True) for t in side_m]
                with torch.enable_grad():
                    h = self.run(inp, side_m, m)
                self.saved.append((inp, side_m, h))
            else:
                with torch.no_grad():
                    h = self.run(inp, side_m, m)
                if self.grad:
                    self.saved.append((inp.detach(), [t.detach() for t in side_m], None))
            if self.next is not None:
                distributed.send(h.detach(), self.next)
            else:
                outs.append(h.detach())
        out = torch.cat(outs) if self.next is None else torch.empty_like(x)
        return distributed.broadcast(out, self.stage.size - 1, self.stage)

    def backward(self, g):
        mb = self.shape[0]
        gx = []
        gside = [torch.zeros(shape, dtype=self.dtype, device=g.device) for shape in self.side]
        for m in range(self.M):
            inp, side_m, h = self.saved[m]
            if h is None:
                inp = inp.requires_grad_(True)
                side_m = [t.requires_grad_(True) for t in side_m]
                with torch.enable_grad():
                    h = self.run(inp, side_m, m)
            if self.next is None:
                gh = g[m * mb:(m + 1) * mb]
            else:
                gh = distributed.recv(self.shape, h.dtype, g.device, self.next)
            torch.autograd.backward(h, gh.to(h.dtype))
            gin = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if self.prev is not None:
                distributed.send(gin, self.prev)
            else:
                gx.append(gin)
            for j, t in enumerate(side_m):
                if t.grad is not None:
                    gside[j][m * mb:(m + 1) * mb] = t.grad
            self.saved[m] = None
        self.saved = None
        out = (torch.cat(gx) if self.prev is None else
               torch.empty((mb * self.M,) + self.shape[1:], dtype=self.dtype, device=g.device))
        return distributed.broadcast(out, 0, self.stage), gside


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule, x, *side):
        ctx.schedule = schedule
        return schedule.forward(x, side)

    @staticmethod
    def backward(ctx, g):
        gx, gside = ctx.schedule.backward(g)
        ctx.schedule = None
        return (None, gx, *gside)


def _pipeline(grid, run, x, side, n_micro, remat, params):
    grad = torch.is_grad_enabled() and any(p.requires_grad for p in params)
    schedule = _Schedule(grid, run, n_micro, remat, grad)
    return _Pipeline.apply(schedule, x, *side)


def check_pipeline(cfg, grid, batch_rows, n_micro, train):
    """The refusals of kmbart_tpu/parallel/pp.py:211-216 and 320-329."""
    S = grid.stage.size
    if train and (cfg.encoder_layerdrop or cfg.decoder_layerdrop):
        raise ValueError("pipeline parallelism does not support LayerDrop")
    if cfg.encoder_layers % S or cfg.decoder_layers % S:
        raise ValueError(
            f"encoder/decoder layer counts ({cfg.encoder_layers}/"
            f"{cfg.decoder_layers}) must divide the stage count {S}")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    if batch_rows % n_micro:
        raise ValueError(f"batch {batch_rows * grid.data.size} not divisible by "
                         f"n_micro={n_micro} x data shards={grid.data.size}")


def pipelined_forward(trunk, cfg, batch, grid, *, n_micro, train=False, generator=None):
    """Trunk forward (``bart.forward`` semantics) with both layer stacks
    pipelined over the grid's stage axis, and tensor parallel inside each
    stage when the grid has a model axis. ``trunk`` is the model's
    ``MultiModalBartModel`` (this rank's part of it, or the whole).
    Returns (dec, enc) hidden, whole on every stage."""
    check_pipeline(cfg, grid, batch["input_ids"].shape[0], n_micro, train)
    dtype = bart.compute_dtype(cfg)
    tp = grid.tp
    attention_mask = batch.get("attention_mask")
    dec_mask = batch.get("decoder_attention_mask")
    mb = batch["input_ids"].shape[0] // n_micro
    params = list(trunk.parameters())

    def rows(t, m):
        return None if t is None else t[m * mb:(m + 1) * mb]

    def layer_context(salt, li, m, length):
        gen = _layer_generator(generator, salt, li, m) if train else None
        return gen, (None if tp is None else tp.stack(length, gen, salt))

    enc_layers = stage_layers(trunk.encoder, cfg, grid, encoder=True)

    def run_encoder(h, side, m):
        for li, layer in enc_layers:
            gen, stack = layer_context(1, li, m, h.shape[1])
            h = bart._encoder_layer(h, layer, rows(attention_mask, m), cfg, dtype, train, gen,
                                    stack)
        return h

    x = bart._encoder_embed(trunk, cfg, batch["input_ids"], batch.get("image_features"), train,
                            generator)
    enc = _pipeline(grid, run_encoder, x, [], n_micro, cfg.remat, params)
    if cfg.normalize_before:
        enc = bart._ln(enc, trunk.encoder.layer_norm)
    # every stage's cross-attention reads the encoder output
    enc_dec = copy_to(enc, grid.stage)
    if tp is not None:
        enc_dec = copy_to(enc_dec, tp.axis)

    dec_layers = stage_layers(trunk.decoder, cfg, grid, encoder=False)

    def run_decoder(h, side, m):
        for li, layer in dec_layers:
            gen, stack = layer_context(2, li, m, h.shape[1])
            h = bart._decoder_layer(h, layer, side[0], cfg, dtype, rows(dec_mask, m),
                                    rows(attention_mask, m), train, gen, stack)
        return h

    y = bart._decoder_embed(trunk, cfg, batch["decoder_input_ids"], 0, train, generator)
    dec = _pipeline(grid, run_decoder, y, [enc_dec], n_micro, cfg.remat, params)
    if cfg.add_final_layer_norm:
        dec = bart._ln(dec, trunk.decoder.layer_norm)
    return dec, enc


def _trunk(grid, n_micro):
    def trunk_fn(trunk, cfg, batch, train, generator):
        dec, _ = pipelined_forward(trunk, cfg, batch, grid, n_micro=n_micro, train=train,
                                   generator=generator)
        return dec
    return trunk_fn


def pipelined_conditional_loss(model, cfg, batch, grid, *, n_micro, train=False,
                               generator=None):
    """``conditional_loss`` with the trunk pipelined; the LM head and its CE
    run whole on every stage on the broadcast decoder output (K7/K8, or
    K9/K10 under "nomat", on every rank)."""
    from kmbart_tpu_torch.models.conditional import conditional_loss
    return conditional_loss(model, cfg, batch, train=train, generator=generator,
                            trunk_fn=_trunk(grid, n_micro))


def pipelined_pretraining_loss(model, cfg, batch, grid, *, n_micro, train=False,
                               generator=None):
    """``pretraining_loss`` with the trunk pipelined; the four heads run
    whole on every stage on the broadcast decoder output."""
    from kmbart_tpu_torch.models.pretraining import pretraining_loss
    return pretraining_loss(model, cfg, batch, train=train, generator=generator,
                            trunk_fn=_trunk(grid, n_micro))
