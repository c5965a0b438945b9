#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kmbart_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(``--kernels-only`` stops after phase 3, to compare kernel builds;
``--only serve,sample`` drives only the named paths after it.)

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device    the card's name and power limit (needs a CUDA device);
  2. build     nvcc builds the eleven kernels from kmbart_tpu_torch/csrc (one
               nvcc per source, all started together);
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the generation, fine-tune and pretraining paths' shapes and at
               edge shapes (K1 and its backward also on the fused QKV
               projection's strided chunks, at Tk 256 and ragged lengths;
               K2 and K2b at every training row, ragged rows and a wide
               FFN), with the device times of both from CUDA events, the
               bound the card sets for the same work (bytes or FLOPs, each
               input read once and each output written once), for the
               attention kernels the time of one
               F.scaled_dot_product_attention call on the same data and for
               K2, K2b and K7-K10 the time of the bf16 torch.mm products
               of their GEMMs (the port never calls either), K8's two
               launches and K10's first pass timed alone, K9's statistics
               and K10's outputs held equal to K7's and K8's (on K7's
               logits) bit for bit, K11's error split into what its bf16
               p terms cost and the rest, and K2's and K2b's host time a
               call (and K7's); K3 at cache positions 0, 15 and 31 with the
               bound of the rows its ancestry reads, and in ring mode at the
               serving pool's shape (windows 1..32 with most wrapping past
               column 0, all 32, all 1; each window's output equal bit for
               bit to the scalar mode's on the window rotated to columns
               [0, n)); a planted-tie top-k;
  4. generate  beam-5 VCG generation at BART-base width (config/vcg_base.json,
               random weights from a seed, batch 64): every generation kernel
               must have launched, outputs finite, and the encoder output and
               first-step log-probs close to the plain path's on the card;
               one real K3 call (the cache and ancestry of the last step)
               against its plain version; a torch.profiler trace of one call
               (device-busy share, K2's and K3's device time, K3's summed
               bound);
  5. cli       ``python -m kmbart_tpu_torch.vcg_generate --device cuda`` on a
               fixture dataset;
  6. train     fine-tuning at full width and depth (batch 128, 72 encoder and
               40 decoder tokens): one step at dropout 0 on the kernel path
               and on the plain path (loss and per-leaf gradient norms close),
               then ten AdamW steps on one batch with the config's dropout
               (every fine-tune kernel launched the expected number of times
               per step, the loss finite and falling), with ms/step, samples/s
               and peak device memory, then the step on the plain path in
               turns with the kernel path, and a torch.profiler trace of
               three steps (device-busy share, top device kernels, the
               shares of K1, K1b, K2, K2b, K7 and K8);
  7. train_cli ``python -m kmbart_tpu_torch.vcg_train --device cuda`` trains one
               epoch on the fixture dataset, and the generate twin decodes
               from its model0/;
  8. pretrain  multi-task pretraining at full width and depth
               (config/pretrain_base.json, batch 128 at the collator's default
               lengths: 96 encoder and 72 decoder tokens, 30 image slots, 80
               relation pairs, rows present in all four heads), in LM-CE mode
               "fwdbwd" and in mode "nomat": one step at dropout 0 on the
               kernel path and on the plain path (the five losses and per-leaf
               gradient norms close), nomat against fwdbwd, then ten AdamW
               steps with the config's dropout in each mode (launches per step
               exact, loss finite and falling, ms/step, samples/s, peak
               memory), then the two modes in turns and a torch.profiler
               trace of three steps in each mode;
  9. pretrain_long  the same at --lm_max_len 224 (296 encoder and 272 decoder
               tokens, batch 32), where every attention goes to the flash
               kernel K11 and none to K1: kernel path against plain path at
               dropout 0, then four steps and a torch.profiler trace of
               three (K11's share);
 10. pretrain_cli  ``python -m kmbart_tpu_torch.pretrain --device cuda`` trains
               one epoch on the fixture's coco, vg, vcg and reason datasets, and
               the vcg_train twin fine-tunes one epoch from its model0/;
 11. sample    generate() with do_sample, top_k 50 and top_p 0.9 at batch 64,
               beam 5 and greedy: one generator seed gives the same tokens
               twice, K1-K4 launch (K4 on the beam path), sentences/s;
 12. serve     the continuous engine at serve.py's defaults (pool 112, chunk
               4, beam 5, max_length 32, 96 encoder tokens, 30 image slots) on
               224 requests in four staggered bursts: every request's tokens
               equal generate()'s on the same row (batches of 112), requests/s,
               p50 and p99 latency, K3-ring and K4 launches, the device-busy
               share of a profiled burst; then 64 requests through the static
               engine and one POST through the HTTP server on 127.0.0.1;
 13. extract   the bottom-up-attention extractor at config/extract_config.yaml's
               widths (ResNet-101 C4, 1601 classes, 6000/300 proposals, 600 x
               1000 px, bf16) on random weights: the given-boxes path on 16
               images (the whole-image box and 24 boxes), the proposal path on
               8 images batched and one by one (images/s, each stage's device
               ms, peak memory, host syncs an image, 10..50 boxes kept), the
               card's fp32 run against the CPU's on one image and the batch
               path against the single path (the same kept rows but for named
               near-ties, each pair on the same ROI-pool window, features
               within 1e-3), bf16 against fp32;
 14. knowledge COMET's GPT at GPT-1's widths on random weights: greedy and
               beam-5 get_reason over 32 events (events/s, ms a step), and the
               card's fp32 run against the CPU's on 4 events (first-step
               log-probs within 1e-4, the same tokens but for named near-ties);
 15. reason_filter  the filter_reason twin at BART-base on 64 rows (rows/s,
               K1 and K2 launches, kernel path against plain path), a few
               steps of the prepare_atomic twin with a BART-base text
               backbone and its pooled encoder states on the kernel path
               against the plain path (each bound checked to reject a
               control that rounds K2's output to float8), and the
               prepare_vcg twin's feature loop on images handed in as arrays.
The line before the last lists every kernel with its launches on the main
path, its error, its time, its plain version's, its bound and the library
call's; the last line is {"ok": true, "device": {...}}. The port imports
nothing of jax or kmbart_tpu, and the script checks that at its end.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# stated tolerances (see _bf16_tol): kernel vs plain version on one card
BF16_ULPS = 2            # bf16 outputs: the two differ in fp32 summation order only
ES_RTOL = 1e-5           # vocab exp-sums (fp32, summation order)
ENC_ULPS = 8             # full-width encoder output: 6 layers of <= 2-ulp kernel
                         # differences compounded through layer norm, in bf16
                         # ulps of the output's largest magnitude
LOGPROB_ATOL = 0.1       # first-step log-probs through the 6-layer decoder
# kernel path vs plain path through a whole fine-tune step (bf16, 12 layers
# of <= 2-ulp kernel differences, compounded through layer norms and the
# 50320-way softmax)
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_NORM_RTOL = 5e-2
# launches per fine-tune step: K1 over 6 encoder self + 6 decoder self +
# 6 cross attentions, K2 over 12 FFNs, K7/K8 once
TRAIN_LAUNCHES = {"train_attention": 18, "train_attention_bwd": 18, "ffn": 12,
                  "ffn_bwd": 12, "lm_ce_fwd": 1, "lm_ce_bwd": 1}
GENERATE_KERNELS = ("train_attention", "ffn", "beam_attention", "vocab_stats")
# K11's fp32 output against its plain version, in units of max|v|: the
# bf16 kernel multiplies V by p_hi + p_lo (two bf16 terms, within 2^-16 p of
# the fp32 p), so the output, a convex combination of v rows, moves by at
# most 2^-16 = 1.5e-5 (the K11 rows' p_split_err measures it); the scores are
# the same exact products summed in another order (the tensor cores' fp32
# sums; a few ulps of a score), and the online rescaling adds a few
# roundings per 64-key tile. 2e-5 is the JAX flash tests' bound, unchanged
FLASH_RTOL = 2e-5
# launches per pretraining step at 96/72 tokens (K1 as in fine-tuning; the
# LM-CE pair by mode) and at 296/272 tokens (every attention on K11, whose
# backward is the plain math, as in the JAX package)
PRETRAIN_LAUNCHES = {
    "fwdbwd": {**TRAIN_LAUNCHES, "lm_ce_fwd_stats": 0, "lm_ce_recompute_bwd": 0,
               "flash_attention": 0},
    "nomat": {**TRAIN_LAUNCHES, "lm_ce_fwd": 0, "lm_ce_bwd": 0, "lm_ce_fwd_stats": 1,
              "lm_ce_recompute_bwd": 1, "flash_attention": 0},
}
PRETRAIN_LONG_LAUNCHES = {**PRETRAIN_LAUNCHES["fwdbwd"], "train_attention": 0,
                          "train_attention_bwd": 0, "flash_attention": 18}
# the least time the card could take (bound_ms): an H100 SXM's published
# dense peaks (NVIDIA data sheet) at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12      # tensor cores, bf16 operands
F32_FLOPS = 67e12        # fp32 outside the tensor cores


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _bf16_tol(ref, floor=1.0):
    """BF16_ULPS bf16 ulps of ref's largest magnitude, or of ``floor`` where
    that is larger. The LM loss's dlogits and dh scale with 1 / (valid
    tokens), far below 1: they are held with floor=0, at their own size."""
    scale = max(floor, float(ref.abs().max()), 2.0 ** -126)
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)


def _events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


_SLEEP_MS_PER_MCYCLE = []


def _time_ms(torch, fn, iters=20, warmup=3, reps=3):
    """Device time of one call in ms: ``iters`` calls enqueued behind a
    sleeping kernel that outlasts the host's enqueueing of them, so the
    events time the device's work and not the host's launch path; the
    median of ``reps`` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not _SLEEP_MS_PER_MCYCLE:
        start, end = _events(torch)
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        end.synchronize()
        _SLEEP_MS_PER_MCYCLE.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int((1.5 * host_ms + 1.0) / _SLEEP_MS_PER_MCYCLE[0] * 1e6)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        start, end = _events(torch)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def _host_us(torch, fn, iters=50):
    """The host's time to enqueue one call, in microseconds: the mean over
    ``iters`` calls made without waiting for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return host_us


def _bound(nbytes, bf16_flops=0.0, f32_flops=0.0):
    """{"bound_ms", "bound_by"}: the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    mem = nbytes / HBM_BYTES_PER_S
    ops = bf16_flops / BF16_FLOPS + f32_flops / F32_FLOPS
    return {"bound_ms": 1e3 * max(mem, ops), "bound_by": "bytes" if mem >= ops else "operations",
            "bytes": nbytes, "flops": bf16_flops + f32_flops}


def _k3_bound(anc, B, K, D, cache_index):
    """K3's bound at one step (bf16 q and cache): q and the ancestry read,
    the fp32 output written, and the K and V rows (slot, position) that some
    beam of the sample descends through (all K of them at each position
    when ``anc`` is None), each read once; the scores and P.V at the bf16
    rate."""
    n = cache_index + 1
    if anc is None:
        rows = B * K * n
    else:
        a = anc[:, :n].long().reshape(B, K, n)
        rows = int(a.new_zeros((B, K, n), dtype=bool).scatter_(1, a, True).sum())
    return _bound(2 * B * K * D + 4 * B * K * n + 4 * B * K * D + 2 * 2 * rows * D,
                  bf16_flops=4.0 * B * K * n * D)


def _ring_window(torch, T, ring_col, valid):
    """[B, T] bool: the columns of each sample's ring window (the valid[b]
    columns ending at ring_col, cyclically; lengths clamped to [1, T])."""
    age = torch.remainder(ring_col - torch.arange(T, device=valid.device), T)
    return age[None, :] < valid.clamp(1, T)[:, None]


def _k3_ring_bound(torch, anc, B, K, T, D, ring_col, valid):
    """``_k3_bound``'s rule over a ring call: q, the window lengths and the
    ancestry of the window read, the fp32 output written, the K and V rows
    (slot, column) of each window that some beam descends through read
    once, and the scores and P.V of each window's positions."""
    window = _ring_window(torch, T, ring_col, valid)                    # [B, T]
    a = anc.long().reshape(B, K, T)
    used = a.new_zeros((B, K, T), dtype=torch.bool).scatter_(1, a, True) & window[:, None]
    n = int(window.sum())
    return _bound(2 * B * K * D + 4 * B + 4 * K * n + 4 * B * K * D
                  + 2 * 2 * int(used.sum()) * D, bf16_flops=4.0 * K * n * D)


def _pairs(Tq, Tk, causal):
    """(query, key) pairs an attention needs: causal keeps j <= i."""
    return Tq * (Tq + 1) // 2 if causal else Tq * Tk


def _sdpa_ms(torch, q, k, v, mask, H, causal, g=None):
    """library_ms of an attention kernel: one F.scaled_dot_product_attention
    call on the same data, the key mask (and causal mask) as one additive
    [B, 1, Tq, Tk] bias in the inputs' dtype; with ``g``, its backward:
    torch.autograd.grad through that call, the forward outside the timed
    window."""
    import torch.nn.functional as F
    B, Tq, D = q.shape
    Tk, hd = k.shape[1], D // H
    bias = torch.where(mask.bool(), 0.0, -1e9)[:, None, None, :].expand(B, 1, Tq, Tk)
    if causal:
        keep = (torch.arange(Tk, device=q.device)[None, :]
                <= torch.arange(Tq, device=q.device)[:, None])
        bias = torch.where(keep, bias, -1e9)
    bias = bias.to(q.dtype).contiguous()

    def heads(t, T):   # [B, T, D] (rows may be strided) -> [B, H, T, hd] view
        return t.detach().view(B, T, H, hd).transpose(1, 2).requires_grad_(g is not None)

    qh, kh, vh = heads(q, Tq), heads(k, Tk), heads(v, Tk)

    def call():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

    if g is None:
        with torch.no_grad():
            return _time_ms(torch, call)
    out = call()
    gh = g.view(B, Tq, H, hd).transpose(1, 2)
    return _time_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                       retain_graph=True))


def _flash_p_terms(torch, fa, q, k, v, mask, terms, *, num_heads, causal):
    """flash_attention_plain's math with p = exp(s - m) replaced by the sum
    of its first ``terms`` bf16 terms (fa.p_split); l stays the fp32 sum."""
    B, Tq, D = q.shape
    Tk, H = k.shape[1], num_heads
    hd = D // H
    qf = q.float().reshape(B, Tq, H, hd) * hd ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float().reshape(B, Tk, H, hd))
    s = s + fa._key_bias(mask, B, Tk, q.device)[:, None, None, :]
    if causal:
        keep = (torch.arange(Tk, device=q.device)[None, :]
                <= torch.arange(Tq, device=q.device)[:, None])
        s = torch.where(keep, s, fa.NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).clamp(min=fa.NEG_INF))
    l = e.sum(dim=-1).transpose(1, 2)[..., None]
    hi, lo = fa.p_split(e)
    p = hi + lo if terms == 2 else hi
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float().reshape(B, Tk, H, hd))
    return (out / l.clamp(min=1e-30)).reshape(B, Tq, D)


def _check(name, err, tol):
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: max error {err} above tolerance {tol}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def check_kernels(torch, dev):
    from kmbart_tpu_torch.ops import beam_attention as ba
    from kmbart_tpu_torch.ops import flash_attention as fa
    from kmbart_tpu_torch.ops import ffn, lm_ce, train_attention as ta, vocab_stats as vs
    from kmbart_tpu_torch.ops.topk import top_k

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    results = {}

    # K1 and its backward. Main-path shapes (D 768, 12 heads): the generation
    # encoder (B 64, 72 x 72); fine-tuning at B 128: encoder self 72 x 72
    # with 9 padded keys, decoder causal 40 x 40 with 7, cross 40 x 72;
    # pretraining at B 128: encoder self 96 x 96 with 6 padded keys, decoder
    # causal 72 x 72 with 6, cross 72 x 96 (the decoder's causal attention
    # also takes its key mask). Self-attention hands K1 the strided chunks
    # of its fused QKV projection ("fused"), as the model does. Edges: Tk 256
    # (plain and causal), a ragged 24 x 40, tiny widths (head_dim 8), heads
    # wider than one 64-column slab (head_dim 128, 72 and 256), and the
    # float instantiation.
    def qkv(B, Tq, Tk, D, fused, dtype):
        if fused:   # row stride 3D, no copy
            return randn(B, Tq, 3 * D, dtype=dtype).chunk(3, dim=-1)
        return randn(B, Tq, D, dtype=dtype), randn(B, Tk, D, dtype=dtype), \
            randn(B, Tk, D, dtype=dtype)

    def key_mask(B, Tk, pad):
        mask = torch.ones((B, Tk), dtype=torch.long, device=dev)
        if pad:
            mask[1::2, Tk - pad:] = 0
        return mask

    K1_SHAPES = [  # (B, Tq, Tk, D, H, padded keys, causal, fused QKV, timed)
        (64, 72, 72, 768, 12, 0, False, True, True),
        (128, 72, 72, 768, 12, 9, False, True, True),
        (128, 40, 40, 768, 12, 7, True, True, True),
        (128, 40, 72, 768, 12, 9, False, False, True),
        (128, 96, 96, 768, 12, 6, False, True, True),
        (128, 72, 72, 768, 12, 6, True, True, True),
        (128, 72, 96, 768, 12, 6, False, False, True),
        (2, 256, 256, 768, 12, 7, False, False, False),
        (2, 256, 256, 768, 12, 0, True, True, False),
        (3, 24, 40, 768, 12, 5, False, False, False),
        (3, 16, 16, 32, 4, 5, False, True, False),
        (3, 16, 16, 32, 4, 5, True, True, False),
        (3, 8, 16, 32, 4, 5, False, False, False),
        (4, 72, 72, 1024, 8, 9, False, True, False),
        (4, 40, 40, 1024, 8, 7, True, True, False),
        (3, 24, 40, 288, 4, 5, False, False, False),
        (2, 72, 72, 1024, 4, 6, True, True, False),
    ]

    def k1(B, Tq, Tk, D, H, pad, causal, fused, timed, dtype=bf16):
        q, k, v = qkv(B, Tq, Tk, D, fused, dtype)
        mask = key_mask(B, Tk, pad)
        kw = dict(num_heads=H, causal=causal)
        out = ta.train_attention_flat(q, k, v, mask, **kw)
        ref = ta.train_attention_plain(q, k, v, mask, **kw)
        err, tol = _max_err(out, ref), _bf16_tol(ref.float())
        _check(f"train_attention {B}x{Tq}x{Tk}x{D} causal={causal} fused={fused} {dtype}",
               err, tol)
        res = {"shape": [B, Tq, Tk, D, H], "pad": pad, "causal": causal, "fused_qkv": fused,
               "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tol": tol}
        if timed:
            res["ms"] = _time_ms(torch, lambda: ta.train_attention_flat(q, k, v, mask, **kw))
            res["plain_ms"] = _time_ms(torch, lambda: ta.train_attention_plain(q, k, v, mask,
                                                                               **kw))
            res["library_ms"] = _sdpa_ms(torch, q, k, v, mask, H, causal)
            res.update(_bound(2 * (2 * B * Tq * D + 2 * B * Tk * D) + 8 * B * Tk,
                              bf16_flops=4.0 * B * _pairs(Tq, Tk, causal) * D))
        return res

    results["train_attention"] = [k1(*shape) for shape in K1_SHAPES] + [
        k1(3, 16, 16, 32, 4, 5, True, True, False, dtype=torch.float32),
        k1(4, 40, 72, 768, 12, 9, False, False, False, dtype=torch.float32)]

    # K2 at the rows its callers give it: generation's encoder (64 x 72) and
    # decode step (64 x 5) without the pre-activation; with it (the
    # backward's residual), fine-tuning's encoder (128 x 72, also
    # pretraining's decoder) and decoder (128 x 40) and pretraining's
    # encoder (128 x 96); edges: ragged rows at tiny widths, a wide FFN.
    # Timed rows carry gemm_ms, the two bf16 torch.mm products of the same
    # shapes (a yardstick the port never calls), and host_us.
    def k2(N, D, F, timed, with_a=False, path="edge"):
        x = randn(N, D)
        w1, w2 = randn(F, D, std=0.02), randn(D, F, std=0.02)
        b1 = randn(F, std=0.02, dtype=torch.float32)
        b2 = randn(D, std=0.02, dtype=torch.float32)
        outs = ffn.fused_ffn(x, w1, b1, w2, b2, with_a=with_a)
        refs = ffn.fused_ffn_plain(x, w1, b1, w2, b2, with_a=with_a)
        outs, refs = (outs, refs) if with_a else ((outs,), (refs,))
        res = {"shape": [N, D, F], "with_a": with_a, "path": path}
        for name, out, ref in zip(("y", "a"), outs, refs):
            err, tol = _max_err(out, ref), _bf16_tol(ref.float())
            _check(f"fused_ffn {name} {N}x{D}x{F} with_a={with_a}", err, tol)
            res[f"{name}_err"], res[f"{name}_tol"] = err, tol
        res["max_abs_err"] = max(res[f"{name}_err"] for name in ("y", "a")[:len(outs)])
        if timed:
            call = lambda: ffn.fused_ffn(x, w1, b1, w2, b2, with_a=with_a)  # noqa: E731
            res["ms"] = _time_ms(torch, call)
            res["plain_ms"] = _time_ms(torch, lambda: ffn.fused_ffn_plain(x, w1, b1, w2, b2,
                                                                          with_a=with_a))
            h = randn(N, F)
            res["gemm_ms"] = _time_ms(torch, lambda: (torch.mm(x, w1.t()), torch.mm(h, w2.t())))
            res["host_us"] = _host_us(torch, call)
            res.update(_bound(2 * (2 * N * D + 2 * F * D) + 4 * (F + D)
                              + (2 * N * F if with_a else 0), bf16_flops=4.0 * N * D * F))
        return res

    results["ffn"] = [k2(64 * 72, 768, 3072, True, path="generate encoder"),
                      k2(64 * 5, 768, 3072, True, path="generate decode step"),
                      k2(128 * 72, 768, 3072, True, with_a=True,
                         path="fine-tune encoder, pretraining decoder"),
                      k2(128 * 40, 768, 3072, True, with_a=True, path="fine-tune decoder"),
                      k2(128 * 96, 768, 3072, True, with_a=True, path="pretraining encoder"),
                      k2(37, 32, 64, False), k2(37, 32, 64, False, with_a=True),
                      k2(1000, 1024, 4096, False), k2(1000, 1024, 4096, False, with_a=True)]

    # K3: decoder self-attention, B 64, K 5, T 32, D 768, 12 heads, with
    # branching ancestry, at the last position (the kernels line's row) and
    # at positions 0 and 15; edges: K 1 and K 4, every beam descending from
    # one slot ("shared") and each beam keeping its own ("distinct"), head_dim
    # 32 and 128 (two shared-memory chunks), tiny widths, and the fp32 q and
    # fp32 cache instantiations
    def k3(B, K, T, D, H, cache_index, timed, ancestry="branching", q_dtype=bf16,
           cache_dtype=bf16):
        q = randn(B * K, D, dtype=q_dtype) * (D // H) ** -0.5
        kc, vc = randn(B, K, T, D, dtype=cache_dtype), randn(B, K, T, D, dtype=cache_dtype)
        if ancestry == "branching":
            anc = torch.randint(0, K, (B * K, T), generator=g, device=dev, dtype=torch.int32)
        elif ancestry == "shared":
            anc = torch.full((B * K, T), K - 1, device=dev, dtype=torch.int32)
        else:
            anc = torch.arange(K, device=dev, dtype=torch.int32).repeat(B)[:, None] \
                .expand(B * K, T).contiguous()
        kw = dict(num_beams=K, num_heads=H)
        out = ba.beam_gather_attention(q, kc, vc, anc, cache_index, **kw)
        ref = ba.beam_gather_attention_plain(q, kc, vc, anc, cache_index, **kw)
        err = float((out - ref).abs().max())
        tol = _bf16_tol(ref)   # P is rounded to bf16 on both sides
        _check(f"beam_gather_attention {B}x{K}x{T}x{D} H={H} ci={cache_index} {ancestry} "
               f"q {q_dtype} cache {cache_dtype}", err, tol)
        res = {"shape": [B, K, T, D, H], "cache_index": cache_index, "ancestry": ancestry,
               "q_dtype": str(q_dtype).split(".")[-1],
               "cache_dtype": str(cache_dtype).split(".")[-1], "max_abs_err": err, "tol": tol}
        if timed:
            res["ms"] = _time_ms(torch, lambda: ba.beam_gather_attention(q, kc, vc, anc, cache_index, **kw))
            res["plain_ms"] = _time_ms(torch, lambda: ba.beam_gather_attention_plain(q, kc, vc, anc, cache_index, **kw))
            res.update(_k3_bound(anc, B, K, D, cache_index))
            res["bound_all_rows_ms"] = _k3_bound(None, B, K, D, cache_index)["bound_ms"]
        return res

    # K1 backward at K1's shapes (the generation encoder's row is forward
    # only, so the backward's first row is the fine-tune encoder's)
    def k1b(B, Tq, Tk, D, H, pad, causal, fused, timed, dtype=bf16):
        q, k, v = qkv(B, Tq, Tk, D, fused, dtype)
        g = randn(B, Tq, D, dtype=dtype)
        mask = key_mask(B, Tk, pad)
        kw = dict(num_heads=H, causal=causal)
        outs = ta.train_attention_bwd(q, k, v, mask, g, **kw)
        refs = ta.train_attention_bwd_plain(q, k, v, mask, g, **kw)
        res = {"shape": [B, Tq, Tk, D, H], "pad": pad, "causal": causal, "fused_qkv": fused,
               "dtype": str(dtype).split(".")[-1]}
        errs = []
        for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
            err, tol = _max_err(out, ref), _bf16_tol(ref.float())
            _check(f"train_attention_bwd {name} {B}x{Tq}x{Tk} causal={causal} fused={fused} "
                   f"{dtype}", err, tol)
            res[f"{name}_err"], res[f"{name}_tol"] = err, tol
            errs.append(err)
        res["max_abs_err"] = max(errs)
        if timed:
            res["ms"] = _time_ms(torch, lambda: ta.train_attention_bwd(q, k, v, mask, g, **kw))
            res["plain_ms"] = _time_ms(
                torch, lambda: ta.train_attention_bwd_plain(q, k, v, mask, g, **kw))
            res["library_ms"] = _sdpa_ms(torch, q, k, v, mask, H, causal, g=g)
            res.update(_bound(2 * (2 * B * Tq * D + 2 * B * Tk * D + B * Tq * D
                                   + 2 * B * Tk * D) + 8 * B * Tk,
                              bf16_flops=10.0 * B * _pairs(Tq, Tk, causal) * D))
        return res

    results["train_attention_bwd"] = [k1b(*shape) for shape in K1_SHAPES[1:]] + [
        k1b(3, 16, 16, 32, 4, 5, True, True, False, dtype=torch.float32),
        k1b(4, 40, 72, 768, 12, 9, False, False, False, dtype=torch.float32)]

    # K2 backward at the training rows (as K2 with_a); edges: ragged rows at
    # tiny widths, a wide FFN
    def k2b(N, D, F, timed, path="edge"):
        g, a = randn(N, D), randn(N, F)
        w1, w2 = randn(F, D, std=0.02), randn(D, F, std=0.02)
        outs = ffn.fused_ffn_bwd(g, a, w1, w2)
        refs = ffn.fused_ffn_bwd_plain(g, a, w1, w2)
        res = {"shape": [N, D, F], "path": path}
        for name, out, ref in zip(("da", "dx"), outs, refs):
            err, tol = _max_err(out, ref), _bf16_tol(ref.float())
            _check(f"fused_ffn_bwd {name} {N}x{D}x{F}", err, tol)
            res[f"{name}_err"], res[f"{name}_tol"] = err, tol
        res["max_abs_err"] = max(res["da_err"], res["dx_err"])
        if timed:
            call = lambda: ffn.fused_ffn_bwd(g, a, w1, w2)  # noqa: E731
            res["ms"] = _time_ms(torch, call)
            res["plain_ms"] = _time_ms(torch, lambda: ffn.fused_ffn_bwd_plain(g, a, w1, w2))
            res["gemm_ms"] = _time_ms(torch, lambda: (torch.mm(g, w2), torch.mm(a, w1)))
            res["host_us"] = _host_us(torch, call)
            res.update(_bound(2 * (2 * N * D + 2 * N * F + 2 * F * D),
                              bf16_flops=4.0 * N * D * F))
        return res

    results["ffn_bwd"] = [k2b(128 * 72, 768, 3072, True,
                              path="fine-tune encoder, pretraining decoder"),
                          k2b(128 * 40, 768, 3072, True, path="fine-tune decoder"),
                          k2b(128 * 96, 768, 3072, True, path="pretraining encoder"),
                          k2b(37, 32, 64, False), k2b(1000, 1024, 4096, False)]

    # K7 and K8 at the fine-tune head (N 128 x 40 = 5120 rows, V 50320, D 768,
    # ragged last vocab tile); edge: ragged rows and a small ragged vocab
    def k7_check(h, w, fbias, labels):
        """K7 against its plain version: logits, logsumexp and label logit."""
        N, V = h.shape[0], w.shape[0]
        logits, m, se, ll = lm_ce.lm_ce_fwd(h, w, fbias, labels)
        rl, rm, rse, rll = lm_ce.lm_ce_fwd_plain(h, w, fbias, labels)
        tol = _bf16_tol(rl.float())
        fwd = {"shape": [N, V, h.shape[1]], "logits_err": _max_err(logits, rl),
               "lse_err": _max_err(torch.log(se) + m, torch.log(rse) + rm),
               "ll_err": _max_err(ll, rll), "tol": tol, "logits_pitch": logits.stride(0)}
        for key in ("logits_err", "lse_err", "ll_err"):
            _check(f"lm_ce_fwd {key} {N}x{V}", fwd[key], tol)
        fwd["max_abs_err"] = max(fwd["logits_err"], fwd["lse_err"], fwd["ll_err"])
        return fwd, (logits, m, se, ll)

    def head_labels(N, V):
        """Random labels, with rows 0-2 at column 0, at V - 1 and at the
        first column of the ragged last 128-column tile."""
        labels = torch.randint(0, V, (N,), generator=g, device=dev, dtype=torch.int32)
        labels[:3] = torch.tensor([0, V - 1, (V - 1) // 128 * 128], dtype=torch.int32)
        return labels

    def k78(N, V, D, timed):
        h = randn(N, D)
        w = randn(V, D, std=0.02)
        fbias = randn(V, std=0.02, dtype=torch.float32)
        labels = head_labels(N, V)
        fwd, (logits, m, se, _) = k7_check(h, w, fbias, labels)
        valid = torch.rand((N,), generator=g, device=dev) > 0.1
        scale = (valid.float() / valid.sum().clamp(min=1)).contiguous()
        inv_se = (1.0 / se).contiguous()
        bargs = (logits, w, m, inv_se, scale, labels)
        dl, dh = lm_ce.lm_ce_bwd(*bargs)
        rdl, rdh = lm_ce.lm_ce_bwd_plain(*bargs)
        bwd = {"shape": [N, V, D]}
        for name, out, ref in (("dlogits", dl, rdl), ("dh", dh, rdh)):
            err, tol = _max_err(out, ref), _bf16_tol(ref.float(), floor=0.0)
            _check(f"lm_ce_bwd {name} {N}x{V}", err, tol)
            bwd[f"{name}_err"], bwd[f"{name}_tol"] = err, tol
        bwd["max_abs_err"] = max(bwd["dlogits_err"], bwd["dh_err"])
        if timed:
            # K10 at these rows too (its own path is the pretraining head's)
            rargs = (h, w, fbias, m, inv_se, scale, labels)
            for name, out, ref in zip(("dlogits", "dh"), lm_ce.lm_ce_recompute_bwd(*rargs),
                                      lm_ce.lm_ce_recompute_bwd_plain(*rargs)):
                err, tol = _max_err(out, ref), _bf16_tol(ref.float(), floor=0.0)
                _check(f"lm_ce_recompute_bwd {name} {N}x{V}", err, tol)
                bwd[f"k10_{name}_err"], bwd[f"k10_{name}_tol"] = err, tol
            call = lambda: lm_ce.lm_ce_fwd(h, w, fbias, labels)  # noqa: E731
            fwd["ms"] = _time_ms(torch, call, iters=10)
            fwd["host_us"] = _host_us(torch, call)
            fwd["plain_ms"] = _time_ms(torch, lambda: lm_ce.lm_ce_fwd_plain(h, w, fbias, labels),
                                       iters=10)
            bwd["ms"] = _time_ms(torch, lambda: lm_ce.lm_ce_bwd(*bargs), iters=10)
            bwd["plain_ms"] = _time_ms(torch, lambda: lm_ce.lm_ce_bwd_plain(*bargs), iters=10)
            _lm_ce_parts(fwd, bwd, h, w, rdl, bargs)
            fwd.update(_k7_bound(N, V, D))
            bwd.update(_k8_bound(N, V, D))
        return fwd, bwd

    def _lm_ce_parts(fwd, bwd, h, w, dl, bargs=None):
        """Where K7-K10's time goes beside their yardsticks: ``gemm_ms``, one
        bf16 torch.mm of the same GEMM ([N, D] x [D, V] forward, [N, V] x
        [V, D] backward; the port calls neither), and, with K8's arguments,
        the time of K8's two launches alone."""
        dl = dl.contiguous()
        fwd["gemm_ms"] = _time_ms(torch, lambda: torch.mm(h, w.t()), iters=10)
        bwd["gemm_ms"] = _time_ms(torch, lambda: torch.mm(dl, w), iters=10)
        V = w.shape[0]
        buf = torch.zeros((dl.shape[0], lm_ce.padded_vocab(V)), dtype=dl.dtype, device=dev)
        buf[:, :V] = dl
        bwd["dh_ms"] = _time_ms(torch, lambda: lm_ce.dh_gemm("dh", buf, V, w), iters=10)
        if bargs is not None:
            logits, _, m, inv_se, scale, labels = bargs
            bwd["dlogits_ms"] = _time_ms(
                torch, lambda: lm_ce.dlogits_pass(logits, m, inv_se, scale, labels), iters=10)

    def _k7_bound(N, V, D):
        return _bound(2 * N * D + 2 * V * D + 4 * V + 4 * N + 2 * N * V + 12 * N,
                      bf16_flops=2.0 * N * V * D)

    def _k8_bound(N, V, D):
        return _bound(2 * 2 * N * V + 2 * V * D + 16 * N + 2 * N * D,
                      bf16_flops=2.0 * N * V * D)

    head = [k78(5120, 50320, 768, True), k78(24, 1100, 128, False)]
    results["lm_ce_fwd"] = [f for f, _ in head]
    results["lm_ce_bwd"] = [b for _, b in head]

    # K9 and K10 ("nomat") at the pretraining head (N 128 x 72 = 9216 rows,
    # V 50320, D 768); edge: ragged rows and a small ragged vocab (pitch
    # 1104). At both, K9 runs K7's projection without the store and K10's
    # first pass forms K8's dlogits from K7's rounding, so on the same inputs
    # K9's statistics equal K7's and K10's outputs equal K8's on K7's logits
    # bit for bit, and K10's pad columns are zero
    def k910(N, V, D, timed):
        h = randn(N, D)
        w = randn(V, D, std=0.02)
        fbias = randn(V, std=0.02, dtype=torch.float32)
        labels = head_labels(N, V)
        m, se, ll = lm_ce.lm_ce_fwd_stats(h, w, fbias, labels)
        rl, rm, rse, rll = lm_ce.lm_ce_fwd_plain(h, w, fbias, labels)
        tol = _bf16_tol(rl.float())
        fwd = {"shape": [N, V, D], "lse_err": _max_err(torch.log(se) + m, torch.log(rse) + rm),
               "ll_err": _max_err(ll, rll), "tol": tol}
        for key in ("lse_err", "ll_err"):
            _check(f"lm_ce_fwd_stats {key} {N}x{V}", fwd[key], tol)
        fwd["max_abs_err"] = max(fwd["lse_err"], fwd["ll_err"])
        # the "fwdbwd" pair on the same inputs, K7 held to its plain version
        k7, (logits, k7_m, k7_se, k7_ll) = k7_check(h, w, fbias, labels)
        fwd.update({f"k7_{key}": k7[key] for key in ("logits_err", "lse_err", "ll_err")})
        fwd["equal_to_k7"] = all(torch.equal(a, b) for a, b in
                                 ((m, k7_m), (se, k7_se), (ll, k7_ll)))
        if not fwd["equal_to_k7"]:
            raise AssertionError(f"lm_ce_fwd_stats {N}x{V}: statistics differ from K7's")
        valid = torch.rand((N,), generator=g, device=dev) > 0.1
        scale = (valid.float() / valid.sum().clamp(min=1)).contiguous()
        bargs = (h, w, fbias, m, (1.0 / se).contiguous(), scale, labels)
        dl, dh = lm_ce.lm_ce_recompute_bwd(*bargs)
        rdl, rdh = lm_ce.lm_ce_recompute_bwd_plain(*bargs)
        bwd = {"shape": [N, V, D]}
        for name, out, ref in (("dlogits", dl, rdl), ("dh", dh, rdh)):
            err, tol = _max_err(out, ref), _bf16_tol(ref.float(), floor=0.0)
            _check(f"lm_ce_recompute_bwd {name} {N}x{V}", err, tol)
            bwd[f"{name}_err"], bwd[f"{name}_tol"] = err, tol
        bwd["max_abs_err"] = max(bwd["dlogits_err"], bwd["dh_err"])
        # K10's whole padded buffer: the pad columns [V, padded_vocab(V))
        pitch = lm_ce.padded_vocab(V)
        pad = dl.as_strided((N, pitch - V), (dl.stride(0), 1), dl.storage_offset() + V)
        bwd["pad_columns"] = pitch - V
        if dl.stride(0) != pitch or bool(pad.ne(0).any()):
            raise AssertionError(f"lm_ce_recompute_bwd {N}x{V}: pad columns not zero")
        # K8 on K7's logits, both outputs held to its plain version, as at
        # the fine-tune rows, and K10's equal to its bit for bit
        k8args = (logits, w, m, bargs[4], scale, labels)
        k8_dl, k8_dh = lm_ce.lm_ce_bwd(*k8args)
        for name, out, ref in zip(("dlogits", "dh"), (k8_dl, k8_dh),
                                  lm_ce.lm_ce_bwd_plain(*k8args)):
            err, tol = _max_err(out, ref), _bf16_tol(ref.float(), floor=0.0)
            _check(f"lm_ce_bwd {name} {N}x{V}", err, tol)
            bwd[f"k8_{name}_err"], bwd[f"k8_{name}_tol"] = err, tol
        bwd["equal_to_k8"] = torch.equal(dl, k8_dl) and torch.equal(dh, k8_dh)
        if not bwd["equal_to_k8"]:
            raise AssertionError(f"lm_ce_recompute_bwd {N}x{V}: outputs differ from K8's "
                                 f"on K7's logits")
        if timed:
            fwd["ms"] = _time_ms(torch, lambda: lm_ce.lm_ce_fwd_stats(h, w, fbias, labels),
                                 iters=10)
            fwd["plain_ms"] = _time_ms(
                torch, lambda: lm_ce.lm_ce_fwd_stats_plain(h, w, fbias, labels), iters=10)
            bwd["ms"] = _time_ms(torch, lambda: lm_ce.lm_ce_recompute_bwd(*bargs), iters=10)
            bwd["plain_ms"] = _time_ms(torch, lambda: lm_ce.lm_ce_recompute_bwd_plain(*bargs),
                                       iters=10)
            bwd["dlogits_bound_ms"] = _bound(2 * N * D + 2 * V * D + 4 * V + 16 * N + 2 * N * V,
                                             bf16_flops=2.0 * N * V * D)["bound_ms"]
            k7_call = lambda: lm_ce.lm_ce_fwd(h, w, fbias, labels)  # noqa: E731
            fwd["k7_ms"] = _time_ms(torch, k7_call, iters=10)
            fwd["k7_host_us"] = _host_us(torch, k7_call)
            bwd["k8_ms"] = _time_ms(torch, lambda: lm_ce.lm_ce_bwd(*k8args), iters=10)
            fwd["k7_bound_ms"] = _k7_bound(N, V, D)["bound_ms"]
            bwd["k8_bound_ms"] = _k8_bound(N, V, D)["bound_ms"]
            _lm_ce_parts(fwd, bwd, h, w, rdl, k8args)
            bwd["k8_dlogits_ms"] = bwd.pop("dlogits_ms")   # K8's first launch at these rows
            # K10's first pass alone, beside K8's two launches
            bwd["dlogits_ms"] = _time_ms(
                torch, lambda: lm_ce.recompute_dlogits_pass(*bargs), iters=10)
            fwd.update(_bound(2 * N * D + 2 * V * D + 4 * V + 4 * N + 12 * N,
                              bf16_flops=2.0 * N * V * D))
            bwd.update(_bound(2 * N * D + 2 * V * D + 4 * V + 16 * N + 2 * N * V + 2 * N * D,
                              bf16_flops=4.0 * N * V * D))
        return fwd, bwd

    nomat = [k910(9216, 50320, 768, True), k910(24, 1100, 128, False)]
    results["lm_ce_fwd_stats"] = [f for f, _ in nomat]
    results["lm_ce_recompute_bwd"] = [b for _, b in nomat]

    # K11 at the long-caption pretraining shapes (B 32, 12 heads): encoder
    # self 296 with padded keys, decoder causal 272, cross 272 x 296, the
    # two self-attentions also as the strided chunks of their fused QKV
    # projection ("fused"), as the model hands them over; edges: a ragged
    # 264 (not a multiple of the 64-row tiles), causal and padded; a causal
    # 272 whose batch rows 0 and 2 mask key 0 and row 3 every key ("key0":
    # no tile skipped there, and row 3 averages over all keys); head_dim 128,
    # 72 and 48 (the mma.sync instantiations) and 8 (tiny lengths); fp32
    def k11(B, Tq, Tk, D, H, pad, causal, timed, fused=False, key0=False, dtype=bf16):
        q, k, v = qkv(B, Tq, Tk, D, fused, dtype)
        mask = key_mask(B, Tk, pad)
        if key0:
            mask[0::2, 0] = 0
            mask[3] = 0
        kw = dict(num_heads=H, causal=causal)
        out = fa.flash_attention(q, k, v, mask, **kw)
        ref = fa.flash_attention_plain(q, k, v, mask, **kw)
        err = _max_err(out, ref)
        max_v = max(1.0, float(v.float().abs().max()))
        tol = FLASH_RTOL * max_v
        _check(f"flash_attention {B}x{Tq}x{Tk} hd={D // H} causal={causal} fused={fused} "
               f"key0={key0} {dtype}", err, tol)
        res = {"shape": [B, Tq, Tk, D, H], "pad": pad, "causal": causal, "fused_qkv": fused,
               "key0_masked": key0, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err, "tol": tol, "err_over_max_v": err / max_v}
        if dtype == bf16:
            # the plain math with p replaced by the kernel's two bf16 terms,
            # and by bf16(p) alone, against the plain version: what the
            # split costs, apart from the order of the sums
            res["p_split_err"] = _max_err(_flash_p_terms(torch, fa, q, k, v, mask, 2, **kw), ref)
            res["p_bf16_err"] = _max_err(_flash_p_terms(torch, fa, q, k, v, mask, 1, **kw), ref)
        if timed:
            res["ms"] = _time_ms(torch, lambda: fa.flash_attention(q, k, v, mask, **kw))
            res["plain_ms"] = _time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, mask,
                                                                               **kw))
            res["library_ms"] = _sdpa_ms(torch, q, k, v, mask, H, causal)
            # the work: q·k and p·v once each at the bf16 rate (each input
            # read once, the fp32 output written once)
            pairs = B * _pairs(Tq, Tk, causal) * D
            res.update(_bound(2 * (B * Tq * D + 2 * B * Tk * D) + 4 * B * Tk + 4 * B * Tq * D,
                              bf16_flops=4.0 * pairs))
        return res

    results["flash_attention"] = [k11(32, 296, 296, 768, 12, 9, False, True),
                                  k11(32, 272, 272, 768, 12, 7, True, True),
                                  k11(32, 272, 296, 768, 12, 9, False, True),
                                  k11(32, 296, 296, 768, 12, 9, False, True, fused=True),
                                  k11(32, 272, 272, 768, 12, 7, True, True, fused=True),
                                  k11(3, 264, 264, 768, 12, 5, True, False),
                                  k11(4, 272, 272, 768, 12, 7, True, False, fused=True,
                                      key0=True),
                                  k11(2, 200, 264, 768, 6, 5, False, False),
                                  k11(4, 264, 264, 768, 6, 5, True, False, fused=True,
                                      key0=True),
                                  k11(2, 200, 264, 576, 8, 5, False, False),
                                  k11(2, 264, 264, 384, 8, 5, True, False, fused=True),
                                  k11(2, 24, 40, 32, 4, 5, False, False),
                                  k11(2, 200, 264, 768, 12, 5, False, False,
                                      dtype=torch.float32),
                                  k11(4, 272, 272, 768, 12, 7, True, False, key0=True,
                                      dtype=torch.float32)]

    results["beam_attention"] = [
        k3(64, 5, 32, 768, 12, 31, True), k3(64, 5, 32, 768, 12, 0, True),
        k3(64, 5, 32, 768, 12, 15, True),
        k3(64, 5, 32, 768, 12, 31, False, ancestry="shared"),
        k3(64, 5, 32, 768, 12, 31, False, ancestry="distinct"),
        k3(16, 1, 32, 768, 12, 20, False), k3(16, 4, 32, 768, 12, 31, False),
        k3(8, 5, 32, 384, 12, 31, False), k3(8, 5, 32, 1536, 12, 31, False),
        k3(3, 5, 12, 32, 4, 6, False),
        k3(8, 5, 32, 768, 12, 31, False, q_dtype=torch.float32),
        k3(8, 5, 32, 768, 12, 31, False, cache_dtype=torch.float32),
        k3(8, 5, 32, 768, 12, 31, False, q_dtype=torch.float32, cache_dtype=torch.float32)]

    # K3's ring mode at the serving pool's shape (pool 112, K 5, T 32): window
    # lengths spread 1..32 with ring column 10 (the 21 lengths above 11 wrap
    # past column 0), every window at 32, every window at 1
    def k3_ring(B, K, T, D, H, ring_col, valid, what):
        q = randn(B * K, D) * (D // H) ** -0.5
        kc, vc = randn(B, K, T, D), randn(B, K, T, D)
        anc = torch.randint(0, K, (B * K, T), generator=g, device=dev, dtype=torch.int32)
        valid = torch.as_tensor(valid, dtype=torch.int32, device=dev)
        kw = dict(num_beams=K, num_heads=H, valid_counts=valid)
        out = ba.beam_gather_attention(q, kc, vc, anc, ring_col, **kw)
        ref = ba.beam_gather_attention_plain(q, kc, vc, anc, ring_col, **kw)
        err, tol = _max_err(out, ref), _bf16_tol(ref)
        _check(f"beam_gather_attention ring {what} {B}x{K}x{T}x{D} col={ring_col}", err, tol)
        wraps = int((valid > ring_col + 1).sum())
        res = {"shape": [B, K, T, D, H], "ring_col": ring_col, "valid": what,
               "windows_wrapping": wraps, "max_abs_err": err, "tol": tol}
        # the window visited oldest first: every sample's output equals the
        # scalar mode's on its window rotated to columns [0, n), bit for bit
        lengths = sorted(set(valid.tolist()))
        for n in set(lengths[::max(1, len(lengths) // 4)] + lengths[-1:]):
            rows = (valid == n).nonzero()[:, 0]
            cols = torch.remainder(ring_col - n + 1 + torch.arange(n, device=dev), T)
            bk = (rows[:, None] * K + torch.arange(K, device=dev)[None, :]).reshape(-1)
            scalar = ba.beam_gather_attention(
                q[bk].contiguous(), kc[rows][:, :, cols].contiguous(),
                vc[rows][:, :, cols].contiguous(), anc[bk][:, cols].contiguous(), n - 1,
                num_beams=K, num_heads=H)
            if not torch.equal(scalar, out[bk]):
                raise AssertionError(f"ring mode {what}: window length {n} differs from the "
                                     "scalar mode on the rotated window")
        res["equals_rotated_scalar"] = True
        res["ms"] = _time_ms(torch, lambda: ba.beam_gather_attention(q, kc, vc, anc, ring_col,
                                                                     **kw))
        res["plain_ms"] = _time_ms(torch, lambda: ba.beam_gather_attention_plain(
            q, kc, vc, anc, ring_col, **kw))
        res.update(_k3_ring_bound(torch, anc, B, K, T, D, ring_col, valid))
        return res

    spread = [1 + i % 32 for i in range(112)]
    results["beam_attention_ring"] = [
        k3_ring(112, 5, 32, 768, 12, 10, spread, "1..32"),
        k3_ring(112, 5, 32, 768, 12, 17, [32] * 112, "all 32"),
        k3_ring(112, 5, 32, 768, 12, 5, [1] * 112, "all 1")]
    if results["beam_attention_ring"][0]["windows_wrapping"] * 3 < 112:
        raise AssertionError("ring rows: fewer than a third of the windows wrap")

    # K4: [B*K, V] = [320, 50320] logits (ragged tail chunk); edge: forced
    # rows that are -inf except one column (49 all--inf chunks per row)
    def k4(R, V, forced, timed):
        x = randn(R, V, std=4.0, dtype=torch.float32)
        if forced:
            keep = torch.arange(V, device=dev) == 2
            x = torch.where(keep[None, :], x, -math.inf)
        cm, es = vs.chunk_stats(x)
        rcm, res_ = vs.chunk_stats_plain(x)
        if not (torch.equal(cm, rcm) and torch.isfinite(es).all()):
            raise AssertionError("chunk_stats: chunk maxima differ or exp-sums not finite")
        rel = float(((es - res_).abs() / res_.clamp(min=1e-30)).max())
        _check(f"chunk_stats {R}x{V} forced={forced}", rel, ES_RTOL)
        lse = vs.logsumexp_from_stats(cm, es)
        if forced and not torch.equal(lse, x[:, 2]):
            raise AssertionError("chunk_stats: forced-row logsumexp is not the kept logit")
        finite = torch.isfinite(rcm)  # equal -inf maxima already checked
        err = max(float((cm - rcm)[finite].abs().max()), float((es - res_).abs().max()))
        out = {"shape": [R, V], "forced": forced, "max_abs_err": err,
               "es_max_rel_err": rel, "tol": ES_RTOL}
        if timed:
            out["ms"] = _time_ms(torch, lambda: vs.chunk_stats(x))
            out["plain_ms"] = _time_ms(torch, lambda: vs.chunk_stats_plain(x))
            # a max, an exp and a sum for each logit, in fp32
            out.update(_bound(4 * R * V + 8 * R * cm.shape[1], f32_flops=3.0 * R * V))
        return out

    results["vocab_stats"] = [k4(320, 50320, False, True), k4(8, 50320, True, False)]

    # planted ties: the top-k must list equal values lowest index first
    x = torch.randn((4, 50320), generator=g, device=dev)
    x[0, [40000, 123, 4567]] = 9.0
    x[1, :] = 1.25
    x[2, [7, 50319]] = 5.0
    x[3, ::7] = -math.inf
    _, idx = top_k(x, 10)
    expect_first = [[123, 4567, 40000], list(range(10)), [7, 50319]]
    for row, want in enumerate(expect_first):
        got = idx[row, :len(want)].tolist()
        if got != want:
            raise AssertionError(f"top_k tie order row {row}: {got} != {want}")
    results["topk_ties"] = "lowest index first"
    return results


# ---------------------------------------------------------------------------
# phase 4: full-width generation
# ---------------------------------------------------------------------------

def random_jax_params(cfg, seed, heads=False):
    """Random weights in the JAX package's params.npz layout ("/"-joined
    pytree paths, [in, out] kernels, layers stacked on a leading axis); with
    ``heads``, the pretraining model's three classification heads too."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d, std = cfg.d_model, cfg.init_std

    def w(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * std)

    def ln(prefix, *lead):
        return {f"{prefix}/scale": 1.0 + w(*lead, d) * 5, f"{prefix}/bias": w(*lead, d)}

    n_pos = cfg.max_position_embeddings + cfg.extra_pos_embeddings
    p = {"model/shared": w(cfg.vocab_size, d), "final_logits_bias": w(cfg.vocab_size)}
    for side in ("encoder", "decoder"):
        base = f"model/{side}"
        L = cfg.encoder_layers if side == "encoder" else cfg.decoder_layers
        f = cfg.encoder_ffn_dim if side == "encoder" else cfg.decoder_ffn_dim
        p[f"{base}/embed_positions"] = w(n_pos, d)
        p.update(ln(f"{base}/layernorm_embedding"))
        lp = f"{base}/layers"
        for attn in ("self_attn",) + (("encoder_attn",) if side == "decoder" else ()):
            for proj in "qkvo":
                p[f"{lp}/{attn}/{proj}_kernel"] = w(L, d, d)
                p[f"{lp}/{attn}/{proj}_bias"] = w(L, d)
            p.update(ln(f"{lp}/{attn}_layer_norm", L))
        p.update({f"{lp}/fc1_kernel": w(L, d, f), f"{lp}/fc1_bias": w(L, f),
                  f"{lp}/fc2_kernel": w(L, f, d), f"{lp}/fc2_bias": w(L, d)})
        p.update(ln(f"{lp}/final_layer_norm", L))
    p["model/encoder/embed_images/kernel"] = w(cfg.image_feature_size, d)
    p["model/encoder/embed_images/bias"] = w(d)
    if heads:
        for name, d_in, n_out in (("mrm_head", d, cfg.num_labels),
                                  ("attribute_head", d, cfg.num_attributes),
                                  ("relation_head", 2 * d, cfg.num_relations)):
            p.update({f"{name}/dense_kernel": w(d_in, d), f"{name}/dense_bias": w(d),
                      f"{name}/out_kernel": w(d, n_out), f"{name}/out_bias": w(n_out)})
    return p


def write_checkpoint(path, cfg, seed, heads=False):
    import numpy as np
    os.makedirs(path, exist_ok=True)
    cfg.save_json(os.path.join(path, "config.json"))
    np.savez(os.path.join(path, "params.npz"), **random_jax_params(cfg, seed, heads))


@contextlib.contextmanager
def plain_path():
    """Route every kernel call site of the model (both directions) to the
    plain versions, to hold the kernel path against the plain path on the
    same card."""
    from kmbart_tpu_torch.generation import beam
    from kmbart_tpu_torch.models import bart
    from kmbart_tpu_torch.ops import beam_attention, ffn, lm_ce, train_attention, vocab_stats
    from kmbart_tpu_torch.ops import flash_attention
    swaps = [(train_attention, "train_attention_flat", train_attention.train_attention_plain),
             (train_attention, "train_attention_bwd", train_attention.train_attention_bwd_plain),
             (ffn, "fused_ffn", ffn.fused_ffn_plain),
             (ffn, "fused_ffn_bwd", ffn.fused_ffn_bwd_plain),
             (lm_ce, "lm_ce_fwd", lm_ce.lm_ce_fwd_plain),
             (lm_ce, "lm_ce_bwd", lm_ce.lm_ce_bwd_plain),
             (lm_ce, "lm_ce_fwd_stats", lm_ce.lm_ce_fwd_stats_plain),
             (lm_ce, "lm_ce_recompute_bwd", lm_ce.lm_ce_recompute_bwd_plain),
             (flash_attention, "flash_attention", flash_attention.flash_attention_plain),
             (bart, "beam_gather_attention", beam_attention.beam_gather_attention_plain),
             (beam, "chunk_stats", vocab_stats.chunk_stats_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_generate(torch, dev, card):
    import numpy as np
    from kmbart_tpu_torch import MultiModalBartConfig
    from kmbart_tpu_torch.checkpoint.io import load_pretrained
    from kmbart_tpu_torch.generation.api import generate
    from kmbart_tpu_torch.models import bart
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = MultiModalBartConfig.from_json(os.path.join(REPO, "config", "vcg_base.json"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_checkpoint(tmp, cfg, seed=0)
        _, model, _ = load_pretrained(tmp, device=dev)
        load_s = time.perf_counter() - t0

    B, T = 64, 72   # bench.py's decode batch: 72 tokens, rows 1-30 image slots
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 50000, (B, T))
    ids[:, 1:31] = cfg.img_feat_id
    input_ids = torch.as_tensor(ids, device=dev)
    mask = torch.ones((B, T), dtype=torch.long, device=dev)
    feats = torch.as_tensor(rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size)),
                            dtype=torch.float32, device=dev)
    batch = {"input_ids": input_ids, "attention_mask": mask, "image_features": feats}

    def gen():
        # the user-level entry point; it returns host tokens trimmed to the
        # HF output width, so the device work is done when it returns
        out = generate(model, cfg, batch, num_beams=5, max_length=32, early_stopping=True)
        return np.pad(out, ((0, 0), (0, 32 - out.shape[1])),
                      constant_values=cfg.pad_token_id), out.shape[1]

    gen()  # warm-up: cuBLAS handles, allocator
    reset_launch_counts()
    t0 = time.perf_counter()
    out, width = gen()
    seconds = time.perf_counter() - t0
    launches = {k: n for k, n in launch_counts().items() if k in GENERATE_KERNELS}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    steps = launches["beam_attention"] // cfg.decoder_layers
    if out.shape != (B, 32) or not (1 <= width <= 32) or out.min() < 0 \
            or out.max() >= cfg.vocab_size:
        raise AssertionError(f"bad generate output {tuple(out.shape)} width {width}")

    with torch.no_grad():
        def first_step():
            enc = bart.encode(model.model, cfg, input_ids, feats, mask)
            caches = bart.init_decode_cache_layers(model.model, cfg, enc, 32, num_beams=5)
            anc = torch.zeros((B * 5, 32), dtype=torch.int32, device=dev)
            prev = torch.full((B * 5, 1), cfg.decoder_start_token_id, device=dev)
            h = bart.decode_step_stationary(model.model, cfg, prev, caches, 0, anc, mask,
                                            num_beams=5)
            logits = bart.lm_logits(model.model, cfg, h, model.final_logits_bias)
            return enc.float(), torch.log_softmax(logits[:, 0], dim=-1)

        enc_k, lp_k = first_step()
        with plain_path():
            enc_p, lp_p = first_step()
    if not (torch.isfinite(enc_k).all() and torch.isfinite(lp_k).all()):
        raise AssertionError("non-finite encoder output or log-probs")
    enc_err = float((enc_k - enc_p).abs().max())
    enc_tol = ENC_ULPS / BF16_ULPS * _bf16_tol(enc_p)
    lp_err = float((lp_k - lp_p).abs().max())
    _check("encoder output vs plain path", enc_err, enc_tol)
    _check("first-step log-probs vs plain path", lp_err, LOGPROB_ATOL)

    # end to end, kernel path (K) against plain path (P) in turns K P P K K P
    # after the plain path's own warm-up; medians of three each
    def timed(plain):
        with plain_path() if plain else contextlib.nullcontext():
            t0 = time.perf_counter()
            result = gen()
            return time.perf_counter() - t0, result

    with plain_path():
        gen()
    times = {False: [seconds], True: []}
    for plain in (True, True, False, False, True):
        dt, result = timed(plain)
        times[plain].append(dt)
        if plain:
            out_p, width_p = result
    seconds, plain_seconds = (sorted(times[p])[1] for p in (False, True))
    same_rows = float((out == out_p).all(axis=1).mean())

    # one real K3 call, held against its plain version: the cache and the
    # ancestry of the last step of the first decoder layer, recorded in a
    # further generate call (each call's inputs copied as it is made)
    from kmbart_tpu_torch.ops import beam_attention
    kernel = bart.beam_gather_attention
    calls = []

    def record(q, kc, vc, anc, cache_index, **kw):
        if not calls or cache_index > calls[-1][4]:
            calls[:] = [(q.clone(), kc.clone(), vc.clone(), anc.clone(), cache_index, kw)]
        steps_read.append(_k3_bound(anc, kc.shape[0], kc.shape[1], kc.shape[3], cache_index))
        return kernel(q, kc, vc, anc, cache_index, **kw)

    steps_read = []
    bart.beam_gather_attention = record
    try:
        gen()
    finally:
        bart.beam_gather_attention = kernel
    q_r, kc_r, vc_r, anc_r, ci_r, kw_r = calls[-1]
    with torch.no_grad():
        k3_out = beam_attention.beam_gather_attention(q_r, kc_r, vc_r, anc_r, ci_r, **kw_r)
        k3_ref = beam_attention.beam_gather_attention_plain(q_r, kc_r, vc_r, anc_r, ci_r, **kw_r)
    k3_err = float((k3_out - k3_ref).abs().max())
    _check(f"beam_gather_attention on generate's step {ci_r}", k3_err, _bf16_tol(k3_ref))
    k3_bound_ms = sum(b["bound_ms"] for b in steps_read)

    emit("generate", card=card, config="config/vcg_base.json", batch=B, enc_len=T,
         num_beams=5, max_length=32, dtype=cfg.dtype, load_seconds=load_s,
         steps=steps, width=width, launches=launches,
         runs_s=times[False], plain_runs_s=times[True],
         sentences_per_s=B / seconds, ms_per_step=1e3 * seconds / steps,
         plain_sentences_per_s=B / plain_seconds,
         plain_ms_per_step=1e3 * plain_seconds / steps, plain_width=width_p,
         encoder_max_abs_err=enc_err, encoder_mean_abs_err=float((enc_k - enc_p).abs().mean()),
         encoder_max_abs=float(enc_p.abs().max()), encoder_tol=enc_tol,
         first_step_logprob_max_abs_err=lp_err, logprob_tol=LOGPROB_ATOL,
         rows_equal_to_plain=same_rows, k3_real_step=ci_r,
         k3_real_step_max_abs_err=k3_err, k3_real_step_tol=_bf16_tol(k3_ref),
         k3_real_step_ancestor_slots=int(anc_r[:, :ci_r + 1].unique().numel()))
    profile = _profile_steps(torch, gen, n=1)
    # K3 over one call: its device time beside the summed bound of the
    # launches recorded above (the rows each step's ancestry reads)
    profile.update(k3_launches=len(steps_read), k3_bound_ms_per_call=k3_bound_ms)
    emit("generate_profile", card=card, **profile)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the CLI twin
# ---------------------------------------------------------------------------

def make_dataset(out_dir):
    """The fixture dataset of tests/fixtures/make_dataset.py (its writers,
    loaded by path: tests/ is not a package) with the tokenizer assets and
    the tiny config made by the port's own modules, as that script's
    make_dataset makes them with the JAX package's."""
    import importlib.util
    import numpy as np
    from kmbart_tpu_torch.config import tiny_config
    from kmbart_tpu_torch.data.bpe import build_toy_assets
    from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
    path = os.path.join(REPO, "tests", "fixtures", "make_dataset.py")
    spec = importlib.util.spec_from_file_location("kmbart_fixture_make_dataset", path)
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    rng = np.random.default_rng(0)
    paths = {name: os.path.join(out_dir, name) for name in ("vcg", "coco", "vg", "reason")}
    for name in paths:
        os.makedirs(paths[name], exist_ok=True)
    fx.make_vcg(paths["vcg"], rng)
    fx.make_coco(paths["coco"], rng)
    fx.make_vg(paths["vg"], rng)
    fx.make_reason(paths["reason"], paths["vcg"], rng)
    paths["tokenizer"] = os.path.join(out_dir, "tokenizer")
    build_toy_assets(paths["tokenizer"])
    tok = ConditionTokenizer(assets_dir=paths["tokenizer"])
    cfg = tiny_config(
        vocab_size=len(tok) + 8, img_feat_id=tok.img_feat_id, cls_token_id=tok.cls_token_id,
        pad_token_id=tok.pad_token_id, bos_token_id=tok.bos_token_id,
        eos_token_id=tok.eos_token_id, decoder_start_token_id=tok.bos_token_id,
        image_feature_size=fx.FEAT_DIM + fx.BOX_DIM, num_labels=fx.NUM_MRM_LABELS,
        num_attributes=8, num_relations=8)
    paths["config"] = os.path.join(out_dir, "config.json")
    cfg.save_json(paths["config"])
    return paths


def run_cli(card):
    from kmbart_tpu_torch import MultiModalBartConfig

    with tempfile.TemporaryDirectory() as tmp:
        paths = make_dataset(os.path.join(tmp, "data"))
        cfg = MultiModalBartConfig.from_json(paths["config"])
        ckpt = os.path.join(tmp, "ckpt")
        write_checkpoint(ckpt, cfg, seed=1)
        out_file = os.path.join(tmp, "gen.json")
        cmd = [sys.executable, "-m", "kmbart_tpu_torch.vcg_generate",
               "--data_dir", paths["vcg"], "--output_file", out_file,
               "--checkpoint", ckpt, "--tokenizer_dir", paths["tokenizer"],
               "--num_beams", "5", "--num_gen", "2", "--batch_size", "6",
               "--max_length", "10", "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, timeout=600, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"CLI failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        with open(out_file) as f:
            gen = json.load(f)
    if len(gen) != 18 or not all(len(g["generations"]) == 2 for g in gen):
        raise AssertionError(f"CLI wrote {len(gen)} entries, expected 18 with 2 generations")
    emit("cli", card=card, entries=len(gen), seconds=seconds, num_beams=5)



# ---------------------------------------------------------------------------
# phase 6: full-width fine-tuning
# ---------------------------------------------------------------------------

def _train_batch(torch, cfg, dev, B=128, T_enc=72, T_dec=40, seed=0):
    """bench.py's fine-tune batch: 72 encoder tokens with rows 1-30 image
    slots, 40 decoder tokens, labels the decoder tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 50000, (B, T_enc))
    ids[:, 1:31] = cfg.img_feat_id
    dec = rng.integers(4, 50000, (B, T_dec))
    t = lambda a: torch.as_tensor(a, device=dev)
    return {"input_ids": t(ids), "attention_mask": t(np.ones((B, T_enc), np.int64)),
            "image_features": t(rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size))
                                .astype(np.float32)),
            "decoder_input_ids": t(dec), "decoder_attention_mask": t(np.ones((B, T_dec),
                                                                            np.int64)),
            "labels": t(dec.copy())}


def _leaf_norms(torch, model, groups):
    """{JAX leaf key: the norm of its tensors' gradients} (0 without one)."""
    from kmbart_tpu_torch.training.state import model_tensors
    tensors = model_tensors(model)
    norms = {}
    for key, names in groups.items():
        sq = [tensors[n].grad.float().square().sum() for n in names
              if tensors[n].grad is not None]
        norms[key] = float(torch.stack(sq).sum().sqrt()) if sq else 0.0
    return norms


def _max_rel(name, got, want, rtol):
    """The largest relative difference over the keys with a nonzero
    reference, checked against ``rtol``; returns (differences, worst key)."""
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want if want[k] != 0}
    worst = max(rel, key=rel.get)
    _check(f"{name} (relative, {worst})", rel[worst], rtol)
    if not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"{name}: non-finite values")
    return rel, worst


def run_train(torch, dev, card):
    from kmbart_tpu_torch import MultiModalBartConfig
    from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups, load_pretrained
    from kmbart_tpu_torch.models.conditional import conditional_loss
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    from kmbart_tpu_torch.parallel.train_step import build_train_step
    from kmbart_tpu_torch.training.adamw import AdamW
    from kmbart_tpu_torch.training.state import TrainState

    cfg = MultiModalBartConfig.from_json(os.path.join(REPO, "config", "vcg_base.json"))
    with tempfile.TemporaryDirectory() as tmp:
        write_checkpoint(tmp, cfg, seed=0)
        _, model, _ = load_pretrained(tmp, device=dev)
    batch = _train_batch(torch, cfg, dev)
    B = batch["input_ids"].shape[0]
    groups = jax_leaf_groups(cfg)

    # (i) one step's loss and gradients at dropout 0, kernel path against
    # plain path, with per-leaf gradient norms
    cfg0 = cfg.replace(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)

    def loss_and_norms():
        model.zero_grad(set_to_none=True)
        loss, _ = conditional_loss(model, cfg0, batch, train=True,
                                   generator=torch.Generator(device=dev).manual_seed(0))
        loss.backward()
        norms = _leaf_norms(torch, model, groups)
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), norms

    loss_k, norms_k = loss_and_norms()
    with plain_path():
        loss_p, norms_p = loss_and_norms()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    _check("fine-tune loss, kernel vs plain path (relative)", loss_rel, TRAIN_LOSS_RTOL)
    grad_rel = {k: abs(norms_k[k] - norms_p[k]) / norms_p[k] for k in norms_p if norms_p[k] > 0}
    worst = max(grad_rel, key=grad_rel.get)
    _check(f"per-leaf gradient norm, kernel vs plain path (relative, {worst})",
           grad_rel[worst], TRAIN_GRAD_NORM_RTOL)
    if not all(math.isfinite(v) for v in norms_k.values()):
        raise AssertionError("non-finite gradient norm on the kernel path")

    # (ii) ten AdamW steps on the fixed batch with the config's dropout
    def loss_fn(m, b, generator):
        loss, _ = conditional_loss(m, cfg, b, train=True, generator=generator)
        return loss, {}

    optimizer = AdamW(lr=1e-4, groups=groups)
    state = TrainState.create(model, optimizer)
    step = build_train_step(loss_fn, optimizer)
    n_steps = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    launches = {k: n for k, n in launch_counts().items() if k in TRAIN_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    per_step = {k: n / n_steps for k, n in launches.items()}
    if per_step != {k: float(n) for k, n in TRAIN_LAUNCHES.items()}:
        raise AssertionError(f"launches per step {per_step}, expected {TRAIN_LAUNCHES}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fine-tune losses not finite and falling: {losses}")
    if float(metrics["skipped"]) != 0.0:
        raise AssertionError("the non-finite guard skipped a step")
    timed = sorted(times[2:])          # the first steps warm the allocator and cuBLAS
    median = timed[len(timed) // 2]

    # the same step on the plain path, in turns with the kernel path
    # (K P P K, three steps each, after one plain warm-up step)
    def steps(plain, n=3):
        nonlocal state
        out = []
        with plain_path() if plain else contextlib.nullcontext():
            for _ in range(n):
                t0 = time.perf_counter()
                state, _ = step(state, batch, 0)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
        return out

    steps(True, 1)
    turns = {False: [], True: []}
    for plain in (False, True, True, False):
        turns[plain] += steps(plain)
    k_med, p_med = (sorted(turns[p])[len(turns[p]) // 2] for p in (False, True))
    profile = _profile_steps(torch, lambda: step(state, batch, 0))
    emit("train", card=card, config="config/vcg_base.json", batch=B, enc_len=72, dec_len=40,
         dtype=cfg.dtype, dropout=cfg.dropout, lr=1e-4, losses=losses,
         loss_kernel_path=loss_k, loss_plain_path=loss_p, loss_rel_err=loss_rel,
         loss_rtol=TRAIN_LOSS_RTOL, grad_norm_max_rel_err=grad_rel[worst],
         grad_norm_worst_leaf=worst, grad_norm_rtol=TRAIN_GRAD_NORM_RTOL,
         grad_norm_rel_errs=grad_rel, launches=launches, launches_per_step=per_step,
         step_s=times, ms_per_step=1e3 * median, samples_per_s=B / median,
         peak_memory_gb=peak_gb, turns_kernel_s=turns[False], turns_plain_s=turns[True],
         turns_kernel_ms_per_step=1e3 * k_med, turns_plain_ms_per_step=1e3 * p_med)
    emit("train_profile", card=card, **profile)
    return launches


def _profile_steps(torch, run_step, n=3):
    """Device-busy share and the top device kernels over ``n`` steps (or
    generate calls) under torch.profiler (kernels run on one stream, so
    their device times add up without overlap); K1, K1b, K2, K2b, K7-K10
    and K11 summed over their kernels."""
    from torch.profiler import ProfilerActivity, profile
    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    from torch.autograd import DeviceType
    dev = lambda e: e.self_device_time_total
    # device kernels only: a host op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    busy_ms = sum(dev(e) for e in events) / 1e3
    top = sorted(events, key=dev, reverse=True)[:15]
    # K1 and K1b over all their instantiations (they may rank below the
    # top); K2 is its two GEMMs and the split-K finalize (a decode step's
    # only; training rows never split), K2b its two GEMMs
    per_step = lambda *tags: sum(dev(e) for e in events
                                 if any(t in e.key for t in tags)) / 1e3 / n
    k2, k2b = per_step("ffn_fwd_gemm", "ffn_finalize"), per_step("ffn_bwd_gemm")
    # the LM-CE kernels: K7 or K9 (a projection and the merge), K8 or K10
    # (a dlogits launch and the dh GEMM with its split-K finalize); a step
    # runs one pair, "fwdbwd" or "nomat", so the shared merge and dh GEMM
    # go to the pair whose own kernel ran. K11, K3 (the bf16 cache's kernel)
    merge, dh = per_step("lm_ce_merge_kernel"), per_step("lm_ce_dh_")
    k7, k9 = per_step("lm_ce_logits_gemm"), per_step("lm_ce_stats_gemm")
    k8, k10 = per_step("lm_ce_dlogits_kernel"), per_step("lm_ce_dlogits_gemm")
    if k7:
        k7 += merge
    elif k9:
        k9 += merge
    if k8:
        k8 += dh
    elif k10:
        k10 += dh
    k11 = per_step("flash_attention_wg", "flash_attention_tc")
    return {"steps": n, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "k1_ms_per_step": per_step("attn_fwd_tc"),
            "k1b_ms_per_step": per_step("attn_bwd_tc"),
            "k2_ms_per_step": k2, "k2_share": k2 * n / busy_ms,
            "k2b_ms_per_step": k2b, "k2b_share": k2b * n / busy_ms,
            "k7_ms_per_step": k7, "k7_share": k7 * n / busy_ms,
            "k8_ms_per_step": k8, "k8_share": k8 * n / busy_ms,
            "k9_ms_per_step": k9, "k9_share": k9 * n / busy_ms,
            "k10_ms_per_step": k10, "k10_share": k10 * n / busy_ms,
            "k11_ms_per_step": k11, "k11_share": k11 * n / busy_ms,
            "k3_ms_per_step": per_step("beam_attention_bf16"),
            "top_device_ops": [{"name": e.key[:80], "calls": e.count,
                                "ms_per_step": dev(e) / 1e3 / n,
                                "share": dev(e) / 1e3 / busy_ms} for e in top]}


# ---------------------------------------------------------------------------
# phase 7: the fine-tune CLI twin
# ---------------------------------------------------------------------------

def run_train_cli(card):
    with tempfile.TemporaryDirectory() as tmp:
        paths = make_dataset(os.path.join(tmp, "data"))
        ckpt_dir = os.path.join(tmp, "ckpt")
        cmd = [sys.executable, "-m", "kmbart_tpu_torch.vcg_train",
               "--data_dir", paths["vcg"], "--checkpoint_dir", ckpt_dir,
               "--model_config", paths["config"], "--tokenizer_dir", paths["tokenizer"],
               "--epochs", "1", "--batch_size", "6", "--validate_loss", "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, timeout=600, capture_output=True, text=True)
        train_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"train CLI failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        (run,) = os.listdir(ckpt_dir)
        model0 = os.path.join(ckpt_dir, run, "model0")
        for name in ("config.json", "params.npz", "training_data.npz"):
            if not os.path.exists(os.path.join(model0, name)):
                raise AssertionError(f"train CLI wrote no model0/{name}")
        out_file = os.path.join(tmp, "gen.json")
        cmd = [sys.executable, "-m", "kmbart_tpu_torch.vcg_generate",
               "--data_dir", paths["vcg"], "--output_file", out_file, "--checkpoint", model0,
               "--tokenizer_dir", paths["tokenizer"], "--num_beams", "2", "--batch_size", "6",
               "--max_length", "10", "--device", "cuda"]
        proc = subprocess.run(cmd, cwd=REPO, timeout=600, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"generate from model0 failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        with open(out_file) as f:
            gen = json.load(f)
    if len(gen) != 18:
        raise AssertionError(f"generate from model0 wrote {len(gen)} entries, expected 18")
    emit("train_cli", card=card, train_seconds=train_s, generated_entries=len(gen))

# ---------------------------------------------------------------------------
# phases 8-10: multi-task pretraining
# ---------------------------------------------------------------------------

def _pretrain_batch(torch, cfg, dev, B, T_enc, T_dec, R=80, seed=0):
    """A batch shaped as the pretraining collator makes it: encoder rows
    1-30 image slots, a fifth of them masked regions (cls tokens, which keep
    their ROI feature), the odd rows' last 6 encoder tokens padded; the
    decoder's image span at rows 1-30 with the same cls tokens, labels -100
    on that span except at the masked regions, which carry the detector's
    soft labels; attributes on about half the image slots; 10 relation
    pairs a row among R."""
    import numpy as np
    rng = np.random.default_rng(seed)
    N = cfg.max_img_num
    ids = rng.integers(4, 50000, (B, T_enc))
    ids[:, 1:1 + N] = cfg.img_feat_id
    masked = rng.random((B, N)) < 0.2
    ids[:, 1:1 + N][masked] = cfg.cls_token_id
    attention_mask = np.ones((B, T_enc), np.int64)
    attention_mask[1::2, -6:] = 0
    dec = rng.integers(4, 50000, (B, T_dec))
    dec[:, 1:1 + N] = ids[:, 1:1 + N]
    labels = rng.integers(4, 50000, (B, T_dec))
    labels[:, 1:1 + N] = np.where(masked, cfg.cls_token_id, -100)
    attribute_mask = np.zeros((B, T_dec), np.float32)
    attribute_mask[:, 1:1 + N] = rng.random((B, N)) < 0.5
    relation_mask = np.zeros((B, R), bool)
    relation_mask[:, :10] = True
    gen = torch.Generator(device=dev).manual_seed(seed)
    soft = torch.softmax(2.0 * torch.randn((B, T_dec, cfg.num_labels), generator=gen,
                                           device=dev), dim=-1)
    t = lambda a: torch.as_tensor(a, device=dev)
    return {"input_ids": t(ids), "attention_mask": t(attention_mask),
            "image_features": t(rng.normal(size=(B, N, cfg.image_feature_size))
                                .astype(np.float32)),
            "decoder_input_ids": t(dec), "decoder_attention_mask": t(np.ones((B, T_dec),
                                                                            np.int64)),
            "labels": t(labels), "mrm_soft_labels": soft,
            "mrm_mask": t(labels == cfg.cls_token_id),
            "attribute_labels": t(rng.integers(0, cfg.num_attributes, (B, T_dec))),
            "attribute_mask": t(attribute_mask),
            "relation_pairs": t(rng.integers(1, 1 + N, (B, R, 2))),
            "relation_labels": t(rng.integers(0, cfg.num_relations, (B, R))),
            "relation_mask": t(relation_mask)}


def _pretrain_setup(torch, dev, seed):
    from kmbart_tpu_torch import MultiModalBartConfig
    from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups, load_pretrained
    from kmbart_tpu_torch.models.pretraining import init_pretraining_model
    cfg = MultiModalBartConfig.from_json(os.path.join(REPO, "config", "pretrain_base.json"))
    with tempfile.TemporaryDirectory() as tmp:
        write_checkpoint(tmp, cfg, seed, heads=True)
        _, model, report = load_pretrained(tmp, device=dev, init_model_fn=init_pretraining_model)
    if report:
        raise AssertionError(f"pretraining checkpoint did not load whole: {report}")
    return cfg, model, jax_leaf_groups(cfg, heads=True)


@contextlib.contextmanager
def _ce_mode(mode):
    """KMBART_FUSED_CE_MODE set to ``mode`` (the LM loss reads it per call)."""
    saved = os.environ.get("KMBART_FUSED_CE_MODE")
    os.environ["KMBART_FUSED_CE_MODE"] = mode
    try:
        yield
    finally:
        if saved is None:
            del os.environ["KMBART_FUSED_CE_MODE"]
        else:
            os.environ["KMBART_FUSED_CE_MODE"] = saved


def _losses_and_norms(torch, model, cfg, batch, groups):
    """One step at dropout 0: the five losses and per-leaf gradient norms."""
    from kmbart_tpu_torch.models.pretraining import pretraining_loss
    cfg0 = cfg.replace(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                       classif_dropout=0.0)
    model.zero_grad(set_to_none=True)
    total, aux = pretraining_loss(model, cfg0, batch, train=True)
    total.backward()
    norms = _leaf_norms(torch, model, groups)
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in aux["losses"].items()}, norms


def _pretrain_paths(torch, model, cfg, batch, groups):
    """The kernel path against the plain path at dropout 0: the five losses
    and per-leaf gradient norms of each, and their relative differences."""
    lk, nk = _losses_and_norms(torch, model, cfg, batch, groups)
    with plain_path():
        lp, np_ = _losses_and_norms(torch, model, cfg, batch, groups)
    loss_rel, loss_worst = _max_rel("pretraining losses, kernel vs plain path", lk, lp,
                                    TRAIN_LOSS_RTOL)
    grad_rel, grad_worst = _max_rel("per-leaf gradient norm, kernel vs plain path", nk, np_,
                                    TRAIN_GRAD_NORM_RTOL)
    return {"losses_kernel_path": lk, "losses_plain_path": lp,
            "loss_max_rel_err": loss_rel[loss_worst], "loss_worst": loss_worst,
            "grad_norm_max_rel_err": grad_rel[grad_worst], "grad_norm_worst_leaf": grad_worst,
            "_norms": nk}


def _pretrain_steps(torch, state, step, batch, n, expect_launches, what):
    """``n`` train steps on one batch: launches per step against
    ``expect_launches``, losses finite and falling; returns (state, stats)."""
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, heads = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
        heads.append({k: metrics[k] for k in ("lm_loss", "mrm_loss", "attribute_loss",
                                              "relation_loss")})
    counts = launch_counts()
    per_step = {k: counts[k] / n for k in expect_launches}
    if per_step != {k: float(v) for k, v in expect_launches.items()}:
        raise AssertionError(f"{what}: launches per step {per_step}, expected "
                             f"{expect_launches}")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: losses not finite and falling: {losses}")
    if float(metrics["skipped"]) != 0.0:
        raise AssertionError(f"{what}: the non-finite guard skipped a step")
    timed = sorted(times[2:] if n > 4 else times[1:])
    median = timed[len(timed) // 2]
    return state, {"losses": losses, "head_losses_last": {k: float(v) for k, v in
                                                          heads[-1].items()},
                   "launches": {k: counts[k] for k in expect_launches},
                   "launches_per_step": per_step, "step_s": times, "ms_per_step": 1e3 * median,
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _pretrain_step_fn(cfg, groups, lr=1e-4):
    from kmbart_tpu_torch.models.pretraining import pretraining_loss
    from kmbart_tpu_torch.parallel.train_step import build_train_step
    from kmbart_tpu_torch.training.adamw import AdamW

    def loss_fn(m, b, generator):
        loss, aux = pretraining_loss(m, cfg, b, train=True, generator=generator)
        return loss, {k: v for k, v in aux["losses"].items() if k != "loss"}

    optimizer = AdamW(lr=lr, groups=groups)
    return optimizer, build_train_step(loss_fn, optimizer)


def run_pretrain(torch, dev, card):
    """Phase 8; returns the launch counts of the nomat run."""
    from kmbart_tpu_torch.training.state import TrainState
    cfg, model, groups = _pretrain_setup(torch, dev, seed=0)
    B, T_enc, T_dec = 128, 96, 72   # the collator's lengths at the CLI defaults
    batch = _pretrain_batch(torch, cfg, dev, B, T_enc, T_dec)
    init = {k: v.clone() for k, v in model.state_dict().items()}

    # (i) kernel path against plain path at dropout 0, in each mode; (ii)
    # nomat against fwdbwd on the kernel path
    paths = {}
    for mode in ("fwdbwd", "nomat"):
        with _ce_mode(mode):
            paths[mode] = _pretrain_paths(torch, model, cfg, batch, groups)
    modes_loss_rel, modes_loss_worst = _max_rel(
        "pretraining losses, nomat vs fwdbwd", paths["nomat"]["losses_kernel_path"],
        paths["fwdbwd"]["losses_kernel_path"], TRAIN_LOSS_RTOL)
    modes_grad_rel, modes_grad_worst = _max_rel(
        "per-leaf gradient norm, nomat vs fwdbwd", paths["nomat"].pop("_norms"),
        paths["fwdbwd"]["_norms"], TRAIN_GRAD_NORM_RTOL)
    # the same fwdbwd step once more: the run-to-run spread of the gradients
    # (atomic scatter-adds in the embedding and gather backwards)
    with _ce_mode("fwdbwd"):
        _, again = _losses_and_norms(torch, model, cfg, batch, groups)
    repeat_rel, repeat_worst = _max_rel("per-leaf gradient norm, fwdbwd repeated", again,
                                        paths["fwdbwd"].pop("_norms"), TRAIN_GRAD_NORM_RTOL)

    # (iii) ten AdamW steps in each mode from the same weights, config dropout
    runs, launches = {}, None
    for mode in ("fwdbwd", "nomat"):
        model.load_state_dict(init)
        optimizer, step = _pretrain_step_fn(cfg, groups)
        state = TrainState.create(model, optimizer)
        with _ce_mode(mode):
            state, runs[mode] = _pretrain_steps(torch, state, step, batch, 10,
                                                PRETRAIN_LAUNCHES[mode], f"pretrain {mode}")
        runs[mode]["samples_per_s"] = B / (runs[mode]["ms_per_step"] / 1e3)
        if mode == "nomat":
            launches = runs[mode]["launches"]
    # (iv) the two modes in turns (F N N F, three steps each) on one state
    turns = {"fwdbwd": [], "nomat": []}
    for mode in ("fwdbwd", "nomat", "nomat", "fwdbwd"):
        with _ce_mode(mode):
            for _ in range(3):
                t0 = time.perf_counter()
                state, _ = step(state, batch, 0)
                torch.cuda.synchronize()
                turns[mode].append(time.perf_counter() - t0)
    turn_ms = {m: 1e3 * sorted(v)[len(v) // 2] for m, v in turns.items()}
    profiles = {}
    for mode in ("fwdbwd", "nomat"):
        with _ce_mode(mode):
            profiles[mode] = _profile_steps(torch, lambda: step(state, batch, 0))
    emit("pretrain", card=card, config="config/pretrain_base.json", batch=B, enc_len=T_enc,
         dec_len=T_dec, image_slots=cfg.max_img_num, relation_pairs=80, dtype=cfg.dtype,
         dropout=cfg.dropout, lr=1e-4, paths=paths,
         nomat_vs_fwdbwd_loss_max_rel_err=modes_loss_rel[modes_loss_worst],
         nomat_vs_fwdbwd_grad_norm_max_rel_err=modes_grad_rel[modes_grad_worst],
         nomat_vs_fwdbwd_grad_norm_worst_leaf=modes_grad_worst,
         fwdbwd_repeat_grad_norm_max_rel_err=repeat_rel[repeat_worst],
         fwdbwd_repeat_grad_norm_worst_leaf=repeat_worst, runs=runs,
         turns_s=turns, turns_ms_per_step=turn_ms)
    for mode, profile in profiles.items():
        emit("pretrain_profile", card=card, mode=mode, **profile)
    return launches


def run_pretrain_long(torch, dev, card):
    """Phase 9; returns the launch counts of its steps."""
    from kmbart_tpu_torch.training.state import TrainState
    cfg, model, groups = _pretrain_setup(torch, dev, seed=1)
    # the collator's lengths at --lm_max_len 224: encoder round8(1 + 32 + 22
    # + 226 + 8) = 296, decoder round8(32 + 224 + 1 + 8) = 272
    B, T_enc, T_dec = 32, 296, 272
    batch = _pretrain_batch(torch, cfg, dev, B, T_enc, T_dec, seed=1)
    with _ce_mode("fwdbwd"):
        paths = _pretrain_paths(torch, model, cfg, batch, groups)
        paths.pop("_norms")
        optimizer, step = _pretrain_step_fn(cfg, groups)
        state = TrainState.create(model, optimizer)
        state, run = _pretrain_steps(torch, state, step, batch, 4, PRETRAIN_LONG_LAUNCHES,
                                     "pretrain_long")
        profile = _profile_steps(torch, lambda: step(state, batch, 0))
    run["samples_per_s"] = B / (run["ms_per_step"] / 1e3)
    emit("pretrain_long", card=card, config="config/pretrain_base.json", batch=B,
         enc_len=T_enc, dec_len=T_dec, lm_max_len=224, dtype=cfg.dtype, paths=paths, **run)
    emit("pretrain_long_profile", card=card, mode="fwdbwd", **profile)
    return run["launches"]


def run_pretrain_cli(card):
    """Phase 10: the pretrain twin on the fixture, then a fine-tune epoch of
    the vcg_train twin from its model0/."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = make_dataset(os.path.join(tmp, "data"))
        ckpt_dir, ft_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "ft")
        cmd = [sys.executable, "-m", "kmbart_tpu_torch.pretrain",
               "--dataset", "coco_train", paths["coco"], "--dataset", "vg_train", paths["vg"],
               "--dataset", "vcg_train", paths["vcg"],
               "--dataset", "coco_reason_train", paths["reason"],
               "--checkpoint_dir", ckpt_dir, "--model_config", paths["config"],
               "--tokenizer_dir", paths["tokenizer"], "--epochs", "1", "--batch_size", "8",
               "--max_img_num", "4", "--lr", "1e-3", "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, timeout=600, capture_output=True, text=True)
        pretrain_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"pretrain CLI failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        (run,) = os.listdir(ckpt_dir)
        model0 = os.path.join(ckpt_dir, run, "model0")
        for name in ("config.json", "params.npz", "training_data.npz"):
            if not os.path.exists(os.path.join(model0, name)):
                raise AssertionError(f"pretrain CLI wrote no model0/{name}")
        cmd = [sys.executable, "-m", "kmbart_tpu_torch.vcg_train",
               "--data_dir", paths["vcg"], "--checkpoint_dir", ft_dir, "--checkpoint", model0,
               "--tokenizer_dir", paths["tokenizer"], "--epochs", "1", "--batch_size", "6",
               "--device", "cuda"]
        proc = subprocess.run(cmd, cwd=REPO, timeout=600, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"vcg_train from model0 failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        if "unused checkpoint keys: 12" not in proc.stdout:
            raise AssertionError("vcg_train did not drop the 12 head tensors of model0")
        (ft_run,) = os.listdir(ft_dir)
        if not os.path.exists(os.path.join(ft_dir, ft_run, "model0", "params.npz")):
            raise AssertionError("vcg_train from model0 wrote no model0/params.npz")
    emit("pretrain_cli", card=card, pretrain_seconds=pretrain_s,
         finetune_from_model0="ok, 12 head tensors dropped")


# ---------------------------------------------------------------------------
# phases 11-12: sampling and serving
# ---------------------------------------------------------------------------

def _base_model(dev, seed):
    """config/vcg_base.json with random weights from ``seed``, loaded the
    way a user loads a checkpoint."""
    from kmbart_tpu_torch import MultiModalBartConfig
    from kmbart_tpu_torch.checkpoint.io import load_pretrained
    cfg = MultiModalBartConfig.from_json(os.path.join(REPO, "config", "vcg_base.json"))
    with tempfile.TemporaryDirectory() as tmp:
        write_checkpoint(tmp, cfg, seed=seed)
        _, model, _ = load_pretrained(tmp, device=dev)
    return cfg, model


def run_sample(torch, dev, card):
    """generate() with do_sample, top_k 50 and top_p 0.9 at batch 64, beam 5
    and greedy: one generator seed gives the same tokens twice, and the
    kernels of the path launch (K4 on the beam path's fast sampling)."""
    import numpy as np
    from kmbart_tpu_torch.generation.api import generate
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg, model = _base_model(dev, seed=0)
    B, T = 64, 72
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 50000, (B, T))
    ids[:, 1:31] = cfg.img_feat_id
    batch = {"input_ids": torch.as_tensor(ids, device=dev),
             "attention_mask": torch.ones((B, T), dtype=torch.long, device=dev),
             "image_features": torch.as_tensor(
                 rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size)),
                 dtype=torch.float32, device=dev)}
    result = {}
    for mode, beams in (("beam5", 5), ("greedy", 1)):
        def gen(seed=7):
            return generate(model, cfg, batch, num_beams=beams, max_length=32,
                            early_stopping=True, do_sample=True, top_k=50, top_p=0.9,
                            trim=False, generator=torch.Generator(device=dev).manual_seed(seed))
        gen(seed=1)   # warm-up
        reset_launch_counts()
        t0 = time.perf_counter()
        first = gen()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        want = ("train_attention", "ffn", "beam_attention") + (("vocab_stats",) if beams > 1
                                                                else ())
        missing = [k for k in want if counts[k] == 0]
        if missing:
            raise AssertionError(f"sample {mode}: kernels not launched: {missing}")
        if not np.array_equal(first, gen()):
            raise AssertionError(f"sample {mode}: one generator seed gave two outputs")
        if first.shape != (B, 32) or first.min() < 0 or first.max() >= cfg.vocab_size:
            raise AssertionError(f"sample {mode}: bad output {first.shape}")
        result[mode] = {"sentences_per_s": B / seconds, "seconds": seconds,
                        "launches": {k: counts[k] for k in want}, "same_seed_identical": True,
                        "distinct_rows": int(len({r.tobytes() for r in first}))}
    emit("sample", card=card, config="config/vcg_base.json", batch=B, enc_len=T,
         top_k=50, top_p=0.9, max_length=32, **result)


SERVE_POOL, SERVE_CHUNK, SERVE_BEAMS, SERVE_MAXLEN, SERVE_ENC = 112, 4, 5, 32, 96
SERVE_KERNELS = ("train_attention", "ffn", "beam_attention_ring", "vocab_stats")


def _serve_requests(np, cfg, n, seed):
    """n requests padded to the pool's 96 encoder tokens: 40-96 real tokens,
    the first 30 after BOS image slots, with 30 ROI features each."""
    rng = np.random.default_rng(seed)
    E = SERVE_ENC
    ids = np.full((n, E), cfg.pad_token_id, np.int64)
    mask = np.zeros((n, E), np.int64)
    widths = rng.integers(40, E + 1, n)
    for i, w in enumerate(widths):
        ids[i, :w] = rng.integers(4, 50000, w)
        ids[i, 1:31] = cfg.img_feat_id
        mask[i, :w] = 1
    feats = rng.normal(size=(n, cfg.max_img_num, cfg.image_feature_size)).astype(np.float32)
    return ids, mask, feats, widths


def _row_invariance(torch, dev, model, cfg, A=32, B=112):
    """Whether each GEMM shape of the encoder and of the admit's cross K/V
    gives a row the same bits at A samples as at B samples (``dense``'s
    bf16 product with an fp32 result), and whether a row's place in the
    batch matters; the model's blocked image projection and K2 (the fused
    FFN) likewise."""
    from kmbart_tpu_torch.models.bart import image_projection
    from kmbart_tpu_torch.ops.ffn import ffn
    from kmbart_tpu_torch.ops.layers import matmul_f32
    g = torch.Generator(device=dev).manual_seed(5)
    E, D, F, R = SERVE_ENC, cfg.d_model, cfg.encoder_ffn_dim, cfg.max_img_num
    shapes = {"image_projection": (R, cfg.image_feature_size, D), "qkv": (E, D, 3 * D),
              "out_proj_and_cross_kv": (E, D, D)}
    out = {}
    for name, (rows, k, n) in shapes.items():
        x = torch.randn((B * rows, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((n, k), generator=g, device=dev) * 0.02)
        small = matmul_f32(x[:A * rows], w)
        moved = matmul_f32(torch.roll(x[:A * rows], rows, 0), w)
        out[name] = {"rows": [A * rows, B * rows], "same_at_both_widths":
                     bool(torch.equal(small, matmul_f32(x, w)[:A * rows])),
                     "same_at_another_place": bool(torch.equal(small,
                                                               torch.roll(moved, -rows, 0)))}
    f = torch.randn((B, R, cfg.image_feature_size), generator=g, device=dev)
    small = image_projection(model.model, f[:A], torch.bfloat16)
    out["image_projection_blocked"] = {
        "rows": [A * R, B * R], "same_at_both_widths": bool(torch.equal(
            small, image_projection(model.model, f, torch.bfloat16)[:A])),
        "same_at_another_place": bool(torch.equal(
            small[1:], image_projection(model.model, f[1:A + 1], torch.bfloat16)[:A - 1]))}
    x = torch.randn((B * E, D), generator=g, device=dev).to(torch.bfloat16)
    w1 = (torch.randn((F, D), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    w2 = (torch.randn((D, F), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    b1, b2 = torch.zeros(F, device=dev), torch.zeros(D, device=dev)
    out["k2_ffn"] = {"rows": [A * E, B * E], "same_at_both_widths": bool(torch.equal(
        ffn(x[:A * E], w1, b1, w2, b2), ffn(x, w1, b1, w2, b2)[:A * E]))}
    return out


def run_serve(torch, dev, card):
    """The continuous engine at serve.py's defaults: 224 requests in four
    staggered bursts, each request's tokens equal to generate()'s on the
    same row (batches of 112, the pool's decode shape), and the encoder
    GEMMs' row invariance between the admit's 32 samples and 112; then 64
    requests through the static engine and one POST through the HTTP
    server."""
    import urllib.request
    import numpy as np
    from kmbart_tpu_torch.generation.api import generate
    from kmbart_tpu_torch.models import bart
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    from kmbart_tpu_torch.serving.continuous import ContinuousGenerationEngine
    from kmbart_tpu_torch.serving.engine import GenerationEngine
    from kmbart_tpu_torch.serving.http import serve
    cfg, model = _base_model(dev, seed=0)
    N, bursts = 224, 4
    ids, mask, feats, widths = _serve_requests(np, cfg, N, seed=3)

    engine = ContinuousGenerationEngine(
        model, cfg, pool_size=SERVE_POOL, encoder_seq_len=SERVE_ENC, chunk_steps=SERVE_CHUNK,
        num_beams=SERVE_BEAMS, max_length=SERVE_MAXLEN, early_stopping=True)

    def burst_run(rows, gap_s):
        """Submit ``rows`` in four bursts ``gap_s`` apart; wait for all."""
        done_at, sent_at, futs = {}, {}, {}
        per = -(-len(rows) // bursts)
        for b in range(bursts):
            for i in rows[b * per:(b + 1) * per]:
                sent_at[i] = time.perf_counter()
                futs[i] = engine.submit(ids[i:i + 1, :widths[i]], mask[i:i + 1, :widths[i]],
                                        feats[i:i + 1])
                futs[i].add_done_callback(
                    lambda _f, i=i: done_at.__setitem__(i, time.perf_counter()))
            if b + 1 < bursts:
                time.sleep(gap_s)
        outs = {i: f.result(timeout=600) for i, f in futs.items()}
        return outs, sent_at, done_at

    try:
        # warm-up: cuBLAS handles, the allocator, the kernels' first launches
        burst_run(list(range(8)), 0.0)
        torch.cuda.synchronize()
        reset_launch_counts()
        outs, sent_at, done_at = burst_run(list(range(N)), 0.25)
        launches = {k: n for k, n in launch_counts().items() if k in SERVE_KERNELS}
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"serve: kernels not launched: {missing}")
        lat = np.array([done_at[i] - sent_at[i] for i in range(N)])
        wall = max(done_at.values()) - min(sent_at.values())
        profile = _profile_steps(torch, lambda: burst_run(list(range(SERVE_POOL)), 0.0), n=1)
    finally:
        engine.shutdown()
    got = np.concatenate([outs[i] for i in range(N)])

    # the reference: generate() on the same padded rows, in batches of 112
    ref = np.concatenate([generate(
        model, cfg, {"input_ids": torch.as_tensor(ids[s:s + SERVE_POOL], device=dev),
                     "attention_mask": torch.as_tensor(mask[s:s + SERVE_POOL], device=dev),
                     "image_features": torch.as_tensor(feats[s:s + SERVE_POOL], device=dev)},
        num_beams=SERVE_BEAMS, max_length=SERVE_MAXLEN, early_stopping=True, trim=False)
        for s in range(0, N, SERVE_POOL)])
    equal = (got == ref).all(axis=1)
    with torch.no_grad():
        t = lambda a: torch.as_tensor(a, device=dev)
        enc32 = bart.encode(model.model, cfg, t(ids[:32]), t(feats[:32]), t(mask[:32]))
        enc112 = bart.encode(model.model, cfg, t(ids[:112]), t(feats[:112]),
                             t(mask[:112]))[:32]
        invariance = _row_invariance(torch, dev, model, cfg)
    emit("serve_row_invariance", card=card, encoder_rows_equal_at_32_and_112=bool(
        torch.equal(enc32, enc112)), **invariance)
    fields = dict(card=card, config="config/vcg_base.json", requests=N, bursts=bursts,
                  burst_gap_s=0.25, pool=SERVE_POOL, chunk_steps=SERVE_CHUNK,
                  num_beams=SERVE_BEAMS, max_length=SERVE_MAXLEN, encoder_seq_len=SERVE_ENC,
                  admit_width=32, requests_per_s=N / wall, wall_s=wall,
                  latency_p50_s=float(np.percentile(lat, 50)),
                  latency_p99_s=float(np.percentile(lat, 99)),
                  latency_max_s=float(lat.max()), launches=launches,
                  k3_ring_launches=launches["beam_attention_ring"],
                  k4_launches=launches["vocab_stats"],
                  device_busy_share=profile["device_busy_share"], profile=profile,
                  rows_equal_to_generate=float(equal.mean()))
    if not equal.all():
        bad = np.nonzero(~equal)[0]
        emit("serve", **fields, mismatched_rows=bad[:20].tolist(),
             first_differing_position=[int(np.nonzero(got[i] != ref[i])[0][0])
                                       for i in bad[:10]])
        raise AssertionError(f"serve: {len(bad)} of {N} requests differ from generate()")

    # the static engine: 64 requests, coalesced into batches of up to 32
    static = GenerationEngine(model, cfg, max_batch_size=32, encoder_seq_len=SERVE_ENC,
                              num_beams=SERVE_BEAMS, max_length=SERVE_MAXLEN,
                              early_stopping=True)
    server = None
    try:
        t0 = time.perf_counter()
        futs = [static.submit(ids[i:i + 1, :widths[i]], mask[i:i + 1, :widths[i]],
                              feats[i:i + 1]) for i in range(64)]
        static_out = np.concatenate([f.result(timeout=600) for f in futs])
        static_s = time.perf_counter() - t0
        if static_out.shape != (64, SERVE_MAXLEN) or static_out.min() < 0:
            raise AssertionError(f"static engine: bad output {static_out.shape}")
        server = serve(static, port=0, block=False)
        body = json.dumps({"input_ids": ids[:1, :widths[0]].tolist(),
                           "image_features": feats[:1].tolist()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/generate",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            http_out = np.asarray(json.loads(r.read())["token_ids"])
        if http_out.shape != (1, SERVE_MAXLEN):
            raise AssertionError(f"HTTP: bad output {http_out.shape}")
    finally:
        if server is not None:
            server.shutdown()
        static.shutdown()
    emit("serve", **fields, static_requests=64, static_seconds=static_s,
         static_requests_per_s=64 / static_s,
         static_rows_equal_to_generate=float((static_out == ref[:64]).all(axis=1).mean()),
         http_tokens_equal_to_generate=bool((http_out[0] == ref[0]).all()))
    return launches


# ---------------------------------------------------------------------------
# phases 13-15: data preparation (the feature extractor, COMET, the filter)
# ---------------------------------------------------------------------------

# config/extract_config.yaml's detector: ResNet-101 C4, 1601 classes, 401
# attributes, a 512-channel RPN with 12 anchors, 6000 / 300 proposals
# before / after the RPN's NMS (0.7), class-wise NMS 0.3, 600 / 1000 px
EXTRACT = dict(num_classes=1601, num_attributes=401, rpn_channels=512, depth=101,
               pre_nms_topk=6000, post_nms_topk=300, rpn_nms_thresh=0.7, nms_thresh=0.3,
               min_size=600, max_size=1000)
EXTRACT_FEAT_RTOL = 1e-3   # card fp32 vs CPU fp32 (and batch vs single), of max |feature|
EXTRACT_TIE = 1e-4         # a kept row may differ where its max_conf is this near a tie
# px: the same proposal on both sides. Matched proposals moved by up to
# 0.044 px between an NVIDIA H100 80GB HBM3's fp32 run and the CPU's; two
# kept rows whose boxes sit 0.1-0.5 px apart, with max_conf equal within
# 1e-6, pass only as near-tie swaps (named)
EXTRACT_BOX_ATOL = 0.1
# bf16 against the same card's fp32 run, on the given boxes: bf16 operands at
# every conv through 34 bottlenecks (and each conv's output rounded to bf16
# on the card), held to 8 bf16 ulps at the features' largest magnitude and
# the class probabilities to 8 ulps at 1
EXTRACT_BF16_ULPS = 8
GIVEN_SHAPES = [(480, 640), (640, 480), (375, 500), (500, 333), (427, 640), (480, 360),
                (333, 500), (612, 612)] * 2
# the first six share a padded shape (608 x 800) with the batch
PROPOSAL_SHAPES = [(480, 640)] * 4 + [(375, 500)] * 2 + [(400, 500), (600, 600)]


def _synthetic_image(np, rng, h, w):
    """A BGR uint8 image with structure at several scales: 40-px blocks of
    random colour, a gradient and pixel noise."""
    base = rng.integers(0, 256, (h // 40 + 1, w // 40 + 1, 3)).astype(np.float32)
    img = np.kron(base, np.ones((40, 40, 1), np.float32))[:h, :w]
    img += np.linspace(0, 40, w, dtype=np.float32)[None, :, None]
    img += rng.normal(0, 20, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _given_boxes(np, rng, h, w, n=24):
    """The whole-image box and ``n`` boxes inside the image, as VCG's
    metadata gives them (prepare_vcg prepends the whole-image box)."""
    xy = rng.uniform(0, 0.7, (n, 2)) * [w, h]
    wh = rng.uniform(0.05, 0.3, (n, 2)) * [w, h]
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], axis=1)
    return np.vstack([[0, 0, w, h], boxes]).astype(np.float32)


def _detector_params(torch, seed=0):
    """Random detector weights from ``seed`` whose activations stay O(1)
    through 34 bottlenecks (each block's last BN and its shortcut's damp the
    residual branch, as a trained network's do) and whose classifier is
    confident enough that the CONF_THRESH rule has rows on both sides."""
    from kmbart_tpu_torch.vision.extractor import init_extractor_params
    p = init_extractor_params(torch.Generator().manual_seed(seed))
    for stage in ("res2", "res3", "res4", "res5"):
        for block in p["resnet"][stage]:
            block["bn3"]["scale"].mul_(0.25)
            if "shortcut_bn" in block:
                block["shortcut_bn"]["scale"].mul_(0.25)
    p["cls_score"].mul_(3.0)
    return p


def _proposal_arrays(torch, ex, image):
    """The proposal path's stages on one image: (proposals [n, 4] in the
    resized image, feats [n, 2048], max_conf [n]) as numpy."""
    with torch.no_grad():
        blob, _ = ex._blob(image)
        sizes = torch.tensor([blob.shape[:2]], dtype=torch.float32, device=ex.device)
        p, f, _, mc = ex._proposal_stages(ex._pad32(blob)[None], sizes)
    return p[0].cpu().numpy(), f[0].cpu().numpy(), mc[0].cpu().numpy()


def _same_kept_rows(np, ex, ref, got, what):
    """The rows ``_keep_indices`` keeps from two runs of one image, matched by
    box within EXTRACT_BOX_ATOL: the same set, each pair on the same
    stride-16 ROI-pool window and its features within EXTRACT_FEAT_RTOL of
    the largest. A row kept on one side only passes when its max_conf is
    within EXTRACT_TIE of the threshold or of a row kept on the other side
    only (the two swapped), and is named."""
    (rp, rf, rm), (gp, gf, gm) = ref, got
    rk, gk = set(ex._keep_indices(rm).tolist()), set(ex._keep_indices(gm).tolist())
    match = {}
    for i in rk:
        near = np.nonzero(np.abs(gp - rp[i]).max(axis=1) <= EXTRACT_BOX_ATOL)[0]
        hit = [j for j in near if j in gk]
        if hit:
            match[i] = hit[0]
    only_ref = [i for i in rk if i not in match]
    only_got = [j for j in gk if j not in match.values()]
    named = []
    for rows, conf, other in ((only_ref, rm, [gm[j] for j in only_got]),
                              (only_got, gm, [rm[i] for i in only_ref])):
        for r in rows:
            near = [abs(conf[r] - ex.conf_thresh)] + [abs(conf[r] - o) for o in other]
            if min(near) > EXTRACT_TIE:
                raise AssertionError(f"{what}: row {r} (max_conf {conf[r]:.6f}) kept on one "
                                     f"side only, {min(near):.2e} from any tie")
            named.append({"row": int(r), "max_conf": float(conf[r]), "tie": float(min(near))})
    # the ROI pool rounds each box to the stride-16 grid
    window = lambda b: np.round(b.astype(np.float32) * np.float32(1 / 16))
    moved = [(rp[i].tolist(), gp[j].tolist()) for i, j in match.items()
             if (window(rp[i]) != window(gp[j])).any()]
    if moved:
        raise AssertionError(f"{what}: matched boxes pool other windows {moved}")
    i, j = list(match), list(match.values())
    drift = float(np.abs(gp[j] - rp[i]).max()) if i else 0.0
    err = float(np.abs(gf[j] - rf[i]).max() / np.abs(rf[i]).max()) if i else 0.0
    if err > EXTRACT_FEAT_RTOL:
        rows = np.abs(gf[j] - rf[i]).max(axis=1) / np.abs(rf[i]).max()
        raise AssertionError(f"{what}: kept features differ by {err:.3e} of the largest; "
                             f"rows {[(a, float(e)) for a, e in zip(i, rows) if e > 1e-4]}")
    return {"kept": len(rk), "matched": len(match), "box_drift_px": drift,
            "feat_rel_err": err, "near_tie_rows": named}


def _stage_ms(torch, ex, images, dev):
    """Device ms of each proposal-path stage, averaged over ``images``:
    backbone, RPN + its NMS, ROI pool + res5, class-wise NMS."""
    from kmbart_tpu_torch.vision.nms import class_wise_max_conf_batched
    sums = {"backbone": 0.0, "rpn_nms": 0.0, "roi_pool_res5": 0.0, "class_nms": 0.0}
    with torch.no_grad():
        for image in images:
            blob, _ = ex._blob(image)
            sizes = torch.tensor([blob.shape[:2]], dtype=torch.float32, device=dev)
            blob = ex._pad32(blob)[None]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            feat = ex._backbone(blob)
            ev[1].record()
            proposals, valid = ex._rpn_proposals(feat, sizes)
            ev[2].record()
            feats, scores = ex._roi_features(feat[0], proposals[0])
            ev[3].record()
            class_wise_max_conf_batched(proposals, scores[None], ex.nms_thresh)
            ev[4].record()
            torch.cuda.synchronize()
            for k, name in enumerate(sums):
                sums[name] += ev[k].elapsed_time(ev[k + 1])
    return {k: v / len(images) for k, v in sums.items()}


def _host_syncs(torch, fn):
    """Host synchronisations while ``fn`` runs, from PyTorch's sync debug
    mode (one warning per synchronising call)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def run_extract(torch, dev, card):
    """The bottom-up-attention extractor at config/extract_config.yaml's
    widths on random weights: the given-boxes path on 16 images at VCG's
    shape (the whole-image box and 24 boxes), the proposal path on 8 images
    batched and one by one, with their rates, each stage's device time, the
    peak memory and the host syncs of a proposal image; the card's fp32 run
    against the CPU's, the batch path against the single path, and bf16
    against fp32."""
    import numpy as np
    from kmbart_tpu_torch.vision.extractor import FeatureExtractor
    params = _detector_params(torch)
    ex16 = FeatureExtractor(params=params, dtype=torch.bfloat16, device=dev, **EXTRACT)
    ex32 = FeatureExtractor(params=params, dtype=torch.float32, device=dev, **EXTRACT)
    rng = np.random.default_rng(0)
    given = [(_synthetic_image(np, rng, h, w), _given_boxes(np, rng, h, w))
             for h, w in GIVEN_SHAPES]
    props = [_synthetic_image(np, rng, h, w) for h, w in PROPOSAL_SHAPES]

    ex16.extract_feature(*given[0])                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [ex16.extract_feature(img, boxes) for img, boxes in given]
    given_s = time.perf_counter() - t0
    for out in outs:
        if out["features"].shape != (25, 2048) or out["scores"].shape != (25, 1601) \
                or not np.isfinite(out["features"]).all():
            raise AssertionError(f"extract: given-boxes output {out['features'].shape}")

    # bf16 against fp32 on the same card, given boxes (the same rows on both)
    bf16 = {"features_ulps": 0.0, "scores_ulps": 0.0}
    for img, boxes in given[:2]:
        a, b = ex32.extract_feature(img, boxes), ex16.extract_feature(img, boxes)
        m = float(np.abs(a["features"]).max())
        ulp = 2.0 ** (math.floor(math.log2(m)) - 7)
        bf16["features_ulps"] = max(bf16["features_ulps"],
                                    float(np.abs(a["features"] - b["features"]).max()) / ulp)
        bf16["scores_ulps"] = max(bf16["scores_ulps"],
                                  float(np.abs(a["scores"] - b["scores"]).max()) / 2.0 ** -7)
    if max(bf16.values()) > EXTRACT_BF16_ULPS:
        raise AssertionError(f"extract: bf16 against fp32 {bf16} > {EXTRACT_BF16_ULPS} ulps")

    ex16.extract_feature_batch(props)                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch_out = ex16.extract_feature_batch(props)
    batch_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    single_out = [ex16.extract_feature(img) for img in props]
    single_s = time.perf_counter() - t0
    kept = [len(o["boxes"]) for o in batch_out + single_out]
    if not all(10 <= k <= 50 for k in kept):
        raise AssertionError(f"extract: kept {kept}, not 10..50")
    syncs = _host_syncs(torch, lambda: ex16.extract_feature(props[0]))
    stage = _stage_ms(torch, ex16, props[:3], dev)

    # the batch path against the single path (fp32, images of the batch's padded shape)
    with torch.no_grad():
        blobs = [ex32._blob(img)[0] for img in props]
        H = max(-(-b.shape[0] // 32) * 32 for b in blobs)
        W = max(-(-b.shape[1] // 32) * 32 for b in blobs)
        stacked = torch.stack([torch.nn.functional.pad(
            b, (0, 0, 0, W - b.shape[1], 0, H - b.shape[0])) for b in blobs])
        sizes = torch.tensor([b.shape[:2] for b in blobs], dtype=torch.float32, device=dev)
        bp, bf, _, bm = (t.cpu().numpy() for t in ex32._proposal_stages(stacked, sizes))
    shared = [i for i, b in enumerate(blobs)
              if (-(-b.shape[0] // 32) * 32, -(-b.shape[1] // 32) * 32) == (H, W)]
    batch_vs_single = {}
    for i in shared:
        batch_vs_single[i] = _same_kept_rows(np, ex32, _proposal_arrays(torch, ex32, props[i]),
                                             (bp[i], bf[i], bm[i]), f"batch vs single {i}")
    # the card's fp32 run against the CPU's, on one image
    cpu = FeatureExtractor(params=params, dtype=torch.float32, device="cpu", **EXTRACT)
    cpu_vs_card = _same_kept_rows(np, ex32, _proposal_arrays(torch, cpu, props[0]),
                                  _proposal_arrays(torch, ex32, props[0]), "card vs CPU")
    img, boxes = given[0]
    a, b = cpu.extract_feature(img, boxes), ex32.extract_feature(img, boxes)
    given_err = float(np.abs(a["features"] - b["features"]).max() / np.abs(a["features"]).max())
    if given_err > EXTRACT_FEAT_RTOL:
        raise AssertionError(f"extract: given boxes, card vs CPU {given_err:.3e}")
    emit("extract", card=card, config="config/extract_config.yaml widths", dtype="bfloat16",
         given_boxes={"images": len(given), "boxes_per_image": 25,
                      "images_per_s": len(given) / given_s},
         proposals={"images": len(props), "batch_images_per_s": len(props) / batch_s,
                    "single_images_per_s": len(props) / single_s, "kept": kept,
                    "peak_memory_gb_batch": peak_gb, "host_syncs_per_image": syncs,
                    "stage_ms_per_image": stage},
         bf16_vs_fp32=bf16, card_vs_cpu_fp32={"proposals": cpu_vs_card,
                                               "given_boxes_feat_rel_err": given_err},
         batch_vs_single_fp32=batch_vs_single)
    return ex16


COMET = dict(d_model=768, n_layers=12, n_heads=12)   # GPT-1, as COMET runs it
COMET_BASE_VOCAB = 40478
COMET_LOGPROB_ATOL = 1e-4
COMET_TIE = 1e-4


def _comet_assets(path):
    """A GPT-1-sized vocab.json (40478 entries: characters and their word
    ends, some merged words, the ATOMIC markers, filler words) with a
    merges.txt, so that the BPE and get_reason run end to end."""
    os.makedirs(path, exist_ok=True)
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789'.,":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    merges = [("t", "h"), ("th", "e</w>"), ("a", "t</w>"), ("o", "n</w>"), ("i", "n"),
              ("in", "g</w>"), ("e", "r</w>"), ("o", "u"), ("ou", "t</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    for sp in ("none</w>", "<END>", "<xIntent>", "<xWant>", "<xNeed>", "<xReact>",
               "<xEffect>"):
        vocab[sp] = len(vocab)
    i = 0
    while len(vocab) < COMET_BASE_VOCAB:
        vocab[f"w{i}</w>"] = len(vocab)
        i += 1
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


@contextlib.contextmanager
def _decision_gaps(torch, atomic, K):
    """Record, each decode step, the smallest gap that decided a token:
    greedy, the top-two gap of each row's logits; beam, the smallest gap
    among each row's K + 1 best candidates (a swap there changes the beams)."""
    from kmbart_tpu_torch.knowledge import gpt
    gaps, logits_fn, top_k = [], gpt.gpt_logits, atomic.top_k

    def logits(*a, **k):
        out = logits_fn(*a, **k)
        if K == 1:
            v = out.float().topk(2, dim=-1).values
            gaps.append(float((v[..., 0] - v[..., 1]).min()))
        return out

    def beam_top_k(x, k):
        vals, idx = top_k(x, k + 1)
        d = vals[:, :-1] - vals[:, 1:]
        d = d[torch.isfinite(d)]
        gaps.append(float(d.min()) if d.numel() else math.inf)
        return vals[:, :k], idx[:, :k]

    gpt.gpt_logits, atomic.top_k = logits, beam_top_k
    try:
        yield gaps
    finally:
        gpt.gpt_logits, atomic.top_k = logits_fn, top_k


def run_knowledge(torch, dev, card):
    """COMET's GPT at GPT-1's widths (12 layers, d_model 768, 12 heads,
    n_ctx 52, a 40478 + 6 vocabulary) on random weights: greedy and beam-5
    get_reason over 32 events (events/s, ms a step), and the card's fp32
    run against the CPU's on 4 events in both samplers (the first step's
    log-probs, and the same tokens unless they part at a step decided by a
    gap under COMET_TIE on either device, which is named)."""
    import numpy as np
    from kmbart_tpu_torch.knowledge import atomic, gpt
    from kmbart_tpu_torch.knowledge.bpe_gpt1 import GPT1BPE
    with tempfile.TemporaryDirectory() as tmp:
        _comet_assets(tmp)
        enc = GPT1BPE(os.path.join(tmp, "vocab.json"), os.path.join(tmp, "merges.txt"))
    n_vocab = len(enc.encoder) + 5 + 1
    model = gpt.init_gpt_model(n_vocab, 52, seed=0, device=dev, **COMET)
    words = ["person", "the", "door", "eats", "at", "table", "runs", "out", "in", "car",
             "2", "1", "talks", "to", "dog", "opens", "sits", "on", "bench", "laughing"]
    rng = np.random.default_rng(0)
    events = [" ".join(rng.choice(words, size=int(rng.integers(3, 12)))) for _ in range(32)]
    steps = [0]
    step_fn = gpt.gpt_step

    def counted(*a, **k):
        steps[0] += 1
        return step_fn(*a, **k)

    result = {}
    for sampling in ("greedy", "beam-5"):
        gen = atomic.AtomicGenerator(model, enc, sampling_algorithm=sampling)
        gen.get_reason(events[0])                                        # warm-up
        torch.cuda.synchronize()
        steps[0] = 0
        gpt.gpt_step = counted
        try:
            t0 = time.perf_counter()
            out = [gen.get_reason(e) for e in events]
            seconds = time.perf_counter() - t0
        finally:
            gpt.gpt_step = step_fn
        if not all(set(o) == {"after", "before", "intent"} for o in out):
            raise AssertionError(f"knowledge {sampling}: bad get_reason output")
        result[sampling] = {"events_per_s": len(events) / seconds, "steps": steps[0],
                            "ms_per_step": 1e3 * seconds / steps[0],
                            "generations": sum(len(v) for o in out for v in o.values())}

    # the card's fp32 run against the CPU's
    cpu_model = gpt.init_gpt_model(n_vocab, 52, seed=0, device="cpu", **COMET)
    parity = {"first_step_logprob_err": 0.0, "events": 4, "near_tie_partings": []}
    for sampling, K in (("greedy", 1), ("beam-5", 5)):
        gens = {d: atomic.AtomicGenerator(m, enc, sampling_algorithm=sampling,
                                          dtype=torch.float32)
                for d, m in (("card", model), ("cpu", cpu_model))}
        for e, event in enumerate(events[:4]):
            lp, toks, gaps = {}, {}, {}
            for d, g in gens.items():
                with torch.no_grad():
                    tokens = torch.zeros((5, 52), dtype=torch.long, device=g.device)
                    tokens[:, :18] = g.prompt(event)
                    cache = g._prime(tokens, 18, 52)
                    lp[d] = torch.log_softmax(g._step_logits(tokens, cache, 18), -1).cpu()
                with _decision_gaps(torch, atomic, K) as gap_list:
                    toks[d] = g.sample(g.prompt(event)).cpu().numpy()
                gaps[d] = gap_list
            parity["first_step_logprob_err"] = max(parity["first_step_logprob_err"], float(
                (lp["card"] - lp["cpu"]).abs().max()))
            differ = np.nonzero((toks["card"] != toks["cpu"]).any(axis=0))[0]
            if len(differ):
                # greedy: the steps up to the first differing column decide it;
                # beam: any step may (a late swap re-parents the best beam)
                t = int(differ[0])
                upto = t - 18 + 1 if K == 1 else None
                gap = min(min(gaps[d][:upto]) for d in gaps)
                if gap >= COMET_TIE:
                    raise AssertionError(f"knowledge {sampling}: event {e} parts at column "
                                         f"{t}, smallest deciding gap {gap:.2e}")
                parity["near_tie_partings"].append({"sampling": sampling, "event": e,
                                                    "column": t, "gap": gap})
    if parity["first_step_logprob_err"] > COMET_LOGPROB_ATOL:
        raise AssertionError(f"knowledge: first-step log-probs differ by "
                             f"{parity['first_step_logprob_err']:.2e}")
    emit("knowledge", card=card, model="GPT-1 (COMET) 12x768, 12 heads, n_ctx 52",
         n_vocab=n_vocab, dtype="bfloat16", events=len(events), **result,
         card_vs_cpu_fp32=parity)


# the filter's log-perplexities (a mean of ~30 label tokens' log-probs
# through 12 BART-base layers), kernel path against plain path: 2.2e-3 on an
# NVIDIA H100 80GB HBM3, and 1.9e-2 for coarse_ffn_control
FILTER_LOGPP_ATOL = 0.01
# prepare_atomic's mean-pooled BART-base encoder states, kernel path against
# plain path, in bf16 ulps of the pooled states' largest magnitude: 2 on an
# NVIDIA H100 80GB HBM3, and 5.75 for coarse_ffn_control
ATOMIC_POOLED_ULPS = 4


@contextlib.contextmanager
def coarse_ffn_control():
    """The plain path with K2's output rounded to float8 e5m2 (2 mantissa
    bits where bf16 has 7): a control that a kernel-against-plain bound must
    reject, so the bound sits between the sound reading and this one."""
    import torch
    from kmbart_tpu_torch.ops import ffn
    top = torch.finfo(torch.float8_e5m2).max
    with plain_path():
        plain = ffn.fused_ffn

        def coarse(*a, **k):   # the forward alone: both checks run without grad
            y = plain(*a, **k)
            return y.clamp(-top, top).to(torch.float8_e5m2).to(y.dtype)

        ffn.fused_ffn = coarse
        try:
            yield
        finally:
            ffn.fused_ffn = plain


def _hold(what, err, bound, control):
    """err within bound, and the control (the same comparison on
    coarse_ffn_control) past it."""
    if not err <= bound < control:
        raise AssertionError(f"{what}: kernel vs plain {err:.3e}, bound {bound:.3e}, "
                             f"coarse control {control:.3e}")


def run_reason_filter(torch, dev, card, extractor=None):
    """The filter_reason twin's batch_log_perplexity at BART-base on 64
    reasoning rows (72 encoder tokens with 30 image slots, 40 label tokens):
    rows/s, K1 and K2 launches, and the kernel path against the plain path;
    then a few steps of the prepare_atomic twin with a BART-base text
    backbone (its K1/K2 launches, and its pooled encoder states on the
    kernel path against the plain path), and the prepare_vcg twin's feature
    loop on images handed in as arrays."""
    import pickle
    import numpy as np
    from types import SimpleNamespace
    from kmbart_tpu_torch.data.datasets import VCGDataset
    from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    from kmbart_tpu_torch.vision.extractor import FeatureExtractor
    if extractor is None:
        extractor = FeatureExtractor(params=_detector_params(torch), dtype=torch.bfloat16,
                                     device=dev, **EXTRACT)
    from kmbart_tpu_torch.scripts import prep_common, prepare_atomic, prepare_vcg
    from kmbart_tpu_torch.scripts.filter_reason import batch_log_perplexity
    cfg, model = _base_model(dev, seed=2)
    batch = _train_batch(torch, cfg, dev, B=64, seed=3)
    batch["labels"][:, 30:] = -100                   # ragged label lengths, as collated
    batch_log_perplexity(model, cfg, batch)          # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    log_pp = batch_log_perplexity(model, cfg, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    filt = {"train_attention": counts["train_attention"], "ffn": counts["ffn"]}
    if not filt["train_attention"] or not filt["ffn"]:
        raise AssertionError(f"reason_filter: K1/K2 not launched {filt}")
    with plain_path():
        plain = batch_log_perplexity(model, cfg, batch)
    with coarse_ffn_control():
        coarse = batch_log_perplexity(model, cfg, batch)
    err = float((log_pp - plain).abs().max())
    control = float((coarse - plain).abs().max())
    if log_pp.shape != (64,) or not torch.isfinite(log_pp).all():
        raise AssertionError(f"reason_filter: log-perplexity {tuple(log_pp.shape)}")
    _hold("reason_filter log-perplexity", err, FILTER_LOGPP_ATOL, control)

    with tempfile.TemporaryDirectory() as tmp:
        paths = make_dataset(os.path.join(tmp, "data"))
        backbone = os.path.join(tmp, "backbone")
        write_checkpoint(backbone, cfg, seed=4)
        reset_launch_counts()
        t0 = time.perf_counter()
        params = prepare_atomic.main(prepare_atomic.parse_args([
            "--data_dir", paths["vcg"], "--checkpoint_dir", os.path.join(tmp, "atomic"),
            "--tokenizer_dir", paths["tokenizer"], "--text_backbone", backbone,
            "--epochs", "1", "--batch_size", "4", "--image_seq_length", "4",
            "--image_feature_size", "20", "--inner_dim", "64", "--device", str(dev)]))
        atomic_s = time.perf_counter() - t0
        atomic_counts = launch_counts()
        if not all(torch.isfinite(p).all() for p in params.values()):
            raise AssertionError("prepare_atomic: non-finite classifier weights")
        # its text backbone on the fixture's four distinct events (ragged
        # lengths, the trainer's batch), kernel path against plain path
        tokenizer = ConditionTokenizer(assets_dir=paths["tokenizer"])
        encode, _ = prepare_atomic.build_text_encoder(
            SimpleNamespace(text_backbone=backbone), tokenizer, dev)
        dataset = VCGDataset(paths["vcg"], split="train")
        texts = sorted({str(dataset[i].get("event", "")) for i in range(len(dataset))})[:4]
        reset_launch_counts()
        pooled = encode(texts)
        enc_counts = launch_counts()
        if not enc_counts["train_attention"] or not enc_counts["ffn"]:
            raise AssertionError(f"prepare_atomic encoder: K1/K2 not launched {enc_counts}")
        with plain_path():
            pooled_plain = encode(texts)
        with coarse_ffn_control():
            pooled_coarse = encode(texts)
        ulp = 2.0 ** (math.floor(math.log2(float(np.abs(pooled_plain).max()))) - 7)
        pooled_ulps = float(np.abs(pooled - pooled_plain).max()) / ulp
        pooled_control = float(np.abs(pooled_coarse - pooled_plain).max()) / ulp
        if pooled.shape != (4, cfg.d_model) or not np.isfinite(pooled).all():
            raise AssertionError(f"prepare_atomic encoder: pooled {pooled.shape}")
        _hold("prepare_atomic pooled encoder states (ulps)", pooled_ulps, ATOMIC_POOLED_ULPS,
              pooled_control)

        # prepare_vcg's feature loop on three images handed in as arrays
        rng = np.random.default_rng(9)
        annots, arrays = [], {}
        for k, (h, w) in enumerate(((480, 640), (375, 500), (640, 480))):
            annot = {"img_fn": f"img/{k}.jpg", "metadata_fn": f"md/{k}.json"}
            boxes = _given_boxes(np, rng, h, w, n=6)[1:]
            arrays[annot["img_fn"]] = (_synthetic_image(np, rng, h, w),
                                       {"boxes": boxes.tolist(), "height": h, "width": w})
            annots.append(annot)
        args = SimpleNamespace(output_dir=tmp, shard=0, num_shards=1)
        os.makedirs(os.path.join(tmp, "train"), exist_ok=True)
        prep_common.extract_features_loop(
            annots, "train", args,
            lambda a, _, ex: prepare_vcg.image_data(a, *arrays[a["img_fn"]], ex),
            extractor=extractor)
        shapes = []
        for k in range(3):
            with open(os.path.join(tmp, "train", f"{k}.pkl"), "rb") as f:
                feats = pickle.load(f)
            shapes.append(list(feats["image_features"].shape))
        if shapes != [[7, 2048]] * 3:
            raise AssertionError(f"prepare_vcg feature loop wrote {shapes}")
    emit("reason_filter", card=card, config="config/vcg_base.json", rows=64,
         rows_per_s=64 / seconds, ms=1e3 * seconds, launches=filt,
         kernel_vs_plain_log_pp_err=err, bound=FILTER_LOGPP_ATOL,
         coarse_control_log_pp_err=control, log_pp_mean=float(log_pp.mean()),
         prepare_atomic={"seconds": atomic_s, "text_backbone": "config/vcg_base.json",
                         "launches": {k: atomic_counts[k] for k in ("train_attention", "ffn")},
                         "pooled_kernel_vs_plain_ulps": pooled_ulps,
                         "pooled_bound_ulps": ATOMIC_POOLED_ULPS,
                         "pooled_coarse_control_ulps": pooled_control,
                         "encoder_launches": {k: enc_counts[k]
                                              for k in ("train_attention", "ffn")},
                         "encoder_tokens": [len(tokenizer.encode(t)[:32]) for t in texts]},
         prepare_vcg_feature_loop={"images": 3, "pickle_feature_shapes": shapes})


KERNEL_INFO = {
    "train_attention": ("kmbart_tpu_torch/csrc/train_attention_tc.cuh",
                        "kmbart_tpu/ops/pallas_train_attention.py:194"),
    "train_attention_bwd": ("kmbart_tpu_torch/csrc/train_attention_tc.cuh",
                            "kmbart_tpu/ops/pallas_train_attention.py:223"),
    "ffn": ("kmbart_tpu_torch/csrc/ffn.cu", "kmbart_tpu/ops/pallas_ffn.py:160"),
    "ffn_bwd": ("kmbart_tpu_torch/csrc/ffn.cu", "kmbart_tpu/ops/pallas_ffn.py:190"),
    "beam_attention": ("kmbart_tpu_torch/csrc/beam_attention.cu",
                       "kmbart_tpu/ops/pallas_beam_attention.py:214"),
    "beam_attention_ring": ("kmbart_tpu_torch/csrc/beam_attention.cu",
                            "kmbart_tpu/ops/pallas_beam_attention.py:214"),
    "vocab_stats": ("kmbart_tpu_torch/csrc/vocab_stats.cu",
                    "kmbart_tpu/ops/pallas_vocab_stats.py:60"),
    "lm_ce_fwd": ("kmbart_tpu_torch/csrc/lm_ce.cu", "kmbart_tpu/ops/pallas_lm_ce.py:250"),
    "lm_ce_bwd": ("kmbart_tpu_torch/csrc/lm_ce.cu", "kmbart_tpu/ops/pallas_lm_ce.py:289"),
    "lm_ce_fwd_stats": ("kmbart_tpu_torch/csrc/lm_ce.cu",
                        "kmbart_tpu/ops/pallas_lm_ce.py:348"),
    "lm_ce_recompute_bwd": ("kmbart_tpu_torch/csrc/lm_ce.cu",
                            "kmbart_tpu/ops/pallas_lm_ce.py:317"),
    "flash_attention": ("kmbart_tpu_torch/csrc/flash_attention.cu",
                        "kmbart_tpu/ops/pallas_attention.py:62"),
}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, hold each against its plain version, print "
                         "the kernels phase and stop (no paths driven, no ok line)")
    ap.add_argument("--only", default=None,
                    help="comma-separated paths to drive after the kernels phase "
                         "(generate, sample, serve, extract, knowledge, reason_filter), "
                         "then stop without the ok line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kmbart_tpu_torch.ops import _cuda
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    emit("device", card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _cuda.build()
    _cuda.lib()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_cuda.last_build_seconds)

    kernels = check_kernels(torch, dev)
    emit("kernels", card=card, **kernels)
    if args.kernels_only:
        return
    if args.only:
        paths = {"generate": lambda: run_generate(torch, dev, card),
                 "sample": lambda: run_sample(torch, dev, card),
                 "serve": lambda: run_serve(torch, dev, card),
                 "extract": lambda: run_extract(torch, dev, card),
                 "knowledge": lambda: run_knowledge(torch, dev, card),
                 "reason_filter": lambda: run_reason_filter(torch, dev, card)}
        for name in args.only.split(","):
            paths[name]()
        return
    launches = run_generate(torch, dev, card)
    run_cli(card)
    launches.update(run_train(torch, dev, card))
    run_train_cli(card)
    # K9 and K10 are counted on the nomat pretraining run, K11 on the long one
    nomat = run_pretrain(torch, dev, card)
    launches.update({k: nomat[k] for k in ("lm_ce_fwd_stats", "lm_ce_recompute_bwd")})
    torch.cuda.empty_cache()
    launches["flash_attention"] = run_pretrain_long(torch, dev, card)["flash_attention"]
    run_pretrain_cli(card)
    run_sample(torch, dev, card)
    launches["beam_attention_ring"] = run_serve(torch, dev, card)["beam_attention_ring"]
    torch.cuda.empty_cache()
    extractor = run_extract(torch, dev, card)
    run_knowledge(torch, dev, card)
    run_reason_filter(torch, dev, card, extractor)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    loaded = [m for m in sys.modules if m == "kmbart_tpu" or m.startswith("kmbart_tpu.")]
    if loaded:
        raise AssertionError(f"modules of kmbart_tpu were imported: {loaded}")

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name],
         "max_abs_err": kernels[name][0]["max_abs_err"],
         "ms": kernels[name][0]["ms"], "plain_ms": kernels[name][0]["plain_ms"],
         "bound_ms": kernels[name][0]["bound_ms"], "bound_by": kernels[name][0]["bound_by"],
         "library_ms": kernels[name][0].get("library_ms")}
        for name in KERNEL_INFO]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
