#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kmbart_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(``--kernels-only`` stops after phase 3, to compare kernel builds;
``--only serve,sample`` drives only the named paths after it.)

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device    the card's name and power limit (needs a CUDA device);
  2. build     nvcc builds the twelve kernels from kmbart_tpu_torch/csrc (one
               nvcc per source, all started together);
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the generation, fine-tune and pretraining paths' shapes and at
               edge shapes (K1 and its backward also on the fused QKV
               projection's strided chunks, at Tk 256 and ragged lengths,
               on the plan's route (ops/train_attention.py plan: the
               persistent TMA + wgmma kernels wherever they take the shape)
               and, where that is "wg", on PR 4's kernels too: the elements
               that differ between the two, the largest difference in bf16
               ulps, PR 4's time (legacy_ms) and the host's time a call;
               K2 and K2b at every training row, ragged rows, an odd
               count of row tiles and a wide FFN, the first GEMM on each
               of its layouts (ops/ffn.py train_plan: held to the plain
               version and to each other bit for bit, and timed),
               two calls of the plan's route equal bit for bit; K2's
               inference route at generation's and serving's rows held bit
               for bit to the partials route in every F2 mode, its first
               320 rows equal at every N, its partials route's and
               each mode's times and the device kernels of one call), with
               the device times of both from CUDA events, the
               bound the card sets for the same work (bytes or FLOPs, each
               input read once and each output written once), for the
               attention kernels the time of one
               F.scaled_dot_product_attention call on the same data and for
               K2, K2b and K7-K10 the time of the bf16 torch.mm products
               of their GEMMs (the port never calls either), K8's plan
               (work units, vocab parts), K8's dlogits also element by
               element in bf16 ulps, K8 at one part and with a negative
               loss scale against its plain version too, K10's two passes
               timed alone, K9's statistics
               and K10's outputs held equal to K7's and K8's (on K7's
               logits) bit for bit, K11's error split into what its bf16
               p terms cost and the rest, and K2's and K2b's host time a
               call (and K7's, beside its plan's 256 x 128 tiles and
               blocks); K3 at cache positions 0, 15 and 31 with the
               bound of the rows its ancestry reads, and in ring mode at the
               serving pool's shape (windows 1..32 with most wrapping past
               column 0, all 32, all 1; each window's output equal bit for
               bit to the scalar mode's on the window rotated to columns
               [0, n)), with its plan (blocks, heads a block, shared memory
               a block), the blocks an SM holds by the occupancy API and the
               waves; K4's statistics and top-k against the statistics'
               plain version and the stable sort (values and int64 indices
               bit for bit) at the beam step's, sampling's, the serving
               pool's and the flat rows' shapes, at k 1024 (its largest) and
               on tie-heavy rows, with torch.topk's and the sort's times; at
               k 2000 the wrapper refuses and the route (stats_top_k,
               exact_top_k) equals the plain version; a planted-tie top-k;
               K12 (AdamW) against the plain per-tensor path over five
               steps at the fine-tune and pretraining tensors and at odd
               shapes on narrow parts (moments and step counts bit for bit,
               parameters within 2 ulps), its device time, byte bound,
               the plain path's time and the host's time a call;
  4. generate  beam-5 VCG generation at BART-base width (config/vcg_base.json,
               random weights from a seed, batch 64): every generation kernel
               must have launched (K4 and its merge once a step), outputs
               finite, and the encoder output and first-step log-probs close
               to the plain path's on the card; every row's tokens equal to
               a call with only the selection swapped to the stable sort, and
               to one with K2's inference calls on the partials route (and
               the two timed in turns), no torch.sort of vocabulary-wide
               rows; one real K3 call (the
               cache and ancestry of the last step) against its plain
               version; a torch.profiler trace of one call (device-busy
               share, K2's, K3's, K4's and the sorts' device time, K3's
               summed bound, no segmented sort kernel, no ffn_finalize; the
               same on the partials route);
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
               epoch on the fixture dataset, resumes from its model0/ with
               --continue_training for a second (the loaded moments on K12:
               its launches counted), and the generate twin decodes from
               model0/;
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
               twice, K1-K4 launch (K4's top-k on both), sentences/s; beam 5
               at top_k 2000, over K4's largest k, takes K4's statistics and
               the sort's top-k;
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
               prepare_vcg twin's feature loop on images handed in as arrays;
 16. prep_twins  the COCO and VG twins (given boxes) and the CC and SBU twins
               (proposals) on decoded images through the extract phase's
               extractor, each pickle equal bit for bit to direct
               extract_feature calls, and the prepare_coco_reason twin over
               three captions at COMET's GPT-1 widths;
 17. ddp       two processes on the one card (gloo) at 64 rows each against
               one process at 128 (NCCL at world size 1), BART-base at the
               fine-tune shapes, dropout 0, three steps: losses within 2e-3,
               the fine-tune kernels launched on each rank, ZeRO-1's
               parameters bit-equal to the replicated pair's, ms a step and
               the all-reduce's share.
 18. parallel  tensor, sequence and pipeline parallelism: two processes on the
               one card (gloo, collectives and point-to-point transfers of
               CUDA tensors staged through the host) at TP 2, TP 2 with SP,
               PP 2 with 2 micro-batches and the pretraining step under PP 2
               in LM-CE mode "nomat", BART-base at 32 rows a group (72 + 40
               tokens; 96 + 72 for pretraining), dropout 0, K2 off as the
               CLIs set it, three AdamW steps, each held against one process
               on the same rows (losses within 2e-3, per-leaf gradient
               norms); K1 and K1b launched at 6 heads inside each TP rank
               and K7/K8 (K9/K10) on every rank, in the launch counts and in
               a torch.profiler trace of one step a rank; ms a step a rank
               and the collectives' share. ``--only parallel_nccl`` runs
               TP 2 x DP 2 and PP 2 x TP 2 over NCCL on four cards instead,
               then phase 19's TP 2 x DP 2 generation.
 19. parallel_generate  generate() over a split model at the generate cell's
               call (batch 64 of 72 tokens, beam 5, max_length 32): TP 2 and
               DP 2 (32 rows a rank), two processes on the one card over gloo
               (host-staged), each rank on its part of the model and its
               block of the rows; ms a call a rank and the collectives'
               share, K1-K4 launches a rank and K1's and K3's head counts (6
               under TP, where K2 stays off), the samples that differ from
               one process's generate() on the card (each must start at a
               near-tie, as phase 12 bounds them) and between the ranks
               (none may).
Phase 4 also wraps one generate() call in utils.profiling.trace and finds
K3's and K4's launches in the trace it writes; phase 12 also holds each of
the static engine's 64 requests to generate() on the padded batch the
engine ran (its ``record`` hook), bounds how the engine's answers may differ
from generate() at 112 samples (every divergence starts at a near-tie within
the two runs' rounding), and probes the decode step's products at 160
against 560 rows.
The line before the last lists every kernel with its launches on the main
path, its error, its time, its plain version's, its bound and the library
call's (K1 and K1b also at a TP 2 rank's local shape, with the TP 2 run's
launches, and K3 at a TP 2 rank's decode step, with phase 19's TP 2
launches); the last line is {"ok": true, "device": {...}}. The port imports
nothing of jax or kmbart_tpu, and the script checks that at its end.
"""

import contextlib
import json
import math
import os
import socket
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
                  "ffn_bwd": 12, "lm_ce_fwd": 1, "lm_ce_bwd": 1,
                  # K12: the "used" test, the steps kernel and the update
                  "adamw": 3,
                  # of those, on PR 4's kernels (ops/train_attention.py plan): none
                  "train_attention_legacy": 0, "train_attention_bwd_legacy": 0}
GENERATE_KERNELS = ("train_attention", "ffn", "beam_attention", "vocab_stats_topk",
                    "vocab_topk_merge")
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
# the static engine against generate() at another batch width: the two
# calls' beam scores of the same candidate may differ by rounding (bf16
# hidden states whose GEMMs sum in another order at 160 rows than at 560,
# accumulated over the steps); 0.25 is two bf16 ulps of a logit of
# magnitude 16, far below the O(1) differences of a wrong row or token
NEAR_TIE_NOISE_MAX = 0.25
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


def _device_kernels(torch, fn, calls=4):
    """{device kernel name: launches a call} over ``calls`` calls
    (torch.profiler; a single call's first kernel can fall outside the
    window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name[:80] for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {name: names.count(name) / calls for name in sorted(set(names))}


def _gemm_ms(torch, fn, calls=5):
    """{GEMM: device ms a call} of a K2 or K2b call over ``calls`` calls
    (torch.profiler): F1, F2 (ffn_fwd_gemm), B1, B2 (ffn_bwd_gemm) and
    ffn_finalize, told apart by the kernels' epilogue codes. A profile that
    saw none of them (one did on an H100, once) is taken again, once; {}
    after that."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = {"ffn_fwd_gemm<0": "F1", "ffn_fwd_gemm<1": "F2", "ffn_bwd_gemm<2": "B1",
             "ffn_bwd_gemm<1": "B2"}
    out = {}
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            m = re.search(r"ffn_(fwd|bwd)_gemm<\d", e.name)
            key = names[m.group(0)] if m else ("finalize" if "ffn_finalize" in e.name else None)
            if key is not None:
                out[key] = out.get(key, 0.0) + e.device_time_total / 1e3 / calls
        if out:
            break
    return out


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

# K12 against AdamW's plain per-tensor path (training/adamw.py update_plain):
# the same arithmetic in the same order, so the moments and step counts are
# equal bit for bit; the step size's powf may round apart, by an ulp or two
# of the parameters
ADAMW_PARAM_ULPS = 2


def _ulps(torch, a, b):
    """The largest distance between fp32 tensors in units in the last place
    (through the ordered integer view, so across zero too)."""
    def ordered(t):
        i = t.view(torch.int32).long()
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _adamw_sets(torch):
    """{set: (shapes {name: shape}, groups)} of the fine-tune and the
    pretraining models' tensors (config/vcg_base.json, pretrain_base.json),
    read on the meta device."""
    from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups
    from kmbart_tpu_torch.config import MultiModalBartConfig
    from kmbart_tpu_torch.models.conditional import MultiModalBartForConditionalGeneration
    from kmbart_tpu_torch.models.pretraining import MultiModalBartForPreTraining
    from kmbart_tpu_torch.training.state import model_tensors
    out = {}
    for name, path, cls, heads in (
            ("finetune", "config/vcg_base.json", MultiModalBartForConditionalGeneration, False),
            ("pretrain", "config/pretrain_base.json", MultiModalBartForPreTraining, True)):
        cfg = MultiModalBartConfig.from_json(os.path.join(REPO, path))
        with torch.device("meta"):
            model = cls(cfg)
        out[name] = ({n: tuple(t.shape) for n, t in model_tensors(model).items()},
                     jax_leaf_groups(cfg, heads=heads))
    return out


def _adamw_compare(torch, opt, params, grads_of, oks, part=None, label=""):
    """K12 (``opt.update`` on CUDA tensors) against ``opt.update_plain`` over
    len(oks) steps from copies of one start; ``grads_of(i)`` the step's
    gradients, ``oks[i]`` its guard (None: no guard). Returns the largest
    parameter distance in ulps and in value; raises on any moment or step
    count that differs."""
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    pk = {n: t.clone() for n, t in params.items()}
    pp = {n: t.clone() for n, t in params.items()}

    def start(ps):
        return opt.init({n: t if part is None else part(n, t) for n, t in ps.items()})
    sk, sp = start(pk), start(pp)
    reset_launch_counts()
    for i, ok in enumerate(oks):
        grads = grads_of(i)
        okt = None if ok is None else torch.tensor(ok, device=next(iter(params.values())).device)
        sk = opt.update(grads, sk, pk, ok=okt, part=part)
        sp = opt.update_plain(grads, sp, pp, ok=okt, part=part)
    torch.cuda.synchronize()
    launches = launch_counts()["adamw"]
    if launches != 3 * len(oks):
        raise AssertionError(f"adamw {label}: {launches} K12 launches in {len(oks)} steps")
    if int(sk.step) != int(sp.step):
        raise AssertionError(f"adamw {label}: global step {int(sk.step)} != {int(sp.step)}")
    if (sk.leaf_steps is None) != (sp.leaf_steps is None) or any(
            int(sk.leaf_steps[k]) != int(v) for k, v in (sp.leaf_steps or {}).items()):
        raise AssertionError(f"adamw {label}: per-group step counts differ")
    for field in ("mu", "nu"):
        a, b = getattr(sk, field), getattr(sp, field)
        bad = [n for n in b if not torch.equal(a[n], b[n])]
        if bad:
            raise AssertionError(f"adamw {label}: {field} differs from the plain path in {bad[:5]}")
    ulps = max(_ulps(torch, pk[n], pp[n]) for n in params)
    _check(f"adamw {label}: parameters in fp32 ulps", ulps, ADAMW_PARAM_ULPS)
    return ulps, max(float((pk[n] - pp[n]).abs().max()) for n in params)


def check_adamw(torch, dev):
    """K12 against the plain path over five steps at the fine-tune and the
    pretraining tensors (a group whose gradients are all zero at step 2, a
    None gradient in a used group at step 3, the guard false at step 4), and
    at small odd shapes with weight decay, without bias correction and
    without the per-group test, on ``narrow`` parts on dimension 1; then
    K12's device time, its byte bound, the plain path's time and the host's
    time a call at both full sets. Returns [fine-tune row, pretraining row,
    edge rows]."""
    from kmbart_tpu_torch.training.adamw import AdamW
    g = torch.Generator(device=dev).manual_seed(12)
    out = []
    for set_name, (shapes, groups) in _adamw_sets(torch).items():
        params = {n: torch.randn(s, generator=g, device=dev) * 0.02 for n, s in shapes.items()}
        zero_group = next(k for k, names in groups.items() if len(names) > 1)
        none_name = next(names[0] for k, names in groups.items()
                         if len(names) > 1 and k != zero_group)
        draws = [{n: torch.randn(s, generator=g, device=dev) * 1e-3 for n, s in shapes.items()}
                 for _ in range(2)]

        def grads_of(i):
            grads = dict(draws[i % 2])
            grads["final_logits_bias"] = None      # a buffer: never a gradient
            if i == 2:
                grads.update({n: torch.zeros_like(grads[n]) for n in groups[zero_group]})
            if i == 3:
                grads[none_name] = None
            return grads
        opt = AdamW(lr=1e-4, groups=groups)
        ulps, err = _adamw_compare(torch, opt, params, grads_of,
                                   [True, True, True, True, False], label=set_name)
        # timing: each path carries its own state from call to call
        grads = grads_of(0)
        ok = torch.tensor(True, device=dev)
        states = {True: opt.init(params), False: opt.init(params)}

        def call(plain=False):
            update = opt.update_plain if plain else opt.update
            states[plain] = update(grads, states[plain], params, ok=ok)
        n = sum(t.numel() for t in params.values())
        res = {"set": set_name, "tensors": len(params), "groups": len(groups),
               "parameters": n, "param_ulps_max": ulps, "max_abs_err": err,
               "launches_a_step": 3,
               "ms": _time_ms(torch, call), "host_us": _host_us(torch, call),
               "plain_ms": _time_ms(torch, lambda: call(True), iters=3, warmup=1, reps=3),
               "plain_host_us": _host_us(torch, lambda: call(True), iters=3)}
        res.update(_bound(28 * n))
        res["bound_with_used_ms"] = 1e3 * 32 * n / HBM_BYTES_PER_S
        res["roofline_pct"] = 100 * res["bound_ms"] / res["ms"]
        out.append(res)
        del params, draws, grads, states
    # small odd shapes: sizes that no 16-byte load covers whole, parts on dim 1
    shapes = {"a": (37, 13), "b": (5,), "c": (3, 7, 11), "d": (64, 96), "e": (6, 10)}
    params = {n: torch.randn(s, generator=g, device=dev) for n, s in shapes.items()}
    draws = [{n: torch.randn(s, generator=g, device=dev) for n, s in shapes.items()}
             for _ in range(5)]
    part = lambda n, t: t.narrow(1, 2, 5) if t.dim() > 1 else t

    def small_grads(i):
        grads = dict(draws[i])
        if i == 1:
            grads["b"] = None
        return grads
    edges = {}
    for kw in (dict(weight_decay=0.01, correct_bias=False, skip_unused=False),
               dict(weight_decay=0.01), dict(correct_bias=False)):
        opt = AdamW(lr=1e-2, groups={"x": ["a", "c"], "b": ["b"], "d": ["d", "e"]}, **kw)
        for label, p in (("whole", None), ("narrow", part)):
            edges[f"{label} {kw}"] = _adamw_compare(
                torch, opt, params, small_grads, [True, None, False, True, True], part=p,
                label=f"{label} {kw}")[0]
    out.append({"set": "edges", "param_ulps_max": edges})
    return out



def _max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def _bf16_ulps(torch, a, b):
    """The largest difference of two bf16 tensors in ulps of the larger
    magnitude of each pair (0 where they are equal)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(diff), (e - 8).clamp(min=-133))
    return float(torch.where(diff > 0, diff / ulp, torch.zeros_like(diff)).max())


def _tie_rows(n, seed=0):
    """tests/test_torch_topk.py's eight tie-heavy [n] fp32 rows (numpy seed):
    planted ties across and at chunk borders, a constant row, -inf stripes,
    one finite column, halves, mixed +-0.0, a tied group straddling a chunk
    border, integers."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(8, n)) * 4).astype(np.float32)
    x[0, [n - 1, 123, n // 2, 1023, 1024]] = 9.0
    x[1, :] = 1.25
    x[2, ::7] = -np.inf
    x[2, [5, 6, 8, 1022, 1025]] = 7.5
    x[3, :] = -np.inf
    x[3, n // 3] = 0.5
    x[4] = np.round(x[4] * 2) / 2
    zeros = rng.choice(n, 40, replace=False)
    x[5] = -np.abs(x[5]) - 1.0
    x[5, zeros] = np.where(rng.random(40) < 0.5, -0.0, 0.0)
    x[6, 1020:1028] = x[6].max() + 1.0
    x[7] = np.round(x[7])
    return x


# K1 and K1b's shapes (see check_kernels); the timed rows are the main
# path's: G, F (three), P (three), T (three), G-TP
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
    # a TP 2 rank's local heads at the parallel phase's 32 rows: 6 heads
    # of 64 over the [B, T, 384] column slice (encoder self, decoder
    # causal self, cross)
    (32, 72, 72, 384, 6, 9, False, True, True),
    (32, 40, 40, 384, 6, 0, True, True, True),
    (32, 40, 72, 384, 6, 9, False, False, True),
    # generation's encoder on a TP 2 rank (the parallel_generate phase):
    # B 64, 72 x 72, 6 heads over the [B, T, 384] columns
    (64, 72, 72, 384, 6, 0, False, True, True),
]


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

    # K1 and K1b on the plan's route (ops/train_attention.py plan: "wg", the
    # persistent TMA + wgmma kernels, wherever they take the shape, else PR
    # 4's "legacy" kernels). Where the plan takes "wg", the legacy kernel
    # runs on the same inputs too: the elements where the two differ and the
    # largest difference in bf16 ulps (both are held to the plain version;
    # they may differ only in the order of fp32 sums), and at timed rows its
    # time (legacy_ms) and the host's time to enqueue a call (host_us).
    def k1_route(res, run, outs, Tq, Tk, D, H, B, causal, dtype, timed, backward):
        p = ta.plan(Tq, Tk, D // H, dtype, causal, backward=backward)
        res["plan"] = {"kernel": p.kernel}
        if p.kernel == "wg":
            res["plan"].update(
                grid=ta.launch_grid(dev, Tq, Tk, B * H, backward),
                resident=ta.resident(dev, Tq, Tk, backward), smem_bytes=p.smem_bytes,
                consumers=p.consumers, stages=p.stages)
            legacy = run("legacy")
            res["elements_differing_from_legacy"] = sum(int((u != w).sum())
                                                        for u, w in zip(outs, legacy))
            res["max_ulps_from_legacy"] = max(_bf16_ulps(torch, u, w)
                                              for u, w in zip(outs, legacy))
            if timed:
                res["legacy_ms"] = _time_ms(torch, lambda: run("legacy"))
        if timed:
            res["host_us"] = _host_us(torch, lambda: run(None))

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
        k1_route(res, lambda kernel: (ta._fwd_launch(q, k, v, mask, H, causal, kernel),),
                 (out,), Tq, Tk, D, H, B, causal, dtype, timed, False)
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

    # K2 with a and K2b on the plan's route (ops/ffn.py train_plan) and with
    # the first GEMM forced to each of its two layouts: Legacy (the parent
    # kernel) and the direction's own (F1 "table", B1 "fast"), whatever the
    # plan takes there. Legacy's output is held to the plain version, the
    # other layout's (and the plan's, held by the caller) to Legacy's bit
    # for bit; two calls of the plan's route must give the same bits. Every
    # row times both layouts (layout_ms), so the plan's rule (F1 on Legacy
    # below TABLE_MIN_DEPTH) is measured on each side; timed rows also split
    # each call by GEMM (gemm_split_ms).
    def train_layouts(what, res, run, refs, N, D, F, timed, backward):
        first, second = ffn.train_plan(N, D, F, ffn.sm_count(dev), backward)
        own = ffn.TRAIN_FIRST[backward]
        res["plan"] = {"first": first.layout, "first_ctas": first.ctas,
                       "first_waves": ffn.waves(first), "second_ctas": second.ctas,
                       "second_splits": second.splits, "second_waves": ffn.waves(second)}
        outs = run(None)
        if not all(torch.equal(u, v) for u, v in zip(outs, run(None))):
            raise AssertionError(f"{what} {N}x{D}x{F}: two calls give different bits")
        res["two_calls_equal"] = True
        legacy = run("legacy")
        for name, out, ref in zip(what.split("/"), legacy, refs):
            _check(f"{name} {N}x{D}x{F} on legacy", _max_err(out, ref), _bf16_tol(ref.float()))
        res["legacy_max_abs_err"] = max(_max_err(out, ref) for out, ref in zip(legacy, refs))
        differ = {lay: sum(int((u != v).sum()) for u, v in zip(got, legacy))
                  for lay, got in (("plan", outs), (own, run(own)))}
        res["elements_differing_from_legacy"] = differ
        if any(differ.values()):
            raise AssertionError(f"{what} {N}x{D}x{F}: elements differing from legacy's "
                                 f"{differ}")
        res["layout_ms"] = {lay: _time_ms(torch, lambda lay=lay: run(lay), iters=10)
                            for lay in (own, "legacy")}
        if timed:
            res["legacy_ms"] = res["layout_ms"]["legacy"]
            # each GEMM's share of a call, on the plan's route and Legacy's
            res["gemm_split_ms"] = {"plan": _gemm_ms(torch, lambda: run(None)),
                                    "legacy": _gemm_ms(torch, lambda: run("legacy"))}

    # K2 at the rows its callers give it: generation's encoder (64 x 72) and
    # decode step (64 x 5), the serving pool's decode step (112 x 5) and its
    # admit's encoder (32 x 96), without the pre-activation (the inference
    # route, infer_plan); with it (the backward's residual), fine-tuning's
    # encoder (128 x 72, also pretraining's decoder) and decoder (128 x 40)
    # and pretraining's encoder (128 x 96); edges: ragged rows at tiny
    # widths, a wide FFN (eight parts: a cluster of eight), and F 5120 and
    # 8192 at a decode step's rows (10 and 16 parts, more than a cluster's
    # tile takes: the running sum). Timed rows carry
    # gemm_ms, the two bf16 torch.mm products of the same shapes (a
    # yardstick the port never calls), and host_us. Every inference row is
    # held bit for bit to the partials route (fused_ffn_partials: the same
    # parts through an fp32 buffer and a third launch), with F2's depth
    # mode as the plan picks it and forced to each mode the card can run; the
    # timed ones also give the partials route's and each forced mode's
    # times, and the device kernels of one call. The four main-path rows share their
    # weights and the first rows of x: the first 320 rows' bits must be the
    # same in every call (row-count invariance).
    def k2(N, D, F, timed, with_a=False, path="edge", x=None, weights=None):
        x = randn(N, D) if x is None else x
        if weights is None:
            weights = (randn(F, D, std=0.02), randn(F, std=0.02, dtype=torch.float32),
                       randn(D, F, std=0.02), randn(D, std=0.02, dtype=torch.float32))
        w1, b1, w2, b2 = weights
        outs = ffn.fused_ffn(x, w1, b1, w2, b2, with_a=with_a)
        refs = ffn.fused_ffn_plain(x, w1, b1, w2, b2, with_a=with_a)
        outs, refs = (outs, refs) if with_a else ((outs,), (refs,))
        res = {"shape": [N, D, F], "with_a": with_a, "path": path}
        for name, out, ref in zip(("y", "a"), outs, refs):
            err, tol = _max_err(out, ref), _bf16_tol(ref.float())
            _check(f"fused_ffn {name} {N}x{D}x{F} with_a={with_a}", err, tol)
            res[f"{name}_err"], res[f"{name}_tol"] = err, tol
        res["max_abs_err"] = max(res[f"{name}_err"] for name in ("y", "a")[:len(outs)])
        if not with_a:
            sms, slots = ffn.sm_count(dev), ffn.cluster_slots(dev)
            first, second = ffn.infer_plan(N, D, F, sms, slots)
            res["plan"] = {"f1_tile_rows": first.tile_rows, "f1_ctas": first.ctas,
                           "f2_mode": second.mode, "f2_tile_rows": second.tile_rows,
                           "f2_tile_cols": second.tile_cols,
                           "f2_cluster": second.cluster, "f2_ctas": second.ctas,
                           "f2_parts": second.splits, "f2_kper": second.kper}
            partials = ffn.fused_ffn_partials(x, w1, b1, w2, b2)
            # every F2 mode the card runs: "sum", "cluster<parts a block>@<tile>"
            modes = list(ffn.f2_modes(second.splits, sms, slots))
            differ = {"plan": int((outs[0] != partials).sum())}
            for mode in modes:
                got = ffn._fused_ffn_infer(x, w1, b1, w2, b2, mode=mode)
                differ[mode] = int((got != partials).sum())
            res["elements_differing_from_partials"] = differ
            if any(differ.values()):
                raise AssertionError(f"fused_ffn {N}x{D}x{F}: elements differing from the "
                                     f"partials route {differ}")
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
            if not with_a:
                part = lambda: ffn.fused_ffn_partials(x, w1, b1, w2, b2)  # noqa: E731
                res["partials_ms"] = _time_ms(torch, part)
                res["partials_host_us"] = _host_us(torch, part)
                res["mode_ms"] = {m: _time_ms(torch, lambda m=m: ffn._fused_ffn_infer(
                    x, w1, b1, w2, b2, mode=m)) for m in modes}
                res["device_kernels_a_call"] = _device_kernels(torch, call)
                res["partials_device_kernels_a_call"] = _device_kernels(torch, part)
                if any("ffn_finalize" in k for k in res["device_kernels_a_call"]):
                    raise AssertionError(f"fused_ffn {N}: the inference route launched "
                                         f"{res['device_kernels_a_call']}")
        if with_a:
            train_layouts("y/a", res, lambda lay: ffn._fused_ffn_split(
                x, w1, b1, w2, b2, True, layout=lay), refs, N, D, F, timed, False)
        return res

    k2_x = randn(64 * 72, 768)
    k2_w = (randn(3072, 768, std=0.02), randn(3072, std=0.02, dtype=torch.float32),
            randn(768, 3072, std=0.02), randn(768, std=0.02, dtype=torch.float32))
    k2_rows = [k2(n, 768, 3072, True, path=path, x=k2_x[:n], weights=k2_w)
               for n, path in ((64 * 72, "generate encoder"), (64 * 5, "generate decode step"),
                               (112 * 5, "serving decode step (pool 112, beam 5)"),
                               (32 * 96, "serving encoder (admit 32 x 96)"))]
    # row-count invariance: the first 320 rows inside the 560-, 3072- and
    # 4608-row calls against the 320-row call
    w1, b1, w2, b2 = k2_w
    y320 = ffn.fused_ffn(k2_x[:320], w1, b1, w2, b2)
    for n in (560, 32 * 96, 64 * 72):
        same = torch.equal(ffn.fused_ffn(k2_x[:n], w1, b1, w2, b2)[:320], y320)
        k2_rows[1].setdefault("first_320_rows_equal_at", {})[n] = same
        if not same:
            raise AssertionError(f"fused_ffn: the first 320 rows differ between N 320 and N {n}")
    k2_rows[0]["cluster_slots"] = ffn.cluster_slots(dev)
    results["ffn"] = k2_rows + [
        k2(128 * 72, 768, 3072, True, with_a=True, path="fine-tune encoder, pretraining decoder"),
        k2(128 * 40, 768, 3072, True, with_a=True, path="fine-tune decoder"),
        k2(128 * 96, 768, 3072, True, with_a=True, path="pretraining encoder"),
        k2(37, 32, 64, False), k2(37, 32, 64, False, with_a=True),
        k2(1000, 1024, 4096, False), k2(1000, 1024, 4096, False, with_a=True),
        k2(5157, 768, 3072, False, with_a=True, path="odd row tiles (41, the last of 37 rows)"),
        k2(1, 768, 3072, False), k2(37, 768, 3072, False),
        k2(320, 768, 5120, False), k2(320, 768, 8192, False)]

    # K3: decoder self-attention, B 64, K 5, T 32, D 768, 12 heads, with
    # branching ancestry, at the last position (the kernels line's row) and
    # at positions 0 and 15; edges: K 1 and K 4, every beam descending from
    # one slot ("shared") and each beam keeping its own ("distinct"), head_dim
    # 32 and 128 (two shared-memory chunks), tiny widths, and the fp32 q and
    # fp32 cache instantiations
    def k3_plan(B, K, T, D, H, n, ring):
        """K3's plan (ops/beam_attention.py beam_plan: a block of 256
        threads per (sample, head), its positions in chunks), the blocks an
        SM holds by the occupancy API, and the waves of the grid."""
        import ctypes
        from kmbart_tpu_torch.ops import _cuda
        p = ba.beam_plan(K, n - 1, D // H)
        held = ctypes.c_int(0)
        _cuda.check(_cuda.lib().kmb_beam_attention_occupancy(
            K, D, H, int(ring), n, p.chunk, ctypes.byref(held)), "beam_attention occupancy")
        sms = ffn.sm_count(dev)
        return {"plan": {"blocks": B * H, "heads_a_block": 1, "smem_a_block": p.smem,
                         "threads": 256, "chunk": p.chunk, "nchunks": p.nchunks},
                "blocks_per_sm": held.value, "sms": sms,
                "waves": -(-B * H // (held.value * sms)) if held.value else None}

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
            res.update(k3_plan(B, K, T, D, H, cache_index + 1, False))
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
        k1_route(res, lambda kernel: ta._bwd_launch(q, k, v, mask, g, H, causal, kernel), outs,
                 Tq, Tk, D, H, B, causal, dtype, timed, True)
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
    # tiny widths, a wide FFN, an odd count of row tiles
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
        train_layouts("da/dx", res, lambda lay: ffn._fused_ffn_bwd(g, a, w1, w2, layout=lay),
                      refs, N, D, F, timed, True)
        return res

    results["ffn_bwd"] = [k2b(128 * 72, 768, 3072, True,
                              path="fine-tune encoder, pretraining decoder"),
                          k2b(128 * 40, 768, 3072, True, path="fine-tune decoder"),
                          k2b(128 * 96, 768, 3072, True, path="pretraining encoder"),
                          k2b(37, 32, 64, False), k2b(1000, 1024, 4096, False),
                          k2b(5157, 768, 3072, False, path="odd row tiles (41, the last of 37 rows)")]

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
        bwd["dlogits_ulps"] = _check_dlogits_ulps(f"lm_ce_bwd {N}x{V}", dl, rdl)
        bwd["max_abs_err"] = max(bwd["dlogits_err"], bwd["dh_err"])
        # a negative loss scale (the cotangent of -loss): the same checks
        nargs = (logits, w, m, inv_se, (-scale).contiguous(), labels)
        for name, out, ref in zip(("dlogits", "dh"), lm_ce.lm_ce_bwd(*nargs),
                                  lm_ce.lm_ce_bwd_plain(*nargs)):
            err, tol = _max_err(out, ref), _bf16_tol(ref.float(), floor=0.0)
            _check(f"lm_ce_bwd negative scale {name} {N}x{V}", err, tol)
            bwd[f"negative_scale_{name}_err"] = err
            if name == "dlogits":
                _check_dlogits_ulps(f"lm_ce_bwd negative scale {N}x{V}", out, ref)
        # the pad columns of K8's buffer are zero
        pitch = lm_ce.padded_vocab(V)
        if dl.stride(0) != pitch or bool(dl.as_strided(
                (N, pitch - V), (dl.stride(0), 1), dl.storage_offset() + V).ne(0).any()):
            raise AssertionError(f"lm_ce_bwd {N}x{V}: pad columns not zero")
        if timed:
            # the plan's vocab parts written straight out (one part: no
            # partials, no finalize_sum), held to the plain version too
            one_dl, one_dh = lm_ce._bwd_launch("lm_ce_bwd", *bargs, splits=1)
            for name, out, ref in (("dlogits", one_dl[:, :V], rdl), ("dh", one_dh, rdh)):
                err, tol = _max_err(out, ref), _bf16_tol(ref.float(), floor=0.0)
                _check(f"lm_ce_bwd one part {name} {N}x{V}", err, tol)
                bwd[f"one_part_{name}_err"] = err
            _check_dlogits_ulps(f"lm_ce_bwd one part {N}x{V}", one_dl[:, :V], rdl)
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
            _lm_ce_parts(fwd, bwd, h, w, rdl)
            fwd.update(_k7_bound(N, V, D))
            bwd.update(_k8_bound(N, V, D))
        return fwd, bwd

    def _check_dlogits_ulps(what, got, ref):
        """K8's dlogits element by element: each within BF16_ULPS bf16 ulps
        of its own reference value (the largest-magnitude tolerance above is
        set by the label columns, about 1 / (valid rows), far above a typical
        dlogit). Returns the largest difference in ulps."""
        ulps = _bf16_ulps(torch, got, ref)
        if not ulps <= BF16_ULPS:
            raise AssertionError(f"{what}: dlogits {ulps} bf16 ulps from the plain version's "
                                 f"(at most {BF16_ULPS})")
        return ulps

    def _lm_ce_parts(fwd, bwd, h, w, dl):
        """Where K7-K10's time goes beside their yardsticks: ``gemm_ms``, one
        bf16 torch.mm of the same GEMM ([N, D] x [D, V] forward, [N, V] x
        [V, D] backward; the port calls neither), K8's plan, and ``dh_ms``,
        K10's second pass (the dlogits loaded, not formed; 128-row units) on
        the same dlogits."""
        dl = dl.contiguous()
        fwd["gemm_ms"] = _time_ms(torch, lambda: torch.mm(h, w.t()), iters=10)
        bwd["gemm_ms"] = _time_ms(torch, lambda: torch.mm(dl, w), iters=10)
        V = w.shape[0]
        buf = torch.zeros((dl.shape[0], lm_ce.padded_vocab(V)), dtype=dl.dtype, device=dev)
        buf[:, :V] = dl
        bwd["dh_ms"] = _time_ms(torch, lambda: lm_ce.dh_gemm("dh", buf, V, w), iters=10)
        plan = lm_ce.bwd_plan(dl.shape[0], w.shape[1], V, ffn.sm_count(dev))
        bwd.update({"units": plan.units, "splits": plan.splits, "kper": plan.kper,
                    "ctas": plan.ctas})
        # K7's plan: 256 x 128 tiles, both consumers on each, rows fastest
        p7 = lm_ce.coop_plan(h.shape[0], w.shape[1], V, ffn.sm_count(dev))
        fwd["plan"] = {"tile_rows": p7.tile_rows, "tile_cols": lm_ce.TILE_V,
                       "row_tiles": p7.row_tiles, "col_tiles": p7.col_tiles, "ctas": p7.ctas}

    def _k7_bound(N, V, D):
        return _bound(2 * N * D + 2 * V * D + 4 * V + 4 * N + 2 * N * V + 12 * N,
                      bf16_flops=2.0 * N * V * D)

    def _k8_bound(N, V, D):
        return _bound(2 * 2 * N * V + 2 * V * D + 16 * N + 2 * N * D,
                      bf16_flops=2.0 * N * V * D)

    # and a 1024-wide head (BART-large's): K8's two column groups, the
    # second's last warpgroup idle, over ragged rows and a ragged vocab
    head = [k78(5120, 50320, 768, True), k78(24, 1100, 128, False),
            k78(136, 2100, 1024, False)]
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
            if name == "dlogits":
                bwd["k8_dlogits_ulps"] = _check_dlogits_ulps(f"lm_ce_bwd {N}x{V}", out, ref)
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
            _lm_ce_parts(fwd, bwd, h, w, rdl)
            # each of K10's passes alone beside the torch.mm of its GEMM
            # (dh_ms: the second pass)
            bwd["dlogits_ms"] = _time_ms(
                torch, lambda: lm_ce.recompute_dlogits_pass(*bargs), iters=10)
            bwd["dlogits_gemm_ms"] = fwd["gemm_ms"]
            fwd.update(_bound(2 * N * D + 2 * V * D + 4 * V + 4 * N + 12 * N,
                              bf16_flops=2.0 * N * V * D))
            bwd.update(_bound(2 * N * D + 2 * V * D + 4 * V + 16 * N + 2 * N * V + 2 * N * D,
                              bf16_flops=4.0 * N * V * D))
        return fwd, bwd

    nomat = [k910(9216, 50320, 768, True), k910(24, 1100, 128, False),
             k910(136, 2100, 1024, False)]
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
        k3(8, 5, 32, 768, 12, 31, False, q_dtype=torch.float32, cache_dtype=torch.float32),
        # a TP 2 rank's decode step (the parallel_generate phase): 6 heads of
        # 64 over a 384-column cache row, at the last position first (the
        # kernels line's beam_attention_tp2_local row)
        k3(64, 5, 32, 384, 6, 31, True), k3(64, 5, 32, 384, 6, 0, True),
        k3(64, 5, 32, 384, 6, 15, True)]

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
        res.update(k3_plan(B, K, T, D, H, T, True))
        return res

    spread = [1 + i % 32 for i in range(112)]
    results["beam_attention_ring"] = [
        k3_ring(112, 5, 32, 768, 12, 10, spread, "1..32"),
        k3_ring(112, 5, 32, 768, 12, 17, [32] * 112, "all 32"),
        k3_ring(112, 5, 32, 768, 12, 5, [1] * 112, "all 1")]
    if results["beam_attention_ring"][0]["windows_wrapping"] * 3 < 112:
        raise AssertionError("ring rows: fewer than a third of the windows wrap")

    # K4: the statistics and each row's top-k in one pass, held to the
    # statistics' plain version and the stable sort on the same rows:
    # values and int64 indices bit-equal, cm equal, es within ES_RTOL.
    # Main-path shapes: the beam step's [B*K, V] = [320, 50320] at k 10
    # (2K) and fast sampling's k 50, the serving pool's [560, 50320] at k
    # 10, the flat [64, 5 * 50320] rows of the postprocessed paths at k 10
    # with the statistics off (exact_top_k's route); edges: forced rows
    # (-inf but one column), the tie-heavy rows of tests/test_torch_topk.py
    # at V 50320, 5 * 50320 and 3000, and the statistics alone (k 0)
    def k4(x, k, stats=True, timed=False, label=None):
        R, N = x.shape
        cm, es, vals, idx = vs.chunk_stats_topk(x, k, stats)
        rcm, res_, rvals, ridx = vs.chunk_stats_topk_plain(x, k, stats)
        torch.cuda.synchronize()
        name = f"chunk_stats_topk {label or [R, N]} k={k} stats={stats}"
        if not (torch.equal(vals.view(torch.int32), rvals.view(torch.int32))
                and torch.equal(idx, ridx) and idx.dtype == torch.int64):
            bad = (idx != ridx).any(dim=1).nonzero()[:4, 0].tolist()
            raise AssertionError(f"{name}: top-k differs from the stable sort in rows {bad}")
        finite = torch.isfinite(rvals)
        err = float((vals - rvals)[finite].abs().max()) if finite.any() else 0.0
        out = {"shape": [R, N], "k": k, "stats": stats, "label": label}
        if stats:
            if not (torch.equal(cm, rcm) and torch.isfinite(es).all()):
                raise AssertionError(f"{name}: chunk maxima differ or exp-sums not finite")
            rel = float(((es - res_).abs() / res_.clamp(min=1e-30)).max())
            _check(name, rel, ES_RTOL)
            cfin = torch.isfinite(rcm)  # equal -inf maxima already checked
            err = max(err, float((cm - rcm)[cfin].abs().max()) if cfin.any() else 0.0,
                      float((es - res_).abs().max()))
            out.update(es_max_rel_err=rel, tol=ES_RTOL)
        out["max_abs_err"] = err
        if timed:
            C = -(-N // 1024)
            out["ms"] = _time_ms(torch, lambda: vs.chunk_stats_topk(x, k, stats))
            out["plain_ms"] = _time_ms(torch, lambda: vs.chunk_stats_topk_plain(x, k, stats))
            # the library calls beside it: torch.topk on the same rows and k
            # (no documented tie order), and the stable sort it replaces
            out["library_ms"] = _time_ms(torch, lambda: torch.topk(x, k, dim=1))
            out["sort_ms"] = _time_ms(torch, lambda: top_k(x, k))
            # the logits read once; cm, es, the values and the indices
            # written once; with the statistics a max, an exp and a sum for
            # each logit in fp32
            out.update(_bound(4 * R * N + (8 * R * C if stats else 0) + 12 * R * k,
                              f32_flops=3.0 * R * N if stats else 0.0))
        return out

    x320 = randn(320, 50320, std=4.0, dtype=torch.float32)
    forced = torch.where(torch.arange(50320, device=dev)[None, :] == 2,
                         randn(320, 50320, std=4.0, dtype=torch.float32), -math.inf)
    rows_k4 = [k4(x320, 10, timed=True), k4(x320, 50, timed=True),
               k4(randn(560, 50320, std=4.0, dtype=torch.float32), 10, timed=True),
               k4(randn(64, 5 * 50320, std=4.0, dtype=torch.float32), 10, stats=False,
                  timed=True),
               k4(forced, 10, timed=True, label="forced")]
    cm_f, es_f, _, _ = vs.chunk_stats_topk(forced, 10)
    if not torch.equal(vs.logsumexp_from_stats(cm_f, es_f), forced[:, 2]):
        raise AssertionError("chunk_stats_topk: forced-row logsumexp is not the kept logit")
    # exact_top_k's other rows on the main path, statistics off: sampling's
    # postprocessed [320, 50320] at k 50 and greedy sampling's [64, 50320]
    # at k 50; and the kernel's largest k, 1024
    rows_k4 += [k4(x320, 50, stats=False, timed=True),
                k4(randn(64, 50320, std=4.0, dtype=torch.float32), 50, stats=False,
                   timed=True),
                k4(x320, 1024, label="largest k")]
    # a k over 1024: the wrapper refuses it, and the route (stats_top_k,
    # exact_top_k) takes the statistics from K4 at k 0, the top-k from the sort
    try:
        vs.chunk_stats_topk(x320, 2000)
    except ValueError:
        pass
    else:
        raise AssertionError("chunk_stats_topk: the kernel took k 2000")
    cm2, es2, v2, i2 = vs.stats_top_k(x320, 2000)
    rcm2, res2, rv2, ri2 = vs.chunk_stats_topk_plain(x320, 2000)
    ev2, ei2 = vs.exact_top_k(x320, 2000)
    bits = lambda t: t.view(torch.int32)
    if not (torch.equal(cm2, rcm2) and all(torch.equal(bits(v), bits(rv2)) for v in (v2, ev2))
            and torch.equal(i2, ri2) and torch.equal(ei2, ri2)):
        raise AssertionError("stats_top_k / exact_top_k at k 2000 differ from the plain version")
    rel2 = float(((es2 - res2).abs() / res2).max())
    _check("stats_top_k 320x50320 k=2000", rel2, ES_RTOL)
    results["vocab_stats_topk_route"] = {
        "shape": [320, 50320], "k": 2000, "es_max_rel_err": rel2, "tol": ES_RTOL,
        "route": "statistics from K4 at k 0, top-k from the stable sort"}
    for label, n in (("ties", 50320), ("ties flat", 5 * 50320), ("ties ragged", 3000)):
        x = torch.as_tensor(_tie_rows(n), device=dev)
        for k in (2, 10, 50):
            rows_k4.append(k4(x, k, label=label))
        rows_k4.append(k4(x, 10, stats=False, label=label))
    # the statistics alone (chunk_stats, k 0): the old K4's function
    stats_only = {"shape": [320, 50320], "k": 0}
    cm0, es0 = vs.chunk_stats(x320)
    rcm0, res0 = vs.chunk_stats_plain(x320)
    if not torch.equal(cm0, rcm0):
        raise AssertionError("chunk_stats: chunk maxima differ")
    _check("chunk_stats 320x50320", float(((es0 - res0).abs() / res0).max()), ES_RTOL)
    stats_only["ms"] = _time_ms(torch, lambda: vs.chunk_stats(x320))
    stats_only.update(_bound(4 * 320 * 50320 + 8 * 320 * 50, f32_flops=3.0 * 320 * 50320))
    results["vocab_stats_topk"] = rows_k4
    results["vocab_stats_only"] = stats_only

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
    results["adamw"] = check_adamw(torch, dev)
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
    from kmbart_tpu_torch.generation import beam, logits
    from kmbart_tpu_torch.models import bart, utils
    from kmbart_tpu_torch.ops import beam_attention, ffn, lm_ce, train_attention, vocab_stats
    from kmbart_tpu_torch.ops import flash_attention
    from kmbart_tpu_torch.ops.topk import top_k
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
             (beam, "stats_top_k", vocab_stats.chunk_stats_topk_plain),
             (beam, "exact_top_k", top_k), (logits, "exact_top_k", top_k),
             (utils, "exact_top_k", top_k)]
    with _swapped(swaps):
        yield


@contextlib.contextmanager
def _swapped(swaps):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def sort_selection():
    """Only the selection swapped to the stable sort it replaces: the beam
    step's statistics still from K4 (at k 0), its top-k from top_k."""
    from kmbart_tpu_torch.generation import beam
    from kmbart_tpu_torch.ops import vocab_stats
    from kmbart_tpu_torch.ops.topk import top_k

    def stats_then_sort(x, k):
        return (*vocab_stats.chunk_stats(x), *top_k(x, k))

    return _swapped([(beam, "stats_top_k", stats_then_sort),
                     (beam, "exact_top_k", top_k)])


def partials_route():
    """Only K2's inference calls swapped to the partials route
    (ffn.fused_ffn_partials: the same parts through an fp32 buffer and a
    third launch); calls with ``a`` (training) unchanged."""
    from kmbart_tpu_torch.ops import ffn
    fused = ffn.fused_ffn

    def route(x, w1, b1, w2, b2, with_a=False):
        if with_a:
            return fused(x, w1, b1, w2, b2, with_a=True)
        return ffn.fused_ffn_partials(x, w1, b1, w2, b2)

    return _swapped([(ffn, "fused_ffn", route)])


def _generate_batch(torch, cfg, dev, B=64, T=72):
    """bench.py's decode batch on ``dev``: B rows of T tokens from seed 0,
    positions 1-30 image slots, 30 ROI features a row."""
    import numpy as np
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 50000, (B, T))
    ids[:, 1:31] = cfg.img_feat_id
    return {"input_ids": torch.as_tensor(ids, device=dev),
            "attention_mask": torch.ones((B, T), dtype=torch.long, device=dev),
            "image_features": torch.as_tensor(
                rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size)),
                dtype=torch.float32, device=dev)}


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

    B, T = 64, 72
    batch = _generate_batch(torch, cfg, dev, B, T)
    input_ids, mask, feats = (batch[k] for k in ("input_ids", "attention_mask",
                                                 "image_features"))

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
    if launch_counts()["train_attention_legacy"]:
        raise AssertionError("generate: K1 launched PR 4's kernel, not the plan's")
    steps = launches["beam_attention"] // cfg.decoder_layers
    # K4 once a decode step: its statistics and chunk candidates, then the merge
    if not launches["vocab_stats_topk"] == launches["vocab_topk_merge"] == steps:
        raise AssertionError(f"K4: {launches['vocab_stats_topk']} launches and "
                             f"{launches['vocab_topk_merge']} merges over {steps} steps")
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

    # the same call with only the selection swapped to the stable sort: the
    # same function, so every row's tokens must be equal; and no torch.sort
    # of vocabulary-wide rows runs on the kernel path
    with sort_selection():
        out_s, _ = gen()
    rows_equal_sort = float((out == out_s).all(axis=1).mean())
    # and the two in turns (sort, K4, K4, sort): what the selection moves end to end
    sel_times = {False: [], True: []}
    for sort_sel in (True, False, False, True):
        with sort_selection() if sort_sel else contextlib.nullcontext():
            t0 = time.perf_counter()
            gen()
            sel_times[sort_sel].append(time.perf_counter() - t0)
    if rows_equal_sort != 1.0:
        raise AssertionError(f"generate: {int((1 - rows_equal_sort) * B)} of {B} rows differ "
                             "from the sort selection's")
    # the same call with K2's inference calls on the partials route: the
    # same bits, so every row's tokens must be equal; and the two in turns
    # (partials, K2's route, K2's route, partials)
    with partials_route():
        out_pr, _ = gen()
    rows_equal_partials = float((out == out_pr).all(axis=1).mean())
    if rows_equal_partials != 1.0:
        raise AssertionError(f"generate: {int((1 - rows_equal_partials) * B)} of {B} rows "
                             "differ from the K2 partials route's")
    k2_times = {False: [], True: []}
    for partial in (True, False, False, True):
        with partials_route() if partial else contextlib.nullcontext():
            t0 = time.perf_counter()
            gen()
            k2_times[partial].append(time.perf_counter() - t0)
    sort_shapes, torch_sort = [], torch.sort

    def recording_sort(t, *a, **kw):
        sort_shapes.append(list(t.shape))
        return torch_sort(t, *a, **kw)

    torch.sort = recording_sort
    try:
        gen()
    finally:
        torch.sort = torch_sort
    wide_sorts = [sh for sh in sort_shapes if sh and sh[-1] >= cfg.vocab_size]
    if wide_sorts:
        raise AssertionError(f"generate: torch.sort over vocabulary rows {wide_sorts[:3]}")

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
         rows_equal_to_plain=same_rows, rows_equal_to_sort_selection=rows_equal_sort,
         k4_selection_runs_s=sel_times[False], sort_selection_runs_s=sel_times[True],
         rows_equal_to_k2_partials_route=rows_equal_partials,
         k2_route_runs_s=k2_times[False], k2_partials_route_runs_s=k2_times[True],
         widest_sort=max((sh[-1] for sh in sort_shapes if sh), default=0),
         sorts_a_call=len(sort_shapes), k3_real_step=ci_r,
         k3_real_step_max_abs_err=k3_err, k3_real_step_tol=_bf16_tol(k3_ref),
         k3_real_step_ancestor_slots=int(anc_r[:, :ci_r + 1].unique().numel()))
    profile = _profile_steps(torch, gen, n=1)
    with sort_selection():
        sorted_profile = _profile_steps(torch, gen, n=1)
    profile["sort_selection"] = {key: sorted_profile[key] for key in (
        "wall_ms", "device_busy_ms", "device_busy_share", "k4_ms_per_step", "sort_ms_per_step")}
    with partials_route():
        partials_profile = _profile_steps(torch, gen, n=1)
    profile["k2_partials_route"] = {key: partials_profile[key] for key in (
        "wall_ms", "device_busy_ms", "device_busy_share", "k2_ms_per_step",
        "k2_union_ms_per_step", "k2_kernel_calls")}
    if any("ffn_finalize" in k for k in profile["k2_kernel_calls"]):
        raise AssertionError(f"generate profile: K2's inference route launched "
                             f"{profile['k2_kernel_calls']}")
    if profile["segmented_sort_kernels"]:
        raise AssertionError(f"generate profile: segmented sort kernels "
                             f"{profile['segmented_sort_kernels']}")
    # K3 over one call: its device time beside the summed bound of the
    # launches recorded above (the rows each step's ancestry reads)
    profile.update(k3_launches=len(steps_read), k3_bound_ms_per_call=k3_bound_ms)
    emit("generate_profile", card=card, **profile)

    # utils.profiling.trace around one generate() call: the Chrome trace it
    # writes names K3's and K4's launches
    from kmbart_tpu_torch.utils import profiling
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            gen()
        (name,) = os.listdir(tmp)
        size_mb = os.path.getsize(os.path.join(tmp, name)) / 2 ** 20
        with open(os.path.join(tmp, name)) as f:
            events = json.load(f)["traceEvents"]
    kernel_names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k3 = sum("beam_attention_bf16" in n for n in kernel_names)
    k4 = sum("vocab_stats_topk_kernel" in n for n in kernel_names)
    k4m = sum("topk_merge_kernel" in n for n in kernel_names)
    if not (k3 and k4 and k4m):
        raise AssertionError(f"profiling.trace: {k3} K3, {k4} K4 and {k4m} K4 merge kernels "
                             "in the trace")
    emit("generate_trace", card=card, file=name, size_mb=size_mb, events=len(events),
         kernel_events=len(kernel_names), k3_kernel_events=k3, k4_kernel_events=k4,
         k4_merge_kernel_events=k4m, k3_launches_a_call=launches["beam_attention"],
         k4_launches_a_call=launches["vocab_stats_topk"])
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


def _union_ms(prof, tags):
    """Device time during which a kernel whose name holds one of ``tags``
    runs, in ms: the union of their intervals in a profile."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and any(t in e.name for t in tags))
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


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
    # the LM-CE kernels: K7 or K9 (a projection and the merge), K8 (one
    # launch, lm_ce_bwd_gemm) or K10 (its first pass and its dh pass,
    # lm_ce_dh_gemm), each with the split vocab walk's
    # finalize; a step runs one pair, "fwdbwd" or "nomat", so the shared
    # merge and finalize go to the pair whose own kernel ran. K11, K3 (the
    # bf16 cache's kernel)
    merge, fin = per_step("lm_ce_merge_kernel"), per_step("lm_ce_dh_finalize")
    k7, k9 = per_step("lm_ce_logits_gemm"), per_step("lm_ce_stats_gemm")
    k8 = per_step("lm_ce_bwd_gemm")
    k10 = per_step("lm_ce_dlogits_gemm", "lm_ce_dh_gemm")
    if k7:
        k7 += merge
    elif k9:
        k9 += merge
    if k8:
        k8 += fin
    elif k10:
        k10 += fin
    k11 = per_step("flash_attention_wg", "flash_attention_tc")
    return {"steps": n, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            # K1 and K1b on either route (ops/train_attention.py plan)
            "k1_ms_per_step": per_step("attn_fwd_wg", "attn_fwd_tc"),
            "k1b_ms_per_step": per_step("attn_bwd_wg", "attn_bwd_tc"),
            "k2_ms_per_step": k2, "k2_share": k2 * n / busy_ms,
            # K2's second launch of an inference call starts (a programmatic
            # dependent) while the first still runs, so its kernel time
            # includes that wait: the time some K2 kernel runs, the union
            "k2_union_ms_per_step": _union_ms(prof, ("ffn_fwd_gemm", "ffn_finalize")) / n,
            # K2's forward kernels by name (the instantiations), calls a step
            "k2_kernel_calls": {e.key[:100]: e.count / n for e in events
                                if "ffn_fwd_gemm" in e.key or "ffn_finalize" in e.key},
            "k2b_ms_per_step": k2b, "k2b_share": k2b * n / busy_ms,
            "k7_ms_per_step": k7, "k7_share": k7 * n / busy_ms,
            "k8_ms_per_step": k8, "k8_share": k8 * n / busy_ms,
            "k9_ms_per_step": k9, "k9_share": k9 * n / busy_ms,
            "k10_ms_per_step": k10, "k10_share": k10 * n / busy_ms,
            "k11_ms_per_step": k11, "k11_share": k11 * n / busy_ms,
            "k3_ms_per_step": per_step("beam_attention_bf16"),
            # K4 (statistics, chunk candidates and merge) and every sort kernel
            "k4_ms_per_step": per_step("vocab_stats_topk_kernel", "topk_merge_kernel"),
            "sort_ms_per_step": per_step("sort", "Sort"),
            # the vocabulary-wide sort that K4's selection replaced ran as
            # cub's segmented radix sort behind fill_reverse_indices_kernel;
            # rows of a few dozen sort in place (radixSortKVInPlace)
            "segmented_sort_kernels": sorted({e.key[:80] for e in events if any(
                t in e.key for t in ("SegmentedRadixSort", "fill_reverse_indices"))}),
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
        # a resume from model0/: the moments checkpoint/io.py loads, updated by K12
        resume = ["--data_dir", paths["vcg"], "--checkpoint_dir", os.path.join(tmp, "resume"),
                  "--tokenizer_dir", paths["tokenizer"], "--epochs", "2", "--batch_size", "6",
                  "--checkpoint", model0, "--continue_training", "--device", "cuda"]
        code = ("import json\n"
                "from kmbart_tpu_torch import vcg_train\n"
                "from kmbart_tpu_torch.ops import launch_counts\n"
                f"run = vcg_train.main(vcg_train.parse_args({resume!r}))\n"
                "print(json.dumps({'run': run, 'adamw': launch_counts()['adamw']}))\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=600,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"train CLI resume failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        resumed = json.loads(proc.stdout.strip().splitlines()[-1])
        if not resumed["adamw"] or resumed["adamw"] % 3 or not os.path.exists(
                os.path.join(resumed["run"], "model1", "training_data.npz")):
            raise AssertionError(f"train CLI resume: {resumed}, no model1/ or not on K12")
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
    emit("train_cli", card=card, train_seconds=train_s, generated_entries=len(gen),
         resumed_adamw_launches=resumed["adamw"])

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
    kernels of the path launch (K4's top-k on the beam path's fast sampling
    and greedy sampling's draw). Beam 5 at top_k 2000 (over the 1024 K4's
    selection takes) runs K4's statistics alone and the sort's top-k."""
    import numpy as np
    from kmbart_tpu_torch.generation.api import generate
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg, model = _base_model(dev, seed=0)
    B, T = 64, 72
    batch = _generate_batch(torch, cfg, dev, B, T)
    result = {}
    for mode, beams, top_k in (("beam5", 5, 50), ("greedy", 1, 50),
                               ("beam5_top_k2000", 5, 2000)):
        def gen(seed=7):
            return generate(model, cfg, batch, num_beams=beams, max_length=32,
                            early_stopping=True, do_sample=True, top_k=top_k, top_p=0.9,
                            trim=False, generator=torch.Generator(device=dev).manual_seed(seed))
        gen(seed=1)   # warm-up
        reset_launch_counts()
        t0 = time.perf_counter()
        first = gen()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        want = ("train_attention", "ffn", "beam_attention", "vocab_stats_topk") + (
            ("vocab_topk_merge",) if top_k <= 1024 else ())
        missing = [k for k in want if counts[k] == 0]
        if missing:
            raise AssertionError(f"sample {mode}: kernels not launched: {missing}")
        if top_k > 1024 and counts["vocab_topk_merge"]:
            raise AssertionError(f"sample {mode}: K4's selection launched at k {top_k}")
        if not np.array_equal(first, gen()):
            raise AssertionError(f"sample {mode}: one generator seed gave two outputs")
        if first.shape != (B, 32) or first.min() < 0 or first.max() >= cfg.vocab_size:
            raise AssertionError(f"sample {mode}: bad output {first.shape}")
        result[mode] = {"top_k": top_k, "sentences_per_s": B / seconds, "seconds": seconds,
                        "launches": {k: counts[k] for k in want}, "same_seed_identical": True,
                        "distinct_rows": int(len({r.tobytes() for r in first}))}
    emit("sample", card=card, config="config/vcg_base.json", batch=B, enc_len=T,
         top_k=50, top_p=0.9, max_length=32, **result)


SERVE_POOL, SERVE_CHUNK, SERVE_BEAMS, SERVE_MAXLEN, SERVE_ENC = 112, 4, 5, 32, 96
SERVE_KERNELS = ("train_attention", "ffn", "beam_attention_ring", "vocab_stats_topk",
                 "vocab_topk_merge")


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


def hold_static_engine(torch, model, cfg, records, dev, **gen_kw):
    """generate() on each padded batch the static engine recorded (its
    ``record`` hook: ids, mask, features and the requests' futures in row
    order), at the engine's own bucket; every request's tokens must equal
    its own rows of that call, or this raises. Returns (requests held,
    [(batch, sample) of each request], the step traces of each call)."""
    import numpy as np
    from kmbart_tpu_torch.generation import beam
    from kmbart_tpu_torch.generation.api import generate
    t = lambda a: None if a is None else torch.as_tensor(a, device=dev)
    held, where, traces = 0, {}, []
    for j, (ids, mask, feats, futures) in enumerate(records):
        beam.STEP_TRACE = []
        try:
            ref = generate(model, cfg, {"input_ids": t(ids), "attention_mask": t(mask),
                                        "image_features": t(feats)}, trim=False, **gen_kw)
            traces.append(beam.STEP_TRACE)
        finally:
            beam.STEP_TRACE = None
        n_ret = ref.shape[0] // ids.shape[0]
        row = 0
        for fut in futures:
            got = fut.result()
            n = got.shape[0] // n_ret
            if not np.array_equal(got, ref[row * n_ret:(row + n) * n_ret]):
                raise AssertionError(f"static engine: batch {j} rows {row}..{row + n - 1} "
                                     f"differ from generate() on the same padded batch")
            where[id(fut)] = (j, row)
            row += n
            held += 1
    return held, where, traces


def near_ties(np, got, want, where, traces, ref_trace,
              what="static engine vs generate() at another batch"):
    """For each request whose tokens ``got`` (request i at (batch j, sample
    s) of the traced calls ``traces``) differ from ``want`` (sample i of the
    traced call ``ref_trace``): the first step where the two calls'
    candidates for it differ, the gap there between the two calls' choices
    (in each call's scores, the smaller of the two gaps) and the noise, the
    largest difference between the two calls' scores of the same (beam,
    token) among the sample's top-2K rows at that step. A divergence that
    starts where the gap is not within the noise, or where the noise is
    more than rounding (NEAR_TIE_NOISE_MAX), raises. Returns the report,
    one entry per differing request."""
    report = []
    steps_ref = [x for x in ref_trace if "cand_idx" in x]
    for i, (j, s) in enumerate(where):
        if np.array_equal(got[i], want[i]):
            continue
        steps = [x for x in traces[j] if "cand_idx" in x]
        entry = {"request": i, "first_token_differing": int(np.nonzero(got[i] != want[i])[0][0])}
        for t, (a, b) in enumerate(zip(steps, steps_ref)):
            ca, cb = a["cand_idx"][s].tolist(), b["cand_idx"][i].tolist()
            if ca == cb:
                continue
            pos = next(p for p in range(len(ca)) if ca[p] != cb[p])
            x, y = ca[pos], cb[pos]
            sa = dict(zip(a["row_idx"][s].tolist(), a["row_scores"][s].tolist()))
            sb = dict(zip(b["row_idx"][i].tolist(), b["row_scores"][i].tolist()))
            noise = max(abs(sa[k] - sb[k]) for k in sa.keys() & sb.keys())
            gaps = [abs(d[x] - d[y]) for d in (sa, sb) if x in d and y in d]
            entry.update(step=t + 1, candidate=pos, gap=min(gaps) if gaps else float("inf"),
                         noise=noise)
            break
        else:
            fa = traces[j][-1]["final_scores"][s].tolist()
            fb = ref_trace[-1]["final_scores"][i].tolist()
            entry.update(step="final", gap=min(abs(fa[0] - fa[1]), abs(fb[0] - fb[1])),
                         noise=max(abs(u - v) for u, v in zip(fa, fb)))
        entry["near_tie"] = entry["gap"] <= entry["noise"] <= NEAR_TIE_NOISE_MAX
        report.append(entry)
    bad = [e for e in report if not e["near_tie"]]
    if bad:
        raise AssertionError(f"{what}: divergences that do not start at a near-tie: "
                             f"{bad[:5]}")
    return report


def _row_invariance(torch, dev, model, cfg, A=32, B=112):
    """Whether each GEMM shape of the encoder and of the admit's cross K/V
    gives a row the same bits at A samples as at B samples (``dense``'s
    bf16 product with an fp32 result), and whether a row's place in the
    batch matters; the model's blocked image projection and K2 (the fused
    FFN) likewise; and the decode step's products (self-attention QKV and
    out, cross-attention Q and out, K2, the LM head) at A·5 against B·5
    rows."""
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
    # the decode step's products, one row a beam: A·5 against B·5 rows
    K, V = SERVE_BEAMS, cfg.vocab_size
    step = {"decode_self_qkv": 3 * D, "decode_self_out": D, "decode_cross_q": D,
            "decode_cross_out": D, "decode_lm_logits": V}
    for name, n in step.items():
        x = torch.randn((B * K, D), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn((n, D), generator=g, device=dev) * 0.02
        out[name] = {"rows": [A * K, B * K], "same_at_both_widths": bool(torch.equal(
            matmul_f32(x[:A * K], w), matmul_f32(x, w)[:A * K]))}
    x = torch.randn((B * K, D), generator=g, device=dev).to(torch.bfloat16)
    out["decode_k2_ffn"] = {"rows": [A * K, B * K], "same_at_both_widths": bool(torch.equal(
        ffn(x[:A * K], w1, b1, w2, b2), ffn(x, w1, b1, w2, b2)[:A * K]))}
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
        # one burst profiled on K2's route and one with K2's inference calls
        # on the partials route, in turns (partials, K2's route, partials):
        # K2's kernels summed and the union of their intervals, both routes
        # from the same run
        burst = lambda: burst_run(list(range(SERVE_POOL)), 0.0)  # noqa: E731
        keys = ("wall_ms", "device_busy_ms", "device_busy_share", "k2_ms_per_step",
                "k2_union_ms_per_step", "k2_kernel_calls")
        partials_profiles = []
        with partials_route():
            partials_profiles.append(_profile_steps(torch, burst, n=1))
        profile = _profile_steps(torch, burst, n=1)
        with partials_route():
            partials_profiles.append(_profile_steps(torch, burst, n=1))
        profile["k2_partials_route"] = [{k: pp[k] for k in keys} for pp in partials_profiles]
    finally:
        engine.shutdown()
    if any("ffn_finalize" in k for k in profile["k2_kernel_calls"]):
        raise AssertionError(f"serve profile: K2's inference route launched "
                             f"{profile['k2_kernel_calls']}")
    if not all(any("ffn_finalize" in k for k in pp["k2_kernel_calls"])
               for pp in profile["k2_partials_route"]):
        raise AssertionError("serve profile: the partials route launched no ffn_finalize")
    got = np.concatenate([outs[i] for i in range(N)])

    # the reference: generate() on the same padded rows, in batches of 112;
    # the first call's steps traced for the static engine's near-ties below
    from kmbart_tpu_torch.generation import beam
    refs, ref_trace = [], []
    for s in range(0, N, SERVE_POOL):
        beam.STEP_TRACE = ref_trace if s == 0 else None
        try:
            refs.append(generate(
                model, cfg,
                {"input_ids": torch.as_tensor(ids[s:s + SERVE_POOL], device=dev),
                 "attention_mask": torch.as_tensor(mask[s:s + SERVE_POOL], device=dev),
                 "image_features": torch.as_tensor(feats[s:s + SERVE_POOL], device=dev)},
                num_beams=SERVE_BEAMS, max_length=SERVE_MAXLEN, early_stopping=True,
                trim=False))
        finally:
            beam.STEP_TRACE = None
    ref = np.concatenate(refs)
    equal = (got == ref).all(axis=1)
    with torch.no_grad():
        t = lambda a: torch.as_tensor(a, device=dev)
        enc32 = bart.encode(model.model, cfg, t(ids[:32]), t(feats[:32]), t(mask[:32]))
        enc112 = bart.encode(model.model, cfg, t(ids[:112]), t(feats[:112]),
                             t(mask[:112]))[:32]
        invariance = _row_invariance(torch, dev, model, cfg)
    emit("serve_row_invariance", card=card, encoder_rows_equal_at_32_and_112=bool(
        torch.equal(enc32, enc112)), **invariance)
    if not invariance["decode_k2_ffn"]["same_at_both_widths"]:
        raise AssertionError("K2 gives a decode row other bits at 160 rows than at 560")
    fields = dict(card=card, config="config/vcg_base.json", requests=N, bursts=bursts,
                  burst_gap_s=0.25, pool=SERVE_POOL, chunk_steps=SERVE_CHUNK,
                  num_beams=SERVE_BEAMS, max_length=SERVE_MAXLEN, encoder_seq_len=SERVE_ENC,
                  admit_width=32, requests_per_s=N / wall, wall_s=wall,
                  latency_p50_s=float(np.percentile(lat, 50)),
                  latency_p99_s=float(np.percentile(lat, 99)),
                  latency_max_s=float(lat.max()), launches=launches,
                  k3_ring_launches=launches["beam_attention_ring"],
                  k4_launches=launches["vocab_stats_topk"],
                  k4_merge_launches=launches["vocab_topk_merge"],
                  device_busy_share=profile["device_busy_share"], profile=profile,
                  rows_equal_to_generate=float(equal.mean()))
    if not equal.all():
        bad = np.nonzero(~equal)[0]
        emit("serve", **fields, mismatched_rows=bad[:20].tolist(),
             first_differing_position=[int(np.nonzero(got[i] != ref[i])[0][0])
                                       for i in bad[:10]])
        raise AssertionError(f"serve: {len(bad)} of {N} requests differ from generate()")

    # the static engine: 64 requests, coalesced into batches of up to 32,
    # each held to generate() on the padded batch the engine ran
    records = []
    static = GenerationEngine(model, cfg, max_batch_size=32, encoder_seq_len=SERVE_ENC,
                              num_beams=SERVE_BEAMS, max_length=SERVE_MAXLEN,
                              early_stopping=True, record=records)
    server = None
    try:
        t0 = time.perf_counter()
        futs = [static.submit(ids[i:i + 1, :widths[i]], mask[i:i + 1, :widths[i]],
                              feats[i:i + 1]) for i in range(64)]
        static_out = np.concatenate([f.result(timeout=600) for f in futs])
        static_s = time.perf_counter() - t0
        static.record = None     # the HTTP request below is not one of the 64
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
    held, where, traces = hold_static_engine(torch, model, cfg, records, dev,
                                             num_beams=SERVE_BEAMS, max_length=SERVE_MAXLEN,
                                             early_stopping=True)
    if held != 64:
        raise AssertionError(f"static engine: {held} of 64 requests recorded")
    # the bound the engine meets against generate() at another batch (112
    # samples): every request that differs starts at a near-tie
    report = near_ties(np, static_out, ref[:64], [where[id(f)] for f in futs], traces,
                       ref_trace)
    emit("serve", **fields, static_requests=64, static_seconds=static_s,
         static_requests_per_s=64 / static_s, static_batches=len(records),
         static_rows_equal_to_own_batches=held / 64,
         static_requests_differing_from_generate_at_112=len(report),
         static_near_ties=report,
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


def _same_arrays(np, what, got, want):
    """``got`` has the keys of ``want`` and each array equal bit for bit."""
    if set(got) != set(want):
        raise AssertionError(f"prep_twins {what}: keys {sorted(got)} != {sorted(want)}")
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            if got[k].dtype != v.dtype or not np.array_equal(got[k], v):
                raise AssertionError(f"prep_twins {what}: {k} differs from extract_feature's")
        elif got[k] != v:
            raise AssertionError(f"prep_twins {what}: {k} {got[k]!r} != {v!r}")


def run_prep_twins(torch, dev, card, extractor):
    """The COCO and VG twins (given boxes) and the CC and SBU twins
    (proposals) on synthetic decoded images through the extract phase's
    extractor: each pickle dict equal bit for bit to direct extract_feature
    calls on the boxes the root scripts build, with their keys and shapes;
    then the prepare_coco_reason twin over three captions on the knowledge
    phase's COMET widths and assets."""
    import numpy as np
    from kmbart_tpu_torch.scripts import (prepare_cc, prepare_coco, prepare_coco_reason,
                                          prepare_sbu, prepare_vg)
    rng = np.random.default_rng(11)
    h, w = GIVEN_SHAPES[0]
    img = _synthetic_image(np, rng, h, w)
    ex = extractor
    xy = rng.uniform(0, 0.6, (12, 2)) * [w, h]
    wh = rng.uniform(0.1, 0.35, (12, 2)) * [w, h]
    seconds = {}

    # COCO: the instance boxes (xywh -> xyxy) and the whole image
    caps = {"images": [{"id": 3, "file_name": "3.jpg", "width": w, "height": h}],
            "annotations": [{"image_id": 3, "caption": "a cat"}]}
    inst = {"annotations": [{"image_id": 3, "bbox": [float(a), float(b), float(c), float(d)]}
                            for (a, b), (c, d) in zip(xy[:8], wh[:8])]}
    entry = prepare_coco.extract_data(caps, inst)[3]
    t0 = time.perf_counter()
    got = prepare_coco.image_data(entry, img, ex)
    seconds["coco"] = time.perf_counter() - t0
    f = ex.extract_feature(img, np.vstack((np.array(entry["boxes"]), [0, 0, w, h])))
    _same_arrays(np, "coco", got, {"__img_id__": "3", "image_features": f["features"],
                                   "mrm_labels": f["scores"], "boxes": f["boxes"]})
    if got["image_features"].shape != (9, 2048) or got["mrm_labels"].shape != (9, 1601):
        raise AssertionError(f"prep_twins coco: shapes {got['image_features'].shape}")

    # VG: regions, objects and the whole image; y is a box's bottom edge
    box = lambda i: {"x": float(xy[i, 0]), "y": float(xy[i, 1] + wh[i, 1]),
                     "w": float(wh[i, 0]), "h": float(wh[i, 1])}
    entry = {"img_id": 5, "regions": [{"region_id": 50 + i, **box(i)} for i in range(5)],
             "objects": [{"object_id": 500 + i, **box(i)} for i in range(5, 12)]}
    t0 = time.perf_counter()
    got = prepare_vg.image_data(entry, img, ex)
    seconds["vg"] = time.perf_counter() - t0
    boxes = np.array([[xy[i, 0], xy[i, 1], xy[i, 0] + wh[i, 0], xy[i, 1] + wh[i, 1]]
                      for i in range(12)] + [[0, 0, w, h]])
    f = ex.extract_feature(img, boxes)
    _same_arrays(np, "vg", got, {
        "__img_id__": "5", "region_features": f["features"][:5],
        "region_scores": f["scores"][:5], "region_boxes": f["boxes"][:5],
        "region_ids": list(range(50, 55)), "object_features": f["features"][5:-1],
        "object_scores": f["scores"][5:-1], "object_boxes": f["boxes"][5:-1],
        "object_ids": list(range(505, 512)), "image_feature": f["features"][-1],
        "image_score": f["scores"][-1], "image_box": f["boxes"][-1]})

    # CC and SBU: the proposal path
    ph, pw = PROPOSAL_SHAPES[-1]
    img2 = _synthetic_image(np, rng, ph, pw)
    t0 = time.perf_counter()
    got_cc = prepare_cc.image_data(img2, ex)
    seconds["cc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_sbu = prepare_sbu.image_data({"img_id": 9}, img2, ex)
    seconds["sbu"] = time.perf_counter() - t0
    f = ex.extract_feature(img2)
    want = {"image_features": f["features"], "mrm_labels": f["scores"], "boxes": f["boxes"]}
    _same_arrays(np, "cc", got_cc, want)
    _same_arrays(np, "sbu", got_sbu, {"__img_id__": "9", **want})
    kept = int(got_cc["boxes"].shape[0])
    if not 10 <= kept <= 100 or got_cc["image_features"].shape != (kept, 2048):
        raise AssertionError(f"prep_twins cc: {kept} boxes kept")

    # the COCO captions' reasoning twin, on the card
    with tempfile.TemporaryDirectory() as tmp:
        _comet_assets(os.path.join(tmp, "vocab"))
        os.makedirs(os.path.join(tmp, "annot"))
        captions = ["a man holds a cup at the table", "2 dogs run on the grass",
                    "a person sits on the bench"]
        with open(os.path.join(tmp, "annot", "train.json"), "w") as fh:
            json.dump([{"img_id": i, "img_fn": f"{i}.jpg", "labels": c}
                       for i, c in enumerate(captions)], fh)
        t0 = time.perf_counter()
        prepare_coco_reason.main(["--annot_dir", os.path.join(tmp, "annot"), "--output_dir",
                                  os.path.join(tmp, "out"), "--comet_vocab_dir",
                                  os.path.join(tmp, "vocab"), "--splits", "train",
                                  "--device", "cuda"])
        seconds["coco_reason"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "out", "reason_train.json")) as fh:
            rows = json.load(fh)
        with open(os.path.join(tmp, "out", "reason_train_ref.json")) as fh:
            refs = json.load(fh)
    if len(refs) != 3 or not rows or {r["task_type"] for r in rows} - {"before", "after",
                                                                        "intent"}:
        raise AssertionError(f"prep_twins coco_reason: {len(rows)} rows, {len(refs)} refs")
    if {r["event"] for r in rows} - set(captions):
        raise AssertionError("prep_twins coco_reason: rows of unknown captions")
    emit("prep_twins", card=card, config="config/extract_config.yaml widths, COMET GPT-1 widths",
         given_boxes={"coco_boxes": 9, "vg_boxes": 13}, proposals_kept=kept,
         equal_to_extract_feature=True, seconds=seconds, reason_rows=len(rows),
         reason_captions=len(refs))


# ---------------------------------------------------------------------------
# phase 16: multi-process data parallelism on the one card
# ---------------------------------------------------------------------------

DDP_ROWS, DDP_STEPS = 128, 3
DDP_LOSS_RTOL = 2e-3


def ddp_worker():
    """One process of the ddp phase (``chip_smoke.py --ddp-worker``): BART-base
    fine-tune steps at dropout 0 on the fine-tune cell's shapes, 128 rows
    (the second half with fewer labels) split over KMBART_NUM_PROCESSES
    ranks, replicated and then with ZeRO-1 from the same start. Prints one
    JSON line: the backend, losses, ms a step, the all-reduce's share, the
    kernel launches and a digest of the parameters after the steps."""
    import hashlib
    import torch
    from kmbart_tpu_torch import MultiModalBartConfig
    from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups
    from kmbart_tpu_torch.models.conditional import conditional_loss, init_conditional_model
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    from kmbart_tpu_torch.parallel import distributed, zero1 as zero1_mod
    from kmbart_tpu_torch.parallel.mesh import Grid
    from kmbart_tpu_torch.parallel.train_step import build_train_step
    from kmbart_tpu_torch.training.adamw import AdamW
    from kmbart_tpu_torch.training.state import TrainState, model_tensors
    torch.backends.cuda.matmul.allow_tf32 = False
    # the deterministic backward of the embedding lookup and of the ROI
    # splice (their default CUDA kernels accumulate with atomics), so two
    # runs from the same start can be compared bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    world = int(os.environ["KMBART_NUM_PROCESSES"])
    # ranks that share one card rendezvous over gloo (NCCL refuses two ranks
    # on a device); otherwise the default, which on a card is NCCL
    dev = distributed.init_distributed("cuda", backend=os.environ.get("DDP_BACKEND"))
    rank = distributed.rank()
    cfg = MultiModalBartConfig.from_json(os.path.join(REPO, "config", "vcg_base.json")).replace(
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    batch = _train_batch(torch, cfg, dev, B=DDP_ROWS)
    batch["labels"][DDP_ROWS // 2:, 24:] = -100
    rows = DDP_ROWS // world
    batch = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}

    def loss_fn(m, b, generator):
        loss, _ = conditional_loss(m, cfg, b, train=True, generator=generator)
        return loss, {}

    comm = [0.0]

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            comm[0] += time.perf_counter() - t0
            return out
        return call

    distributed.all_reduce_sum = timed(distributed.all_reduce_sum)
    zero1_mod.all_gather_flat = timed(zero1_mod.all_gather_flat)
    result = {"rank": rank, "world": world, "backend": torch.distributed.get_backend(),
              "device": str(dev)}
    for mode in ("replicated", "zero1") if world > 1 else ("replicated",):
        model = init_conditional_model(cfg, seed=0, device=dev)
        opt = AdamW(lr=1e-4, groups=jax_leaf_groups(cfg))
        state = TrainState.create(model, opt)
        z1 = None
        if mode == "zero1":
            z1 = zero1_mod.Zero1(cfg, model_tensors(model), world, rank)
            state = state._replace(opt_state=z1.shard_state(state.opt_state))
        step = build_train_step(loss_fn, opt, zero1=z1, grid=Grid())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        comm[0] = 0.0
        losses, times = [], []
        for _ in range(DDP_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, 0)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        digest = hashlib.sha256()
        for name, t in sorted(model_tensors(model).items()):
            digest.update(name.encode())
            digest.update(t.detach().cpu().numpy().tobytes())
        result[mode] = {"losses": losses, "step_s": times,
                        "ms_per_step": 1e3 * sorted(times)[len(times) // 2],
                        "comm_s": comm[0], "comm_share": comm[0] / sum(times),
                        "launches": launch_counts(), "params_sha256": digest.hexdigest(),
                        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        del model, state, step, opt
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    distributed.shutdown()


def _ddp_run(world, shared_card):
    """``world`` ddp workers, all on card 0 over gloo (``shared_card``) or
    each on its own card; their JSON lines in rank order."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    for r in range(world):
        env = dict(os.environ, KMBART_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KMBART_NUM_PROCESSES=str(world), KMBART_PROCESS_ID=str(r),
                   LOCAL_RANK="0" if shared_card else str(r),
                   CUBLAS_WORKSPACE_CONFIG=":4096:8")
        if shared_card:
            env["DDP_BACKEND"] = "gloo"
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--ddp-worker"], env=env, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"ddp worker exited {p.returncode}: {err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_ddp(torch, dev, card, cards=1):
    """Two processes on the one card, rendezvoused over gloo, at 64 rows each
    for three steps (or, with ``cards`` > 1, one process a card over NCCL,
    128 / cards rows each), against one process at 128 rows (whose
    --multihost rendezvous at world size 1 must pick NCCL): losses equal
    within DDP_LOSS_RTOL step for step, the fine-tune kernels launched on
    each rank, and the ZeRO-1 ranks' parameters bit-equal to the replicated
    ranks'; ms a step and the all-reduce's share per rank."""
    t0 = time.perf_counter()
    pair = _ddp_run(2, True) if cards == 1 else _ddp_run(cards, False)
    single = _ddp_run(1, False)[0]
    seconds = time.perf_counter() - t0
    if single["backend"] != "nccl":
        raise AssertionError(f"ddp: one rank on cuda took {single['backend']}, not nccl")
    want = single["replicated"]["losses"]
    backend = "gloo" if cards == 1 else "nccl"
    for r in pair:
        if r["backend"] != backend:
            raise AssertionError(f"ddp: rank {r['rank']} on {r['backend']}, not {backend}")
        for mode in ("replicated", "zero1"):
            got = r[mode]["losses"]
            if any(abs(a - b) > DDP_LOSS_RTOL * abs(b) for a, b in zip(got, want)):
                raise AssertionError(f"ddp {mode} rank {r['rank']}: losses {got} vs {want}")
            counts = r[mode]["launches"]
            wrong = {k: counts[k] for k, n in TRAIN_LAUNCHES.items()
                     if counts[k] != n * DDP_STEPS}
            if wrong:
                raise AssertionError(f"ddp {mode} rank {r['rank']}: launches {wrong}")
    digests = {r[m]["params_sha256"] for r in pair for m in ("replicated", "zero1")}
    if len(digests) != 1:
        raise AssertionError("ddp: ZeRO-1's parameters differ from the replicated pair's")
    emit("ddp" if cards == 1 else "ddp_nccl", card=card, config="config/vcg_base.json",
         rows=DDP_ROWS, enc_len=72, dec_len=40, steps=DDP_STEPS, dropout=0.0,
         loss_rtol=DDP_LOSS_RTOL, single_backend=single["backend"],
         ranks_backend="gloo (host-staged), one card" if cards == 1 else
         f"nccl, {cards} cards", devices=sorted({r["device"] for r in pair}),
         losses_single=want, params_bit_equal_zero1_replicated=True,
         ranks=[{"rank": r["rank"], **{m: {k: r[m][k] for k in
                                           ("losses", "ms_per_step", "comm_share",
                                            "peak_memory_gb")}
                                       for m in ("replicated", "zero1")}} for r in pair],
         single_ms_per_step=single["replicated"]["ms_per_step"],
         single_peak_memory_gb=single["replicated"]["peak_memory_gb"], seconds=seconds)


# ---------------------------------------------------------------------------
# phase 18: tensor, sequence and pipeline parallelism on the one card
# ---------------------------------------------------------------------------

PARALLEL_ROWS, PARALLEL_STEPS = 32, 3
# a parallel run against one process on the same rows, both in bf16 with K2
# off (as the CLIs run TP and PP): the step's arithmetic is the same but the
# sums run in another order (row-parallel partial products summed in fp32,
# micro-batches back-propagated one at a time), so the bounds are those of
# the kernel path against the plain path (TRAIN_LOSS_RTOL,
# TRAIN_GRAD_NORM_RTOL), per leaf with a norm of at least PARALLEL_NORM_FLOOR
# of the largest; a leaf below it (the k-projection biases, whose gradient
# is zero but for rounding: softmax ignores a constant added to a row's
# scores) is held to PARALLEL_NORM_FLOOR of the largest norm, absolutely
PARALLEL_LOSS_RTOL = TRAIN_LOSS_RTOL
PARALLEL_GRAD_NORM_RTOL = TRAIN_GRAD_NORM_RTOL
PARALLEL_NORM_FLOOR = 1e-3
# case -> (Grid options, n_micro or None, pretraining "nomat" step)
PARALLEL_CASES = {
    "tp2": (dict(model_parallel=2), None, False),
    "tp2_sp": (dict(model_parallel=2, sequence_parallel=True), None, False),
    "pp2": (dict(stages=2), 2, False),
    "pp2_pretrain_nomat": (dict(stages=2), 2, True),
    "tp2_dp2": (dict(model_parallel=2), None, False),
    "tp2_sp_dp2": (dict(model_parallel=2, sequence_parallel=True), None, False),
    "pp2_tp2": (dict(model_parallel=2, stages=2), 2, False),
}
# K1 and K1b per rank and step: 18 attentions on TP 2's 6 local heads; 9 a
# stage (3 + 3 + 3 layers' worth) on each of 2 micro-batches under PP 2; the
# LM-CE pair once on every rank (the head is whole everywhere); K2 off
PARALLEL_LAUNCHES = {"train_attention": 18, "train_attention_bwd": 18, "ffn": 0,
                     "ffn_bwd": 0, "train_attention_legacy": 0,
                     "train_attention_bwd_legacy": 0}


def _parallel_setup(torch, dev, pretrain, rows):
    """The model (random weights from seed 0), its config at dropout 0, the
    JAX leaf groups and ``rows`` rows of the fine-tune (72 + 40 tokens) or
    pretraining (96 + 72) batch."""
    from kmbart_tpu_torch import MultiModalBartConfig
    from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups
    from kmbart_tpu_torch.models.conditional import init_conditional_model
    from kmbart_tpu_torch.models.pretraining import init_pretraining_model
    name = "pretrain_base.json" if pretrain else "vcg_base.json"
    cfg = MultiModalBartConfig.from_json(os.path.join(REPO, "config", name)).replace(
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, classif_dropout=0.0)
    init = init_pretraining_model if pretrain else init_conditional_model
    model = init(cfg, seed=0, device=dev)
    batch = (_pretrain_batch(torch, cfg, dev, rows, 96, 72) if pretrain
             else _train_batch(torch, cfg, dev, B=rows))
    if not pretrain:
        batch["attention_mask"][1::2, -9:] = 0
        batch["labels"][rows // 2:, 24:] = -100
    return cfg, model, jax_leaf_groups(cfg, heads=pretrain), batch


def _parallel_loss_fn(cfg, grid, n_micro, pretrain):
    from kmbart_tpu_torch.models.conditional import conditional_loss
    from kmbart_tpu_torch.models.pretraining import pretraining_loss
    from kmbart_tpu_torch.parallel import pp

    def loss_fn(m, b, generator):
        if n_micro is not None:
            fn = pp.pipelined_pretraining_loss if pretrain else pp.pipelined_conditional_loss
            loss, _ = fn(m, cfg, b, grid, n_micro=n_micro, train=True, generator=generator)
        else:
            fn = pretraining_loss if pretrain else conditional_loss
            loss, _ = fn(m, cfg, b, train=True, generator=generator,
                         tp=None if grid is None else grid.tp)
        return loss, {}
    return loss_fn


class _GradNorms:
    """AdamW that records, at its first update, the squared norm of each JAX
    leaf's gradient as this rank holds it: a split tensor's part on every
    rank of the model axis, a whole tensor on model rank 0 of its stage (the
    ends on stage 0), so that the sum over a data coordinate's ranks is the
    whole gradient's."""

    def __init__(self, inner, groups, grid):
        self.inner, self.groups, self.grid, self.sq = inner, groups, grid, None

    def update(self, grads, state, params, **kw):
        if self.sq is None:
            import torch
            from kmbart_tpu_torch.parallel.tp import tp_axis
            grid = self.grid
            sq = []
            for key, names in self.groups.items():
                total = torch.zeros((), dtype=torch.float32, device=next(iter(params.values()))
                                    .device)
                for n in names:
                    g = grads.get(n)
                    if g is None:
                        continue
                    counted = grid is None or (
                        tp_axis(n) is not None or grid.model.index == 0) and (
                        ".layers." in n or grid.stage.index == 0)
                    if counted:
                        total = total + g.float().square().sum()
                sq.append(total)
            self.sq = torch.stack(sq)
        return self.inner.update(grads, state, params, **kw)


def parallel_worker():
    """One rank of the parallel phase (``chip_smoke.py --parallel-worker``):
    each case of PARALLEL_CASES named in PARALLEL_CASES_RUN runs
    PARALLEL_STEPS AdamW steps at dropout 0 on its grid, with
    PARALLEL_ROWS rows a data coordinate, K2 off (KMBART_NO_FUSED_FFN=1, as
    the CLIs set it), then the same steps timed once more with every
    collective timed between two synchronisations, and one step under
    torch.profiler. Prints one JSON line a case: the losses, the per-leaf
    gradient norms of the first step, ms a step, the collectives' share,
    the launches, the head counts K1 ran at, and the kernels the profile
    saw."""
    import torch
    from kmbart_tpu_torch.ops import attention as attention_mod
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    from kmbart_tpu_torch.parallel import distributed, sp
    from kmbart_tpu_torch.parallel.mesh import Grid
    from kmbart_tpu_torch.parallel.tp import shard_model_
    from kmbart_tpu_torch.parallel.train_step import build_train_step
    from kmbart_tpu_torch.training.adamw import AdamW
    from kmbart_tpu_torch.training.state import TrainState
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.init_distributed("cuda", backend=os.environ.get("DDP_BACKEND"))
    backend = torch.distributed.get_backend()

    heads = {}
    k1 = attention_mod.train_attention

    def counting_k1(*a, num_heads, **k):
        heads[num_heads] = heads.get(num_heads, 0) + 1
        return k1(*a, num_heads=num_heads, **k)

    attention_mod.train_attention = counting_k1
    comm = [0.0, False]

    def timed(fn):
        def call(*a, **k):
            if not comm[1]:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            comm[0] += time.perf_counter() - t0
            return out
        return call

    for name in ("_all_reduce", "all_gather_flat", "broadcast", "send", "recv"):
        setattr(distributed, name, timed(getattr(distributed, name)))
    sp.dist.reduce_scatter_tensor = timed(sp.dist.reduce_scatter_tensor)

    for case in os.environ["PARALLEL_CASES_RUN"].split(","):
        grid_kw, n_micro, pretrain = PARALLEL_CASES[case]
        grid = Grid(**grid_kw)
        rows = PARALLEL_ROWS
        cfg, model, groups, batch = _parallel_setup(torch, dev, pretrain,
                                                    rows * grid.data.size)
        d = grid.data.index
        batch = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
        shard_model_(model, cfg, grid)
        opt = _GradNorms(AdamW(lr=1e-4, groups=groups), groups, grid)
        step = build_train_step(_parallel_loss_fn(cfg, grid, n_micro, pretrain), opt, grid=grid)
        state = TrainState.create(model, opt.inner)
        with _ce_mode("nomat" if pretrain else "fwdbwd"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            heads.clear()
            losses, times = [], []
            for _ in range(PARALLEL_STEPS):
                t0 = time.perf_counter()
                state, metrics = step(state, batch, 0)
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            launches = launch_counts()
            k1_heads = dict(heads)
            sq = opt.sq.clone()
            distributed.all_reduce_axis(sq, grid.feed)
            norms = dict(zip(groups, sq.sqrt().tolist()))
            comm[0], comm[1] = 0.0, True
            timed_steps = []
            for _ in range(2):
                t0 = time.perf_counter()
                state, _ = step(state, batch, 0)
                torch.cuda.synchronize()
                timed_steps.append(time.perf_counter() - t0)
            comm_s, comm[1] = comm[0], False
            profile = _profile_steps(torch, lambda: step(state, batch, 0), n=1)
        kernels_seen = sorted({e["name"] for e in profile["top_device_ops"]})
        result = {"case": case, "rank": distributed.rank(), "coords": list(grid.coords),
                  "backend": backend, "device": str(dev), "losses": losses,
                  "grad_norms": norms, "step_s": times,
                  "ms_per_step": 1e3 * sorted(times[1:])[len(times[1:]) // 2],
                  "instrumented_step_s": timed_steps,
                  "collectives_share": comm_s / sum(timed_steps),
                  "launches": {k: launches[k] for k in (*PARALLEL_LAUNCHES, "lm_ce_fwd",
                                                        "lm_ce_bwd", "lm_ce_fwd_stats",
                                                        "lm_ce_recompute_bwd")},
                  "k1_heads": k1_heads,
                  "profile": {k: profile[k] for k in ("device_busy_ms", "wall_ms",
                                                       "k1_ms_per_step", "k1b_ms_per_step",
                                                       "k7_ms_per_step", "k8_ms_per_step",
                                                       "k9_ms_per_step", "k10_ms_per_step")},
                  "top_device_ops": kernels_seen,
                  "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        print(json.dumps(result), flush=True)
        del model, state, step, opt, batch
        torch.cuda.empty_cache()
    distributed.shutdown()


def _parallel_run(world, cases, shared_card, worker="--parallel-worker", **env_extra):
    """``world`` workers (``chip_smoke.py <worker>``) over ``cases``, all on
    card 0 over gloo (``shared_card``) or one a card over NCCL, with
    ``env_extra`` in their environment; {case: [rank lines]}."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    for r in range(world):
        env = dict(os.environ, KMBART_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KMBART_NUM_PROCESSES=str(world), KMBART_PROCESS_ID=str(r),
                   LOCAL_RANK="0" if shared_card else str(r),
                   PARALLEL_CASES_RUN=",".join(cases), **env_extra)
        if shared_card:
            env["DDP_BACKEND"] = "gloo"
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), worker],
                                      env=env, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out = {c: [] for c in cases}
    try:
        for p in procs:
            stdout, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"{worker} exited {p.returncode}: {err[-3000:]}")
            for line in stdout.strip().splitlines():
                if line.startswith("{"):
                    row = json.loads(line)
                    out[row["case"]].append(row)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _parallel_reference(torch, dev, pretrain, rows):
    """One process on the same rows: the losses of PARALLEL_STEPS steps and
    the per-leaf gradient norms of the first, K2 off as in the workers."""
    from kmbart_tpu_torch.parallel.train_step import build_train_step
    from kmbart_tpu_torch.training.adamw import AdamW
    from kmbart_tpu_torch.training.state import TrainState
    saved = os.environ.get("KMBART_NO_FUSED_FFN")
    os.environ["KMBART_NO_FUSED_FFN"] = "1"
    try:
        cfg, model, groups, batch = _parallel_setup(torch, dev, pretrain, rows)
        opt = _GradNorms(AdamW(lr=1e-4, groups=groups), groups, None)
        step = build_train_step(_parallel_loss_fn(cfg, None, None, pretrain), opt)
        state = TrainState.create(model, opt.inner)
        losses = []
        with _ce_mode("nomat" if pretrain else "fwdbwd"):
            for _ in range(PARALLEL_STEPS):
                state, metrics = step(state, batch, 0)
                losses.append(float(metrics["loss"]))
        norms = dict(zip(groups, opt.sq.sqrt().tolist()))
    finally:
        if saved is None:
            del os.environ["KMBART_NO_FUSED_FFN"]
        else:
            os.environ["KMBART_NO_FUSED_FFN"] = saved
    del model, state, step
    torch.cuda.empty_cache()
    return losses, norms


def _hold_parallel(case, rank_rows, ref, expect_heads):
    """Every rank's losses and per-leaf gradient norms against the one
    process's, launches per step, K1's head count, the LM-CE kernels."""
    want_losses, want_norms = ref
    top = max(want_norms.values())
    pretrain = PARALLEL_CASES[case][2]
    worst = {"loss_rel": 0.0, "grad_norm_rel": 0.0, "grad_norm_abs_of_largest": 0.0}
    for r in rank_rows:
        what = f"parallel {case} rank {r['rank']}"
        for a, b in zip(r["losses"], want_losses):
            _check(f"{what} loss (relative)", abs(a - b) / abs(b), PARALLEL_LOSS_RTOL)
            worst["loss_rel"] = max(worst["loss_rel"], abs(a - b) / abs(b))
        for key, want in want_norms.items():
            got = r["grad_norms"][key]
            if want >= PARALLEL_NORM_FLOOR * top:
                err = abs(got - want) / want
                _check(f"{what} gradient norm of {key} (relative)", err,
                       PARALLEL_GRAD_NORM_RTOL)
                worst["grad_norm_rel"] = max(worst["grad_norm_rel"], err)
            else:
                err = abs(got - want) / top
                _check(f"{what} gradient norm of {key} (absolute, of the largest)", err,
                       PARALLEL_NORM_FLOOR)
                worst["grad_norm_abs_of_largest"] = max(worst["grad_norm_abs_of_largest"], err)
        per_step = {k: r["launches"][k] / PARALLEL_STEPS for k in PARALLEL_LAUNCHES}
        if per_step != {k: float(v) for k, v in PARALLEL_LAUNCHES.items()}:
            raise AssertionError(f"{what}: launches per step {per_step}")
        pair = ("lm_ce_fwd_stats", "lm_ce_recompute_bwd") if pretrain else ("lm_ce_fwd",
                                                                            "lm_ce_bwd")
        if any(r["launches"][k] != PARALLEL_STEPS for k in pair):
            raise AssertionError(f"{what}: LM-CE launches {r['launches']}")
        if set(r["k1_heads"]) != {str(expect_heads)}:
            raise AssertionError(f"{what}: K1 ran at heads {r['k1_heads']}, not {expect_heads}")
        seen = " ".join(r["top_device_ops"])
        kernels = ["attn_fwd_wg", "attn_bwd_wg"] + (
            ["lm_ce_stats_gemm", "lm_ce_dlogits_gemm"] if pretrain
            else ["lm_ce_logits_gemm", "lm_ce_bwd_gemm"])
        profiled = {"attn_fwd_wg": r["profile"]["k1_ms_per_step"],
                    "attn_bwd_wg": r["profile"]["k1b_ms_per_step"],
                    "lm_ce_stats_gemm": r["profile"]["k9_ms_per_step"],
                    "lm_ce_dlogits_gemm": r["profile"]["k10_ms_per_step"],
                    "lm_ce_logits_gemm": r["profile"]["k7_ms_per_step"],
                    "lm_ce_bwd_gemm": r["profile"]["k8_ms_per_step"]}
        missing = [k for k in kernels if not profiled[k] > 0]
        if missing:
            raise AssertionError(f"{what}: the profile shows no device time of {missing} "
                                 f"(top ops: {seen})")
    return worst


def run_parallel(torch, dev, card, cards=1):
    """TP 2, TP 2 with SP, PP 2 (2 micro-batches) and the pretraining step
    under PP 2 in LM-CE mode "nomat": two processes on the one card over
    gloo (collectives, sends and receives of CUDA tensors staged through
    the host; NCCL refuses two ranks on one card), PARALLEL_ROWS rows of
    BART-base at the fine-tune shapes (the pretraining shapes for the
    pretraining step), each held against one process on the same rows.
    With ``cards`` = 4: TP 2 x DP 2 (also with SP, NCCL's reduce-scatter)
    and PP 2 x TP 2, one rank a card over NCCL. Returns the TP 2 case's K1 and K1b launches (both ranks)."""
    t0 = time.perf_counter()
    if cards == 1:
        cases, world = ["tp2", "tp2_sp", "pp2", "pp2_pretrain_nomat"], 2
    else:
        cases, world = ["tp2_dp2", "tp2_sp_dp2", "pp2_tp2"], 4
    runs = _parallel_run(world, cases, shared_card=cards == 1, KMBART_NO_FUSED_FFN="1")
    backend = "gloo" if cards == 1 else "nccl"
    refs = {}
    summary = {}
    for case in cases:
        grid_kw, n_micro, pretrain = PARALLEL_CASES[case]
        rows = runs[case]
        if len(rows) != world or any(r["backend"] != backend for r in rows):
            raise AssertionError(f"parallel {case}: ranks {[(r['rank'], r['backend']) for r in rows]}")
        n_data = world // (grid_kw.get("model_parallel", 1) * grid_kw.get("stages", 1))
        key = (pretrain, n_data)
        if key not in refs:
            refs[key] = _parallel_reference(torch, dev, pretrain, PARALLEL_ROWS * n_data)
        heads = 12 // grid_kw.get("model_parallel", 1)
        worst = _hold_parallel(case, rows, refs[key], heads)
        summary[case] = {
            "worst": worst,
            "grid": grid_kw, "n_micro": n_micro, "pretrain_nomat": pretrain,
            "rows_per_data_coordinate": PARALLEL_ROWS, "data_coordinates": n_data,
            "losses_single": refs[key][0],
            "ranks": [{k: r[k] for k in ("rank", "coords", "device", "losses", "ms_per_step",
                                         "collectives_share", "launches", "k1_heads",
                                         "peak_memory_gb", "profile")} for r in rows]}
    emit("parallel" if cards == 1 else "parallel_nccl", card=card,
         ranks_backend="gloo (host-staged), one card" if cards == 1 else
         f"nccl, {cards} cards", steps=PARALLEL_STEPS, dropout=0.0, ffn_kernel="off",
         loss_rtol=PARALLEL_LOSS_RTOL, grad_norm_rtol=PARALLEL_GRAD_NORM_RTOL,
         norm_floor=PARALLEL_NORM_FLOOR, cases=summary, seconds=time.perf_counter() - t0)
    if cards == 1:
        return {k: sum(r["launches"][k] for r in runs["tp2"])
                for k in ("train_attention", "train_attention_bwd")}
    return None


# ---------------------------------------------------------------------------
# phase 19: generation over a split model
# ---------------------------------------------------------------------------

# the generate cell's call (batch 64 of 72 tokens, beam 5, max_length 32)
PGEN_ROWS, PGEN_ENC, PGEN_BEAMS, PGEN_MAXLEN = 64, 72, 5, 32
# case -> Grid options: TP 2 and DP 2 on one card, TP 2 x DP 2 on four
PGEN_CASES = {"tp2": dict(model_parallel=2), "dp2": {}, "tp2_dp2": dict(model_parallel=2)}
PGEN_KERNELS = ("train_attention", "ffn", "beam_attention", "vocab_stats_topk",
                "vocab_topk_merge", "train_attention_legacy")


def parallel_generate_worker():
    """One rank of the parallel_generate phase (``chip_smoke.py
    --parallel-generate-worker``): for each case of PGEN_CASES named in
    PARALLEL_CASES_RUN, the checkpoint PGEN_CHECKPOINT cut to the rank's
    part of the grid and ``generate(..., grid=grid)`` on the whole batch:
    a warm-up, a call with the launches and the head counts K1 and K3 ran
    at, a call with every collective timed between two synchronisations,
    and a call with beam.STEP_TRACE on, whose tokens and trace go to
    PGEN_DIR/<case>.rank<r>.pt. Prints one JSON line a case."""
    import torch
    from kmbart_tpu_torch.checkpoint.io import load_pretrained
    from kmbart_tpu_torch.generation import beam
    from kmbart_tpu_torch.generation.api import generate
    from kmbart_tpu_torch.models import bart
    from kmbart_tpu_torch.ops import attention as attention_mod
    from kmbart_tpu_torch.ops import launch_counts, reset_launch_counts
    from kmbart_tpu_torch.parallel import distributed
    from kmbart_tpu_torch.parallel.mesh import Grid
    from kmbart_tpu_torch.parallel.tp import shard_model_
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.init_distributed("cuda", backend=os.environ.get("DDP_BACKEND"))
    backend = torch.distributed.get_backend()

    heads = {"k1": {}, "k3": {}}

    def counting(key, fn):
        def call(*a, num_heads, **k):
            heads[key][num_heads] = heads[key].get(num_heads, 0) + 1
            return fn(*a, num_heads=num_heads, **k)
        return call

    attention_mod.train_attention = counting("k1", attention_mod.train_attention)
    bart.beam_gather_attention = counting("k3", bart.beam_gather_attention)
    comm = [0.0, False]

    def timed(fn):
        def call(*a, **k):
            if not comm[1]:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            comm[0] += time.perf_counter() - t0
            return out
        return call

    for name in ("_all_reduce", "all_gather_flat", "broadcast"):
        setattr(distributed, name, timed(getattr(distributed, name)))

    for case in os.environ["PARALLEL_CASES_RUN"].split(","):
        grid = Grid(**PGEN_CASES[case])
        cfg, model, _ = load_pretrained(os.environ["PGEN_CHECKPOINT"], device=dev)
        if grid.model.size > 1:
            shard_model_(model, cfg, grid)
        batch = _generate_batch(torch, cfg, dev, PGEN_ROWS, PGEN_ENC)

        def gen():
            return generate(model, cfg, batch, grid=grid, num_beams=PGEN_BEAMS,
                            max_length=PGEN_MAXLEN, early_stopping=True, trim=False)

        gen()   # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        reset_launch_counts()
        for h in heads.values():
            h.clear()
        t0 = time.perf_counter()
        out = gen()
        seconds = time.perf_counter() - t0
        launches = {k: launch_counts()[k] for k in PGEN_KERNELS}
        ran_at = {k: dict(v) for k, v in heads.items()}
        comm[0], comm[1] = 0.0, True
        t0 = time.perf_counter()
        gen()
        instrumented = time.perf_counter() - t0
        comm_s, comm[1] = comm[0], False
        beam.STEP_TRACE = []
        try:
            traced = gen()
            trace = beam.STEP_TRACE
        finally:
            beam.STEP_TRACE = None
        torch.save({"tokens": traced, "trace": trace},
                   os.path.join(os.environ["PGEN_DIR"], f"{case}.rank{distributed.rank()}.pt"))
        print(json.dumps({
            "case": case, "rank": distributed.rank(), "coords": list(grid.coords),
            "backend": backend, "device": str(dev), "ms_per_call": 1e3 * seconds,
            "instrumented_ms": 1e3 * instrumented, "collectives_share": comm_s / instrumented,
            "launches": launches, "k1_heads": ran_at["k1"], "k3_heads": ran_at["k3"],
            "traced_equals_timed": bool((traced == out).all()),
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30}), flush=True)
        del model
        torch.cuda.empty_cache()
    distributed.shutdown()


def _block(B, n_data, d):
    """Data coordinate d's rows [lo, hi) of B (generation/api.py)."""
    per = -(-B // n_data)
    lo = min(d * per, B)
    return lo, min(lo + per, B)


def run_parallel_generate(torch, dev, card, cards=1):
    """Beam-5 generation over a split model at the generate cell's call
    (BART-base bf16, batch 64 of 72 tokens, max_length 32): TP 2 and DP 2
    (32 rows a rank) as two processes on the one card over gloo, or with
    ``cards`` = 4 TP 2 x DP 2 over NCCL, one rank a card; each rank's
    tokens held to one process's ``generate()`` on the same card (every
    sample that differs must start at a near-tie, ``near_ties``), the
    ranks' arrays to each other (none may differ), the launches and head
    counts of K1-K4 a rank (K1 and K3 at 6 heads and K2 off under TP).
    Returns the TP 2 case's K3 launches (both ranks)."""
    import numpy as np
    from kmbart_tpu_torch import MultiModalBartConfig
    from kmbart_tpu_torch.checkpoint.io import load_pretrained
    from kmbart_tpu_torch.generation import beam
    from kmbart_tpu_torch.generation.api import generate
    t0 = time.perf_counter()
    cfg = MultiModalBartConfig.from_json(os.path.join(REPO, "config", "vcg_base.json"))
    cases, world = (["tp2", "dp2"], 2) if cards == 1 else (["tp2_dp2"], 4)
    backend = "gloo" if cards == 1 else "nccl"
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_checkpoint(tmp, cfg, seed=0)   # the generate phase's weights
        runs = _parallel_run(world, cases, cards == 1, "--parallel-generate-worker",
                             PGEN_CHECKPOINT=tmp, PGEN_DIR=tmp)
        _, model, _ = load_pretrained(tmp, device=dev)
        batch = _generate_batch(torch, cfg, dev, PGEN_ROWS, PGEN_ENC)
        beam.STEP_TRACE = []
        try:
            t1 = time.perf_counter()
            ref = generate(model, cfg, batch, num_beams=PGEN_BEAMS, max_length=PGEN_MAXLEN,
                           early_stopping=True, trim=False)
            ref_s = time.perf_counter() - t1
            ref_trace = beam.STEP_TRACE
        finally:
            beam.STEP_TRACE = None
        del model
        torch.cuda.empty_cache()
        for case in cases:
            rows = runs[case]
            if len(rows) != world or any(r["backend"] != backend for r in rows):
                raise AssertionError(f"parallel_generate {case}: ranks "
                                     f"{[(r['rank'], r['backend']) for r in rows]}")
            tp = PGEN_CASES[case].get("model_parallel", 1)
            n_data = world // tp
            heads = 12 // tp
            saved = {r["rank"]: torch.load(os.path.join(tmp, f"{case}.rank{r['rank']}.pt"),
                                           weights_only=False) for r in rows}
            first = saved[rows[0]["rank"]]["tokens"]
            between = max(int((~(saved[r]["tokens"] == first).all(axis=1)).sum())
                          for r in saved)
            if between:
                raise AssertionError(f"parallel_generate {case}: {between} samples differ "
                                     "between ranks")
            differing, ties = {}, []
            for r in rows:
                what = f"parallel_generate {case} rank {r['rank']}"
                d = r["coords"][0]
                lo, hi = _block(PGEN_ROWS, n_data, d)
                if not r["traced_equals_timed"]:
                    raise AssertionError(f"{what}: two calls gave two outputs")
                missing = [k for k in ("train_attention", "beam_attention", "vocab_stats_topk")
                           if r["launches"][k] == 0]
                if missing:
                    raise AssertionError(f"{what}: kernels not launched: {missing}")
                if r["launches"]["train_attention_legacy"]:
                    raise AssertionError(f"{what}: K1 launched PR 4's kernel")
                if (r["launches"]["ffn"] == 0) != (tp > 1):
                    raise AssertionError(f"{what}: K2 launched {r['launches']['ffn']} times "
                                         f"at TP {tp}")
                for k in ("k1_heads", "k3_heads"):
                    if set(r[k]) != {str(heads)}:
                        raise AssertionError(f"{what}: {k} {r[k]}, not {heads}")
                sliced = [{k: v[lo:hi] for k, v in step.items()} for step in ref_trace]
                got, want = saved[r["rank"]]["tokens"][lo:hi], ref[lo:hi]
                report = near_ties(np, got, want, [(0, s) for s in range(hi - lo)],
                                   [saved[r["rank"]]["trace"]], sliced, what=what)
                differing[r["rank"]] = len(report)
                ties += [dict(e, rank=r["rank"], sample=lo + e["request"]) for e in report]
            summary[case] = {
                "grid": PGEN_CASES[case], "rows_per_data_coordinate": -(-PGEN_ROWS // n_data),
                "samples_differing_from_one_process": differing,
                "samples_differing_between_ranks": between, "near_ties": ties[:8],
                "ranks": [{k: r[k] for k in ("rank", "coords", "device", "ms_per_call",
                                             "collectives_share", "instrumented_ms",
                                             "launches", "k1_heads", "k3_heads",
                                             "peak_memory_gb")} for r in rows]}
    emit("parallel_generate" if cards == 1 else "parallel_generate_nccl", card=card,
         config="config/vcg_base.json", batch=PGEN_ROWS, enc_len=PGEN_ENC,
         num_beams=PGEN_BEAMS, max_length=PGEN_MAXLEN,
         ranks_backend="gloo (host-staged), one card" if cards == 1 else
         f"nccl, {cards} cards", one_process_ms_per_call=1e3 * ref_s,
         near_tie_noise_max=NEAR_TIE_NOISE_MAX, cases=summary,
         seconds=time.perf_counter() - t0)
    if cards == 1:
        return sum(r["launches"]["beam_attention"] for r in runs["tp2"])
    return None


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
    "train_attention": ("kmbart_tpu_torch/csrc/train_attention_wg.cu",
                        "kmbart_tpu/ops/pallas_train_attention.py:194"),
    "train_attention_bwd": ("kmbart_tpu_torch/csrc/train_attention_wg_bwd.cu",
                            "kmbart_tpu/ops/pallas_train_attention.py:223"),
    "ffn": ("kmbart_tpu_torch/csrc/ffn.cu", "kmbart_tpu/ops/pallas_ffn.py:160"),
    "ffn_bwd": ("kmbart_tpu_torch/csrc/ffn_bwd.cu", "kmbart_tpu/ops/pallas_ffn.py:190"),
    "beam_attention": ("kmbart_tpu_torch/csrc/beam_attention.cu",
                       "kmbart_tpu/ops/pallas_beam_attention.py:214"),
    "beam_attention_ring": ("kmbart_tpu_torch/csrc/beam_attention.cu",
                            "kmbart_tpu/ops/pallas_beam_attention.py:214"),
    "vocab_stats_topk": ("kmbart_tpu_torch/csrc/vocab_stats.cu",
                         "kmbart_tpu/ops/pallas_vocab_stats.py:60"),
    "adamw": ("kmbart_tpu_torch/csrc/adamw.cu",
              "none: kmbart_tpu/training/adamw.py is plain jitted JAX"),
    "lm_ce_fwd": ("kmbart_tpu_torch/csrc/lm_ce.cu", "kmbart_tpu/ops/pallas_lm_ce.py:250"),
    "lm_ce_bwd": ("kmbart_tpu_torch/csrc/lm_ce_bwd.cu", "kmbart_tpu/ops/pallas_lm_ce.py:289"),
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
                         "(kernels: that phase alone; generate, sample, serve, extract, "
                         "knowledge, reason_filter, "
                         "prep_twins, ddp, ddp_nccl, parallel, parallel_generate, "
                         "parallel_nccl, parallel_generate_nccl), then stop without the "
                         "ok line")
    ap.add_argument("--ddp-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-generate-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ddp_worker:
        return ddp_worker()
    if args.parallel_worker:
        return parallel_worker()
    if args.parallel_generate_worker:
        return parallel_generate_worker()
    run_start = time.perf_counter()
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

    t0 = time.perf_counter()
    kernels = check_kernels(torch, dev)
    emit("kernels", card=card, seconds=time.perf_counter() - t0, **kernels)
    if args.kernels_only:
        return
    if args.only:
        paths = {"kernels": lambda: None,   # it has run: the name alone stops there
                 "generate": lambda: run_generate(torch, dev, card),
                 "sample": lambda: run_sample(torch, dev, card),
                 "serve": lambda: run_serve(torch, dev, card),
                 "extract": lambda: run_extract(torch, dev, card),
                 "knowledge": lambda: run_knowledge(torch, dev, card),
                 "reason_filter": lambda: run_reason_filter(torch, dev, card),
                 "prep_twins": lambda: run_prep_twins(torch, dev, card,
                                                      run_extract(torch, dev, card)),
                 "ddp": lambda: run_ddp(torch, dev, card),
                 # every card of the machine, one rank each over NCCL
                 "ddp_nccl": lambda: run_ddp(torch, dev, card,
                                             cards=torch.cuda.device_count()),
                 "parallel": lambda: run_parallel(torch, dev, card),
                 "parallel_generate": lambda: run_parallel_generate(torch, dev, card),
                 # four cards: TP 2 x DP 2 and PP 2 x TP 2 training over
                 # NCCL, then (alone: parallel_generate_nccl) TP 2 x DP 2
                 # generation
                 "parallel_nccl": lambda: (run_parallel(torch, dev, card, cards=4),
                                           run_parallel_generate(torch, dev, card, cards=4)),
                 "parallel_generate_nccl": lambda: run_parallel_generate(torch, dev, card,
                                                                         cards=4)}
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
    run_prep_twins(torch, dev, card, extractor)
    run_knowledge(torch, dev, card)
    run_reason_filter(torch, dev, card, extractor)
    del extractor
    torch.cuda.empty_cache()
    run_ddp(torch, dev, card)
    torch.cuda.empty_cache()
    tp_launches = run_parallel(torch, dev, card)
    torch.cuda.empty_cache()
    tp_launches["beam_attention"] = run_parallel_generate(torch, dev, card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    loaded = [m for m in sys.modules if m == "kmbart_tpu" or m.startswith("kmbart_tpu.")]
    if loaded:
        raise AssertionError(f"modules of kmbart_tpu were imported: {loaded}")

    # K1 and K1b also at a TP 2 rank's local shape (6 heads, [32, 72, 384]),
    # with their launches in the parallel phase's TP 2 run (both ranks), and
    # K3 at a TP 2 rank's decode step (6 heads, cache [64, 5, 32, 384]) with
    # its launches in the parallel_generate phase's TP 2 run (both ranks)
    rows = {name: kernels[name][0] for name in KERNEL_INFO}
    for name, shape in (("train_attention", [32, 72, 72, 384, 6]),
                        ("train_attention_bwd", [32, 72, 72, 384, 6]),
                        ("beam_attention", [64, 5, 32, 384, 6])):
        rows[name + "_tp2_local"] = next(r for r in kernels[name] if r["shape"] == shape)
        launches[name + "_tp2_local"] = tp_launches[name]
    line = [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name.replace("_tp2_local", "")][0],
         "replaces": KERNEL_INFO[name.replace("_tp2_local", "")][1], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row.get("library_ms")}
        for name, row in rows.items()]
    # K4's row: its merges on the main path, and the stable sort it replaced
    k4_entry = next(e for e in line if e["name"] == "vocab_stats_topk")
    k4_entry.update(merge_launches=launches["vocab_topk_merge"],
                    sort_ms=rows["vocab_stats_topk"]["sort_ms"])
    emit("total", seconds=time.perf_counter() - run_start)
    print(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
