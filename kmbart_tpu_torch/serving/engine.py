"""Dynamic-batching generation engine for serving.

Counterpart of kmbart_tpu/serving/engine.py. Requests are queued,
coalesced into one batch (padded to a bucket size with dummy rows), run on
a background thread through ``generate()``, and resolved through futures.
"""

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from kmbart_tpu_torch.generation.api import generate

# The batch sizes a coalesced batch is padded to: the smallest entry that
# holds the pending rows. The tuple is the JAX package's, chosen there by a
# batch sweep on its own hardware; these sizes have not been measured on the
# card. Override per deployment with the ``batch_buckets`` argument after
# running a batch sweep on the target hardware and model.
DEFAULT_BATCH_BUCKETS = (8, 16, 32, 48, 64, 80, 96, 112, 160)


class _Request:
    __slots__ = ("batch", "future", "n")

    def __init__(self, batch, n):
        self.batch = batch
        self.future = Future()
        self.n = n


class GenerationEngine:
    def __init__(self, model, cfg, tokenizer=None, *, max_batch_size=32, encoder_seq_len=None,
                 max_wait_ms=5.0, batch_buckets=None, record=None, **gen_options):
        """gen_options: forwarded to generate() (num_beams, max_length, ...;
        ``generator`` for sampling).

        ``encoder_seq_len``: requests are padded to this width (default: the
        widest request of a batch, rounded up to a multiple of 8).

        ``batch_buckets``: ascending batch sizes (DEFAULT_BATCH_BUCKETS); a
        batch pads to the smallest bucket that fits, capped by
        ``max_batch_size``.

        ``record``: a list that each padded batch is appended to, as
        ``(input_ids, attention_mask, image_features, futures)`` with the
        futures of its requests in row order: a hook for holding the engine
        to ``generate()`` on its own batches. The arrays are the ones the
        batch ran on, not copies; ``None`` (the default) records nothing."""
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_batch_size = max_batch_size
        buckets = tuple(b for b in (batch_buckets or DEFAULT_BATCH_BUCKETS)
                        if b <= max_batch_size)
        if not buckets or buckets[-1] < max_batch_size:
            buckets = buckets + (max_batch_size,)
        self.batch_buckets = buckets
        self.encoder_seq_len = encoder_seq_len
        self.max_wait_ms = max_wait_ms
        self.gen_options = gen_options
        self.record = record
        self._queue = queue.Queue()
        self._carry = None  # the request that did not fit the previous batch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- public -------------------------------------------------------------

    def submit(self, input_ids, attention_mask=None, image_features=None):
        """Queue one request (a single example or a small batch). Returns a
        Future resolving to the token array [n · num_return_sequences, L]."""
        input_ids = np.atleast_2d(np.asarray(input_ids, np.int32))
        n = input_ids.shape[0]
        if n > self.max_batch_size:
            raise ValueError(f"request of {n} rows exceeds max_batch_size="
                             f"{self.max_batch_size}; split it across submits")
        if attention_mask is None:
            attention_mask = (input_ids != self.cfg.pad_token_id).astype(np.int32)
        batch = {"input_ids": input_ids,
                 "attention_mask": np.asarray(attention_mask, np.int32),
                 "image_features": image_features}
        req = _Request(batch, n)
        self._queue.put(req)
        return req.future

    def generate_text(self, text, **kw):
        """Encode, submit, wait and decode (needs a tokenizer)."""
        enc = self.tokenizer.encode(text)
        out = self.submit(np.asarray([enc], np.int32), **kw).result()
        return [self.tokenizer.decode(row, skip_special_tokens=True) for row in out]

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- internals ----------------------------------------------------------

    def _pad_width(self, width):
        if self.encoder_seq_len is not None:
            return self.encoder_seq_len
        return ((width + 7) // 8) * 8

    def _loop(self):
        while not self._stop.is_set():
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
            reqs = [first]
            total = first.n
            # coalesce what arrives within the batching window; a request
            # that would overflow the batch waits for the next one (rows
            # must never cross requests)
            t0 = time.perf_counter()
            while total < self.max_batch_size and \
                    (time.perf_counter() - t0) < self.max_wait_ms / 1000.0:
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    time.sleep(0.0005)
                    continue
                if total + r.n > self.max_batch_size:
                    self._carry = r
                    break
                reqs.append(r)
                total += r.n
            try:
                self._run_batch(reqs)
            except Exception as e:  # surface errors through the futures
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _bucket_for(self, n):
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _run_batch(self, reqs):
        width = self._pad_width(max(r.batch["input_ids"].shape[1] for r in reqs))
        B = self._bucket_for(sum(r.n for r in reqs))
        ids = np.full((B, width), self.cfg.pad_token_id, np.int32)
        mask = np.zeros((B, width), np.int32)
        feats = None
        if any(r.batch.get("image_features") is not None for r in reqs):
            feats = np.zeros((B, self.cfg.max_img_num, self.cfg.image_feature_size),
                             np.float32)
        row = 0
        for r in reqs:
            b = r.batch
            w = min(b["input_ids"].shape[1], width)
            ids[row:row + r.n, :w] = b["input_ids"][:, :w]
            mask[row:row + r.n, :w] = b["attention_mask"][:, :w]
            if feats is not None and b.get("image_features") is not None:
                f = np.asarray(b["image_features"], np.float32)
                feats[row:row + r.n, :f.shape[1]] = f[:, :self.cfg.max_img_num]
            row += r.n
        # dummy rows keep the bucket's shape; a real token lets them finish
        ids[row:, 0] = self.cfg.eos_token_id
        mask[row:, 0] = 1
        if self.record is not None:
            self.record.append((ids, mask, feats, [r.future for r in reqs]))
        # trim=False: a response keeps the max_length width whatever batch
        # it was coalesced into; one host copy of the whole batch
        out = generate(self.model, self.cfg,
                       {"input_ids": ids, "attention_mask": mask, "image_features": feats},
                       trim=False, **self.gen_options)
        n_ret = out.shape[0] // B
        row = 0
        for r in reqs:
            r.future.set_result(out[row * n_ret:(row + r.n) * n_ret])
            row += r.n
