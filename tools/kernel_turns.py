"""Times K3 (beam attention) and K7-K9 (the LM head) from the tree in the
working directory, and holds their outputs to another tree's bit for bit.

    python tools/kernel_turns.py NAME --out DIR [--compare OTHER]

Run from the root of a tree (its ``kmbart_tpu_torch`` is the one imported),
on a machine with the card; every input is made from seed 0, so two trees
see the same data. Writes ``DIR/NAME.pt``: each call's outputs (K3's
whole, the LM head's m, se, ll whole and the SHA-256 of its logits, dlogits
and dh bytes). With ``--compare OTHER`` it loads ``DIR/OTHER.pt`` and
reports, for each call, the elements that differ (for a hash, 0 if equal
and 1 if not). One JSON line: the card, each call's device ms
(chip_smoke.py's _time_ms: calls queued behind a sleeping kernel, the
median of three runs of 20, 10 for the LM head) and the comparison.
Running trees in turns (A, B, B, A) in one machine gives like positions to
compare. ``--k3-only`` runs K3's calls alone.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def _time_ms(fn, iters):
    import chip_smoke
    return chip_smoke._time_ms(torch, fn, iters=iters)


def _sha(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name")
    ap.add_argument("--out", required=True)
    ap.add_argument("--compare")
    ap.add_argument("--k3-only", action="store_true")
    args = ap.parse_args()
    from kmbart_tpu_torch.ops import beam_attention as ba
    from kmbart_tpu_torch.ops import lm_ce
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    outs, ms = {}, {}

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    # K3: the main path's calls (generation's decode step at three cache
    # positions, a TP 2 rank's, the serving pool's ring windows) and the
    # edges chip_smoke.py checks (ancestry, K, head_dim, fp32 queries)
    def k3(name, B, K, T, D, H, ci, ancestry="branching", valid=None, timed=True,
           q_dtype=bf16):
        q = randn(B * K, D, dtype=q_dtype) * (D // H) ** -0.5
        kc, vc = randn(B, K, T, D), randn(B, K, T, D)
        if ancestry == "branching":
            anc = torch.randint(0, K, (B * K, T), generator=g, device=dev, dtype=torch.int32)
        elif ancestry == "shared":
            anc = torch.full((B * K, T), K - 1, device=dev, dtype=torch.int32)
        else:
            anc = torch.arange(K, device=dev, dtype=torch.int32).repeat(B)[:, None] \
                .expand(B * K, T).contiguous()
        kw = dict(num_beams=K, num_heads=H)
        if valid is not None:
            kw["valid_counts"] = torch.as_tensor(valid, dtype=torch.int32, device=dev)
        call = lambda: ba.beam_gather_attention(q, kc, vc, anc, ci, **kw)  # noqa: E731
        outs[name] = call().cpu()
        if timed:
            ms[name] = _time_ms(call, 20)

    spread = [1 + i % 32 for i in range(112)]
    for ci in (31, 15, 0):
        k3(f"k3_ci{ci}", 64, 5, 32, 768, 12, ci)
    for ci in (31, 15, 0):
        k3(f"k3_tp2_ci{ci}", 64, 5, 32, 384, 6, ci)
    k3("k3_ring_1_32", 112, 5, 32, 768, 12, 10, valid=spread)
    k3("k3_ring_all_32", 112, 5, 32, 768, 12, 17, valid=[32] * 112)
    k3("k3_ring_all_1", 112, 5, 32, 768, 12, 5, valid=[1] * 112)
    for anc in ("shared", "distinct"):
        k3(f"k3_{anc}", 64, 5, 32, 768, 12, 31, ancestry=anc, timed=False)
    k3("k3_K1", 16, 1, 32, 768, 12, 20, timed=False)
    k3("k3_K4", 16, 4, 32, 768, 12, 31, timed=False)
    k3("k3_hd32", 8, 5, 32, 384, 12, 31, timed=False)
    k3("k3_hd128", 8, 5, 32, 1536, 12, 31, timed=False)
    k3("k3_tiny", 3, 5, 12, 32, 4, 6, timed=False)
    k3("k3_q_f32", 8, 5, 32, 768, 12, 31, timed=False, q_dtype=torch.float32)

    # K7 and K8 at the fine-tune head, K7 and K9 at the pretraining head
    V, D = 50320, 768
    w = randn(V, D, std=0.02)
    fbias = randn(V, std=0.02, dtype=torch.float32)
    for N in (() if args.k3_only else (5120, 9216)):
        h = randn(N, D)
        labels = torch.randint(0, V, (N,), generator=g, device=dev, dtype=torch.int32)
        logits, m, se, ll = lm_ce.lm_ce_fwd(h, w, fbias, labels)
        outs[f"k7_{N}"] = {"m": m.cpu(), "se": se.cpu(), "ll": ll.cpu(),
                           "logits_sha256": _sha(logits)}
        m9, se9, ll9 = lm_ce.lm_ce_fwd_stats(h, w, fbias, labels)
        outs[f"k9_eq_k7_{N}"] = all(torch.equal(a, b) for a, b in ((m, m9), (se, se9), (ll, ll9)))
        ms[f"k7_{N}"] = _time_ms(lambda: lm_ce.lm_ce_fwd(h, w, fbias, labels), 10)
        valid = torch.rand((N,), generator=g, device=dev) > 0.1
        scale = (valid.float() / valid.sum()).contiguous()
        bargs = (logits, w, m, (1.0 / se).contiguous(), scale, labels)
        dl, dh = lm_ce.lm_ce_bwd(*bargs)
        outs[f"k8_{N}"] = {"dlogits_sha256": _sha(dl), "dh_sha256": _sha(dh)}
        ms[f"k8_{N}"] = _time_ms(lambda: lm_ce.lm_ce_bwd(*bargs), 10)
        if N == 9216:
            dl10, dh10 = lm_ce.lm_ce_recompute_bwd(h, w, fbias, *bargs[2:])
            outs["k10_eq_k8_9216"] = torch.equal(dl10, dl) and torch.equal(dh10, dh)
            ms["k9_9216"] = _time_ms(lambda: lm_ce.lm_ce_fwd_stats(h, w, fbias, labels), 10)
        del logits, dl, dh

    os.makedirs(args.out, exist_ok=True)
    torch.save(outs, os.path.join(args.out, f"{args.name}.pt"))
    row = {"tree": args.name, "card": card.strip(), "ms": ms,
           "checks": {k: v for k, v in outs.items() if isinstance(v, bool)}}
    if args.compare:
        other = torch.load(os.path.join(args.out, f"{args.compare}.pt"))
        diff = {}
        for k, v in outs.items():
            if k not in other or isinstance(v, bool):
                continue
            if torch.is_tensor(v):
                diff[k] = int((v.view(torch.int32) != other[k].view(torch.int32)).sum())
            else:
                diff[k] = {f: (int((x.view(torch.int32) != other[k][f].view(torch.int32)).sum())
                               if torch.is_tensor(x) else int(x != other[k][f]))
                           for f, x in v.items()}
        row["differing_from_" + args.compare] = diff
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
