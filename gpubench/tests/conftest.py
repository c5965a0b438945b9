"""Shared settings of the benchmark's CPU tests: every cell at a tiny size.

``tiny_mix(cell)`` shrinks the cell's traffic (batch, lengths, pool) and
``TINY`` the configuration's sizes, keeping every other key of the
manifest's files, so a test drives the harness's whole run on the CPU.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(vocab_size=128, d_model=32, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
            decoder_ffn_dim=64, max_position_embeddings=128, img_feat_id=90, cls_token_id=93,
            image_feature_size=20, num_labels=7, num_attributes=5, num_relations=5,
            max_img_num=4)

SEED = 3000000019


def tiny_mix(cell):
    mix = {"batch": 4, "enc_len": 16, "real_len": [10, 16], "image_slots": 4, "pool": 3,
           "ref_block": 2, "check_rows": 6, "traced_units": 1}
    if "gen" in cell:
        mix["generate"] = {"num_beams": 2, "max_length": 6, "early_stopping": True,
                           "do_sample": False}
    else:
        # 16 rows: at fewer, a small leaf's change moves by more than the
        # cell's limit on round-off alone
        mix.update(batch=16, ref_block=8, dec_len=8, dec_real_len=[4, 8])
    if "pretrain" in cell:
        mix.update(real_len=[14, 16], dec_len=12, dec_real_len=[12, 12], relation_pairs=6,
                   relations_present=2, masked_region_share=0.5)
    return mix


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
