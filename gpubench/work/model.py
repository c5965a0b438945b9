"""The model's operations from its shapes, for MFU.

Matrix products only, 2 operations a multiply-add, as the model needs them
(not as a kernel pads or recomputes them): every position of the padded
batch the system is handed, causal self-attention over the pairs it keeps,
the image projection of every ROI slot, and the LM head over every decoder
position. Training counts the forward three times (forward and backward).
"""


def encoder_flops(cfg, T):
    """One sequence of T encoder positions, with its image projection."""
    D, F = cfg["d_model"], cfg["encoder_ffn_dim"]
    per_layer = 8 * T * D * D + 4 * T * T * D + 4 * T * D * F
    return 2 * cfg["max_img_num"] * cfg["image_feature_size"] * D \
        + cfg["encoder_layers"] * per_layer


def decoder_flops(cfg, T, T_enc):
    """One sequence of T teacher-forced decoder positions over T_enc
    encoder positions, with the LM head."""
    D, F, V = cfg["d_model"], cfg["decoder_ffn_dim"], cfg["vocab_size"]
    pairs = T * (T + 1) // 2
    per_layer = (8 * T * D * D + 4 * pairs * D            # self-attention
                 + 4 * T * D * D + 4 * T_enc * D * D      # cross q, out; k, v
                 + 4 * T * T_enc * D                      # cross scores, P.V
                 + 4 * T * D * F)
    return cfg["decoder_layers"] * per_layer + 2 * T * D * V


def heads_flops(cfg, T, pairs):
    """The three pretraining heads (dense, tanh, out) of one sequence."""
    D = cfg["d_model"]
    return (T * (2 * D * D + 2 * D * cfg["num_labels"])
            + T * (2 * D * D + 2 * D * cfg["num_attributes"])
            + pairs * (4 * D * D + 2 * D * cfg["num_relations"]))


def train_step_flops(cfg, mix):
    B, Te, Td = mix["batch"], mix["enc_len"], mix["dec_len"]
    fwd = encoder_flops(cfg, Te) + decoder_flops(cfg, Td, Te)
    if mix.get("relation_pairs"):
        fwd += heads_flops(cfg, Td, mix["relation_pairs"])
    return 3.0 * B * fwd


def generate_flops(cfg, mix, steps):
    """One generate call of ``steps`` decode steps over a batch: the
    encoder, each layer's cross K/V once, and each step's B·K beam rows
    (step s attends s + 1 positions), the LM head included."""
    B, Te, K = mix["batch"], mix["enc_len"], mix["generate"]["num_beams"]
    D, F, V = cfg["d_model"], cfg["decoder_ffn_dim"], cfg["vocab_size"]
    L = cfg["decoder_layers"]
    total = B * encoder_flops(cfg, Te) + L * B * 4 * Te * D * D
    for s in range(steps):
        per_row = L * (8 * D * D + 4 * (s + 1) * D + 4 * D * D + 4 * Te * D + 4 * D * F) \
            + 2 * D * V
        total += B * K * per_row
    return float(total)
