"""Model FLOPs of a dense decoder LM call (the work the model needs).

Per new token and layer: two operations a weight of the q, k, v and output
projections and of the three MLP matrices; per new token at absolute
position p, causal attention over its p + 1 rows: 4 H D (p + 1) (scores and
the weighted sum); the output head for the tokens whose logits are taken
(the last of a prefill, every decode token).  Norms, rotary embeddings and
softmax are left out.  Counted from the configuration's published sizes.
"""
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16


def linear_params(cfg: dict) -> int:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    return d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * f


def flops(cfg: dict, batch: int, new: int, prior: int) -> float:
    """One call over ``batch`` sequences: ``new`` tokens each after
    ``prior`` cached rows, logits of the last token only."""
    layers = cfg["num_hidden_layers"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = d // h
    rows = new * prior + new * (new + 1) // 2  # sum of (p + 1) over the new positions
    per_seq = (2.0 * layers * linear_params(cfg) * new + 4.0 * layers * h * hd * rows
               + 2.0 * d * cfg["vocab_size"])
    return batch * per_seq
