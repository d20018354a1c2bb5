"""The whole step's share of the card's peak: the model's operations a
step, counted from the configuration's shapes, times the steps of the
traced window's plain part, over its host-clock length times the peak of
the configuration's dtype (NVIDIA's data sheet, H100 SXM at 700 W: 67
TFLOP/s in float32 outside the tensor cores, 989 in bfloat16).

Full-graph GCN training: the decode's adds, the products of the decoder
MLP and of each of the ``n_gnn_layers`` GCN layers (``d_e`` to
``hidden``, then ``hidden`` to ``hidden``), each layer's sparse product
over its input (a multiply and an add a stored element and column of
A + I) and the output layer over the training rows; the backward twice
each dense product, once each sparse product (the input's gradient) and
the codebook gradient's adds.  LM training: ``lm_flops``."""

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def gcn_flops(cfg: dict, traffic: dict) -> float:
    e = cfg["embedding"]
    n, H, d_e, C = cfg["n_nodes"], cfg["hidden"], cfg["d_e"], cfg["n_classes"]
    nnz = 2 * cfg["n_edges"] + n
    dims = [e["d_c"]] + [e["d_m"]] * (e["n_layers"] - 1) + [d_e]
    gnn = [d_e] + [H] * cfg["n_gnn_layers"]
    dense = n * sum(a * b for a, b in zip(dims, dims[1:]))
    dense += n * sum(a * b for a, b in zip(gnn, gnn[1:]))
    dense += int(cfg["split_frac"][0] * n) * H * C
    sparse = nnz * sum(gnn[:-1])
    decode = n * (e["m"] - 1) * e["d_c"]
    forward = 2 * dense + 2 * sparse + decode
    return float(forward + 4 * dense + 2 * sparse + n * e["m"] * e["d_c"])


def lm_flops(cfg: dict, traffic: dict) -> float:
    """A training step of an attention LM: 6 times the parameters a token
    multiplies through times the tokens (the experts a token is routed to,
    not the ones the dense dispatch also computes; no recompute), plus the
    causal attention's products, forward and backward: 12 L H Dh S^2 B / 2.
    The embedding's decode is a lookup and its decoder MLP is counted."""
    e = cfg["embedding"]
    L, D, F = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = D // H
    attn = D * H * Dh + 2 * D * K * Dh + H * Dh * D
    experts = cfg["num_experts_per_tok"] * 3 * D * F + D * cfg["num_local_experts"]
    dims = [e["d_c"]] + [e["d_m"]] * (e["n_layers"] - 1) + [D]
    decoder = sum(a * b for a, b in zip(dims, dims[1:]))
    n_active = L * (attn + experts) + D * cfg["vocab_padded"] + decoder
    B, S = traffic["batch"], traffic["seq"]
    return 6.0 * n_active * B * S + 12.0 * L * H * Dh * S**2 * B / 2


FLOPS = {"fullgraph_gnn": gcn_flops, "lm_train": lm_flops}


def read(ctx: dict):
    cfg, plain = ctx["config"], ctx["plain"]
    count = FLOPS.get(cfg["system"])
    if count is None or not plain["units"]:
        return None
    flops = count(cfg, ctx["traffic"]) * plain["units"]
    return 100.0 * flops / (plain["seconds"] * PEAK_FLOPS[cfg["compute_dtype"]])
