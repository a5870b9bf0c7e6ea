"""Matmul FLOPs and K3 bytes of one SCM DMPNN step (SumPredictNet with
its node-weight head), from the batch's real sizes.

FLOPs, 2·m·n·k per matmul of the forward (times 3 for training):
  embeddings   multi-hot label rows @ tables: 2·N·Dvl·H + 2·E·Del·H
  per DMP layer, N nodes, E edges, width H (pattern and graph alike):
    nodes  h@[W_src|W_dst] (2 products), h@W_nloop, MLP 2     5·2·N·H²
    edges  e@W_in, e@W_out, e@(W_src-W_dst), e@W_eloop, MLP 2 6·2·E·H²
  SumPredictNet, hidden P, B pairs, Ng graph nodes, Np pattern nodes:
    p_fc, g_fc                 2·(Np + Ng)·H·P
    weight head, concat-free   2·B·P² + 3·2·Ng·P² + 2·2·B·P
                               + 2·Ng·P + 2·2·B
    count head                 2·B·(4P+4)·P + 2·B·(P+4)

K3 bytes (each input read once, each output written once, over the
real rows: float32 rows, int64 indices):
  forward, per layer and side   the node sum: E·H·4 + N·H·4 + E·8
          per side              the out-degrees: E·4 + N·4 + E·8
  backward, per layer and side  the two endpoint gathers' sums:
                                2·(E·2H·4 + N·2H·4 + E·8)
"""

F32, I64 = 4, 8


def forward_flops(s: dict) -> float:
    h, p, layers = s["hidden"], s["pred_hidden"], s["layers"]
    f = 0.0
    for side in ("p", "g"):
        n, e = s[side + "_nodes"], s[side + "_edges"]
        f += 2 * n * s["enc_vl"] * h + 2 * e * s["enc_el"] * h
        f += layers * 2 * h * h * (5 * n + 6 * e)
    b, ng, np_ = s["batch"], s["g_nodes"], s["p_nodes"]
    f += 2 * (np_ + ng) * h * p
    f += 2 * b * p * p + 3 * 2 * ng * p * p + 2 * 2 * b * p \
        + 2 * ng * p + 2 * 2 * b
    f += 2 * b * (4 * p + 4) * p + 2 * b * (p + 4)
    return f


def k3_bytes(s: dict, train: bool) -> float:
    h, layers = s["hidden"], s["layers"]
    total = 0.0
    for side in ("p", "g"):
        n, e = s[side + "_nodes"], s[side + "_edges"]
        total += layers * (e * h * F32 + n * h * F32 + e * I64)
        total += e * F32 + n * F32 + e * I64
        if train:
            total += layers * 2 * (e * 2 * h * F32 + n * 2 * h * F32
                                   + e * I64)
    return total


def train_step(s: dict):
    return 3 * forward_flops(s), {"K3": k3_bytes(s, True)}


def eval_step(s: dict):
    return forward_flops(s), {"K3": k3_bytes(s, False)}
