"""Matmul FLOPs and kernel bytes of one UNC DMPNN training step, from
the batch's real sizes (what the step needs, whatever it pads).

FLOPs: 2·m·n·k for every matmul of the forward, times 3 for a training
step (the backward's two products per matmul; nothing recomputed):
  per DualGraphConv layer, V real nodes, E real edges, width H:
    nodes  h@W_src, h@W_dst, h@W_nloop, the update MLP's 2   5·2·V·H²
    edges  z@W_in, z@W_out, z@(W_src-W_dst), z@W_eloop, MLP 2 6·2·E·H²
  the relation rows one_hot(E, 2R)@rel_emb and the per-relation mean
  one_hot.T@z (2·2·E·2R·H); the loss: the DistMult relation rows
  one_hot(S, R)@w_relation (2·S·R·H), the regulariser's edge_fc(z)
  (2·E·H²) and its relation rows (2·E·R·H).

Bytes (each input read once, each output written once, over the real
rows; float32 rows, int64 indices, int32 row pointers), per layer:
  K1 (segment sums over the receiver or sender plan):
    forward   the node aggregation       E·H·4 + V·H·4 + (V+1)·4
    backward  the receiver gather's      E·W·4 + V·W·4 + (V+1)·4
              the sender gather's        E·W·4 + E·8 + V·W·4 + (V+1)·4
  K2 (row gathers at the receivers):
    forward   the [V, W] endpoint table  E·W·4 + V·W·4 + E·8
    backward  the aggregation's          E·H·4 + V·H·4 + E·8
with W = 2H + 1 (the endpoint table: two products and the log-degree).
"""

F32, I64, I32 = 4, 8, 4


def forward_flops(s: dict) -> float:
    v, e, n = s["nodes"], s["edges"], s["samples"]
    h, r = s["hidden"], s["rels"]
    layer = 2 * h * h * (5 * v + 6 * e)
    return (s["layers"] * layer + 2 * 2 * e * (2 * r) * h
            + 2 * n * r * h + 2 * e * h * h + 2 * e * r * h)


def kernel_bytes(s: dict) -> dict:
    v, e, h = s["nodes"], s["edges"], s["hidden"]
    w = 2 * h + 1
    rp = (v + 1) * I32
    k1 = (e * h * F32 + v * h * F32 + rp) + (e * w * F32 + v * w * F32 + rp) \
        + (e * w * F32 + e * I64 + v * w * F32 + rp)
    k2 = (e * w * F32 + v * w * F32 + e * I64) \
        + (e * h * F32 + v * h * F32 + e * I64)
    return {"K1": s["layers"] * k1, "K2": s["layers"] * k2}


def train_step(s: dict):
    """-> (matmul FLOPs, {kernel: bytes}) of one training step."""
    return 3 * forward_flops(s), kernel_bytes(s)
