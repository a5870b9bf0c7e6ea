"""UNC DMPNN forward in PyTorch (dualmessagepassing_tpu/unc/model.py:
UpdateMLP2 407, DualGraphConv 429, UNCDMPNN 667, _input_embeddings 955,
UNCTrainModel 998, apply_unc_forward 1176).

Reference: HKUST-KnowComp/DualMessagePassing,
UnsupervisedNodeClassification/Model/DMPNN/src/model.py (DualGraphConv 117-280, DMPNN 283-328, TrainModel 632-737).

Reference quirks preserved, as in the JAX package:
  * DualGraphConv's dropout calls discard their result (model.py:245,260)
    — the `dropout` argument is kept for config parity and does nothing;
  * unused nfc/efc Linear layers are not reproduced;
  * update MLP is Linear-[BN]-LeakyReLU(1/5.5)-Linear with xavier-uniform
    weights and zero biases (model.py:146-168);
  * tanh between hidden layers, no activation after the last
    (model.py:299-308);
  * r-bar = per-relation mean of final edge outputs (model.py:319-325).

Port notes:
  * Parameters keep JAX's names and [in, out] layout (x @ W), so
    params_from_flax is a copy of the flax tree.
  * The compute dtype is an argument of forward: float32 master
    parameters are cast to it at use (utils/amp.py). Node and relation
    rows are gathered from the float32 tables and cast afterwards — the
    same values as casting first, and it keeps a later backward in f32.
  * The layer has one composition. Every lowering choice of the JAX
    layer (scatter_backend, pad_cols, recv_bcast, sender_windowed,
    sorted_edges, the fused endpoint gather) computes the same numbers
    and is tested equal to its plain path, so none exists here: the
    receiver gather of the [V, 2H+1] endpoint table is K2, the node
    aggregation is K1 (ops/segment_kernel.py), the sender gather is a
    plain index_select. Both kernels need the host CSR plan
    (sk_rowptr, n_real: ops/segment_kernel.attach_csr_plan).
  * K2 returns zero rows for pad edges where a plain gather returns
    table[last receiver]; pad edges are masked everywhere they could
    reach a real output, so compare valid rows only.
  * Forward only: the training slice adds the kernels' backward, the
    DistMult loss and the regularisers. Until then the kernels raise on
    inputs that require grad.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..constants import LEAKY_RELU_A
from ..models.layers import MaskedBatchNorm
from ..ops.segment_kernel import gather_rows_sorted, segment_sum_sorted
from ..utils.amp import cast_floats
from ..utils.init import embedding_uniform, scaled, xavier_uniform

Sub = Dict[str, object]


def _param(init, shape, generator) -> nn.Parameter:
    return nn.Parameter(init(shape, generator))


def _zeros(n: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n))


def _out_degrees(sub: Sub) -> torch.Tensor:
    """Global out-degrees over real edges (pad_subgraph ships them as
    sub["out_deg"]; this is the in-model fallback)."""
    senders = sub["senders"]
    v = sub["node_mask"].shape[0]
    return torch.zeros(v, device=senders.device).index_add_(
        0, senders, sub["edge_mask"].float())


class Dense(nn.Module):
    """x @ kernel + bias with an [in, out] kernel (flax nn.Dense names)."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.kernel = _param(xavier_uniform(1.0), (in_dim, out_dim), generator)
        self.bias = _zeros(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class UpdateMLP2(nn.Module):
    """Linear-[BN]-LeakyReLU(1/5.5)-Linear (model.py:146-168)."""

    def __init__(self, in_dim: int, hidden_dim: int, batch_norm: bool = True,
                 generator=None):
        super().__init__()
        h = hidden_dim
        self.fc0_kernel = _param(xavier_uniform(1.0), (in_dim, h), generator)
        self.fc0_bias = _zeros(h)
        self.fc1_kernel = _param(xavier_uniform(1.0), (h, h), generator)
        self.fc1_bias = _zeros(h)
        self.bn = MaskedBatchNorm(h) if batch_norm else None

    def forward(self, x, mask=None, train: bool = False):
        dt = x.dtype
        y = x @ self.fc0_kernel.to(dt) + self.fc0_bias.to(dt)
        if self.bn is not None:
            y = self.bn(y, mask=mask, train=train)
        y = F.leaky_relu(y, LEAKY_RELU_A)
        return y @ self.fc1_kernel.to(dt) + self.fc1_bias.to(dt)


class DualGraphConv(nn.Module):
    """UNC flavor of the dual message passing layer (model.py:117-280)."""

    def __init__(self, in_dim: int, hidden_dim: int,
                 init_neigenv: float = 4.0, init_eeigenv: float = 4.0,
                 use_bias: bool = True, batch_norm: bool = True,
                 activation: Optional[str] = None, dropout: float = 0.0,
                 generator=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.activation = activation
        self.dropout = dropout   # config parity only; see module docstring
        n_init = scaled(xavier_uniform(1.0), 1.0 / init_neigenv)
        e_init = scaled(xavier_uniform(1.0), 1.0 / init_eeigenv)
        shape = (in_dim, hidden_dim)
        self.in_weight = _param(n_init, shape, generator)
        self.out_weight = _param(n_init, shape, generator)
        self.nloop_weight = _param(n_init, shape, generator)
        self.src_weight = _param(e_init, shape, generator)
        self.dst_weight = _param(e_init, shape, generator)
        self.eloop_weight = _param(e_init, shape, generator)
        self.use_bias = use_bias
        if use_bias:
            self.nbias = _zeros(hidden_dim)
            self.ebias = _zeros(hidden_dim)
        self.nmlp = UpdateMLP2(hidden_dim, hidden_dim, batch_norm, generator)
        self.emlp = UpdateMLP2(hidden_dim, hidden_dim, batch_norm, generator)

    def forward(self, sub: Sub, node_feat: torch.Tensor,
                edge_feat: torch.Tensor, edge_norm=None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.hidden_dim
        dt = node_feat.dtype
        w_src = self.src_weight.to(dt)
        w_dst = self.dst_weight.to(dt)
        senders = sub["senders"]
        receivers = sub["receivers"]
        e_mask = sub["edge_mask"]
        rev = sub["rev_flag"][:, None]
        out_deg = sub["out_deg"] if "out_deg" in sub else _out_degrees(sub)

        # ONE [V, 2H+1] endpoint table: src/dst products plus the
        # log-degree column, cast to the compute dtype BEFORE the concat
        # (unc/model.py:525 order, for bf16 parity)
        d_col = torch.log2(1.0 + out_deg).to(dt)[:, None]
        cols = torch.cat([node_feat @ w_src, node_feat @ w_dst, d_col], dim=1)
        at_send = cols.index_select(0, senders)
        at_recv = gather_rows_sorted(cols, receivers, sub["n_real"])   # K2
        edge_msg = torch.where(
            rev,
            at_send[:, h: 2 * h] - at_recv[:, :h],
            at_recv[:, h: 2 * h] - at_send[:, :h],
        )
        node_msg = torch.where(rev, edge_feat @ self.out_weight.to(dt),
                               -(edge_feat @ self.in_weight.to(dt)))
        if edge_norm is not None:
            # edge_norm stays a float32 input; follow the compute dtype
            node_msg = node_msg * edge_norm.to(dt)
        node_msg = torch.where(e_mask[:, None], node_msg, 0.0)
        agg = segment_sum_sorted(node_msg, sub["sk_rowptr"])          # K1

        n_out = node_feat @ self.nloop_weight.to(dt) + agg
        if self.use_bias:
            n_out = n_out + self.nbias.to(dt)
        n_out = self.nmlp(n_out, mask=sub["node_mask"], train=train)

        # log-degree at the receiver, gathered with the endpoint table
        d = at_recv[:, 2 * h: 2 * h + 1].to(edge_feat.dtype)
        add = 2.0 * (1.0 + d) * (edge_feat @ (w_src - w_dst))
        e_out = edge_feat @ self.eloop_weight.to(dt) + edge_msg + add
        if self.use_bias:
            e_out = e_out + self.ebias.to(dt)
        e_out = self.emlp(e_out, mask=e_mask, train=train)

        if self.activation == "tanh":
            n_out = torch.tanh(n_out)
            e_out = torch.tanh(e_out)
        return n_out, e_out


class UNCDMPNN(nn.Module):
    """DMPNN UNC model: learned node/relation embeddings + DualGraphConv
    stack (model.py:283-328). Returns (h, z, r_bar)."""

    def __init__(self, num_nodes: int, num_rels: int, h_dim: int,
                 out_dim: int, num_hidden_layers: int = 1,
                 dropout: float = 0.0, generator=None):
        super().__init__()
        self.num_rels = num_rels          # already doubled by the caller
        emb_init = embedding_uniform(h_dim)
        self.node_emb = _param(emb_init, (num_nodes, h_dim), generator)
        self.rel_emb = _param(emb_init, (num_rels, h_dim), generator)
        self.layers = nn.ModuleList([
            DualGraphConv(
                h_dim if i == 0 else out_dim, out_dim,
                activation="tanh" if i < num_hidden_layers - 1 else None,
                dropout=dropout, generator=generator)
            for i in range(num_hidden_layers)])

    def input_embeddings(self, sub: Sub, dtype: torch.dtype):
        """EmbeddingLayer on the learned-embedding branch
        (unc/model.py:979-994): rows gathered from the float32 tables,
        then cast to the compute dtype."""
        h = self.node_emb[sub["nid"]].to(dtype)
        z = self.rel_emb[sub["edge_type"]].to(dtype)
        return h, z

    def forward(self, sub: Sub, train: bool = False,
                dtype: torch.dtype = torch.float32):
        h, z = self.input_embeddings(sub, dtype)
        # the (layer-invariant) global out-degree, hoisted out of the layers
        if "out_deg" not in sub:
            sub = dict(sub, out_deg=_out_degrees(sub))
        norm = sub.get("edge_norm")
        for layer in self.layers:
            h, z = layer(sub, h, z, edge_norm=norm, train=train)

        # per-relation mean of final edge outputs, as one_hot.T @ z in
        # float32 like the JAX package (an index_add_ of E rows into 2R
        # rows serialises on atomics: 2.0 of the 8.3 ms of device time
        # of an f32 forward at the PubMed envelope, H100 80GB HBM3, 700 W)
        onehot = F.one_hot(sub["edge_type"], self.num_rels).float() \
            * sub["edge_mask"].float()[:, None]
        sums = onehot.T @ z.float()
        cnts = onehot.sum(0)[:, None]
        r_bar = sums / (cnts + 1e-8)
        return h, z, r_bar

    def full_node_embeddings(self) -> torch.Tensor:
        """The learned embedding table (main.py:187 node_emb.weight)."""
        return self.node_emb


class UNCTrainModel(nn.Module):
    """DistMult link-prediction model around the DMPNN backbone
    (model.py:632-737), forward only in this slice. It holds w_relation
    and edge_fc so that the whole JAX parameter tree maps onto it; the
    loss, the regularisers and the supervised head come with training."""

    def __init__(self, num_nodes: int, num_rels: int, h_dim: int,
                 num_hidden_layers: int = 1, dropout: float = 0.0,
                 generator=None):
        """num_rels is the ORIGINAL relation count; the backbone embeds
        both directions (2 * num_rels edge types)."""
        super().__init__()
        self.model = UNCDMPNN(num_nodes, num_rels * 2, h_dim, h_dim,
                              num_hidden_layers, dropout, generator)
        self.w_relation = _param(xavier_uniform(math.sqrt(2.0)),
                                 (num_rels, h_dim), generator)
        self.edge_fc = Dense(h_dim, h_dim, generator)

    def forward(self, sub: Sub, train: bool = False,
                dtype: torch.dtype = torch.float32):
        """-> (h [V, H], z [E, H], r_bar [2R, H]) in `dtype` (r_bar f32)."""
        return self.model(sub, train=train, dtype=dtype)


def apply_unc_forward(model: UNCTrainModel, sub: Sub, amp: bool = False,
                      train: bool = False):
    """Forward with optional bf16 mixed precision
    (unc/model.py:1176-1208). amp=True runs the backbone with float32
    master parameters cast to bf16 at use, and casts the outputs back to
    float32. In train mode the BatchNorm running statistics are updated
    in place (they stay float32). Returns the output tuple."""
    if amp:
        return cast_floats(model(sub, train=train, dtype=torch.bfloat16),
                           torch.float32)
    return model(sub, train=train)


# -----------------------------------------------------------------------------
# weights from the JAX package
# -----------------------------------------------------------------------------

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name(path, stats: bool) -> str:
    parts = []
    for p in path:
        if p.startswith("layer_") and p[6:].isdigit():
            parts += ["layers", p[6:]]
        else:
            parts.append(p)
    if parts[-2:] == ["bn", "scale"]:
        parts[-1] = "weight"
    if stats:
        parts[-1] = _STAT_NAMES[parts[-1]]
    return ".".join(parts)


def params_from_flax(params: Mapping,
                     batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """Map a JAX UNCTrainModel(backbone="DMPNN") variable tree onto this
    module's state_dict. `params` and `batch_stats` are the nested dicts
    of the flax variables (numpy arrays, or anything np.asarray takes);
    kernels keep their [in, out] layout, so every leaf is a copy.
    BatchNorm scale -> weight, mean/var -> running_mean/running_var."""
    sd = {}
    for path, leaf in _flax_leaves(params):
        sd[_torch_name(path, stats=False)] = torch.from_numpy(
            np.array(leaf, np.float32))
    for path, leaf in _flax_leaves(batch_stats or {}):
        sd[_torch_name(path, stats=True)] = torch.from_numpy(
            np.array(leaf, np.float32))
    return sd
