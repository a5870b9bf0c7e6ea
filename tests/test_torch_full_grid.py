"""The port's capability grid (tests/test_full_grid.py for
dualmessagepassing_tpu_torch): every ported rep net x every ported pred
net trains.

Nine rep nets (DMPNN, CompGCN, R-GCN, R-GIN; CNN, RNN, TXL; LRP, DMPLRP)
x ten pred nets (Sum, Mean, Max, their Attn and MemAttn variants, and
DIAMNet; the memory nets' mem_init runs through the ten values over the
grid, MEM_INITS). For each
combination: (a) the model builds and gives finite counts of shape
[B, 1]; (b) over two optimizer steps of the count + matching loss the
loss and every gradient stay finite, and the second step's gradient is
not identically zero in any rep or pred subtree, nor in any submodule of
a pred net (p_attn and g_attn among them: the zero-initialised last
layers stop the first gradient by construction); (c) the loss after them
is finite. On the CPU; gated behind FULL_GRID=1, as the JAX package's
grid is.

Run with:  FULL_GRID=1 python -m pytest tests/test_torch_full_grid.py -q
"""

import os

import numpy as np
import pytest
import torch

from dualmessagepassing_tpu_torch.data.dataset import lrp_batch
from dualmessagepassing_tpu_torch.data.lrp import (count_perms,
                                                   record_to_lrp_perms)
from dualmessagepassing_tpu_torch.graph import (add_reversed_edges,
                                                batch_edgeseqs, batch_graphs,
                                                record_to_edgeseq,
                                                single_graph)
from dualmessagepassing_tpu_torch.models.basemodel import ModelConfig
from dualmessagepassing_tpu_torch.models.pred_attn import MEM_INITS
from dualmessagepassing_tpu_torch.models.scm_models import build_model
from dualmessagepassing_tpu_torch.train import scm_driver as tdrv

pytestmark = pytest.mark.skipif(
    not os.environ.get("FULL_GRID"),
    reason="90-combination grid; set FULL_GRID=1 to run")

REP_NETS = ["DMPNN", "CompGCN", "RGCN", "RGIN", "CNN", "RNN", "TXL", "LRP",
            "DMPLRP"]
PRED_NETS = ["SumPredictNet", "MeanPredictNet", "MaxPredictNet",
             "SumAttnPredictNet", "MeanAttnPredictNet", "MaxAttnPredictNet",
             "SumMemAttnPredictNet", "MeanMemAttnPredictNet",
             "MaxMemAttnPredictNet", "DIAMNet"]


def grid_batch(rep_net, bsz=4, seed=0):
    """bsz random pairs (pattern 4 V / 4 E, graph 6 V / 10 E, 2 labels,
    reversed edges), as GraphBatches, EdgeSeqBatches or LRP batches."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(bsz):
        pair = []
        for v, e in ((4, 4), (6, 10)):
            nv, ne = int(rng.integers(2, v + 1)), int(rng.integers(1, e + 1))
            pair.append(add_reversed_edges(single_graph(
                nv, rng.integers(0, nv, ne), rng.integers(0, nv, ne),
                node_labels=rng.integers(0, 2, nv),
                edge_labels=rng.integers(0, 2, ne), v_max=v, e_max=e), 2))
        pairs.append(pair)
    recs = ([p[0] for p in pairs], [p[1] for p in pairs])
    if rep_net in ("CNN", "RNN", "TXL"):
        return tuple(batch_edgeseqs([record_to_edgeseq(r) for r in rs])
                     for rs in recs)
    if rep_net in ("LRP", "DMPLRP"):
        def lift(rs):
            p_max = max(count_perms(r, 4) for r in rs) or 1
            return lrp_batch(batch_graphs(rs), [
                {k: a for k, a in record_to_lrp_perms(r, 4, p_max).items()
                 if k != "n_perm"} for r in rs])
        return tuple(lift(rs) for rs in recs)
    return tuple(batch_graphs(rs) for rs in recs)


def subtrees(model):
    """(name, module) of every rep and pred subtree with parameters, and
    of every child of a pred net."""
    for name, child in model.named_children():
        if "rep" in name or "pred" in name:
            yield name, child
        if "pred" in name:
            for sub, grand in child.named_children():
                yield f"{name}.{sub}", grand


@pytest.mark.parametrize("rep_net", REP_NETS)
@pytest.mark.parametrize("pred_net", PRED_NETS)
def test_grid(rep_net, pred_net):
    cfg = ModelConfig(
        max_ngv=6, max_ngvl=2, max_nge=20, max_ngel=4, max_npv=4,
        max_npvl=2, max_npe=8, max_npel=4, hid_dim=8,
        rep_num_pattern_layers=1, rep_num_graph_layers=1, pred_hid_dim=8,
        filter_net="ScalarFilter", rep_net=rep_net, pred_net=pred_net,
        pred_return_weights="nodeedge", rep_rgcn_num_bases=2,
        rep_rgin_num_bases=2, rep_txl_seg_len=4, rep_txl_mem_len=4,
        pred_mem_len=3, pred_mem_init=MEM_INITS[
            (REP_NETS.index(rep_net) + PRED_NETS.index(pred_net))
            % len(MEM_INITS)])
    model = build_model(cfg, device="cpu")
    pattern, graph = grid_batch(rep_net)
    with torch.no_grad():
        pred_c = tdrv.apply_model(model, pattern, graph)["pred_c"]
    assert pred_c.shape == (4, 1) and bool(torch.isfinite(pred_c).all())

    def loss_fn():
        out = tdrv.apply_model(model, pattern, graph, train=True)
        loss = ((out["pred_c"] - 1.0) ** 2).mean()
        for k in ("pred_v", "pred_e"):
            if out[k] is not None:
                loss = loss + 0.1 * ((out[k] - 0.5) ** 2).mean()
        return loss

    opt = tdrv.make_optimizer(model.parameters(), 1e-2)
    for _ in range(2):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        assert bool(torch.isfinite(loss))
        for k, p in model.named_parameters():
            assert p.grad is None or bool(torch.isfinite(p.grad).all()), k
        opt.step()
    for name, sub in subtrees(model):
        grads = [p.grad for p in sub.parameters()]
        if grads:
            total = sum(float(g.abs().sum()) for g in grads if g is not None)
            assert total > 0, f"identically-zero gradient subtree: {name}"
    with torch.no_grad():
        assert bool(torch.isfinite(loss_fn()))
