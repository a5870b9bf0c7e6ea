"""UNC training on prepared batches: the program's train step, fed as
train_unc feeds it, with the host sampler taken out of the window.

Set-up (as unc/driver.train_unc prepares a run): the heterogeneous
graph from the seed; the model (unc/model.UNCTrainModel) with the
benchmark's weights; make_unc_optimizer over train_unc's schedule
length; make_unc_train_step with a dropout generator seeded from the
seed; and traffic["batches"] batches of the first epoch, each sampled by
the program's sample_batch and planned by attach_csr_plan(sender_plan=
True) from np.random.default_rng(seed).spawn, on traffic["sample_threads"]
threads. The first traffic["check_steps"] batches are then trained on,
through the window's own call: their losses, the first gradient (from
Adam's first moment after one step) and the parameters after the last
of them are what the check compares; they also warm up every shape.

Window: the remaining batches, then all of them in turn; each step is
to_device, the step and the loss read, as train_unc runs it.
Work: the positive links of every completed step.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dualmessagepassing_tpu_torch.cli.unc_train import get_args
from dualmessagepassing_tpu_torch.ops.segment_kernel import attach_csr_plan
from dualmessagepassing_tpu_torch.unc.data import WholeGraph
from dualmessagepassing_tpu_torch.unc.driver import (make_unc_optimizer,
                                                     make_unc_train_step,
                                                     sample_batch, to_device)
from dualmessagepassing_tpu_torch.unc.model import UNCTrainModel

from ..core import compare
from ..core.generators import synthetic_hin
from ..core.harness import Window, tally, timed_loop
from ..core.weights import make_weights


class State:
    pass


def flags(config: dict):
    return get_args(config["argv"])


def setup(ctx) -> State:
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    a = flags(cfg)
    data = cfg["data"]
    n, r = data["num_nodes"], data["num_rels"]
    st = State()
    st.ref = ctx.cell.reference
    rng = np.random.default_rng(ctx.seed)
    with ctx.span("graph"):
        triplets = synthetic_hin(n, data["num_links"], r, rng)
        graph = WholeGraph(n, r, triplets)
    model = UNCTrainModel(n, r, a.n_hidden, num_hidden_layers=a.n_layers,
                          dropout=a.dropout, reg_param=a.regularization,
                          backbone=a.model).to(dev)
    spec = st.ref.param_spec(cfg)
    model.load_state_dict(make_weights(spec, ctx.seed, dev), strict=True)
    # train_unc's schedule length: n_epochs rescaled to cover the nodes
    n_batches = math.ceil(len(triplets) / a.graph_batch_size)
    n_epochs = math.ceil(a.n_epochs * n_batches * a.graph_batch_size / n)
    opt = make_unc_optimizer(model, a.lr, n_epochs * n_batches, a.grad_norm)
    dropout_gen = torch.Generator(device=dev).manual_seed(
        ctx.seed % (2 ** 63))
    step = make_unc_train_step(model, opt, amp=False, generator=dropout_gen)

    v_max = n
    e_max = min(v_max * a.sample_width, graph.num_edges)
    s_max = a.graph_batch_size * (1 + a.negative_sample)
    order = rng.permutation(len(triplets))
    nb = traffic["batches"]
    edges = [triplets[order[i * a.graph_batch_size:
                            (i + 1) * a.graph_batch_size]]
             for i in range(nb)]
    child = rng.spawn(nb)

    def prepare(i):
        return attach_csr_plan(sample_batch(
            graph, edges[i], a.sampler, a.sample_depth, a.sample_width,
            a.graph_split_size, a.negative_sample, v_max, e_max, s_max,
            child[i], send_keys=True), sender_plan=True)

    with ctx.span("sample"):
        with ThreadPoolExecutor(traffic["sample_threads"]) as pool:
            batches = list(pool.map(prepare, range(nb)))
    st.summaries = [summary(b, a, r) for b in batches]

    k = traffic["check_steps"]
    names = [name for name, _ in model.named_parameters()]
    losses = []
    for i in range(k):
        sub = to_device(batches[i], dev)
        losses.append(float(step(sub)))
        if i == 0:
            b1 = opt.adam.defaults["betas"][0]
            st.grad1 = {name: (opt.adam.state[p].get(
                "exp_avg", torch.zeros_like(p)) / (1.0 - b1)).detach().cpu()
                for name, p in zip(names, opt.params)}
    st.losses = losses
    st.after = {name: p.detach().cpu().clone()
                for name, p in model.named_parameters()}
    st.model, st.opt, st.step = model, opt, step
    st.batches, st.edges, st.triplets = batches, edges, triplets
    st.first = k
    st.flags = a
    return st


def summary(batch: dict, a, rels: int) -> dict:
    """The sizes the counts read: real edges, nodes and samples."""
    return {"edges": int(batch["n_real"]),
            "nodes": int(np.asarray(batch["node_mask"]).sum()),
            "samples": int(np.asarray(batch["sample_mask"]).sum()),
            "positives": int(np.asarray(batch["labels"]).sum()),
            "hidden": a.n_hidden, "layers": a.n_layers,
            "rels": rels}


def window(st: State, seconds: float, ctx) -> Window:
    dev, nb = ctx.device, len(st.batches)
    done = []

    def body(i):
        b = (st.first + i) % nb
        with ctx.span("to_device"):
            sub = to_device(st.batches[b], dev)
        with ctx.span("dispatch"):
            loss = st.step(sub)
        with ctx.span("loss_read"):
            float(loss)
        done.append(b)

    secs, steps = timed_loop(seconds, body)
    flops, kbytes = tally(ctx.cell.counts.train_step,
                          [st.summaries[b] for b in done])
    links = sum(st.summaries[b]["positives"] for b in done)
    return Window(secs, {"links": links}, steps, flops=flops,
                  kernel_bytes=kbytes)


def release(st: State) -> None:
    del st.model, st.opt, st.step


def check(st: State, ctx) -> dict:
    """The program's first steps against the reference's, and the
    sampled batches against the graph they were drawn from."""
    ref = st.ref.train_steps(ctx.config, st.batches[:st.first], ctx.seed,
                             ctx.device)
    faults = sum(st.ref.sample_faults(st.batches[i], st.edges[i],
                                      st.triplets, ctx.config)
                 for i in range(st.first))
    st.last_ref = ref
    return compare.training_readings(st.losses, st.grad1, st.after, ref) \
        | {"sample_faults": float(faults)}


FAULTS = ("unchanged_state", "half_batch")


def control(st: State, ctx) -> dict:
    """The reference with TF32 matmuls in the program's place."""
    args = (ctx.config, st.batches[:st.first], ctx.seed, ctx.device)
    ref = st.ref.train_steps(*args)
    low = st.ref.train_steps(*args, precision="tf32")
    st.last_control = (low, ref)
    return compare.training_readings(low["losses"], low["grad1"],
                                     low["after"], ref)
