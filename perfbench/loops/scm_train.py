"""SCM training as the published command runs an epoch: the program's
train_epoch over its BucketSampler, collate and host-to-device copies
inside, one forward of the whole batch per update.

Set-up: the config from the published flags (loops/scm_common); the
dataset of traffic["pairs"] pairs; the model with the benchmark's
weights; make_optimizer and the schedule train.py derives
(derive_schedule_config); make_train_step as cli/scm_train.py makes it,
with a dropout generator seeded from the seed. Then epoch 0 runs
through train_epoch over the sampler's first traffic["check_steps"]
batches: their losses, the first gradient (the optimizer's first moment
after one step) and the parameters after them are what the check
compares; they also warm up every shape (every batch has the envelope's
shape).

Window: train_epoch over whole epochs (epoch 1, 2, ...) until the first
epoch end past the window's seconds. Work: the pairs of every batch of
those epochs.
"""

from __future__ import annotations

from dualmessagepassing_tpu_torch.train.samplers import BucketSampler
from dualmessagepassing_tpu_torch.train.schedules import \
    derive_schedule_config
from dualmessagepassing_tpu_torch.train.scm_driver import (make_optimizer,
                                                           make_train_step,
                                                           train_epoch)

from ..core import compare
from ..core.harness import Window, tally, timed_loop
from . import scm_common as common


class State:
    pass


class SpanStep:
    """The train step as train_epoch calls it, inside a "dispatch" span,
    with the attributes train_epoch reads; `watch` sees every call."""

    def __init__(self, step, ctx):
        self.step, self.ctx = step, ctx
        self.model, self.optimizer = step.model, step.optimizer
        self.world, self.chunks = step.world, step.chunks
        self.watch = None

    def __call__(self, *args, **kwargs):
        with self.ctx.span("dispatch"):
            out = self.step(*args, **kwargs)
        if self.watch is not None:
            self.watch(out)
        return out


class FirstBatches:
    """The first n batches of a sampler's epoch, with its full length (the
    scalar schedules' clock)."""

    def __init__(self, sampler, n: int):
        self.batches = list(sampler)[:n]
        self.full_len = sampler.full_len

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def setup(ctx) -> State:
    st = State()
    cfg = common.train_config(ctx.config)
    st.raw = common.make_raw(cfg, ctx.traffic, ctx.seed)
    dataset = common.make_dataset(st.raw, cfg)
    cfg.update(derive_schedule_config(len(dataset), cfg))
    model = common.make_model(ctx, cfg)
    tx = make_optimizer(model.parameters(), cfg["lr"], cfg["weight_decay"],
                        cfg["max_grad_norm"])
    step = make_train_step(
        model, tx, cfg["bp_loss"], cfg["match_weights"],
        eval_metric=cfg["eval_metric"], amp=cfg.get("amp", False),
        accum_chunks=cfg.get("train_microbatch_chunks", 0) or None,
        generator=common.torch_generator(ctx.device, ctx.seed))
    st.step = SpanStep(step, ctx)
    st.data = common.SpanData(dataset, ctx)
    st.sampler = BucketSampler(dataset.sizes(), ["g_len", "p_len"],
                               cfg["train_batch_size"], shuffle=True,
                               seed=ctx.seed)
    st.cfg = cfg

    names = [n for n, _ in model.named_parameters()]
    losses = []

    def watch(out):
        losses.append(out["total"])
        if len(losses) == 1:
            st.grad1 = {n: (s["mu"] / (1.0 - tx.b1)).detach().cpu()
                        for n, s in zip(names, tx.state)}

    st.sampler.set_epoch(0)
    first = FirstBatches(st.sampler, ctx.traffic["check_steps"])
    st.rows = [list(b) for b in first]
    st.step.watch = watch
    train_epoch(st.step, st.data, first, cfg, 0)
    st.step.watch = None
    st.losses = [float(x) for x in losses]
    st.after = {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}
    st.sizes = common.Sizes(dataset, model)
    st.epoch = 0
    return st


def window(st: State, seconds: float, ctx) -> Window:
    st.data.seen = []

    def body(i):
        st.epoch += 1
        st.sampler.set_epoch(st.epoch)
        with ctx.span("epoch"):
            train_epoch(st.step, st.data, st.sampler, st.cfg, st.epoch)

    secs, _ = timed_loop(seconds, body)
    flops, kbytes = tally(ctx.cell.counts.train_step,
                          [st.sizes(rows) for rows in st.data.seen])
    pairs = sum(len(rows) for rows in st.data.seen)
    return Window(secs, {"pairs": pairs}, len(st.data.seen), flops=flops,
                  kernel_bytes=kbytes)


def release(st: State) -> None:
    del st.step, st.data


def check(st: State, ctx) -> dict:
    ref = ctx.cell.reference.train_steps(ctx.config, st.raw, st.rows,
                                         ctx.seed, ctx.device)
    st.last_ref = ref
    return compare.training_readings(st.losses, st.grad1, st.after, ref)


FAULTS = ("unchanged_state", "half_batch")


def control(st: State, ctx) -> dict:
    """The reference with TF32 matmuls in the program's place."""
    ref_fn = ctx.cell.reference.train_steps
    args = (ctx.config, st.raw, st.rows, ctx.seed, ctx.device)
    ref, low = ref_fn(*args), ref_fn(*args, precision="tf32")
    st.last_control = (low, ref)
    return compare.training_readings(low["losses"], low["grad1"],
                                     low["after"], ref)
