"""SCM evaluation: the program's eval step (make_eval_step, float32, as
the command lines make it) over batches already on the card, each
batch's predictions read back to the host.

Set-up: the config, pairs, dataset and model as loops/scm_common; the
pairs collated into batches of eval_batch_size by the program's
batchify and moved to the card; traffic["warmup"] eval steps.

Window: the batches in turn, each the eval step's call and the read of
pred_c and pred_v to the host. Work: the pairs of every completed
batch. For the check, one
answer of each batch is kept, drawn from the seed among that batch's
answers in the window (a reservoir of one).
"""

from __future__ import annotations

import numpy as np

from dualmessagepassing_tpu_torch.train.scm_driver import make_eval_step

from ..core import compare
from ..core.harness import Window, tally, timed_loop
from . import scm_common as common


class State:
    pass


def setup(ctx) -> State:
    st = State()
    cfg = common.train_config(ctx.config)
    st.raw = common.make_raw(cfg, ctx.traffic, ctx.seed)
    dataset = common.make_dataset(st.raw, cfg)
    model = common.make_model(ctx, cfg)
    st.step = make_eval_step(model)
    bsz = cfg["eval_batch_size"]
    n = len(dataset) // bsz
    st.rows = [list(range(i * bsz, (i + 1) * bsz)) for i in range(n)]
    st.batches = []
    for rows in st.rows:
        _, pattern, graph, _, _ = dataset.batchify(rows)
        st.batches.append((pattern.to(ctx.device), graph.to(ctx.device)))
    sizes = common.Sizes(dataset, model)
    st.summaries = [sizes(rows) for rows in st.rows]
    for i in range(ctx.traffic["warmup"]):
        pred_c, pred_v = st.step(*st.batches[i % n])[:2]
        pred_c.cpu(), pred_v.cpu()
    st.kept = [None] * n
    return st


def window(st: State, seconds: float, ctx) -> Window:
    n = len(st.batches)
    pick = np.random.default_rng([ctx.seed % (2 ** 63), 1])
    seen = [0] * n
    done = []

    def body(i):
        b = i % n
        with ctx.span("dispatch"):
            pred_c, pred_v = st.step(*st.batches[b])[:2]
        with ctx.span("predictions_read"):
            answer = (pred_c.cpu(), pred_v.cpu())
        done.append(b)
        seen[b] += 1
        if pick.random() * seen[b] < 1.0:
            st.kept[b] = answer

    secs, steps = timed_loop(seconds, body)
    ctx.note(f"latency samples: {steps} batches")
    flops, kbytes = tally(ctx.cell.counts.eval_step,
                          [st.summaries[b] for b in done])
    pairs = sum(st.summaries[b]["batch"] for b in done)
    return Window(secs, {"pairs": pairs}, steps, flops=flops,
                  kernel_bytes=kbytes)


def release(st: State) -> None:
    del st.step, st.batches


def _gaps(answers, refs) -> dict:
    return {"pred_c_gap": max(compare.answer_gap(a[0], r[0])
                              for a, r in zip(answers, refs)),
            "pred_v_gap": max(compare.answer_gap(a[1], r[1])
                              for a, r in zip(answers, refs))}


def _reference(st: State, ctx, which, precision="float32"):
    return ctx.cell.reference.eval_forward(
        ctx.config, st.raw, [st.rows[b] for b in which], ctx.seed,
        ctx.device, precision)


def check(st: State, ctx) -> dict:
    """Each kept answer against the reference's predictions of its
    batch."""
    which = [b for b, a in enumerate(st.kept) if a is not None]
    ctx.note(f"answers compared: {len(which)} batches of "
             f"{len(st.rows[0])} pairs")
    return _gaps([st.kept[b] for b in which], _reference(st, ctx, which))


FAULTS = ("altered_answer",)


def control(st: State, ctx) -> dict:
    """The reference with TF32 matmuls in the program's place."""
    which = range(len(st.rows))
    return _gaps(_reference(st, ctx, which, "tf32"),
                 _reference(st, ctx, which))
