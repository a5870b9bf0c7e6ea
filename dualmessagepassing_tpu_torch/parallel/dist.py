"""Process groups: the port's counterpart of the JAX package's meshes and
psum (dualmessagepassing_tpu/parallel/dp.py:make_dp_mesh,
parallel/ep_unc.py's shard_map over 'ep').

JAX runs one process over N devices. The port runs N processes, one rank
per device, over a torch.distributed process group:

  * launch(fn, size, backend=..., devices=[...], init_file=...) spawns
    the ranks (start method spawn), rendezvous on the file the caller
    names (file://, so concurrent launches never race for a TCP port),
    and calls fn(world, *args) in each; it returns every rank's result.
    The backend and each rank's device are the caller's: NCCL with rank r
    on cuda:r, or gloo on the CPU or on CUDA tensors (two ranks may then
    share a card). Nothing picks either by itself. A rank that fails, or
    a run that outlives its timeout, kills every rank and raises.
  * World is one rank's view: rank, size, device, backend.
  * all_reduce_sum is the sum over the ranks whose backward is again the
    sum over the ranks (the adjoint of a psum). all_reduce_max carries no
    gradient. Both are the identity where no world is given.
  * split_rows(module, world) is the counterpart of a flax module's
    axis_name: inside it every submodule with a row_world attribute
    (MaskedBatchNorm, the predict nets, the UNC layers and losses) holds
    `world`, and completes its batch statistics, lengths and
    aggregations over the ranks that hold the other rows.
    split_rows(module, world, owner=True) is the counterpart of the JAX
    UNC model's node_sharding="owner": the submodules with an
    owner_rows attribute (the UNC layers and losses) also hold True,
    and read their node rows as owned by this rank.
  * halo_exchange and all_gather_rows are the two collectives of that
    owner-sharded mode (jax.lax.all_to_all and jax.lax.all_gather in
    the JAX package), each with its true adjoint as its backward.
    halo_table builds a layer's [owned; halo; dump] sender table with
    one halo_exchange (the UNC models and parallel/halo.py read it).
  * all_reduce_grads sums each parameter's gradient over the ranks.

The convention that makes every gradient exact: each rank computes the
whole, replicated loss L (every cross-rank partial sum goes through
all_reduce_sum), seeds its backward with 1/size, and the gradients are
summed over the ranks before the update. That differentiates
(1/size) * sum over the ranks of L = L over a graph in which every
cross-rank sum has its true adjoint. Every rank then applies the same
update to the same parameters, so they stay equal bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue
import time
import traceback
from typing import (Any, Callable, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class World:
    """One rank of a process group: its rank, the group's size, the
    rank's device and the group's backend. The group is the default one
    (init_world's); the collectives here take the World to name the
    ranks they run over."""

    rank: int
    size: int
    device: torch.device
    backend: str


def _reduce(x: torch.Tensor, world: World, op) -> torch.Tensor:
    """A copy of x, at least float32, reduced over the ranks, cast back to
    x's dtype (a bf16 partial sum is summed in float32 and rounded
    once)."""
    y = x.detach().to(torch.promote_types(x.dtype, torch.float32),
                      copy=True).contiguous()
    dist.all_reduce(y, op=op)
    return y.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return _reduce(x, world, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.world, dist.ReduceOp.SUM), None


def all_reduce_sum(x: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    """The sum of x over the ranks of `world` (x itself without one); its
    backward sums the cotangents over the ranks."""
    if world is None:
        return x
    return _AllReduceSum.apply(x, world)


def all_reduce_max(x: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    """The elementwise max of x over the ranks (x without a world); no
    gradient flows through it."""
    if world is None:
        return x
    return _reduce(x, world, dist.ReduceOp.MAX)


@contextlib.contextmanager
def split_rows(module: nn.Module, world: Optional[World],
               owner: bool = False):
    """Within it, every submodule of `module` that has a row_world
    attribute holds `world`, and with owner=True every submodule that
    has an owner_rows attribute holds True; the attributes are restored
    on exit. A train step wraps its forward and backward in it, so that
    a rematerialised forward sees it too. Without a world (all rows on
    this rank) it does nothing."""
    if world is None:
        yield
        return
    sets = [(m, "row_world", world) for m in module.modules()
            if hasattr(m, "row_world")]
    if owner:
        sets += [(m, "owner_rows", True) for m in module.modules()
                 if hasattr(m, "owner_rows")]
    old = [getattr(m, name) for m, name, _ in sets]
    for m, name, value in sets:
        setattr(m, name, value)
    try:
        yield
    finally:
        for (m, name, _), value in zip(sets, old):
            setattr(m, name, value)


def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Block i of x ([size, ...]) to rank i; block i of the result from
    rank i. all_to_all_single on every backend: gloo runs it on CPU and
    on CUDA tensors, float32 and bfloat16 (and not the list form,
    all_to_all)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out


class _HaloExchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, send, world):
        return _all_to_all(send)

    @staticmethod
    def backward(ctx, g):
        # a permutation of blocks: its adjoint is the same exchange
        return _all_to_all(g), None


def halo_exchange(send: torch.Tensor, world: World) -> torch.Tensor:
    """send [size, B, H] -> recv [size, B, H], recv[o] = rank o's
    send[this rank]: jax.lax.all_to_all(send, axis, split_axis=0,
    concat_axis=0, tiled=False), the owner-sharded mode's exchange of
    boundary rows. Rows travel in send's dtype (bf16 under amp). Its
    backward exchanges the cotangent the same way, its adjoint."""
    if send.shape[0] != world.size:
        raise ValueError(f"halo_exchange: {send.shape[0]} blocks for "
                         f"{world.size} ranks")
    return _HaloExchange.apply(send, world)


def halo_table(node_feat: torch.Tensor, sub: Mapping[str, torch.Tensor],
               world: World) -> torch.Tensor:
    """The owner-sharded sender table [Vp + n * B + 1, H]: this rank's
    owned rows, then the boundary rows the other ranks own (B from each
    owner o at Vp + o * B, fetched with one halo_exchange), then a zero
    dump row for the pad edges (the JAX package's unc/model.py:384-403).
    The send buffer [n, B, H] holds, at the real slots of send_mask,
    the owned rows send_idx names there, and zeros elsewhere: the rows
    are gathered at the real slots only (send_pos, send_rows:
    parallel/halo_unc.attach_halo_csr_plans), so the backward sums into
    each owned row only the slots that send it. (JAX gathers every slot and masks; its
    pad slots all name row 0, and a gather's backward over that many
    duplicates of one row made a rank's PubMed step 87-124 device ms
    instead of 27-28 on an H100, chip_smoke.py phase 19.)"""
    n, b = sub["send_idx"].shape
    h = node_feat.shape[-1]
    rows = node_feat.index_select(0, sub["send_rows"])
    send = node_feat.new_zeros(n * b, h).index_copy(0, sub["send_pos"], rows)
    recv = halo_exchange(send.view(n, b, h), world)
    return torch.cat([node_feat, recv.reshape(n * b, h),
                      node_feat.new_zeros(1, h)])


class _AllGatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        x = x.contiguous()
        out = x.new_empty((world.size * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x)
        return out

    @staticmethod
    def backward(ctx, g):
        # rank r's rows reach every rank's table: their cotangent is the
        # sum over the ranks of the cotangent of slice r
        g32 = g.to(torch.promote_types(g.dtype, torch.float32)).contiguous()
        out = g32.new_empty((g.shape[0] // ctx.world.size,) + g.shape[1:])
        dist.reduce_scatter_tensor(out, g32)
        return out.to(g.dtype), None


def all_gather_rows(x: torch.Tensor, world: World) -> torch.Tensor:
    """x [N, ...] on each rank -> [size * N, ...], rank r's rows at
    r * N: jax.lax.all_gather(x, axis, axis=0, tiled=True). Its backward
    is its adjoint, a reduce-scatter: this rank's slice of the cotangent
    summed over the ranks, in float32. gloo runs both collectives on CPU
    and on CUDA tensors."""
    return _AllGatherRows.apply(x, world)


def all_reduce_grads(params: Iterable[torch.Tensor], world: World) -> None:
    """Sum every parameter's gradient over the ranks, in one all-reduce
    of one float32 buffer. A parameter without a gradient gets zeros
    first (the optimizers update every parameter)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def broadcast_object(world: World, obj: Any = None, src: int = 0) -> Any:
    """Rank `src`'s `obj` (anything picklable) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def same_on_all_ranks(value: int, world: World) -> bool:
    """Whether every rank passed the same integer (a checksum)."""
    t = torch.tensor([value, -value], dtype=torch.int64, device=world.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t[0]) == value and int(t[1]) == -value


# -----------------------------------------------------------------------------
# the launcher
# -----------------------------------------------------------------------------

def launch_plan(n: int, device,
                backend: Optional[str] = None) -> Tuple[str, List[str]]:
    """The command lines' (backend, one device per rank) for n ranks of a
    run on `device`: gloo with every rank on the CPU for a CPU device,
    else NCCL with rank r on cuda:r; more ranks than visible CUDA devices
    are refused (the JAX CLI's rule, cli/scm_train.py:211-214).
    backend="gloo" on a CUDA device puts rank r on cuda:(r mod the
    visible count), so ranks may share a card (NCCL refuses that)."""
    if torch.device(device).type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend} on the CPU: use gloo")
        return "gloo", ["cpu"] * n
    n_avail = torch.cuda.device_count()
    if backend == "gloo" and n_avail:
        return "gloo", [f"cuda:{r % n_avail}" for r in range(n)]
    if n > n_avail:
        raise ValueError(f"{n} ranks but only {n_avail} CUDA devices are "
                         "visible")
    return "nccl", [f"cuda:{r}" for r in range(n)]


def init_world(rank: int, size: int, backend: str, device,
               init_file: str, timeout: float = 300.0) -> World:
    """Join the default process group as `rank` of `size` over `backend`,
    rendezvous on the file `init_file`; collectives that wait longer than
    `timeout` seconds raise."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method="file://" + os.path.abspath(init_file),
        rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    return World(rank, size, device, backend)


def rank_threads(devices: Sequence[str]) -> Optional[int]:
    """Each rank's torch threads where the ranks share the host's CPU
    cores (a CPU run): this process's count over the number of CPU
    ranks, at least 1; None (torch's default) where no rank is on the
    CPU."""
    n_cpu = sum(torch.device(d).type == "cpu" for d in devices)
    return max(1, torch.get_num_threads() // n_cpu) if n_cpu else None


def _rank_main(rank: int, fn: Callable, size: int, backend: str,
               devices: Sequence[str], init_file: str, args: tuple,
               threads: Optional[int], timeout: float, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        world = init_world(rank, size, backend, devices[rank], init_file,
                           timeout)
        try:
            out = fn(world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def _failures(results, size: int, backend: str, failed: dict,
              wait: float = 2.0) -> str:
    """The tracebacks of the ranks that failed: the first one's and those
    that arrive within `wait` seconds (a rank that fails takes the
    others' collectives down with it)."""
    end = time.monotonic() + wait
    while time.monotonic() < end:
        try:
            rank, ok, value = results.get(timeout=0.1)
        except queue.Empty:
            continue
        if not ok:
            failed[rank] = value
    return "\n".join(f"rank {r} of {size} over {backend} failed:\n{tb}"
                     for r, tb in sorted(failed.items()))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


# the collective timeout of the command lines' ranks: there rank 0
# evaluates, exports or writes a checkpoint while the others wait in a
# collective, for as long as a real dataset takes
CLI_COLLECTIVE_TIMEOUT = 7 * 24 * 3600.0


def launch(fn: Callable, size: int, *, backend: str, devices: Sequence[str],
           init_file: str, args: tuple = (),
           timeout: Optional[float] = 600.0,
           collective_timeout: float = 1800.0,
           threads: Optional[int] = None) -> List[Any]:
    """Run fn(world, *args) in `size` spawned processes, rank r on
    devices[r], over `backend` ("gloo" or "nccl"), with the rendezvous
    file `init_file` (it must not exist; it is removed afterwards). fn
    must be importable by name, and its arguments and result picklable;
    a result holds numpy arrays, not tensors (a tensor would come back
    through shared memory that the rank's exit releases).
    threads, if given, is each rank's torch.set_num_threads. -> each
    rank's result, by rank. When a rank raises, or the ranks have not all
    returned after `timeout` seconds (None: no limit), every rank is
    killed and a RuntimeError (TimeoutError) says which. A collective
    that waits `collective_timeout` seconds for another rank raises in
    its rank."""
    if len(devices) != size:
        raise ValueError(f"{size} ranks need {size} devices, got {devices}")
    if os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists already")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, fn, size, backend, [str(d) for d in devices], init_file,
              args, threads, collective_timeout, results), daemon=True)
        for r in range(size)]
    for p in procs:
        p.start()
    out = {}
    deadline = float("inf") if timeout is None else time.monotonic() + timeout
    try:
        while len(out) < size:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"rank(s) {dead} of {size} exited without a result "
                        f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{size} ranks over {backend}: no result from rank(s) "
                        f"{sorted(set(range(size)) - set(out))} after "
                        f"{timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(_failures(results, size, backend,
                                             {rank: value}))
            out[rank] = value
        for p in procs:
            p.join(min(max(deadline - time.monotonic(), 1.0), 60.0))
    finally:
        _stop(procs)
        if os.path.exists(init_file):
            os.remove(init_file)
    return [out[r] for r in range(size)]
