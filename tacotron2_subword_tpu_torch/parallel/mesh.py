"""Data and model axes for multi-rank training over ``torch.distributed``.

Counterpart of ``tacotron2_subword_tpu/parallel/mesh.py``.  The JAX
package lays a ('data', 'model') device mesh, shards the batch over
'data' and lets XLA insert the gradient psum.  Here one process drives one
device, and the ranks of a process group form the same grid:

 - ``make_mesh`` places this rank at (data, model) in an
   [n_data, n_model] grid of group ranks (the model axis inner, as JAX's
   default device order), and makes one data group per model column and one
   model group per data row.  Without an initialized ``torch.distributed``
   it is the 1x1 mesh, whose collectives are the identity: the train step
   has one code path.
 - The batch is split over 'data': the ranks of one data row take the same
   rows (``shard_batch``, or the loader's ``shard_within_batch``).
 - The model axis splits the storage of the leaves named by the plans
   (``tacotron_param_sharding``, ``hifigan_param_sharding``) and of their
   Adam moments, by rows (or the given dim): each rank keeps its slice.
   The step gathers the full weights first (``gather``), computes the full
   gradient on every rank and keeps its slice for the update; it does not
   split the compute.

Every collective is an ``all_reduce`` SUM (or the barrier's): an
all-gather is the sum of zero-filled buffers that each rank wrote its own
part into, exact in floating point.  So one path runs over NCCL, over gloo
on the CPU and over gloo on CUDA tensors.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tacotron2_subword_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                                    tree_unflatten)

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
TIMEOUT = timedelta(seconds=600)


class Mesh(NamedTuple):
    """This rank's coordinates in the (data, model) grid and the groups its
    collectives run over (None on the 1x1 mesh of one process)."""
    n_data: int = 1
    n_model: int = 1
    data: int = 0
    model: int = 0
    group: Any = None        # every rank of the mesh
    data_group: Any = None   # the ranks that share this rank's model index
    model_group: Any = None  # the ranks that share this rank's data index

    @property
    def is_main(self) -> bool:
        """The rank that writes files and prints: (0, 0)."""
        return self.data == 0 and self.model == 0

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis; differentiable (the backward
        sums the gradient over the same ranks)."""
        if self.data_group is None:
            return t
        return _AllReduceSum.apply(t, self.data_group)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x.  Each rank's loss is its share of the
    global loss, so dL/dx = the sum over the group of dL_r/dy."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def torchrun_env() -> bool:
    """True when a launcher (``torch.distributed.run``) set this process's
    rank environment."""
    return "WORLD_SIZE" in os.environ


def init_from_env(device=None) -> torch.device:
    """Initialize ``torch.distributed`` from the torchrun environment and
    return this rank's device: ``cuda:LOCAL_RANK`` (NCCL, one process per
    card) unless ``device`` is "cpu" (gloo).  A missing variable, a card
    that is absent or a failed initialization raises."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            "multi-rank training needs the torchrun environment (missing "
            + ", ".join(missing) + "): launch with python -m "
            "torch.distributed.run --nproc_per_node=N -m ...")
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "train over gloo on the CPU")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", timeout=TIMEOUT, device_id=dev)
    else:
        dist.init_process_group("gloo", timeout=TIMEOUT)
    return dev


def rank_grid(n_data: int, n_model: int,
              model_across_processes: bool = False) -> np.ndarray:
    """[n_data, n_model] group ranks: JAX's device grid, the model axis
    inner (a data row's ranks adjacent, on one host), or transposed with
    ``model_across_processes``."""
    ranks = np.arange(n_data * n_model)
    if model_across_processes:
        return ranks.reshape(n_model, n_data).T
    return ranks.reshape(n_data, n_model)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, group=None,
              model_across_processes: bool = False) -> Mesh:
    """This rank's Mesh over ``group`` (the world group by default; its
    backend carries the collectives).  ``n_data`` defaults to the group's
    size / ``n_model``.  Every rank of the world calls this, in the same
    order (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise ValueError(f"a {n_data}x{n_model} mesh needs "
                             f"torch.distributed initialized")
        return Mesh()
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if n_data is None:
        n_data = size // n_model
    if n_data * n_model != size:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model}"
                         f" ranks; the group has {size}")
    grid = rank_grid(n_data, n_model, model_across_processes)
    world = dist.get_process_group_ranks(group)
    backend = dist.get_backend(group)
    new = lambda ranks: dist.new_group([world[r] for r in ranks],
                                       backend=backend, timeout=TIMEOUT)
    data_groups = [new(grid[:, m]) for m in range(n_model)]
    model_groups = [new(grid[d, :]) for d in range(n_data)]
    (d,), (m,) = np.nonzero(grid == dist.get_rank(group))
    return Mesh(n_data, n_model, int(d), int(m), group, data_groups[m],
                model_groups[d])


def collective_barrier(mesh: Mesh) -> None:
    """One small all_reduce over every rank of the mesh, then a block on
    its result: it sets up the backend's communicators while the ranks are
    in lockstep, and keeps a rank from reading a file another has not
    finished writing."""
    if mesh.group is None:
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu"))
    x = torch.ones(1, device=dev)
    dist.all_reduce(x, group=mesh.group)
    if int(x.item()) != mesh.n_data * mesh.n_model:
        raise RuntimeError(f"barrier: {x.item()} ranks answered")


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous rows of the global batch (every leading dim
    divisible by n_data)."""
    if mesh.n_data == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.n_data:
            raise ValueError(f"global batch {v.shape[0]} ({k}) not divisible"
                             f" by n_data={mesh.n_data}")
        n = v.shape[0] // mesh.n_data
        out[k] = v[mesh.data * n:(mesh.data + 1) * n]
    return out


# -- plans: per leaf, the dim split over the model axis (None: replicated) ---

LSTM_LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh")


def _check_divides(params, plan, n_model: int) -> None:
    for p, dim in zip(tree_leaves(params), tree_leaves(plan)):
        if dim is not None and p.shape[dim] % n_model:
            raise ValueError(f"a leaf of shape {tuple(p.shape)} cannot be "
                             f"split {n_model} ways on dim {dim}")


def tacotron_param_sharding(params, mesh: Mesh):
    """The params' tree of plans: with a model axis > 1 the two embedding
    tables by vocabulary row and the three decoder LSTMs' w_ih, w_hh,
    b_ih, b_hh by their 4H rows (dim 0); everything else replicated.  A
    leaf that n_model does not divide raises ValueError."""
    plan = tree_map(lambda _: None, params)
    if mesh.n_model == 1:
        return plan
    plan["embedding"] = plan["embedding_sub"] = 0
    for name in ("attention_rnn", "attention_rnn_bert", "decoder_rnn"):
        for k in LSTM_LEAVES:
            plan["decoder"][name][k] = 0
    _check_divides(params, plan, mesh.n_model)
    return plan


def hifigan_param_sharding(params, mesh: Mesh):
    """The generator's tree of plans: with a model axis > 1 each upsampling
    layer's out channels (``v`` / ``w`` [in, out, k] on dim 1, ``b`` on dim
    0); its ``g`` (per in channel) and every other leaf replicated."""
    plan = tree_map(lambda _: None, params)
    if mesh.n_model == 1:
        return plan
    for i, up in enumerate(params["ups"]):
        for k in ("v", "w"):
            if k in up:
                plan["ups"][i][k] = 1
        if "b" in up:
            plan["ups"][i]["b"] = 0
    _check_divides(params, plan, mesh.n_model)
    return plan


def train_state_shardings(state, mesh: Mesh):
    """The TrainState's tree of plans: the params' plan, Adam's ``mu`` and
    ``nu`` the plan of the param at the same path (they mirror the params'
    tree), the step, the BN statistics and Adam's count replicated."""
    pplan = tacotron_param_sharding(state.params, mesh)
    return state._replace(
        step=None, params=pplan,
        bn_state=tree_map(lambda _: None, state.bn_state),
        opt_state=state.opt_state._replace(count=None, mu=pplan, nu=pplan))


# -- slicing and gathering --------------------------------------------------

def _dims(tree, plan) -> list:
    """The plan's leaves; None (every leaf replicated) for no plan."""
    return ([None] * len(tree_leaves(tree)) if plan is None
            else tree_leaves(plan))


def _slice(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    if dim is None:
        return t
    k = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model * k, k).clone()


def shard(tree, plan, mesh: Mesh):
    """This rank's slice of every planned leaf of a full tree."""
    if plan is None or mesh.n_model == 1:
        return tree
    return tree_map(lambda t, dim: _slice(t, dim, mesh), tree, plan)


# each part of a flat all_reduce buffer starts on this many elements (512
# bytes, as a fresh CUDA allocation): a reduction or a GEMM over a view
# then takes the kernel, and the rounding, it takes on its own tensor
ALIGN = 128


def _sum_of_parts(group, shapes: Sequence, writes: Sequence[Callable],
                  like: torch.Tensor) -> List[torch.Tensor]:
    """Zero-filled tensors of ``shapes`` (one flat buffer), each handed to
    its ``writes[i]`` to fill this rank's own part, summed over ``group``
    in one all_reduce."""
    sizes = [math.prod(s) for s in shapes]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // ALIGN) * ALIGN)
    buf = like.new_zeros(offsets[-1])
    views = [buf[o:o + n].view(s) for o, n, s in zip(offsets, sizes, shapes)]
    for v, write in zip(views, writes):
        write(v)
    dist.all_reduce(buf, group=group)
    return views


def _full_shape(t: torch.Tensor, dim: int, n: int):
    s = list(t.shape)
    s[dim] *= n
    return s


def gather(tree, plan, mesh: Mesh):
    """The full tree from each rank's slices: every planned leaf's slices
    gathered over the model group (zeros elsewhere, summed), the other
    leaves as they are."""
    leaves, dims = tree_leaves(tree), _dims(tree, plan)
    idx = [i for i, d in enumerate(dims) if d is not None]
    if mesh.n_model == 1 or not idx:
        return tree

    def write(src, dim):
        k = src.shape[dim]
        return lambda v: v.narrow(dim, mesh.model * k, k).copy_(src)

    full = _sum_of_parts(
        mesh.model_group,
        [_full_shape(leaves[i], dims[i], mesh.n_model) for i in idx],
        [write(leaves[i], dims[i]) for i in idx], leaves[idx[0]])
    out = list(leaves)
    for i, t in zip(idx, full):
        out[i] = t
    return tree_unflatten(tree, out)


def sum_gradients(grads, plan, mesh: Mesh):
    """Full gradients summed over the data axis, bit-identical on every
    rank: one all_reduce over the whole mesh to which each rank gives only
    what it owns (a replicated leaf: the ranks of model index 0; a planned
    leaf: each rank its own slice).  The ranks of one data row compute the
    same gradient, so this is the data-axis sum, and the replicated params
    cannot drift apart across the model axis through the nondeterministic
    order of a kernel's atomics."""
    if mesh.group is None:
        return grads
    leaves, dims = tree_leaves(grads), _dims(grads, plan)

    def write(g, dim):
        if dim is None:
            return (lambda v: v.copy_(g)) if mesh.model == 0 \
                else (lambda v: None)
        k = g.shape[dim] // mesh.n_model
        return lambda v: v.narrow(dim, mesh.model * k, k).copy_(
            g.narrow(dim, mesh.model * k, k))

    summed = _sum_of_parts(mesh.group, [g.shape for g in leaves],
                           [write(g, d) for g, d in zip(leaves, dims)],
                           leaves[0])
    return tree_unflatten(grads, summed)


def sharded_norm(tree, plan, mesh: Mesh) -> torch.Tensor:
    """The global L2 norm of a tree whose planned leaves are this rank's
    slices: their squares summed over the model group once."""
    leaves, dims = tree_leaves(tree), _dims(tree, plan)
    sq = lambda ts: sum(torch.sum(t * t) for t in ts)
    rep = sq([t for t, d in zip(leaves, dims) if d is None])
    split = [t for t, d in zip(leaves, dims) if d is not None]
    if mesh.n_model == 1 or not split:
        return torch.sqrt(rep + sq(split))
    part = sq(split).reshape(1).clone()
    dist.all_reduce(part, group=mesh.model_group)
    return torch.sqrt(rep + part[0])


def shard_train_state(state, mesh: Mesh):
    """The TrainState laid out on the mesh: replicated with one model
    index, else each planned param and its Adam moments sliced (a leaf that
    n_model does not divide raises ValueError)."""
    if mesh.n_model == 1:
        return state
    return shard(state, train_state_shardings(state, mesh), mesh)


def gather_train_state(state, mesh: Mesh, shardings):
    """The full TrainState (for a checkpoint) from each rank's slices;
    ``shardings`` is ``train_state_shardings`` of the full state.  A
    collective over the model group: every rank calls it."""
    if mesh.n_model == 1:
        return state
    return state._replace(
        params=gather(state.params, shardings.params, mesh),
        opt_state=state.opt_state._replace(
            mu=gather(state.opt_state.mu, shardings.opt_state.mu, mesh),
            nu=gather(state.opt_state.nu, shardings.opt_state.nu, mesh)))


def make_parallel_train_step(cfg, tx, mesh: Mesh, state=None):
    """The train step on ``mesh``: the rank's rows of the batch, params
    replicated, or with a model axis > 1 and the full ``state`` given, the
    planned leaves' storage split (``train_lib.train_step`` with the
    plan)."""
    from tacotron2_subword_tpu_torch import train_lib as T
    plan = (tacotron_param_sharding(state.params, mesh)
            if state is not None and mesh.n_model > 1 else None)

    def step(state, batch, **kw):
        return T.train_step(state, batch, cfg, tx, mesh=mesh, plan=plan,
                            **kw)
    return step
