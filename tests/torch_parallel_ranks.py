"""The ranks of ``tests/test_torch_parallel.py``: one process per rank of a
gloo group on the CPU, started by ``spawn`` (this module imports no JAX, so
a rank starts quickly).

``run(rank, world, store, inputs, out)`` waits for the inputs the test
writes (``torch.save``; the ranks start while the test makes them), runs
every case on this rank, then one of the single-process references (each
rank another), and writes what it found to ``out/rank{rank}.pt``.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from tacotron2_subword_tpu_torch import train_lib as T
from tacotron2_subword_tpu_torch.apps import train_hifigan as TTH
from tacotron2_subword_tpu_torch.apps import train_waveglow as TTW
from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.models import waveglow as WG
from tacotron2_subword_tpu_torch.parallel import mesh as PM
from tacotron2_subword_tpu_torch.utils import checkpoint as CK
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves

TACOTRON_MESHES = ((4, 1), (2, 2))
WAIT_S = 240


def _rows(mesh, t, B):
    n = B // mesh.n_data
    return t[mesh.data * n:(mesh.data + 1) * n]


def tacotron_case(inp, mesh, out_dir):
    """One train step (and its gradients) and one eval step on ``mesh``,
    from the full state; a checkpoint of the new state written by rank
    (0, 0) and loaded back by every rank."""
    cfg = TacotronConfig(**inp["cfg"])
    state, batch = inp["state"], inp["batch"]
    B = batch["text"].shape[0]
    n = B // mesh.n_data
    rows = lambda r: TM.randomness_rows(r, mesh.data * n,
                                        (mesh.data + 1) * n)
    shardings = PM.train_state_shardings(state, mesh)
    plan = shardings.params
    sharded = PM.shard_train_state(state, mesh)
    local = PM.shard_batch(batch, mesh)
    tx = T.make_optimizer(cfg)
    losses, grads, bn = T.loss_and_grads(
        sharded, local, cfg, mesh=mesh, plan=plan,
        randomness=rows(inp["rnd_train"]))
    new, metrics = PM.make_parallel_train_step(cfg, tx, mesh, state)(
        sharded, local, randomness=rows(inp["rnd_train"]))
    full = PM.gather_train_state(new, mesh, shardings)
    eval_losses, outputs = T.eval_step(sharded, local, cfg, mesh=mesh,
                                       plan=plan,
                                       randomness=rows(inp["rnd_eval"]))
    ck = CK.save_checkpoint(full, out_dir, name=f"ck_{mesh.n_data}"
                            f"x{mesh.n_model}", mesh=mesh)
    loaded, _ = CK.load_checkpoint(ck, "cpu")
    reloaded = PM.shard_train_state(loaded, mesh)
    # the single-process checkpoint the test wrote, sharded on this mesh
    single, _ = CK.load_checkpoint(inp["single_checkpoint"], "cpu")
    single = PM.shard_train_state(single, mesh)
    same = lambda a, b: all(
        torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for x, y in zip(tree_leaves(a), tree_leaves(b)))
    return {"losses": losses, "metrics": metrics, "grads": grads,
            "bn": bn, "full": full, "eval_losses": eval_losses,
            "outputs": outputs,
            "stored_shapes": {k: tuple(new.params[k].shape)
                              for k in ("embedding", "embedding_sub")},
            "mu_shape": tuple(new.opt_state.mu["decoder"]["decoder_rnn"]
                              ["w_ih"].shape),
            "reload_equal": same(reloaded, new),
            "single_shard_equal": same(single, sharded)}


def vocoder_cases(inp, mesh):
    """At (4, 1): one GAN step and one WaveGlow step on this rank's rows;
    at (2, 2): the generator's forward from its model-axis slices."""
    out = {}
    if mesh.n_model == 1:
        h = HG.HifiganConfig(**inp["hifigan_h"])
        g = inp["gan"]
        tx_g, tx_d = TTH.make_optimizer(2e-4), TTH.make_optimizer(2e-4)
        B = g["mel"].shape[0]
        state, m = TTH.gan_step(g["state"], _rows(mesh, g["mel"], B),
                                _rows(mesh, g["audio"], B), h, tx_g, tx_d,
                                mesh=mesh)
        out["gan"] = {"state": state, "metrics": m}
        w = inp["waveglow"]
        wc = WG.WaveGlowConfig(**w["cfg"])
        audio = _rows(mesh, w["audio"], w["audio"].shape[0])
        nll, grads = TTW.loss_and_grads(w["params"], audio, wc, mesh=mesh)
        tx = TTW.make_optimizer(1e-4)
        params, opt, nll2 = TTW.train_step(w["params"],
                                           tx.init(w["params"]), audio, wc,
                                           tx, mesh=mesh)
        out["waveglow"] = {"nll": nll, "grads": grads, "params": params,
                           "nll_step": nll2}
    else:
        h = HG.HifiganConfig(**inp["hifigan_h"])
        params = inp["gan"]["state"].gen
        plan = PM.hifigan_param_sharding(params, mesh)
        sliced = PM.shard(params, plan, mesh)
        out["generator"] = {
            "ups0_v_shape": tuple(sliced["ups"][0]["v"].shape),
            "wav": HG.generator_apply(PM.gather(sliced, plan, mesh), h,
                                      inp["gan"]["mel"][:2])}
    return out


def reference(inp, rank: int):
    """One single-process reference on the global batch, no mesh: rank 0
    the GAN step, 1 WaveGlow's NLL and gradients, 2 the Tacotron 2 loss and
    gradients, 3 the generator's forward."""
    h, g, w = HG.HifiganConfig(**inp["hifigan_h"]), inp["gan"], \
        inp["waveglow"]
    if rank == 0:
        tx = TTH.make_optimizer(2e-4)
        return TTH.gan_step(g["state"], g["mel"], g["audio"], h, tx, tx)
    if rank == 1:
        return TTW.loss_and_grads(w["params"], w["audio"],
                                  WG.WaveGlowConfig(**w["cfg"]))
    if rank == 2:
        return T.loss_and_grads(inp["state"], inp["batch"],
                                TacotronConfig(**inp["cfg"]),
                                randomness=inp["rnd_train"])
    return HG.generator_apply(g["state"].gen, h, g["mel"][:2])


def run(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=240))
    try:
        deadline = time.monotonic() + WAIT_S
        while not os.path.exists(inputs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {inputs} after {WAIT_S} s")
            time.sleep(0.1)
        inp = torch.load(inputs, weights_only=False)
        result = {}
        for shape in TACOTRON_MESHES:
            mesh = PM.make_mesh(*shape)
            result[shape] = {
                "coords": (mesh.data, mesh.model),
                **tacotron_case(inp, mesh, out),
                **vocoder_cases(inp, mesh)}
        result["reference"] = reference(inp, rank)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
        PM.collective_barrier(PM.make_mesh())
    finally:
        dist.destroy_process_group()
