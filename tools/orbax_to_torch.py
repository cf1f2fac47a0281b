#!/usr/bin/env python
"""Convert checkpoints of the JAX package (Orbax directories) to the
PyTorch port's formats.  It reads with JAX and orbax and writes with the
port, so it lives outside both packages.

    # acoustic: checkpoint_{step} dirs of tacotron2_subword_tpu.apps.train
    python tools/orbax_to_torch.py --checkpoint run/checkpoint_4000 \
        --out-dir port_run [--hparams "[k:v-k:v]"]
    python tools/orbax_to_torch.py --sweep-dir run --out-dir port_run \
        [--hparams ...]
    # HiFi-GAN: a g_NNNNNNNN dir of tacotron2_subword_tpu.apps.train_hifigan
    python tools/orbax_to_torch.py --generator run/g_00040000 \
        --out port/g_00040000 [--config config_v1.json]

Acoustic checkpoints are restored by the JAX package's
``utils/checkpoint.load_checkpoint`` against the tree of
``train_lib.create_train_state`` under ``--hparams`` (the hparams the run
was trained with), moved through numpy by the port's
``utils/import_jax.tacotron2_params_from_numpy`` and
``adam_state_from_numpy`` (every leaf's shape checked), and written by the
port's ``utils/checkpoint.save_checkpoint`` under the same directory name
in ``--out-dir``: ``state.pt`` and a ``meta.json`` with the step,
val_loss and learning rate of the input's.  ``--sweep-dir`` converts every
``checkpoint_*`` directory of a run (``checkpoint_best`` too).  The port's
training CLI resumes from the result, and its inference, sweep and
``tools/eval_synthetic`` read it.

A generator directory is restored against ``init_generator``'s tree under
``--config`` (HiFi-GAN v1 without one) and written as the reference's
``{'generator': state_dict}`` torch file (``models/hifigan.
export_torch_generator``), which ``--hifigan-checkpoint`` of the port's
CLIs reads.

Only new files are written: an existing output raises, and the input is
never touched.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import os
import re
import sys

import numpy as np

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _fresh(path: str) -> str:
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"{path} exists; the converter writes only "
                              f"new files")
    return path


def _zeros_like_init(init_fn):
    """The tree ``init_fn(PRNGKey(0))`` returns, as numpy zeros of its
    shapes and dtypes: traced, never compiled or run."""
    import jax
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@functools.lru_cache(maxsize=None)
def _skeleton(hparams):
    """(JAX config, the train state tree Orbax restores into), once per
    hparams."""
    from tacotron2_subword_tpu import train_lib as JT
    from tacotron2_subword_tpu.config import create_config as jax_config
    jcfg = jax_config(hparams_string=hparams)
    return jcfg, _zeros_like_init(
        lambda key: JT.create_train_state(key, jcfg)[0])


def convert_acoustic(src: str, out_dir: str, hparams: str = None) -> str:
    """One JAX ``checkpoint_*`` directory -> the port's directory of the
    same name under ``out_dir``; returns its path."""
    from tacotron2_subword_tpu.utils import checkpoint as JCK
    from tacotron2_subword_tpu_torch import train_lib as TT
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    from tacotron2_subword_tpu_torch.utils import checkpoint as TCK
    from tacotron2_subword_tpu_torch.utils.import_jax import (
        adam_state_from_numpy, tacotron2_params_from_numpy)

    src = os.path.abspath(src.rstrip(os.sep))
    name = os.path.basename(src)
    dst = _fresh(os.path.join(out_dir, name))
    jcfg, skeleton = _skeleton(hparams)
    state, meta = JCK.load_checkpoint(src, skeleton)
    cfg = TacotronConfig(**dataclasses.asdict(jcfg))
    params, bn = tacotron2_params_from_numpy(
        _np(state.params), _np(state.bn_state), cfg, device="cpu")
    # the optimizer chain: weight decay, clip, Adam, scale (train_lib's
    # make_optimizer); only Adam holds state
    adam = state.opt_state[2]
    opt = adam_state_from_numpy(np.asarray(adam.count), _np(adam.mu),
                                _np(adam.nu), params, device="cpu")
    TCK.save_checkpoint(
        TT.TrainState(int(state.step), params, bn, opt), out_dir,
        val_loss=meta.get("val_loss", float("inf")),
        learning_rate=meta.get("learning_rate", 0.0), name=name)
    return dst


def convert_generator(src: str, out: str, config: str = None) -> str:
    """One JAX ``g_NNNNNNNN`` directory -> a ``{'generator': state_dict}``
    torch file at ``out``; returns its path."""
    import orbax.checkpoint as ocp
    import torch
    from tacotron2_subword_tpu.models import hifigan as JHG
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.utils.import_jax import \
        hifigan_params_from_numpy

    out = _fresh(out)
    jh = JHG.HifiganConfig.from_json(config) if config else JHG.HifiganConfig()
    h = HG.HifiganConfig.from_json(config) if config else HG.HifiganConfig()
    template = _zeros_like_init(lambda key: JHG.init_generator(key, jh))
    tree = ocp.PyTreeCheckpointer().restore(
        os.path.abspath(src.rstrip(os.sep)), item=template)
    params = hifigan_params_from_numpy(_np(tree), h, device="cpu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save({"generator": HG.export_torch_generator(params)}, out)
    return out


def sweep_dirs(run_dir: str):
    """Every ``checkpoint_*`` directory of a run: by step, then the rest
    (``checkpoint_best``) by name."""
    found = [p for p in glob.glob(os.path.join(run_dir, "checkpoint_*"))
             if os.path.isdir(p)]
    key = lambda p: ((0, int(m.group(1)), "")
                     if (m := re.search(r"_(\d+)$", p))
                     else (1, 0, os.path.basename(p)))
    return sorted(found, key=key)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="one JAX checkpoint_* directory")
    src.add_argument("--sweep-dir", help="a JAX run directory: convert "
                                         "every checkpoint_* in it")
    src.add_argument("--generator", help="a JAX g_NNNNNNNN directory")
    ap.add_argument("--out-dir", help="the port's run directory (acoustic)")
    ap.add_argument("--out", help="the torch file to write (--generator)")
    ap.add_argument("--hparams", default=None,
                    help="the hparams the acoustic run was trained with")
    ap.add_argument("--config", default=None,
                    help="the HiFi-GAN JSON config (v1 without one)")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.generator:
        if not args.out:
            ap.error("--generator needs --out")
        written = [convert_generator(args.generator, args.out, args.config)]
    else:
        if not args.out_dir:
            ap.error("--checkpoint / --sweep-dir need --out-dir")
        srcs = ([args.checkpoint] if args.checkpoint
                else sweep_dirs(args.sweep_dir))
        if not srcs:
            ap.error(f"no checkpoint_* directory in {args.sweep_dir}")
        written = [convert_acoustic(s, args.out_dir, args.hparams)
                   for s in srcs]
    for path in written:
        print("wrote", path)
    return written


if __name__ == "__main__":
    main()
