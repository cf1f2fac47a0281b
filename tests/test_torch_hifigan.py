"""Port of the HiFi-GAN generator against ``HG.generator_apply`` on the same
weights, at a tiny config in f32.  Tolerance 1e-5 relative to the output's
scale: the same convolutions summed in another order."""

import numpy as np
import pytest
import torch

import jax

from tacotron2_subword_tpu.models import hifigan as HG
from tacotron2_subword_tpu_torch.models import hifigan as THG
from tacotron2_subword_tpu_torch.utils.import_jax import \
    hifigan_params_from_numpy


def _configs(resblock):
    kw = dict(resblock=resblock, upsample_rates=(4, 2),
              upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
              resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 3), (1, 2)), num_mels=6)
    return HG.HifiganConfig(**kw), THG.HifiganConfig(**kw)


@pytest.mark.parametrize("resblock", ["1", "2"])
@pytest.mark.parametrize("fused", [True, False])
def test_generator_matches_jax(resblock, fused):
    jh, th = _configs(resblock)
    params = HG.init_generator(jax.random.PRNGKey(0), jh)
    # break the init's g = ||v|| so weight norm is exercised
    params["conv_pre"]["g"] = params["conv_pre"]["g"] * 3.0
    if fused:
        params = HG.fuse_generator(params)
    mel = np.random.RandomState(0).randn(2, 6, 11).astype(np.float32)
    j = np.asarray(HG.generator_apply(params, jh, mel))
    tp = hifigan_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   th, device="cpu")
    if fused:
        tp = THG.fuse_generator(tp)  # fusing a fused tree changes nothing
    t = THG.generator_apply(tp, th, torch.from_numpy(mel))
    assert t.shape == (2, 1, 11 * th.total_upsample)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * max(np.abs(j).max(), 1e-3))


def test_fuse_generator_matches_jax():
    jh, th = _configs("1")
    params = HG.init_generator(jax.random.PRNGKey(1), jh)
    jf = HG.fuse_generator(params)
    tf = THG.fuse_generator(hifigan_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), th, device="cpu"))
    jl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jf))
    tl = jax.tree_util.tree_leaves(tf)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-7)


def test_init_matches_jax_structure():
    jh, th = _configs("1")
    jp = HG.init_generator(jax.random.PRNGKey(0), jh)
    tp = THG.init_generator(torch.Generator().manual_seed(0), th,
                            device="cpu")
    jl, jdef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray,
                                                                 jp))
    tl, tdef = jax.tree_util.tree_flatten(tp)
    assert jdef == tdef
    assert [a.shape for a in jl] == [tuple(a.shape) for a in tl]
