"""HiFi-GAN's channels-last serving path (``_generator_apply_channels_last``,
taken by ``generator_apply`` for a CUDA mel with autograd off) against the
generator's own path, on the CPU, where ``ops.conv_epilogue`` runs its plain
version.  The convolutions alone differ between the two paths (channels-last
against NCL kernels), so with NCL convolutions swapped into the channels-last
path the two are bit-equal, and with its own ones they stay within 1e-6 of
the output's scale."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.models import hifigan as THG
from tacotron2_subword_tpu_torch.ops import conv_epilogue as EP
from tests.torch_threads import one_torch_thread  # noqa: F401

# (resblock, kernel sizes, dilations): nk = 2, 3 and 1 resblocks a stage
SHAPES = {
    "rb1-nk2": ("1", (3, 5), ((1, 3), (1, 2))),
    "rb1-nk3": ("1", (3, 7, 11), ((1, 3, 5),) * 3),
    "rb1-nk1": ("1", (3,), ((1,),)),
    "rb2-nk2": ("2", (3, 7), ((1, 3), (1, 3))),
    "rb2-nk3": ("2", (3, 5, 7), ((1, 2), (2, 6), (3, 12))),
    "rb2-nk1": ("2", (5,), ((1, 2),)),
}


def _setup(name, seed=0):
    """A tiny generator at weights large enough that tanh is not saturated
    or flat, non-zero biases in every conv, and a [3, 6, 11] mel."""
    resblock, kernels, dils = SHAPES[name]
    h = THG.HifiganConfig(resblock=resblock, upsample_rates=(4, 2),
                          upsample_kernel_sizes=(8, 4),
                          upsample_initial_channel=16,
                          resblock_kernel_sizes=kernels,
                          resblock_dilation_sizes=dils, num_mels=6)
    gen = torch.Generator().manual_seed(seed)
    params = THG.init_generator(gen, h, device="cpu")
    for p in [params["conv_pre"], *params["ups"], params["conv_post"]]:
        p["g"] = p["g"] * 3.0
    convs = [params["conv_pre"], *params["ups"], params["conv_post"],
             *(c for rb in params["resblocks"] for cs in rb.values()
               for c in cs)]
    for p in convs:
        p["b"] = 0.1 * torch.randn(p["b"].shape, generator=gen)
    mel = torch.from_numpy(
        np.random.RandomState(seed).randn(3, 6, 11).astype(np.float32))
    return h, params, mel


def _conv_ncl(p, x, dilation=1, padding=None):
    """The generator path's convolution (F.conv1d on [B, C, T]), without
    its bias, handed back channels-last."""
    w = p["w"]
    if padding is None:
        padding = THG.get_padding(w.shape[-1], dilation)
    y = F.conv1d(x[:, :, 0, :].contiguous(), w, None, padding=padding,
                 dilation=dilation)
    return y.unsqueeze(2).contiguous(memory_format=torch.channels_last)


def _convt_ncl(p, x, stride, padding):
    y = F.conv_transpose1d(x[:, :, 0, :].contiguous(), p["w"], None,
                           stride=stride, padding=padding)
    return y.unsqueeze(2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("fused", [True, False])
def test_channels_last_path_matches_generator_apply(name, fused):
    """Under inference_mode, as served: within 1e-6 of the output's scale
    (the CPU's channels-last convolutions sum in another order)."""
    h, params, mel = _setup(name)
    if fused:
        params = THG.fuse_generator(params)
    with torch.inference_mode():
        ref = THG.generator_apply(params, h, mel)
        got = THG._generator_apply_channels_last(params, h, mel)
    assert got.shape == ref.shape == (3, 1, 11 * h.total_upsample)
    assert got.is_contiguous()
    scale = ref.abs().max().item()
    assert 1e-3 < scale < 0.9      # neither flat nor saturated
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("name", list(SHAPES))
def test_channels_last_path_bit_equal_with_the_same_convolutions(
        name, monkeypatch):
    """With the generator path's NCL convolutions swapped in, every other
    operation (bias, residual, MRF sum and average, activations) is the
    same f32 operation in the same order: bit-equal."""
    h, params, mel = _setup(name, seed=1)
    with torch.no_grad():
        ref = THG.generator_apply(params, h, mel)
        monkeypatch.setattr(THG, "_conv_cl", _conv_ncl)
        monkeypatch.setattr(THG, "_convt_cl", _convt_ncl)
        got = THG._generator_apply_channels_last(params, h, mel)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name", ["rb1-nk3", "rb2-nk2"])
def test_one_epilogue_per_convolution(name, monkeypatch):
    """Each convolution is followed by exactly one epilogue pass, through
    the plain version on the CPU, and K4 is not launched."""
    h, params, mel = _setup(name)
    calls = []
    plain = EP.conv_epilogue_plain

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)
    monkeypatch.setattr(EP, "conv_epilogue_plain", spy)
    before = EP.launches
    with torch.inference_mode():
        THG._generator_apply_channels_last(params, h, mel)
    per_pair = 2 if h.resblock == "1" else 1
    resblock_convs = sum(per_pair * len(d) for d in h.resblock_dilation_sizes)
    stages = len(h.upsample_rates)
    assert len(calls) == 2 + stages * (1 + resblock_convs)
    assert EP.launches == before
    # the stage averages divide by nk once a stage, conv_post ends in tanh
    assert sum(1 for c in calls if c["mrf_div"]) == stages
    assert calls[-1]["act"] == "tanh"


class _Taken(Exception):
    pass


def test_cpu_and_grad_enabled_calls_take_the_generator_path(monkeypatch):
    """The channels-last path is chosen by the device and the grad mode
    alone: a CUDA mel with autograd off takes it, whatever cuDNN's TF32
    switch reads; a CPU mel in any mode and a CUDA mel with autograd on
    take the generator's own path."""
    def channels_last(*args):
        raise _Taken("channels_last")

    def conv(*args, **kwargs):
        raise _Taken("generator")
    monkeypatch.setattr(THG, "_generator_apply_channels_last", channels_last)
    monkeypatch.setattr(THG, "_conv", conv)
    h, params, mel = _setup("rb1-nk2")
    fake_cuda = types.SimpleNamespace(is_cuda=True)

    def taken(m, mode):
        with mode():
            try:
                THG.generator_apply(params, h, m)
            except _Taken as e:
                return str(e)
        raise AssertionError("neither path ran")
    for mode in (torch.inference_mode, torch.no_grad, torch.enable_grad):
        assert taken(mel, mode) == "generator"
    assert taken(fake_cuda, torch.enable_grad) == "generator"
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for allow in (True, False):
            torch.backends.cudnn.allow_tf32 = allow
            assert taken(fake_cuda, torch.no_grad) == "channels_last"
            assert taken(fake_cuda, torch.inference_mode) == "channels_last"
            assert taken(fake_cuda, torch.enable_grad) == "generator"
            assert taken(mel, torch.inference_mode) == "generator"
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
