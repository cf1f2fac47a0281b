"""The FLOP and byte counts against values worked by hand."""

from __future__ import annotations

import pytest

from t2s_bench import flops, layout

HIFIGAN = layout.vocoder("hifigan")

T = dict(n_mel_channels=2, n_frames_per_step=1, prenet_dim=3,
         encoder_embedding_dim=4, attention_rnn_dim=5, decoder_rnn_dim=6,
         attention_dim=2, attention="StepwiseMonotonicAttention",
         attention_location_n_filters=1, attention_location_kernel_size=3,
         encoder_kernel_size=3, encoder_n_convolutions=2,
         bert_embedding_dim=5, postnet_n_convolutions=3,
         postnet_kernel_size=3, postnet_embedding_dim=4)


def test_decode_step_by_hand():
    # prenets 2 x (2*3 + 3*3) = 30; attention LSTMs 2 x (3+4+5) x 4*5 = 480;
    # decoder LSTM (10+8+6) x 24 = 576; projections (6+8) x 3 = 42
    # attention per stream 5*2 + 2L + 4L: L=7 -> 52, L=3 -> 28
    assert flops.decode_step_flops(T, 7, 3) == 2 * (1128 + 52 + 28)
    # location features: 2*1*3*L + 1*2*L a stream
    lsa = dict(T, attention="LocationSensitiveAttention")
    assert flops.decode_step_flops(lsa, 7, 3) == 2 * (1128 + 52 + 28
                                                       + 8 * 7 + 8 * 3)


def test_encoder_and_postnet_by_hand():
    # convs 2 x 4*4*3*L, BiLSTM 2 x (4+2) x 8 x L, converter 9*4*L, memory 4*2*L
    assert flops.encoder_flops(T, 5) == 2 * 5 * (96 + 96 + 36 + 8)
    # 2->4, 4->4, 4->2 channels, k3
    assert flops.postnet_frame_flops(T) == 2 * (24 + 48 + 24)


def test_hifigan_by_hand():
    h = dict(upsample_initial_channel=4, num_mels=2, upsample_rates=[2, 2],
             upsample_kernel_sizes=[4, 4], resblock="1",
             resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]])
    # conv_pre 56, convT 32 + 16, resblocks 2*(2*2*3)*2 + 2*(1*1*3)*4,
    # conv_post 1*1*7*4
    assert HIFIGAN.frame_flops(h) == 2 * (56 + 32 + 48 + 16 + 24 + 28)
    v1 = layout.config("t2s-sma-int8-hifigan-v1")["hifigan"]
    assert HIFIGAN.frame_flops(v1) == 2 * 307_052_544   # ~614 MFLOP


@pytest.mark.parametrize("shape, bound_ms", [
    ((2, 4, 1792, 4096), 0.00444), ((1, 4, 4096, 4096), 0.00504),
    ((2, 128, 1792, 4096), 0.00592), ((1, 128, 4096, 4096), 0.00595)])
def test_k1_bound_is_the_kernel_tables(shape, bound_ms):
    """The bounds of PERF.md's K1 rows, to their printed digits."""
    assert round(flops.k1_bound_s(*shape) * 1e3, 5) == bound_ms


def test_k1_step_bound():
    t = layout.config("t2s-sma-int8-hifigan-v1")["tacotron"]
    assert flops.k1_step_shapes(t, 128) == [(2, 128, 1792, 4096),
                                            (1, 128, 4096, 4096)]
    assert round(flops.k1_step_bound_s(t, 128) * 1e3, 5) == 0.01187
    assert flops.k1_bytes(1, 1, 2, 3) == 6 + 4 + 12 + 12


def test_batch_flops_is_the_sum_of_its_layers():
    voc = HIFIGAN.frame_flops(
        layout.config("t2s-sma-int8-hifigan-v1")["hifigan"])
    one = (flops.encoder_flops(T, 5) + flops.encoder_flops(T, 3)
           + 7 * (flops.decode_step_flops(T, 5, 3) + flops.postnet_frame_flops(T)
                  + voc))
    assert flops.batch_flops(T, voc, [5, 5], [3, 3], [7, 7]) == 2 * one


@pytest.mark.parametrize("name, voc, batch", [
    ("t2s-sma-int8-hifigan-v1", 614_105_088.0, 511_759_578_112.0),
    ("t2s-lsa-bf16-hifigan-v2", 38_510_592.0, 85_594_616_320.0)])
def test_full_configs_flops_are_unchanged(name, voc, batch):
    """Each full configuration's vocoder FLOPs a frame, from its part, and
    a batch's FLOPs: the values of the formula before the vocoder became a
    part of its own."""
    cfg = layout.config(name)
    part = layout.vocoder(cfg["vocoder"])
    assert part.frame_flops(cfg[cfg["vocoder"]]) == voc
    assert flops.batch_flops(cfg["tacotron"], voc, [100, 37], [17, 5],
                             [600, 142]) == batch
