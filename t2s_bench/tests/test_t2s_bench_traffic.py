"""The traffic generator's draws repeat for one seed, every batch and
every seed asks for the same lengths, and the rigged gate stops each
sentence near the frame its phone count sets."""

from __future__ import annotations

import numpy as np
import torch

from t2s_bench import layout, run as R

SEED = 2 ** 31 + 12345


def _mix():
    return layout.traffic("synth-b256"), layout.config(
        "t2s-sma-int8-hifigan-v1")["tacotron"]


def _flat(batches):
    return [np.concatenate([np.concatenate([r[0], r[1], r[2]]) for r in b])
            for b in batches]


def test_draws_repeat_for_one_seed():
    mix, t = _mix()
    traffic = layout.generator(mix["generator"])
    a, b = traffic.make(mix, SEED, t), traffic.make(mix, SEED, t)
    c = traffic.make(mix, SEED + 1, t)
    assert all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    assert not np.array_equal(_flat(a)[0], _flat(c)[0])
    assert traffic.check_batch(mix, SEED) == traffic.check_batch(mix, SEED)


def test_every_batch_asks_for_the_same_lengths():
    mix, t = _mix()
    traffic = layout.generator(mix["generator"])
    phones, subs, stops = traffic.sizes(mix, t)
    latch = dict(zip(phones, traffic.latch_input(stops)))
    for seed in (0, SEED):
        for batch in traffic.make(mix, seed, t):
            assert len(batch) == mix["batch"]
            assert sorted(len(r[0]) for r in batch) == sorted(phones)
            assert sorted(len(r[1]) for r in batch) == sorted(subs)
            assert all(r[2][0] == latch[len(r[0])] for r in batch)
            ids = np.concatenate([r[0] for r in batch])
            assert ids.min() >= 1 and ids.max() < t["n_symbols"]


def test_lengths_follow_the_spoken_seconds():
    """A sentence's phones, subwords and frames follow its spoken length
    at the mix's rates; the lengths' mean is the mix's."""
    mix, t = _mix()
    traffic = layout.generator(mix["generator"])
    d = traffic.spoken_seconds(mix)
    s = mix["seconds"]
    assert s["min"] < d[0] and d[-1] < s["max"]
    assert abs(d.mean() - s["mean"]) < 0.01
    phones, subs, stops = traffic.sizes(mix, t)
    assert np.all(np.abs(phones - d * mix["symbols_per_s"]) <= 0.5)
    assert np.all(np.abs(subs - d * mix["subwords_per_s"]) <= 0.5)
    spoken = stops * t["hop_length"] / t["sampling_rate"]
    assert np.all(np.abs(spoken - d) < 0.05)
    assert np.all(np.diff(stops) >= 0) and stops[-1] < mix["max_steps"]


def test_the_rig_stops_each_sentence_near_its_frame(bench_copy):
    """Served on the CPU, each sentence of the tiny cell stops within a
    count (4 frames) of its target, and none runs to the step limit."""
    cell = layout.cell("tiny-lsa", bench_copy)
    traffic = layout.generator("synth_batches", bench_copy)
    mix, cfg = cell["mix"], cell["config"]
    tree = R.make_tree(cell, traffic, SEED, "cpu")
    sut = layout.system(cfg["system"], bench_copy).System(cfg, mix, tree,
                                                           "cpu")
    batch = traffic.make(mix, SEED, cfg["tacotron"])[0]
    gen = torch.Generator().manual_seed(1)
    out = sut.serve(batch, gen)
    phones, _, stops = traffic.sizes(mix, cfg["tacotron"])
    target = dict(zip(phones, stops))
    want = np.array([target[len(r[0])] for r in batch])
    n = out["mel_lengths"].numpy()
    assert bool(out["infer_ok"].all()) and len(set(stops)) > 1
    assert np.all(np.abs(n - want) <= traffic.PERIOD), (n, want)


def test_check_rows_hold_the_longest():
    mix, _ = _mix()
    traffic = layout.generator(mix["generator"])
    n = np.full(mix["batch"], 350)
    n[77] = 351
    rows = traffic.check_rows(mix, SEED, 0, n)
    assert 77 in rows and len(set(rows)) == mix["check_rows"]
    assert np.array_equal(rows, traffic.check_rows(mix, SEED, 0, n))
