"""Checkpoints and reference-weight loading of the port: its own checkpoint
format (round trip, newest-first scan, the JAX layout's meta.json), the
reference torch state dicts of the acoustic model and of HiFi-GAN through
the JAX package's importers and the port's.

Tolerances: imported trees exactly; the SMALL ``infer`` on the imported
weights (f32, prenet dropout off) and the HiFi-GAN output 1e-5 of the
output's scale (the same f32 arithmetic summed in another order)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_subword_tpu import train_lib as JT
from tacotron2_subword_tpu.models import hifigan as JHG
from tacotron2_subword_tpu.models import tacotron2 as JM
from tacotron2_subword_tpu.utils import checkpoint as JCK
from tacotron2_subword_tpu.utils import import_torch as JIT
from tacotron2_subword_tpu_torch import train_lib as TT
from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.config import TacotronConfig as TConfig
from tacotron2_subword_tpu_torch.models import attention as TA
from tacotron2_subword_tpu_torch.models import hifigan as THG
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.utils import checkpoint as TCK
from tacotron2_subword_tpu_torch.utils import import_torch as TIT
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
from tests.test_model import SMALL, make_batch


def _leaves_equal(port_tree, jax_tree, path="tree", subset=False):
    """The same structure, key by key, with bit-equal leaves; with
    ``subset`` the port's dicts may hold keys that JAX's lack."""
    if isinstance(jax_tree, dict):
        assert (set(jax_tree) <= set(port_tree) if subset
                else sorted(port_tree) == sorted(jax_tree)), path
        for k in jax_tree:
            _leaves_equal(port_tree[k], jax_tree[k], f"{path}.{k}", subset)
    elif isinstance(jax_tree, (list, tuple)):
        assert len(port_tree) == len(jax_tree), path
        for i, (t, j) in enumerate(zip(port_tree, jax_tree)):
            _leaves_equal(t, j, f"{path}.{i}", subset)
    else:
        np.testing.assert_array_equal(port_tree.numpy(), np.asarray(jax_tree),
                                      err_msg=path)


def _port_state(step=7, seed=0):
    state, _ = TT.create_train_state(torch.Generator().manual_seed(seed),
                                     TConfig(**dataclasses.asdict(SMALL)),
                                     device="cpu")
    return state._replace(step=step)


def test_save_load_round_trip(tmp_path):
    state = _port_state()
    # a non-trivial optimizer state
    state = state._replace(opt_state=state.opt_state._replace(
        count=torch.tensor(3, dtype=torch.int32),
        mu=[torch.full((2,), 0.5)], nu={"a": torch.ones(3)}))
    path = TCK.save_checkpoint(state, str(tmp_path), val_loss=0.25,
                               learning_rate=1e-3)
    assert path == TCK.checkpoint_path(str(tmp_path), 7)
    back, meta = TCK.load_checkpoint(path, device="cpu")
    assert back.step == 7
    assert meta == {"iteration": 7, "val_loss": 0.25, "learning_rate": 1e-3}
    for a, b in ((state.params, back.params), (state.bn_state, back.bn_state),
                 (list(state.opt_state), list(back.opt_state))):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_scan_picks_the_newest(tmp_path):
    assert TCK.scan_checkpoint(str(tmp_path)) is None
    state = _port_state()
    for step in (100, 20, 300, 9):
        TCK.save_checkpoint(state._replace(step=step), str(tmp_path))
    (tmp_path / "checkpoint_999.txt").write_text("not a checkpoint")
    assert TCK.scan_checkpoint(str(tmp_path)) == str(tmp_path /
                                                     "checkpoint_300")
    assert TI.latest_checkpoint_path(str(tmp_path)) == str(
        tmp_path / "checkpoint_300")


def test_meta_matches_jax_and_orbax_is_refused(tmp_path):
    """meta.json has the JAX layout's keys; an Orbax directory of the JAX
    package is refused with a message that says how to cross over."""
    jstate, _ = JT.create_train_state(jax.random.PRNGKey(0), SMALL)
    jstate = jstate._replace(step=jnp.asarray(5, jnp.int32))
    jpath = JCK.save_checkpoint(jstate, str(tmp_path / "jax"), val_loss=1.5,
                                learning_rate=2e-3)
    tpath = TCK.save_checkpoint(_port_state(step=5), str(tmp_path / "port"),
                                val_loss=1.5, learning_rate=2e-3)
    with open(os.path.join(jpath, "meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(tpath, "meta.json")) as f:
        tmeta = json.load(f)
    assert tmeta == jmeta
    with pytest.raises(FileNotFoundError, match="Orbax"):
        TCK.load_checkpoint(jpath, device="cpu")


def reference_state_dict(params, bn, cfg, bert_attention=True):
    """The reference BERT_Tacotron2 state dict of a JAX param tree
    (torch Linear weights [out, in]), numpy, with ``cfg.attention``'s keys;
    without ``bert_attention`` no ``attention_layer_bert`` (the reference
    builds it for SMA only)."""
    sd = {}
    p = jax.tree_util.tree_map(np.asarray, params)
    bn = jax.tree_util.tree_map(np.asarray, bn)

    def lin(prefix, q, plain=False):
        base = prefix if plain else f"{prefix}.linear_layer"
        sd[f"{base}.weight"] = q["w"].T
        if "b" in q:
            sd[f"{base}.bias"] = q["b"]

    def conv_bn(prefix, layers, states):
        for i, (layer, st) in enumerate(zip(layers, states)):
            sd[f"{prefix}.convolutions.{i}.0.conv.weight"] = layer["conv"]["w"]
            if "b" in layer["conv"]:
                sd[f"{prefix}.convolutions.{i}.0.conv.bias"] = \
                    layer["conv"]["b"]
            b = f"{prefix}.convolutions.{i}.1"
            sd[f"{b}.weight"], sd[f"{b}.bias"] = (layer["bn"]["scale"],
                                                  layer["bn"]["bias"])
            sd[f"{b}.running_mean"], sd[f"{b}.running_var"] = (st["mean"],
                                                               st["var"])

    def cell(prefix, q, suffix=""):
        for k, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                        ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            sd[f"{prefix}.{name}{suffix}"] = q[k]

    sd["embedding.weight"] = p["embedding"]
    sd["embedding_sub.weight"] = p["embedding_sub"]
    for enc in ("encoder", "encoder_sub"):
        conv_bn(enc, p[enc]["convs"], bn[enc])
        cell(f"{enc}.lstm", p[enc]["lstm"]["fwd"], "_l0")
        cell(f"{enc}.lstm", p[enc]["lstm"]["bwd"], "_l0_reverse")
    lin("linear_converter", p["linear_converter"])
    lin("linear_converter_sub", p["linear_converter_sub"])
    conv_bn("postnet", p["postnet"], bn["postnet"])
    d = p["decoder"]
    for net in ("prenet", "prenet_bert"):
        for i in range(2):
            lin(f"decoder.{net}.layers.{i}", d[net][i])
    for rnn in ("attention_rnn", "attention_rnn_bert", "decoder_rnn"):
        cell(f"decoder.{rnn}", d[rnn])
    names = (("attention", "attention_layer"),
             ("attention_bert", "attention_layer_bert"))
    for att, name in names[:2 if bert_attention else 1]:
        q, pre = d[att], f"decoder.{name}"
        lin(f"{pre}.memory_layer", q["memory"])
        if cfg.attention == "DynamicConvolutionAttention":
            for k in ("W", "V", "U", "T", "v"):
                lin(f"{pre}.{k}", q[k], plain=True)
            sd[f"{pre}.F.weight"] = q["F"]["w"]
            sd[f"{pre}.P"] = q["prior"]
        elif cfg.attention == "GMMAttention":
            lin(f"{pre}.mlp.0", q["mlp1"], plain=True)
            lin(f"{pre}.mlp.2", q["mlp2"], plain=True)
        else:
            lin(f"{pre}.query_layer", q["query"])
            lin(f"{pre}.v", q["v"],
                plain=cfg.attention == "StepwiseMonotonicAttention")
        if "loc_conv" in q:
            loc = f"{pre}.location_layer"
            sd[f"{loc}.location_conv.conv.weight"] = q["loc_conv"]["w"]
            lin(f"{loc}.location_dense", q["loc_dense"])
    lin("decoder.linear_projection", d["linear_projection"])
    lin("decoder.gate_layer", d["gate_layer"])
    return sd


def test_reference_state_dict_imports_like_jax(tmp_path):
    cfg = SMALL.replace(prenet_dropout_always_on=False)
    tcfg = TConfig(**dataclasses.asdict(cfg))
    params, bn = JM.init_tacotron2(jax.random.PRNGKey(3), cfg)
    sd = reference_state_dict(params, bn, cfg)
    jp, jbn = JIT.params_from_torch_state_dict(sd, cfg)
    tp, tbn = TIT.params_from_torch_state_dict(sd, tcfg, device="cpu")
    _leaves_equal(tp, jp)
    _leaves_equal(tbn, jbn)

    # the same through a reference checkpoint_{iter} file
    path = str(tmp_path / "checkpoint_1200")
    torch.save({"iteration": 1200, "learning_rate": 5e-4,
                "state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, path)
    fp, fbn, meta = TIT.load_torch_checkpoint(path, tcfg, device="cpu")
    assert meta == {"iteration": 1200, "learning_rate": 5e-4}
    _leaves_equal(fp, jp)
    lp, lbn = TI.load_acoustic_model(path, tcfg, "cpu")
    _leaves_equal(lp, jp)

    b = make_batch(cfg)
    j = JM.infer(jp, jbn, cfg, b["text"], b["sub"], b["cls_phone"],
                 b["cls_sub"], rng=jax.random.PRNGKey(1), max_steps=12,
                 gate_threshold=1.1, text_lengths=b["text_lengths"],
                 sub_lengths=b["sub_lengths"])
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    t = TM.infer(fp, fbn, tcfg, tb["text"], tb["sub"], tb["cls_phone"],
                 tb["cls_sub"], max_steps=12, gate_threshold=1.1,
                 text_lengths=tb["text_lengths"],
                 sub_lengths=tb["sub_lengths"])
    for k in ("mel_postnet", "alignments", "alignments_bert"):
        ref = np.asarray(j[k])
        assert np.abs(t[k].numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), k
    np.testing.assert_array_equal(t["mel_lengths"].numpy(),
                                  np.asarray(j["mel_lengths"]))

    # a key the importer reads is missing: both raise
    del sd["decoder.gate_layer.linear_layer.weight"]
    with pytest.raises(KeyError):
        JIT.params_from_torch_state_dict(sd, cfg)
    with pytest.raises(KeyError):
        TIT.params_from_torch_state_dict(sd, tcfg, device="cpu")


@pytest.mark.parametrize("bert_attention", [False, True])
@pytest.mark.parametrize("variant", [
    "LocationSensitiveAttention", "ForwardAttentionV2", "ContentAttention",
    "DynamicConvolutionAttention", "GMMAttention"])
def test_reference_state_dict_of_every_variant_imports_like_jax(
        variant, bert_attention):
    """Each variant's reference keys, with the subword stream's attention
    (SMA's layout) or without it (the reference's, for the other
    variants: the phone stream's weights drive both).  The tree equals the
    JAX import wherever JAX has the leaf, equals the weights the state dict
    was made from, and has ``init_tacotron2``'s structure.  JAX's importer
    has no ContentAttention branch: its tree lacks ``query`` and ``v``,
    which the port reads."""
    cfg = SMALL.replace(attention=variant)
    tcfg = TConfig(**dataclasses.asdict(cfg))
    params, bn = JM.init_tacotron2(jax.random.PRNGKey(5), cfg)
    sd = reference_state_dict(params, bn, cfg, bert_attention)
    jp, _ = JIT.params_from_torch_state_dict(sd, cfg)
    tp, tbn = TIT.params_from_torch_state_dict(sd, tcfg, device="cpu")
    _leaves_equal(tp, jp, subset=True)
    if variant == "ContentAttention":
        assert "query" not in jp["decoder"]["attention"]
    src = params["decoder"]
    _leaves_equal(tp["decoder"]["attention"], src["attention"])
    _leaves_equal(tp["decoder"]["attention_bert"],
                  src["attention_bert" if bert_attention else "attention"])
    ip, ibn = TM.init_tacotron2(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    for t, i in ((tp, ip), (tbn, ibn)):
        assert (jax.tree_util.tree_structure(t)
                == jax.tree_util.tree_structure(i))
        assert [a.shape for a in tree_leaves(t)] == [a.shape for a in
                                                     tree_leaves(i)]
    # a key of the variant is missing: the import raises
    key = next(k for k in sd if k.startswith("decoder.attention_layer.")
               and "memory_layer" not in k)
    del sd[key]
    with pytest.raises(KeyError):
        TIT.params_from_torch_state_dict(sd, tcfg, device="cpu")


def test_unknown_attention_variant_raises():
    cfg = SMALL.replace(attention="MonotonicAttention")
    params, bn = JM.init_tacotron2(jax.random.PRNGKey(0), SMALL)
    sd = reference_state_dict(params, bn, SMALL)
    with pytest.raises(ValueError, match="unknown attention variant"):
        TIT.params_from_torch_state_dict(
            sd, TConfig(**dataclasses.asdict(cfg)), device="cpu")


def hifigan_state_dict(params):
    """A HiFi-GAN param tree of JAX or numpy arrays as the reference's
    generator state dict (the port's ``export_torch_generator``)."""
    return THG.export_torch_generator(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), params))


@pytest.mark.parametrize("resblock", ["1", "2"])
@pytest.mark.parametrize("fused", [False, True])
def test_hifigan_reference_checkpoint_matches_jax(tmp_path, resblock, fused):
    kw = dict(resblock=resblock, upsample_rates=(4, 2),
              upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
              resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 3), (1, 2)), num_mels=6)
    jh, th = JHG.HifiganConfig(**kw), THG.HifiganConfig(**kw)
    # THG.HifiganConfig.from_json reads the reference's JSON
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({**kw, "sampling_rate": 22050}))
    assert THG.HifiganConfig.from_json(str(cfg_path)) == th
    params = JHG.init_generator(jax.random.PRNGKey(0), jh)
    params["conv_pre"]["g"] = params["conv_pre"]["g"] * 3.0
    if fused:
        params = JHG.fuse_generator(params)
    sd = hifigan_state_dict(params)
    jp = JHG.fuse_generator(JHG.import_torch_generator(
        {k: v.numpy() for k, v in sd.items()}, jh))
    tp = THG.fuse_generator(THG.import_torch_generator(sd, th, device="cpu"))
    mel = np.random.RandomState(0).randn(2, 6, 11).astype(np.float32)
    j = np.asarray(JHG.generator_apply(jp, jh, mel))
    t = THG.generator_apply(tp, th, torch.from_numpy(mel)).numpy()
    assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max()

    # and through the CLI's loader, from a {'generator': sd} file
    path = str(tmp_path / "g_00000100")
    torch.save({"generator": sd}, path)
    vocode, name = TI.load_vocoder(path, str(cfg_path), "cpu")
    assert name == "hifigan"
    v = vocode(torch.from_numpy(mel)).numpy()
    assert np.abs(v - j[:, 0]).max() <= 1e-5 * np.abs(j).max()


def _trained_state(steps=2, attention="StepwiseMonotonicAttention"):
    """A SMALL port state after ``steps`` train steps (Adam moments and BN
    statistics that a fresh init does not have)."""
    cfg = TConfig(**dataclasses.asdict(SMALL.replace(attention=attention)))
    state, tx = TT.create_train_state(torch.Generator().manual_seed(3), cfg,
                                      device="cpu")
    b = make_batch(SMALL)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    for k in ("text", "sub", "text_lengths", "sub_lengths",
              "output_lengths"):
        batch[k] = batch[k].long()
    batch["gate_target"] = TT.make_gate_target(batch["output_lengths"],
                                               batch["mels"].shape[2])
    for i in range(steps):
        state, _ = TT.train_step(state, batch, cfg, tx,
                                 generator=torch.Generator().manual_seed(i))
    return state, tx, batch, cfg


def test_round_trip_of_a_trained_state_continues_bit_equal(tmp_path):
    """As the JAX package's round-trip test: after real steps, the loaded
    state equals the saved one and the next step from it equals the next
    step from the original, bit for bit."""
    state, tx, batch, cfg = _trained_state()
    back, _ = TCK.load_checkpoint(TCK.save_checkpoint(state, str(tmp_path)),
                                  device="cpu")
    assert back.step == state.step == 2
    (a, ma), (b, mb) = [TT.train_step(
        s, batch, cfg, tx, generator=torch.Generator().manual_seed(9))
        for s in (state, back)]
    assert a.step == b.step == 3
    assert ma["total"].item() == mb["total"].item()
    for x, y in zip(tree_leaves((a.params, a.bn_state, list(a.opt_state))),
                    tree_leaves((b.params, b.bn_state, list(b.opt_state)))):
        assert torch.equal(x, y)


def test_round_trip_and_warm_start_of_a_dca_state(tmp_path):
    """A trained DynamicConvolutionAttention state (its prior a trained
    leaf, as in the JAX package) round-trips bit for bit and continues
    bit-equal; warm start onto a fresh DCA state loads it."""
    attention = "DynamicConvolutionAttention"
    state, tx, batch, cfg = _trained_state(steps=1, attention=attention)
    prior = state.params["decoder"]["attention"]["prior"]
    assert not torch.equal(prior, TA.dca_prior())
    back, _ = TCK.load_checkpoint(TCK.save_checkpoint(state, str(tmp_path)),
                                  device="cpu")
    (a, ma), (b, mb) = [TT.train_step(
        s, batch, cfg, tx, generator=torch.Generator().manual_seed(9))
        for s in (state, back)]
    assert ma["total"].item() == mb["total"].item()
    for x, y in zip(tree_leaves((a.params, a.bn_state, list(a.opt_state))),
                    tree_leaves((b.params, b.bn_state, list(b.opt_state)))):
        assert torch.equal(x, y)
    fresh, _ = TT.create_train_state(torch.Generator().manual_seed(99), cfg,
                                     device="cpu")
    warm = TCK.warm_start(TCK.checkpoint_path(str(tmp_path), 1), fresh)
    assert torch.equal(warm.params["decoder"]["attention"]["prior"], prior)
    assert torch.equal(warm.params["embedding"], fresh.params["embedding"])


def test_warm_start_keeps_ignore_layers_and_loads_the_rest(tmp_path):
    trained, _, _, _ = _trained_state()
    path = TCK.save_checkpoint(trained, str(tmp_path))
    fresh = _port_state(step=0, seed=99)
    warm = TCK.warm_start(path, fresh, ignore_layers=("embedding",
                                                      "embedding_sub"))
    assert warm.step == 0
    for k in trained.params:
        src = fresh if k in ("embedding", "embedding_sub") else trained
        for a, b in zip(tree_leaves(warm.params[k]),
                        tree_leaves(src.params[k])):
            assert torch.equal(a, b), k
    for a, b in zip(tree_leaves(warm.bn_state),
                    tree_leaves(trained.bn_state)):
        assert torch.equal(a, b)
    # the optimizer state stays the current (fresh) one
    for a, b in zip(tree_leaves(list(warm.opt_state)),
                    tree_leaves(list(fresh.opt_state))):
        assert torch.equal(a, b)
    # the default keeps only the phone embedding
    warm = TCK.warm_start(path, fresh)
    assert torch.equal(warm.params["embedding"], fresh.params["embedding"])
    assert torch.equal(warm.params["embedding_sub"],
                       trained.params["embedding_sub"])


def test_best_tracker_saves_only_on_a_fall(tmp_path):
    state = _port_state(step=4)
    best = os.path.join(str(tmp_path), "checkpoint_best", "meta.json")
    tracker = TCK.BestTracker(str(tmp_path))
    assert tracker.best == float("inf")
    assert tracker.update(state, 2.0, 1e-3)
    assert not tracker.update(state._replace(step=5), 3.0, 1e-3)
    with open(best) as f:
        assert json.load(f) == {"iteration": 4, "val_loss": 2.0,
                                "learning_rate": 1e-3}
    assert tracker.update(state._replace(step=6), 1.0, 1e-3)
    # a new tracker reads the best so far from checkpoint_best/meta.json
    again = TCK.BestTracker(str(tmp_path))
    assert again.best == 1.0
    assert not again.update(state._replace(step=7), 1.5, 1e-3)
    with open(best) as f:
        assert json.load(f)["iteration"] == 6
    back, _ = TCK.load_checkpoint(os.path.dirname(best), device="cpu")
    assert back.step == 6
