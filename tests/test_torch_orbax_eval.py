"""The Orbax -> port converter (``tools/orbax_to_torch.py``) and the port's
``tools/eval_synthetic`` against the JAX package's, on the CPU at the SMALL
widths of tests/test_model.py with the synthetic corpus's vocabularies.

- A JAX acoustic checkpoint, converted and loaded by the port: every
  param, BN statistic and Adam moment bit-equal, the step and meta.json
  kept; the port's ``infer`` on it matches JAX's ``infer`` on the JAX
  checkpoint with JAX's prenet masks injected, to 2e-4 (the f32 decode
  parity bound of tests/test_torch_infer.py: the same arithmetic summed in
  another order, through a recurrence).
- A JAX HiFi-GAN generator directory, converted and served by the port's
  loader: within 1e-5 of the output's scale of JAX's ``generator_apply``
  (the bound of tests/test_torch_hifigan.py).
- ``eval_synthetic``, JAX's tool on the JAX checkpoints and the port's on
  the converted ones (JAX's masks injected), on a corpus of the port's
  ``make_synthetic_dataset``: equal ``frames_pred`` and ``gate_ok`` (so
  equal ``len_err``), at gate thresholds that no step's gate value lies
  within 1e-3 of (checked); ``softdtw`` and ``mcd`` within 2e-4 relative
  (+1e-4 absolute for the per-utterance rows, which are rounded to 4
  decimals), the decode's bound.
"""

import csv
import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tacotron2_subword_tpu import train_lib as JT
from tacotron2_subword_tpu.config import create_config as jax_config
from tacotron2_subword_tpu.models import hifigan as JHG
from tacotron2_subword_tpu.models import tacotron2 as JM
from tacotron2_subword_tpu.utils import checkpoint as JCK
from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.tools import eval_synthetic as TES
from tacotron2_subword_tpu_torch.tools import make_synthetic_dataset as TMS
from tacotron2_subword_tpu_torch.utils import checkpoint as TCK
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
DECODE_TOL = 2e-4
# the SMALL widths with the corpus's vocabularies, 80 mels and 768-d [CLS]
EVAL_HP = ("[n_symbols:80-sub_n_symbols:520-symbols_embedding_dim:16-"
           "encoder_embedding_dim:16-bert_embedding_dim:768-"
           "attention_rnn_dim:20-attention_dim:8-decoder_rnn_dim:24-"
           "prenet_dim:10-n_mel_channels:80-postnet_embedding_dim:16-"
           "attention_location_n_filters:4-attention_location_kernel_size:7-"
           "parity_mode:true]")
EVAL_N, EVAL_STEPS = 3, 12
GATES = (0.5525, 0.58)
GATE_MARGIN = 1e-3
HIFIGAN = {"resblock": "1", "upsample_rates": [4, 2],
           "upsample_kernel_sizes": [8, 4], "upsample_initial_channel": 16,
           "resblock_kernel_sizes": [3, 5],
           "resblock_dilation_sizes": [[1, 3], [1, 2]], "num_mels": 6,
           "sampling_rate": 22050}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's decodes here are thousands of tiny ops: with every core
    per test worker, the suite's workers starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONVERTER = _tool("orbax_to_torch")


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(path.rglob("*")):
        h.update(str(p.relative_to(path)).encode())
        if p.is_file():
            h.update(p.read_bytes())
    return h.hexdigest()


def _jax_state(cfg, seed, step):
    """A JAX train state with seeded params and non-zero Adam moments."""
    state, _ = JT.create_train_state(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)
    adam = state.opt_state[2]
    moments = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), t)
    adam = adam._replace(count=jnp.asarray(step, jnp.int32),
                         mu=moments(adam.mu), nu=moments(adam.nu))
    opt = tuple(adam if i == 2 else s for i, s in enumerate(state.opt_state))
    return state._replace(step=jnp.asarray(step, jnp.int32), opt_state=opt)


def _jax_prenet_masks(rng, B, steps, prenet_dim):
    """The scaled prenet keep-masks [4, B, P] per step that JAX's
    ``infer(rng=rng)`` draws (its split, then one split per step)."""
    key = jax.random.split(rng, 5)[3]
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(torch.from_numpy(np.array(JM._prenet_masks(
            k, 4, (B, prenet_dim), np.float32))))
    return out


def _inject_masks(monkeypatch, masks):
    """Every decode of the port (a new generator each) takes ``masks`` from
    its first step on."""
    streams, keep = {}, []

    def fake(generator, n, shape, dtype, device):
        if id(generator) not in streams:
            keep.append(generator)
            streams[id(generator)] = iter(masks)
        return next(streams[id(generator)]).to(dtype)
    monkeypatch.setattr(TM, "_prenet_masks", fake)


def _same_leaves(port_tree, jax_tree):
    a, b = tree_leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape
        np.testing.assert_array_equal(x.numpy(), y)
        assert x.numpy().dtype == y.dtype


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """A corpus of EVAL_N val utterances, a JAX run of two checkpoints (its
    states beside it) and its conversion."""
    d = tmp_path_factory.mktemp("eval")
    TMS.main(["--out", str(d / "data"), "--n-train", "0", "--n-val",
              str(EVAL_N), "--seed", "3", "--no-wavs"])
    cfg = jax_config(hparams_string=EVAL_HP)
    states = {step: _jax_state(cfg, seed, step)
              for seed, step in ((5, 100), (6, 200))}
    for state in states.values():
        JCK.save_checkpoint(state, str(d / "jax"))
    CONVERTER.main(["--sweep-dir", str(d / "jax"), "--out-dir",
                    str(d / "port"), "--hparams", EVAL_HP])
    return d, cfg, states


def test_converted_checkpoint_is_bit_equal_and_decodes_like_jax(
        eval_run, tmp_path, monkeypatch):
    d, cfg, states = eval_run
    jstate = states[100]
    jpath = JCK.save_checkpoint(jstate, str(tmp_path / "jax"), val_loss=1.25,
                                learning_rate=5e-4)
    before = _digest(Path(jpath))
    out = tmp_path / "port"
    written = CONVERTER.main(["--checkpoint", jpath, "--out-dir", str(out),
                              "--hparams", EVAL_HP])
    assert written == [str(out / "checkpoint_100")]
    assert _digest(Path(jpath)) == before  # the input is not touched
    with pytest.raises(FileExistsError):   # nor is an earlier output
        CONVERTER.main(["--checkpoint", jpath, "--out-dir", str(out),
                        "--hparams", EVAL_HP])

    state, meta = TCK.load_checkpoint(written[0], device="cpu")
    assert state.step == 100
    assert meta == {"iteration": 100, "val_loss": 1.25, "learning_rate": 5e-4}
    _same_leaves(state.params, jstate.params)
    _same_leaves(state.bn_state, jstate.bn_state)
    adam = jstate.opt_state[2]
    assert int(state.opt_state.count) == 100
    _same_leaves(state.opt_state.mu, adam.mu)
    _same_leaves(state.opt_state.nu, adam.nu)

    # infer on the converted state against JAX on the JAX checkpoint, over
    # the corpus's val batch
    b = TES.load_val_batch(TES.build_argparser().parse_args(
        _eval_argv(d / "data", GATES)), torch.device("cpu"))
    j = {k: jnp.asarray(b[k].numpy().astype(
        np.float32 if k == "cls" else np.int32))
        for k in ("text", "sub", "cls", "t_lens", "s_lens")}
    steps = 8
    infer = jax.jit(lambda p, bn, b: JM.infer(
        p, bn, cfg, b["text"], b["sub"], b["cls"], b["cls"],
        rng=jax.random.PRNGKey(1), max_steps=steps, gate_threshold=1.1,
        text_lengths=b["t_lens"], sub_lengths=b["s_lens"]))
    ref = _np(infer(jstate.params, jstate.bn_state, j))
    _inject_masks(monkeypatch, _jax_prenet_masks(
        jax.random.PRNGKey(1), EVAL_N, steps, cfg.prenet_dim))
    port_cfg = TM.TacotronConfig(**dataclasses.asdict(cfg))
    got = TM.infer(state.params, state.bn_state, port_cfg, b["text"],
                   b["sub"], b["cls"], b["cls"], generator=torch.Generator(),
                   max_steps=steps, gate_threshold=1.1,
                   text_lengths=b["t_lens"], sub_lengths=b["s_lens"])
    for k in ("mel_postnet", "gate", "alignments", "alignments_bert"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=k)


def test_sweep_dir_converts_every_checkpoint(eval_run, tmp_path):
    """--sweep-dir: each checkpoint_* (checkpoint_best too) under its own
    name, with its own step."""
    _, _, states = eval_run
    run = tmp_path / "run"
    for step in (200, 100):
        JCK.save_checkpoint(states[step], str(run))
    JCK.save_checkpoint(states[100], str(run), name="checkpoint_best",
                        val_loss=0.5)
    out = tmp_path / "port"
    written = CONVERTER.main(["--sweep-dir", str(run), "--out-dir", str(out),
                              "--hparams", EVAL_HP])
    assert [Path(p).name for p in written] == [
        "checkpoint_100", "checkpoint_200", "checkpoint_best"]
    for p, step in zip(written, (100, 200, 100)):
        state, meta = TCK.load_checkpoint(p, device="cpu")
        assert state.step == step and meta["iteration"] == step
    assert TCK.load_checkpoint(written[2], "cpu")[1]["val_loss"] == 0.5


def test_converted_generator_matches_jax(tmp_path):
    """A g_NNNNNNNN Orbax dir of the JAX trainer -> the reference
    {'generator': ...} file -> the port's loader (fused for serving)."""
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(HIFIGAN))
    jh = JHG.HifiganConfig.from_json(str(cfg_path))
    params = jax.jit(lambda key: JHG.init_generator(key, jh))(
        jax.random.PRNGKey(4))
    # g away from ||v||, so the weight norm is carried, not re-derived
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 1.3 if str(path[-1]) == "['g']" else a, params)
    gdir = tmp_path / "g_00000010"
    ocp.PyTreeCheckpointer().save(str(gdir), _np(params))
    out = tmp_path / "port" / "g_00000010"
    CONVERTER.main(["--generator", str(gdir), "--out", str(out),
                    "--config", str(cfg_path)])
    ck = torch.load(out, map_location="cpu", weights_only=True)
    assert set(ck) == {"generator"}
    assert any(k.endswith("weight_g") for k in ck["generator"])
    vocode, name = TI.load_vocoder(str(out), str(cfg_path), "cpu")
    assert name == "hifigan"
    mel = np.random.RandomState(0).randn(2, 6, 9).astype(np.float32)
    ref = np.asarray(JHG.generator_apply(params, jh, jnp.asarray(mel)))[:, 0]
    got = vocode(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# eval_synthetic
# ---------------------------------------------------------------------------

def _eval_argv(data, gates, *extra):
    return ["--data", str(data), "--hparams", EVAL_HP, "--n", str(EVAL_N),
            "--max-steps", str(EVAL_STEPS), "--gate-thresholds",
            ",".join(str(g) for g in gates), *extra]


def _jax_eval(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["eval_synthetic.py", *argv, "--cpu"])
    _tool("eval_synthetic").main()


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _rows_match(got, ref, atol):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if k in ("softdtw", "mcd"):
                np.testing.assert_allclose(float(g[k]), float(r[k]),
                                           rtol=DECODE_TOL, atol=atol,
                                           err_msg=k)
            else:
                assert g[k] == r[k], k


def test_eval_synthetic_sweep_matches_jax(eval_run, tmp_path, monkeypatch):
    """Sweep mode: one summary row per (checkpoint, gate), equal to the JAX
    tool's; a second run skips every row; a CSV of another schema stops
    the tool."""
    d, cfg, _ = eval_run
    masks = _jax_prenet_masks(jax.random.PRNGKey(TES.MASK_SEED), EVAL_N,
                              EVAL_STEPS, cfg.prenet_dim)
    _inject_masks(monkeypatch, masks)
    # no step's gate value lies within GATE_MARGIN of a threshold, so the
    # stop frames cannot flip on the decode's f32 rounding
    batch = TES.load_val_batch(
        TES.build_argparser().parse_args(_eval_argv(d / "data", GATES)),
        torch.device("cpu"))
    port_cfg = TM.TacotronConfig(**dataclasses.asdict(cfg))
    for ck in ("checkpoint_100", "checkpoint_200"):
        state, _ = TCK.load_checkpoint(str(d / "port" / ck), "cpu")
        out = TES.decode(state, port_cfg, batch, 2.0, EVAL_STEPS, "cpu")
        gate = torch.sigmoid(out["gate"][:, :EVAL_STEPS]).numpy()
        for thr in GATES:
            assert np.abs(gate - thr).min() > GATE_MARGIN, (ck, thr)

    jcsv, tcsv = tmp_path / "jax.csv", tmp_path / "port.csv"
    _jax_eval(_eval_argv(d / "data", GATES, "--sweep-dir", str(d / "jax"),
                         "--out-csv", str(jcsv)), monkeypatch)
    res = TES.main(_eval_argv(d / "data", GATES, "--sweep-dir",
                              str(d / "port"), "--out-csv", str(tcsv),
                              "--cpu"))
    ref, got = _read(jcsv), _read(tcsv)
    _rows_match(got, ref, atol=0)
    assert [(r["checkpoint"], r["gate"]) for r in got] == [
        (c, str(g)) for c in ("checkpoint_100", "checkpoint_200")
        for g in GATES]
    # the thresholds split the utterances: some stop, some run out
    assert {r["gate_ok"] for r in got} == {"0", "1", "2"}
    assert len(res["decodes"]) == 4
    assert all(0 < r["steps_run"] <= EVAL_STEPS for r in res["decodes"])

    again = TES.main(_eval_argv(d / "data", GATES, "--sweep-dir",
                                str(d / "port"), "--out-csv", str(tcsv),
                                "--cpu"))
    assert again["decodes"] == [] and _read(tcsv) == got

    other = tmp_path / "other.csv"
    other.write_text("checkpoint,gate,mcd\nx,0.1,1.0\n")
    with pytest.raises(SystemExit, match="header"):
        TES.main(_eval_argv(d / "data", GATES, "--sweep-dir",
                            str(d / "port"), "--out-csv", str(other),
                            "--cpu"))


def test_eval_synthetic_utterance_rows_match_jax(eval_run, tmp_path,
                                                 monkeypatch):
    """One checkpoint, one threshold: the per-utterance rows (the lines
    stop at frames 2 and 1, the third runs to the last step)."""
    d, cfg, _ = eval_run
    _inject_masks(monkeypatch, _jax_prenet_masks(
        jax.random.PRNGKey(TES.MASK_SEED), EVAL_N, EVAL_STEPS,
        cfg.prenet_dim))
    jcsv, tcsv = tmp_path / "jax.csv", tmp_path / "port.csv"
    gate = GATES[:1]
    _jax_eval(_eval_argv(d / "data", gate, "--checkpoint",
                         str(d / "jax" / "checkpoint_100"), "--out-csv",
                         str(jcsv)), monkeypatch)
    TES.main(_eval_argv(d / "data", gate, "--checkpoint",
                        str(d / "port" / "checkpoint_100"), "--out-csv",
                        str(tcsv), "--cpu"))
    got = _read(tcsv)
    _rows_match(got, _read(jcsv), atol=1e-4)
    assert [r["utt"] for r in got] == [str(i) for i in range(EVAL_N)]
    assert [r["frames_pred"] for r in got] == ["2", "1", str(EVAL_STEPS)]
