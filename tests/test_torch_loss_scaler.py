"""The port's dynamic loss scaler (utils/loss_scaler) against the JAX
package's, step for step: the same gradients, with an inf and a nan
injected, through six updates at ``scale_window=2``.  Scale, good steps
and the overflow flag exactly; the unscaled gradients bit for bit (one f32
division each), a bf16 leaf promoted to f32 as JAX promotes it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_subword_tpu.utils import loss_scaler as JLS
from tacotron2_subword_tpu_torch.utils import loss_scaler as TLS
from tests.torch_threads import one_torch_thread  # noqa: F401

# per step: None, or (leaf, index, value) injected into the scaled grads
INJECT = [None, None, ("w", (1, 2), np.inf), None, ("b", (0,), np.nan),
          None]


def _grads(rng, step, scale):
    g = {"w": (rng.randn(3, 4) * scale).astype(np.float32),
         "b": (rng.randn(5) * scale).astype(np.float32),
         "layers": [(rng.randn(2) * scale).astype(np.float32)]}
    if INJECT[step] is not None:
        name, at, val = INJECT[step]
        g[name][at] = val
    return g


@pytest.mark.parametrize("init_scale", [2.0 ** 32, 2.0 ** 10])
def test_updates_match_jax(init_scale):
    rng = np.random.RandomState(0)
    js = JLS.init_loss_scaler(init_scale)
    ts = TLS.init_loss_scaler(init_scale, device="cpu")
    assert ts.scale.dtype == torch.float32 and ts.good_steps.dtype == \
        torch.int32
    loss = np.float32(0.731)
    for step in range(len(INJECT)):
        np.testing.assert_array_equal(
            TLS.scale_loss(ts, torch.tensor(loss)).numpy(),
            np.asarray(JLS.scale_loss(js, jnp.float32(loss))))
        g = _grads(rng, step, float(np.asarray(js.scale)))
        jg, js, jo = JLS.unscale_and_update(
            js, {k: jnp.asarray(v) if k != "layers" else [jnp.asarray(v[0])]
                 for k, v in g.items()}, scale_window=2)
        tg, ts, to = TLS.unscale_and_update(
            ts, {k: torch.from_numpy(v) if k != "layers"
                 else [torch.from_numpy(v[0])] for k, v in g.items()},
            scale_window=2)
        assert to.dtype == torch.bool and bool(to) == bool(jo), step
        assert bool(to) == (INJECT[step] is not None)
        assert ts.scale.item() == float(np.asarray(js.scale)), step
        assert ts.good_steps.item() == int(np.asarray(js.good_steps)), step
        for k in ("w", "b"):
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_array_equal(tg["layers"][0].numpy(),
                                      np.asarray(jg["layers"][0]))
    # the first two clean steps doubled the scale, each overflow halved it
    assert ts.scale.item() == init_scale / 2


def test_half_precision_leaves_are_promoted_like_jax():
    js = JLS.init_loss_scaler(2.0 ** 12)
    ts = TLS.init_loss_scaler(2.0 ** 12, device="cpu")
    g = np.random.RandomState(1).randn(6).astype(np.float32) * 4096
    jg, _, jo = JLS.unscale_and_update(
        js, [jnp.asarray(g, jnp.bfloat16)])
    tg, _, to = TLS.unscale_and_update(
        ts, [torch.from_numpy(g).to(torch.bfloat16)])
    assert tg[0].dtype == torch.float32 and jg[0].dtype == jnp.float32
    np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg[0]))
    assert not bool(to) and not bool(jo)
