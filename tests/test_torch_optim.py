"""The port's AdamW, its int8 quantizer and its schedules against the JAX
package, on the CPU.

The cases of ``tests/test_optim.py`` run on the port; then one and three
``adamw_update``s of the port and of the JAX package on the same
parameters and gradients (made from a seed with numpy) for float32,
bfloat16 and int8 moments: parameters and fp32 moments within 1e-6, bf16
moments and int8 payloads bitwise, int8 scales within 1e-6.  Both
``torch.round`` and ``jnp.round`` round half to even.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.schedule import constant as jax_constant
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch.optim.adamw import (AdamWConfig, _q_dec, _q_enc, adamw_init,
                                     adamw_update)
from repro_torch.optim.schedule import constant, warmup_cosine


# ------------------------------------------------- the cases of test_optim.py
@pytest.mark.parametrize("sd", ["float32", "bfloat16", "int8"])
def test_adamw_converges_quadratic(sd):
    cfg = AdamWConfig(lr=0.1, state_dtype=sd, weight_decay=0.0)
    params = {"w": torch.tensor([[3.0, -2.0, 1.5]] * 5),
              "b": torch.tensor(4.0)}
    state = adamw_init(params, cfg)
    for _ in range(250):
        g = {k: 2 * w for k, w in params.items()}
        adamw_update(g, state, params, cfg, 0.05)
    assert float(params["w"].abs().max()) < 0.06
    assert abs(float(params["b"])) < 0.06


def test_grad_clip_reported():
    cfg = AdamWConfig(lr=0.1, grad_clip=1.0)
    params = {"w": torch.ones(4)}
    state = adamw_init(params, cfg)
    _, _, m = adamw_update({"w": torch.full((4,), 100.0)}, state, params,
                           cfg, 0.1)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_quantizer_roundtrip_bound(rng):
    x = torch.from_numpy((rng.standard_normal((7, 300)) * 5).astype(
        np.float32))
    err = (_q_dec(_q_enc(x), x.shape) - x).abs()
    bound = float(x.abs().max()) / 127.0 + 1e-6
    assert float(err.max()) <= bound * 1.01


def test_quantizer_preserves_shape(rng):
    for shape in [(5,), (3, 4), (2, 3, 257), ()]:
        x = torch.from_numpy(np.asarray(rng.standard_normal(shape),
                                        np.float32))
        enc = _q_enc(x)
        if shape:
            assert enc["q"].shape == shape
        dec = _q_dec(enc, shape if shape else (1,))
        assert dec.shape == (shape if shape else (1,))


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in range(100)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0)
    assert lrs[5] < lrs[9]  # warming up
    assert lrs[99] < lrs[50]  # decaying
    assert lrs[99] >= 0.1  # min ratio floor


# ----------------------------------------------------- against the reference
def test_schedules_equal_the_reference():
    for s in range(61):
        kw = dict(peak_lr=3e-4, warmup_steps=8, total_steps=50)
        assert float(warmup_cosine(s, **kw)) == float(
            jax_warmup_cosine(s, **kw)), s
        assert float(constant(s, peak_lr=1e-3)) == float(
            jax_constant(s, peak_lr=1e-3))


SHAPES = {"w": (5, 300), "b": (7,), "t": (2, 3, 257)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.int16)
    return x


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("sd", ["float32", "bfloat16", "int8"])
def test_adamw_updates_equal_the_reference(rng, sd, steps):
    """Gradients with a global norm below the clip (the clip is 1 exactly
    on both sides), so every step is elementwise float32 arithmetic in the
    same order."""
    p0 = _tree(rng)
    grads = [_tree(rng, 0.01) for _ in range(steps)]
    jcfg = JaxAdamWConfig(state_dtype=sd)
    tcfg = AdamWConfig(state_dtype=sd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jax_adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = adamw_init(tp, tcfg)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js, jm = jax_adamw_update({k: jnp.asarray(v) for k, v in
                                       g.items()}, js, jp, jcfg,
                                      jnp.float32(lr))
        _, _, tm = adamw_update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts, tp, tcfg, lr)
        assert float(tm["grad_norm"]) < 1.0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == steps
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        for m in ("m", "v"):
            got, want = ts["mu_nu"][k][m], js["mu_nu"][k][m]
            if sd == "int8":
                np.testing.assert_array_equal(got["q"].numpy(),
                                              np.asarray(want["q"]))
                np.testing.assert_allclose(got["scale"].numpy(),
                                           np.asarray(want["scale"]),
                                           rtol=1e-6, atol=0)
            elif sd == "bfloat16":
                np.testing.assert_array_equal(_np(got), _np(want))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-12)


def test_clip_and_grad_norm_equal_the_reference(rng):
    """A global norm far above the clip: the same norm and the same
    clipped update."""
    p0, g = _tree(rng), _tree(rng, 10.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jp, _, jm = jax_adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                 jax_adamw_init(jp, JaxAdamWConfig()), jp,
                                 JaxAdamWConfig(), jnp.float32(1e-2))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    _, _, tm = adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                            adamw_init(tp, AdamWConfig()), tp, AdamWConfig(),
                            1e-2)
    assert float(jm["grad_norm"]) > 100.0
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_int8_quantizer_equals_the_reference(rng):
    from repro.optim.adamw import _q_dec as jax_q_dec
    from repro.optim.adamw import _q_enc as jax_q_enc
    for shape in [(7, 300), (3, 257), (5,)]:
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        got, want = _q_enc(torch.from_numpy(x)), jax_q_enc(jnp.asarray(x))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))
        np.testing.assert_array_equal(
            _q_dec(got, shape).numpy(),
            np.asarray(jax_q_dec(jax.tree.map(jnp.asarray, want), shape)))


@pytest.mark.parametrize("sd", ["float32", "bfloat16", "int8"])
def test_sliced_update_is_the_whole_update_bitwise(rng, monkeypatch, sd):
    """A parameter over ``UPDATE_SLICE`` elements is updated a slice of its
    leading axis at a time (the MoE experts' weights, the largest models'
    embeddings): parameters and moments (int8: payload and scales) are
    bitwise those of the update in one piece."""
    from repro_torch.optim import adamw
    shapes = {"experts": (6, 5, 7), "vec": (9,), "gate": ()}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(3)]
    cfg = AdamWConfig(state_dtype=sd)
    out = []
    for limit in (adamw.UPDATE_SLICE, 40):          # whole, slices of 1
        monkeypatch.setattr(adamw, "UPDATE_SLICE", limit)
        p = {k: v.clone() for k, v in params.items()}
        st = adamw_init(p, cfg)
        for g in grads:
            adamw_update(g, st, p, cfg, 1e-2)
        out.append((p, st))
    (p0, s0), (p1, s1) = out
    for k in shapes:
        assert torch.equal(p0[k], p1[k]), k
        for m in ("m", "v"):
            a, b = s0["mu_nu"][k][m], s1["mu_nu"][k][m]
            if sd == "int8":
                assert torch.equal(a["q"], b["q"]), (k, m)
                assert torch.equal(a["scale"], b["scale"]), (k, m)
            else:
                assert torch.equal(a, b), (k, m)
    assert not torch.equal(p0["experts"], params["experts"])
