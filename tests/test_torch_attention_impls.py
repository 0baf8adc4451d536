"""The port's attention paths (``repro_torch/models/attention.py``) against
the JAX package's (CPU).

``chunked_attention`` (forward and its recompute backward),
``folded_causal_attention`` and the ``attention(impl=)`` dispatcher are
held to the JAX functions on inputs drawn with numpy from a seed, at the
JAX package's own tolerances (``tests/test_attention_impls.py``: 3e-4
forward, 3e-3 gradients), at B 2, S 256, H 4 over 2 KV heads, hd 16, fp32;
and at ``q_offset`` 128 with T 256 != S 128, non-causal, and at chunks that
do not divide S or T.  ``context_parallel_attention`` runs on 4 gloo ranks
on the CPU (``run_ranks``; bodies in ``tests/torch_cp_ranks.py``) against
the JAX ``chunked_attention`` whole (the JAX CP needs a JAX mesh), at S 512
(S/M = 128, a multiple of 16) and S 520 (S/M = 130: every rank computes
the whole).  The ``attn_impl`` plumbing: the reduced dense, vlm (one cross
layer above S·T = 2^22) and zamba2 forwards at each impl against the JAX
models at the same impl, within 3e-4 (fp32, the model tests' tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs import scale as jax_scale
from repro.models import attention as R
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_reduced, scale
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import attention as P
from repro_torch.models import transformer as T
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.layers import Policy
from repro_torch.models.registry import build_model
from torch_cp_ranks import cp_rank

FWD, GRAD = 3e-4, 3e-3


def _qkv(seed, B=2, S=256, T_=None, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    T_ = S if T_ is None else T_
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T_, KV, hd)).astype(np.float32),
            rng.standard_normal((B, T_, KV, hd)).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_folded_equals_the_reference(depth):
    q, k, v = _qkv(0)
    got = P.folded_causal_attention(*_t(q, k, v), depth=depth).numpy()
    want = R.folded_causal_attention(q, k, v, depth=depth)
    np.testing.assert_allclose(got, want, rtol=FWD, atol=FWD)
    np.testing.assert_allclose(got, R.direct_attention(q, k, v, True),
                               rtol=FWD, atol=FWD)


def test_folded_stops_where_the_reference_does():
    """An odd S (255) and an S below 256 after one split (S 384 -> 192)
    end the recursion as in the JAX function."""
    for S in (255, 384):
        q, k, v = _qkv(1, S=S)
        got = P.folded_causal_attention(*_t(q, k, v), depth=4).numpy()
        np.testing.assert_allclose(
            got, R.folded_causal_attention(q, k, v, depth=4), rtol=FWD,
            atol=FWD)


# (S, T, causal, q_offset, q_chunk, kv_chunk)
CHUNKED = [(256, 256, True, 0, 64, 64),
           (128, 256, True, 128, 64, 64),
           (128, 256, False, 0, 64, 128),
           (256, 256, False, 0, 100, 100),     # chunks that do not divide
           (256, 256, True, 0, 1024, 512)]     # one block, one chunk


@pytest.mark.parametrize("S, T_, causal, off, qc, kc", CHUNKED)
def test_chunked_and_its_gradients_match_the_reference(S, T_, causal, off,
                                                       qc, kc):
    q, k, v = _qkv(2, S=S, T_=T_)
    tq, tk, tv = _t(q, k, v, grad=True)
    o = P.chunked_attention(tq, tk, tv, causal, q_offset=off, q_chunk=qc,
                            kv_chunk=kc)

    def ref(a, b, c):
        return R.chunked_attention(a, b, c, causal, q_offset=off,
                                   q_chunk=qc, kv_chunk=kc)

    np.testing.assert_allclose(o.detach().numpy(), ref(q, k, v), rtol=FWD,
                               atol=FWD)
    torch.tanh(o).sum().backward()
    want = jax.grad(lambda a, b, c: jnp.sum(jnp.tanh(ref(a, b, c))),
                    argnums=(0, 1, 2))(q, k, v)
    for got, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), w, rtol=GRAD,
                                   atol=GRAD)


def test_chunked_takes_a_tensor_offset_and_keeps_o_and_lse_only():
    """``q_offset`` as a 0-d tensor (context parallelism passes one); the
    backward's residuals are q, k, v, qpos, o and lse: no [S, T] scores."""
    q, k, v = _qkv(3, S=128, T_=256)
    tq, tk, tv = _t(q, k, v, grad=True)
    o = P.chunked_attention(tq, tk, tv, True, q_offset=torch.tensor(128),
                            q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(
        o.detach().numpy(), R.chunked_attention(q, k, v, True, q_offset=128,
                                                q_chunk=64, kv_chunk=64),
        rtol=FWD, atol=FWD)
    saved = o.grad_fn.next_functions[0][0].saved_tensors
    assert sorted(tuple(t.shape) for t in saved) == sorted(
        [(2, 128, 2, 2, 16), (2, 256, 2, 16), (2, 256, 2, 16), (128,),
         (2, 128, 2, 2, 16), (2, 2, 2, 128)])


@pytest.mark.parametrize("impl", ["direct", "chunked", "folded", "cp"])
@pytest.mark.parametrize("causal", [True, False])
def test_dispatcher_follows_the_reference(impl, causal):
    q, k, v = _qkv(4)
    got = P.attention(*_t(q, k, v), causal=causal, impl=impl, q_chunk=64,
                      kv_chunk=64).numpy()
    want = R.attention(q, k, v, causal=causal, impl=impl, q_chunk=64,
                       kv_chunk=64)
    np.testing.assert_allclose(got, want, rtol=FWD, atol=FWD)


def test_auto_routes(monkeypatch):
    """``"auto"``: causal self-attention over the whole sequence takes the
    flash op (the declared difference); anything else the JAX rule, direct
    up to S·T = 2^20 and chunked above it."""
    taken = []
    monkeypatch.setattr(P, "flash_attention",
                        lambda *a, **kw: taken.append("flash"))
    monkeypatch.setattr(P, "direct_attention",
                        lambda *a, **kw: taken.append("direct"))
    monkeypatch.setattr(P, "chunked_attention",
                        lambda *a, **kw: taken.append("chunked"))
    for S, T_, causal, off in ((256, 256, True, 0), (256, 256, False, 0),
                               (128, 256, True, 128), (1024, 1025, False, 0),
                               (1024, 1024, False, 0)):
        q = torch.empty(1, S, 4, 16, device="meta")
        k = torch.empty(1, T_, 2, 16, device="meta")
        P.attention(q, k, k, causal=causal, q_offset=off)
    assert taken == ["flash", "direct", "direct", "chunked", "direct"]


def test_cross_layers_switch_above_2_22():
    assert T.cross_impl(1024, 4096) == "direct"
    assert T.cross_impl(1025, 4096) == "chunked"
    assert T.cross_impl(4096, 1600) == "chunked"     # the VLM at prompt 4096


# --------------------------------------------------------------------------- #
# context parallelism on 4 gloo ranks
# --------------------------------------------------------------------------- #
W = 4
# (S, causal, q_offset, q_chunk, kv_chunk): S/M 128 passes the 16-row rule;
# 520 / 4 = 130 does not, and every rank computes the whole
CP_CASES = [(512, True, 0, 1024, 512), (512, True, 64, 64, 128),
            (512, False, 0, 128, 256), (520, True, 0, 1024, 512)]


@pytest.fixture(scope="module")
def cp_run():
    cases = []
    for i, (S, causal, off, qc, kc) in enumerate(CP_CASES):
        q, k, v = _qkv(10 + i, B=2, S=S)
        cases.append(dict(q=q, k=k, v=v, causal=causal, q_offset=off,
                          q_chunk=qc, kv_chunk=kc))
    llama = get_reduced("llama3.2-1b")
    jm = jax_build_model(jax_get_reduced("llama3.2-1b"),
                         policy=JL.Policy(jnp.float32, jnp.float32),
                         attn_impl="chunked")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(5).integers(0, llama.vocab_size, (2, 64))
    ranks = run_ranks(cp_rank, W, cases, llama,
                      params_from_jax(jp), tokens, device="cpu",
                      timeout=240.0)
    want_logits = np.asarray(jm.apply(jp, jnp.asarray(tokens,
                                                      jnp.int32))[0])
    return cases, ranks, want_logits


@pytest.mark.parametrize("i", range(len(CP_CASES)))
def test_context_parallel_matches_chunked_whole(cp_run, i):
    cases, ranks, _ = cp_run
    c = cases[i]
    want = R.chunked_attention(c["q"], c["k"], c["v"], c["causal"],
                               c["q_offset"], q_chunk=c["q_chunk"],
                               kv_chunk=c["kv_chunk"])
    for r in ranks:
        np.testing.assert_allclose(r["outs"][i], want, rtol=FWD, atol=FWD)


def test_cp_model_forward_matches_the_reference(cp_run):
    """The reduced llama with ``attn_impl="cp"`` on (data 1, model 4): S 64
    gives each rank 16 rows; every rank's logits are the JAX model's."""
    _, ranks, want = cp_run
    for r in ranks:
        np.testing.assert_allclose(r["logits"], want, rtol=FWD, atol=FWD)


def test_cp_under_the_op_analysis_records_its_all_gather(cp_run):
    """On meta tensors a rank's CP call moves nothing and records one ring
    all-gather of the gathered rows over the 4-rank model subgroup."""
    cases, ranks, _ = cp_run
    B, S, H, hd = cases[0]["q"].shape
    rows = B * S * H * hd * 4
    for r in ranks:
        ag = r["meta"]["collectives"]["all-gather"]
        assert ag == {"count": 1, "result_bytes": rows,
                      "wire_bytes": rows * (W - 1) / W}


def test_cp_refuses_a_gradient_and_a_shape_only_mesh():
    from repro_torch.parallel.mesh import make_production_mesh
    q, k, v = _t(*_qkv(6, S=512))
    with pytest.raises(RuntimeError, match="shape-only"):
        P.context_parallel_attention(q, k, v, make_production_mesh())


# --------------------------------------------------------------------------- #
# the attn_impl plumbing, model by model
# --------------------------------------------------------------------------- #
IMPLS = ["auto", "direct", "chunked", "folded"]


def _models(arch, impl, **cut):
    ref = jax_get_reduced(arch)
    ours = get_reduced(arch)
    if cut:
        ref, ours = jax_scale(ref, **cut), scale(ours, **cut)
    jm = jax_build_model(ref, policy=JL.Policy(jnp.float32, jnp.float32),
                         attn_impl=impl)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if "cross" in jp:                       # open the cross layers' gates
        jp["cross"]["attn"]["gate"] = np.full_like(
            jp["cross"]["attn"]["gate"], 0.5)
        jp["cross"]["gate_mlp"] = np.full_like(jp["cross"]["gate_mlp"], -0.4)
    pm = build_model(ours, Policy(torch.float32), "cpu", attn_impl=impl)
    pm.load_params(params_from_jax(jp))
    return jm, jp, pm, ours


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch, S", [("llama3.2-1b", 256),
                                     ("zamba2-2.7b", 256)])
def test_model_forward_at_each_impl(arch, S, impl):
    jm, jp, pm, cfg = _models(arch, impl)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, S))
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens, jnp.int32))[0])
    with torch.no_grad():
        got = pm.apply(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD, atol=FWD)


@pytest.mark.parametrize("impl", ["auto", "chunked"])
def test_vlm_forward_above_2_22(impl, monkeypatch):
    """4096 vision tokens and S 1025: S·T above 2^22, so the cross layer
    takes ``chunked`` (seen by a spy), in both packages."""
    jm, jp, pm, cfg = _models("llama-3.2-vision-11b", impl,
                              vision_tokens=4096)
    S = 1025
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (1, S))
    vision = rng.standard_normal((1, 4096, cfg.vision_d)).astype(np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens, jnp.int32),
                               vision_embeds=jnp.asarray(vision))[0])
    seen = []
    real = P.chunked_attention
    monkeypatch.setattr(P, "chunked_attention", lambda q, k, *a, **kw: (
        seen.append((q.shape[1], k.shape[1])), real(q, k, *a, **kw))[1])
    with torch.no_grad():
        got = pm.apply(torch.from_numpy(tokens),
                       torch.from_numpy(vision)).numpy()
    assert (S, 4096) in seen
    np.testing.assert_allclose(got, want, rtol=FWD, atol=FWD)


def test_build_model_refuses_an_unknown_impl():
    with pytest.raises(ValueError, match="attn_impl"):
        build_model(get_reduced("llama3.2-1b"), device="meta",
                    attn_impl="ring")


def test_auto_keeps_the_flash_route_of_every_existing_path(monkeypatch):
    """The default stays ``"auto"``: a training forward of the reduced
    llama calls the flash op once a layer and nothing else."""
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(P, "flash_attention", lambda *a, **kw: (
        calls.append(1), real(*a, **kw))[1])
    monkeypatch.setattr(P, "chunked_attention", None)
    monkeypatch.setattr(P, "direct_attention", None)
    cfg = get_reduced("llama3.2-1b")
    m = build_model(cfg, Policy(torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    m.loss(torch.zeros(2, 32, dtype=torch.long),
           torch.zeros(2, 32, dtype=torch.long)).backward()
    assert len(calls) == cfg.num_layers
