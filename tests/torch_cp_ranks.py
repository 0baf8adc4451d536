"""Rank bodies of ``tests/test_torch_attention_impls.py`` (a module of its
own, so that spawned ranks import it without the test file's JAX
imports)."""
import torch

from repro_torch.launch.op_analysis import analyze
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import Policy
from repro_torch.models.registry import build_model
from repro_torch.parallel.mesh import make_test_mesh


def cp_rank(ctx, cases: list, llama, state: dict, tokens):
    """Each case's ``context_parallel_attention`` on a (data 1, model 4)
    mesh; the reduced llama's logits with ``attn_impl="cp"``; and one CP
    call on meta tensors under the op analysis (its collectives)."""
    mesh = make_test_mesh(data=1, model=ctx.world_size)
    outs = []
    with torch.no_grad():
        for c in cases:
            q, k, v = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
            o = attn_lib.context_parallel_attention(
                q, k, v, mesh, causal=c["causal"], q_offset=c["q_offset"],
                q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
            outs.append(o.numpy())
        model = build_model(llama, Policy(torch.float32), "cpu", mesh=mesh,
                            attn_impl="cp")
        model.load_params(state)
        logits = model.apply(torch.from_numpy(tokens)).numpy()
    first = cases[0]
    q, k, v = (torch.empty(first[n].shape, device="meta")
               for n in ("q", "k", "v"))
    stats = analyze(attn_lib.context_parallel_attention, q, k, v, mesh,
                    causal=True)
    stats.pop("result")
    return {"outs": outs, "logits": logits, "meta": stats}
