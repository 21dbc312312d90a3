"""Mixture-of-Experts: routing and the grouped expert product
(counterpart of aphrodite_tpu/ops/moe.py, without its expert-parallel
mesh branch).

Routing: ``topk_routing`` (softmax then top-k, optionally renormalized,
or top-k then softmax) and ``sparsemixer_routing`` (PhiMoE's iterated
masked argmax), both on f32 router logits.

The grouped expert product is the JAX package's arithmetic: gate and up
with f32 sums, ``silu(gate) * up`` in f32 rounded to the model dtype,
down with f32 sums, each row times its routing weight in f32, the k
contributions of a token summed in f32 and cast to the model dtype. The
JAX package computes it with ``jax.lax.ragged_dot`` (XLA's grouped
matmul, no Pallas kernel); here it is plain PyTorch in two forms of one
function, picked by the step's static shape (``capacity_form``):

- capacity form (every decode window, and any step of at most
  ``CAPACITY_MAX_T`` tokens): a token meets each expert at most once, so
  an [E, T, H] buffer holds every routed row at [expert_ids[t, j], t];
  one batched product per projection, the results gathered back by the
  same indices. It reads no host value, so a decode window's CUDA graph
  captures it. It computes E * T rows for T * k routed ones.
- loop form (eager steps above ``CAPACITY_MAX_T`` tokens): the (token,
  expert) pairs stably sorted by expert, the group sizes read on the host
  once per layer, one product per expert that has rows. It computes the
  routed rows only.

Expert weights are stacked [E, H, F] (gate ``w1``, up ``w3``) and
[E, F, H] (down ``w2``), as in the JAX package. An experts_int8
container {q int8, scale f32[E, 1, N]} is dequantized one layer at a
time (``materialize_experts``).
"""

from typing import Any, Dict, Tuple, Union

import torch

# Steps of at most this many tokens take the capacity form (the decode
# windows take it at any size).
CAPACITY_MAX_T = 64

Experts = Union[torch.Tensor, Dict[str, Any]]


def topk_routing(router_logits: torch.Tensor, top_k: int,
                 renormalize: bool = True, pre_softmax: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights f32[T, k], expert_ids i32[T, k]) from router logits
    [T, E]. pre_softmax: softmax over all experts, then the top k,
    renormalized to sum 1 if ``renormalize`` (Mixtral); else the top k
    logits, then a softmax over those k (GraniteMoE)."""
    logits = router_logits.float()
    if not pre_softmax:
        top, ids = torch.topk(logits, top_k, dim=-1)
        return torch.softmax(top, dim=-1), ids.to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)
    if renormalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, ids.to(torch.int32)


def sparsemixer_routing(router_logits: torch.Tensor,
                        jitter_eps: float = 0.01
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PhiMoE's inference-mode sparsemixer: two rounds of a masked argmax;
    each pick's weight is its softmax probability over the experts whose
    score lies within 2 * jitter_eps of the round's maximum (relative to
    max(|score|, maximum)). The two weights are not renormalized."""
    s = router_logits.float()

    def pick(masked):
        m = masked.amax(dim=-1, keepdim=True)
        factor = torch.maximum(s.abs(), m)
        drop = ((m - s) / factor) > (2 * jitter_eps)
        gates = masked.masked_fill(drop, float("-inf"))
        sel = masked.argmax(dim=-1)
        w = torch.softmax(gates, dim=-1).gather(-1, sel[:, None])[:, 0]
        return w, sel

    w1, e1 = pick(s)
    w2, e2 = pick(s.scatter(-1, e1[:, None], float("-inf")))
    return (torch.stack([w1, w2], dim=-1),
            torch.stack([e1, e2], dim=-1).to(torch.int32))


def materialize_experts(w: Experts, dtype: torch.dtype) -> torch.Tensor:
    """The dense expert stack of one layer: an experts_int8 container
    dequantized as (q * scale) in f32, rounded to ``dtype``; a tensor as
    it is."""
    if isinstance(w, dict):
        return (w["q"] * w["scale"]).to(dtype)
    return w


def capacity_form(num_tokens: int, decode: bool) -> bool:
    """Whether a step takes the capacity form: every pure-decode step (the
    decode windows, whose graphs cannot read a host value), and any step
    of at most CAPACITY_MAX_T tokens."""
    return decode or num_tokens <= CAPACITY_MAX_T


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D or batched 3-D) with f32 sums into an f32 result. On the
    CPU, which has no mixed-dtype product, both operands are upcast first:
    a product of two bf16 values is exact in f32, so the sums are the
    same."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _gate_up(x: torch.Tensor, w1: torch.Tensor,
             w3: torch.Tensor) -> torch.Tensor:
    """silu(x @ w1) * (x @ w3) in f32, rounded to x's dtype."""
    gate, up = _matmul_f32(x, w1), _matmul_f32(x, w3)
    return (torch.nn.functional.silu(gate) * up).to(x.dtype)


def capacity_expert_mlp(x: torch.Tensor, w1: torch.Tensor,
                        w3: torch.Tensor, w2: torch.Tensor,
                        weights: torch.Tensor,
                        expert_ids: torch.Tensor) -> torch.Tensor:
    """The capacity form (see the module docstring): x [T, H], w1 and w3
    [E, H, F], w2 [E, F, H], weights f32[T, k], expert_ids [T, k] -> [T, H]
    in x's dtype."""
    T, H = x.shape
    E, k = w1.shape[0], expert_ids.shape[1]
    ids = expert_ids.long()
    tokens = torch.arange(T, device=x.device)[:, None].expand(T, k)
    routed = x.new_zeros((E, T, H))
    routed[ids, tokens] = x[:, None, :].expand(T, k, H)
    out = _matmul_f32(_gate_up(routed, w1, w3), w2)  # [E, T, H] f32
    rows = out[ids, tokens] * weights[..., None]  # [T, k, H]
    return rows.sum(dim=1).to(x.dtype)


def loop_expert_mlp(x: torch.Tensor, w1: torch.Tensor,
                    w3: torch.Tensor, w2: torch.Tensor,
                    weights: torch.Tensor,
                    expert_ids: torch.Tensor) -> torch.Tensor:
    """The loop form (see the module docstring), with capacity_expert_mlp's
    arguments and result. Reads the group sizes on the host."""
    T, H = x.shape
    E, k = w1.shape[0], expert_ids.shape[1]
    flat = expert_ids.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    # bincount on a card reads its maximum back to the host; a scatter of
    # ones does not.
    sizes = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat)).tolist()
    xs = x[order // k]
    out = torch.empty((T * k, H), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(sizes):
        if not n:
            continue
        rows = xs[start:start + n]
        act = _gate_up(rows, w1[e], w3[e])
        out[start:start + n] = _matmul_f32(act, w2[e])
        start += n
    # Back to token-major order, so the k contributions of each token are
    # summed in a fixed order, as in the capacity form.
    by_token = torch.empty_like(out)
    by_token[order] = out
    rows = by_token.view(T, k, H) * weights[..., None]
    return rows.sum(dim=1).to(x.dtype)


def plain_expert_mlp(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                     w2: torch.Tensor, weights: torch.Tensor,
                     expert_ids: torch.Tensor) -> torch.Tensor:
    """The plain version both forms are held against on the card: each
    token through each of its k experts, in f32 (gate, up, silu(gate) * up
    rounded to x's dtype as the function defines it, down, times its
    weight), the k summed: [T, H] f32, not rounded."""
    xf = x.float()
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in expert_ids.unique().tolist():
        t, j = (expert_ids == e).nonzero(as_tuple=True)
        h = xf[t]
        act = (torch.nn.functional.silu(h @ w1[e].float())
               * (h @ w3[e].float())).to(x.dtype).float()
        out.index_add_(0, t, (act @ w2[e].float()) * weights[t, j, None])
    return out


def grouped_expert_mlp(x: torch.Tensor, w1: torch.Tensor,
                       w3: torch.Tensor, w2: torch.Tensor,
                       weights: torch.Tensor, expert_ids: torch.Tensor,
                       decode: bool = False) -> torch.Tensor:
    """SwiGLU experts over the top-k routed tokens: the capacity form for a
    pure-decode step (``decode``) or a step of at most CAPACITY_MAX_T
    tokens, else the loop form."""
    form = (capacity_expert_mlp if capacity_form(x.shape[0], decode)
            else loop_expert_mlp)
    return form(x, w1, w3, w2, weights, expert_ids)


def apply_experts(x: torch.Tensor, w1: Experts, w3: Experts,
                  w2: Experts, weights: torch.Tensor,
                  expert_ids: torch.Tensor,
                  decode: bool = False) -> torch.Tensor:
    """One layer's experts (dense, or experts_int8 containers dequantized
    here) applied to the routed tokens."""
    return grouped_expert_mlp(
        x, materialize_experts(w1, x.dtype), materialize_experts(w3, x.dtype),
        materialize_experts(w2, x.dtype), weights, expert_ids, decode)


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """x [T, H] @ router [H, E] with f32 sums into f32 logits, as
    jnp.dot(..., preferred_element_type=f32) in the JAX package."""
    return _matmul_f32(x, router)
