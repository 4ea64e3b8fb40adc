"""The model ops that run on each rank's local shards on a mesh.

The models are written for plain tensors.  On a mesh (``Trainer(mesh=
...)``, the dry run) their parameters, batch and activations are
DTensors, and most ops run through DTensor's own sharding rules.  The ops
here do not: DTensor has no rule for them (the MoE's sorts and index
scatters, the one-hot's scalar scatter), refuses the layout in some torch
releases (2.11 refuses to flatten a split that is not leading, a batch
split over ("pod", "data") in its index rule, a pad on a 2-D mesh), or
picks a strategy that computes a product whole on every rank (2.13 on a
3-D mesh, for the vocab projection's weight gradient).  Each runs on the
local shards with explicit layouts and collectives, as the reference's
``shard_map`` regions do.  The models call them in one place each; every
function is the plain op on a plain tensor.

Coverage: on the card only a 1 x 1 mesh has run, where every placement
replicates, so the splits these functions handle run only on the CPU
(``tests/test_torch_mesh_train.py``: 4 x 2 and 2 x 2 on gloo, against
the reference; ``tests/test_torch_dryrun.py``: the fake 4 x 2 mesh).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import contiguous_stride

__all__ = ["is_sharded", "shard_of", "split_on", "attention",
           "decode_attention", "ssd_scan", "ssd_readout", "split_matmul",
           "embed_lookup", "embed_grad", "pad", "like", "vocab_sharded",
           "whole_last_dim", "vocab_logits", "moe_ffn"]


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor (laid out on a mesh)."""
    return hasattr(t, "device_mesh")


def shard_of(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself otherwise)."""
    return getattr(t, "_local_tensor", t)


def split_on(w: torch.Tensor, dim: int) -> bool:
    """Whether a DTensor is split along ``dim`` (False for a tensor)."""
    return any(getattr(p, "dim", None) == dim
               for p in getattr(w, "placements", ()))


# ---------------------------------------------------------------- attention --
def _repeat_heads(x: torch.Tensor, rep: int, like_: torch.Tensor
                  ) -> torch.Tensor:
    """A DTensor x (B, S, KV, hd) with each head repeated ``rep`` times
    (GQA's repeat to full heads), gathered over its head and head_dim
    shards first and laid out as ``like_`` (the queries) after: DTensor
    cannot split a heads-sharded gradient back into (KV, rep), so the
    repeat's backward must see whole heads."""
    from torch.distributed.tensor import Replicate, Shard
    keep = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
            for p in x.placements]
    y = x.redistribute(x.device_mesh, keep).repeat_interleave(rep, dim=2)
    return y.redistribute(y.device_mesh, like_.placements)


def attention(fn: Callable, q, k, v, **kw) -> torch.Tensor:
    """``fn`` (``models.attention.chunked_attention``) of DTensors on each
    rank's own (batch, head) pairs: attention is independent across them,
    so q, k and v are laid out by batch and heads alone (sequence and
    head_dim whole; k and v repeated to the full heads first), ``fn`` runs
    on the shards, and its output keeps that layout.  DTensor's rules
    would otherwise flatten the sharded heads into the batch of its
    products, which they refuse."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in q.placements]
    q = q.redistribute(mesh, pl)
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k, v = _repeat_heads(k, rep, q), _repeat_heads(v, rep, q)
    k, v = k.redistribute(mesh, pl), v.redistribute(mesh, pl)
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def decode_attention(plain: Callable, q, k_cache, v_cache, valid: int, *,
                     pos: Optional[int] = None, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """One-token attention of DTensors (``models.attention``'s
    ``decode_attention``, with ``pos``, or ``_ring_decode_attn``) on each
    rank's own shards of the cache, whose first ``valid`` slots are read.
    q (B, 1, H, hd) is laid out as the cache (B, S, KV, hd) is split: by
    batch, and by heads where the cache splits its kv heads (a rank's q
    heads are then its kv heads' groups), whole elsewhere.  Where no mesh
    dim splits the cache's sequence, ``plain(q, k, v)`` runs on the local
    shards; where one does, each rank attends its own slots and the
    softmax is combined over the sequence's mesh dims (the running max,
    then the rescaled sums and outputs, in float32).  The output keeps q's
    layout.  DTensor would otherwise take q's heads split into the
    (KV, G) view, which some torch releases (2.11) refuse."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = k_cache.device_mesh
    kv_pl = list(k_cache.placements)
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else
          Shard(2) if isinstance(p, Shard) and p.dim == 2 else Replicate()
          for p in kv_pl]
    seq_dims = [i for i, p in enumerate(kv_pl)
                if isinstance(p, Shard) and p.dim == 1]
    v_cache = v_cache.redistribute(mesh, kv_pl)
    q_loc = q.redistribute(mesh, pl).to_local()
    k_loc, v_loc = k_cache.to_local(), v_cache.to_local()
    if not seq_dims:
        out = plain(q_loc, k_loc, v_loc)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    (_, slots, _, _), (_, lo, _, _) = compute_local_shape_and_global_offset(
        k_cache.shape, mesh, kv_pl)
    n = max(0, min(slots, valid - lo))
    b, _, h, hd = q_loc.shape
    kv = k_loc.shape[2]
    k_loc, v_loc = k_loc[:, :n], v_loc[:, :n]
    qg = q_loc.reshape(b, kv, h // kv, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_loc).float() / \
        math.sqrt(hd)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    if window and pos is not None:
        k_pos = lo + torch.arange(n, device=scores.device)
        scores = torch.where(pos - k_pos < window, scores, -1e30)
    m = scores.amax(dim=-1) if n else torch.full(
        scores.shape[:-1], -1e30, dtype=torch.float32, device=scores.device)

    def over_seq(t, op):
        red = [Partial(op) if i in seq_dims else Replicate()
               for i in range(len(kv_pl))]
        keep = [Replicate()] * len(kv_pl)
        return DTensor.from_local(t, mesh, red, run_check=False).redistribute(
            mesh, keep).to_local()
    m_all = over_seq(m, "max")
    prob = torch.exp(scores - m_all[..., None])
    total = over_seq(prob.sum(dim=-1), "sum")
    acc = over_seq(torch.einsum("bkgs,bskh->bkgh", prob, v_loc.float()),
                   "sum")
    out = (acc / total[..., None]).to(v_loc.dtype).reshape(b, 1, h, hd)
    return DTensor.from_local(out, mesh, pl, run_check=False)


# ---------------------------------------------------------------- embedding --
def embed_lookup(embed, tokens):
    """The lookup of DTensors, vocab-parallel, on the local shards: each
    rank gathers its own tokens' rows from its own rows of the table (a
    token outside them reads a zero row), and the rows are partial sums
    over the table's vocab split.  The output is batch-split as the
    tokens are.  Done by hand: DTensor's index rule refuses a batch split
    over two mesh dims (("pod", "data")) in some torch releases."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = tokens.device_mesh
    table, tok = embed.to_local(), tokens.to_local().long()
    (rows, d), (lo, _) = compute_local_shape_and_global_offset(
        embed.shape, mesh, embed.placements)
    split = [isinstance(p, Shard) and p.dim == 0 for p in embed.placements]
    if any(split):
        inside = (tok >= lo) & (tok < lo + rows)
        out = table[torch.where(inside, tok - lo, 0)] * \
            inside[..., None].to(table.dtype)
    else:
        out = table[tok]
    pl = [bp if isinstance(bp, Shard) else Partial() if vs else Replicate()
          for vs, bp in zip(split, tokens.placements)]
    shape = tuple(tokens.shape) + (embed.shape[1],)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=(shape[1] * shape[2], shape[2], 1))


def embed_grad(plain: Callable, tokens, g, vocab: int, placements,
               dtype: torch.dtype, grad_chunk: int):
    """``plain`` (``models.common.embed_grad``) of DTensors,
    vocab-parallel: the cotangent laid out as the tokens (batch-sharded),
    and each rank's float32 sum over its own tokens into its own rows of
    the table (``placements``: the table's; a token outside its rows adds
    a zero row), then summed over the batch's mesh dims into the table's
    layout and cast.  DTensor has no sharding rule for the one-hot's
    scalar scatter, so the sum is formed on the local shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = tokens.device_mesh
    d = g.shape[-1]
    g = g.redistribute(mesh, tokens.placements).to_local()
    tok = tokens.to_local().long()
    (rows, _), (lo, _) = compute_local_shape_and_global_offset(
        (vocab, d), mesh, placements)
    inside = (tok >= lo) & (tok < lo + rows)
    local = plain(torch.where(inside, tok - lo, 0),
                  g * inside[..., None].to(g.dtype), rows, torch.float32,
                  grad_chunk)
    pl = [tp if isinstance(tp, Shard) and tp.dim == 0 else
          Partial() if isinstance(bp, Shard) else Replicate()
          for tp, bp in zip(placements, tokens.placements)]
    whole = DTensor.from_local(local, mesh, pl, run_check=False,
                               shape=torch.Size((vocab, d)), stride=(d, 1))
    return whole.redistribute(mesh, placements).to(dtype)


# ------------------------------------------------------------- layout glue --
def pad(x: torch.Tensor, widths: Sequence[int],
        value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, widths, value=value)``.  A DTensor is padded shard by
    shard, each padded dim gathered whole first: DTensor's rule for the
    pad gives a wrong layout on a mesh of more than one dim in some torch
    releases (2.11's)."""
    if not is_sharded(x):
        return F.pad(x, widths, value=value)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    padded = {x.ndim - 1 - i for i in range(len(widths) // 2)
              if widths[2 * i] or widths[2 * i + 1]}
    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.ndim in padded
          else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(F.pad(x.to_local(), widths, value=value),
                              x.device_mesh, pl, run_check=False)


def like(y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """y in h's layout when both are DTensors and h holds no pending sum
    (as is otherwise): a block's output redistributed to the residual
    stream's before the add, so that the backward hands the block's
    products gradients in their own layout (DTensor refuses to flatten a
    sequence-split gradient into a product's rows in some torch
    releases)."""
    if is_sharded(y) and is_sharded(h) and \
            tuple(y.placements) != tuple(h.placements) and \
            not any(p.is_partial() for p in h.placements):
        return y.redistribute(h.device_mesh, h.placements)
    return y


# ----------------------------------------------------- vocab-parallel loss --
def vocab_sharded(t: torch.Tensor) -> bool:
    """Whether a DTensor's last dim is split over a mesh dim of size > 1."""
    placements = getattr(t, "placements", ())
    return any(getattr(p, "dim", None) in (t.ndim - 1, -1) and
               t.device_mesh.size(i) > 1 for i, p in enumerate(placements))


def whole_last_dim(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums along its last dim reduced and any shard
    of that dim gathered (shards of the other dims stay); anything but a
    DTensor as it is."""
    if not is_sharded(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    last = t.ndim - 1
    pl = [p if isinstance(p, Shard) and p.dim not in (last, -1)
          else Replicate() for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(
        t.device_mesh, pl)


class _VocabLogits(torch.autograd.Function):
    """h (B, C, d) @ head (d, V), head split along V: each rank's own
    (batch rows, vocab columns) block, forward and backward, on the local
    shards.  The weight's gradient is each rank's h^T g over its own rows
    and columns, summed over the batch's mesh dims: DTensor's rule for
    that product computes it over the whole vocab on every rank of the
    vocab's split on a 3-D mesh in some torch releases (2.13's)."""

    @staticmethod
    def forward(ctx, h, head):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = h.device_mesh
        rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in h.placements]
        cols = [p if isinstance(p, Shard) and p.dim == 1 else Replicate()
                for p in head.placements]
        h_loc = h.redistribute(mesh, rows).to_local()
        w_loc = head.redistribute(mesh, cols).to_local()
        ctx.save_for_backward(h_loc, w_loc)
        ctx.layout = (mesh, rows, cols, tuple(h.placements),
                      tuple(head.placements), h.shape, head.shape)
        out = [Shard(2) if isinstance(c, Shard) else r
               for r, c in zip(rows, cols)]
        shape = (*h.shape[:-1], head.shape[1])
        ctx.out = out
        return DTensor.from_local(h_loc @ w_loc, mesh, out, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=(shape[1] * shape[2], shape[2], 1))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Shard
        h_loc, w_loc = ctx.saved_tensors
        mesh, rows, cols, h_pl, w_pl, h_shape, w_shape = ctx.layout
        g_loc = g.redistribute(mesh, ctx.out).to_local()
        # dh: partial over the vocab's split; dW: partial over the batch's
        dh_pl = [Partial() if isinstance(c, Shard) else r
                 for r, c in zip(rows, cols)]
        dw_pl = [Partial() if isinstance(r, Shard) else c
                 for r, c in zip(rows, cols)]
        dh = DTensor.from_local(g_loc @ w_loc.T, mesh, dh_pl,
                                run_check=False, shape=h_shape,
                                stride=(h_shape[1] * h_shape[2],
                                        h_shape[2], 1))
        dw = DTensor.from_local(
            h_loc.flatten(0, 1).T @ g_loc.flatten(0, 1), mesh, dw_pl,
            run_check=False, shape=w_shape, stride=(w_shape[1], 1))
        return dh.redistribute(mesh, h_pl), dw.redistribute(mesh, w_pl)


def vocab_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """h @ head, on the local shards where both are DTensors and the head
    is split along the vocab (``_VocabLogits``); the plain product
    otherwise."""
    if is_sharded(h) and vocab_sharded(head):
        return _VocabLogits.apply(h, head)
    return h @ head


# ------------------------------------------------- row-parallel product --
class _SplitMatmul(torch.autograd.Function):
    """x (..., K) @ w (K, N) with K split the same way on both (x's last
    dim and w's first over the same mesh dims): each rank's product of its
    own shards, the partial sums reduce-scattered onto N over those mesh
    dims (gathered where N does not divide); the backward on the local
    shards too (dx from the gathered gradient, dw summed over x's other
    splits).  DTensor's own rule for this product fails on some torch
    releases (2.11: "redistribute from S(0) to P(sum)") for the RG-LRU's
    gates."""

    @staticmethod
    def forward(ctx, x, w):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        mesh = x.device_mesh
        last = x.ndim - 1
        split = [isinstance(p, Shard) and p.dim == last
                 for p in x.placements]
        w_pl = [Shard(0) if k else Replicate() for k in split]
        x_loc = x.to_local()
        w_loc = w.redistribute(mesh, w_pl).to_local()
        out_pl = [(Shard(last) if w.shape[1] % mesh.size(i) == 0
                   else Replicate()) if k else p
                  for i, (k, p) in enumerate(zip(split, x.placements))]
        ctx.save_for_backward(x_loc, w_loc)
        ctx.layout = (mesh, split, tuple(x.placements),
                      tuple(w.placements), w_pl, out_pl, x.shape, w.shape)
        y = DTensor.from_local(
            x_loc @ w_loc, mesh,
            [Partial() if k else p for k, p in zip(split, x.placements)],
            run_check=False, shape=torch.Size((*x.shape[:-1], w.shape[1])),
            stride=contiguous_stride((*x.shape[:-1], w.shape[1])))
        return y.redistribute(mesh, out_pl)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        x_loc, w_loc = ctx.saved_tensors
        mesh, split, x_pl, w_orig, w_pl, out_pl, x_shape, w_shape = \
            ctx.layout
        g_loc = g.redistribute(mesh, [Replicate() if k else p for k, p in
                                      zip(split, out_pl)]).to_local()
        dx = DTensor.from_local(g_loc @ w_loc.T, mesh, list(x_pl),
                                run_check=False, shape=x_shape,
                                stride=contiguous_stride(x_shape))
        dw_pl = [Shard(0) if k else Partial() if isinstance(p, Shard)
                 else Replicate() for k, p in zip(split, x_pl)]
        dw = DTensor.from_local(
            x_loc.flatten(0, -2).T @ g_loc.flatten(0, -2), mesh, dw_pl,
            run_check=False, shape=w_shape, stride=contiguous_stride(w_shape))
        return dx, dw.redistribute(mesh, list(w_orig))


def split_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w; on the local shards (``_SplitMatmul``) where both are
    DTensors and x's last dim is split over some mesh dim."""
    if is_sharded(x) and is_sharded(w) and split_on(x, x.ndim - 1):
        return _SplitMatmul.apply(x, w)
    return x @ w


# ---------------------------------------------------------------------- SSD --
def ssd_scan(plain: Callable, xh, dt, a, b_mat, c_mat, d_skip, q: int,
             valid: Optional[int] = None):
    """``plain`` (``models.ssd._chunked_scan``) of DTensors on each rank's
    own (batch, head) shards: the scan is independent across batch rows
    and heads, so xh (B,S,H,P) and dt (B,S,H) are laid out by batch (as
    xh is split) and by heads over "model" where they divide, a and
    d_skip (H,) by the same heads, b_mat and c_mat (B,S,N) by batch alone,
    and ``plain`` runs on the shards -> (y (B,S,H,P) in xh's layout, the
    final state (B,H,P,N) split as y by batch and heads).
    DTensor's own rules would flatten the batch split over ("pod",
    "data") into the scan's products as a strided shard, whose layout
    they take minutes of host time to plan."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = xh.device_mesh
    names = mesh.mesh_dim_names
    heads = xh.shape[2]
    batch = [isinstance(p, Shard) and p.dim == 0 for p in xh.placements]
    split = [names[i] == "model" and not batch[i] and
             heads % mesh.size(i) == 0 for i in range(mesh.ndim)]

    def local(t, head_dim):
        pl = [Shard(0) if batch[i] else
              Shard(head_dim) if head_dim is not None and split[i] else
              Replicate() for i in range(mesh.ndim)]
        return t.redistribute(mesh, pl).to_local(), pl
    xh_loc, pl = local(xh, 2)
    y, last = plain(xh_loc, local(dt, 2)[0],
                    _head_shard(a, mesh, split), local(b_mat, None)[0],
                    local(c_mat, None)[0], _head_shard(d_skip, mesh, split),
                    q, valid)
    state_pl = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
                for p in pl]
    return (DTensor.from_local(y, mesh, pl, run_check=False),
            DTensor.from_local(last, mesh, state_pl, run_check=False))


def ssd_readout(ssm, c):
    """einsum('bhpn,bn->bhp', ssm, c) of DTensors (the SSD decode step's
    readout) on the local shards: the state (B, H, P, N) keeps its layout
    (``sharding.cache_shardings`` never splits N), c (B, N) is laid out by
    the state's batch split and whole elsewhere.  Some torch releases
    (2.11) refuse to flatten the state's split P into the product's
    rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ssm.device_mesh
    c_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in ssm.placements]
    y = torch.einsum("bhpn,bn->bhp", ssm.to_local(),
                     c.redistribute(mesh, c_pl).to_local())
    return DTensor.from_local(y, mesh, list(ssm.placements), run_check=False,
                              shape=ssm.shape[:3],
                              stride=contiguous_stride(ssm.shape[:3]))


def _head_shard(t, mesh, split):
    """A (H,) DTensor's shard split over the mesh dims ``split`` marks."""
    from torch.distributed.tensor import Replicate, Shard
    return t.redistribute(mesh, [Shard(0) if s else Replicate()
                                 for s in split]).to_local()


# ---------------------------------------------------------------------- MoE --
def moe_ffn(body: Callable, experts: Callable, x, router
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``body(x, router, experts)`` (``models.moe``'s routing, dispatch
    and combine on plain tensors -> (y, probs, counts)) of a DTensor x:
    DTensor has no sharding rule for the routing's sorts and index
    scatters, so ``body`` runs on each rank's own batch rows (x gathered
    over any other shard, the small router whole); ``experts`` (the
    expert products) runs on DTensors, the buffer's rows split as the
    batch, against the expert weights' layout.  y, probs and counts come
    back as DTensors split by batch, so the aux loss's batch means are
    taken over the mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    batch = [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
             for q in x.placements]
    rows_pl = [Shard(1) if isinstance(q, Shard) else q for q in batch]

    def sharded_experts(xe):
        ye = experts(DTensor.from_local(xe, mesh, rows_pl, run_check=False))
        return ye.redistribute(mesh, rows_pl).to_local()
    y, probs, counts = body(x.redistribute(mesh, batch).to_local(),
                            router.full_tensor(), sharded_experts)
    return tuple(DTensor.from_local(t, mesh, batch, run_check=False)
                 for t in (y, probs, counts))
