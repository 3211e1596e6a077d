"""ViT-family helpers — the part of ``mertools_tpu/encoders/vit.py`` that the
CLIP extractor uses: Token Merging (:func:`tome_merge`). The DINOv2 / BEiT /
VideoMAE / EVA encoders of that module are ROADMAP A9."""

from __future__ import annotations

import torch


def tome_merge(x: torch.Tensor, metric: torch.Tensor, sizes: torch.Tensor,
               r: int, n_protected: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ToMe bipartite soft matching (arXiv:2210.09461 §3): split tokens
    alternately into sets A/B, match each A token to its most similar B
    token (cosine on the attention-key metric), merge the r best-scoring A
    tokens into their matches by size-weighted mean. Fixed r -> static
    output shape (B, N - r, D). The first ``n_protected`` tokens (CLS) are
    never merged. Ties rank as ``jnp.argsort``'s stable order does, so
    identical tokens merge as in the JAX package."""
    B = x.shape[0]
    prot_x = x[:, :n_protected]
    xm = x[:, n_protected:]
    m = metric[:, n_protected:]
    sm = sizes[:, n_protected:]
    m = m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + 1e-6)
    a, b = m[:, ::2], m[:, 1::2]
    xa, xb = xm[:, ::2], xm[:, 1::2]
    sa, sb = sm[:, ::2], sm[:, 1::2]

    scores = torch.einsum("bad,bkd->bak", a, b)
    node_max = scores.amax(dim=-1)                    # (B, Na)
    node_idx = scores.argmax(dim=-1)                  # (B, Na) first max
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merge_src, keep_src = order[:, :r], order[:, r:]

    def take(t, idx):                                 # t[b, idx[b]]
        return torch.gather(t, 1, idx if t.dim() == 2 else
                            idx[..., None].expand(-1, -1, t.shape[-1]))

    sa_m = take(sa, merge_src)                        # (B, r)
    xa_m = take(xa, merge_src) * sa_m[..., None]
    # a row's destinations, offset into the flattened (B * Nb) set B
    Nb = xb.shape[1]
    dst = (take(node_idx, merge_src)
           + torch.arange(B, device=x.device)[:, None] * Nb).reshape(-1)
    num = (xb * sb[..., None]).reshape(B * Nb, -1).index_add(
        0, dst, xa_m.reshape(B * r, -1)).view(B, Nb, -1)
    den = sb.reshape(-1).index_add(0, dst, sa_m.reshape(-1)).view(B, Nb)
    out = torch.cat([prot_x, take(xa, keep_src), num / den[..., None]], dim=1)
    out_sizes = torch.cat([sizes[:, :n_protected], take(sa, keep_src), den],
                          dim=1)
    return out, out_sizes
