"""Mamba2 (SSD) block: chunked parallel scan for train / prefill, an O(1)
recurrent state for decode — the twin of ``repro.models.mamba2``.

The full-sequence path is the SSD block decomposition: a within-chunk
quadratic term through the segment-sum decay mask, and a cross-chunk
term through a loop over chunk states — O(S * Q) work for chunks of Q.
Decode carries (ssm_state (B, H, P, N), conv_tail (B, d_conv - 1,
conv_dim)) and costs O(1) a token.

The reference's three multi-operand einsums are contracted here pairwise,
in an order whose largest intermediate is a (B, C, H, Q, Q) or
(B, C, Q, H, P) tensor, so no contraction path has to be searched for.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import resolve_device
from repro_torch.models.layers import ParamSpec, rmsnorm


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


def mamba2_spec(cfg: Mamba2Config) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    proj_out = 2 * di + 2 * n + h          # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.d_conv, cfg.conv_dim), (None, "mlp"),
                            scale=0.5),
        "conv_b": ParamSpec((cfg.conv_dim,), ("mlp",), init="zeros"),
        "a_log": ParamSpec((h,), (None,), init="zeros"),
        "d_skip": ParamSpec((h,), (None,), init="ones"),
        "dt_bias": ParamSpec((h,), (None,), init="zeros"),
        "norm": ParamSpec((di,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }


def _split_proj(cfg: Mamba2Config, proj):
    di = cfg.d_inner
    z = proj[..., :di]
    xbc = proj[..., di:di + cfg.conv_dim]
    dt = proj[..., di + cfg.conv_dim:]
    return z, xbc, dt


def _causal_conv(cfg: Mamba2Config, p, xbc):
    """Depthwise causal conv, width d_conv, over (B, S, conv_dim)."""
    w = p["conv_w"].to(xbc.dtype)                        # (K, C)
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, cfg.d_conv - 1, 0))
    y = sum(pad[:, i:i + s] * w[i] for i in range(cfg.d_conv))
    return F.silu(y + p["conv_b"].to(xbc.dtype))


def _segsum(a):
    """(..., Q) -> (..., Q, Q) lower-triangular cumulative sums
    ``sum a[j+1..i]``, -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def _conv_tail(cfg: Mamba2Config, xbc_raw):
    """The last d_conv - 1 pre-conv channel values (zeros before the
    first token): the decode conv state."""
    pad = F.pad(xbc_raw, (0, 0, cfg.d_conv - 1, 0))
    return pad[:, pad.shape[1] - (cfg.d_conv - 1):, :]


def mamba2_forward(p, cfg: Mamba2Config, x, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D); the SSD chunked algorithm.

    A length that is not a multiple of the chunk is right-padded; padded
    positions get dt = 0 (identity state transition, no contribution), so
    the outputs at valid positions AND the final state are exact.  With
    ``return_state`` also returns (final ssm state, conv tail)."""
    b, s0, _ = x.shape
    n, h, pd, q = cfg.d_state, cfg.n_heads, cfg.head_dim, cfg.chunk
    qq = min(q, s0)
    pad = (-s0) % qq
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    s = s0 + pad
    nc = s // qq
    ct = torch.promote_types(x.dtype, torch.float32)

    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc_raw, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(cfg, p, xbc_raw)
    xs = xbc[..., :cfg.d_inner].reshape(b, s, h, pd)
    bmat = xbc[..., cfg.d_inner:cfg.d_inner + n]          # (B, S, N)
    cmat = xbc[..., cfg.d_inner + n:]                     # (B, S, N)

    dt = F.softplus(dt.to(ct) + p["dt_bias"].to(ct))     # (B, S, H)
    if pad:
        valid = (torch.arange(s, device=x.device) < s0)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    a = -torch.exp(p["a_log"].to(ct))                    # (H,)
    la = dt * a                                          # log decay
    xdt = xs.to(ct) * dt[..., None]                      # dt-weighted x

    # chunked views
    xc = xdt.reshape(b, nc, qq, h, pd)
    bc = bmat.reshape(b, nc, qq, n).to(ct)
    cc = cmat.reshape(b, nc, qq, n).to(ct)
    lac = la.reshape(b, nc, qq, h)
    cum = torch.cumsum(lac, dim=2)                       # (B, C, Q, H)

    # within-chunk (quadratic in Q only)
    lmask = torch.exp(_segsum(lac.movedim(-1, -2)))      # (B, C, H, Q, Q)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)         # (B, C, Q, Q)
    ydiag = torch.einsum("bchqk,bckhp->bcqhp", cb[:, :, None] * lmask, xc)

    # chunk states + cross-chunk recurrence
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)    # (B, C, Q, H)
    states = torch.einsum("bckhp,bckn->bchpn", xc * decay_states[..., None],
                          bc)                            # (B, C, H, P, N)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B, C, H)
    st = x.new_zeros((b, h, pd, n), dtype=ct)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B, C, H, P, N)

    yoff = (torch.einsum("bcqn,bchpn->bcqhp", cc, prev_states)
            * torch.exp(cum)[..., None])
    y = (ydiag + yoff).reshape(b, s, h, pd)
    y = y + xs.to(ct) * p["d_skip"].to(ct)[:, None]
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)

    y = rmsnorm({"scale": p["norm"]}, y * F.silu(z))
    out = (y @ p["out_proj"].to(x.dtype))[:, :s0]
    if return_state:
        return out, (st, _conv_tail(cfg, xbc_raw[:, :s0]))
    return out


def xbc_tail(cfg: Mamba2Config, x, p):
    """Last d_conv - 1 pre-conv channel values of x (B, S, D): the
    decode conv state."""
    proj = x @ p["in_proj"].to(x.dtype)
    _, xbc, _ = _split_proj(cfg, proj)
    return _conv_tail(cfg, xbc)


def mamba2_init_state(cfg: Mamba2Config, batch: int, dtype=torch.float32,
                      device=None):
    """The zero decode state (ssm, conv_tail); ``device=None`` is the
    card, as everywhere in the port."""
    device = resolve_device(device)
    return (torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                        dtype=torch.promote_types(dtype, torch.float32),
                        device=device),
            torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim), dtype=dtype,
                        device=device))


def mamba2_decode(p, cfg: Mamba2Config, x, state):
    """One-token recurrent step. x: (B, 1, D); state: (ssm, conv_tail).
    Returns (y (B, 1, D), new state)."""
    ssm, conv_tail = state
    b = x.shape[0]
    n, h, pd = cfg.d_state, cfg.n_heads, cfg.head_dim
    ct = torch.promote_types(x.dtype, torch.float32)

    proj = x[:, 0] @ p["in_proj"].to(x.dtype)            # (B, proj)
    z, xbc, dt = _split_proj(cfg, proj)

    # conv over the carried tail
    win = torch.cat([conv_tail.to(x.dtype), xbc[:, None, :]], dim=1)
    w = p["conv_w"].to(x.dtype)                          # (K, C)
    conv = torch.einsum("bkc,kc->bc", win, w) + p["conv_b"].to(x.dtype)
    conv = F.silu(conv)
    new_tail = win[:, 1:]

    xs = conv[:, :cfg.d_inner].reshape(b, h, pd).to(ct)
    bvec = conv[:, cfg.d_inner:cfg.d_inner + n].to(ct)
    cvec = conv[:, cfg.d_inner + n:].to(ct)

    dt = F.softplus(dt.to(ct) + p["dt_bias"].to(ct))     # (B, H)
    a = -torch.exp(p["a_log"].to(ct))
    decay = torch.exp(dt * a)                            # (B, H)
    ssm = (ssm * decay[..., None, None]
           + (xs * dt[..., None])[..., None] * bvec[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", ssm, cvec)
    y = y + xs * p["d_skip"].to(ct)[:, None]
    y = y.reshape(b, cfg.d_inner).to(x.dtype)
    y = rmsnorm({"scale": p["norm"]}, y * F.silu(z))
    out = (y @ p["out_proj"].to(x.dtype))[:, None, :]
    return out, (ssm, new_tail)
