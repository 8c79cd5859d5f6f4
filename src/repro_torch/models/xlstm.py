"""xLSTM blocks: mLSTM (matrix memory; chunked-parallel full sequence,
recurrent decode) and sLSTM (scalar memory; a recurrence over the
sequence with an exponential-gating stabiliser) — the twins of
``repro.models.xlstm``.

mLSTM's parallel form is gated linear attention with a matrix state
C_t = f_t C_{t-1} + i_t v_t k_t^T, normaliser n_t = f_t n_{t-1} + i_t k_t
and readout h_t = (C_t q_t) / max(|n_t . q_t|, 1).  The full-sequence
path uses the chunked block decomposition (like SSD) with log-space gate
stabilisation, with the reference's sentinels: -inf above the diagonal
of the segment sums, -1e30 for padding and the initial stabiliser, and
``exp(-m)`` of the joint stabiliser in the normaliser.  Decode carries
(C, n, m, conv_tail) per head: O(1) a token.  The prefill's state comes
from :func:`mlstm_replay_state`, as in the reference.

sLSTM is a Python loop over the sequence; the reference broadcasts its
recurrent matrices per sample only to shape its gradient's sharding, and
the plain ``bhk,hkj->bhj`` contraction computes the same values.

The xlstm-125m config has d_ff=0: the blocks carry their own
projections and no separate FFN follows.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import resolve_device
from repro_torch.models.layers import ParamSpec, rmsnorm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0
    d_conv: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int = 4

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_spec(cfg: MLSTMConfig) -> dict:
    d, di, h, hd = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.head_dim
    return {
        "up": ParamSpec((d, di), ("embed", "mlp")),
        "up_gate": ParamSpec((d, di), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.d_conv, di), (None, "mlp"), scale=0.5),
        "conv_b": ParamSpec((di,), ("mlp",), init="zeros"),
        "wq": ParamSpec((di, h, hd), ("mlp", "heads", "head_dim")),
        "wk": ParamSpec((di, h, hd), ("mlp", "heads", "head_dim")),
        "wv": ParamSpec((di, h, hd), ("mlp", "heads", "head_dim")),
        "w_i": ParamSpec((di, h), ("mlp", "heads"), scale=0.01),
        "b_i": ParamSpec((h,), ("heads",), init="zeros"),
        "w_f": ParamSpec((di, h), ("mlp", "heads"), scale=0.01),
        "b_f": ParamSpec((h,), ("heads",), init="ones"),
        "out_norm": ParamSpec((di,), ("mlp",), init="ones"),
        "down": ParamSpec((di, d), ("mlp", "embed")),
    }


def _mlstm_gates(p, conv):
    """Log input / forget gates from the conv branch. conv: (B, S, di) ->
    (li, lf), each (B, S, H), lf <= 0."""
    ct = torch.promote_types(conv.dtype, torch.float32)
    c = conv.to(ct)
    lf = F.logsigmoid(c @ p["w_f"].to(ct) + p["b_f"].to(ct))
    li = c @ p["w_i"].to(ct) + p["b_i"].to(ct)
    return li, lf


def _segsum(a):
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def mlstm_cell_chunked(q, k, v, li, lf, chunk: int):
    """Stabilised chunked mLSTM. q/k/v: (B, S, H, hd); li/lf: (B, S, H).

    Returns h: (B, S, H, hd) in float32 (float64 for float64 inputs).  A
    length that is not a multiple of the chunk is right-padded with
    li = -1e30 (no contribution) and lf = 0 (identity decay): the outputs
    at valid positions are exact."""
    b, s0, h, hd = q.shape
    qq = min(chunk, s0)
    pad = (-s0) % qq
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG_INF)
        lf = F.pad(lf, (0, 0, 0, pad))
    s = s0 + pad
    nc = s // qq
    scale = hd ** -0.5
    ct = torch.promote_types(li.dtype, torch.float32)

    qc = q.reshape(b, nc, qq, h, hd).to(ct) * scale
    kc = k.reshape(b, nc, qq, h, hd).to(ct)
    vc = v.reshape(b, nc, qq, h, hd).to(ct)
    lic = li.reshape(b, nc, qq, h)
    lfc = lf.reshape(b, nc, qq, h)
    cum = torch.cumsum(lfc, dim=2)                       # (B, C, Q, H)

    # within-chunk log gate weights: cum_f[t] - cum_f[s] + li[s], t >= s
    lw = (_segsum(lfc.movedim(-1, -2))                   # (B, C, H, Q, Q)
          + lic.movedim(-1, -2)[..., None, :])
    # max(dim).values: its gradient reaches the row's maximum alone, as
    # the reference's does (amax's would carry a NaN into the whole row)
    m_loc = torch.clamp_min(lw.max(dim=-1).values, NEG_INF)    # (B, C, H, Q)
    w_loc = torch.exp(lw - m_loc[..., None])             # (B, C, H, Q, Q)
    qk = torch.einsum("bcqhk,bcshk->bchqs", qc, kc)
    wqk = w_loc * qk
    num_loc = torch.einsum("bchqs,bcshk->bcqhk", wqk, vc)
    den_loc = wqk.sum(dim=-1)                            # (B, C, H, Q)

    # chunk summary state: sum_s exp(cum_end - cum_s + li_s - m_add) k v^T
    l_end = cum[:, :, -1:, :] - cum + lic                # (B, C, Q, H)
    m_add = l_end.max(dim=2).values                      # (B, C, H)
    kw = kc * torch.exp(l_end - m_add[:, :, None, :])[..., None]
    s_chunk = torch.einsum("bcqhk,bcqhv->bchkv", kw, vc)
    z_chunk = kw.sum(dim=2)                              # (B, C, H, hd)
    chunk_lf = cum[:, :, -1, :]                          # (B, C, H)

    # carry into each chunk: the state before it, then its update
    s_st = qc.new_zeros((b, h, hd, hd))
    z_st = qc.new_zeros((b, h, hd))
    m_st = torch.full((b, h), NEG_INF, dtype=ct, device=q.device)
    s_prev, z_prev, m_prev = [], [], []
    for c in range(nc):
        s_prev.append(s_st)
        z_prev.append(z_st)
        m_prev.append(m_st)
        m_new = torch.maximum(m_st + chunk_lf[:, c], m_add[:, c])
        scale_old = torch.exp(m_st + chunk_lf[:, c] - m_new)
        scale_add = torch.exp(m_add[:, c] - m_new)
        s_st = (s_st * scale_old[..., None, None]
                + s_chunk[:, c] * scale_add[..., None, None])
        z_st = z_st * scale_old[..., None] + z_chunk[:, c] * scale_add[..., None]
        m_st = m_new
    s_prev = torch.stack(s_prev, dim=1)                  # (B, C, H, hd, hd)
    z_prev = torch.stack(z_prev, dim=1)
    m_prev = torch.stack(m_prev, dim=1)                  # (B, C, H)

    # merge local + cross-chunk with a joint stabiliser
    l_cross = cum + m_prev[:, :, None, :]                # (B, C, Q, H)
    m_loc_t = m_loc.movedim(-1, -2)                      # (B, C, Q, H)
    m_tot = torch.maximum(m_loc_t, l_cross)
    a_loc = torch.exp(m_loc_t - m_tot)
    a_cross = torch.exp(l_cross - m_tot)
    num_cross = torch.einsum("bcqhk,bchkv->bcqhv", qc, s_prev)
    den_cross = torch.einsum("bcqhk,bchk->bcqh", qc, z_prev)
    num = num_loc * a_loc[..., None] + num_cross * a_cross[..., None]
    den = den_loc.movedim(2, 3) * a_loc + den_cross * a_cross
    # xLSTM normaliser: max(|n.q|, exp(-m)) in the stabilised form
    denom = torch.maximum(torch.abs(den), torch.exp(-m_tot))
    out = num / denom[..., None]
    return out.reshape(b, s, h, hd)[:, :s0]


def _mlstm_branches(p, cfg: MLSTMConfig, x):
    """(left, conv, conv's padded input) of the full-sequence mLSTM."""
    s = x.shape[1]
    left = x @ p["up"].to(x.dtype)                       # (B, S, di)
    pad = F.pad(left, (0, 0, cfg.d_conv - 1, 0))
    w = p["conv_w"].to(x.dtype)
    conv = sum(pad[:, i:i + s] * w[i] for i in range(cfg.d_conv))
    conv = F.silu(conv + p["conv_b"].to(x.dtype))
    return left, conv, pad


def mlstm_forward(p, cfg: MLSTMConfig, x, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D); with ``return_state`` also the decode
    state (C, n, m, conv_tail) of :func:`mlstm_replay_state`."""
    b, s, _ = x.shape
    left, conv, _ = _mlstm_branches(p, cfg, x)
    gate = F.silu(x @ p["up_gate"].to(x.dtype))
    q = torch.einsum("bsd,dhk->bshk", conv, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", conv, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", left, p["wv"].to(x.dtype))
    li, lf = _mlstm_gates(p, conv)
    hcell = mlstm_cell_chunked(q, k, v, li, lf, cfg.chunk)
    hcell = hcell.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = rmsnorm({"scale": p["out_norm"]}, hcell) * gate
    out = y @ p["down"].to(x.dtype)
    if return_state:
        return out, mlstm_replay_state(p, cfg, x)
    return out


def mlstm_init_state(cfg: MLSTMConfig, batch: int, dtype=torch.float32,
                     device=None):
    """The empty decode state (C, n, m, conv_tail), m at its sentinel;
    ``device=None`` is the card."""
    device = resolve_device(device)
    h, hd = cfg.n_heads, cfg.head_dim
    ct = torch.promote_types(dtype, torch.float32)
    return (torch.zeros((batch, h, hd, hd), dtype=ct, device=device),
            torch.zeros((batch, h, hd), dtype=ct, device=device),
            torch.full((batch, h), NEG_INF, dtype=ct, device=device),
            torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                        device=device))


def mlstm_replay_state(p, cfg: MLSTMConfig, x):
    """The recurrent state after a full-sequence pass over x (B, S, D),
    recomputed: (C (B, H, hd, hd), n (B, H, hd), m (B, H), conv_tail)."""
    b = x.shape[0]
    left, conv, pad = _mlstm_branches(p, cfg, x)
    ct = torch.promote_types(x.dtype, torch.float32)
    k = torch.einsum("bsd,dhk->bshk", conv, p["wk"].to(x.dtype)).to(ct)
    v = torch.einsum("bsd,dhk->bshk", left, p["wv"].to(x.dtype)).to(ct)
    li, lf = _mlstm_gates(p, conv)
    cum = torch.cumsum(lf, dim=1)
    l_end = cum[:, -1:, :] - cum + li                    # (B, S, H)
    m = l_end.max(dim=1).values                          # (B, H)
    kw = k * torch.exp(l_end - m[:, None, :])[..., None]
    c_state = torch.einsum("bshk,bshv->bhkv", kw, v)
    n_state = kw.sum(dim=1)
    if cfg.d_conv > 1:
        conv_tail = pad[:, pad.shape[1] - (cfg.d_conv - 1):, :]
    else:
        conv_tail = x.new_zeros((b, 0, cfg.d_inner))
    return (c_state, n_state, m, conv_tail)


def mlstm_decode(p, cfg: MLSTMConfig, x, state):
    """One-token recurrent mLSTM. x: (B, 1, D) -> (y (B, 1, D), state)."""
    c_st, n_st, m_st, conv_tail = state
    b = x.shape[0]
    hd = cfg.head_dim
    ct = torch.promote_types(x.dtype, torch.float32)
    left = x[:, 0] @ p["up"].to(x.dtype)                 # (B, di)
    gate = F.silu(x[:, 0] @ p["up_gate"].to(x.dtype))
    win = torch.cat([conv_tail.to(x.dtype), left[:, None]], dim=1)
    conv = torch.einsum("bkc,kc->bc", win, p["conv_w"].to(x.dtype))
    conv = F.silu(conv + p["conv_b"].to(x.dtype))
    new_tail = win[:, 1:]
    q = torch.einsum("bd,dhk->bhk", conv,
                     p["wq"].to(x.dtype)).to(ct) * hd ** -0.5
    k = torch.einsum("bd,dhk->bhk", conv, p["wk"].to(x.dtype)).to(ct)
    v = torch.einsum("bd,dhk->bhk", left, p["wv"].to(x.dtype)).to(ct)
    li, lf = _mlstm_gates(p, conv[:, None, :])
    li, lf = li[:, 0], lf[:, 0]                          # (B, H)

    m_new = torch.maximum(lf + m_st, li)
    f_sc = torch.exp(lf + m_st - m_new)
    i_sc = torch.exp(li - m_new)
    c_new = (c_st * f_sc[..., None, None]
             + i_sc[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = n_st * f_sc[..., None] + i_sc[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, c_new)
    den = torch.einsum("bhk,bhk->bh", q, n_new)
    denom = torch.maximum(torch.abs(den), torch.exp(-m_new))
    hcell = (num / denom[..., None]).reshape(b, cfg.d_inner).to(x.dtype)
    y = rmsnorm({"scale": p["out_norm"]}, hcell) * gate
    out = (y @ p["down"].to(x.dtype))[:, None]
    return out, (c_new, n_new, m_new, new_tail)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_spec(cfg: SLSTMConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim

    def wx():
        return ParamSpec((d, h, hd), ("embed", "heads", "head_dim"))

    def rh():
        return ParamSpec((h, hd, hd), ("heads", "head_dim", None),
                         scale=0.3)

    def bias(init="zeros"):
        return ParamSpec((h, hd), ("heads", "head_dim"), init=init)

    return {
        "wi": wx(), "wf": wx(), "wz": wx(), "wo": wx(),
        "ri": rh(), "rf": rh(), "rz": rh(), "ro": rh(),
        "bi": bias(), "bf": bias("ones"), "bz": bias(), "bo": bias(),
        "out_norm": ParamSpec((d,), ("embed",), init="ones"),
        "out_proj": ParamSpec((d, d), ("embed", "embed")),
    }


def slstm_step(p, cfg: SLSTMConfig, xi, xf, xz, xo, state):
    """One sLSTM step. x*: (B, H, hd) precomputed input parts; state
    (c, n, h, m), each (B, H, hd)."""
    c, n, hprev, m = state
    ct = xi.dtype

    def rec(name):
        return torch.einsum("bhk,hkj->bhj", hprev, p[name].to(ct))

    it = xi + rec("ri") + p["bi"].to(ct)
    ft = xf + rec("rf") + p["bf"].to(ct)
    zt = xz + rec("rz") + p["bz"].to(ct)
    ot = xo + rec("ro") + p["bo"].to(ct)

    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.exp(lf + m - m_new)
    c_new = f_sc * c + i_sc * torch.tanh(zt)
    n_new = f_sc * n + i_sc
    h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, h_new, m_new)


def slstm_init_state(cfg: SLSTMConfig, batch: int, dtype=torch.float32,
                     device=None):
    """The zero state (c, n, h, m); ``device=None`` is the card."""
    z = torch.zeros((batch, cfg.n_heads, cfg.head_dim), dtype=dtype,
                    device=resolve_device(device))
    return (z, z, z, z)


def _slstm_parts(p, x):
    ct = torch.promote_types(x.dtype, torch.float32)
    return [torch.einsum("b...d,dhk->b...hk", x.to(ct), p[name].to(ct))
            for name in ("wi", "wf", "wz", "wo")]


def slstm_forward(p, cfg: SLSTMConfig, x, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D), the recurrence looped over S; with
    ``return_state`` also the final (c, n, h, m)."""
    b, s, d = x.shape
    xi, xf, xz, xo = _slstm_parts(p, x)                  # (B, S, H, hd)
    state = slstm_init_state(cfg, b, xi.dtype, x.device)
    hs = []
    for t in range(s):
        state = slstm_step(p, cfg, xi[:, t], xf[:, t], xz[:, t], xo[:, t],
                           state)
        hs.append(state[2])
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    y = rmsnorm({"scale": p["out_norm"]}, h)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, state
    return out


def slstm_decode(p, cfg: SLSTMConfig, x, state):
    """One sLSTM step. x: (B, 1, D) -> (y (B, 1, D), state)."""
    b = x.shape[0]
    new = slstm_step(p, cfg, *_slstm_parts(p, x[:, 0]), state)
    h = new[2].reshape(b, cfg.d_model).to(x.dtype)
    y = rmsnorm({"scale": p["out_norm"]}, h)
    out = (y @ p["out_proj"].to(x.dtype))[:, None]
    return out, new
