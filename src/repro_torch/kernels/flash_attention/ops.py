"""Public wrapper for forward flash attention in the model's layout.

``flash_sdpa(q, k, v, *, scale, causal, window)`` takes q (B, S, Hq, hd)
and k/v (B, S, Hkv, hd), float32 or bfloat16, and returns (B, S, Hq, hd)
in q's type: softmax(q k^T * scale) v with float32 accumulators, query
head h reading KV head ``h // (Hq // Hkv)``, under the causal mask
(``q_pos >= k_pos``) and, when ``window > 0``, the sliding window
(``k_pos > q_pos - window``).  Any S is taken: keys at or past S are
masked, so no padding enters the softmax (the reference wrapper pads K/V
with zeros and leaves them unmasked when ``causal=False``).

For bfloat16 inputs the probabilities are rounded to bfloat16 before
P·V, as the TPU kernel rounds them to V's type
(``repro/kernels/flash_attention/kernel.py:59-60``); float32 keeps them
in float32.

Where the tensors live decides how it runs.  On CUDA tensors the wrapper
launches ``flash_attention_f32_kernel`` (CUDA cores, 128 query rows by
64 keys) or ``flash_attention_bf16_kernel`` (wgmma tensor cores fed by
TMA, 128 x 128 tiles) from ``csrc/flash_attention.cu``, or raises; on CPU tensors it
runs :func:`flash_sdpa_plain`, the kernels' blockwise online softmax with
the same tiles, masks, skipped tiles and rounding of P in PyTorch.  No
path falls back from one to the other.  ``launches`` counts the kernels'
launches.
"""
from __future__ import annotations

import torch

launches = 0

# query rows per thread block and keys per K/V tile, by input type (csrc
# simt::kBQ/kBK for float32, tc::kBQ/kBK for bfloat16)
BLOCK_Q = {torch.float32: 128, torch.bfloat16: 128}
BLOCK_K = {torch.float32: 64, torch.bfloat16: 128}
HEAD_DIMS = (16, 32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def key_range(q0: int, s: int, causal: bool, window: int,
              dtype: torch.dtype = torch.float32) -> range:
    """Starts of the K/V tiles that the q tile starting at ``q0`` can see,
    in the tiles of ``dtype``'s kernel; tiles wholly above the causal
    diagonal or before the window are skipped."""
    bq, bk = BLOCK_Q[dtype], BLOCK_K[dtype]
    end = min(s, q0 + bq) if causal else s
    begin = max(0, q0 - window + 1) if window > 0 else 0
    return range(begin // bk * bk, end, bk)


def flash_sdpa_plain(q, k, v, *, scale: float, causal: bool = True,
                     window: int = 0) -> torch.Tensor:
    """The kernels' arithmetic in PyTorch: per q tile of ``q.dtype``'s
    kernel, an online softmax over the K/V tiles of :func:`key_range` in
    float32, masked scores at -inf, P rounded to bfloat16 before P·V for
    bfloat16 inputs (the sum l is taken before the rounding), and
    ``acc / max(l, 1e-30)`` at the end."""
    b, s, hq, hd = q.shape
    bq, bk = BLOCK_Q[q.dtype], BLOCK_K[q.dtype]
    rounded = q.dtype == torch.bfloat16
    g = hq // k.shape[2]
    qf = q.float().transpose(1, 2)                          # (B, Hq, S, hd)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    out = torch.empty_like(qf)
    for q0 in range(0, s, bq):
        qb = qf[:, :, q0:q0 + bq]
        qp = torch.arange(q0, min(q0 + bq, s), device=q.device)[:, None]
        m = torch.full(qb.shape[:-1], float("-inf"), device=q.device)
        lsum = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in key_range(q0, s, causal, window, q.dtype):
            kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            kp = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
            ok = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool,
                            device=q.device)
            if causal:
                ok &= kp <= qp
            if window > 0:
                ok &= kp > qp - window
            sc = ((qb @ kb.transpose(-1, -2)) * scale).masked_fill(
                ~ok, float("-inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
            alpha = torch.exp(m - m_use)
            p = torch.exp(sc - m_use[..., None])
            lsum = lsum * alpha + p.sum(-1)
            if rounded:
                p = p.bfloat16().float()
            acc = acc * alpha[..., None] + p @ vb
            m = m_new
        out[:, :, q0:q0 + bq] = acc / lsum.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _launch(q, k, v, scale: float, causal: bool, window: int):
    global launches
    from repro_torch.kernels.flash_attention.kernel import LIBRARY

    lib = LIBRARY.load()
    b, s, hq, hd = q.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hq,
        k.shape[2], hd, _DTYPES[q.dtype], scale, int(causal), window,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the f32 kernel's
    cp.async, the bf16 kernel's tensor maps)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_sdpa(q, k, v, *, scale: float | None = None, causal: bool = True,
               window: int = 0) -> torch.Tensor:
    """q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd) -> (B, S, Hq, hd).

    ``scale`` defaults to ``hd ** -0.5``; ``window`` 0 is global.  Raises
    ``ValueError`` on shapes, types or devices the kernel does not take
    (hd must be one of ``HEAD_DIMS``), on CPU tensors as on CUDA ones."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"want q (B, S, Hq, hd) and k, v (B, S, Hkv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, hd = q.shape
    if b < 1 or s < 1 or k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError(f"want B, S >= 1 and Hq a multiple of Hkv; got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {hd}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a type in float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.is_cuda:
        return _launch(q, k, v, scale, causal, int(window))
    if q.device.type != "cpu":
        raise ValueError(f"flash_sdpa runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return flash_sdpa_plain(q, k, v, scale=scale, causal=causal,
                            window=int(window))
