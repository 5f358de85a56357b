"""Mamba-2 mixer (SSD, state-space duality): the port of
``repro/models/mamba.py``.

Prefill (``mamba_forward``) runs the chunked SSD scan through
``kernels.ssd_scan.ops.ssd_scan``: the CUDA kernel on the card, the plain
``ssd_chunked`` arithmetic on the CPU or with ``force="torch"``.  Decode
(``mamba_decode``) is the O(1) per-token state update and runs no kernel.
State math is f32, as in the reference.

Layouts (the reference's):
  u  : [b, l, d_model]
  x  : [b, l, h, p]     (h = d_inner / head_dim SSD heads, p = head_dim)
  B,C: [b, l, g, n]     (g groups, n = ssm state)
  dt : [b, l, h]
  state (decode): [b, h, p, n] f32
  conv buffer   : [b, K-1, conv_dim] with conv_dim = d_inner + 2 g n
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_dA
from repro_torch.models.layers import dense_init, dot


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    h = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.n_groups * ssm.state
    return d_inner, h, conv_dim


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype):
    """The reference's distributions, drawn from ``gen`` on its device:
    fan-in projections, a unit normal conv kernel times K^-0.5, zero conv
    bias, dt_bias and A_log (A = -1), D = 1 and unit norm scale; the three
    per-head leaves are f32 whatever ``dtype`` is."""
    ssm = cfg.ssm
    d = cfg.d_model
    d_inner, h, conv_dim = _dims(cfg)
    dev = gen.device
    proj_out = 2 * d_inner + 2 * ssm.n_groups * ssm.state + h
    conv_w = torch.randn((ssm.conv_kernel, conv_dim), generator=gen,
                         device=dev) * ssm.conv_kernel ** -0.5
    return {
        "in_proj": dense_init(gen, d, (proj_out,), dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_inner, (d,), dtype),
    }


def _split_proj(cfg, zxbcdt):
    d_inner, h, _ = _dims(cfg)
    gn = cfg.ssm.n_groups * cfg.ssm.state
    return torch.split(zxbcdt, [d_inner, d_inner, 2 * gn, h], dim=-1)


def _softplus(x):
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) (``F.softplus`` returns x itself above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xbc, w, b, prev=None):
    """Depthwise causal conv1d.  xbc: [b, l, c]; w: [K, c]; prev:
    [b, K-1, c] or None.  The K taps are added in f32 in tap order, the
    bias last, then silu, cast back to xbc's dtype.  Returns (out
    [b, l, c], tail [b, K-1, c])."""
    k = w.shape[0]
    if prev is None:
        prev = torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]),
                           dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prev, xbc], dim=1)                     # [b, l+K-1, c]
    length = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + xp[:, i:i + length].float() * w[i].float()
    out = out + b.float()
    tail = xp[:, xp.shape[1] - (k - 1):]
    return F.silu(out).to(xbc.dtype), tail


def _gated_norm(y, z, scale, eps):
    """RMSNormGated(y * silu(z)) over the channel dim; f32 result."""
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * scale.float()


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan, the plain version in the model layout.
    x [b, l, h, p]; dt [b, l, h]; A [h]; B, C [b, l, g, n].  Returns (y
    [b, l, h, p] f32, final state [b, h, p, n] f32)."""
    return ssd_chunked_dA(x, dt, dt.float() * A, B, C, chunk)


def _heads(cfg, xbc):
    """x [b, l, h, p], B and C [b, l, g, n]: views of the conv output."""
    ssm = cfg.ssm
    d_inner, h, _ = _dims(cfg)
    gn = ssm.n_groups * ssm.state
    x, bc = xbc[..., :d_inner], xbc[..., d_inner:]
    lead = xbc.shape[:-1]
    return (x.reshape(*lead, h, ssm.head_dim),
            bc[..., :gn].reshape(*lead, ssm.n_groups, ssm.state),
            bc[..., gn:].reshape(*lead, ssm.n_groups, ssm.state))


def mamba_forward(p, u, cfg: ModelConfig, *, return_state: bool = False,
                  force=None):
    """Full mixer forward (prefill).  u: [b, l, d] with l a multiple of the
    chunk.  Returns out [b, l, d] (and (conv_tail, ssd_state) if
    ``return_state``).  ``force`` (None | 'cuda' | 'torch') goes to the
    scan's dispatch."""
    ssm = cfg.ssm
    if u.shape[1] % ssm.chunk:
        raise ValueError(f"prefill length {u.shape[1]} is not a multiple of "
                         f"the SSD chunk {ssm.chunk}")
    d_inner, h, _ = _dims(cfg)
    z, x, bc, dt = _split_proj(cfg, dot(u, p["in_proj"]))
    xbc, conv_tail = _causal_conv(torch.cat([x, bc], dim=-1), p["conv_w"],
                                  p["conv_b"])
    xh, B, C = _heads(cfg, xbc)
    dtv = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ops.ssd_scan(xh, dtv, dtv * A, B, C, chunk=ssm.chunk,
                            force=force)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(*y.shape[:2], d_inner)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps).to(u.dtype)
    out = dot(y, p["out_proj"])
    if return_state:
        return out, (conv_tail, state)
    return out


def mamba_decode(p, u, cfg: ModelConfig, conv_buf, state):
    """One-token decode.  u: [b, 1, d]; conv_buf: [b, K-1, conv_dim];
    state: [b, h, p, n] f32.  Returns (out [b, 1, d], conv_buf, state), the
    last two new tensors."""
    ssm = cfg.ssm
    d_inner, h, _ = _dims(cfg)
    z, x, bc, dt = _split_proj(cfg, dot(u, p["in_proj"]))
    xbc, conv_buf = _causal_conv(torch.cat([x, bc], dim=-1), p["conv_w"],
                                 p["conv_b"], prev=conv_buf)
    xh, B, C = _heads(cfg, xbc[:, 0])                   # [b,h,p], [b,g,n]
    xh = xh.float()
    dtv = _softplus(dt[:, 0].float() + p["dt_bias"])     # [b, h]
    A = -torch.exp(p["A_log"])
    rep = h // ssm.n_groups
    Bh = B.float().repeat_interleave(rep, dim=1)         # [b, h, n]
    Ch = C.float().repeat_interleave(rep, dim=1)
    dA = torch.exp(dtv * A)
    state = (state * dA[..., None, None]
             + torch.einsum("bh,bhp,bhn->bhpn", dtv, xh, Bh))
    y = torch.einsum("bhn,bhpn->bhp", Ch, state) + p["D"][None, :, None] * xh
    y = y.reshape(-1, 1, d_inner)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps).to(u.dtype)
    return dot(y, p["out_proj"]), conv_buf, state


def mamba_decode_cache_specs(cfg: ModelConfig, batch: int):
    """(shape, dtype) of one mamba layer's decode cache: the conv buffer
    in the config's dtype and the f32 SSD state."""
    ssm = cfg.ssm
    d_inner, h, conv_dim = _dims(cfg)
    return (((batch, ssm.conv_kernel - 1, conv_dim),
             getattr(torch, cfg.dtype)),
            ((batch, h, ssm.head_dim, ssm.state), torch.float32))
