"""Mamba2 / SSD (state-space duality) block, arXiv:2405.21060, ported from
``src/repro/models/ssm.py``.

Prefill: the chunked SSD algorithm (an intra-chunk 'attention-like' term
through the decay matrix ``L = exp(segsum(dA))``, and a recurrence over the
chunks' states).  Decode: the O(1) update ``h = h * exp(dt a) + dt x B^T``.

Shapes (ngroups = 1): ``d_inner = expand * d_model``; ``H = d_inner /
headdim`` heads of ``P = headdim``; ``N = ssm_state``.

The reference writes SSD's contractions as three- and four-operand
``einsum``s.  Here each is a sequence of explicit pairwise products (a
broadcast multiply and one batched ``matmul``), so no contraction order is
left to a planner: the largest intermediate is the (B, H, nc, c, c) decay
matrix itself, which serving masks, exponentiates and weights in place
(training forms it out of place, for autograd).

The stages (:func:`split_proj`, the causal conv with SiLU, :func:`ssd`,
:func:`gate_norm`, the output projection; :func:`ssd_step` in decode) are
functions of their own so that each can be timed alone.  Plain PyTorch throughout: the reference reaches no Pallas
kernel here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash import needs_grad
from .common import ParamInit, causal_conv, conv_step, rmsnorm


class SSM(nn.Module):
    """The reference's ``init_ssm`` leaves, drawn in its order: separate
    projections ``w_z w_x`` (D, d_in), ``w_B w_C`` (D, N), ``w_dt`` (D,
    H); the depthwise conv ``conv_w`` (K, d_in + 2N, scale 0.5) and
    ``conv_b`` (zeros); ``A_log`` (zeros), ``D`` (ones), ``dt_bias``
    (zeros), ``norm_scale`` (ones) and ``out_proj`` (d_in, D)."""

    def __init__(self, init: ParamInit, d_model: int, ssm_state: int,
                 headdim: int = 64, expand: int = 2, conv_kernel: int = 4):
        super().__init__()
        d_in = expand * d_model
        H = d_in // headdim
        conv_dim = d_in + 2 * ssm_state
        self.w_z = init.param((d_model, d_in))
        self.w_x = init.param((d_model, d_in))
        self.w_B = init.param((d_model, ssm_state))
        self.w_C = init.param((d_model, ssm_state))
        self.w_dt = init.param((d_model, H))
        self.conv_w = init.param((conv_kernel, conv_dim), scale=0.5)
        self.conv_b = init.param((conv_dim,), init="zeros")
        self.A_log = init.param((H,), init="zeros")
        self.D = init.param((H,), init="ones")
        self.dt_bias = init.param((H,), init="zeros")
        self.norm_scale = init.param((d_in,), init="ones")
        self.out_proj = init.param((d_in, d_model))


def init_ssm(init: ParamInit, d_model: int, ssm_state: int,
             headdim: int = 64, expand: int = 2,
             conv_kernel: int = 4) -> SSM:
    return SSM(init, d_model, ssm_state, headdim, expand, conv_kernel)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[i, j] = sum_{j < k <= i} x_k
    (lower-triangular incl. the diagonal at 0; -inf above), from the
    difference of cumulative sums as the reference takes it."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((T, T), dtype=torch.bool, device=x.device).triu(1)
    return d.masked_fill_(upper, float("-inf"))


def split_proj(p: SSM, x: torch.Tensor):
    """The five input projections: z, x, B, C, dt."""
    return x @ p.w_z, x @ p.w_x, x @ p.w_B, x @ p.w_C, x @ p.w_dt


def _chunk(S: int, chunk: int) -> int:
    """The reference's chunk rule: the largest divisor of S up to chunk."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def ssd(p: SSM, xs, Bm, Cm, dt, *, headdim: int, chunk: int = 256):
    """Chunked SSD over post-conv ``xs`` (B, S, d_in), ``Bm``, ``Cm`` (B,
    S, N) and the raw ``dt`` (B, S, H).  Returns (y (B, S, H, P) float32
    with the skip term ``D x`` added, final state (B, H, P, N) float32).

    When a gradient is needed (grad mode on and an input or parameter
    requiring grad) the decay matrix and the output are formed out of
    place, since autograd keeps the tensors the in-place form overwrites;
    otherwise (serving) they are weighted in place."""
    Bsz, S, d_in = xs.shape
    N = Bm.shape[-1]
    P = headdim
    H = d_in // P
    grad = needs_grad(xs, Bm, Cm, dt, p.A_log, p.D, p.dt_bias)
    a = -torch.exp(p.A_log.float())                              # (H,)
    dt = F.softplus(dt.float() + p.dt_bias.float())              # (B,S,H)
    c = _chunk(S, chunk)
    nc = S // c
    xh = xs.reshape(Bsz, nc, c, H, P).float()
    Bc = Bm.reshape(Bsz, nc, c, N).float()
    Cc = Cm.reshape(Bsz, nc, c, N).float()
    dtc = dt.reshape(Bsz, nc, c, H)
    dA = (dtc * a).permute(0, 3, 1, 2)                           # (B,H,nc,c)
    xdt = xh * dtc[..., None]                                    # (B,nc,c,H,P)
    xdt_h = xdt.permute(0, 3, 1, 2, 4)                           # (B,H,nc,c,P)

    # intra-chunk: y_diag[b,c,l,h,:] = sum_s (C_l . B_s) L[b,h,c,l,s] xdt_s
    CB = (Cc @ Bc.transpose(-1, -2))[:, None]                    # (B,1,nc,c,c)
    if grad:        # autograd keeps exp's output: no in-place write to it
        L = _segsum(dA).exp() * CB
    else:           # serving: one (B,H,nc,c,c) buffer, weighted in place
        L = _segsum(dA).exp_().mul_(CB)
    y = L @ xdt_h                                                # (B,H,nc,c,P)
    del L, CB

    # chunk states: states[b,c,h,:,n] = sum_l decay_l xdt_l B_l[n]
    A_cum = torch.cumsum(dA, dim=-1)                             # (B,H,nc,c)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)
    states = (xdt_h * decay_states[..., None]).transpose(-1, -2) \
        @ Bc[:, None]                                            # (B,H,nc,P,N)

    # inter-chunk recurrence over the chunk boundaries
    A_last = F.pad(A_cum[..., -1], (1, 0))                       # (B,H,nc+1)
    decay_chunk = torch.exp(_segsum(A_last))                     # (B,H,z,nc+1)
    st = F.pad(states.reshape(Bsz, H, nc, P * N), (0, 0, 1, 0))  # (B,H,nc+1,PN)
    new_states = (decay_chunk @ st).reshape(Bsz, H, nc + 1, P, N)
    prev = new_states[:, :, :-1]                                 # (B,H,nc,P,N)
    final_state = new_states[:, :, -1]                           # (B,H,P,N)

    # state -> output: y_off[b,c,l,h,:] = exp(A_cum_l) (prev_c C_l)
    y_off = Cc[:, None] @ prev.transpose(-1, -2)                 # (B,H,nc,c,P)
    if grad:
        y = y + y_off * torch.exp(A_cum)[..., None]
    else:
        y.add_(y_off.mul_(torch.exp(A_cum)[..., None]))
    y = y.permute(0, 2, 3, 1, 4).reshape(Bsz, S, H, P)
    y = y + p.D.float()[None, None, :, None] \
        * xs.reshape(Bsz, S, H, P).float()
    return y, final_state


def gate_norm(p: SSM, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y (..., H, P) float32 -> rmsnorm(y * silu(z)) in z's dtype."""
    y = y.reshape(*z.shape).to(z.dtype)
    return rmsnorm(y * F.silu(z), p.norm_scale)


def ssm_forward(p: SSM, x: torch.Tensor, *, ssm_state: int,
                headdim: int = 64, expand: int = 2, chunk: int = 256,
                return_state: bool = False):
    """Prefill SSD.  x: (B, S, D) -> (B, S, D), or (y, cache) with
    ``return_state``: the cache's ``conv`` holds the last K - 1 *pre-conv*
    inputs (what ``conv_step`` convolves next), ``h`` the final state
    in float32."""
    S = x.shape[1]
    d_in = expand * x.shape[-1]
    z, xs, Bm, Cm, dt = split_proj(p, x)
    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    xbc = F.silu(causal_conv(xbc_raw, p.conv_w, p.conv_b))
    xs, Bm, Cm = torch.split(xbc, [d_in, ssm_state, ssm_state], dim=-1)
    y, final_state = ssd(p, xs, Bm, Cm, dt, headdim=headdim, chunk=chunk)
    out = gate_norm(p, y, z) @ p.out_proj
    if return_state:
        # copies, not views: a view would hold the whole (B, S, C) input
        # and the (B, H, nc + 1, P, N) states alive with the cache
        K = p.conv_w.shape[0]
        return out, {"conv": xbc_raw[:, S - (K - 1):].clone(),
                     "h": final_state.clone()}
    return out


def ssm_init_cache(d_model: int, ssm_state: int, batch: int,
                   headdim: int = 64, expand: int = 2, conv_kernel: int = 4,
                   dtype=torch.float32, device=None) -> dict:
    """``conv`` (B, K - 1, d_in + 2N) in the model's dtype, ``h`` (B, H,
    P, N) float32, both zero."""
    d_in = expand * d_model
    H = d_in // headdim
    conv_dim = d_in + 2 * ssm_state
    return {
        "conv": torch.zeros((batch, conv_kernel - 1, conv_dim), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, H, headdim, ssm_state),
                         dtype=torch.float32, device=device),
    }


def ssd_step(p: SSM, h, xs, Bm, Cm, dt, *, headdim: int):
    """One recurrent step: (y (B, H, P) float32 with ``D x``, new h)."""
    Bsz = xs.shape[0]
    a = -torch.exp(p.A_log.float())
    dtv = F.softplus(dt.float() + p.dt_bias.float())             # (B, H)
    dA = torch.exp(dtv * a)
    xh = xs.reshape(Bsz, -1, headdim).float()                    # (B, H, P)
    h = h * dA[..., None, None] \
        + (xh * dtv[..., None])[..., None] * Bm.float()[:, None, None, :]
    y = (h @ Cm.float()[:, None, :, None])[..., 0]               # (B, H, P)
    return y + p.D.float()[None, :, None] * xh, h


def ssm_decode(p: SSM, x: torch.Tensor, cache: dict, *, ssm_state: int,
               headdim: int = 64, expand: int = 2):
    """One decode step.  x: (B, 1, D) -> ((B, 1, D), new cache)."""
    d_in = expand * x.shape[-1]
    z, xs, Bm, Cm, dt = split_proj(p, x[:, 0])
    xbc = torch.cat([xs, Bm, Cm], dim=-1)                        # (B, conv_dim)
    conv_out, new_conv = conv_step(cache["conv"], xbc, p.conv_w, p.conv_b)
    xs, Bm, Cm = torch.split(F.silu(conv_out), [d_in, ssm_state, ssm_state],
                             dim=-1)
    y, h = ssd_step(p, cache["h"], xs, Bm, Cm, dt, headdim=headdim)
    out = gate_norm(p, y, z) @ p.out_proj
    return out[:, None], {"conv": new_conv, "h": h}
