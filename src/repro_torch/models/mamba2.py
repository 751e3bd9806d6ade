"""Mamba2 (SSD) layer: the chunked state-space dual form and one-step decode.

Port of :mod:`repro.models.mamba2`.  Per head h, with scalar decay
a_t = exp(dt_t * A_h):

    H_t = a_t * H_{t-1} + dt_t * B_t (x) x_t          (H: (headdim, d_state))
    y_t = C_t . H_t + D_h * x_t

Chunked evaluation (chunk Q): within a chunk a masked (C B^T) "attention"
with the decay mask L[i, j] = exp(cum_i - cum_j); across chunks the state
is carried by a loop over the chunks.  The JAX package has no Pallas kernel
here; the port is plain PyTorch.  Its one departure in form: the
four-operand intra-chunk einsum ``bcij,bcijh,bcjh,bcjhp->bcihp`` is
contracted pairwise (the decay-weighted scores first, then a batched
(Q x Q) . (Q x P) product), so no (B, nc, Q, Q, H, P) tensor exists.
Mixed-dtype products promote to fp32 as JAX's do.

``ssd_reference`` is the naive per-step recurrence, the tests' oracle.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as coll
from repro_torch.models import common as cm
from repro_torch.models.common import ArchConfig, Params

_CONV_K = 4
_F32 = torch.float32


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    return d_inner, n_heads, cfg.ssm_state


def init_mamba(cfg: ArchConfig, gen: torch.Generator, device=None) -> Params:
    d = cfg.d_model
    d_inner, nh, ds = _dims(cfg)
    pd = cfg.pdtype
    return Params({
        "w_z": cm.dense_init(gen, (d, d_inner), pd, device=device),  # gate
        "w_x": cm.dense_init(gen, (d, d_inner), pd, device=device),
        "w_b": cm.dense_init(gen, (d, ds), pd, device=device),
        "w_c": cm.dense_init(gen, (d, ds), pd, device=device),
        "w_dt": cm.dense_init(gen, (d, nh), pd, device=device),
        "conv_wx": cm.normal(gen, (d_inner, _CONV_K), 0.1, device=device).to(pd),
        "conv_wbc": cm.normal(gen, (2 * ds, _CONV_K), 0.1, device=device).to(pd),
        "conv_b": torch.zeros((d_inner + 2 * ds,), dtype=pd, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=_F32, device=device)),
        "d_skip": torch.ones((nh,), dtype=_F32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=_F32, device=device),
        "norm": torch.ones((d_inner,), dtype=pd, device=device),
        "w_out": cm.dense_init(gen, (d_inner, d), pd, device=device),
    })


def mamba_axes(cfg: ArchConfig) -> dict:
    """Logical axes of :func:`init_mamba`'s parameters, by name."""
    return {
        "w_z": ("embed_p", "inner"),
        "w_x": ("embed_p", "inner"),
        "w_b": ("embed_p", None),
        "w_c": ("embed_p", None),
        "w_dt": ("embed_p", None),
        "conv_wx": ("inner", None),
        "conv_wbc": (None, None),
        "conv_b": (None,),
        "a_log": ("state",),
        "d_skip": ("state",),
        "dt_bias": ("state",),
        "norm": ("inner",),
        "w_out": ("inner", "embed_p"),
    }


def _project(cfg: ArchConfig, p: Params, x):
    """x (B,S,d) -> (z, x_in, b, c, dt_raw), the projections before the conv."""
    dt = cfg.cdtype
    return (x @ p.w_z.to(dt), x @ p.w_x.to(dt), x @ p.w_b.to(dt), x @ p.w_c.to(dt),
            x @ p.w_dt.to(dt))


def _causal_conv(u, w, b):
    """Depthwise causal conv, kernel _CONV_K; u (B, S, C), w (C, K)."""
    s = u.shape[1]
    pad = F.pad(u, (0, 0, _CONV_K - 1, 0))
    out = sum(pad[:, i : i + s, :] * w[None, None, :, i].to(u.dtype) for i in range(_CONV_K))
    return out + b.to(u.dtype)


def _conv_all(cfg: ArchConfig, p: Params, xi, b, c):
    """Conv x with its filter and (B, C) jointly with theirs, then SiLU."""
    d_inner, _, ds = _dims(cfg)
    xi = _causal_conv(xi, p.conv_wx, p.conv_b[:d_inner])
    bc = _causal_conv(torch.cat([b, c], -1), p.conv_wbc, p.conv_b[d_inner:])
    xi = F.silu(xi.to(_F32)).to(xi.dtype)
    bc = F.silu(bc.to(_F32)).to(bc.dtype)
    return xi, bc[..., :ds], bc[..., ds:]


def _gated_norm(p: Params, y, z):
    yf = y.to(_F32) * F.silu(z.to(_F32))
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    return yf * p.norm.to(_F32)


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int, h0=None):
    """SSD core.  x (B,S,H,P); dt (B,S,H) fp32; b/c (B,S,N); returns (y, h_final).

    The chunk is ``min(chunk, S)`` halved until it divides S.  h0 / h_final:
    (B, H, P, N), the state entering the first chunk and leaving the last;
    y is fp32, h_final in x's dtype, as in the JAX package.
    """
    bs, s, nh, hd = x.shape
    ds = b_mat.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q

    la = (-torch.exp(a_log)[None, None, :] * dt).reshape(bs, nc, q, nh)  # log a_t
    xc = x.reshape(bs, nc, q, nh, hd)
    dtc = dt.reshape(bs, nc, q, nh)
    bc = b_mat.reshape(bs, nc, q, ds)
    cc = c_mat.reshape(bs, nc, q, ds)

    cum = torch.cumsum(la, dim=2)  # (B,nc,Q,H) inclusive
    # intra-chunk: Y[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B,nc,Q,Q) in x's dtype
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,i,j,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # mask the exponent, not the exp (exp of a large positive would be inf)
    decay = decay.masked_fill(~mask[None, None, :, :, None], -math.inf)
    wts = scores[..., None] * torch.exp(decay) * dtc[:, :, None, :, :]  # (B,nc,i,j,H) fp32
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", wts, xc.to(_F32))

    # chunk states: S_c = sum_j exp(cum_Q - cum_j) dt_j B_j (x) x_j
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjhp,bcjn->bchpn", tail[..., None] * xc.to(_F32), bc.to(_F32))
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)

    h = (h0 if h0 is not None else torch.zeros((bs, nh, hd, ds), dtype=x.dtype,
                                               device=x.device)).to(_F32)
    h_prevs = []
    for ci in range(nc):  # the state entering each chunk
        h_prevs.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + s_chunk[:, ci]
    h_prev = torch.stack(h_prevs, dim=1).to(x.dtype).to(_F32)  # (B,nc,H,P,N)

    # inter-chunk: Y_inter[i] = exp(cum_i) * C_i . H_prev
    y_inter = torch.exp(cum)[..., None] * torch.einsum("bcin,bchpn->bcihp", cc.to(_F32), h_prev)
    y = (y_intra + y_inter).reshape(bs, s, nh, hd)
    y = y + d_skip[None, None, :, None] * x
    return y, h.to(x.dtype)


def ssd_reference(x, dt, a_log, b_mat, c_mat, d_skip, h0=None):
    """Naive per-step recurrence (the tests' oracle); y and h in x's dtype."""
    bs, s, nh, hd = x.shape
    ds = b_mat.shape[-1]
    h = (h0 if h0 is not None else torch.zeros((bs, nh, hd, ds), device=x.device)).to(_F32)
    xf, bf, cf = x.to(_F32), b_mat.to(_F32), c_mat.to(_F32)
    ys = []
    for t in range(s):
        a = torch.exp(-torch.exp(a_log)[None, :] * dt[:, t])  # (B,H)
        h = h * a[..., None, None] + torch.einsum("bh,bn,bhp->bhpn", dt[:, t], bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], h))
    y = torch.stack(ys, dim=1) + d_skip[None, None, :, None] * xf
    return y.to(x.dtype), h.to(x.dtype)


def apply_mamba(cfg: ArchConfig, p: Params, x, *, return_cache: bool = False):
    """Prefill forward; x (B, S, d) -> (B, S, d) [, the decode cache].

    The cache's conv rows are the last _CONV_K - 1 pre-conv inputs (zeros
    before the prompt when it is shorter), its state the SSD's final state.
    """
    d_inner, nh, ds = _dims(cfg)
    dt_ = cfg.cdtype
    b_, s = x.shape[:2]
    z, xi, b, c, dtr = _project(cfg, p, x)
    conv_in = torch.cat([xi, b, c], -1)
    conv_tail = F.pad(conv_in, (0, 0, max(_CONV_K - 1 - s, 0), 0))[:, -(_CONV_K - 1):, :]
    xi, b, c = _conv_all(cfg, p, xi, b, c)
    dt_pos = F.softplus(dtr.to(_F32) + p.dt_bias[None, None, :])
    y, h_fin = ssd_chunked(xi.reshape(b_, s, nh, cfg.ssm_headdim), dt_pos, p.a_log, b, c,
                           p.d_skip, chunk=cfg.ssm_chunk)
    y = _gated_norm(p, y.reshape(b_, s, d_inner), z)
    out = y.to(dt_) @ p.w_out.to(dt_)
    if return_cache:
        return out, {"conv": conv_tail, "ssm": h_fin}
    return out


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype, device=None) -> dict:
    d_inner, nh, ds = _dims(cfg)
    conv_dim = d_inner + 2 * ds
    return {
        "conv": torch.zeros((batch, _CONV_K - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_headdim, ds), dtype=dtype, device=device),
    }


def apply_mamba_decode(cfg: ArchConfig, p: Params, x, cache: dict):
    """One-token step; x (B, 1, d); returns (y, new cache).

    The conv filter is read in fp32 from the parameter dtype, as the JAX
    package's decode reads it.
    """
    d_inner, nh, ds = _dims(cfg)
    dt_ = cfg.cdtype
    z, xi, b, c, dtr = _project(cfg, p, x)
    new_row = torch.cat([xi, b, c], -1)  # (B, 1, conv_dim)
    win = torch.cat([cache["conv"], new_row], dim=1)  # (B, K, conv_dim)
    w_full = torch.cat([p.conv_wx, p.conv_wbc], dim=0)
    out = torch.einsum("bkc,ck->bc", win.to(_F32), w_full.to(_F32))
    act = F.silu(out + p.conv_b.to(_F32))[:, None, :].to(dt_)
    xi1, b1, c1 = act[..., :d_inner], act[..., d_inner:d_inner + ds], act[..., d_inner + ds:]
    dt_pos = F.softplus(dtr.to(_F32) + p.dt_bias[None, None, :])

    xt = xi1.reshape(-1, nh, cfg.ssm_headdim).to(_F32)
    a = torch.exp(-torch.exp(p.a_log)[None, :] * dt_pos[:, 0])  # (B,H)
    h = cache["ssm"].to(_F32) * a[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt_pos[:, 0], b1[:, 0].to(_F32), xt)
    y = torch.einsum("bn,bhpn->bhp", c1[:, 0].to(_F32), h)
    y = y + p.d_skip[None, :, None] * xt
    y = _gated_norm(p, y.reshape(-1, 1, d_inner), z)
    out = y.to(dt_) @ p.w_out.to(dt_)
    return out, {"conv": win[:, 1:, :], "ssm": h.to(cache["ssm"].dtype)}


# ---------------------------------------------------------------------------
# on a device grid
# ---------------------------------------------------------------------------


def _grid_heads(cfg: ArchConfig, run) -> tuple[tuple, int]:
    """(the axes ``inner`` splits the SSD heads over, heads a tile)."""
    _, nh, _ = _dims(cfg)
    ti = run.entry("inner", nh)
    return ti, nh // run.size(ti)


def _grid_params(cfg: ArchConfig, run, p, ti: tuple, varying: tuple) -> list:
    """Each tile's parameters: ``w_z``, ``w_x``, ``conv_wx`` and ``norm`` by
    their ``inner`` channels, ``w_out`` by its rows, the rest whole (each
    tile takes its heads' slice of ``dt``, ``a_log``, ``d_skip`` and
    ``dt_bias``, and of ``conv_b``'s x part)."""
    ents = {"w_z": ((), ti), "w_x": ((), ti), "conv_wx": (ti, ()), "norm": (ti,),
            "w_out": (ti, ()), "w_b": ((), ()), "w_c": ((), ()), "w_dt": ((), ()),
            "conv_wbc": ((), ()), "conv_b": ((),), "a_log": ((),), "d_skip": ((),),
            "dt_bias": ((),)}
    return run.tiles(p, ents, varying)


def _gated_norm_grid(run, ti: tuple, d_inner: int, norms: list, ys: list, zs: list) -> list:
    """:func:`_gated_norm` over channels split over ``ti``: each tile's sum
    of squares of its channels, summed over ``ti`` in tile order, divided by
    d_inner (the RMS over the whole of d_inner)."""
    grid = run.grid
    yf = [y.to(_F32) * F.silu(z.to(_F32)) for y, z in zip(ys, zs)]
    sq = coll.all_reduce([(v * v).sum(-1, keepdim=True) for v in yf], grid, ti, run.path)
    sq = coll.pvary(sq, grid, ti, run.path)
    return [v * torch.rsqrt(s / d_inner + 1e-6) * n.to(_F32) for v, s, n in zip(yf, sq, norms)]


def _tile_slices(cfg: ArchConfig, run, ti: tuple, n_loc: int, t: int) -> tuple[slice, slice]:
    """Tile ``t``'s heads and its x channels."""
    h0 = run.grid.position(t, ti) * n_loc
    return slice(h0, h0 + n_loc), slice(h0 * cfg.ssm_headdim, (h0 + n_loc) * cfg.ssm_headdim)


def _cut_conv(cfg: ArchConfig, run, whole: list, spec) -> coll.Sharded:
    """The decode cache's conv rows in the JAX layout from each tile's whole
    rows (B, K - 1, d_inner + 2N): each tile keeps its slice of the last
    dim, split over ``inner`` by ``spec`` -- a boundary that need not be the
    heads' (zamba2 on two tiles: 7296 / 2 = 3648 columns, so tile 1 holds
    x[3648:] and all of B and C)."""
    d_inner, _, ds = _dims(cfg)
    shape = (whole[0].shape[0] * run.size(coll.entry_axes(spec[0])), _CONV_K - 1,
             d_inner + 2 * ds)
    return coll.split(coll.Sharded(whole, (spec[0], None, None), shape), run.grid,
                      coll.entry_axes(spec[2]), 2)


def apply_mamba_grid(cfg: ArchConfig, run, p, x: coll.Sharded, *, cache_specs=None):
    """:func:`apply_mamba` on a grid: ``x`` (B, S, d) per tile laid out by
    ``(batch, seq, embed)``.  Each tile projects its heads' channels of z
    and x (the (B, C) and dt projections whole), convolves them, runs the
    SSD over its heads with no collective, and applies the gated norm, whose
    RMS over d_inner sums the tiles' squares over ``inner``; ``w_out``'s
    partials are summed over ``inner``'s axes.  A sequence split over tiles
    is gathered first.  With ``cache_specs`` (the cache's ``conv`` and
    ``ssm`` specs) also returns the decode cache laid out by them."""
    grid = run.grid
    d_inner, nh, ds = _dims(cfg)
    dt_ = cfg.cdtype
    xw, sa = run.whole_seq(x)
    ti, n_loc = _grid_heads(cfg, run)
    varying = coll.entry_axes(xw.spec[0]) + sa + ti
    xt = coll.pvary(xw, grid, ti, run.path)
    w = _grid_params(cfg, run, p, ti, varying)
    b_, s = xw[0].shape[:2]
    zs, ys, states, tails, bc_tails = [], [], [], [], []
    for t in range(grid.n_tiles):
        hs, cs = _tile_slices(cfg, run, ti, n_loc, t)
        z, xi, b, c, dtr = _project(cfg, w[t], xt[t])
        if cache_specs is not None:
            pad = max(_CONV_K - 1 - s, 0)
            tails.append(F.pad(xi, (0, 0, pad, 0))[:, -(_CONV_K - 1):])
            bc_tails.append(F.pad(torch.cat([b, c], -1), (0, 0, pad, 0))[:, -(_CONV_K - 1):])
        xi = F.silu(_causal_conv(xi, w[t].conv_wx, w[t].conv_b[:d_inner][cs]).to(_F32)).to(dt_)
        bc = _causal_conv(torch.cat([b, c], -1), w[t].conv_wbc, w[t].conv_b[d_inner:])
        bc = F.silu(bc.to(_F32)).to(bc.dtype)
        dt_pos = F.softplus(dtr[..., hs].to(_F32) + w[t].dt_bias[hs][None, None, :])
        y, h_fin = ssd_chunked(xi.reshape(b_, s, n_loc, cfg.ssm_headdim), dt_pos,
                               w[t].a_log[hs], bc[..., :ds], bc[..., ds:], w[t].d_skip[hs],
                               chunk=cfg.ssm_chunk)
        zs.append(z)
        ys.append(y.reshape(b_, s, n_loc * cfg.ssm_headdim))
        states.append(h_fin)
    normed = _gated_norm_grid(run, ti, d_inner, [wt.norm for wt in w], ys, zs)
    outs = [v.to(dt_) @ w[t].w_out.to(dt_) for t, v in enumerate(normed)]
    y = coll.split(coll.Sharded(coll.all_reduce(outs, grid, ti, run.path), xw.spec, xw.shape),
                   grid, sa, 1)
    if cache_specs is None:
        return y
    xs = coll.all_gather(tails, grid, ti, -1, run.path)  # the x channels whole (counted)
    conv = _cut_conv(cfg, run, [torch.cat(v, -1) for v in zip(xs, bc_tails)],
                     cache_specs["conv"])
    ssm = coll.Sharded(states, (xw.spec[0], ti, None, None),
                       (x.shape[0], nh, cfg.ssm_headdim, ds))
    return y, {"conv": conv, "ssm": coll.relayout(ssm, cache_specs["ssm"], grid, run.path)}


def apply_mamba_decode_grid(cfg: ArchConfig, run, p, x: coll.Sharded, cache: dict):
    """:func:`apply_mamba_decode` on a grid: ``x`` (B, 1, d) laid out by
    batch; the cache's conv rows in the JAX layout (split over ``inner`` on
    [x | B | C]) are gathered whole for the step (counted), each tile
    convolves its heads' channels and the (B, C) ones, steps its heads'
    states and applies the gated norm as :func:`apply_mamba_grid`; the new
    conv rows are cut back into the cache's layout.  Returns (y, the new
    cache)."""
    grid = run.grid
    d_inner, nh, ds = _dims(cfg)
    dt_ = cfg.cdtype
    ti, n_loc = _grid_heads(cfg, run)
    w = _grid_params(cfg, run, p, ti, ())
    conv = cache["conv"]
    whole = coll.relayout(conv, (conv.spec[0], None, None), grid, run.path)
    ssm = coll.relayout(cache["ssm"], (x.spec[0], ti, None, None), grid, run.path)
    zs, ys, states, rows, bcs = [], [], [], [], []
    for t in range(grid.n_tiles):
        hs, cs = _tile_slices(cfg, run, ti, n_loc, t)
        z, xi, b, c, dtr = _project(cfg, w[t], x[t])
        win_x = torch.cat([whole[t][..., :d_inner][..., cs], xi], dim=1)  # (B, K, d_loc)
        win_bc = torch.cat([whole[t][..., d_inner:], torch.cat([b, c], -1)], dim=1)
        ox = torch.einsum("bkc,ck->bc", win_x.to(_F32), w[t].conv_wx.to(_F32))
        obc = torch.einsum("bkc,ck->bc", win_bc.to(_F32), w[t].conv_wbc.to(_F32))
        xi1 = F.silu(ox + w[t].conv_b[:d_inner][cs].to(_F32)).to(dt_)
        bc1 = F.silu(obc + w[t].conv_b[d_inner:].to(_F32)).to(dt_)
        dt_pos = F.softplus(dtr[:, 0, hs].to(_F32) + w[t].dt_bias[hs][None, :])  # (B, H_loc)
        xt = xi1.reshape(-1, n_loc, cfg.ssm_headdim).to(_F32)
        a = torch.exp(-torch.exp(w[t].a_log[hs])[None, :] * dt_pos)
        h = ssm[t].to(_F32) * a[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt_pos, bc1[:, :ds].to(_F32), xt)
        y = torch.einsum("bn,bhpn->bhp", bc1[:, ds:].to(_F32), h)
        y = y + w[t].d_skip[hs][None, :, None] * xt
        zs.append(z)
        ys.append(y.reshape(-1, 1, n_loc * cfg.ssm_headdim))
        states.append(h.to(cache["ssm"][t].dtype))
        rows.append(xi)
        bcs.append(torch.cat([b, c], -1))
    normed = _gated_norm_grid(run, ti, d_inner, [wt.norm for wt in w], ys, zs)
    outs = [v.to(dt_) @ w[t].w_out.to(dt_) for t, v in enumerate(normed)]
    y = coll.Sharded(coll.all_reduce(outs, grid, ti, run.path), x.spec, x.shape)
    xs = coll.all_gather(rows, grid, ti, -1, run.path)  # the new x row whole (counted)
    new_conv = _cut_conv(cfg, run, [torch.cat([old[:, 1:], torch.cat(v, -1)], 1)
                                    for old, v in zip(whole, zip(xs, bcs))], conv.spec)
    new_ssm = coll.Sharded(states, (x.spec[0], ti, None, None), cache["ssm"].shape)
    return y, {"conv": new_conv, "ssm": coll.relayout(new_ssm, cache["ssm"].spec, grid, run.path)}
