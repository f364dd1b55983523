"""Per-channel window alignment: row gather + sub-window shift.

The demodulator needs each channel's windows at a per-channel sample
offset t0.  Instead of a sample-granular gather, whole N-sample rows are
gathered on the aligned grid (gather_rows) and the remaining sub-N shift
r = t0 mod N is applied to adjacent row pairs (shift_windows):
window w = rows[w][r:] ++ rows[w+1][:r].  Together they equal slicing
x[t0 : t0 + n*N].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .cplx import IQ


def shift_windows(g: IQ, r: jax.Array, mtu: int) -> IQ:
    """g: IQ [B, *k, R, N] aligned rows (R >= mtu+1); r: int32 [B, *k] in
    [0, N); returns IQ [B, *k, mtu, N] with window
    w = g[..., w, r:] ++ g[..., w+1, :r]."""
    g = cplx.as_iq(g)
    *lead, R, N = g.shape
    BF = int(np.prod(lead)) if lead else 1
    gf = g.reshape(BF, R, N)
    rf = r.reshape(BF)
    # concat adjacent rows, slice at r per channel
    wide_re = jnp.concatenate([gf.re[:, :-1], gf.re[:, 1:]], axis=-1)
    wide_im = jnp.concatenate([gf.im[:, :-1], gf.im[:, 1:]], axis=-1)

    def one(w, rr):
        return jax.lax.dynamic_slice(w, (0, rr), (w.shape[0], N))

    f = jax.vmap(one)
    out = IQ(f(wide_re[:, :mtu], rf), f(wide_im[:, :mtu], rf))
    return out.reshape(*lead, mtu, N)


def gather_rows(x: IQ, q: jax.Array, n_rows: int, N: int) -> IQ:
    """x: IQ [B, T]; q: int32 [B, *k] row indices on the N-grid; returns
    IQ [B, *k, n_rows, N] = x[b, (q+j)*N : (q+j+1)*N] (clamped)."""
    x = cplx.as_iq(x)
    B, T = x.shape
    rows_total = T // N
    q = jnp.clip(q.astype(jnp.int32), 0, max(0, rows_total - n_rows))
    ksh = q.shape[1:]
    idx = q[..., None] + jnp.arange(n_rows, dtype=jnp.int32)
    flat_idx = idx.reshape(B, -1)

    def leaf(a):
        a3 = a[:, : rows_total * N].reshape(B, rows_total, N)
        g = jnp.take_along_axis(a3, flat_idx[:, :, None], axis=1)
        return g.reshape(B, *ksh, n_rows, N)

    return IQ(leaf(x.re), leaf(x.im))
