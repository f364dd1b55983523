"""Planar complex arrays: the framework's on-device IQ representation.

The reference's `std::complex<float>` streams (LoRaMod.cpp:107,
LoRaDemod.cpp:157) become a *planar* pair of float32 arrays — an `IQ`
NamedTuple pytree — throughout the compute path; complex matmuls are 4
real matmuls.  The FFT (ops/detect.fft) converts to complex64 and back at its
boundary.

Host boundaries (numpy complex captures, test vectors) convert with
`from_complex` / `to_complex`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class IQ(NamedTuple):
    """Planar complex: same-shape float32 real and imaginary planes."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def __getitem__(self, idx):  # type: ignore[override]
        if isinstance(idx, int):  # preserve tuple-unpacking of NamedTuple? no:
            # IQ is array-like; integer indexing slices the array, use
            # .re/.im for field access.
            return IQ(self.re[idx], self.im[idx])
        return IQ(self.re[idx], self.im[idx])

    def reshape(self, *shape):
        return IQ(self.re.reshape(*shape), self.im.reshape(*shape))

    def astype(self, dtype):
        return IQ(self.re.astype(dtype), self.im.astype(dtype))


def as_iq(x) -> IQ:
    """Coerce complex arrays / IQ / real arrays (imag=0) to planar IQ."""
    if isinstance(x, IQ):
        return x
    if isinstance(x, (tuple, list)) and len(x) == 2:
        return IQ(jnp.asarray(x[0], jnp.float32), jnp.asarray(x[1], jnp.float32))
    if hasattr(x, "dtype") and jnp.issubdtype(np.asarray(x).dtype if isinstance(
        x, np.ndarray
    ) else x.dtype, jnp.complexfloating):
        return from_complex(x)
    x = jnp.asarray(x, jnp.float32)
    return IQ(x, jnp.zeros_like(x))


def from_complex(x) -> IQ:
    """numpy/jax complex array -> planar IQ (host conversion for numpy)."""
    if isinstance(x, np.ndarray):
        return IQ(
            jnp.asarray(np.ascontiguousarray(x.real), jnp.float32),
            jnp.asarray(np.ascontiguousarray(x.imag), jnp.float32),
        )
    return IQ(jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32))


def to_complex(a: IQ) -> np.ndarray:
    """Planar IQ -> host numpy complex64."""
    return np.asarray(a.re) + 1j * np.asarray(a.im)


def mul(a: IQ, b: IQ) -> IQ:
    """Complex multiply."""
    return IQ(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def mul_conj(a: IQ, b: IQ) -> IQ:
    """a * conj(b)."""
    return IQ(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def conj(a: IQ) -> IQ:
    return IQ(a.re, -a.im)


def add(a: IQ, b: IQ) -> IQ:
    return IQ(a.re + b.re, a.im + b.im)


def scale(a: IQ, s) -> IQ:
    return IQ(a.re * s, a.im * s)


def mag2(a: IQ) -> jax.Array:
    return a.re * a.re + a.im * a.im


def from_turns(turns, ampl=1.0) -> IQ:
    """exp(2j*pi*turns) * ampl as planar IQ."""
    ang = (2 * np.pi) * turns
    ampl = jnp.float32(ampl)
    return IQ(jnp.cos(ang) * ampl, jnp.sin(ang) * ampl)


def matmul(a: IQ, b: IQ) -> IQ:
    """Complex matmul as 4 real matmuls.  Precision HIGHEST keeps float32
    products (no TF32), so results match the CPU's."""
    mm = lambda x, y: jnp.matmul(x, y, precision=jax.lax.Precision.HIGHEST)
    rr = mm(a.re, b.re)
    ii = mm(a.im, b.im)
    ri = mm(a.re, b.im)
    ir = mm(a.im, b.re)
    return IQ(rr - ii, ri + ir)


def zeros(shape, dtype=jnp.float32) -> IQ:
    z = jnp.zeros(shape, dtype)
    return IQ(z, z)


def pad(a: IQ, pad_width) -> IQ:
    return IQ(jnp.pad(a.re, pad_width), jnp.pad(a.im, pad_width))


def concatenate(parts, axis=-1) -> IQ:
    return IQ(
        jnp.concatenate([p.re for p in parts], axis=axis),
        jnp.concatenate([p.im for p in parts], axis=axis),
    )


def broadcast_to(a: IQ, shape) -> IQ:
    return IQ(jnp.broadcast_to(a.re, shape), jnp.broadcast_to(a.im, shape))


def where(cond, a: IQ, b: IQ) -> IQ:
    return IQ(jnp.where(cond, a.re, b.re), jnp.where(cond, a.im, b.im))
