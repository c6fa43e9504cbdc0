"""The CKKS encoder's complex DWT, double for double as SEAL computes it.

The port of seal_tpu/utils/dwt.py (SEAL util/dwthandler.h:94-356 over
std::complex<double>, root tables from util/croots.cpp). The root tables
are built on the host once per n, with CPython's math.cos and math.sin as
seal_tpu builds them. The butterflies run as float64 tensor ops on the
tensors' device, one stage at a time: a stage's butterflies are
independent, and each eager PyTorch op rounds once, as IEEE 754 requires,
so every value is SEAL's scalar loop's, on the card and on the CPU alike.
Nothing may fuse a product into an add (no addcmul, lerp or compiled
kernels); the complex product is the naive (ac - bd, ad + bc). The
transforms run over the last axis, so a batch [B, n] is B transforms with
the same launches as one, each member's values those of its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from seal_tpu_torch.ops.galois import reverse_bits_vec

# croots.h:27 — rounds to the IEEE double nearest pi
_PI = 3.1415926535897932384626433832795028842


def _primitive_roots_octant(m: int):
    """polar(1, 2·PI·i/m) for 0 <= i <= m/8 (croots.cpp:30-40)."""
    re = np.empty(m // 8 + 1, dtype=np.float64)
    im = np.empty(m // 8 + 1, dtype=np.float64)
    for i in range(m // 8 + 1):
        theta = (2.0 * _PI) * float(i) / float(m)    # C++'s order of evaluation
        re[i] = math.cos(theta)
        im[i] = math.sin(theta)
    return re, im


def _get_roots(m: int, idx: np.ndarray, re8: np.ndarray, im8: np.ndarray):
    """ComplexRoots::get_root (croots.cpp:43-71) over an index array, by
    the 8-fold symmetry of the octant table."""
    idx = idx & (m - 1)
    q8, q4, q2, q34 = m // 8, m // 4, m // 2, 3 * m // 4
    j = np.where(idx <= q4, idx,
                 np.where(idx <= q2, q2 - idx,
                          np.where(idx <= q34, idx - q2, m - idx)))
    in_oct = j <= q8
    jo = np.where(in_oct, j, 0)
    jm = np.where(in_oct, 0, q4 - j)
    base_re = np.where(in_oct, re8[jo], im8[jm])
    base_im = np.where(in_oct, im8[jo], re8[jm])
    sign_re = np.where(idx <= q4, 1.0, np.where(idx <= q34, -1.0, 1.0))
    sign_im = np.where((idx <= q4) | ((idx > q4) & (idx <= q2)), 1.0, -1.0)
    return sign_re * base_re, sign_im * base_im


def encoder_root_tables(n: int):
    """(root_powers, inv_root_powers) as CKKSEncoder's constructor builds
    them (ckks.cpp:52-70): for 1 <= i < n, root_powers[i] =
    get_root(reverse_bits(i)) and inv_root_powers[i] =
    conj(get_root(reverse_bits(i - 1) + 1)); index 0 is never read.
    Returns ((re, im), (re, im)), float64 [n] numpy arrays."""
    log_n = n.bit_length() - 1
    m = 2 * n
    rp_re, rp_im = np.zeros(n), np.zeros(n)
    irp_re, irp_im = np.zeros(n), np.zeros(n)
    if m >= 8:
        re8, im8 = _primitive_roots_octant(m)
        i = np.arange(1, n, dtype=np.int64)
        rp_re[1:], rp_im[1:] = _get_roots(m, reverse_bits_vec(i, log_n), re8, im8)
        cr, ci = _get_roots(m, reverse_bits_vec(i - 1, log_n) + 1, re8, im8)
        irp_re[1:], irp_im[1:] = cr, -ci
    elif m == 4:
        rp_re[1], rp_im[1] = 0.0, 1.0
        irp_re[1], irp_im[1] = 0.0, -1.0
    return (rp_re, rp_im), (irp_re, irp_im)


def transform_from_rev(re: torch.Tensor, im: torch.Tensor, roots, scalar=None):
    """DWTHandler::transform_from_rev (dwthandler.h:202-356): bit-reversed
    input -> natural output, roots consumed in order from index 1, the
    scalar merged into the last stage. roots: (re, im) float64 tensors on
    the device. re, im: [..., n], contiguous. Writes into and returns (re,
    im)."""
    n = re.shape[-1]
    lead = re.shape[:-1]
    r_re, r_im = roots
    gap, m, ridx = 1, n >> 1, 1
    while m > 1:
        rr = r_re[ridx:ridx + m, None]
        ri = r_im[ridx:ridx + m, None]
        ridx += m
        vre, vim = re.view(lead + (m, 2, gap)), im.view(lead + (m, 2, gap))
        ure, uim = vre[..., 0, :].clone(), vim[..., 0, :].clone()
        wre, wim = vre[..., 1, :], vim[..., 1, :]
        # x = u + v; y = (u - v)·r
        sre = ure - wre
        sim = uim - wim
        vre[..., 0, :] = ure + wre
        vim[..., 0, :] = uim + wim
        vre[..., 1, :] = sre * rr - sim * ri
        vim[..., 1, :] = sre * ri + sim * rr
        gap <<= 1
        m >>= 1
    rr, ri = float(r_re[ridx]), float(r_im[ridx])
    ure, uim = re[..., :gap].clone(), im[..., :gap].clone()
    wre, wim = re[..., gap:], im[..., gap:]
    sre = ure - wre
    sim = uim - wim
    if scalar is not None:
        # x = (u + v)·scalar; y = (u - v)·(r·scalar) (dwthandler.h:276-305)
        rr, ri = rr * scalar, ri * scalar
        re[..., :gap] = (ure + wre) * scalar
        im[..., :gap] = (uim + wim) * scalar
    else:
        re[..., :gap] = ure + wre
        im[..., :gap] = uim + wim
    re[..., gap:] = sre * rr - sim * ri
    im[..., gap:] = sre * ri + sim * rr
    return re, im


def transform_to_rev(re: torch.Tensor, im: torch.Tensor, roots, scalar=None):
    """DWTHandler::transform_to_rev (dwthandler.h:94-191): natural input ->
    bit-reversed output, over the last axis of contiguous [..., n] tensors.
    Writes into and returns (re, im)."""
    n = re.shape[-1]
    lead = re.shape[:-1]
    r_re, r_im = roots
    gap, m, ridx = n >> 1, 1, 1
    while m < (n >> 1):
        rr = r_re[ridx:ridx + m, None]
        ri = r_im[ridx:ridx + m, None]
        ridx += m
        vre, vim = re.view(lead + (m, 2, gap)), im.view(lead + (m, 2, gap))
        ure, uim = vre[..., 0, :].clone(), vim[..., 0, :].clone()
        wre, wim = vre[..., 1, :], vim[..., 1, :]
        # v = y·r; x = u + v; y = u - v
        pre = wre * rr - wim * ri
        pim = wre * ri + wim * rr
        vre[..., 0, :] = ure + pre
        vim[..., 0, :] = uim + pim
        vre[..., 1, :] = ure - pre
        vim[..., 1, :] = uim - pim
        gap >>= 1
        m <<= 1
    rr, ri = r_re[ridx:ridx + m], r_im[ridx:ridx + m]
    vre, vim = re.view(lead + (m, 2)), im.view(lead + (m, 2))
    ure, uim = vre[..., 0].clone(), vim[..., 0].clone()
    wre, wim = vre[..., 1], vim[..., 1]
    if scalar is not None:
        # u = x·scalar before the butterfly, v = y·(r·scalar)
        # (dwthandler.h:165-178)
        rr, ri = rr * scalar, ri * scalar
        ure, uim = ure * scalar, uim * scalar
    pre = wre * rr - wim * ri
    pim = wre * ri + wim * rr
    vre[..., 0] = ure + pre
    vim[..., 0] = uim + pim
    vre[..., 1] = ure - pre
    vim[..., 1] = uim - pim
    return re, im


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round (halves away from zero) on float64; torch.round rounds
    halves to even."""
    ax = x.abs()
    fl = torch.floor(ax)
    r = fl + (ax - fl >= 0.5).to(x.dtype)
    return torch.copysign(r, x)


def round_half_away_scalar(x: float) -> int:
    a = math.floor(abs(x))
    if abs(x) - a >= 0.5:
        a += 1
    return -a if (x < 0 or (x == 0 and math.copysign(1.0, x) < 0)) else a
