"""Batched Montgomery modexp on the card: the port's K7-K10.

The counterpart of the reference's device functions in
``cleisthenes_tpu/ops/modmath.py:425-732``.  Four entry points, each
with its plain PyTorch version beside it:

- ``mont_mul_batch``     K10, ``mont_mul_batch`` (modmath.py:504)
- ``pow_fused``          K7,  ``_pow_fused`` (:551)
- ``dual_pow_fused``     K8,  ``_dual_pow_fused`` (:592)
- ``pow_fused_grouped``  K9,  ``_pow_fused_grouped`` (:639): the
                         fixed-base comb, two launches (a table per
                         base, then one thread per exponent, which
                         names its base by a row index)

The byte contract is the reference's: values are (B, 33) uint8
little-endian rows (a base may lie anywhere in [0, 2^264)), exponents
(B, 32) uint8 big-endian rows, results (B, 33) rows in [0, p).  The
group rides in as a ``MontSpec`` (``mont_spec(p)``), the counterpart of
the reference's ``_spec256``: any odd modulus of 256 bits or fewer.

K10 differs from the reference in its radix.  The reference's
``mont_mul_batch`` takes (B, 22) 12-bit limbs and returns
x*y*2^-264 mod p; the port's takes 33-byte values x, y in [0, p) and
returns x*y*2^-256 mod p (csrc/modexp.cu keeps 8 x 32-bit limbs, so
R = 2^256).  The two agree on integer semantics:
out * 2^256 == x * y == ref_out * 2^264 (mod p).

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel (csrc/modexp.cu) or raises.  The plain versions
work in int64 with 17 limbs of 16 bits and their own radix 2^272,
whose headroom over p lets every product skip the conditional subtract:
a product's limbs are normalised by whole-tensor carry passes, and only
the final result is reduced to [0, p).  Only their outputs need to
match the kernels', so the plain generic pow uses a 4-bit fixed window
(256 squarings and 64 multiplies) to keep its op count low.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from cleisthenes_tpu_torch.csrc import build as _kb
from cleisthenes_tpu_torch.ops.sha256_cuda import _on_cuda

# the kernels' radix (8 x 32-bit limbs)
KERNEL_R_BITS = 256

# the plain versions' limbs: L limbs of W bits, radix 2^(W*L) = 2^272
_W = 16
_L = 17
_MASK = (1 << _W) - 1
_PLAIN_R_BITS = _W * _L
COMB_ROWS = 64  # nibble positions of a 256-bit exponent
COMB_COLS = 16  # nibble values


@dataclasses.dataclass(frozen=True)
class MontSpec:
    """Montgomery constants of one odd modulus p < 2^256.

    ``words`` is the kernels' argument: 33 uint32 (p, -p^-1 mod 2^32,
    R mod p, R^2 mod p, R^3 mod p, each 8 little-endian words,
    R = 2^256).  The plain versions' constants (radix 2^272) are built
    per device by ``_plain_consts``."""

    p: int
    words: np.ndarray = dataclasses.field(compare=False, repr=False)


def _words(x: int, n: int = 8) -> list:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


@functools.lru_cache(maxsize=None)
def mont_spec(p: int) -> MontSpec:
    """The MontSpec of modulus ``p``; raises for an even modulus or one
    wider than 256 bits (no CUDA layout hosts it yet)."""
    if p % 2 == 0 or p < 3 or p.bit_length() > KERNEL_R_BITS:
        raise ValueError(
            f"modulus of {p.bit_length()} bits (odd={p % 2 == 1}): the "
            "CUDA Montgomery kernels take odd moduli of at most 256 bits"
        )
    r = 1 << KERNEL_R_BITS
    words = np.array(
        _words(p)
        + [(-pow(p, -1, 1 << 32)) % (1 << 32)]
        + _words(r % p)
        + _words(r * r % p)
        + _words(r * r * r % p),
        dtype=np.uint32,
    )
    words.setflags(write=False)
    return MontSpec(p=p, words=words)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _limbs(x: int) -> list:
    return [(x >> (_W * i)) & _MASK for i in range(_L)]


@functools.lru_cache(maxsize=None)
def _plain_consts(p: int, device: torch.device) -> dict:
    """Constants of the plain Montgomery product (radix 2^272) on one
    device: p's limbs, the Toeplitz matrices that multiply by
    -p^-1 mod R (low half) and by p, R mod p, R^2 mod p, and 2^288 mod p
    (which turns a radix-2^272 product into the kernels' 2^-256)."""
    r = 1 << _PLAIN_R_BITS
    pl = _limbs(p)
    pinv = _limbs((-pow(p, -1, r)) % r)
    t_pinv = torch.zeros((_L, _L), dtype=torch.int64)
    t_p = torch.zeros((_L, 2 * _L - 1), dtype=torch.int64)
    skew = torch.full((_L, 2 * _L - 1), _L, dtype=torch.int64)
    for i in range(_L):
        for k in range(i, _L):
            t_pinv[i, k] = pinv[k - i]
        for j in range(_L):
            t_p[i, i + j] = pl[j]
            skew[i, i + j] = j

    def vec(x: int) -> torch.Tensor:
        return torch.tensor(_limbs(x), dtype=torch.int64, device=device)

    return {
        "p": vec(p),
        "t_pinv": t_pinv.to(device),
        "t_p": t_p.to(device),
        "skew": skew.to(device),
        "one": vec(r % p),
        "r2": vec(r * r % p),
        "c288": vec((1 << 288) % p),
        "unit": vec(1),
    }


def _carry(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Whole-tensor carry passes over the last (limb) axis: each limb
    keeps its low 16 bits and hands the rest to the next; the top
    limb's carry is dropped (callers either work mod R or know it is
    zero)."""
    for _ in range(passes):
        c = x >> _W
        x = x & _MASK
        x[..., 1:] += c[..., :-1]
    return x


def _mont(a: torch.Tensor, b: torch.Tensor, c: dict) -> torch.Tensor:
    """a * b / 2^272 mod p, up to a multiple of p: (..., 17) int64
    limbs below 2^17 in and out.  The output is below a*b/R + 1.05p, so
    inputs below 1.1p (or one below 2^264 and the other below p) give
    an output below 1.1p (R = 2^272 > 2^16 p): products chain without
    a conditional subtract.

    Bounds: limb products < 2^34, column sums < 2^38.1; m's columns
    < 2^58.1 before its three carry passes; S = t + m*p < 2^39.  The
    division by R is exact: the low half of S is k*R, and k is
    ceil((S[16] * 2^16 + S[15]) / 2^32), since the lower columns add
    less than 2^-8 to that quotient."""
    bz = torch.nn.functional.pad(b, (0, 1))
    bt = bz[..., c["skew"]]  # (..., L, 2L-1): bt[i, i+j] = b[j]
    t = (a.unsqueeze(-1) * bt).sum(-2)  # (..., 2L-1) columns of a*b
    m = (t[..., :_L].unsqueeze(-1) * c["t_pinv"]).sum(-2)  # -t/p mod R
    m = _carry(m, 3)
    s = t + (m.unsqueeze(-1) * c["t_p"]).sum(-2)
    k = (s[..., _L - 1] * (1 << _W) + s[..., _L - 2] + ((1 << 32) - 1)) >> 32
    u = torch.nn.functional.pad(s[..., _L:], (0, 1))
    u[..., 0] += k
    return _carry(u, 2)


def _bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """(..., 33) uint8 little-endian -> (..., 17) int64 16-bit limbs."""
    x = torch.nn.functional.pad(b.to(torch.int64), (0, 1))
    x = x.reshape(*b.shape[:-1], _L, 2)
    return x[..., 0] | (x[..., 1] << 8)


def _limbs_to_bytes(x: torch.Tensor, c: dict) -> torch.Tensor:
    """(B, 17) limbs of a value below 2p -> (B, 33) uint8 of its
    residue in [0, p): one sequential carry, one conditional
    subtract (once per call, so the per-limb loops are cheap)."""
    x = x.clone()
    for i in range(_L - 1):
        x[:, i + 1] += x[:, i] >> _W
        x[:, i] &= _MASK
    d = x - c["p"]
    for i in range(_L - 1):
        d[:, i + 1] += d[:, i] >> _W  # arithmetic shift: floor borrow
        d[:, i] &= _MASK
    x = torch.where(d[:, _L - 1 :] >= 0, d, x)
    out = torch.stack([x & 0xFF, x >> 8], -1).reshape(x.shape[0], 2 * _L)
    return out[:, :33].to(torch.uint8)


def _nibbles_msb(e: torch.Tensor) -> torch.Tensor:
    """(B, 32) big-endian exponent bytes -> (B, 64) int64 nibbles, most
    significant first."""
    e = e.to(torch.int64)
    return torch.stack([e >> 4, e & 15], -1).reshape(e.shape[0], 64)


def _to_mont(b: torch.Tensor, c: dict) -> torch.Tensor:
    """(B, 33) values below 2^264 -> Montgomery-domain limbs."""
    x = _bytes_to_limbs(b)
    return _mont(x, c["r2"].expand_as(x), c)


def _from_mont(x: torch.Tensor, c: dict) -> torch.Tensor:
    return _limbs_to_bytes(_mont(x, c["unit"].expand_as(x), c), c)


def _powers16(x: torch.Tensor, c: dict) -> torch.Tensor:
    """(B, 17) Montgomery x -> (B, 16, 17): x^0 .. x^15, in four
    product calls (doubling)."""
    one = c["one"].expand_as(x)
    pw = [one, x]
    while len(pw) < COMB_COLS:
        top = pw[-1]
        want = min(len(pw) - 1, COMB_COLS - len(pw))
        lhs = torch.cat([top] * want, 0)
        rhs = torch.cat(pw[1 : 1 + want], 0)
        pw.extend(_mont(lhs, rhs, c).split(x.shape[0], 0))
    return torch.stack(pw, 1)


def _pow_mont(x: torch.Tensor, e: torch.Tensor, c: dict) -> torch.Tensor:
    """x^e in the Montgomery domain by a 4-bit fixed window: x (B, 17)
    Montgomery limbs, e (B, 32) big-endian exponent bytes."""
    tab = _powers16(x, c)
    nib = _nibbles_msb(e)
    rows = torch.arange(x.shape[0], device=x.device)
    acc = tab[rows, nib[:, 0]]
    for k in range(1, 64):
        for _ in range(4):
            acc = _mont(acc, acc, c)
        acc = _mont(acc, tab[rows, nib[:, k]], c)
    return acc


def mont_mul_batch_plain(a: torch.Tensor, b: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """(B, 33) x, y in [0, p) -> (B, 33) x*y*2^-256 mod p."""
    c = _plain_consts(spec.p, a.device)
    x = _mont(_bytes_to_limbs(a), _bytes_to_limbs(b), c)  # x*y/2^272
    x = _mont(x, c["c288"].expand_as(x), c)  # * 2^288 / 2^272
    return _limbs_to_bytes(x, c)


def pow_fused_plain(base: torch.Tensor, exp: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """(B, 33) bases, (B, 32) exponents -> (B, 33) base^exp mod p."""
    if base.shape[0] == 0:
        return torch.empty((0, 33), dtype=torch.uint8, device=base.device)
    c = _plain_consts(spec.p, base.device)
    return _from_mont(_pow_mont(_to_mont(base, c), exp, c), c)


def dual_pow_fused_plain(
    u1: torch.Tensor, e1: torch.Tensor, u2: torch.Tensor, e2: torch.Tensor,
    spec: MontSpec,
) -> torch.Tensor:
    """(B, 33) u1, u2 and (B, 32) e1, e2 -> (B, 33) u1^e1 * u2^e2 mod p."""
    b = u1.shape[0]
    if b == 0:
        return torch.empty((0, 33), dtype=torch.uint8, device=u1.device)
    c = _plain_consts(spec.p, u1.device)
    both = _pow_mont(
        _to_mont(torch.cat([u1, u2]), c), torch.cat([e1, e2]), c
    )
    return _from_mont(_mont(both[:b], both[b:], c), c)


def comb_table_plain(bases: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """(n, 33) bases -> (n, 64, 16, 17) Montgomery limbs of
    base^(j * 16^k), the plain counterpart of the comb's table."""
    c = _plain_consts(spec.p, bases.device)
    x = _to_mont(bases, c)
    chain = [x]
    for _ in range(COMB_ROWS - 1):
        for _ in range(4):
            x = _mont(x, x, c)
        chain.append(x)
    s = torch.stack(chain, 1)  # (n, 64, 17): base^(16^k)
    n = bases.shape[0]
    return _powers16(s.reshape(n * COMB_ROWS, _L), c).reshape(
        n, COMB_ROWS, COMB_COLS, _L
    )


def pow_fused_grouped_plain(
    bases: torch.Tensor, exps: torch.Tensor, rows: torch.Tensor, spec: MontSpec
) -> torch.Tensor:
    """(n, 33) bases, (M, 32) exponents, (M,) int32 row indices -> (M, 33)
    with out[i] = bases[rows[i]]^exps[i] mod p, by the fixed-base comb."""
    m = exps.shape[0]
    if m == 0:
        return torch.empty((0, 33), dtype=torch.uint8, device=exps.device)
    c = _plain_consts(spec.p, bases.device)
    tab = comb_table_plain(bases, spec).reshape(-1, _L)
    nib = _nibbles_msb(exps)
    row = rows.to(torch.int64) * (COMB_ROWS * COMB_COLS)
    # nibble k (bits [4k, 4k+4)) is column 63 - k of the MSB-first list
    acc = tab[row + nib[:, 63]]
    for k in range(1, COMB_ROWS):
        acc = _mont(acc, tab[row + k * COMB_COLS + nib[:, 63 - k]], c)
    return _from_mont(acc, c)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_bytes(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if (
        t.dtype != torch.uint8
        or t.dim() != len(shape)
        or any(want >= 0 and got != want for got, want in zip(t.shape, shape))
        or not t.is_contiguous()
    ):
        raise ValueError(
            f"{name}: need a contiguous uint8 tensor of shape "
            f"{tuple('*' if s < 0 else s for s in shape)}, got {t.dtype} "
            f"{tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _launch(fn: str, sites: Tuple[str, ...], ref: torch.Tensor, *args) -> None:
    """One launch of ``fn`` on ``ref``'s card and current stream."""
    lib = _kb.load("modexp")
    with torch.cuda.device(ref.device):
        rc = getattr(lib, fn)(*args, _kb.stream_of(ref))
    _kb.check(rc, fn)
    _kb.COUNTS.add(fn, sites)


def mont_mul_batch(a: torch.Tensor, b: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """K10: (B, 33) x, y in [0, p) -> (B, 33) x*y*2^-256 mod p."""
    _check_bytes("mont_mul_batch a", a, (-1, 33))
    _check_bytes("mont_mul_batch b", b, (a.shape[0], 33))
    if not _on_cuda(a, b):
        return mont_mul_batch_plain(a, b, spec)
    out = torch.empty_like(a)
    if a.shape[0]:
        _launch(
            "mont_mul", ("mont_mul",), a, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), a.shape[0], spec.words.ctypes.data,
        )
    return out


def pow_fused(base: torch.Tensor, exp: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """K7: (B, 33) bases in [0, 2^264), (B, 32) exponents -> (B, 33)
    base^exp mod p."""
    _check_bytes("pow_fused base", base, (-1, 33))
    _check_bytes("pow_fused exp", exp, (base.shape[0], 32))
    if not _on_cuda(base, exp):
        return pow_fused_plain(base, exp, spec)
    out = torch.empty_like(base)
    if base.shape[0]:
        _launch(
            "pow_fused", ("pow",), base, base.data_ptr(),
            exp.data_ptr(), out.data_ptr(), base.shape[0],
            spec.words.ctypes.data,
        )
    return out


def dual_pow_fused(
    u1: torch.Tensor, e1: torch.Tensor, u2: torch.Tensor, e2: torch.Tensor,
    spec: MontSpec,
) -> torch.Tensor:
    """K8: (B, 33) u1, u2 and (B, 32) e1, e2 -> (B, 33) u1^e1 * u2^e2 mod p."""
    b = u1.shape[0]
    _check_bytes("dual_pow_fused u1", u1, (-1, 33))
    _check_bytes("dual_pow_fused u2", u2, (b, 33))
    _check_bytes("dual_pow_fused e1", e1, (b, 32))
    _check_bytes("dual_pow_fused e2", e2, (b, 32))
    if not _on_cuda(u1, e1, u2, e2):
        return dual_pow_fused_plain(u1, e1, u2, e2, spec)
    out = torch.empty_like(u1)
    if b:
        _launch(
            "dual_pow_fused", ("dual_pow",), u1, u1.data_ptr(),
            e1.data_ptr(), u2.data_ptr(), e2.data_ptr(), out.data_ptr(), b,
            spec.words.ctypes.data,
        )
    return out


def pow_fused_grouped(
    bases: torch.Tensor, exps: torch.Tensor, rows: torch.Tensor, spec: MontSpec
) -> torch.Tensor:
    """K9: (n, 33) bases, (M, 32) exponents, (M,) int32 row indices in
    [0, n) -> (M, 33) with out[i] = bases[rows[i]]^exps[i] mod p: a comb
    table per base (``comb_table``, 32 KiB per base), then one thread
    per exponent (``comb_apply``).  The reference's (n, G) rectangle is
    rows = arange(n).repeat_interleave(G)."""
    n, m = bases.shape[0], exps.shape[0]
    _check_bytes("pow_fused_grouped bases", bases, (-1, 33))
    _check_bytes("pow_fused_grouped exps", exps, (-1, 32))
    if rows.dtype != torch.int32 or tuple(rows.shape) != (m,) or not rows.is_contiguous():
        raise ValueError(
            f"pow_fused_grouped rows: need a contiguous int32 tensor of shape "
            f"({m},), got {rows.dtype} {tuple(rows.shape)}"
        )
    if m:
        lo, hi = torch.stack(torch.aminmax(rows)).tolist()  # one sync
        if lo < 0 or hi >= n:
            raise ValueError(f"pow_fused_grouped rows: an index lies outside [0, {n})")
    if not _on_cuda(bases, exps, rows):
        return pow_fused_grouped_plain(bases, exps, rows, spec)
    out = torch.empty((m, 33), dtype=torch.uint8, device=exps.device)
    if m == 0:
        return out
    table = torch.empty(
        (n, COMB_ROWS, COMB_COLS, 8), dtype=torch.int32, device=exps.device
    )
    sites = ("pow_grouped",)
    _launch(
        "comb_table", sites, exps, bases.data_ptr(), table.data_ptr(),
        n, spec.words.ctypes.data,
    )
    _launch(
        "comb_apply", sites, exps, exps.data_ptr(), rows.data_ptr(),
        table.data_ptr(), out.data_ptr(), m, spec.words.ctypes.data,
    )
    return out


__all__ = [
    "COMB_COLS",
    "COMB_ROWS",
    "KERNEL_R_BITS",
    "MontSpec",
    "comb_table_plain",
    "dual_pow_fused",
    "dual_pow_fused_plain",
    "mont_mul_batch",
    "mont_mul_batch_plain",
    "mont_spec",
    "pow_fused",
    "pow_fused_grouped",
    "pow_fused_grouped_plain",
    "pow_fused_plain",
]
